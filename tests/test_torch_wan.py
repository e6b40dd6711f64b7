"""The port's Wan2.1 video DiT (``models/wan.py``) and the trainer's flow
objective against the benchmark's plain reference (``bench_h100/reference/
wan.py``, fp32, written from the published model) on seeded weights, at a
tiny size on the CPU: the forward bare and with LoKr live, one flow-matching
step (loss, every adapter gradient, the AdamW update) with and without block
recompute and the factored backward, RoPE3D against a complex-number form,
the flash gate at a ragged T, the rope spans, and the full-size parameter
count and key names on the meta device. Tolerances: fp32 on both sides, so
2e-5 relative (the reference sums in other orders: attention in query
blocks, the patch embedding as a matmul)."""

import dataclasses

import pytest
import torch

from bench_h100 import inputs
from bench_h100.algos import lokr as lokr_algo
from bench_h100.reference.common import WeightStore
from bench_h100.reference.wan import TrainReference, rope_apply, rope_freqs, wan_forward, wan_spec
from lycoris_tpu_torch.functional import merged as fm
from lycoris_tpu_torch.models.wan import (WanConfig, WanModel, rope3d, rope_table,
                                          tiny_wan_config)
from lycoris_tpu_torch.ops import flash as tflash
from lycoris_tpu_torch.trainer import DiffusionTrainer

ADAPTER = {"algo": "lokr", "dim": 4, "alpha": 2.0, "factor": 4, "targets": ["WanAttentionBlock"]}
REL = 2e-5
BETA1 = 0.9


def _sizes(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "remat"}


def _rel(got, want):
    return float((got - want).norm() / want.norm())


def _model(cfg, seed=7):
    """The port's model on the benchmark's seeded weights; (model, base)."""
    base = inputs.make_weights(wan_spec(_sizes(cfg)), seed, torch.float32, "cpu")
    model = WanModel(cfg, device="meta")
    model.load_state_dict(base, strict=True, assign=True)
    return model, base


def _inputs(cfg, fhw=(3, 4, 4), txt=7, seed=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, cfg.in_dim, *fhw, generator=g)
    t = torch.rand(2, generator=g) * 1000
    ctx = torch.randn(2, txt, cfg.text_dim, generator=g)
    return x, t, ctx


def _lokr(model, base_seed=7):
    spec = wan_spec(_sizes(model.cfg))
    theta, scales = inputs.make_adapters(spec, ADAPTER, base_seed, "cpu", lokr_algo)
    net = inputs.port_network(model, ADAPTER, "cpu", lokr_algo)
    leaves = inputs.load_adapters(net, theta)
    return net, leaves, theta, scales


def test_full_size_parameters_and_keys_on_meta():
    cfg = WanConfig()
    model = WanModel(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 14_288_491_584
    sd = model.state_dict()
    spec = wan_spec(_sizes(cfg))
    assert sorted(sd) == sorted(n for n, *_ in spec)
    assert all(tuple(sd[n].shape) == tuple(s) for n, s, *_ in spec)
    for key in ("patch_embedding.weight", "text_embedding.2.bias", "time_embedding.0.weight",
                "time_projection.1.weight", "blocks.39.self_attn.norm_q.weight",
                "blocks.0.cross_attn.o.bias", "blocks.7.norm3.bias", "blocks.3.ffn.2.weight",
                "blocks.3.modulation", "head.head.weight", "head.modulation"):
        assert key in sd, key
    assert tuple(sd["patch_embedding.weight"].shape) == (5120, 16, 1, 2, 2)
    assert type(model.blocks[0]).__name__ == "WanAttentionBlock"


@pytest.mark.parametrize("grid,head_dim", [((3, 4, 5), 24), ((9, 30, 52), 128)])
def test_rope3d_against_the_complex_form(grid, head_dim):
    cos, sin = rope_table(grid, head_dim, torch.device("cpu"))
    n = grid[0] * grid[1] * grid[2]
    x = torch.randn(1, n, 2, head_dim, generator=torch.Generator().manual_seed(0))
    want = rope_apply(x, rope_freqs(grid, head_dim, "cpu"))
    got = rope3d(x, cos, sin)
    assert float((got - want).abs().max()) <= 1e-5 * float(x.abs().max())
    # the frame axis turns the first c - 4 (c // 6) channels, at n = 44 for c = 128
    pairs_f = (head_dim - 4 * (head_dim // 6)) // 2
    ang = torch.atan2(sin, cos)
    row = grid[1] * grid[2]  # the first token of frame 1
    assert torch.allclose(ang[row, :pairs_f], torch.pow(
        10000.0, -torch.arange(0, 2 * pairs_f, 2).double() / (2 * pairs_f)).float(), atol=1e-6)
    assert float(ang[row, pairs_f:].abs().max()) == 0.0


def test_forward_bare_matches_the_reference():
    cfg = tiny_wan_config()
    model, base = _model(cfg)
    x, t, ctx = _inputs(cfg)
    with torch.no_grad():
        got = model(x, t, ctx)
    want = wan_forward(_sizes(cfg), WeightStore(base), x, t, ctx, qblock=5)
    assert got.shape == x.shape
    assert _rel(got, want) <= REL


def test_forward_with_lokr_live_matches_the_reference():
    cfg = tiny_wan_config()
    model, base = _model(cfg)
    net, _, theta, scales = _lokr(model)
    assert len(net.loras) == 10 * cfg.num_layers
    net.apply_to(merged_forward=True)
    x, t, ctx = _inputs(cfg)
    with torch.no_grad():
        got = model(x, t, ctx)
    store = WeightStore(base, theta, scales, lokr_algo.delta)
    want = wan_forward(_sizes(cfg), store, x, t, ctx, qblock=5)
    bare = wan_forward(_sizes(cfg), WeightStore(base), x, t, ctx, qblock=5)
    assert _rel(got, want) <= REL
    assert _rel(want, bare) > 1e-2  # the adapters move the output


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("factored", [False, True])
def test_flow_step_matches_the_reference(monkeypatch, remat, factored):
    """One flow-matching step: the loss, every adapter leaf's gradient (from
    AdamW's first moment) and every leaf after the update."""
    if factored:  # the tiny layers take the factored backward too
        monkeypatch.setattr(fm, "FACTORED_MIN", 1)
    cfg = tiny_wan_config(remat=remat)
    model, base = _model(cfg)
    net, leaves, theta, scales = _lokr(model)
    batch = dict(zip(("latents", "context"), _inputs(cfg, seed=11)[::2]))
    trainer = DiffusionTrainer(model, net, lr=1e-3, weight_dtype=torch.float32,
                               generator=torch.Generator().manual_seed(5), objective="flow")
    n = fm.applications
    theta0 = [p.detach().clone() for *_, p in leaves]
    loss = float(trainer.train_step(batch))
    assert (fm.applications - n > 0) == factored
    ref = TrainReference(_sizes(cfg), base, theta, scales, lokr_algo.delta,
                         torch.Generator().manual_seed(5), lr=1e-3, qblock=5)
    want_loss, want_grads = ref.step(batch)
    assert abs(loss - want_loss) <= REL * abs(want_loss)
    by_key = dict(zip(ref.keys, zip(want_grads, ref.leaves)))
    for (layer, key, p), p0 in zip(leaves, theta0):
        g_ref, p_ref = by_key[(layer, key)]
        g = trainer.optimizer.state[p]["exp_avg"] / (1 - BETA1)
        assert _rel(g, g_ref) <= 1e-4, (layer, key)
        torch.testing.assert_close(p.detach() - p0, p_ref.detach() - p0, rtol=1e-3, atol=1e-6)


def test_eps_objective_loss_is_unchanged():
    """The eps objective's loss is the formula it was, bit for bit, on 4-D
    latents; the flow objective's is the velocity MSE at 1000 sigma."""
    calls = []

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor(0.5))

        def forward(self, x, t, ctx):
            calls.append(t)
            return x * self.w + ctx.mean()

    g = torch.Generator().manual_seed(0)
    lat, noise = torch.randn(3, 4, 8, 8, generator=g), torch.randn(3, 4, 8, 8, generator=g)
    ctx, t = torch.randn(3, 5, 6, generator=g), torch.tensor([3, 500, 999])
    net = type("Net", (), {"apply_to": lambda self, **kw: self,
                           "prepare_optimizer_params": lambda self: [torch.zeros(1,
                                                                     requires_grad=True)]})()
    tr = DiffusionTrainer(Probe(), net, weight_dtype=torch.float32)
    a = tr.alphas_cumprod[t].reshape(3, 1, 1, 1)
    noisy = (torch.sqrt(a) * lat + torch.sqrt(1 - a) * noise).to(torch.float32)
    want = ((Probe()(noisy, t, ctx).float() - noise) ** 2).mean()
    assert torch.equal(tr.loss_fn(lat, ctx, noise, t), want)
    tr.objective = "flow"
    lat5, noise5 = lat[:, :, None], noise[:, :, None]  # 5-D video latents
    s = torch.tensor([0.1, 0.5, 0.9])
    got = tr.loss_fn(lat5, ctx, noise5, s)
    assert torch.equal(calls[-1], s * 1000)
    sb = s.reshape(3, 1, 1, 1, 1)
    x = (1 - sb) * lat5 + sb * noise5
    assert torch.allclose(got, ((x * 0.5 + ctx.mean() - (noise5 - lat5)) ** 2).mean())
    with pytest.raises(ValueError):
        DiffusionTrainer(Probe(), net, objective="v")


def test_self_attention_takes_flash_at_a_ragged_t(monkeypatch):
    """At 5 x 8 x 26 = 1,040 tokens (no multiple of 128) each block's
    self-attention takes the flash Function and its cross-attention the
    plain path; the output is the reference's."""
    calls = []
    real = tflash.flash_attention

    def spy(q, k, v, sm):
        calls.append(tuple(q.shape))
        return real(q, k, v, sm)

    monkeypatch.setattr(tflash, "flash_attention", spy)
    cfg = tiny_wan_config()
    model, base = _model(cfg)
    x, t, ctx = _inputs(cfg, fhw=(5, 16, 52))
    with torch.no_grad():
        got = model(x[:1], t[:1], ctx[:1])
    assert calls == [(1, cfg.num_heads, 1040, cfg.head_dim)] * cfg.num_layers
    want = wan_forward(_sizes(cfg), WeightStore(base), x[:1], t[:1], ctx[:1], qblock=256)
    assert _rel(got, want) <= REL


def test_rope_spans_a_step():
    """Under the profiler a training forward and backward open one
    ``lycoris.rope`` span an application: q and k of every block, again in
    each checkpointed block's recompute."""
    cfg = tiny_wan_config(remat=True)
    model, _ = _model(cfg)
    net, *_ = _lokr(model)
    net.apply_to(merged_forward=True)
    x, t, ctx = _inputs(cfg)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(x, t, ctx).square().mean().backward()
    names = [e.name for e in prof.events()]
    assert names.count("lycoris.rope") == 2 * 2 * cfg.num_layers
