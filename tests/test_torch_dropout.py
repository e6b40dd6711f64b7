"""The dropout trio (dropout, rank dropout, module dropout) of the port's
LoCon, LoKr and LoHa modules against the JAX package, and in training.

The two packages draw their masks from different random streams (JAX keys
folded with salts; the port's generators seeded from the step seed, the
module's name and the same salts). So the parity tests replace the mask
helpers in both packages' namespaces with ones that return the same numpy
masks, at test time only, and compare the training forward and the adapter
gradients in merged and bypass mode. The port's own draws are held to the
properties ``tests/test_dropout.py`` pins on the JAX side: each mask's rate,
the exact base output of a dropped module, zero gradients on dropped
ranks, ``rank_dropout_scale`` and the inverted 1/(1-p) scaling. With
training off, or all rates 0, the forward is bit-identical to the merged
forward it replaces.

The trainer tests: checkpointing (``remat="transformer"``) gives the same
gradients with dropout as no checkpointing (the recompute draws the same
masks), another drop seed gives others, and with all rates 0 a train step's
loss and gradients match the JAX trainer on the same noise and timesteps.

Tolerance: fp32 atol/rtol 1e-5 for outputs and gradients of one module; 1e-4
relative for the whole tiny UNet against JAX (as tests/test_torch_train.py);
1e-5 between the port with and without checkpointing (the same ops again).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lycoris_tpu as jl
import lycoris_tpu_torch as tl
from lycoris_tpu.models import unet as junet
from lycoris_tpu.modules import base as jbase
from lycoris_tpu.modules import locon as jlocon_mod
from lycoris_tpu.modules import loha as jloha_mod
from lycoris_tpu.modules import lokr as jlokr_mod
from lycoris_tpu.trainer import ddpm_alphas_cumprod as jax_acp
from lycoris_tpu_torch.models import unet as tunet
from lycoris_tpu_torch.modules import LayerInfo, LoConModule, LohaModule, LokrModule
from lycoris_tpu_torch.modules import base as tbase
from lycoris_tpu_torch.trainer import DiffusionTrainer

TOL = dict(atol=1e-5, rtol=1e-5)
REL = 1e-4
ATTN_MLP = {"target_module": ["Transformer2DModel"]}
RATES = dict(dropout=0.3, rank_dropout=0.4, module_dropout=0.2)


@pytest.fixture(autouse=True)
def reset_presets():
    yield
    jl.LycorisNetwork.reset_preset()
    tl.LycorisNetwork.reset_preset()


def _rand(rng, *shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


# ---------------------------------------------------------------------------
# module parity with the masks fixed
# ---------------------------------------------------------------------------

# algorithm -> (port class, JAX class, conv layer?)
ALGOS = {
    "locon": (LoConModule, jlocon_mod.LoConModule, False),
    "locon_conv": (LoConModule, jlocon_mod.LoConModule, True),
    "lokr": (LokrModule, jlokr_mod.LokrModule, False),
    "loha": (LohaModule, jloha_mod.LohaModule, False),
}


def _pair(algo, bypass, rates):
    """The JAX module and the port's, the same seeded values in every
    trainable tensor, the layer's weight and bias, and an input."""
    tcls, jcls, conv = ALGOS[algo]
    if conv:
        tli = LayerInfo.conv(2, 24, 16, 3, padding=1)
        jli = jbase.LayerInfo.conv(2, 24, 16, 3, padding=1)
    else:
        tli, jli = LayerInfo.linear(24, 16), jbase.LayerInfo.linear(24, 16)
    cfg = dict(bypass_mode=bypass, factor=4, **rates)
    rng = np.random.default_rng(0)
    w = _rand(rng, *tli.shape, std=0.2)
    jm = jcls("t", jli, 0.8, 4, 3.0, rng=jax.random.key(1), org_weight=jnp.asarray(w), **cfg)
    tm = tcls("t", tli, 0.8, 4, 3.0, generator=torch.Generator().manual_seed(1), **cfg)
    with torch.no_grad():
        for k in sorted(jm.trainable):
            v = _rand(rng, *np.shape(jm.params[k]), std=0.3)
            jm.params[k] = jnp.asarray(v)
            tm._p(k).copy_(torch.tensor(v))
    assert {k for k, _ in tm.named_parameters()} == set(jm.trainable)
    b = _rand(rng, 24, std=0.1)
    x = _rand(rng, 2, 16, 6, 6) if conv else _rand(rng, 2, 7, 16)
    return tm, jm, w, b, x


class FixedMasks:
    """Numpy masks by size (rank), by shape (dropout) and one keep flag,
    served to both packages in place of their draws."""

    def __init__(self, keep, seed=3):
        self.keep = keep
        self.rng = np.random.default_rng(seed)
        self.rank, self.drop = {}, {}
        self.calls = []

    def rank_mask(self, n):
        if n not in self.rank:
            m = (self.rng.uniform(size=n) > 0.4).astype(np.float32)
            m[0] = 0.0  # at least one rank dropped, one kept
            m[-1] = 1.0
            self.rank[n] = m
        self.calls.append(("rank", n))
        return self.rank[n]

    def drop_mask(self, shape):
        shape = tuple(shape)
        if shape not in self.drop:
            self.drop[shape] = self.rng.uniform(size=shape) < 0.7
        self.calls.append(("drop", shape))
        return self.drop[shape]

    def patch(self, monkeypatch):
        def j_rank(rng, n, p, scale, dtype=jnp.float32):
            return jnp.asarray(self.rank_mask(n), dtype)

        def j_drop(rng, x, p):
            return jnp.where(jnp.asarray(self.drop_mask(x.shape)), x / (1.0 - p), 0.0).astype(x.dtype)

        def j_keep(rng, p):
            return jnp.float32(self.keep)

        def t_rank(gen, n, p, scale, dtype, device):
            return torch.tensor(self.rank_mask(n), dtype=dtype, device=device)

        def t_drop(gen, x, p, shard=(0, 1)):
            return torch.where(torch.tensor(self.drop_mask(x.shape)), x / (1.0 - p), 0.0).to(x.dtype)

        def t_keep(gen, p):
            return torch.tensor(float(self.keep))

        for mod in (jlocon_mod, jlokr_mod, jloha_mod):
            monkeypatch.setattr(mod, "rank_dropout_mask", j_rank)
            monkeypatch.setattr(mod, "traced_dropout", j_drop)
        monkeypatch.setattr(jbase, "module_keep", j_keep)
        monkeypatch.setattr(tbase, "rank_dropout_mask", t_rank)
        monkeypatch.setattr(tbase, "dropout", t_drop)
        monkeypatch.setattr(tbase, "module_keep", t_keep)


@pytest.mark.parametrize("keep", [1.0, 0.0])
@pytest.mark.parametrize("bypass", [False, True], ids=["merged", "bypass"])
@pytest.mark.parametrize("algo", list(ALGOS))
def test_training_forward_and_grads_match_jax(monkeypatch, algo, bypass, keep):
    masks = FixedMasks(keep)
    masks.patch(monkeypatch)
    tm, jm, w, b, x = _pair(algo, bypass, RATES)
    ct = _rand(np.random.default_rng(9), *np.shape(jm.forward(jnp.asarray(x), jnp.asarray(w),
                                                              jnp.asarray(b))))

    def jax_loss(tp):
        out = jm.forward(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         params={**jm.params, **tp}, multiplier=0.6, train=True,
                         rng=jax.random.key(5))
        return jnp.sum(out * jnp.asarray(ct)), out

    masks.calls.clear()
    (_, want), want_g = jax.value_and_grad(jax_loss, has_aux=True)(jm.trainable_params())
    jax_calls = set(masks.calls)
    masks.calls.clear()
    out = tm(torch.tensor(x), torch.tensor(w), torch.tensor(b), multiplier=0.6, train=True,
             seed=123)
    # the same draws as the JAX forward (rank masks; dropout in bypass mode)
    assert jax_calls and set(masks.calls) == jax_calls
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    (out * torch.tensor(ct)).sum().backward()
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g[k]), **TOL, err_msg=k)
    if keep == 0.0:  # a dropped module gives the base output and no gradient
        base = jm.op(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(base), **TOL)
        assert all(float(p.grad.abs().max()) == 0.0 for p in tm.parameters())


@pytest.mark.parametrize("algo", ["lokr", "loha"])
def test_merged_diff_weight_rows_match_jax(monkeypatch, algo):
    """Rank dropout of the merged form masks the out-dim rows of dW."""
    masks = FixedMasks(1.0)
    masks.patch(monkeypatch)
    tm, jm, _, _, _ = _pair(algo, False, dict(rank_dropout=0.5))
    want = jm.get_weight(train=True, rng=jax.random.key(2))
    got = tm.get_weight(train=True, seed=7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    zero_rows = np.all(got.detach().numpy().reshape(24, -1) == 0, axis=1)
    np.testing.assert_array_equal(zero_rows, masks.rank[24] == 0)


# ---------------------------------------------------------------------------
# the port's own draws (tests/test_dropout.py's properties)
# ---------------------------------------------------------------------------


def _noised(cls, **kw):
    tm = cls("t", LayerInfo.linear(16, 16), 1.0, 4, 4.0, factor=4,
             generator=torch.Generator().manual_seed(3), **kw)
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for p in tm.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return tm


def test_mask_rates():
    p, n = 0.3, 20000
    gen = tbase.draw_generator(1, tbase.RANK_SALT, "cpu")
    assert abs(1 - float(tbase.rank_dropout_mask(gen, n, p, False, torch.float32, "cpu").mean())
               - p) < 0.02
    keeps = [float(tbase.module_keep(tbase.draw_generator(s, tbase.MODULE_SALT, "cpu"), p))
             for s in range(600)]
    assert abs(1 - np.mean(keeps) - p) < 0.06
    x = torch.ones(128, 128)
    out = tbase.dropout(tbase.draw_generator(2, tbase.DROP_SALT, "cpu"), x, p)
    assert abs(float((out == 0).float().mean()) - p) < 0.02


def test_dropout_inverted_scaling():
    p = 0.25
    x = torch.ones(64, 64)
    out = tbase.dropout(tbase.draw_generator(5, tbase.DROP_SALT, "cpu"), x, p)
    np.testing.assert_allclose(out[out != 0].numpy(), 1.0 / (1 - p), rtol=1e-6)
    assert abs(float(out.mean()) - 1.0) < 0.03


def test_rank_dropout_scale():
    plain = tbase.rank_dropout_mask(tbase.draw_generator(3, 0, "cpu"), 64, 0.5, False,
                                    torch.float32, "cpu")
    scaled = tbase.rank_dropout_mask(tbase.draw_generator(3, 0, "cpu"), 64, 0.5, True,
                                     torch.float32, "cpu")
    assert 0 < float(plain.mean()) < 1
    np.testing.assert_allclose(scaled.numpy(), (plain / plain.mean()).numpy(), rtol=1e-6)


@pytest.mark.parametrize("cls", [LoConModule, LokrModule, LohaModule])
def test_module_dropout_gives_the_base_output_exactly(cls):
    p = 0.3
    tm = _noised(cls, module_dropout=p)
    g = torch.Generator().manual_seed(4)
    x, w = torch.randn(2, 16, generator=g), torch.randn(16, 16, generator=g)
    base = tm.op(x, w)
    full = tm(x, w)
    dropped = 0
    for seed in range(200):
        out = tm(x, w, train=True, seed=seed)
        if torch.equal(out, base):
            dropped += 1
        else:
            torch.testing.assert_close(out, full, atol=1e-6, rtol=1e-6)
    assert abs(dropped / 200 - p) < 0.1


def test_dropped_ranks_get_zero_gradients():
    """LoCon bypass: the up factor's columns of the dropped ranks (the mask
    the module draws for its seed) get exactly zero gradient."""
    tm = _noised(LoConModule, rank_dropout=0.5, bypass_mode=True)
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(6))
    for seed in range(8):
        tm.zero_grad()
        (tm.bypass_forward_diff(x, train=True, seed=seed) ** 2).sum().backward()
        mask = tm._rank_mask(4, torch.float32, "cpu", seed)
        col_zero = (tm._p("lora_up.weight").grad == 0).all(dim=0)
        assert torch.equal(col_zero, mask == 0), seed


def test_merged_rank_dropout_masks_outdim_rows():
    tm = _noised(LokrModule, rank_dropout=0.5)
    got = tm.get_weight(train=True, seed=11)
    mask = tm._rank_mask(16, torch.float32, "cpu", 11)
    assert torch.equal((got == 0).all(dim=1), mask == 0)


# ---------------------------------------------------------------------------
# the route: training off or rates 0 leave today's forward bit for bit
# ---------------------------------------------------------------------------


def _net(algo, **rates):
    m = torch.nn.Sequential(torch.nn.Linear(32, 48))
    net = tl.create_lycoris(m, 1.0, 4, 2.0, algo=algo, factor=4, device="cpu", **rates)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.1)
    return m, net


@pytest.mark.parametrize("algo", ["lora", "lokr", "loha"])
def test_inference_and_zero_rates_keep_the_merged_forward(algo):
    x = torch.randn(3, 32, generator=torch.Generator().manual_seed(1))
    m0, net0 = _net(algo)
    m1, net1 = _net(algo, **RATES)
    m1.load_state_dict(m0.state_dict())
    net1.load_state_dict(net0.state_dict())
    net0.apply_to(merged_forward=True)
    net1.apply_to(merged_forward=True)
    lyco = net0.loras[0]
    w, b = m0[0].weight, m0[0].bias
    w_m, b_m = lyco.get_merged_weight(w, b)
    today = torch.nn.functional.linear(x, w_m, b_m)
    assert torch.equal(m0(x), today)
    assert torch.equal(m1(x), today)  # rates set, training off
    with net0.training_step(5):  # training, rates 0
        assert torch.equal(m0(x), today)
    with net1.training_step(5):  # training with dropout: the delta route
        out = m1(x)
    assert not torch.equal(out, today)
    assert torch.equal(m1(x), today)  # back outside the step
    assert net1._drop_seed is None


def test_training_draws_depend_on_seed_and_name_only():
    m, net = _net("lokr", **RATES)
    net.apply_to(merged_forward=True)
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(1))
    outs = {}
    for seed in (1, 2, 1):
        torch.manual_seed(seed + 100)  # the global generator plays no part
        with net.training_step(seed):
            outs.setdefault(seed, []).append(m(x))
    assert torch.equal(outs[1][0], outs[1][1])
    assert not torch.equal(outs[1][0], outs[2][0])


def test_trainer_seeds_its_drop_generator_from_its_generator():
    """The trainer's drop seeds come from a CPU generator of its own, seeded
    with the noise generator's seed: no knob of their own, and the noise
    generator's state is not drawn from by them."""
    for seed in (3, 4):
        m, net = _net("lokr", **RATES)
        gen = torch.Generator().manual_seed(seed)
        tr = DiffusionTrainer(m, net, weight_dtype=torch.float32, generator=gen)
        assert tr.drop_generator is not gen
        assert tr.drop_generator.initial_seed() == seed
        assert torch.equal(gen.get_state(), torch.Generator().manual_seed(seed).get_state())
        net.restore()


# ---------------------------------------------------------------------------
# the trainer: checkpointing, drop seeds, and parity with rates 0
# ---------------------------------------------------------------------------

TINY_SDXL = dict(block_out_channels=(32, 64), layers_per_block=1, transformer_depth=(0, 2),
                 mid_transformer_depth=2, context_dim=32, head_dim=16, norm_groups=8,
                 addition_embed_dim=16)


def _step_grads(m, net, start, batch, drop_seed):
    """The adapter gradients of one train step from the adapter values
    ``start``, with noise and timesteps from generator seed 0 and the drop
    seed drawn from ``drop_seed``."""
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(start[k])
    tr = DiffusionTrainer(m, net, lr=1e-3, weight_dtype=torch.float32,
                          generator=torch.Generator().manual_seed(0))
    tr.drop_generator.manual_seed(drop_seed)
    loss = tr.train_step(batch)
    return float(loss), torch.cat([p.grad.reshape(-1) for _, p in sorted(net.named_parameters())])


def test_checkpointing_draws_the_same_masks():
    """Tiny SDXL-shaped UNet, LoKr with rank and module dropout: one step's
    adapter gradients with remat="transformer" equal those without (the
    recompute in the backward draws the forward's masks); another drop seed
    gives other gradients."""
    m = tunet.UNet2DConditionModel(tunet.UNetConfig(**TINY_SDXL, remat="transformer"),
                                   device="cpu", generator=torch.Generator().manual_seed(0))
    tl.LycorisNetwork.apply_preset(ATTN_MLP)
    net = tl.create_lycoris(m, 1.0, 4, 2.0, algo="lokr", factor=4, rank_dropout=0.5,
                            module_dropout=0.3, device="cpu")
    g = torch.Generator().manual_seed(1)
    start = {k: p.detach() + torch.randn(p.shape, generator=g) * 0.05
             for k, p in net.named_parameters()}
    rng = np.random.default_rng(0)
    batch = {"latents": torch.tensor(_rand(rng, 2, 4, 8, 8)),
             "context": torch.tensor(_rand(rng, 2, 6, 32)),
             "added_cond": torch.tensor(_rand(rng, 2, 16))}
    calls = []
    hook = m.mid_block_attentions_0.register_forward_pre_hook(lambda *_: calls.append(1))
    loss, grads = _step_grads(m, net, start, batch, drop_seed=3)
    assert len(calls) == 2  # the forward, and the recompute in the backward
    m.cfg = dataclasses.replace(m.cfg, remat=False)
    calls.clear()
    loss0, grads0 = _step_grads(m, net, start, batch, drop_seed=3)
    assert len(calls) == 1
    hook.remove()
    np.testing.assert_allclose(loss, loss0, rtol=1e-5)
    assert float(grads0.abs().max()) > 0
    np.testing.assert_allclose(grads.numpy(), grads0.numpy(), rtol=1e-5,
                               atol=1e-5 * float(grads0.abs().max()))
    _, other = _step_grads(m, net, start, batch, drop_seed=4)
    assert float((other - grads0).norm() / grads0.norm()) > 1e-2


def test_train_step_with_zero_rates_matches_jax():
    """A train step (drop seed drawn, forward and backward inside
    training_step) on the tiny UNet with LoKr, all rates 0: its loss and
    adapter gradients match the JAX trainer's loss on the noise and
    timesteps the trainer's generator draws."""
    rng = np.random.default_rng(0)
    lat = _rand(rng, 2, 4, 8, 8)
    ctx = _rand(rng, 2, 6, 32)
    g = torch.Generator().manual_seed(0)
    noise = torch.randn(lat.shape, generator=g, dtype=torch.float32).numpy()
    t = torch.randint(0, 1000, (2,), generator=g).numpy().astype(np.int32)

    model = junet.UNet2DConditionModel(junet.tiny_unet_config())
    args = (jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx))
    variables = jax.jit(model.init)(jax.random.key(0), *args)
    graph = jl.ModelGraph.from_linen(model, variables, *args)
    jl.LycorisNetwork.apply_preset(ATTN_MLP)
    net = jl.create_lycoris(graph, 1.0, 4, 2.0, algo="lokr", factor=4, rng=jax.random.key(1))
    jl.LycorisNetwork.reset_preset()
    tree = net.params_tree()
    for ln, p in tree.items():
        for k in sorted(p):
            if k in net.lora_map[ln].trainable:
                p[k] = p[k] + jnp.asarray(_rand(rng, *p[k].shape, std=0.05))
    net.set_params_tree(tree)
    trainable = net.trainable_params()
    buffers = {ln: {k: v for k, v in net.lora_map[ln].params.items() if k not in sub}
               for ln, sub in trainable.items()}
    a = jnp.asarray(jax_acp(1000)[t]).reshape(-1, 1, 1, 1)
    noisy = jnp.sqrt(a) * jnp.asarray(lat) + jnp.sqrt(1 - a) * jnp.asarray(noise)

    def loss_fn(tr):
        full = {ln: {**buffers[ln], **sub} for ln, sub in tr.items()}
        pred = net({"params": variables["params"]}, noisy, jnp.asarray(t), jnp.asarray(ctx),
                   adapter_params=full, train=True, rng=jax.random.key(5), model=model,
                   merged_forward=True)
        return jnp.mean((pred.astype(jnp.float32) - jnp.asarray(noise)) ** 2)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(trainable)

    m = tunet.UNet2DConditionModel(tunet.tiny_unet_config(), device="cpu")
    m.load_state_dict(tunet.state_dict_from_jax(variables["params"]))
    sd = {k: torch.tensor(np.array(v)) for k, v in net.state_dict().items()}
    tnet, _ = tl.create_lycoris_from_weights(1.0, None, m, weights_sd=sd, device="cpu")
    tr = DiffusionTrainer(m, tnet, lr=1e-3, weight_dtype=torch.float32,
                          generator=torch.Generator().manual_seed(0))
    loss = float(tr.train_step({"latents": torch.tensor(lat), "context": torch.tensor(ctx)}))
    np.testing.assert_allclose(loss, float(want_loss), rtol=REL)
    got = np.concatenate([p.grad.numpy().ravel() for ln, sub in sorted(tnet.trainable_params().items())
                          for _, p in sorted(sub.items())])
    want = np.concatenate([np.asarray(want_grads[ln][k]).ravel() for ln in sorted(want_grads)
                           for k in sorted(want_grads[ln])])
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL * np.abs(want).max())
    assert np.linalg.norm(got - want) <= REL * np.linalg.norm(want)
