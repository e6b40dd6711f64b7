"""The serving slice as a whole: tiny UNet with nonzero LoKr / LoHa adapters
loaded from the JAX package's state dict, DDIM for 4 steps with CFG, port
vs JAX; and the full-width SD1.5 path traced on the meta device, which
shows the kernel dispatch counts the card run asserts.

Tolerance: 1e-4 (fp32; reduction order differs over 4 UNet calls).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lycoris_tpu as jl
import lycoris_tpu_torch as tl
from lycoris_tpu.models import unet as junet
from lycoris_tpu.sampler import make_ddim_sampler as jax_ddim
from lycoris_tpu_torch.models import unet as tunet
from lycoris_tpu_torch.ops import flash as tflash
from lycoris_tpu_torch.ops import group_norm as tgn
from lycoris_tpu_torch.ops import hada as thada
from lycoris_tpu_torch.ops import layer_norm as tln
from lycoris_tpu_torch.sampler import ddim_timesteps, ddpm_alphas_cumprod, make_ddim_sampler

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def reset_presets():
    yield
    jl.LycorisNetwork.reset_preset()
    tl.LycorisNetwork.reset_preset()


def test_schedules_match_jax():
    from lycoris_tpu import sampler as js
    from lycoris_tpu.trainer import ddpm_alphas_cumprod as jax_acp

    np.testing.assert_array_equal(ddpm_alphas_cumprod(1000), jax_acp(1000))
    for n in (4, 20, 50):
        np.testing.assert_array_equal(ddim_timesteps(n), js.ddim_timesteps(n))


@pytest.mark.parametrize("algo", ["lokr", "loha"])
def test_ddim_cfg_with_live_adapters_matches_jax(algo):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 6, 32)).astype(np.float32)
    unc = rng.standard_normal((2, 6, 32)).astype(np.float32) * 0.1

    model = junet.UNet2DConditionModel(junet.tiny_unet_config())
    t0 = jnp.zeros((2,), jnp.int32)
    variables = model.init(jax.random.key(0), jnp.asarray(x), t0, jnp.asarray(ctx))
    graph = jl.ModelGraph.from_linen(model, variables, jnp.asarray(x), t0, jnp.asarray(ctx))
    jl.LycorisNetwork.apply_preset({"target_module": ["Transformer2DModel"]})
    net = jl.create_lycoris(graph, 1.0, 4, 2.0, algo=algo, factor=4, rng=jax.random.key(1))
    jl.LycorisNetwork.reset_preset()
    # the zero-initialised factors get seeded nonzero values (dW != 0)
    tree = net.params_tree()
    for ln, p in tree.items():
        for k in sorted(p):
            if k in net.lora_map[ln].trainable:
                p[k] = p[k] + jnp.asarray(rng.standard_normal(p[k].shape).astype(np.float32) * 0.05)
    net.set_params_tree(tree)

    jsample = jax_ddim(
        lambda p, xx, tt, cc: net({"params": p}, xx, tt, cc, adapter_params=tree, model=model,
                                  merged_forward=True),
        num_inference_steps=4, guidance_scale=7.5,
    )
    want = jax.jit(jsample)(variables["params"], jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(unc))

    m = tunet.UNet2DConditionModel(tunet.tiny_unet_config(), device="cpu")
    m.load_state_dict(tunet.state_dict_from_jax(variables["params"]))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in net.state_dict().items()}
    tnet, _ = tl.create_lycoris_from_weights(1.0, None, m, weights_sd=sd, device="cpu")
    assert len(tnet.loras) == len(net.loras)
    tnet.apply_to(merged_forward=True)
    tsample = make_ddim_sampler(lambda xx, tt, cc: m(xx, tt, cc), num_inference_steps=4,
                                guidance_scale=7.5)
    got = tsample(*map(torch.from_numpy, (x, ctx, unc)))
    assert got.shape == x.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # the adapters move the result: the same sampler without them differs
    tnet.restore()
    base = tsample(*map(torch.from_numpy, (x, ctx, unc)))
    assert float((base - got).abs().max()) > 1e-3


def test_sd15_full_width_dispatch_counts_on_meta():
    """Full-width SD1.5 (bf16, batch 4 = 2 prompts with CFG, 64x64 latents)
    traced on the meta device: 10 flash self-attentions (T4096/D40 and
    T1024/D80), 48 LayerNorms, 61 GroupNorms (45 with SiLU: the resnets and
    conv_norm_out), 192 attn-mlp adapter targets."""
    m = tunet.UNet2DConditionModel(tunet.sd15_config(torch.bfloat16), device="meta",
                                   param_dtype=torch.bfloat16)
    assert sum(p.numel() for p in m.parameters()) == 859_520_964
    graph = tl.ModelGraph.from_torch(m)
    targets = [n for n in graph.nodes
               if n.is_leaf and not n.layer_info.is_norm and "_attentions_" in n.name]
    assert len(targets) == 16 * 10 + 16 * 2

    calls = {"flash": [], "ln": 0, "gn": []}

    def flash_spy(q, k, v, sm):
        calls["flash"].append(tuple(q.shape))
        return tflash.flash_attention_plain(q, k, v, sm)

    def ln_spy(x, w, b, eps):
        calls["ln"] += 1
        return tln.layer_norm_plain(x, w, b, eps)

    def gn_spy(x, num_groups, weight=None, bias=None, eps=1e-5, act=None):
        calls["gn"].append(act)
        return tgn.group_norm_plain(x, num_groups, weight, bias, eps, act)

    mp = pytest.MonkeyPatch()
    mp.setattr(tflash, "flash_attention", flash_spy)
    mp.setattr(tln, "layer_norm", ln_spy)
    mp.setattr(tgn, "group_norm_act", gn_spy)
    try:
        x = torch.empty(4, 4, 64, 64, device="meta", dtype=torch.bfloat16)
        t = torch.zeros(4, dtype=torch.int32, device="meta")
        ctx = torch.empty(4, 77, 768, device="meta", dtype=torch.bfloat16)
        with torch.no_grad():
            y = m(x, t, ctx)
    finally:
        mp.undo()
    assert y.shape == (4, 4, 64, 64) and y.dtype == torch.bfloat16
    assert calls["ln"] == 48
    assert len(calls["gn"]) == 61 and calls["gn"].count("silu") == 45
    assert sorted(calls["flash"]) == [(4, 8, 1024, 80)] * 5 + [(4, 8, 4096, 40)] * 5


def test_loha_dw_goes_through_the_hada_wrapper():
    """Every LoHa layer of the tiny UNet forms its dW through ops.hada where
    the JAX gate takes it (O >= 8, I >= 128) and the functional path otherwise."""
    m = tunet.UNet2DConditionModel(tunet.tiny_unet_config(), device="cpu")
    tl.LycorisNetwork.apply_preset({"target_module": ["Transformer2DModel"]})
    net = tl.create_lycoris(m, 1.0, 4, 2.0, algo="loha", device="cpu")
    tl.LycorisNetwork.reset_preset()
    seen = []
    real = thada.hada_weight
    mp = pytest.MonkeyPatch()
    mp.setattr(thada, "hada_weight", lambda *a: seen.append(a[1].shape) or real(*a))
    try:
        net.apply_to(merged_forward=True)
        with torch.no_grad():
            m(torch.randn(1, 4, 8, 8), torch.zeros(1, dtype=torch.int32), torch.randn(1, 6, 32))
    finally:
        mp.undo()
        net.restore()
    want = sum(1 for lyco in net.loras if lyco.shape[0] >= 8 and
               int(np.prod(lyco.shape[1:])) >= 128)
    assert want > 0 and len(seen) == want
