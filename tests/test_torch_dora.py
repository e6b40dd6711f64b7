"""DoRA (``dora_wd`` / ``weight_decompose``) in the port against the JAX
package: the norm helpers, each module's merged weight and delta forward
(LoCon on a linear layer and a 3x3 conv, LoHa, LoKr, each with
``wd_on_out`` True and False), ``dora_scale``'s init and file round trip,
the tiny UNet through ``create_lycoris(dora_wd=True)`` on the merged and the
delta route against the JAX interceptor, and one trainer step's loss and
adapter gradients (``dora_scale`` included) against the JAX trainer's.

Tolerance: fp32 1e-5 per op (the ROADMAP's parity bound), 1e-4 relative
for whole-UNet outputs, losses and gradients (as tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lycoris_tpu as jl
import lycoris_tpu_torch as tl
import torch_parity as tp
from lycoris_tpu.functional import general as jgeneral
from lycoris_tpu.modules import base as jbase
from lycoris_tpu.modules.base import LayerInfo as JLayerInfo
from lycoris_tpu.modules.locon import LoConModule as JLoCon
from lycoris_tpu.modules.loha import LohaModule as JLoha
from lycoris_tpu.modules.lokr import LokrModule as JLokr
from lycoris_tpu_torch.functional import general as tgeneral
from lycoris_tpu_torch.modules import LayerInfo, LoConModule, LohaModule, LokrModule
from lycoris_tpu_torch.modules import base as tbase

TOL = dict(atol=1e-5, rtol=1e-5)
REL = 1e-4
# LoKr factor 4 keeps w2 factored at these widths, so its file keeps alpha
SHAPES = [(64, 48), (64, 48, 3, 3)]
MODULES = {"locon": (JLoCon, LoConModule), "loha": (JLoha, LohaModule),
           "lokr": (JLokr, LokrModule)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny UNet runs as fast on one intra-op thread, and the parallel
    test workers then do not oversubscribe the cores (many threads each
    spinning on small ops made these tests some 50x slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def reset_presets():
    yield
    jl.LycorisNetwork.reset_preset()
    tl.LycorisNetwork.reset_preset()


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), **(tol or TOL))


def _layers(shape):
    if len(shape) == 2:
        return JLayerInfo.linear(*shape), LayerInfo.linear(*shape)
    o, i, *k = shape
    return (JLayerInfo.conv(2, o, i, tuple(k), padding=1),
            LayerInfo.conv(2, o, i, tuple(k), padding=1))


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("wd_on_out", [True, False])
def test_dora_helpers_match_jax(shape, wd_on_out):
    rng = np.random.default_rng(0)
    w = rng.standard_normal(shape).astype(np.float32)
    d = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    want_init = jbase.init_dora_scale(jnp.asarray(w), wd_on_out)
    got_init = tbase.init_dora_scale(torch.tensor(w), wd_on_out)
    assert got_init.dtype == torch.float32 and tuple(got_init.shape) == want_init.shape
    _close(got_init, want_init)
    scale = got_init * 1.3
    for mult in (1.0, 0.7):
        _close(tbase.apply_weight_decompose(torch.tensor(w + d), scale, wd_on_out, mult),
               jbase.apply_weight_decompose(jnp.asarray(w + d), jnp.asarray(scale.numpy()),
                                            wd_on_out, mult))
    fn_t = tgeneral.apply_dora_scale_on_out if wd_on_out else tgeneral.apply_dora_scale
    fn_j = jgeneral.apply_dora_scale_on_out if wd_on_out else jgeneral.apply_dora_scale
    _close(fn_t(torch.tensor(w), torch.tensor(d), scale, 0.6),
           fn_j(jnp.asarray(w), jnp.asarray(d), jnp.asarray(scale.numpy()), 0.6))


def test_dora_eps_is_that_of_the_scale_dtype():
    """A bf16 weight is cast to dora_scale's fp32 before its norm, and the
    eps is fp32's (JAX base.py:183-185): a zero row stays zero, not NaN."""
    w = torch.zeros(4, 8, dtype=torch.bfloat16)
    w[1:] = 1.0
    scale = torch.ones(4, 1)
    out = tbase.apply_weight_decompose(w, scale, True)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    want = jbase.apply_weight_decompose(jnp.asarray(w.float().numpy()).astype(jnp.bfloat16),
                                        jnp.ones((4, 1)), True)
    _close(out, want)


@pytest.mark.parametrize("shape,out_dim,want", [
    ((24, 1), 24, True), ((1, 16), 24, False), ((24, 1, 1, 1), 24, True),
    ((1, 16, 1, 1), 24, False), ((1, 1), 1, True), ((), 24, True)])
def test_infer_wd_on_out_matches_jax(shape, out_dim, want):
    x = np.zeros(shape, np.float32)
    assert tbase.infer_wd_on_out(torch.tensor(x), out_dim) == want
    assert jbase.infer_wd_on_out(jnp.asarray(x), out_dim) == want


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


def _pair(algo, shape, wd_on_out, seed=0):
    """A JAX DoRA module with every tensor moved off its init, and the
    port's module made from its state dict."""
    rng = np.random.default_rng(seed)
    jli, tli = _layers(shape)
    w = rng.standard_normal(shape).astype(np.float32)
    jcls, tcls = MODULES[algo]
    jm = jcls("t", jli, 1.0, 4, 2.0, weight_decompose=True, wd_on_out=wd_on_out,
              factor=4, rng=jax.random.key(seed), org_weight=jnp.asarray(w))
    for k in sorted(jm.trainable):
        jm.params[k] = jm.params[k] + jnp.asarray(
            rng.standard_normal(jm.params[k].shape).astype(np.float32) * 0.2)
    sd = {f"t.{k}": np.asarray(v) for k, v in jm.custom_state_dict().items()}
    assert "t.dora_scale" in sd
    ttype, params = tl.modules.get_module(sd, "t")
    assert ttype is tcls
    tm = tl.modules.make_module(ttype, [None if p is None else torch.tensor(p) for p in params],
                                "t", tli)
    return jm, tm, w, rng


@pytest.mark.parametrize("algo", list(MODULES))
@pytest.mark.parametrize("wd_on_out", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_module_merged_and_delta_match_jax(algo, wd_on_out, shape):
    jm, tm, w, rng = _pair(algo, shape, wd_on_out)
    assert tm.wd and tm.wd_on_out == wd_on_out and "dora_scale" in tm.trainable
    assert tm._p("dora_scale").requires_grad
    _close(tm._p("dora_scale"), jm.params["dora_scale"])
    wt = torch.tensor(w)
    for mult in (1.0, 0.5):
        _close(tm.get_merged_weight(wt, multiplier=mult)[0],
               jm.get_merged_weight(jnp.asarray(w), multiplier=mult)[0])
    x = rng.standard_normal((2, shape[1], 6, 6) if len(shape) == 4 else (3, shape[1]))
    x = x.astype(np.float32)
    want = jm.forward(jnp.asarray(x), org_weight=jnp.asarray(w), multiplier=0.8)
    # an output sums I * k products of O(1) terms: 1e-5 of its largest magnitude
    _close(tm(torch.tensor(x), wt, multiplier=0.8), want, rtol=1e-5,
           atol=1e-5 * float(jnp.abs(want).max()))
    got = {k: v for k, v in tm.custom_state_dict().items()}
    want = jm.custom_state_dict()
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("algo", list(MODULES))
@pytest.mark.parametrize("wd_on_out", [True, False])
def test_module_init_takes_the_layer_weight(algo, wd_on_out):
    """``dora_scale`` starts at the layer weight's row (or column) norms,
    fp32 and trainable, as in the JAX module; without a weight, at zeros."""
    w = np.random.default_rng(3).standard_normal((24, 16)).astype(np.float32)
    jcls, tcls = MODULES[algo]
    jm = jcls("t", JLayerInfo.linear(24, 16), 1.0, 4, 2.0, weight_decompose=True,
              wd_on_out=wd_on_out, factor=4, org_weight=jnp.asarray(w))
    tm = tcls("t", LayerInfo.linear(24, 16), 1.0, 4, 2.0, weight_decompose=True,
              wd_on_out=wd_on_out, factor=4,
              org_weight=torch.tensor(w).to(torch.bfloat16).float())
    s = tm._p("dora_scale")
    assert isinstance(s, torch.nn.Parameter) and s.dtype == torch.float32
    assert tuple(s.shape) == ((24, 1) if wd_on_out else (1, 16))
    _close(s, jm.params["dora_scale"], atol=1e-2, rtol=1e-2)  # the bf16 copy of w
    assert not torch.any(tcls("t", LayerInfo.linear(24, 16), 1.0, 4, 2.0,
                              weight_decompose=True, factor=4)._p("dora_scale"))


@pytest.mark.parametrize("algo", ["locon", "lokr"])  # LoHa has no factored backward
def test_factored_fns_decline_dora(algo):
    _, tm, _, _ = _pair(algo, SHAPES[0], True)
    assert tm.factored_merged_fns(1.0) is None
    plain = MODULES[algo][1]("t", LayerInfo.linear(*SHAPES[0]), 1.0, 4, 2.0, factor=4)
    assert plain.factored_merged_fns(1.0) is not None


# ---------------------------------------------------------------------------
# the tiny UNet: create_lycoris(dora_wd=True), the routes, the trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["lokr", "loha"])
def test_create_lycoris_dora_matches_jax(algo):
    """The port's ``create_lycoris(dora_wd=True)`` initialises every
    ``dora_scale`` from its layer's weight as the JAX package does (both on
    the same weights); with the factors of the JAX network loaded, the tiny
    UNet's output through the merged and the delta route equals the JAX
    interceptor's (``merged_forward`` True and False)."""
    model, variables, graph, d = tp.jax_unet()
    jl.LycorisNetwork.apply_preset(tp.ATTN_MLP)
    jnet = jl.create_lycoris(graph, 1.0, 4, 2.0, algo=algo, factor=4, dora_wd=True,
                             rng=jax.random.key(1))
    m = tp.port_unet(variables)
    tl.LycorisNetwork.apply_preset(tp.ATTN_MLP)
    tnet = tl.create_lycoris(m, 1.0, 4, 2.0, algo=algo, factor=4, dora_wd=True, device="cpu")
    assert set(tnet.lora_map) == set(jnet.lora_map)
    for ln, lyco in tnet.lora_map.items():
        assert lyco.wd and "dora_scale" in dict(lyco.named_parameters())
        _close(lyco._p("dora_scale"), jnet.lora_map[ln].params["dora_scale"])

    _, _, jnet, m, tnet, d = tp.setup(algo, dora_wd=True)
    args = tuple(jnp.asarray(d[k]) for k in ("lat", "t", "ctx"))
    targs = tuple(torch.tensor(d[k]) for k in ("lat", "t", "ctx"))
    for merged in (True, False):
        want = jnet({"params": variables["params"]}, *args, model=model, merged_forward=merged)
        tnet.apply_to(merged_forward=merged)
        with torch.no_grad():
            got = m(*targs)
        tnet.restore()
        _close(got, want, atol=REL, rtol=REL)


@pytest.mark.parametrize("algo,wd_on_out", [("loha", True), ("lokr", False), ("lora", True)])
def test_trainer_loss_and_grads_match_jax(algo, wd_on_out):
    """One trainer loss and every adapter gradient, ``dora_scale`` included,
    against the JAX trainer's loss (merged forward) on the same numpy noise
    and timesteps."""
    model, variables, net, m, tnet, d = tp.setup(algo, dora_wd=True, wd_on_output=wd_on_out)
    want_loss, want_grads = tp.jax_loss_and_grads(model, variables, net, d)
    assert all("dora_scale" in sub for sub in want_grads.values())
    _, loss, grads = tp.port_loss_and_grads(m, tnet, d)
    np.testing.assert_allclose(loss, float(want_loss), rtol=REL)
    tp.assert_trees_close(grads, want_grads, REL)
