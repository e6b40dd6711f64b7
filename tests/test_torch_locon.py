"""LoRA/LoCon in the port against the JAX package: the functional API, the
module (linear, conv 3x3, tucker, ``use_scalar``, ``rs_lora``), a load from
the JAX module's state dict, the factored cotangents, and
``create_lycoris`` with no ``algo=`` (LoRA is the default) on the tiny UNet.

Inputs are drawn with numpy from a seed; torch gets its own copies
(``torch.tensor``), since a JAX CPU array may alias a numpy buffer.
Tolerance: fp32 atol/rtol 1e-5 per op (the ROADMAP's parity bound), 2e-4
relative for cotangents that sum over many tokens (as the JAX package's own
factored-grad tests), 1e-4 for whole-UNet outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lycoris_tpu as jl
import lycoris_tpu_torch as tl
from lycoris_tpu.functional import locon as jlocon
from lycoris_tpu.models import unet as junet
from lycoris_tpu.modules import base as jbase
from lycoris_tpu.modules.locon import LoConModule as JLoCon
from lycoris_tpu_torch.functional import locon as tlocon
from lycoris_tpu_torch.models import unet as tunet
from lycoris_tpu_torch.modules import LayerInfo, LoConModule

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=2e-4)
UNET_TOL = dict(atol=1e-4, rtol=1e-4)
ATTN_MLP = {"target_module": ["Transformer2DModel"]}


def _rand(rng, *shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), **(tol or TOL))


# ---------------------------------------------------------------------------
# functional API
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,tucker", [((24, 16), False), ((24, 16, 3, 3), False),
                                          ((24, 16, 3, 3), True), ((24, 16, 1, 1), True)])
def test_weight_gen_shapes_match_jax(shape, tucker):
    want = jlocon.weight_gen(jax.random.key(0), shape, 4, tucker=tucker)
    got = tlocon.weight_gen(shape, 4, tucker=tucker, generator=torch.Generator().manual_seed(0))
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert tuple(a.shape) == tuple(b.shape)
    down, up, _ = got
    assert float(up.abs().max()) == 0.0 and float(down.abs().max()) > 0.0


# (layer weight shape, down, up, mid, conv op arguments)
FUNCTIONAL_CASES = {
    "linear": ((24, 16), (4, 16), (24, 4), None, {}),
    "conv3x3": ((24, 16, 3, 3), (4, 16, 3, 3), (24, 4, 1, 1), None, dict(stride=2, padding=1)),
    "tucker": ((24, 16, 3, 3), (4, 16, 1, 1), (24, 4, 1, 1), (4, 4, 3, 3), dict(padding=1)),
}


@pytest.mark.parametrize("case", list(FUNCTIONAL_CASES))
def test_functional_diff_weight_and_bypass_match_jax(case):
    shape, ds, us, ms, kw = FUNCTIONAL_CASES[case]
    rng = np.random.default_rng(0)
    d, u = _rand(rng, *ds), _rand(rng, *us, std=0.3)
    m = None if ms is None else _rand(rng, *ms, std=0.3)
    x = _rand(rng, 2, 7, 16) if len(shape) == 2 else _rand(rng, 2, 16, 9, 9)
    _close(tlocon.diff_weight(_t(d), _t(u), _t(m), gamma=0.7),
           jlocon.diff_weight(_j(d), _j(u), _j(m), gamma=0.7))
    _close(tlocon.bypass_forward_diff(_t(x), None, _t(d), _t(u), _t(m), gamma=0.7, extra_args=kw),
           jlocon.bypass_forward_diff(_j(x), None, _j(d), _j(u), _j(m), gamma=0.7,
                                      extra_args=kw), atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

MODULE_CASES = {
    "linear": (dict(kind="linear"), dict()),
    "conv3x3": (dict(kind="conv", stride=2, padding=1), dict()),
    "tucker": (dict(kind="conv", stride=1, padding=1), dict(use_tucker=True)),
    "scalar": (dict(kind="linear"), dict(use_scalar=True)),
    "rs_lora": (dict(kind="conv", stride=1, padding=1), dict(rs_lora=True)),
}


def _layers(spec):
    if spec["kind"] == "linear":
        return LayerInfo.linear(24, 16), jbase.LayerInfo.linear(24, 16)
    kw = dict(stride=spec["stride"], padding=spec["padding"])
    return LayerInfo.conv(2, 24, 16, 3, **kw), jbase.LayerInfo.conv(2, 24, 16, 3, **kw)


def _pair(case, seed=0):
    """The JAX module and the port's module with the same seeded values in
    every trainable tensor (and a nonzero scalar under ``use_scalar``)."""
    spec, cfg = MODULE_CASES[case]
    tli, jli = _layers(spec)
    jm = JLoCon("t", jli, 0.8, 4, 3.0, rng=jax.random.key(1), **cfg)
    tm = LoConModule("t", tli, 0.8, 4, 3.0, generator=torch.Generator().manual_seed(1), **cfg)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for k in sorted(jm.trainable):
            v = _rand(rng, *np.shape(jm.params[k]), std=0.3)
            if k == "scalar":
                v = np.asarray(0.7, np.float32)
            jm.params[k] = jnp.asarray(v)
            tm._p(k).copy_(torch.tensor(v))
    assert set(tm.trainable) == set(jm.trainable)
    assert {k for k, _ in tm.named_parameters()} == set(jm.trainable)
    return tm, jm, tli, jli


@pytest.mark.parametrize("case", list(MODULE_CASES))
def test_module_matches_jax(case):
    tm, jm, tli, _ = _pair(case)
    assert tm.scale == pytest.approx(jm.scale, rel=1e-7) and tm.tucker == jm.tucker
    _close(tm.alpha, jm.params["alpha"])
    for k in ("lora_up.weight", "lora_down.weight", "lora_mid.weight"):
        assert (tm._p(k) is None) == (jm.params.get(k) is None)
        if tm._p(k) is not None:
            assert tuple(tm._p(k).shape) == tuple(jm.params[k].shape), k

    rng = np.random.default_rng(5)
    w, b = _rand(rng, *tli.shape, std=0.2), _rand(rng, 24, std=0.1)
    x = _rand(rng, 2, 7, 16) if tli.module_type == "linear" else _rand(rng, 2, 16, 9, 9)
    _close(tm.get_diff_weight(0.6)[0], jm.get_diff_weight(multiplier=0.6)[0])
    _close(tm.get_merged_weight(_t(w), _t(b), multiplier=0.6)[0],
           jm.get_merged_weight(_j(w), _j(b), multiplier=0.6)[0])
    # the delta-over-base forward and the bypass path
    _close(tm(_t(x), _t(w), _t(b), multiplier=0.6),
           jm.forward(_j(x), _j(w), _j(b), multiplier=0.6), atol=1e-5, rtol=1e-4)
    _close(tm.bypass_forward_diff(_t(x), scale=0.6),
           jm.bypass_forward_diff(_j(x), scale=0.6), atol=1e-5, rtol=1e-4)

    # the saved form folds the scalar into lora_up.weight
    jsd, tsd = jm.custom_state_dict(), tm.custom_state_dict()
    assert set(tsd) == set(jsd)
    for k in jsd:
        _close(tsd[k], jsd[k])


@pytest.mark.parametrize("case", list(MODULE_CASES))
def test_module_loads_the_jax_state_dict(case):
    """A JAX LoConModule's custom_state_dict, as numpy arrays, loads with the
    shapes re-inferred from the layer and gives the same merged weight."""
    _, jm, tli, _ = _pair(case, seed=3)
    sd = {k: np.array(v) for k, v in jm.custom_state_dict().items()}
    args = [sd.get(k) for k in LoConModule.weight_list]
    loaded = LoConModule.make_module_from_state_dict("t", tli, *args)
    assert loaded.tucker == jm.tucker and loaded.lora_dim == 4
    assert {k for k, _ in loaded.named_parameters()} <= set(jm.trainable)
    w = _rand(np.random.default_rng(4), *tli.shape, std=0.2)
    _close(loaded.get_merged_weight(_t(w))[0], jm.get_merged_weight(_j(w))[0])
    # and through the registry's detection (first hit: lora_up.weight)
    cls, params = tl.modules.get_module({f"t.{k}": v for k, v in sd.items()}, "t")
    assert cls is LoConModule
    mod = tl.modules.make_module(cls, params, "t", tli)
    _close(mod.get_merged_weight(_t(w))[0], jm.get_merged_weight(_j(w))[0])


@pytest.mark.parametrize("case", ["linear", "scalar"])
def test_factored_cotangents_match_jax(case):
    tm, jm, _, _ = _pair(case, seed=6)
    rng = np.random.default_rng(7)
    x, dy = _rand(rng, 30, 16), _rand(rng, 30, 24)
    t_recon, t_dtheta = tm.factored_merged_fns(0.6)
    j_recon, j_dtheta = jm.factored_merged_fns(0.6)
    _close(t_recon(tm.params), j_recon(jm.params))
    assert t_recon(tm.params, torch.bfloat16).dtype == torch.bfloat16
    got = t_dtheta(_t(x), _t(dy), tm.params)
    want = j_dtheta(_j(x), _j(dy), jm.params)
    assert set(got) == set(jm.trainable)
    for k in got:
        _close(got[k], want[k], **GRAD_TOL)


def test_factored_fns_decline_what_needs_autograd():
    tm, _, _, _ = _pair("conv3x3")
    assert tm.factored_merged_fns(1.0) is None
    assert _pair("tucker")[0].factored_merged_fns(1.0) is None
    assert _pair("linear")[0].factored_merged_fns(1.0) is not None


def test_unported_options_name_themselves():
    """DoRA is ported (tests/test_torch_dora.py): it builds a trainable
    ``dora_scale`` of the layer's row norms; the dropout trio is ported
    (tests/test_torch_dropout.py) and accepted: each rate is stored and
    changes the training forward of a bypass module, not its inference
    forward."""
    li = LayerInfo.linear(24, 16)
    dora = LoConModule("t", li, 1.0, 4, 1.0, weight_decompose=True,
                       org_weight=torch.randn(24, 16))
    scale = dict(dora.named_parameters())["dora_scale"]
    assert scale.requires_grad and tuple(scale.shape) == (24, 1)
    x, w = torch.randn(3, 16), torch.randn(24, 16)
    for what in ("dropout", "rank_dropout", "module_dropout"):
        m = LoConModule("t", li, 1.0, 4, 1.0, bypass_mode=True, **{what: 0.5})
        assert getattr(m, what) == 0.5
        with torch.no_grad():
            m._p("lora_up.weight").normal_()
        infer = m(x, w)
        assert torch.equal(m(x, w), infer)
        assert any(not torch.equal(m(x, w, train=True, seed=s), infer) for s in range(8)), what
    with pytest.raises(ValueError, match="not supported"):
        LoConModule("t", LayerInfo.layer_norm(16), 1.0, 4, 1.0)


# ---------------------------------------------------------------------------
# the default algorithm through create_lycoris on the tiny UNet
# ---------------------------------------------------------------------------


@pytest.fixture()
def reset_presets():
    yield
    jl.LycorisNetwork.reset_preset()
    tl.LycorisNetwork.reset_preset()


@pytest.mark.parametrize("preset", [ATTN_MLP, None], ids=["attn-mlp", "full"])
def test_create_lycoris_defaults_to_lora(reset_presets, preset):
    """No ``algo=``: both packages build LoCon modules with the same names and
    shapes. Under the full preset, which adapts the 3x3 convs too, with
    seeded factors the port's live adapters, both ways, and ``merge_to``
    give the JAX package's output."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.array([10, 500], np.int32)
    ctx = rng.standard_normal((2, 6, 32)).astype(np.float32)
    jx, jt, jc = _j(x), _j(t), _j(ctx)
    model = junet.UNet2DConditionModel(junet.tiny_unet_config())
    variables = model.init(jax.random.key(0), jx, jt, jc)
    graph = jl.ModelGraph.from_linen(model, variables, jx, jt, jc)
    if preset is not None:
        jl.LycorisNetwork.apply_preset(preset)
    jnet = jl.create_lycoris(graph, 1.0, 4, 2.0, rng=jax.random.key(1))
    m = tunet.UNet2DConditionModel(tunet.tiny_unet_config(), device="cpu")
    m.load_state_dict(tunet.state_dict_from_jax(variables["params"]))
    m.eval()
    if preset is not None:
        tl.LycorisNetwork.apply_preset(preset)
    tnet = tl.create_lycoris(m, 1.0, 4, 2.0)
    assert set(tnet.lora_map) == set(jnet.lora_map)
    assert all(type(lyco) is LoConModule for lyco in tnet.loras)
    assert tnet.algo_table == {"LoConModule": len(jnet.loras)}
    assert all(p.device.type == "cpu" for p in tnet.parameters())
    assert any(lyco.layer.is_conv and lyco.shape[2:] == (3, 3) for lyco in tnet.loras) == (
        preset is None)
    jsd, tsd = jnet.state_dict(), tnet.state_dict()
    assert set(jsd) == set(tsd)
    for k in jsd:
        assert tuple(tsd[k].shape) == tuple(np.shape(jsd[k])), k
    if preset is not None:
        return

    tree = jnet.params_tree()
    for ln, p in tree.items():
        for k in sorted(p):
            if k in jnet.lora_map[ln].trainable:
                p[k] = p[k] + jnp.asarray(rng.standard_normal(p[k].shape).astype(np.float32) * 0.05)
    jnet.set_params_tree(tree)
    sd = {k: _t(v) for k, v in jnet.state_dict().items()}
    tnet, _ = tl.create_lycoris_from_weights(1.0, None, m, weights_sd=sd, device="cpu")
    tx, tt, tc = _t(x), _t(t), _t(ctx)
    for merged in (True, False):
        want = jnet(variables, jx, jt, jc, adapter_params=tree, model=model, merged_forward=merged)
        tnet.apply_to(merged_forward=merged)
        with torch.no_grad():
            got = m(tx, tt, tc)
        tnet.restore()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **UNET_TOL)
    tnet.merge_to(1.0)
    with torch.no_grad():
        got = m(tx, tt, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **UNET_TOL)
