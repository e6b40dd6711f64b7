"""The other algorithms of the port against the JAX package: the functional
Diag-OFT and BOFT (the Cayley transform against the JAX Gauss-Jordan, with
and without the COFT constraint and the rescale, linear and conv layouts,
``need_transpose``, BOFT's dense and chain forms), and the seven modules
Diag-OFT, BOFT, (IA)^3, GLoRA, DyLoRA, Full and Norm: the zero-init no-op,
merged == delta == bypass where a bypass exists, a load from the JAX
module's state dict, and the output and gradients against ``jax.grad``.

Inputs are drawn with numpy from a seed; torch gets its own copies
(``torch.tensor``), since a JAX CPU array may alias a numpy buffer.
Last, one trainer step's loss and adapter gradients on the tiny UNet for
Diag-OFT, BOFT, Full and DyLoRA against the JAX trainer's.

Tolerance: fp32 atol/rtol 1e-5 per op (the ROADMAP's parity bound); an
output or gradient that sums many products is held to 1e-5 of its largest
magnitude; 1e-4 relative for whole-UNet losses and gradients (as
tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lycoris_tpu as jl
import lycoris_tpu_torch as tl
import torch_parity as tp
from lycoris_tpu.functional import boft as jboft
from lycoris_tpu.functional import diag_oft as jdiag
from lycoris_tpu.modules import boft as jmboft
from lycoris_tpu.modules import get_module as jget_module
from lycoris_tpu.modules import diag_oft as jmdiag
from lycoris_tpu.modules import dylora as jmdylora
from lycoris_tpu.modules import full as jmfull
from lycoris_tpu.modules import glora as jmglora
from lycoris_tpu.modules import ia3 as jmia3
from lycoris_tpu.modules import norms as jmnorms
from lycoris_tpu.modules.base import LayerInfo as JLayerInfo
from lycoris_tpu_torch.functional import boft as tboft
from lycoris_tpu_torch.functional import diag_oft as tdiag
from lycoris_tpu_torch.modules import (ButterflyOFTModule, DiagOFTModule, DyLoraModule,
                                       FullModule, GLoRAModule, IA3Module, LayerInfo, NormModule)

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(rng, *shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def _close(got, want, scale=False):
    want = np.asarray(want)
    atol = 1e-5 * max(float(np.abs(want).max()), 1.0) if scale else 1e-5
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).detach()), want, rtol=1e-5,
                               atol=atol)


# ---------------------------------------------------------------------------
# functional Diag-OFT and BOFT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 4, 4), (3, 8, 16, 16), (40, 10, 10)])
@pytest.mark.parametrize("constraint", [None, 0, 0.5, 50.0])
def test_get_r_matches_jax_gauss_jordan(shape, constraint):
    """R = (I + Q)(I - Q)^-1 from ``inv_ex`` against the JAX pivot-free
    Gauss-Jordan, with the COFT rescale active (0.5: |Q| above it), idle
    (50) and off (None, 0); R is orthogonal."""
    blocks = _rand(np.random.default_rng(0), *shape, std=0.3)
    want = jdiag.get_r(jnp.asarray(blocks), constraint=constraint)
    got = tdiag.get_r(torch.tensor(blocks), constraint=constraint)
    _close(got, want)
    eye = torch.eye(shape[-1]).expand_as(got)
    _close(got @ got.transpose(-1, -2), eye.numpy())


def _oft_weights(rng, kind, out_dim, ndim, rescale):
    if kind == "diag":
        blocks, _ = tdiag.weight_gen((out_dim, 1), 4)
    else:
        blocks, _ = tboft.weight_gen((out_dim, 1), 4)
    blocks = _rand(rng, *blocks.shape, std=0.2)
    rs = _rand(rng, out_dim, *[1] * (ndim - 1), std=0.1) + 1 if rescale else None
    return blocks, rs


@pytest.mark.parametrize("kind", ["diag", "boft"])
@pytest.mark.parametrize("shape", [(32, 24), (32, 8, 3, 3), (32, 64)])
@pytest.mark.parametrize("rescale", [False, True])
@pytest.mark.parametrize("constraint", [None, 1e-2])
def test_oft_diff_weight_matches_jax(kind, shape, rescale, constraint):
    """dW of a linear and a conv weight (BOFT's chain form where the columns
    are fewer than out_dim, the dense one otherwise)."""
    rng = np.random.default_rng(1)
    blocks, rs = _oft_weights(rng, kind, shape[0], len(shape), rescale)
    w = _rand(rng, *shape)
    jf, tf = (jdiag, tdiag) if kind == "diag" else (jboft, tboft)
    c = None if constraint is None else constraint * shape[0]
    want = jf.diff_weight(jnp.asarray(w), jnp.asarray(blocks),
                          None if rs is None else jnp.asarray(rs), constraint=c)
    got = tf.diff_weight(torch.tensor(w), torch.tensor(blocks),
                         None if rs is None else torch.tensor(rs), constraint=c)
    _close(got, want, scale=True)


@pytest.mark.parametrize("kind", ["diag", "boft"])
@pytest.mark.parametrize("out_shape,transpose", [((5, 7, 32), False), ((2, 32, 6, 6), True),
                                                 ((40, 32), False)])
@pytest.mark.parametrize("rescale", [False, True])
def test_oft_bypass_matches_jax(kind, out_shape, transpose, rescale):
    """The rotation of base outputs, features last or on axis 1
    (``need_transpose``), both BOFT forms by row count."""
    rng = np.random.default_rng(2)
    ndim = 4 if transpose else 2
    blocks, rs = _oft_weights(rng, kind, 32, ndim, rescale)
    out = _rand(rng, *out_shape)
    jf, tf = (jdiag, tdiag) if kind == "diag" else (jboft, tboft)
    want = jf.bypass_forward_diff(jnp.asarray(out), jnp.asarray(blocks),
                                  None if rs is None else jnp.asarray(rs), constraint=0.3,
                                  need_transpose=transpose)
    got = tf.bypass_forward_diff(torch.tensor(out), torch.tensor(blocks),
                                 None if rs is None else torch.tensor(rs), constraint=0.3,
                                 need_transpose=transpose)
    _close(got, want, scale=True)


@pytest.mark.parametrize("shape", [(64, 16), (64, 128), (64, 8, 3, 3)])
def test_boft_forms_agree(shape):
    """Q = chain(I) applied by one matmul equals the direct chain, front and
    last, in value and gradient; the shape rule picks dense exactly where
    the columns reach out_dim; ``dense_rotation`` matches JAX's."""
    rng = np.random.default_rng(3)
    blocks = torch.tensor(_rand(rng, 5, 16, 4, 4, std=0.2), requires_grad=True)
    w = torch.tensor(_rand(rng, *shape))
    cols = int(np.prod(shape[1:]))
    assert tboft.use_dense(shape, 64, False) == (cols >= 64)
    outs, grads = [], []
    for dense in (True, False):
        blocks.grad = None
        r = tboft._scaled_r(blocks, 0.5, 0.7)
        flat = w.reshape(64, -1)
        out = (tboft.dense_rotation(r) @ flat if dense else tboft._chain(flat, r))
        out.square().sum().backward()
        outs.append(out.detach().reshape(w.shape))
        grads.append(blocks.grad.clone())
    _close(outs[0], outs[1].numpy(), scale=True)
    _close(grads[0], grads[1].numpy(), scale=True)
    # rotate_front takes the form the rule picks, checkpointed, and agrees
    _close(tboft.rotate_front(w, blocks, 0.5, 0.7), outs[0].numpy(), scale=True)
    x = w.reshape(64, -1).T.contiguous()
    _close(tboft.rotate_last(x, blocks, 0.5, 0.7), outs[1].reshape(64, -1).T.numpy(), scale=True)
    r = tboft._scaled_r(blocks.detach(), None, 1.0)
    _close(tboft.dense_rotation(r), jboft.dense_rotation(jnp.asarray(r.numpy())))


def test_boft_rotation_is_checkpointed():
    """Under grad the rotation runs in a checkpoint: the saved tensors of the
    graph are the inputs (the blocks and the weight), not the m stages."""
    rng = np.random.default_rng(4)
    blocks = torch.tensor(_rand(rng, 5, 16, 4, 4, std=0.2), requires_grad=True)
    w = torch.tensor(_rand(rng, 64, 16))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                                                  lambda t: t):
        tboft.rotate_front(w, blocks)
    assert set(saved) <= {tuple(blocks.shape), tuple(w.shape)}, saved


@pytest.mark.parametrize("out_dim,dim,want", [(1280, 16, (10, 128, 8)), (10240, 16, (10, 1024, 11)),
                                              (640, 16, (10, 64, 7)), (1280, 8, None)])
def test_boft_factorisation_at_sd_widths(out_dim, dim, want):
    """Blocks of 10 and up to 11 stages at SD widths for dim 16; dim 8 has
    no BOFT factorisation, in both packages."""
    li, jli = LayerInfo.linear(out_dim, 4), JLayerInfo.linear(out_dim, 4)
    if want is None:
        with pytest.raises(ValueError):
            ButterflyOFTModule("t", li, 1.0, dim)
        with pytest.raises(ValueError):
            jmboft.ButterflyOFTModule("t", jli, 1.0, dim)
        return
    m = ButterflyOFTModule("t", li, 1.0, dim)
    assert (m.boft_b, m.block_num, m.boft_m) == want
    assert tuple(m._p("oft_blocks").shape) == (want[2], want[1], want[0], want[0])


# ---------------------------------------------------------------------------
# the seven modules
# ---------------------------------------------------------------------------

# algo -> (JAX class, port class, constructor kwargs, layers it takes)
WEIGHTED = ["linear", "conv"]
MODULES = {
    "diag-oft": (jmdiag.DiagOFTModule, DiagOFTModule, dict(constraint=1e-3, rescaled=True),
                 WEIGHTED),
    "diag-oft-plain": (jmdiag.DiagOFTModule, DiagOFTModule, {}, WEIGHTED),
    "boft": (jmboft.ButterflyOFTModule, ButterflyOFTModule, dict(constraint=1e-3, rescaled=True),
             WEIGHTED),
    "boft-plain": (jmboft.ButterflyOFTModule, ButterflyOFTModule, {}, WEIGHTED),
    "ia3": (jmia3.IA3Module, IA3Module, {}, WEIGHTED),
    "ia3-input": (jmia3.IA3Module, IA3Module, dict(train_on_input=True), WEIGHTED),
    "glora": (jmglora.GLoRAModule, GLoRAModule, {}, WEIGHTED),
    "glora-scalar": (jmglora.GLoRAModule, GLoRAModule, dict(use_scalar=True), WEIGHTED),
    "dylora": (jmdylora.DyLoraModule, DyLoraModule, dict(block_size=2), WEIGHTED),
    "full": (jmfull.FullModule, FullModule, {}, WEIGHTED),
    "norm": (jmnorms.NormModule, NormModule, {}, ["layernorm", "groupnorm", "groupnorm-silu",
                                                   "rmsnorm"]),
}
BYPASS = {"diag-oft", "diag-oft-plain", "boft", "boft-plain", "ia3", "ia3-input", "glora",
          "glora-scalar", "dylora"}
CASES = [(a, k) for a, (_, _, _, kinds) in MODULES.items() for k in kinds]


def _layer(kind, bias=True):
    """(JAX LayerInfo, port LayerInfo, weight shape, input shape)."""
    if kind == "linear":
        return JLayerInfo.linear(32, 24, bias), LayerInfo.linear(32, 24, bias), (32, 24), (3, 5, 24)
    if kind == "conv":
        args = (2, 32, 16, (3, 3))
        return (JLayerInfo.conv(*args, padding=1, bias=bias),
                LayerInfo.conv(*args, padding=1, bias=bias), (32, 16, 3, 3), (2, 16, 6, 6))
    if kind == "layernorm":
        return (JLayerInfo.layer_norm(48, bias=bias), LayerInfo.layer_norm(48, bias=bias), (48,),
                (3, 5, 48))
    if kind == "rmsnorm":
        return JLayerInfo.rms_norm(48), LayerInfo.rms_norm(48), (48,), (3, 5, 48)
    act = "silu" if kind == "groupnorm-silu" else None
    return (JLayerInfo.group_norm(8, 32, bias=bias, act=act),
            LayerInfo.group_norm(8, 32, bias=bias, act=act), (32,), (2, 32, 5, 5))


def _jax_module(algo, kind, bias=True, seed=0):
    """The JAX module with its trainable tensors moved off their init, its
    layer's weight and bias, and an input, all from numpy seed ``seed``."""
    jcls, _, kw, _ = MODULES[algo]
    jli, tli, wshape, xshape = _layer(kind, bias)
    rng = np.random.default_rng(seed)
    w = _rand(rng, *wshape) + (1.0 if jli.is_norm else 0.0)
    b = _rand(rng, wshape[0], std=0.1) if bias and jli.has_bias else None
    if algo == "norm":
        jm = jcls("t", jli, 1.0)
    else:
        jm = jcls("t", jli, 1.0, 4, 2.0, rng=jax.random.key(seed), org_weight=jnp.asarray(w),
                  **kw)
    for k in sorted(jm.trainable):
        jm.params[k] = jm.params[k] + jnp.asarray(_rand(rng, *jm.params[k].shape, std=0.1))
    x = _rand(rng, *xshape)
    return jm, tli, w, b, x


def _port_module(algo, jm, tli):
    """The port's module from the JAX module's state dict; by copying its
    tensors for DyLoRA, whose files load as LoCon, and for GLoRA with
    ``use_scalar``, whose files fold the scalar in."""
    _, tcls, kw, _ = MODULES[algo]
    if algo in ("dylora", "glora-scalar"):
        tm = tcls("t", tli, 1.0, 4, 2.0, **kw)
        for k, v in jm.params.items():
            tm._set(k, torch.tensor(np.asarray(v)).reshape(tm._p(k).shape))
        return tm
    sd = {f"t.{k}": np.asarray(v) for k, v in jm.custom_state_dict().items()}
    ttype, params = tl.modules.get_module(sd, "t")
    assert ttype is tcls
    return tl.modules.make_module(ttype, [None if p is None else torch.tensor(p) for p in params],
                                  "t", tli)


def _jax_forward(jm, x, w, b, params=None, mult=0.8):
    return jm.forward(jnp.asarray(x), org_weight=jnp.asarray(w),
                      org_bias=None if b is None else jnp.asarray(b), params=params,
                      multiplier=mult)


def _port_forward(tm, x, w, b, mult=0.8):
    return tm(torch.tensor(x), torch.tensor(w), None if b is None else torch.tensor(b),
              multiplier=mult)


@pytest.mark.parametrize("algo,kind", CASES)
def test_zero_init_is_a_no_op(algo, kind):
    """A fresh module leaves the layer's output as it is, on every route."""
    _, tcls, kw, _ = MODULES[algo]
    _, tli, wshape, xshape = _layer(kind)
    rng = np.random.default_rng(5)
    w = torch.tensor(_rand(rng, *wshape))
    b = torch.tensor(_rand(rng, wshape[0]))
    x = torch.tensor(_rand(rng, *xshape))
    args = () if algo == "norm" else (4, 2.0)
    tm = tcls("t", tli, 1.0, *args, generator=torch.Generator().manual_seed(0), org_weight=w,
              **kw)
    base = tli.op(x, w, b)
    torch.testing.assert_close(tm(x, w, b), base, **TOL)
    w_m, b_m = tm.get_merged_weight(w, b)
    torch.testing.assert_close(tli.op(x, w_m, b_m), base, **TOL)
    if algo in BYPASS:
        tm.bypass_mode = True
        torch.testing.assert_close(tm(x, w, b), base, **TOL)


@pytest.mark.parametrize("algo,kind", CASES)
def test_module_matches_jax(algo, kind):
    """The port's module loaded from the JAX module's state dict: the same
    trainable set, state dict, merged weight and bias (multipliers 1 and
    0.6), delta forward and, where it exists, bypass forward."""
    jm, tli, w, b, x = _jax_module(algo, kind)
    tm = _port_module(algo, jm, tli)
    assert set(dict(tm.named_parameters())) == set(jm.trainable)
    got_sd, want_sd = tm.custom_state_dict(), jm.custom_state_dict()
    assert set(got_sd) == set(want_sd)
    for k in want_sd:
        _close(got_sd[k].float(), np.asarray(want_sd[k], np.float32))
    for mult in (1.0, 0.6):
        got_w, got_b = tm.get_merged_weight(torch.tensor(w), None if b is None else torch.tensor(b),
                                            multiplier=mult)
        want_w, want_b = jm.get_merged_weight(jnp.asarray(w), None if b is None else jnp.asarray(b),
                                              multiplier=mult)
        _close(got_w, want_w, scale=True)
        assert (got_b is None) == (want_b is None)
        if want_b is not None:
            _close(got_b, want_b)
    _close(_port_forward(tm, x, w, b), _jax_forward(jm, x, w, b), scale=True)
    if algo in BYPASS:
        tm.bypass_mode = jm.bypass_mode = True
        _close(_port_forward(tm, x, w, b), _jax_forward(jm, x, w, b), scale=True)


@pytest.mark.parametrize("algo,kind", [c for c in CASES if c[0] in BYPASS])
def test_merged_delta_and_bypass_agree(algo, kind):
    """On a layer without a bias (the OFT and IA3 bypasses act on the whole
    output, bias included), the merged weight's op, the delta forward and
    the bypass forward are one function."""
    jm, tli, w, _, x = _jax_module(algo, kind, bias=False)
    tm = _port_module(algo, jm, tli)
    wt, xt = torch.tensor(w), torch.tensor(x)
    # the OFT bypass scales the rescaled delta, the merged route rescales the
    # blended rotation: one function at multiplier 1
    mult = 1.0 if "oft" in algo else 0.8
    merged = tli.op(xt, tm.get_merged_weight(wt, multiplier=mult)[0])
    delta = tm(xt, wt, multiplier=mult)
    tm.bypass_mode = True
    bypass = tm(xt, wt, multiplier=mult)
    scale = float(merged.detach().abs().max())
    for got in (delta, bypass):
        torch.testing.assert_close(got, merged, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("algo,kind", CASES)
def test_gradients_match_jax(algo, kind):
    """d/d(trainable) of <forward(x), g> on the delta route (and the bypass
    where it exists) against ``jax.grad``."""
    jm, tli, w, b, x = _jax_module(algo, kind)
    tm = _port_module(algo, jm, tli)
    out = _jax_forward(jm, x, w, b)
    g = _rand(np.random.default_rng(9), *out.shape)
    modes = [False, True] if algo in BYPASS else [False]
    for bypass in modes:
        tm.bypass_mode = jm.bypass_mode = bypass
        tr = jm.trainable_params()

        def loss(p):
            full = {**jm.params, **p}
            return jnp.sum(_jax_forward(jm, x, w, b, params=full) * jnp.asarray(g))

        want = jax.grad(loss)(tr)
        tm.zero_grad(set_to_none=True)
        (_port_forward(tm, x, w, b) * torch.tensor(g)).sum().backward()
        got = dict(tm.named_parameters())
        assert set(got) == set(want)
        for k in want:
            _close(got[k].grad, want[k], scale=True)


@pytest.mark.parametrize("algo", list(MODULES)[:-1])
def test_merged_conv_weight_keeps_standard_strides(algo):
    """A merged 1x1-conv weight has the layer's own (O, I, 1, 1) strides: an
    einsum's permuted result reads as channels-last, and cuDNN then returns
    channels-last outputs and gradients (GroupNorm copies on the card)."""
    _, tcls, kw, _ = MODULES[algo]
    li = LayerInfo.conv(2, 64, 32, (1, 1))
    w = torch.randn(64, 32, 1, 1, dtype=torch.bfloat16)
    tm = tcls("t", li, 1.0, 4, 2.0, **kw)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.1)
    assert tm.get_merged_weight(w)[0].stride() == (32, 1, 1, 1)


@pytest.mark.parametrize("algo", ["diag-oft", "boft"])
def test_oft_max_norm_matches_jax(algo):
    """Max-norm scales ``oft_blocks`` (limit below their norm: scaled; far
    above: untouched), as the JAX module does."""
    for limit in (0.5, 1e3):
        jm, tli, w, b, x = _jax_module(algo, "linear")
        tm = _port_module(algo, jm, tli)
        new_p, j_scaled, j_norm = jm.apply_max_norm(limit)
        _, t_scaled, t_norm = tm.apply_max_norm(limit)
        assert bool(t_scaled) == bool(j_scaled)
        _close(t_norm, j_norm)
        _close(tm._p("oft_blocks"), new_p["oft_blocks"])


@pytest.mark.parametrize("algo", ["ia3", "glora", "dylora", "full", "norm"])
def test_modules_without_max_norm_skip_it(algo):
    jm, tli, *_ = _jax_module(algo, "layernorm" if algo == "norm" else "linear")
    tm = _port_module(algo, jm, tli)
    assert tm.apply_max_norm(0.1)[1] is None


def test_dylora_block_draw_and_gradients():
    """The delta route's training draw of b (a device tensor, no host sync)
    keeps blocks past b out and gives gradients to block b alone; the
    merged route takes the last block. DyLoRA cannot load a state dict."""
    jm, tli, w, b, x = _jax_module("dylora", "linear")
    tm = _port_module("dylora", jm, tli)
    assert tm.block_count == 2
    for blk in range(2):
        want = jm.get_diff_weight(rank=blk * 2)[0] if blk else None
        got = tm.get_diff_weight(rank=blk * 2)[0]
        if want is not None:
            _close(got, want)
        got.square().sum().backward()
        up_g = tm._p("lora_up.weight").grad
        assert torch.count_nonzero(up_g[:, blk * 2:blk * 2 + 2]) > 0
        assert torch.count_nonzero(up_g[:, :blk * 2]) == 0
        assert torch.count_nonzero(up_g[:, blk * 2 + 2:]) == 0
        tm.zero_grad(set_to_none=True)
    drawn = tm._block(True, 123, torch.device("cpu"))
    assert isinstance(drawn, torch.Tensor) and 0 <= int(drawn) < 2
    assert int(drawn) == int(tm._block(True, 123, torch.device("cpu")))
    _close(tm.get_merged_weight(torch.tensor(w))[0], jm.get_merged_weight(jnp.asarray(w))[0])
    before = tm._p("lora_up.weight").clone()
    tm.load_state_dict({"lora_up.weight": torch.zeros_like(before)})
    assert torch.equal(tm._p("lora_up.weight"), before)
    assert tl.modules.make_module(DyLoraModule, [], "t", tli) is None


def test_ia3_state_dict_restores_train_on_input():
    """``on_input`` in the file restores ``train_on_input`` (the reference's
    loader fails on it), saved as the JAX module's int32."""
    jm, tli, w, b, x = _jax_module("ia3-input", "linear")
    sd = {f"t.{k}": np.asarray(v) for k, v in jm.custom_state_dict().items()}
    assert sd["t.on_input"].dtype == np.int32
    tm = _port_module("ia3-input", jm, tli)
    assert tm.train_input and tuple(tm._p("weight").shape) == (24,)
    assert tm.custom_state_dict()["on_input"].dtype == torch.int32


def test_full_keeps_deltas_and_no_bypass():
    """Full holds deltas, not absolute weights, on load too; it refuses
    bypass mode and the parametrize API."""
    jm, tli, w, b, x = _jax_module("full", "linear")
    tm = _port_module("full", jm, tli)
    _close(tm._p("diff"), jm.params["diff"])
    _close(tm.get_merged_weight(torch.tensor(w))[0], np.asarray(jm.params["diff"]) + w)
    with pytest.raises(ValueError):
        FullModule("t", tli, bypass_mode=True)
    with pytest.raises(RuntimeError):
        FullModule.parametrize(torch.tensor(w))


# ---------------------------------------------------------------------------
# one trainer step on the tiny UNet
# ---------------------------------------------------------------------------


@pytest.fixture
def one_thread():
    """One intra-op thread for the tiny UNet (as tests/test_torch_dora.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jl.LycorisNetwork.reset_preset()
    tl.LycorisNetwork.reset_preset()


def _dylora_port_net(net, m):
    """The port's DyLoRA network on the port UNet with the JAX network's
    tensors copied in (its files load as LoCon)."""
    tl.LycorisNetwork.apply_preset(tp.ATTN_MLP)
    tnet = tl.create_lycoris(m, 1.0, 4, 2.0, algo="dylora", block_size=2, device="cpu")
    assert set(tnet.lora_map) == set(net.lora_map)
    for ln, lyco in tnet.lora_map.items():
        assert isinstance(lyco, DyLoraModule)
        for k, v in net.lora_map[ln].params.items():
            lyco._set(k, torch.tensor(np.array(v)).reshape(lyco._p(k).shape))
    return tnet


@pytest.mark.parametrize("algo,kw", [
    ("diag-oft", dict(constraint=1e-3, rescaled=True)), ("boft", {}), ("full", {}),
    ("dylora", dict(block_size=2))])
def test_trainer_step_matches_jax(one_thread, algo, kw):
    """One trainer loss and every adapter gradient against the JAX trainer's
    (merged forward) on the same numpy noise and timesteps; for DyLoRA only
    the last block has gradients, in both packages."""
    model, variables, net, m, tnet, d = tp.setup(algo, **kw)
    if algo == "dylora":
        tnet = _dylora_port_net(net, m)
    # the JAX Gauss-Jordan unrolls into many small ops: compiled, it runs in half the time
    want_loss, want_grads = tp.jax_loss_and_grads(model, variables, net, d,
                                                  jit=algo == "diag-oft")
    _, loss, grads = tp.port_loss_and_grads(m, tnet, d)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-4)
    tp.assert_trees_close(grads, want_grads, 1e-4)
    if algo == "dylora":
        for sub in grads.values():
            assert not torch.any(sub["lora_up.weight"][:, :2])


def test_glora_tucker_file_is_refused_in_both_packages():
    """No GLoRA module has a tucker core (the JAX package's condition for
    one cannot hold), so a file with ``bm.weight`` loads in neither."""
    jm, tli, *_ = _jax_module("glora", "conv")
    sd = {f"t.{k}": np.asarray(v) for k, v in jm.custom_state_dict().items()}
    sd["t.bm.weight"] = np.zeros((4, 4, 3, 3), np.float32)
    jtype, jparams = jget_module(sd, "t")
    with pytest.raises(KeyError):
        jtype.make_module_from_state_dict("t", _layer("conv")[0], *jparams)
    ttype, params = tl.modules.get_module(sd, "t")
    assert ttype is GLoRAModule
    with pytest.raises(ValueError, match="tucker"):
        tl.modules.make_module(ttype, [None if p is None else torch.tensor(p) for p in params],
                               "t", tli)
