"""The one LoKr merge of the port (``LokrModule.get_merged_weight`` and the
factored forward's ``recon_fn``, through ``ops.kron.merge``) on the CPU,
where it takes the plain version of the one-pass kernel.

Its merged weight against the JAX module's and against the autograd route's
formula (W + dW * multiplier, dW = scale * kron(w1, w2) * scalar), for w1
and w2 each whole or a rank pair, a scalar and a multiplier that are not 1,
on a linear and a 1x1 convolution layer; in bf16 within one bf16 ulp of
the float64 sum. Then which merges take it: the ones no autograd graph runs
through, and not DoRA, tucker, kernels larger than 1x1, rank dropout in
training or a merge autograd must differentiate.

Tolerance: 1e-5 of the largest magnitude against the JAX package (the
ROADMAP's fp32 parity bound); 4 fp32 ulps of it against the autograd route
(the same products, the scales folded in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import lycoris_tpu_torch as tl
from lycoris_tpu.modules.base import LayerInfo as JLayerInfo
from lycoris_tpu.modules.lokr import LokrModule as JLokr
from lycoris_tpu_torch.functional import merged as fm
from lycoris_tpu_torch.modules import LayerInfo, LokrModule
from lycoris_tpu_torch.ops import kron

SCALAR, MULT = 0.7, 0.6

# (w1, w2) -> the constructor's branch arguments on a (64, 48) layer, factor 4:
# w1 (4, 4) and w2 (16, 12), or with unbalanced_factorization w1 (16, 4) and
# w2 (4, 12)
FACTORS = {
    ("full", "ab"): dict(lora_dim=2),
    ("full", "full"): dict(lora_dim=2, full_matrix=True),
    ("ab", "ab"): dict(lora_dim=1, decompose_both=True),
    ("ab", "full"): dict(lora_dim=6, decompose_both=True, unbalanced_factorization=True),
}
CASES = [(w1, w2, kind) for (w1, w2) in FACTORS for kind in ("linear", "conv1x1")]


def _layer(kind, shape=(64, 48)):
    if kind == "linear":
        return JLayerInfo.linear(*shape), LayerInfo.linear(*shape)
    return JLayerInfo.conv(2, *shape, 1), LayerInfo.conv(2, *shape, 1)


def _pair(w1, w2, kind, seed=0):
    """The JAX module and the port's with the same branches and the same
    seeded values in every tensor, ``scalar`` set to SCALAR in both."""
    cfg = dict(factor=4, **FACTORS[(w1, w2)])
    r = cfg.pop("lora_dim")
    jli, tli = _layer(kind)
    jm = JLokr("t", jli, 1.0, r, 3.0, rng=jax.random.key(seed), **cfg)
    tm = LokrModule("t", tli, 1.0, r, 3.0, generator=torch.Generator().manual_seed(seed), **cfg)
    assert (tm.use_w1, tm.use_w2) == (jm.use_w1, jm.use_w2) == (w1 == "full", w2 == "full")
    assert tm.scale == pytest.approx(jm.scale)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for k in sorted(jm.trainable):
            v = (rng.standard_normal(np.shape(jm.params[k])) * 0.3).astype(np.float32)
            jm.params[k] = jnp.asarray(v)
            tm._p(k).copy_(torch.tensor(v).reshape(tm._p(k).shape))
        jm.params["scalar"] = jnp.asarray(SCALAR, jnp.float32)
        tm._p("scalar").fill_(SCALAR)
    w = (rng.standard_normal(tli.shape)).astype(np.float32)
    return jm, tm, w


@pytest.fixture()
def merges(monkeypatch):
    """The calls of ``ops.kron.merge`` made during the test."""
    calls = []
    real = kron.merge

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(kron, "merge", counted)
    return calls


def _close(got, want, ulps=None):
    got, want = np.asarray(torch.as_tensor(got).detach().float()), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    tol = 1e-5 if ulps is None else ulps * np.finfo(np.float32).eps
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("w1,w2,kind", CASES)
def test_one_merge_matches_jax_and_the_autograd_formula(w1, w2, kind, merges):
    jm, tm, w = _pair(w1, w2, kind)
    want = np.asarray(jm.get_merged_weight(jnp.asarray(w), multiplier=MULT)[0])
    with torch.no_grad():
        got, _ = tm.get_merged_weight(torch.tensor(w), multiplier=MULT)
    assert len(merges) == 1 and got.dtype == torch.float32 and got.shape == tm.shape
    _close(got, want)
    # the autograd route: today's formula, the scales applied to the full dW
    formula, _ = tm.get_merged_weight(torch.tensor(w), multiplier=MULT)
    assert len(merges) == 1 and formula.requires_grad
    _close(got, formula.detach().numpy(), ulps=4)
    # bf16 in and out (W's dtype, the default): one rounding of the fp32 sum,
    # within a bf16 ulp of float64
    wb = torch.tensor(w).bfloat16()
    with torch.no_grad():
        got16, _ = tm.get_merged_weight(wb, multiplier=MULT)
    assert got16.dtype == torch.bfloat16 and len(merges) == 2
    w1_ = tm._rebuild_w1().detach().double()
    w2_ = tm._rebuild_w2().detach().double().reshape(-1, tm.kron_shape[1][1])
    exact = wb.double().reshape(w1_.shape[0], w2_.shape[0], w1_.shape[1], w2_.shape[1]) + (
        tm.scale * SCALAR * MULT * w1_[:, None, :, None] * w2_[None, :, None, :])
    exact = exact.reshape(tm.shape)
    ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp(min=2.0 ** -100))) - 7)
    assert bool(((got16.double() - exact).abs() <= ulp).all())


def test_recon_fn_merges_in_one_pass_as_get_merged_weight(merges):
    """The factored forward's ``recon_fn.merge(theta, w)`` is the same merge
    as ``get_merged_weight``: bit for bit, and W + recon_fn(theta) within
    rounding."""
    _, tm, w = _pair("full", "ab", "linear")
    recon, _ = tm.factored_merged_fns(MULT)
    with torch.no_grad():
        one = recon.merge(dict(tm.params), torch.tensor(w))
        again, _ = tm.get_merged_weight(torch.tensor(w), multiplier=MULT)
        two = torch.tensor(w) + recon(dict(tm.params))
    assert len(merges) == 2 and torch.equal(one, again)
    _close(one, two.numpy(), ulps=4)


class Block(nn.Module):
    def __init__(self, conv=False):
        super().__init__()
        self.proj = nn.Conv2d(48, 64, 1) if conv else nn.Linear(48, 64)

    def forward(self, x):
        return self.proj(x)


def _net(**kw):
    torch.manual_seed(0)
    model = nn.Sequential(Block(kw.pop("conv", False)))
    tl.LycorisNetwork.apply_preset({"target_module": ["Block"]})
    try:
        net = tl.create_lycoris(model, MULT, 2, 2.0, algo="lokr", factor=4, device="cpu", **kw)
    finally:
        tl.LycorisNetwork.reset_preset()
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.1 * torch.randn_like(p))
    return model, net.apply_to(merged_forward=True)


def _module(shape=(64, 48), **kw):
    if len(shape) == 2:
        li = LayerInfo.linear(*shape)
    else:
        li = LayerInfo.conv(2, *shape[:2], shape[2:], padding=shape[2] // 2)
    m = LokrModule("t", li, 1.0, 2, 2.0, factor=4, generator=torch.Generator().manual_seed(0),
                   org_weight=torch.randn(shape), **kw)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.1 * torch.randn_like(p))
    return m, torch.randn(shape)


def _module_merge(shape=(64, 48), grad=False, frozen=False, w_grad=False, **kw):
    m, w = _module(shape, **kw)
    if frozen:
        m.requires_grad_(False)
    w.requires_grad_(w_grad)
    with torch.set_grad_enabled(grad):
        m.get_merged_weight(w, multiplier=MULT)


def _wrapper_forward(train=False, grad=False, factored=False, conv=False, **kw):
    model, net = _net(conv=conv, **kw)
    x = torch.randn(2, 48, 3, 3) if conv else torch.randn(2, 5, 48, requires_grad=factored)
    if factored:
        fm.FACTORED_MIN = 24  # the (64, 48) layer's harmonic dimension is 27
    try:
        with torch.set_grad_enabled(grad or factored):
            if train:
                with net.training_step(seed=3):
                    y = model(x)
            else:
                y = model(x)
            if factored:
                y.sum().backward()
    finally:
        fm.FACTORED_MIN = 1024


# route -> (what runs, calls of ops.kron.merge)
ROUTES = {
    "no_grad": (lambda: _module_merge(), 1),
    "frozen_factors": (lambda: _module_merge(grad=True, frozen=True), 1),
    "conv1x1": (lambda: _module_merge((64, 48, 1, 1)), 1),
    "grad": (lambda: _module_merge(grad=True), 0),
    "w_wants_grad": (lambda: _module_merge(grad=True, frozen=True, w_grad=True), 0),
    "dora": (lambda: _module_merge(weight_decompose=True), 0),
    "tucker": (lambda: _module_merge((64, 48, 3, 3), use_tucker=True), 0),
    "conv3x3": (lambda: _module_merge((64, 48, 3, 3)), 0),
    "wrapper_no_grad": (lambda: _wrapper_forward(), 1),
    "wrapper_conv1x1_no_grad": (lambda: _wrapper_forward(conv=True), 1),
    "wrapper_grad": (lambda: _wrapper_forward(grad=True), 0),
    "wrapper_rank_dropout_train": (lambda: _wrapper_forward(train=True, grad=True,
                                                            rank_dropout=0.5), 0),
    "wrapper_rank_dropout_no_grad": (lambda: _wrapper_forward(rank_dropout=0.5), 1),
    # the factored Function: its forward, then its backward's recompute for dx
    "factored": (lambda: _wrapper_forward(factored=True), 2),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_merge_routing(route, merges):
    """``ops.kron.merge`` wherever no autograd graph runs through the merge;
    the autograd ops for DoRA, tucker, kernels over 1x1, rank dropout in
    training and a merge that autograd differentiates."""
    run, want = ROUTES[route]
    run()
    assert len(merges) == want, merges
