"""LoHa delta weight dW = (w1u @ w1d) * (w2u @ w2d) * gamma: the CUDA
kernels ``csrc/hada_fwd.cu``, ``csrc/hada_bwd.cu`` and
``csrc/hada_bwd_split.cu``.

Counterpart of ``lycoris_tpu/ops/hada.py``: ``_hada_fwd_pallas``, the
default fused backward ``_hada_bwd_fused1`` and the split backward of
``_hada_bwd_pallas``. :data:`BWD` selects the backward at every call, as
``LYCORIS_TPU_HADA_BWD`` does in the JAX package: ``"fused1"`` (the
default; one pass over the cotangent) or ``"split"`` (two kernels, each a
pass over the cotangent, deterministic sums without cross-block partials).
Dispatch follows the JAX gate (:func:`supported`: O >= 8 and I >= 128);
smaller layers take the functional path in ``functional/loha.py``, as they
do in the JAX package.

:func:`hada_weight` is a :class:`HadaWeightFunction`: it saves only the
four factors, and its backward recomputes both products tile by tile. Each
direction takes its plain version (:func:`hada_weight_plain`,
:func:`hada_weight_bwd_plain`, :func:`hada_weight_bwd_split_plain`) only
for tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0  # forward kernel launches since the last reset (chip_smoke counts these)
bwd_launches = 0  # fused1 backward kernel launches, likewise
split_launches = 0  # split backward calls (each launches the u- and the d-kernel)

# the backward HadaWeightFunction runs, read at every call: "fused1" or
# "split" (the counterpart of the JAX package's LYCORIS_TPU_HADA_BWD)
BWD = "fused1"

_BWD_COLS, _BWD_TILE = 128, 16  # hada_bwd.cu: columns of one block, rows of one tile
_BWD_BLOCKS = 2 * 132  # aim: two blocks per SM of an H100


def bwd_rows_per_block(o: int, i: int) -> int:
    """Rows of g per block of the backward kernel: enough blocks to fill the
    card (a small layer is latency-bound on each block's serial walk), at
    most 256 (each block's d-grad partial costs an extra R x 128 write)."""
    n_u = -(-i // _BWD_COLS)
    rows = -(-o // max(1, _BWD_BLOCKS // n_u))
    return min(256, max(_BWD_TILE, -(-rows // _BWD_TILE) * _BWD_TILE))


def supported(w1d, w1u) -> bool:
    o, r = w1u.shape
    return o >= 8 and w1d.shape[1] >= 128 and r >= 1


def hada_weight_plain(w1d, w1u, w2d, w2u, scale=1.0):
    """Both rank-R products in fp32, multiplied and scaled; out in w1u's dtype."""
    p1 = w1u.float() @ w1d.float()
    p2 = w2u.float() @ w2d.float()
    return (p1 * p2 * scale).to(w1u.dtype)


def hada_weight_bwd_plain(w1d, w1u, w2d, w2u, scale, g):
    """(g1d, g1u, g2d, g2u) in the factors' dtype: the backward kernel's
    formulas in fp32, each partner product recomputed."""
    w1d_, w1u_, w2d_, w2u_ = (t.float() for t in (w1d, w1u, w2d, w2u))
    gs = g.float() * scale
    t1 = gs * (w2u_ @ w2d_)
    t2 = gs * (w1u_ @ w1d_)
    return ((w1u_.T @ t1).to(w1d.dtype), (t1 @ w1d_.T).to(w1u.dtype),
            (w2u_.T @ t2).to(w2d.dtype), (t2 @ w2d_.T).to(w2u.dtype))


def hada_weight_bwd_split_plain(w1d, w1u, w2d, w2u, scale, g):
    """(g1d, g1u, g2d, g2u) in the factors' dtype: the split kernels'
    formulas in fp32, two passes that each recompute both products (the
    u-grads, then the d-grads)."""
    w1d_, w1u_, w2d_, w2u_ = (t.float() for t in (w1d, w1u, w2d, w2u))
    gs = g.float() * scale
    t1, t2 = gs * (w2u_ @ w2d_), gs * (w1u_ @ w1d_)
    g1u, g2u = t1 @ w1d_.T, t2 @ w2d_.T
    t1, t2 = gs * (w2u_ @ w2d_), gs * (w1u_ @ w1d_)
    g1d, g2d = w1u_.T @ t1, w2u_.T @ t2
    return (g1d.to(w1d.dtype), g1u.to(w1u.dtype), g2d.to(w2d.dtype), g2u.to(w2u.dtype))


def _check(name, w1d, w1u, w2d, w2u):
    _build.check_cuda_inputs(name, w1d, w1u, w2d, w2u)
    o, r = w1u.shape
    i = w1d.shape[1]
    if w1d.shape != (r, i) or w2d.shape != (r, i) or w2u.shape != (o, r):
        raise ValueError(
            f"{name}: shapes {tuple(w1d.shape)} {tuple(w1u.shape)} "
            f"{tuple(w2d.shape)} {tuple(w2u.shape)}"
        )
    return o, i, r


def hada_fwd(w1d, w1u, w2d, w2u, scale=1.0):
    """The forward kernel on CUDA tensors: w1d, w2d (R, I); w1u, w2u (O, R)
    -> (O, I) in w1u's dtype."""
    global launches
    if w1u.device.type != "cuda":
        raise RuntimeError(f"hada_weight: no kernel for device {w1u.device}")
    o, i, r = _check("hada_weight", w1d, w1u, w2d, w2u)
    w1d, w1u, w2d, w2u = (t.contiguous() for t in (w1d, w1u, w2d, w2u))
    out = torch.empty((o, i), dtype=w1u.dtype, device=w1u.device)
    rc = _build.lib().lyc_hada_fwd(
        w1d.data_ptr(), w1u.data_ptr(), w2d.data_ptr(), w2u.data_ptr(), out.data_ptr(),
        o, i, r, float(scale), _build.dtype_code(w1u), _build.stream_ptr(w1u),
    )
    _build.check(rc, "lyc_hada_fwd")
    launches += 1
    return out


def _bwd_inputs(name, w1d, w1u, w2d, w2u, g):
    """Checked, contiguous inputs of a backward kernel: (o, i, r, g, w1d, w1u,
    w2d, w2u), the cotangent in the factors' dtype."""
    if w1u.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {w1u.device}")
    o, i, r = _check(name, w1d, w1u, w2d, w2u)
    g = g.to(w1u.dtype).contiguous()
    if g.shape != (o, i):
        raise ValueError(f"{name}: cotangent {tuple(g.shape)} for ({o}, {i})")
    return (o, i, r, g, *(t.contiguous() for t in (w1d, w1u, w2d, w2u)))


def hada_bwd(w1d, w1u, w2d, w2u, scale, g):
    """The backward kernel on CUDA tensors: (g1d, g1u, g2d, g2u) in the
    factors' dtype for the cotangent ``g`` (O, I)."""
    global bwd_launches
    o, i, r, g, w1d, w1u, w2d, w2u = _bwd_inputs("hada_weight_bwd", w1d, w1u, w2d, w2u, g)
    f32 = dict(dtype=torch.float32, device=g.device)
    rpb = bwd_rows_per_block(o, i)
    n_u, n_d = -(-i // _BWD_COLS), -(-o // rpb)
    pu = torch.empty((2, n_u, o, r), **f32)
    pd = torch.empty((2, n_d, r, i), **f32)
    g1d, g2d = torch.empty((r, i), **f32), torch.empty((r, i), **f32)
    g1u, g2u = torch.empty((o, r), **f32), torch.empty((o, r), **f32)
    rc = _build.lib().lyc_hada_bwd(
        g.data_ptr(), w1d.data_ptr(), w1u.data_ptr(), w2d.data_ptr(), w2u.data_ptr(),
        pu[0].data_ptr(), pu[1].data_ptr(), pd[0].data_ptr(), pd[1].data_ptr(),
        g1d.data_ptr(), g1u.data_ptr(), g2d.data_ptr(), g2u.data_ptr(),
        o, i, r, rpb, float(scale), _build.dtype_code(w1u), _build.stream_ptr(w1u),
    )
    _build.check(rc, "lyc_hada_bwd")
    bwd_launches += 1
    return (g1d.to(w1d.dtype), g1u.to(w1u.dtype), g2d.to(w2d.dtype), g2u.to(w2u.dtype))


def hada_bwd_split(w1d, w1u, w2d, w2u, scale, g):
    """The split backward kernels on CUDA tensors: (g1d, g1u, g2d, g2u) in
    the factors' dtype for the cotangent ``g`` (O, I)."""
    global split_launches
    o, i, r, g, w1d, w1u, w2d, w2u = _bwd_inputs("hada_weight_bwd_split", w1d, w1u, w2d, w2u, g)
    f32 = dict(dtype=torch.float32, device=g.device)
    g1d, g2d = torch.empty((r, i), **f32), torch.empty((r, i), **f32)
    g1u, g2u = torch.empty((o, r), **f32), torch.empty((o, r), **f32)
    rc = _build.lib().lyc_hada_bwd_split(
        g.data_ptr(), w1d.data_ptr(), w1u.data_ptr(), w2d.data_ptr(), w2u.data_ptr(),
        g1d.data_ptr(), g1u.data_ptr(), g2d.data_ptr(), g2u.data_ptr(),
        o, i, r, float(scale), _build.dtype_code(w1u), _build.stream_ptr(w1u),
    )
    _build.check(rc, "lyc_hada_bwd_split")
    split_launches += 1
    return (g1d.to(w1d.dtype), g1u.to(w1u.dtype), g2d.to(w2d.dtype), g2u.to(w2u.dtype))


def hada_weight_bwd(w1d, w1u, w2d, w2u, scale, g):
    """The backward that :data:`BWD` selects: the kernel on CUDA tensors,
    its plain version on CPU tensors."""
    cpu = w1u.device.type == "cpu"
    if BWD == "fused1":
        fn = hada_weight_bwd_plain if cpu else hada_bwd
    elif BWD == "split":
        fn = hada_weight_bwd_split_plain if cpu else hada_bwd_split
    else:
        raise ValueError(f"ops.hada.BWD must be 'fused1' or 'split', not {BWD!r}")
    return fn(w1d, w1u, w2d, w2u, scale, g)


class HadaWeightFunction(torch.autograd.Function):
    """LoHa dW whose backward is the kernel :data:`BWD` selects on the card
    (its plain version on the CPU). Saves the four factors, not the
    products."""

    @staticmethod
    def forward(ctx, w1d, w1u, w2d, w2u, scale):
        ctx.save_for_backward(w1d, w1u, w2d, w2u)
        ctx.scale = scale
        if w1u.device.type == "cpu":
            return hada_weight_plain(w1d, w1u, w2d, w2u, scale)
        return hada_fwd(w1d, w1u, w2d, w2u, scale)

    @staticmethod
    def backward(ctx, g):
        w1d, w1u, w2d, w2u = ctx.saved_tensors
        return (*hada_weight_bwd(w1d, w1u, w2d, w2u, ctx.scale, g), None)


def hada_weight(w1d, w1u, w2d, w2u, scale=1.0):
    """w1d, w2d: (R, I); w1u, w2u: (O, R) -> (O, I) in w1u's dtype,
    differentiable in the four factors."""
    return HadaWeightFunction.apply(w1d, w1u, w2d, w2u, float(scale))
