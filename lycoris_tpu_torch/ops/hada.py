"""LoHa delta weight dW = (w1u @ w1d) * (w2u @ w2d) * gamma: the CUDA
kernels ``csrc/hada_fwd.cu``, ``csrc/hada_bwd.cu`` and
``csrc/hada_bwd_split.cu``.

Counterpart of ``lycoris_tpu/ops/hada.py``: ``_hada_fwd_pallas``, the
default fused backward ``_hada_bwd_fused1`` and the split backward of
``_hada_bwd_pallas``. :data:`BWD` selects the backward at every call, as
``LYCORIS_TPU_HADA_BWD`` does in the JAX package: ``"fused1"`` (the
default; one pass over the cotangent) or ``"split"`` (two kernels, each a
pass over the cotangent, deterministic sums without cross-block partials).
Dispatch follows the JAX gate (:func:`supported`: O >= 8 and I >= 128, any
rank); smaller layers take the functional path in ``functional/loha.py``,
as they do in the JAX package.

The forward, the fused backward and the split backward kernels each have
two variants: a fast one built for the path's rank, R = 8, for 16-byte
aligned tensors whose I is a multiple of 4 (:func:`fast`; every LoHa layer
of the SD1.5 and SDXL paths), and a generic one for every other rank and
layout.

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
fast_launches = 0  # of those, launches of the fast (R = 8) variant
generic_launches = 0  # and of the generic one
bwd_launches = 0  # fused1 backward calls (each launches a kernel and its reduction), likewise
bwd_fast_launches = 0  # of those, calls of the fast variant
bwd_generic_launches = 0  # and of the generic one
split_launches = 0  # split backward calls (each launches a u- and a d-kernel), likewise
split_fast_launches = 0  # of those, calls of the fast variant (and its adder of partials)
split_generic_launches = 0  # and of the generic one

# the backward HadaWeightFunction runs, read at every call: "fused1" or
# "split" (the counterpart of the JAX package's LYCORIS_TPU_HADA_BWD)
BWD = "fused1"

_BWD_COLS, _BWD_TILE = 128, 16  # hada_bwd.cu: columns of one block, rows of one tile
_BWD_BLOCKS = 2 * 132  # aim: two blocks per SM of an H100

FAST_RANK = 8  # the rank the fast variants are built for (hada_fwd.cu, hada_r8.cuh)
_FAST_COLS = 128  # columns of a fast block: 32 lanes x 4
_FWD_ROWS_MAX = 512  # a fast forward block's rows (their u-values in shared memory)
_BWD_ROWS_MAX = 1024  # a fast backward block's rows (their u-values in shared memory)
_SPLIT_U_BLOCKS = 2  # blocks an SM of the split's u-pass (hada_bwd_split.cu U_BLOCKS)
_sms: dict = {}  # device index -> SM count


def bwd_rows_per_block(o: int, i: int) -> int:
    """Rows of g per block of the generic backward: enough blocks to fill the
    card (a small layer is latency-bound on each block's serial walk), at
    most 256 (each block's d-grad partial costs an extra R x 128 write)."""
    n_u = -(-i // _BWD_COLS)
    rows = -(-o // max(1, _BWD_BLOCKS // n_u))
    return min(256, max(_BWD_TILE, -(-rows // _BWD_TILE) * _BWD_TILE))


def fast(i: int, r: int, *tensors) -> bool:
    """Whether the fast variants take a layer of width ``i`` and rank ``r``
    on ``tensors``: R = 8, I a multiple of 4, every tensor 16-byte aligned
    (16-byte loads and stores along I, and of each row's 2R u-values)."""
    return r == FAST_RANK and i % 4 == 0 and not any(t.data_ptr() % 16 for t in tensors)


def fwd_grid(o: int, i: int, sms: int) -> tuple[int, int, int]:
    """(column blocks, row blocks, rows per block) of the fast forward:
    about two blocks per SM, each over a run of at most 512 rows (their
    u-values fill shared memory)."""
    gx = -(-i // _FAST_COLS)
    rpb = -(-o // max(1, min(o, 2 * sms // gx), -(-o // _FWD_ROWS_MAX)))
    return gx, -(-o // rpb), rpb


def bwd_grid(o: int, i: int, sms: int) -> tuple[int, int, int]:
    """(column blocks, row blocks, rows per block) of the fast backward: one
    wave of one block per SM where the layer allows, each block over at most
    1024 rows (their u-values fill shared memory) and enough rows that the
    fp32 partial sums stay within a quarter of fp32 g's bytes: per row of g
    (I floats) the u-partials cost 2R floats a column block, the d-partials
    2R floats a column over a block's rows."""
    gx = -(-i // _FAST_COLS)
    u_part = 2 * FAST_RANK * gx  # floats of u-partials per row of g
    d_budget = i // 4 - u_part  # floats per row left for the d-partials
    rows_min = -(-2 * FAST_RANK * i // d_budget) if d_budget > 0 else o
    rpb = -(-o // max(1, min(o // rows_min, sms // gx), -(-o // _BWD_ROWS_MAX)))
    return gx, -(-o // rpb), rpb


def split_grid(o: int, i: int, sms: int) -> tuple[int, int, int, int, int]:
    """(column strips, u-pass runs of rows, rows per u-pass run, d-pass runs,
    rows per d-pass run) of the fast split backward. Both passes split the
    columns into strips of 128 and the rows into runs. The u-pass makes
    about two blocks per SM (two fit on one), each with at least a row a
    warp; the d-pass one wave of one block per SM, each with at least 16
    rows (two a warp), so its d-grad partials (2R floats per column and
    run) stay within fp32 g's elements. A run has at most 1024 rows (their
    u-values fill shared memory)."""
    gx = -(-i // _FAST_COLS)

    def runs(blocks: int, min_rows: int) -> tuple[int, int]:
        n = max(1, min(blocks // gx, o // min_rows), -(-o // _BWD_ROWS_MAX))
        rpb = -(-o // n)
        return -(-o // rpb), rpb

    return (gx, *runs(_SPLIT_U_BLOCKS * sms, 8), *runs(sms, 16))


def _sm_count(dev) -> int:
    n = _sms.get(dev.index)
    if n is None:
        n = _sms[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


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


def _contiguous(*tensors):
    return [t if t.is_contiguous() else t.contiguous() for t in tensors]


def hada_fwd(w1d, w1u, w2d, w2u, scale=1.0):
    """The forward kernel on CUDA tensors: w1d, w2d (R, I); w1u, w2u (O, R)
    -> (O, I) in w1u's dtype. The fast variant where :func:`fast` allows
    it, else the generic one."""
    global launches, fast_launches, generic_launches
    if w1u.device.type != "cuda":
        raise RuntimeError(f"hada_weight: no kernel for device {w1u.device}")
    o, i, r = _check("hada_weight", w1d, w1u, w2d, w2u)
    w1d, w1u, w2d, w2u = _contiguous(w1d, w1u, w2d, w2u)
    out = torch.empty((o, i), dtype=w1u.dtype, device=w1u.device)
    is_fast = fast(i, r, w1d, w1u, w2d, w2u, out)
    rpb = fwd_grid(o, i, _sm_count(w1u.device))[2] if is_fast else 0
    rc = _build.lib().lyc_hada_fwd(
        w1d.data_ptr(), w1u.data_ptr(), w2d.data_ptr(), w2u.data_ptr(), out.data_ptr(),
        o, i, r, rpb, float(scale), _build.dtype_code(w1u), int(is_fast),
        _build.stream_ptr(w1u),
    )
    _build.check(rc, "lyc_hada_fwd")
    launches += 1
    if is_fast:
        fast_launches += 1
    else:
        generic_launches += 1
    return out


def _bwd_inputs(name, w1d, w1u, w2d, w2u, g):
    """Checked, contiguous inputs of a backward kernel: (o, i, r, g, w1d, w1u,
    w2d, w2u), the cotangent in the factors' dtype."""
    if w1u.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {w1u.device}")
    o, i, r = _check(name, w1d, w1u, w2d, w2u)
    if g.dtype != w1u.dtype:
        g = g.to(w1u.dtype)
    if g.shape != (o, i):
        raise ValueError(f"{name}: cotangent {tuple(g.shape)} for ({o}, {i})")
    return (o, i, r, *_contiguous(g, w1d, w1u, w2d, w2u))


def _outputs(out, o, i, r, like):
    """(g1d, g1u, g2d, g2u) as views of the kernel's one fp32 output, which
    holds g1d, g2d (R, I), then g1u, g2u (O, R); in the factors' dtype."""
    ri, ro = r * i, o * r
    grads = (out.as_strided((r, i), (i, 1), 0), out.as_strided((o, r), (r, 1), 2 * ri),
             out.as_strided((r, i), (i, 1), ri), out.as_strided((o, r), (r, 1), 2 * ri + ro))
    if like.dtype != torch.float32:
        grads = tuple(t.to(like.dtype) for t in grads)
    return grads


def hada_bwd(w1d, w1u, w2d, w2u, scale, g):
    """The fused1 backward kernel on CUDA tensors: (g1d, g1u, g2d, g2u) in
    the factors' dtype for the cotangent ``g`` (O, I). The fast variant
    where :func:`fast` allows it, else the generic one; each launches its
    kernel, then the reduction of the partial sums. The fp32 scratch of
    the partial sums is one allocation, the four gradients another: views
    of the scratch would keep it alive as long as the gradients."""
    global bwd_launches, bwd_fast_launches, bwd_generic_launches
    o, i, r, g, w1d, w1u, w2d, w2u = _bwd_inputs("hada_weight_bwd", w1d, w1u, w2d, w2u, g)
    dev = g.device
    is_fast = fast(i, r, g, w1d, w1u, w2d, w2u)
    if is_fast:
        gx, gy, rpb = bwd_grid(o, i, _sm_count(dev))
        n_part = (gx * o + gy * i) * 2 * r
    else:
        rpb = bwd_rows_per_block(o, i)
        n_part = (-(-i // _BWD_COLS) * o + -(-o // rpb) * i) * 2 * r
    part = torch.empty(n_part, dtype=torch.float32, device=dev)
    out = torch.empty(2 * r * (i + o), dtype=torch.float32, device=dev)
    rc = _build.lib().lyc_hada_bwd(
        g.data_ptr(), w1d.data_ptr(), w1u.data_ptr(), w2d.data_ptr(), w2u.data_ptr(),
        part.data_ptr(), out.data_ptr(), o, i, r, rpb, float(scale), _build.dtype_code(w1u),
        int(is_fast), _build.stream_ptr(g),
    )
    _build.check(rc, "lyc_hada_bwd")
    bwd_launches += 1
    if is_fast:
        bwd_fast_launches += 1
    else:
        bwd_generic_launches += 1
    return _outputs(out, o, i, r, w1u)


def hada_bwd_split(w1d, w1u, w2d, w2u, scale, g):
    """The split backward kernels on CUDA tensors: (g1d, g1u, g2d, g2u) in
    the factors' dtype for the cotangent ``g`` (O, I). The fast variant
    where :func:`fast` allows it (a u-pass, a d-pass, then the adder of
    their partial sums, over the grid of :func:`split_grid`), else the
    generic one (a u- and a d-kernel). The fp32 scratch of the partial sums
    is one allocation, the four gradients another."""
    global split_launches, split_fast_launches, split_generic_launches
    o, i, r, g, w1d, w1u, w2d, w2u = _bwd_inputs("hada_weight_bwd_split", w1d, w1u, w2d, w2u, g)
    dev = g.device
    is_fast = fast(i, r, g, w1d, w1u, w2d, w2u)
    part, rpb_u, rpb_d = None, 0, 0
    if is_fast:
        gx, _, rpb_u, gy_d, rpb_d = split_grid(o, i, _sm_count(dev))
        part = torch.empty((gx * o + gy_d * i) * 2 * r, dtype=torch.float32, device=dev)
    out = torch.empty(2 * r * (i + o), dtype=torch.float32, device=dev)
    rc = _build.lib().lyc_hada_bwd_split(
        g.data_ptr(), w1d.data_ptr(), w1u.data_ptr(), w2d.data_ptr(), w2u.data_ptr(),
        _build.ptr(part), out.data_ptr(), o, i, r, rpb_u, rpb_d, float(scale),
        _build.dtype_code(w1u), int(is_fast), _build.stream_ptr(g),
    )
    _build.check(rc, "lyc_hada_bwd_split")
    split_launches += 1
    if is_fast:
        split_fast_launches += 1
    else:
        split_generic_launches += 1
    return _outputs(out, o, i, r, w1u)


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
