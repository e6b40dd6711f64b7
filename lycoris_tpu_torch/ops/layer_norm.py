"""LayerNorm over the last dim: the CUDA kernels ``csrc/ln_fwd.cu`` and
``csrc/ln_bwd.cu``.

Counterpart of ``lycoris_tpu/ops/layer_norm.py`` (``_fwd_call`` and the
``_vjp_bwd`` backward). The TPU gate ``512 <= C <= 8192`` was a TPU
measurement and is not carried over: on the card every affine single-dim
LayerNorm runs the kernels.

:func:`layer_norm` is a :class:`LayerNormFunction`: its forward saves x and
w, its backward recomputes the row statistics. Each direction takes its
plain version (:func:`layer_norm_plain`, :func:`layer_norm_bwd_plain`) only
for tensors on the CPU; for CUDA tensors it launches the kernel or raises.
Each direction's kernel has two variants (``csrc/ln_fwd.cu``,
``csrc/ln_bwd.cu``): the vectorised one, a row held in registers by a
group of lanes (:func:`vec_lanes`; every width of the SD1.5 and SDXL paths
in bf16), and a generic one for other widths and for tensors that are not
16-byte aligned. :func:`fwd_plan` sizes the forward's blocks and grid.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import _build

launches = 0  # forward kernel launches since the last reset (chip_smoke counts these)
fwd_vec_launches = 0  # of those, launches of the vectorised variant
fwd_generic_launches = 0  # and of the generic one
bwd_launches = 0  # backward kernel launches, and of each variant, likewise
bwd_vec_launches = 0
bwd_generic_launches = 0
bwd_wb_launches = 0  # of the backward's launches, those that also formed dw and db

_MAX_PARTS = 4 * 132  # dw/db partial rows: four blocks per SM of an H100
VECS = 5  # 16-byte vectors of x (and of dy) a lane of the vectorised variant holds
# csrc/ln.cuh's kMaxWarps and kBlocksPerSm: warps a block of the vectorised
# variant, halved while the grid would have fewer blocks than this an SM
MAX_WARPS, BLOCKS_PER_SM = 8, 8
GENERIC_WARPS = 4  # csrc/ln_fwd.cu's kRowsPerBlock: the generic forward's rows a block


def vec_lanes(c: int, element_size: int) -> int:
    """Lanes per row of the vectorised variants (both directions) for
    width ``c``: L, a power of two up to a warp, with the row L * ``VECS``
    16-byte vectors (the one count ``csrc/ln.cuh`` is built for), or 0 for
    the generic variant. bf16 C = 320, 640, 1280 give 8, 16, 32 lanes;
    fp32 C = 320, 640 give 16, 32."""
    lanes, rest = divmod(c, VECS * (16 // element_size))
    return lanes if rest == 0 and lanes and 32 % lanes == 0 else 0


bwd_lanes = vec_lanes  # the backward's name for the same planner


class FwdPlan(NamedTuple):
    lanes: int  # lanes a row (0: the generic variant, one warp a row)
    warps: int  # warps a block
    grid: int  # blocks


def fwd_plan(rows: int, c: int, element_size: int, sms: int = 132, aligned: bool = True
             ) -> FwdPlan:
    """The forward's launch: the vectorised variant where :func:`vec_lanes`
    takes the width and the tensors are 16-byte aligned, with 8 warps a
    block, halved until the grid has ``BLOCKS_PER_SM`` blocks on each of
    ``sms`` SMs or the block is one warp (as the backward's), and one group
    of rows a warp; else the generic one."""
    lanes = vec_lanes(c, element_size) if aligned else 0
    if not lanes:
        return FwdPlan(0, GENERIC_WARPS, math.ceil(rows / GENERIC_WARPS))
    groups = 32 // lanes
    warps = MAX_WARPS
    while warps > 1 and math.ceil(rows / (warps * groups)) < BLOCKS_PER_SM * sms:
        warps //= 2
    return FwdPlan(lanes, warps, math.ceil(rows / (warps * groups)))


@functools.cache
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def layer_norm_plain(x, weight, bias, eps: float):
    """fp32 row mean, var = mean((x - mean)^2), y in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def layer_norm_bwd_plain(x, weight, dy, eps: float):
    """(dx in x's dtype, dw fp32, db fp32) of :func:`layer_norm_plain` for
    the cotangent ``dy``, with the statistics recomputed from x in fp32."""
    c = x.shape[-1]
    xf = x.reshape(-1, c).float()
    g = dy.reshape(-1, c).float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    wdy = g * weight.float()
    c1 = (wdy * xhat).mean(dim=-1, keepdim=True)
    c2 = wdy.mean(dim=-1, keepdim=True)
    dx = ((wdy - xhat * c1 - c2) * rstd).to(x.dtype).reshape(x.shape)
    return dx, (g * xhat).sum(dim=0), g.sum(dim=0)


def _check(x, weight, bias):
    c = x.shape[-1]
    _build.check_cuda_inputs("layer_norm", x, weight, bias)
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"layer_norm: weight/bias {tuple(weight.shape)} for C={c}")
    if not (x.is_contiguous() and weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("layer_norm: kernel needs contiguous tensors")


def layer_norm_fwd(x, weight, bias, eps: float, vectorised: bool = True):
    """The forward kernel on CUDA tensors (x (..., C), weight/bias (C,)):
    the variant :func:`fwd_plan` picks, or the generic one if not
    ``vectorised``."""
    global launches, fwd_vec_launches, fwd_generic_launches
    if x.device.type != "cuda":
        raise RuntimeError(f"layer_norm: no kernel for device {x.device}")
    _check(x, weight, bias)
    y = torch.empty_like(x)
    c = x.shape[-1]
    rows = x.numel() // c
    ptrs = (x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr())
    aligned = vectorised and not (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) % 16
    plan = fwd_plan(rows, c, x.element_size(), _sms(x.get_device()), aligned)
    rc = _build.lib().lyc_ln_fwd(
        *ptrs, rows, c, *plan, float(eps), _build.dtype_code(x), _build.stream_ptr(x),
    )
    _build.check(rc, "lyc_ln_fwd")
    launches += 1
    if plan.lanes:
        fwd_vec_launches += 1
    else:
        fwd_generic_launches += 1
    return y


def layer_norm_bwd(x, weight, dy, eps: float, want_wb: bool = True):
    """The backward kernel on CUDA tensors: (dx, dw fp32, db fp32), or
    (dx, None, None) when ``want_wb`` is False (frozen weight and bias).
    The vectorised variant where :func:`vec_lanes` allows it and the
    tensors are 16-byte aligned, else the generic one."""
    global bwd_launches, bwd_vec_launches, bwd_generic_launches, bwd_wb_launches
    if x.device.type != "cuda":
        raise RuntimeError(f"layer_norm_bwd: no kernel for device {x.device}")
    dy = dy.contiguous()
    _build.check_cuda_inputs("layer_norm_bwd", x, weight, dy)
    c = x.shape[-1]
    if weight.shape != (c,) or dy.shape != x.shape or not x.is_contiguous():
        raise ValueError(f"layer_norm_bwd: x {tuple(x.shape)} dy {tuple(dy.shape)} "
                         f"w {tuple(weight.shape)}")
    rows = x.numel() // c
    nparts = max(1, min(_MAX_PARTS, math.ceil(rows / 16)))
    dx = torch.empty_like(x)
    lanes = vec_lanes(c, x.element_size())
    if any(t.data_ptr() % 16 for t in (x, dy, weight, dx)):
        lanes = 0
    dw = db = parts = None
    if want_wb:
        f32 = dict(dtype=torch.float32, device=x.device)
        parts = torch.empty((2, nparts, c), **f32)
        dw, db = torch.empty(c, **f32), torch.empty(c, **f32)
    rc = _build.lib().lyc_ln_bwd(
        x.data_ptr(), dy.data_ptr(), weight.data_ptr(), dx.data_ptr(),
        _build.ptr(None if parts is None else parts[0]),
        _build.ptr(None if parts is None else parts[1]),
        _build.ptr(dw), _build.ptr(db), rows, c, nparts, lanes, float(eps),
        _build.dtype_code(x), _build.stream_ptr(x),
    )
    _build.check(rc, "lyc_ln_bwd")
    bwd_launches += 1
    bwd_wb_launches += int(want_wb)
    if lanes:
        bwd_vec_launches += 1
    else:
        bwd_generic_launches += 1
    return dx, dw, db


class LayerNormFunction(torch.autograd.Function):
    """LayerNorm whose backward is the ``ln_bwd`` kernel on the card (the
    plain backward on the CPU). Saves x and w; dw/db only where needed."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        if x.device.type == "cpu":
            return layer_norm_plain(x, weight, bias, eps)
        return layer_norm_fwd(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        want_wb = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        if x.device.type == "cpu":
            dx, dw, db = layer_norm_bwd_plain(x, weight, dy, ctx.eps)
        else:
            dx, dw, db = layer_norm_bwd(x, weight, dy, ctx.eps, want_wb)
        dw = dw.to(weight.dtype) if ctx.needs_input_grad[1] else None
        db = db.to(weight.dtype) if ctx.needs_input_grad[2] else None
        return dx, dw, db, None


def layer_norm(x, weight, bias, eps: float):
    """LayerNorm of ``x`` (..., C) with ``weight``/``bias`` (C,) in x's
    dtype, differentiable in all three."""
    if bias is None:
        bias = torch.zeros_like(weight)
    return LayerNormFunction.apply(x, weight, bias, float(eps))
