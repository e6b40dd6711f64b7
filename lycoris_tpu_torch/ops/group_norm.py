"""GroupNorm with an optional folded SiLU: the CUDA kernels
``csrc/gn_fwd.cu`` and ``csrc/gn_bwd.cu``.

Counterpart of ``lycoris_tpu/ops/group_norm_v2.py`` (``_gn2``: the stats,
apply, tstats and dx kernels) and of ``lycoris_tpu/ops/group_norm.py``
(``_gn``: the sums2/fma1/fma2 kernels on a rows = N*C view, which compute
the same function without the act and which these kernels serve). The math
is the JAX package's: fp32 statistics, var = E[x^2] - mean^2, gamma/beta
folded into one FMA per channel, y = act(x * scale_c + shift_c); the
backward recomputes dy = dh * act'(z), sums t1 = sum dy and t2 = sum dy*x
per (n, c), forms the per-group coefficients and writes
dx = dy * A_c + x * B_g + C_g; dgamma/dbeta fall out of the same sums.

The TPU kernels work on an (S, N, C) view because the TPU's conv layout
keeps C minor; that is not carried over. PyTorch's activations are
contiguous NCHW, so each (n, c) is one contiguous run of S elements and
each (n, g) one run of cg * S.

Each direction has two variants, chosen here by :func:`variant`: the fast
one (one launch; each group staged in shared memory by bulk copies, split
over a thread block cluster where it is large, as :func:`plan` says, on a
persistent grid of as many clusters as the card holds, :func:`grid`) for
bf16 and fp32 rows of whole 16-byte vectors, 16-byte aligned (every UNet
shape), and the generic one (three launches) for everything else. In bf16
the fast kernels take the SiLU's sigmoid from one ``tanh.approx``
(relative error 2^-11, under the 2^-8 of a bf16 output) in place of an
exponential and a reciprocal, halving their work on the SM's special
function units.

:func:`group_norm_act` is a :class:`GroupNormFunction`: its forward saves x,
gamma, beta and the fp32 (mean, rstd) per group, its backward runs the
backward kernel (dgamma/dbeta only where asked for). Each direction takes
its plain version (:func:`group_norm_plain`, :func:`group_norm_bwd_plain`)
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build

launches = 0  # forward calls since the last reset (chip_smoke counts these)
fast_launches = 0  # of those, calls of the fast variant (one kernel)
generic_launches = 0  # and of the generic one (three kernels)
bwd_launches = 0  # backward calls, likewise
bwd_fast_launches = 0
bwd_generic_launches = 0
bwd_wb_launches = 0  # of the backward calls, those that also formed dgamma and dbeta
copies = 0  # inputs the wrappers had to make contiguous (NCHW) first

ACTS = (None, "silu")
_ACT_CODES = {None: 0, "silu": 1}
PART_LEN = 4096  # generic variant: elements of one (n, c) row that one warp sums

# fast variant (csrc/gn.cuh)
_WARPS = 8  # of a CTA's 256 threads
SMEM_MAX = 232448  # bytes of shared memory a CTA may use on an H100
MAX_CLUSTER = 8  # CTAs of a thread block cluster: the portable size
CHUNK_BYTES = 16384  # per tensor, one bulk copy and one mbarrier each
SLICE_BYTES = 96 * 1024  # what a CTA aims to stage of a group (x, or x and dh): two an SM
BWD_STAGE_BYTES = 72 * 1024  # what a backward slice over SLICE_BYTES stages: three an SM
MAX_CG = 4096  # channels per group whose per-channel arrays the fast kernels hold
_ELEM = {torch.float32: 4, torch.bfloat16: 2}


def _view(x):
    """(N, C, *spatial) -> (N, C, S)."""
    n, c, *spatial = x.shape
    return x.reshape(n, c, math.prod(spatial) if spatial else 1)


def _act(z, act):
    return z * torch.sigmoid(z) if act == "silu" else z


def _act_grad(z, act):
    if act == "silu":
        s = torch.sigmoid(z)
        return s * (1.0 + z * (1.0 - s))
    return torch.ones_like(z)


def group_norm_stats_plain(x, num_groups: int, eps: float):
    """fp32 (mean, rstd), each (N, G): per-channel sums combined per group,
    var = E[x^2] - mean^2 (the JAX package's ``_combine``)."""
    xf = _view(x).float()
    n, c, s = xf.shape
    cg = c // num_groups
    s1 = xf.sum(dim=2).reshape(n, num_groups, cg).sum(dim=2)
    s2 = (xf * xf).sum(dim=2).reshape(n, num_groups, cg).sum(dim=2)
    mean = s1 / (cg * s)
    var = s2 / (cg * s) - mean * mean
    return mean, torch.rsqrt(var + eps)


def _scale_shift(mean, rstd, weight, bias, cg):
    """Per-channel fp32 (scale, shift), each (N, C, 1): gamma/beta folded."""
    scale = rstd.repeat_interleave(cg, dim=1)
    shift = (-mean * rstd).repeat_interleave(cg, dim=1)
    if weight is not None:
        w = weight.float()[None]
        scale, shift = scale * w, shift * w
    if bias is not None:
        shift = shift + bias.float()[None]
    return scale[..., None], shift[..., None]


def group_norm_plain(x, num_groups: int, weight, bias, eps: float, act=None, stats=None):
    """act(GroupNorm(x)) in x's dtype; ``stats`` = (mean, rstd) if known."""
    mean, rstd = group_norm_stats_plain(x, num_groups, eps) if stats is None else stats
    scale, shift = _scale_shift(mean, rstd, weight, bias, x.shape[1] // num_groups)
    return _act(_view(x).float() * scale + shift, act).to(x.dtype).reshape(x.shape)


def group_norm_bwd_plain(x, dh, num_groups: int, weight, bias, eps: float, act=None,
                         stats=None):
    """(dx in x's dtype, dgamma fp32 (C,), dbeta fp32 (C,)) of
    :func:`group_norm_plain` for the cotangent ``dh`` (the JAX ``_gn2_bwd``)."""
    mean, rstd = group_norm_stats_plain(x, num_groups, eps) if stats is None else stats
    xf, dhf = _view(x).float(), _view(dh).float()
    n, c, s = xf.shape
    g, cg = num_groups, c // num_groups
    scale, shift = _scale_shift(mean, rstd, weight, bias, cg)
    dy = dhf * _act_grad(xf * scale + shift, act)
    t1, t2 = dy.sum(dim=2), (dy * xf).sum(dim=2)  # (N, C)
    w = torch.ones(c, device=x.device) if weight is None else weight.float()
    wt1 = (t1 * w).reshape(n, g, cg).sum(dim=2)
    wt2 = (t2 * w).reshape(n, g, cg).sum(dim=2)
    cnt = cg * s
    m_dxhat = wt1 / cnt
    m_dxhat_xhat = (wt2 - mean * wt1) * rstd / cnt
    b_g = -(rstd * rstd * m_dxhat_xhat)
    c_g = -rstd * m_dxhat - mean * b_g

    def rep(a):  # (N, G) -> (N, C, 1)
        return a.repeat_interleave(cg, dim=1)[..., None]

    dx = dy * (rep(rstd) * w[None, :, None]) + xf * rep(b_g) + rep(c_g)
    dgamma = ((t2 - rep(mean)[..., 0] * t1) * rep(rstd)[..., 0]).sum(dim=0)
    return dx.to(x.dtype).reshape(x.shape), dgamma, t1.sum(dim=0)


def _vec(s: int, *tensors) -> int:
    """Elements per 16-byte load when a row of S elements holds whole loads
    and every tensor's base is 16-byte aligned, else 1 (the kernels then
    load one element at a time)."""
    v = 16 // tensors[0].element_size()
    return v if s % v == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


class Plan(NamedTuple):
    """How a fast kernel splits one call (``Plan`` in csrc/gn.cuh);
    sizes in 16-byte vectors of one tensor."""

    k: int  # CTAs per (n, g) group, one thread block cluster (1: no cluster)
    slice: int  # one CTA's part of a group (the whole group when k == 1)
    staged: int  # what a CTA stages in shared memory of each tensor
    reread: int  # the rest of a slice: read from HBM, then again from L2
    chunk: int  # per bulk copy
    smem: int  # dynamic shared memory of a CTA, bytes


@functools.lru_cache(maxsize=1024)
def plan(n: int, c: int, s: int, groups: int, dtype, direction: str) -> Plan:
    """The fast kernel's split of an (N, C, S) call with ``groups`` groups of
    ``dtype`` for ``direction`` "fwd" (x staged) or "bwd" (x and dh). A
    group of more than :data:`SLICE_BYTES` goes to a cluster of k CTAs, as
    few as bring each slice under it, at most 8, the slices whole vectors
    and none empty. A CTA stages its slice up to the shared memory left
    beside its mbarriers, partials and channel arrays, and a backward slice
    still over :data:`SLICE_BYTES` (the 8 CTAs' share of a group of SDXL's
    largest levels) up to :data:`BWD_STAGE_BYTES`, so that three CTAs share
    an SM; past that a slice is read twice (``reread``), the second time
    from L2."""
    nt = {"fwd": 1, "bwd": 2}[direction]
    vec = 16 // _ELEM[dtype]
    if s % vec or c % groups:
        raise ValueError(f"group_norm plan: S={s}, C={c}, groups={groups} for the fast variant")
    cg = c // groups
    gvec = cg * (s // vec)
    k = min(MAX_CLUSTER, max(1, -(-16 * nt * gvec // SLICE_BYTES)))
    part = -(-gvec // k)
    k = -(-gvec // part)  # no empty slice
    chunk = CHUNK_BYTES // 16
    fixed = 4 * (2 * _WARPS + 4) + 4 * (nt + 1) * cg  # partials, channel arrays
    room = SMEM_MAX - fixed - 8 * 16  # 16 mbarriers at most
    if direction == "bwd" and 16 * nt * part > SLICE_BYTES:
        room = min(room, BWD_STAGE_BYTES)
    staged = min(part, room // (16 * nt))
    smem = 16 * nt * staged + 8 * -(-staged // chunk) + fixed
    return Plan(k, part, staged, part - staged, chunk, smem)


@functools.lru_cache(maxsize=1024)
def _active_clusters(direction: str, dtype, act, k: int, smem: int, device: int) -> int:
    out = ctypes.c_int(0)
    fn = getattr(_build.lib(), f"lyc_gn_{direction}_fast_clusters")
    rc = fn(k, smem, _ACT_CODES[act], _build.DTYPE_CODES[str(dtype)], ctypes.byref(out))
    _build.check(rc, f"lyc_gn_{direction}_fast_clusters")
    return out.value


def fast_clusters(pl: Plan, direction: str, dtype, act, device=0) -> int:
    """How many clusters of ``pl.k`` CTAs of the fast kernel with
    ``pl.smem`` bytes each the card holds at once
    (cudaOccupancyMaxActiveClusters; with k = 1, CTAs)."""
    return _active_clusters(direction, dtype, act, pl.k, pl.smem, device)


def grid(pl: Plan, groups_total: int, active: int) -> int:
    """CTAs of a fast launch: at most ``active`` clusters (what the card
    holds at once) and one a group, each taking as many groups as the
    busiest must, in turn."""
    turns = -(-groups_total // max(1, active))
    return -(-groups_total // turns) * pl.k


def variant(x, num_groups: int, *others) -> str:
    """"fast" for bf16 or fp32 ``x`` (N, C, *spatial) whose (n, c) rows hold
    whole 16-byte vectors, with it and ``others`` (dh, the outputs) 16-byte
    aligned and at most :data:`MAX_CG` channels a group, else "generic"."""
    _, c, s = _view(x).shape
    ok = x.dtype in _ELEM and c // num_groups <= MAX_CG and _vec(s, x, *others) > 1
    return "fast" if ok else "generic"


def _contiguous(t):
    global copies
    if t.is_contiguous():
        return t
    copies += 1
    return t.contiguous()


def _check(name, x, num_groups, weight, bias, act):
    _build.check_cuda_inputs(name, *[t for t in (x, weight, bias) if t is not None])
    c = x.shape[1] if x.ndim >= 2 else 0
    if x.ndim < 2 or c % num_groups:
        raise ValueError(f"{name}: x {tuple(x.shape)} with {num_groups} groups")
    for t in (weight, bias):
        if t is not None and (t.shape != (c,) or not t.is_contiguous()):
            raise ValueError(f"{name}: weight/bias {tuple(t.shape)} for C={c}")
    if act not in ACTS:
        raise ValueError(f"{name}: unsupported act {act!r}")


def _parts(s: int) -> tuple[int, int]:
    """(elements per part, parts per row) of a row of S elements."""
    part = min(s, PART_LEN)
    return part, -(-s // part)


def group_norm_fwd(x, num_groups: int, weight, bias, eps: float, act=None):
    """The forward kernel on CUDA tensors: (y, mean (N, G) fp32, rstd (N, G)
    fp32), by the variant :func:`variant` names."""
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm: no kernel for device {x.device}")
    _check("group_norm", x, num_groups, weight, bias, act)
    x = _contiguous(x)
    fn = fwd_fast if variant(x, num_groups) == "fast" else fwd_generic
    return fn(x, num_groups, weight, bias, eps, act)


def _fwd_outputs(x, num_groups):
    n = x.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty_like(x), torch.empty((n, num_groups), **f32),
            torch.empty((n, num_groups), **f32))


def fwd_fast(x, num_groups: int, weight, bias, eps: float, act=None):
    """The fast forward (one launch) on a checked, contiguous CUDA ``x`` that
    :func:`variant` calls fast; :func:`group_norm_fwd` picks it. The C entry
    refuses other inputs."""
    global launches, fast_launches
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm: no kernel for device {x.device}")
    n, c, s = _view(x).shape
    pl = plan(n, c, s, num_groups, x.dtype, "fwd")
    ctas = grid(pl, n * num_groups, fast_clusters(pl, "fwd", x.dtype, act, x.device.index))
    y, mean, rstd = _fwd_outputs(x, num_groups)
    rc = _build.lib().lyc_gn_fwd_fast(
        x.data_ptr(), _build.ptr(weight), _build.ptr(bias), y.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), n, c, s, num_groups, pl.k, pl.slice, pl.staged, pl.chunk,
        ctas, float(eps), _ACT_CODES[act], _build.dtype_code(x), _build.stream_ptr(x),
    )
    _build.check(rc, "lyc_gn_fwd_fast")
    launches += 1
    fast_launches += 1
    return y, mean, rstd


def fwd_generic(x, num_groups: int, weight, bias, eps: float, act=None):
    """The generic forward (three launches) on a checked, contiguous CUDA
    ``x`` of any layout of S; :func:`group_norm_fwd` picks it where the fast
    one does not apply."""
    global launches, generic_launches
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm: no kernel for device {x.device}")
    n, c, s = _view(x).shape
    y, mean, rstd = _fwd_outputs(x, num_groups)
    vec = _vec(s, x, y)
    part, nparts = _parts(s)
    scratch = torch.empty((2, n * c * nparts), dtype=torch.float32, device=x.device)
    rc = _build.lib().lyc_gn_fwd(
        x.data_ptr(), _build.ptr(weight), _build.ptr(bias), y.data_ptr(),
        scratch[0].data_ptr(), scratch[1].data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        n, c, s, num_groups, part, nparts, float(eps), _ACT_CODES[act], vec,
        _build.dtype_code(x), _build.stream_ptr(x),
    )
    _build.check(rc, "lyc_gn_fwd")
    launches += 1
    generic_launches += 1
    return y, mean, rstd


def group_norm_bwd(x, dh, num_groups: int, weight, bias, mean, rstd, act=None,
                   want_wb: bool = True):
    """The backward kernel on CUDA tensors: (dx, dgamma fp32, dbeta fp32), or
    (dx, None, None) when ``want_wb`` is False (frozen gamma and beta), by the
    variant :func:`variant` names for x and dh."""
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm_bwd: no kernel for device {x.device}")
    _check("group_norm_bwd", x, num_groups, weight, bias, act)
    _build.check_cuda_inputs("group_norm_bwd", x, dh)
    if dh.shape != x.shape:
        raise ValueError(f"group_norm_bwd: dh {tuple(dh.shape)} for x {tuple(x.shape)}")
    x, dh = _contiguous(x), _contiguous(dh)
    mean, rstd = mean.contiguous(), rstd.contiguous()
    n = x.shape[0]
    if mean.shape != (n, num_groups) or rstd.shape != (n, num_groups):
        raise ValueError(f"group_norm_bwd: mean/rstd {tuple(mean.shape)} for ({n}, {num_groups})")
    global bwd_wb_launches
    fn = bwd_fast if variant(x, num_groups, dh) == "fast" else bwd_generic
    out = fn(x, dh, num_groups, weight, bias, mean, rstd, act, want_wb)
    bwd_wb_launches += int(want_wb)
    return out


def _wb_outputs(c, dev, want_wb):
    if not want_wb:
        return None, None
    f32 = dict(dtype=torch.float32, device=dev)
    return torch.empty(c, **f32), torch.empty(c, **f32)


def bwd_fast(x, dh, num_groups: int, weight, bias, mean, rstd, act=None, want_wb: bool = True):
    """The fast backward (one launch for dx; the per-channel sums and the
    dgamma/dbeta kernel only with ``want_wb``) on checked, contiguous CUDA
    inputs that :func:`variant` calls fast; :func:`group_norm_bwd` picks it."""
    global bwd_launches, bwd_fast_launches
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm_bwd: no kernel for device {x.device}")
    n, c, s = _view(x).shape
    pl = plan(n, c, s, num_groups, x.dtype, "bwd")
    ctas = grid(pl, n * num_groups, fast_clusters(pl, "bwd", x.dtype, act, x.device.index))
    dx = torch.empty_like(x)
    dgamma, dbeta = _wb_outputs(c, x.device, want_wb)
    tsum = (torch.empty((2, pl.k * n * c), dtype=torch.float32, device=x.device)
            if want_wb else None)
    rc = _build.lib().lyc_gn_bwd_fast(
        x.data_ptr(), dh.data_ptr(), _build.ptr(weight), _build.ptr(bias),
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
        _build.ptr(None if tsum is None else tsum[0]), _build.ptr(None if tsum is None else tsum[1]),
        _build.ptr(dgamma), _build.ptr(dbeta), n, c, s, num_groups, pl.k, pl.slice, pl.staged,
        pl.chunk, ctas, _ACT_CODES[act], _build.dtype_code(x), _build.stream_ptr(x),
    )
    _build.check(rc, "lyc_gn_bwd_fast")
    bwd_launches += 1
    bwd_fast_launches += 1
    return dx, dgamma, dbeta


def bwd_generic(x, dh, num_groups: int, weight, bias, mean, rstd, act=None,
                want_wb: bool = True):
    """The generic backward (three launches, four with ``want_wb``) on
    checked, contiguous CUDA inputs of any layout of S."""
    global bwd_launches, bwd_generic_launches
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm_bwd: no kernel for device {x.device}")
    n, c, s = _view(x).shape
    dx = torch.empty_like(x)
    vec = _vec(s, x, dh, dx)
    part, nparts = _parts(s)
    f32 = dict(dtype=torch.float32, device=x.device)
    scratch = torch.empty((2, n * c * nparts), **f32)
    coef = torch.empty((n * num_groups, 2), **f32)
    dgamma, dbeta = _wb_outputs(c, x.device, want_wb)
    tsum = torch.empty((2, n * c), **f32) if want_wb else None
    rc = _build.lib().lyc_gn_bwd(
        x.data_ptr(), dh.data_ptr(), _build.ptr(weight), _build.ptr(bias),
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
        scratch[0].data_ptr(), scratch[1].data_ptr(), coef.data_ptr(),
        _build.ptr(None if tsum is None else tsum[0]), _build.ptr(None if tsum is None else tsum[1]),
        _build.ptr(dgamma), _build.ptr(dbeta), n, c, s, num_groups, part, nparts,
        _ACT_CODES[act], vec, _build.dtype_code(x), _build.stream_ptr(x),
    )
    _build.check(rc, "lyc_gn_bwd")
    bwd_launches += 1
    bwd_generic_launches += 1
    return dx, dgamma, dbeta


class GroupNormFunction(torch.autograd.Function):
    """GroupNorm(+act) whose directions are the ``gn_fwd``/``gn_bwd`` kernels
    on the card (the plain versions on the CPU). Saves x, gamma, beta and the
    per-group (mean, rstd); dgamma/dbeta only where needed."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, act):
        if x.device.type == "cpu":
            mean, rstd = group_norm_stats_plain(x, num_groups, eps)
            y = group_norm_plain(x, num_groups, weight, bias, eps, act, (mean, rstd))
        else:
            y, mean, rstd = group_norm_fwd(x, num_groups, weight, bias, eps, act)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.num_groups, ctx.eps, ctx.act = num_groups, eps, act
        return y

    @staticmethod
    def backward(ctx, dh):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        want_wb = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        if x.device.type == "cpu":
            dx, dw, db = group_norm_bwd_plain(x, dh, ctx.num_groups, weight, bias, ctx.eps,
                                              ctx.act, (mean, rstd))
        else:
            dx, dw, db = group_norm_bwd(x, dh, ctx.num_groups, weight, bias, mean, rstd,
                                        ctx.act, want_wb)
        dw = dw.to(weight.dtype) if ctx.needs_input_grad[1] else None
        db = db.to(bias.dtype) if ctx.needs_input_grad[2] else None
        return dx, dw, db, None, None, None


def group_norm_act(x, num_groups: int, weight=None, bias=None, eps: float = 1e-5, act=None):
    """act(GroupNorm(x)) of channels-first ``x`` (N, C, *spatial), gamma/beta
    (C,) or None, ``act`` None or "silu"; differentiable in all three."""
    if act not in ACTS:
        raise ValueError(f"unsupported folded act {act!r}")
    return GroupNormFunction.apply(x, weight, bias, int(num_groups), float(eps), act)
