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

:func:`group_norm_act` is a :class:`GroupNormFunction`: its forward saves x,
gamma, beta and the fp32 (mean, rstd) per group, its backward runs the
backward kernel (dgamma/dbeta only where asked for). Each direction takes
its plain version (:func:`group_norm_plain`, :func:`group_norm_bwd_plain`)
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import math

import torch

from . import _build

launches = 0  # forward kernel launches since the last reset (chip_smoke counts these)
bwd_launches = 0  # backward kernel launches, likewise
copies = 0  # inputs the wrappers had to make contiguous (NCHW) first

ACTS = (None, "silu")
_ACT_CODES = {None: 0, "silu": 1}
PART_LEN = 4096  # elements of one (n, c) row that one warp sums (a multiple of 8)


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
    """The forward kernel on CUDA tensors: (y, mean (N, G) fp32, rstd (N, G) fp32)."""
    global launches
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm: no kernel for device {x.device}")
    _check("group_norm", x, num_groups, weight, bias, act)
    x = _contiguous(x)
    n, c, s = _view(x).shape
    y = torch.empty_like(x)
    vec = _vec(s, x, y)
    part, nparts = _parts(s)
    f32 = dict(dtype=torch.float32, device=x.device)
    scratch = torch.empty((2, n * c * nparts), **f32)
    mean, rstd = torch.empty((n, num_groups), **f32), torch.empty((n, num_groups), **f32)
    rc = _build.lib().lyc_gn_fwd(
        x.data_ptr(), _build.ptr(weight), _build.ptr(bias), y.data_ptr(),
        scratch[0].data_ptr(), scratch[1].data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        n, c, s, num_groups, part, nparts, float(eps), _ACT_CODES[act], vec,
        _build.dtype_code(x), _build.stream_ptr(x),
    )
    _build.check(rc, "lyc_gn_fwd")
    launches += 1
    return y, mean, rstd


def group_norm_bwd(x, dh, num_groups: int, weight, bias, mean, rstd, act=None,
                   want_wb: bool = True):
    """The backward kernel on CUDA tensors: (dx, dgamma fp32, dbeta fp32), or
    (dx, None, None) when ``want_wb`` is False (frozen gamma and beta)."""
    global bwd_launches
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm_bwd: no kernel for device {x.device}")
    _check("group_norm_bwd", x, num_groups, weight, bias, act)
    _build.check_cuda_inputs("group_norm_bwd", x, dh)
    if dh.shape != x.shape:
        raise ValueError(f"group_norm_bwd: dh {tuple(dh.shape)} for x {tuple(x.shape)}")
    x, dh = _contiguous(x), _contiguous(dh)
    mean, rstd = mean.contiguous(), rstd.contiguous()
    n, c, s = _view(x).shape
    if mean.shape != (n, num_groups) or rstd.shape != (n, num_groups):
        raise ValueError(f"group_norm_bwd: mean/rstd {tuple(mean.shape)} for ({n}, {num_groups})")
    dx = torch.empty_like(x)
    vec = _vec(s, x, dh, dx)
    part, nparts = _parts(s)
    f32 = dict(dtype=torch.float32, device=x.device)
    scratch = torch.empty((2, n * c * nparts), **f32)
    coef = torch.empty((n * num_groups, 2), **f32)
    tsum = dgamma = dbeta = None
    if want_wb:
        tsum = torch.empty((2, n * c), **f32)
        dgamma, dbeta = torch.empty(c, **f32), torch.empty(c, **f32)
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
