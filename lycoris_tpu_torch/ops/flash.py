"""Flash attention: the CUDA kernels ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``.

Counterpart of ``lycoris_tpu/ops/flash.py`` (``_fwd``/``_fwd_dt`` and the
fused backward ``_bwd_call``/``_bwd_dt_call``). The kernels read q, k, v
(and dO) through their batch/head/token strides (head dim contiguous), so
the head-split projections feed them without a copy, and write O, dq, dk
and dv into (B, T, H, D) buffers that the projections read, or take the
gradient of, as (B, T, C).

The bf16 kernels load their tiles by TMA, which needs a 16-byte aligned
base, strides that are multiples of 8 elements and a head dim that is a
multiple of 8. Every self-attention of the UNets meets this as the
head-split projections produce it; an input that does not
(:func:`needs_pad`) is copied into a zero-padded (B, T, H, Dp) buffer
(:func:`pad_head_dim`), counted in ``pad_copies``.

:func:`flash_attention` is a :class:`FlashAttentionFunction`: its forward
saves q, k, v, o and the fp32 logsumexp; its backward runs the backward
kernels, whose C entry also forms di = rowsum(dO * O) in fp32. Each
direction takes its plain version (:func:`flash_attention_plain`,
:func:`flash_attention_bwd_plain`) only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0  # forward kernel launches since the last reset (chip_smoke counts these)
bwd_launches = 0  # backward kernel launches, likewise
pad_copies = 0  # bf16 inputs copied into a padded buffer for TMA (0 on the UNet paths)


def flash_attention_plain(q, k, v, sm_scale: float):
    """softmax(q k^T * sm_scale) v in fp32; returns (o in q's dtype, lse (B, H, T) fp32)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, sm_scale: float):
    """(dq, dk, dv) in q's dtype: fp32 einsums of the backward kernel's
    formulas, P recomputed from the saved lse."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    di = (dof * o.float()).sum(-1)
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - di[..., None]) * sm_scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _bthd_empty(like):
    """A (B, H, T, D) view of a new (B, T, H, D) buffer."""
    b, h, t, d = like.shape
    return torch.empty((b, t, h, d), dtype=like.dtype, device=like.device).transpose(1, 2)


def needs_pad(x) -> bool:
    """True if the bf16 kernels' TMA cannot read the (B, H, T, D) operand
    ``x`` in place: a head dim that is not contiguous or not a multiple of
    8, a base that is not 16-byte aligned, or a batch/head/token stride
    (of an extent above 1) that is not a multiple of 8 elements."""
    if x.stride(-1) != 1 or x.shape[-1] % 8 or x.data_ptr() % 16:
        return True
    return any(s % 8 for s, n in zip(x.stride()[:3], x.shape[:3]) if n > 1)


def pad_head_dim(x):
    """``x`` (B, H, T, D) as a (B, H, T, Dp) view of a new (B, T, H, Dp)
    buffer, Dp = D rounded up to 8, zero past D; counted in ``pad_copies``."""
    global pad_copies
    b, h, t, d = x.shape
    out = x.new_zeros((b, t, h, -(-d // 8) * 8)).transpose(1, 2)
    out[..., :d] = x
    pad_copies += 1
    return out


def _tma_ready(*xs):
    """bf16 operands as the kernels' TMA reads them: padded where needed."""
    if xs[0].dtype != torch.bfloat16:
        return xs
    return tuple(pad_head_dim(x) if needs_pad(x) else x for x in xs)


def _check(name, q, k, v):
    _build.check_cuda_inputs(name, q, k, v)
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if not 1 <= q.shape[-1] <= 128:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} not in [1, 128]")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError(f"{name}: head dim must be contiguous")


def flash_fwd(q, k, v, sm_scale: float):
    """The forward kernel on CUDA tensors: (o (B, H, T, D), lse (B, H, T) fp32)."""
    global launches
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    _check("flash_attention", q, k, v)
    b, h, t, d = q.shape
    o = _bthd_empty(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    qp, kp, vp = _tma_ready(q, k, v)
    strides = (ctypes.c_longlong * 12)(
        *[s for x in (qp, kp, vp, o) for s in x.stride()[:3]]
    )
    rc = _build.lib().lyc_flash_fwd(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, h, t, d, strides, float(sm_scale), _build.dtype_code(q), _build.stream_ptr(q),
    )
    _build.check(rc, "lyc_flash_fwd")
    launches += 1
    return o, lse


def flash_bwd(q, k, v, o, lse, do, sm_scale: float):
    """The backward kernel on CUDA tensors: (dq, dk, dv), each a (B, H, T, D)
    view of a (B, T, H, D) buffer, in q's dtype."""
    global bwd_launches
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_bwd: no kernel for device {q.device}")
    do, o = (x if x.stride(-1) == 1 else x.contiguous() for x in (do, o))
    _check("flash_attention_bwd", q, k, v)
    _build.check_cuda_inputs("flash_attention_bwd", q, o, do)
    if do.shape != q.shape or o.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} dO {tuple(do.shape)} "
                         f"lse {tuple(lse.shape)}")
    b, h, t, d = q.shape
    lse = lse.float().contiguous()
    di = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    dq, dk, dv = _bthd_empty(q), _bthd_empty(q), _bthd_empty(q)
    qp, kp, vp, dop = _tma_ready(q, k, v, do)
    strides = (ctypes.c_longlong * 24)(
        *[s for x in (qp, kp, vp, dop, dq, dk, dv, o) for s in x.stride()[:3]]
    )
    rc = _build.lib().lyc_flash_bwd(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(), dop.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, t, d, strides,
        float(sm_scale), _build.dtype_code(q), _build.stream_ptr(q),
    )
    _build.check(rc, "lyc_flash_bwd")
    bwd_launches += 1
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention whose backward is the ``flash_bwd`` kernel on the card
    (the plain backward on the CPU). Returns (o, lse); lse carries no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        if q.device.type == "cpu":
            o, lse = flash_attention_plain(q, k, v, sm_scale)
        else:
            o, lse = flash_fwd(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale = sm_scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do, ctx.sm_scale)
        else:
            dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.sm_scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, sm_scale: float):
    """Non-causal attention of (B, H, T, D) q, k, v -> (o (B, H, T, D), lse
    (B, H, T) fp32), differentiable in q, k and v."""
    return FlashAttentionFunction.apply(q, k, v, float(sm_scale))
