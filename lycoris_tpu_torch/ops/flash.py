"""Flash attention forward: the CUDA kernel ``csrc/flash_fwd.cu``.

Counterpart of ``lycoris_tpu/ops/flash.py`` ``_fwd``/``_fwd_dt`` (forward
only; the fused backward belongs to the training slice). The kernel reads
q, k, v through their batch/head/token strides (head dim contiguous), so
the head-split projections feed it without a copy, and writes O into a
(B, T, H, D) buffer that the output projection reads as (B, T, C).

:func:`flash_attention` takes the plain version :func:`flash_attention_plain`
only for tensors on the CPU. For CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0  # kernel launches since the last reset (chip_smoke counts these)


def flash_attention_plain(q, k, v, sm_scale: float):
    """softmax(q k^T * sm_scale) v in fp32; returns (o in q's dtype, lse (B, H, T) fp32)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


def flash_attention(q, k, v, sm_scale: float):
    """Non-causal attention of (B, H, T, D) q, k, v -> (o (B, H, T, D), lse (B, H, T))."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    _build.check_cuda_inputs("flash_attention", q, k, v)
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}"
        )
    b, h, t, d = q.shape
    if not 1 <= d <= 128:
        raise ValueError(f"flash_attention: head_dim {d} not in [1, 128]")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention: head dim must be contiguous")
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *[s for x in (q, k, v, o) for s in x.stride()[:3]]
    )
    lib = _build.lib()
    rc = lib.lyc_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, h, t, d, strides, float(sm_scale), _build.dtype_code(q), _build.stream_ptr(q),
    )
    _build.check(rc, "lyc_flash_fwd")
    launches += 1
    return o, lse
