"""LayerNorm forward over the last dim: the CUDA kernel ``csrc/ln_fwd.cu``.

Counterpart of ``lycoris_tpu/ops/layer_norm.py`` (forward only; the
backward kernel belongs to the training slice). The TPU gate
``512 <= C <= 8192`` was a TPU measurement and is not carried over: on the
card every affine single-dim LayerNorm runs the kernel.

:func:`layer_norm` takes the plain version :func:`layer_norm_plain` only
for a tensor on the CPU. For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0  # kernel launches since the last reset (chip_smoke counts these)


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


def layer_norm(x, weight, bias, eps: float):
    """LayerNorm of ``x`` (..., C) with ``weight``/``bias`` (C,) in x's dtype."""
    global launches
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"layer_norm: no kernel for device {x.device}")
    c = x.shape[-1]
    if bias is None:
        bias = torch.zeros_like(weight)
    _build.check_cuda_inputs("layer_norm", x, weight, bias)
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"layer_norm: weight/bias {tuple(weight.shape)} for C={c}")
    if not (x.is_contiguous() and weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("layer_norm: kernel needs contiguous tensors")
    y = torch.empty_like(x)
    rows = x.numel() // c
    lib = _build.lib()
    rc = lib.lyc_ln_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        rows, c, float(eps), _build.dtype_code(x), _build.stream_ptr(x),
    )
    _build.check(rc, "lyc_ln_fwd")
    launches += 1
    return y
