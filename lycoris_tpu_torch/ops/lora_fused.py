"""Fused LoRA matmul y = x @ (W + scale * up @ down)^T: the CUDA kernels of
``csrc/lora_fused.cu`` (counterpart of ``lycoris_tpu/ops/lora_fused.py``).

The kernel builds each tile of the effective weight in shared memory, W in
fp32 plus scale times the rank-R product, rounded to x's dtype, and
contracts it against the x tile with fp32 accumulation: no (N, K) weight is
written. :func:`fused_lora_matmul` is a differentiable op
(:class:`FusedLoraMatmul`): its backward takes dx from the same kernel with
the weight not transposed (``lyc_lora_fused_nn``), and the factor gradients
``d_up = scale * g^T (x down^T)`` and ``d_down = scale * (g up)^T x`` from
fp32 ``torch.matmul``, as the JAX package leaves them to XLA outside its
kernel. W gets no gradient.

Neither package dispatches this op on its adapter path: the JAX package
measured it slower than the merged path on its own hardware, and the
wrapper here keeps the merged path too (``chip_smoke.py`` times the fused
kernels against that merged route on the card). The TPU kernel's tile
divisibility rules are a Mosaic layout constraint and are not ported: the
CUDA kernels mask ragged edges. :func:`supported` keeps the JAX package's
size minimums.

Each direction takes its plain version (:func:`fused_lora_matmul_plain`,
:func:`fused_lora_dx_plain`) only for tensors on the CPU; for CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build

launches = 0  # nt (forward) kernel launches since the last reset
dx_launches = 0  # nn (input-gradient) kernel launches, likewise


def supported(x_shape, w_shape) -> bool:
    """The JAX package's minimums: M >= 8 rows, N >= 128, K >= 128."""
    m = math.prod(x_shape[:-1])
    n, k = w_shape
    return m >= 8 and n >= 128 and k >= 128


def effective_weight_plain(w, down, up, scale, dtype):
    """W + scale * up @ down in fp32, rounded to ``dtype`` as the kernel
    rounds each tile before the product."""
    return (w.float() + scale * (up.float() @ down.float())).to(dtype)


def fused_lora_matmul_plain(x, w, down, up, scale=1.0):
    """y (..., N) = x (..., K) @ W_eff^T, W_eff in x's dtype; y in x's dtype."""
    return F.linear(x, effective_weight_plain(w, down, up, scale, x.dtype))


def fused_lora_dx_plain(g, w, down, up, scale=1.0):
    """dx (..., K) = g (..., N) @ W_eff, W_eff in g's dtype; dx in g's dtype."""
    return g @ effective_weight_plain(w, down, up, scale, g.dtype)


def _launch(entry, a, w, down, up, scale, nn: bool):
    if a.device.type != "cuda":
        raise RuntimeError(f"fused_lora_matmul: no kernel for device {a.device}")
    n, k = w.shape
    r = down.shape[0]
    inner = n if nn else k
    for t in (w, down, up):
        if t.device != a.device:
            raise ValueError(f"fused_lora_matmul: tensors on {t.device} and {a.device}")
    if a.shape[-1] != inner or down.shape != (r, k) or up.shape != (n, r):
        raise ValueError(
            f"fused_lora_matmul: a {tuple(a.shape)}, w {tuple(w.shape)}, "
            f"down {tuple(down.shape)}, up {tuple(up.shape)}"
        )
    lead = a.shape[:-1]
    a2 = a.reshape(-1, inner).contiguous()
    w_ = w.contiguous()
    down_, up_ = down.float().contiguous(), up.float().contiguous()
    out = torch.empty((a2.shape[0], k if nn else n), dtype=a.dtype, device=a.device)
    rc = getattr(_build.lib(), entry)(
        a2.data_ptr(), w_.data_ptr(), down_.data_ptr(), up_.data_ptr(), out.data_ptr(),
        a2.shape[0], n, k, r, float(scale), _build.dtype_code(a), _build.dtype_code(w_),
        _build.stream_ptr(a),
    )
    _build.check(rc, entry)
    return out.reshape(*lead, out.shape[-1])


def lora_fused_nt(x, w, down, up, scale=1.0):
    """The forward kernel on CUDA tensors: x (..., K), w (N, K), down (R, K),
    up (N, R) -> y (..., N) in x's dtype."""
    global launches
    y = _launch("lyc_lora_fused_nt", x, w, down, up, scale, nn=False)
    launches += 1
    return y


def lora_fused_nn(g, w, down, up, scale=1.0):
    """The input-gradient kernel on CUDA tensors: g (..., N) -> dx (..., K)
    in g's dtype."""
    global dx_launches
    dx = _launch("lyc_lora_fused_nn", g, w, down, up, scale, nn=True)
    dx_launches += 1
    return dx


class FusedLoraMatmul(torch.autograd.Function):
    """y = x @ (W + scale * up @ down)^T; gradients for x, down and up."""

    @staticmethod
    def forward(ctx, x, w, down, up, scale):
        ctx.save_for_backward(x, w, down, up)
        ctx.scale = scale
        if x.device.type == "cpu":
            return fused_lora_matmul_plain(x, w, down, up, scale)
        return lora_fused_nt(x, w, down, up, scale)

    @staticmethod
    def backward(ctx, g):
        x, w, down, up = ctx.saved_tensors
        scale = ctx.scale
        dx = d_down = d_up = None
        if ctx.needs_input_grad[0]:
            if g.device.type == "cpu":
                dx = fused_lora_dx_plain(g, w, down, up, scale)
            else:
                dx = lora_fused_nn(g.contiguous(), w, down, up, scale)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            x2 = x.reshape(-1, x.shape[-1]).float()
            g2 = g.reshape(-1, g.shape[-1]).float()
            d_up = (scale * (g2.T @ (x2 @ down.float().T))).to(up.dtype)
            d_down = (scale * ((g2 @ up.float()).T @ x2)).to(down.dtype)
        return dx, None, d_down, d_up, None


def fused_lora_matmul(x, w, down, up, scale=1.0):
    """x (..., K); w (N, K) torch layout; down (R, K); up (N, R) -> (..., N)
    in x's dtype, differentiable in x, down and up."""
    return FusedLoraMatmul.apply(x, w, down, up, float(scale))
