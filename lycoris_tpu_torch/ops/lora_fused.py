"""Fused LoRA matmul y = x @ (W + scale * up @ down)^T: the CUDA kernels of
``csrc/lora_fused.cu`` (counterpart of ``lycoris_tpu/ops/lora_fused.py``).

The kernels build the effective weight tile by tile on chip, W in fp32
plus scale times the rank-R product, rounded to x's dtype, and contract it
against the x tile with fp32 accumulation: no (N, K) weight is written.
:func:`fused_lora_matmul` is a differentiable op
(:class:`FusedLoraMatmul`): its backward takes dx from the same kernel
with the weight not transposed (nn), and the factor gradients ``d_up =
scale * g^T (x down^T)`` and ``d_down = scale * (g up)^T x`` from fp32
``torch.matmul``, as the JAX package leaves them to XLA outside its
kernel. W gets no gradient.

Neither package dispatches this op on its adapter path: the JAX package
measured it slower than the merged path on its own hardware, and the
wrapper here keeps the merged path too (``chip_smoke.py`` times the fused
kernels against that merged route on the card). The TPU kernel's tile
divisibility rules are a Mosaic layout constraint and are not ported: the
CUDA kernels mask ragged edges. :func:`supported` keeps the JAX package's
size minimums.

Both directions have two variants (:func:`variant` chooses, here in
Python): a fast one for bf16 activations and a bf16 W, the dtypes of every
LoRA leg (TMA ring, ``wgmma``, W_eff written to shared memory a stage ahead
by a warpgroup of its own; N and K multiples of 8, 16-byte aligned tensors),
and a generic one for every other dtype pair. Both take any rank.
:func:`fast_plan` sizes the fast variant's persistent grid and, where the
output tiles cannot fill the card, cuts the contraction into slices whose
fp32 partial sums a second kernel adds in a fixed order.

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
launches_fast = 0  # of the nt launches, those of the fast variant
dx_launches_fast = 0  # of the nn launches, those of the fast variant

# the fast variant's tiles (lora_fused.cu, namespace fast): BM output rows
# (128 or 256) by BP output columns, the contraction BC deep a stage
_FAST_BMS, _FAST_BP, _FAST_BC = (256, 128), 128, 64
_MAX_SPLITS = 8
_MIN_SLICE = 3  # stages of the contraction a slice walks at least
# relative cost of a 128-row tile's stage against a 256-row one, per output:
# a 128 x 128 tile loads 64 FLOP a byte from L2, a 256 x 128 one 85
_BM128_COST = 1.4
_sms: dict = {}  # device index -> SM count


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


def variant(a, w) -> str:
    """"fast" for bf16 ``a`` and ``w`` whose widths are multiples of 8 and
    whose data is 16-byte aligned (the fast kernel reads them by TMA), else
    "generic"."""
    n, k = w.shape
    ok = (a.dtype == w.dtype == torch.bfloat16 and n % 8 == 0 and k % 8 == 0
          and a.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    return "fast" if ok else "generic"


def fast_plan(m: int, p: int, c: int, sms: int) -> tuple[int, int, int]:
    """(bm, splits, grid) of the fast kernel for M = ``m`` rows, ``p`` output
    columns and a contraction of ``c``. For each tile height bm, where the
    output tiles leave SMs idle (the attn2 k/v layers, M = batch x 77) the
    contraction is cut into slices of at least ``_MIN_SLICE`` stages, as many
    as fill the card, at most ``_MAX_SPLITS``; the grid is one persistent
    block per SM at most. The height with the fewer rounds of tiles x stages
    a tile (weighted by its cost per output) wins, 256 on a tie."""
    best = None
    for bm in _FAST_BMS:
        tiles = -(-m // bm) * -(-p // _FAST_BP)
        steps = -(-c // _FAST_BC)
        splits = max(1, min(sms // tiles, steps // _MIN_SLICE, _MAX_SPLITS))
        cps = -(-steps // splits)
        splits = -(-steps // cps)  # no empty slice
        grid = min(tiles * splits, sms)
        cost = -(-tiles * splits // grid) * cps * bm * (_BM128_COST if bm == 128 else 1.0)
        if best is None or cost < best[0]:
            best = (cost, bm, splits, grid)
    return best[1:]


def _sm_count(dev) -> int:
    n = _sms.get(dev.index)
    if n is None:
        n = _sms[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def _factor(t):
    """An fp32 contiguous factor: the tensor itself where it is one."""
    if not t.is_floating_point():
        raise TypeError(f"fused_lora_matmul: factor dtype {t.dtype}")
    if t.dtype != torch.float32:
        t = t.float()
    return t if t.is_contiguous() else t.contiguous()


def _launch(a, w, down, up, scale, nn: bool):
    """Launch the variant :func:`variant` names; returns (out, fast)."""
    if a.device.type != "cuda":
        raise RuntimeError(f"fused_lora_matmul: no kernel for device {a.device}")
    n, k = w.shape
    r = down.shape[0]
    inner = n if nn else k
    for t in (w, down, up):
        if t.device != a.device:
            raise ValueError(f"fused_lora_matmul: tensors on {t.device} and {a.device}")
    if a.shape[-1] != inner or down.shape != (r, k) or up.shape != (n, r) or r < 1:
        raise ValueError(
            f"fused_lora_matmul: a {tuple(a.shape)}, w {tuple(w.shape)}, "
            f"down {tuple(down.shape)}, up {tuple(up.shape)}"
        )
    lead = a.shape[:-1]
    a2 = a.reshape(-1, inner)
    if not a2.is_contiguous():
        a2 = a2.contiguous()
    w_ = w if w.is_contiguous() else w.contiguous()
    down_, up_ = _factor(down), _factor(up)
    adt, wdt = _build.dtype_code(a2), _build.dtype_code(w_)
    m, p = a2.shape[0], k if nn else n
    out = torch.empty((m, p), dtype=a.dtype, device=a.device)
    fast = variant(a2, w_) == "fast"
    lib, stream = _build.lib(), _build.stream_ptr(a)
    if fast:
        bm, splits, grid = fast_plan(m, p, inner, _sm_count(a.device))
        ws = (torch.empty((splits, m, p), dtype=torch.float32, device=a.device)
              if splits > 1 else None)
        rc = lib.lyc_lora_fused_fast(
            a2.data_ptr(), w_.data_ptr(), down_.data_ptr(), up_.data_ptr(), out.data_ptr(),
            _build.ptr(ws), m, n, k, r, float(scale), int(nn), bm, splits, grid, stream,
        )
        _build.check(rc, "lyc_lora_fused_fast")
    else:
        entry = "lyc_lora_fused_nn" if nn else "lyc_lora_fused_nt"
        rc = getattr(lib, entry)(
            a2.data_ptr(), w_.data_ptr(), down_.data_ptr(), up_.data_ptr(), out.data_ptr(),
            m, n, k, r, float(scale), adt, wdt, stream,
        )
        _build.check(rc, entry)
    return out.reshape(*lead, p), fast


def lora_fused_nt(x, w, down, up, scale=1.0):
    """The forward kernel on CUDA tensors: x (..., K), w (N, K), down (R, K),
    up (N, R) -> y (..., N) in x's dtype."""
    global launches, launches_fast
    y, fast = _launch(x, w, down, up, scale, nn=False)
    launches += 1
    launches_fast += fast
    return y


def lora_fused_nn(g, w, down, up, scale=1.0):
    """The input-gradient kernel on CUDA tensors: g (..., N) -> dx (..., K)
    in g's dtype."""
    global dx_launches, dx_launches_fast
    dx, fast = _launch(g, w, down, up, scale, nn=True)
    dx_launches += 1
    dx_launches_fast += fast
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
                dx = lora_fused_nn(g, w, down, up, scale)
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
