"""Shared pieces of the reference: precision, AdamW, the timestep embedding
and the DDPM schedule, and the weight store that hands each layer its fp32
weight (W + dW where an adapter sits) one layer at a time, so that bf16
base weights are upcast only while a layer runs."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round_fp8(x, dtype, top):
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = amax / top
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """Forward: x rounded to e4m3 at a per-tensor scale; backward: the
    gradient rounded to e5m2 likewise (fp8 training's usual pair)."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, E5M2_MAX)


class Ops:
    """The matmul-like operations of the reference in one precision:
    ``"fp32"`` or ``"fp8"`` (operands rounded through float8, products and
    sums in fp32)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}: fp32 or fp8")
        self.q = _Fp8.apply if precision == "fp8" else (lambda t: t)

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def conv(self, x, w, b=None, stride=1, padding=0):
        return F.conv2d(self.q(x), self.q(w), b, stride=stride, padding=padding)

    def attention(self, q, k, v):
        """(B, H, T, D) each; softmax(q k^T / sqrt(D)) v, all in fp32."""
        s = torch.matmul(self.q(q), self.q(k).transpose(-1, -2)) * (q.shape[-1] ** -0.5)
        p = torch.softmax(s, dim=-1)
        return torch.matmul(self.q(p), self.q(v))


@contextlib.contextmanager
def no_tf32():
    """fp32 matmuls and convolutions in full fp32 while the block runs."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class WeightStore:
    """fp32 layer weights from bf16 (or any) base tensors, with an adapter's
    dW added where one sits: ``base`` {param name: tensor}, ``adapters``
    {layer name: {key: fp32 tensor}}, ``scales`` {layer name: scale},
    ``delta(theta, scale) -> (out, in)`` the algorithm's dW (``algos/``).
    A layer's weight is upcast (and merged) at each use."""

    def __init__(self, base: dict, adapters: dict | None = None, scales: dict | None = None,
                 delta=None):
        if adapters and delta is None:
            raise ValueError("adapters without the delta that forms their dW")
        self.base, self.adapters, self.scales, self.delta = base, adapters or {}, scales or {}, delta

    def w(self, layer: str):
        w = self.base[f"{layer}.weight"].float()
        theta = self.adapters.get(layer)
        if theta is not None:
            w = w + self.delta(theta, self.scales[layer]).reshape(w.shape)
        return w

    def b(self, layer: str):
        b = self.base.get(f"{layer}.bias")
        return None if b is None else b.float()


# ---------------------------------------------------------------------------
# diffusion pieces
# ---------------------------------------------------------------------------


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, cos before sin (flip_sin_to_cos, shift 0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def alphas_cumprod(steps: int = 1000, beta_start: float = 0.00085, beta_end: float = 0.012):
    """The scaled-linear DDPM schedule's cumulative alphas, float32."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, steps, dtype=np.float32) ** 2
    return np.cumprod((1.0 - betas).astype(np.float32), dtype=np.float32)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


class AdamW:
    """Decoupled-weight-decay Adam on a list of fp32 leaves, optax's
    defaults (betas 0.9, 0.999, eps 1e-8, weight decay 1e-4)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        self.params, self.lr, self.betas, self.eps, self.wd = params, lr, betas, eps, weight_decay
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - self.lr * self.wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.addcdiv_(m, (v / c2).sqrt_().add_(self.eps), value=-self.lr / c1)
