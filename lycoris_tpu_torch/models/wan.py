"""Wan2.1 text-to-video DiT in PyTorch (Wan-Video/Wan2.1, ``wan/modules/model.py``).

A Conv3d patch embedding turns a (B, 16, F, H, W) latent into
L = F (H/2) (W/2) tokens in (f, h, w) row-major order. Each of the
``num_layers`` :class:`WanAttentionBlock` s runs full self-attention over every
token, with a learned RMSNorm over all ``dim`` channels of q and k and 3-D
rotary positions (:func:`rope3d`), then cross-attention to the text tokens,
then a tanh-GELU FFN; a per-block learned table plus the shared time
projection modulates the self-attention's and the FFN's inputs and gates
their outputs. A modulated head and the unpatchify give back (B, 16, F, H, W).

Submodules carry the official names (``patch_embedding``,
``text_embedding.0``, ``time_projection.1``, ``blocks.3.self_attn.norm_q``,
``blocks.3.ffn.2``, ``head.modulation``, ...), so state-dict keys are the
published checkpoint's and presets target ``WanAttentionBlock``.

Precision, as diffusers' ``WanTransformerBlock``: the time embedding, the
modulation, the no-affine LayerNorms' statistics and outputs, the q/k
RMSNorm and RoPE are fp32; the residual stream, weights and the other
activations follow the input's dtype (bf16 in training), and each modulated
input and gated residual sum is formed in fp32 and rounded once. (The
official code keeps the residual stream in fp32.)

Self-attention goes through :func:`..ops.attention.dot_product_attention`:
at L >= 1024 it takes the flash kernels forward and backward (L need not be
a multiple of any tile); cross-attention to the 512 text tokens takes the
plain path. The cross-attention's LayerNorm (``norm3``, with weight and
bias) runs the LayerNorm kernel on the card. ``WanConfig.remat``
checkpoints each block when a gradient is recorded. Parameters are drawn at
construction from ``generator`` on ``device``, the card unless the caller
asks for another: the 14 B model would take 57 GB in fp32 on the host.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers as L
from ..functional import general
from ..observability import span
from ..ops.attention import dot_product_attention
from .unet import reset_parameters, timestep_embedding


@dataclasses.dataclass(frozen=True)
class WanConfig:
    """Wan2.1-T2V-14B's sizes (``config.json`` and ``wan/configs/wan_t2v_14B.py``);
    qk_norm and cross_attn_norm are on, as in both published T2V models."""

    dim: int = 5120
    ffn_dim: int = 13824
    freq_dim: int = 256
    text_dim: int = 4096
    in_dim: int = 16
    out_dim: int = 16
    num_heads: int = 40
    num_layers: int = 40
    patch_size: tuple = (1, 2, 2)
    eps: float = 1e-6
    remat: bool = False  # checkpoint each WanAttentionBlock in training

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


def tiny_wan_config(remat: bool = False) -> WanConfig:
    return WanConfig(dim=48, ffn_dim=96, freq_dim=32, text_dim=16, num_heads=2, num_layers=2,
                     remat=remat)


@functools.lru_cache(maxsize=8)
def rope_table(grid: tuple, head_dim: int, device) -> tuple:
    """(cos, sin), each (L, head_dim / 2) fp32, of the 3-D rotary angles of
    the tokens of a (f, h, w) ``grid`` in row-major order: pair j of a head
    turns by pos * 10000^(-2 j' / n), its first c - 4 (c // 6) channels
    (pairs 0-21 at c = 128) by the frame, the next 2 (c // 6) by the row,
    the last 2 (c // 6) by the column, j' counting within the axis (the
    official ``rope_params``). Angles in float64, tables in fp32."""
    c = head_dim
    widths = (c - 4 * (c // 6), 2 * (c // 6), 2 * (c // 6))
    pos = torch.stack(torch.meshgrid(*(torch.arange(n, dtype=torch.float64) for n in grid),
                                     indexing="ij"), dim=-1).reshape(-1, 3)
    angles = torch.cat([pos[:, i, None] * 10000.0 ** (
        -torch.arange(0, n, 2, dtype=torch.float64) / n) for i, n in enumerate(widths)], dim=1)
    return torch.cos(angles).float().to(device), torch.sin(angles).float().to(device)


def rope3d(x, cos, sin):
    """(B, L, H, D) ``x`` with each pair (x_2j, x_2j+1) of a head rotated by
    the table's angle, in fp32, rounded once to ``x``'s dtype; one
    ``lycoris.rope`` span."""
    with span("lycoris.rope"):
        a, b = x.float().unflatten(-1, (-1, 2)).unbind(-1)
        c, s = cos[:, None], sin[:, None]
        return torch.stack((a * c - b * s, a * s + b * c), dim=-1).flatten(-2).to(x.dtype)


def _layer_norm(x, eps: float):
    """LayerNorm without affine parameters, fp32 in and out."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps)


class WanRMSNorm(L.RMSNorm):
    """RMSNorm over all channels, computed in fp32 with the weight and
    rounded once to the input's dtype."""

    def forward_with(self, x, weight, bias):
        y = general.rms_norm(x.float(), (self.dim,), weight.float(),
                             None if bias is None else bias.float(), self.eps)
        return y.to(x.dtype)


class Conv3d(nn.Module):
    """Channels-first 3-D convolution, weight (out, in, kf, kh, kw)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: tuple, stride: tuple,
                 device=None, dtype=None):
        super().__init__()
        self.kernel_size, self.stride = tuple(kernel_size), tuple(stride)
        kw = dict(device=device, dtype=dtype or torch.float32)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *self.kernel_size, **kw))
        self.bias = nn.Parameter(torch.empty(out_channels, **kw))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.copy_(general.kaiming_uniform(
                tuple(self.weight.shape), generator=generator, device=self.weight.device))
            bound = 1 / math.sqrt(math.prod(self.weight.shape[1:]))
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        return general.convnd(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                              stride=self.stride)


def _modulation(n: int, dim: int, kw: dict) -> nn.Parameter:
    return nn.Parameter(torch.empty(1, n, dim, device=kw["device"],
                                    dtype=kw["dtype"] or torch.float32))


def _draw_modulation(p: nn.Parameter, generator=None) -> None:
    """The official init: N(0, 1) / sqrt(dim)."""
    with torch.no_grad():
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device) / p.shape[-1] ** 0.5)


class WanSelfAttention(nn.Module):
    """q, k, v, o projections with biases and the RMSNorm of q and k over
    all channels; ``rope`` (cos, sin) rotates q and k (self-attention),
    None leaves them (cross-attention)."""

    def __init__(self, dim: int, num_heads: int, eps: float, **kw):
        super().__init__()
        self.num_heads = num_heads
        self.q = L.Linear(dim, dim, **kw)
        self.k = L.Linear(dim, dim, **kw)
        self.v = L.Linear(dim, dim, **kw)
        self.o = L.Linear(dim, dim, **kw)
        self.norm_q = WanRMSNorm(dim, eps=eps, **kw)
        self.norm_k = WanRMSNorm(dim, eps=eps, **kw)

    def forward(self, x, ctx=None, rope=None):
        src = x if ctx is None else ctx
        heads = lambda y: y.unflatten(-1, (self.num_heads, -1))  # noqa: E731
        q, k = heads(self.norm_q(self.q(x))), heads(self.norm_k(self.k(src)))
        if rope is not None:
            q, k = rope3d(q, *rope), rope3d(k, *rope)
        o = dot_product_attention(q, k, heads(self.v(src)))
        return self.o(o.flatten(-2))


class WanAttentionBlock(nn.Module):
    """Modulated self-attention with 3-D RoPE, cross-attention to the text,
    modulated FFN; residual sums in fp32, rounded once."""

    def __init__(self, cfg: WanConfig, **kw):
        super().__init__()
        d = cfg.dim
        self.eps = cfg.eps
        self.self_attn = WanSelfAttention(d, cfg.num_heads, cfg.eps, **kw)
        self.norm3 = L.LayerNorm(d, eps=cfg.eps, **kw)
        self.cross_attn = WanSelfAttention(d, cfg.num_heads, cfg.eps, **kw)
        self.ffn = nn.Sequential(L.Linear(d, cfg.ffn_dim, **kw), nn.GELU(approximate="tanh"),
                                 L.Linear(cfg.ffn_dim, d, **kw))
        self.modulation = _modulation(6, d, kw)

    def reset_parameters(self, generator=None):
        _draw_modulation(self.modulation, generator)

    def forward(self, x, e0, ctx, rope):
        sh1, sc1, g1, sh2, sc2, g2 = (self.modulation.float() + e0).chunk(6, dim=1)
        h = (_layer_norm(x, self.eps) * (1 + sc1) + sh1).to(x.dtype)
        x = (x.float() + self.self_attn(h, rope=rope).float() * g1).to(x.dtype)
        x = x + self.cross_attn(self.norm3(x), ctx=ctx)
        h = (_layer_norm(x, self.eps) * (1 + sc2) + sh2).to(x.dtype)
        return (x.float() + self.ffn(h).float() * g2).to(x.dtype)


class Head(nn.Module):
    """Modulated no-affine LayerNorm, then the patch projection."""

    def __init__(self, cfg: WanConfig, **kw):
        super().__init__()
        self.eps = cfg.eps
        self.head = L.Linear(cfg.dim, cfg.out_dim * math.prod(cfg.patch_size), **kw)
        self.modulation = _modulation(2, cfg.dim, kw)

    def reset_parameters(self, generator=None):
        _draw_modulation(self.modulation, generator)

    def forward(self, x, e):
        sh, sc = (self.modulation.float() + e[:, None]).chunk(2, dim=1)
        return self.head((_layer_norm(x, self.eps) * (1 + sc) + sh).to(x.dtype))


class WanModel(nn.Module):
    """``forward(x, t, context)``: latents (B, in_dim, F, H, W), timesteps
    (B,) float and text tokens (B, text_len, text_dim) to (B, out_dim, F, H,
    W). Parameters are drawn at construction from ``generator`` (kaiming-
    uniform linears, unit norms, N(0, 1/dim) modulation tables) on
    ``device``, the card unless the caller asks for another."""

    def __init__(self, cfg: WanConfig, device="cuda", param_dtype=None, generator=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=param_dtype)
        d = cfg.dim
        self.patch_embedding = Conv3d(cfg.in_dim, d, cfg.patch_size, cfg.patch_size, **kw)
        self.text_embedding = nn.Sequential(L.Linear(cfg.text_dim, d, **kw),
                                            nn.GELU(approximate="tanh"), L.Linear(d, d, **kw))
        self.time_embedding = nn.Sequential(L.Linear(cfg.freq_dim, d, **kw), nn.SiLU(),
                                            L.Linear(d, d, **kw))
        self.time_projection = nn.Sequential(nn.SiLU(), L.Linear(d, 6 * d, **kw))
        self.blocks = nn.ModuleList(WanAttentionBlock(cfg, **kw) for _ in range(cfg.num_layers))
        self.head = Head(cfg, **kw)
        reset_parameters(self, generator)

    def _run(self, block, *args):
        """``block(*args)``, checkpointed where ``cfg.remat`` asks for it and
        a gradient is being recorded (the blocks draw no random numbers)."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, x, t, context):
        cfg = self.cfg
        b, _, f, h, w = x.shape
        grid = tuple(n // p for n, p in zip((f, h, w), cfg.patch_size))
        x = self.patch_embedding(x).flatten(2).transpose(1, 2)
        e = self.time_embedding(timestep_embedding(t, cfg.freq_dim))  # fp32
        e0 = self.time_projection(e).unflatten(1, (6, cfg.dim))
        ctx = self.text_embedding(context)
        rope = rope_table(grid, cfg.head_dim, x.device)
        for block in self.blocks:
            x = self._run(block, x, e0, ctx, rope)
        y = self.head(x, e)
        return unpatchify(y, grid, cfg.patch_size, cfg.out_dim)


def unpatchify(y, grid: tuple, patch_size: tuple, channels: int):
    """(B, L, prod(patch) * channels) tokens -> (B, channels, F, H, W), each
    token read as (pf, ph, pw, channels) (the official einsum
    ``fhwpqrc->cfphqwr``)."""
    b = y.shape[0]
    y = y.reshape(b, *grid, *patch_size, channels).permute(0, 7, 1, 4, 2, 5, 3, 6)
    return y.reshape(b, channels, *(n * p for n, p in zip(grid, patch_size)))
