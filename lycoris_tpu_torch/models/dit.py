"""Flux-style DiT in PyTorch (counterpart of ``lycoris_tpu/models/dit.py``).

AdaLN-modulated double-stream blocks (image and text tokens, one joint
attention), then single-stream blocks over the joined sequence; no rotary
embedding (positions are the caller's concern), channels-last tokens.

Class names are the Flux ones (``DoubleStreamBlock``, ``SingleStreamBlock``)
so the presets that target Flux apply unchanged, and submodules carry the
flax model's names (``double_blocks_0``, ``img_mod.lin``, ``img_attn.qkv``,
``img_attn.norm.query_norm``, ``img_attn_proj``, ``img_mlp_0``,
``single_blocks_3.linear1``, ``final_mod.lin``), so every adapter
``lora_name`` matches the JAX one and :func:`state_dict_from_jax` is the
dotted key join of ``models/unet.py``.

The joint attention goes through :func:`..ops.attention.dot_product_attention`:
at Flux's T = 512 + 4096 it takes the flash kernel, reading the single
block's v in place from ``linear1``'s output. Every LayerNorm has no bias
and runs the LayerNorm kernel on the card; the qk RMSNorms (eps 1e-6) and
the tanh GELU are plain PyTorch, as they are plain XLA in the JAX model.
Parameters are drawn at construction from ``generator`` on ``device``, the
card unless the caller asks for another: Flux's 11.9 B parameters would
take 44 GiB in fp32 on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L
from ..ops.attention import dot_product_attention
from .unet import reset_parameters, timestep_embedding
from .unet import state_dict_from_jax  # noqa: F401  (the flax names are this model's)


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    hidden_size: int = 3072
    num_heads: int = 24
    mlp_ratio: float = 4.0
    depth_double: int = 19
    depth_single: int = 38
    in_channels: int = 64
    context_dim: int = 4096
    qk_norm: bool = True  # Flux applies a per-head RMSNorm to q and k
    dtype: Any = torch.float32  # activation dtype of the timestep embedding

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def flux_config(dtype=torch.bfloat16) -> DiTConfig:
    return DiTConfig(dtype=dtype)


def tiny_dit_config(dtype=torch.float32) -> DiTConfig:
    return DiTConfig(
        hidden_size=32, num_heads=2, depth_double=2, depth_single=2,
        in_channels=8, context_dim=16, dtype=dtype,
    )


class Modulation(nn.Module):
    """``3 * n`` (shift, scale, gate) vectors, each (B, 1, dim), from silu(vec)."""

    def __init__(self, dim: int, n: int, **kw):
        super().__init__()
        self.n = n
        self.lin = L.Linear(dim, dim * 3 * n, **kw)

    def forward(self, vec):
        return self.lin(F.silu(vec))[:, None, :].chunk(3 * self.n, dim=-1)


class QKNorm(nn.Module):
    """Per-head RMSNorm of q and k (Flux qk-norm), under Flux's names
    ``norm.query_norm`` / ``norm.key_norm``."""

    def __init__(self, head_dim: int, **kw):
        super().__init__()
        self.query_norm = L.RMSNorm(head_dim, **kw)
        self.key_norm = L.RMSNorm(head_dim, **kw)

    def forward(self, q, k):
        return self.query_norm(q), self.key_norm(k)


def _qk_norm(norm: QKNorm, q, k, num_heads: int):
    """(B, T, C) q and k through ``norm`` per head of C // ``num_heads``."""
    q, k = norm(q.unflatten(-1, (num_heads, -1)), k.unflatten(-1, (num_heads, -1)))
    return q.flatten(-2), k.flatten(-2)


def _attention(q, k, v, num_heads: int):
    """(B, T, C) q, k, v -> (B, T, C): softmax(q k^T / sqrt(D)) v per head."""
    o = dot_product_attention(*(x.unflatten(-1, (num_heads, -1)) for x in (q, k, v)))
    return o.flatten(-2)


class QKV(nn.Module):
    """The fused q/k/v projection; ``num_heads`` > 0 adds the qk RMSNorm."""

    def __init__(self, dim: int, num_heads: int = 0, **kw):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = L.Linear(dim, dim * 3, **kw)
        if num_heads:
            self.norm = QKNorm(dim // num_heads, **kw)

    def forward(self, x):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        if self.num_heads:
            q, k = _qk_norm(self.norm, q, k, self.num_heads)
        return q, k, v


class DoubleStreamBlock(nn.Module):
    """Separate image and text streams with one joint attention (Flux layout)."""

    def __init__(self, cfg: DiTConfig, **kw):
        super().__init__()
        d, mlp = cfg.hidden_size, cfg.mlp_dim
        self.num_heads = cfg.num_heads
        nh = cfg.num_heads if cfg.qk_norm else 0
        self.img_mod = Modulation(d, 2, **kw)
        self.txt_mod = Modulation(d, 2, **kw)
        self.img_norm1 = L.LayerNorm(d, bias=False, **kw)
        self.txt_norm1 = L.LayerNorm(d, bias=False, **kw)
        self.img_attn = QKV(d, num_heads=nh, **kw)
        self.txt_attn = QKV(d, num_heads=nh, **kw)
        self.img_attn_proj = L.Linear(d, d, **kw)
        self.txt_attn_proj = L.Linear(d, d, **kw)
        self.img_norm2 = L.LayerNorm(d, bias=False, **kw)
        self.img_mlp_0 = L.Linear(d, mlp, **kw)
        self.img_mlp_2 = L.Linear(mlp, d, **kw)
        self.txt_norm2 = L.LayerNorm(d, bias=False, **kw)
        self.txt_mlp_0 = L.Linear(d, mlp, **kw)
        self.txt_mlp_2 = L.Linear(mlp, d, **kw)

    def forward(self, img, txt, vec):
        i_shift1, i_scale1, i_gate1, i_shift2, i_scale2, i_gate2 = self.img_mod(vec)
        t_shift1, t_scale1, t_gate1, t_shift2, t_scale2, t_gate2 = self.txt_mod(vec)

        img_n = self.img_norm1(img) * (1 + i_scale1) + i_shift1
        txt_n = self.txt_norm1(txt) * (1 + t_scale1) + t_shift1
        iq, ik, iv = self.img_attn(img_n)
        tq, tk, tv = self.txt_attn(txt_n)
        o = _attention(torch.cat([tq, iq], dim=1), torch.cat([tk, ik], dim=1),
                       torch.cat([tv, iv], dim=1), self.num_heads)
        t_len = txt.shape[1]
        img = img + i_gate1 * self.img_attn_proj(o[:, t_len:])
        txt = txt + t_gate1 * self.txt_attn_proj(o[:, :t_len])

        img_h = F.gelu(self.img_mlp_0(self.img_norm2(img) * (1 + i_scale2) + i_shift2),
                       approximate="tanh")
        img = img + i_gate2 * self.img_mlp_2(img_h)
        txt_h = F.gelu(self.txt_mlp_0(self.txt_norm2(txt) * (1 + t_scale2) + t_shift2),
                       approximate="tanh")
        txt = txt + t_gate2 * self.txt_mlp_2(txt_h)
        return img, txt


class SingleStreamBlock(nn.Module):
    """Fused single-stream block: attention and MLP in one residual."""

    def __init__(self, cfg: DiTConfig, **kw):
        super().__init__()
        d, mlp = cfg.hidden_size, cfg.mlp_dim
        self.sizes = (d, d, d, mlp)
        self.num_heads = cfg.num_heads
        self.qk_norm = cfg.qk_norm
        self.modulation = Modulation(d, 1, **kw)
        self.pre_norm = L.LayerNorm(d, bias=False, **kw)
        self.linear1 = L.Linear(d, d * 3 + mlp, **kw)
        if cfg.qk_norm:
            self.norm = QKNorm(cfg.head_dim, **kw)
        self.linear2 = L.Linear(d + mlp, d, **kw)

    def forward(self, x, vec):
        shift, scale, gate = self.modulation(vec)
        x_n = self.pre_norm(x) * (1 + scale) + shift
        # q, k, v and the MLP's input are views of linear1's output
        q, k, v, mlp_h = self.linear1(x_n).split(self.sizes, dim=-1)
        if self.qk_norm:
            q, k = _qk_norm(self.norm, q, k, self.num_heads)
        attn = _attention(q, k, v, self.num_heads)
        mlp_h = F.gelu(mlp_h, approximate="tanh")
        return x + gate * self.linear2(torch.cat([attn, mlp_h], dim=-1))


class FluxTransformer2D(nn.Module):
    """Minimal Flux-style transformer: ``forward(img, txt, timesteps)`` maps
    image tokens (B, N, in_channels), text tokens (B, M, context_dim) and
    timesteps (B,) to (B, N, in_channels). Parameters are drawn at
    construction from ``generator`` (kaiming-uniform linears, unit norms) on
    ``device``, the card unless the caller asks for another."""

    def __init__(self, cfg: DiTConfig, device="cuda", param_dtype=None, generator=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=param_dtype)
        d = cfg.hidden_size
        self.img_in = L.Linear(cfg.in_channels, d, **kw)
        self.txt_in = L.Linear(cfg.context_dim, d, **kw)
        self.time_in_1 = L.Linear(256, d, **kw)
        self.time_in_2 = L.Linear(d, d, **kw)
        for i in range(cfg.depth_double):
            self.add_module(f"double_blocks_{i}", DoubleStreamBlock(cfg, **kw))
        for i in range(cfg.depth_single):
            self.add_module(f"single_blocks_{i}", SingleStreamBlock(cfg, **kw))
        self.final_mod = Modulation(d, 1, **kw)
        self.final_norm = L.LayerNorm(d, bias=False, **kw)
        self.final_proj = L.Linear(d, cfg.in_channels, **kw)
        reset_parameters(self, generator)

    def forward(self, img, txt, timesteps):
        cfg = self.cfg
        img = self.img_in(img)
        txt = self.txt_in(txt)
        vec = timestep_embedding(timesteps, 256).to(cfg.dtype)
        vec = self.time_in_2(F.silu(self.time_in_1(vec)))

        for i in range(cfg.depth_double):
            img, txt = getattr(self, f"double_blocks_{i}")(img, txt, vec)
        x = torch.cat([txt, img], dim=1)
        for i in range(cfg.depth_single):
            x = getattr(self, f"single_blocks_{i}")(x, vec)
        x = x[:, txt.shape[1]:]
        shift, scale, _ = self.final_mod(vec)
        x = self.final_norm(x) * (1 + scale) + shift
        return self.final_proj(x)
