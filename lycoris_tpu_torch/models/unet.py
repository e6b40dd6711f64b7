"""SD1.5 / SDXL-style UNet in PyTorch (counterpart of ``lycoris_tpu/models/unet.py``).

Submodules carry exactly the flax module names (``down_blocks_0_resnets_0``,
``transformer_blocks_0``, ``attn1.to_out_0``, ``ff.net_0_proj``, ...), so
:func:`state_dict_from_jax` is a dotted key join and every adapter
``lora_name`` matches the JAX one by construction. Class names mirror
diffusers so presets target them unchanged.

Rematerialization (``UNetConfig.remat``) takes the JAX values ``False``,
``"transformer"`` (each Transformer2DModel is checkpointed) and ``True``
(the resnets too), through ``torch.utils.checkpoint``: a checkpointed block
keeps only its inputs and runs its forward again in the backward. SDXL
trains at batch 4 on 128x128 latents with ``"transformer"``; SD1.5 trains at
batch 8 without it. The JAX package's named-save tiers (``"attn_out"``,
``"attn_ff"``, ...) are not ported and raise ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers as L
from ..functional.general import geglu_mul
from ..ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    transformer_depth: tuple = (1, 1, 1, 0)  # per down-block; 0 = no attention
    mid_transformer_depth: int = 1
    context_dim: int = 768
    num_heads: int = 8
    head_dim: int | None = None  # diffusers attention_head_dim: heads = ch // head_dim
    norm_groups: int = 32
    time_embed_dim: int | None = None  # default 4*ch0
    addition_embed_dim: int | None = None  # SDXL: 2816 add_embedding in dim
    remat: Any = False  # False | "transformer" | True (also resnets)
    dtype: Any = torch.float32  # activation dtype of the timestep embedding

    def __post_init__(self):
        if not (self.remat is False or self.remat is True or self.remat == "transformer"):
            raise ValueError(
                f"remat={self.remat!r} is not ported: the port checkpoints whole blocks "
                f"(False, 'transformer' or True); the JAX package's named-save tiers "
                f"(attn_out, attn_ff, ...) have no counterpart")

    @property
    def temb_dim(self):
        return self.time_embed_dim or self.block_out_channels[0] * 4


def sd15_config(dtype=torch.float32, remat=False) -> UNetConfig:
    return UNetConfig(dtype=dtype, remat=remat)


def sdxl_config(dtype=torch.float32, remat=False) -> UNetConfig:
    return UNetConfig(
        remat=remat,
        block_out_channels=(320, 640, 1280),
        layers_per_block=2,
        transformer_depth=(0, 2, 10),
        mid_transformer_depth=10,
        context_dim=2048,
        head_dim=64,
        addition_embed_dim=2816,
        dtype=dtype,
    )


def tiny_unet_config(dtype=torch.float32) -> UNetConfig:
    return UNetConfig(
        block_out_channels=(32, 64),
        layers_per_block=1,
        transformer_depth=(1, 1),
        mid_transformer_depth=1,
        context_dim=32,
        num_heads=2,
        norm_groups=8,
        dtype=dtype,
    )


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal timestep embedding, cos before sin (as the JAX model)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, temb_dim: int, **kw):
        super().__init__()
        self.linear_1 = L.Linear(in_dim, temb_dim, **kw)
        self.linear_2 = L.Linear(temb_dim, temb_dim, **kw)

    def forward(self, temb):
        return self.linear_2(F.silu(self.linear_1(temb)))


class CrossAttention(nn.Module):
    """diffusers-style attention: to_q/to_k/to_v (no bias) + to_out_0; the
    projections emit (B, H, T, D) for the attention dispatch."""

    def __init__(self, query_dim: int, context_dim: int | None = None, num_heads: int = 8, **kw):
        super().__init__()
        inner = query_dim
        ctx = query_dim if context_dim is None else context_dim
        hs = (num_heads, inner // num_heads)
        self.inner = inner
        self.to_q = L.Linear(query_dim, inner, bias=False, head_split=hs, **kw)
        self.to_k = L.Linear(ctx, inner, bias=False, head_split=hs, **kw)
        self.to_v = L.Linear(ctx, inner, bias=False, head_split=hs, **kw)
        self.to_out_0 = L.Linear(inner, inner, **kw)

    def forward(self, x, context=None):
        context = x if context is None else context
        q = self.to_q(x)
        k = self.to_k(context)
        v = self.to_v(context)
        o = dot_product_attention(q, k, v, layout="BHTD")  # (B, T, H, D)
        return self.to_out_0(o.reshape(x.shape[0], x.shape[1], self.inner))


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, **kw):
        super().__init__()
        inner = dim * mult
        self.net_0_proj = L.Linear(dim, inner * 2, **kw)
        self.net_2 = L.Linear(inner, dim, **kw)

    def forward(self, x):
        return self.net_2(geglu_mul(self.net_0_proj(x)))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, num_heads: int, **kw):
        super().__init__()
        self.norm1 = L.LayerNorm(dim, **kw)
        self.attn1 = CrossAttention(dim, None, num_heads, **kw)
        self.norm2 = L.LayerNorm(dim, **kw)
        self.attn2 = CrossAttention(dim, context_dim, num_heads, **kw)
        self.norm3 = L.LayerNorm(dim, **kw)
        self.ff = FeedForward(dim, **kw)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    def __init__(self, channels: int, depth: int, context_dim: int, num_heads: int,
                 norm_groups: int, **kw):
        super().__init__()
        self.channels = channels
        self.norm = L.GroupNorm(norm_groups, channels, eps=1e-6, **kw)
        self.proj_in = L.Conv2d(channels, channels, kernel_size=1, **kw)
        for i in range(depth):
            self.add_module(f"transformer_blocks_{i}",
                            BasicTransformerBlock(channels, context_dim, num_heads, **kw))
        self.depth = depth
        self.proj_out = L.Conv2d(channels, channels, kernel_size=1, **kw)

    def forward(self, x, context):
        b, c, h, w = x.shape
        residual = x
        x = self.proj_in(self.norm(x))
        # (B, HW, C), made contiguous once: the LayerNorm kernel reads rows
        x = x.reshape(b, self.channels, h * w).transpose(1, 2).contiguous()
        for i in range(self.depth):
            x = getattr(self, f"transformer_blocks_{i}")(x, context)
        # (B, C, H, W) as a channels-last view: proj_out (a 1x1 conv) reads it
        # as it is, and the sum takes the layout of its first operand, so the
        # residual first keeps the blocks after this one in contiguous NCHW
        x = x.transpose(1, 2).reshape(b, self.channels, h, w)
        return residual + self.proj_out(x)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int, norm_groups: int, **kw):
        super().__init__()
        self.norm1 = L.GroupNorm(norm_groups, in_channels, eps=1e-5, act="silu", **kw)
        self.conv1 = L.Conv2d(in_channels, out_channels, kernel_size=3, padding=1, **kw)
        self.time_emb_proj = L.Linear(temb_dim, out_channels, **kw)
        self.norm2 = L.GroupNorm(norm_groups, out_channels, eps=1e-5, act="silu", **kw)
        self.conv2 = L.Conv2d(out_channels, out_channels, kernel_size=3, padding=1, **kw)
        self.conv_shortcut = (
            L.Conv2d(in_channels, out_channels, kernel_size=1, **kw)
            if in_channels != out_channels else None
        )

    def forward(self, x, temb):
        h = self.conv1(self.norm1(x))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, channels: int, **kw):
        super().__init__()
        self.conv = L.Conv2d(channels, channels, kernel_size=3, stride=2, padding=1, **kw)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int, **kw):
        super().__init__()
        self.conv = L.Conv2d(channels, channels, kernel_size=3, padding=1, **kw)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNet2DConditionModel(nn.Module):
    """Channels-first conditional UNet (diffusers topology, flax names).

    ``forward(sample, timesteps, encoder_hidden_states, added_cond=None)``
    predicts eps. Parameters are drawn at construction from ``generator``
    (kaiming-uniform linears/convs, unit norms) on ``device``, the card
    unless the caller asks for another."""

    def __init__(self, cfg: UNetConfig, device="cuda", param_dtype=None, generator=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=param_dtype)
        ch0 = cfg.block_out_channels[0]

        def heads(ch):
            return ch // cfg.head_dim if cfg.head_dim else cfg.num_heads

        self.time_embedding = TimestepEmbedding(ch0, cfg.temb_dim, **kw)
        if cfg.addition_embed_dim is not None:
            self.add_embedding = TimestepEmbedding(cfg.addition_embed_dim, cfg.temb_dim, **kw)
        self.conv_in = L.Conv2d(cfg.in_channels, ch0, kernel_size=3, padding=1, **kw)

        skip_ch = [ch0]
        ch_in = ch0
        nb = len(cfg.block_out_channels)
        for bi, ch in enumerate(cfg.block_out_channels):
            for li in range(cfg.layers_per_block):
                self.add_module(f"down_blocks_{bi}_resnets_{li}",
                                ResnetBlock2D(ch_in, ch, cfg.temb_dim, cfg.norm_groups, **kw))
                ch_in = ch
                if cfg.transformer_depth[bi] > 0:
                    self.add_module(f"down_blocks_{bi}_attentions_{li}", Transformer2DModel(
                        ch, cfg.transformer_depth[bi], cfg.context_dim, heads(ch),
                        cfg.norm_groups, **kw))
                skip_ch.append(ch)
            if bi < nb - 1:
                self.add_module(f"down_blocks_{bi}_downsamplers_0", Downsample2D(ch, **kw))
                skip_ch.append(ch)

        mid = cfg.block_out_channels[-1]
        self.mid_block_resnets_0 = ResnetBlock2D(mid, mid, cfg.temb_dim, cfg.norm_groups, **kw)
        if cfg.mid_transformer_depth > 0:
            self.mid_block_attentions_0 = Transformer2DModel(
                mid, cfg.mid_transformer_depth, cfg.context_dim, heads(mid), cfg.norm_groups,
                **kw)
        self.mid_block_resnets_1 = ResnetBlock2D(mid, mid, cfg.temb_dim, cfg.norm_groups, **kw)

        ch_in = mid
        for bi, ch in reversed(list(enumerate(cfg.block_out_channels))):
            ui = nb - 1 - bi
            for li in range(cfg.layers_per_block + 1):
                self.add_module(f"up_blocks_{ui}_resnets_{li}", ResnetBlock2D(
                    ch_in + skip_ch.pop(), ch, cfg.temb_dim, cfg.norm_groups, **kw))
                ch_in = ch
                if cfg.transformer_depth[bi] > 0:
                    self.add_module(f"up_blocks_{ui}_attentions_{li}", Transformer2DModel(
                        ch, cfg.transformer_depth[bi], cfg.context_dim, heads(ch),
                        cfg.norm_groups, **kw))
            if bi > 0:
                self.add_module(f"up_blocks_{ui}_upsamplers_0", Upsample2D(ch, **kw))

        self.conv_norm_out = L.GroupNorm(cfg.norm_groups, ch0, act="silu", **kw)
        self.conv_out = L.Conv2d(ch0, cfg.out_channels, kernel_size=3, padding=1, **kw)
        reset_parameters(self, generator)

    def _sub(self, name):
        return self._modules.get(name)

    def _run(self, block, *args):
        """``block(*args)``, checkpointed where ``cfg.remat`` asks for it and
        a gradient is being recorded (the blocks draw no random numbers, so
        the RNG state is not stashed for the recompute)."""
        remat = self.cfg.remat
        if torch.is_grad_enabled() and (
                remat is True or (remat == "transformer" and isinstance(block, Transformer2DModel))):
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, sample, timesteps, encoder_hidden_states, added_cond=None):
        cfg = self.cfg
        ch0 = cfg.block_out_channels[0]
        temb = timestep_embedding(timesteps, ch0).to(cfg.dtype)
        temb = self.time_embedding(temb)
        if cfg.addition_embed_dim is not None and added_cond is not None:
            temb = temb + self.add_embedding(added_cond.to(cfg.dtype))
        temb = temb.to(cfg.dtype)
        ctx = encoder_hidden_states

        h = self.conv_in(sample)
        skips = [h]
        nb = len(cfg.block_out_channels)
        for bi in range(nb):
            for li in range(cfg.layers_per_block):
                h = self._run(self._sub(f"down_blocks_{bi}_resnets_{li}"), h, temb)
                attn = self._sub(f"down_blocks_{bi}_attentions_{li}")
                if attn is not None:
                    h = self._run(attn, h, ctx)
                skips.append(h)
            if bi < nb - 1:
                h = self._sub(f"down_blocks_{bi}_downsamplers_0")(h)
                skips.append(h)

        h = self._run(self.mid_block_resnets_0, h, temb)
        if cfg.mid_transformer_depth > 0:
            h = self._run(self.mid_block_attentions_0, h, ctx)
        h = self._run(self.mid_block_resnets_1, h, temb)

        for ui in range(nb):
            for li in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = self._run(self._sub(f"up_blocks_{ui}_resnets_{li}"), h, temb)
                attn = self._sub(f"up_blocks_{ui}_attentions_{li}")
                if attn is not None:
                    h = self._run(attn, h, ctx)
            up = self._sub(f"up_blocks_{ui}_upsamplers_0")
            if up is not None:
                h = up(h)

        return self.conv_out(self.conv_norm_out(h))


def reset_parameters(model: nn.Module, generator=None) -> nn.Module:
    """Redraw every layer's parameters from ``generator`` (on their device)."""
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator=generator)
    return model


def state_dict_from_jax(params) -> dict:
    """Flax ``variables["params"]`` (nested dict of arrays) -> this model's
    ``state_dict``: the submodule names are the flax names, so each key is
    the dotted path."""
    out = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(key, v)
            else:
                out[key] = torch.from_numpy(np.array(v, dtype=np.float32))

    walk("", params)
    return out
