"""CLIP text encoder in PyTorch (counterpart of ``lycoris_tpu/models/clip.py``):
the kohya front end's text-encoder tree.

Class names mirror transformers (``CLIPAttention``, ``CLIPMLP``) so the
text-encoder presets (``config.py`` ``_TE_MODULES``) target them, and
submodules carry the JAX model's names (``text_model_encoder_layers_{i}``,
``self_attn.q_proj``, ``mlp.fc1``, ``final_layer_norm``), so every adapter
``lora_name`` (``lora_te1_text_model_encoder_layers_0_self_attn_q_proj``)
matches the JAX one and :func:`state_dict_from_jax` is a key join.

The attention is causal at T = 77: plain torch ops (the two products, the
causal mask, a softmax in fp32), as the JAX model's is
``jax.nn.dot_product_attention(is_causal=True)`` in XLA, not a kernel. The
MLP's tanh GELU is computed as ``x * sigmoid(2u)``, the same function
without ``torch.tanh`` (ROADMAP section 3, item 1). The LayerNorms run the
LayerNorm kernel on the card (``models/layers.py``).

Activations are in ``cfg.dtype`` from the embedding sum on. The JAX model
adds its fp32 token embedding to a ``cfg.dtype`` position embedding, so
there a bf16 config runs its layers in fp32; in fp32 the two agree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from . import layers as L
from .unet import reset_parameters
from .unet import state_dict_from_jax as _params_by_path


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    dtype: Any = torch.float32


def clip_l_config(dtype=torch.float32) -> CLIPConfig:
    return CLIPConfig(dtype=dtype)


def clip_g_config(dtype=torch.float32) -> CLIPConfig:
    return CLIPConfig(
        hidden_size=1280, intermediate_size=5120, num_layers=32, num_heads=20, dtype=dtype
    )


def tiny_clip_config(dtype=torch.float32) -> CLIPConfig:
    return CLIPConfig(
        vocab_size=1000, hidden_size=32, intermediate_size=64, num_layers=2,
        num_heads=2, max_positions=16, dtype=dtype,
    )


def causal_attention(q, k, v):
    """(B, T, H, D) -> (B, T, H, D): softmax(q k^T / sqrt(D)) v with key j
    hidden from query i where j > i; logits in the input dtype, the
    masked softmax in fp32 (``jax.nn.dot_product_attention``'s XLA path,
    which masks with -0.7 x the dtype's largest value)."""
    t = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(q.shape[-1]))
    future = torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1)
    s = s.masked_fill(future, -0.7 * torch.finfo(s.dtype).max)
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def gelu_tanh(x):
    """GELU, tanh approximation, as ``x * sigmoid(2u)`` with
    u = sqrt(2/pi) (x + 0.044715 x^3), in fp32, cast back to x's dtype."""
    xf = x.float()
    u = math.sqrt(2.0 / math.pi) * (xf + 0.044715 * xf * xf * xf)
    return (xf * torch.sigmoid(2.0 * u)).to(x.dtype)


class Embedding(nn.Module):
    """Token embedding table (vocab, hidden) under ``weight``."""

    def __init__(self, num: int, dim: int, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim, device=device,
                                               dtype=dtype or torch.float32))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(self.weight.shape[1]), generator=generator)

    def forward(self, ids):
        return self.weight[ids]


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPConfig, **kw):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.q_proj = L.Linear(h, h, **kw)
        self.k_proj = L.Linear(h, h, **kw)
        self.v_proj = L.Linear(h, h, **kw)
        self.out_proj = L.Linear(h, h, **kw)

    def forward(self, x):
        b, t, h = x.shape
        heads = (self.cfg.num_heads, h // self.cfg.num_heads)
        q, k, v = (proj(x).unflatten(-1, heads) for proj in (self.q_proj, self.k_proj,
                                                               self.v_proj))
        return self.out_proj(causal_attention(q, k, v).reshape(b, t, h))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPConfig, **kw):
        super().__init__()
        self.fc1 = L.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc2 = L.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x):
        return self.fc2(gelu_tanh(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPConfig, **kw):
        super().__init__()
        self.layer_norm1 = L.LayerNorm(cfg.hidden_size, **kw)
        self.self_attn = CLIPAttention(cfg, **kw)
        self.layer_norm2 = L.LayerNorm(cfg.hidden_size, **kw)
        self.mlp = CLIPMLP(cfg, **kw)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextModel(nn.Module):
    """``forward(input_ids (B, T) int) -> (B, T, hidden)``, the last
    hidden state after ``final_layer_norm``. Parameters are drawn at
    construction from ``generator`` (kaiming-uniform linears, unit norms, a
    normal token table, zero positions, as the JAX model's init) on
    ``device``, the card unless the caller asks for another."""

    def __init__(self, cfg: CLIPConfig, device="cuda", param_dtype=None, generator=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=param_dtype)
        self.token_embedding = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position_embedding = nn.Parameter(torch.zeros(
            cfg.max_positions, cfg.hidden_size, device=device, dtype=param_dtype or torch.float32))
        for i in range(cfg.num_layers):
            self.add_module(f"text_model_encoder_layers_{i}", CLIPEncoderLayer(cfg, **kw))
        self.final_layer_norm = L.LayerNorm(cfg.hidden_size, **kw)
        reset_parameters(self, generator)

    def forward(self, input_ids):
        c = self.cfg
        x = self.token_embedding(input_ids) + self.position_embedding[: input_ids.shape[1]]
        x = x.to(c.dtype)
        for i in range(c.num_layers):
            x = getattr(self, f"text_model_encoder_layers_{i}")(x)
        return self.final_layer_norm(x)


def state_dict_from_jax(params) -> dict:
    """Flax ``variables["params"]`` of the JAX ``CLIPTextModel`` -> this
    model's ``state_dict``: the dotted paths, with flax ``nn.Embed``'s
    ``token_embedding.embedding`` under ``token_embedding.weight``."""
    sd = _params_by_path(params)
    sd["token_embedding.weight"] = sd.pop("token_embedding.embedding")
    return sd
