"""Attention dispatch (counterpart of ``lycoris_tpu/ops/attention.py``).

Rule: self-attention (tq == tk) with T >= 1024 and head_dim <= 128 goes to
the flash kernel (:mod:`.flash`), at any T: the kernels mask keys past T and
write no row past it, so T need not be a multiple of a tile (Wan's 14,040
tokens). The JAX gate's T % 512 == 0 was its Pallas tiling's. Every other
attention -- cross-attention over the 77 or 512 context tokens, SD1.5's
T256/D160 level, the T64 mid block -- runs the plain path: einsum, softmax
in fp32, einsum.
"""

from __future__ import annotations

import torch

from . import flash


def use_flash(tq: int, tk: int, d: int) -> bool:
    return tq == tk and tq >= 1024 and d <= 128


def attention_plain(q, k, v, sm_scale: float):
    """(B, H, T, D) -> (B, H, T, D): logits in the input dtype, softmax in fp32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def dot_product_attention(q, k, v, layout: str = "BTHD"):
    """Attention with 1/sqrt(D) scaling; returns (B, T, H, D).

    ``layout="BTHD"``: q/k/v are (B, T, H, D). ``layout="BHTD"``: they are
    head-major (B, H, T, D), as the head-split projections emit them."""
    if layout != "BHTD":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    tq, tk, d = q.shape[2], k.shape[2], q.shape[-1]
    sm_scale = 1.0 / (d**0.5)
    if use_flash(tq, tk, d):
        o, _ = flash.flash_attention(q, k, v, sm_scale)
    else:
        o = attention_plain(q, k, v, sm_scale)
    return o.transpose(1, 2)
