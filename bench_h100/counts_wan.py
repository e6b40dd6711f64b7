"""What the port's Wan2.1 work costs, from shapes alone: the census of its
kernel launches in one training step or call, the model's FLOPs a forward,
and the flash kernels' bounds, beside ``counts.py``'s for the UNet and the
Flux DiT (whose kernel formulas, bound and name rules it uses).

The census is frozen here: the port's attention rule with the relaxed gate
(self-attention at any T >= 1024 and head dim <= 128 takes flash; the
cross-attention to the text takes the plain path), the LayerNorm kernel on
each block's ``norm3`` (weight and bias; the modulated norms have no
affine parameters and are plain fp32 LayerNorms), and a checkpointed block
running its forward twice in a training step.
"""

from __future__ import annotations

import math
from collections import Counter

from . import counts


def use_flash(tq: int, tk: int, d: int) -> bool:
    """The port's attention dispatch rule (ops/attention.py, frozen)."""
    return tq == tk and tq >= 1024 and d <= 128


def tokens(sizes: dict, fhw) -> int:
    """Video tokens of an (F, H, W) latent: one a (1, 2, 2) patch."""
    return math.prod(n // p for n, p in zip(fhw, sizes["patch_size"]))


def wan_census(sizes: dict, batch: int, fhw, txt: int, train: bool, remat: bool) -> dict:
    """Launches of each of the port's kernels in one Wan call (``train``:
    one training step, each block run twice where ``remat`` checkpoints
    it), as {kernel: Counter(shape -> launches)}; an adapter's own part
    comes from its algorithm (:func:`counts.with_adapter`)."""
    d, nl, nh = sizes["dim"], sizes["num_layers"], sizes["num_heads"]
    t, hd = tokens(sizes, fhw), sizes["dim"] // sizes["num_heads"]
    again = 2 if train and remat else 1
    out = {k: Counter() for k in ("flash_fwd", "flash_bwd", "layer_norm_fwd", "layer_norm_bwd")}
    for tk in (t, txt):  # self-attention, then cross-attention
        if use_flash(t, tk, hd):
            out["flash_fwd"][(batch * nh, t, hd)] += again * nl
            if train:
                out["flash_bwd"][(batch * nh, t, hd)] += nl
    out["layer_norm_fwd"][(batch * t, d)] += again * nl
    if train:
        out["layer_norm_bwd"][(batch * t, d)] += nl
    return out


def wan_flops(sizes: dict, batch: int, fhw, txt: int) -> float:
    """One Wan forward: the patch embedding, the text and time embeddings,
    every block's projections, self- and cross-attention and FFN, the head."""
    d, ffn = sizes["dim"], sizes["ffn_dim"]
    t, b = tokens(sizes, fhw), batch
    lin = counts.linear_flops
    patch = sizes["in_dim"] * math.prod(sizes["patch_size"])
    f = (lin(patch, d, b * t) + lin(sizes["text_dim"], d, b * txt) + lin(d, d, b * txt)
         + lin(sizes["freq_dim"], d, b) + lin(d, d, b) + lin(d, 6 * d, b))
    block = (4 * lin(d, d, b * t) + counts.attention_flops(b, t, t, d)
             + 2 * lin(d, d, b * t) + 2 * lin(d, d, b * txt) + counts.attention_flops(b, t, txt, d)
             + lin(d, ffn, b * t) + lin(ffn, d, b * t))
    f += sizes["num_layers"] * block
    f += lin(d, sizes["out_dim"] * math.prod(sizes["patch_size"]), b * t)
    return f

