"""LoHa, for the benchmark: dW = scale * (w1_a w1_b) * (w2_a w2_b), the
Hadamard product of two rank-``dim`` products, scale = alpha / dim (no
tucker, no rs-LoRA), as LyCORIS loha.py forms it for linear and 1x1
layers. The port forms it with its hada kernel, once a forward pass of
each adapted layer."""

from __future__ import annotations

from collections import Counter


def shapes(out_dim: int, in_dim: int, adapter: dict) -> dict:
    r = adapter["dim"]
    return {"shapes": {"hada_w1_a": (out_dim, r), "hada_w1_b": (r, in_dim),
                       "hada_w2_a": (out_dim, r), "hada_w2_b": (r, in_dim)},
            "scale": adapter["alpha"] / r}


def delta(theta: dict, scale: float):
    return scale * ((theta["hada_w1_a"] @ theta["hada_w1_b"])
                    * (theta["hada_w2_a"] @ theta["hada_w2_b"]))


def port_kwargs(adapter: dict) -> dict:
    return {}


def census(layers: list, adapter: dict, train: bool) -> dict:
    """One forward kernel launch (``hada_fwd`` at (out, in, rank)) a
    forward pass of each adapted layer."""
    out = Counter()
    for shape, n in layers:
        i = 1
        for s in shape[1:]:
            i *= s
        out[(shape[0], i, adapter["dim"])] += n
    return {"hada_fwd": out}
