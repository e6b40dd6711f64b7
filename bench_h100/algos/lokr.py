"""LoKr, for the benchmark: the trainable tensors of a layer and their
scale, the dW they form, the keyword arguments the port's network takes,
and what the port launches for it beyond the model's own kernels.

dW = scale * kron(w1, w2), w2 = w2_a w2_b where dim is below half the
larger w2 side, else w2 whole (and then scale 1): LyCORIS lokr.py's branch
table for linear and 1x1 layers (no tucker, no decompose_both), frozen.
"""

from __future__ import annotations

FACTORED_MIN = 1024  # the harmonic dimension from which a linear layer takes the factored backward


def factorization(dimension: int, factor: int = -1) -> tuple[int, int]:
    """(m, n), m <= n, m * n == dimension, m the closest-to-square divisor
    not above ``factor`` (LyCORIS functional/general.py)."""
    if factor > 0 and dimension % factor == 0:
        m, n = factor, dimension // factor
        return (n, m) if m > n else (m, n)
    if factor < 0:
        factor = dimension
    m, n = 1, dimension
    length = m + n
    while m < n:
        new_m = m + 1
        while dimension % new_m:
            new_m += 1
        new_n = dimension // new_m
        if new_m + new_n > length or new_m > factor:
            break
        m, n = new_m, new_n
    return (n, m) if m > n else (m, n)


def shapes(out_dim: int, in_dim: int, adapter: dict) -> dict:
    """{"shapes": {key: shape}, "scale": scale} of one layer's factors."""
    dim = adapter["dim"]
    out_l, out_k = factorization(out_dim, adapter["factor"])
    in_m, in_n = factorization(in_dim, adapter["factor"])
    out = {"lokr_w1": (out_l, in_m)}
    if dim < max(out_k, in_n) / 2:
        out["lokr_w2_a"], out["lokr_w2_b"] = (out_k, dim), (dim, in_n)
        scale = adapter["alpha"] / dim
    else:
        out["lokr_w2"] = (out_k, in_n)
        scale = 1.0
    return {"shapes": out, "scale": scale}


def delta(theta: dict, scale: float):
    """scale * kron(w1, w2) as an (out, in) fp32 matrix."""
    import torch

    w2 = theta["lokr_w2"] if "lokr_w2" in theta else theta["lokr_w2_a"] @ theta["lokr_w2_b"]
    return scale * torch.kron(theta["lokr_w1"], w2.reshape(w2.shape[0], -1))


def port_kwargs(adapter: dict) -> dict:
    return {"factor": adapter["factor"]}


def census(layers: list, adapter: dict, train: bool) -> dict:
    """Beyond the model's kernels, for ``layers`` [(weight shape, forward
    passes a call)]: in training, the linear layers whose harmonic
    dimension reaches FACTORED_MIN take the factored backward
    (``factored``: applications a call); LoKr launches no kernel of the
    port's own."""
    if not train:
        return {}
    return {"factored": sum(n for shape, n in layers if len(shape) == 2
                            and (shape[0] * shape[1]) // (shape[0] + shape[1]) >= FACTORED_MIN)}
