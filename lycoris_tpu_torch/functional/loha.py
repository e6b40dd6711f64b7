"""LoHa (Hadamard product of two low-rank factors) functional API, forward
(counterpart of ``lycoris_tpu/functional/loha.py``).

dW = (w1u @ w1d) * (w2u @ w2d) * gamma. ``make_weight`` sends it to the
LoHa kernel (``ops/hada.py``) wherever the JAX package sends it to its
Pallas kernel (O >= 8, I >= 128); the backward waits for the training slice.
"""

from __future__ import annotations

import torch


def hada_weight(w1d, w1u, w2d, w2u, scale=1.0):
    return (w1u @ w1d) * (w2u @ w2d) * scale


def hada_weight_tucker(t1, w1d, w1u, t2, w2d, w2u, scale=1.0):
    rebuild1 = torch.einsum("ij...,jr,ip->pr...", t1, w1d, w1u)
    rebuild2 = torch.einsum("ij...,jr,ip->pr...", t2, w2d, w2u)
    return rebuild1 * rebuild2 * scale


def make_weight(w1d, w1u, w2d, w2u, scale):
    """Note the argument order: (w1d, w1u, w2d, w2u), which modules/loha.py
    fills from (hada_w1_b, hada_w1_a, hada_w2_b, hada_w2_a)."""
    from ..ops import hada

    if hada.supported(w1d, w1u):
        return hada.hada_weight(w1d, w1u, w2d, w2u, scale)
    return hada_weight(w1d, w1u, w2d, w2u, scale)


def diff_weight(*weights, gamma=1.0):
    """dW for LoHa, shaped (O, I, *k) (reference loha.py:119-147)."""
    w1d, w1u, w2d, w2u, t1, t2 = weights
    if t1 is not None and t2 is not None:
        I = w1d.shape[1]
        O = w1u.shape[1]
        k = t1.shape[2:]
        result = hada_weight_tucker(t1, w1d, w1u, t2, w2d, w2u, gamma)
    else:
        _, I, *k = w1d.shape
        O = w1u.shape[0]
        result = make_weight(
            w1d.reshape(w1d.shape[0], -1),
            w1u.reshape(-1, w1u.shape[1]),
            w2d.reshape(w2d.shape[0], -1),
            w2u.reshape(-1, w2u.shape[1]),
            gamma,
        )
    return result.reshape(O, I, *k)

