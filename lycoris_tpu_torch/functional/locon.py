"""LoRA / LoCon functional API (counterpart of
``lycoris_tpu/functional/locon.py``; reference lycoris/functional/locon.py).

- :func:`weight_gen`: kaiming-uniform down, zero up, and a tucker mid core
  for convolutions whose kernel is not 1, drawn from an explicit
  ``torch.Generator``;
- :func:`diff_weight`: dW = gamma * up @ down, or the tucker rebuild;
- :func:`bypass_forward_diff`: x through down (with the layer's op
  arguments), the mid core, then up, times gamma, never forming dW.

Weights keep torch layout (out, in, *k), as the state dicts do.
"""

from __future__ import annotations

import torch

from .general import convnd, kaiming_uniform, op_by_ndim, rebuild_tucker


def weight_gen(org_weight_shape, rank: int, tucker: bool = True, dtype=torch.float32,
               generator=None, device=None):
    """(down, up, mid) for a layer of torch weight shape ``(out, in, *k)``
    (or a tensor of that shape); ``mid`` is None unless ``tucker`` and the
    layer is a convolution."""
    if hasattr(org_weight_shape, "shape"):
        org_weight_shape = org_weight_shape.shape
    out_dim, in_dim, *k = org_weight_shape
    kw = dict(dtype=dtype, generator=generator, device=device)
    ones = tuple(1 for _ in k)
    if k and tucker:
        down = kaiming_uniform((rank, in_dim, *ones), **kw)
        up = torch.zeros((out_dim, rank, *ones), dtype=dtype, device=device)
        mid = kaiming_uniform((rank, rank, *k), **kw)
        return down, up, mid
    down = kaiming_uniform((rank, in_dim, *k), **kw)
    up = torch.zeros((out_dim, rank, *ones), dtype=dtype, device=device)
    return down, up, None


def diff_weight(*weights, gamma=1.0):
    """dW = gamma * up @ down (low rank) or the tucker rebuild, shaped
    (O, I, *k)."""
    d, u, m = weights
    _, i_dim, *k = d.shape
    o_dim = u.shape[0]
    u = u * gamma
    if m is None:
        result = u.reshape(-1, u.shape[1]) @ d.reshape(d.shape[0], -1)
    else:
        k = m.shape[2:]
        result = rebuild_tucker(m, u.reshape(u.shape[0], -1).T, d.reshape(d.shape[0], -1))
    return result.reshape(o_dim, i_dim, *k)


def bypass_forward_diff(x, org_out, *weights, gamma=1.0, extra_args={}, rank_mask=None):
    """Low-rank bypass, channels-first for convolutions. ``org_out`` is
    unused (the uniform functional signature). ``extra_args`` (stride,
    padding, ...) go to the down op, or to the mid core under tucker.
    ``rank_mask`` (r,), if given, scales the rank channels of the down
    output (rank dropout)."""
    d, u, m = weights
    op = op_by_ndim(d.ndim)
    if m is not None:
        mid = convnd(op(x, d), m, **extra_args)
    else:
        mid = op(x, d, **extra_args)
    if rank_mask is not None:
        shape = (1, -1, *[1] * (mid.ndim - 2)) if d.ndim > 2 else (*[1] * (mid.ndim - 1), -1)
        mid = mid * rank_mask.reshape(shape)
    return op_by_ndim(u.ndim)(mid, u) * gamma
