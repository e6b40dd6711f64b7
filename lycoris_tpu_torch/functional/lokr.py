"""LoKr (Kronecker product) functional API (counterpart of
``lycoris_tpu/functional/lokr.py``).

- ``make_kron``: dW = scale * (w1 kron w2), w1 broadcast over w2's spatial dims.
- ``diff_weight``: rebuild w1 and w2 (full, LoRA pair or tucker), then kron
  with scale gamma / rank (reference lokr.py:124-151).
- ``bypass_diff_with_scale``: the grouped-matmul Kronecker bypass that never
  forms dW (reference lokr.py:154-247).
"""

from __future__ import annotations

from .general import linear, op_by_ndim, rebuild_tucker


def make_kron(w1, w2, scale=1.0, out_dtype=None):
    """scale * (w1 kron w2); ``scale`` is folded into the small factor w1 and
    ``out_dtype`` casts before the final reshape."""
    for _ in range(w2.ndim - w1.ndim):
        w1 = w1[..., None]
    if not (isinstance(scale, (int, float)) and scale == 1.0):
        w1 = w1 * scale
    p, q = w1.shape[:2]
    u, v = w2.shape[:2]
    spatial = w2.shape[2:]
    prod = w1.reshape(p, 1, q, 1, *w1.shape[2:]) * w2.reshape(1, u, 1, v, *spatial)
    if out_dtype is not None:
        prod = prod.to(out_dtype)
    return prod.reshape(p * u, q * v, *spatial)


def diff_weight(*weights, gamma=1.0):
    """Rebuild w1 and w2 then Kronecker; scale = gamma / rank, the rank taken
    from whichever LoRA pair exists (reference lokr.py:124-151)."""
    w1, w1a, w1b, w2, w2a, w2b, t = weights
    if w1a is not None:
        rank = w1a.shape[1]
    elif w2a is not None:
        rank = w2a.shape[1]
    else:
        rank = gamma
    scale = gamma / rank
    if w1 is None:
        w1 = w1a @ w1b
    if w2 is None:
        if t is None:
            r, o, *k = w2b.shape
            w2 = (w2a @ w2b.reshape(r, -1)).reshape(-1, o, *k)
        else:
            w2 = rebuild_tucker(t, w2a, w2b)
    return make_kron(w1, w2, scale)


def bypass_diff_with_scale(h, *weights, scale=1.0, extra_args={}):
    """Kronecker bypass with an explicit output scale, in the activation dtype:
    for W = w1 kron w2 and x grouped as (..., uq, vq), y = w1 . (x . w2^T)^T
    over the groups; convs fold the group axis into the batch."""
    weights = tuple(None if w is None else w.to(h.dtype) for w in weights)
    w1, w1a, w1b, w2, w2a, w2b, t = weights
    use_w1 = w1 is not None
    use_w2 = w2 is not None
    tucker = t is not None
    dim = t.ndim if tucker else w2.ndim if w2 is not None else w2b.ndim
    is_conv = dim > 2
    op = op_by_ndim(dim)
    kw_dict = extra_args if is_conv else {}

    if use_w2:
        ba = w2
    else:
        a = w2b
        b = w2a
        if tucker:
            a = a.reshape(*a.shape, *[1] * (dim - 2))
            b = b.T.reshape(*b.T.shape, *[1] * (dim - 2))
        elif is_conv:
            b = b.reshape(*b.shape, *[1] * (dim - 2))

    c = w1 if use_w1 else w1a @ w1b
    uq = c.shape[1]

    if is_conv:
        B = h.shape[0]
        rest = h.shape[2:]
        h_in_group = h.reshape(B * uq, -1, *rest)
    else:
        h_in_group = h.reshape(*h.shape[:-1], uq, -1)

    if use_w2:
        hb = op(h_in_group, ba, **kw_dict)
    elif is_conv:
        if tucker:
            ha = op(h_in_group, a)
            ht = op(ha, t, **kw_dict)
            hb = op(ht, b)
        else:
            ha = op(h_in_group, a, **kw_dict)
            hb = op(ha, b)
    else:
        ha = op(h_in_group, a, **kw_dict)
        hb = op(ha, b)

    if is_conv:
        hb = hb.reshape(B, -1, *hb.shape[1:])
        h_cross_group = hb.transpose(1, -1)
    else:
        h_cross_group = hb.transpose(-1, -2)

    hc = linear(h_cross_group, c)
    if is_conv:
        hc = hc.transpose(1, -1)
        out = hc.reshape(B, -1, *hc.shape[3:])
    else:
        hc = hc.transpose(-1, -2)
        out = hc.reshape(*hc.shape[:-2], -1)
    return (out * scale).to(h.dtype)
