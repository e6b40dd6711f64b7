"""LoKr (Kronecker product) functional API (counterpart of
``lycoris_tpu/functional/lokr.py``).

- ``make_kron``: dW = scale * (w1 kron w2), w1 broadcast over w2's spatial dims.
- ``weight_gen``: the factors of a layer, by the module's branch table
  (reference lokr.py:41-121).
- ``diff_weight``: rebuild w1 and w2 (full, LoRA pair or tucker), then kron
  with scale gamma / rank (reference lokr.py:124-151).
- ``bypass_forward_diff`` / ``bypass_diff_with_scale``: the grouped-matmul
  Kronecker bypass that never forms dW (reference lokr.py:154-247).
"""

from __future__ import annotations

import torch

from .general import factorization, kaiming_uniform, linear, op_by_ndim, rebuild_tucker


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


def weight_gen(org_weight_shape, rank: int, tucker: bool = True, factor: int = -1,
               decompose_both: bool = False, full_matrix: bool = False,
               unbalanced_factorization: bool = False, dtype=torch.float32, generator=None,
               device=None):
    """(w1, w1a, w1b, w2, w2a, w2b, t2), None for the unused slots, for a
    layer of torch weight shape ``(out, in, *k)`` (or a tensor of that
    shape): the JAX ``weight_gen``'s branches and init (w2 or w2b zero)."""
    if hasattr(org_weight_shape, "shape"):
        org_weight_shape = org_weight_shape.shape
    out_dim, in_dim, *k = org_weight_shape
    in_m, in_n = factorization(in_dim, factor)
    out_l, out_k = factorization(out_dim, factor)
    if unbalanced_factorization:
        out_l, out_k = out_k, out_l
    shape = ((out_l, out_k), (in_m, in_n))
    tucker = bool(k) and tucker and any(i != 1 for i in k)
    if decompose_both and rank < max(shape[0][0], shape[1][0]) / 2 and not (k and full_matrix):
        w1_shapes = ((shape[0][0], rank), (rank, shape[1][0]))
    else:
        w1_shapes = ((shape[0][0], shape[1][0]),)
    if k:
        if rank >= max(shape[0][1], shape[1][1]) / 2 or full_matrix:
            w2_shapes = ((shape[0][1], shape[1][1], *k),)
        elif tucker:
            w2_shapes = ((rank, shape[0][1]), (rank, shape[1][1]), (rank, rank, *k))
        else:
            w2_shapes = ((shape[0][1], rank), (rank, shape[1][1], *k))
    elif rank < max(shape[0][1], shape[1][1]) / 2:
        w2_shapes = ((shape[0][1], rank), (rank, shape[1][1]))
    else:
        w2_shapes = ((shape[0][1], shape[1][1]),)

    kw = dict(dtype=dtype, generator=generator, device=device)
    w1 = w1a = w1b = w2 = w2a = w2b = t2 = None
    if len(w2_shapes) == 1:
        w2 = torch.zeros(w2_shapes[0], dtype=dtype, device=device)
    else:
        if len(w2_shapes) == 3:
            t2 = kaiming_uniform(w2_shapes[2], **kw)
        w2a = kaiming_uniform(w2_shapes[0], **kw)
        w2b = torch.zeros(w2_shapes[1], dtype=dtype, device=device)
    if len(w1_shapes) == 1:
        w1 = kaiming_uniform(w1_shapes[0], **kw)
    else:
        w1a, w1b = (kaiming_uniform(s_, **kw) for s_ in w1_shapes)
    return w1, w1a, w1b, w2, w2a, w2b, t2


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


def bypass_forward_diff(h, org_out, *weights, gamma=1.0, extra_args={}):
    """The Kronecker bypass of :func:`diff_weight`'s dW (scale gamma / rank,
    the rank of the LoRA pair that exists); ``org_out`` is unused."""
    w1, w1a, w1b, w2, w2a, w2b, t = weights
    rank = w1b.shape[0] if w1 is None else w2b.shape[0] if w2 is None else gamma
    return bypass_diff_with_scale(h, *weights, scale=gamma / rank, extra_args=extra_args)


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
