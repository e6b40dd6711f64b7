"""Diag-OFT functional API (counterpart of ``lycoris_tpu/functional/diag_oft.py``;
reference lycoris/functional/diag_oft.py).

- :func:`get_r`: the Cayley transform R = (I + Q)(I - Q)^-1 of the
  skew-symmetric Q = B - B^T of each (b, b) block, with the COFT norm
  constraint as a tensor ``clamp`` (never a host ``if`` on a tensor);
- :func:`weight_gen`: zero blocks from ``factorization(out_dim, max_block)``
  and an optional all-ones rescale;
- :func:`diff_weight`: the layer's weight rotated by (R - I) block by block
  on its output axis;
- :func:`bypass_forward_diff`: the same rotation applied to the base layer's
  outputs, the boft signature ``(org_out, *weights)`` as in the JAX package.

The inverse is ``torch.linalg.inv_ex`` in fp32 with ``check_errors=False``:
``torch.linalg.inv`` would read the LU info on the host, a synchronisation
in every adapted layer. I - Q has the identity as its symmetric part, so it
is never singular. The JAX package's pivot-free Gauss-Jordan was chosen for
a TPU measurement and is not carried over.
"""

from __future__ import annotations

import torch

from .general import factorization


def _constrained(constraint) -> bool:
    if constraint is None:
        return False
    return not isinstance(constraint, (int, float)) or constraint > 0


def get_r(oft_blocks, I=None, constraint=0):
    """R = (I + Q)(I - Q)^-1 with Q = B - B^T over the last two dims; with
    ``constraint``, Q is first scaled by min(1, constraint / (|Q| + 1e-8))."""
    if I is None:
        I = torch.eye(oft_blocks.shape[-1], dtype=oft_blocks.dtype, device=oft_blocks.device)
    q = oft_blocks - oft_blocks.transpose(-1, -2)
    if _constrained(constraint):
        q_norm = torch.linalg.vector_norm(q) + 1e-8
        q = q * (constraint / q_norm).clamp(max=1.0)
    inv = torch.linalg.inv_ex((I - q).float(), check_errors=False)[0].to(q.dtype)
    return (I + q) @ inv


def weight_gen(org_weight_shape, max_block_size: int = -1, rescale: bool = False,
               dtype=torch.float32, device=None):
    """Zero-init oft blocks (the identity rotation) and, with ``rescale``, an
    all-ones (out, 1, ...) rescale, else None."""
    if hasattr(org_weight_shape, "shape"):
        org_weight_shape = org_weight_shape.shape
    out_dim, *rest = org_weight_shape
    block_size, block_num = factorization(out_dim, max_block_size)
    blocks = torch.zeros((block_num, block_size, block_size), dtype=dtype, device=device)
    if rescale:
        return blocks, torch.ones((out_dim, *[1] * len(rest)), dtype=dtype, device=device)
    return blocks, None


def diff_weight(org_weight, *weights, constraint=None):
    """dW of the block-diagonal rotation of ``org_weight``'s output rows,
    with the rescale if given: zero at init."""
    oft_blocks, rescale = weights
    I = torch.eye(oft_blocks.shape[1], dtype=oft_blocks.dtype, device=oft_blocks.device)
    r = get_r(oft_blocks, I, constraint)
    block_num, block_size, _ = oft_blocks.shape
    shape = org_weight.shape[1:]
    org = org_weight.to(r.dtype).reshape(block_num, block_size, *shape)
    weight = ((r - I).transpose(1, 2) @ org.reshape(block_num, block_size, -1)).reshape(
        -1, *shape)
    if rescale is not None:
        weight = rescale * weight
        weight = weight + (rescale - 1) * org_weight
    return weight


def bypass_forward_diff(org_out, *weights, constraint=None, need_transpose=False):
    """The base layer's outputs rotated by (R - I) (features last, or on
    axis 1 with ``need_transpose``); the delta only."""
    oft_blocks, rescale = weights
    block_num, block_size, _ = oft_blocks.shape
    I = torch.eye(block_size, dtype=oft_blocks.dtype, device=oft_blocks.device)
    r = get_r(oft_blocks, I, constraint)
    if need_transpose:
        org_out = org_out.transpose(1, -1)
    org_out = org_out.to(r.dtype)
    lead = org_out.shape[:-1]
    out = torch.einsum("knm,...kn->...km", r - I,
                       org_out.reshape(*lead, block_num, block_size)).reshape(*lead, -1)
    if rescale is not None:
        rs = rescale.transpose(-1, 0)
        out = rs * out
        out = out + (rs - 1) * org_out
    if need_transpose:
        out = out.transpose(1, -1)
    return out
