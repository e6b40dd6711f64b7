"""BOFT (butterfly orthogonal fine-tuning) functional API (counterpart of
``lycoris_tpu/functional/boft.py``; reference lycoris/functional/boft.py).

- :func:`weight_gen`: zero blocks (m, num, b, b) from
  ``power2factorization``, m at most popcount(num - 1) + 1;
- :func:`_chain`: the m butterfly stages (permute, rotate each (b, b)
  block, unpermute) along axis 0;
- :func:`dense_rotation`: the whole product as one (dim, dim) matrix,
  ``chain(I)``;
- :func:`rotate_front` / :func:`rotate_last`: the rotation of features on
  axis 0 (a weight) or on the last axis (the bypass outputs), in one of two
  equal forms picked by shape: where the other axes hold at least ``dim``
  columns, Q = chain(I) once and one matmul; else the chain on the tensor
  itself, which never forms a (dim, dim) matrix per stage (at out_dim
  10240 that would be 400 MB in fp32 for each of 11 stages). The rotation,
  the Cayley transform included, runs under ``torch.utils.checkpoint``, so
  the backward keeps only the blocks and the input and replays the stages;
- :func:`diff_weight` / :func:`bypass_forward_diff`: the rotated weight
  (or outputs), rescaled if given, less the original.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .diag_oft import get_r
from .general import power2factorization


def weight_gen(org_weight_shape, max_block_size: int, boft_m: int = -1, rescale: bool = False,
               dtype=torch.float32, device=None):
    if hasattr(org_weight_shape, "shape"):
        org_weight_shape = org_weight_shape.shape
    out_dim, *rest = org_weight_shape
    block_size, block_num = power2factorization(out_dim, max_block_size)
    if block_size is None:
        raise ValueError(f"Cannot power-of-2 factorize {out_dim} with max block size "
                         f"{max_block_size}")
    max_boft_m = (block_num - 1).bit_count() + 1
    if boft_m == -1:
        boft_m = max_boft_m
    boft_m = min(boft_m, max_boft_m)
    blocks = torch.zeros((boft_m, block_num, block_size, block_size), dtype=dtype, device=device)
    if rescale:
        return blocks, torch.ones((out_dim, *[1] * len(rest)), dtype=dtype, device=device)
    return blocks, None


def _chain(inp, r):
    """The m butterfly stages of ``r`` (m, num, b, b) applied to ``inp``
    along axis 0."""
    m, _, b, _ = r.shape
    r_b = b // 2
    rest = inp.shape[1:]
    cols = math.prod(rest)
    for i in range(m):
        k = (2 ** i) * r_b
        # butterfly permutation on axis 0: (c g k) -> (c k g), then (b, ...) blocks
        inp = inp.reshape(-1, 2, k, *rest).transpose(1, 2).reshape(-1, b, cols)
        inp = r[i] @ inp
        inp = inp.reshape(-1, k, 2, cols).transpose(1, 2).reshape(-1, *rest)
    return inp


def dense_rotation(r):
    """The butterfly product as one dense (dim, dim) matrix Q = chain(I), so
    that chain(X) == Q @ X for features on axis 0."""
    _, num, b, _ = r.shape
    return _chain(torch.eye(num * b, dtype=r.dtype, device=r.device), r)


def _scaled_r(oft_blocks, constraint, scale):
    """Every stage's Cayley rotation, blended toward I by ``scale``."""
    I = torch.eye(oft_blocks.shape[-1], dtype=oft_blocks.dtype, device=oft_blocks.device)
    r = get_r(oft_blocks, I, constraint)
    if scale != 1:
        r = r * scale + (1 - scale) * I
    return r


def use_dense(shape, dim: int, last: bool) -> bool:
    """Whether a tensor of ``shape`` with its features on axis 0 (or the last
    axis with ``last``) takes the dense form: its other axes hold at least
    ``dim`` columns."""
    if len(shape) <= 1:
        return 1 >= dim
    cols = math.prod(shape[:-1]) if last else math.prod(shape[1:])
    return cols >= dim


def _rotate_impl(inp, oft_blocks, constraint, scale, last: bool):
    _, num, b, _ = oft_blocks.shape
    r = _scaled_r(oft_blocks, constraint, scale)
    if use_dense(inp.shape, num * b, last):
        # plain matmuls: the result has the input's own strides (an einsum's
        # may read as channels-last to cuDNN)
        q = dense_rotation(r)
        return inp @ q.T if last else (q @ inp.reshape(q.shape[1], -1)).reshape(inp.shape)
    if last:
        return _chain(inp.movedim(-1, 0), r).movedim(0, -1)
    return _chain(inp, r)


def _rotate(inp, oft_blocks, constraint, scale, last):
    if torch.is_grad_enabled() and (inp.requires_grad or oft_blocks.requires_grad):
        return checkpoint(_rotate_impl, inp, oft_blocks, constraint, scale, last,
                          use_reentrant=False)
    return _rotate_impl(inp, oft_blocks, constraint, scale, last)


def rotate_front(inp, oft_blocks, constraint=None, scale: float = 1.0):
    """Checkpointed butterfly rotation, features on axis 0 (weight layout)."""
    return _rotate(inp, oft_blocks, constraint, scale, False)


def rotate_last(inp, oft_blocks, constraint=None, scale: float = 1.0):
    """Checkpointed butterfly rotation, features on the last axis (bypass)."""
    return _rotate(inp, oft_blocks, constraint, scale, True)


def diff_weight(org_weight, *weights, constraint=None):
    oft_blocks, rescale = weights
    org = org_weight.to(oft_blocks.dtype)
    inp = rotate_front(org, oft_blocks, constraint)
    if rescale is not None:
        inp = inp * rescale
    return inp - org


def bypass_forward_diff(org_out, *weights, constraint=None, need_transpose=False):
    """The base outputs butterfly-rotated (features last, or on axis 1 with
    ``need_transpose``); the delta only."""
    oft_blocks, rescale = weights
    inp = org = org_out.to(oft_blocks.dtype)
    if need_transpose:
        inp = org = inp.transpose(1, -1)
    inp = rotate_last(inp, oft_blocks, constraint)
    if rescale is not None:
        inp = inp * rescale.transpose(0, -1)
    inp = inp - org
    if need_transpose:
        inp = inp.transpose(1, -1)
    return inp
