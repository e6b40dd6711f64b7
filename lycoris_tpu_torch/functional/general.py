"""Shared stateless math of the port (counterpart of
``lycoris_tpu/functional/general.py``).

- ``factorization`` / ``power2factorization`` are integer code copied bit
  for bit: they define the checkpoint format.
- The activation ops keep torch layout (weights (out, in, *k),
  channels-first activations), as the JAX package does.
- ``layer_norm`` sends the affine single-dim case to the LayerNorm kernel
  (``ops/layer_norm.py``); ``group_norm`` and ``group_norm_act`` go to the
  GroupNorm(+SiLU) kernels (``ops/group_norm.py``: the JAX package's math,
  var = E[x^2] - mean^2 in fp32, gamma/beta folded into one FMA), not
  ``F.group_norm``; ``geglu_mul`` (the tanh-approximated gelu that
  ``jax.nn.gelu`` defaults to) has its backward in the GEGLU kernel
  (``ops/geglu.py``); ``rms_norm`` is plain PyTorch, as it is plain XLA in
  the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Integer factorizations (host-side, static)
# ---------------------------------------------------------------------------


def factorization(dimension: int, factor: int = -1) -> tuple[int, int]:
    """Decompose ``dimension`` into (m, n), m <= n, m*n == dimension, with m
    the closest-to-square divisor not above ``factor`` (reference
    lycoris/functional/general.py:14-56, including the fast path when
    ``factor`` divides ``dimension``)."""
    if factor > 0 and (dimension % factor) == 0:
        m = factor
        n = dimension // factor
        if m > n:
            n, m = m, n
        return m, n
    if factor < 0:
        factor = dimension
    m, n = 1, dimension
    length = m + n
    while m < n:
        new_m = m + 1
        while dimension % new_m != 0:
            new_m += 1
        new_n = dimension // new_m
        if new_m + new_n > length or new_m > factor:
            break
        m, n = new_m, new_n
    if m > n:
        n, m = m, n
    return m, n


def power2factorization(dimension: int, factor: int = -1) -> tuple[int | None, int]:
    """(m, n) with m even, n a power of two, m*n == dimension, m <= factor;
    (None, 0) when impossible (reference lycoris/functional/general.py:59-81)."""
    if factor == -1:
        factor = dimension

    m = n = 0
    while m <= factor:
        m += 2
        while dimension % m != 0 and m < dimension:
            m += 2
        if m > factor:
            break
        if (dimension // m).bit_count() == 1:
            n = dimension // m

    if n == 0:
        return None, n
    return dimension // n, n


# ---------------------------------------------------------------------------
# Tucker rebuild
# ---------------------------------------------------------------------------


def rebuild_tucker(t, wa, wb):
    """einsum("i j ..., i p, j r -> p r ...", t, wa, wb) (reference general.py:9-11)."""
    return torch.einsum("ij...,ip,jr->pr...", t, wa, wb)


# ---------------------------------------------------------------------------
# DoRA
# ---------------------------------------------------------------------------


def out_norm(weight):
    """The L2 norm of each output row of ``weight`` (O, I, *k), shaped
    (O, 1, *1): DoRA's ``wd_on_out`` norm."""
    return weight.reshape(weight.shape[0], -1).norm(dim=1).reshape(
        weight.shape[0], *[1] * (weight.ndim - 1))


def in_norm(weight):
    """The L2 norm of each input column of ``weight`` (O, I, *k) over O and
    the kernel, shaped (1, I, *1): DoRA's norm without ``wd_on_out``."""
    return weight.transpose(0, 1).reshape(weight.shape[1], -1).norm(dim=1).reshape(
        weight.shape[1], *[1] * (weight.ndim - 1)).transpose(0, 1)


def apply_dora_scale(org_weight, rebuild, dora_scale, scale):
    """Weight-decompose (DoRA) merge, column-norm variant (JAX
    functional/general.py:144-163; reference general.py:95-108)."""
    weight = (org_weight + rebuild).to(dora_scale.dtype)
    diff_weight = weight / in_norm(weight) * dora_scale - org_weight
    return org_weight + diff_weight * scale


def apply_dora_scale_on_out(org_weight, rebuild, dora_scale, scale):
    """Weight-decompose (DoRA) merge, row-norm (``wd_on_out``) variant (JAX
    functional/general.py:166-179)."""
    weight = (org_weight + rebuild).to(dora_scale.dtype)
    diff_weight = weight / out_norm(weight) * dora_scale - org_weight
    return org_weight + diff_weight * scale


# ---------------------------------------------------------------------------
# Channels-first linear / convNd ops
# ---------------------------------------------------------------------------


def _normalize_tuple(v, n: int):
    if isinstance(v, (tuple, list)):
        if len(v) == n:
            return tuple(int(x) for x in v)
        if len(v) == 1:
            return tuple(int(v[0]) for _ in range(n))
        raise ValueError(f"expected length-{n} tuple, got {v}")
    return tuple(int(v) for _ in range(n))


def linear(x, weight, bias=None):
    """y = x @ W^T + b with W of shape (out, in)."""
    return F.linear(x, weight, bias)


def linear_head_split(x, weight, bias, heads: int, head_dim: int):
    """Attention projection emitting the head-major layout:
    ``(..., T, C_in) -> (..., heads, T, head_dim)``. The result is a strided
    view of the (..., T, heads * head_dim) matmul output; the flash kernel
    reads it through its strides without a copy."""
    y = F.linear(x, weight, bias)
    return y.unflatten(-1, (heads, head_dim)).transpose(-2, -3)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def convnd(x, weight, bias=None, stride=1, padding=0, dilation=1, groups: int = 1):
    """Channels-first N-d convolution with torch-layout weight (O, I/g, *k)."""
    nd = weight.ndim - 2
    if nd not in _CONV:
        raise ValueError(f"unsupported conv ndim {nd}")
    if isinstance(padding, str):
        pad = padding.lower()
        if pad not in ("same", "valid"):
            raise ValueError(f"unsupported padding {padding}")
    else:
        pad = _normalize_tuple(padding, nd)
    return _CONV[nd](
        x, weight, bias, stride=_normalize_tuple(stride, nd), padding=pad,
        dilation=_normalize_tuple(dilation, nd), groups=groups,
    )


def layer_norm(x, normalized_shape, weight=None, bias=None, eps: float = 1e-5):
    """torch F.layer_norm semantics over the trailing dims. The affine
    single-trailing-dim case goes to the LayerNorm kernels, forward and
    backward (ops/layer_norm.py)."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    if len(normalized_shape) == 1 and weight is not None and weight.ndim == 1:
        from ..ops import layer_norm as _ln

        return _ln.layer_norm(
            x.contiguous(), weight.to(x.dtype),
            None if bias is None else bias.to(x.dtype), eps,
        )
    dims = tuple(range(x.ndim - len(normalized_shape), x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def rms_norm(x, normalized_shape, weight=None, bias=None, eps: float = 1e-6):
    """RMSNorm over the trailing dims (torch ``nn.RMSNorm``, the reference's
    duck-typed ``_norm`` modules): x / sqrt(mean(x^2) + eps), then
    ``weight`` and ``bias``. With ``weight=dw`` it is the Norm algorithm's
    delta ``org_norm(x) * dw`` (JAX functional/general.py:382-400)."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.ndim - len(normalized_shape), x.ndim))
    y = x * torch.rsqrt((x * x).mean(dim=dims, keepdim=True) + eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def group_norm(x, num_groups: int, weight=None, bias=None, eps: float = 1e-5):
    """GroupNorm (N, C, *spatial) as the JAX package computes it
    (general.py:435-463), through the GroupNorm kernels (ops/group_norm.py)."""
    from ..ops import group_norm as _gn

    return _gn.group_norm_act(x, num_groups, weight, bias, eps)


def group_norm_act(x, num_groups: int, weight=None, bias=None, eps: float = 1e-5,
                   act: str | None = None):
    """GroupNorm followed by a folded activation (None or "silu"), one kernel
    per direction (ops/group_norm.py)."""
    from ..ops import group_norm as _gn

    return _gn.group_norm_act(x, num_groups, weight, bias, eps, act=act)


def geglu_mul(h_full):
    """``h * gelu(gate)`` with ``h, gate = split(h_full, 2)``; gelu is the tanh
    approximation, as ``jax.nn.gelu`` defaults to. The backward is the GEGLU
    kernel (ops/geglu.py)."""
    from ..ops import geglu as _geglu

    return _geglu.geglu_mul(h_full)


def op_by_ndim(ndim: int):
    """Dispatch helper mirroring reference ``FUNC_LIST[w.dim()]``."""
    if ndim == 2:
        return linear
    if ndim in (3, 4, 5):
        return convnd
    raise ValueError(f"no op for weight ndim {ndim}")


# ---------------------------------------------------------------------------
# Initializers (torch-parity)
# ---------------------------------------------------------------------------


def kaiming_uniform(shape, a: float = math.sqrt(5), dtype=torch.float32, generator=None,
                    device=None):
    """torch.nn.init.kaiming_uniform_ parity: U(-b, b), b = sqrt(6/((1+a^2)*fan_in)),
    fan_in = in * prod(k) for (out, in, *k) tensors."""
    fan_in = shape[1] * math.prod(shape[2:]) if len(shape) > 1 else shape[0]
    gain = math.sqrt(2.0 / (1.0 + a * a))
    bound = gain * math.sqrt(3.0 / fan_in)
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.uniform_(-bound, bound, generator=generator)


def normal_init(shape, std: float = 1.0, dtype=torch.float32, generator=None, device=None):
    return torch.randn(shape, dtype=dtype, device=device, generator=generator) * std
