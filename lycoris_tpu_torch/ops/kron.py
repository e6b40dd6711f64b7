"""LoKr's merged weight W + c * kron(w1, w2) in one pass: the CUDA kernel
``csrc/kron_merge.cu`` and its plain version.

:func:`merge` is the one LoKr merge of the port (``LokrModule``'s
``get_merged_weight`` and the factored forward's ``recon_fn``, wherever no
autograd graph runs through the merge). c = scalar * k, with ``scalar`` a
tensor read on the device (no host synchronise) and ``k`` a float. It
launches the kernel for the shapes and dtypes :func:`supported` admits (a bf16
weight on the card merged into bf16, fp32 factors, v a multiple of 8), and
takes :func:`merge_plain`, the same formula in PyTorch ops, for everything
else, the CPU included. Both round in the same order, so on the card they
agree bit for bit.

The kernel has no counterpart among the JAX package's Pallas kernels: XLA
fuses the JAX package's W + dW into one loop over W by itself.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0  # kernel launches since the last reset (chip_smoke and the card tests count these)

PAIRS_PER_BLOCK = 8  # blocks of W (of the p*q) a CUDA block sweeps, two loops of kron_merge.cu's 4
_THREADS = 256  # kron_merge.cu THREADS: 8-column vectors of w2 a CUDA block
_MAX_TILES = 65535  # the grid's y: tiles of w2


def supported(w, w1, w2, scalar, out_dtype) -> bool:
    """Whether the kernel takes this merge: W (p*u, q*v), bf16 on the card,
    into bf16; w1 (p, q), w2 (u, v) and ``scalar`` fp32 on W's device; every
    tensor contiguous and 16-byte aligned; v a multiple of 8 (16-byte
    vectors of W along a row of w2)."""
    if not (w.is_cuda and w.dtype == torch.bfloat16 and out_dtype == torch.bfloat16
            and w1.ndim == 2 and w2.ndim == 2):
        return False
    (p, q), (u, v) = w1.shape, w2.shape
    if (w.numel() != p * u * q * v or w.shape[0] != p * u or v % 8
            or -(-u * v // 8 // _THREADS) > _MAX_TILES):
        return False
    tensors = (w, w1, w2, scalar)
    return (all(t.dtype == torch.float32 for t in tensors[1:]) and scalar.numel() == 1
            and all(t.device == w.device and t.is_contiguous() and t.data_ptr() % 16 == 0
                    for t in tensors[:3])
            and scalar.device == w.device)


def merge_plain(w, w1, w2, scalar, k, out_dtype):
    """W + ((w1 * (scalar * k)) kron w2) in fp32, then cast to ``out_dtype``:
    the kernel's formula and rounding order, in W's shape (a 1x1
    convolution's weight taken as its 2-D matrix)."""
    (p, q), (u, v) = w1.shape, w2.shape
    w1c = w1.float() * (scalar.float() * k)
    prod = w1c.reshape(p, 1, q, 1) * w2.float().reshape(1, u, 1, v)
    return (w.float().reshape(p, u, q, v) + prod).reshape(w.shape).to(out_dtype)


def merge_kernel(w, w1, w2, scalar, k):
    """The kernel on tensors :func:`supported` admits: a fresh bf16 W_eff."""
    global launches
    (p, q), (u, v) = w1.shape, w2.shape
    out = torch.empty(w.shape, dtype=w.dtype, device=w.device)
    rc = _build.lib().lyc_kron_merge(
        w.data_ptr(), w1.data_ptr(), w2.data_ptr(), scalar.data_ptr(), float(k),
        out.data_ptr(), p, q, u, v, min(PAIRS_PER_BLOCK, p * q), _build.stream_ptr(w))
    _build.check(rc, "lyc_kron_merge")
    launches += 1
    return out


def merge(w, w1, w2, scalar, k, out_dtype):
    """W + c * kron(w1, w2) in ``out_dtype``, c = ``scalar`` * ``k``: the
    kernel where :func:`supported` admits the call, else
    :func:`merge_plain`. No autograd graph is made through the kernel: the
    caller takes this route only where none is wanted."""
    if supported(w, w1, w2, scalar, out_dtype):
        return merge_kernel(w, w1, w2, scalar, k)
    return merge_plain(w, w1, w2, scalar, k, out_dtype)
