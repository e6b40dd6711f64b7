"""LoHa delta weight dW = (w1u @ w1d) * (w2u @ w2d) * gamma: the CUDA kernel
``csrc/hada_fwd.cu``.

Counterpart of ``lycoris_tpu/ops/hada.py`` (forward only; the fused1 and
split backward kernels belong to the training slice). Dispatch follows the
JAX gate (:func:`supported`: O >= 8 and I >= 128); smaller layers take the
functional path in ``functional/loha.py``, as they do in the JAX package.

:func:`hada_weight` takes the plain version :func:`hada_weight_plain` only
for tensors on the CPU. For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0  # kernel launches since the last reset (chip_smoke counts these)


def supported(w1d, w1u) -> bool:
    o, r = w1u.shape
    return o >= 8 and w1d.shape[1] >= 128 and r >= 1


def hada_weight_plain(w1d, w1u, w2d, w2u, scale=1.0):
    """Both rank-R products in fp32, multiplied and scaled; out in w1u's dtype."""
    p1 = w1u.float() @ w1d.float()
    p2 = w2u.float() @ w2d.float()
    return (p1 * p2 * scale).to(w1u.dtype)


def hada_weight(w1d, w1u, w2d, w2u, scale=1.0):
    """w1d, w2d: (R, I); w1u, w2u: (O, R) -> (O, I) in w1u's dtype."""
    global launches
    if w1u.device.type == "cpu":
        return hada_weight_plain(w1d, w1u, w2d, w2u, scale)
    if w1u.device.type != "cuda":
        raise RuntimeError(f"hada_weight: no kernel for device {w1u.device}")
    _build.check_cuda_inputs("hada_weight", w1d, w1u, w2d, w2u)
    o, r = w1u.shape
    i = w1d.shape[1]
    if w1d.shape != (r, i) or w2d.shape != (r, i) or w2u.shape != (o, r):
        raise ValueError(
            f"hada_weight: shapes {tuple(w1d.shape)} {tuple(w1u.shape)} "
            f"{tuple(w2d.shape)} {tuple(w2u.shape)}"
        )
    w1d, w1u, w2d, w2u = (t.contiguous() for t in (w1d, w1u, w2d, w2u))
    out = torch.empty((o, i), dtype=w1u.dtype, device=w1u.device)
    lib = _build.lib()
    rc = lib.lyc_hada_fwd(
        w1d.data_ptr(), w1u.data_ptr(), w2d.data_ptr(), w2u.data_ptr(), out.data_ptr(),
        o, i, r, float(scale), _build.dtype_code(w1u), _build.stream_ptr(w1u),
    )
    _build.check(rc, "lyc_hada_fwd")
    launches += 1
    return out
