"""The GEGLU gate product ``h * gelu(gate)`` and its backward: the CUDA
kernel ``csrc/geglu_bwd.cu``.

Counterpart of ``lycoris_tpu/ops/geglu.py`` (``geglu_bwd_dt``) and of the
``_geglu_mul_cvjp`` custom vjp (``lycoris_tpu/functional/general.py``). The
forward is plain torch, as the JAX forward is plain XLA; the backward writes
d_hfull = [dy * gelu(gate) | dy * h * gelu'(gate)] into one (..., 2F) buffer,
with gelu the tanh approximation and gelu' its derivative (what
``jax.jvp(jax.nn.gelu)`` gives). Not carried over: the TPU gate
``T % 512 == 0 and F % 256 == 0`` and the D-major transpose; on the card
every shape runs the kernel.

:func:`geglu_mul` is a :class:`GegluFunction`: it saves ``h_full`` only and
its backward takes the plain version (:func:`geglu_bwd_plain`) for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build

bwd_launches = 0  # backward kernel launches since the last reset (chip_smoke counts these)

_K0 = math.sqrt(2.0 / math.pi)
_K1 = 0.044715


def geglu_fwd_plain(h_full):
    """``h * gelu(gate)`` with ``h, gate = h_full.chunk(2, dim=-1)``, in h_full's dtype."""
    h, gate = h_full.chunk(2, dim=-1)
    return h * F.gelu(gate, approximate="tanh")


def geglu_bwd_plain(h_full, dy):
    """d_hfull (h_full's shape and dtype): gelu and gelu' in fp32, each half
    rounded once.

    The tanh form through sigmoids: with u = K0 (z + K1 z^3) and s =
    sigmoid(2u), 0.5 (1 + tanh u) = s and 1 - tanh^2 u = 4 s sigmoid(-2u),
    so gelu = z s and gelu' = s + 2 z s sigmoid(-2u) K0 (1 + 3 K1 z^2).
    ``torch.tanh`` is not used: on torch 2.13's CPU build its first
    vectorised call in a process, over 8 threads, was seen to get one
    thread's rows wrong by about 1e-4 relative, which gelu' amplifies.
    sigmoid(-2u) stands for 1 - s, which cancels where s is near 1."""
    h, gate = h_full.float().chunk(2, dim=-1)
    d = dy.float()
    u2 = (2.0 * _K0) * (gate + _K1 * gate * gate * gate)
    s, s_neg = torch.sigmoid(u2), torch.sigmoid(-u2)
    gelu = gate * s
    dgelu = s + 2.0 * gate * s * s_neg * _K0 * (1.0 + 3.0 * _K1 * gate * gate)
    return torch.cat([d * gelu, d * h * dgelu], dim=-1).to(h_full.dtype)


def geglu_bwd(h_full, dy):
    """The backward kernel on CUDA tensors: d_hfull, a new (..., 2F) tensor."""
    global bwd_launches
    if h_full.device.type != "cuda":
        raise RuntimeError(f"geglu_bwd: no kernel for device {h_full.device}")
    _build.check_cuda_inputs("geglu_bwd", h_full, dy)
    f2 = h_full.shape[-1]
    if f2 % 2 or dy.shape != (*h_full.shape[:-1], f2 // 2):
        raise ValueError(f"geglu_bwd: h_full {tuple(h_full.shape)} dy {tuple(dy.shape)}")
    h_full, dy = h_full.contiguous(), dy.contiguous()
    out = torch.empty_like(h_full)
    f = f2 // 2
    vec = 16 // h_full.element_size()
    if f % vec or any(t.data_ptr() % 16 for t in (h_full, dy, out)):
        vec = 1
    rc = _build.lib().lyc_geglu_bwd(
        h_full.data_ptr(), dy.data_ptr(), out.data_ptr(), h_full.numel() // f2, f, vec,
        _build.dtype_code(h_full), _build.stream_ptr(h_full),
    )
    _build.check(rc, "lyc_geglu_bwd")
    bwd_launches += 1
    return out


class GegluFunction(torch.autograd.Function):
    """``h * gelu(gate)`` whose backward is the ``geglu_bwd`` kernel on the
    card (the plain backward on the CPU). Saves ``h_full`` only."""

    @staticmethod
    def forward(ctx, h_full):
        ctx.save_for_backward(h_full)
        return geglu_fwd_plain(h_full)

    @staticmethod
    def backward(ctx, dy):
        (h_full,) = ctx.saved_tensors
        if h_full.device.type == "cpu":
            return geglu_bwd_plain(h_full, dy)
        return geglu_bwd(h_full, dy)


def geglu_mul(h_full):
    """GEGLU gate product of ``h_full`` (..., 2F) -> (..., F), differentiable."""
    return GegluFunction.apply(h_full)
