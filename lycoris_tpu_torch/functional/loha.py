"""LoHa (Hadamard product of two low-rank factors) functional API
(counterpart of ``lycoris_tpu/functional/loha.py``).

dW = (w1u @ w1d) * (w2u @ w2d) * gamma. ``make_weight`` sends it to the
LoHa kernels (``ops/hada.py``) wherever the JAX package sends it to its
Pallas kernel (O >= 8, I >= 128). :func:`hada_weight` and
:func:`hada_weight_tucker` are the JAX package's ``custom_vjp``s (the
reference's ``HadaWeight``/``HadaWeightTucker``) as autograd Functions:
they save only the factors and recompute the partner product in backward.
"""

from __future__ import annotations

import torch


class HadaWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w1d, w1u, w2d, w2u, scale):
        ctx.save_for_backward(w1d, w1u, w2d, w2u)
        ctx.scale = scale
        return (w1u @ w1d) * (w2u @ w2d) * scale

    @staticmethod
    def backward(ctx, grad_out):
        w1d, w1u, w2d, w2u = ctx.saved_tensors
        grad_out = grad_out * ctx.scale
        temp = grad_out * (w2u @ w2d)
        grad_w1u = temp @ w1d.T
        grad_w1d = w1u.T @ temp
        temp = grad_out * (w1u @ w1d)
        grad_w2u = temp @ w2d.T
        grad_w2d = w2u.T @ temp
        return grad_w1d, grad_w1u, grad_w2d, grad_w2u, None


class HadaWeightTucker(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t1, w1d, w1u, t2, w2d, w2u, scale):
        ctx.save_for_backward(t1, w1d, w1u, t2, w2d, w2u)
        ctx.scale = scale
        rebuild1 = torch.einsum("ij...,jr,ip->pr...", t1, w1d, w1u)
        rebuild2 = torch.einsum("ij...,jr,ip->pr...", t2, w2d, w2u)
        return rebuild1 * rebuild2 * scale

    @staticmethod
    def backward(ctx, grad_out):
        t1, w1d, w1u, t2, w2d, w2u = ctx.saved_tensors
        grad_out = grad_out * ctx.scale

        temp = torch.einsum("ij...,jr->ir...", t2, w2d)
        rebuild = torch.einsum("ij...,ir->rj...", temp, w2u)
        grad_w = rebuild * grad_out
        grad_w1u = torch.einsum("rj...,ij...->ri", temp, grad_w)
        grad_temp = torch.einsum("ij...,ir->rj...", grad_w, w1u.T)
        grad_w1d = torch.einsum("ir...,ij...->rj", t1, grad_temp)
        grad_t1 = torch.einsum("ij...,jr->ir...", grad_temp, w1d.T)

        temp = torch.einsum("ij...,jr->ir...", t1, w1d)
        rebuild = torch.einsum("ij...,ir->rj...", temp, w1u)
        grad_w = rebuild * grad_out
        grad_w2u = torch.einsum("rj...,ij...->ri", temp, grad_w)
        grad_temp = torch.einsum("ij...,ir->rj...", grad_w, w2u.T)
        grad_w2d = torch.einsum("ir...,ij...->rj", t2, grad_temp)
        grad_t2 = torch.einsum("ij...,jr->ir...", grad_temp, w2d.T)
        return grad_t1, grad_w1d, grad_w1u, grad_t2, grad_w2d, grad_w2u, None


def hada_weight(w1d, w1u, w2d, w2u, scale=1.0):
    return HadaWeight.apply(w1d, w1u, w2d, w2u, scale)


def hada_weight_tucker(t1, w1d, w1u, t2, w2d, w2u, scale=1.0):
    return HadaWeightTucker.apply(t1, w1d, w1u, t2, w2d, w2u, scale)


def make_weight(w1d, w1u, w2d, w2u, scale):
    """Note the argument order: (w1d, w1u, w2d, w2u), which modules/loha.py
    fills from (hada_w1_b, hada_w1_a, hada_w2_b, hada_w2_a)."""
    from ..ops import hada

    if hada.supported(w1d, w1u):
        return hada.hada_weight(w1d, w1u, w2d, w2u, scale)
    return hada_weight(w1d, w1u, w2d, w2u, scale)


def weight_gen(org_weight_shape, rank: int, tucker: bool = True, dtype=torch.float32,
               generator=None, device=None):
    """(w1d, w1u, w2d, w2u, t1, t2) for a layer of torch weight shape
    ``(out, in, *k)`` (or a tensor of that shape), the JAX ``weight_gen``'s
    shapes and init (w1u zero; t1, t2 only for a tucker convolution)."""
    if hasattr(org_weight_shape, "shape"):
        org_weight_shape = org_weight_shape.shape
    out_dim, in_dim, *k = org_weight_shape

    def normal(shape, std):
        return torch.randn(shape, dtype=dtype, device=device, generator=generator) * std

    tucker = bool(k) and tucker
    up = (rank, out_dim) if tucker else (out_dim, rank)
    w1d = normal((rank, in_dim), 1.0)
    w1u = torch.zeros(up, dtype=dtype, device=device)
    w2d = normal((rank, in_dim), 1.0)
    w2u = normal(up, 0.1)
    if not tucker:
        return w1d, w1u, w2d, w2u, None, None
    return w1d, w1u, w2d, w2u, normal((rank, rank, *k), 0.1), normal((rank, rank, *k), 0.1)


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


def bypass_forward_diff(x, org_out, *weights, gamma=1.0, extra_args={}):
    """LoHa has no factored bypass: dW by :func:`diff_weight`, applied once
    (reference loha.py:150-165); ``org_out`` is unused."""
    from .general import op_by_ndim

    diff_w = diff_weight(*weights, gamma=gamma)
    return op_by_ndim(diff_w.ndim)(x.to(diff_w.dtype), diff_w, **extra_args)
