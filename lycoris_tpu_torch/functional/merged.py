"""Dense-dW-free backward for the merged forward (counterpart of
``lycoris_tpu/functional/merged.py``).

The merged forward runs each adapted layer once with ``W_eff = W + dW(theta)``.
Plain autograd through it forms a dense ``x^T dy`` weight gradient for every
adapted layer, whose only consumer is the small chain into the adapter
factors. For multilinear low-rank dW (LoRA up/down, LoKr kron factors) the
same cotangents have an exact reordering that never forms it, e.g.
``d_up = dy^T (x down^T)``. :func:`factored_merged_apply` wraps the layer in
an autograd Function whose backward takes dx through the layer's own input
gradient and the adapter gradients through a per-algorithm ``dtheta_fn``;
the frozen base weight and bias get none.

Left out, because they compute the same cotangents: the JAX package's
``packed``/``hybrid`` LoKr branches, the batched dW1 form and the
absolute-FLOPs gate of :func:`worth_factoring` (TPU tuning). The
contractions are plain ``torch.einsum``, as the JAX package leaves them to
XLA outside any kernel.
"""

from __future__ import annotations

import torch

from ..observability import span

applications = 0  # factored layer applications since the last reset (chip_smoke counts these)


def _e(spec, *ops):
    """einsum in fp32, or in bf16 when any operand is bf16: the small fp32
    factors are cast down rather than the large activation up (the JAX
    package's rule). cuBLAS accumulates bf16 products in fp32; the result is
    returned as fp32."""
    if any(o.dtype == torch.bfloat16 for o in ops):
        ops = [o.to(torch.bfloat16) for o in ops]
    return torch.einsum(spec, *ops).float()


# the harmonic-dimension threshold the wrapper passes to worth_factoring: the
# JAX package's default, tuned on a TPU and not yet measured on the H100
FACTORED_MIN = 1024


def worth_factoring(out_dim: int, in_dim: int, threshold: int = FACTORED_MIN) -> bool:
    """Factor a layer whose harmonic dimension out*in/(out+in) reaches
    ``threshold``: the factored backward trades the dense dW matmul for a few
    more passes over x and dy, and both scale with the token count."""
    return (out_dim * in_dim) // (out_dim + in_dim) >= threshold


def _merge(recon_fn, theta, w):
    """W + dW in ``w``'s dtype: ``recon_fn.merge(theta, w)`` where the
    recon carries one (LoKr's one pass, ``ops.kron.merge``), else
    ``w + recon_fn(theta, w.dtype)``."""
    merge = getattr(recon_fn, "merge", None)
    if merge is not None:
        return merge(theta, w)
    return w + recon_fn(theta, w.dtype)


class _FactoredMerged(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, fns, keys, *thetas):
        recon_fn, dtheta_fn, apply_fn, dx_fn, dy2d_fn = fns
        theta = dict(zip(keys, thetas))
        ctx.save_for_backward(x, w, *thetas)
        ctx.fns, ctx.keys = fns, keys
        with span("lycoris.merge"):
            w_eff = _merge(recon_fn, theta, w)
        return apply_fn(x, w_eff, b)

    @staticmethod
    def backward(ctx, g):
        recon_fn, dtheta_fn, apply_fn, dx_fn, dy2d_fn = ctx.fns
        x, w, *thetas = ctx.saved_tensors
        theta = dict(zip(ctx.keys, thetas))
        # dW is recomputed here instead of cached: one small rebuild and a
        # W-sized add against a W-sized residual kept alive until backward
        dx = None
        if ctx.needs_input_grad[0]:
            with span("lycoris.merge"):
                w_eff = _merge(recon_fn, theta, w)
            dx = dx_fn(g, w_eff)
        dtheta = dtheta_fn(x.reshape(-1, x.shape[-1]), dy2d_fn(g), theta)
        grads = [
            dtheta[k].to(t.dtype) if need and k in dtheta else None
            for k, t, need in zip(ctx.keys, thetas, ctx.needs_input_grad[5:])
        ]
        return (dx, None, None, None, None, *grads)


def factored_merged_apply(x, w, b, theta: dict, *, recon_fn, dtheta_fn, apply_fn, dx_fn,
                          dy2d_fn):
    """``apply_fn(x, w + recon_fn(theta), b)`` with a factored backward.

    - ``recon_fn(theta, out_dtype) -> dW`` in ``out_dtype``; where it has a
      ``merge`` attribute, ``recon_fn.merge(theta, w) -> W + dW`` in ``w``'s
      dtype forms the merged weight of the forward and the backward's
      recompute (LoKr's one pass, ``ops.kron.merge``);
    - ``dtheta_fn(x2d, dy2d, theta) -> {key: d_key}``, the exact reordering
      of ``VJP(recon)(x^T dy)`` that never forms the dense product;
    - ``apply_fn(x, w_eff, b) -> y``, linear in x and in w_eff;
    - ``dx_fn(g, w_eff) -> dx`` and ``dy2d_fn(g) -> (N, out)``.

    ``x`` is torch layout ``(..., in)``. ``w`` and ``b`` get no gradient
    (the base is frozen)."""
    global applications
    applications += 1
    keys = tuple(theta)
    fns = (recon_fn, dtheta_fn, apply_fn, dx_fn, dy2d_fn)
    return _FactoredMerged.apply(x, w, b, fns, keys, *theta.values())


# ---------------------------------------------------------------------------
# per-algorithm factored cotangents (raw: the caller applies the
# alpha/r * multiplier scale and maps them onto its parameters)
# ---------------------------------------------------------------------------


def lora_dtheta(x2d, dy2d, up, down, want_scalar=False):
    """Cotangents of dW = up @ down, up (out, r), down (r, in): two (N, r)
    intermediates instead of one (out, in) product. ``d_scalar`` (when
    asked) is the raw inner product <dY, X dW^T> = sum (dy up) * (x down^T)."""
    u = _e("ni,ri->nr", x2d, down)
    z = _e("no,or->nr", dy2d, up)
    d_up = _e("no,nr->or", dy2d, u)
    d_down = _e("nr,ni->ri", z, x2d)
    d_scalar = (z * u).sum() if want_scalar else None
    return d_up, d_down, d_scalar


def lokr_dtheta(x2d, dy2d, w1_full, w2_full, w2_ab=None, want_scalar=False):
    """Cotangents of dW = kron(W1, W2): W1 (p, q), W2 (u, v), out = p*u,
    in = q*v. Returns ``(dW1, dW2, d_scalar)`` in the factor shapes. With
    ``w2_ab=(A, B)``, W2 = A B, every contraction goes through the rank-r
    intermediates s = x B^T (N, q, r) and t = dy A (N, p, r), and dW2 comes
    back as ``(dA, dB)``. With W2 full the order pivots on the smaller of
    the two sides, so the one large intermediate is min(N q u, N p v)."""
    p, q = w1_full.shape
    if w2_ab is not None:
        u, v = w2_ab[0].shape[0], w2_ab[1].shape[1]
    else:
        u, v = w2_full.shape
    n = x2d.shape[0]
    x3 = x2d.reshape(n, q, v)
    dy3 = dy2d.reshape(n, p, u)

    if w2_ab is not None:
        a_f, b_f = w2_ab  # A (u, r), B (r, v)
        s = _e("nqv,rv->nqr", x3, b_f)
        t = _e("npu,ur->npr", dy3, a_f)
        dW1 = _e("npr,nqr->pq", t, s)
        qs = _e("pq,nqr->npr", w1_full, s)
        dA = _e("npu,npr->ur", dy3, qs)
        m = _e("pq,npr->nqr", w1_full, t)
        dB = _e("nqr,nqv->rv", m, x3)
        d_scalar = (t * qs).sum() if want_scalar else None
        return dW1, (dA, dB), d_scalar

    if v <= u:  # pivot on the in side: (n, p, v) intermediates
        P = _e("npu,uv->npv", dy3, w2_full)
        dW1 = _e("npv,nqv->pq", P, x3)
        Q = _e("pq,nqv->npv", w1_full, x3)
        dW2 = _e("npu,npv->uv", dy3, Q)
        d_scalar = (P * Q).sum() if want_scalar else None
    else:  # pivot on the out side: (n, q, u) intermediates
        U = _e("nqv,uv->nqu", x3, w2_full)
        dW1 = _e("npu,nqu->pq", dy3, U)
        R = _e("pq,npu->nqu", w1_full, dy3)
        dW2 = _e("nqu,nqv->uv", R, x3)
        d_scalar = (U * R).sum() if want_scalar else None
    return dW1, dW2, d_scalar
