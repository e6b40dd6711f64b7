"""LoKr (Kronecker) adapter module (counterpart of ``lycoris_tpu/modules/lokr.py``).

Same keys, factorization branches, init table and checkpoint shape
re-inference as the JAX module (reference lokr.py:31-342). dW is
(alpha / r) * (w1 kron w2) * scalar; the bypass path is the grouped-matmul
Kronecker product scaled the same way (the JAX package's documented
deviations from the reference). In training, rank dropout masks the
out-dim rows of dW (in either mode) and plain dropout applies to the bypass
output only: the merged forward ignores it, as the JAX module does (JAX
lokr.py:307-312, 446-447); module dropout as in ``modules/base.py``. DoRA
(``weight_decompose``) as in ``modules/base.py``; a DoRA layer takes no
factored backward. Max-norm scales every factor by ratio ** (1 / factors).

The one LoKr merge: where no autograd graph runs through W + dW (grad off,
or neither W nor any factor wants a gradient; the factored forward and its
recompute, through ``recon_fn.merge``) on a linear or 1x1 layer without DoRA
or tucker, the merge is ``ops.kron.merge`` with scale * scalar * multiplier
folded into w1 once: the one-pass kernel on the card, its plain version
elsewhere. Every other merge is the base class's autograd ops.
"""

from __future__ import annotations

import math

import torch

from ..functional.general import factorization, kaiming_uniform, rebuild_tucker
from ..functional.lokr import bypass_diff_with_scale, make_kron
from ..functional.merged import lokr_dtheta
from ..ops import kron
from .base import (LayerInfo, LycorisBaseModule, as_float, infer_wd_on_out, max_norm_ratio,
                   to_tensor)


class LokrModule(LycorisBaseModule):
    name = "kron"
    support_module = frozenset({"linear", "conv1d", "conv2d", "conv3d"})
    weight_list = [
        "lokr_w1", "lokr_w1_a", "lokr_w1_b", "lokr_w2", "lokr_w2_a", "lokr_w2_b",
        "lokr_t1", "lokr_t2", "alpha", "dora_scale",
    ]
    weight_list_det = ["lokr_w1", "lokr_w1_a"]

    def __init__(self, lora_name, layer: LayerInfo, multiplier=1.0, lora_dim=4, alpha=1,
                 dropout=0.0, rank_dropout=0.0, module_dropout=0.0, use_tucker=False,
                 use_scalar=False, decompose_both=False, factor: int = -1,
                 rank_dropout_scale=False, weight_decompose=False, wd_on_out=True,
                 full_matrix=False, bypass_mode=None, rs_lora=False,
                 unbalanced_factorization=False, generator=None, device=None,
                 dtype=torch.float32, org_weight=None, **kwargs):
        super().__init__(lora_name, layer, multiplier, dropout, rank_dropout, module_dropout,
                         rank_dropout_scale, bypass_mode)
        if self.not_supported:
            raise ValueError(f"{self.module_type} is not supported in LoKr algo.")

        factor = int(factor)
        self.lora_dim = lora_dim
        self.tucker = False
        self.use_w1 = False
        self.use_w2 = False
        self.full_matrix = full_matrix
        self.rs_lora = rs_lora
        self.use_scalar = use_scalar

        out_dim, in_dim, *k_size = self.shape
        in_m, in_n = factorization(in_dim, factor)
        out_l, out_k = factorization(out_dim, factor)
        if unbalanced_factorization:
            out_l, out_k = out_k, out_l
        shape = ((out_l, out_k), (in_m, in_n))
        self.kron_shape = shape

        if self.layer.is_conv:
            self.tucker = use_tucker and any(i != 1 for i in k_size)
            if decompose_both and lora_dim < max(shape[0][0], shape[1][0]) / 2 and not full_matrix:
                w1a_shape, w1b_shape = (shape[0][0], lora_dim), (lora_dim, shape[1][0])
            else:
                self.use_w1 = True
                w1_shape = (shape[0][0], shape[1][0])
            if lora_dim >= max(shape[0][1], shape[1][1]) / 2 or full_matrix:
                self.use_w2 = True
                w2_shape = (shape[0][1], shape[1][1], *k_size)
            elif self.tucker:
                t2_shape = (lora_dim, lora_dim, *k_size)
                w2a_shape = (lora_dim, shape[0][1])
                w2b_shape = (lora_dim, shape[1][1])
            else:
                w2a_shape = (shape[0][1], lora_dim)
                w2b_shape = (lora_dim, shape[1][1] * math.prod(k_size))
        else:
            if decompose_both and lora_dim < max(shape[0][0], shape[1][0]) / 2 and not full_matrix:
                w1a_shape, w1b_shape = (shape[0][0], lora_dim), (lora_dim, shape[1][0])
            else:
                self.use_w1 = True
                w1_shape = (shape[0][0], shape[1][0])
            if lora_dim < max(shape[0][1], shape[1][1]) / 2 and not full_matrix:
                w2a_shape = (shape[0][1], lora_dim)
                w2b_shape = (lora_dim, shape[1][1])
            else:
                self.use_w2 = True
                w2_shape = (shape[0][1], shape[1][1])

        kw = dict(dtype=dtype, generator=generator, device=device)
        zeros = lambda s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
        for k in ("lokr_w1", "lokr_w1_a", "lokr_w1_b", "lokr_w2", "lokr_w2_a", "lokr_w2_b",
                  "lokr_t2"):
            self.trainable.add(k)
        if self.use_w2:
            self._set("lokr_w2", kaiming_uniform(w2_shape, **kw) if use_scalar else zeros(w2_shape))
        else:
            if self.tucker:
                self._set("lokr_t2", kaiming_uniform(t2_shape, **kw))
            self._set("lokr_w2_a", kaiming_uniform(w2a_shape, **kw))
            self._set("lokr_w2_b", kaiming_uniform(w2b_shape, **kw) if use_scalar else zeros(w2b_shape))
        if self.use_w1:
            self._set("lokr_w1", kaiming_uniform(w1_shape, **kw))
        else:
            self._set("lokr_w1_a", kaiming_uniform(w1a_shape, **kw))
            self._set("lokr_w1_b", kaiming_uniform(w1b_shape, **kw))
        self.trainable = {k for k in self.trainable if self._p(k) is not None}
        self._init_dora(weight_decompose, wd_on_out, org_weight, device)

        alpha = as_float(alpha)
        alpha = lora_dim if alpha == 0.0 else alpha
        if self.use_w1 and self.use_w2:
            alpha = lora_dim  # scale = 1 (reference lokr.py:209-211)
        r_factor = math.sqrt(lora_dim) if rs_lora else lora_dim
        self.scale = alpha / r_factor
        self._set("alpha", torch.tensor(alpha * (lora_dim / r_factor), dtype=torch.float32,
                                        device=device), trainable=False)
        if use_scalar:
            self.trainable.add("scalar")
        self._set("scalar", torch.tensor(0.0 if use_scalar else 1.0, dtype=dtype, device=device))

    # -- checkpoint re-inference (reference lokr.py:246-342) -------------------
    @classmethod
    def make_module_from_state_dict(cls, lora_name, layer, w1, w1a, w1b, w2, w2a, w2b, _t1,
                                    t2, alpha, dora_scale):
        full_matrix = False
        tucker = t2 is not None
        if w1a is not None:
            lora_dim = w1a.shape[1]
        elif w2a is not None:
            lora_dim = w2a.shape[0] if tucker else w2a.shape[1]
        else:
            full_matrix = True
            lora_dim = 1

        if w1 is None:
            out_dim, in_dim = w1a.shape[0], w1b.shape[1]
        else:
            out_dim, in_dim = w1.shape
        shape_s = [out_dim, in_dim]
        if w2 is None:
            out_dim *= w2a.shape[1] if tucker else w2a.shape[0]
            in_dim *= w2b.shape[1]
        else:
            out_dim *= w2.shape[0]
            in_dim *= w2.shape[1]

        if shape_s[0] == factorization(out_dim, -1)[0] and shape_s[1] == factorization(in_dim, -1)[0]:
            factor = -1
        else:
            w1_shape = tuple(w1.shape) if w1 is not None else (w1a.shape[0], w1b.shape[1])
            if w2 is not None:
                w2_shape = tuple(w2.shape[:2])
            elif tucker:
                w2_shape = (w2a.shape[1], w2b.shape[1])
            else:
                w2_shape = (w2a.shape[0], w2b.shape[1])
            shape_group_1 = (w1_shape[0], w2_shape[0])
            shape_group_2 = (w1_shape[1], w2_shape[1])
            w_shape = (w1_shape[0] * w2_shape[0], w1_shape[1] * w2_shape[1])
            factor1 = max(w1_shape) if w1 is not None else max(w1a.shape[0], w1b.shape[1])
            factor2 = max(w2_shape)
            if (w_shape[0] % factor1 == 0 and w_shape[1] % factor1 == 0
                    and factor1 in shape_group_1 and factor1 in shape_group_2):
                factor = factor1
            elif (w_shape[0] % factor2 == 0 and w_shape[1] % factor2 == 0
                    and factor2 in shape_group_1 and factor2 in shape_group_2):
                factor = factor2
            else:
                factor = min(factor1, factor2)

        module = cls(lora_name, layer, 1, lora_dim, alpha, use_tucker=t2 is not None,
                     decompose_both=w1 is None and w2 is None, factor=factor,
                     weight_decompose=dora_scale is not None,
                     wd_on_out=infer_wd_on_out(dora_scale, layer.shape[0]),
                     full_matrix=full_matrix)
        for key, val in [("lokr_w1", w1), ("lokr_w1_a", w1a), ("lokr_w1_b", w1b),
                         ("lokr_w2", w2), ("lokr_w2_a", w2a), ("lokr_w2_b", w2b),
                         ("lokr_t2", t2), ("dora_scale", dora_scale)]:
            if val is not None:
                v = to_tensor(val)
                cur = module._p(key)
                if cur is not None and tuple(cur.shape) != tuple(v.shape):
                    v = v.reshape(cur.shape)
                module._set(key, v.clone())
        return module

    # -- weight reconstruction ------------------------------------------------
    def _rebuild_w1(self):
        if self.use_w1:
            return self._p("lokr_w1")
        return self._p("lokr_w1_a") @ self._p("lokr_w1_b")

    def _rebuild_w2(self):
        if self.use_w2:
            return self._p("lokr_w2")
        a, b = self._p("lokr_w2_a"), self._p("lokr_w2_b")
        if self.tucker:
            return rebuild_tucker(self._p("lokr_t2"), a, b)
        return a @ b

    def get_weight(self, train=False, seed=None):
        weight = make_kron(self._rebuild_w1(), self._rebuild_w2(), self.scale).reshape(self.shape)
        return self._rank_masked(weight, train, seed)

    def _one_pass(self, org_weight) -> bool:
        """Whether W + dW is the one-pass ``ops.kron.merge``: no DoRA, no
        tucker, a linear or 1x1 layer, and no autograd graph to run through
        the merge (grad off, or neither W nor a factor wants a gradient)."""
        if self.wd or self.tucker or any(k != 1 for k in self.shape[2:]):
            return False
        return not (torch.is_grad_enabled() and (
            org_weight.requires_grad or any(p.requires_grad for p in self.parameters())))

    def get_merged_weight(self, org_weight, org_bias=None, multiplier=1.0, out_dtype=None):
        """W + dW * multiplier (DoRA: the rescale of W + dW) in ``out_dtype``.
        Where :meth:`_one_pass` allows, ``ops.kron.merge`` with scale *
        scalar * multiplier folded into w1, rounded once into ``out_dtype``
        (default: W's dtype, so a bf16 layer's merge is the one-pass
        kernel); else the base class's autograd ops (default: the dtype
        W + dW promotes to), then the cast."""
        if not self._one_pass(org_weight):
            w, b = super().get_merged_weight(org_weight, org_bias, multiplier)
            return (w if out_dtype is None else w.to(out_dtype)), b
        w2 = self._rebuild_w2()
        if w2.ndim > 2:
            w2 = w2.reshape(w2.shape[0], -1)
        return kron.merge(org_weight, self._rebuild_w1(), w2, self._p("scalar"),
                          self.scale * multiplier,
                          org_weight.dtype if out_dtype is None else out_dtype), org_bias

    def factored_merged_fns(self, multiplier):
        """(recon_fn, dtheta_fn) for the dense-dW-free merged backward
        (functional/merged.py), or None where this configuration needs plain
        autograd (conv kernels, tucker, DoRA, rank dropout). ``theta`` is the
        module's tensors by key (:attr:`params`)."""
        if self.layer.is_conv or self.tucker or self.wd or self.rank_dropout:
            return None
        k = self.scale * multiplier

        def w1_of(theta):
            if self.use_w1:
                return theta["lokr_w1"]
            return theta["lokr_w1_a"] @ theta["lokr_w1_b"]

        def w2_of(theta):
            if self.use_w2:
                return theta["lokr_w2"]
            return theta["lokr_w2_a"] @ theta["lokr_w2_b"]

        def recon_fn(theta, out_dtype=None):
            # scale * scalar * multiplier folded into the small w1 factor, as
            # in get_merged_weight
            return make_kron(w1_of(theta) * (theta["scalar"] * k), w2_of(theta),
                             out_dtype=out_dtype)

        # W + dW in W's dtype in one pass, for the factored forward and its
        # recompute (functional/merged.py)
        recon_fn.merge = lambda theta, w: kron.merge(w, w1_of(theta), w2_of(theta),
                                                     theta["scalar"], k, w.dtype)

        want_scalar = "scalar" in self.trainable

        def dtheta_fn(x2d, dy2d, theta):
            if self.use_w2:
                w2f, w2ab = theta["lokr_w2"], None
            else:
                w2f, w2ab = None, (theta["lokr_w2_a"], theta["lokr_w2_b"])
            dW1, dW2, d_s = lokr_dtheta(x2d, dy2d, w1_of(theta), w2f, w2_ab=w2ab,
                                        want_scalar=want_scalar)
            cc = self.scale * multiplier * theta["scalar"]
            grads = {}
            if self.use_w1:
                grads["lokr_w1"] = dW1 * cc
            else:
                d = dW1 * cc
                grads["lokr_w1_a"] = d @ theta["lokr_w1_b"].to(d.dtype).T
                grads["lokr_w1_b"] = theta["lokr_w1_a"].to(d.dtype).T @ d
            if self.use_w2:
                grads["lokr_w2"] = dW2 * cc
            else:
                grads["lokr_w2_a"], grads["lokr_w2_b"] = dW2[0] * cc, dW2[1] * cc
            if want_scalar:
                grads["scalar"] = d_s * (self.scale * multiplier)
            return grads

        return recon_fn, dtheta_fn

    def custom_state_dict(self):
        src = self.params
        dest = {"alpha": src["alpha"]}
        if self.use_w1:
            dest["lokr_w1"] = src["lokr_w1"] * src["scalar"]
        else:
            dest["lokr_w1_a"] = src["lokr_w1_a"] * src["scalar"]
            dest["lokr_w1_b"] = src["lokr_w1_b"]
        if self.use_w2:
            dest["lokr_w2"] = src["lokr_w2"]
        else:
            dest["lokr_w2_a"] = src["lokr_w2_a"]
            dest["lokr_w2_b"] = src["lokr_w2_b"]
            if self.tucker:
                dest["lokr_t2"] = src["lokr_t2"]
        if self.wd:
            dest["dora_scale"] = src["dora_scale"]
        return {k: v.detach() for k, v in dest.items()}

    @torch.no_grad()
    def apply_max_norm(self, max_norm):
        """Max-norm on the norm of dW without ``scalar``: each factor scaled
        by ratio ** (1 / factors) (JAX lokr.py:354-366)."""
        orig = self.get_weight().norm()
        scaled, ratio = max_norm_ratio(orig, max_norm)
        n_factors = 4 - self.use_w1 - self.use_w2 + (not self.use_w2 and self.tucker)
        r = torch.where(scaled, ratio ** (1 / n_factors), 1.0)
        for k in ("lokr_w1", "lokr_w1_a", "lokr_w1_b", "lokr_w2", "lokr_w2_a", "lokr_w2_b",
                  "lokr_t2"):
            p = self._p(k)
            if p is not None:
                p.mul_(r.to(p.dtype))
        return self.params, scaled, orig * ratio

    # -- forward paths -----------------------------------------------------------
    def _functional_weights(self):
        w2b = self._p("lokr_w2_b")
        if w2b is not None and self.layer.is_conv and not self.tucker:
            w2b = w2b.reshape(w2b.shape[0], self.kron_shape[1][1], *self.shape[2:])
        return (self._p("lokr_w1"), self._p("lokr_w1_a"), self._p("lokr_w1_b"),
                self._p("lokr_w2"), self._p("lokr_w2_a"), w2b, self._p("lokr_t2"))

    def bypass_forward_diff(self, x, scale=1.0, train=False, seed=None, shard=(0, 1)):
        out = bypass_diff_with_scale(
            x, *self._functional_weights(), scale=self.scale * self._p("scalar") * scale,
            extra_args=self.layer.kw if self.layer.is_conv else {},
        )
        return self._dropped(out, train, seed, shard)
