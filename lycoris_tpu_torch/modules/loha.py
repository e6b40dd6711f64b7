"""LoHa adapter module (counterpart of ``lycoris_tpu/modules/loha.py``).

Keys ``hada_w1_a/b, hada_w2_a/b, hada_t1/t2, alpha``; non-tucker factors
``w1_a (O, r)`` / ``w1_b (r, I*prod(k))``. dW = (alpha / r) *
(w1a @ w1b) * (w2a @ w2b) * scalar, formed by the LoHa kernel
(``functional/loha.py`` -> ``ops/hada.py``). In training, rank dropout
masks the out-dim rows of dW (in either mode) and plain dropout applies to
the bypass output only (JAX loha.py:206-211, 264-265); module dropout as in
``modules/base.py``. DoRA (``weight_decompose``) and max-norm (through
``scalar``) as in ``modules/base.py``.
"""

from __future__ import annotations

import math

import torch

from ..functional import loha as F_loha
from .base import LayerInfo, LycorisBaseModule, as_float, infer_wd_on_out, to_tensor


class LohaModule(LycorisBaseModule):
    name = "loha"
    support_module = frozenset({"linear", "conv1d", "conv2d", "conv3d"})
    weight_list = ["hada_w1_a", "hada_w1_b", "hada_w2_a", "hada_w2_b", "hada_t1", "hada_t2",
                   "alpha", "dora_scale"]
    weight_list_det = ["hada_w1_a"]

    def __init__(self, lora_name, layer: LayerInfo, multiplier=1.0, lora_dim=4, alpha=1,
                 dropout=0.0, rank_dropout=0.0, module_dropout=0.0, use_tucker=False,
                 use_scalar=False, rank_dropout_scale=False, weight_decompose=False,
                 wd_on_out=True, bypass_mode=None, rs_lora=False, generator=None,
                 device=None, dtype=torch.float32, org_weight=None, **kwargs):
        super().__init__(lora_name, layer, multiplier, dropout, rank_dropout, module_dropout,
                         rank_dropout_scale, bypass_mode)
        if self.not_supported:
            raise ValueError(f"{self.module_type} is not supported in LoHa algo.")
        self.lora_dim = lora_dim
        self.rs_lora = rs_lora
        self.use_scalar = use_scalar

        out_dim, in_dim, *k_size = self.shape
        self.tucker = self.layer.is_conv and use_tucker and any(i != 1 for i in k_size)
        if self.layer.is_conv and not self.tucker:
            w_shape = (out_dim, in_dim * math.prod(k_size))
        else:
            w_shape = (out_dim, in_dim)

        def normal(shape, std):
            return torch.randn(shape, dtype=dtype, device=device, generator=generator) * std

        def zeros(shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.trainable |= {"hada_w1_a", "hada_w1_b", "hada_w2_a", "hada_w2_b"}
        if self.tucker:
            self.trainable |= {"hada_t1", "hada_t2"}
            self._set("hada_t1", normal((lora_dim, lora_dim, *k_size), 0.1))
            self._set("hada_t2", normal((lora_dim, lora_dim, *k_size), 0.1))
            self._set("hada_w1_a", normal((lora_dim, w_shape[0]), 0.1))
            self._set("hada_w1_b", normal((lora_dim, w_shape[1]), 1.0))
            self._set("hada_w2_a", normal((lora_dim, w_shape[0]), 0.1) if use_scalar
                      else zeros((lora_dim, w_shape[0])))
            self._set("hada_w2_b", normal((lora_dim, w_shape[1]), 1.0))
        else:
            self._set("hada_w1_a", normal((w_shape[0], lora_dim), 0.1))
            self._set("hada_w1_b", normal((lora_dim, w_shape[1]), 1.0))
            self._set("hada_w2_a", normal((w_shape[0], lora_dim), 0.1) if use_scalar
                      else zeros((w_shape[0], lora_dim)))
            self._set("hada_w2_b", normal((lora_dim, w_shape[1]), 1.0))
        self._init_dora(weight_decompose, wd_on_out, org_weight, device)

        alpha = as_float(alpha)
        alpha = lora_dim if alpha == 0.0 else alpha
        r_factor = math.sqrt(lora_dim) if rs_lora else lora_dim
        self.scale = alpha / r_factor
        self._set("alpha", torch.tensor(alpha * (lora_dim / r_factor), dtype=torch.float32,
                                        device=device), trainable=False)
        if use_scalar:
            self.trainable.add("scalar")
        self._set("scalar", torch.tensor(0.0 if use_scalar else 1.0, dtype=dtype, device=device))

    @classmethod
    def make_module_from_state_dict(cls, lora_name, layer, w1a, w1b, w2a, w2b, t1, t2, alpha,
                                    dora_scale):
        module = cls(lora_name, layer, 1, w1b.shape[0], alpha, use_tucker=t1 is not None,
                     weight_decompose=dora_scale is not None,
                     wd_on_out=infer_wd_on_out(dora_scale, layer.shape[0]))
        for key, val in [("hada_w1_a", w1a), ("hada_w1_b", w1b), ("hada_w2_a", w2a),
                         ("hada_w2_b", w2b), ("hada_t1", t1), ("hada_t2", t2),
                         ("dora_scale", dora_scale)]:
            if val is not None:
                module._set(key, to_tensor(val).clone())
        return module

    # -- weight reconstruction ------------------------------------------------
    def get_weight(self, train=False, seed=None):
        t1 = self._p("hada_t1") if self.tucker else None
        t2 = self._p("hada_t2") if self.tucker else None
        # make_weight's order is (w1d, w1u, w2d, w2u): the b factors are "down"
        weight = F_loha.diff_weight(
            self._p("hada_w1_b"), self._p("hada_w1_a"),
            self._p("hada_w2_b"), self._p("hada_w2_a"),
            t1, t2, gamma=self.scale,
        )
        return self._rank_masked(weight.reshape(self.shape), train, seed)

    def custom_state_dict(self):
        src = self.params
        dest = {
            "alpha": src["alpha"],
            "hada_w1_a": src["hada_w1_a"] * src["scalar"],
            "hada_w1_b": src["hada_w1_b"],
            "hada_w2_a": src["hada_w2_a"],
            "hada_w2_b": src["hada_w2_b"],
        }
        if self.tucker:
            dest["hada_t1"] = src["hada_t1"]
            dest["hada_t2"] = src["hada_t2"]
        if self.wd:
            dest["dora_scale"] = src["dora_scale"]
        return {k: v.detach() for k, v in dest.items()}

    def apply_max_norm(self, max_norm):
        """Max-norm through ``scalar`` (JAX loha.py:250-258); on the card
        dW comes from the LoHa forward kernel."""
        return self._max_norm_on_scalar(max_norm)

    def bypass_forward_diff(self, x, scale=1.0, train=False, seed=None, shard=(0, 1)):
        diff_weight = self.get_weight(train, seed) * self._p("scalar") * scale
        return self._dropped(self.op(x, diff_weight.to(x.dtype)), train, seed, shard)
