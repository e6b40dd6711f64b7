"""GLoRA adapter module (counterpart of ``lycoris_tpu/modules/glora.py``;
reference lycoris/modules/glora.py).

f(x) = W x + W A(x) + B(x) with low-rank pairs A = a1 a2 (in -> in, 1x1 for
convolutions) and B = b1 b2 (b2 with the layer's kernel). Keys ``a1.weight,
a2.weight, b1.weight, b2.weight, bm.weight, alpha``, detected by
``a1.weight``. No module has the tucker core ``bm``: the JAX package ANDs
``use_tucker`` with an all-1 kernel and then asks for a kernel that is not
1, so it never builds one, and a file with ``bm.weight`` is refused, as it
fails to load there. Merged dW =
(B + W A) * (alpha / r) * scalar * multiplier; the bypass is
``org_forward(x + A(x) s) + B(x) s`` with the scale s applied once (the
reference applies alpha / r twice and drops ``scalar``), so bypass equals
the rebuild. a1/b1 start from kaiming, a2/b2 from zero unless
``use_scalar`` (then a trainable ``scalar`` from 0). In training the bypass
masks A's and B's rank (JAX salts ``0x61``, ``0x62``) and drops elements of
their outputs (``0x64611``, ``0x64622``); the merged and delta routes take
module dropout only. No max-norm.
"""

from __future__ import annotations

import math

import torch

from ..functional.general import convnd, kaiming_uniform, linear
from .base import (LayerInfo, LycorisBaseModule, _need_org_forward, as_float, draw_generator,
                   dropout, rank_dropout_mask, to_tensor)

_SALTS = {"rank_a": 0x61, "rank_b": 0x62, "drop_a": 0x64611, "drop_b": 0x64622}


class GLoRAModule(LycorisBaseModule):
    name = "glora"
    support_module = frozenset({"linear", "conv1d", "conv2d", "conv3d"})
    weight_list = ["a1.weight", "a2.weight", "b1.weight", "b2.weight", "bm.weight", "alpha"]
    weight_list_det = ["a1.weight"]

    def __init__(self, lora_name, layer: LayerInfo, multiplier=1.0, lora_dim=4, alpha=1,
                 dropout=0.0, rank_dropout=0.0, module_dropout=0.0, use_scalar=False, rank_dropout_scale=False, bypass_mode=None, rs_lora=False,
                 generator=None, device=None, dtype=torch.float32, **kwargs):
        super().__init__(lora_name, layer, multiplier, dropout, rank_dropout, module_dropout,
                         rank_dropout_scale, bypass_mode)
        if self.not_supported:
            raise ValueError(f"{self.module_type} is not supported in GLoRA algo.")
        self.lora_dim = lora_dim
        self.rs_lora = rs_lora
        self.use_scalar = use_scalar

        out_dim, in_dim, *k_size = self.shape
        if self.layer.is_conv:
            ones = tuple(1 for _ in k_size)
            a2_shape, a1_shape = (lora_dim, in_dim, *ones), (in_dim, lora_dim, *ones)
            b2_shape, b1_shape = (lora_dim, in_dim, *k_size), (out_dim, lora_dim, *ones)
        else:
            a2_shape, a1_shape = (lora_dim, in_dim), (in_dim, lora_dim)
            b2_shape, b1_shape = (lora_dim, in_dim), (out_dim, lora_dim)

        kw = dict(dtype=dtype, generator=generator, device=device)
        self.trainable |= {"a1.weight", "a2.weight", "b1.weight", "b2.weight"}
        self._set("a1.weight", kaiming_uniform(a1_shape, **kw))
        self._set("b1.weight", kaiming_uniform(b1_shape, **kw))
        for key, shape in (("a2.weight", a2_shape), ("b2.weight", b2_shape)):
            self._set(key, kaiming_uniform(shape, **kw) if use_scalar
                      else torch.zeros(shape, dtype=dtype, device=device))

        alpha = as_float(alpha)
        alpha = lora_dim if alpha == 0.0 else alpha
        self.scale = alpha / (math.sqrt(lora_dim) if rs_lora else lora_dim)
        self._set("alpha", torch.tensor(alpha, dtype=torch.float32, device=device),
                  trainable=False)
        if use_scalar:
            self.trainable.add("scalar")
        self._set("scalar", torch.tensor(0.0 if use_scalar else 1.0, dtype=dtype, device=device))

    @classmethod
    def make_module_from_state_dict(cls, lora_name, layer, a1, a2, b1, b2, bm, alpha):
        if bm is not None:
            raise ValueError(f"{lora_name}: GLoRA with a tucker core (bm.weight) is not "
                             "supported")
        module = cls(lora_name, layer, 1, a2.shape[0], alpha)
        for key, val in (("a1.weight", a1), ("a2.weight", a2), ("b1.weight", b1),
                         ("b2.weight", b2)):
            module._set(key, to_tensor(val).reshape(module._p(key).shape).clone())
        return module

    def make_weight(self, org_weight):
        """(B + W A) * (alpha / r) * scalar in the layer's shape."""
        wa1, wa2 = self._p("a1.weight"), self._p("a2.weight")
        org_weight = org_weight.to(wa1.dtype)
        wa1 = wa1.reshape(wa1.shape[0], -1)
        wa2 = wa2.reshape(wa2.shape[0], -1)
        wb1, wb2 = self._p("b1.weight"), self._p("b2.weight")
        wb = (wb1.reshape(wb1.shape[0], -1) @ wb2.reshape(wb2.shape[0], -1)).reshape(
            org_weight.shape)
        if org_weight.ndim > 2:
            w_wa = torch.einsum("oi...,ij->oj...", org_weight, wa1)
            w_wa = torch.einsum("oi...,ij->oj...", w_wa, wa2)
        else:
            w_wa = org_weight @ wa1 @ wa2
        return (wb + w_wa) * self.scale * self._p("scalar")

    def get_diff_weight(self, multiplier=1.0, org_weight=None):
        return self.make_weight(org_weight) * multiplier, None

    def get_merged_weight(self, org_weight, org_bias=None, multiplier=1.0):
        return org_weight + self.get_diff_weight(multiplier, org_weight)[0], org_bias

    def custom_state_dict(self):
        src = self.params
        dest = {
            "alpha": src["alpha"],
            "a1.weight": src["a1.weight"],
            "a2.weight": src["a2.weight"] * src["scalar"],
            "b1.weight": src["b1.weight"],
            "b2.weight": src["b2.weight"] * src["scalar"],
        }
        return {k: v.detach() for k, v in dest.items()}

    def _plain_op(self, x, w):
        return convnd(x, w) if self.layer.is_conv else linear(x, w)

    def _down_op(self, x, w):
        """B's first op: the layer's stride and padding for a kernel that is not 1."""
        if not self.layer.is_conv:
            return linear(x, w)
        if all(i == 1 for i in w.shape[2:]):
            return convnd(x, w)
        kw = self.layer.kw
        return convnd(x, w, stride=kw.get("stride", 1), padding=kw.get("padding", 0))

    def _rank_dropped(self, mid, seed, salt):
        drop = rank_dropout_mask(draw_generator(seed, salt, mid.device), self.lora_dim,
                                 self.rank_dropout, self.rank_dropout_scale, mid.dtype,
                                 mid.device)
        if self.layer.is_conv:
            return mid * drop.reshape(1, -1, *[1] * (mid.ndim - 2))
        return mid * drop

    def _bypass(self, x, scale, org_forward, train=False, seed=None, diff=False):
        """``org_forward(x + A(x) s) + B(x) s`` with one scale s = alpha / r *
        scalar * ``scale``, in the activation dtype (with ``diff``,
        ``org_forward(A(x) s) + B(x) s``)."""
        s = self.scale * self._p("scalar") * scale
        ax_mid = self._plain_op(x, self._p("a2.weight").to(x.dtype))
        bx_mid = self._down_op(x, self._p("b2.weight").to(x.dtype))
        if self._draws(train, seed, self.rank_dropout):
            ax_mid = self._rank_dropped(ax_mid, seed, _SALTS["rank_a"])
            bx_mid = self._rank_dropped(bx_mid, seed, _SALTS["rank_b"])
        a_out = (self._plain_op(ax_mid, self._p("a1.weight").to(x.dtype)) * s).to(x.dtype)
        b_out = (self._plain_op(bx_mid, self._p("b1.weight").to(x.dtype)) * s).to(x.dtype)
        if self._draws(train, seed, self.dropout):
            a_out = dropout(draw_generator(seed, _SALTS["drop_a"], x.device), a_out, self.dropout)
            b_out = dropout(draw_generator(seed, _SALTS["drop_b"], x.device), b_out, self.dropout)
        return org_forward(a_out if diff else x + a_out) + b_out

    def bypass_forward_diff(self, x, scale=1.0, train=False, seed=None, org_forward=None):
        """``org_forward(A(x) s) + B(x) s`` (JAX glora.py:250; the layer's
        bias is in it, as there), with the dropout draws of a training forward."""
        return self._bypass(x, scale, _need_org_forward(org_forward), train, seed, diff=True)

    def forward(self, x, org_weight=None, org_bias=None, multiplier=None, org_forward=None,
                train=False, seed=None):
        multiplier = self.multiplier if multiplier is None else multiplier
        if org_forward is None:
            org_forward = lambda z: self.op(z, org_weight, org_bias)  # noqa: E731
        if self.bypass_mode:
            out = self._bypass(x, multiplier, org_forward, train, seed)
            return self._module_dropout_mix(seed, train, org_forward(x), out)
        base = org_forward(x)
        delta = self.op(x, self.get_diff_weight(multiplier, org_weight)[0].to(x.dtype))
        return self._module_dropout_mix(seed, train, base, base + delta)
