"""Norm-layer tuning module (counterpart of ``lycoris_tpu/modules/norms.py``;
reference lycoris/modules/norms.py).

Trains additive deltas ``w_norm`` / ``b_norm`` (zero-init; ``b_norm`` where
the layer has a bias) of a LayerNorm, GroupNorm or RMSNorm layer (torch
``nn.RMSNorm`` and the duck-typed modules with a ``weight`` and a callable
``_norm``). Keys ``w_norm, b_norm``, detected by ``w_norm``. The merged
route runs the layer once with (w + dw, b + db): through the LayerNorm and
GroupNorm kernels, whose backward then also forms dw and db. The delta
route adds ``op(x, dw, db)``, the norm's output times dw plus db; for a
GroupNorm with a folded activation it sums the act-less outputs and applies
the activation to the sum (the norm is linear in (gamma, beta) for fixed
statistics). A module on a layer of another kind keeps the base output.
No max-norm; module dropout as in ``modules/base.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import LayerInfo, LycorisBaseModule, to_tensor


class NormModule(LycorisBaseModule):
    name = "norm"
    support_module = frozenset({"layernorm", "groupnorm", "rmsnorm"})
    weight_list = ["w_norm", "b_norm"]
    weight_list_det = ["w_norm"]

    def __init__(self, lora_name, layer: LayerInfo, multiplier=1.0, rank_dropout=0.0,
                 module_dropout=0.0, rank_dropout_scale=False, device=None, dtype=torch.float32,
                 **kwargs):
        super().__init__(lora_name, layer, multiplier=multiplier, rank_dropout=rank_dropout,
                         module_dropout=module_dropout, rank_dropout_scale=rank_dropout_scale)
        if self.not_supported:
            return
        dim = self.shape[0]
        self.trainable.add("w_norm")
        self._set("w_norm", torch.zeros((dim,), dtype=dtype, device=device))
        if layer.has_bias:
            self.trainable.add("b_norm")
            self._set("b_norm", torch.zeros((dim,), dtype=dtype, device=device))

    @classmethod
    def make_module_from_state_dict(cls, lora_name, layer, w_norm, b_norm):
        module = cls(lora_name, layer, 1)
        module._set("w_norm", to_tensor(w_norm).clone(), trainable=True)
        if b_norm is not None:
            module.trainable.add("b_norm")
            module._set("b_norm", to_tensor(b_norm).clone())
        return module

    def get_diff_weight(self, multiplier=1.0):
        b = self._p("b_norm")
        return self._p("w_norm") * multiplier, None if b is None else b * multiplier

    def get_merged_weight(self, org_weight, org_bias=None, multiplier=1.0):
        dw, db = self.get_diff_weight(multiplier)
        merged_b = org_bias
        if db is not None:
            merged_b = db if org_bias is None else org_bias + db
        return org_weight + dw.reshape(org_weight.shape), merged_b

    def custom_state_dict(self):
        dest = {"w_norm": self._p("w_norm")}
        if self._p("b_norm") is not None:
            dest["b_norm"] = self._p("b_norm")
        return {k: v.detach() for k, v in dest.items()}

    def forward(self, x, org_weight=None, org_bias=None, multiplier=None, org_forward=None,
                train=False, seed=None, shard=(0, 1)):
        multiplier = self.multiplier if multiplier is None else multiplier
        if org_forward is None:
            org_forward = lambda z: self.layer.op(z, org_weight, org_bias)  # noqa: E731
        base = org_forward(x)
        if self.not_supported:
            return base
        dw, db = self.get_diff_weight(multiplier)
        dw = dw.to(x.dtype)
        db = None if db is None else db.to(x.dtype)
        act = self.layer.act
        if act is not None and org_weight is not None:
            pre = self.layer.op(x, org_weight.to(x.dtype),
                                None if org_bias is None else org_bias.to(x.dtype), with_act=False)
            pre = pre + self.layer.op(x, dw, db, with_act=False)
            full = F.silu(pre) if act == "silu" else pre
        else:
            full = base + self.layer.op(x, dw, db)
        return self._module_dropout_mix(seed, train, base, full)
