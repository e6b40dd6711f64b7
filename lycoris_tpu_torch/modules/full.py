"""Full (native fine-tune as an adapter) module (counterpart of
``lycoris_tpu/modules/full.py``; reference lycoris/modules/full.py).

The adapter holds zero-init deltas ``diff`` (the layer's weight shape) and
``diff_b`` (where the layer has a bias), fp32 tensors of their own that
share no storage with the frozen base; the adapted layer computes with
W + diff and b + diff_b. Files keep the deltas under ``diff, diff_b``
(detected by ``diff``) and loading keeps them deltas. No bypass mode and no
max-norm; in training rank dropout masks the out rows of both deltas (JAX
salt ``0x72616E6B``), module dropout as in ``modules/base.py``.
"""

from __future__ import annotations

import torch

from .base import LayerInfo, LycorisBaseModule, to_tensor


class FullModule(LycorisBaseModule):
    name = "full"
    support_module = frozenset({"linear", "conv1d", "conv2d", "conv3d"})
    weight_list = ["diff", "diff_b"]
    weight_list_det = ["diff"]

    def __init__(self, lora_name, layer: LayerInfo, multiplier=1.0, lora_dim=4, alpha=1,
                 dropout=0.0, rank_dropout=0.0, module_dropout=0.0, rank_dropout_scale=False,
                 bypass_mode=None, device=None, dtype=torch.float32, **kwargs):
        super().__init__(lora_name, layer, multiplier, dropout, rank_dropout, module_dropout,
                         rank_dropout_scale, False)
        if bypass_mode:
            raise ValueError("bypass mode is not supported in Full algo.")
        if self.not_supported:
            raise ValueError(f"{self.module_type} is not supported in Full algo.")
        self.trainable.add("diff")
        self._set("diff", torch.zeros(self.shape, dtype=dtype, device=device))
        self.has_bias = self.layer.has_bias
        if self.has_bias:
            self.trainable.add("diff_b")
            self._set("diff_b", torch.zeros((self.shape[0],), dtype=dtype, device=device))

    @classmethod
    def make_module_from_state_dict(cls, lora_name, layer, diff, diff_b):
        module = cls(lora_name, layer, 1)
        module._set("diff", to_tensor(diff).reshape(module.shape).clone())
        if diff_b is not None:
            module.has_bias = True
            module.trainable.add("diff_b")
            module._set("diff_b", to_tensor(diff_b).reshape(-1).clone())
        return module

    def get_diff_weight(self, multiplier=1.0):
        db = self._p("diff_b")
        return self._p("diff") * multiplier, None if db is None else db * multiplier

    def get_merged_weight(self, org_weight, org_bias=None, multiplier=1.0):
        dw, db = self.get_diff_weight(multiplier)
        merged_b = org_bias
        if db is not None:
            merged_b = db if org_bias is None else org_bias + db
        return org_weight + dw, merged_b

    def custom_state_dict(self):
        dest = {"diff": self._p("diff")}
        if self._p("diff_b") is not None:
            dest["diff_b"] = self._p("diff_b")
        return {k: v.detach() for k, v in dest.items()}

    def forward(self, x, org_weight=None, org_bias=None, multiplier=None, org_forward=None,
                train=False, seed=None, shard=(0, 1)):
        multiplier = self.multiplier if multiplier is None else multiplier
        if org_forward is None:
            org_forward = lambda z: self.op(z, org_weight, org_bias)  # noqa: E731
        base = org_forward(x)
        dw, db = self.get_diff_weight(multiplier)
        if self._draws(train, seed, self.rank_dropout):
            drop = self._rank_mask(self.shape[0], dw.dtype, dw.device, seed)
            dw = dw * drop.reshape(-1, *[1] * (dw.ndim - 1))
            if db is not None:
                db = db * drop
        delta = self.op(x, dw.to(x.dtype), None if db is None else db.to(x.dtype))
        return self._module_dropout_mix(seed, train, base, base + delta)
