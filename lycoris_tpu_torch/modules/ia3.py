"""(IA)^3 adapter module (counterpart of ``lycoris_tpu/modules/ia3.py``;
reference lycoris/modules/ia3.py).

One learned scale vector, zero-init, on the output dim (or the input dim
with ``train_on_input``): merged W' = W * (1 + w * multiplier). Keys
``weight, on_input``, detected by ``on_input``. Loading takes both keys and
restores ``train_on_input`` from ``on_input`` (the reference's loader takes
only ``weight`` and fails). No max-norm; module dropout as in
``modules/base.py``.
"""

from __future__ import annotations

import torch

from .base import LayerInfo, LycorisBaseModule, _need_org_forward, to_tensor


class IA3Module(LycorisBaseModule):
    name = "ia3"
    support_module = frozenset({"linear", "conv1d", "conv2d", "conv3d"})
    weight_list = ["weight", "on_input"]
    weight_list_det = ["on_input"]

    def __init__(self, lora_name, layer: LayerInfo, multiplier=1.0, lora_dim=4, alpha=1,
                 dropout=0.0, rank_dropout=0.0, module_dropout=0.0, train_on_input=False,
                 bypass_mode=None, device=None, dtype=torch.float32, **kwargs):
        super().__init__(lora_name, layer, multiplier, dropout, rank_dropout, module_dropout,
                         False, bypass_mode)
        if self.not_supported:
            raise ValueError(f"{self.module_type} is not supported in IA^3 algo.")
        out_dim, in_dim, *k = self.shape
        train_dim = in_dim if train_on_input else out_dim
        w_shape = (1, train_dim, *[1] * len(k)) if self.layer.is_conv else (train_dim,)
        self.train_input = bool(train_on_input)
        self.trainable.add("weight")
        self._set("weight", torch.zeros(w_shape, dtype=dtype, device=device))
        self._set("on_input", torch.tensor(int(train_on_input), dtype=torch.int32, device=device),
                  trainable=False)

    @classmethod
    def make_module_from_state_dict(cls, lora_name, layer, weight, on_input=None):
        train_on_input = bool(int(to_tensor(on_input))) if on_input is not None else False
        module = cls(lora_name, layer, 1, train_on_input=train_on_input)
        module._set("weight", to_tensor(weight).reshape(module._p("weight").shape).clone())
        return module

    def get_merged_weight(self, org_weight, org_bias=None, multiplier=1.0):
        """W * (1 + w * multiplier) on the output rows (or input columns)."""
        weight = self._p("weight") * multiplier + 1
        if self.train_input:
            if org_weight.ndim > 2:
                weight = weight.reshape(1, -1, *[1] * (org_weight.ndim - 2))
            return org_weight * weight, org_bias
        return org_weight * weight.reshape(-1, *[1] * (org_weight.ndim - 1)), org_bias

    def custom_state_dict(self):
        return {"weight": self._p("weight").detach(), "on_input": self._p("on_input")}

    def _bypass(self, x, scale, org_forward, diff=False):
        """The input (or the base output) scaled by 1 + w * ``scale`` (with
        ``diff``, by w * ``scale``), in the activation dtype."""
        weight = (self._p("weight") * scale + (0 if diff else 1)).to(x.dtype)
        if self.train_input:
            return org_forward(x * weight)
        return org_forward(x) * weight

    def bypass_forward_diff(self, x, scale=1.0, train=False, seed=None, org_forward=None):
        """``org_forward(x * w s)`` on the input, else ``org_forward(x) * w s``
        (JAX ia3.py:107; the input form keeps the layer's bias, as there)."""
        return self._bypass(x, scale, _need_org_forward(org_forward), diff=True)

    def forward(self, x, org_weight=None, org_bias=None, multiplier=None, org_forward=None,
                train=False, seed=None):
        multiplier = self.multiplier if multiplier is None else multiplier
        if org_forward is None:
            org_forward = lambda z: self.op(z, org_weight, org_bias)  # noqa: E731
        if self.bypass_mode:
            out = self._bypass(x, multiplier, org_forward)
            return self._module_dropout_mix(seed, train, org_forward(x), out)
        base = org_forward(x)
        merged = self.get_merged_weight(org_weight, multiplier=multiplier)[0]
        delta = self.op(x, (merged - org_weight).to(x.dtype))
        return self._module_dropout_mix(seed, train, base, base + delta)
