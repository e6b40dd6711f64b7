"""Quantized base layers (QLyCORIS; counterpart of ``lycoris_tpu/utils/quant.py``,
reference lycoris/utils/quant.py and modules/base.py:162-177).

:class:`Int8Linear` is a weight-only int8 linear layer: ``weight_q`` (int8,
torch layout) with one fp32 ``scale`` per output row, dequantized into the
compute dtype at each call. The network wrapper finds a quantized layer by
its class name (:data:`QUANT_CLASSES`) or its ``lycoris_quant`` flag and
forces its adapter into bypass mode, so that dW never touches the quantized
weight: such a layer never takes the merged route, premerge or
``merge_to``, and the Full algorithm refuses it. The graph sees its weight
dequantized in fp32 (``dequantized_weight``; JAX graph.py ``_quant_adapter``).
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from ..functional import general
from ..logging import logger
from ..modules.base import LayerInfo

QUANT_CLASSES = {
    "Int8Linear",
    "QuantLinear",
    "Linear8bitLt",
    "LinearFP4",
    "LinearNF4",
    "QLinear",
    "WeightOnlyQuantLinear",
}


@functools.cache
def log_bypass():
    return logger.warning(
        "Quantized base layer detected, adapter forced into bypass mode "
        "(ΔW never touches the quantized weight)."
    )


def quantize_int8(w: torch.Tensor, axis: int = 1):
    """(q, scale): per-output-row symmetric int8 of a torch-layout weight,
    rounded half to even (``jnp.round``'s rule, and ``torch.round``'s);
    the scale is computed in ``w``'s dtype and returned in fp32."""
    reduce_dims = tuple(range(1, w.ndim))
    amax = w.abs().amax(dim=reduce_dims, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16):
    return (q.to(torch.float32) * scale).to(dtype)


class Int8Linear(nn.Module):
    """Weight-only int8 Linear: ``weight_q`` (out, in) int8 and ``scale``
    (out, 1) fp32 as buffers, ``bias`` (out,) fp32 as a parameter; y = x @
    dequant(W).T + b in ``dtype``. ``head_split=(heads, head_dim)`` emits
    the head-major (..., H, T, D) layout, as ``models.layers.Linear`` does,
    so that it can stand in for any linear layer of the UNet.
    :func:`quantize_linear_params` gives its state dict from a float
    layer's."""

    lycoris_quant = True

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 head_split: tuple | None = None, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.head_split = head_split
        self.dtype = dtype
        self.register_buffer("weight_q", torch.zeros((out_features, in_features), dtype=torch.int8,
                                                     device=device))
        self.register_buffer("scale", torch.ones((out_features, 1), dtype=torch.float32,
                                                 device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=torch.float32, device=device))
                     if bias else None)

    @classmethod
    def from_linear(cls, layer: nn.Module, dtype=torch.bfloat16) -> "Int8Linear":
        """The quantized copy of a float linear layer (``weight`` (out, in),
        optional ``bias`` and ``head_split``), on its device."""
        w = layer.weight.detach()
        b = getattr(layer, "bias", None)
        q = cls(w.shape[1], w.shape[0], b is not None, getattr(layer, "head_split", None),
                dtype=dtype, device=w.device)
        params = {"weight": w, **({"bias": b.detach()} if b is not None else {})}
        q.load_state_dict(quantize_linear_params(params))
        return q

    def dequantized_weight(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize_int8(self.weight_q, self.scale, dtype)

    def forward_with(self, x, weight, bias):
        w = weight.to(self.dtype)
        b = None if bias is None else bias.to(self.dtype)
        x = x.to(self.dtype)
        if self.head_split is not None:
            return general.linear_head_split(x, w, b, *self.head_split)
        return general.linear(x, w, b)

    def forward(self, x):
        return self.forward_with(x, self.dequantized_weight(self.dtype), self.bias)

    def to_native(self, y):
        """Torch-layout output (..., T, out) -> this layer's output layout."""
        if self.head_split is None:
            return y
        return y.unflatten(-1, self.head_split).transpose(-2, -3)

    def from_native(self, y):
        """This layer's output layout -> torch-layout (..., T, out)."""
        if self.head_split is None:
            return y
        return y.transpose(-2, -3).flatten(-2)

    def lycoris_layer_info(self) -> LayerInfo:
        return LayerInfo.linear(self.out_features, self.in_features, self.bias is not None)


def quantize_linear_params(params: dict) -> dict:
    """A float Linear's ``{"weight", "bias"}`` -> :class:`Int8Linear`'s
    ``{"weight_q", "scale", "bias"}`` (the bias in fp32)."""
    q, scale = quantize_int8(params["weight"])
    out = {"weight_q": q, "scale": scale}
    if params.get("bias") is not None:
        out["bias"] = params["bias"].to(torch.float32)
    return out


def is_quant_class(class_name: str) -> bool:
    return class_name in QUANT_CLASSES
