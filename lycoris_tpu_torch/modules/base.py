"""Adapter module base (counterpart of ``lycoris_tpu/modules/base.py``).

An adapter is an ``nn.Module`` that owns its tensors under the reference
state-dict keys (``lokr_w1``, ``hada_w1_a``, ...): trainable factors are
``nn.Parameter``s, ``alpha`` and a fixed ``scalar`` are buffers. Its
``forward(x, org_weight, org_bias, org_forward=...)`` returns the adapted
layer's output; the network wrapper puts it in place of the layer's own
forward (``LycorisNetwork.apply_to``), as the reference LyCORIS does.

The forward is the inference forward (dropout off, as the JAX forward
with ``train=False``); dropout, the parametrize API and max-norm wait for
the training slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..functional import general
from ..functional.general import convnd, layer_norm, linear


def _hashable_kw(kw: dict) -> tuple:
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in kw.items()))


@dataclasses.dataclass(frozen=True)
class LayerInfo:
    """Static description of a wrapped layer: kind, torch weight shape and
    the op's keyword arguments (reference modules/base.py:88-158)."""

    module_type: str  # linear | conv1d | conv2d | conv3d | layernorm | groupnorm
    shape: tuple  # torch weight shape
    kw_dict: tuple = ()
    has_bias: bool = False
    name: str = ""

    @property
    def kw(self) -> dict:
        return {k: v for k, v in self.kw_dict}

    @property
    def is_conv(self) -> bool:
        return self.module_type.startswith("conv")

    @property
    def is_norm(self) -> bool:
        return self.module_type in ("layernorm", "groupnorm", "rmsnorm")

    @staticmethod
    def linear(out_features: int, in_features: int, bias: bool = True, name: str = "") -> "LayerInfo":
        return LayerInfo("linear", (out_features, in_features), (), bias, name)

    @staticmethod
    def conv(nd: int, out_channels: int, in_channels: int, kernel_size, stride=1, padding=0,
             dilation=1, groups: int = 1, bias: bool = True, name: str = "") -> "LayerInfo":
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * nd
        kw = _hashable_kw(dict(stride=stride, padding=padding, dilation=dilation, groups=groups))
        return LayerInfo(f"conv{nd}d", (out_channels, in_channels // groups, *kernel_size),
                         kw, bias, name)

    @staticmethod
    def layer_norm(normalized_shape, eps: float = 1e-5, bias: bool = True, name: str = "") -> "LayerInfo":
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        kw = _hashable_kw(dict(normalized_shape=tuple(normalized_shape), eps=eps))
        return LayerInfo("layernorm", tuple(normalized_shape), kw, bias, name)

    @staticmethod
    def group_norm(num_groups: int, num_channels: int, eps: float = 1e-5, bias: bool = True,
                   name: str = "", act: str | None = None) -> "LayerInfo":
        kw = dict(num_groups=num_groups, eps=eps)
        if act is not None:
            kw["act"] = act
        return LayerInfo("groupnorm", (num_channels,), _hashable_kw(kw), bias, name)

    def op(self, x, weight, bias=None, with_act: bool = True):
        t = self.module_type
        if t == "linear":
            return linear(x, weight, bias)
        if t.startswith("conv"):
            return convnd(x, weight, bias, **self.kw)
        if t == "layernorm":
            kw = self.kw
            return layer_norm(x, kw["normalized_shape"], weight, bias, kw["eps"])
        if t == "groupnorm":
            kw = self.kw
            return general.group_norm_act(
                x, kw["num_groups"], weight, bias, kw["eps"],
                act=kw.get("act") if with_act else None,
            )
        raise ValueError(f"unsupported module_type {t}")


def as_float(alpha) -> float:
    if alpha is None:
        return 0.0
    if isinstance(alpha, torch.Tensor):
        return float(alpha.detach().float().reshape(-1)[0].cpu())
    if isinstance(alpha, np.ndarray) or hasattr(alpha, "__array__"):
        return float(np.asarray(alpha).reshape(-1)[0])
    return float(alpha)


def to_tensor(v) -> torch.Tensor:
    """A state-dict value (numpy array, torch tensor or array-like) as a tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.as_tensor(np.asarray(v))


class LycorisBaseModule(nn.Module):
    """Base adapter: static layer info plus the adapter's tensors."""

    name: str = "base"
    support_module: frozenset = frozenset()
    weight_list: list = []
    weight_list_det: list = []

    def __init__(self, lora_name: str, layer: LayerInfo, multiplier: float = 1.0,
                 dropout: float = 0.0, rank_dropout: float = 0.0, module_dropout: float = 0.0,
                 rank_dropout_scale: bool = False, bypass_mode: bool | None = None, **kwargs):
        super().__init__()
        self.lora_name = lora_name
        self.layer = layer
        self.multiplier = multiplier
        self.dropout = dropout
        self.rank_dropout = rank_dropout
        self.rank_dropout_scale = rank_dropout_scale
        self.module_dropout = module_dropout
        self.bypass_mode = bool(bypass_mode)
        self.not_supported = layer.module_type not in self.support_module
        self.trainable: set[str] = set()

    # -- tensors under their reference keys ----------------------------------
    def _owner(self, key: str, create: bool = False):
        """(module, name) that holds ``key``: a dotted key (``lora_up.weight``)
        lives on a child module named by its prefix, as in the reference, so
        ``named_parameters()`` gives the state-dict key."""
        if "." not in key:
            return self, key
        child, name = key.split(".", 1)
        mod = self._modules.get(child)
        if mod is None and create:
            mod = nn.Module()
            self.add_module(child, mod)
        return mod, name

    def _set(self, key: str, value: torch.Tensor, trainable: bool | None = None):
        """Register ``value`` under ``key``: a Parameter if trainable, else a buffer."""
        mod, name = self._owner(key, create=True)
        if name in mod._parameters:
            del mod._parameters[name]
        if name in mod._buffers:
            del mod._buffers[name]
        if trainable is None:
            trainable = key in self.trainable
        if trainable:
            mod.register_parameter(name, nn.Parameter(value, requires_grad=True))
        else:
            mod.register_buffer(name, value)

    def _p(self, key):
        mod, name = self._owner(key)
        if mod is None:
            return None
        if name in mod._parameters:
            return mod._parameters[name]
        return mod._buffers.get(name)

    @property
    def params(self) -> dict:
        """Every tensor of the adapter by key (parameters and buffers)."""
        return {**dict(self.named_buffers()), **dict(self.named_parameters())}

    @property
    def module_type(self) -> str:
        return self.layer.module_type

    @property
    def shape(self) -> tuple:
        return self.layer.shape

    def op(self, x, weight, bias=None):
        return self.layer.op(x, weight, bias)

    # -- checkpoint API -------------------------------------------------------
    @classmethod
    def algo_check(cls, state_dict, lora_name) -> bool:
        """First-match detection by key presence (reference base.py:236-238)."""
        return any(f"{lora_name}.{k}" in state_dict for k in cls.weight_list_det)

    @classmethod
    def extract_state_dict(cls, state_dict, lora_name) -> list:
        return [state_dict.get(f"{lora_name}.{k}", None) for k in cls.weight_list]

    @classmethod
    def make_module_from_state_dict(cls, lora_name, layer: LayerInfo, *weights):
        raise NotImplementedError

    def custom_state_dict(self) -> dict:
        raise NotImplementedError

    def state_dict(self, *args, **kwargs) -> dict:
        """The reference's saved form (``scalar`` folded in), keys unprefixed."""
        return self.custom_state_dict()

    def load_state_dict(self, sd: dict, strict: bool = False):
        """Copy values from a flat unprefixed state dict; reset ``scalar`` to 1
        like the reference load hook (locon.py:184-196)."""
        with torch.no_grad():
            for k, v in sd.items():
                cur = self._p(k)
                if cur is None:
                    continue
                cur.copy_(to_tensor(v).reshape(cur.shape).to(cur.dtype))
            scalar = self._p("scalar")
            if scalar is not None:
                scalar.fill_(1.0)

    # -- compute API ------------------------------------------------------------
    def get_diff_weight(self, multiplier=1.0):
        raise NotImplementedError

    def get_merged_weight(self, org_weight, org_bias=None, multiplier=1.0):
        raise NotImplementedError

    def bypass_forward_diff(self, x, scale=1.0):
        raise NotImplementedError

    def bypass_forward(self, x, scale=1.0, org_forward=None):
        return org_forward(x) + self.bypass_forward_diff(x, scale=scale)

    def forward(self, x, org_weight=None, org_bias=None, multiplier=None, org_forward=None):
        """Delta over base: ``org_forward(x) + op(x, dW)`` (or the bypass path)."""
        multiplier = self.multiplier if multiplier is None else multiplier
        if org_forward is None:
            org_forward = lambda z: self.op(z, org_weight, org_bias)  # noqa: E731
        if self.bypass_mode:
            return self.bypass_forward(x, scale=multiplier, org_forward=org_forward)
        base = org_forward(x)
        diff = self.get_weight().to(org_weight.dtype) * self._p("scalar")
        new_weight = org_weight + diff * multiplier
        return base + self.op(x, (new_weight - org_weight).to(x.dtype))
