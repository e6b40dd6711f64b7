"""Torch-layout layers of the port (counterpart of ``lycoris_tpu/models/layers.py``).

Class names mirror torch (``Linear``, ``Conv2d``, ``LayerNorm``,
``RMSNorm``, ``GroupNorm``) because presets target class names. Weights stay in torch
layout and are cast to the activation dtype at each call, as in the JAX
layers. Each layer gives the graph its :class:`LayerInfo`
(``lycoris_layer_info``) and can run with a substituted weight
(``forward_with``), which the merged adapter forward uses.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..functional import general
from ..modules.base import LayerInfo


class Linear(nn.Module):
    """y = x @ W.T + b with W (out, in). ``head_split=(heads, head_dim)``
    emits the head-major (..., H, T, D) layout of the attention projections;
    weight, checkpoint keys and adapter math are those of a plain linear."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 head_split: tuple | None = None, device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.head_split = head_split
        kw = dict(device=device, dtype=dtype or torch.float32)
        self.weight = nn.Parameter(torch.empty(out_features, in_features, **kw))
        self.bias = nn.Parameter(torch.empty(out_features, **kw)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.copy_(general.kaiming_uniform(
                tuple(self.weight.shape), generator=generator, device=self.weight.device))
            if self.bias is not None:
                bound = 1 / math.sqrt(self.in_features)
                self.bias.uniform_(-bound, bound, generator=generator)

    def forward_with(self, x, weight, bias):
        w = weight.to(x.dtype)
        b = None if bias is None else bias.to(x.dtype)
        if self.head_split is not None:
            return general.linear_head_split(x, w, b, *self.head_split)
        return general.linear(x, w, b)

    def forward(self, x):
        return self.forward_with(x, self.weight, self.bias)

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


class Conv2d(nn.Module):
    """Channels-first 2-D convolution, weight (out, in/groups, kh, kw)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3, stride=1,
                 padding=0, dilation=1, groups: int = 1, bias: bool = True, device=None,
                 dtype=None):
        super().__init__()
        k = (kernel_size,) * 2 if isinstance(kernel_size, int) else tuple(kernel_size)
        self.in_channels, self.out_channels, self.kernel_size = in_channels, out_channels, k
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        kw = dict(device=device, dtype=dtype or torch.float32)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, *k, **kw))
        self.bias = nn.Parameter(torch.empty(out_channels, **kw)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.copy_(general.kaiming_uniform(
                tuple(self.weight.shape), generator=generator, device=self.weight.device))
            if self.bias is not None:
                fan_in = (self.in_channels // self.groups) * math.prod(self.kernel_size)
                bound = 1 / math.sqrt(fan_in)
                self.bias.uniform_(-bound, bound, generator=generator)

    def forward_with(self, x, weight, bias):
        return general.convnd(
            x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
            stride=self.stride, padding=self.padding, dilation=self.dilation,
            groups=self.groups,
        )

    def forward(self, x):
        return self.forward_with(x, self.weight, self.bias)

    def lycoris_layer_info(self) -> LayerInfo:
        return LayerInfo.conv(2, self.out_channels, self.in_channels, self.kernel_size,
                              stride=self.stride, padding=self.padding, dilation=self.dilation,
                              groups=self.groups, bias=self.bias is not None)


class LayerNorm(nn.Module):
    """Trailing-dim LayerNorm; the affine case runs the LayerNorm kernel."""

    def __init__(self, dim: int, eps: float = 1e-5, bias: bool = True, device=None, dtype=None):
        super().__init__()
        self.dim, self.eps = dim, eps
        kw = dict(device=device, dtype=dtype or torch.float32)
        self.weight = nn.Parameter(torch.ones(dim, **kw))
        self.bias = nn.Parameter(torch.zeros(dim, **kw)) if bias else None

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward_with(self, x, weight, bias):
        return general.layer_norm(
            x, (self.dim,), weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
            self.eps,
        )

    def forward(self, x):
        return self.forward_with(x, self.weight, self.bias)

    def lycoris_layer_info(self) -> LayerInfo:
        return LayerInfo.layer_norm(self.dim, self.eps, self.bias is not None)


class RMSNorm(nn.Module):
    """Trailing-dim RMSNorm, x / sqrt(mean(x^2) + eps) then the weight (the
    JAX ``L.RMSNorm``: no mean subtraction, no bias by default); plain
    PyTorch, as it is plain XLA in the JAX package. The graph and the Norm
    algorithm see it as an RMSNorm through its LayerInfo."""

    def __init__(self, dim: int, eps: float = 1e-6, bias: bool = False, device=None, dtype=None):
        super().__init__()
        self.dim, self.eps = dim, eps
        kw = dict(device=device, dtype=dtype or torch.float32)
        self.weight = nn.Parameter(torch.ones(dim, **kw))
        self.bias = nn.Parameter(torch.zeros(dim, **kw)) if bias else None

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward_with(self, x, weight, bias):
        return general.rms_norm(
            x, (self.dim,), weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
            self.eps,
        )

    def forward(self, x):
        return self.forward_with(x, self.weight, self.bias)

    def lycoris_layer_info(self) -> LayerInfo:
        return LayerInfo.rms_norm(self.dim, self.eps, self.bias is not None)


class GroupNorm(nn.Module):
    """Channels-first GroupNorm with an optional folded activation (``act="silu"``)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5, bias: bool = True,
                 act: str | None = None, device=None, dtype=None):
        super().__init__()
        self.num_groups, self.num_channels, self.eps, self.act = num_groups, num_channels, eps, act
        kw = dict(device=device, dtype=dtype or torch.float32)
        self.weight = nn.Parameter(torch.ones(num_channels, **kw))
        self.bias = nn.Parameter(torch.zeros(num_channels, **kw)) if bias else None

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward_with(self, x, weight, bias):
        return general.group_norm_act(
            x, self.num_groups, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
            self.eps, act=self.act,
        )

    def forward(self, x):
        return self.forward_with(x, self.weight, self.bias)

    def lycoris_layer_info(self) -> LayerInfo:
        return LayerInfo.group_norm(self.num_groups, self.num_channels, self.eps,
                                    self.bias is not None, act=self.act)
