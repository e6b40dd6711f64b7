"""Model graph of the port: a walk over ``named_modules()`` that keeps
references to the live modules (counterpart of ``ModelGraph.from_torch``,
``lycoris_tpu/graph.py:421-498``, without the numpy copies), or the layers
of a flat state dict (:meth:`ModelGraph.from_state_dict`, JAX
graph.py:388-420), each a :class:`TensorLayer` that holds a weight and a
bias and no module, for the extract and merge tools.

Each leaf node carries the :class:`LayerInfo` of its layer and runs it with
a substituted weight (:meth:`Node.apply`), in the layer's own output layout.
A quantized layer (``lycoris_quant``, :mod:`.utils.quant`) shows the graph
its weight dequantized (:meth:`Node.weights`); that weight is not the
layer's own storage, so nothing can be merged into it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from .modules.base import LayerInfo
from .parallel import sharding


def layer_info_for(mod: nn.Module, name: str = "") -> LayerInfo | None:
    """The LayerInfo of an adaptable layer, None for a container."""
    li = None
    li_fn = getattr(mod, "lycoris_layer_info", None)
    if callable(li_fn):
        li = li_fn()
    elif isinstance(mod, nn.Linear):
        li = LayerInfo.linear(mod.out_features, mod.in_features, mod.bias is not None)
    elif isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
        li = LayerInfo.conv(
            mod.weight.ndim - 2, mod.out_channels, mod.in_channels, mod.kernel_size,
            stride=mod.stride, padding=mod.padding, dilation=mod.dilation, groups=mod.groups,
            bias=mod.bias is not None,
        )
    elif isinstance(mod, nn.LayerNorm):
        li = LayerInfo.layer_norm(tuple(mod.normalized_shape), mod.eps, mod.bias is not None)
    elif isinstance(mod, nn.GroupNorm):
        li = LayerInfo.group_norm(mod.num_groups, mod.num_channels, mod.eps, mod.bias is not None)
    elif isinstance(mod, nn.RMSNorm):
        li = LayerInfo.rms_norm(tuple(mod.normalized_shape),
                                mod.eps if mod.eps is not None else 1e-6,
                                getattr(mod, "bias", None) is not None)
    elif (getattr(mod, "weight", None) is not None and callable(getattr(mod, "_norm", None))
          and getattr(mod.weight, "ndim", 0) >= 1):
        # the reference's duck typing (norms.py:37-44): a ``weight`` and a
        # stats-only ``_norm`` make an RMSNorm-like (JAX graph.py:453-470)
        li = LayerInfo.rms_norm(
            tuple(mod.weight.shape),
            float(getattr(mod, "eps", getattr(mod, "variance_epsilon", 1e-6))),
            getattr(mod, "bias", None) is not None)
    if li is None:
        return None
    return dataclasses.replace(li, name=name)


@dataclasses.dataclass
class Node:
    name: str  # dotted path ("" = root)
    class_name: str
    module: nn.Module
    layer_info: LayerInfo | None = None  # None for containers
    # a quantized base layer: adapters go into bypass mode and never merge
    is_quant: bool = dataclasses.field(init=False, default=False)

    def __post_init__(self):
        from .utils.quant import is_quant_class

        self.is_quant = (bool(getattr(self.module, "lycoris_quant", False))
                         or is_quant_class(self.class_name))

    @property
    def is_leaf(self) -> bool:
        return self.layer_info is not None

    def weights(self):
        """(weight, bias) in torch layout; a quantized layer's weight
        dequantized in fp32; a leaf sharded over a model axis
        (:func:`~.parallel.sharding.shard_base_params`) whole: the one its
        running forward gathered, else gathered now."""
        if self.is_quant and hasattr(self.module, "dequantized_weight"):
            return self.module.dequantized_weight(), getattr(self.module, "bias", None)
        if hasattr(self.module, "_lycoris_shards"):
            return sharding.full_param(self.module, "weight"), sharding.full_param(self.module,
                                                                                   "bias")
        return self.module.weight, getattr(self.module, "bias", None)

    def stored(self):
        """(weight, bias) as the layer stores them: this rank's slices of
        sharded leaves."""
        return (sharding.stored_param(self.module, "weight"),
                sharding.stored_param(self.module, "bias"))

    def write(self, name: str, value):
        """Write the whole ``value`` into the layer's leaf ``name`` (this
        rank's slice of it where the leaf is sharded)."""
        sharding.write_param(self.module, name, value)

    def apply(self, x, weight, bias):
        """The layer's output for ``x`` with ``weight``/``bias`` in place of its own."""
        fwd = getattr(self.module, "forward_with", None)
        if fwd is not None:
            return fwd(x, weight, bias)
        return self.layer_info.op(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))

    def to_native(self, y):
        """Torch-layout output -> the layer's own output layout."""
        f = getattr(self.module, "to_native", None)
        return y if f is None else f(y)

    def from_native(self, y):
        """The layer's own output layout -> torch-layout output."""
        f = getattr(self.module, "from_native", None)
        return y if f is None else f(y)


class TensorLayer:
    """A layer of a flat state dict: its weight and bias, and no module."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor | None = None):
        self.weight = weight
        self.bias = bias


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


class ModelGraph:
    """Ordered nodes in ``named_modules()`` order."""

    def __init__(self, nodes=None, model: nn.Module | None = None):
        self.nodes: list[Node] = list(nodes or [])
        self.model = model

    def named_modules(self, root: str = ""):
        """Yield (relative_name, node) for nodes under ``root``, root first."""
        prefix = root + "." if root else ""
        for n in self.nodes:
            if root == "" or n.name == root or n.name.startswith(prefix):
                rel = n.name[len(prefix):] if root and n.name != root else ("" if n.name == root else n.name)
                yield rel, n

    @staticmethod
    def from_state_dict(sd: dict) -> "ModelGraph":
        """The layers of a flat torch-style state dict (``{name}.weight`` and
        ``{name}.bias``), in its key order after a root node. The kind comes
        from the weight's ndim: 2 is Linear, 3-5 ConvNd, 1 LayerNorm; a
        convolution's stride and padding are unknown, which the extract and
        merge tools never need (JAX graph.py:388-420). The tensors are the
        state dict's own (numpy arrays become CPU tensors)."""
        nodes = [Node(name="", class_name="root", module=None)]
        for key in sd:
            if not key.endswith(".weight"):
                continue
            name = key[: -len(".weight")]
            w = _as_tensor(sd[key])
            b = sd.get(f"{name}.bias")
            b = None if b is None else _as_tensor(b)
            if w.ndim == 2:
                li, cls = LayerInfo.linear(w.shape[0], w.shape[1], b is not None, name), "Linear"
            elif w.ndim in (3, 4, 5):
                nd = w.ndim - 2
                li = LayerInfo.conv(nd, w.shape[0], w.shape[1], tuple(w.shape[2:]),
                                    bias=b is not None, name=name)
                cls = f"Conv{nd}d"
            elif w.ndim == 1:
                li = LayerInfo.layer_norm(w.shape[0], bias=b is not None, name=name)
                cls = "LayerNorm"
            else:
                continue
            nodes.append(Node(name=name, class_name=cls, module=TensorLayer(w, b), layer_info=li))
        return ModelGraph(nodes)

    @staticmethod
    def from_torch(module: nn.Module) -> "ModelGraph":
        nodes = [
            Node(name=name, class_name=type(mod).__name__, module=mod,
                 layer_info=layer_info_for(mod, name))
            for name, mod in module.named_modules()
        ]
        return ModelGraph(nodes, model=module)
