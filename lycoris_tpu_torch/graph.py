"""Model graph of the port: a walk over ``named_modules()`` that keeps
references to the live modules (counterpart of ``ModelGraph.from_torch``,
``lycoris_tpu/graph.py:421-498``, without the numpy copies).

Each leaf node carries the :class:`LayerInfo` of its layer and runs it with
a substituted weight (:meth:`Node.apply`), in the layer's own output layout.
"""

from __future__ import annotations

import dataclasses

from torch import nn

from .modules.base import LayerInfo


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

    @property
    def is_leaf(self) -> bool:
        return self.layer_info is not None

    def weights(self):
        return self.module.weight, getattr(self.module, "bias", None)

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
    def from_torch(module: nn.Module) -> "ModelGraph":
        nodes = [
            Node(name=name, class_name=type(mod).__name__, module=mod,
                 layer_info=layer_info_for(mod, name))
            for name, mod in module.named_modules()
        ]
        return ModelGraph(nodes, model=module)
