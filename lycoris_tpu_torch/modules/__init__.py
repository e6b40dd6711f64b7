"""Adapter module registry (counterpart of ``lycoris_tpu/modules/__init__.py``).

``MODULE_LIST`` keeps the JAX package's detection order (first
``algo_check`` hit wins). LoRA/LoCon, LoKr and LoHa are ported; every
other algorithm is detected by its keys and then raises
``NotImplementedError`` naming itself, so a file of an unported kind fails
loudly instead of loading without its adapters.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import LayerInfo, LycorisBaseModule
from .locon import LoConModule
from .loha import LohaModule
from .lokr import LokrModule


class UnportedModule:
    """Detection stub for an algorithm the port does not have yet."""

    name = "unported"
    weight_list_det: list = []
    det_ndim: int | None = None  # OFT kinds share a key and differ by its rank

    @classmethod
    def algo_check(cls, state_dict, lora_name) -> bool:
        for k in cls.weight_list_det:
            key = f"{lora_name}.{k}"
            if key in state_dict:
                if cls.det_ndim is None or np.ndim(state_dict[key]) == cls.det_ndim:
                    return True
        return False

    @classmethod
    def extract_state_dict(cls, state_dict, lora_name) -> list:
        return []

    @classmethod
    def make_module_from_state_dict(cls, lora_name, layer, *weights):
        raise NotImplementedError(
            f"algorithm {cls.name!r} ({lora_name}) is not ported to lycoris_tpu_torch yet"
        )


def _unported(name: str, det: list, ndim: int | None = None):
    return type(f"Unported_{name}", (UnportedModule,),
                {"name": name, "weight_list_det": det, "det_ndim": ndim})


IA3Module = _unported("ia3", ["on_input"])
FullModule = _unported("full", ["diff"])
NormModule = _unported("norm", ["w_norm"])
DiagOFTModule = _unported("diag-oft", ["oft_blocks"], 3)
ButterflyOFTModule = _unported("boft", ["oft_blocks"], 4)
GLoRAModule = _unported("glora", ["a1.weight"])
DyLoraModule = _unported("dylora", [])

# detection order matters: first algo_check hit wins
MODULE_LIST = [
    LoConModule,
    LohaModule,
    IA3Module,
    LokrModule,
    FullModule,
    NormModule,
    DiagOFTModule,
    ButterflyOFTModule,
    GLoRAModule,
    DyLoraModule,
]


def get_module(lyco_state_dict, lora_name):
    """(module_class, ordered_params) for the first matching algorithm."""
    for module_class in MODULE_LIST:
        if module_class.algo_check(lyco_state_dict, lora_name):
            return module_class, module_class.extract_state_dict(lyco_state_dict, lora_name)
    return None, None


def make_module(module_class, params, lora_name, layer: LayerInfo, dtype=torch.float32,
                device=None):
    """Instantiate from extracted params, floating tensors cast to ``dtype``
    (fp32 by default, as the reference upcasts fp16 files on load), on
    ``device`` (by default where the loaded tensors are).
    Raises ``NotImplementedError`` for an algorithm the port does not have."""
    module = module_class.make_module_from_state_dict(lora_name, layer, *params)
    if device is None:
        device = next((p.device for p in params if isinstance(p, torch.Tensor)), None)
    if device is not None:
        module.to(device)
    with torch.no_grad():
        for key, val in module.params.items():
            if val.is_floating_point() and val.dtype != dtype:
                module._set(key, val.detach().to(dtype), trainable=key in module.trainable)
    return module


__all__ = [
    "LayerInfo",
    "LycorisBaseModule",
    "LoConModule",
    "LohaModule",
    "LokrModule",
    "MODULE_LIST",
    "get_module",
    "make_module",
]
