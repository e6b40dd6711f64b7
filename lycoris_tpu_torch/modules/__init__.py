"""Adapter module registry (counterpart of ``lycoris_tpu/modules/__init__.py``).

``MODULE_LIST`` keeps the JAX package's detection order (first
``algo_check`` hit wins): LoRA/LoCon, LoHa, (IA)^3, LoKr, Full, Norm,
Diag-OFT and BOFT (told apart by the rank of ``oft_blocks``), GLoRA, and
DyLoRA, which has no keys of its own (its files load as LoCon).
"""

from __future__ import annotations

import torch

from .base import LayerInfo, LycorisBaseModule, LycorisParametrization
from .boft import ButterflyOFTModule
from .diag_oft import DiagOFTModule
from .dylora import DyLoraModule
from .full import FullModule
from .glora import GLoRAModule
from .ia3 import IA3Module
from .locon import LoConModule
from .loha import LohaModule
from .lokr import LokrModule
from .norms import NormModule

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
    ``device`` (by default where the loaded tensors are); None for a class
    that cannot be made from a state dict (DyLoRA), as in the JAX package."""
    module = module_class.make_module_from_state_dict(lora_name, layer, *params)
    if module is None:
        return None
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
    "LycorisParametrization",
    "LoConModule",
    "LohaModule",
    "LokrModule",
    "IA3Module",
    "FullModule",
    "NormModule",
    "DiagOFTModule",
    "ButterflyOFTModule",
    "GLoRAModule",
    "DyLoraModule",
    "MODULE_LIST",
    "get_module",
    "make_module",
]
