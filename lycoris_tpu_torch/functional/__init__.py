"""Stateless math of the port: shared ops (:mod:`.general`), LoRA/LoCon
(:mod:`.locon`), LoKr (:mod:`.lokr`), LoHa (:mod:`.loha`), Diag-OFT
(:mod:`.diag_oft`), BOFT (:mod:`.boft`) and the factored merged backward
(:mod:`.merged`), with the shared helpers of :mod:`.general` re-exported as
``lycoris_tpu/functional/__init__.py`` does."""

from . import boft, diag_oft, general, locon, loha, lokr, merged
from .general import (FUNC_LIST, apply_dora_scale, convnd, factorization, linear, op_by_ndim,
                      power2factorization, rebuild_tucker, tucker_weight, tucker_weight_from_conv)

__all__ = [
    "general",
    "locon",
    "loha",
    "lokr",
    "diag_oft",
    "boft",
    "merged",
    "FUNC_LIST",
    "factorization",
    "power2factorization",
    "rebuild_tucker",
    "tucker_weight",
    "tucker_weight_from_conv",
    "apply_dora_scale",
    "op_by_ndim",
    "linear",
    "convnd",
]
