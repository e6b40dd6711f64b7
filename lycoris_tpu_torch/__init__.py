"""lycoris_tpu_torch -- the PyTorch/CUDA port of lycoris_tpu.

The port so far: the SD1.5/SDXL UNet (:mod:`.models.unet`, with whole-block
checkpointing), the adapters of all ten algorithms (:mod:`.modules`:
LoRA/LoCon, the default, LoHa and LoKr, with DoRA; Diag-OFT, BOFT, (IA)^3,
GLoRA, DyLoRA, Full, and Norm for ``train_norm``; the parametrize API)
targeted and applied by :class:`LycorisNetwork`, which reads and writes adapter files
(``.safetensors`` by :mod:`.utils.safetensors_io`, or ``torch.save``),
DDIM sampling with CFG (:mod:`.sampler`), and adapter training by
:class:`DiffusionTrainer` (:mod:`.trainer`: the factored merged backward of
:mod:`.functional.merged` or premerge, max-norm, checkpoint resume). Flash attention, LayerNorm, the LoHa delta
weight and GroupNorm(+SiLU) run hand-written CUDA kernels on the card,
forward and backward, and so does the GEGLU backward (:mod:`.ops`), beside
the opt-in split LoHa backward and the fused LoRA matmul
(:func:`.ops.lora_fused.fused_lora_matmul`); on the CPU each runs its plain
PyTorch version. The kohya front end (:mod:`.kohya`) targets the UNet and
the CLIP text encoders (:mod:`.models.clip`), and ``python -m
lycoris_tpu_torch.train`` trains from the repo's TOML configs. The tools
(:mod:`.utils`: SVD extract, merge, bundle, HCP convert, int8 quantized
bases) run as ``python -m lycoris_tpu_torch.tools.<name>``. The package
never imports JAX.
"""

__version__ = "0.1.0"

from . import functional, kohya, modules, utils
from .graph import ModelGraph
from .logging import logger
from .modules import (ButterflyOFTModule, DiagOFTModule, DyLoraModule, FullModule, GLoRAModule,
                      IA3Module, LoConModule, LohaModule, LokrModule, NormModule, make_module)
from .trainer import DiffusionTrainer
from .wrapper import LycorisNetwork, create_lycoris, create_lycoris_from_weights

__all__ = [
    "functional",
    "modules",
    "utils",
    "kohya",
    "logger",
    "ModelGraph",
    "LycorisNetwork",
    "create_lycoris",
    "create_lycoris_from_weights",
    "DiffusionTrainer",
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
    "make_module",
    "__version__",
]
