"""Host models of the port: torch-layout layers, the SD UNet, the CLIP text
encoder and the Flux-style DiT."""

from . import clip, dit, layers, unet

__all__ = ["clip", "dit", "layers", "unet"]
