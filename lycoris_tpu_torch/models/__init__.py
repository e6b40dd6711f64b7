"""Host models of the port: torch-layout layers, the SD UNet, the CLIP text
encoder, the Flux-style DiT and the Wan2.1 video DiT."""

from . import clip, dit, layers, unet, wan

__all__ = ["clip", "dit", "layers", "unet", "wan"]
