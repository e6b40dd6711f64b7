"""Host models of the port: torch-layout layers, the SD UNet and the CLIP text encoder."""

from . import clip, layers, unet

__all__ = ["clip", "layers", "unet"]
