"""Host models of the port: torch-layout layers and the SD UNet."""

from . import layers, unet

__all__ = ["layers", "unet"]
