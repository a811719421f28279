"""Denoiser backbones (UNet so far)."""

from .layers import LabelEmbedder, UNetTimeEmbed, sinusoidal_time_embedding_unet
from .unet import UNet

__all__ = ["LabelEmbedder", "UNet", "UNetTimeEmbed",
           "sinusoidal_time_embedding_unet"]
