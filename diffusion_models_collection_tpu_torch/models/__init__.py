"""Denoiser backbones: the UNet and DiM."""

from .dim import DiM
from .layers import LabelEmbedder, UNetTimeEmbed, sinusoidal_time_embedding_unet
from .unet import UNet

__all__ = ["DiM", "LabelEmbedder", "UNet", "UNetTimeEmbed",
           "sinusoidal_time_embedding_unet"]
