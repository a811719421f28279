"""Denoiser backbones (the UNet, DiT and DiM) and the latent-diffusion
autoencoder (the KL-VAE)."""

from .dim import DiM
from .dit import DiT
from .layers import LabelEmbedder, UNetTimeEmbed, sinusoidal_time_embedding_unet
from .unet import UNet
from .vae import VAE

__all__ = ["DiM", "DiT", "LabelEmbedder", "UNet", "UNetTimeEmbed",
           "sinusoidal_time_embedding_unet", "VAE"]
