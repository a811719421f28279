"""Denoiser backbones (the UNet, DiT and DiM), the latent-diffusion
autoencoder (the KL-VAE) and the noise-conditional classifier of classifier
guidance."""

from .classifier import NoisyClassifier
from .dim import DiM
from .dit import DiT
from .layers import LabelEmbedder, UNetTimeEmbed, sinusoidal_time_embedding_unet
from .unet import UNet
from .vae import VAE

__all__ = ["DiM", "DiT", "LabelEmbedder", "NoisyClassifier", "UNet",
           "UNetTimeEmbed", "sinusoidal_time_embedding_unet", "VAE"]
