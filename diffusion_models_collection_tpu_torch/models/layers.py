"""Shared building blocks of the denoiser backbones.

Counterpart of `diffusion_models_collection_tpu/models/layers.py` (the UNet
pieces). Module and parameter names follow the PyTorch reference, so the
reference's `state_dict` keys load with `strict=True`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def sinusoidal_time_embedding_unet(t: torch.Tensor, dim: int) -> torch.Tensor:
    """UNet-style sinusoidal embedding: freqs exp(-arange(half) *
    ln(10000) / (half - 1)), concat [sin, cos]. The trig runs in float32
    whatever the model's compute type: t spans [0, 1000)."""
    half = dim // 2
    scale = math.log(10000.0) / (half - 1)
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device) * -scale)
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class SinusoidalTimeEmbedding(nn.Module):
    """(B,) timesteps -> (B, dim) sinusoidal features; no parameters."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return sinusoidal_time_embedding_unet(t, self.dim)


class UNetTimeEmbed(nn.Sequential):
    """Sinusoidal features -> Linear -> SiLU -> Linear, to 4 * model_channels
    (the reference's `time_embed` Sequential, so its keys are
    `time_embed.1.*` and `time_embed.3.*`)."""

    def __init__(self, model_channels: int):
        dim = model_channels * 4
        super().__init__(
            SinusoidalTimeEmbedding(model_channels),
            nn.Linear(model_channels, dim),
            nn.SiLU(),
            nn.Linear(dim, dim),
        )


class LabelEmbedder(nn.Module):
    """Class-label table with the CFG null label at row 0.

    Labels arrive shifted by +1; 0 is the unconditional label. Row 0 is zero
    at init and the lookup output is masked where y == 0, as the JAX package
    does (`models/layers.py:127-129`): torch's `padding_idx` only freezes
    the row's gradient, so it agrees only while the row stays zero.
    """

    def __init__(self, num_classes: int, hidden_size: int):
        super().__init__()
        self.num_classes = num_classes
        self.weight = nn.Parameter(torch.randn(num_classes + 1, hidden_size))
        with torch.no_grad():
            self.weight[0].zero_()

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        y = y.clamp(0, self.num_classes)
        emb = F.embedding(y, self.weight)
        return emb * (y != 0).to(emb.dtype)[:, None]
