"""Shared building blocks of the denoiser backbones.

Counterpart of `diffusion_models_collection_tpu/models/layers.py`: the
UNet's time embedding, and the patch-token scaffolding that DiT and DiM
share (timestep embedder, patch embedding, `unpatchify`, adaLN modulation).
Module and parameter names follow the PyTorch reference, so the reference's
`state_dict` keys load with `strict=True`. Images are NHWC, tokens (B, L, D).
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


def sinusoidal_time_embedding_dit(t: torch.Tensor, dim: int,
                                  max_period: float = 10000.0) -> torch.Tensor:
    """DiT-style sinusoidal embedding: freqs exp(-ln(max_period) *
    arange(half) / half), concat [cos, sin], a zero column for odd dim.
    float32 trig whatever the model's compute type."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    """(B,) timesteps -> sinusoidal features (256) -> Linear -> SiLU ->
    Linear (keys `mlp.0`, `mlp.2`), xavier weights and zero biases as the
    JAX package."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp = nn.Sequential(
            nn.Linear(frequency_embedding_size, hidden_size), nn.SiLU(),
            nn.Linear(hidden_size, hidden_size))
        for layer in (self.mlp[0], self.mlp[2]):
            xavier_linear_(layer)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.mlp(sinusoidal_time_embedding_dit(
            t, self.frequency_embedding_size))


class LabelTable(nn.Module):
    """Holds the `LabelEmbedder` under the reference's DiT/DiM name, so its
    key is `y_embedder.embedding_table.weight`."""

    def __init__(self, num_classes: int, hidden_size: int):
        super().__init__()
        self.embedding_table = LabelEmbedder(num_classes, hidden_size)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return self.embedding_table(y)


class PatchEmbed(nn.Module):
    """NHWC image -> (B, (H/p) (W/p), embed_dim) tokens in row-major patch
    order, through a stride-p Conv2d (`proj`, torch's default init)."""

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size,
                              stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.proj(x.to(torch.float32).permute(0, 3, 1, 2))
        return h.flatten(2).transpose(1, 2)


def unpatchify(x: torch.Tensor, h_tokens: int, w_tokens: int,
               patch_size: int, channels: int) -> torch.Tensor:
    """Tokens (B, h w, p p C) -> NHWC image (B, h p, w p, C)."""
    p = patch_size
    x = x.reshape(x.shape[0], h_tokens, w_tokens, p, p, channels)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(x.shape[0], h_tokens * p, w_tokens * p, channels)


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation x (1 + scale) + shift, (B, D) over the tokens."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class AdaLNModulation(nn.Sequential):
    """SiLU -> Linear(n_chunks * dim), zero-initialised (keys
    `adaLN_modulation.1.*`), split into n_chunks (B, dim) tensors."""

    def __init__(self, dim: int, n_chunks: int):
        super().__init__(nn.SiLU(), nn.Linear(dim, n_chunks * dim))
        self.n_chunks = n_chunks
        nn.init.zeros_(self[1].weight)
        nn.init.zeros_(self[1].bias)

    def forward(self, c: torch.Tensor):
        return super().forward(c).chunk(self.n_chunks, dim=-1)


def xavier_linear_(layer: nn.Linear) -> nn.Linear:
    """Xavier-uniform weight and zero bias (JAX `init.xavier_uniform`,
    `init.zeros`)."""
    nn.init.xavier_uniform_(layer.weight)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)
    return layer
