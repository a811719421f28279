"""DiT pieces that DiM shares.

Counterpart of `diffusion_models_collection_tpu/models/dit.py`: so far only
`Mlp`, the feed-forward of DiT's and DiM's blocks. The DiT model itself
(`SelfAttention`, `DiTBlock`, `FinalLayer`, `DiT`) is ROADMAP queue 1 item
8.
"""

from __future__ import annotations

from torch import nn

from .layers import xavier_linear_


class Mlp(nn.Sequential):
    """Linear -> GELU (exact erf) -> Dropout -> Linear -> Dropout (keys
    `0` and `3`), xavier weights and zero biases as the JAX package."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dropout: float = 0.1):
        super().__init__(
            xavier_linear_(nn.Linear(in_dim, hidden_dim)),
            nn.GELU(approximate="none"),
            nn.Dropout(dropout),
            xavier_linear_(nn.Linear(hidden_dim, out_dim)),
            nn.Dropout(dropout),
        )
