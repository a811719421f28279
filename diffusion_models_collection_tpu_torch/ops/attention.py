"""Multi-head attention for the denoiser backbones.

Counterpart of `diffusion_models_collection_tpu/ops/attention.py`. Every
call goes through the differentiable flash attention
(`ops/flash_attention.py`: the forward kernel, and the backward kernel under
autograd); the JAX package kept those kernels behind an opt-in flag, which
answered a TPU trade-off and has no counterpart here. Attention dropout
(the UNet has none) and proportional (ToMe) key sizes are not ported and
raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    *,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    key_sizes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over (B, L, D) tensors split into `num_heads` heads."""
    if dropout_rate > 0.0 and not deterministic:
        raise NotImplementedError(
            "attention dropout is not ported yet (ROADMAP queue 1 item 8)")
    if key_sizes is not None:
        raise NotImplementedError(
            "proportional attention (key_sizes, ToMe) is not ported yet "
            "(ROADMAP queue 1 item 11)")
    batch, length, dim = q.shape
    head_dim = dim // num_heads

    def split(x):
        x = x.reshape(batch, -1, num_heads, head_dim).transpose(1, 2)
        return x.reshape(batch * num_heads, -1, head_dim).contiguous()

    out = flash_attention(split(q), split(k), split(v))
    out = out.reshape(batch, num_heads, length, head_dim).transpose(1, 2)
    return out.reshape(batch, length, dim)
