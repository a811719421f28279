"""Exponential moving average of parameters.

Counterpart of `diffusion_models_collection_tpu/utils/ema.py`: ema <-
ema * decay + params * (1 - decay), in place over the parameter lists with
one fused launch per operation on the card. The trainer calls it once per
optimizer update, so with gradient accumulation the micro-steps that apply
no update leave the EMA alone (the JAX trainer's `has_updated` gate).
"""

from __future__ import annotations

from typing import Sequence

import torch


@torch.no_grad()
def ema_update(ema_params: Sequence[torch.Tensor],
               params: Sequence[torch.Tensor], decay: float) -> None:
    """ema <- ema * decay + params * (1 - decay), in place."""
    ema_params, params = list(ema_params), list(params)
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, params, alpha=1.0 - decay)
