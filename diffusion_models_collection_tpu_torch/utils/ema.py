"""Exponential moving average of parameters.

Counterpart of `diffusion_models_collection_tpu/utils/ema.py`: ema <-
ema * decay + params * (1 - decay), in place over the parameter lists with
one fused launch per operation on the card. With gradient accumulation the
micro-steps that apply no update leave the EMA alone (`gated_ema_update`,
the JAX trainers' `has_updated` gate), so it lerps once per update. Under
FSDP the EMA and the parameters are sharded alike and the lerp runs on each
rank's shards.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..parallel.fsdp import local


@torch.no_grad()
def ema_update(ema_params: Sequence[torch.Tensor],
               params: Sequence[torch.Tensor], decay: float) -> None:
    """ema <- ema * decay + params * (1 - decay), in place."""
    ema_params = [local(p) for p in ema_params]
    params = [local(p) for p in params]
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, params, alpha=1.0 - decay)


def gated_ema_update(applied: bool, ema_params: Sequence[torch.Tensor],
                     params: Sequence[torch.Tensor], decay: float) -> None:
    """`ema_update` after an optimizer call that `applied` an update
    (`Optimizer.step`'s result); nothing on an accumulation micro-step."""
    if applied:
        ema_update(ema_params, params, decay)
