"""Learning-rate schedules as functions of the optimizer's update count.

Counterpart of `diffusion_models_collection_tpu/utils/lr_schedules.py`: the
reference steps a torch scheduler once per epoch; here, as in the JAX
package, each schedule is a function of the epoch `count //
updates_per_epoch`, evaluated in float32, so resuming needs no scheduler
state. The trainer sets the optimizer's learning rate from it before each
update, at the count of updates made so far, as Optax does.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

ETA_MIN = 1e-6

EpochFn = Callable[[torch.Tensor], torch.Tensor]


def cosine_epoch_lr(base_lr: float, t_max: int) -> EpochFn:
    """torch CosineAnnealingLR(T_max, eta_min=1e-6) at epoch e."""

    def fn(epoch):
        return ETA_MIN + (base_lr - ETA_MIN) * (
            1 + torch.cos(math.pi * torch.clamp(epoch, max=t_max) / t_max)) / 2

    return fn


def linear_epoch_lr(base_lr: float, total_iters: int, start_factor=1.0,
                    end_factor=0.1) -> EpochFn:
    """torch LinearLR: the factor goes from start to end over total_iters."""

    def fn(epoch):
        frac = torch.clamp(epoch / total_iters, 0.0, 1.0)
        return base_lr * (start_factor + (end_factor - start_factor) * frac)

    return fn


def step_epoch_lr(base_lr: float, step_size: int, gamma: float) -> EpochFn:
    """torch StepLR: lr * gamma^(epoch // step_size)."""

    def fn(epoch):
        return base_lr * gamma ** torch.floor(epoch / step_size)

    return fn


def warmup_cosine_epoch_lr(base_lr: float, epochs: int, warmup_epochs: int,
                           warmup_start_factor: float) -> EpochFn:
    """torch SequentialLR(LinearLR warm-up, CosineAnnealingLR)."""
    cosine = cosine_epoch_lr(base_lr, max(1, epochs - warmup_epochs))
    if warmup_epochs <= 0:
        return cosine
    warm = linear_epoch_lr(base_lr, max(1, warmup_epochs),
                           warmup_start_factor, 1.0)

    def fn(epoch):
        return torch.where(epoch < warmup_epochs, warm(epoch),
                           cosine(epoch - warmup_epochs))

    return fn


def build_lr_schedule(config: dict,
                      updates_per_epoch: int) -> Callable[[int], float]:
    """The learning rate as a function of the update count: constant when
    `use_scheduler` is false, else cosine, linear, step or warmup_cosine
    over epochs."""
    base_lr = float(config["learning_rate"])
    upe = max(1, int(updates_per_epoch))
    if not config.get("use_scheduler", False):
        constant = float(torch.tensor(base_lr, dtype=torch.float32))
        return lambda count: constant

    stype = config.get("scheduler_type", "cosine").lower()
    epochs = int(config["epochs"])
    if stype == "cosine":
        epoch_fn = cosine_epoch_lr(base_lr, epochs)
    elif stype == "linear":
        epoch_fn = linear_epoch_lr(base_lr, epochs)
    elif stype == "step":
        epoch_fn = step_epoch_lr(base_lr, int(config.get("step_size", 50)),
                                 float(config.get("gamma", 0.5)))
    elif stype == "warmup_cosine":
        epoch_fn = warmup_cosine_epoch_lr(
            base_lr, epochs, max(0, int(config.get("warmup_epochs", 0))),
            float(config.get("warmup_start_factor", 0.01)))
    else:
        raise ValueError(f"Unknown scheduler: {stype}")

    def schedule(count: int) -> float:
        epoch = torch.tensor(int(count) // upe, dtype=torch.float32)
        return float(epoch_fn(epoch).to(torch.float32))

    return schedule
