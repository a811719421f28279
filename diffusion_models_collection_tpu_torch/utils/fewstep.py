"""What the few-step trainers share: consistency training and distillation
(`utils/consistency_trainer.py`), progressive distillation
(`utils/distill_trainer.py`) and reflow (`utils/reflow_trainer.py`).

Each trains one student network with a second copy of it, the target
network theta^- or the EMA, which is lerped once per optimizer update
(`gated_ema_update`: never on an accumulation micro-step), in eval mode and
without gradients. A step is the trainer's loss, `backward`, and
`utils/trainer.py`'s `Optimizer` (clip by global norm 1.0, then AdamW, Adam,
Adafactor or Lion at the scheduled learning rate). The step's draws come
from the trainer's `torch.Generator` (`draw`), or are passed in, as the
parity tests pass the JAX package's; dropout masks come from torch's global
generator. Losses stay on the device during an epoch and are read once at
its end; a non-finite epoch raises. Checkpoints are the `.pth` schema of
the other trainers: the student as `model_state_dict`, the target or EMA as
`ema_model_state_dict` (`sample --use_ema` samples it), the config of the
result embedded. The JAX trainers' parallel layouts and orbax checkpoints
raise, as in `DiffusionTrainer`.
"""

from __future__ import annotations

import copy
import math
from pathlib import Path
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from . import checkpoint as ckpt_lib
from .ema import gated_ema_update
from .profiler import StepTimer
from .tracker import Tracker, build_tracker
from .trainer import (_not_ported, build_optimizer, progress_shown,
                      report_batch)


def load_teacher(config: dict):
    """(payload, embedded config) of `config['teacher_checkpoint']`, a
    `.pth` or a JAX `.ckpt`."""
    payload = ckpt_lib.load_checkpoint(config["teacher_checkpoint"])
    t_cfg = dict(payload.get("config") or {})
    if not t_cfg:
        raise ValueError("teacher checkpoint has no embedded config")
    return payload, t_cfg


def teacher_state(payload: dict) -> dict:
    """The teacher's weights: its EMA where the checkpoint has one."""
    state = payload.get("ema_model_state_dict")
    return state if state is not None else payload["model_state_dict"]


def frozen_copy(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of `model` in eval mode without gradients."""
    out = copy.deepcopy(model).eval()
    out.requires_grad_(False)
    return out


class FewStepTrainer:
    """The student, its target or EMA copy, the optimizer, the draws, the
    epoch loop and the checkpoints of a few-step trainer."""

    def __init__(self, config: dict, device,
                 generator: Optional[torch.Generator] = None,
                 tracker: Optional[Tracker] = None):
        for key, item in _not_ported(config):
            raise NotImplementedError(
                f"{key} is not ported yet (ROADMAP {item})")
        self.config = config
        self.device = torch.device(device)
        self.generator = (generator if generator is not None else
                          torch.Generator(device=self.device).manual_seed(
                              config.get("seed", 42)))
        self.epochs = int(config.get("epochs", 1))
        self.save_dir = Path(config.get("save_dir", "./checkpoints"))
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.accum = max(1, int(config.get("gradient_accumulation_steps", 1)))
        self.tracker = (tracker if tracker is not None
                        else build_tracker(config, str(self.save_dir)))
        self.step_timer = StepTimer()
        self.global_step = 0
        self.model = self.ema_model = self.optimizer = None
        self.conditional = False
        self.num_classes = None
        self.cfg_dropout_prob = 0.0

    # ------------------------------------------------------------- student
    def start(self, model: torch.nn.Module, batches_per_epoch: int,
              decay: Optional[float]) -> None:
        """Train `model` (moved to the device) with a fresh optimizer whose
        schedule counts the updates of `batches_per_epoch` batches, and,
        with `decay`, a target copy lerped at that decay (it starts at the
        student, the paper's initialisation)."""
        self.model = model.to(self.device).train()
        self.decay = decay
        self.ema_model = frozen_copy(self.model) if decay is not None else None
        self.optimizer = build_optimizer(
            self.config, self.model.parameters(),
            max(1, max(1, batches_per_epoch) // self.accum))

    def update(self, loss: torch.Tensor) -> torch.Tensor:
        """Backward, the optimizer call and the gated lerp; the loss,
        detached."""
        loss.backward()
        applied = self.optimizer.step()
        if self.ema_model is not None:
            gated_ema_update(applied, self.ema_model.parameters(),
                             self.model.parameters(), self.decay)
        self.global_step += 1
        return loss.detach()

    # --------------------------------------------------------------- draws
    def draw(self, shape: Sequence[int], n_pairs: int):
        """A step's draws for a batch of `shape`: the grid-pair index of
        each sample, the noise, the CFG dropout mask (None when labels are
        not dropped)."""
        gen, batch = self.generator, shape[0]
        idx = torch.randint(0, n_pairs, (batch,), generator=gen,
                            device=self.device)
        noise = torch.randn(tuple(shape), generator=gen, device=self.device)
        drop = None
        if (self.conditional and self.cfg_dropout_prob > 0
                and self.num_classes is not None):
            drop = torch.rand(batch, generator=gen,
                              device=self.device) < self.cfg_dropout_prob
        return idx, noise, drop

    def model_labels(self, labels: torch.Tensor,
                     drop: Optional[torch.Tensor]):
        """The labels a conditional model sees: +1, dropped to the null
        label 0 under `drop`; None for an unconditional one."""
        if not self.conditional:
            return None
        y = labels.to(torch.int64) + 1
        return y if drop is None else torch.where(drop, torch.zeros_like(y),
                                                  y)

    # ---------------------------------------------------------------- loop
    def loader_batches(self, loader, epoch: int) -> Iterable:
        """(images, labels) of the loader's epoch as device tensors; labels
        0 where the data has none."""
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        for images, labels in loader:
            yield (torch.from_numpy(np.asarray(images, np.float32)).to(
                       self.device),
                   torch.from_numpy(np.asarray(
                       labels if labels is not None else np.zeros(len(images)),
                       np.int64)).to(self.device))

    def run_epoch(self, epoch: int, batches: Iterable, total: int,
                  step: Callable, what: str) -> float:
        """`step(*batch)` over the batches; their mean loss, read once. A
        non-finite mean raises "non-finite `what`"."""
        shown = progress_shown(self.config)
        losses = []
        for batch in batches:
            with self.step_timer.step():
                losses.append(step(*batch))
            report_batch(shown, epoch, self.epochs, len(losses), total)
        avg = float(torch.stack(losses).mean()) if losses else float("nan")
        if not math.isfinite(avg):
            raise RuntimeError(f"non-finite {what}")
        return avg

    def save(self, names: Sequence[str], epoch: int, best_loss: float,
             config: dict) -> None:
        """The student, its target or EMA and the optimizer under each of
        `names` in `save_dir`, with `config` embedded."""
        for name in names:
            ckpt_lib.save_checkpoint(
                self.save_dir / name, self.model.state_dict(), config,
                ema_model_state_dict=(self.ema_model.state_dict()
                                      if self.ema_model is not None else None),
                epoch=epoch, best_loss=best_loss,
                optimizer_state_dict=self.optimizer.state_dict(),
                global_step=self.global_step)
