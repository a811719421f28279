"""Progressive distillation (Salimans & Ho 2022).

Counterpart of `diffusion_models_collection_tpu/utils/distill_trainer.py` on
one device (`utils/fewstep.py` has what the few-step trainers share). From
a trained VP checkpoint, the teacher (`teacher_checkpoint`, `.pth` or JAX
`.ckpt`, its EMA weights where it has them), each stage teaches a student,
started at the teacher, to match two teacher DDIM steps with one of its own
on an N-step grid (`diffusion/distill.py`), then promotes the student (its
EMA with `use_ema`, the default) to teacher and halves N: `distill_steps`
(8) is the first student's count, `distill_stages` (1) the number of
stages, `epochs` each stage's epochs, `ema_decay` (0.999). A step: the grid
index, the noise and the CFG drop mask from the trainer's generator
(`draw`), two teacher forwards without gradients, the student's forward
with dropout and backward. Each stage writes `distilled_{N:04d}step.pth`
and `current_model.pth`, the teacher's config with `num_inference_steps: N`
and `distilled_steps: N`, which `sample --sampling_method ddim
--num_inference_steps N` runs.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..diffusion import base as dbase
from ..diffusion.distill import (distill_grids, student_distill_loss,
                                 two_step_teacher_target)
from .consistency_trainer import vp_teacher
from .fewstep import FewStepTrainer, frozen_copy, teacher_state
from .helpers import count_parameters


class DistillationTrainer(FewStepTrainer):
    """Progressive distillation; `distill()` runs the stages, `start_stage`
    sets one up and `train_step` is one step of it."""

    def __init__(self, train_loader, config: dict, device,
                 generator: Optional[torch.Generator] = None, tracker=None):
        from ..factory import get_diffusion, get_model

        cfg = config
        payload, t_cfg = vp_teacher(cfg, "progressive distillation")
        steps0 = int(cfg.get("distill_steps", 8))
        stages = int(cfg.get("distill_stages", 1))
        if steps0 < 2 or steps0 % 2:
            raise ValueError("distill_steps must be an even integer >= 2")
        if stages < 1 or steps0 % (2 ** (stages - 1)):
            raise ValueError(f"distill_steps={steps0} cannot halve "
                             f"{stages - 1} times")
        super().__init__(cfg, device, generator, tracker)
        self.teacher_config = t_cfg
        self.steps0, self.stages = steps0, stages
        self.use_ema = bool(cfg.get("use_ema", True))
        self.ema_decay = float(cfg.get("ema_decay", 0.999))
        self.conditional = bool(t_cfg.get("conditional", False))
        self.num_classes = t_cfg.get("num_classes")
        self.cfg_dropout_prob = float(cfg.get(
            "cfg_dropout_prob", t_cfg.get("cfg_dropout_prob", 0.0)))
        self.diffusion = get_diffusion(t_cfg)  # the schedule, prediction_type
        self.schedule = self.diffusion.schedule_on(self.device)
        self.train_loader = train_loader
        self.student = get_model(t_cfg)
        self.student.load_state_dict(teacher_state(payload), strict=True)
        print(f"Distilling {cfg['teacher_checkpoint']} "
              f"({count_parameters(self.student):,} params): {steps0} "
              f"steps, {stages} stage(s)")

    def pair_of(self, model):
        return dbase.wrap_model_as_eps_x0(self.schedule, model,
                                          self.diffusion.prediction_type)

    def start_stage(self, steps: int) -> None:
        """A stage of an `steps`-step student: the current student becomes
        the frozen teacher and the new student's start, with a fresh
        optimizer and EMA."""
        self.grids = [g.to(self.device) for g in distill_grids(
            self.diffusion.num_timesteps, steps)]
        self.teacher = frozen_copy(self.student).to(self.device)
        self.start(self.student, len(self.train_loader),
                   self.ema_decay if self.use_ema else None)

    def train_step(self, images: torch.Tensor, labels: torch.Tensor,
                   idx: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step on a device batch: images (B, H, W, C) in [-1, 1],
        labels (B,) unshifted; `idx` (the grid point of each sample),
        `noise` and `drop` are drawn unless given. Returns the loss, on the
        device."""
        self.model.train()
        if idx is None:
            idx, noise, drop = self.draw(images.shape, len(self.grids[0]))
        t, t_mid, t_next = (g[idx] for g in self.grids)
        z = dbase.q_sample(self.schedule, images, t, noise)
        y = self.model_labels(labels, drop)
        x0_target = two_step_teacher_target(
            self.schedule, self.pair_of(self.teacher), z, t, t_mid, t_next, y)
        loss = student_distill_loss(self.schedule, self.pair_of(self.model),
                                    x0_target, z, t, y)
        return self.update(loss)

    def distill(self):
        """Every stage; returns the trainer, whose `student` is the last
        stage's result."""
        steps = self.steps0
        for stage in range(self.stages):
            self.start_stage(steps)
            best = float("inf")
            for epoch in range(1, self.epochs + 1):
                start = time.time()
                avg = self.run_epoch(
                    epoch, self.loader_batches(self.train_loader, epoch),
                    len(self.train_loader), self.train_step,
                    f"distillation loss at stage {stage} epoch {epoch}")
                best = min(best, avg)
                print(f"[stage {stage + 1}/{self.stages}, {steps} steps] "
                      f"epoch {epoch}/{self.epochs} - loss {avg:.5f} - "
                      f"{time.time() - start:.1f}s")
                self.tracker.log({f"distill/{steps}step/loss": avg},
                                 step=epoch)
            self.save([f"distilled_{steps:04d}step.pth", "current_model.pth"],
                      self.epochs, best,
                      dict(self.teacher_config, num_inference_steps=steps,
                           distilled_steps=steps))
            # promote: the (EMA) student teaches the next stage
            if self.ema_model is not None:
                self.student.load_state_dict(self.ema_model.state_dict())
            steps //= 2
        print("Distillation completed!")
        self.tracker.finish()
        return self
