"""Consistency training and consistency distillation.

Counterpart of `diffusion_models_collection_tpu/utils/consistency_trainer.py`
on one device (`utils/fewstep.py` has the loop, the optimizer, the target's
gated lerp and the checkpoints they share):

* `ConsistencyTrainingTrainer` (Song et al. 2023 Alg. 3, the iCT keys of
  Song & Dhariwal 2023): from scratch, no teacher; `train` routes a config
  of `diffusion_type: 'consistency'` here. A step: the pair index, the
  noise and the CFG drop mask from the trainer's generator (`draw`), the
  student's f at (z_t, t) with dropout, the target's at (z_next, t_next) in
  eval mode without gradients (two forwards, one backward). Keys:
  `consistency_grid_size` (50) or the staged `ct_grid_schedule` (the epochs
  split evenly over the stages, the rest to the last), `target_ema_decay`
  (0.95; 0.0 is iCT's target, the student itself), `consistency_loss`
  ('huber' or 'l2'), `huber_c` (0.03), `ct_weighting` ('uniform' or
  'inverse_gap'), `sigma_data`, `timestep_scaling`,
  `consistency_sample_steps` (2, embedded as the checkpoint's
  `num_inference_steps`), `cfg_dropout_prob` (0), `save_current_interval`.
  A resumed run continues at the checkpoint's epoch + 1 up to `epochs`.
* `ConsistencyDistillationTrainer` (Alg. 2): distills a VP checkpoint
  (`teacher_checkpoint`, `.pth` or JAX `.ckpt`, its EMA weights where it
  has them) into a consistency model through one teacher DDIM step a
  sample; with `distill_cfg_scale` w > 0 the teacher step is guided (one
  teacher call on the [cond; uncond] batch) and the guidance is baked into
  the student, whose checkpoint then says `cfg_scale: 1.0`. The student
  and the target start at the teacher. Three forwards a step.

Both write `consistency_model.pth` and `current_model.pth` with the config
of the result (`diffusion_type: 'consistency'`, `num_inference_steps`,
`sigma_data`, `timestep_scaling`), so `sample`, `evaluate` and `serve` run
them; `--use_ema` samples the target network, the paper's choice.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..diffusion import base as dbase
from ..diffusion.consistency import (VALID_WEIGHTINGS, cd_grids,
                                     consistency_distill_loss,
                                     consistency_training_loss)
from ..diffusion.schedule import NoiseSchedule
from . import checkpoint as ckpt_lib
from .fewstep import FewStepTrainer, frozen_copy, load_teacher, teacher_state
from .helpers import count_parameters


class ConsistencyTrainingTrainer(FewStepTrainer):
    """From-scratch consistency training; `train()` runs every grid stage,
    `train_step` is one step."""

    def __init__(self, model: torch.nn.Module, train_loader, config: dict,
                 device, generator: Optional[torch.Generator] = None,
                 resume_path: Optional[str] = None, tracker=None):
        cfg = dict(config)
        if cfg.get("super_resolution"):
            raise ValueError(
                "super_resolution is supported by the standard diffusion "
                "trainer (ddpm/flow/edm objectives), not consistency "
                "training")
        self.prediction_type = str(cfg.get("prediction_type", "eps"))
        zero_snr = bool(cfg.get("zero_terminal_snr", False))
        if zero_snr and self.prediction_type == "eps":
            raise ValueError(
                "zero_terminal_snr requires prediction_type 'v' or 'x0' "
                "(eps carries no signal at SNR 0)")
        grid_schedule = cfg.get("ct_grid_schedule")
        if grid_schedule is None:
            grid_schedule = [int(cfg.get("consistency_grid_size", 50))]
        self.grid_schedule = [int(n) for n in grid_schedule]
        if not self.grid_schedule or min(self.grid_schedule) < 2:
            raise ValueError("ct_grid_schedule needs grid sizes >= 2")
        if int(cfg.get("epochs", 1)) < len(self.grid_schedule):
            raise ValueError(
                "epochs must cover ct_grid_schedule: need at least one "
                f"epoch per grid stage ({len(self.grid_schedule)} stages)")
        self.weighting = str(cfg.get("ct_weighting", "uniform"))
        if self.weighting not in VALID_WEIGHTINGS:
            raise ValueError(f"Unknown ct_weighting: {self.weighting!r} "
                             "(expected 'uniform' or 'inverse_gap')")
        target_decay = float(cfg.get("target_ema_decay", 0.95))
        if not 0.0 <= target_decay < 1.0:
            raise ValueError("target_ema_decay must be in [0, 1)")
        super().__init__(cfg, device, generator, tracker)
        self.num_timesteps = int(cfg.get("num_timesteps", 1000))
        self.schedule = NoiseSchedule.create(
            self.num_timesteps, cfg.get("beta_start", 1e-4),
            cfg.get("beta_end", 0.02), cfg.get("beta_schedule", "linear"),
            zero_terminal_snr=zero_snr).to(self.device)
        self.sigma_data = float(cfg.get("sigma_data", 0.5))
        self.timestep_scaling = float(cfg.get("timestep_scaling", 10.0))
        self.loss_type = str(cfg.get("consistency_loss", "huber"))
        self.huber_c = float(cfg.get("huber_c", 0.03))
        self.sample_steps = int(cfg.get("consistency_sample_steps", 2))
        self.conditional = bool(cfg.get("conditional", False))
        self.num_classes = cfg.get("num_classes")
        self.cfg_dropout_prob = float(cfg.get("cfg_dropout_prob", 0.0))
        self.train_loader = train_loader
        self.start(model, len(train_loader), target_decay)
        self.say(f"Consistency training from scratch "
                 f"({count_parameters(self.model):,} params): grids "
                 f"{self.grid_schedule}, mu={target_decay}, {self.weighting} "
                 "weighting")
        self.set_grid(self.grid_schedule[0])
        self.start_epoch = 0
        if resume_path:
            self.resume(resume_path)

    def resume(self, path) -> None:
        """Student, target, optimizer state (a torch optimizer's) and the
        epoch reached, from a consistency checkpoint."""
        payload = ckpt_lib.load_checkpoint(path)
        r_cfg = payload.get("config") or {}
        if str(r_cfg.get("diffusion_type", "")).lower() != "consistency":
            raise ValueError(
                "resume_path is not a consistency checkpoint "
                f"(diffusion_type={r_cfg.get('diffusion_type')!r})")
        self.model.load_state_dict(payload["model_state_dict"])
        ema = payload.get("ema_model_state_dict")
        self.ema_model.load_state_dict(
            ema if ema is not None else payload["model_state_dict"])
        opt_state = payload.get("optimizer_state_dict")
        if isinstance(opt_state, dict) and "param_groups" in opt_state:
            self.optimizer.load_state_dict(opt_state)
        self.global_step = int(payload.get("global_step", 0))
        self.optimizer.count = self.global_step // self.accum
        self.start_epoch = int(payload.get("epoch", 0))
        self.say(f"Resuming consistency training from {path} "
                 f"(epoch {self.start_epoch})")

    def set_grid(self, grid_size: int) -> None:
        """Train on the adjacent pairs of the `grid_size`-point grid."""
        self.grid_size = grid_size
        self.grid = [g.to(self.device)
                     for g in cd_grids(self.num_timesteps, grid_size)]

    def grid_for_epoch(self):
        """The grid size of each epoch (1-indexed order): the epochs split
        evenly over the stages, the remainder to the last."""
        n_stages = len(self.grid_schedule)
        per_stage = self.epochs // n_stages
        grids = []
        for stage, g in enumerate(self.grid_schedule):
            n = (per_stage if stage < n_stages - 1
                 else self.epochs - per_stage * (n_stages - 1))
            grids.extend([g] * n)
        return grids

    def pair_of(self, model):
        return dbase.wrap_model_as_eps_x0(self.schedule, model,
                                          self.prediction_type)

    def train_step(self, images: torch.Tensor, labels: torch.Tensor,
                   idx: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step on a device batch: images (B, H, W, C) in [-1, 1],
        labels (B,) unshifted; `idx` (the grid pair of each sample),
        `noise` and `drop` are drawn unless given. Returns the loss, on the
        device."""
        self.model.train()
        if idx is None:
            idx, noise, drop = self.draw(images.shape, len(self.grid[0]))
        t, t_next = self.grid[0][idx], self.grid[1][idx]
        loss = consistency_training_loss(
            self.schedule, self.pair_of(self.train_model),
            self.pair_of(self.ema_model), images, noise, t, t_next,
            self.model_labels(labels, drop), sigma_data=self.sigma_data,
            timestep_scaling=self.timestep_scaling, loss_type=self.loss_type,
            huber_c=self.huber_c, weighting=self.weighting)
        return self.update(loss)

    def out_config(self) -> dict:
        return dict(self.config, diffusion_type="consistency",
                    num_inference_steps=self.sample_steps,
                    sigma_data=self.sigma_data,
                    timestep_scaling=self.timestep_scaling)

    def train(self):
        """Every grid stage from the epoch after `start_epoch`; the
        checkpoints every `save_current_interval` epochs (1) and at the
        last. Returns the trainer."""
        best = float("inf")
        save_every = int(self.config.get("save_current_interval", 1) or 1)
        for epoch, grid_size in enumerate(self.grid_for_epoch(), start=1):
            if epoch <= self.start_epoch:
                continue  # resume: stage allocation consumed in order
            if grid_size != self.grid_size:
                self.set_grid(grid_size)
            start = time.time()
            avg = self.run_epoch(
                epoch, self.loader_batches(self.train_loader, epoch),
                len(self.train_loader), self.train_step,
                f"consistency-training loss at epoch {epoch}")
            best = min(best, avg)
            self.say(f"[ct] epoch {epoch}/{self.epochs} (grid {grid_size}) - "
                     f"loss {avg:.5f} - {time.time() - start:.1f}s")
            self.tracker.log({"ct/loss": avg, "ct/grid_size": grid_size},
                             step=epoch)
            if epoch % save_every == 0 or epoch == self.epochs:
                self.save(["consistency_model.pth", "current_model.pth"],
                          epoch, best, self.out_config())
        self.say("Consistency training completed!")
        self.tracker.finish()
        return self


def vp_teacher(config: dict, method: str):
    """(payload, config) of a VP teacher for `method` (its name in the
    errors), with the JAX trainers' checks."""
    payload, t_cfg = load_teacher(config)
    dtype_key = str(t_cfg.get("diffusion_type", "ddpm")).lower()
    if dtype_key not in ("ddpm", "diffusion"):
        raise ValueError(
            f"{method} operates on the VP (DDPM/DDIM) family; teacher has "
            f"diffusion_type={dtype_key!r}")
    if t_cfg.get("super_resolution"):
        raise ValueError(
            f"{method} does not support super-resolution teachers (the "
            "student would need the LR conditioning threaded through every "
            "pair)")
    return payload, t_cfg


class ConsistencyDistillationTrainer(FewStepTrainer):
    """Consistency distillation of a VP checkpoint; `distill()` runs the
    epochs, `train_step` is one step."""

    def __init__(self, train_loader, config: dict, device,
                 generator: Optional[torch.Generator] = None, tracker=None):
        from ..factory import get_diffusion, get_model

        cfg = config
        payload, t_cfg = vp_teacher(cfg, "consistency distillation")
        self.teacher_config = t_cfg
        distill_cfg_scale = float(cfg.get("distill_cfg_scale", 0.0))
        conditional = bool(t_cfg.get("conditional", False))
        if distill_cfg_scale > 0.0 and not conditional:
            raise ValueError(
                "distill_cfg_scale needs a conditional teacher (guided "
                "distillation guides on class labels)")
        super().__init__(cfg, device, generator, tracker)
        self.grid_size = int(cfg.get("consistency_grid_size", 50))
        self.distill_cfg_scale = distill_cfg_scale
        self.conditional = conditional
        self.num_classes = t_cfg.get("num_classes")
        self.cfg_dropout_prob = float(cfg.get(
            "cfg_dropout_prob", t_cfg.get("cfg_dropout_prob", 0.0)))
        self.sigma_data = float(cfg.get("sigma_data", 0.5))
        self.timestep_scaling = float(cfg.get("timestep_scaling", 10.0))
        self.loss_type = str(cfg.get("consistency_loss", "huber"))
        self.huber_c = float(cfg.get("huber_c", 0.03))
        self.sample_steps = int(cfg.get("consistency_sample_steps", 2))
        diffusion = get_diffusion(t_cfg)  # the schedule, prediction_type
        self.prediction_type = diffusion.prediction_type
        self.schedule = diffusion.schedule_on(self.device)
        self.grid = [g.to(self.device)
                     for g in cd_grids(diffusion.num_timesteps,
                                       self.grid_size)]
        self.train_loader = train_loader
        student = get_model(t_cfg)
        student.load_state_dict(teacher_state(payload), strict=True)
        self.teacher = frozen_copy(student).to(self.device)
        self.start(student, len(train_loader),
                   float(cfg.get("target_ema_decay", 0.95)))
        self.say(f"Consistency-distilling {cfg['teacher_checkpoint']} "
                 f"({count_parameters(self.model):,} params): grid "
                 f"{self.grid_size}, w={self.distill_cfg_scale}")

    def pair_of(self, model):
        return dbase.wrap_model_as_eps_x0(self.schedule, model,
                                          self.prediction_type)

    def train_step(self, images: torch.Tensor, labels: torch.Tensor,
                   idx: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step (see `ConsistencyTrainingTrainer.train_step`): z_t from
        the batch, the teacher's DDIM step, the target's and the student's
        f."""
        self.model.train()
        if idx is None:
            idx, noise, drop = self.draw(images.shape, len(self.grid[0]))
        t, t_next = self.grid[0][idx], self.grid[1][idx]
        z = dbase.q_sample(self.schedule, images, t, noise)
        loss = consistency_distill_loss(
            self.schedule, self.pair_of(self.train_model),
            self.pair_of(self.ema_model), self.pair_of(self.teacher), z, t,
            t_next, self.model_labels(labels, drop),
            sigma_data=self.sigma_data,
            timestep_scaling=self.timestep_scaling,
            distill_cfg_scale=self.distill_cfg_scale,
            loss_type=self.loss_type, huber_c=self.huber_c)
        return self.update(loss)

    def out_config(self) -> dict:
        out = dict(self.teacher_config, diffusion_type="consistency",
                   num_inference_steps=self.sample_steps,
                   sigma_data=self.sigma_data,
                   timestep_scaling=self.timestep_scaling)
        if self.distill_cfg_scale > 0.0:
            # the guidance is baked in: sample at the conditional scale-1
            # limit (0 would drop the requested labels)
            out["distilled_cfg_scale"] = self.distill_cfg_scale
            out["cfg_scale"] = 1.0
        return out

    def distill(self):
        """The epochs, then `consistency_model.pth` and
        `current_model.pth`. Returns the trainer."""
        best = float("inf")
        for epoch in range(1, self.epochs + 1):
            start = time.time()
            avg = self.run_epoch(
                epoch, self.loader_batches(self.train_loader, epoch),
                len(self.train_loader), self.train_step,
                f"consistency loss at epoch {epoch}")
            best = min(best, avg)
            self.say(f"[consistency] epoch {epoch}/{self.epochs} - loss "
                     f"{avg:.5f} - {time.time() - start:.1f}s")
            self.tracker.log({"consistency/loss": avg}, step=epoch)
        self.save(["consistency_model.pth", "current_model.pth"],
                  self.epochs, best, self.out_config())
        self.say("Consistency distillation completed!")
        self.tracker.finish()
        return self
