"""Reflow, the k-th rectification of a flow-matching model (Liu et al.
2023).

Counterpart of `diffusion_models_collection_tpu/utils/reflow_trainer.py` on
one device (`utils/fewstep.py` has what the few-step trainers share). A
round synthesizes `reflow_pairs` couplings (x_hat, z) from the teacher
(`teacher_checkpoint`, a flow-matching `.pth` or JAX `.ckpt`, its EMA
weights where it has them): z and the labels (+1-shifted, uniform over the
classes) from the trainer's generator (`draw_pairs`), x_hat the teacher's
own solver from z at `teacher_sample_steps` steps (the teacher config's
count by default), with CFG at `reflow_cfg_scale` when it is > 0, in
batches of `pair_batch_size` (the config's `batch_size`, else 64; the pair
count rounds up to a multiple of it). The pairs stay on the device. Then
the student, started at the teacher, fits the straight path between them:
x_tau = (1 - tau) x_hat + tau z, target z - x_hat, t uniform from the
generator (or passed in), each epoch in an order drawn from it. The round
writes `reflow_round{k}.pth` and `current_model.pth`, the teacher's config
with `reflow_rounds_done` one higher (a flow-matching checkpoint that
`sample` runs at any step count), and its student (its EMA with `use_ema`,
the default; `ema_decay` 0.999) is the next round's teacher. No dataset is
read. The JAX trainer reads `teacher_sample_steps` but samples at the
teacher config's count; the port samples at the count the key names.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import torch

from ..diffusion.base import diffusion_loss
from ..diffusion.flow_matching import interpolate
from .fewstep import FewStepTrainer, load_teacher, teacher_state
from .helpers import count_parameters, resolve_image_size


class ReflowTrainer(FewStepTrainer):
    """Reflow of a flow-matching checkpoint; `reflow()` runs the rounds,
    `synthesize_pairs` and `train_step` are a round's parts."""

    def __init__(self, config: dict, device,
                 generator: Optional[torch.Generator] = None, tracker=None):
        from ..factory import get_diffusion, get_model

        cfg = config
        payload, t_cfg = load_teacher(cfg)
        dtype_key = str(t_cfg.get("diffusion_type", "ddpm")).lower()
        if dtype_key not in ("flow", "flow_matching", "rectified_flow"):
            raise ValueError(
                "reflow rectifies FLOW-MATCHING checkpoints; teacher has "
                f"diffusion_type={dtype_key!r} (progressive/consistency "
                "distillation cover the VP family)")
        if t_cfg.get("super_resolution"):
            raise ValueError(
                "reflow does not support super-resolution teachers (pair "
                "synthesis would need an LR conditioning source)")
        n_pairs = int(cfg.get("reflow_pairs", 2048))
        rounds = int(cfg.get("reflow_rounds", 1))
        if rounds < 1:
            raise ValueError("reflow_rounds must be >= 1")
        batch = int(cfg.get("pair_batch_size", cfg.get("batch_size", 64)))
        reflow_cfg_scale = float(cfg.get("reflow_cfg_scale", 0.0))
        conditional = bool(t_cfg.get("conditional", False))
        if reflow_cfg_scale > 0.0 and not conditional:
            raise ValueError("reflow_cfg_scale needs a conditional teacher")
        if n_pairs < batch:
            raise ValueError("reflow_pairs must be >= pair_batch_size")
        super().__init__(cfg, device, generator, tracker)
        self.teacher_config = t_cfg
        self.rounds, self.batch = rounds, batch
        self.reflow_cfg_scale = reflow_cfg_scale
        self.conditional = conditional
        self.num_classes = t_cfg.get("num_classes")
        # whole batches are synthesized anyway: keep every pair
        self.n_pairs = math.ceil(n_pairs / batch) * batch
        if self.n_pairs != n_pairs:
            self.say(f"reflow_pairs {n_pairs} -> {self.n_pairs} (rounded up "
                     "to a pair_batch_size multiple)")
        self.sample_steps = int(cfg.get(
            "teacher_sample_steps", t_cfg.get("num_inference_steps", 50)))
        self.diffusion = get_diffusion(t_cfg)  # FlowMatching
        self.diffusion.set_inference_steps(self.sample_steps)
        self.use_ema = bool(cfg.get("use_ema", True))
        self.ema_decay = float(cfg.get("ema_decay", 0.999))
        self.shape = (*resolve_image_size(t_cfg["image_size"]),
                      t_cfg.get("model_params", {}).get("in_channels", 3))
        self.student = get_model(t_cfg).to(self.device)
        self.student.load_state_dict(teacher_state(payload), strict=True)
        self.say(f"Reflowing {cfg['teacher_checkpoint']} "
                 f"({count_parameters(self.student):,} params): "
                 f"{self.n_pairs} pairs x {rounds} round(s), "
                 f"{self.sample_steps}-step synthesis")

    def draw_pairs(self):
        """A synthesis batch's draws: z, then the +1-shifted labels (None
        for an unconditional teacher)."""
        gen = self.generator
        z = torch.randn((self.batch, *self.shape), generator=gen,
                        device=self.device)
        y = None
        if self.conditional:
            y = torch.randint(1, (self.num_classes or 1) + 1, (self.batch,),
                              generator=gen, device=self.device)
        return z, y

    def synthesize_pairs(self, teacher: torch.nn.Module):
        """(x_hat, z, y) of the round on the device: each batch's
        `draw_pairs` through the teacher's sampler; y is 0 for an
        unconditional teacher."""
        xs, zs, ys = [], [], []
        for _ in range(self.n_pairs // self.batch):
            z, y = self.draw_pairs()
            if y is not None and self.reflow_cfg_scale > 0.0:
                x_hat = self.diffusion.sample_with_cfg(
                    teacher, z.shape, y, cfg_scale=self.reflow_cfg_scale,
                    init_noise=z)
            else:
                x_hat = self.diffusion.sample(teacher, z.shape, y=y,
                                              init_noise=z)
            xs.append(x_hat)
            zs.append(z)
            ys.append(y if y is not None else torch.zeros(
                self.batch, dtype=torch.int64, device=self.device))
        return torch.cat(xs), torch.cat(zs), torch.cat(ys)

    def train_step(self, x_hat: torch.Tensor, z: torch.Tensor,
                   labels: torch.Tensor,
                   t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step on a batch of pairs (labels already shifted); t is drawn
        uniformly from [0, T) unless given. Every data-parallel rank holds
        the round's pairs and takes its rows of each batch (the batch is the
        global one). Returns the loss, on the device."""
        self.model.train()
        if t is None:
            t = torch.randint(0, self.diffusion.num_timesteps,
                              (x_hat.shape[0],), generator=self.generator,
                              device=self.device)
        x_hat, z, labels, t = (self.plan.layout.rows(a)
                               for a in (x_hat, z, labels, t))
        x_t = interpolate(x_hat, self.diffusion.tau_of_t(t), z)
        v = self.train_model(x_t, t, labels if self.conditional else None)
        return self.update(diffusion_loss(z - x_hat, v, "l2"))

    def reflow(self):
        """Every round; returns the trainer, whose `student` is the last
        round's result."""
        for rnd in range(1, self.rounds + 1):
            start = time.time()
            x_hat, z, y = self.synthesize_pairs(self.student.eval())
            self.say(f"[reflow round {rnd}/{self.rounds}] synthesized "
                     f"{len(x_hat)} pairs in {time.time() - start:.1f}s")
            num_batches = len(x_hat) // self.batch
            self.start(self.student, num_batches,
                       self.ema_decay if self.use_ema else None)
            best = float("inf")
            for epoch in range(1, self.epochs + 1):
                order = torch.randperm(len(x_hat), generator=self.generator,
                                       device=self.device)
                batches = ((x_hat[sel], z[sel], y[sel])
                           for sel in order.split(self.batch)[:num_batches])
                start = time.time()
                avg = self.run_epoch(
                    epoch, batches, num_batches, self.train_step,
                    f"reflow loss at round {rnd} epoch {epoch}")
                best = min(best, avg)
                self.say(f"[reflow round {rnd}/{self.rounds}] epoch "
                         f"{epoch}/{self.epochs} - loss {avg:.5f} - "
                         f"{time.time() - start:.1f}s")
                self.tracker.log({f"reflow/round{rnd}/loss": avg},
                                 step=epoch)
            done = int(self.teacher_config.get("reflow_rounds_done", 0)) + rnd
            self.save([f"reflow_round{rnd}.pth", "current_model.pth"],
                      self.epochs, best,
                      dict(self.teacher_config, reflow_rounds_done=done))
            # the (EMA) student's couplings drive the next rectification
            if self.ema_model is not None:
                self.student.load_state_dict(self.ema_model.state_dict())
        self.say("Reflow completed!")
        self.tracker.finish()
        return self
