"""Trainer of the noise-conditional classifier of classifier guidance.

Counterpart of `diffusion_models_collection_tpu/utils/classifier_trainer.py`
on one device. `model_type: 'classifier'` routes `train` here. A step: t
uniform in [0, T) and the noise from the trainer's generator (or passed in,
as the parity tests do), x_t by `q_sample` on the config's schedule (the
four schedule keys and `zero_terminal_snr`, the marginals the classifier
will guide through), cross-entropy of the logits against the raw labels
0..K-1 (no CFG shift) and the accuracy, backward, then the diffusion
trainer's optimizer chain (clip by global norm 1.0, AdamW or Adam at the
scheduled learning rate, gradient accumulation) and EMA, once per update.

Checkpoints are the `.pth` schema of the other trainers, so `sample
--classifier_checkpoint` reads them: `current_model.pth` every epoch,
`best_model.pth` on a new best cross-entropy, `model_epoch_NNNN.pth` every
`save_interval` epochs. A non-finite epoch loss stops the run before they
are written. Resuming follows the JAX trainer: the run continues at the
checkpoint's epoch + 1 up to the configured `epochs`, never beyond.
"""

from __future__ import annotations

import copy
import math
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..diffusion.base import q_sample
from ..diffusion.schedule import NoiseSchedule
from . import checkpoint as ckpt_lib
from .ema import ema_update
from .helpers import count_parameters
from .profiler import StepTimer
from .tracker import Tracker, build_tracker
from .trainer import (build_optimizer, progress_shown, report_batch,
                      restore_checkpoint)


class ClassifierTrainer:
    """Trainer for `model_type: 'classifier'` configs; `train()` runs the
    epochs, `train_step` is one step. The schedule keys must be those of
    the diffusion model the classifier will guide."""

    def __init__(self, model: torch.nn.Module, train_loader, config: dict,
                 device, generator: torch.Generator = None,
                 resume_path: Optional[str] = None,
                 tracker: Optional[Tracker] = None):
        cfg = self.config = config
        if not cfg.get("conditional", False):
            raise ValueError("classifier training needs a labeled dataset "
                             "(conditional: true)")
        if cfg.get("super_resolution"):
            raise ValueError(
                "super_resolution does not apply to classifier training")
        if cfg.get("latent_diffusion"):
            raise ValueError(
                "classifier guidance is defined on pixels; train the "
                "classifier on the pixel dataset (no latent_diffusion)")
        self.num_classes = int(cfg.get("num_classes", 0) or 0)
        if self.num_classes < 2:
            raise ValueError("classifier training needs num_classes >= 2")
        # the JAX trainer's other format is orbax, which the port does not
        # need
        if cfg.get("checkpoint_format", "pickle") != "pickle":
            raise NotImplementedError(
                "checkpoint_format is not ported yet (ROADMAP queue 1 item "
                "16)")
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.train_loader = train_loader
        self.generator = (generator if generator is not None else
                          torch.Generator(device=self.device).manual_seed(
                              cfg.get("seed", 42)))
        self.epochs = cfg.get("epochs", 100)
        self.save_dir = Path(cfg.get("save_dir", "./checkpoints"))
        self.save_interval = cfg.get("save_interval", 10)
        self.ema_decay = float(cfg.get("ema_decay", 0.9999))
        self.num_timesteps = int(cfg.get("num_timesteps", 1000))
        self.schedule = NoiseSchedule.create(
            self.num_timesteps, cfg.get("beta_start", 1e-4),
            cfg.get("beta_end", 0.02), cfg.get("beta_schedule", "linear"),
            zero_terminal_snr=bool(cfg.get("zero_terminal_snr", False)),
        ).to(self.device)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        print(f"Classifier parameters: {count_parameters(self.model):,}")

        self.accum = max(1, int(cfg.get("gradient_accumulation_steps", 1)))
        updates_per_epoch = max(1, max(1, len(train_loader)) // self.accum)
        self.optimizer = build_optimizer(cfg, self.model.parameters(),
                                         updates_per_epoch)
        self.ema_model = None
        if cfg.get("use_ema", False):
            self.ema_model = copy.deepcopy(self.model).eval()
            self.ema_model.requires_grad_(False)

        self.best_loss = float("inf")
        self.start_epoch = 1
        self.global_step = 0
        if resume_path:
            self.load_checkpoint(resume_path)
        self.tracker = (tracker if tracker is not None
                        else build_tracker(cfg, str(self.save_dir)))
        self.step_timer = StepTimer()

    # ---------------------------------------------------------------- step
    def draw(self, shape) -> Tuple[torch.Tensor, torch.Tensor]:
        """The step's draws from the trainer's generator: t ~ U[0, T), then
        the noise."""
        gen = self.generator
        t = torch.randint(0, self.num_timesteps, (shape[0],), generator=gen,
                          device=self.device)
        noise = torch.randn(tuple(shape), generator=gen, device=self.device)
        return t, noise

    def train_step(self, images: torch.Tensor, labels: torch.Tensor,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step on a device batch: images (B, H, W, C) in [-1, 1],
        labels (B,) raw 0..K-1. Returns (cross-entropy, accuracy), on the
        device."""
        self.model.train()
        if t is None:
            t, noise = self.draw(images.shape)
        x_t = q_sample(self.schedule, images, t, noise)
        y = labels.to(torch.int64)
        logits = self.model(x_t, t)
        ce = torch.nn.functional.cross_entropy(logits, y)
        acc = (logits.argmax(-1) == y).to(torch.float32).mean()
        ce.backward()
        if self.optimizer.step() and self.ema_model is not None:
            ema_update(self.ema_model.parameters(), self.model.parameters(),
                       self.ema_decay)
        self.global_step += 1
        return torch.stack([ce, acc]).detach()

    def train_epoch(self, epoch: int) -> Tuple[float, float]:
        """One epoch; the mean cross-entropy and accuracy over its
        batches (one host read at its end)."""
        self.train_loader.set_epoch(epoch)
        out: List[torch.Tensor] = []
        shown, total = progress_shown(self.config), len(self.train_loader)
        for images, labels in self.train_loader:
            if labels is None:
                raise ValueError("classifier training requires labeled "
                                 "batches")
            with self.step_timer.step():
                x = torch.from_numpy(np.asarray(images, np.float32)).to(
                    self.device)
                y = torch.from_numpy(np.asarray(labels, np.int64)).to(
                    self.device)
                out.append(self.train_step(x, y))
            report_batch(shown, epoch, self.epochs, len(out), total)
        if not out:
            return float("nan"), float("nan")
        ce, acc = torch.stack(out).mean(0).tolist()
        return ce, acc

    # --------------------------------------------------------- checkpoints
    def save_checkpoint(self, epoch: int, is_best: bool = False) -> None:
        names = ["current_model.pth"]
        if is_best:
            names.append("best_model.pth")
        if epoch % self.save_interval == 0:
            names.append(f"model_epoch_{epoch:04d}.pth")
        for name in names:
            ckpt_lib.save_checkpoint(
                self.save_dir / name, self.model.state_dict(), self.config,
                ema_model_state_dict=(self.ema_model.state_dict()
                                      if self.ema_model is not None
                                      else None),
                epoch=epoch, best_loss=self.best_loss,
                optimizer_state_dict=self.optimizer.state_dict(),
                global_step=self.global_step)

    def load_checkpoint(self, checkpoint_path) -> None:
        """Resume at the checkpoint's epoch + 1, with no extension past the
        configured `epochs`."""
        restore_checkpoint(self, checkpoint_path)
        print(f"Resuming classifier training from epoch {self.start_epoch}")

    # ---------------------------------------------------------------- loop
    def train(self) -> None:
        print(f"Starting classifier training for {self.epochs} epochs on "
              f"{self.device}")
        for epoch in range(self.start_epoch, self.epochs + 1):
            start_time = time.time()
            avg_loss, avg_acc = self.train_epoch(epoch)
            epoch_time = time.time() - start_time
            if not math.isfinite(avg_loss):
                print(f"ERROR: non-finite classifier loss ({avg_loss}) at "
                      f"epoch {epoch}; stopping before overwriting "
                      "checkpoints.")
                self.tracker.log({"train/diverged_epoch": epoch}, step=epoch)
                break
            print(f"Epoch {epoch}/{self.epochs} - CE: {avg_loss:.4f} - "
                  f"Acc: {avg_acc:.3f} - Time: {epoch_time:.2f}s")
            self.tracker.log({"train/loss": avg_loss,
                              "train/accuracy": avg_acc,
                              "train/epoch_time": epoch_time}, step=epoch)
            is_best = avg_loss < self.best_loss
            if is_best:
                self.best_loss = avg_loss
            self.save_checkpoint(epoch, is_best=is_best)
        print("Training completed!")
        self.tracker.finish()
