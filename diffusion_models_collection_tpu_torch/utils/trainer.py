"""Training runtime: the optimizer chain and the diffusion trainer.

Counterpart of `diffusion_models_collection_tpu/utils/trainer.py` on one
device. The JAX package fuses a train step into one jitted program; here the
step is PyTorch code that launches asynchronously on the model's device:

* `(t, noise, drop)` come from the trainer's `torch.Generator` on the device
  (`draw`), or are passed in, which the parity tests do; the dropout masks
  come from torch's global generator, seeded by `helpers.set_seed`;
* the labels shift by +1 and the CFG dropout maps them to the null label 0;
* `p_losses`, plus `moe_aux_weight` (default 0.01) times the mean
  load-balance loss of a MoE DiT's blocks (only when the model routes
  experts; the forward hands it over in its `moe_losses` list, the JAX
  model's sown 'losses'), `backward`, clip by global norm 1.0, AdamW or Adam
  at the scheduled learning rate, then the EMA lerp, once per optimizer
  update;
* the losses stay on the device during an epoch and are read once at its
  end; a non-finite epoch loss stops the run before the checkpoints rotate;
* `progress` (the JAX trainer's key): a line a batch on stderr, under a tty
  (True, the default) or always ('force'); False shows none. The JAX
  trainer's bar is tqdm's and shows nothing without it; the port prints
  its own (`progress_shown`, `diffusion/base.py` `report_progress`).

`optimizer` is 'adamw' (default), 'adam', 'adafactor' or 'lion', the last
two Optax's formulas (`utils/optimizers.py`).

Latent diffusion (`latent_diffusion: true`, `utils/latent.py`): the working
geometry is the VAE's latent one, each batch is encoded inside the step to a
scaled posterior sample (no gradient reaches the frozen VAE), and the
in-training sample grids are decoded. The encoder's noise is drawn from the
trainer's generator after the step's other draws, and only under latent, so
pixel-space runs keep their random stream (the JAX trainer splits its key
five ways only under latent).

Super-resolution (a `super_resolution` block, `utils/sr.py`): each step
conditions the model on its own batch, area-downsampled and upsampled back
(plus `noise_aug` noise, drawn from the trainer's generator after the
step's other draws and only under SR, or passed in), concatenated to x_t on
the channel axis. The in-training grids condition on the first batch's
images (`sr_condition.png` shows that view once); before any batch the grid
is skipped. SR with latent diffusion raises.

Checkpoints are the reference's `torch.save` schema (`current_model.pth`,
`best_model.pth`, `model_epoch_NNNN.pth`); resuming keeps the epoch
extension. The JAX trainer's parallel layouts (tensor, pipeline, sequence,
expert, FSDP) raise, naming their ROADMAP items. `VAETrainer`
(`utils/vae_trainer.py`) trains the first stage on this trainer's optimizer,
EMA, checkpoints and loop.
"""

from __future__ import annotations

import copy
import math
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..diffusion.base import report_progress
from . import checkpoint as ckpt_lib
from .ema import ema_update
from .helpers import count_parameters, resolve_image_size, save_image_grid
from .latent import LatentCodec
from .lr_schedules import build_lr_schedule
from .optimizers import Adafactor, Lion
from .profiler import StepTimer, profile_trace
from .sr import SRSpec, make_condition, wrap_model_fn
from .tracker import Tracker, build_tracker


def _not_ported(cfg: dict):
    """(key, ROADMAP item) for each config key of the JAX trainer that
    selects what this port has not ported yet."""
    for key in ("tensor_parallel", "pipeline_parallel", "sequence_parallel",
                "expert_parallel"):
        if int(cfg.get(key, 1) or 1) > 1:
            yield key, "queue 1 item 15"
    if cfg.get("fsdp"):
        yield "fsdp", "queue 1 item 15"
    # the JAX trainer's other format is orbax, which the port does not need
    if cfg.get("checkpoint_format", "pickle") != "pickle":
        yield "checkpoint_format", "queue 1 item 16"


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Optax's clip: scale every gradient by max_norm / ||g|| when the global
    norm ||g|| is at least max_norm (torch's `clip_grad_norm_` adds 1e-6 to
    the norm and so differs). In place; returns the norm, on the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(list(grads), factor)
    return norm


class Optimizer:
    """The JAX package's Optax chain for torch parameters: clip by global
    norm 1.0, then the inner optimizer at `lr_schedule(update count)`, set
    before each update; with `accum` > 1, Optax's `MultiSteps`: the gradients
    of `accum` calls (summed by autograd) are averaged into one update."""

    def __init__(self, params, inner: torch.optim.Optimizer,
                 lr_schedule: Callable[[int], float], accum: int = 1,
                 max_norm: float = 1.0):
        self.params = list(params)
        self.inner = inner
        self.lr_schedule = lr_schedule
        self.accum = max(1, int(accum))
        self.max_norm = max_norm
        self.count = 0       # updates applied
        self.mini_step = 0   # backward calls since the last update

    def step(self) -> bool:
        """Call after each backward. Returns whether an update was applied
        (every `accum`-th call); the gradients are then cleared."""
        self.mini_step += 1
        if self.mini_step < self.accum:
            return False
        self.mini_step = 0
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.accum > 1:
            torch._foreach_div_(grads, float(self.accum))
        clip_by_global_norm_(grads, self.max_norm)
        lr = self.lr_schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.inner.zero_grad(set_to_none=True)
        self.count += 1
        return True

    def state_dict(self) -> dict:
        """The inner optimizer's state, the reference checkpoint's
        `optimizer_state_dict`."""
        return self.inner.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state)


def build_optimizer(config: dict, params,
                    updates_per_epoch: int) -> Optimizer:
    """Clip by global norm 1.0, then AdamW (decoupled weight decay) or Adam
    (weight decay as an L2 term added to the gradient), betas (0.9, 0.999),
    eps 1e-8, or Optax's Adafactor or Lion (`utils/optimizers.py`), at the
    config's learning-rate schedule."""
    lr_schedule = build_lr_schedule(config, updates_per_epoch)
    wd = float(config.get("weight_decay", 0.0))
    opt_type = config.get("optimizer", "adamw").lower()
    params = list(params)
    lr = lr_schedule(0)
    if opt_type == "adamw":
        inner = torch.optim.AdamW(params, lr=lr, weight_decay=wd)
    elif opt_type == "adam":
        inner = torch.optim.Adam(params, lr=lr, weight_decay=wd)
    elif opt_type == "adafactor":
        inner = Adafactor(params, lr=lr, weight_decay=wd)
    elif opt_type == "lion":
        inner = Lion(params, lr=lr, weight_decay=wd)
    else:
        raise ValueError(f"Unknown optimizer: {opt_type}")
    return Optimizer(params, inner, lr_schedule,
                     int(config.get("gradient_accumulation_steps", 1)))


def progress_shown(config: dict) -> bool:
    """Whether the trainer prints a line a batch: `progress` 'force', or
    true (the default) with stderr a terminal."""
    progress = config.get("progress", True)
    return progress == "force" or (bool(progress) and sys.stderr.isatty())


def report_batch(shown: bool, epoch: int, epochs: int, done: int,
                 total: int) -> None:
    """The per-batch progress line of `progress_shown`, on stderr."""
    report_progress(shown, f"Epoch {epoch}/{epochs}", done, total,
                    every=total, file=sys.stderr)


def restore_checkpoint(trainer, checkpoint_path) -> None:
    """Resume `trainer` (its `model`, `ema_model`, `optimizer`, `accum` and
    `config`) from a `.pth` or a JAX `.ckpt`: weights, EMA, optimizer state
    where it is a torch optimizer's, step count, `start_epoch` (the
    checkpoint's epoch + 1) and best loss. The epoch target is left alone:
    each trainer keeps its JAX counterpart's rule for it."""
    print(f"Loading checkpoint from {checkpoint_path}...")
    payload = ckpt_lib.load_checkpoint(checkpoint_path, trainer.config)
    trainer.model.load_state_dict(payload["model_state_dict"])
    if trainer.ema_model is not None:
        ema = payload.get("ema_model_state_dict")
        trainer.ema_model.load_state_dict(
            ema if ema is not None else payload["model_state_dict"])
    trainer.global_step = int(payload.get("global_step", 0))
    opt_state = payload.get("optimizer_state_dict")
    if isinstance(opt_state, dict) and "param_groups" in opt_state:
        trainer.optimizer.load_state_dict(opt_state)
    else:
        print("The checkpoint holds no torch optimizer state (a JAX "
              "checkpoint?): reinitializing the optimizer.")
    trainer.optimizer.count = trainer.global_step // trainer.accum
    trainer.start_epoch = int(payload.get("epoch", 0)) + 1
    trainer.best_loss = float(payload.get("best_loss", float("inf")))


class DiffusionTrainer:
    """Trainer of a denoiser under a diffusion process's `p_losses`, on
    one device. `train()` runs the epochs; `train_step` is one step."""

    def __init__(self, model: torch.nn.Module, diffusion, train_loader,
                 config: dict, device, generator: torch.Generator = None,
                 resume_path: Optional[str] = None,
                 tracker: Optional[Tracker] = None):
        cfg = config
        for key, item in _not_ported(cfg):
            raise NotImplementedError(
                f"{key} is not ported yet (ROADMAP {item})")
        self.config = cfg
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.diffusion = diffusion
        self.train_loader = train_loader
        self.generator = (generator if generator is not None else
                          torch.Generator(device=self.device).manual_seed(
                              cfg.get("seed", 42)))

        self.epochs = cfg.get("epochs", 100)
        self.save_dir = Path(cfg.get("save_dir", "./checkpoints"))
        self.sample_dir = Path(cfg.get("sample_dir", "./generated_images"))
        self.loss_type = cfg.get("loss_type", "l2")
        self.save_interval = cfg.get("save_interval", 10)
        self.sample_interval = cfg.get("sample_interval", 5)
        self.sample_start_epoch = cfg.get("sample_start_epoch", 20)
        self.num_samples = cfg.get("num_samples", 16)
        self.cfg_dropout_prob = float(cfg.get("cfg_dropout_prob", 0.2))
        # the MoE load-balance loss's weight, active only when the model
        # routes experts
        self.moe_aux_weight = (
            float(cfg.get("moe_aux_weight", 0.01))
            if int(getattr(model, "num_experts", 0) or 0) > 0 else 0.0)
        self.cfg_scale = cfg.get("cfg_scale", 1.8)
        self.ema_decay = float(cfg.get("ema_decay", 0.9999))
        self.conditional = cfg.get("conditional", False)
        self.num_classes = cfg.get("num_classes", None)
        self.image_size = resolve_image_size(cfg.get("image_size", 32))
        self.in_channels = cfg.get("model_params", {}).get("in_channels", 3)
        self.latent = LatentCodec.from_config(cfg, device=self.device)
        if self.latent is not None:
            self.image_size = self.latent.latent_hw()
            self.in_channels = self.latent.latent_channels
        self.sr = SRSpec.from_config(cfg)
        if self.sr is not None and self.latent is not None:
            raise ValueError("super_resolution composes with pixel-space "
                             "diffusion only (the LR conditioning is defined "
                             "on pixels)")
        # the first train batch's images: the in-training grids' condition
        self.sr_cond_images = None
        self.sr_cond_saved = False
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.sample_dir.mkdir(parents=True, exist_ok=True)
        print(f"Model parameters: {count_parameters(self.model):,}")

        self.accum = max(1, int(cfg.get("gradient_accumulation_steps", 1)))
        updates_per_epoch = max(1, max(1, len(train_loader)) // self.accum)
        self.optimizer = build_optimizer(cfg, self.model.parameters(),
                                         updates_per_epoch)
        # the EMA starts as a copy of the params
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
        self.profile_dir = cfg.get("profile_dir")

    # ---------------------------------------------------------------- step
    def draw(self, shape: Sequence[int]
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """The step's random draws from the trainer's generator for a batch
        of `shape` (the model's space): timesteps t ~ U[0, T), the noise,
        and the CFG dropout mask (None when labels are not dropped)."""
        batch, gen = shape[0], self.generator
        t = torch.randint(0, self.diffusion.num_timesteps, (batch,),
                          generator=gen, device=self.device)
        noise = torch.randn(tuple(shape), generator=gen, device=self.device)
        drop = None
        if (self.conditional and self.cfg_dropout_prob > 0
                and self.num_classes is not None):
            drop = torch.rand(batch, generator=gen,
                              device=self.device) < self.cfg_dropout_prob
        return t, noise, drop

    def train_step(self, images: torch.Tensor, labels: torch.Tensor,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   drop: Optional[torch.Tensor] = None,
                   encoder_noise: Optional[torch.Tensor] = None,
                   sr_noise: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """One step on a device batch: images (B, H, W, C) in [-1, 1],
        labels (B,) unshifted. `t`, `noise` and `drop` are drawn unless
        given; under latent diffusion the images are encoded with
        `encoder_noise`, drawn after them unless given; under
        super-resolution the batch's condition takes `sr_noise` (with
        `noise_aug` > 0), drawn after them unless given. Returns the loss,
        on the device."""
        self.model.train()
        shape = (images.shape if self.latent is None
                 else self.latent.latent_shape(images.shape[0]))
        if t is None:
            t, noise, drop = self.draw(shape)
        model_fn = self.model
        moe_losses = []
        if self.moe_aux_weight > 0:
            def model_fn(x, tt, yy=None):
                return self.model(x, tt, yy, moe_losses=moe_losses)
        if self.sr is not None:
            cond = make_condition(self.sr, images.shape[1:3],
                                  hr_images=images, generator=self.generator,
                                  noise=sr_noise)
            model_fn = wrap_model_fn(model_fn, cond)
        if self.latent is not None:
            if encoder_noise is None:
                encoder_noise = torch.randn(shape, generator=self.generator,
                                            device=self.device)
            images = self.latent.encode(images, noise=encoder_noise)
        y = None
        if self.conditional:
            y = labels.to(torch.int64) + 1
            if drop is not None:
                y = torch.where(drop, torch.zeros_like(y), y)
        loss = self.diffusion.p_losses(model_fn, images, t, noise, y=y,
                                       loss_type=self.loss_type)
        if moe_losses:  # the first call's, as the JAX trainer
            loss = loss + self.moe_aux_weight * moe_losses[0]
        loss.backward()
        if self.optimizer.step() and self.ema_model is not None:
            ema_update(self.ema_model.parameters(), self.model.parameters(),
                       self.ema_decay)
        self.global_step += 1
        return loss.detach()

    # --------------------------------------------------------------- epoch
    def train_epoch(self, epoch: int) -> float:
        """One epoch; returns the mean loss over its batches. A step may
        return further values after its loss (the VAE's reconstruction and
        KL terms): the means of all are kept in `epoch_means`."""
        self.train_loader.set_epoch(epoch)
        losses: List[torch.Tensor] = []
        shown, total = progress_shown(self.config), len(self.train_loader)
        for images, labels in self.train_loader:
            if self.sr is not None and self.sr_cond_images is None:
                self.sr_cond_images = np.asarray(
                    images, np.float32)[:self.num_samples]
            with self.step_timer.step():
                x = torch.from_numpy(np.asarray(images, np.float32)).to(
                    self.device)
                y = torch.from_numpy(
                    np.asarray(labels if labels is not None
                               else np.zeros(len(images)), np.int64)).to(
                    self.device)
                losses.append(self.train_step(x, y))
            report_batch(shown, epoch, self.epochs, len(losses), total)
        if not losses:
            self.epoch_means = None
            return float("nan")
        # the epoch's one host read
        self.epoch_means = torch.stack(losses).mean(0).cpu()
        return float(self.epoch_means.reshape(-1)[0])

    def epoch_details(self) -> dict:
        """Metrics of the epoch just run beyond its loss, for the log."""
        return {}

    # ------------------------------------------------------------ sampling
    def sample_images(self, epoch: int,
                      num_samples: Optional[int] = None
                      ) -> Optional[np.ndarray]:
        """In-training sample grid from the EMA model (the model without
        EMA): CFG sampling over the labels 0, 1, ... one per row for a
        conditional model; a latent model's samples decoded; an SR model's
        conditioned on the first train batch (None before one was seen).
        Saved as `<sample_dir>/epoch_NNNN.png`."""
        num_samples = num_samples or self.num_samples
        h, w = self.image_size
        shape = (num_samples, h, w, self.in_channels)
        nrow = max(1, int(math.sqrt(num_samples)))
        model = self.ema_model if self.ema_model is not None else self.model
        model_fn = model
        if self.sr is not None:
            model_fn = self.sr_wrap_for_sampling(model, num_samples, nrow)
            if model_fn is None:
                return None
        was_training = model.training
        model.eval()
        if self.conditional and self.num_classes:
            num_rows = (num_samples + nrow - 1) // nrow
            row_labels = np.arange(num_rows) % self.num_classes
            labels = torch.as_tensor(
                np.repeat(row_labels + 1, nrow)[:num_samples],
                device=self.device)
            print(f"Sampling with labels: {labels.tolist()}")
            samples = self.diffusion.sample_with_cfg(
                model_fn, shape, labels, self.generator,
                cfg_scale=self.cfg_scale)
        else:
            samples = self.diffusion.sample(model_fn, shape, self.generator)
        model.train(was_training)
        if self.latent is not None:
            samples = self.latent.decode(samples)
        samples = np.clip((samples.cpu().numpy() + 1) / 2, 0, 1)
        save_path = self.sample_dir / f"epoch_{epoch:04d}.png"
        save_image_grid(samples, save_path, nrow=nrow)
        self.tracker.log_image("samples", str(save_path), step=epoch)
        return samples

    def sr_wrap_for_sampling(self, model, num_samples: int, nrow: int):
        """`model` conditioned on the cached first-batch images (tiled to
        `num_samples`), or None before any batch was seen. The first call
        saves the condition as `<sample_dir>/sr_condition.png`."""
        if self.sr_cond_images is None:
            print("SR sample grid skipped: no train batch seen yet")
            return None
        src = self.sr_cond_images
        if len(src) < num_samples:
            src = np.tile(src, (-(-num_samples // len(src)), 1, 1, 1))
        cond = make_condition(
            self.sr, self.image_size,
            hr_images=torch.as_tensor(src[:num_samples], device=self.device),
            generator=self.generator)
        if not self.sr_cond_saved:
            # the LR view the model sees, beside the generated grids
            grid = np.clip((cond.cpu().numpy() + 1) / 2, 0, 1)
            save_image_grid(grid, self.sample_dir / "sr_condition.png",
                            nrow=nrow)
            self.sr_cond_saved = True
        return wrap_model_fn(model, cond)

    # --------------------------------------------------------- checkpoints
    def save_checkpoint(self, epoch: int, is_best: bool = False,
                        is_last: bool = False) -> None:
        """current_model.pth every `save_current_interval` epochs (1 by
        default) and at the last epoch; best_model.pth on a new best loss
        unless `save_best` is false; model_epoch_NNNN.pth every
        `save_interval` epochs."""
        every = int(self.config.get("save_current_interval", 1) or 1)
        write_current = is_last or epoch % every == 0
        write_best = is_best and bool(self.config.get("save_best", True))
        write_periodic = epoch % self.save_interval == 0
        names = []
        if write_current:
            names.append("current_model.pth")
        if write_best:
            names.append("best_model.pth")
        if write_periodic:
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
        """Resume from a `.pth` (this trainer's or the reference's) or a JAX
        `.ckpt` (`restore_checkpoint`). A run resumed past its configured
        epochs is extended by that many epochs."""
        restore_checkpoint(self, checkpoint_path)
        print(f"Resuming training from epoch {self.start_epoch}")
        if self.start_epoch > self.epochs:
            extend = self.config.get("epochs", 100)
            print(f"Checkpoint epoch ({self.start_epoch - 1}) is greater "
                  f"than configured epochs ({self.epochs}).")
            print(f"Extending training by {extend} epochs...")
            self.epochs = self.start_epoch + extend
            print(f"New target epochs: {self.epochs}")

    # ---------------------------------------------------------------- loop
    def current_lr(self) -> float:
        return self.optimizer.lr_schedule(self.global_step // self.accum)

    def train(self) -> None:
        """The epoch loop: train, log, checkpoint, sample."""
        print(f"Starting training for {self.epochs} epochs on {self.device}")
        for epoch in range(self.start_epoch, self.epochs + 1):
            start_time = time.time()
            with profile_trace(self.profile_dir
                               if epoch == self.start_epoch else None):
                avg_loss = self.train_epoch(epoch)
            epoch_time = time.time() - start_time
            # a diverged run stops before the checkpoint rotation overwrites
            # the last good state
            if not math.isfinite(avg_loss):
                print(f"ERROR: non-finite loss ({avg_loss}) at epoch {epoch}; "
                      "stopping before overwriting checkpoints. Resume from "
                      f"{self.save_dir / 'current_model.pth'} with a lower "
                      "learning rate.")
                self.tracker.log({"train/diverged_epoch": epoch}, step=epoch)
                break
            lr = self.current_lr()
            details = self.epoch_details()
            parts = ", ".join(f"{k.split('/')[-1]} {v:.4f}"
                              for k, v in details.items())
            print(f"Epoch {epoch}/{self.epochs} - Loss: {avg_loss:.4f}"
                  + (f" ({parts})" if parts else "")
                  + f" - LR: {lr:.6f} - Time: {epoch_time:.2f}s")
            timing = {f"train/step_{k}": v
                      for k, v in self.step_timer.summary().items()}
            self.step_timer.reset()
            self.tracker.log({"train/loss": avg_loss, **details,
                              "train/lr": lr, "train/epoch_time": epoch_time,
                              **timing}, step=epoch)
            is_best = avg_loss < self.best_loss
            if is_best:
                self.best_loss = avg_loss
            self.save_checkpoint(epoch, is_best, is_last=epoch == self.epochs)
            if (epoch >= self.sample_start_epoch
                    and epoch % self.sample_interval == 0):
                print(f"Generating samples at epoch {epoch}...")
                self.sample_images(epoch)
        print("Training completed!")
        self.tracker.finish()
