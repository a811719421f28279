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
extension.

Parallel training (`parallel/`), in a process group (torchrun, or a test's):
data parallelism (DDP over 'data'), `fsdp: true` (ZeRO-3, FSDP2 per block,
`fsdp_min_size`), `tensor_parallel: N` (Megatron rules for the DiT and the
DiM; a UNet stays replicated), their hybrid, `sequence_parallel: S` (the
DiT's and the DiM's tokens over S ranks, composing with `tensor_parallel`),
`pipeline_parallel: S` (GPipe of the DiT's and the DiM's blocks over S
stages in `pp_microbatches` microbatches, the DiT's composing with
`tensor_parallel`) and `expert_parallel: E` (a MoE DiT's experts over E
ranks), through `ParallelPlan`. `batch_size` is the global batch: each data-parallel
rank loads `max(1, batch_size // dp)` images (`factory.get_dataloader`).
Every rank draws the global batch's (t, noise, drop) from the generator
that every rank seeds alike and keeps its rows, so world N takes the steps
of one device on the same global batch; the dropout masks are keyed on the
global batch too (`models/layers.Dropout`, the attention's head grid). The
clip sums the squares of sharded gradients over their groups; rank 0
prints, writes the grids, logs and writes the checkpoints, which every rank
gathers to the full state dict; every rank samples the grids (a collective
under FSDP, TP, PP and EP; under pipeline parallelism through the
stages, each data rank on its rows of the grid); the epoch's logged loss is
the mean over 'data'. A MoE's load-balance loss is the global batch's under
every data-parallel layout (`models/moe.py`). `VAETrainer`
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
import torch.distributed as dist

from ..diffusion.base import report_progress
from ..parallel.fsdp import local, sharded_fraction
from ..parallel.plan import ParallelPlan
from . import checkpoint as ckpt_lib
from .ema import ema_update
from .helpers import count_parameters, resolve_image_size, save_image_grid
from .latent import LatentCodec
from .lr_schedules import build_lr_schedule
from .optimizers import Adafactor, Lion
from .profiler import StepTimer, profile_trace
from .sr import SRSpec, make_condition, wrap_model_fn
from .tracker import NullTracker, Tracker, build_tracker


def _not_ported(cfg: dict):
    """(key, ROADMAP item) for each config key of the JAX trainer that
    selects what this port has not ported yet."""
    # the JAX trainer's other format is orbax, which the port does not need
    if cfg.get("checkpoint_format", "pickle") != "pickle":
        yield "checkpoint_format", "queue 1 item 16"


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         groups: Optional[Sequence[tuple]] = None
                         ) -> torch.Tensor:
    """Optax's clip: scale every gradient by max_norm / ||g|| when the global
    norm ||g|| is at least max_norm (torch's `clip_grad_norm_` adds 1e-6 to
    the norm and so differs). In place; returns the norm, on the device.
    `groups` gives, for each gradient, the process groups over which its
    pieces lie (a sharded one's); each piece's squares are summed over
    them, so a replicated gradient counts once."""
    grads = [local(g) for g in grads]
    if groups is None or not any(groups):
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
    else:
        squares = torch.stack(torch._foreach_norm(grads)) ** 2
        norm_sq = squares.new_zeros(())
        # every rank takes the groups in the same order (first seen)
        for key in dict.fromkeys(groups):
            picked = torch.tensor([g == key for g in groups],
                                  device=squares.device)
            part = squares[picked].sum()
            for group in key:
                dist.all_reduce(part, group=group)
            norm_sq = norm_sq + part
        norm = torch.sqrt(norm_sq)
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
                 max_norm: float = 1.0, plan=None):
        self.params = list(params)
        self.plan = plan
        self.groups = (None if plan is None
                       else plan.grad_groups(self.params))
        self.inner = inner
        self.lr_schedule = lr_schedule
        self.accum = max(1, int(accum))
        self.max_norm = max_norm
        self.count = 0       # updates applied
        self.mini_step = 0   # backward calls since the last update

    def updates_next(self) -> bool:
        """Whether the next `step` applies an update (the micro-step whose
        gradients a data-parallel run synchronises)."""
        return self.mini_step + 1 >= self.accum

    def step(self) -> bool:
        """Call after each backward. Returns whether an update was applied
        (every `accum`-th call); the gradients are then cleared. Under FSDP
        the gradients it leaves replicated are averaged over 'data' first."""
        self.mini_step += 1
        if self.mini_step < self.accum:
            return False
        self.mini_step = 0
        if self.plan is not None:
            self.plan.average_replicated_grads()
        has = [p.grad is not None for p in self.params]
        grads = [local(p.grad) for p, h in zip(self.params, has) if h]
        if self.accum > 1:
            torch._foreach_div_(grads, float(self.accum))
        clip_by_global_norm_(grads, self.max_norm,
                             None if self.groups is None else
                             [g for g, h in zip(self.groups, has) if h])
        lr = self.lr_schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.inner.zero_grad(set_to_none=True)
        self.count += 1
        return True

    def state_dict(self) -> dict:
        """The inner optimizer's state, the reference checkpoint's
        `optimizer_state_dict`; a sharded run's gathered to the full
        parameters' (a collective)."""
        if self.plan is not None:
            return self.plan.full_optimizer_state(self.inner, self.params)
        return self.inner.state_dict()

    def load_state_dict(self, state: dict) -> None:
        """Load a full optimizer state, re-sharded to a sharded run's."""
        if self.plan is not None:
            self.plan.load_optimizer_state(self.inner, self.params, state)
        else:
            self.inner.load_state_dict(state)


def build_optimizer(config: dict, params, updates_per_epoch: int,
                    plan=None) -> Optimizer:
    """Clip by global norm 1.0, then AdamW (decoupled weight decay) or Adam
    (weight decay as an L2 term added to the gradient), betas (0.9, 0.999),
    eps 1e-8, or Optax's Adafactor or Lion (`utils/optimizers.py`), at the
    config's learning-rate schedule; on `plan`'s layout (`parallel/plan.py`)
    when one is given."""
    lr_schedule = build_lr_schedule(config, updates_per_epoch)
    wd = float(config.get("weight_decay", 0.0))
    opt_type = config.get("optimizer", "adamw").lower()
    params = list(params)
    lr = lr_schedule(0)
    # FSDP's shards (DTensors) beside the parameters it leaves replicated:
    # the fused multi-tensor path takes one kind a call, so a tensor at a time
    foreach = (False if plan is not None and plan.fsdp and plan.replicated
               else None)
    if opt_type == "adamw":
        inner = torch.optim.AdamW(params, lr=lr, weight_decay=wd,
                                  foreach=foreach)
    elif opt_type == "adam":
        inner = torch.optim.Adam(params, lr=lr, weight_decay=wd,
                                 foreach=foreach)
    elif opt_type == "adafactor":
        inner = Adafactor(params, lr=lr, weight_decay=wd)
    elif opt_type == "lion":
        inner = Lion(params, lr=lr, weight_decay=wd)
    else:
        raise ValueError(f"Unknown optimizer: {opt_type}")
    return Optimizer(params, inner, lr_schedule,
                     int(config.get("gradient_accumulation_steps", 1)),
                     plan=plan)


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
    plan = getattr(trainer, "plan", None)
    if plan is None or plan.is_main:
        print(f"Loading checkpoint from {checkpoint_path}...")
    payload = ckpt_lib.load_checkpoint(checkpoint_path, trainer.config)

    def load(module, state):
        if plan is None:
            module.load_state_dict(state)
        else:  # re-sharded to this rank's layout
            plan.load_state_dict(module, state)

    load(trainer.model, payload["model_state_dict"])
    if trainer.ema_model is not None:
        ema = payload.get("ema_model_state_dict")
        load(trainer.ema_model,
             ema if ema is not None else payload["model_state_dict"])
    trainer.global_step = int(payload.get("global_step", 0))
    opt_state = payload.get("optimizer_state_dict")
    if isinstance(opt_state, dict) and "param_groups" in opt_state:
        trainer.optimizer.load_state_dict(opt_state)
    elif plan is None or plan.is_main:
        print("The checkpoint holds no torch optimizer state (a JAX "
              "checkpoint?): reinitializing the optimizer.")
    trainer.optimizer.count = trainer.global_step // trainer.accum
    trainer.start_epoch = int(payload.get("epoch", 0)) + 1
    trainer.best_loss = float(payload.get("best_loss", float("inf")))


class DiffusionTrainer:
    """Trainer of a denoiser under a diffusion process's `p_losses`, on
    one device or a parallel layout. `train()` runs the epochs;
    `train_step` is one step."""

    # whether `tensor_parallel` and `fsdp` apply (else data parallel only)
    model_parallel = True

    def __init__(self, model: torch.nn.Module, diffusion, train_loader,
                 config: dict, device, generator: torch.Generator = None,
                 resume_path: Optional[str] = None,
                 tracker: Optional[Tracker] = None):
        cfg = config
        self.device = torch.device(device)
        # the JAX trainer's exclusions among the layouts come first
        self.plan = ParallelPlan(cfg, model, self.device,
                                 self.model_parallel)
        for key, item in _not_ported(cfg):
            raise NotImplementedError(
                f"{key} is not ported yet (ROADMAP {item})")
        self.config = cfg
        self.is_main = self.plan.is_main
        num_params = count_parameters(model)  # the whole model's
        self.model = self.plan.prepare(model).to(self.device)
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
        if self.is_main:
            self.save_dir.mkdir(parents=True, exist_ok=True)
            self.sample_dir.mkdir(parents=True, exist_ok=True)
            print(f"Model parameters: {num_params:,}")

        self.accum = max(1, int(cfg.get("gradient_accumulation_steps", 1)))
        updates_per_epoch = max(1, max(1, len(train_loader)) // self.accum)
        # the EMA starts as a copy of the params
        self.ema_model = None
        if cfg.get("use_ema", False):
            self.ema_model = copy.deepcopy(self.model).eval()
            self.ema_model.requires_grad_(False)
        # DDP around the model, or the model (and EMA) sharded by FSDP
        self.train_model = self.plan.wrap(self.model, self.ema_model)
        if self.plan.fsdp and self.is_main:
            print(f"FSDP: {sharded_fraction(self.model):.0%} of parameter "
                  f"elements sharded over {self.plan.layout.dp} devices")
        self.optimizer = build_optimizer(cfg, self.model.parameters(),
                                         updates_per_epoch, self.plan)

        self.best_loss = float("inf")
        self.start_epoch = 1
        self.global_step = 0
        if resume_path:
            self.load_checkpoint(resume_path)
        if tracker is not None:
            self.tracker = tracker
        elif self.is_main:
            self.tracker = build_tracker(cfg, str(self.save_dir))
        else:
            self.tracker = NullTracker()
        self.step_timer = StepTimer()
        self.profile_dir = cfg.get("profile_dir")

    # ---------------------------------------------------------------- step
    def draw(self, shape: Sequence[int]
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """The step's random draws from the trainer's generator for a batch
        of `shape` (the model's space): timesteps t ~ U[0, T), the noise,
        and the CFG dropout mask (None when labels are not dropped); drawn
        for the global batch and cut to this rank's rows."""
        lay, gen = self.plan.layout, self.generator
        batch = shape[0] * lay.dp
        t = torch.randint(0, self.diffusion.num_timesteps, (batch,),
                          generator=gen, device=self.device)
        noise = torch.randn((batch, *shape[1:]), generator=gen,
                            device=self.device)
        drop = None
        if (self.conditional and self.cfg_dropout_prob > 0
                and self.num_classes is not None):
            drop = lay.rows(torch.rand(batch, generator=gen,
                                       device=self.device)
                            < self.cfg_dropout_prob)
        return lay.rows(t), lay.rows(noise), drop

    def randn_rows(self, shape: Sequence[int]) -> torch.Tensor:
        """This rank's rows of a normal draw from the trainer's generator
        over the global batch (`shape` this rank's)."""
        lay = self.plan.layout
        return lay.rows(torch.randn((shape[0] * lay.dp, *shape[1:]),
                                    generator=self.generator,
                                    device=self.device))

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
        model_fn = self.train_model
        moe_losses = []
        if self.moe_aux_weight > 0:
            def model_fn(x, tt, yy=None):
                return self.train_model(x, tt, yy, moe_losses=moe_losses)
        if self.sr is not None:
            if sr_noise is None and self.sr.noise_aug > 0:
                sr_noise = self.randn_rows(images.shape)
            cond = make_condition(self.sr, images.shape[1:3],
                                  hr_images=images, noise=sr_noise)
            model_fn = wrap_model_fn(model_fn, cond)
        if self.latent is not None:
            if encoder_noise is None:
                encoder_noise = self.randn_rows(shape)
            images = self.latent.encode(images, noise=encoder_noise)
        y = None
        if self.conditional:
            y = labels.to(torch.int64) + 1
            if drop is not None:
                y = torch.where(drop, torch.zeros_like(y), y)
        # gradients synchronised over 'data' on an update's micro-step only
        with self.plan.sync(self.train_model, self.optimizer.updates_next()):
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
        # the epoch's one host read, of the mean over 'data'
        self.epoch_means = self.plan.layout.mean_over_data(
            torch.stack(losses).mean(0)).cpu()
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
        Saved as `<sample_dir>/epoch_NNNN.png`. Every rank samples (a
        collective under FSDP and TP, and every rank's generator takes the
        same draws); rank 0 writes."""
        num_samples = num_samples or self.num_samples
        h, w = self.image_size
        shape = (num_samples, h, w, self.in_channels)
        nrow = max(1, int(math.sqrt(num_samples)))
        model = self.ema_model if self.ema_model is not None else self.model
        # the module, or its pipeline over the stages
        model_fn = self.plan.forward_fn(model)
        if self.sr is not None:
            model_fn = self.sr_wrap_for_sampling(model_fn, num_samples, nrow)
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
            if self.is_main:
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
        if self.is_main:
            save_path = self.sample_dir / f"epoch_{epoch:04d}.png"
            save_image_grid(samples, save_path, nrow=nrow)
            self.tracker.log_image("samples", str(save_path), step=epoch)
        return samples

    def sr_wrap_for_sampling(self, model, num_samples: int, nrow: int):
        """`model` conditioned on the cached first-batch images (tiled to
        `num_samples`), or None before any batch was seen. The first call
        saves the condition as `<sample_dir>/sr_condition.png`."""
        if self.sr_cond_images is None:
            if self.is_main:
                print("SR sample grid skipped: no train batch seen yet")
            return None
        src = self.sr_cond_images
        if len(src) < num_samples:
            src = np.tile(src, (-(-num_samples // len(src)), 1, 1, 1))
        cond = make_condition(
            self.sr, self.image_size,
            hr_images=torch.as_tensor(src[:num_samples], device=self.device),
            generator=self.generator)
        if not self.sr_cond_saved and self.is_main:
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
        `save_interval` epochs. Every rank gathers the full state (a
        collective under FSDP and TP); rank 0 writes."""
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
        if not names:
            return
        model_sd = self.plan.full_state_dict(self.model)
        ema_sd = (self.plan.full_state_dict(self.ema_model)
                  if self.ema_model is not None else None)
        opt_sd = self.optimizer.state_dict()
        if not self.is_main:
            return
        for name in names:
            ckpt_lib.save_checkpoint(
                self.save_dir / name, model_sd, self.config,
                ema_model_state_dict=ema_sd, epoch=epoch,
                best_loss=self.best_loss, optimizer_state_dict=opt_sd,
                global_step=self.global_step)

    def load_checkpoint(self, checkpoint_path) -> None:
        """Resume from a `.pth` (this trainer's or the reference's) or a JAX
        `.ckpt` (`restore_checkpoint`). A run resumed past its configured
        epochs is extended by that many epochs."""
        restore_checkpoint(self, checkpoint_path)
        say = print if self.is_main else (lambda *a: None)
        say(f"Resuming training from epoch {self.start_epoch}")
        if self.start_epoch > self.epochs:
            extend = self.config.get("epochs", 100)
            say(f"Checkpoint epoch ({self.start_epoch - 1}) is greater "
                f"than configured epochs ({self.epochs}).")
            say(f"Extending training by {extend} epochs...")
            self.epochs = self.start_epoch + extend
            say(f"New target epochs: {self.epochs}")

    # ---------------------------------------------------------------- loop
    def current_lr(self) -> float:
        return self.optimizer.lr_schedule(self.global_step // self.accum)

    def train(self) -> None:
        """The epoch loop: train, log, checkpoint, sample (rank 0 prints)."""
        say = print if self.is_main else (lambda *a: None)
        say(f"Starting training for {self.epochs} epochs on {self.device}")
        for epoch in range(self.start_epoch, self.epochs + 1):
            start_time = time.time()
            with profile_trace(self.profile_dir
                               if epoch == self.start_epoch else None):
                avg_loss = self.train_epoch(epoch)
            epoch_time = time.time() - start_time
            # a diverged run stops before the checkpoint rotation overwrites
            # the last good state
            if not math.isfinite(avg_loss):
                say(f"ERROR: non-finite loss ({avg_loss}) at epoch {epoch}; "
                    "stopping before overwriting checkpoints. Resume from "
                    f"{self.save_dir / 'current_model.pth'} with a lower "
                    "learning rate.")
                self.tracker.log({"train/diverged_epoch": epoch}, step=epoch)
                break
            lr = self.current_lr()
            details = self.epoch_details()
            parts = ", ".join(f"{k.split('/')[-1]} {v:.4f}"
                              for k, v in details.items())
            say(f"Epoch {epoch}/{self.epochs} - Loss: {avg_loss:.4f}"
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
                say(f"Generating samples at epoch {epoch}...")
                self.sample_images(epoch)
        say("Training completed!")
        self.tracker.finish()
