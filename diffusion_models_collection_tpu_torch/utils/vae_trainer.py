"""Trainer of the first stage of latent diffusion, the KL-VAE.

Counterpart of `diffusion_models_collection_tpu/utils/vae_trainer.py` on one
device. A step: the reparameterised forward with noise drawn from the
trainer's generator (or passed in, as the parity tests do), the loss
mse(reconstruction, x) + `kl_weight` * KL (`kl_weight` 1e-4 by default, as
LDM trains its KL autoencoders), backward, then `DiffusionTrainer`'s clip,
AdamW or Adam, EMA (once per optimizer update, also under gradient
accumulation), epoch loop, non-finite stop and checkpoint schema and gates
(`save_current_interval`, `save_best`, `save_interval`; `.pth`). Resuming
follows the JAX VAE trainer, not the diffusion trainer: the run continues
at the checkpoint's epoch + 1 up to the configured `epochs` and is never
extended, so a resume at or past `epochs` trains nothing.
The epoch log carries the mean reconstruction and KL terms beside the loss;
every `sample_interval` epochs from `sample_start_epoch` (1 by default) it
writes `<sample_dir>/vae_epoch_NNNN.png`: the loader's first batch, drawn
once at the first sampled epoch and kept, over its posterior-mode
reconstructions. A diffusion config then points `vae_checkpoint` at the
checkpoint (`utils/latent.py`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.vae import kl_divergence
from .ema import ema_update
from .helpers import save_image_grid
from .trainer import DiffusionTrainer, restore_checkpoint


class VAETrainer(DiffusionTrainer):
    """Trainer for the `model_type: 'vae'` stage; `train()` runs the epochs,
    `train_step` is one step. Data parallel only, as the JAX trainer."""

    model_parallel = False

    def __init__(self, model: torch.nn.Module, train_loader, config: dict,
                 device, generator: torch.Generator = None,
                 resume_path: Optional[str] = None, tracker=None):
        super().__init__(model, None, train_loader, config, device,
                         generator=generator, resume_path=resume_path,
                         tracker=tracker)
        self.kl_weight = float(config.get("kl_weight", 1e-4))
        self.sample_start_epoch = config.get("sample_start_epoch", 1)
        self.num_samples = config.get("num_samples", 8)
        self.grid_batch = None  # the reconstruction grid's images, kept

    def load_checkpoint(self, checkpoint_path) -> None:
        """Resume at the checkpoint's epoch + 1 (`restore_checkpoint`), with
        no extension past the configured `epochs`."""
        restore_checkpoint(self, checkpoint_path)
        if self.is_main:
            print(f"Resuming VAE training from epoch {self.start_epoch}")

    def draw(self, shape):
        """The step's reparameterisation noise for a pixel batch of
        `shape`, from the trainer's generator (this rank's rows of the
        global batch's)."""
        lh, lw = self.model.latent_hw()
        return self.randn_rows((shape[0], lh, lw,
                                self.model.latent_channels))

    def train_step(self, images: torch.Tensor, labels=None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step on a device batch of images (B, H, W, C) in [-1, 1]
        (`labels` are ignored: the VAE is unconditional). Returns (loss,
        reconstruction, KL), on the device."""
        self.model.train()
        if noise is None:
            noise = self.draw(images.shape)
        with self.plan.sync(self.train_model, self.optimizer.updates_next()):
            recon, mean, logvar = self.train_model(images, noise)
            rec = torch.mean((recon - images) ** 2)
            kl = kl_divergence(mean, logvar)
            loss = rec + self.kl_weight * kl
            loss.backward()
        if self.optimizer.step() and self.ema_model is not None:
            ema_update(self.ema_model.parameters(), self.model.parameters(),
                       self.ema_decay)
        self.global_step += 1
        return torch.stack([loss, rec, kl]).detach()

    def epoch_details(self) -> dict:
        if self.epoch_means is None:
            return {}
        rec, kl = self.epoch_means[1:].tolist()
        return {"train/recon_loss": rec, "train/kl": kl}

    @torch.no_grad()
    def reconstruction_grid(self, epoch: int, images) -> np.ndarray:
        """Save the first `num_samples` of `images` over their
        posterior-mode reconstructions by the EMA model (the model without
        EMA) as `<sample_dir>/vae_epoch_NNNN.png`; returns the grid's
        images in [0, 1]."""
        x = torch.as_tensor(np.asarray(images[:self.num_samples],
                                       np.float32), device=self.device)
        model = self.ema_model if self.ema_model is not None else self.model
        was_training = model.training
        model.eval()
        mean, _ = model.encode(x)
        recon = model.decode(mean)
        model.train(was_training)
        grid = np.clip((torch.cat([x, recon]).cpu().numpy() + 1) / 2, 0, 1)
        if self.is_main:
            path = self.sample_dir / f"vae_epoch_{epoch:04d}.png"
            save_image_grid(grid, path, nrow=len(x))
            self.tracker.log_image("vae_recon", str(path), step=epoch)
        return grid

    def sample_images(self, epoch: int) -> np.ndarray:
        """The VAE's in-training grid: `reconstruction_grid` of the
        loader's first batch, drawn at the first sampled epoch and reused at
        every later one."""
        if self.grid_batch is None:
            self.grid_batch, _ = next(iter(self.train_loader))
        return self.reconstruction_grid(epoch, self.grid_batch)
