"""Latent-diffusion codec: a frozen, trained KL-VAE wrapped for the trainer,
the sampling, evaluation and serving entry points.

Counterpart of `diffusion_models_collection_tpu/utils/latent.py`. Stage 2 of
latent diffusion: a diffusion config sets `latent_diffusion: true` and
`vae_checkpoint: <stage-1 checkpoint>`, and every entry point moves the
denoiser into the VAE's latent space: images are encoded (a posterior sample
in training, the mode at the img2img entry), the denoiser sees (H/f, W/f,
latent_channels) arrays, and sampled latents are decoded back to pixels.
`latent_scale_factor` rescales latents towards unit variance before
diffusion (LDM's sigma normalisation); 1/scale is applied before decoding.

The VAE runs in eval mode under `torch.no_grad()` on the device the caller
names (its GroupNorm+SiLU and attention through the kernels on a card), in
its own config's `mixed_precision`, with its EMA weights where the checkpoint
has them. A checkpoint is loaded once per process and device (and again
only if the file changes). The port's trainers write `.pth`; the shipped
`configs/cifar10_latent_unet.py` names the JAX trainer's `best_model.ckpt`.
Where the named file is missing and a `.pth` of the same stem lies beside
it, that `.pth` is read, and the load says so; so the repo's two configs run
end to end in the port as they do in the JAX package.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path
from typing import Optional, Tuple, Union

import torch

from . import checkpoint as ckpt_lib


@functools.lru_cache(maxsize=8)
def _load_vae(abspath: str, stamp: Tuple[int, int], device: str):
    """(VAE in eval mode on `device`, its config) of a checkpoint, built
    once per (file, version `stamp`, device)."""
    payload = ckpt_lib.load_checkpoint(abspath)
    vae_config = payload.get("config") or {}
    if str(vae_config.get("model_type", "")).lower() != "vae":
        raise ValueError(
            f"{abspath} is not a VAE checkpoint "
            f"(model_type={vae_config.get('model_type')!r}); train one "
            "with a `model_type: 'vae'` config first")
    from ..factory import get_model  # deferred: the factory imports this

    model = get_model(vae_config)
    state = payload.get("ema_model_state_dict")
    if state is None:
        state = payload["model_state_dict"]
    model.load_state_dict(state, strict=True)
    model.requires_grad_(False)
    return model.to(device).eval(), vae_config


def load_vae(path: Union[str, Path], device: Union[str, torch.device]):
    """(the frozen VAE of the checkpoint at `path` on `device`, its
    config). A missing file is replaced by the `.pth` of its stem where one
    exists."""
    path = Path(path).resolve()
    if not path.exists():
        beside = path.with_suffix(".pth")
        if path.suffix == ".pth" or not beside.exists():
            raise FileNotFoundError(f"vae_checkpoint {path} does not exist")
        print(f"vae_checkpoint {path} does not exist; reading {beside}, "
              "the .pth of its stem that the port's trainers write")
        path = beside
    stat = os.stat(path)
    return _load_vae(str(path), (stat.st_mtime_ns, stat.st_size),
                     str(torch.device(device)))


class LatentCodec:
    """Frozen encode and decode views of a trained VAE checkpoint on one
    device. Images are NHWC in [-1, 1], latents NHWC, both float32."""

    def __init__(self, vae_checkpoint: Union[str, Path],
                 scale_factor: float = 1.0, *,
                 device: Union[str, torch.device]):
        self.scale = float(scale_factor)
        if self.scale <= 0.0:
            raise ValueError("latent_scale_factor must be positive")
        self.device = torch.device(device)
        self.model, self.vae_config = load_vae(vae_checkpoint, self.device)

    @classmethod
    def from_config(cls, config: dict, *,
                    device: Union[str, torch.device]
                    ) -> Optional["LatentCodec"]:
        """The codec of a diffusion config on `device`, or None when the
        config is not latent."""
        if not config.get("latent_diffusion"):
            return None
        path = config.get("vae_checkpoint")
        if not path:
            raise ValueError(
                "latent_diffusion: true needs a `vae_checkpoint` config key")
        return cls(path, config.get("latent_scale_factor", 1.0),
                   device=device)

    # ------------------------------------------------------------- geometry
    def latent_hw(self) -> Tuple[int, int]:
        return self.model.latent_hw()

    @property
    def latent_channels(self) -> int:
        return self.model.latent_channels

    @property
    def in_channels(self) -> int:
        """The pixel images' channels."""
        return self.model.in_channels

    def latent_shape(self, batch: int) -> Tuple[int, int, int, int]:
        lh, lw = self.latent_hw()
        return (batch, lh, lw, self.latent_channels)

    # ----------------------------------------------------------- transforms
    @torch.no_grad()
    def encode(self, x: torch.Tensor,
               generator: Optional[torch.Generator] = None, *,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Pixel batch -> scaled posterior SAMPLE (the training encode):
        (mean + exp(logvar / 2) * noise) * scale, the noise drawn from
        `generator` on the codec's device unless given."""
        mean, logvar = self.model.encode(x.to(self.device))
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=self.device)
        return (mean + torch.exp(0.5 * logvar)
                * noise.to(self.device)) * self.scale

    @torch.no_grad()
    def encode_mode(self, x: torch.Tensor) -> torch.Tensor:
        """Pixel batch -> scaled posterior MODE (the img2img encode)."""
        mean, _ = self.model.encode(x.to(self.device))
        return mean * self.scale

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latent batch -> pixel batch, on the codec's device."""
        return self.model.decode(z.to(self.device) / self.scale)

    def decode_trajectory(self, z: torch.Tensor) -> torch.Tensor:
        """(S, B, lh, lw, C) latent trajectory -> (S, B, H, W, C) pixel
        frames on the host, decoded one step at a time (a flattened S * B
        batch would hold every frame on the card at once)."""
        return torch.stack([self.decode(z[s]).cpu()
                            for s in range(z.shape[0])])
