"""DDPM (Ho et al., 2020): the training objective and ancestral sampling.

Counterpart of `diffusion_models_collection_tpu/diffusion/ddpm.py`: the same
posterior step (mean from the posterior coefficients, noise scaled by
exp(0.5 * clipped log-variance) and masked at t = 0), x0 clamp or dynamic
thresholding, and classifier-free guidance as one model call on the
[cond; uncond] batch. The JAX package runs the T steps as `lax.scan`s in
segments of at most 250 (a TPU runtime limit); here they are one Python loop
that launches asynchronously on the model's device. Each step's noise comes
from the caller's `torch.Generator`, or from `noises`, one tensor per step
in the order the steps run (t = T-1 down to 0), which the parity tests use
to feed both packages the same draws.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import base
from .schedule import NoiseSchedule, extract


def posterior_step(schedule: NoiseSchedule, x: torch.Tensor, t: torch.Tensor,
                   x0_pred: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """One ancestral step x_t -> x_{t-1}: posterior mean c1[t] x0 + c2[t]
    x_t, plus exp(0.5 logvar[t]) noise except where t == 0."""
    c1 = extract(schedule.posterior_mean_coef1, t, x.ndim)
    c2 = extract(schedule.posterior_mean_coef2, t, x.ndim)
    mean = c1 * x0_pred + c2 * x
    logvar = extract(schedule.posterior_log_variance_clipped, t, x.ndim)
    nonzero = (t != 0).reshape(-1, *((1,) * (x.ndim - 1))).to(x.dtype)
    return mean + nonzero * torch.exp(0.5 * logvar) * noise


class DDPM(base.ScheduledProcess):
    """DDPM diffusion process: the JAX class's training API (`q_sample`,
    `p_losses`) and its samplers (`sample`, `sample_with_cfg`)."""

    def __init__(
        self,
        num_timesteps: int = 1000,
        beta_start: float = 1e-4,
        beta_end: float = 0.02,
        beta_schedule: str = "linear",
        prediction_type: str = "eps",
        loss_weighting: str = "uniform",
        min_snr_gamma: float = 5.0,
        zero_terminal_snr: bool = False,
        guidance_rescale: float = 0.0,
        clip_sample: bool = True,
        cfg_interval=None,
    ):
        if prediction_type not in base.VALID_PREDICTION_TYPES:
            raise base.invalid_choice("prediction type", prediction_type,
                                      base.VALID_PREDICTION_TYPES)
        if loss_weighting not in base.VALID_LOSS_WEIGHTINGS:
            raise base.invalid_choice("loss weighting", loss_weighting,
                                      base.VALID_LOSS_WEIGHTINGS)
        if zero_terminal_snr and prediction_type == "eps":
            raise ValueError(
                "zero_terminal_snr requires prediction_type 'v' or 'x0': at "
                "SNR = 0 an eps-prediction carries no signal to denoise from")
        self.num_timesteps = num_timesteps
        self.prediction_type = prediction_type
        self.loss_weighting = loss_weighting
        self.min_snr_gamma = float(min_snr_gamma)
        self.guidance_rescale = base.validate_guidance_rescale(guidance_rescale)
        self.clip_sample = bool(clip_sample)
        self.cfg_interval = base.validate_cfg_interval(cfg_interval,
                                                       num_timesteps)
        self.schedule = NoiseSchedule.create(
            num_timesteps, beta_start, beta_end, beta_schedule,
            zero_terminal_snr=zero_terminal_snr)

    # -- training --------------------------------------------------------
    def q_sample(self, x_start, t, noise):
        return base.q_sample(self.schedule_on(x_start.device), x_start, t,
                             noise)

    def p_losses(self, model_fn, x_start, t, noise, y=None, loss_type="l2"):
        return base.p_losses(
            self.schedule_on(x_start.device), model_fn, x_start, t, noise,
            y=y, loss_type=loss_type, prediction_type=self.prediction_type,
            weighting=self.loss_weighting, snr_gamma=self.min_snr_gamma)

    # -- sampling --------------------------------------------------------
    @torch.no_grad()
    def _run(self, model_fn, shape, generator, y, cfg_scale, init_noise,
             noises, *, use_cfg, p_threshold, progress, desc):
        if init_noise is not None:
            img = init_noise.to(torch.float32)
        else:
            if generator is None:
                raise ValueError("pass a torch.Generator or init_noise")
            img = torch.randn(tuple(shape), generator=generator,
                              device=generator.device, dtype=torch.float32)
        if noises is None and generator is None:
            raise ValueError("pass a torch.Generator or the per-step noises")
        if noises is not None and len(noises) != self.num_timesteps:
            raise ValueError(f"noises: {len(noises)} given for "
                             f"{self.num_timesteps} steps")
        device = img.device
        schedule = self.schedule_on(device)
        pair_fn = base.wrap_model_as_eps_x0(schedule, model_fn,
                                            self.prediction_type)
        if y is not None:
            y = torch.as_tensor(y, device=device)
        batch = img.shape[0]
        for i, t_i in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((batch,), t_i, dtype=torch.int64, device=device)
            if use_cfg:
                _, x0 = base.cfg_eps_x0(
                    pair_fn, img, t, y, cfg_scale,
                    guidance_rescale=self.guidance_rescale, schedule=schedule,
                    cfg_interval=self.cfg_interval)
                x0 = base.constrain_x0(x0, p_threshold, self.clip_sample)
            else:
                _, x0 = pair_fn(img, t, y)
                if self.clip_sample:
                    x0 = torch.clamp(x0, -1.0, 1.0)
            if noises is not None:
                noise = noises[i].to(device, torch.float32)
            else:
                noise = torch.randn(img.shape, generator=generator,
                                    device=generator.device).to(device)
            img = posterior_step(schedule, img, t, x0, noise)
            if progress and (i + 1) % max(1, self.num_timesteps // 10) == 0:
                print(f"{desc}: step {i + 1}/{self.num_timesteps}", flush=True)
        return img

    def sample(self, model_fn, shape, generator=None, y=None,
               init_noise=None, noises: Optional[Sequence] = None,
               progress: bool = False) -> torch.Tensor:
        """Ancestral sampling over all T steps: (B, H, W, C)."""
        return self._run(model_fn, shape, generator, y, 0.0, init_noise,
                         noises, use_cfg=False, p_threshold=None,
                         progress=progress, desc="Sampling")

    def sample_with_cfg(self, model_fn, shape, y, generator=None,
                        cfg_scale: float = 3.0,
                        p_threshold=base.AUTO_THRESHOLD, init_noise=None,
                        noises: Optional[Sequence] = None,
                        progress: bool = False) -> torch.Tensor:
        """Ancestral sampling with classifier-free guidance on labels `y`
        (shifted +1) and dynamic thresholding of x0 (p = 0.995 by default in
        pixel space)."""
        if y is None:
            raise ValueError("CFG sampling requires class labels y.")
        p_threshold = base.resolve_p_threshold(p_threshold, self.clip_sample)
        return self._run(model_fn, shape, generator, y, float(cfg_scale),
                         init_noise, noises, use_cfg=True,
                         p_threshold=p_threshold, progress=progress,
                         desc=f"DDPM Sampling with CFG scale {cfg_scale}")
