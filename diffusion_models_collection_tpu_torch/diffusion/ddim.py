"""DDIM sampler (Song et al., 2020).

Counterpart of `diffusion_models_collection_tpu/diffusion/ddim.py`: the same
grid round(linspace(T-1, 0, S)), eta-sigma stochasticity and final step
(t_next = -1 means alpha_bar_next = 1), with classifier-free guidance as
one model call on the [cond; uncond] batch. The JAX package runs the steps
as one `lax.scan`; here they are a Python loop that launches asynchronously
on the model's device. eta > 0 draws its noise from the caller's
`torch.Generator`; `init_noise` replaces the initial draw.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import base
from .schedule import NoiseSchedule, ddim_timesteps, extract


def ddim_step(schedule: NoiseSchedule, x: torch.Tensor, t: torch.Tensor,
              t_next: torch.Tensor, eps: torch.Tensor, x0_pred: torch.Tensor,
              eta: float, noise: Optional[torch.Tensor]) -> torch.Tensor:
    """One DDIM update; `t_next` entries of -1 select alpha_bar = 1."""
    bshape = (-1, *((1,) * (x.ndim - 1)))
    alpha_t = extract(schedule.alphas_cumprod, t, x.ndim)
    alpha_next = torch.where(
        (t_next >= 0).reshape(bshape),
        extract(schedule.alphas_cumprod, t_next.clamp(min=0), x.ndim),
        torch.ones_like(alpha_t),
    )
    sigma = eta * torch.sqrt(torch.clamp(
        (1 - alpha_next) / (1 - alpha_t) * (1 - alpha_t / alpha_next),
        min=0.0))
    dir_xt = torch.sqrt(torch.clamp(1 - alpha_next - sigma**2, min=0.0)) * eps
    x_prev = torch.sqrt(alpha_next) * x0_pred + dir_xt
    if eta > 0:
        x_prev = x_prev + sigma * noise
    return x_prev


class DDIM(base.ScheduledProcess):
    """DDIM diffusion process: the JAX class's sampling API. Training runs
    on `DDPM`, as in the JAX package."""

    def __init__(
        self,
        num_timesteps: int = 1000,
        num_inference_steps: int = 50,
        beta_start: float = 1e-4,
        beta_end: float = 0.02,
        beta_schedule: str = "linear",
        eta: float = 0.0,
        prediction_type: str = "eps",
        zero_terminal_snr: bool = False,
        timestep_spacing: str = "uniform",
        guidance_rescale: float = 0.0,
        clip_sample: bool = True,
        cfg_interval=None,
    ):
        if prediction_type not in base.VALID_PREDICTION_TYPES:
            raise ValueError(f"Unknown prediction type: {prediction_type!r} "
                             f"(expected one of "
                             f"{base.VALID_PREDICTION_TYPES})")
        if zero_terminal_snr and prediction_type == "eps":
            raise ValueError(
                "zero_terminal_snr requires prediction_type 'v' or 'x0': at "
                "SNR = 0 an eps-prediction carries no signal to denoise from")
        if timestep_spacing != "uniform":
            raise NotImplementedError(
                f"timestep_spacing {timestep_spacing!r} is not ported yet "
                "(karras_timesteps, ROADMAP queue 1 item 3)")
        self.num_timesteps = num_timesteps
        self.eta = float(eta)
        self.prediction_type = prediction_type
        self.guidance_rescale = base.validate_guidance_rescale(guidance_rescale)
        self.clip_sample = bool(clip_sample)
        self.cfg_interval = base.validate_cfg_interval(cfg_interval,
                                                       num_timesteps)
        self.schedule = NoiseSchedule.create(
            num_timesteps, beta_start, beta_end, beta_schedule,
            zero_terminal_snr=zero_terminal_snr)
        self.set_inference_steps(num_inference_steps)

    def set_inference_steps(self, num_inference_steps: int):
        self.num_inference_steps = num_inference_steps
        self.inference_timesteps = ddim_timesteps(self.num_timesteps,
                                                  num_inference_steps)

    @torch.no_grad()
    def _run(self, model_fn, shape, generator, y, cfg_scale, init_noise, *,
             use_cfg, p_threshold, progress, desc):
        if init_noise is not None:
            img = init_noise.to(torch.float32)
        else:
            if generator is None:
                raise ValueError("pass a torch.Generator or init_noise")
            img = torch.randn(tuple(shape), generator=generator,
                              device=generator.device, dtype=torch.float32)
        device = img.device
        schedule = self.schedule_on(device)
        pair_fn = base.wrap_model_as_eps_x0(schedule, model_fn,
                                            self.prediction_type)
        if y is not None:
            y = torch.as_tensor(y, device=device)
        steps = self.inference_timesteps.tolist()
        batch = img.shape[0]
        for i, t_i in enumerate(steps):
            t_next_i = steps[i + 1] if i + 1 < len(steps) else -1
            t = torch.full((batch,), t_i, dtype=torch.int64, device=device)
            t_next = torch.full((batch,), t_next_i, dtype=torch.int64,
                                device=device)
            if use_cfg:
                eps, x0 = base.cfg_eps_x0(
                    pair_fn, img, t, y, cfg_scale,
                    guidance_rescale=self.guidance_rescale, schedule=schedule,
                    cfg_interval=self.cfg_interval)
                x0 = base.constrain_x0(x0, p_threshold, self.clip_sample)
            else:
                eps, x0 = pair_fn(img, t, y)
                if self.clip_sample:
                    x0 = torch.clamp(x0, -1.0, 1.0)
            noise = None
            if self.eta > 0:
                if generator is None:
                    raise ValueError("eta > 0 needs a torch.Generator")
                noise = torch.randn(img.shape, generator=generator,
                                    device=generator.device).to(device)
            img = ddim_step(schedule, img, t, t_next, eps, x0, self.eta, noise)
            if progress and (i + 1) % max(1, len(steps) // 5) == 0:
                print(f"{desc}: step {i + 1}/{len(steps)}", flush=True)
        return img

    def sample(self, model_fn, shape, generator=None, y=None,
               init_noise=None, progress: bool = False) -> torch.Tensor:
        """Unguided DDIM: (B, H, W, C)."""
        return self._run(model_fn, shape, generator, y, 0.0, init_noise,
                         use_cfg=False, p_threshold=None, progress=progress,
                         desc="DDIM Sampling")

    def sample_with_cfg(self, model_fn, shape, y, generator=None,
                        cfg_scale: float = 3.0,
                        p_threshold=base.AUTO_THRESHOLD, init_noise=None,
                        progress: bool = False) -> torch.Tensor:
        """DDIM with classifier-free guidance on labels `y` (shifted +1) and
        dynamic thresholding of x0 (p = 0.995 by default in pixel space)."""
        if y is None:
            raise ValueError("CFG sampling requires class labels y.")
        p_threshold = base.resolve_p_threshold(p_threshold, self.clip_sample)
        return self._run(model_fn, shape, generator, y, float(cfg_scale),
                         init_noise, use_cfg=True, p_threshold=p_threshold,
                         progress=progress,
                         desc=f"DDIM sampling with CFG scale {cfg_scale}")
