"""DDIM sampler (Song et al., 2020).

Counterpart of `diffusion_models_collection_tpu/diffusion/ddim.py`: the same
grid round(linspace(T-1, 0, S)), eta-sigma stochasticity and final step
(t_next = -1 means alpha_bar_next = 1), with classifier-free guidance as
one model call on the [cond; uncond] batch. The grid is
`timestep_spacing`'s: uniform, or Karras-spaced (`karras_timesteps`). The
JAX package runs the steps as one `lax.scan`; here they are a Python loop
that launches asynchronously on the model's device. eta > 0 draws its noise
from the caller's `torch.Generator`, or takes it from `noises`, one tensor
a step; `init_noise` replaces the initial draw.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import base
from .schedule import NoiseSchedule, extract


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


class DDIM(base.FastVPSampler):
    """DDIM diffusion process: the JAX class's sampling API on a uniform or
    Karras grid (`sample`, `sample_with_cfg`, `p_sample`) and the training
    API it shares with DDPM (`q_sample`, `p_losses`)."""

    DESC = "DDIM sampling"

    def __init__(self, num_timesteps: int = 1000,
                 num_inference_steps: int = 50, eta: float = 0.0, **common):
        self.eta = float(eta)
        super().__init__(num_inference_steps=num_inference_steps,
                         num_timesteps=num_timesteps, **common)

    def p_sample(self, model_fn, x, t, t_next, noise=None, y=None,
                 clip_denoised: bool = True, eps=None, x0_pred=None):
        """One DDIM step from x_t to x_{t_next} (t_next -1: the clean
        image); `noise` is the eta > 0 draw."""
        schedule = self.schedule_on(x.device)
        if eps is None:
            eps, pair_x0 = self.pair_fn(model_fn, x.device)(x, t, y)
            if x0_pred is None:
                x0_pred = pair_x0
        if x0_pred is None:
            x0_pred = base.predict_x0_from_eps(schedule, x, t, eps)
        if clip_denoised:
            x0_pred = torch.clamp(x0_pred, -1.0, 1.0)
        if self.eta > 0 and noise is None:
            raise ValueError("eta > 0 needs the step's noise")
        return ddim_step(schedule, x, t, t_next, eps, x0_pred, self.eta,
                         noise)

    @torch.no_grad()
    def _solve(self, eps_x0, img, generator, noises, return_all_timesteps,
               progress, desc):
        device = img.device
        schedule = self.schedule_on(device)
        steps = self.inference_timesteps.tolist()
        if self.eta > 0:
            base.check_noises(noises, len(steps))
        out = base.Trajectory(return_all_timesteps)
        batch = img.shape[0]
        for i, t_i in enumerate(steps):
            t_next_i = steps[i + 1] if i + 1 < len(steps) else -1
            t = torch.full((batch,), t_i, dtype=torch.int64, device=device)
            t_next = torch.full((batch,), t_next_i, dtype=torch.int64,
                                device=device)
            eps, x0 = eps_x0(img, t)
            noise = (base.step_noise(noises, i, img, generator)
                     if self.eta > 0 else None)
            img = ddim_step(schedule, img, t, t_next, eps, x0, self.eta, noise)
            out.add(img)
            base.report_progress(progress, desc, i + 1, len(steps))
        return out.result()
