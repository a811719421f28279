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


class DDPM(base.VPProcess):
    """DDPM diffusion process: the JAX class's training API (`q_sample`,
    `p_losses`), its one-step `p_sample` and its samplers (`sample`,
    `sample_with_cfg`) over all T steps."""

    DESC = "DDPM sampling"

    def p_sample(self, model_fn, x, t, noise, y=None,
                 clip_denoised: bool = True, eps=None, x0_pred=None):
        """One ancestral step x_t -> x_{t-1} with the step's `noise`; x0
        from the model unless `x0_pred` or `eps` is given."""
        schedule = self.schedule_on(x.device)
        if x0_pred is None:
            if eps is None:
                _, x0_pred = self.pair_fn(model_fn, x.device)(x, t, y)
            else:
                x0_pred = base.predict_x0_from_eps(schedule, x, t, eps)
        if clip_denoised:
            x0_pred = torch.clamp(x0_pred, -1.0, 1.0)
        return posterior_step(schedule, x, t, x0_pred, noise)

    @torch.no_grad()
    def _solve(self, eps_x0, img, generator, noises, return_all_timesteps,
               progress, desc):
        base.check_noises(noises, self.num_timesteps)
        device = img.device
        schedule = self.schedule_on(device)
        out = base.Trajectory(return_all_timesteps)
        batch = img.shape[0]
        for i, t_i in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((batch,), t_i, dtype=torch.int64, device=device)
            _, x0 = eps_x0(img, t)
            noise = base.step_noise(noises, i, img, generator)
            img = posterior_step(schedule, img, t, x0, noise)
            out.add(img)
            base.report_progress(progress, desc, i + 1, self.num_timesteps,
                                 every=10)
        return out.result()
