"""Consistency models (Song et al. 2023): the consistency function, the
distillation and training losses, and the multistep sampler.

Counterpart of `diffusion_models_collection_tpu/diffusion/consistency.py`.
The consistency function maps any point of the probability-flow ODE
trajectory to its origin,

    f(x_t, t) = c_skip(t) x_t + c_out(t) x0_hat(x_t, t),
    c_skip = sd^2 / (s^2 + sd^2),  c_out = s / sqrt(s^2 + sd^2),
    s = t / timestep_scaling,

so f(x, 0) = x exactly. x0_hat is the model's x0 view
(`base.wrap_model_as_eps_x0`), so every `prediction_type` works.

Distillation (paper Alg. 2) regresses f_theta(z_t, t) onto the target
network's f(z_hat, t_next), z_hat one teacher DDIM step from z_t (guided at
`distill_cfg_scale` when it is > 0); training (Alg. 3) onto f(z_next,
t_next), z_t and z_next noised from the same data with the same noise. The
distance is the pseudo-Huber sqrt(mean d^2 + c^2) - c per sample, or L2.

Sampling (Alg. 1, multistep): x0 = f(x_T, T - 1), then for each later grid
time re-noise x0 to it and map back. The grid is the S interior points of
the (S + 1)-point DDIM grid. Classifier-free guidance is applied to f on
one [cond; uncond] batch (f is affine in the model's x0 at fixed x, t). The
re-noising draws come from the caller's `torch.Generator`, or from
`noises`, one tensor a step after the first.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from . import base
from .ddim import ddim_step
from .schedule import NoiseSchedule, ddim_timesteps, extract

VALID_WEIGHTINGS = ("uniform", "inverse_gap")


def consistency_scalings(t: torch.Tensor, ndim: int, sigma_data: float = 0.5,
                         timestep_scaling: float = 10.0):
    """(c_skip, c_out) at integer timesteps t, shaped (B, 1, ..., 1); at
    t = 0 exactly (1, 0)."""
    s = (t.to(torch.float32) / float(timestep_scaling)).reshape(
        -1, *((1,) * (ndim - 1)))
    sd2 = float(sigma_data) ** 2
    return sd2 / (s**2 + sd2), s / torch.sqrt(s**2 + sd2)


def consistency_apply(pair_fn: Callable, x: torch.Tensor, t: torch.Tensor,
                      y, sigma_data: float,
                      timestep_scaling: float) -> torch.Tensor:
    """f(x, t) = c_skip x + c_out x0_hat on the model's x0 view."""
    _, x0 = pair_fn(x, t, y)
    c_skip, c_out = consistency_scalings(t, x.ndim, sigma_data,
                                         timestep_scaling)
    return c_skip * x + c_out * x0


def cd_grids(num_timesteps: int, grid_size: int):
    """Adjacent (t, t_next) pairs of the `grid_size`-point DDIM grid,
    int64; the last pair ends at t = 0."""
    if grid_size < 2:
        raise ValueError("consistency grid needs >= 2 points")
    grid = ddim_timesteps(num_timesteps, grid_size)
    return grid[:-1], grid[1:]


def pseudo_huber(diff: torch.Tensor, c: float) -> torch.Tensor:
    """Per-sample sqrt(mean(d^2) + c^2) - c (Song & Dhariwal 2023)."""
    ms = (diff**2).mean(dim=tuple(range(1, diff.ndim)))
    return torch.sqrt(ms + c * c) - c


def _per_sample(diff: torch.Tensor, loss_type: str,
                huber_c: float) -> torch.Tensor:
    if loss_type == "huber":
        return pseudo_huber(diff, float(huber_c))
    if loss_type == "l2":
        return (diff**2).mean(dim=tuple(range(1, diff.ndim)))
    raise ValueError(f"Unknown consistency loss_type: {loss_type!r}")


def consistency_distill_loss(schedule: NoiseSchedule, student_pair_fn,
                             target_pair_fn, teacher_pair_fn,
                             z: torch.Tensor, t: torch.Tensor,
                             t_next: torch.Tensor, y, *, sigma_data: float,
                             timestep_scaling: float,
                             distill_cfg_scale: float = 0.0,
                             loss_type: str = "huber",
                             huber_c: float = 0.03) -> torch.Tensor:
    """One consistency-distillation step's loss: the teacher's eta 0 DDIM
    step z_t -> z_hat (one call on the [cond; uncond] batch when guided),
    the target's f at (z_hat, t_next) without a gradient, the student's at
    (z, t)."""
    with torch.no_grad():
        if distill_cfg_scale and distill_cfg_scale > 0.0:
            if y is None:
                raise ValueError("guided distillation needs labels y")
            eps, x0 = base.cfg_eps_x0(teacher_pair_fn, z, t, y,
                                      float(distill_cfg_scale))
        else:
            eps, x0 = teacher_pair_fn(z, t, y)
        z_hat = ddim_step(schedule, z, t, t_next, eps, x0, 0.0, None)
        f_target = consistency_apply(target_pair_fn, z_hat, t_next, y,
                                     sigma_data, timestep_scaling)
    f_student = consistency_apply(student_pair_fn, z, t, y, sigma_data,
                                  timestep_scaling)
    return _per_sample(f_student - f_target, loss_type, huber_c).mean()


def consistency_training_loss(schedule: NoiseSchedule, student_pair_fn,
                              target_pair_fn, x0: torch.Tensor,
                              noise: torch.Tensor, t: torch.Tensor,
                              t_next: torch.Tensor, y, *, sigma_data: float,
                              timestep_scaling: float,
                              loss_type: str = "huber", huber_c: float = 0.03,
                              weighting: str = "uniform") -> torch.Tensor:
    """One consistency-training step's loss: z_t and z_next from the same
    x0 and noise, the target's f at (z_next, t_next) without a gradient,
    the student's at (z_t, t); `weighting` 'inverse_gap' divides each
    sample's distance by (t - t_next) / timestep_scaling (iCT)."""
    z_t = base.q_sample(schedule, x0, t, noise)
    with torch.no_grad():
        z_next = base.q_sample(schedule, x0, t_next, noise)
        f_target = consistency_apply(target_pair_fn, z_next, t_next, y,
                                     sigma_data, timestep_scaling)
    f_student = consistency_apply(student_pair_fn, z_t, t, y, sigma_data,
                                  timestep_scaling)
    per_sample = _per_sample(f_student - f_target, loss_type, huber_c)
    if weighting == "inverse_gap":
        gap = (t - t_next).to(torch.float32) / float(timestep_scaling)
        per_sample = per_sample / torch.clamp(gap, min=1e-8)
    elif weighting != "uniform":
        raise ValueError(f"Unknown ct weighting: {weighting!r} "
                         "(expected 'uniform' or 'inverse_gap')")
    return per_sample.mean()


class ConsistencyModel(base.ScheduledProcess):
    """The consistency-model process, sampling side, with DDIM's API
    (`sample`, `sample_with_cfg`, `set_inference_steps`). The factory
    builds it for checkpoints of `diffusion_type: 'consistency'` whatever
    sampling method is asked for: the checkpoint owns its stack and its
    step count (`num_inference_steps`, 2 by default)."""

    def __init__(self, num_timesteps: int = 1000,
                 num_inference_steps: int = 2, beta_start: float = 1e-4,
                 beta_end: float = 0.02, beta_schedule: str = "linear",
                 prediction_type: str = "eps", sigma_data: float = 0.5,
                 timestep_scaling: float = 10.0,
                 zero_terminal_snr: bool = False, clip_sample: bool = True):
        if prediction_type not in base.VALID_PREDICTION_TYPES:
            raise base.invalid_choice("prediction type", prediction_type,
                                      base.VALID_PREDICTION_TYPES)
        self.num_timesteps = num_timesteps
        self.prediction_type = prediction_type
        self.sigma_data = float(sigma_data)
        self.timestep_scaling = float(timestep_scaling)
        self.clip_sample = bool(clip_sample)
        self.schedule = NoiseSchedule.create(
            num_timesteps, beta_start, beta_end, beta_schedule,
            zero_terminal_snr=zero_terminal_snr)
        self.set_inference_steps(num_inference_steps)

    def set_inference_steps(self, num_inference_steps: int):
        """The S-step grid: the (S + 1)-point DDIM grid without its t = 0
        anchor, where f is the identity."""
        if int(num_inference_steps) < 1:
            raise ValueError("num_inference_steps must be >= 1")
        self.num_inference_steps = int(num_inference_steps)
        self.inference_timesteps = ddim_timesteps(
            self.num_timesteps, self.num_inference_steps + 1)[:-1]

    @torch.no_grad()
    def _run(self, model_fn, img, y, cfg_scale: float, *, use_cfg: bool,
             p_threshold, generator, noises, return_all_timesteps, progress,
             desc):
        steps = self.inference_timesteps.tolist()
        base.check_noises(noises, len(steps) - 1)
        schedule = self.schedule_on(img.device)
        pair_fn = base.wrap_model_as_eps_x0(schedule, model_fn,
                                            self.prediction_type)
        batch = img.shape[0]

        def f(x, t_i):
            t = torch.full((batch,), t_i, dtype=torch.int64, device=x.device)
            if use_cfg:
                f2 = consistency_apply(
                    pair_fn, torch.cat([x, x]), torch.cat([t, t]),
                    torch.cat([y, torch.zeros_like(y)]), self.sigma_data,
                    self.timestep_scaling)
                f_c, f_u = f2.chunk(2, dim=0)
                out = f_u + cfg_scale * (f_c - f_u)
            else:
                out = consistency_apply(pair_fn, x, t, y, self.sigma_data,
                                        self.timestep_scaling)
            return base.constrain_x0(out, p_threshold, self.clip_sample)

        out = base.Trajectory(return_all_timesteps)
        x0 = f(img, steps[0])
        out.add(x0)
        base.report_progress(progress, desc, 1, len(steps))
        for k, t_i in enumerate(steps[1:]):
            noise = base.step_noise(noises, k, x0, generator)
            t = torch.full((batch,), t_i, dtype=torch.int64, device=x0.device)
            a = extract(schedule.sqrt_alphas_cumprod, t, x0.ndim)
            b = extract(schedule.sqrt_one_minus_alphas_cumprod, t, x0.ndim)
            x0 = f(a * x0 + b * noise, t_i)
            out.add(x0)
            base.report_progress(progress, desc, k + 2, len(steps))
        return out.result()

    def sample(self, model_fn, shape, generator=None, y=None,
               init_noise=None, noises: Optional[Sequence] = None,
               return_all_timesteps: bool = False,
               progress: bool = False) -> torch.Tensor:
        """Unguided sampling, x0 clamped to [-1, 1] when `clip_sample`:
        (B, H, W, C), or each step's x0 (S, B, H, W, C) with
        `return_all_timesteps`."""
        img = base.initial_image(shape, generator, init_noise)
        if y is not None:
            y = torch.as_tensor(y, device=img.device)
        return self._run(model_fn, img, y, 0.0, use_cfg=False,
                         p_threshold=None, generator=generator,
                         noises=noises,
                         return_all_timesteps=return_all_timesteps,
                         progress=progress, desc="Consistency sampling")

    def sample_with_cfg(self, model_fn, shape, y, generator=None,
                        cfg_scale: float = 1.0,
                        p_threshold=base.AUTO_THRESHOLD, init_noise=None,
                        noises: Optional[Sequence] = None,
                        return_all_timesteps: bool = False,
                        progress: bool = False) -> torch.Tensor:
        """f-space CFG on labels `y` (shifted +1), with dynamic thresholding
        (p = 0.995 by default in pixel space); at `cfg_scale` 1 (or None)
        the conditional model alone. A checkpoint distilled with
        `distill_cfg_scale` has the guidance inside: sample it at 1."""
        if y is None:
            raise ValueError("CFG sampling requires class labels y.")
        img = base.initial_image(shape, generator, init_noise)
        y = torch.as_tensor(y, device=img.device)
        guided = cfg_scale is not None and float(cfg_scale) != 1.0
        return self._run(
            model_fn, img, y, float(cfg_scale) if guided else 1.0,
            use_cfg=guided,
            p_threshold=base.resolve_p_threshold(p_threshold,
                                                 self.clip_sample),
            generator=generator, noises=noises,
            return_all_timesteps=return_all_timesteps, progress=progress,
            desc=(f"Consistency sampling with CFG scale {cfg_scale}"
                  if guided else "Consistency sampling (cond)"))
