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

Also the JAX class's editing and restart samplers: `img2img` (SDEdit on the
grid cut at round(strength (T - 1)), with an optional inpainting mask),
`invert` (the deterministic update on the ascending grid: a clean image to
the noise that DDIM maps back to it) and `sample_restart` (Xu et al. 2023:
the eta 0 ODE, renoised `restarts` times from the bottom of an interval of
the training axis back to its top in one forward hop and re-integrated).
Their draws are the generator's, or the caller's: `start_noise`, one
tensor a step in `noises` (eta > 0) and `known_noises` (the projection's),
and one a restart in `restart_noises`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import base
from .ddpm import project_known
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


class DDIM(base.FastVPSampler):
    """DDIM diffusion process: the JAX class's sampling API on a uniform or
    Karras grid (`sample`, `sample_with_cfg`, `p_sample`, `img2img`,
    `invert`, `sample_restart`) and the training API it shares with DDPM
    (`q_sample`, `p_losses`)."""

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

    def timestep_pairs(self):
        """The sampler's steps as (t, t_next) lists: the grid, and the grid
        shifted by one with -1 (the clean image) last."""
        steps = self.inference_timesteps.tolist()
        return steps, steps[1:] + [-1]

    def step(self, schedule: NoiseSchedule, x, t, t_next, noise, eps_x0):
        """One sampling step from x_t to x_{t_next} through `eps_x0`, the
        step's (eps, x0) (`guided_eps_x0`); `noise` is the eta > 0 draw."""
        eps, x0 = eps_x0(x, t)
        return ddim_step(schedule, x, t, t_next, eps, x0, self.eta, noise)

    @torch.no_grad()
    def _solve(self, eps_x0, img, generator, noises, return_all_timesteps,
               progress, desc):
        ts, ts_next = self.timestep_pairs()
        if self.eta > 0:
            base.check_noises(noises, len(ts))
        out = base.Trajectory(return_all_timesteps)
        self._steps(eps_x0, img, ts, ts_next, 0, generator, noises, out,
                    progress, desc)
        return out.result()

    def _steps(self, eps_x0, img, ts, ts_next, first, generator, noises, out,
               progress, desc, known=None, known_noises=None):
        """DDIM updates from each of `ts` to the same place of `ts_next`
        (-1: the clean image), each followed by the inpainting projection
        when `known` is given; the run's k-th step, k = `first` + position,
        takes noises[k] (eta > 0) and known_noises[k]. Every step's state
        goes to `out`."""
        schedule = self.schedule_on(img.device)
        batch = img.shape[0]
        for j, (t_i, t_next_i) in enumerate(zip(ts, ts_next)):
            k = first + j
            t = torch.full((batch,), t_i, dtype=torch.int64, device=img.device)
            t_next = torch.full((batch,), t_next_i, dtype=torch.int64,
                                device=img.device)
            noise = (base.step_noise(noises, k, img, generator)
                     if self.eta > 0 else None)
            img = self.step(schedule, img, t, t_next, noise, eps_x0)
            if known is not None:
                img = project_known(
                    schedule, img, t_next_i, known,
                    base.step_noise(known_noises, k, img, generator)
                    if t_next_i >= 0 else None)
            out.add(img)
            base.report_progress(progress, desc, j + 1, len(ts))
        return img

    @torch.no_grad()
    def img2img(self, model_fn, init_image, generator=None,
                strength: float = 0.8, y=None,
                cfg_scale: Optional[float] = None,
                p_threshold=base.AUTO_THRESHOLD, mask=None,
                start_noise: Optional[torch.Tensor] = None,
                noises: Optional[Sequence] = None,
                known_noises: Optional[Sequence] = None,
                return_all_timesteps: bool = False,
                progress: bool = False) -> torch.Tensor:
        """SDEdit and inpainting on the grid (see `DDPM.img2img`): the grid
        cut to timesteps <= round(strength (T - 1)), the input forward-noised
        to the first one kept, so an S-step grid runs about strength S
        steps."""
        if not 0.0 <= float(strength) <= 1.0:
            raise ValueError("strength must be in [0, 1]")
        init_image, known = base.editing_start(init_image, mask)
        t0 = int(round(float(strength) * (self.num_timesteps - 1)))
        if t0 <= 0 and known is None:
            return init_image
        grid = self.inference_timesteps.numpy()
        sub = [int(v) for v in grid[grid <= t0]]
        if not sub:
            return init_image
        img = init_image
        if sub[0] > 0:
            noise = (start_noise if start_noise is not None
                     else base.step_noise(None, 0, init_image, generator))
            t = torch.full((init_image.shape[0],), sub[0], dtype=torch.int64,
                           device=init_image.device)
            img = self.q_sample(init_image, t, noise.to(img.device))
        if cfg_scale is not None and y is None:
            raise ValueError("CFG img2img requires class labels y.")
        eps_x0 = self.guided_eps_x0(model_fn, img.device, y, cfg_scale,
                                    p_threshold)
        out = base.Trajectory(return_all_timesteps)
        self._steps(eps_x0, img, sub, sub[1:] + [-1], 0, generator, noises,
                    out, progress, f"DDIM img2img (strength {strength})",
                    known=known, known_noises=known_noises)
        return out.result()

    @torch.no_grad()
    def invert(self, model_fn, images, y=None,
               num_steps: Optional[int] = None,
               progress: bool = False) -> torch.Tensor:
        """DDIM inversion: the eta 0 update on the ascending grid (of
        `num_steps` when given), from a clean image to the noise whose DDIM
        trajectory returns to it (O(1/S) off at S steps), so that
        `sample(init_noise=invert(x))` is about x. The model sees `y`
        directly: no classifier-free guidance, and x0 is not clamped."""
        if self.eta != 0.0:
            raise ValueError("DDIM inversion requires eta = 0")
        images = images.to(torch.float32)
        grid = (self.inference_timesteps if num_steps is None
                else ddim_timesteps(self.num_timesteps, int(num_steps)))
        asc = grid.flip(0).tolist()
        # the first move leaves t = -1, read as t = 0 (alpha_bar[0] ~ 1)
        ts = [max(t, 0) for t in [-1] + asc[:-1]]
        pair_fn = self.pair_fn(model_fn, images.device)
        if y is not None:
            y = torch.as_tensor(y, device=images.device)
        out = base.Trajectory(False)
        return self._steps(lambda x, t: pair_fn(x, t, y), images, ts, asc, 0,
                           None, None, out, progress, "DDIM inversion")

    @torch.no_grad()
    def sample_restart(self, model_fn, shape, generator=None, y=None,
                       cfg_scale: Optional[float] = None,
                       restart_interval=(1, 300), restarts: int = 2,
                       p_threshold=base.AUTO_THRESHOLD, init_noise=None,
                       restart_noises: Optional[Sequence] = None,
                       return_all_timesteps: bool = False,
                       progress: bool = False) -> torch.Tensor:
        """Restart sampling: the eta 0 ODE down to the last grid point at or
        above t_min of `restart_interval` (t_min, t_max) on the training
        axis, then `restarts` times a forward hop to the first grid point at
        or below t_max and the ODE down again, then on to the clean image.
        The interval must hold two grid points; `restarts` 0 is plain DDIM.
        `cfg_scale` None runs unguided."""
        if self.eta != 0.0:
            raise ValueError(
                "restart sampling re-injects noise itself — it requires the "
                "deterministic eta = 0 DDIM ODE between restarts")
        restarts = int(restarts)
        if restarts < 0:
            raise ValueError("restarts must be >= 0")
        t_min, t_max = (int(v) for v in restart_interval)
        if not 0 <= t_min < t_max < self.num_timesteps:
            raise ValueError(
                f"restart_interval must satisfy 0 <= t_min < t_max < "
                f"{self.num_timesteps}, got ({t_min}, {t_max})")
        if cfg_scale is not None and y is None:
            raise ValueError("CFG restart sampling requires labels y.")
        grid = self.inference_timesteps.tolist()
        inside = [i for i, t in enumerate(grid) if t_min <= t <= t_max]
        if restarts > 0 and len(inside) < 2:
            raise ValueError(
                f"restart_interval ({t_min}, {t_max}) contains "
                f"{len(inside)} inference-grid point(s); need >= 2 (widen "
                "the interval or raise num_inference_steps)")
        base.check_noises(restart_noises, restarts)
        img = base.initial_image(shape, generator, init_noise)
        eps_x0 = self.guided_eps_x0(model_fn, img.device, y, cfg_scale,
                                    p_threshold)
        ts_next = grid[1:] + [-1]
        out = base.Trajectory(return_all_timesteps)

        def run(img, a, b):
            """The grid's steps a to b - 1: from grid[a] to grid[b]."""
            return self._steps(eps_x0, img, grid[a:b], ts_next[a:b], a, None,
                               None, out, False, "")

        if restarts == 0:
            run(img, 0, len(grid))
            return out.result()
        i_hi, i_bot = inside[0], inside[-1]
        acp = self.schedule_on(img.device).alphas_cumprod
        img = run(img, 0, i_bot)
        for k in range(restarts):
            ratio = acp[grid[i_hi]] / acp[grid[i_bot]]
            noise = base.step_noise(restart_noises, k, img, generator)
            img = torch.sqrt(ratio) * img + torch.sqrt(1.0 - ratio) * noise
            img = run(img, i_hi, i_bot)
            if progress:
                print(f"Restart {k + 1}/{restarts} done", flush=True)
        run(img, i_bot, len(grid))
        return out.result()
