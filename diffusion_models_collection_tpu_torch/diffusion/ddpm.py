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

`img2img` is SDEdit from a given image, with an optional inpainting mask
(each step's result re-imposes the kept pixels, forward-noised to the level
just reached) and RePaint's resampling (Lugmayr et al. 2022, Alg. 2: every
`repaint_jump` steps are renoised back up in one forward hop and rerun,
`repaint_resample` times in all). Its draws come from the generator, or
from the caller: `start_noise` for the start, one tensor a step in the
order the steps run (reruns included) in `noises` and `known_noises` (the
projection's), and one a hop in `renoise_noises`.
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


def project_known(schedule: NoiseSchedule, img: torch.Tensor, t_next: int,
                  known, noise: Optional[torch.Tensor]) -> torch.Tensor:
    """Inpainting projection: where the mask is 0 (keep), the known image
    forward-noised to the level `t_next` just reached with `noise`, or the
    known image itself at `t_next` -1 (the clean end). `known` is
    (known_x0, mask), mask 1 to generate."""
    known_x0, mask = known
    if t_next >= 0:
        t = torch.full((img.shape[0],), t_next, dtype=torch.int64,
                       device=img.device)
        x_known = base.q_sample(schedule, known_x0, t, noise)
    else:
        x_known = known_x0
    return mask * img + (1.0 - mask) * x_known


class DDPM(base.VPProcess):
    """DDPM diffusion process: the JAX class's training API (`q_sample`,
    `p_losses`), its one-step `p_sample`, its samplers (`sample`,
    `sample_with_cfg`) over all T steps, and `img2img` with inpainting and
    RePaint."""

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

    def timestep_pairs(self):
        """The sampler's steps as (t, t_next) lists: every timestep from
        T - 1 down to 0, and the one below it."""
        ts = list(range(self.num_timesteps - 1, -1, -1))
        return ts, [t - 1 for t in ts]

    def step(self, schedule: NoiseSchedule, x, t, t_next, noise, eps_x0):
        """One ancestral step x_t -> x_{t-1} (`t_next`, always t - 1, is
        not read) through `eps_x0`, the step's (eps, x0)
        (`guided_eps_x0`), with the step's `noise`."""
        _, x0 = eps_x0(x, t)
        return posterior_step(schedule, x, t, x0, noise)

    @torch.no_grad()
    def _solve(self, eps_x0, img, generator, noises, return_all_timesteps,
               progress, desc):
        base.check_noises(noises, self.num_timesteps)
        out = base.Trajectory(return_all_timesteps)
        self._steps(eps_x0, img, self.timestep_pairs()[0], 0, generator,
                    noises, None, None, out, progress, desc)
        return out.result()

    def _steps(self, eps_x0, img, ts, first, generator, noises, known,
               known_noises, out, progress, desc):
        """Ancestral steps at the descending timesteps `ts`, each followed by
        the inpainting projection when `known` is given; the run's k-th
        step, k = `first` + position, takes noises[k] and known_noises[k]
        (or draws). Every step's state goes to `out`."""
        schedule = self.schedule_on(img.device)
        batch = img.shape[0]
        for j, t_i in enumerate(ts):
            k = first + j
            t = torch.full((batch,), t_i, dtype=torch.int64, device=img.device)
            noise = base.step_noise(noises, k, img, generator)
            img = self.step(schedule, img, t, None, noise, eps_x0)
            if known is not None:
                img = project_known(
                    schedule, img, t_i - 1, known,
                    base.step_noise(known_noises, k, img, generator)
                    if t_i > 0 else None)
            out.add(img)
            base.report_progress(progress, desc, j + 1, len(ts), every=10)
        return img

    @torch.no_grad()
    def img2img(self, model_fn, init_image, generator=None,
                strength: float = 0.8, y=None,
                cfg_scale: Optional[float] = None,
                p_threshold=base.AUTO_THRESHOLD, mask=None,
                repaint_jump: int = 0, repaint_resample: int = 1,
                start_noise: Optional[torch.Tensor] = None,
                noises: Optional[Sequence] = None,
                known_noises: Optional[Sequence] = None,
                renoise_noises: Optional[Sequence] = None,
                return_all_timesteps: bool = False,
                progress: bool = False) -> torch.Tensor:
        """SDEdit: forward-noise `init_image` to t0 = round(strength (T - 1))
        and denoise from there (strength 0 returns the input). `mask`
        (1 regenerate, 0 keep; broadcast to the image) inpaints, ending at
        the kept pixels exactly. `cfg_scale` None runs unguided, a float
        with classifier-free guidance on labels `y`. `repaint_resample` > 1
        with `repaint_jump` j >= 1 runs RePaint's schedule (needs a mask)."""
        if not 0.0 <= float(strength) <= 1.0:
            raise ValueError("strength must be in [0, 1]")
        repaint_jump = int(repaint_jump)
        repaint_resample = int(repaint_resample)
        if repaint_resample < 1:
            raise ValueError("repaint_resample must be >= 1")
        if repaint_resample > 1:
            if mask is None:
                raise ValueError(
                    "repaint_resample > 1 is the RePaint inpainting schedule "
                    "— it requires a mask")
            if repaint_jump < 1:
                raise ValueError(
                    "repaint_resample > 1 requires repaint_jump >= 1 (the "
                    "jump length j in RePaint Alg. 2)")
        init_image, known = base.editing_start(init_image, mask)
        t0 = int(round(float(strength) * (self.num_timesteps - 1)))
        if t0 <= 0 and known is None:
            return init_image
        img = init_image
        if t0 > 0:
            noise = (start_noise if start_noise is not None
                     else base.step_noise(None, 0, init_image, generator))
            t = torch.full((init_image.shape[0],), t0, dtype=torch.int64,
                           device=init_image.device)
            img = self.q_sample(init_image, t, noise.to(img.device))
        if cfg_scale is not None and y is None:
            raise ValueError("CFG img2img requires class labels y.")
        eps_x0 = self.guided_eps_x0(model_fn, img.device, y, cfg_scale,
                                    p_threshold)
        ts = list(range(t0, -1, -1))
        out = base.Trajectory(return_all_timesteps)
        desc = f"DDPM img2img (strength {strength})"
        if repaint_resample == 1:
            self._steps(eps_x0, img, ts, 0, generator, noises, known,
                        known_noises, out, progress, desc)
            return out.result()
        self._run_repaint(eps_x0, img, ts, generator, noises, known,
                          known_noises, renoise_noises, repaint_jump,
                          repaint_resample, out, progress, desc + " [RePaint]")
        return out.result()

    def _renoise(self, img: torch.Tensor, t_lo: int, t_hi: int,
                 noise: torch.Tensor) -> torch.Tensor:
        """One forward hop x_{t_lo} -> x_{t_hi} (t_lo -1: the clean image):
        sqrt(r) x + sqrt(1 - r) noise, r = acp[t_hi] / acp[t_lo], the
        marginal of the composed per-step kernels."""
        acp = self.schedule_on(img.device).alphas_cumprod
        ratio = acp[t_hi] if t_lo < 0 else acp[t_hi] / acp[t_lo]
        return torch.sqrt(ratio) * img + torch.sqrt(1.0 - ratio) * noise

    def _run_repaint(self, eps_x0, img, ts, generator, noises, known,
                     known_noises, renoise_noises, jump, resample, out,
                     progress, desc):
        """RePaint (Alg. 2): denoise `jump` steps, renoise back to the
        chunk's top level, `resample` times in all, then go on."""
        first = hop = pos = 0
        while pos < len(ts):
            chunk = ts[pos:pos + jump]
            for rep in range(resample):
                img = self._steps(eps_x0, img, chunk, first, generator,
                                  noises, known, known_noises, out, False,
                                  desc)
                first += len(chunk)
                if rep < resample - 1:
                    img = self._renoise(
                        img, chunk[-1] - 1, chunk[0],
                        base.step_noise(renoise_noises, hop, img, generator))
                    hop += 1
            pos += len(chunk)
            base.report_progress(progress, desc, pos, len(ts), every=10)
        return img
