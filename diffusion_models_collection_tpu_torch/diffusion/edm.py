"""EDM (Karras et al. 2022): the preconditioned denoiser, log-normal sigma
training and the Heun sampler with optional churn.

Counterpart of `diffusion_models_collection_tpu/diffusion/edm.py`. With
sigma_data = s_d:

    D(x; sigma) = c_skip x + c_out F(c_in x, t(sigma)),
      c_skip = s_d^2 / (sigma^2 + s_d^2),
      c_out = sigma s_d / sqrt(sigma^2 + s_d^2),
      c_in = 1 / sqrt(sigma^2 + s_d^2);
    t(sigma) = (ln sigma - ln sigma_min) / (ln sigma_max - ln sigma_min)
               (T - 1), a continuous timestep for the network;
    training: x = x0 + sigma(t) n, sigma(t) = exp(P_mean + P_std
      ndtri((t + 1/2) / T)) for integer t, loss lambda(sigma) |D - x0|^2,
      lambda = 1 / c_out^2;
    sampling: the Karras sigma grid (numpy float64, cast to float32), churn
      lifting sigma to sigma_hat = sigma (1 + gamma) with matched noise,
      then a Heun step; the last step (sigma_next = 0) is Euler.

The JAX package evaluates the last step's corrector at sigma 1e-12 and
discards it with `where`; here it is skipped, one model call fewer
(2 S - 1 calls). Churn noise comes from the caller's `torch.Generator`, or
from `noises`, one tensor a step (the parity tests pass the JAX package's
`fold_in(rng, i)` draws); with no churn nothing is drawn.

`img2img` enters the grid at sigma0 = sigma_min (sigma_max / sigma_min) **
strength: the input plus the first grid sigma <= sigma0 times a draw
(`start_noise`), then the grid's steps from there. With a mask, each step
re-imposes the kept pixels as the original plus sigma_next times a draw
(`known_noises`, one a step).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from . import base


def _t_of_sigma(sigma: torch.Tensor, sigma_min: float, sigma_max: float,
                num_timesteps: int) -> torch.Tensor:
    """The network's noise input for `sigma`: ln sigma mapped affinely
    onto [0, T - 1]."""
    lo, hi = math.log(sigma_min), math.log(sigma_max)
    return (torch.log(sigma) - lo) / (hi - lo) * (num_timesteps - 1)


def _cfg_denoised(d_fn, x, sigma, y, cfg_scale: float,
                  guidance_rescale: float) -> torch.Tensor:
    """Classifier-free guidance on D (x0-space), one call on the
    [cond; uncond] batch, with the optional contrast rescale."""
    x2 = torch.cat([x, x], dim=0)
    s2 = torch.cat([sigma, sigma], dim=0)
    y2 = torch.cat([y, torch.zeros_like(y)], dim=0)
    d_c, d_u = d_fn(x2, s2, y2).chunk(2, dim=0)
    d_g = d_u + cfg_scale * (d_c - d_u)
    if guidance_rescale > 0.0:
        d_g = base.rescale_guided(d_g, d_c, guidance_rescale)
    return d_g


class EDM:
    """EDM process with the DDPM API: `q_sample` adds sigma(t) noise,
    `p_losses` is the preconditioned weighted loss, `sample` and
    `sample_with_cfg` run Heun over the Karras grid."""

    def __init__(self, num_timesteps: int = 1000,
                 num_inference_steps: int = 18, sigma_data: float = 0.5,
                 sigma_min: float = 0.002, sigma_max: float = 80.0,
                 rho: float = 7.0, p_mean: float = -1.2, p_std: float = 1.2,
                 s_churn: float = 0.0, s_min: float = 0.0,
                 s_max: float = float("inf"), s_noise: float = 1.0,
                 guidance_rescale: float = 0.0, clip_sample: bool = True):
        if num_timesteps < 2:
            raise ValueError("EDM needs num_timesteps >= 2")
        if not 0.0 < sigma_min < sigma_max:
            raise ValueError("need 0 < sigma_min < sigma_max")
        if sigma_data <= 0.0:
            raise ValueError("sigma_data must be positive")
        if s_churn < 0.0 or s_noise <= 0.0:
            raise ValueError("s_churn must be >= 0 and s_noise > 0")
        self.num_timesteps = int(num_timesteps)
        self.sigma_data = float(sigma_data)
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)
        self.rho = float(rho)
        self.p_mean = float(p_mean)
        self.p_std = float(p_std)
        self.s_churn = float(s_churn)
        self.s_min = float(s_min)
        self.s_max = float(s_max)
        self.s_noise = float(s_noise)
        self.guidance_rescale = base.validate_guidance_rescale(
            guidance_rescale)
        self.clip_sample = bool(clip_sample)
        self.prediction_type = "edm_denoised"
        self.set_inference_steps(num_inference_steps)

    # -- sigma machinery -------------------------------------------------
    def sigma_of_t(self, t: torch.Tensor) -> torch.Tensor:
        """Stratified log-normal sigma for integer t in [0, T): the inverse
        CDF of ln sigma ~ N(P_mean, P_std^2) at (t + 1/2) / T."""
        u = (t.to(torch.float32) + 0.5) / self.num_timesteps
        z = torch.special.ndtri(torch.clamp(u, 1e-7, 1.0 - 1e-7))
        return torch.exp(self.p_mean + self.p_std * z)

    def set_inference_steps(self, num_inference_steps: int):
        """The Karras grid (eq. 5) in float64 and each step's churn lift
        sigma_hat = sigma (1 + gamma), as float32 rows (sigma, sigma_hat,
        sigma_next)."""
        n = int(num_inference_steps)
        if n < 1:
            raise ValueError("num_inference_steps must be >= 1")
        self.num_inference_steps = n
        i = np.arange(n, dtype=np.float64)
        inv = 1.0 / self.rho
        sig = (self.sigma_max**inv + i / max(n - 1, 1)
               * (self.sigma_min**inv - self.sigma_max**inv)) ** self.rho
        sig_next = np.concatenate([sig[1:], [0.0]])
        gamma = np.where((sig >= self.s_min) & (sig <= self.s_max),
                         min(self.s_churn / n, math.sqrt(2.0) - 1.0), 0.0)
        self.sigmas = torch.from_numpy(sig.astype(np.float32))
        self.rows = np.stack([sig, sig * (1.0 + gamma),
                              sig_next]).T.astype(np.float32)

    # -- preconditioning -------------------------------------------------
    def denoiser_fn(self, model_fn):
        """(x, sigma, y) -> D(x; sigma), sigma of shape (B,)."""
        sd = self.sigma_data

        def denoise(x, sigma, y=None):
            s = sigma.reshape(-1, *((1,) * (x.ndim - 1)))
            denom = s**2 + sd**2
            c_skip = sd**2 / denom
            c_out = s * sd / torch.sqrt(denom)
            c_in = 1.0 / torch.sqrt(denom)
            t_in = _t_of_sigma(sigma, self.sigma_min, self.sigma_max,
                               self.num_timesteps)
            return c_skip * x + c_out * model_fn(c_in * x, t_in, y)
        return denoise

    # -- training --------------------------------------------------------
    def q_sample(self, x_start, t, noise):
        """x0 + sigma(t) noise (variance exploding: no signal decay)."""
        s = self.sigma_of_t(t).reshape(-1, *((1,) * (x_start.ndim - 1)))
        return x_start + s * noise

    def p_losses(self, model_fn, x_start, t, noise, y=None, loss_type="l2"):
        """lambda(sigma)-weighted per-sample loss of D against x0."""
        sigma = self.sigma_of_t(t)
        d = self.denoiser_fn(model_fn)(self.q_sample(x_start, t, noise),
                                       sigma, y)
        lam = (sigma**2 + self.sigma_data**2) / (sigma * self.sigma_data)**2
        return (lam * base.per_sample_loss(x_start, d, loss_type)).mean()

    # -- sampling --------------------------------------------------------
    @torch.no_grad()
    def _solve(self, model_fn, img, y, cfg_scale, generator, noises, *,
               use_cfg, p_threshold, return_all_timesteps, progress, desc,
               rows=None, unit_img=True, known=None, known_noises=None):
        """Heun over `rows` (the grid's by default) from `img`, scaled by
        the first sigma where `unit_img` (a unit Gaussian); with `known`,
        the inpainting projection after each step."""
        batch, device = img.shape[0], img.device
        d_fn = self.denoiser_fn(model_fn)

        def denoise(x, sigma_value):
            sigma = torch.full((batch,), float(sigma_value),
                               dtype=torch.float32, device=device)
            if use_cfg:
                d = _cfg_denoised(d_fn, x, sigma, y, cfg_scale,
                                  self.guidance_rescale)
                return base.constrain_x0(d, p_threshold, self.clip_sample)
            d = d_fn(x, sigma, y)
            return torch.clamp(d, -1.0, 1.0) if self.clip_sample else d

        rows = self.rows if rows is None else rows
        base.check_noises(noises, len(rows))
        out = base.Trajectory(return_all_timesteps)
        x = float(rows[0, 0]) * img if unit_img else img
        for i, (sigma, sigma_hat, sigma_next) in enumerate(rows):
            churn_std = np.sqrt(np.maximum(sigma_hat**2 - sigma**2,
                                           np.float32(0.0)))
            x_hat = x
            if churn_std > 0:
                eps = base.step_noise(noises, i, x, generator)
                x_hat = x + float(churn_std * np.float32(self.s_noise)) * eps
            d1 = (x_hat - denoise(x_hat, sigma_hat)) / float(sigma_hat)
            h = float(sigma_next - sigma_hat)
            x = x_hat + h * d1
            if sigma_next > 0.0:
                d2 = (x - denoise(x, sigma_next)) / float(sigma_next)
                x = x_hat + h * 0.5 * (d1 + d2)
            if known is not None:
                known_x0, mask = known
                x_known = known_x0
                if sigma_next > 0.0:
                    x_known = known_x0 + float(sigma_next) * base.step_noise(
                        known_noises, i, x, generator)
                x = mask * x + (1.0 - mask) * x_known
            out.add(x)
            base.report_progress(progress, desc, i + 1, len(rows))
        return out.result()

    def sample(self, model_fn, shape, generator=None, y=None,
               init_noise=None, noises: Optional[Sequence] = None,
               return_all_timesteps: bool = False,
               progress: bool = False) -> torch.Tensor:
        """Heun sampling from sigma_max: `init_noise` is unit Gaussian and
        scaled by the first sigma."""
        img = base.initial_image(shape, generator, init_noise)
        if y is not None:
            y = torch.as_tensor(y, device=img.device)
        return self._solve(model_fn, img, y, 0.0, generator, noises,
                           use_cfg=False, p_threshold=None,
                           return_all_timesteps=return_all_timesteps,
                           progress=progress, desc="EDM (Heun) sampling")

    def sample_with_cfg(self, model_fn, shape, y, generator=None,
                        cfg_scale: float = 3.0,
                        p_threshold=base.AUTO_THRESHOLD, init_noise=None,
                        noises: Optional[Sequence] = None,
                        return_all_timesteps: bool = False,
                        progress: bool = False) -> torch.Tensor:
        if y is None:
            raise ValueError("CFG sampling requires class labels y.")
        img = base.initial_image(shape, generator, init_noise)
        return self._solve(
            model_fn, img, torch.as_tensor(y, device=img.device),
            float(cfg_scale), generator, noises, use_cfg=True,
            p_threshold=base.resolve_p_threshold(p_threshold,
                                                 self.clip_sample),
            return_all_timesteps=return_all_timesteps, progress=progress,
            desc=f"EDM (Heun) sampling with CFG scale {cfg_scale}")

    def img2img(self, model_fn, init_image, generator=None,
                strength: float = 0.8, y=None,
                cfg_scale: Optional[float] = None,
                p_threshold=base.AUTO_THRESHOLD, mask=None,
                start_noise: Optional[torch.Tensor] = None,
                noises: Optional[Sequence] = None,
                known_noises: Optional[Sequence] = None,
                return_all_timesteps: bool = False,
                progress: bool = False) -> torch.Tensor:
        """SDEdit and inpainting on the Karras grid (see `DDPM.img2img` for
        the arguments): the grid from its first sigma <= sigma_min
        (sigma_max / sigma_min) ** strength; `noises` and `known_noises`
        one a step of that run."""
        if not 0.0 <= float(strength) <= 1.0:
            raise ValueError("strength must be in [0, 1]")
        init_image, known = base.editing_start(init_image, mask)
        if float(strength) <= 0.0 and known is None:
            return init_image
        sigma0 = self.sigma_min * (self.sigma_max
                                   / self.sigma_min) ** float(strength)
        keep = self.rows[:, 0] <= sigma0 + 1e-12
        if not keep.any():
            return init_image
        rows = self.rows[int(np.argmax(keep)):]
        noise = (start_noise if start_noise is not None
                 else base.step_noise(None, 0, init_image, generator))
        start_img = init_image + float(rows[0, 0]) * noise.to(
            init_image.device, torch.float32)
        use_cfg = cfg_scale is not None
        if use_cfg and y is None:
            raise ValueError("CFG img2img requires class labels y.")
        if y is not None:
            y = torch.as_tensor(y, device=init_image.device)
        return self._solve(
            model_fn, start_img, y, float(cfg_scale) if use_cfg else 0.0,
            generator, noises, use_cfg=use_cfg,
            p_threshold=(base.resolve_p_threshold(p_threshold,
                                                  self.clip_sample)
                         if use_cfg else None),
            return_all_timesteps=return_all_timesteps, progress=progress,
            desc=f"EDM img2img (strength {strength})", rows=rows,
            unit_img=False, known=known, known_noises=known_noises)
