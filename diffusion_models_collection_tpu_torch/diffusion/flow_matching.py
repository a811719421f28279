"""Flow matching with the linear (rectified-flow) path (Lipman et al. 2023;
Liu et al. 2023): training and ODE sampling.

Counterpart of `diffusion_models_collection_tpu/diffusion/flow_matching.py`.
With data x0 and noise x1 ~ N(0, I):

    x_tau = (1 - tau) x0 + tau x1,   tau = t / (T - 1) for integer t,
    target v = x1 - x0,
    sampling: dx/dtau = v(x, tau) from tau = 1 to 0, Euler or Heun.

The network sees the integer timestep round(tau * (T - 1)). The tau grid
is linspace(1, 0, S + 1), computed in float64 and cast to float32; Heun's
final step (tau_next = 0) is first order. The JAX package evaluates that
step's corrector and discards it with `where`; here it is skipped, one
model call fewer (2 S - 1 calls for Heun). The steps are a Python loop on
host scalars that launches asynchronously on the model's device.

`img2img` starts at tau0 = strength on the path toward one noise draw
(`start_noise`, or the generator's) and integrates back to 0 in
ceil(strength S) steps; with a mask, the kept pixels ride that same path,
(1 - tau) x0 + tau noise, and end at the original values.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from . import base

VALID_FLOW_SOLVERS = ("euler", "heun")


def interpolate(x_start: torch.Tensor, tau: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
    """x_tau on the straight data -> noise path; tau per sample."""
    tau = tau.reshape(-1, *((1,) * (x_start.ndim - 1)))
    return (1.0 - tau) * x_start + tau * noise


def _constrained_velocity(x: torch.Tensor, tau: float, v: torch.Tensor,
                          p_threshold: Optional[float],
                          clip_denoised: bool) -> torch.Tensor:
    """The x0 constraint (threshold or clamp) in velocity space: x0 = x -
    tau v is constrained and v' = (x - x0') / tau; skipped at tau <= 1e-4,
    where x is x0."""
    if (p_threshold is None and not clip_denoised) or not tau > 1e-4:
        return v
    x0 = x - tau * v
    x0c = (base.apply_x0_constraint(x0, p_threshold)
           if p_threshold is not None else torch.clamp(x0, -1.0, 1.0))
    return (x - x0c) / tau


class FlowMatching:
    """Rectified-flow process with the DDPM API: `q_sample` is the linear
    path, `p_losses` the velocity regression, `sample` and
    `sample_with_cfg` integrate the ODE."""

    def __init__(self, num_timesteps: int = 1000,
                 num_inference_steps: int = 50, solver: str = "euler",
                 clip_sample: bool = True):
        if solver not in VALID_FLOW_SOLVERS:
            raise base.invalid_choice("flow solver", solver,
                                      VALID_FLOW_SOLVERS)
        if num_timesteps < 2:
            raise ValueError("flow matching needs num_timesteps >= 2")
        self.num_timesteps = num_timesteps
        self.num_inference_steps = int(num_inference_steps)
        self.solver = solver
        self.clip_sample = bool(clip_sample)
        self.prediction_type = "v_flow"

    def set_inference_steps(self, num_inference_steps: int):
        self.num_inference_steps = int(num_inference_steps)

    def tau_of_t(self, t: torch.Tensor) -> torch.Tensor:
        """Path position of integer timesteps, float32."""
        return t.to(torch.float32) / float(self.num_timesteps - 1)

    # -- training --------------------------------------------------------
    def q_sample(self, x_start, t, noise):
        return interpolate(x_start, self.tau_of_t(t), noise)

    def p_losses(self, model_fn, x_start, t, noise, y=None, loss_type="l2"):
        """Regress the velocity noise - x_start."""
        v_pred = model_fn(self.q_sample(x_start, t, noise), t, y)
        return base.diffusion_loss(noise - x_start, v_pred, loss_type)

    # -- sampling --------------------------------------------------------
    def taus(self) -> np.ndarray:
        """(S, 2) float32 rows [tau_i, tau_{i+1}] from 1 down to 0."""
        grid = np.linspace(1.0, 0.0, self.num_inference_steps + 1,
                           dtype=np.float64).astype(np.float32)
        return np.stack([grid[:-1], grid[1:]], axis=1)

    @torch.no_grad()
    def _solve(self, model_fn, img, y, cfg_scale, *, use_cfg, p_threshold,
               return_all_timesteps, progress, desc, rows=None, known=None):
        batch, device = img.shape[0], img.device
        t_max = np.float32(self.num_timesteps - 1)

        def velocity(x, tau):
            t = torch.full((batch,), int(np.round(tau * t_max)),
                           dtype=torch.int64, device=device)
            # guidance is linear, so the velocity is guided as eps is (JAX's
            # `_cfg_velocity`): one call on the [cond; uncond] batch
            v = (base.cfg_eps(model_fn, x, t, y, cfg_scale) if use_cfg
                 else model_fn(x, t, y))
            return _constrained_velocity(x, float(tau), v, p_threshold,
                                         self.clip_sample)

        if rows is None:
            rows = self.taus()
        out = base.Trajectory(return_all_timesteps)
        x = img
        for i, (tau, tau_next) in enumerate(rows):
            dt = float(tau_next - tau)  # negative: noise -> data
            v1 = velocity(x, tau)
            x_pred = x + dt * v1
            if self.solver == "heun" and tau_next > 1e-6:
                v2 = velocity(x_pred, tau_next)
                x = x + dt * 0.5 * (v1 + v2)
            else:
                x = x_pred
            if known is not None:
                known_x0, mask, eps0 = known
                x_known = (float(np.float32(1.0) - tau_next) * known_x0
                           + float(tau_next) * eps0)
                x = mask * x + (1.0 - mask) * x_known
            out.add(x)
            base.report_progress(progress, desc, i + 1, len(rows))
        return out.result()

    def sample(self, model_fn, shape, generator=None, y=None,
               init_noise=None, return_all_timesteps: bool = False,
               progress: bool = False) -> torch.Tensor:
        img = base.initial_image(shape, generator, init_noise)
        if y is not None:
            y = torch.as_tensor(y, device=img.device)
        return self._solve(model_fn, img, y, 0.0, use_cfg=False,
                           p_threshold=None,
                           return_all_timesteps=return_all_timesteps,
                           progress=progress,
                           desc=f"Flow sampling ({self.solver})")

    def sample_with_cfg(self, model_fn, shape, y, generator=None,
                        cfg_scale: float = 3.0,
                        p_threshold=base.AUTO_THRESHOLD, init_noise=None,
                        return_all_timesteps: bool = False,
                        progress: bool = False) -> torch.Tensor:
        if y is None:
            raise ValueError("CFG sampling requires class labels y.")
        img = base.initial_image(shape, generator, init_noise)
        return self._solve(
            model_fn, img, torch.as_tensor(y, device=img.device),
            float(cfg_scale), use_cfg=True,
            p_threshold=base.resolve_p_threshold(p_threshold,
                                                 self.clip_sample),
            return_all_timesteps=return_all_timesteps, progress=progress,
            desc=f"Flow sampling ({self.solver}) with CFG scale {cfg_scale}")

    def img2img(self, model_fn, init_image, generator=None,
                strength: float = 0.8, y=None,
                cfg_scale: Optional[float] = None,
                p_threshold=base.AUTO_THRESHOLD, mask=None,
                start_noise: Optional[torch.Tensor] = None,
                return_all_timesteps: bool = False,
                progress: bool = False) -> torch.Tensor:
        """SDEdit and inpainting on the flow ODE (see `DDPM.img2img` for the
        arguments): from (1 - strength) x + strength noise, ceil(strength
        S) steps on linspace(strength, 0)."""
        if not 0.0 <= float(strength) <= 1.0:
            raise ValueError("strength must be in [0, 1]")
        init_image, known = base.editing_start(init_image, mask)
        tau0 = float(strength)
        if tau0 <= 0.0:
            return init_image
        n_steps = max(1, math.ceil(tau0 * self.num_inference_steps))
        eps0 = (start_noise if start_noise is not None
                else base.step_noise(None, 0, init_image, generator))
        eps0 = eps0.to(init_image.device, torch.float32)
        start_img = (1.0 - tau0) * init_image + tau0 * eps0
        if known is not None:
            known = (*known, eps0)
        grid = np.linspace(tau0, 0.0, n_steps + 1,
                           dtype=np.float64).astype(np.float32)
        use_cfg = cfg_scale is not None
        if use_cfg and y is None:
            raise ValueError("CFG img2img requires class labels y.")
        if y is not None:
            y = torch.as_tensor(y, device=init_image.device)
        return self._solve(
            model_fn, start_img, y, float(cfg_scale) if use_cfg else 0.0,
            use_cfg=use_cfg,
            p_threshold=(base.resolve_p_threshold(p_threshold,
                                                  self.clip_sample)
                         if use_cfg else None),
            return_all_timesteps=return_all_timesteps, progress=progress,
            desc=f"Flow img2img ({self.solver}, strength {strength})",
            rows=np.stack([grid[:-1], grid[1:]], axis=1), known=known)
