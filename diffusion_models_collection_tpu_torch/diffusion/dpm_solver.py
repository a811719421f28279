"""DPM-Solver++(2M) (Lu et al. 2022): a deterministic second-order
multistep ODE sampler in the data-prediction (x0) form, and its SDE form.

Counterpart of `diffusion_models_collection_tpu/diffusion/dpm_solver.py`,
with the same grid (uniform or Karras) and the same steps. With
alpha_t = sqrt(acp_t), sigma_t = sqrt(1 - acp_t), lambda_t =
log(alpha_t / sigma_t), h_i = lambda_{t_{i+1}} - lambda_{t_i} and
r_i = h_{i-1} / h_i:

    D_i = (1 + 1/(2 r_i)) x0_i - 1/(2 r_i) x0_{i-1}     (first step: x0_i)
    ODE:  x_{i+1} = (sigma_{i+1} / sigma_i) x_i
                    - alpha_{i+1} (e^{-h_i} - 1) D_i
    SDE:  x_{i+1} = (sigma_{i+1} / sigma_i) e^{-h_i} x_i
                    + alpha_{i+1} (1 - e^{-2 h_i}) D_i
                    + sigma_{i+1} sqrt(1 - e^{-2 h_i}) z_i

The final step (t_next = -1) returns D, which is x0 there (first order,
`lower_order_final`). The JAX package runs the steps as one `lax.scan` with
the per-step scalars on the device; here the scalars (lambda, alpha, sigma
of the grid and what is computed from them) are numpy float32 values on the
host, computed in the JAX package's order, and the steps a Python loop that
launches asynchronously on the model's device. The SDE's
z_i comes from the caller's `torch.Generator`, or from `noises`, one tensor
a step (the parity tests pass the JAX package's `fold_in(rng, t)` draws).
Each step's guided, constrained x0 (JAX's `make_x0_fn`) is
`base.VPProcess.eps_x0_fn`, shared with UniPC and DDIM.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import base
from .schedule import NoiseSchedule


def multistep_D(x0: torch.Tensor, x0_prev: torch.Tensor, h: float,
                h_prev: float, have_prev: bool, final: bool) -> torch.Tensor:
    """DPM-Solver++(2M)'s extrapolated data term, shared with UniPC's
    predictor: first order on the first step, at a degenerate h and on the
    final step, where h is not defined. The coefficients in float32."""
    h, h_prev = np.float32(h), np.float32(h_prev)
    if not have_prev or final or not h > 1e-12:
        return x0
    r = h_prev / max(h, np.float32(1e-12))
    coef = np.float32(1.0) / max(np.float32(2.0) * r, np.float32(1e-12))
    return float(np.float32(1.0) + coef) * x0 - float(coef) * x0_prev


def alpha_sigma_lambda(schedule: NoiseSchedule):
    """alpha = sqrt(acp), sigma = sqrt(1 - acp) and lambda = log(alpha /
    sigma), float32 numpy arrays over the schedule's timesteps, computed
    once per schedule and kept on it: a run that `torch.export` traces
    (`serving.export_sampler`, which computes them first) cannot read a
    tensor back to the host."""
    cached = schedule.__dict__.get("_alpha_sigma_lambda")
    if cached is None:
        acp = schedule.alphas_cumprod.cpu()
        a = torch.sqrt(acp)
        s = torch.sqrt(1.0 - acp)
        lam = torch.log(a.clamp(min=1e-12) / s.clamp(min=1e-12))
        cached = (a.numpy(), s.numpy(), lam.numpy())
        schedule.__dict__["_alpha_sigma_lambda"] = cached
    return cached


def grid_scalars(schedule: NoiseSchedule, timesteps: torch.Tensor
                 ) -> List[Tuple[int, int, np.float32, np.float32,
                                 np.float32, np.float32, np.float32]]:
    """Per step of the grid: (t, t_next, lambda_t, lambda_next, alpha_next,
    sigma_next, sigma_next / sigma_t), float32; t_next = -1 on the final
    step, whose lambda_next is lambda_t + 1, a finite placeholder as in the
    JAX package."""
    a, s, lam = alpha_sigma_lambda(schedule)
    steps = timesteps.tolist()
    rows = []
    for i, t in enumerate(steps):
        t_next = steps[i + 1] if i + 1 < len(steps) else -1
        tn = max(t_next, 0)
        lam_next = lam[t] + np.float32(1.0) if t_next < 0 else lam[tn]
        rows.append((t, t_next, lam[t], lam_next, a[tn], s[tn],
                     s[tn] / max(s[t], np.float32(1e-12))))
    return rows


class DPMSolverPP(base.FastVPSampler):
    """DPM-Solver++(2M) process (the DDIM API; `sde=True`:
    SDE-DPM-Solver++(2M), which injects matched noise each step)."""

    def __init__(self, num_timesteps: int = 1000,
                 num_inference_steps: int = 20, eta: float = 0.0,
                 sde: bool = False, **common):
        del eta  # accepted for the DDIM API; the solver sets its own noise
        self.sde = bool(sde)
        self.DESC = ("SDE-" if self.sde else "") + "DPM-Solver++ sampling"
        super().__init__(num_inference_steps=num_inference_steps,
                         num_timesteps=num_timesteps, **common)

    @torch.no_grad()
    def _solve(self, eps_x0, img, generator, noises, return_all_timesteps,
               progress, desc):
        rows = grid_scalars(self.schedule, self.inference_timesteps)
        if self.sde:
            base.check_noises(noises, len(rows))
        out = base.Trajectory(return_all_timesteps)
        batch, device = img.shape[0], img.device
        x, x0_prev, lam_prev, have_prev = img, None, np.float32(0.0), False
        for i, (t_i, t_next, lam_t, lam_next, a_next, s_next,
                sig_ratio) in enumerate(rows):
            t = torch.full((batch,), t_i, dtype=torch.int64, device=device)
            _, x0 = eps_x0(x, t)
            final = t_next < 0
            h = lam_next - lam_t
            D = multistep_D(x0, x0_prev, h, lam_t - lam_prev, have_prev,
                            final)
            if final:
                x = D
            elif self.sde:
                decay = np.exp(-h)
                z = base.step_noise(noises, i, x, generator)
                one = np.float32(1.0)
                x = (float(sig_ratio * decay) * x
                     + float(a_next * (one - decay**2)) * D
                     + float(s_next * np.sqrt(max(one - decay**2,
                                                  np.float32(0.0)))) * z)
            else:
                x = (float(sig_ratio) * x
                     - float(a_next * (np.exp(-h) - np.float32(1.0))) * D)
            x0_prev, lam_prev, have_prev = x0, lam_t, True
            out.add(x)
            base.report_progress(progress, desc, i + 1, len(rows))
        return out.result()
