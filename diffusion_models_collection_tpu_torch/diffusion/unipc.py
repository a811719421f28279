"""UniPC (Zhao et al. 2023): a predictor-corrector sampler in the x0 form,
order 2, one model call a step.

Counterpart of `diffusion_models_collection_tpu/diffusion/unipc.py`. The
model is evaluated at the predicted point; that evaluation corrects the
previous step (UniC-2, the exact exponential trapezoid over [t_prev, t]
with x0 linear in lambda),

    x_i^c = (sigma_i / sigma_{i-1}) x_{i-1}^c
            + alpha_i [(phi1 - c2) x0_{i-1} + c2 x0_i],
    phi1 = 1 - e^{-h},  c2 = phi1 - (1 - (h + 1) e^{-h}) / h,

and feeds the next predictor (UniP-2, DPM-Solver++(2M)'s update anchored at
the corrected sample). The final step returns D. The JAX package runs the
steps as one `lax.scan`, where the first step's corrector is computed and
discarded by `where`; here the steps are a Python loop on host scalars
(`dpm_solver.grid_scalars`) and the first step has no corrector.
"""

from __future__ import annotations

import numpy as np
import torch

from . import base
from .dpm_solver import alpha_sigma_lambda, grid_scalars, multistep_D


def corrector_coefficients(h_prev):
    """(phi1 - c2, c2) of UniC-2 over a step of length h_prev in lambda
    (clipped at 1e-12, as the JAX package does), float32."""
    one = np.float32(1.0)
    hp = max(np.float32(h_prev), np.float32(1e-12))
    phi1 = one - np.exp(-hp)
    c2 = phi1 - (one - (hp + one) * np.exp(-hp)) / hp
    return phi1 - c2, c2


class UniPC(base.FastVPSampler):
    """UniPC process (the DDIM API; deterministic)."""

    DESC = "UniPC sampling"

    def __init__(self, num_timesteps: int = 1000,
                 num_inference_steps: int = 10, eta: float = 0.0, **common):
        del eta  # accepted for the DDIM API; the solver is an ODE
        super().__init__(num_inference_steps=num_inference_steps,
                         num_timesteps=num_timesteps, **common)

    @torch.no_grad()
    def _solve(self, eps_x0, img, generator, noises, return_all_timesteps,
               progress, desc):
        rows = grid_scalars(self.schedule, self.inference_timesteps)
        a, s, _ = alpha_sigma_lambda(self.schedule)
        out = base.Trajectory(return_all_timesteps)
        batch, device = img.shape[0], img.device
        x_pred, x_prev, x0_prev = img, None, None
        t_prev, lam_prev, have_prev = 0, np.float32(0.0), False
        for i, (t_i, t_next, lam_t, lam_next, a_next, _,
                sig_ratio) in enumerate(rows):
            t = torch.full((batch,), t_i, dtype=torch.int64, device=device)
            _, x0 = eps_x0(x_pred, t)
            h_prev = lam_t - lam_prev
            if have_prev:
                c_prev, c_cur = corrector_coefficients(h_prev)
                ratio = s[t_i] / max(s[t_prev], np.float32(1e-12))
                x_cur = (float(ratio) * x_prev
                         + float(a[t_i]) * (float(c_prev) * x0_prev
                                            + float(c_cur) * x0))
            else:
                x_cur = x_pred
            final = t_next < 0
            h = lam_next - lam_t
            D = multistep_D(x0, x0_prev, h, h_prev, have_prev, final)
            x_pred = (D if final else float(sig_ratio) * x_cur
                      - float(a_next * (np.exp(-h) - np.float32(1.0))) * D)
            x_prev, x0_prev = x_cur, x0
            t_prev, lam_prev, have_prev = t_i, lam_t, True
            out.add(x_pred)
            base.report_progress(progress, desc, i + 1, len(rows))
        return out.result()
