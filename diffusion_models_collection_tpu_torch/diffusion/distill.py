"""Progressive distillation (Salimans & Ho 2022): a student matches two
teacher DDIM steps with one of its own.

Counterpart of `diffusion_models_collection_tpu/diffusion/distill.py`. From
z at grid time t the teacher's eta 0 DDIM steps t -> t_mid -> t_next land on
z''; the student's one step from (z, t) reaches z'' when it predicts

    x0_target = (z'' - (b_next / b_t) z) / (a_next - (b_next / b_t) a_t)

(x_t = a_t x0 + b_t eps; t_next = -1 is the clean end, a = 1, b = 0, where
x0_target = z''). The student regresses onto it in x0 space with the weight
max(SNR(t), 1).
"""

from __future__ import annotations

import torch

from .ddim import ddim_step
from .schedule import NoiseSchedule, ddim_timesteps, extract


def distill_grids(num_timesteps: int, student_steps: int):
    """(t, t_mid, t_next), int64, of a `student_steps`-step student under a
    2N-step teacher grid: t its even entries, t_mid its odd ones, t_next the
    even ones shifted by one with the terminal -1."""
    if student_steps < 1:
        raise ValueError("student_steps must be >= 1")
    teacher = ddim_timesteps(num_timesteps, 2 * student_steps)
    t_next = torch.cat([teacher[2::2], torch.tensor([-1])])
    return teacher[0::2], teacher[1::2], t_next


def _ab(schedule: NoiseSchedule, t: torch.Tensor, ndim: int):
    """(sqrt(acp_t), sqrt(1 - acp_t)), with (1, 0) where t < 0."""
    a = extract(schedule.sqrt_alphas_cumprod, t.clamp(min=0), ndim)
    b = extract(schedule.sqrt_one_minus_alphas_cumprod, t.clamp(min=0), ndim)
    mask = (t >= 0).reshape(-1, *((1,) * (ndim - 1)))
    return (torch.where(mask, a, torch.ones_like(a)),
            torch.where(mask, b, torch.zeros_like(b)))


@torch.no_grad()
def two_step_teacher_target(schedule: NoiseSchedule, teacher_pair_fn,
                            z: torch.Tensor, t: torch.Tensor,
                            t_mid: torch.Tensor, t_next: torch.Tensor,
                            y=None) -> torch.Tensor:
    """The x0-space target of one student step t -> t_next that matches
    the teacher's two eta 0 DDIM steps through t_mid (t_next may be -1).
    The teacher's x0 is not clipped."""
    eps1, x01 = teacher_pair_fn(z, t, y)
    z_mid = ddim_step(schedule, z, t, t_mid, eps1, x01, 0.0, None)
    eps2, x02 = teacher_pair_fn(z_mid, t_mid.clamp(min=0), y)
    z2 = ddim_step(schedule, z_mid, t_mid, t_next, eps2, x02, 0.0, None)
    a_t, b_t = _ab(schedule, t, z.ndim)
    a_n, b_n = _ab(schedule, t_next, z.ndim)
    ratio = b_n / torch.clamp(b_t, min=1e-12)
    denom = a_n - ratio * a_t
    # 0 only for two grid points at one noise level: never on a strictly
    # descending grid
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12),
                        denom)
    return (z2 - ratio * z) / denom


def student_distill_loss(schedule: NoiseSchedule, student_pair_fn,
                         x0_target: torch.Tensor, z: torch.Tensor,
                         t: torch.Tensor, y=None) -> torch.Tensor:
    """mean over the batch of max(SNR(t), 1) times the student's x0 error's
    per-sample mean square."""
    _, x0_pred = student_pair_fn(z, t, y)
    acp = extract(schedule.alphas_cumprod, t, 1)
    w = torch.clamp(acp / torch.clamp(1.0 - acp, min=1e-12), min=1.0)
    diff = x0_pred - x0_target
    return (w * (diff**2).mean(dim=tuple(range(1, diff.ndim)))).mean()
