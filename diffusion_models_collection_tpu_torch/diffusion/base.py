"""Shared diffusion-process pieces of the sampling path: x0 recovery,
parameterization views, classifier-free guidance and x0 constraints.

Counterpart of the sampling half of
`diffusion_models_collection_tpu/diffusion/base.py`. Plain functions on
tensors; the model is any callable `(x, t, y) -> output` on NHWC tensors.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .schedule import NoiseSchedule, extract

VALID_PREDICTION_TYPES = ("eps", "v", "x0")

# Sentinel default for p_threshold: 0.995 in bounded (pixel) spaces, None
# in unbounded (latent) ones.
AUTO_THRESHOLD = "auto"


def predict_x0_from_eps(schedule: NoiseSchedule, x: torch.Tensor,
                        t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """x0 = sqrt(1/acp_t) * x_t - sqrt(1/acp_t - 1) * eps."""
    c1 = extract(schedule.sqrt_recip_alphas_cumprod, t, x.ndim)
    c2 = extract(schedule.sqrt_recipm1_alphas_cumprod, t, x.ndim)
    return c1 * x - c2 * eps


def wrap_model_as_eps_x0(schedule: NoiseSchedule, model_fn: Callable,
                         prediction_type: str) -> Callable:
    """A `(x, t, y) -> (eps, x0)` view of a model in any parameterization,
    converting the raw output to each directly (the only finite route under
    zero-terminal-SNR schedules, where eps carries no x0 information)."""
    if prediction_type == "eps":
        def pair(x, t, y=None):
            eps = model_fn(x, t, y)
            return eps, predict_x0_from_eps(schedule, x, t, eps)
    elif prediction_type == "v":
        def pair(x, t, y=None):
            v = model_fn(x, t, y)
            a = extract(schedule.sqrt_alphas_cumprod, t, x.ndim)
            b = extract(schedule.sqrt_one_minus_alphas_cumprod, t, x.ndim)
            return b * x + a * v, a * x - b * v
    elif prediction_type == "x0":
        def pair(x, t, y=None):
            x0 = model_fn(x, t, y)
            a = extract(schedule.sqrt_alphas_cumprod, t, x.ndim)
            b = extract(schedule.sqrt_one_minus_alphas_cumprod, t, x.ndim)
            return (x - a * x0) / torch.clamp(b, min=1e-12), x0
    else:
        raise ValueError(f"Unknown prediction type: {prediction_type!r} "
                         f"(expected one of {VALID_PREDICTION_TYPES})")
    return pair


def resolve_p_threshold(p_threshold, clip_sample: bool):
    """AUTO_THRESHOLD becomes 0.995 for bounded spaces and None for
    unbounded ones; floats in (0, 1) and None pass through."""
    if isinstance(p_threshold, str):
        if p_threshold != AUTO_THRESHOLD:
            raise ValueError(f"Unknown p_threshold: {p_threshold!r}")
        return 0.995 if clip_sample else None
    if p_threshold is not None and not 0.0 < float(p_threshold) < 1.0:
        raise ValueError("p_threshold must be in (0, 1) or None")
    return p_threshold


def dynamic_threshold(x0: torch.Tensor, p_threshold: float) -> torch.Tensor:
    """Imagen dynamic thresholding: per-sample quantile s of |x0| at
    p_threshold (linear interpolation), floored at 1; clamp to [-s, s] and
    divide by s."""
    batch = x0.shape[0]
    flat = x0.reshape(batch, -1).abs()
    s = torch.quantile(flat, p_threshold, dim=1, interpolation="linear")
    s = torch.clamp(s, min=1.0).reshape(batch, *((1,) * (x0.ndim - 1)))
    return torch.clamp(x0, -s, s) / s


def constrain_x0(x0: torch.Tensor, p_threshold: Optional[float],
                 clip_denoised: bool) -> torch.Tensor:
    """Dynamic threshold when p_threshold is set, else clamp to [-1, 1] when
    clip_denoised, else pass through (unbounded latent spaces)."""
    if p_threshold is not None:
        if not 0.0 < float(p_threshold) < 1.0:
            raise ValueError("p_threshold must be in (0, 1) or None")
        return dynamic_threshold(x0, float(p_threshold))
    if clip_denoised:
        return torch.clamp(x0, -1.0, 1.0)
    return x0


def rescale_guided(x_g: torch.Tensor, x_c: torch.Tensor,
                   phi: float) -> torch.Tensor:
    """Guidance contrast rescale (Lin et al. 2023 section 3.4): pull the
    guided prediction's per-sample std toward the conditional branch's and
    blend with factor phi. Population std, as jnp.std."""
    axes = tuple(range(1, x_g.ndim))
    std_c = torch.std(x_c, dim=axes, keepdim=True, correction=0)
    std_g = torch.std(x_g, dim=axes, keepdim=True, correction=0)
    res = x_g * (std_c / torch.clamp(std_g, min=1e-12))
    return phi * res + (1.0 - phi) * x_g


def validate_guidance_rescale(value) -> float:
    v = float(value)
    if not 0.0 <= v <= 1.0:
        raise ValueError(f"guidance_rescale must be in [0, 1], got {value!r}")
    return v


def validate_cfg_interval(value, num_timesteps: int):
    """A `cfg_interval: [t_lo, t_hi]` value (0 <= lo <= hi < T) or None."""
    if value is None:
        return None
    lo, hi = int(value[0]), int(value[1])
    if not 0 <= lo <= hi < num_timesteps:
        raise ValueError(f"cfg_interval must satisfy 0 <= lo <= hi < "
                         f"{num_timesteps}, got {value!r}")
    return (lo, hi)


def cfg_eps_x0(pair_fn: Callable, x: torch.Tensor, t: torch.Tensor,
               y: torch.Tensor, cfg_scale: float, guidance_rescale: float = 0.0,
               schedule: Optional[NoiseSchedule] = None, cfg_interval=None):
    """Classifier-free guidance on an (eps, x0) pair with one model call on
    the [cond; uncond] batch (labels, then the null label 0).

    `guidance_rescale` (phi in [0, 1]) rescales the guided x0 toward the
    conditional branch's std and re-derives eps from it; `cfg_interval`
    (t_lo, t_hi) guides only inside that timestep range and uses the
    conditional prediction outside it.
    """
    x2 = torch.cat([x, x], dim=0)
    t2 = torch.cat([t, t], dim=0)
    y2 = torch.cat([y, torch.zeros_like(y)], dim=0)
    eps2, x02 = pair_fn(x2, t2, y2)
    eps_c, eps_u = eps2.chunk(2, dim=0)
    x0_c, x0_u = x02.chunk(2, dim=0)
    eps_g = eps_u + cfg_scale * (eps_c - eps_u)
    x0_g = x0_u + cfg_scale * (x0_c - x0_u)
    if float(guidance_rescale) > 0.0:
        if schedule is None:
            raise ValueError("guidance_rescale needs the noise schedule")
        x0_g = rescale_guided(x0_g, x0_c, float(guidance_rescale))
        a = extract(schedule.sqrt_alphas_cumprod, t, x.ndim)
        b = extract(schedule.sqrt_one_minus_alphas_cumprod, t, x.ndim)
        eps_g = (x - a * x0_g) / torch.clamp(b, min=1e-12)
    if cfg_interval is not None:
        lo, hi = cfg_interval
        gate = ((t >= lo) & (t <= hi)).reshape(-1, *((1,) * (x.ndim - 1)))
        eps_g = torch.where(gate, eps_g, eps_c)
        x0_g = torch.where(gate, x0_g, x0_c)
    return eps_g, x0_g
