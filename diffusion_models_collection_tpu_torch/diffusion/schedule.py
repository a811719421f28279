"""Noise schedules for diffusion processes.

Counterpart of `diffusion_models_collection_tpu/diffusion/schedule.py`:
linear, cosine and quadratic beta schedules and every derived coefficient,
in float32, with the same zero-terminal-SNR rescale, DDIM grid and Karras
grid.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

VALID_SCHEDULES = ("linear", "cosine", "quadratic")
VALID_SPACINGS = ("uniform", "karras")


def make_betas(num_timesteps: int, beta_start: float = 1e-4,
               beta_end: float = 0.02,
               beta_schedule: str = "linear") -> torch.Tensor:
    """The beta schedule, float32, shape (T,)."""
    if beta_schedule == "linear":
        return torch.linspace(beta_start, beta_end, num_timesteps,
                              dtype=torch.float32)
    if beta_schedule == "quadratic":
        return torch.linspace(beta_start**0.5, beta_end**0.5, num_timesteps,
                              dtype=torch.float32) ** 2
    if beta_schedule == "cosine":
        return _cosine_betas(num_timesteps)
    raise ValueError(f"Unknown beta schedule: {beta_schedule!r} (expected one "
                     f"of {VALID_SCHEDULES})")


def _cosine_betas(num_timesteps: int, s: float = 0.008) -> torch.Tensor:
    """Cosine schedule (Nichol & Dhariwal 2021)."""
    x = torch.linspace(0.0, num_timesteps, num_timesteps + 1,
                       dtype=torch.float32)
    acp = torch.cos(((x / num_timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    acp = acp / acp[0]
    return torch.clamp(1.0 - acp[1:] / acp[:-1], 0.0001, 0.9999)


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """All precomputed diffusion coefficients, each float32 of shape (T,)."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    def to(self, device) -> "NoiseSchedule":
        return NoiseSchedule(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})

    @classmethod
    def create(cls, num_timesteps: int = 1000, beta_start: float = 1e-4,
               beta_end: float = 0.02, beta_schedule: str = "linear",
               zero_terminal_snr: bool = False) -> "NoiseSchedule":
        betas = make_betas(num_timesteps, beta_start, beta_end, beta_schedule)
        alphas = 1.0 - betas
        alphas_cumprod = torch.cumprod(alphas, dim=0)
        if zero_terminal_snr:
            # Lin et al. 2023: rescale sqrt(acp) affinely so acp[T-1] = 0
            # and acp[0] is unchanged; betas follow from the new cumprod
            s = torch.sqrt(alphas_cumprod)
            s = (s - s[-1]) * (s[0] / (s[0] - s[-1]))
            alphas_cumprod = s**2
            alphas = torch.cat(
                [alphas_cumprod[:1], alphas_cumprod[1:] / alphas_cumprod[:-1]])
            betas = 1.0 - alphas
        alphas_cumprod_prev = torch.cat(
            [torch.ones(1, dtype=torch.float32), alphas_cumprod[:-1]])
        posterior_variance = (
            betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod))
        return cls(
            betas=betas,
            alphas=alphas,
            alphas_cumprod=alphas_cumprod,
            alphas_cumprod_prev=alphas_cumprod_prev,
            sqrt_alphas_cumprod=torch.sqrt(alphas_cumprod),
            sqrt_one_minus_alphas_cumprod=torch.sqrt(1.0 - alphas_cumprod),
            sqrt_recip_alphas=torch.sqrt(1.0 / alphas),
            sqrt_recip_alphas_cumprod=torch.sqrt(1.0 / alphas_cumprod),
            sqrt_recipm1_alphas_cumprod=torch.sqrt(1.0 / alphas_cumprod - 1.0),
            posterior_variance=posterior_variance,
            posterior_log_variance_clipped=torch.log(
                torch.clamp(posterior_variance, min=1e-20)),
            posterior_mean_coef1=(
                betas * torch.sqrt(alphas_cumprod_prev)
                / (1.0 - alphas_cumprod)),
            posterior_mean_coef2=(
                (1.0 - alphas_cumprod_prev) * torch.sqrt(alphas)
                / (1.0 - alphas_cumprod)),
        )


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients as (B, 1, ..., 1) with `ndim - 1`
    trailing singleton axes."""
    return a[t].reshape(t.shape[0], *((1,) * (ndim - 1)))


def ddim_timesteps(num_timesteps: int,
                   num_inference_steps: int) -> torch.Tensor:
    """DDIM grid round(linspace(T-1, 0, S)): descending, endpoints included,
    half to even, int64. The grid is computed in float64, so a value that
    is an exact tie (T = 1000, S = 3 gives 499.5) rounds as a tie."""
    grid = torch.linspace(num_timesteps - 1, 0, num_inference_steps,
                          dtype=torch.float64)
    return torch.round(grid).to(torch.int64)


def karras_timesteps(schedule: NoiseSchedule, num_inference_steps: int,
                     rho: float = 7.0) -> torch.Tensor:
    """Karras-spaced grid (Karras et al. 2022, eq. 5) over the schedule's VP
    sigma range sigma_t = sqrt((1 - acp) / acp), each sigma mapped to the
    nearest timestep, deduplicated; descending int64. Computed in float64
    from the float32 `alphas_cumprod`, so it may hold fewer than
    `num_inference_steps` entries. Zero-terminal-SNR puts sigma = inf at
    the last step, which the grid then starts from."""
    if num_inference_steps < 2:
        return torch.tensor([schedule.num_timesteps - 1], dtype=torch.int64)
    acp = schedule.alphas_cumprod.cpu().numpy().astype(np.float64)
    # zero-terminal-SNR: sigma[-1] = inf and the grid after it NaN, as in
    # the JAX package
    with np.errstate(divide="ignore", invalid="ignore"):
        sigmas = np.sqrt((1.0 - acp) / acp)  # ascending in t
        smin, smax = sigmas[0], sigmas[-1]
        i = np.arange(num_inference_steps, dtype=np.float64)
        grid = (smax ** (1.0 / rho) + i / (num_inference_steps - 1)
                * (smin ** (1.0 / rho) - smax ** (1.0 / rho))) ** rho
    idx = np.clip(np.searchsorted(sigmas, grid, side="left"), 1,
                  len(sigmas) - 1)
    left_closer = np.abs(grid - sigmas[idx - 1]) <= np.abs(sigmas[idx] - grid)
    ts = np.unique(np.where(left_closer, idx - 1, idx))[::-1]
    return torch.from_numpy(ts.copy()).to(torch.int64)


def inference_timesteps(schedule: NoiseSchedule, num_inference_steps: int,
                        spacing: str = "uniform",
                        rho: float = 7.0) -> torch.Tensor:
    """The fast samplers' descending grid: `ddim_timesteps` or, with
    `spacing` 'karras', `karras_timesteps`."""
    if spacing == "karras":
        return karras_timesteps(schedule, num_inference_steps, rho)
    if spacing != "uniform":
        raise ValueError(f"Unknown timestep spacing: {spacing!r} (expected "
                         f"one of {VALID_SPACINGS})")
    return ddim_timesteps(schedule.num_timesteps, num_inference_steps)
