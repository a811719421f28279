"""Diffusion processes: DDPM (training and ancestral sampling) and DDIM
sampling."""

from .ddim import DDIM, ddim_step
from .ddpm import DDPM, posterior_step
from .schedule import NoiseSchedule, ddim_timesteps, extract, make_betas

__all__ = ["DDIM", "DDPM", "NoiseSchedule", "ddim_step", "ddim_timesteps",
           "extract", "make_betas", "posterior_step"]
