"""Diffusion processes (DDIM sampling so far)."""

from .ddim import DDIM, ddim_step
from .schedule import NoiseSchedule, ddim_timesteps, extract, make_betas

__all__ = ["DDIM", "NoiseSchedule", "ddim_step", "ddim_timesteps", "extract",
           "make_betas"]
