"""Diffusion processes: DDPM (training and ancestral sampling), the fast VP
samplers (DDIM, DPM-Solver++ 2M and SDE, UniPC; uniform or Karras grids),
flow matching and EDM, with img2img and inpainting (RePaint on DDPM, DDIM
inversion and restarts); PAG (`pag`) and DeepCache (`deepcache`) sampling
around them; consistency models (`consistency`) and progressive
distillation's objective (`distill`)."""

from .consistency import ConsistencyModel
from .ddim import DDIM, ddim_step
from .ddpm import DDPM, posterior_step
from .dpm_solver import DPMSolverPP
from .edm import EDM
from .flow_matching import FlowMatching
from .schedule import (NoiseSchedule, ddim_timesteps, extract,
                       karras_timesteps, make_betas)
from .unipc import UniPC

__all__ = ["ConsistencyModel", "DDIM", "DDPM", "DPMSolverPP", "EDM",
           "FlowMatching", "NoiseSchedule", "UniPC", "ddim_step", "ddim_timesteps", "extract",
           "karras_timesteps", "make_betas", "posterior_step"]
