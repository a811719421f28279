"""Composition helpers of the sampling CLI: build the model and the diffusion
process from a config, and load a checkpoint's weights for inference.

Counterpart of `diffusion_models_collection_tpu/factory.py` for what this
port covers: the UNet, DDIM sampling, float32. Every other model type,
diffusion type, sampler and config extension raises, naming the ROADMAP
item that ports it.
"""

from __future__ import annotations

from typing import Mapping

import torch

from .diffusion import DDIM
from .models import UNet
from .utils.helpers import resolve_image_size


def get_model(config: Mapping) -> UNet:
    """Build the denoiser from config, injecting the normalized image size
    and the conditional class count."""
    model_type = str(config["model_type"]).lower()
    if model_type != "unet":
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported yet (ROADMAP queue 1 "
            "items 8, 9 and 11)")
    for key in ("latent_diffusion", "super_resolution"):
        if config.get(key):
            raise NotImplementedError(
                f"{key} is not ported yet (ROADMAP queue 1 item 11)")
    mp = str(config.get("mixed_precision", "none") or "none").lower()
    if mp in ("bf16", "bfloat16"):
        raise NotImplementedError(
            "mixed_precision 'bf16' is not ported yet (ROADMAP queue 1 "
            "item 5); this port runs float32")
    if mp not in ("none", "fp32", "float32", "off", "false"):
        raise ValueError(f"Unknown mixed_precision: {mp!r}")
    params = dict(config.get("model_params", {}))
    params["image_size"] = resolve_image_size(config["image_size"])
    params["num_classes"] = (config.get("num_classes")
                             if config.get("conditional", False) else None)
    if config.get("remat", False):
        params["remat"] = True
    return UNet(**params)


def get_diffusion(config: Mapping, sampling_method: str = "ddim") -> DDIM:
    """Build the sampler: DDIM over the config's VP schedule."""
    dtype_key = str(config.get("diffusion_type", "ddpm")).lower()
    if dtype_key not in ("ddpm", "diffusion"):
        raise NotImplementedError(
            f"diffusion_type {dtype_key!r} is not ported yet (ROADMAP queue "
            "1 item 10)")
    if sampling_method.lower() != "ddim":
        raise NotImplementedError(
            f"sampling_method {sampling_method!r} is not ported yet: DDPM is "
            "ROADMAP queue 1 item 3, the other samplers item 10")
    return DDIM(
        num_timesteps=config["num_timesteps"],
        num_inference_steps=config.get("num_inference_steps", 50),
        beta_start=config["beta_start"],
        beta_end=config["beta_end"],
        beta_schedule=config["beta_schedule"],
        eta=config.get("ddim_eta", 0.0),
        prediction_type=config.get("prediction_type", "eps"),
        zero_terminal_snr=config.get("zero_terminal_snr", False),
        timestep_spacing=config.get("timestep_spacing", "uniform"),
        guidance_rescale=config.get("guidance_rescale", 0.0),
        clip_sample=bool(config.get("clip_sample", True)),
        cfg_interval=config.get("cfg_interval"),
    )


def load_model_for_inference(checkpoint: Mapping, config: Mapping,
                             use_ema: bool,
                             device: torch.device) -> UNet:
    """The model with the checkpoint's weights (the EMA weights with
    `use_ema` when present), strict load, eval mode, on `device`."""
    model = get_model(config)
    if use_ema and checkpoint.get("ema_model_state_dict") is not None:
        print("Using EMA model")
        state = checkpoint["ema_model_state_dict"]
    else:
        state = checkpoint["model_state_dict"]
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()
