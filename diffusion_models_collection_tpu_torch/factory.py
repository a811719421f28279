"""Composition helpers of the CLIs: build the model, the diffusion process
and the training data from a config, and load a checkpoint's weights for
inference.

Counterpart of `diffusion_models_collection_tpu/factory.py` for what this
port covers: the UNet, DiT and DiM, DDPM training and sampling, DDIM
sampling, float32 or mixed precision (`mixed_precision: 'bf16'`).
The datasets and the loader are this package's `datasets/` (numpy and
ctypes, a copy of the JAX package's: the port imports nothing of it). Every
other model type,
diffusion type, sampler and config extension raises, naming the ROADMAP
item that ports it.
"""

from __future__ import annotations

from typing import Mapping, Union

import torch
from torch import nn

from .datasets import CustomImageDataset, DataLoader, DiffusionDataset
from .diffusion import DDIM, DDPM
from .models import DiM, DiT, UNet
from .utils.helpers import resolve_image_size


MODEL_CLASSES = {"unet": UNet, "dit": DiT, "dim": DiM}


def get_model(config: Mapping) -> nn.Module:
    """Build the denoiser from config, injecting the normalized image size
    (`image_size` for the UNet, `img_size` for DiT and DiM) and the
    conditional class count."""
    model_type = str(config["model_type"]).lower()
    if model_type not in MODEL_CLASSES:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported yet (ROADMAP queue 1 "
            "item 11)")
    for key in ("latent_diffusion", "super_resolution"):
        if config.get(key):
            raise NotImplementedError(
                f"{key} is not ported yet (ROADMAP queue 1 item 11)")
    params = dict(config.get("model_params", {}))
    # Mixed precision, the JAX factory's policy: 'bf16' runs the model's
    # convs, linears and activations in bfloat16 while the parameters, the
    # optimizer state, the EMA and the loss stay float32 (the model returns
    # float32 eps); no loss scaling.
    mp = str(config.get("mixed_precision", "none") or "none").lower()
    if mp in ("bf16", "bfloat16"):
        params["dtype"] = torch.bfloat16
    elif mp not in ("none", "fp32", "float32", "off", "false"):
        raise ValueError(f"Unknown mixed_precision: {mp!r}")
    size_key = "image_size" if model_type == "unet" else "img_size"
    params[size_key] = resolve_image_size(config["image_size"])
    params["num_classes"] = (config.get("num_classes")
                             if config.get("conditional", False) else None)
    if config.get("remat", False):
        params["remat"] = True
    return MODEL_CLASSES[model_type](**params)


def get_diffusion(config: Mapping,
                  sampling_method: str = "ddpm") -> Union[DDPM, DDIM]:
    """The diffusion process over the config's VP schedule: DDPM (training
    always, and ancestral sampling) or DDIM sampling."""
    dtype_key = str(config.get("diffusion_type", "ddpm")).lower()
    if dtype_key not in ("ddpm", "diffusion"):
        raise NotImplementedError(
            f"diffusion_type {dtype_key!r} is not ported yet (ROADMAP queue "
            "1 item 10)")
    common = dict(
        num_timesteps=config["num_timesteps"],
        beta_start=config["beta_start"],
        beta_end=config["beta_end"],
        beta_schedule=config["beta_schedule"],
        prediction_type=config.get("prediction_type", "eps"),
        zero_terminal_snr=config.get("zero_terminal_snr", False),
        guidance_rescale=config.get("guidance_rescale", 0.0),
        clip_sample=bool(config.get("clip_sample", True)),
        cfg_interval=config.get("cfg_interval"),
    )
    method = sampling_method.lower()
    if method == "ddpm":
        return DDPM(loss_weighting=config.get("loss_weighting", "uniform"),
                    min_snr_gamma=config.get("min_snr_gamma", 5.0), **common)
    if method != "ddim":
        raise NotImplementedError(
            f"sampling_method {sampling_method!r} is not ported yet (ROADMAP "
            "queue 1 item 10)")
    return DDIM(
        num_inference_steps=config.get("num_inference_steps", 50),
        eta=config.get("ddim_eta", 0.0),
        timestep_spacing=config.get("timestep_spacing", "uniform"),
        **common,
    )


def get_dataset(config: Mapping, train: bool = True):
    """The training dataset, built as the JAX package's factory builds it
    (uint8 images in host memory, decoded by numpy), from `.datasets`."""
    dataset_name = config["dataset"].lower()
    img_size = resolve_image_size(config["image_size"])
    if dataset_name == "custom":
        return CustomImageDataset(
            root=config["data_root"],
            transform=CustomImageDataset.get_default_transform(
                img_size, "rgb", train=train),
            conditional=config.get("conditional", False),
            label_file=config.get("label_file"),
            use_subdirs=config.get("use_subdirs", False),
        )
    kwargs = {}
    if dataset_name == "synthetic":
        kwargs = dict(
            image_size=img_size,
            channels=config.get("model_params", {}).get("in_channels", 3),
            num_classes=config.get("num_classes", 10) or 10,
        )
    return DiffusionDataset(
        dataset_name=dataset_name,
        root=config.get("data_root", "./data"),
        train=train,
        transform=DiffusionDataset.get_default_transform(
            img_size, dataset_name, train=train),
        conditional=config.get("conditional", False),
        **kwargs,
    )


def get_dataloader(config: Mapping, dataset, train: bool = True,
                   seed: int = 0) -> DataLoader:
    """The loader of `.datasets` in one process: numpy batches (B, H, W, C)
    in [-1, 1], reshuffled per epoch from `seed`, the last partial batch
    dropped in training."""
    return DataLoader(
        dataset,
        batch_size=config["batch_size"],
        shuffle=train,
        drop_last=train,
        seed=seed,
        num_workers=config.get("num_workers"),
        cache_decoded=config.get("cache_decoded", False),
        fast_jpeg_decode=train and config.get("fast_jpeg_decode", False),
    )


def load_model_for_inference(checkpoint: Mapping, config: Mapping,
                             use_ema: bool,
                             device: torch.device) -> nn.Module:
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
