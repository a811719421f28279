"""Composition helpers of the CLIs: build the model, the diffusion process
and the training data from a config, and load a checkpoint's weights for
inference.

Counterpart of `diffusion_models_collection_tpu/factory.py` for what this
port covers: the UNet, DiT and DiM; the KL-VAE (`model_type: 'vae'`) and
latent diffusion (`latent_diffusion: true`: any denoiser in the latent space
of the VAE checkpoint that `vae_checkpoint` names, its geometry read from
that checkpoint, `utils/latent.py`); the noise-conditional classifier of
classifier guidance (`model_type: 'classifier'`, `models/classifier.py`);
SR3 super-resolution stages (a `super_resolution` block, `utils/sr.py`:
the denoiser's input channels double for the upsampled LR image, its
output keeps the data channels); DDPM training and sampling and the fast
VP samplers (DDIM, DPM-Solver++ 2M and SDE, UniPC); flow matching and EDM,
each training and sampling; consistency models (`diffusion_type:
'consistency'`, their multistep sampler); float32 or mixed precision
(`mixed_precision: 'bf16'`).
The datasets and the loader are this package's `datasets/` (numpy and
ctypes, a copy of the JAX package's: the port imports nothing of it).
`model_params` reach the model as they are, the training-free fields among
them (the UNet's `pag_perturb`, `freeu`, `deepcache_mode`,
`deepcache_depth`; the DiT's `pag_perturb`, `tome_ratio`, `tome_mlp`,
`quant`) and the DiT's Mixture-of-Experts keys (`num_experts`,
`moe_top_k`, `moe_capacity_factor`), so every config of `configs/` builds.
An unknown model type raises as in the JAX factory.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from .datasets import CustomImageDataset, DataLoader, DiffusionDataset
from .diffusion import (DDIM, DDPM, ConsistencyModel, DPMSolverPP, EDM,
                        FlowMatching, UniPC)
from .models import VAE, DiM, DiT, NoisyClassifier, UNet
from .utils.helpers import resolve_image_size
from .utils.latent import LatentCodec
from .utils.sr import SRSpec


MODEL_CLASSES = {"unet": UNet, "dit": DiT, "dim": DiM, "vae": VAE,
                 "classifier": NoisyClassifier}


def get_model(config: Mapping) -> nn.Module:
    """Build the model from config, injecting the normalized image size
    (`image_size` for the UNet, the VAE and the classifier, `img_size` for
    DiT and DiM) and, for a denoiser, the conditional class count (for the
    classifier the real class count, at least 2, with no null class). Under
    `latent_diffusion` the denoiser's size and channels are the VAE
    checkpoint's latent ones (the JAX factory's rule), and a declared
    `in_channels` must agree. Under `super_resolution` the denoiser takes
    twice the data channels and predicts the data channels."""
    model_type = str(config["model_type"]).lower()
    if model_type not in MODEL_CLASSES:
        raise ValueError(f"Unknown model type: {model_type}")
    params = dict(config.get("model_params", {}))
    image_size = resolve_image_size(config["image_size"])
    # validated before the latent block, so a conflict surfaces without
    # reading the VAE checkpoint
    sr = SRSpec.from_config(config)
    if sr is not None:
        if model_type == "vae":
            raise ValueError(
                "super_resolution applies to denoisers, not the VAE stage")
        if config.get("latent_diffusion"):
            raise ValueError(
                "super_resolution composes with pixel-space diffusion only "
                "(the LR conditioning is defined on pixels, not on a VAE's "
                "latent grid)")
    if config.get("latent_diffusion") and model_type != "vae":
        # the geometry only: the VAE is read on the host, once per process
        codec = LatentCodec.from_config(config, device="cpu")
        image_size = codec.latent_hw()
        lc = codec.latent_channels
        declared = params.get("in_channels")
        if declared is not None and int(declared) != lc:
            raise ValueError(
                f"model_params.in_channels={declared} conflicts with the "
                f"VAE's latent_channels={lc} under latent_diffusion")
        params["in_channels"] = lc
        if model_type == "unet":
            params["out_channels"] = lc
    if sr is not None:
        # [x_t ; upsampled LR] in, eps of the data channels out
        data_ch = int(params.get("in_channels", 3))
        params["in_channels"] = 2 * data_ch
        if model_type == "unet":
            params.setdefault("out_channels", data_ch)
        else:
            params["out_channels"] = data_ch
    # Mixed precision, the JAX factory's policy: 'bf16' runs the model's
    # convs, linears and activations in bfloat16 while the parameters, the
    # optimizer state, the EMA and the loss stay float32 (the model returns
    # float32 eps); no loss scaling.
    mp = str(config.get("mixed_precision", "none") or "none").lower()
    if mp in ("bf16", "bfloat16"):
        params["dtype"] = torch.bfloat16
    elif mp not in ("none", "fp32", "float32", "off", "false"):
        raise ValueError(f"Unknown mixed_precision: {mp!r}")
    size_key = ("image_size" if model_type in ("unet", "vae", "classifier")
                else "img_size")
    params[size_key] = image_size
    if model_type == "classifier":
        # labels are the classifier's targets, not an input embedding: the
        # real class count, no CFG null class
        if sr is not None:
            raise ValueError(
                "super_resolution does not apply to the classifier")
        nc = int(config.get("num_classes", 0) or 0)
        if nc < 2:
            raise ValueError("model_type 'classifier' needs num_classes >= 2")
        params["num_classes"] = nc
    elif model_type != "vae":  # the autoencoder is unconditional
        params["num_classes"] = (config.get("num_classes")
                                 if config.get("conditional", False) else None)
    if config.get("remat", False):
        params["remat"] = True
    return MODEL_CLASSES[model_type](**params)


def get_diffusion(config: Mapping, sampling_method: str = "ddpm"):
    """The diffusion process of a config, as the JAX factory builds it.

    `diffusion_type: 'flow_matching'` (also 'flow', 'rectified_flow') and
    'edm' own training and sampling, and 'consistency' sampling, whatever
    `sampling_method` says; the first two reject the VP-only keys that do
    not apply to them. Otherwise
    `sampling_method` picks DDIM, DPM-Solver++ (also its SDE form) or
    UniPC on the VP schedule, under the JAX factory's aliases, and DDPM
    for 'ddpm' or any other name (training always runs DDPM's objective).
    """
    dtype_key = str(config.get("diffusion_type", "ddpm")).lower()
    clip_sample = bool(config.get("clip_sample",
                                  not config.get("latent_diffusion", False)))
    if dtype_key in ("flow", "flow_matching", "rectified_flow"):
        if str(config.get("loss_weighting", "uniform")) != "uniform":
            raise ValueError(
                "loss_weighting is SNR-based and does not apply to flow "
                "matching (the velocity objective is already uniformly "
                "weighted along the path)")
        if float(config.get("guidance_rescale", 0.0)) != 0.0:
            raise ValueError(
                "guidance_rescale is defined on the VP-diffusion x0 "
                "prediction and does not apply to flow matching")
        if config.get("cfg_interval") is not None:
            raise ValueError("cfg_interval is defined on the VP timestep "
                             "grid and does not apply to flow matching")
        return FlowMatching(
            num_timesteps=config["num_timesteps"],
            num_inference_steps=config.get("num_inference_steps", 50),
            solver=config.get("flow_solver", "euler"),
            clip_sample=clip_sample)
    if dtype_key == "edm":
        if str(config.get("loss_weighting", "uniform")) != "uniform":
            raise ValueError("loss_weighting does not apply to EDM: it has "
                             "its own lambda(sigma) weighting")
        if str(config.get("prediction_type", "eps")) != "eps":
            raise ValueError("prediction_type does not apply to EDM: the "
                             "preconditioned denoiser D is defined in x0 "
                             "space")
        if config.get("cfg_interval") is not None:
            raise ValueError("cfg_interval is defined on the VP timestep "
                             "grid and does not apply to EDM (its noise "
                             "levels are sigmas)")
        return EDM(
            num_timesteps=config["num_timesteps"],
            num_inference_steps=config.get("num_inference_steps", 18),
            sigma_data=config.get("sigma_data", 0.5),
            sigma_min=config.get("sigma_min", 0.002),
            sigma_max=config.get("sigma_max", 80.0),
            rho=config.get("edm_rho", config.get("karras_rho", 7.0)),
            p_mean=config.get("p_mean", -1.2),
            p_std=config.get("p_std", 1.2),
            s_churn=config.get("s_churn", 0.0),
            s_min=config.get("s_min", 0.0),
            s_max=config.get("s_max", float("inf")),
            s_noise=config.get("s_noise", 1.0),
            guidance_rescale=config.get("guidance_rescale", 0.0),
            clip_sample=clip_sample)
    if dtype_key == "consistency":
        # a checkpoint of the consistency trainers owns its stack and step
        # count: DDPM/DDIM grids mean nothing for f(x, t) -> x0
        return ConsistencyModel(
            num_timesteps=config["num_timesteps"],
            num_inference_steps=config.get("num_inference_steps", 2),
            beta_start=config["beta_start"],
            beta_end=config["beta_end"],
            beta_schedule=config["beta_schedule"],
            prediction_type=config.get("prediction_type", "eps"),
            sigma_data=config.get("sigma_data", 0.5),
            timestep_scaling=config.get("timestep_scaling", 10.0),
            zero_terminal_snr=config.get("zero_terminal_snr", False),
            clip_sample=clip_sample)
    if dtype_key not in ("ddpm", "diffusion"):
        raise ValueError(
            f"Unknown diffusion_type: {config.get('diffusion_type')!r} "
            "(expected 'ddpm', 'flow_matching', 'edm' or 'consistency')")
    common = dict(
        num_timesteps=config["num_timesteps"],
        beta_start=config["beta_start"],
        beta_end=config["beta_end"],
        beta_schedule=config["beta_schedule"],
        prediction_type=config.get("prediction_type", "eps"),
        loss_weighting=config.get("loss_weighting", "uniform"),
        min_snr_gamma=config.get("min_snr_gamma", 5.0),
        zero_terminal_snr=config.get("zero_terminal_snr", False),
        guidance_rescale=config.get("guidance_rescale", 0.0),
        clip_sample=clip_sample,
        cfg_interval=config.get("cfg_interval"),
    )
    fast_common = dict(
        common,
        timestep_spacing=config.get("timestep_spacing", "uniform"),
        karras_rho=config.get("karras_rho", 7.0),
    )
    method = sampling_method.lower()
    if method == "ddim":
        return DDIM(num_inference_steps=config.get("num_inference_steps", 50),
                    eta=config.get("ddim_eta", 0.0), **fast_common)
    if method in ("dpm++", "dpmpp", "dpm_solver++", "dpm-solver++"):
        return DPMSolverPP(
            num_inference_steps=config.get("num_inference_steps", 20),
            **fast_common)
    if method in ("unipc", "uni-pc", "uni_pc"):
        return UniPC(num_inference_steps=config.get("num_inference_steps", 10),
                     **fast_common)
    if method in ("dpm++sde", "dpmpp_sde", "sde-dpm++", "dpm++_sde"):
        return DPMSolverPP(
            num_inference_steps=config.get("num_inference_steps", 20),
            sde=True, **fast_common)
    return DDPM(**common)


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
                   seed: int = 0, process_index: int = 0,
                   process_count: int = 1) -> DataLoader:
    """The loader of `.datasets`: numpy batches (B, H, W, C) in [-1, 1],
    reshuffled per epoch from `seed`, the last partial batch dropped in
    training; with `process_count` > 1 data-parallel ranks, the strided
    shard `process_index` of each epoch in batches of `max(1, batch_size //
    process_count)`: `batch_size` is the global batch, as the JAX package's
    loader takes it (`factory.py` there)."""
    return DataLoader(
        dataset,
        batch_size=max(1, config["batch_size"] // max(1, process_count)),
        shuffle=train,
        drop_last=train,
        seed=seed,
        process_index=process_index,
        process_count=process_count,
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
