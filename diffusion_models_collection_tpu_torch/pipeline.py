"""Sampling pipeline behind `sample.py`.

Counterpart of `diffusion_models_collection_tpu/pipeline.py` for the
branches this port serves: DDPM, DDIM, DPM-Solver++ (2M and SDE) and UniPC
on a VP checkpoint, and the flow-matching and EDM checkpoints' own
samplers, each with classifier-free guidance (conditional checkpoints with
--cfg_scale > 0; --guidance_rescale and --cfg_interval override the
config's keys) or plain, optionally returning every step's state;
--num_inference_steps and --mixed_precision override the config's keys.
The JAX pipeline's other knobs (ToMe, FreeU, int8, PAG, DeepCache,
classifier guidance, super-resolution, img2img, restarts, latent decode)
are ROADMAP queue 1 items 10 and 11; configs that ask for them raise in the
factory.
"""

from __future__ import annotations

import numpy as np
import torch

from .factory import get_diffusion, load_model_for_inference
from .utils.helpers import resolve_image_size


def build_labels(args, config, nrow: int, num_rows: int):
    """Per-row class labels shifted by +1 (0 is the CFG null label), or None
    for an unconditional checkpoint."""
    conditional = config.get("conditional", False)
    num_classes = config.get("num_classes")
    if not conditional:
        return None
    if args.labels:
        row_labels = [int(x.strip()) for x in args.labels.split(",")]
        if num_classes is not None:
            for lbl in row_labels:
                if not 0 <= lbl < num_classes:
                    raise ValueError(
                        f"Label {lbl} is out of range [0, {num_classes})")
        if len(row_labels) < num_rows:
            row_labels = (row_labels * (num_rows // len(row_labels) + 1))[
                :num_rows]
        else:
            row_labels = row_labels[:num_rows]
        labels = np.repeat(np.asarray(row_labels) + 1, nrow)[:args.num_samples]
    elif num_classes is not None:
        rng = np.random.default_rng(args.seed)
        row_labels = rng.integers(0, num_classes, size=num_rows)
        labels = np.repeat(row_labels + 1, nrow)[:args.num_samples]
    else:
        raise ValueError("Conditional generation requires either --labels "
                         "or known num_classes.")
    print(f"Using conditional generation with labels: {labels.tolist()}")
    return labels.astype(np.int64)


FAST_SAMPLERS = ("ddim", "dpm++", "dpm++sde", "unipc")


def apply_steps_and_precision(args, config, is_flow: bool,
                              is_edm: bool) -> None:
    """The JAX pipeline's step-count rule: --num_inference_steps sets the
    config's count for the fast samplers and for flow and EDM checkpoints;
    without it DDIM on a VP checkpoint takes the CLI's default of 50 and
    every other case keeps the checkpoint's count. --mixed_precision
    overrides the compute dtype."""
    method = args.sampling_method.lower()
    if args.num_inference_steps is not None:
        if method in FAST_SAMPLERS or is_flow or is_edm:
            config["num_inference_steps"] = args.num_inference_steps
    elif method == "ddim" and not (is_flow or is_edm):
        config["num_inference_steps"] = 50
    if args.mixed_precision is not None:
        config["mixed_precision"] = args.mixed_precision


class SamplingPipeline:
    """Model, sampler and per-batch dispatch for `sample.py`."""

    def __init__(self, args, config, checkpoint, device: torch.device):
        self.args = args
        self.config = config
        self.device = device
        dtype_key = str(config.get("diffusion_type", "ddpm")).lower()
        self.is_flow = dtype_key in ("flow", "flow_matching",
                                     "rectified_flow")
        self.is_edm = dtype_key == "edm"
        apply_steps_and_precision(args, config, self.is_flow, self.is_edm)
        if args.guidance_rescale is not None:
            config["guidance_rescale"] = args.guidance_rescale
        if args.cfg_interval is not None:
            lo, hi = (int(v) for v in args.cfg_interval.split(","))
            config["cfg_interval"] = (lo, hi)
        config["image_size"] = resolve_image_size(config["image_size"])
        print("Creating model...")
        self.model = load_model_for_inference(checkpoint, config, args.use_ema,
                                              device)
        print(f"Using sampling method: {args.sampling_method.upper()}")
        self.diffusion = get_diffusion(config, args.sampling_method)
        self.conditional = bool(config.get("conditional", False))
        h, w = config["image_size"]
        self.channels = config["model_params"]["in_channels"]
        self.hw = (h, w)

    def run_batch(self, i: int, num_batches: int, batch: int, labels,
                  generator: torch.Generator,
                  return_all: bool = False) -> torch.Tensor:
        """Generate `batch` images with labels `labels` (None for an
        unconditional model): (B, H, W, C) in [-1, 1], or with `return_all`
        every step's state, (S, B, H, W, C)."""
        args = self.args
        shape = (batch, *self.hw, self.channels)
        y = (torch.as_tensor(labels, device=self.device)
             if labels is not None else None)
        if args.cfg_scale > 0 and self.conditional:
            print(f"Sampling batch {i + 1}/{num_batches} with CFG scale "
                  f"{args.cfg_scale}...")
            return self.diffusion.sample_with_cfg(
                self.model, shape, y, generator, cfg_scale=args.cfg_scale,
                return_all_timesteps=return_all, progress=True)
        print(f"Sampling batch {i + 1}/{num_batches}...")
        return self.diffusion.sample(self.model, shape, generator, y=y,
                                     return_all_timesteps=return_all,
                                     progress=True)
