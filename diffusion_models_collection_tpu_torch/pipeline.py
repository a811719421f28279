"""Sampling pipeline behind `sample.py`.

Counterpart of `diffusion_models_collection_tpu/pipeline.py` for the
branches this port serves: DDIM or DDPM, each with classifier-free guidance
(conditional checkpoints with --cfg_scale > 0; --guidance_rescale and
--cfg_interval override the config's keys) or plain; --mixed_precision
overrides the config's compute dtype. The JAX pipeline's other
knobs (ToMe, FreeU, int8, PAG, DeepCache, classifier guidance,
super-resolution, img2img, restarts, latent decode) are ROADMAP queue 1
items 10 and 11; configs that ask for them raise in the factory.
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


class SamplingPipeline:
    """Model, sampler and per-batch dispatch for `sample.py`."""

    def __init__(self, args, config, checkpoint, device: torch.device):
        self.args = args
        self.config = config
        self.device = device
        if args.sampling_method.lower() == "ddim":
            # the sample CLI's DDIM default of 50 steps overrides the
            # checkpoint's embedded count unless the flag is given
            config["num_inference_steps"] = (
                args.num_inference_steps
                if args.num_inference_steps is not None else 50)
        if args.guidance_rescale is not None:
            config["guidance_rescale"] = args.guidance_rescale
        if args.cfg_interval is not None:
            lo, hi = (int(v) for v in args.cfg_interval.split(","))
            config["cfg_interval"] = (lo, hi)
        if args.mixed_precision is not None:
            config["mixed_precision"] = args.mixed_precision
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
                  generator: torch.Generator) -> torch.Tensor:
        """Generate `batch` images with labels `labels` (None for an
        unconditional model): (B, H, W, C) in [-1, 1]."""
        args = self.args
        shape = (batch, *self.hw, self.channels)
        y = (torch.as_tensor(labels, device=self.device)
             if labels is not None else None)
        if args.cfg_scale > 0 and self.conditional:
            print(f"Sampling batch {i + 1}/{num_batches} with CFG scale "
                  f"{args.cfg_scale}...")
            return self.diffusion.sample_with_cfg(
                self.model, shape, y, generator, cfg_scale=args.cfg_scale,
                progress=True)
        print(f"Sampling batch {i + 1}/{num_batches}...")
        return self.diffusion.sample(self.model, shape, generator, y=y,
                                     progress=True)
