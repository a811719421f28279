"""Calibrate `latent_scale_factor` for a latent-diffusion config: LDM's
sigma normalisation rescales latents towards unit variance before
diffusing, so that the noise schedule's SNR means what it means in pixel
space.

    python -m diffusion_models_collection_tpu_torch.tools.compute_latent_scale \\
        --config <latent config .py/.yaml/.json> [--batches 8] [--device cpu]

The port's counterpart of the repository's `tools/compute_latent_scale.py`:
the per-element mean and std of the posterior-MODE latents (unscaled) of
the config's `vae_checkpoint` over the first `--batches` batches of the
config's training data (shuffled from its seed), accumulated in float64 on
the host; prints one JSON object whose `latent_scale_factor` (1 / std) goes
into the diffusion config. `--device` defaults to `cuda` and fails when CUDA
is absent. One process, as the JAX tool: under torchrun (`WORLD_SIZE` > 1)
it raises.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..factory import get_dataloader, get_dataset
from ..parallel.mesh import refuse_process_world
from ..utils.helpers import load_config, resolve_device, resolve_image_size
from ..utils.latent import LatentCodec


def compute_scale(config: dict, batches: int = 8,
                  device="cpu") -> dict:
    """Mean and std of the unscaled posterior-mode latents over `batches`
    batches, and 1 / std."""
    codec = LatentCodec(config["vae_checkpoint"], scale_factor=1.0,
                        device=device)
    loader = get_dataloader(config, get_dataset(config, train=True),
                            train=True, seed=config.get("seed", 42))
    total = total_sq = 0.0
    count = seen = 0
    for images, _ in loader:
        if seen >= batches:
            break
        z = codec.encode_mode(torch.from_numpy(
            np.asarray(images, np.float32))).cpu().numpy().astype(np.float64)
        total += float(z.sum())
        total_sq += float((z ** 2).sum())
        count += z.size
        seen += 1
    if count == 0:
        raise RuntimeError("dataset yielded no batches")
    mean = total / count
    std = max(total_sq / count - mean ** 2, 1e-12) ** 0.5
    return {"latent_mean": round(mean, 6), "latent_std": round(std, 6),
            "latent_scale_factor": round(1.0 / std, 6), "batches": seen,
            "elements": count}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Compute LDM sigma normalization for a latent config "
                    "(PyTorch port)")
    parser.add_argument("--config", type=str, required=True,
                        help="latent-diffusion config (.py/.yaml/.json) "
                             "with vae_checkpoint + dataset keys")
    parser.add_argument("--batches", type=int, default=8)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default), cuda:N or cpu")
    return parser


def main(argv=None) -> dict:
    """Run the tool; returns the JSON object it prints."""
    args = build_parser().parse_args(argv)
    refuse_process_world(
        "tools.compute_latent_scale", "16", "the JAX package's tool does not "
        "split its batches either")
    device = resolve_device(args.device, "compute the latent scale")
    config = load_config(Path(args.config))
    config["image_size"] = resolve_image_size(config["image_size"])
    result = compute_scale(config, args.batches, device)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
