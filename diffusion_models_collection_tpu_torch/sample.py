"""Sampling entry point of the PyTorch port.

    python -m diffusion_models_collection_tpu_torch.sample \\
        --checkpoint best_model.pth --sampling_method ddim \\
        --num_inference_steps 50 --cfg_scale 3 --num_samples 80

Counterpart of the repository's `sample.py` with the flags this port serves:
DDPM's ancestral sampling over all T steps (the default, which ignores
`--num_inference_steps`) or DDIM (`--sampling_method ddim`), each with
classifier-free guidance and its two knobs (`--guidance_rescale`,
`--cfg_interval`).
The checkpoint is a PyTorch reference `.pth` or a JAX `.ckpt`, config
embedded. Labels follow the reference: per-row classes shifted by +1, 0 the
CFG null label. Writes an image grid (PNG) and the images as a float32
(N, H, W, C) array in [0, 1] (`.npy` beside the PNG).

`--device` defaults to `cuda` and fails when CUDA is absent; the CPU runs
only when asked for with `--device cpu`. The model computes in the
checkpoint config's `mixed_precision` (float32, or 'bf16': bfloat16 convs,
linears and activations on float32 weights), which `--mixed_precision`
overrides; on CUDA, TF32 is switched off for matrix products and
convolutions.
"""

from __future__ import annotations

import argparse
import math
import time
from pathlib import Path

import numpy as np
import torch

from .pipeline import SamplingPipeline, build_labels
from .utils.checkpoint import load_checkpoint
from .utils.helpers import (format_duration, load_config, resolve_device,
                            save_image_grid, set_seed)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Sample from diffusion models (PyTorch port)")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="Path to checkpoint (.pth reference or JAX .ckpt)")
    parser.add_argument("--config", type=str, default=None,
                        help="Path to config file (if not in checkpoint)")
    parser.add_argument("--sampling_method", type=str, default="ddpm",
                        choices=["ddpm", "ddim"], help="Sampling method")
    parser.add_argument("--num_inference_steps", type=int, default=None,
                        help="Number of inference steps (default: 50)")
    parser.add_argument("--num_samples", type=int, default=64,
                        help="Number of samples to generate")
    parser.add_argument("--batch_size", type=int, default=16,
                        help="Batch size for sampling")
    parser.add_argument("--output_dir", type=str, default="./samples",
                        help="Output directory")
    parser.add_argument("--output_name", type=str, default="samples.png",
                        help="Output filename")
    parser.add_argument("--use_ema", action="store_true",
                        help="Use EMA model if available")
    parser.add_argument("--cfg_scale", type=float, default=0.0,
                        help="Classifier-free guidance scale (0 = no CFG)")
    parser.add_argument("--guidance_rescale", type=float, default=None,
                        help="CFG contrast rescale phi in [0, 1] (overrides "
                             "the config's guidance_rescale key; 0 disables)")
    parser.add_argument("--cfg_interval", type=str, default=None,
                        help="Apply CFG only inside this 'lo,hi' timestep "
                             "interval; overrides the config key")
    parser.add_argument("--mixed_precision", type=str, default=None,
                        choices=["bf16", "none"],
                        help="Override the checkpoint config's compute "
                             "dtype (e.g. bf16 inference on an fp32 "
                             "checkpoint)")
    parser.add_argument("--labels", type=str, default=None,
                        help="Comma-separated labels for conditional "
                             "generation")
    parser.add_argument("--seed", type=int, default=42, help="Random seed")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default), cuda:N or cpu")
    return parser


def main(argv=None) -> dict:
    """Run the CLI; returns {"samples": (N, H, W, C) float32 in [0, 1],
    "sampling_seconds": seconds spent generating, device work included}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device, "sample")
    generator = set_seed(args.seed, device)

    print(f"Loading checkpoint from {args.checkpoint}...")
    config = load_config(Path(args.config)) if args.config else None
    checkpoint = load_checkpoint(args.checkpoint, config)
    config = config if config is not None else checkpoint["config"]

    pipe = SamplingPipeline(args, config, checkpoint, device)

    nrow = max(1, int(math.sqrt(args.num_samples)))
    num_rows = math.ceil(args.num_samples / nrow)
    labels = build_labels(args, config, nrow, num_rows)

    print(f"Generating {args.num_samples} samples...")
    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    num_batches = math.ceil(args.num_samples / args.batch_size)
    start_time = time.perf_counter()
    batches = []
    for i in range(num_batches):
        start = i * args.batch_size
        end = min(start + args.batch_size, args.num_samples)
        batch_labels = labels[start:end] if labels is not None else None
        batches.append(pipe.run_batch(i, num_batches, end - start,
                                      batch_labels, generator))
    samples = torch.cat(batches).cpu().numpy()  # waits for the device
    seconds = time.perf_counter() - start_time
    print(f"Sampled {args.num_samples} images in {format_duration(seconds)} "
          f"({args.num_samples / seconds:.2f} samples/s) on {device}")

    samples = np.clip((samples + 1) / 2, 0, 1).astype(np.float32)
    output_path = output_dir / args.output_name
    print(f"Saving samples to {output_path}...")
    save_image_grid(samples, output_path, nrow=nrow)
    np.save(output_path.with_suffix(".npy"), samples)
    print("Done!")
    return {"samples": samples, "sampling_seconds": seconds}


if __name__ == "__main__":
    main()
