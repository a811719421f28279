"""Sampling entry point of the PyTorch port.

    python -m diffusion_models_collection_tpu_torch.sample \\
        --checkpoint best_model.pth --sampling_method ddim \\
        --num_inference_steps 50 --cfg_scale 3 --num_samples 80

Counterpart of the repository's `sample.py` with the flags this port serves:
DDPM's ancestral sampling over all T steps (the default, which ignores
`--num_inference_steps`), DDIM, DPM-Solver++ (`dpm++`, its SDE form
`dpm++sde`) or UniPC (`unipc`), on the config's uniform or Karras grid
(`timestep_spacing`); a flow-matching or EDM checkpoint samples with its own
solver, and a consistency checkpoint (`train` with `diffusion_type:
'consistency'`, `tools/distill.py`) with its multistep sampler at the step
count it embeds unless `--num_inference_steps` is given, whatever
`--sampling_method` says. Each with classifier-free
guidance and its two knobs (`--guidance_rescale`, `--cfg_interval`).
Editing and training-free knobs, as the root CLI's: `--init_image` with
`--strength` (SDEdit on DDPM, DDIM, flow or EDM), `--mask` (inpainting;
white regenerates) and `--repaint_jump`/`--repaint_resample` (RePaint on
DDPM); `--restarts` and `--restart_interval` (restart sampling on DDIM);
`--pag_scale` (perturbed attention guidance, UNet and DiT); `--deepcache`
and `--deepcache_depth` (cached deep features on DDIM, UNet); `--freeu`
(UNet); `--tome_ratio` and `--tome_mlp` (token merging, DiT) and
`--quantize int8` (w8a8 products, DiT), which compose with each other and
with bf16. Classifier guidance: `--classifier_checkpoint` (a checkpoint of
`model_type: 'classifier'` trained on the same schedule) and
`--classifier_scale` shift eps by the classifier's gradient toward the
labels (VP eps checkpoints). Super-resolution: a checkpoint with a
`super_resolution` block needs `--sr_source` (an image or a directory of
them, read at the LR size) and generates their high-resolution versions.
Images and masks are 8-bit PNGs of the model's size, read without Pillow;
other files or sizes need Pillow.
`--save_intermediate` writes every step's state (`intermediate/steps.npy`,
(S, N, H, W, C) in [0, 1], and PNG grids); `--create_gif` writes the
trajectory as a GIF with Pillow and stops with an error where Pillow is
absent.
A latent-diffusion checkpoint (`latent_diffusion: true`) samples the
latents of the VAE its config's `vae_checkpoint` names and decodes them
before clipping and saving (the trajectory too); its img2img encodes
`--init_image` to the posterior mode, and `--mask` raises.
The checkpoint is a PyTorch reference `.pth` or a JAX `.ckpt`, config
embedded. Labels follow the reference: per-row classes shifted by +1, 0 the
CFG null label. Writes an image grid (PNG) and the images as a float32
(N, H, W, C) array in [0, 1] (`.npy` beside the PNG).

Under torchrun, one process a card:

    torchrun --nproc_per_node N \
        -m diffusion_models_collection_tpu_torch.sample --checkpoint ...

every rank joins the group (NCCL on `cuda:LOCAL_RANK`; gloo with `--device
cpu`), seeds its generator alike and runs every trajectory over the whole
batch, each model call on its contiguous rows, gathered in rank order
(`parallel/data_parallel.py`; a call whose rows do not divide by N runs
whole on every rank): the one-process run's trajectory but for the float
rounding of the model on fewer rows (cuDNN and oneDNN pick kernels by the
batch), which a clamped CFG trajectory can grow. Rank 0 alone prints and
writes the PNG, the `.npy`, the intermediates and the GIF.

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

from .parallel.mesh import (Layout, is_main_process, join_world,
                            leave_world, main_process_output)
from .pipeline import SamplingPipeline, build_labels
from .utils.checkpoint import load_checkpoint
from .utils.helpers import (create_gif, format_duration, load_config,
                            make_grid, resolve_device, save_image_grid,
                            set_seed)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Sample from diffusion models (PyTorch port)")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="Path to checkpoint (.pth reference or JAX .ckpt)")
    parser.add_argument("--config", type=str, default=None,
                        help="Path to config file (if not in checkpoint)")
    parser.add_argument("--sampling_method", type=str, default="ddpm",
                        choices=["ddpm", "ddim", "dpm++", "dpm++sde",
                                 "unipc"],
                        help="Sampling method (dpm++ = DPM-Solver++(2M), "
                             "dpm++sde = its stochastic SDE form, unipc = "
                             "UniPC predictor-corrector)")
    parser.add_argument("--num_inference_steps", type=int, default=None,
                        help="Number of inference steps (default: 50 for "
                             "ddim; other methods and flow/edm checkpoints "
                             "default to the config's count)")
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
    parser.add_argument("--init_image", type=str, default=None,
                        help="Image-to-image (SDEdit): start from this image "
                             "instead of pure noise")
    parser.add_argument("--strength", type=float, default=0.8,
                        help="img2img noising strength in [0, 1] (1.0 ~ "
                             "fresh sample, 0.0 returns the input)")
    parser.add_argument("--mask", type=str, default=None,
                        help="Inpainting mask image (white = regenerate, "
                             "black = keep); requires --init_image")
    parser.add_argument("--repaint_jump", type=int, default=0,
                        help="RePaint jump length j (inpainting; requires "
                             "--mask and --sampling_method ddpm)")
    parser.add_argument("--repaint_resample", type=int, default=1,
                        help="RePaint resample count r: denoise j steps, "
                             "renoise j levels, rerun r times; 1 = single "
                             "pass (default)")
    parser.add_argument("--restarts", type=int, default=0,
                        help="Restart sampling: re-inject noise and "
                             "re-integrate the DDIM ODE K times inside "
                             "--restart_interval; 0 = plain sampling")
    parser.add_argument("--restart_interval", type=str, default=None,
                        help="'t_min,t_max' training-timestep interval for "
                             "--restarts (must contain >= 2 inference-grid "
                             "points); default: the bottom 30%% of the "
                             "schedule (1,0.3*num_timesteps)")
    parser.add_argument("--tome_ratio", type=float, default=0.0,
                        help="Token Merging (ToMe, beyond the reference; "
                             "DiT checkpoints only): merge this fraction "
                             "of patch tokens before every block's "
                             "attention — training-free inference "
                             "speedup; 0 = off")
    parser.add_argument("--tome_mlp", action="store_true",
                        help="extend --tome_ratio merging around each "
                             "block's MLP too (faster, coarser)")
    parser.add_argument("--quantize", type=str, default=None,
                        choices=["int8"],
                        help="w8a8 int8 inference (beyond the reference; "
                             "DiT checkpoints only): contract the block "
                             "matmuls through the int8 path — per-token "
                             "dynamic activation scales, per-channel "
                             "weight scales quantized once")
    parser.add_argument("--classifier_checkpoint", type=str, default=None,
                        help="Noise-conditional classifier checkpoint "
                             "(model_type 'classifier') for classifier "
                             "guidance: shifts eps by the classifier score "
                             "toward the target labels")
    parser.add_argument("--classifier_scale", type=float, default=1.0,
                        help="Classifier-guidance strength s (gradient "
                             "scale); used with --classifier_checkpoint")
    parser.add_argument("--pag_scale", type=float, default=0.0,
                        help="Perturbed Attention Guidance strength (UNet and "
                             "DiT): the same checkpoint with identity "
                             "attention maps, extrapolated away from; stacks "
                             "with CFG; 0 = off")
    parser.add_argument("--deepcache", type=int, default=0,
                        metavar="INTERVAL",
                        help="DeepCache (UNet + DDIM): the full network every "
                             "INTERVAL steps, only the outermost levels in "
                             "between on cached deep features; 0 = off, 1 = "
                             "exact plain DDIM")
    parser.add_argument("--deepcache_depth", type=int, default=1,
                        help="Outer UNet levels that stay live on cached "
                             "steps (must be < len(channel_mult))")
    parser.add_argument("--freeu", type=str, default=None,
                        metavar="B1,B2,S1,S2",
                        help="FreeU factors (UNet): scale the backbone's "
                             "first half-channels (b1, b2) and Fourier-low-"
                             "pass the skip features (s1, s2) at the two "
                             "deepest up levels (e.g. 1.2,1.1,0.9,0.95)")
    parser.add_argument("--sr_source", type=str, default=None,
                        help="Super-resolution conditioning source (image "
                             "file or directory): required for checkpoints "
                             "trained with a super_resolution config block; "
                             "inputs are read at the LR grid and the model "
                             "generates their high-resolution versions")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default), cuda:N or cpu")
    parser.add_argument("--save_intermediate", action="store_true",
                        help="Save intermediate denoising steps")
    parser.add_argument("--create_gif", action="store_true",
                        help="Create GIF of the denoising process (needs "
                             "Pillow)")
    parser.add_argument("--gif_fps", type=int, default=20,
                        help="FPS for the GIF")
    parser.add_argument("--gif_final_seconds", type=float, default=2.0,
                        help="Seconds to hold the final frame in the GIF")
    return parser


def save_trajectory(args, inter: np.ndarray, output_dir: Path,
                    nrow: int) -> None:
    """Write the (S, N, H, W, C) trajectory in [0, 1]: with
    --save_intermediate `intermediate/steps.npy` and a PNG grid of every
    step (every S // 50-th beyond 100 steps, and the last); with
    --create_gif the GIF beside the samples."""
    steps = inter.shape[0]
    if args.create_gif:
        gif_path = output_dir / Path(args.output_name).with_suffix(".gif")
        print(f"Creating GIF at {gif_path}...")
        frames = [make_grid(inter[t], nrow=nrow, padding=2)
                  for t in range(steps)]
        if args.gif_final_seconds and args.gif_final_seconds > 0:
            frames += [frames[-1]] * max(
                1, int(args.gif_fps * float(args.gif_final_seconds)))
        create_gif(frames, gif_path, fps=args.gif_fps)
    if args.save_intermediate:
        intermediate_dir = output_dir / "intermediate"
        intermediate_dir.mkdir(exist_ok=True)
        print(f"Saving intermediate frames to {intermediate_dir}...")
        np.save(intermediate_dir / "steps.npy", inter)
        interval = 1 if steps <= 100 else steps // 50
        for t in sorted(set(range(0, steps, interval)) | {steps - 1}):
            save_image_grid(inter[t], intermediate_dir / f"step_{t:04d}.png",
                            nrow=nrow)


def require_pillow() -> None:
    """--create_gif writes with Pillow: stop before sampling where it is
    absent."""
    try:
        import PIL  # noqa: F401
    except ImportError:
        raise SystemExit("--create_gif needs Pillow, which is not installed; "
                         "use --save_intermediate for the frames as .npy "
                         "and PNG") from None


def main(argv=None) -> dict:
    """Run the CLI; returns {"samples": (N, H, W, C) float32 in [0, 1],
    "sampling_seconds": seconds spent generating, device work included}."""
    args = build_parser().parse_args(argv)
    device, layout = join_world(resolve_device(args.device, "sample"))
    with main_process_output():
        return run(args, device, layout)


def run(args, device: torch.device, layout: Layout) -> dict:
    """`main` after the world is joined; every rank samples, rank 0
    writes."""
    generator = set_seed(args.seed, device)

    print(f"Loading checkpoint from {args.checkpoint}...")
    config = load_config(Path(args.config)) if args.config else None
    checkpoint = load_checkpoint(args.checkpoint, config)
    config = config if config is not None else checkpoint["config"]

    if args.create_gif:
        require_pillow()
    pipe = SamplingPipeline(args, config, checkpoint, device, layout)

    nrow = max(1, int(math.sqrt(args.num_samples)))
    num_rows = math.ceil(args.num_samples / nrow)
    labels = build_labels(args, config, nrow, num_rows)

    print(f"Generating {args.num_samples} samples...")
    output_dir = Path(args.output_dir)
    writes = is_main_process()
    if writes:
        output_dir.mkdir(parents=True, exist_ok=True)
    pipe.setup_conditioning(labels, nrow, num_rows)

    return_all = args.save_intermediate or args.create_gif
    num_batches = math.ceil(args.num_samples / args.batch_size)
    start_time = time.perf_counter()
    batches = []
    for i in range(num_batches):
        start = i * args.batch_size
        end = min(start + args.batch_size, args.num_samples)
        batches.append(pipe.run_batch(i, num_batches, start, end, labels,
                                      generator, return_all))
    # waits for the device
    trajectory = torch.cat(batches, dim=1 if return_all else 0).cpu().numpy()
    seconds = time.perf_counter() - start_time
    samples = trajectory[-1] if return_all else trajectory
    print(f"Sampled {args.num_samples} images in {format_duration(seconds)} "
          f"({args.num_samples / seconds:.2f} samples/s) on {device}"
          + (f" and {layout.dp - 1} more processes" if layout.dp > 1
             else ""))

    samples = np.clip((samples + 1) / 2, 0, 1).astype(np.float32)
    if not writes:
        return {"samples": samples, "sampling_seconds": seconds}
    output_path = output_dir / args.output_name
    print(f"Saving samples to {output_path}...")
    save_image_grid(samples, output_path, nrow=nrow)
    np.save(output_path.with_suffix(".npy"), samples)
    if return_all:
        print("Processing intermediate steps...")
        save_trajectory(args, np.clip((trajectory + 1) / 2, 0, 1).astype(
            np.float32), output_dir, nrow)
    print("Done!")
    return {"samples": samples, "sampling_seconds": seconds}


if __name__ == "__main__":
    main()
    leave_world()
