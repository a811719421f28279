"""Evaluation entry point of the PyTorch port.

    python -m diffusion_models_collection_tpu_torch.evaluate \\
        --checkpoint best_model.pth --use_ema --sampling_method ddim \\
        --num_inference_steps 50 --cfg_scale 3 --num_samples 5000

Counterpart of the repository's `evaluate.py`, with its flags, defaults,
rules and messages (but `--device`, which defaults to `cuda`): generate
`--num_samples` images from a checkpoint (DDPM over all T steps by default,
the reference's protocol; `--sampling_method` ddim, dpm++, dpm++sde or
unipc with `--num_inference_steps`), with classifier-free guidance, PAG,
DeepCache and FreeU as `sample` has them; load as many real images from the
checkpoint config's dataset (its test split, shuffled with `--seed`, no
flip); conditional checkpoints generate with the real labels shifted by +1
(0 is the null label), cycled where the eval set is smaller; a
super-resolution checkpoint generates each batch conditioned on the real
images area-downsampled by its factor (cycled likewise; `--deepcache` is
refused for it), so the metrics measure upsampling fidelity; save both sets
as PNGs and 64-image grids under `--save_images_dir` (`real/`,
`generate/`); compute FID, improved precision/recall (or the marker that
skips it below 1000 images), KID, Inception Score and LPIPS diversity with
the port's metric networks on the model's device in float32 (whatever
`--mixed_precision` says), and multi-scale SWD by default when any of them
ran on random weights (`--swd`/`--no_swd` decide otherwise); write the
metrics JSON to `--output`, the relative-only metrics listed under
`uncalibrated_relative_only`.

`--device` defaults to `cuda` and fails when CUDA is absent; the CPU runs
only when asked for with `--device cpu`. Under torchrun (`torchrun
--nproc_per_node N -m diffusion_models_collection_tpu_torch.evaluate ...`)
every rank joins the group (NCCL on `cuda:LOCAL_RANK`; gloo with `--device
cpu`), loads the same real images and generates every batch as `sample`
does, each model call on its rows and gathered
(`parallel/data_parallel.py`), the one-process run's but for the float
rounding of the model on fewer rows; the metric networks split each batch likewise (InceptionV3's
features and logits, LPIPS's distances), and every rank forms FID, KID, IS,
precision/recall and SWD from the gathered features and images, as the
JAX package's data-parallel generation and feature extraction over a
device mesh. Rank 0 alone prints and writes the JSON and the image
folders. A
latent-diffusion checkpoint generates the latents of the VAE its config names
and decodes them before the metric networks see them. `--tome_ratio`
(with `--tome_mlp`) and `--quantize int8` generate through the DiT's token
merging and int8 products, to measure their quality cost. A consistency
checkpoint generates with its own multistep sampler at its embedded step
count (or `--num_inference_steps`), whatever `--sampling_method` says.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .datasets import DataLoader
from .diffusion.deepcache import deepcache_sample
from .factory import get_dataset, get_diffusion, load_model_for_inference
from .metrics import calculate_all_metrics, compute_swd
from .parallel.mesh import (Layout, is_main_process, join_world,
                            leave_world, main_process_output)
from .pipeline import (build_deepcache, process_flags, split_model_calls,
                       wrap_pag)
from .utils.checkpoint import load_checkpoint
from .utils.helpers import (format_duration, load_config, resolve_device,
                            resolve_image_size, save_image, save_image_grid,
                            set_seed)
from .utils import sr as sr_lib
from .utils.latent import LatentCodec


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Evaluate diffusion models (PyTorch port)")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="Path to checkpoint")
    parser.add_argument("--config", type=str, default=None,
                        help="Path to config file")
    parser.add_argument("--num_samples", type=int, default=5000,
                        help="Number of samples to generate")
    parser.add_argument("--batch_size", type=int, default=32, help="Batch size")
    parser.add_argument("--use_ema", action="store_true", help="Use EMA model")
    parser.add_argument("--output", type=str, default="./metrics_results.json",
                        help="Output file for metrics")
    parser.add_argument("--save_images_dir", type=str, default="./eval",
                        help="Directory to save PNG images (real/generate "
                             "subfolders)")
    parser.add_argument("--seed", type=int, default=42, help="Random seed")
    parser.add_argument("--mixed_precision", type=str, default=None,
                        choices=["bf16", "none"],
                        help="Override the checkpoint config's compute dtype")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default), cuda:N or cpu")
    parser.add_argument("--sampling_method", type=str, default="ddpm",
                        choices=["ddpm", "ddim", "dpm++", "dpm++sde",
                                 "unipc"],
                        help="The reference always evaluates with DDPM "
                             "full-step sampling (the default, kept for "
                             "metric parity); ddim/dpm++/dpm++sde/unipc "
                             "trade exact protocol parity for 20-60x faster "
                             "generation")
    parser.add_argument("--num_inference_steps", type=int, default=None,
                        help="Steps for ddim/dpm++ eval sampling "
                             "(default: config value)")
    parser.add_argument("--cfg_scale", type=float, default=0.0,
                        help="CFG guidance scale (0 = no CFG)")
    parser.add_argument("--guidance_rescale", type=float, default=None,
                        help="CFG contrast rescale phi in [0, 1] (overrides "
                             "the config key)")
    parser.add_argument("--cfg_interval", type=str, default=None,
                        help="Guide only inside this 'lo,hi' timestep "
                             "interval; overrides the config key")
    parser.add_argument("--tome_ratio", type=float, default=0.0,
                        help="Token Merging (DiT only): merge this "
                             "fraction of patch tokens per block during "
                             "generation — measures ToMe's quality cost")
    parser.add_argument("--tome_mlp", action="store_true",
                        help="extend --tome_ratio merging to block MLPs")
    parser.add_argument("--quantize", type=str, default=None,
                        choices=["int8"],
                        help="w8a8 int8 inference (DiT only) — measures "
                             "the quantization quality cost")
    parser.add_argument("--pag_scale", type=float, default=0.0,
                        help="Perturbed Attention Guidance strength (UNet/"
                             "DiT, eps-VP checkpoints) during generation; "
                             "0 = off")
    parser.add_argument("--freeu", type=str, default=None,
                        metavar="B1,B2,S1,S2",
                        help="FreeU factors (UNet only) during generation")
    parser.add_argument("--deepcache", type=int, default=0,
                        metavar="INTERVAL",
                        help="DeepCache interval (UNet + --sampling_method "
                             "ddim only) during generation; 0 = off")
    parser.add_argument("--deepcache_depth", type=int, default=1,
                        help="Live outer UNet levels on cached steps "
                             "(as sample --deepcache_depth)")
    parser.add_argument("--swd", dest="swd", action="store_true",
                        default=None,
                        help="also compute multi-scale Sliced Wasserstein "
                             "Distance on Laplacian-pyramid patches. Needs "
                             "no pretrained weights. Default: on whenever "
                             "inception/lpips weights are absent; --no_swd "
                             "disables")
    parser.add_argument("--no_swd", dest="swd", action="store_false",
                        help="disable SWD even when pretrained metric "
                             "weights are unavailable")
    parser.add_argument("--inception_weights", type=str, default=None,
                        help="torchvision inception_v3 .pth (or converted "
                             ".npz) to calibrate FID/IS; defaults to env "
                             "DMC_TPU_INCEPTION_WEIGHTS")
    parser.add_argument("--lpips_weights", type=str, default=None,
                        help="lpips-package AlexNet state (or converted "
                             ".npz) to calibrate LPIPS; defaults to env "
                             "DMC_TPU_LPIPS_WEIGHTS")
    return parser


def apply_overrides(args, config: dict) -> None:
    """--mixed_precision, --tome_ratio, --freeu, --quantize,
    --guidance_rescale and --cfg_interval into `config`, with the root
    CLI's rules and messages (ToMe and int8 become the DiT's `tome_ratio`,
    `tome_mlp` and `quant` fields)."""
    model_type = str(config.get("model_type", "")).lower()
    if args.mixed_precision is not None:
        config["mixed_precision"] = args.mixed_precision
    if args.tome_ratio > 0:
        if model_type != "dit":
            raise SystemExit("--tome_ratio applies to DiT checkpoints")
        mp = dict(config.get("model_params", {}), tome_ratio=args.tome_ratio)
        if args.tome_mlp:
            mp["tome_mlp"] = True
        config["model_params"] = mp
    if args.freeu is not None:
        if model_type != "unet":
            raise SystemExit("--freeu applies to UNet checkpoints")
        try:
            factors = tuple(float(v) for v in args.freeu.split(","))
        except ValueError:
            factors = ()
        if len(factors) != 4:
            raise SystemExit("--freeu expects four floats: b1,b2,s1,s2")
        config["model_params"] = dict(config.get("model_params", {}),
                                      freeu=factors)
    if args.quantize:
        if model_type != "dit":
            raise SystemExit("--quantize applies to DiT checkpoints")
        config["model_params"] = dict(config.get("model_params", {}),
                                      quant=args.quantize)
    if args.guidance_rescale is not None:
        config["guidance_rescale"] = args.guidance_rescale
    if args.cfg_interval is not None:
        lo, hi = (int(v) for v in args.cfg_interval.split(","))
        config["cfg_interval"] = (lo, hi)
    config["image_size"] = resolve_image_size(config["image_size"])


def load_real_images(args, config):
    """Up to --num_samples images of the config's dataset (its test split,
    shuffled with --seed, no flip) in [0, 1], and their labels or None."""
    dataset = get_dataset(config, train=False)
    loader = DataLoader(dataset, batch_size=args.batch_size, shuffle=True,
                        drop_last=False, seed=args.seed, random_flip=False)
    real_images, real_labels = [], []
    for images, labels in loader:
        real_images.append((images + 1) / 2)  # [-1,1] -> [0,1]
        if labels is not None:
            real_labels.append(labels)
        if sum(len(x) for x in real_images) >= args.num_samples:
            break
    real_images = np.concatenate(real_images, axis=0)[: args.num_samples]
    real_labels = (np.concatenate(real_labels, axis=0)[: args.num_samples]
                   if real_labels else None)
    return real_images, real_labels


def generation_labels(args, config, real_labels):
    """The real labels shifted by +1 (0 is the null label) and cycled up to
    --num_samples, or None for an unconditional checkpoint."""
    if not config.get("conditional", False):
        return None
    if real_labels is None or config.get("num_classes") is None:
        raise ValueError(
            "Conditional evaluation requires labels from the real dataset "
            "and known num_classes.")
    labels_all = real_labels.astype(np.int64) + 1
    if len(labels_all) < args.num_samples:
        # eval set smaller than --num_samples (e.g. the 50-image fixture
        # test split): keep the real class distribution
        reps = -(-args.num_samples // len(labels_all))
        labels_all = np.tile(labels_all, reps)[: args.num_samples]
    return labels_all


def save_images(save_root: Path, real_images, fake_images) -> None:
    """Every image as a PNG under real/ and generate/, and 64-image grids of
    each set beside them."""
    real_dir = save_root / "real"
    gen_dir = save_root / "generate"
    real_dir.mkdir(parents=True, exist_ok=True)
    gen_dir.mkdir(parents=True, exist_ok=True)
    num_digits = len(str(max(len(real_images), len(fake_images), 1)))
    for idx, img in enumerate(real_images):
        save_image(img, real_dir / f"real_{idx + 1:0{num_digits}d}.png")
    for idx, img in enumerate(fake_images):
        save_image(img, gen_dir / f"generate_{idx + 1:0{num_digits}d}.png")

    grid_size = 64
    for imgs, prefix in ((real_images, "real"), (fake_images, "generate")):
        total = len(imgs)
        num_digits_grid = len(str((total + grid_size - 1) // grid_size))
        for i in range(0, total, grid_size):
            chunk = imgs[i : i + grid_size]
            nrow = min(8, max(1, int(len(chunk) ** 0.5)))
            grid_idx = i // grid_size + 1
            save_image_grid(
                chunk,
                save_root / f"{prefix}_grid_{grid_idx:0{num_digits_grid}d}.png",
                nrow=nrow)
    print(f"Saved real images to {real_dir} and generated images to {gen_dir}")


def main(argv=None, seconds: Optional[Dict[str, float]] = None) -> dict:
    """Run the CLI; returns the metrics report written to --output.
    `seconds`, when given, receives the wall time of each stage: generation
    (device work included), the stages of `calculate_all_metrics`, and
    SWD."""
    args = build_parser().parse_args(argv)
    seconds = {} if seconds is None else seconds
    device, layout = join_world(resolve_device(args.device, "evaluate"))
    with main_process_output():
        return run(args, device, layout, seconds)


def run(args, device: torch.device, layout: Layout,
        seconds: Dict[str, float]) -> dict:
    """`main` after the world is joined; every rank generates and computes
    the metrics, rank 0 writes."""
    generator = set_seed(args.seed, device)

    print(f"Loading checkpoint from {args.checkpoint}...")
    config = load_config(Path(args.config)) if args.config else None
    checkpoint = load_checkpoint(args.checkpoint, config)
    config = dict(config if config is not None else checkpoint["config"])
    apply_overrides(args, config)

    if str(config.get("model_type", "")).lower() == "classifier":
        raise SystemExit(
            "this is a noise-conditional CLASSIFIER checkpoint — it has "
            "no sampler to evaluate (it guides sample.py via "
            "--classifier_checkpoint)"
        )

    print("Creating model...")
    model = load_model_for_inference(checkpoint, config, args.use_ema, device)
    apply = split_model_calls(model, layout)
    flags = process_flags(config)
    model_fn = wrap_pag(args, config, apply, flags)
    dc_full_fn, dc_shallow_fn = build_deepcache(
        args, config, apply, flags, base_wrapped=model_fn is not apply)
    if args.num_inference_steps is not None:
        if args.sampling_method == "ddpm" and not any(flags):
            raise SystemExit(
                "--num_inference_steps has no effect with the default DDPM "
                "eval protocol (always full-step) — pass --sampling_method "
                "ddim or dpm++ to use it"
            )
        config["num_inference_steps"] = args.num_inference_steps
    diffusion = get_diffusion(config, sampling_method=args.sampling_method)
    if args.sampling_method != "ddpm":
        print(f"NOTE: evaluating with {args.sampling_method} sampling — "
              "faster than the reference's DDPM-1000 protocol; metrics are "
              "not directly comparable to its published tables")

    print("Loading real images...")
    real_images, real_labels = load_real_images(args, config)
    print(f"Loaded {len(real_images)} real images")
    labels_all = generation_labels(args, config, real_labels)
    sr_spec = sr_lib.SRSpec.from_config(config)
    if sr_spec is not None:
        if args.deepcache > 0:
            raise SystemExit(
                "--deepcache does not compose with super-resolution "
                "checkpoints (the cached views bypass the SR conditioning "
                "wrapper)")
        print(f"Super-resolution checkpoint: conditioning on real images "
              f"downsampled by {sr_spec.factor}x")

    print(f"Generating {args.num_samples} fake images...")
    codec = LatentCodec.from_config(config, device=device)
    if codec is not None:
        shape = codec.latent_shape(args.batch_size)
        print(f"Latent diffusion: sampling {shape[1]}x{shape[2]}x{shape[3]} "
              "latents, decoding through the VAE")
    else:
        h, w = config["image_size"]
        shape = (args.batch_size, h, w,
                 config["model_params"]["in_channels"])
    num_batches = (args.num_samples + args.batch_size - 1) // args.batch_size
    use_cfg = args.cfg_scale > 0 and config.get("conditional", False)
    start_time = time.perf_counter()
    batches = []
    for i in range(num_batches):
        start = i * args.batch_size
        end = min(start + args.batch_size, args.num_samples)
        y = None
        if labels_all is not None:
            batch_labels = labels_all[start:end]
            if len(batch_labels) < args.batch_size:
                batch_labels = np.pad(
                    batch_labels, (0, args.batch_size - len(batch_labels)),
                    mode="edge")
            y = torch.as_tensor(batch_labels, device=device)
        batch_fn = model_fn
        if sr_spec is not None:
            # the eval set may hold fewer images than --num_samples
            cond = sr_lib.batch_condition(
                sr_spec, config["image_size"], real_images * 2.0 - 1.0,
                start, end, args.batch_size, generator, source_is_hr=True,
                cycle=True, device=device)
            batch_fn = sr_lib.wrap_model_fn(model_fn, cond)
        print(f"Generating batch {i + 1}/{num_batches}...")
        if args.deepcache > 0:
            samples = deepcache_sample(
                diffusion, dc_full_fn, dc_shallow_fn, shape, generator, y=y,
                cfg_scale=args.cfg_scale if use_cfg else None,
                interval=args.deepcache)
        elif use_cfg:
            samples = diffusion.sample_with_cfg(
                batch_fn, shape, y, generator, cfg_scale=args.cfg_scale,
                progress=True)
        else:
            samples = diffusion.sample(batch_fn, shape, generator, y=y,
                                       progress=True)
        if codec is not None:
            samples = codec.decode(samples)
        batches.append(samples[: end - start])
    # waits for the device
    fake_images = torch.cat(batches).float().cpu().numpy()
    seconds["generation"] = time.perf_counter() - start_time
    fake_images = np.clip((fake_images + 1) / 2, 0, 1)
    real_images = np.clip(real_images, 0, 1)
    print(f"Generated {len(fake_images)} fake images in "
          f"{format_duration(seconds['generation'])} on {device}")

    if args.save_images_dir and is_main_process():
        save_images(Path(args.save_images_dir), real_images, fake_images)

    print("\n" + "=" * 50)
    print("Computing metrics...")
    print("=" * 50)
    metrics = calculate_all_metrics(
        real_images, fake_images,
        weights_path=args.inception_weights,
        lpips_weights_path=args.lpips_weights,
        device=device, seconds=seconds,
    )
    uncalibrated = metrics.pop("_uncalibrated", [])
    # SWD defaults on whenever a learned-feature metric ran uncalibrated, so
    # a run without pretrained weights still reports a calibrated number
    want_swd = args.swd if args.swd is not None else bool(uncalibrated)
    if want_swd:
        print("\n=== Computing SWD (x1e3, lower is better) ===")
        start_time = time.perf_counter()
        metrics.update(compute_swd(real_images, fake_images, device=device))
        seconds["SWD"] = time.perf_counter() - start_time

    print("\n" + "=" * 50)
    print("Results:")
    print("=" * 50)
    for key, value in metrics.items():
        print(f"{key}: {value}")
    if uncalibrated:
        print(
            "NOTE: no pretrained feature weights — "
            + ", ".join(sorted(set(k.split("_")[0] for k in uncalibrated)))
            + " are RELATIVE-only statistics (random features); "
            + ("swd_* are the calibrated values." if want_swd
               else "pass --swd for a calibrated metric.")
        )
    print("Stage seconds: " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in seconds.items()))

    report = {k: float(v) for k, v in metrics.items()}
    if uncalibrated:
        report["uncalibrated_relative_only"] = uncalibrated
    if is_main_process():
        with Path(args.output).open("w", encoding="utf-8") as f:
            json.dump(report, f, indent=4)
        print(f"\nResults saved to {args.output}")
    return report


if __name__ == "__main__":
    start = time.time()
    main()
    if is_main_process():
        print(f"Total evaluation time: "
              f"{format_duration(time.time() - start)}")
    leave_world()
