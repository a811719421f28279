"""Cascaded sampling: a base checkpoint followed by one or more
super-resolution checkpoints (Ho et al. 2021 "Cascaded Diffusion Models";
Saharia et al. 2021 "SR3").

    python -m diffusion_models_collection_tpu_torch.tools.cascade \\
        --base_checkpoint checkpoints/cifar10_unet/best_model.pth \\
        --sr_checkpoint checkpoints/sr64/best_model.pth \\
        [--sr_checkpoint ...]   # chain more stages \\
        --num_samples 16 --cfg_scale 1.8 [--device cpu]

The port's counterpart of the repository's `tools/cascade.py`, with its
flags (and `--device`, which defaults to `cuda` and fails when CUDA is
absent). Stage 0 samples the base resolution from noise; every later stage
is a `super_resolution` checkpoint (`utils/sr.py`) whose LR grid must equal
the previous stage's output size, checked for every stage before any
sampling. Each stage writes its grid (`cascade_stage{k}.png`); the last one
also writes `--output_name`. The base and the SR stages take their own
sampler, step count and CFG scale; the labels (one a sample, shifted by +1)
are shared by every conditional stage. Checkpoints are `.pth` or JAX
`.ckpt`, config embedded; latent-diffusion checkpoints are refused. One
process, as the JAX tool: under torchrun (`WORLD_SIZE` > 1) it raises.
"""

from __future__ import annotations

import argparse
import math
import time
from pathlib import Path

import numpy as np
import torch

from ..factory import get_diffusion, load_model_for_inference
from ..parallel.mesh import refuse_process_world
from ..utils import sr as sr_lib
from ..utils.checkpoint import load_checkpoint
from ..utils.helpers import (format_duration, resolve_device,
                             resolve_image_size, save_image_grid, set_seed)

SAMPLERS = ["ddpm", "ddim", "dpm++", "dpm++sde", "unipc"]


def load_stage(path, use_ema: bool, mixed_precision, num_inference_steps,
               sampling_method: str, device):
    """(config, model, diffusion, SRSpec or None) of one stage."""
    payload = load_checkpoint(path)
    config = dict(payload["config"])
    config["image_size"] = resolve_image_size(config["image_size"])
    if mixed_precision:
        config["mixed_precision"] = mixed_precision
    if num_inference_steps:
        config["num_inference_steps"] = int(num_inference_steps)
    if config.get("latent_diffusion"):
        raise SystemExit(
            "cascade stages must be pixel-space checkpoints (latent "
            "diffusion decodes through its own VAE)")
    model = load_model_for_inference(payload, config, use_ema, device)
    method = sampling_method
    if str(config.get("diffusion_type", "ddpm")).lower() not in (
            "ddpm", "diffusion"):
        method = "ddpm"  # flow and EDM checkpoints own their samplers
    diffusion = get_diffusion(config, method)
    return config, model, diffusion, sr_lib.SRSpec.from_config(config)


def sample_stage(diffusion, make_fn, hw, channels: int, labels, generator,
                 cfg_scale: float, batch_size: int, num_samples: int,
                 desc: str) -> torch.Tensor:
    """`num_samples` images (N, H, W, C) in [-1, 1] on the host, a batch at
    a time; `make_fn(start, end)` gives each batch's model callable (an SR
    stage's conditioned on its LR images)."""
    out = []
    num_batches = math.ceil(num_samples / batch_size)
    for i in range(num_batches):
        start = i * batch_size
        end = min(start + batch_size, num_samples)
        fn = make_fn(start, end)
        y = labels[start:end] if labels is not None else None
        shape = (end - start, *hw, channels)
        print(f"{desc}: batch {i + 1}/{num_batches}")
        with torch.no_grad():
            if cfg_scale and cfg_scale > 0 and y is not None:
                samples = diffusion.sample_with_cfg(
                    fn, shape, y, generator, cfg_scale=cfg_scale)
            else:
                samples = diffusion.sample(fn, shape, generator, y=y)
        out.append(samples.float().cpu())
    return torch.cat(out)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Cascaded sampling: base checkpoint + SR stage(s) "
                    "(PyTorch port)")
    parser.add_argument("--base_checkpoint", type=str, required=True)
    parser.add_argument("--sr_checkpoint", type=str, action="append",
                        required=True,
                        help="super_resolution checkpoint; repeat the flag "
                             "to chain stages (each LR grid must match the "
                             "previous stage's output size)")
    parser.add_argument("--num_samples", type=int, default=16)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--sampling_method", type=str, default="ddim",
                        choices=SAMPLERS,
                        help="sampler for the base stage (flow/edm "
                             "checkpoints keep their own)")
    parser.add_argument("--sr_sampling_method", type=str, default="ddim",
                        choices=SAMPLERS, help="sampler for SR stages")
    parser.add_argument("--num_inference_steps", type=int, default=None,
                        help="base-stage step count (default: config)")
    parser.add_argument("--sr_num_inference_steps", type=int, default=None,
                        help="SR-stage step count (default: config)")
    parser.add_argument("--cfg_scale", type=float, default=0.0,
                        help="base-stage CFG scale (0 = no CFG)")
    parser.add_argument("--sr_cfg_scale", type=float, default=0.0,
                        help="SR-stage CFG scale (SR stages usually want "
                             "little or none)")
    parser.add_argument("--labels", type=str, default=None,
                        help="comma-separated class labels, cycled over "
                             "samples (conditional stages)")
    parser.add_argument("--use_ema", action="store_true")
    parser.add_argument("--mixed_precision", type=str, default=None,
                        choices=["bf16", "none"])
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--output_dir", type=str, default="./samples")
    parser.add_argument("--output_name", type=str, default="cascade.png")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default), cuda:N or cpu")
    return parser


def main(argv=None) -> list:
    """Run the CLI; returns each stage's images (N, H, W, C) in [0, 1]."""
    args = build_parser().parse_args(argv)
    refuse_process_world(
        "tools.cascade", "16", "the JAX package's tool does not split its "
        "batches either")
    device = resolve_device(args.device, "run the cascade")
    generator = set_seed(args.seed, device)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    nrow = max(1, int(math.sqrt(args.num_samples)))

    print(f"Loading base stage from {args.base_checkpoint}...")
    base_cfg, base_model, base_diff, base_sr = load_stage(
        args.base_checkpoint, args.use_ema, args.mixed_precision,
        args.num_inference_steps, args.sampling_method, device)
    if base_sr is not None:
        raise SystemExit(
            "--base_checkpoint must be a from-noise checkpoint (it has a "
            "super_resolution block — pass it as --sr_checkpoint instead)")

    stages = []
    prev_hw = tuple(base_cfg["image_size"])
    in_ch = int(base_cfg.get("model_params", {}).get("in_channels", 3))
    for k, path in enumerate(args.sr_checkpoint, start=1):
        print(f"Loading SR stage {k} from {path}...")
        cfg, model, diff, spec = load_stage(
            path, args.use_ema, args.mixed_precision,
            args.sr_num_inference_steps, args.sr_sampling_method, device)
        if spec is None:
            raise SystemExit(
                f"--sr_checkpoint {path} has no super_resolution config "
                "block — it cannot consume the previous stage's output")
        lr_hw = spec.lr_hw(cfg["image_size"])
        if lr_hw != prev_hw:
            raise SystemExit(f"SR stage {k} expects LR {lr_hw} but the "
                             f"previous stage produces {prev_hw}")
        if int(cfg.get("model_params", {}).get("in_channels", 3)) != in_ch:
            raise SystemExit(
                f"SR stage {k} channel count differs from the base stage")
        stages.append((cfg, model, diff, spec))
        prev_hw = tuple(cfg["image_size"])

    # one label a sample, shared by every conditional stage (+1 shift)
    labels = None
    conditional = [c for c in [base_cfg] + [s[0] for s in stages]
                   if c.get("conditional", False)]
    if conditional:
        num_classes = min(int(c.get("num_classes", 0) or 0)
                          for c in conditional)
        if args.labels:
            row = [int(x) for x in args.labels.split(",")]
            for lbl in row:
                if not 0 <= lbl < num_classes:
                    raise SystemExit(
                        f"label {lbl} out of range [0, {num_classes})")
            labels = np.asarray([row[i % len(row)]
                                 for i in range(args.num_samples)]) + 1
        else:
            labels = np.random.default_rng(args.seed).integers(
                0, num_classes, size=args.num_samples) + 1
        print(f"Labels (+1 shifted): {labels.tolist()}")
        labels = torch.as_tensor(labels, dtype=torch.int64, device=device)

    outputs = []
    hw = tuple(base_cfg["image_size"])
    images = sample_stage(
        base_diff, lambda start, end: base_model, hw, in_ch,
        labels if base_cfg.get("conditional", False) else None, generator,
        args.cfg_scale, args.batch_size, args.num_samples,
        f"Base stage ({hw[0]}x{hw[1]})")
    outputs.append(np.clip((images.numpy() + 1) / 2, 0, 1))
    save_image_grid(outputs[-1], out_dir / "cascade_stage0.png", nrow=nrow)

    for k, (cfg, model, diff, spec) in enumerate(stages, start=1):
        hw = tuple(cfg["image_size"])
        lr_all = images.numpy()  # the previous stage's output conditions it

        def make_fn(start, end, model=model, spec=spec, hw=hw,
                    lr_all=lr_all):
            cond = sr_lib.batch_condition(spec, hw, lr_all, start, end,
                                          end - start, generator,
                                          device=device)
            return sr_lib.wrap_model_fn(model, cond)

        images = sample_stage(
            diff, make_fn, hw, in_ch,
            labels if cfg.get("conditional", False) else None, generator,
            args.sr_cfg_scale, args.batch_size, args.num_samples,
            f"SR stage {k} ({hw[0]}x{hw[1]})")
        outputs.append(np.clip((images.numpy() + 1) / 2, 0, 1))
        save_image_grid(outputs[-1], out_dir / f"cascade_stage{k}.png",
                        nrow=nrow)

    final = out_dir / args.output_name
    save_image_grid(outputs[-1], final, nrow=nrow)
    print(f"Cascade complete: {final}")
    return outputs


if __name__ == "__main__":
    start_time = time.time()
    main()
    print(f"Total cascade time: {format_duration(time.time() - start_time)}")
