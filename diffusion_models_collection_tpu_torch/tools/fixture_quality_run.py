"""Fixture quality run of the PyTorch port: train the UNet on the committed
CIFAR-10 fixtures and evaluate each checkpoint, the check that the port
learns (and not only that two steps agree with the JAX package).

    python -m diffusion_models_collection_tpu_torch.tools.fixture_quality_run \\
        --epochs 1000 --ckpt_every 250 --out fixture_quality.json

The UNet part of the recipe of the repository's
`tools/fixture_quality_run.py`, through the port's own `train` and
`evaluate` (in this process): `configs/cifar10_unet.py` at full width on
`tests/fixtures/data` (200 training images; the 50-image test split is the
real set), batch 32, T = 200 with `beta_end` scaled by (config T / T) so the
terminal alpha_bar stays ~4e-5 as at T = 1000, EMA decay 0.995, constant
learning rate, no samples during training, a checkpoint every
`--ckpt_every` epochs; each checkpoint evaluated with DDIM-50, 200 samples
in batches of 50, the EMA weights, seed 42 and SWD. Without pretrained
Inception and LPIPS weights FID, KID, IS and LPIPS are relative-only (and
not comparable with the JAX package's, whose random weights differ); SWD is
the calibrated metric. Writes the per-epoch loss curve, each checkpoint's
metrics and stage seconds as JSON to `--out`, and prints a table.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

import torch

from .. import evaluate, train
from ..utils.helpers import load_config

REPO = Path(__file__).resolve().parents[2]
FIXTURES = REPO / "tests" / "fixtures" / "data"
EVAL_KEYS = ("FID", "KID_mean", "swd_avg", "IS_mean", "LPIPS_diversity")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=str(REPO / "configs" /
                                            "cifar10_unet.py"))
    ap.add_argument("--epochs", type=int, default=600)
    ap.add_argument("--ckpt_every", type=int, default=100)
    ap.add_argument("--ema_decay", type=float, default=0.995)
    ap.add_argument("--num_timesteps", type=int, default=200)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--eval_samples", type=int, default=200)
    ap.add_argument("--eval_batch", type=int, default=50)
    ap.add_argument("--eval_steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None,
                    help="checkpoints and images (default: a temporary "
                         "directory, removed at the end)")
    ap.add_argument("--out", default="fixture_quality.json")
    return ap


def recipe_config(args, workdir: Path) -> dict:
    """The config with the fixture recipe's overrides."""
    config = dict(load_config(args.config))
    config.update(
        dataset="cifar10", data_root=str(FIXTURES), epochs=args.epochs,
        batch_size=args.batch_size, save_interval=args.ckpt_every,
        save_current_interval=args.ckpt_every, save_best=False,
        save_dir=str(workdir / "ckpt"), sample_dir=str(workdir / "samples"),
        sample_interval=10**6, sample_start_epoch=10**6,
        ema_decay=args.ema_decay, use_scheduler=False,
        num_timesteps=args.num_timesteps,
        beta_end=config["beta_end"] * config["num_timesteps"]
        / args.num_timesteps,
        use_swanlab=False, resume_path=None, seed=args.seed)
    return config


def evaluate_checkpoint(args, ckpt: Path, workdir: Path) -> dict:
    seconds = {}
    report = evaluate.main([
        "--checkpoint", str(ckpt), "--device", args.device,
        "--sampling_method", "ddim",
        "--num_inference_steps", str(args.eval_steps),
        "--num_samples", str(args.eval_samples),
        "--batch_size", str(args.eval_batch), "--seed", str(args.seed),
        "--use_ema", "--swd", "--save_images_dir", "",
        "--output", str(workdir / f"metrics_{ckpt.stem}.json")],
        seconds=seconds)
    return {**{k: report[k] for k in EVAL_KEYS if k in report},
            "seconds": seconds}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    workdir = Path(args.workdir or tempfile.mkdtemp(prefix="fixture_run_"))
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        config = recipe_config(args, workdir)
        cfg_path = workdir / "fixture_config.py"
        cfg_path.write_text(f"config = {config!r}\n")
        start = time.perf_counter()
        trainer = train.main(["--config", str(cfg_path), "--device",
                              args.device])
        if args.device.startswith("cuda"):
            torch.cuda.synchronize()
        train_seconds = time.perf_counter() - start
        metrics_file = trainer.save_dir / (
            f"{config.get('experiment_name', 'run')}.metrics.jsonl")
        losses = [json.loads(line)["train/loss"]
                  for line in metrics_file.read_text().splitlines()
                  if "train/loss" in line]
        rows = []
        for ckpt in sorted(trainer.save_dir.glob("model_epoch_*.pth")):
            row = {"epoch": int(ckpt.stem.rsplit("_", 1)[1]),
                   **evaluate_checkpoint(args, ckpt, workdir)}
            rows.append(row)
            print(f"epoch {row['epoch']}: " + ", ".join(
                f"{k}={row[k]:.4g}" for k in EVAL_KEYS if k in row))
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    result = {
        "device": (torch.cuda.get_device_name(0)
                   if args.device.startswith("cuda") else args.device),
        "recipe": {k: v for k, v in vars(args).items()
                   if k not in ("workdir", "out")},
        "steps": trainer.global_step, "train_seconds": train_seconds,
        "losses": losses, "rows": rows}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=2))
    print("| epoch | rel-FID | rel-KID x1e3 | SWD x1e3 | IS | LPIPS div |")
    print("|---|---|---|---|---|---|")
    for row in rows:
        print(f"| {row['epoch']} | {row['FID']:.4g} | "
              f"{row['KID_mean'] * 1e3:.4g} | {row['swd_avg']:.4g} | "
              f"{row['IS_mean']:.4g} | {row['LPIPS_diversity']:.4g} |")
    every = max(1, len(losses) // 12)
    print("loss (per-epoch mean): " + ", ".join(
        f"{v:.4f}" for v in losses[::every]) + f" ... final {losses[-1]:.4f}")
    print(f"{trainer.global_step} steps in {train_seconds:.1f} s on "
          f"{result['device']}; written to {args.out}")
    return result


if __name__ == "__main__":
    main()
