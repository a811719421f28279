"""Training entry point of the PyTorch port.

    python -m diffusion_models_collection_tpu_torch.train \\
        --config configs/cifar10_unet.py [--device cuda|cpu]

Counterpart of the repository's `train.py` for the diffusion denoisers this
port has (the UNet and the DiM, DDPM objective; `configs/cifar10_dim.py`
trains the DiM): one process on one device. The seed
(`config["seed"]`) seeds the weight init, the dropout masks and the
trainer's generator for t, noise and the CFG label dropout. `--device`
defaults to `cuda` and fails when CUDA is absent; the CPU runs only when
asked for with `--device cpu`. Float32 throughout: on CUDA, TF32 is switched
off for matrix products and convolutions. The JAX trainer's other model
types (VAE, classifier, consistency training) and its multi-process,
multi-device launch raise, naming their ROADMAP items.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from .factory import get_dataloader, get_dataset, get_diffusion, get_model
from .utils.helpers import (format_duration, load_config, resolve_device,
                            resolve_image_size, set_seed)
from .utils.trainer import DiffusionTrainer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train diffusion models (PyTorch port)")
    parser.add_argument("--config", type=str, required=True,
                        help="Path to config file")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default), cuda:N or cpu")
    return parser


def main(argv=None) -> DiffusionTrainer:
    """Run the CLI; returns the trainer after its last epoch."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device, "train")
    config = load_config(Path(args.config))
    config["image_size"] = resolve_image_size(config["image_size"])
    model_type = str(config.get("model_type", "")).lower()
    if model_type in ("vae", "classifier"):
        raise NotImplementedError(
            f"training a {model_type} is not ported yet (ROADMAP queue 1 "
            "items 11 and 12)")
    if str(config.get("diffusion_type", "ddpm")).lower() == "consistency":
        raise NotImplementedError(
            "consistency training is not ported yet (ROADMAP queue 1 item 12)")
    generator = set_seed(config.get("seed", 42), device)
    print(f"Device: {device}")

    print("Creating model...")
    model = get_model(config)

    print("Loading dataset...")
    train_dataset = get_dataset(config, train=True)
    train_loader = get_dataloader(config, train_dataset, train=True,
                                  seed=config.get("seed", 42))

    trainer = DiffusionTrainer(
        model=model,
        diffusion=get_diffusion(config),  # training is always DDPM
        train_loader=train_loader,
        config=config,
        device=device,
        generator=generator,
        resume_path=config.get("resume_path"),
    )
    trainer.train()
    return trainer


if __name__ == "__main__":
    start_time = time.time()
    main()
    print(f"Total training time: {format_duration(time.time() - start_time)}")
