"""Distillation entry point of the PyTorch port: a trained VP checkpoint
into a few-step student, by the config's `distill_method`.

    python -m diffusion_models_collection_tpu_torch.tools.distill \\
        --config my_distill.py [--device cuda|cpu]

The port's counterpart of the repository's `tools/distill.py`:

* 'progressive' (default; Salimans & Ho 2022, `utils/distill_trainer.py`):
  halves the DDIM step count each stage (`distill_steps`,
  `distill_stages`) and writes `distilled_{N:04d}step.pth`;
* 'consistency' (Song et al. 2023, `utils/consistency_trainer.py`): a 1-4
  step consistency model (`consistency_grid_size`, `distill_cfg_scale`,
  `consistency_sample_steps`, `target_ema_decay`, `sigma_data`,
  `timestep_scaling`), written as `consistency_model.pth`.

The config names the teacher (`teacher_checkpoint`, `.pth` or JAX
`.ckpt`), the data and loader (the training configs' keys: the teacher's
data) and the optimizer. The results sample through the ordinary CLI:

    python -m diffusion_models_collection_tpu_torch.sample \\
        --checkpoint <save_dir>/distilled_0004step.pth \\
        --sampling_method ddim --num_inference_steps 4

(a consistency checkpoint samples at the step count it embeds).
`--device` defaults to `cuda` and fails when CUDA is absent. The tool runs in
one process: under torchrun (`WORLD_SIZE` > 1) it raises.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from ..factory import get_dataloader, get_dataset
from ..parallel.mesh import refuse_process_world
from ..utils.consistency_trainer import ConsistencyDistillationTrainer
from ..utils.distill_trainer import DistillationTrainer
from ..utils.helpers import (format_duration, load_config, resolve_device,
                             resolve_image_size, set_seed)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Progressively distill a trained diffusion checkpoint")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default), cuda:N or cpu")
    return parser


def main(argv=None):
    """Run the tool; returns the trainer after its last epoch."""
    args = build_parser().parse_args(argv)
    refuse_process_world("tools.distill")
    device = resolve_device(args.device, "distill")
    config = load_config(Path(args.config))
    config["image_size"] = resolve_image_size(config["image_size"])
    generator = set_seed(config.get("seed", 42), device)
    method = str(config.get("distill_method", "progressive")).lower()
    if method not in ("progressive", "consistency"):
        raise ValueError(f"Unknown distill_method: {method!r} "
                         "(expected 'progressive' or 'consistency')")
    loader = get_dataloader(config, get_dataset(config, train=True),
                            train=True, seed=config.get("seed", 42))
    trainer_class = (ConsistencyDistillationTrainer if method == "consistency"
                     else DistillationTrainer)
    return trainer_class(loader, config, device, generator=generator).distill()


if __name__ == "__main__":
    start = time.time()
    main()
    print(f"Total distillation time: {format_duration(time.time() - start)}")
