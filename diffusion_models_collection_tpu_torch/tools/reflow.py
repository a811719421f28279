"""Reflow entry point of the PyTorch port: rectify a trained flow-matching
checkpoint so that few-step (eventually 1-step) Euler sampling approaches
the full ODE's result (Liu et al. 2023).

    python -m diffusion_models_collection_tpu_torch.tools.reflow \\
        --config my_reflow.py [--device cuda|cpu]

The port's counterpart of the repository's `tools/reflow.py`. The config
names the teacher (`teacher_checkpoint`, a `diffusion_type:
'flow_matching'` `.pth` or JAX `.ckpt`), the optimizer and the reflow keys
(`reflow_pairs`, `reflow_rounds`, `pair_batch_size`, `teacher_sample_steps`,
`reflow_cfg_scale`, `epochs`; `utils/reflow_trainer.py`); no data: the
pairs come from the teacher. Each round writes `reflow_round{k}.pth`, which
samples through the ordinary CLI at any step count:

    python -m diffusion_models_collection_tpu_torch.sample \\
        --checkpoint <save_dir>/reflow_round1.pth --num_inference_steps 1

`--device` defaults to `cuda` and fails when CUDA is absent. The tool runs in
one process: under torchrun (`WORLD_SIZE` > 1) it raises.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from ..parallel.mesh import refuse_process_world
from ..utils.helpers import (format_duration, load_config, resolve_device,
                             set_seed)
from ..utils.reflow_trainer import ReflowTrainer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Rectify (reflow) a trained flow-matching checkpoint")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default), cuda:N or cpu")
    return parser


def main(argv=None):
    """Run the tool; returns the trainer after its last round."""
    args = build_parser().parse_args(argv)
    refuse_process_world("tools.reflow")
    device = resolve_device(args.device, "reflow")
    config = load_config(Path(args.config))
    generator = set_seed(config.get("seed", 42), device)
    return ReflowTrainer(config, device, generator=generator).reflow()


if __name__ == "__main__":
    start = time.time()
    main()
    print(f"Total reflow time: {format_duration(time.time() - start)}")
