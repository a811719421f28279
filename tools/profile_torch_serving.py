"""What the serving engine's admission and read-back cost on one NVIDIA GPU.

    python tools/profile_torch_serving.py [--output_dir DIR]

From the root of a checkout, on a machine with one CUDA card. Times the
PyTorch port's `ContinuousBatchingEngine` (16 slots of 32x32x3 images, not
started, so no model runs) on its own paths: `_admit` of a request of 1 row
against one of 16 (the JAX engine pads every admission to the pool), and
`_gather` of 1 finished slot against all 16 (the JAX engine reads back the
whole pool). Medians of 50 calls after 5 warm-up calls, the card
synchronised around each, so the host's part is included. Prints them with
the card's name and power limit from nvidia-smi, and writes them as JSON to
DIR/profile_torch_serving.json.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from diffusion_models_collection_tpu_torch.diffusion import DDIM  # noqa: E402
from diffusion_models_collection_tpu_torch.serving_engine import (  # noqa: E402
    ContinuousBatchingEngine,
    _Request,
)

SLOTS, SHAPE, REPS, WARMUP = 16, (32, 32, 3), 50, 5


def median_ms(fn):
    samples = []
    for _ in range(WARMUP + REPS):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - start)
    return 1e3 * statistics.median(samples[WARMUP:])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--output_dir", default="profile_out")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_torch_serving.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    engine = ContinuousBatchingEngine(
        DDIM(num_inference_steps=50), model_fn=None, image_shape=SHAPE,
        num_slots=SLOTS, conditional=True, device="cuda")
    times = {}
    for k in (1, SLOTS):
        noise = np.random.RandomState(k).randn(k, *SHAPE).astype(np.float32)
        req = _Request(noise=torch.from_numpy(noise),
                       labels=torch.ones((k,), dtype=torch.int64),
                       cfg_scale=3.0, slots=np.arange(k, dtype=np.int64))
        times[f"admit_{k}_ms"] = median_ms(lambda req=req: engine._admit(req))
        slots = np.arange(k, dtype=np.int64)
        times[f"gather_{k}_ms"] = median_ms(
            lambda slots=slots: engine._gather(slots))
    print(f"serving engine, {SLOTS} slots, median of {REPS}, on {smi}: "
          f"admit 1 row {times['admit_1_ms']:.4f} ms, {SLOTS} rows "
          f"{times[f'admit_{SLOTS}_ms']:.4f} ms; gather 1 slot "
          f"{times['gather_1_ms']:.4f} ms, {SLOTS} slots "
          f"{times[f'gather_{SLOTS}_ms']:.4f} ms")
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "profile_torch_serving.json").write_text(json.dumps(
        {"device": smi, "torch": torch.__version__, **times}, indent=1))


if __name__ == "__main__":
    main()
