"""Where the PyTorch port's training time goes on one NVIDIA GPU.

    python tools/profile_torch_training.py [--config CONFIG] [--output_dir DIR]

From the root of a checkout, on a machine with one CUDA card and nvcc. The
model is the one CONFIG describes (default configs/cifar10_unet.py, the
CIFAR-10 UNet; configs/cifar10_dim.py is the CIFAR-10 DiM) at full width
with random weights from seed 0, trained as that config trains it (batch
128, AdamW, clip 1.0, EMA, CFG label dropout, dropout 0.1), float32 with
TF32 off, on one batch of the committed CIFAR-10 fixtures
(tests/fixtures/data). Two measurements, both through the trainer's own
`train_step`:

1. `torch.profiler` over 5 train steps after 3 warm-up steps: host wall
   time, the time some kernel ran on the device (the union of the kernels'
   intervals), the device's idle share, and device time by kind of kernel.
2. Train images/s, the median of 10 CUDA-synchronised steps after 2,
   alternating the kernel path and the plain PyTorch versions of the
   kernels (`ops.plain.plain_kernels`), three times each.

Prints both with the card's name and power limit from nvidia-smi, and
writes them as JSON to DIR/profile_torch_training_<model_type>.json.
"""

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from diffusion_models_collection_tpu_torch import factory  # noqa: E402
from diffusion_models_collection_tpu_torch.ops.plain import plain_kernels  # noqa: E402
from diffusion_models_collection_tpu_torch.utils.helpers import (  # noqa: E402
    load_config,
    set_seed,
)
from diffusion_models_collection_tpu_torch.utils.profiler import device_time  # noqa: E402
from diffusion_models_collection_tpu_torch.utils.trainer import (  # noqa: E402
    DiffusionTrainer,
)

DEFAULT_CONFIG = ROOT / "configs" / "cifar10_unet.py"
FIXTURE_DATA = ROOT / "tests" / "fixtures" / "data"
WARMUP, PROFILED_STEPS, TIMED, REPEATS = 3, 5, 10, 3

# Kinds of device kernel, matched in order on the kernel's name. The names
# are cuDNN's, cuBLAS's, PyTorch's and the port's own.
KINDS = [
    ("GN+SiLU forward, K1 (gn_silu_fwd)", ("gn_silu",)),
    ("attention forward, K2 (flash_attn_fwd)", ("flash_fwd_kernel",)),
    ("attention backward, K3 (flash_attn_bwd)", ("flash_bwd",)),
    ("selective scan forward, K4/K5/K6 (selective_scan_fwd)",
     ("scan_fwd_kernel",)),
    ("selective scan backward, K8 (selective_scan_bwd)", ("scan_bwd",)),
    ("conv backward (data and filter gradients)", ("dgrad", "wgrad",
                                                   "bwd_data", "bwd_filter",
                                                   "backward")),
    ("3x3 convs as FFT", ("fft", "pointwise_mult_and_sum_complex",
                          "flip_filter")),
    ("NHWC<->NCHW transposes", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("conv forward (implicit GEMM or direct)", ("implicit_gemm", "conv",
                                                "fprop")),
    ("matrix products (linears)", ("gemm", "gemv", "cutlass", "xmma")),
    ("layer norms", ("layer_norm",)),
    ("AdamW, EMA, clip (multi-tensor)", ("multi_tensor", "foreach")),
    ("reductions (GN+SiLU backward recompute, norms, loss)", ("reduce",)),
    ("elementwise, copies, cat, upsample", ("elementwise", "vectorized",
                                            "catarray", "upsample", "copy",
                                            "fill")),
]


def build_trainer(config_path, tmp):
    config = load_config(config_path)
    config.update(data_root=str(FIXTURE_DATA), save_dir=str(Path(tmp) / "ckpt"),
                  sample_dir=str(Path(tmp) / "samples"))
    generator = set_seed(0, "cuda")
    model = factory.get_model(config)
    loader = factory.get_dataloader(
        config, factory.get_dataset(config, train=True), train=True, seed=0)
    trainer = DiffusionTrainer(model, factory.get_diffusion(config), loader,
                               config, "cuda", generator=generator)
    images, labels = next(iter(loader))
    return (trainer, torch.from_numpy(images).to("cuda"),
            torch.from_numpy(labels).to("cuda"))


def profile_steps(trainer, images, labels):
    for _ in range(WARMUP):  # kernel library, cuDNN's choices, Adam state
        trainer.train_step(images, labels)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            trainer.train_step(images, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    busy_ms, by_kind = device_time(prof, KINDS, "the rest")
    return {"steps": PROFILED_STEPS, "batch": int(images.shape[0]),
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "device_ms_by_kind": by_kind}


def images_per_s(trainer, images, labels):
    times = []
    for i in range(2 + TIMED):
        torch.cuda.synchronize()
        start = time.perf_counter()
        trainer.train_step(images, labels)
        torch.cuda.synchronize()
        if i >= 2:
            times.append(time.perf_counter() - start)
    return images.shape[0] / statistics.median(times)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default=str(DEFAULT_CONFIG))
    parser.add_argument("--output_dir", default="profile_out")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_torch_training.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with tempfile.TemporaryDirectory() as tmp:
        trainer, images, labels = build_trainer(args.config, tmp)
        profile = profile_steps(trainer, images, labels)
        print(f"profile, {PROFILED_STEPS} train steps at batch "
              f"{profile['batch']}, on {smi}: wall {profile['wall_ms']:.1f} "
              f"ms, device busy {profile['device_busy_ms']:.1f} ms, idle "
              f"share {profile['device_idle_share']:.4f}")
        busy_sum = sum(profile["device_ms_by_kind"].values())
        for kind, ms in profile["device_ms_by_kind"].items():
            print(f"  {kind}: {ms:.2f} ms ({100 * ms / busy_sum:.1f} %)")

        rates = {"kernels": [], "plain": []}
        for _ in range(REPEATS):
            rates["kernels"].append(images_per_s(trainer, images, labels))
            with plain_kernels():
                rates["plain"].append(images_per_s(trainer, images, labels))
    print(f"train images/s at batch {profile['batch']}, alternating, on "
          f"{smi}: kernel path "
          f"{', '.join(f'{r:.2f}' for r in rates['kernels'])}; plain path "
          f"{', '.join(f'{r:.2f}' for r in rates['plain'])}")
    result = {"device": smi, "torch": torch.__version__,
              "config": args.config, "profile": profile,
              "train_images_per_s": rates}
    model_type = trainer.config["model_type"]
    (out_dir / f"profile_torch_training_{model_type}.json").write_text(
        json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
