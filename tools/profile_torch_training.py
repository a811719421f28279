"""Where the PyTorch port's training time goes on one NVIDIA GPU.

    python tools/profile_torch_training.py [--config CONFIG] [--output_dir DIR]
                                           [--remat] [--image_size N]
                                           [--mixed_precision bf16|none]

From the root of a checkout, on a machine with one CUDA card and nvcc. The
model is the one CONFIG describes (default configs/cifar10_unet.py, the
CIFAR-10 UNet; configs/cifar10_dim.py is the CIFAR-10 DiM,
configs/cifar10_dit.py the CIFAR-10 DiT, whose attention trains in the
kernels' dropout form) at full width
with random weights from seed 0, trained as that config trains it (batch
128, AdamW, clip 1.0, EMA, CFG label dropout, dropout 0.1), float32 with
TF32 off, on one batch of the committed CIFAR-10 fixtures
(tests/fixtures/data). `--remat` sets the config's `remat: True` (gradient
checkpointing per block); `--image_size N` trains on N x N images of the
`synthetic` dataset at batch 16 (N = 64 is the long-sequence DiM, whose
scans run time-split); `--mixed_precision bf16` overrides the config's
compute dtype (bf16 convs, linears and activations on float32 weights). Two measurements, both through the trainer's own
`train_step`:

1. `torch.profiler` over 5 train steps after 3 warm-up steps: host wall
   time, the time some kernel ran on the device (the union of the kernels'
   intervals), the device's idle share, and device time by kind of kernel.
2. Train images/s, the median of 10 CUDA-synchronised steps after 2,
   alternating the kernel path and the plain PyTorch versions of the
   kernels (`ops.plain.plain_kernels`), three times each.

Prints both with the card's name and power limit from nvidia-smi, and
writes them as JSON to DIR/profile_torch_training_<model_type>.json
(`_remat`, `_N` and `_bf16` added to the name with those flags).
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
    ("GN+SiLU backward, K1b (gn_silu_bwd)", ("gn_silu_bwd",)),
    ("GN+SiLU forward, K1 (gn_silu_fwd)", ("gn_silu",)),
    ("attention forward, K2 (flash_attn_fwd)", ("flash_fwd",)),
    ("attention backward's delta and dq-share sum passes (K3)",
     ("flash_bwd_delta", "flash_bwd_dq_sum")),
    ("attention backward, K3 (flash_attn_bwd)", ("flash_bwd",)),
    ("selective scan forward, K4/K5/K6 (selective_scan_fwd)",
     ("scan_fwd_kernel",)),
    ("selective scan backward without states, K7 "
     "(selective_scan_bwd_nostate)", ("scan_bwd_nostate",)),
    ("selective scan backward, K8 (selective_scan_bwd)", ("scan_bwd_kernel",)),
    ("dB/dC tile sums of K7, K8, K10", ("scan_bwd_sum",)),
    ("time-split scan forward, K9 (selective_scan_fwd_split)",
     ("split_fwd",)),
    ("time-split scan backward, K10 (selective_scan_bwd_split)",
     ("split_bwd",)),
    ("time-split scans' carry pass (K9, K10)", ("split_carry",)),
    ("conv backward (data and filter gradients)", ("dgrad", "wgrad",
                                                   "bwd_data", "bwd_filter",
                                                   "backward")),
    ("3x3 convs as FFT", ("fft", "pointwise_mult_and_sum_complex",
                          "flip_filter")),
    ("NHWC<->NCHW transposes", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("conv forward (implicit GEMM or direct)", ("implicit_gemm", "conv",
                                                "fprop")),
    ("matrix products (linears)", ("gemm", "gemv", "cutlass", "xmma",
                                   "nvjet")),
    ("layer norms", ("layer_norm",)),
    ("AdamW, EMA, clip (multi-tensor)", ("multi_tensor", "foreach")),
    ("reductions (norms, loss, bias gradients)", ("reduce",)),
    ("elementwise, copies, cat, upsample", ("elementwise", "vectorized",
                                            "catarray", "upsample", "copy",
                                            "fill")),
]


def build_trainer(config_path, tmp, remat=False, image_size=None,
                  mixed_precision=None):
    config = load_config(config_path)
    if mixed_precision is not None:
        config["mixed_precision"] = mixed_precision
    config.update(data_root=str(FIXTURE_DATA), save_dir=str(Path(tmp) / "ckpt"),
                  sample_dir=str(Path(tmp) / "samples"))
    if remat:
        config["remat"] = True
    if image_size:
        size = (image_size, image_size)
        config.update(image_size=size, dataset="synthetic", batch_size=16)
        if "img_size" in config["model_params"]:
            config["model_params"] = dict(config["model_params"],
                                          img_size=size)
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
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--mixed_precision", choices=["bf16", "none"],
                        default=None,
                        help="override the config's compute dtype")
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
        trainer, images, labels = build_trainer(args.config, tmp, args.remat,
                                                args.image_size,
                                                args.mixed_precision)
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
    name = trainer.config["model_type"] + ("_remat" if args.remat else "") + (
        f"_{args.image_size}" if args.image_size else "") + (
        "_bf16" if args.mixed_precision == "bf16" else "")
    (out_dir / f"profile_torch_training_{name}.json").write_text(
        json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
