"""Where the PyTorch port's sampling time goes on one NVIDIA GPU.

    python tools/profile_torch_sampling.py [--config CONFIG] [--output_dir DIR]

From the root of a checkout, on a machine with one CUDA card and nvcc. The
model is the one CONFIG describes (default configs/cifar10_unet.py, the
CIFAR-10 UNet; configs/cifar10_dim.py is the CIFAR-10 DiM) at full width
with random weights from seed 0, float32 with TF32 off, sampled with DDIM
and classifier-free guidance (scale 3) on 80 images, so 160 rows per model
call. Two measurements:

1. `torch.profiler` over 5 DDIM CFG steps after a warm-up run: host wall
   time, the time some kernel ran on the device (the union of the kernels'
   intervals), the device's idle share, and device time by kind of kernel.
2. End to end: `sample.main` with DDIM-50 on 80 images, alternating the
   kernel path and the plain PyTorch versions of the kernels
   (`ops.plain.plain_kernels`), three times each, in samples/s.

Prints both with the card's name and power limit from nvidia-smi, and
writes them as JSON to DIR/profile_torch_sampling_<model_type>.json.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from diffusion_models_collection_tpu_torch import factory, sample  # noqa: E402
from diffusion_models_collection_tpu_torch.diffusion import DDIM  # noqa: E402
from diffusion_models_collection_tpu_torch.ops.plain import plain_kernels  # noqa: E402
from diffusion_models_collection_tpu_torch.utils import checkpoint  # noqa: E402
from diffusion_models_collection_tpu_torch.utils.helpers import (  # noqa: E402
    load_config,
    resolve_image_size,
)
from diffusion_models_collection_tpu_torch.utils.profiler import device_time  # noqa: E402

DEFAULT_CONFIG = ROOT / "configs" / "cifar10_unet.py"
SAMPLES, STEPS, CFG_SCALE, PROFILED_STEPS, REPEATS = 80, 50, 3.0, 5, 3

# Kinds of device kernel, matched in order on the kernel's name. The names
# are cuDNN's, cuBLAS's, PyTorch's and the port's own.
KINDS = [
    ("GN+SiLU, K1 (gn_silu_fwd)", ("gn_silu",)),
    ("attention forward, K2 (flash_attn_fwd)", ("flash_fwd_kernel",)),
    ("selective scan forward, K4/K5/K6 (selective_scan_fwd)",
     ("scan_fwd_kernel",)),
    ("3x3 convs as FFT", ("fft", "pointwise_mult_and_sum_complex",
                          "flip_filter")),
    ("NHWC<->NCHW transposes", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("convs as implicit GEMM or direct", ("implicit_gemm", "conv", "fprop")),
    ("matrix products (linears)", ("gemm", "gemv", "cutlass", "xmma")),
    ("layer norms", ("layer_norm",)),
    ("elementwise, copies, cat, upsample", ("elementwise", "vectorized",
                                            "catarray", "upsample", "copy",
                                            "fill")),
]


def profile_steps(config, model):
    ddim = DDIM(num_timesteps=1000, num_inference_steps=PROFILED_STEPS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    labels = torch.arange(SAMPLES, device="cuda") % config["num_classes"] + 1
    shape = (SAMPLES, *resolve_image_size(config["image_size"]),
             config["model_params"]["in_channels"])

    def run():
        return ddim.sample_with_cfg(model, shape, labels, gen,
                                    cfg_scale=CFG_SCALE)

    run()  # warm-up: kernel library, cuDNN's choices for batch 160
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    busy_ms, by_kind = device_time(
        prof, KINDS, "the rest (reductions, sorts for the quantile, ...)")
    return {"steps": PROFILED_STEPS, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "device_ms_by_kind": by_kind}


def end_to_end(config, model):
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "random.pth"
        checkpoint.save_checkpoint(ckpt, model.state_dict(), config)
        argv = ["--checkpoint", str(ckpt), "--sampling_method", "ddim",
                "--cfg_scale", str(CFG_SCALE), "--num_samples", str(SAMPLES),
                "--batch_size", str(SAMPLES), "--seed", "0",
                "--device", "cuda", "--output_dir", tmp,
                "--num_inference_steps", str(STEPS)]
        rates = {"kernels": [], "plain": []}
        for _ in range(REPEATS):
            result = sample.main(argv)
            rates["kernels"].append(SAMPLES / result["sampling_seconds"])
            with plain_kernels():
                result = sample.main(argv)
            rates["plain"].append(SAMPLES / result["sampling_seconds"])
    return rates


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default=str(DEFAULT_CONFIG))
    parser.add_argument("--output_dir", default="profile_out")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_torch_sampling.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    config = load_config(args.config)
    torch.manual_seed(0)
    model = factory.get_model(config).to("cuda").eval()
    with torch.no_grad():
        profile = profile_steps(config, model)
    print(f"profile, {PROFILED_STEPS} DDIM CFG steps at batch "
          f"{2 * SAMPLES}, on {smi}: wall {profile['wall_ms']:.1f} ms, "
          f"device busy {profile['device_busy_ms']:.1f} ms, idle share "
          f"{profile['device_idle_share']:.4f}")
    busy_sum = sum(profile["device_ms_by_kind"].values())
    for kind, ms in profile["device_ms_by_kind"].items():
        print(f"  {kind}: {ms:.2f} ms ({100 * ms / busy_sum:.1f} %)")

    rates = end_to_end(config, model)
    print(f"end to end, DDIM-{STEPS} CFG {CFG_SCALE}, {SAMPLES} images, "
          f"alternating, on {smi}: kernel path "
          f"{', '.join(f'{r:.3f}' for r in rates['kernels'])} samples/s; "
          f"plain path {', '.join(f'{r:.3f}' for r in rates['plain'])} "
          "samples/s")
    result = {"device": smi, "torch": torch.__version__,
              "config": args.config, "profile": profile,
              "samples_per_s": rates}
    (out_dir / f"profile_torch_sampling_{config['model_type']}.json").write_text(
        json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
