"""What the port's activation dropout costs a train step on one NVIDIA GPU.

    python tools/profile_torch_dropout.py [--output_dir DIR] [--rounds N]

From the root of a checkout, on a machine with one CUDA card and nvcc. The
port's `models.layers.Dropout` draws a one-byte mask (`bernoulli_` into a
bool tensor) and scales through `F.dropout`'s own masked scale, so that a
data-parallel or tensor-parallel run can keep its slice of the global mask;
`nn.Dropout` (`F.dropout`) draws and scales in one fused kernel, and cannot.
For each case, the model trained as its config trains it through
`DiffusionTrainer.train_step` (AdamW, clip, EMA, dropout 0.1, random weights
from seed 0, TF32 off) on one batch:

* the CIFAR-10 DiT (configs/cifar10_dit.py) at batch 128, float32 and bf16;
* the CIFAR-10 MoE DiT (configs/cifar10_dit_moe.py) at batch 128, bf16;
* the DiT at 64x64 on `synthetic` (L 1024) at batch 128, bf16;

train images/s (the median of 10 CUDA-synchronised steps after 2) and the
peak device memory of those steps, with the port's `Dropout` and with
`nn.Dropout.forward` in its place, in alternating rounds (port, nn, nn,
port, ...; `--rounds` rounds of each). Prints the medians and the largest
peak of each with the card's name and power limit, and writes them as JSON
to DIR/profile_torch_dropout.json.
"""

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
from torch import nn

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from diffusion_models_collection_tpu_torch import factory  # noqa: E402
from diffusion_models_collection_tpu_torch.models import layers  # noqa: E402
from diffusion_models_collection_tpu_torch.utils.helpers import (  # noqa: E402
    load_config,
    set_seed,
)
from diffusion_models_collection_tpu_torch.utils.trainer import (  # noqa: E402
    DiffusionTrainer,
)

FIXTURE_DATA = ROOT / "tests" / "fixtures" / "data"
BATCH, WARMUP, TIMED = 128, 2, 10
# (label, config, mixed precision, image size or None for the config's)
CASES = [
    ("DiT fp32", "configs/cifar10_dit.py", "none", None),
    ("DiT bf16", "configs/cifar10_dit.py", "bf16", None),
    ("MoE DiT bf16", "configs/cifar10_dit_moe.py", "bf16", None),
    ("DiT 64x64 bf16", "configs/cifar10_dit.py", "bf16", 64),
]


def build_trainer(config_path, precision, image_size, tmp):
    config = load_config(ROOT / config_path)
    config.update(mixed_precision=precision, batch_size=BATCH,
                  data_root=str(FIXTURE_DATA),
                  save_dir=str(Path(tmp) / "ckpt"),
                  sample_dir=str(Path(tmp) / "samples"))
    if image_size:
        size = (image_size, image_size)
        config.update(image_size=size, dataset="synthetic")
        config["model_params"] = dict(config["model_params"], img_size=size)
    generator = set_seed(0, "cuda")
    model = factory.get_model(config)
    loader = factory.get_dataloader(
        config, factory.get_dataset(config, train=True), train=True, seed=0)
    trainer = DiffusionTrainer(model, factory.get_diffusion(config), loader,
                               config, "cuda", generator=generator)
    images, labels = next(iter(loader))
    return (trainer, torch.from_numpy(images).to("cuda"),
            torch.from_numpy(labels).to("cuda"))


@contextlib.contextmanager
def library_dropout(on):
    """With `on`, every `Dropout` runs `nn.Dropout.forward` (F.dropout)."""
    saved = layers.Dropout.forward
    if on:
        layers.Dropout.forward = nn.Dropout.forward
    try:
        yield
    finally:
        layers.Dropout.forward = saved


def timed_round(trainer, images, labels):
    """(images/s, peak device memory in bytes) of TIMED steps after
    WARMUP."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(WARMUP + TIMED):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        trainer.train_step(images, labels)
        end.record()
        end.synchronize()
        if i >= WARMUP:
            times.append(start.elapsed_time(end) / 1e3)
    return images.shape[0] / statistics.median(times), \
        torch.cuda.max_memory_allocated()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--output_dir", default="profile_out")
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_torch_dropout.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    order = [False, True, True, False] * ((args.rounds + 1) // 2)
    order = order[:2 * args.rounds]
    result = {"device": smi, "torch": torch.__version__, "batch": BATCH,
              "cases": {}}
    for label, config, precision, size in CASES:
        runs = {"port": [], "nn.Dropout": []}
        peaks = {"port": [], "nn.Dropout": []}
        with tempfile.TemporaryDirectory() as tmp:
            trainer, images, labels = build_trainer(config, precision, size,
                                                    tmp)
            for library in order:
                key = "nn.Dropout" if library else "port"
                with library_dropout(library):
                    rate, peak = timed_round(trainer, images, labels)
                runs[key].append(rate)
                peaks[key].append(peak)
            del trainer, images, labels
        torch.cuda.empty_cache()
        case = {key: {"images_per_s": runs[key],
                      "median_images_per_s": statistics.median(runs[key]),
                      "peak_mib": max(peaks[key]) / 2**20}
                for key in runs}
        result["cases"][label] = case
        port, lib = case["port"], case["nn.Dropout"]
        print(f"{label} at batch {BATCH}: the port's Dropout "
              f"{port['median_images_per_s']:.2f} train images/s (rounds "
              f"{', '.join(f'{r:.2f}' for r in runs['port'])}), peak "
              f"{port['peak_mib']:.1f} MiB; nn.Dropout "
              f"{lib['median_images_per_s']:.2f} (rounds "
              f"{', '.join(f'{r:.2f}' for r in runs['nn.Dropout'])}), peak "
              f"{lib['peak_mib']:.1f} MiB; ratio "
              f"{port['median_images_per_s'] / lib['median_images_per_s']:.4f}"
              f" on {smi}", flush=True)
    (out_dir / "profile_torch_dropout.json").write_text(
        json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
