"""Train images/s of the PyTorch port's train steps that run K1b's cluster
form and K8's wide sweep, for one or more trees, on one NVIDIA GPU.

    python tools/time_torch_train_steps.py [ROOT ...]

From the root of a checkout, on a machine with one CUDA card and nvcc. Both
paths, full width with random weights from seed 0, float32 with TF32 off,
each step through the trainer's own `train_step` on one batch:

* `sr`: configs/celeba64_sr_unet.py (the 64x64 SR UNet, 13 of its 45
  GroupNorm+SiLU backward calls a step on groups past one SM's shared
  memory) on the `synthetic` dataset at batch 256, the batch
  `chip_smoke.py`'s `phase_sr` trains it at on an H100;
* `dim64`: configs/cifar10_dim.py at `state_size` 64 (12 K8 calls a step at
  N 64) on the committed CIFAR-10 fixtures at batch 128.

Each ROOT (default: this checkout) is a directory holding a
`diffusion_models_collection_tpu_torch/` package (an unpacked parent commit:
`git archive <commit> diffusion_models_collection_tpu_torch | tar -x -C
build/parent`); each runs in a process of its own, in the order given, so
name them parent, change, change, parent to see the spread. Prints, with
the card's name and power limit, the median train images/s of 5
CUDA-synchronised steps after 2 warm-up steps, and each step's seconds.
"""

import argparse
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve()
CONFIGS = HERE.parent.parent / "configs"
FIXTURE_DATA = HERE.parent.parent / "tests" / "fixtures" / "data"
PATHS = {"sr": ("celeba64_sr_unet.py", 256), "dim64": ("cifar10_dim.py", 128)}
STEPS = 5


def trainer_for(path, tmp):
    import torch
    from diffusion_models_collection_tpu_torch import factory
    from diffusion_models_collection_tpu_torch.utils.helpers import (
        load_config,
        set_seed,
    )
    from diffusion_models_collection_tpu_torch.utils.trainer import (
        DiffusionTrainer,
    )
    name, batch = PATHS[path]
    config = load_config(CONFIGS / name)
    config.update(data_root=str(FIXTURE_DATA), batch_size=batch,
                  save_dir=str(Path(tmp) / "ckpt"),
                  sample_dir=str(Path(tmp) / "samples"))
    if path == "sr":
        config.update(dataset="synthetic", image_size=(64, 64))
    else:
        config["model_params"] = dict(config["model_params"], state_size=64)
    generator = set_seed(0, "cuda")
    model = factory.get_model(config)
    loader = factory.get_dataloader(
        config, factory.get_dataset(config, train=True), train=True, seed=0)
    trainer = DiffusionTrainer(model, factory.get_diffusion(config), loader,
                               config, "cuda", generator=generator)
    images, labels = next(iter(loader))  # no labels: the SR UNet
    return (trainer, torch.from_numpy(images).to("cuda"),
            None if labels is None else torch.from_numpy(labels).to("cuda"))


def run_tree(root):
    import torch
    sys.path.insert(0, str(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for path in PATHS:
        with tempfile.TemporaryDirectory() as tmp:
            trainer, images, labels = trainer_for(path, tmp)
            seconds = []
            for i in range(2 + STEPS):
                torch.cuda.synchronize()
                start = time.perf_counter()
                trainer.train_step(images, labels)
                torch.cuda.synchronize()
                if i >= 2:
                    seconds.append(time.perf_counter() - start)
            rate = images.shape[0] / statistics.median(seconds)
            steps_s = ", ".join(f"{s:.4f}" for s in seconds)
            print(f"{root}: {path} at batch {images.shape[0]}: {rate:.2f} "
                  f"train images/s (steps {steps_s} s)", flush=True)
            del trainer, images, labels
            torch.cuda.empty_cache()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("roots", nargs="*", default=[str(HERE.parent.parent)])
    parser.add_argument("--tree", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.tree:
        run_tree(Path(args.tree).resolve())
        return 0
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("time_torch_train_steps.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    failed = 0
    for root in args.roots:
        failed |= subprocess.run(
            [sys.executable, str(HERE), "--tree", root]).returncode
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
