"""Training entry point of the PyTorch port.

    python -m diffusion_models_collection_tpu_torch.train \\
        --config configs/cifar10_unet.py [--device cuda|cpu]

Counterpart of the repository's `train.py` for the diffusion denoisers this
port has (the UNet, the DiT and the DiM: `configs/cifar10_unet.py`,
`configs/cifar10_dit.py`, `configs/cifar10_dim.py`) under the config's
process (DDPM's objective, or `diffusion_type: 'flow_matching'` or
`'edm'`), in pixel space or, with `latent_diffusion: true`, in the latent
space of a trained VAE (`configs/cifar10_latent_unet.py`), or as an SR3
super-resolution stage (a `super_resolution` block,
`configs/celeba64_sr_unet.py`: each batch conditions on its own area
downsample); for that VAE itself (`model_type: 'vae'`,
`configs/cifar10_vae.py`, `VAETrainer`); for the noise-conditional
classifier of classifier guidance (`model_type: 'classifier'`,
`configs/cifar10_classifier.py`, `ClassifierTrainer`); and consistency
training from scratch (`diffusion_type: 'consistency'`,
`ConsistencyTrainingTrainer`; consistency and progressive distillation of a
trained checkpoint are `tools/distill.py`'s, reflow `tools/reflow.py`'s):
one process on one device, or one process a device under torchrun:

    torchrun --nproc_per_node N \
        -m diffusion_models_collection_tpu_torch.train \
        --config configs/cifar10_dit.py

joins a process group (NCCL on `cuda:LOCAL_RANK`; gloo with `--device
cpu`) and trains data parallel, or with the config's `tensor_parallel: k`
(DiT, DiM) and `fsdp: true` (`fsdp_min_size`) on a (N / k data, k model)
mesh, or with `sequence_parallel: S` (DiT, DiM; with `tensor_parallel` too)
on a (N / (S k) data, S seq, k model) mesh, or with `pipeline_parallel: S`
(DiT, DiM; the DiT with `tensor_parallel` too; `pp_microbatches`) on a (N /
(S k) data, S stage, k model) mesh, or with `expert_parallel: E` (a MoE
DiT) on a (N / E data, E expert) mesh (`parallel/`). `batch_size` is the
global batch, as in the JAX package: each of the dp = N / (S k)
data-parallel ranks (every rank under expert parallelism) loads its
strided shard of every epoch in batches of `max(1, batch_size // dp)` (a
model group, its seq, stage and model ranks, shares one), and rank 0
prints and writes. The seed
(`config["seed"]`) seeds the weight init, the dropout masks and the
trainer's generator for t, noise and the CFG label dropout, alike on every
rank (Python's and numpy's generators take seed + rank, as the JAX CLI's
host seed). `--device` defaults to `cuda` and fails when CUDA is absent;
the CPU runs only when asked for with `--device cpu`. The model computes in
the config's `mixed_precision` (float32, or 'bf16': bfloat16 convs, linears and
activations while the weights, the optimizer state, the EMA and the loss stay
float32); on CUDA, TF32 is switched off for matrix products and
convolutions.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch
import torch.distributed as dist

from .factory import get_dataloader, get_dataset, get_diffusion, get_model
from .parallel.mesh import (init_process_group, local_device, process_count,
                            process_index)
from .utils.helpers import (format_duration, load_config, resolve_device,
                            resolve_image_size, set_seed)
from .utils.classifier_trainer import ClassifierTrainer
from .utils.consistency_trainer import ConsistencyTrainingTrainer
from .utils.trainer import DiffusionTrainer
from .utils.vae_trainer import VAETrainer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train diffusion models (PyTorch port)")
    parser.add_argument("--config", type=str, required=True,
                        help="Path to config file")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default), cuda:N or cpu")
    return parser


def main(argv=None):
    """Run the CLI; returns the trainer after its last epoch."""
    args = build_parser().parse_args(argv)
    device = local_device(resolve_device(args.device, "train"))
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)  # this rank's card under torchrun
    init_process_group(device)  # under torchrun; else one process
    rank, world = process_index(), process_count()
    say = print if rank == 0 else (lambda *a: None)
    config = load_config(Path(args.config))
    config["image_size"] = resolve_image_size(config["image_size"])
    model_type = str(config.get("model_type", "")).lower()
    generator = set_seed(config.get("seed", 42), device, process_offset=rank)
    say(f"Device: {device}" + (f" ({world} processes)" if world > 1 else ""))

    say("Creating model...")
    model = get_model(config)

    say("Loading dataset...")
    train_dataset = get_dataset(config, train=True)
    # a model group (its tensor-parallel, sequence-parallel and pipeline
    # ranks) shares one shard of the data; `batch_size` is the global batch
    # (an expert-parallel rank loads its own shard)
    group = (int(config.get("tensor_parallel", 1) or 1)
             * int(config.get("sequence_parallel", 1) or 1)
             * int(config.get("pipeline_parallel", 1) or 1))
    train_loader = get_dataloader(config, train_dataset, train=True,
                                  seed=config.get("seed", 42),
                                  process_index=rank // group,
                                  process_count=max(1, world // group))

    if model_type == "vae":
        # stage 1 of latent diffusion: the KL-VAE alone; diffusion configs
        # then point `vae_checkpoint` at its checkpoint
        trainer = VAETrainer(model=model, train_loader=train_loader,
                             config=config, device=device,
                             generator=generator,
                             resume_path=config.get("resume_path"))
        trainer.train()
        return trainer
    if model_type == "classifier":
        # the guidance classifier; `sample --classifier_checkpoint` reads
        # its checkpoint
        trainer = ClassifierTrainer(model=model, train_loader=train_loader,
                                    config=config, device=device,
                                    generator=generator,
                                    resume_path=config.get("resume_path"))
        trainer.train()
        return trainer
    if str(config.get("diffusion_type", "ddpm")).lower() == "consistency":
        # teacher-free (Song et al. 2023 Alg. 3); distilling a trained
        # checkpoint is tools/distill.py's
        trainer = ConsistencyTrainingTrainer(
            model=model, train_loader=train_loader, config=config,
            device=device, generator=generator,
            resume_path=config.get("resume_path"))
        trainer.train()
        return trainer

    trainer = DiffusionTrainer(
        model=model,
        # DDPM's objective, or the flow-matching or EDM process that the
        # config's diffusion_type names
        diffusion=get_diffusion(config),
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
    if process_index() == 0:
        print(f"Total training time: "
              f"{format_duration(time.time() - start_time)}")
    if dist.is_initialized():
        dist.destroy_process_group()
