"""Dry run of the port's parallel training on several processes.

    python -m diffusion_models_collection_tpu_torch.tools.dryrun_multichip \\
        [N] [--device cpu]

Counterpart of the data- and model-parallel legs of the repository's
`__graft_entry__.py` dry run, for the layouts of this port's parallel slice,
each through `DiffusionTrainer` as `train` builds it, on tiny models and
synthetic data, three epochs each, with dropout 0.1 on (the masks are keyed
on the global batch and head, so the layouts must agree exactly):

* unet DP: N data-parallel ranks against one process fed the same global
  batches (each rank's batch, in rank order);
* unet DP sample: the in-training CFG grid of that DP trainer (2N images,
  each model call's rows split over the ranks, `parallel/data_parallel.py`)
  against the one process's grid;
* dit TP and dim TP: (N/2 data, 2 model) against their N-rank DP twins;
* dit FSDP: N ranks of ZeRO-3 against the DP twin;
* dit hybrid FSDPxTP: (N/2 data, 2 model), ZeRO over 'data' (N >= 4);
* dit SP: (N/2 data, 2 seq) against the DP twin;
* dim SP distributed scan: (N/2 data, 2 seq) at 16x16 (16 tokens: 8 a rank,
  at least the conv's halo) against its 16x16 DP twin;
* dim SPxTP: (N/4 data, 2 seq, 2 model) at 16x16 against the same twin
  (N >= 4);
* dit PP and dim PP: GPipe over (N/2 data, 2 stage), two microbatches a
  data rank, against their DP twins;
* dit PPxTP: (N/4 data, 2 stage, 2 model) against the DiT's DP twin (N >=
  4);
* dit-moe EP: a MoE DiT (4 experts, top 2) over (N/2 data, 2 expert)
  against its N-rank DP twin.

Each leg prints `dryrun_multichip(N): OK, <leg> loss=... (dp ref ...)`, or
the script raises. The ranks are processes joined in a gloo group on a
`FileStore` in a temporary directory (`launch`, which the tests use too);
`--device cuda` puts every rank's tensors on the one card (gloo carries
them).
"""

from __future__ import annotations

import argparse
import faulthandler
import importlib
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TINY_MODEL_PARAMS = {
    "unet": {"in_channels": 3, "model_channels": 16, "out_channels": 3,
             "num_res_blocks": 1, "attention_resolutions": (4,),
             "channel_mult": (1, 2), "dropout": 0.1},
    "dit": {"in_channels": 3, "patch_size": 4, "hidden_size": 32,
            "depth": 2, "num_heads": 4, "dropout": 0.1},
    "dim": {"in_channels": 3, "patch_size": 4, "hidden_size": 64,
            "depth": 2, "state_size": 4, "dropout": 0.1},
    "dit-moe": {"in_channels": 3, "patch_size": 4, "hidden_size": 32,
                "depth": 2, "num_heads": 4, "dropout": 0.1,
                "num_experts": 4, "moe_top_k": 2},
}
SIZE = (8, 8)
# the DiM's sequence-parallel legs: 16 tokens, 8 a seq rank (the conv's halo
# needs 3)
SP_SIZE = (16, 16)
EPOCHS = 3
# the DP-twin bar of the repository's dry run: the last epoch's losses
BAR = 2e-3
# the grid against one process's, max abs on [0, 1]: the trained weights
# differ by float noise of three epochs
SAMPLE_BAR = 1e-4


def _child(rank: int, world: int, store_path: str, device: str,
           backend: str, target: str, args: tuple, out_dir: str) -> None:
    """One rank: join the group, run `target(*args)`, save its result (or
    its traceback) as `out_dir/rank<r>.pt`."""
    from ..parallel.mesh import init_process_group

    faulthandler.enable()  # a crashing rank prints its stack
    if device == "cpu":
        torch.set_num_threads(1)
    out = Path(out_dir) / f"rank{rank}.pt"
    try:
        store = dist.FileStore(store_path, world)
        init_process_group(torch.device(device), rank=rank, world_size=world,
                           store=store, backend=backend)
        module, name = target.rsplit(".", 1)
        result = getattr(importlib.import_module(module), name)(*args)
        dist.barrier()
        dist.destroy_process_group()
        torch.save({"result": result}, out)
    except BaseException:  # noqa: BLE001 - reported to the parent
        torch.save({"error": traceback.format_exc()}, out)
        raise


def launch(world: int, target: str, *args, device: str = "cpu",
           backend: str = "gloo", timeout: float = 600.0,
           exit_codes: Optional[list] = None) -> List:
    """Run `target(*args)` (a function named `module.name`, imported in each
    child) in `world` fresh processes joined in one process group, and
    return each rank's result in rank order. A rank that raises, dies or
    outlives `timeout` fails the launch, and every process is stopped.
    `exit_codes`, a list, receives each process's exit code in rank
    order."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dmc_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_child, args=(
            rank, world, store, device, backend, target, args, tmp))
            for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if exit_codes is not None:
            exit_codes.extend(p.exitcode for p in procs)
        results = []
        for rank, p in enumerate(procs):
            path = Path(tmp) / f"rank{rank}.pt"
            if not path.exists():
                raise RuntimeError(f"rank {rank} of {target} ended with "
                                   f"exit code {p.exitcode} and no result")
            payload = torch.load(path, weights_only=False)
            if "error" in payload:
                raise RuntimeError(f"rank {rank} of {target} failed:\n"
                                   f"{payload['error']}")
            results.append(payload["result"])
        return results


# ------------------------------------------------------------------ legs
def tiny_config(model_type: str, batch: int, save_dir: str,
                size=SIZE, **overrides) -> dict:
    """The dry run's config: `batch` images a step (the global batch, split
    over the data-parallel ranks)."""
    return {
        "model_type": model_type.split("-")[0],
        "model_params": dict(TINY_MODEL_PARAMS[model_type]),
        "image_size": size, "conditional": True, "num_classes": 10,
        "num_timesteps": 10, "beta_start": 1e-4, "beta_end": 0.02,
        "beta_schedule": "linear", "loss_type": "l2", "epochs": EPOCHS,
        "batch_size": batch, "optimizer": "adamw", "learning_rate": 1e-3,
        "weight_decay": 1e-4, "gradient_accumulation_steps": 1,
        "use_ema": True, "ema_decay": 0.99, "cfg_dropout_prob": 0.2,
        "use_scheduler": False, "fsdp_min_size": 512,
        "save_dir": os.path.join(save_dir, "ckpt"),
        "sample_dir": os.path.join(save_dir, "samples"),
        "sample_interval": 1000, "sample_start_epoch": 1000, "seed": 0,
        "use_swanlab": False, "progress": False, **overrides,
    }


def global_loader(global_batch: int, size=SIZE):
    """The synthetic data in global batches of `global_batch` (two a
    epoch), the same whatever the layout."""
    from ..datasets import DataLoader, DiffusionDataset, ImageTransform

    ds = DiffusionDataset("synthetic", conditional=True,
                          transform=ImageTransform(size, train=True),
                          image_size=size, n_train=2 * global_batch, seed=7)
    return DataLoader(ds, batch_size=global_batch, seed=0, prefetch=0)


class RowsLoader:
    """A data-parallel rank's rows (block `index` of `count`) of each batch
    of `loader`, so every layout trains on the same global batches."""

    def __init__(self, loader, index: int, count: int):
        self.loader, self.index, self.count = loader, index, count

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        for images, labels in self.loader:
            n = len(images) // self.count
            rows = slice(self.index * n, (self.index + 1) * n)
            yield images[rows], labels[rows]


def make_trainer(config: dict, device: str, global_batch: int):
    """`DiffusionTrainer` on `config`'s tiny model, seeded as `train` seeds
    it, on this rank's rows of the global batches."""
    from ..factory import get_diffusion, get_model
    from ..parallel.mesh import process_count, process_index
    from ..utils.helpers import set_seed
    from ..utils.tracker import NullTracker
    from ..utils.trainer import DiffusionTrainer

    group = (int(config.get("tensor_parallel", 1))
             * int(config.get("sequence_parallel", 1))
             * int(config.get("pipeline_parallel", 1)))
    dp = process_count() // group
    generator = set_seed(config["seed"], device)
    model = get_model(config)
    loader = RowsLoader(global_loader(global_batch, config["image_size"]),
                        process_index() // group, dp)
    return DiffusionTrainer(model, get_diffusion(config), loader, config,
                            device, generator=generator,
                            tracker=NullTracker())


def leg_losses(model_type: str, overrides: dict, device: str,
               global_batch: int, size=SIZE, sample: int = 0) -> dict:
    """(In each rank, or alone.) The per-epoch losses of a trainer of
    `overrides`, the share of its parameters' elements FSDP shards, and
    with `sample` its in-training grid of that many images."""
    from ..parallel.fsdp import sharded_fraction

    with tempfile.TemporaryDirectory() as tmp:
        config = tiny_config(model_type, global_batch, tmp, size,
                             **overrides)
        trainer = make_trainer(config, device, global_batch)
        losses = [trainer.train_epoch(e) for e in range(1, EPOCHS + 1)]
        return {"losses": losses,
                "sharded": sharded_fraction(trainer.model),
                "samples": (trainer.sample_images(EPOCHS, sample)
                            if sample else None)}


def all_legs(world: int, device: str) -> dict:
    """(In each rank.) Every leg of the dry run at this world size."""
    batch = 2 * world
    out = {"unet DP": leg_losses("unet", {}, device, batch, sample=batch)}
    for model_type in ("dit", "dim"):
        out[f"{model_type} DP"] = leg_losses(model_type, {}, device, batch)
        if world % 2 == 0:
            out[f"{model_type} TP"] = leg_losses(
                model_type, {"tensor_parallel": 2}, device, batch)
    out["dit FSDP"] = leg_losses("dit", {"fsdp": True}, device, batch)
    if world % 4 == 0:
        out["dit hybrid FSDPxTP"] = leg_losses(
            "dit", {"fsdp": True, "tensor_parallel": 2}, device, batch)
    if world % 2 == 0:
        sp = {"sequence_parallel": 2}
        out["dit SP"] = leg_losses("dit", sp, device, batch)
        out["dim 16x16 DP"] = leg_losses("dim", {}, device, batch, SP_SIZE)
        out["dim SP distributed scan"] = leg_losses("dim", sp, device, batch,
                                                    SP_SIZE)
    if world % 4 == 0:
        out["dim SPxTP"] = leg_losses(
            "dim", {"sequence_parallel": 2, "tensor_parallel": 2}, device,
            batch, SP_SIZE)
    if world % 2 == 0:
        pp = {"pipeline_parallel": 2}
        out["dit PP"] = leg_losses("dit", pp, device, batch)
        out["dim PP"] = leg_losses("dim", pp, device, batch)
        out["dit-moe DP"] = leg_losses("dit-moe", {}, device, batch)
        out["dit-moe EP"] = leg_losses("dit-moe", {"expert_parallel": 2},
                                       device, batch)
    if world % 4 == 0:
        out["dit PPxTP"] = leg_losses(
            "dit", {"pipeline_parallel": 2, "tensor_parallel": 2}, device,
            batch)
    return out


def _check(name: str, losses, ref, world: int, what: str) -> None:
    loss, want = losses[-1], ref[-1]
    if not (np.isfinite(losses).all() and loss > 1e-3):
        raise AssertionError(f"{name}: degenerate losses {losses}")
    if abs(loss - want) > BAR * max(1.0, abs(want)):
        raise AssertionError(f"{name}: losses {losses} != {what} {ref}")
    print(f"dryrun_multichip({world}): OK, {name} loss={loss:.4f} "
          f"({what} {want:.4f})")


def dryrun(world: int = 4, device: str = "cpu") -> dict:
    """Run every leg at `world` ranks; raise on a disagreement. Returns the
    legs' losses."""
    start = time.perf_counter()
    legs = launch(world, f"{__name__}.all_legs", world, device,
                  device=device)[0]
    # the one-process reference: the same global batches, no group
    one = leg_losses("unet", {}, device, 2 * world, sample=2 * world)
    ref = one["losses"]
    _check("unet DP", legs["unet DP"]["losses"], ref, world,
           "1-process ref")
    grid, grid_ref = legs["unet DP"]["samples"], one["samples"]
    err = float(np.abs(grid - grid_ref).max())
    if grid.shape != grid_ref.shape or not err <= SAMPLE_BAR:
        raise AssertionError(f"unet DP sample: the grid {grid.shape} is "
                             f"{err} from the 1-process grid")
    print(f"dryrun_multichip({world}): OK, unet DP sample "
          f"{grid.shape[0]} images within {err:.2e} of the 1-process ref")
    twins = {"dim SP distributed scan": "dim 16x16 DP",
             "dim SPxTP": "dim 16x16 DP"}
    for name in ("dit TP", "dim TP", "dit FSDP", "dit hybrid FSDPxTP",
                 "dit SP", "dim SP distributed scan", "dim SPxTP", "dit PP",
                 "dit PPxTP", "dim PP", "dit-moe EP"):
        if name not in legs:
            continue
        twin = legs[twins.get(name, f"{name.split()[0]} DP")]["losses"]
        extra = ""
        if "FSDP" in name:
            extra = f" ({legs[name]['sharded']:.0%} param mass sharded)"
        _check(name + extra, legs[name]["losses"], twin, world, "dp ref")
    print(f"dryrun_multichip({world}): {time.perf_counter() - start:.1f}s")
    legs["unet 1-process"] = one
    return legs


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("world", nargs="?", type=int, default=4)
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args(argv)
    dryrun(args.world, args.device)


if __name__ == "__main__":
    sys.exit(main())
