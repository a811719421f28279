"""What the parallel tests run in each rank of a gloo world of processes
(`tools/dryrun_multichip.launch`), and alone in the test process for the
one-device reference. It imports no JAX: the ranks must not.

A job is a dict: the trainer (`kind`: 'diffusion', 'vae', 'classifier' or
'consistency'),
its config, the full weights (numpy, by state-dict name), the global
batches with their draws (numpy), the torch seed of the dropout masks, and
what to return. Every rank trains on its rows of each global batch and its
draws; the result (from rank 0) holds the loss of each step (the mean over
'data'), the gradients of each update gathered to the full parameters
before the clip, the full parameters, EMA and optimizer state after the
steps, the local shapes and sharded share of the parameters, every rank's
parameter names, and with `sample` an in-training grid of that many
images.
"""

import copy

import numpy as np
import torch

from diffusion_models_collection_tpu_torch.diffusion import DDPM
from diffusion_models_collection_tpu_torch.factory import get_model
from diffusion_models_collection_tpu_torch.parallel.fsdp import (
    local,
    sharded_fraction,
)
from diffusion_models_collection_tpu_torch.parallel.mesh import process_index
from diffusion_models_collection_tpu_torch.utils.classifier_trainer import (
    ClassifierTrainer,
)
from diffusion_models_collection_tpu_torch.utils.consistency_trainer import (
    ConsistencyTrainingTrainer,
)
from diffusion_models_collection_tpu_torch.utils.tracker import NullTracker
from diffusion_models_collection_tpu_torch.utils.trainer import (
    DiffusionTrainer,
)
from diffusion_models_collection_tpu_torch.utils.vae_trainer import VAETrainer


def build_trainer(job):
    config = copy.deepcopy(job["config"])
    model = get_model(config)
    if job.get("state") is not None:
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in job["state"].items()})
    kind = job.get("kind", "diffusion")
    loader = [None] * max(1, len(job.get("batches", ())))
    common = dict(train_loader=loader, config=config, device="cpu",
                  tracker=NullTracker(),
                  resume_path=config.get("resume_path"))
    if kind == "vae":
        return VAETrainer(model=model, **common)
    if kind == "classifier":
        return ClassifierTrainer(model=model, **common)
    if kind == "consistency":
        return ConsistencyTrainingTrainer(model=model, **common)
    return DiffusionTrainer(model, DDPM(num_timesteps=config.get(
        "num_timesteps", 1000)), **common)


def record_gradients(trainer, store):
    """Append to `store`, at every update, the full gradients (gathered,
    before the clip) of `trainer.model`, by name."""
    plan = trainer.plan
    before = plan.average_replicated_grads

    def hook():
        before()
        store.append(plan.full_gradients(trainer.model))

    plan.average_replicated_grads = hook


def step(trainer, kind, batch):
    lay = trainer.plan.layout
    b = {k: lay.rows(torch.as_tensor(v)) for k, v in batch.items()}
    if kind == "vae":
        return trainer.train_step(b["x0"], None, b["noise"])[0]
    if kind == "classifier":
        return trainer.train_step(b["x0"], b["labels"], b["t"],
                                  b["noise"])[0]
    if kind == "consistency":  # t picks the grid pair
        return trainer.train_step(b["x0"], b["labels"],
                                  b["t"] % len(trainer.grid[0]), b["noise"],
                                  b.get("drop"))
    return trainer.train_step(b["x0"], b["labels"], b["t"], b["noise"],
                              b.get("drop"))


def train_job(job):
    """Run `job` (see the module docstring); rank 0's result, None on the
    other ranks."""
    torch.manual_seed(job.get("seed", 0))
    trainer = build_trainer(job)
    kind = job.get("kind", "diffusion")
    grads = []
    record_gradients(trainer, grads)
    lay = trainer.plan.layout
    loaded = (trainer.plan.full_state_dict(trainer.model)
              if job["config"].get("resume_path") else None)
    losses = []
    for batch in job.get("batches", ()):
        loss = step(trainer, kind, batch)
        losses.append(float(lay.mean_over_data(loss)))
    if job.get("save"):
        trainer.save_checkpoint(epoch=1, is_last=True)
    samples = (trainer.sample_images(1, job["sample"]) if job.get("sample")
               else None)
    result = {
        "losses": losses,
        "grads": grads,
        "params": trainer.plan.full_state_dict(trainer.model),
        "ema": (trainer.plan.full_state_dict(trainer.ema_model)
                if trainer.ema_model is not None else None),
        "opt": trainer.optimizer.state_dict(),
        "loaded": loaded,
        "sharded": sharded_fraction(trainer.model),
        "local_shapes": {n: tuple(local(p).shape)
                         for n, p in trainer.model.named_parameters()},
        "dtensor_states": sum(hasattr(v, "placements")
                              for s in trainer.optimizer.inner.state.values()
                              for v in s.values()),
        "names_by_rank": names_by_rank(trainer.model),
        "samples": samples,
    }
    return result if process_index() == 0 else None


def names_by_rank(model):
    """Every rank's parameter names, in rank order (a collective in a
    world; this process's alone without one)."""
    import torch.distributed as dist

    names = [n for n, _ in model.named_parameters()]
    if not dist.is_initialized():
        return [names]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, names)
    return out


def scan_job(job):
    """The distributed scan (`parallel/dim_sequence_parallel.py`) over
    groups of `job["sp"]` consecutive ranks, each group on the whole
    sequence of `job`'s numpy inputs (x, dt, A, B, C, D) with the cotangent
    `gy` of y: (y, and the gradients of x, dt, A, B, C, D), whole, from rank
    0."""
    import torch.distributed as dist

    from diffusion_models_collection_tpu_torch.parallel.dim_sequence_parallel \
        import distributed_selective_scan
    from diffusion_models_collection_tpu_torch.parallel.sequence_parallel \
        import SeqGroup

    sp, rank = job["sp"], process_index()
    groups = [dist.new_group(list(range(i, i + sp)))
              for i in range(0, dist.get_world_size(), sp)]
    seq = SeqGroup(groups[rank // sp], rank % sp, sp)
    n = job["x"].shape[1] // sp
    cut = slice(seq.rank * n, (seq.rank + 1) * n)
    args = {k: torch.tensor(job[k][:, cut] if k in ("x", "dt", "B", "C")
                            else job[k], requires_grad=True)
            for k in ("x", "dt", "A", "B", "C", "D")}
    y = distributed_selective_scan(*args.values(), seq=seq)
    (y * torch.as_tensor(job["gy"][:, cut])).sum().backward()
    out = {"y": y.detach()}
    for k, v in args.items():
        g = v.grad.contiguous()
        if k in ("A", "D"):  # a rank's tokens' share: summed over 'seq'
            dist.all_reduce(g, group=seq.group)
            out[k] = g
        else:
            parts = [torch.empty_like(g) for _ in range(sp)]
            dist.all_gather(parts, g, group=seq.group)
            out[k] = torch.cat(parts, 1)
    parts = [torch.empty_like(out["y"]) for _ in range(sp)]
    dist.all_gather(parts, out["y"], group=seq.group)
    out["y"] = torch.cat(parts, 1)
    return {k: v.numpy() for k, v in out.items()}


def cli_job(config_paths):
    """The port's `train` CLI (`train.main`, on the CPU) on each config file
    in turn, in a rank of a world: each run's loader batch, batches an epoch,
    steps taken and data-parallel ranks, from this rank."""
    from diffusion_models_collection_tpu_torch import train

    out = []
    for path in config_paths:
        trainer = train.main(["--config", path, "--device", "cpu"])
        loader = trainer.train_loader
        out.append(dict(batch=loader.batch_size, batches=len(loader),
                        steps=trainer.global_step,
                        dp=trainer.plan.layout.dp))
    return out


def run_jobs(jobs):
    """Every job in turn (one world of processes serves a test file): a
    train job, or a distributed-scan job (`kind` 'scan')."""
    return [scan_job(job) if job.get("kind") == "scan" else train_job(job)
            for job in jobs]


def batches(seed, n, shape, num_classes=10, num_timesteps=1000,
            latent=None):
    """`n` global batches of `shape` (B, H, W, C): x0 in [-1, 1], labels,
    t, noise (of `latent`'s shape when given, the VAE's posterior draw) and
    the CFG drop mask, numpy from one seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append(dict(
            x0=rng.uniform(-1, 1, shape).astype(np.float32),
            labels=rng.integers(0, num_classes, shape[0]).astype(np.int64),
            t=rng.integers(0, num_timesteps, shape[0]).astype(np.int64),
            noise=rng.standard_normal(latent or shape).astype(np.float32),
            drop=rng.uniform(size=shape[0]) < 0.3))
    return out
