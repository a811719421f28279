"""What `test_torch_port_data_parallel.py` runs in each rank of a gloo world
of processes (`tools/dryrun_multichip.launch`), and alone in the test
process for the one-process reference. It imports no JAX: the ranks must
not.

A job is a dict with its `kind` (a key of `JOBS`). The entry points run as
a user runs them under torchrun: `sample.main`, `evaluate.main`,
`tools.distill.main` and `tools.reflow.main` with `--device cpu`; each rank
is given its own output directory (`rank<r>` under the job's `out`), so
the test can see that rank 0 alone wrote.
"""

import contextlib
import copy
import json
from pathlib import Path

import numpy as np
import torch
from threadpoolctl import threadpool_limits

from diffusion_models_collection_tpu_torch.diffusion import (
    DDIM,
    NoiseSchedule,
)
from diffusion_models_collection_tpu_torch.factory import get_model
from diffusion_models_collection_tpu_torch.parallel.data_parallel import (
    DataParallelApply,
)
from diffusion_models_collection_tpu_torch.parallel.mesh import (
    data_layout,
    process_index,
)


class Blocks:
    """`fn` with each call whose rows divide by `world` run on `world`
    contiguous row blocks in turn, in this process, the outputs
    concatenated: the float work of a world of `world` ranks (x, t, y and
    keyword tensors of the call's batch cut, as `DataParallelApply` cuts
    them)."""

    def __init__(self, fn, world):
        self.fn, self.world = fn, world

    def __call__(self, *args, **kw):
        rows = args[0].shape[0]
        if rows % self.world:
            return self.fn(*args, **kw)
        n = rows // self.world
        outs = []
        for i in range(self.world):
            def cut(a):
                return (a[i * n:(i + 1) * n] if torch.is_tensor(a)
                        and a.dim() > 0 and a.shape[0] == rows else a)
            with torch.no_grad():
                outs.append(self.fn(*map(cut, args),
                                    **{k: cut(v) for k, v in kw.items()}))
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts) for parts in zip(*outs))
        return torch.cat(outs)


@contextlib.contextmanager
def rows_in_blocks(world):
    """Within it, this process splits as a world of `world` ranks would, on
    its own: `sample`'s, `evaluate`'s and `serve`'s model calls, a
    trainer's grid, the metric networks' batches and `serve`'s latent
    decode each on the ranks' row blocks in turn."""
    from diffusion_models_collection_tpu_torch import (
        evaluate,
        pipeline,
        serve,
    )
    from diffusion_models_collection_tpu_torch.metrics import (
        inception,
        lpips_score,
    )
    from diffusion_models_collection_tpu_torch.parallel.plan import (
        ParallelPlan,
    )

    saved = [(obj, name, getattr(obj, name)) for obj, name in (
        (pipeline, "split_model_calls"), (evaluate, "split_model_calls"),
        (serve, "split_model_calls"), (inception, "gather_rows"),
        (lpips_score, "gather_rows"), (serve, "gather_rows"),
        (ParallelPlan, "forward_fn"))]
    pipeline.split_model_calls = evaluate.split_model_calls = (
        serve.split_model_calls) = lambda model, layout: Blocks(model, world)
    inception.gather_rows = lpips_score.gather_rows = serve.gather_rows = (
        lambda fn, layout, *batches: Blocks(fn, world)(*batches))
    ParallelPlan.forward_fn = lambda self, module: Blocks(module, world)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def rank_dir(out) -> Path:
    return Path(out) / f"rank{process_index()}"


def numpy_state(module):
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def apply_job(job):
    """`DataParallelApply` around a recording stand-in model: the rows this
    rank's model saw and the gathered output of a call at `rows` rows, with
    a keyword tensor of the call's batch, a plain keyword, and a tuple
    output whose second part stays this rank's."""
    layout, seen = data_layout(), []

    def fn(x, t, y=None, extra=None, *, scale=1.0, bias=None, full=False):
        seen.append(x[:, 0].tolist())
        out = x * scale + t[:, None] + y[:, None] + bias
        return (out, x[:, :1] + 100.0) if full else out

    apply = DataParallelApply(fn, layout)
    out = {}
    for rows in job["rows"]:
        x = torch.arange(rows * 3, dtype=torch.float32).reshape(rows, 3)
        t = torch.arange(rows, dtype=torch.float32) * 10
        y = torch.arange(rows, dtype=torch.float32) * 100
        bias = torch.arange(rows, dtype=torch.float32)[:, None] * 1000
        seen.clear()
        eps = apply(x, t, y, scale=2.0, bias=bias)
        got, cache = apply(x, t, y, "extra", scale=2.0, bias=bias, full=True)
        out[rows] = {"seen": [list(s) for s in seen], "eps": eps.numpy(),
                     "tuple": got.numpy(), "cache": cache.numpy(),
                     "want": (x * 2.0 + t[:, None] + y[:, None]
                              + bias).numpy()}
    return out


def sample_job(job):
    """`sample.main` on `job["argv"]`, this rank's output directory: the
    samples."""
    from diffusion_models_collection_tpu_torch import sample

    argv = job["argv"] + ["--device", "cpu", "--output_dir",
                          str(rank_dir(job["out"]))]
    return sample.main(argv)["samples"]


def noise_job(job):
    """DDIM-10 with CFG 3 of `job`'s UNet weights from its explicit initial
    noise, each model call through `DataParallelApply`."""
    model = get_model(copy.deepcopy(job["config"]))
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in job["state"].items()})
    apply = DataParallelApply(model.eval(), data_layout())
    ddim = DDIM(num_timesteps=1000, num_inference_steps=10)
    noise = torch.as_tensor(job["noise"])
    return ddim.sample_with_cfg(apply, noise.shape,
                                torch.as_tensor(job["labels"]),
                                cfg_scale=3.0, init_noise=noise).numpy()


def evaluate_job(job):
    """`evaluate.main` on `job["argv"]` (one BLAS thread: FID's sqrtm),
    this rank's JSON and image folder: the report."""
    from diffusion_models_collection_tpu_torch import evaluate

    out = rank_dir(job["out"])
    argv = job["argv"] + ["--device", "cpu", "--output",
                          f"{out}_metrics.json", "--save_images_dir",
                          str(out)]
    with threadpool_limits(1):
        return evaluate.main(argv)


def inception_job(job):
    """InceptionV3's features and logits of `job["images"]` with the
    weights of `job["weights"]`."""
    from diffusion_models_collection_tpu_torch.metrics.inception import (
        InceptionFeatures,
    )

    feats, logits = InceptionFeatures(job["weights"])(job["images"])
    return feats.numpy(), logits.numpy()


def grid_job(job):
    """A DDP trainer's steps and in-training grid (`torch_parallel_jobs`),
    the grid and the losses."""
    from torch_parallel_jobs import train_job

    result = train_job(job)
    return None if result is None else {
        "samples": result["samples"], "losses": result["losses"]}


def recording(fn):
    """`fn()` with every few-step epoch's mean loss (over 'data') and every
    update's gradients (by name, before the clip; DDP's average over
    'data') recorded: (its result, the losses, the gradients)."""
    from diffusion_models_collection_tpu_torch.utils.fewstep import (
        FewStepTrainer,
    )
    from diffusion_models_collection_tpu_torch.utils.trainer import Optimizer

    losses, grads = [], []
    run_epoch, step = FewStepTrainer.run_epoch, Optimizer.step

    def recording_epoch(self, *args, **kwargs):
        losses.append(run_epoch(self, *args, **kwargs))
        return losses[-1]

    def recording_step(self):
        if self.mini_step + 1 >= self.accum:
            grads.append({self.plan.names[id(p)]: p.grad.detach().clone()
                          for p in self.params if p.grad is not None})
        return step(self)

    FewStepTrainer.run_epoch, Optimizer.step = recording_epoch, recording_step
    try:
        return fn(), losses, grads
    finally:
        FewStepTrainer.run_epoch, Optimizer.step = run_epoch, step


class RankOrder:
    """The loaders of every rank's shard as one loader of the global
    batches, each the ranks' batches concatenated in rank order: what a
    data-parallel run of `tools.distill` trains on, for one process."""

    def __init__(self, loaders):
        self.loaders = loaders

    def set_epoch(self, epoch: int) -> None:
        for loader in self.loaders:
            loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loaders[0])

    def __iter__(self):
        for parts in zip(*self.loaders):
            yield (np.concatenate([p[0] for p in parts]),
                   np.concatenate([p[1] for p in parts]))


def distill_in_one_process(config, shards):
    """`tools.distill.main`'s run in one process (progressive), fed the
    global batches that `shards` data-parallel ranks load (`RankOrder`)."""
    from diffusion_models_collection_tpu_torch.factory import (
        get_dataloader,
        get_dataset,
    )
    from diffusion_models_collection_tpu_torch.utils.distill_trainer import (
        DistillationTrainer,
    )
    from diffusion_models_collection_tpu_torch.utils.helpers import set_seed

    generator = set_seed(config.get("seed", 42), "cpu")
    dataset = get_dataset(config, train=True)
    loader = RankOrder([get_dataloader(
        config, dataset, train=True, seed=config.get("seed", 42),
        process_index=r, process_count=shards) for r in range(shards)])
    return DistillationTrainer(loader, config, "cpu",
                               generator=generator).distill()


def tool_job(job):
    """`tools.distill.main` or `tools.reflow.main` (`job["tool"]`) on
    `job["config"]` with this rank's `save_dir` (with `job["shards"]`, the
    distillation in one process on that many ranks' global batches): the
    epoch losses, every update's gradients, the student and its EMA, and
    the steps taken."""
    from diffusion_models_collection_tpu_torch.tools import distill, reflow

    out = rank_dir(job["out"])
    config = dict(job["config"], save_dir=str(out))
    if job.get("shards"):
        def run():
            return distill_in_one_process(config, job["shards"])
    else:
        path = Path(f"{out}_config.json")
        path.write_text(json.dumps(config))
        tool = {"distill": distill, "reflow": reflow}[job["tool"]]

        def run():
            return tool.main(["--config", str(path), "--device", "cpu"])
    trainer, losses, grads = recording(run)
    return {"losses": losses, "grads": grads,
            "student": numpy_state(trainer.model),
            "ema": numpy_state(trainer.ema_model),
            "steps": trainer.global_step}


def recorded_step(trainer, step):
    """`step()` (one update) with the gradients before the optimizer runs
    (DDP's average over 'data'): loss over 'data', gradients, student and
    EMA after it."""
    grads, optimizer_step = {}, trainer.optimizer.step

    def recording():
        grads.update({n: p.grad.detach().numpy().copy()
                      for n, p in trainer.model.named_parameters()})
        return optimizer_step()

    trainer.optimizer.step = recording
    loss = float(trainer.plan.layout.mean_over_data(step()))
    return {"loss": loss, "grads": grads,
            "student": numpy_state(trainer.model),
            "ema": numpy_state(trainer.ema_model)}


def step_job(job):
    """One step of `DistillationTrainer` (progressive, 4 steps) or
    `ReflowTrainer` (`job["tool"]`) on `job`'s global batch and draws, the
    schedule's arrays given (the JAX schedule's, so that only the
    arithmetic is compared): `recorded_step`'s result."""
    from diffusion_models_collection_tpu_torch.utils.distill_trainer import (
        DistillationTrainer,
    )
    from diffusion_models_collection_tpu_torch.utils.reflow_trainer import (
        ReflowTrainer,
    )

    b = {k: torch.as_tensor(v) for k, v in job["batch"].items()}
    if job["tool"] == "reflow":
        trainer = ReflowTrainer(job["config"], "cpu")
        trainer.start(trainer.student, 1, 0.9)
        return recorded_step(trainer, lambda: trainer.train_step(
            b["x_hat"], b["z"], b["labels"], b["t"]))
    trainer = DistillationTrainer([None], job["config"], "cpu")
    trainer.start_stage(4)
    trainer.schedule = NoiseSchedule(**{
        k: torch.as_tensor(v) for k, v in job["schedule"].items()})
    rows = trainer.plan.layout.rows
    return recorded_step(trainer, lambda: trainer.train_step(
        rows(b["x0"]), rows(b["labels"]), rows(b["idx"]), rows(b["noise"]),
        rows(b["drop"])))


JOBS = {"apply": apply_job, "sample": sample_job, "noise": noise_job,
        "evaluate": evaluate_job, "inception": inception_job,
        "grid": grid_job, "tool": tool_job, "step": step_job}


def run_jobs(jobs):
    """Every job in turn, in one world of processes (one world serves the
    test file); one BLAS thread a rank."""
    with threadpool_limits(1):
        return [JOBS[job["kind"]](job) for job in jobs]
