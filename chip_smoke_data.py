"""`chip_smoke.py`'s data-parallel phase outside `train`
(`phase_data_parallel`): the port's `parallel/data_parallel.py` on the card
through the entry points a user runs under torchrun, in a gloo world of two
processes on the one card (`tools/dryrun_multichip.py` `launch`; NCCL
refuses two ranks on one device), each path against this process's runs
of the same call: one that runs every model call and metric batch on the
ranks' row blocks in turn (`rows_in_blocks`: the same float work, so the
same result, TOL_IMAGES and TOL_METRICS), and one on whole calls, whose
distance is printed: one UNet call on 16 rows differs from the same call
on 32 by float rounding (cuDNN and cuBLAS pick kernels by the batch;
`check_one_call` holds it to `chip_smoke.TOL_UNET`), which a clamped CFG
trajectory grows step by step.

* `sample.main`: the fp32 UNet of `configs/cifar10_unet.py` (the weights
  `phase_train_main` trained), DDIM-50 with CFG 3, 16 images at batch 16,
  each model call's 32 rows split 16 a rank (K1 and K2 on a rank's rows):
  the images, a rank's K1 and K2 launches equal to one process's on whole
  calls (one model call a step; the row-block run launches twice as
  many), rank 0 alone writing, samples/s of both; then the
  same sampling of 16 images with the all-gather timed (its share of the
  sampling);
* `evaluate.main`: the same checkpoint, 32 images DDIM-20 with CFG 3 at
  batch 16, the metric networks' batches split too, FID's tr sqrtm on the
  card in every run (`chip_smoke.CardFrechet`): every metric, launches
  equal, rank 0 alone writing;
* the in-training grid of a DDP UNet trainer (`parallel/plan.py`
  `forward_fn`): the EMA's DDPM CFG grid of 16 on a 50-step schedule
  (against the row-block run alone), then one step at global batch 32
  (dropout 0.1) against one process's loss;
* `tools.distill` (progressive, 1 stage, 2 epochs of one global batch of
  128 from the fixtures, 64 a rank) and `tools.reflow` (1 round on the
  flow-matching UNet `phase_process` trained: 128 pairs of 10-step Euler
  CFG 3, whole on each rank, then one epoch of 2 steps of 64) against
  one process: the epoch losses within `chip_smoke.TOL_LOSS` and the
  student and its EMA within `chip_smoke.TOL_GRAD` over the elements
  Adam's updates decide (within 2 lr a step elsewhere), a step's launches
  a rank a UNet step's (the distillation's two teacher forwards more),
  rank 0 alone writing. The one-process distillation is fed the global
  batches the two ranks load (each its strided shard of the fixtures, in
  rank order), as DDP trains on them.

Every failure raises; nothing falls back to the CPU or to a plain version.
Alone, after `phase_build` (with a trained UNet and flow UNet `.pth` of
configs/cifar10_unet.py), from a script whose main module is guarded (the
ranks are spawned):

    import torch, chip_smoke as c, chip_smoke_data as d
    if __name__ == "__main__":
        smi = c.device_line(); c.phase_build()
        d.phase_data_parallel(smi, "unet.pth", "flow.pth")
"""

from __future__ import annotations

import contextlib
import json
import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as c
from diffusion_models_collection_tpu_torch import (evaluate, factory,
                                                   pipeline, sample, serve)
from diffusion_models_collection_tpu_torch.metrics import (inception,
                                                           lpips_score)
from diffusion_models_collection_tpu_torch.parallel import data_parallel
from diffusion_models_collection_tpu_torch.parallel.plan import ParallelPlan
from diffusion_models_collection_tpu_torch.parallel.mesh import process_index
from diffusion_models_collection_tpu_torch.tools import distill, reflow
from diffusion_models_collection_tpu_torch.utils.distill_trainer import (
    DistillationTrainer,
)
from diffusion_models_collection_tpu_torch.utils.fewstep import (
    FewStepTrainer,
)
from diffusion_models_collection_tpu_torch.utils.helpers import set_seed
from diffusion_models_collection_tpu_torch.utils.trainer import Optimizer

WORLD = 2
TIMEOUT = 600
# `sample`: one batch, 32 rows a CFG call (32 images, 2 batches, until the
# batched `serve` split's phase came)
SAMPLES, BATCH = 16, 16
# `evaluate`: 2 batches (64 images at 32 until then)
EVAL_SAMPLES, EVAL_BATCH, EVAL_STEPS = 32, 16, 20
GRID_SAMPLES, GRID_TIMESTEPS = 16, 50
GLOBAL_BATCH = 128  # the few-step tools' global batch: 64 rows a rank
DISTILL_EPOCHS = 2
# the split run against one process that runs each model call and metric
# batch on the ranks' row blocks in turn (`rows_in_blocks`): the same float
# work, so the same images (max abs on [0, 1]) and metrics (relative)
TOL_IMAGES = 1e-6
TOL_METRICS = 1e-6


def rank_dir(out) -> Path:
    return Path(out) / f"rank{process_index()}"


def counted(fn):
    """(fn(), its launches, its seconds), synchronised."""
    torch.cuda.synchronize()
    c.reset_launches()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, c.read_launches(), time.perf_counter() - start


def timed_gathers():
    """Time every all-gather of `DataParallelApply` (synchronised); returns
    the list of seconds and a function that restores the gather."""
    seconds, gather = [], data_parallel.gather

    def timed(out, layout):
        torch.cuda.synchronize()
        start = time.perf_counter()
        full = gather(out, layout)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        return full

    data_parallel.gather = timed
    return seconds, lambda: setattr(data_parallel, "gather", gather)


class Blocks:
    """`fn` with each call whose rows divide by WORLD run on WORLD
    contiguous row blocks in turn, in this process, the outputs
    concatenated: the float work of a world of WORLD ranks (x, t, y and
    keyword tensors of the call's batch cut, as `DataParallelApply`
    cuts them)."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args, **kw):
        rows = args[0].shape[0]
        if rows % WORLD:
            return self.fn(*args, **kw)
        n = rows // WORLD
        outs = []
        for i in range(WORLD):
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
def rows_in_blocks():
    """Within it, this process splits as a world of WORLD ranks would, on
    its own: `sample`'s, `evaluate`'s and `serve`'s model calls, the
    trainer's grid, the metric networks' batches and `serve`'s latent
    decode each run on the ranks' row blocks in turn (`Blocks`)."""
    saved = [(pipeline, "split_model_calls"),
             (evaluate, "split_model_calls"), (serve, "split_model_calls"),
             (inception, "gather_rows"), (lpips_score, "gather_rows"),
             (serve, "gather_rows"), (ParallelPlan, "forward_fn")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in saved]
    pipeline.split_model_calls = evaluate.split_model_calls = (
        serve.split_model_calls) = lambda model, layout: Blocks(model)
    inception.gather_rows = lpips_score.gather_rows = serve.gather_rows = (
        lambda fn, layout, *batches: Blocks(fn)(*batches))
    ParallelPlan.forward_fn = lambda self, module: Blocks(module)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def check_one_call(unet_ckpt, smi):
    """One UNet call at a CFG call's 32 rows against the same call on two
    blocks of 16 in turn: what the split alone changes in one model call
    (cuDNN and cuBLAS pick kernels by the batch). Returns its max-rel."""
    payload = torch.load(unet_ckpt, weights_only=True)
    model = factory.load_model_for_inference(payload, payload["config"],
                                             False, torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(2 * BATCH, 32, 32, 3, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (2 * BATCH,), generator=gen, device="cuda")
    y = torch.randint(0, 11, (2 * BATCH,), generator=gen, device="cuda")
    with torch.no_grad():
        rel = c.max_rel(Blocks(model)(x, t, y), model(x, t, y))
    print(f"data parallel: one UNet call on 2 blocks of {BATCH} rows against "
          f"{2 * BATCH} rows: max_rel {rel:.3e} (bar {c.TOL_UNET:g}); on "
          f"{smi}")
    if not rel <= c.TOL_UNET:
        raise AssertionError(f"one call split: max_rel {rel}")
    return rel


# ------------------------------------------------------------ the paths
def run_sample(job):
    """`sample.main` with this rank's output directory: images, launches,
    sampling seconds; with `job["time_gather"]` a second run with every
    all-gather timed."""
    argv = job["argv"] + ["--output_dir", str(rank_dir(job["out"]))]
    result, launches, _ = counted(lambda: sample.main(argv))
    out = {"samples": result["samples"], "launches": launches,
           "seconds": result["sampling_seconds"]}
    if job.get("time_gather"):
        # one batch of BATCH images, every all-gather synchronised
        gathers, restore = timed_gathers()
        timed = argv[:-1] + [argv[-1] + "_timed", "--num_samples",
                             str(BATCH)]
        try:
            again = sample.main(timed)
        finally:
            restore()
        out.update(gather_seconds=sum(gathers), gathers=len(gathers),
                   timed_seconds=again["sampling_seconds"])
    return out


def run_evaluate(job):
    """`evaluate.main` (FID's tr sqrtm on the card) with this rank's JSON
    and image folder: the report, launches and stage seconds."""
    out = rank_dir(job["out"])
    argv = job["argv"] + ["--output", f"{out}_metrics.json",
                          "--save_images_dir", str(out)]
    seconds = {}
    with c.CardFrechet(host=False):
        report, launches, wall = counted(
            lambda: evaluate.main(argv, seconds=seconds))
    return {"report": report, "launches": launches, "seconds": seconds,
            "wall": wall}


def run_grid(job):
    """The in-training grid of a DDP UNet trainer, then one step on the
    global batch (this rank's rows, dropout 0.1 from TRAIN_SEED): the grid,
    its launches and seconds, the loss (mean over 'data')."""
    config = dict(job["config"], sample_dir=str(rank_dir(job["out"])))
    trainer = c.parallel_trainer(config, torch.load(job["state"]))
    lay = trainer.plan.layout
    batch = {k: lay.rows(v.to("cuda"))
             for k, v in torch.load(job["batch"]).items()}
    # the grid of the trainer's starting EMA, then the step: a step's
    # weights differ from one process's by float rounding, which a
    # clamped 50-step trajectory grows
    grid, launches, seconds = counted(
        lambda: trainer.sample_images(1, GRID_SAMPLES))
    torch.manual_seed(c.TRAIN_SEED)
    loss, _ = c.timed_step(trainer, batch)
    return {"loss": float(lay.mean_over_data(loss)), "samples": grid,
            "launches": launches, "seconds": seconds}


def recording(fn, grads=False):
    """`fn()` with every few-step epoch's mean loss recorded (and with
    `grads` every update's gradients, on the host, before the clip): (its
    result, the record with the launches and seconds of the run)."""
    losses, updates = [], []
    run_epoch, step = FewStepTrainer.run_epoch, Optimizer.step

    def recording_epoch(self, *args, **kwargs):
        losses.append(run_epoch(self, *args, **kwargs))
        return losses[-1]

    def recording_step(self):
        updates.append({self.plan.names[id(p)]: p.grad.detach().cpu()
                        for p in self.params if p.grad is not None})
        return step(self)

    FewStepTrainer.run_epoch = recording_epoch
    if grads:
        Optimizer.step = recording_step
    try:
        result, launches, seconds = counted(fn)
    finally:
        FewStepTrainer.run_epoch, Optimizer.step = run_epoch, step
    return result, {"losses": losses, "grads": updates,
                    "launches": launches, "seconds": seconds}


class RankOrder:
    """Every rank's shard loader as one loader of the global batches, each
    the ranks' batches concatenated in rank order."""

    def __init__(self, loaders):
        self.loaders = loaders

    def set_epoch(self, epoch):
        for loader in self.loaders:
            loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loaders[0])

    def __iter__(self):
        for parts in zip(*self.loaders):
            yield (np.concatenate([p[0] for p in parts]),
                   np.concatenate([p[1] for p in parts]))


def distill_one_process(config):
    """`tools.distill.main`'s run in this process, fed the global batches
    WORLD ranks load."""
    generator = set_seed(config.get("seed", 42), "cuda")
    dataset = factory.get_dataset(config, train=True)
    loader = RankOrder([factory.get_dataloader(
        config, dataset, train=True, seed=config.get("seed", 42),
        process_index=r, process_count=WORLD) for r in range(WORLD)])
    return DistillationTrainer(loader, config, "cuda",
                               generator=generator).distill()


def run_tool(job, one_process=False):
    """`tools.distill.main` or `tools.reflow.main` on `job["config"]` with
    this rank's `save_dir`: the epoch losses, launches and seconds, the
    student and its EMA, the steps; with `one_process`, the run in this
    process (the distillation fed the world's global batches) and every
    update's gradients (`check_decided`'s)."""
    out = rank_dir(job["out"])
    config = dict(job["config"], save_dir=str(out))
    if one_process and job["tool"] == "distill":
        trainer, rec = recording(lambda: distill_one_process(config), True)
    else:
        path = Path(f"{out}_config.json")
        path.write_text(json.dumps(config))
        tool = {"distill": distill, "reflow": reflow}[job["tool"]]
        trainer, rec = recording(
            lambda: tool.main(["--config", str(path), "--device", "cuda"]),
            one_process)
    rec.update(steps=trainer.global_step,
               student={k: v.detach().cpu() for k, v in
                        trainer.model.state_dict().items()},
               ema={k: v.detach().cpu() for k, v in
                    trainer.ema_model.state_dict().items()})
    del trainer
    torch.cuda.empty_cache()
    return rec


RUNS = {"sample": run_sample, "evaluate": run_evaluate, "grid": run_grid,
        "tool": run_tool}


def data_rank(jobs):
    """(In each rank of the gloo world.) Every job in turn; rank 0's
    results."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = [RUNS[job["kind"]](job) for job in jobs]
    return out if process_index() == 0 else None


# ------------------------------------------------------------- the checks
def wrote_on_rank_0_alone(label, out, *names):
    missing = [n for n in names if not (Path(out) / "rank0" / n).exists()]
    if missing or (Path(out) / "rank1").exists():
        raise AssertionError(f"{label}: rank 0 did not write {missing}, or "
                             "rank 1 wrote")


def check_decided(label, got, want, grads, steps, lr):
    """The weights after `steps` Adam updates of the world against one
    process's, one vector: TOL_GRAD max-rel over the elements whose
    gradient is decided (at least 1e-3 of its tensor's largest) in every
    update, within 2 lr a step everywhere. Returns the max-rel."""
    ours, refs = [], []
    for name, ref in want.items():
        mine = got[name].to("cuda", torch.float64)
        ref = ref.to("cuda", torch.float64)
        decided = torch.ones_like(ref, dtype=torch.bool)
        for g in grads:
            if name in g:
                mag = g[name].to("cuda").abs()
                decided &= mag >= 1e-3 * mag.max()
        if float((mine - ref).abs().max()) > 2 * lr * steps + 1e-7:
            raise AssertionError(f"{label}: {name} moved over 2 lr a step")
        ours.append(mine[decided])
        refs.append(ref[decided])
    rel = c.max_rel(torch.cat(ours), torch.cat(refs))
    if not rel <= c.TOL_GRAD:
        raise AssertionError(f"{label}: weights max_rel {rel}")
    return rel


def image_err(a, b):
    return float(np.abs(a["samples"] - b["samples"]).max())


def check_sample(got, ref, whole, smi):
    """The world's `sample` against one process on the ranks' row blocks
    (`ref`, TOL_IMAGES) and one process on whole calls (`whole`,
    printed)."""
    err, whole_err = image_err(got, ref), image_err(got, whole)
    print(f"data parallel sample.main: {SAMPLES} images DDIM-{c.STEPS} CFG "
          f"{c.CFG_SCALE} at batch {BATCH}, world {WORLD} (gloo, one card): "
          f"against one process on the ranks' row blocks max_abs {err:.3e} "
          f"(bar {TOL_IMAGES:g}), against one process on whole calls "
          f"{whole_err:.3e}; launches a rank {got['launches']}; "
          f"{SAMPLES / got['seconds']:.2f} samples/s at world {WORLD}, "
          f"{SAMPLES / whole['seconds']:.2f} in one process; the "
          f"all-gathers {got['gather_seconds']:.3f} s of "
          f"{got['timed_seconds']:.3f} s ({got['gathers']} gathers, "
          f"{got['gather_seconds'] / got['timed_seconds']:.3f} of the "
          f"sampling) in a timed run of {BATCH} images; on {smi}")
    calls = SAMPLES // BATCH * c.STEPS
    if not (err <= TOL_IMAGES and got["launches"] == whole["launches"]
            == c.scaled(c.UNET_FORWARD, calls)
            and ref["launches"] == c.scaled(got["launches"], WORLD)
            and got["gathers"] == c.STEPS and np.isfinite(whole_err)):
        raise AssertionError(f"data parallel sample: max_abs {err}, "
                             f"launches {got['launches']}, "
                             f"{ref['launches']}, gathers {got['gathers']}")
    return whole_err


def metric_rel(got, ref):
    return {key: abs(got["report"][key] - want) / max(abs(want), 1e-12)
            for key, want in ref["report"].items()
            if key != "uncalibrated_relative_only"}


def check_evaluate(got, ref, whole, smi):
    """The world's `evaluate` against one process on the ranks' row blocks
    (TOL_METRICS) and on whole calls (printed)."""
    rel, whole_rel = metric_rel(got, ref), metric_rel(got, whole)
    worst = max(rel.values())
    print(f"data parallel evaluate.main: {EVAL_SAMPLES} images DDIM-"
          f"{EVAL_STEPS} CFG {c.CFG_SCALE} at batch {EVAL_BATCH}: every "
          f"metric within {worst:.3e} relative of one process's on the "
          f"ranks' row blocks (bar {TOL_METRICS:g}); of one process's on "
          "whole calls " + ", ".join(f"{k} {v:.2e}"
                                     for k, v in whole_rel.items())
          + f"; launches a rank {got['launches']}; stage seconds world "
          + ", ".join(f"{k} {v:.3f}" for k, v in got["seconds"].items())
          + "; one process " + ", ".join(
              f"{k} {v:.3f}" for k, v in whole["seconds"].items())
          + f"; whole call {got['wall']:.3f} s against {whole['wall']:.3f} "
          f"s; on {smi}")
    if set(got["report"]) != set(ref["report"]) or not worst <= \
            TOL_METRICS or got["launches"] != whole["launches"] or \
            ref["launches"] != c.scaled(got["launches"], WORLD) or not all(
            math.isfinite(v) for k, v in got["report"].items()
            if k != "uncalibrated_relative_only"):
        raise AssertionError(f"data parallel evaluate: {rel}, launches "
                             f"{got['launches']}, {ref['launches']}")
    return max(whole_rel.values())


def check_grid(got, ref, smi):
    """The DDP trainer's grid against one process's on the ranks' row
    blocks (TOL_IMAGES), its step's loss against one process's."""
    loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    err = image_err(got, ref)
    print(f"data parallel in-training grid (DDP UNet, DDPM-{GRID_TIMESTEPS} "
          f"CFG grid of {GRID_SAMPLES}, then one step at global batch "
          f"{c.PARALLEL_BATCH}): grid max_abs {err:.3e} against one process "
          f"on the ranks' row blocks (bar {TOL_IMAGES:g}); step loss "
          f"max_rel {loss_rel:.3e}; grid launches a rank {got['launches']}; "
          f"grid {got['seconds']:.3f} s; on {smi}")
    if not (loss_rel <= c.TOL_LOSS and err <= TOL_IMAGES
            and got["launches"] == c.scaled(c.UNET_FORWARD, GRID_TIMESTEPS)
            and ref["launches"] == c.scaled(got["launches"], WORLD)):
        raise AssertionError(f"data parallel grid: loss {loss_rel}, grid "
                             f"{err}, launches {got['launches']}")


def check_tool(label, got, ref, per_step, lr, smi):
    loss_rel = c.max_rel(torch.tensor(got["losses"]),
                         torch.tensor(ref["losses"]))
    rels = [check_decided(f"{label} {what}", got[what], ref[what],
                          ref["grads"], ref["steps"], lr)
            for what in ("student", "ema")]
    print(f"data parallel {label}: {got['steps']} steps, epoch losses "
          f"{[round(v, 6) for v in got['losses']]} against "
          f"{[round(v, 6) for v in ref['losses']]} (max_rel {loss_rel:.3e}); "
          f"student, EMA max_rel {rels[0]:.3e}, {rels[1]:.3e} over the "
          f"decided elements; launches a rank {got['launches']}; "
          f"{got['seconds']:.3f} s against {ref['seconds']:.3f} s in one "
          f"process; on {smi}")
    if not (got["steps"] == ref["steps"] and loss_rel <= c.TOL_LOSS
            and got["launches"] == ref["launches"]):
        raise AssertionError(f"data parallel {label}: steps {got['steps']}, "
                             f"losses {loss_rel}, launches "
                             f"{got['launches']}, {ref['launches']}")
    if per_step is not None and got["launches"] != c.scaled(
            per_step, got["steps"]):
        raise AssertionError(f"data parallel {label}: launches "
                             f"{got['launches']}")
    if not all(got["launches"][k] for k in ("gn", "gn_bwd", "attn",
                                              "attn_bwd")):
        raise AssertionError(f"data parallel {label}: a kernel of the path "
                             f"did not launch: {got['launches']}")


# -------------------------------------------------------------- the phase
def jobs_and_inputs(unet_ckpt, flow_ckpt, tmp, gen):
    config = c.load_config(c.CONFIG)
    common = ["--device", "cuda", "--seed", "0", "--cfg_scale",
              str(c.CFG_SCALE)]
    sample_argv = ["--checkpoint", str(unet_ckpt), "--sampling_method",
                   "ddim", "--num_inference_steps", str(c.STEPS),
                   "--num_samples", str(SAMPLES), "--batch_size", str(BATCH),
                   *common]
    eval_ckpt = Path(tmp) / "eval.pth"
    payload = torch.load(unet_ckpt, weights_only=True)
    c.checkpoint.save_checkpoint(
        eval_ckpt, payload["model_state_dict"],
        dict(payload["config"], data_root=str(c.FIXTURE_DATA)))
    eval_argv = ["--checkpoint", str(eval_ckpt), "--sampling_method", "ddim",
                 "--num_inference_steps", str(EVAL_STEPS), "--num_samples",
                 str(EVAL_SAMPLES), "--batch_size", str(EVAL_BATCH), "--swd",
                 *common]
    state = payload["model_state_dict"]
    shape = (c.PARALLEL_BATCH, *c.image_shape(config))
    batch = {"x0": torch.rand(*shape, generator=gen, device="cuda") * 2 - 1,
             "labels": torch.randint(0, 10, (c.PARALLEL_BATCH,),
                                     generator=gen, device="cuda"),
             "t": torch.randint(0, GRID_TIMESTEPS, (c.PARALLEL_BATCH,),
                                generator=gen, device="cuda"),
             "noise": torch.randn(*shape, generator=gen, device="cuda"),
             "drop": torch.rand(c.PARALLEL_BATCH, generator=gen,
                                device="cuda") < 0.2}
    files = {"state": str(Path(tmp) / "grid_state.pt"),
             "batch": str(Path(tmp) / "grid_batch.pt")}
    torch.save(state, files["state"])
    torch.save({k: v.cpu() for k, v in batch.items()}, files["batch"])
    grid_config = dict(config, num_timesteps=GRID_TIMESTEPS,
                       batch_size=c.PARALLEL_BATCH,
                       save_dir=str(Path(tmp) / "grid_ckpt"))
    few = dict(optimizer="adamw", learning_rate=1e-4, weight_decay=1e-4,
               use_scheduler=False, ema_decay=0.9, seed=0, progress=False)
    distill_config = dict(config, **few, teacher_checkpoint=str(unet_ckpt),
                          distill_method="progressive",
                          distill_steps=c.PD_STEPS, distill_stages=1,
                          epochs=DISTILL_EPOCHS, batch_size=GLOBAL_BATCH,
                          data_root=str(c.FIXTURE_DATA))
    reflow_config = dict(few, teacher_checkpoint=str(flow_ckpt),
                         reflow_pairs=c.REFLOW_PAIRS,
                         pair_batch_size=c.REFLOW_BATCH,
                         teacher_sample_steps=c.REFLOW_TEACHER_STEPS,
                         reflow_cfg_scale=c.CFG_SCALE, reflow_rounds=1,
                         epochs=1)
    out = {name: Path(tmp) / name for name in (
        "sample", "evaluate", "grid", "distill", "reflow")}
    for path in out.values():
        path.mkdir()
    return [
        {"kind": "sample", "argv": sample_argv, "out": str(out["sample"]),
         "time_gather": True},
        {"kind": "evaluate", "argv": eval_argv, "out": str(out["evaluate"])},
        {"kind": "grid", "config": grid_config, "out": str(out["grid"]),
         **files},
        {"kind": "tool", "tool": "distill", "config": distill_config,
         "out": str(out["distill"])},
        {"kind": "tool", "tool": "reflow", "config": reflow_config,
         "out": str(out["reflow"])},
    ], out


def phase_data_parallel(smi, unet_ckpt, flow_ckpt):
    """Item 15d on the card: the paths of the module docstring in a gloo
    world of two processes against one process. Returns the figures."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(23)
    with tempfile.TemporaryDirectory() as tmp:
        jobs, out = jobs_and_inputs(unet_ckpt, flow_ckpt, tmp, gen)
        start = time.perf_counter()
        world = c.launch(WORLD, "chip_smoke_data.data_rank", jobs,
                         device="cuda", backend="gloo",
                         timeout=TIMEOUT)[0]
        world_seconds = time.perf_counter() - start
        one = Path(tmp) / "one"
        refs, wholes = [], []
        for job in jobs:
            job = dict(job, out=str(one / job["kind"]
                                    / job.get("tool", "")))
            job.pop("time_gather", None)
            run = RUNS[job["kind"]]
            if job["kind"] == "tool":
                Path(job["out"]).mkdir(parents=True)
                refs.append(run(job, one_process=True))
                continue
            runs = ((refs, "rows"),) if job["kind"] == "grid" else (
                (wholes, "whole"), (refs, "rows"))
            for store, where in runs:
                part = dict(job, out=str(Path(job["out"]) / where))
                Path(part["out"]).mkdir(parents=True)
                with (rows_in_blocks() if where == "rows"
                      else contextlib.nullcontext()):
                    store.append(run(part))
        sample_got, eval_got, grid_got, distill_got, reflow_got = world
        sample_ref, eval_ref, grid_ref, distill_ref, reflow_ref = refs
        sample_whole, eval_whole = wholes
        one_call = check_one_call(unet_ckpt, smi)
        sample_err = check_sample(sample_got, sample_ref, sample_whole, smi)
        wrote_on_rank_0_alone("sample", out["sample"], "samples.png",
                              "samples.npy")
        eval_rel = check_evaluate(eval_got, eval_ref, eval_whole, smi)
        wrote_on_rank_0_alone("evaluate", out["evaluate"], "real",
                              "generate")
        if not (out["evaluate"] / "rank0_metrics.json").is_file() or (
                out["evaluate"] / "rank1_metrics.json").exists():
            raise AssertionError("evaluate: rank 0 alone writes the JSON")
        check_grid(grid_got, grid_ref, smi)
        wrote_on_rank_0_alone("grid", out["grid"], "epoch_0001.png")
        check_tool("tools.distill (progressive, 1 stage)", distill_got,
                   distill_ref, c.DISTILL_STEP, 1e-4, smi)
        wrote_on_rank_0_alone("distill", out["distill"],
                              f"distilled_{c.PD_STEPS:04d}step.pth")
        check_tool("tools.reflow (1 round)", reflow_got, reflow_ref, None,
                   1e-4, smi)
        wrote_on_rank_0_alone("reflow", out["reflow"], "reflow_round1.pth")
    print(f"data parallel: the gloo world of {WORLD} took "
          f"{world_seconds:.1f} s; on {smi}")
    return {"world_seconds": world_seconds, "one_call": one_call,
            "whole": {"sample": sample_err, "evaluate": eval_rel},
            "sample": (sample_got["seconds"], sample_whole["seconds"]),
            "gather_share": (sample_got["gather_seconds"]
                             / sample_got["timed_seconds"]),
            "evaluate": (eval_got["wall"], eval_whole["wall"]),
            "distill": (distill_got["seconds"], distill_ref["seconds"]),
            "reflow": (reflow_got["seconds"], reflow_ref["seconds"]),
            "launches": {"sample": sample_got["launches"],
                         "evaluate": eval_got["launches"],
                         "grid": grid_got["launches"],
                         "distill": distill_got["launches"],
                         "reflow": reflow_got["launches"]}}
