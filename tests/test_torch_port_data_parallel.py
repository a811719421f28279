"""The PyTorch port's data parallelism outside `train`
(`parallel/data_parallel.py`) on the CPU, in one gloo world of 2 processes
(`torch_data_parallel_jobs.py`, one torch thread a rank), started in the
background while the one-process and JAX references run here:

* `DataParallelApply`: each rank's contiguous rows in rank order, a call
  whose rows do not divide by the world whole on every rank, keywords and
  extra arguments passed through, a tuple output's tail kept local;
* `sample.main` at world 2 against one process (DDIM with CFG, DDPM with
  its per-step noise, DPM++ SDE, PAG, DeepCache, and rows that do not
  divide), rank 0 alone writing;
* DDIM-10 with CFG from an explicit initial noise, split, against the JAX
  pipeline's data-parallel path (`dp_sampling_sharding`: the noise and
  labels placed over the virtual CPU mesh);
* `evaluate.main` at world 2 against one process, rank 0 alone writing;
  InceptionV3's features at world 2 against JAX's extractor on the mesh
  with the same weights;
* the in-training grid of a DDP UNet against one process's;
* `tools.distill` and `tools.reflow` at world 2 against one process (the
  distillation fed the global batches the two ranks load, in rank order),
  and one step of each at world 2 against the JAX trainers' step on a
  2-device 'data' mesh;
* `tools.cascade` and `tools.compute_latent_scale` refuse a torchrun
  world, naming their ROADMAP item, and so does `serve --continuous`
  (`test_torch_port_serve_data_parallel.py` holds the batched daemon's
  split).

Bars: the split against one process that runs each model call and metric
batch on the ranks' row blocks in turn (the same float work) 1e-6 (max abs
on [0, 1] for images, max-rel for metrics); against one process on whole
calls, images 1e-5 and metrics 1e-5 relative (one call of the small UNet on
4 rows against 8 moves eps by up to 3.7e-6 on the CPU, oneDNN's
convolutions being picked by the batch; the 5-step DDIM CFG trajectory
read 2.4e-6); losses 1e-6 max-rel; the few-step weights 1e-5 where Adam's
updates are decided (`check_decided`). Against JAX 5e-4 for the DDIM
trajectory (or twice JAX's own sharded-vs-one-device distance, where that
is larger), 2e-4 for the features and the steps (the forward bar).
"""

import concurrent.futures
import contextlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

from diffusion_models_collection_tpu import factory as jax_factory
from diffusion_models_collection_tpu.diffusion import base as jax_base
from diffusion_models_collection_tpu.diffusion import distill as jax_distill
from diffusion_models_collection_tpu.diffusion.ddim import DDIM as JaxDDIM
from diffusion_models_collection_tpu.diffusion.flow_matching import (
    FlowMatching as JaxFlowMatching,
)
from diffusion_models_collection_tpu.diffusion.flow_matching import (
    interpolate as jax_interpolate,
)
from diffusion_models_collection_tpu.metrics import inception as jax_inception
from diffusion_models_collection_tpu.parallel import mesh as jax_mesh
from diffusion_models_collection_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from diffusion_models_collection_tpu.utils.ema import (
    gated_ema_update as jax_gated_ema_update,
)
from diffusion_models_collection_tpu.utils.trainer import (
    build_optimizer as jax_build_optimizer,
)
from diffusion_models_collection_tpu_torch import serve
from diffusion_models_collection_tpu_torch.factory import get_model
from diffusion_models_collection_tpu_torch.metrics.inception import (
    InceptionFeatures,
)
from diffusion_models_collection_tpu_torch.tools import (
    cascade,
    compute_latent_scale,
)
from diffusion_models_collection_tpu_torch.tools.dryrun_multichip import (
    launch,
)
from diffusion_models_collection_tpu_torch.utils.checkpoint import (
    save_checkpoint,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
import torch_data_parallel_jobs as jobs
from torch_parallel_helpers import train_config
from torch_parallel_jobs import batches as train_batches
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    H,
    W,
    check_first_adam_update,
    max_rel,
    one_torch_thread,
    shared_schedule,
    traced_unet,
)

WORLD = 2
TOL = 1e-6
TOL_IMAGES = 1e-5
TOL_METRICS = 1e-5
TOL_WEIGHTS = 1e-5
LR = 1e-4  # the parallel tests' rate: float-noise flips of Adam move 2 lr
B = 4
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "data"

SAMPLE_CASES = {
    "ddim_cfg": ["--sampling_method", "ddim", "--num_inference_steps", "5",
                 "--cfg_scale", "3", "--num_samples", "4",
                 "--batch_size", "4"],
    "ddpm": ["--sampling_method", "ddpm", "--num_samples", "4",
             "--batch_size", "4"],
    "dpmpp_sde_cfg": ["--sampling_method", "dpm++sde",
                      "--num_inference_steps", "5", "--cfg_scale", "3",
                      "--num_samples", "4", "--batch_size", "4"],
    "pag_cfg": ["--sampling_method", "ddim", "--num_inference_steps", "4",
                "--pag_scale", "2", "--cfg_scale", "3", "--num_samples", "4",
                "--batch_size", "4"],
    "deepcache_cfg": ["--sampling_method", "ddim", "--num_inference_steps",
                      "6", "--deepcache", "3", "--cfg_scale", "3",
                      "--num_samples", "4", "--batch_size", "4"],
    # 3 rows a call: each rank runs the whole call
    "ddim_3_rows": ["--sampling_method", "ddim", "--num_inference_steps",
                    "4", "--num_samples", "3", "--batch_size", "3"],
}
EVAL_ARGV = ["--num_samples", "8", "--batch_size", "4", "--sampling_method",
             "ddim", "--num_inference_steps", "3", "--cfg_scale", "3",
             "--seed", "0"]


def tiny_unet_config(root, name, **changes):
    """An 8x8 UNet `.pth` (random weights from torch seed 0) and its
    config: the teachers of the tool runs."""
    config = {
        "model_type": "unet",
        "model_params": {"image_size": (8, 8), "in_channels": 3,
                         "model_channels": 16, "out_channels": 3,
                         "num_res_blocks": 1, "attention_resolutions": (4,),
                         "dropout": 0.1, "channel_mult": (1, 2),
                         "use_attention": True},
        "dataset": "synthetic", "image_size": (8, 8), "conditional": True,
        "num_classes": 10, "num_timesteps": 20, "beta_start": 0.0001,
        "beta_end": 0.02, "beta_schedule": "linear",
        "num_inference_steps": 3, "cfg_dropout_prob": 0.2, **changes}
    torch.manual_seed(0)
    path = root / f"{name}.pth"
    save_checkpoint(path, get_model(config).state_dict(), config)
    return path, config


def few_step_config(teacher, **changes):
    return dict(dict(
        teacher_checkpoint=str(teacher), optimizer="adamw",
        learning_rate=LR, weight_decay=1e-4, use_scheduler=False, epochs=1,
        ema_decay=0.9, seed=0, progress=False), **changes)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs of every job, and the world running them in the
    background: (inputs, a future of every rank's results)."""
    root = tmp_path_factory.mktemp("data_parallel")
    model, params, config = traced_unet(seed=3)
    state = state_dict_from_jax(params, config)
    inputs = {"root": root, "model": model, "params": params,
              "config": config, "state": state}

    sample_config = dict(config, num_timesteps=20)
    ckpt = root / "sample.pth"
    save_checkpoint(ckpt, {k: torch.as_tensor(v) for k, v in state.items()},
                    sample_config)
    # 8x8: LPIPS upsamples images under 16 px (AlexNet's pools need it)
    eval_ckpt, _ = tiny_unet_config(root, "eval", num_timesteps=10,
                                    dataset="cifar10",
                                    data_root=str(FIXTURES))
    inputs["sample_argv"] = {k: ["--checkpoint", str(ckpt), "--seed", "7",
                                 *v] for k, v in SAMPLE_CASES.items()}
    inputs["eval_argv"] = ["--checkpoint", str(eval_ckpt), *EVAL_ARGV]

    rng = np.random.default_rng(11)
    inputs["noise"] = rng.standard_normal((8, H, W, 3)).astype(np.float32)
    inputs["labels"] = rng.integers(1, 11, 8).astype(np.int64)
    inputs["images"] = rng.random((8, 32, 32, 3), dtype=np.float32)
    weights = root / "inception.npz"
    np.savez(weights, **{k: v.numpy() for k, v in
                         InceptionFeatures().model.state_dict().items()})
    inputs["weights"] = str(weights)

    grid = train_config(dict(config, num_timesteps=20), root / "grid")
    inputs["grid"] = dict(config=grid, state=state, seed=0, sample=4,
                          batches=train_batches(3, 1, (B, H, W, 3),
                                                num_timesteps=20))

    distill_teacher, _ = tiny_unet_config(root, "pd_teacher")
    flow_teacher, _ = tiny_unet_config(root, "flow_teacher",
                                       diffusion_type="flow_matching")
    inputs["distill"] = few_step_config(
        distill_teacher, distill_method="progressive", distill_steps=4,
        distill_stages=2, batch_size=128, dataset="synthetic",
        image_size=(8, 8), num_classes=10, conditional=True,
        num_workers=0)
    inputs["reflow"] = few_step_config(
        flow_teacher, reflow_pairs=16, pair_batch_size=8, reflow_rounds=2,
        teacher_sample_steps=3, reflow_cfg_scale=2.0)
    inputs.update(step_inputs(root, model, params, config))

    world_jobs = [
        {"kind": "apply", "rows": [4, 3]},
        *({"kind": "sample", "argv": argv, "out": str(root / name)}
          for name, argv in inputs["sample_argv"].items()),
        {"kind": "noise", "config": config, "state": state,
         "noise": inputs["noise"], "labels": inputs["labels"]},
        {"kind": "evaluate", "argv": inputs["eval_argv"],
         "out": str(root / "eval")},
        {"kind": "inception", "weights": inputs["weights"],
         "images": inputs["images"]},
        {"kind": "grid", **inputs["grid"]},
        {"kind": "tool", "tool": "distill", "config": inputs["distill"],
         "out": str(root / "distill")},
        {"kind": "tool", "tool": "reflow", "config": inputs["reflow"],
         "out": str(root / "reflow")},
        {"kind": "step", **inputs["distill_step"]},
        {"kind": "step", **inputs["reflow_step"]},
    ]
    for name in [*SAMPLE_CASES, "eval", "distill", "reflow"]:
        (root / name).mkdir()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch, WORLD, "torch_data_parallel_jobs.run_jobs",
                         world_jobs, timeout=600)
    names = ["apply", *SAMPLE_CASES, "noise", "evaluate", "inception",
             "grid", "distill", "reflow", "distill_step", "reflow_step"]
    yield inputs, lambda: [dict(zip(names, r)) for r in future.result()]
    pool.shutdown(wait=True)


def step_inputs(root, model, params, config):
    """The distill and reflow step jobs: JAX `.ckpt` teachers of the small
    UNet (dropout 0), a global batch of 4 and its draws."""
    teacher_cfg = dict(config, model_params=dict(config["model_params"],
                                                 dropout=0.0),
                       cfg_dropout_prob=0.2)
    vp, flow = root / "vp.ckpt", root / "flow.ckpt"
    jax_save_checkpoint(vp, epoch=1, params=params, opt_state=None,
                        best_loss=1.0, config=teacher_cfg)
    jax_save_checkpoint(flow, epoch=1, params=params, opt_state=None,
                        best_loss=1.0, config=dict(
                            teacher_cfg, diffusion_type="flow_matching",
                            num_inference_steps=50))
    rng = np.random.default_rng(4)
    distill_batch = dict(
        x0=rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
        noise=rng.standard_normal((B, H, W, 3)).astype(np.float32),
        labels=rng.integers(0, 10, B).astype(np.int64),
        drop=rng.uniform(size=B) < 0.3, idx=np.array([0, 3, 1, 3]))
    reflow_batch = dict(
        x_hat=rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
        z=rng.standard_normal((B, H, W, 3)).astype(np.float32),
        labels=rng.integers(1, 11, B), t=np.array([0, 999, 400, 77]))
    _, sched = shared_schedule()
    schedule = {k: v.numpy() for k, v in vars(sched).items()}
    common = dict(optimizer="adamw", learning_rate=LR, weight_decay=1e-4,
                  use_scheduler=False, epochs=1, batch_size=B, seed=0)
    return {
        "teacher_cfg": teacher_cfg,
        "distill_step": dict(tool="distill", batch=distill_batch,
                             schedule=schedule, config=dict(
                                 common, teacher_checkpoint=str(vp),
                                 distill_steps=4, ema_decay=0.9,
                                 save_dir=str(root / "pd_step"))),
        "reflow_step": dict(tool="reflow", batch=reflow_batch, config=dict(
            common, teacher_checkpoint=str(flow), reflow_pairs=2 * B,
            pair_batch_size=B, teacher_sample_steps=3, ema_decay=0.9,
            save_dir=str(root / "reflow_step")))}


def one_process(job, out, rows=False):
    """A job in this process (no process group), its outputs under
    `out/rank0`; with `rows`, each model call and metric batch run on the
    world's row blocks in turn (`jobs.rows_in_blocks`: the world's float
    work)."""
    out.mkdir(exist_ok=True)
    with (jobs.rows_in_blocks(WORLD) if rows
          else contextlib.nullcontext()):
        return jobs.JOBS[job["kind"]](dict(job, out=str(out)))


def wrote_on_rank_0_alone(out, *names):
    for name in names:
        assert (out / "rank0" / name).exists(), name
    assert not (out / "rank1").exists()


# ---------------------------------------------------------------- metrics
def test_evaluate_at_world_2_matches_one_process(setup):
    inputs, results = setup
    root = inputs["root"]
    job = {"kind": "evaluate", "argv": inputs["eval_argv"]}
    with threadpool_limits(1):
        ref = one_process(job, root / "eval_one")
        rows = one_process(job, root / "eval_rows", rows=True)
    got = results()[0]["evaluate"]
    for want, bar in ((rows, TOL), (ref, TOL_METRICS)):
        assert set(got) == set(want)
        for key, value in want.items():
            if isinstance(value, float) and np.isnan(value):
                assert np.isnan(got[key]), key  # IS of 8 images, 10 splits
            elif isinstance(value, float):
                assert abs(got[key] - value) <= bar * max(abs(value),
                                                          1e-12), key
            else:
                assert got[key] == value, key
    written = json.loads((root / "eval" / "rank0_metrics.json").read_text())
    assert json.dumps(written, sort_keys=True) == json.dumps(got,
                                                             sort_keys=True)
    assert not (root / "eval" / "rank1_metrics.json").exists()
    wrote_on_rank_0_alone(root / "eval", "real", "generate")


def test_inception_features_at_world_2_match_jax_on_the_mesh(setup):
    inputs, results = setup
    assert jax_mesh.dp_batch_sharding(8) is not None  # JAX splits the 8
    ref = jax_inception.InceptionFeatures(inputs["weights"])(inputs["images"])
    got = results()[0]["inception"]
    for ours, want in zip(got, ref):
        want = np.asarray(want)
        assert ours.shape == want.shape
        assert max_rel(ours, want) <= 2e-4


# ---------------------------------------------------------------- sample
@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_at_world_2_matches_one_process(setup, case):
    """Against one process on the ranks' row blocks (the same float work)
    at TOL, and on whole calls at TOL_IMAGES."""
    inputs, results = setup
    root = inputs["root"]
    job = {"kind": "sample", "argv": inputs["sample_argv"][case]}
    ref = one_process(job, root / f"{case}_one")
    rows = one_process(job, root / f"{case}_rows", rows=True)
    got = results()[0][case]
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - rows).max() <= TOL, np.abs(got - rows).max()
    assert np.abs(got - ref).max() <= TOL_IMAGES, np.abs(got - ref).max()
    assert np.abs(got - 0.5).max() > 1e-3  # not a constant image
    wrote_on_rank_0_alone(root / case, "samples.png", "samples.npy")


def test_split_ddim_cfg_matches_the_jax_data_parallel_path(setup):
    """DDIM-10 CFG 3 of 8 images from one initial noise: the port's split
    at world 2 against the JAX pipeline's path on its 8 virtual devices
    (`dp_sampling_sharding`, the noise and labels placed sharded, as
    `sharded_init_noise` places its draw)."""
    inputs, results = setup
    sharding = jax_factory.dp_sampling_sharding(8)
    assert sharding is not None and len(sharding.device_set) == 8
    params, model = inputs["params"], inputs["model"]

    def jax_fn(x, t, y):
        return model.apply({"params": params}, x, t, y)

    def jax_ddim(place):
        return np.asarray(JaxDDIM(
            num_timesteps=1000, num_inference_steps=10).sample_with_cfg(
            jax.tree_util.Partial(jax_fn), inputs["noise"].shape,
            place(jnp.asarray(inputs["labels"], jnp.int32)),
            jax.random.PRNGKey(0), cfg_scale=3.0,
            init_noise=place(jnp.asarray(inputs["noise"]))))

    ref = jax_ddim(lambda a: jax.device_put(a, sharding))
    # JAX's own sharded trajectory against its one-device one: 6.2e-4 on
    # these 8 images (CFG 3's dynamic threshold grows a float32 change
    # each step), so the bar is twice that where it passes 5e-4
    own = max_rel(ref, jax_ddim(lambda a: a))
    got = results()[0]["noise"]
    assert np.isfinite(got).all()
    assert max_rel(got, ref) <= max(5e-4, 2 * own), (max_rel(got, ref), own)


# ------------------------------------------------------- the trainers' grid
def test_ddp_grid_matches_one_process(setup):
    """One DDP step (dropout 0.1, the global batch's masks) and the EMA's
    DDPM-20 CFG grid of 4, each model call split over the two ranks."""
    inputs, results = setup
    one = inputs["root"] / "grid_one"
    ref = jobs.grid_job(dict(inputs["grid"], config=dict(
        inputs["grid"]["config"], save_dir=str(one / "ckpt"),
        sample_dir=str(one / "samples"))))
    got = results()[0]["grid"]
    assert max_rel(got["losses"], ref["losses"]) <= TOL
    assert got["samples"].shape == ref["samples"].shape == (4, H, W, 3)
    assert np.abs(got["samples"] - ref["samples"]).max() <= TOL_IMAGES


# ------------------------------------------------------- distill and reflow
def check_decided(got, want, grads, steps, bar=TOL_WEIGHTS):
    """Weights after `steps` Adam updates against another order of
    summation, as one vector (a zero-initialised bias is its updates
    alone, and its elements carry their gradients' relative noise): at
    `bar` (max-rel) over the elements whose gradient is decided (at least
    1e-3 of its tensor's largest) in every update, and within 2 lr a step
    everywhere."""
    ours, refs = [], []
    for name, ref in want.items():
        mine, ref = np.asarray(got[name]), np.asarray(ref)
        decided = np.ones(ref.shape, bool)
        for g in grads:
            if name in g:
                mag = np.abs(np.asarray(g[name]))
                decided &= mag >= 1e-3 * mag.max()
        ours.append(mine[decided])
        refs.append(ref[decided])
        assert np.abs(mine - ref).max() <= 2 * LR * steps + 1e-7, name
    assert max_rel(np.concatenate(ours), np.concatenate(refs)) <= bar


@pytest.mark.parametrize("tool", ["distill", "reflow"])
def test_tool_at_world_2_matches_one_process(setup, tool):
    """Two progressive stages (4 then 2 steps; 4 global batches of 128
    images, 64 a rank) or two reflow rounds (16 pairs in batches of 8, CFG 2
    synthesis, whole on each rank), dropout 0.1: the epoch losses, every
    update's gradients (one vector: a tensor of gradients near 0 sums
    64 against 128 rows to 1.1e-5 of itself), the student and its EMA;
    rank 0 alone writes."""
    inputs, results = setup
    root = inputs["root"]
    job = {"kind": "tool", "tool": tool, "config": inputs[tool]}
    if tool == "distill":
        job["shards"] = WORLD
    ref = one_process(job, root / f"{tool}_one")
    got = results()[0][tool]
    assert got["steps"] == ref["steps"] == (8 if tool == "distill" else 4)
    assert max_rel(got["losses"], ref["losses"]) <= TOL
    assert len(got["grads"]) == len(ref["grads"]) == ref["steps"]
    for mine, want in zip(got["grads"], ref["grads"]):
        # each update's gradient as the one vector the clip sees
        assert set(mine) == set(want)
        assert max_rel(np.concatenate([mine[n].reshape(-1) for n in want]),
                       np.concatenate([want[n].reshape(-1) for n in want])
                       ) <= TOL_WEIGHTS
    for what in ("student", "ema"):
        check_decided(got[what], ref[what], ref["grads"], ref["steps"])
    names = (["distilled_0004step.pth", "distilled_0002step.pth"]
             if tool == "distill" else ["reflow_round1.pth",
                                        "reflow_round2.pth"])
    wrote_on_rank_0_alone(root / tool, *names, "current_model.pth")


def jax_dp_step(loss_of, params, config, args):
    """One step of the JAX trainers' chain on a 2-device 'data' mesh: the
    parameters replicated, `args` (the global batch) sharded; the loss,
    gradients, parameters and EMA (decay 0.9)."""
    mesh = jax_mesh.data_parallel_mesh(WORLD)
    rows = jax_mesh.batch_sharding(mesh)
    tx, _, _ = jax_build_optimizer(config, 1)

    @jax.jit
    def step(p, *batch):
        loss, grads = jax.value_and_grad(loss_of)(p, *batch)
        updates, opt_state = tx.update(grads, tx.init(p), p)
        new = optax.apply_updates(p, updates)
        return (loss, grads, new,
                jax_gated_ema_update(tx, opt_state, p, new, 0.9))

    p = jax_mesh.replicate(mesh, jax.tree_util.tree_map(jnp.asarray, params))
    return step(p, *(jax.device_put(jnp.asarray(a), rows) for a in args))


def check_against_jax(got, refs, config):
    loss_ref, grads_ref, p_ref, ema_ref = refs
    assert max_rel(got["loss"], loss_ref) <= 2e-4
    grads = {k: torch.as_tensor(v) for k, v in got["grads"].items()}
    for name, want in state_dict_from_jax(grads_ref, config).items():
        assert max_rel(grads[name], want) <= 2e-4, name
    for what, ref in (("student", p_ref), ("ema", ema_ref)):
        check_first_adam_update(
            what, {k: torch.as_tensor(v) for k, v in got[what].items()},
            state_dict_from_jax(ref, config), grads, LR)


def test_distill_step_at_world_2_matches_the_jax_data_parallel_step(setup):
    inputs, results = setup
    job, cfg = inputs["distill_step"], inputs["teacher_cfg"]
    model, b = inputs["model"], job["batch"]
    jsched, _ = shared_schedule()
    grids = [np.asarray(g)[b["idx"]]
             for g in jax_distill.distill_grids(1000, 4)]
    y = np.where(b["drop"], 0, b["labels"] + 1).astype(np.int32)

    def pair(p):
        return jax_base.wrap_model_as_eps_x0(
            jsched, lambda x, t, yy=None: model.apply({"params": p}, x, t,
                                                      yy), "eps")

    def loss_of(p, x0, noise, t, t_mid, t_next, yy):
        z = jax_base.q_sample(jsched, x0, t, noise)
        target = jax.lax.stop_gradient(jax_distill.two_step_teacher_target(
            jsched, pair(inputs["params"]), z, t, t_mid, t_next, yy))
        return jax_distill.student_distill_loss(jsched, pair(p), target, z,
                                                t, yy)

    refs = jax_dp_step(loss_of, inputs["params"], job["config"],
                       (b["x0"], b["noise"], *grids, y))
    got = results()[0]["distill_step"]
    check_against_jax(got, refs, cfg)
    one = jobs.step_job(job)
    assert max_rel(got["loss"], one["loss"]) <= TOL
    check_decided(got["student"], one["student"], [one["grads"]], 1)


def test_reflow_step_at_world_2_matches_the_jax_data_parallel_step(setup):
    inputs, results = setup
    job, cfg = inputs["reflow_step"], inputs["teacher_cfg"]
    model, b = inputs["model"], job["batch"]
    jflow = JaxFlowMatching(num_timesteps=1000)

    def loss_of(p, x_hat, z, t, y):
        x_t = jax_interpolate(x_hat, jflow.tau_of_t(t), z)
        v = model.apply({"params": p}, x_t, t, y)
        return jax_base.diffusion_loss(z - x_hat, v, "l2")

    refs = jax_dp_step(loss_of, inputs["params"], job["config"],
                       (b["x_hat"], b["z"], b["t"],
                        b["labels"].astype(np.int32)))
    got = results()[0]["reflow_step"]
    check_against_jax(got, refs, cfg)
    one = jobs.step_job(job)
    assert max_rel(got["loss"], one["loss"]) <= TOL
    check_decided(got["student"], one["student"], [one["grads"]], 1)


# ------------------------------------------------------------- the split
def test_data_parallel_apply_splits_in_rank_order(setup):
    """Rank r's model sees rows r n/2 .. (r + 1) n/2 and the output is
    every row's; at 3 rows each rank sees all 3; keywords reach the model
    (a keyword tensor of the batch cut with x); a tuple's tail stays the
    rank's."""
    results = setup[1]()
    for rank, result in enumerate(r["apply"] for r in results):
        four, three = result[4], result[3]
        assert four["seen"] == [[0.0, 3.0], [0.0, 3.0]] if rank == 0 else \
            four["seen"] == [[6.0, 9.0], [6.0, 9.0]]
        np.testing.assert_array_equal(four["eps"], four["want"])
        np.testing.assert_array_equal(four["tuple"], four["want"])
        assert four["cache"].shape == (2, 1)
        np.testing.assert_array_equal(
            four["cache"][:, 0], np.array([0.0, 3.0]) + 6 * rank + 100)
        assert three["seen"] == [[0.0, 3.0, 6.0]] * 2
        np.testing.assert_array_equal(three["eps"], three["want"])
        assert three["cache"].shape == (3, 1)


# ------------------------------------------------ the one-process tools
@pytest.mark.parametrize("main,error,match", [
    (serve.main, ValueError, "--continuous runs in one process"),
    (cascade.main, NotImplementedError, "item 16"),
    (compute_latent_scale.main, NotImplementedError, "item 16"),
], ids=["serve", "cascade", "compute_latent_scale"])
def test_one_process_tool_refuses_a_torchrun_world(monkeypatch, main, error,
                                                   match):
    """Under torchrun at WORLD_SIZE 2 each process would run the whole run
    on its own: the tool raises before it reads its arguments' files, the
    two tools naming their ROADMAP item, `serve --continuous` (the
    continuous engine runs in one process, as the JAX engine runs on one
    device; the batched daemon splits its batches over the world) with
    `ValueError`."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    argv = {serve.main: ["--checkpoint", "absent.pth", "--device", "cpu",
                         "--continuous"],
            cascade.main: ["--base_checkpoint", "absent.pth",
                           "--sr_checkpoint", "absent.pth", "--device",
                           "cpu"],
            compute_latent_scale.main: ["--config", "absent.py", "--device",
                                        "cpu"]}[main]
    with pytest.raises(error, match=match):
        main(argv)
