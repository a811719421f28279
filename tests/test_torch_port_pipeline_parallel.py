"""The port's pipeline parallelism (`parallel/pipeline_parallel.py`, GPipe of
the DiT's and the DiM's blocks over a 'stage' axis) against the JAX
package and against the port's own one-device step, on the CPU.

The JAX side runs on its virtual CPU devices (`tests/conftest.py`): its
`make_pipeline_apply` step (`torch_parallel_helpers.jax_pp_steps`). The port
runs in one gloo world of four processes for the whole file
(`torch_parallel_jobs.py`, importing no JAX): (2 data, 2 stage) for the
conditional and unconditional DiT, the DiM and four microbatches, and (1
data, 2 stage, 2 model) for the DiT. Against JAX the model runs with
dropout 0 (the JAX masks are its own); against the port's one-device step,
with dropout 0.1, whose masks and attention seeds every stage replays in
the one-device order. Each step takes a global batch of 8 rows (4 a data
rank: four microbatches fit). Bars: the trainer bars of
`torch_parallel_helpers.py`.
"""

import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu_torch.models import DiM, DiT, UNet
from diffusion_models_collection_tpu_torch.parallel import plan as plan_mod
from diffusion_models_collection_tpu_torch.parallel.plan import (
    ParallelPlan,
    check_config,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from torch_parallel_helpers import (
    check_against_jax,
    check_against_one_device,
    jax_pp_steps,
    numpy_state,
    run_world,
    train_config,
)
from torch_parallel_jobs import batches, build_trainer, train_job
from torch_port_helpers import (  # noqa: F401 (autouse: one torch thread)
    jax_dim,
    jax_dit,
    one_torch_thread,
)

BATCH = 8
PARALLEL_KEYS = ("pipeline_parallel", "tensor_parallel", "pp_microbatches")


# ---------------------------------------------------------------- rules
def dit(**kw):
    return DiT(img_size=(8, 8), patch_size=2, hidden_size=32, depth=2,
               num_heads=4, num_classes=10, **kw)


def dim(**kw):
    return DiM(img_size=(8, 8), patch_size=2, hidden_size=32, depth=2,
               state_size=4, num_classes=10, **kw)


def unet():
    return UNet(image_size=(8, 8), model_channels=16, channel_mult=(1, 2),
                num_res_blocks=1, attention_resolutions=(), num_classes=10)


@pytest.mark.parametrize("config,model,match", [
    # test_trainer_backbones.py: test_pipeline_parallel_rejects_bad_configs
    ({"sequence_parallel": 2}, dit, "sequence_parallel cannot be combined "
                                    "with pipeline_parallel"),
    ({"pipeline_parallel": 3}, dit, "DiT depth 2 not divisible by "
                                    "pipeline_parallel=3"),
    ({}, unet, r"pipeline_parallel supports the DiT and DiM backbones "
               r"\(got UNet\)"),
    ({}, lambda: dim(use_attention_fallback=True),
     "pipeline_parallel for DiM runs the Mamba mixer stack — the attention "
     "fallback has no pipelined path"),
    # test_pp_x_tp_rejects_dim
    ({"tensor_parallel": 2}, dim, "pipeline_parallel x tensor_parallel is "
                                  "supported for DiT"),
    # test_moe.py: test_expert_parallel_validation (MoE rejects PP)
    ({}, lambda: dit(num_experts=2), r"MoE models \(num_experts > 0\) do "
                                     "not support pipeline/sequence "
                                     "parallelism"),
    ({"fsdp": True}, dit, "fsdp cannot be combined with pipeline_parallel"),
    ({}, dit, "pipeline_parallel=2 does not divide 1 devices"),
])
def test_every_rejection_has_the_jax_message(config, model, match):
    """The JAX trainer's rules for `pipeline_parallel`, word for word
    (`utils/trainer.py` of the JAX package), in one process."""
    with pytest.raises(ValueError, match=match):
        check_config(dict({"pipeline_parallel": 2}, **config), model())


def test_the_data_axis_and_the_microbatches_must_split(monkeypatch):
    """The global batch and `num_samples` divide by the data axis (the JAX
    messages, test_trainer.py: test_pp_rejects_indivisible_num_samples); a
    data rank's rows of a step and of the sample grid's CFG call divide
    into `pp_microbatches` (where the JAX pipeline's reshape fails); the
    stage axis times the model axis divides the devices."""
    with pytest.raises(ValueError, match=r"num_samples 6 not divisible by "
                       "the data-axis size 4 required by pipeline_parallel"):
        plan_mod._check_data_axis({"batch_size": 16, "num_samples": 6}, 4,
                                  "pipeline_parallel")
    with pytest.raises(ValueError, match="global batch size 14 not "
                       "divisible by the data-axis size 4 required by "
                       "pipeline_parallel"):
        plan_mod._check_data_axis({"batch_size": 14}, 4, "pipeline_parallel")
    with pytest.raises(ValueError, match="batch_size 12: 6 rows a "
                       "data-parallel rank do not split into "
                       "pp_microbatches=4"):
        plan_mod._check_microbatches({"batch_size": 12, "num_samples": 8},
                                     2, 4)
    with pytest.raises(ValueError, match="sample grid's model call of 12 "
                       "rows: 6 rows .* pp_microbatches=4"):
        plan_mod._check_microbatches({"batch_size": 8, "num_samples": 6,
                                      "conditional": True,
                                      "num_classes": 10}, 2, 4)
    plan_mod._check_microbatches({"batch_size": 8, "num_samples": 4,
                                  "conditional": True, "num_classes": 10},
                                 2, 4)
    monkeypatch.setattr(plan_mod, "process_count", lambda: 6)
    with pytest.raises(ValueError, match="pipeline_parallel=2 x "
                       "tensor_parallel=2 does not divide 6 devices"):
        check_config({"pipeline_parallel": 2, "tensor_parallel": 2}, dit())


TRAINER_KINDS = ("vae", "classifier", "consistency")


@pytest.mark.parametrize("key", ["pipeline_parallel", "expert_parallel"])
@pytest.mark.parametrize("kind", TRAINER_KINDS)
def test_data_parallel_trainers_refuse_pipeline_and_experts(kind, key):
    """The VAE, classifier and few-step trainers are data parallel only, as
    in JAX: both keys raise, naming them, before any layout is made."""
    config = {"vae": {"model_type": "vae", "image_size": (8, 8),
                      "model_params": {"in_channels": 3, "base_channels": 8,
                                       "channel_mult": (1,),
                                       "latent_channels": 2,
                                       "num_res_blocks": 1}},
              "classifier": {"model_type": "classifier",
                             "image_size": (8, 8), "num_classes": 10,
                             "conditional": True,
                             "model_params": {"in_channels": 3,
                                              "model_channels": 8,
                                              "channel_mult": (1,),
                                              "num_res_blocks": 1,
                                              "attention_resolutions": ()}},
              "consistency": {"model_type": "unet", "image_size": (8, 8),
                              "diffusion_type": "consistency",
                              "model_params": {"in_channels": 3,
                                               "model_channels": 8,
                                               "channel_mult": (1,),
                                               "num_res_blocks": 1,
                                               "attention_resolutions": ()}},
              }[kind]
    job = {"kind": kind, "config": dict(config, **{key: 2}),
           "batches": [None]}
    with pytest.raises(ValueError, match="data-parallel only: "
                       "tensor_parallel, sequence_parallel, "
                       "pipeline_parallel, expert_parallel and fsdp"):
        build_trainer(job)


# ------------------------------------------------------------ the steps
@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    out = {"data": batches(5, 2, (BATCH, 16, 16, 3)), "tmp": tmp}
    for name, make, conditional in (("dit", jax_dit, True),
                                    ("uncond", jax_dit, False),
                                    ("dim", jax_dim, True)):
        model, params, cfg = make(conditional, seed=0, size=16)
        config = dict(train_config(cfg, tmp / name), batch_size=BATCH)
        out[name] = dict(model=model, params=params, config=config,
                         state=numpy_state(state_dict_from_jax(params, cfg)))
    return out


def job(setup, data, dropout=True, **changes):
    config = dict(setup["config"], **changes)
    if not dropout:
        config = dict(config, model_params=dict(config["model_params"],
                                                dropout=0.0))
    return dict(config=config, state=setup["state"], batches=data, seed=11)


def one_device(j):
    """The port's one-device step of job `j` (no parallel key)."""
    config = {k: v for k, v in j["config"].items() if k not in PARALLEL_KEYS}
    return train_job(dict(j, config=config))


LAYOUTS = {  # name: (setup, layout keys, (dp, pp, tp, M))
    "dit": ("dit", {"pipeline_parallel": 2}, (2, 2, 1, None)),
    "uncond": ("uncond", {"pipeline_parallel": 2}, (2, 2, 1, None)),
    "dim": ("dim", {"pipeline_parallel": 2}, (2, 2, 1, None)),
    "pptp": ("dit", {"pipeline_parallel": 2, "tensor_parallel": 2},
             (1, 2, 2, None)),
    "m4": ("dit", {"pipeline_parallel": 2, "pp_microbatches": 4},
           (2, 2, 1, 4)),
}


@pytest.fixture(scope="module")
def world4(setups):
    data, tmp = setups["data"], setups["tmp"]
    # a one-device checkpoint for a pipeline run to resume
    start = job(setups["dit"], data[:1])
    start["config"] = dict(start["config"], save_dir=str(tmp / "one"))
    saved = one_device(dict(start, save=True))
    jobs = {}
    for name, (setup, keys, _) in LAYOUTS.items():
        jobs[f"{name}_jax"] = job(setups[setup], data, False, **keys)
        jobs[f"{name}_drop"] = job(setups[setup], data, **keys)
    # the DiT's pipeline step writes its checkpoint; another resumes the
    # one-device checkpoint
    jobs["dit_drop"]["save"] = True
    jobs["dit_drop"]["config"] = dict(jobs["dit_drop"]["config"],
                                      save_dir=str(tmp / "pp"))
    resume = job(setups["dit"], [], pipeline_parallel=2)
    resume["config"] = dict(resume["config"], resume_path=str(
        tmp / "one" / "current_model.pth"), save_dir=str(tmp / "resumed"))
    jobs["resume"] = resume
    # in-training grids of 4 images (CFG: 8 rows, 4 a data rank, 2 a
    # microbatch) through the pipeline, DDPM over 10 steps
    for name, keys in (("grid", {"pipeline_parallel": 2}),
                       ("grid_pptp", {"pipeline_parallel": 2,
                                      "tensor_parallel": 2})):
        grid = job(setups["dit"], [], **keys)
        grid["config"] = dict(grid["config"], num_timesteps=10,
                              num_samples=4)
        jobs[name] = dict(grid, sample=4)
    results = dict(zip(jobs, run_world(4, list(jobs.values()))))
    return jobs, results, saved


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_pp_step_matches_the_jax_pipeline_step(setups, world4, name):
    """(2 data, 2 stage) for the conditional and unconditional DiT and the
    DiM, (1 data, 2 stage, 2 model) for the DiT, and four microbatches,
    against the JAX package's `make_pipeline_apply` step on the same mesh:
    losses and parameters after two steps at 2e-4."""
    jobs, results, _ = world4
    setup_name, _, (dp, pp, tp, micro) = LAYOUTS[name]
    s = setups[setup_name]
    config = jobs[f"{name}_jax"]["config"]
    losses, params = jax_pp_steps(s["model"], s["params"], config,
                                  setups["data"], dp=dp, pp=pp, tp=tp,
                                  microbatches=micro)
    check_against_jax(results[f"{name}_jax"], losses, params, config)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_pp_step_with_dropout_is_the_one_device_step(world4, name):
    """With dropout 0.1 (each stage replays the one-device draws and keeps
    its blocks' masks and attention seeds, a microbatch its rows), each
    layout's two steps are the one-device steps on the same global
    batches: losses, every update's gathered gradients, parameters and
    EMA."""
    jobs, results, _ = world4
    j = jobs[f"{name}_drop"]
    check_against_one_device(results[f"{name}_drop"],
                             one_device(dict(j, save=False)))


def test_a_stage_rank_holds_only_its_blocks(world4):
    """Stage s of 2 holds block s of the depth-2 models under its
    single-device name, and the prologue and final layer whole; under PP x
    TP its heads' slices."""
    _, results, _ = world4
    for name, tp in (("dit_drop", 1), ("dim_drop", 1), ("pptp_drop", 2)):
        by_rank = results[name]["names_by_rank"]
        for rank, names in enumerate(by_rank):
            stage = (rank // tp) % 2
            blocks = {n.split(".")[1] for n in names
                      if n.startswith("blocks.")}
            assert blocks == {str(stage)}, (name, rank, blocks)
            assert "pos_embed" in names
            assert any(n.startswith("final_layer.") for n in names)
    shapes = results["pptp_drop"]["local_shapes"]
    assert shapes["blocks.0.attn.in_proj_weight"] == (3 * 32, 64)


def test_a_pipeline_checkpoint_resumes_in_one_process_and_back(setups,
                                                              world4):
    """The pipeline run's checkpoint holds the single-device names and
    shapes (parameters, EMA, optimizer state) and resumes in one process
    to the run's parameters and optimizer state; a one-device checkpoint
    resumes in the pipeline world to its own."""
    jobs, results, saved = world4
    run = results["dit_drop"]
    path = setups["tmp"] / "pp" / "current_model.pth"
    config = dict(jobs["dit_drop"]["config"], resume_path=str(path))
    config = {k: v for k, v in config.items() if k not in PARALLEL_KEYS}
    trainer = build_trainer({"config": config, "state": None})
    state = trainer.model.state_dict()
    assert set(state) == set(run["params"])
    for name, value in state.items():
        torch.testing.assert_close(value, run["params"][name], rtol=0,
                                   atol=0)
    for name, value in trainer.ema_model.state_dict().items():
        torch.testing.assert_close(value, run["ema"][name], rtol=0, atol=0)
    check_optimizer_states(trainer.optimizer.state_dict(), run["opt"])
    assert trainer.start_epoch == 2 and trainer.global_step == 2
    resumed = results["resume"]
    for name, value in saved["params"].items():
        torch.testing.assert_close(resumed["loaded"][name], value, rtol=0,
                                   atol=0)
    check_optimizer_states(resumed["opt"], saved["opt"])


def check_optimizer_states(got, want):
    """Two full optimizer states: the same entries at the same indices,
    equal tensors."""
    assert set(got["state"]) == set(want["state"])
    for index, entry in want["state"].items():
        for key, value in entry.items():
            torch.testing.assert_close(torch.as_tensor(got["state"][index][key]),
                                       torch.as_tensor(value), rtol=0, atol=0)
    assert len(got["param_groups"][0]["params"]) == len(
        want["param_groups"][0]["params"])


@pytest.mark.parametrize("name", ["grid", "grid_pptp"])
def test_the_sample_grid_runs_through_the_pipeline(world4, name):
    """`sample_images` under (2 data, 2 stage) and (1 data, 2 stage, 2
    model): every rank samples its data rank's rows through the stages in
    eval mode and gathers the grid, which is the one-device trainer's grid
    from the same generator (CFG, DDPM over 10 steps, 4 images)."""
    jobs, results, _ = world4
    got = results[name]["samples"]
    want = one_device(jobs[name])["samples"]
    assert got.shape == want.shape == (4, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
