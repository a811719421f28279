"""The port's expert parallelism (`parallel/expert_parallel.py`, a MoE DiT's
experts over an 'expert' axis with token all-to-alls) and its load-balance
loss over the global batch under every data-parallel layout, against the
JAX package and against the port's own one-device and data-parallel steps,
on the CPU.

The JAX side runs on its virtual CPU devices (`tests/conftest.py`): the MoE
DiT's train step, DDPM's loss plus `moe_aux_weight` 0.01 times the blocks'
mean load-balance loss, over a (data, expert) mesh with the experts sharded,
or over a data mesh with the parameters replicated
(`torch_parallel_helpers.jax_moe_steps`). JAX's step is one program over
the global batch, so its load-balance loss takes f and P over the global
batch. The port runs in one gloo world of four processes for the expert
layouts ((2 data, 2 expert), (1 data, 4 expert), and data parallel 4) and
in one of two for the data-parallel layouts (DDP and FSDP at world 2):
each rank's f and P averaged over the data-parallel group before their
product. Against JAX the model runs with dropout 0; against the port's
one-device step, with dropout 0.1 (the expert buffer's mask is the
one-device draw: a rank keeps its experts and its group's rows). Bars: the
trainer bars of `torch_parallel_helpers.py`; the gradients against JAX at
2e-4 (`TOL_JAX`).
"""

import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.models import DiT as JaxDiT
from diffusion_models_collection_tpu_torch.models import DiT, UNet
from diffusion_models_collection_tpu_torch.parallel.plan import check_config
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from torch_parallel_helpers import (
    TOL_JAX,
    check_against_jax,
    check_against_one_device,
    jax_moe_steps,
    max_rel,
    numpy_state,
    run_world,
    train_config,
)
from torch_parallel_jobs import batches, build_trainer, train_job
from torch_port_helpers import (  # noqa: F401 (autouse: one torch thread)
    DIT_PARAMS,
    one_torch_thread,
    perturbed,
    small_dit_config,
)

BATCH = 8
MOE = dict(num_experts=4, moe_top_k=2, moe_capacity_factor=1.25)
PARALLEL_KEYS = ("expert_parallel", "fsdp")


# ---------------------------------------------------------------- rules
def dit(**kw):
    return DiT(img_size=(8, 8), patch_size=2, hidden_size=32, depth=1,
               num_heads=4, num_classes=10, **kw)


@pytest.mark.parametrize("config,model,match", [
    # test_moe.py: test_expert_parallel_validation
    ({}, dit, r"expert_parallel > 1 needs a MoE model \(DiT with "
              r"num_experts > 0\)"),
    ({"expert_parallel": 3}, lambda: dit(num_experts=4),
     "num_experts 4 not divisible by expert_parallel=3"),
    ({"tensor_parallel": 2}, lambda: dit(num_experts=4),
     "expert_parallel composes with plain data parallelism only"),
    ({"pipeline_parallel": 2}, lambda: dit(num_experts=4),
     "expert_parallel composes with plain data parallelism only"),
    ({"fsdp": True}, lambda: dit(num_experts=4),
     "fsdp cannot be combined with pipeline_parallel, sequence_parallel or "
     "expert_parallel"),
    ({}, lambda: UNet(image_size=(8, 8), model_channels=16,
                      channel_mult=(1,), num_res_blocks=1,
                      attention_resolutions=()),
     "needs a MoE model"),
    ({}, lambda: dit(num_experts=4),
     "expert_parallel=2 does not divide 1 devices"),
])
def test_every_rejection_has_the_jax_message(config, model, match):
    """The JAX trainer's rules for `expert_parallel`, word for word
    (`utils/trainer.py` of the JAX package), in one process."""
    with pytest.raises(ValueError, match=match):
        check_config(dict({"expert_parallel": 2}, **config), model())


# ------------------------------------------------------------ the steps
@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    tmp = tmp_path_factory.mktemp("ep")
    model = JaxDiT(img_size=(16, 16), **dict(DIT_PARAMS, **MOE),
                   num_classes=10)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))["params"]
    params = perturbed(params, 0)
    cfg = small_dit_config(True, 16)
    cfg["model_params"] = dict(cfg["model_params"], **MOE)
    config = dict(train_config(cfg, tmp / "run"), batch_size=BATCH,
                  moe_aux_weight=0.01)
    return dict(model=model, params=params, config=config, tmp=tmp,
                state=numpy_state(state_dict_from_jax(params, cfg)),
                data=batches(5, 2, (BATCH, 16, 16, 3)))


def job(setup, dropout=True, **changes):
    config = dict(setup["config"], **changes)
    if not dropout:
        config = dict(config, model_params=dict(config["model_params"],
                                                dropout=0.0))
    return dict(config=config, state=setup["state"], batches=setup["data"],
                seed=11)


def one_device(j):
    """The port's one-device step of job `j` (no parallel key)."""
    config = {k: v for k, v in j["config"].items() if k not in PARALLEL_KEYS}
    return train_job(dict(j, config=config, save=False))


LAYOUTS = {"ep22": (2, 2), "ep14": (1, 4)}  # name: (dp, ep)


@pytest.fixture(scope="module")
def world4(setup):
    # a one-device checkpoint for an expert-parallel run to resume
    start = job(setup)
    start["config"] = dict(start["config"], save_dir=str(setup["tmp"] / "one"))
    saved = train_job(dict(start, batches=start["batches"][:1], save=True))
    jobs = {}
    for name, (_, ep) in LAYOUTS.items():
        jobs[f"{name}_jax"] = job(setup, False, expert_parallel=ep)
        jobs[f"{name}_drop"] = job(setup, expert_parallel=ep)
    jobs["dp4_drop"] = job(setup)
    jobs["ep22_drop"]["save"] = True
    jobs["ep22_drop"]["config"] = dict(jobs["ep22_drop"]["config"],
                                       save_dir=str(setup["tmp"] / "ep"))
    resume = job(setup, expert_parallel=2)
    resume["config"] = dict(resume["config"], resume_path=str(
        setup["tmp"] / "one" / "current_model.pth"),
        save_dir=str(setup["tmp"] / "resumed"))
    jobs["resume"] = dict(resume, batches=[])
    results = dict(zip(jobs, run_world(4, list(jobs.values()))))
    results["saved"] = saved
    return jobs, results


@pytest.fixture(scope="module")
def world2(setup):
    """F9's layouts at world 2: DDP and FSDP (every entry sharded), dropout
    0, against the JAX data-parallel step."""
    jobs = {"ddp": job(setup, False),
            "fsdp": job(setup, False, fsdp=True, fsdp_min_size=1)}
    return jobs, dict(zip(jobs, run_world(2, list(jobs.values()))))


@pytest.fixture(scope="module")
def jax_steps(setup):
    """The JAX steps, each once: {(dp, ep): (losses, first gradients,
    parameters)}."""
    config = job(setup, False)["config"]
    return {(dp, ep): jax_moe_steps(setup["model"], setup["params"], config,
                                    setup["data"], dp, ep)
            for dp, ep in ((2, 2), (1, 4), (2, 1))}


def check_gradients(result, jax_grads, config):
    """The port's first update's gathered gradients against JAX's, by
    name, at `TOL_JAX` (the clip comes after both)."""
    want = state_dict_from_jax(jax_grads, config)
    got = result["grads"][0]
    assert set(got) == set(want)
    for name, ref in want.items():
        assert max_rel(got[name], np.asarray(ref)) <= TOL_JAX, name


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_ep_step_matches_the_jax_expert_parallel_step(setup, world4,
                                                      jax_steps, name):
    """(2 data, 2 expert) and (1 data, 4 expert) against the JAX package's
    step on the same mesh, the experts sharded over 'expert' and the
    load-balance loss weighted 0.01: losses, the first update's gradients
    and the parameters after two steps at 2e-4."""
    jobs, results = world4
    config = jobs[f"{name}_jax"]["config"]
    losses, grads, params = jax_steps[LAYOUTS[name]]
    check_against_jax(results[f"{name}_jax"], losses, params, config)
    check_gradients(results[f"{name}_jax"], grads, config)


@pytest.mark.parametrize("name", ["ep22", "ep14", "dp4"])
def test_step_with_dropout_is_the_one_device_step(world4, name):
    """With dropout 0.1 each expert layout's two steps, and data parallel
    4's, are the one-device steps on the same global batches: losses,
    every update's gathered gradients, parameters and EMA (the expert
    buffer's mask is the one-device draw on every layout)."""
    jobs, results = world4
    check_against_one_device(results[f"{name}_drop"],
                             one_device(jobs[f"{name}_drop"]))


def test_ep_step_with_dropout_is_the_data_parallel_step(world4):
    """(2 data, 2 expert) with dropout 0.1 against data parallel 4 in the
    same world: the sharding changes no number beyond float rounding."""
    _, results = world4
    check_against_one_device(results["ep22_drop"], results["dp4_drop"])


def test_an_expert_rank_holds_its_experts(world4):
    """Rank e of an expert group holds experts e E / ep .. of every bank
    (their local shapes), everything else whole."""
    _, results = world4
    for name, (_, ep) in LAYOUTS.items():
        shapes = results[f"{name}_drop"]["local_shapes"]
        assert shapes["blocks.0.mlp.w1"] == (4 // ep, 64, 256)
        assert shapes["blocks.0.mlp.b2"] == (4 // ep, 64)
        assert shapes["blocks.0.mlp.router.weight"] == (4, 64)
        assert shapes["blocks.0.attn.in_proj_weight"] == (3 * 64, 64)


def test_an_ep_checkpoint_resumes_in_one_process_and_back(setup, world4):
    """The expert-parallel run's checkpoint holds the single-device names
    and shapes and reloads into a one-process trainer bit for bit
    (parameters, EMA, optimizer state; test_moe.py:
    test_expert_parallel_checkpoint_interchange); a one-device checkpoint
    resumes in the expert-parallel world to its own parameters and
    optimizer state."""
    jobs, results = world4
    run = results["ep22_drop"]
    path = setup["tmp"] / "ep" / "current_model.pth"
    config = dict(jobs["ep22_drop"]["config"], resume_path=str(path))
    config = {k: v for k, v in config.items() if k not in PARALLEL_KEYS}
    trainer = build_trainer({"config": config, "state": None})
    assert trainer.start_epoch == 2
    for got, want in ((trainer.model, run["params"]),
                      (trainer.ema_model, run["ema"])):
        state = got.state_dict()
        assert set(state) == set(want)
        for name, value in state.items():
            torch.testing.assert_close(value, want[name], rtol=0, atol=0)
    check_optimizer_states(trainer.optimizer.state_dict(), run["opt"])
    resumed, saved = results["resume"], results["saved"]
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
            torch.testing.assert_close(
                torch.as_tensor(got["state"][index][key]),
                torch.as_tensor(value), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["ddp", "fsdp"])
def test_data_parallel_moe_step_matches_the_jax_data_parallel_step(
        setup, world2, jax_steps, name):
    """The load-balance loss under data parallelism is the global batch's
    (JAX's step is one program over it): the port's DDP and FSDP MoE steps
    at world 2, moe_aux_weight 0.01, dropout 0, against the JAX
    data-parallel step: losses, the first update's gradients (the router's
    among them) and the parameters after two steps at 2e-4. Averaging each
    rank's own E sum f P instead moves the router's gradient far past the
    bar."""
    jobs, results = world2
    config = jobs[name]["config"]
    losses, grads, params = jax_steps[(2, 1)]
    check_gradients(results[name], grads, config)
    check_against_jax(results[name], losses, params, config)

