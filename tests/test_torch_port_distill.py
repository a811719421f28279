"""The PyTorch port's distillation against the JAX package, on the CPU:
`diffusion/distill.py` (the grids, the two-step teacher target with its
t = -1 terminal, the student's loss), one step of `DistillationTrainer`
(progressive) and of `ConsistencyDistillationTrainer` (guided) from the
same teacher checkpoint (a JAX `.ckpt`), and the port's `tools/distill.py`
end to end with both methods, its checkpoint names and the validations'
messages. Inputs come from numpy and go to both sides.

Bars, max|port - jax| / max|jax|:
  * grids: equal;
  * the target and the loss through a stand-in model affine in x, t and
    y, on one shared schedule (the port's NoiseSchedule holding the JAX
    arrays): 1e-5 (two model calls, two DDIM steps and a division);
  * one trainer step through the small UNet on the shared schedule: the
    loss and every gradient 2e-4, the forward bar; the updated student and
    its EMA or target 2e-4 where the gradient decides Adam's first update
    (`torch_port_helpers.check_first_adam_update`), 2 lr elsewhere.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_models_collection_tpu.diffusion import base as jax_base
from diffusion_models_collection_tpu.diffusion import (
    consistency as jax_cons,
)
from diffusion_models_collection_tpu.diffusion import distill as jax_distill
from diffusion_models_collection_tpu.utils import (
    consistency_trainer as jax_ct,
)
from diffusion_models_collection_tpu.utils import (
    distill_trainer as jax_dt,
)
from diffusion_models_collection_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from diffusion_models_collection_tpu.utils.ema import (
    gated_ema_update as jax_gated_ema_update,
)
from diffusion_models_collection_tpu.utils.trainer import (
    build_optimizer as jax_build_optimizer,
)
from diffusion_models_collection_tpu_torch import sample, train
from diffusion_models_collection_tpu_torch.diffusion import (
    DDIM,
    ConsistencyModel,
    base,
)
from diffusion_models_collection_tpu_torch.diffusion import distill
from diffusion_models_collection_tpu_torch.factory import get_diffusion
from diffusion_models_collection_tpu_torch.tools import distill as tool
from diffusion_models_collection_tpu_torch.utils.consistency_trainer import (
    ConsistencyDistillationTrainer,
)
from diffusion_models_collection_tpu_torch.utils.distill_trainer import (
    DistillationTrainer,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    H,
    W,
    affine_xty,
    check_first_adam_update,
    max_rel,
    one_torch_thread,
    recording_gradients,
    shared_schedule,
    small_config,
    traced_unet,
)

B = 4


@pytest.mark.parametrize("num_timesteps,steps", [(1000, 1), (1000, 4),
                                                 (100, 8), (1000, 25)])
def test_distill_grids_equal_jax(num_timesteps, steps):
    ours = distill.distill_grids(num_timesteps, steps)
    ref = jax_distill.distill_grids(num_timesteps, steps)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ours[2][-1].item() == -1
    with pytest.raises(ValueError, match=">= 1"):
        distill.distill_grids(num_timesteps, 0)


def stand_in_pair(lib, sched):
    """(eps, x0) of the affine stand-in model on `sched`."""
    return (jax_base if lib is jnp else base).wrap_model_as_eps_x0(
        sched, lambda x, t, y=None: affine_xty(x, t, y, lib), "eps")


@pytest.mark.parametrize("steps", [1, 4])
def test_teacher_target_and_student_loss_match_jax(steps):
    """Every grid point of an N-step student, the last one the t = -1
    terminal (N = 1 has only it)."""
    jsched, sched = shared_schedule()
    rng = np.random.default_rng(steps)
    z = rng.standard_normal((steps, 4, 4, 3)).astype(np.float32)
    y = rng.integers(0, 11, steps)
    jt = jax_distill.distill_grids(1000, steps)
    tt = distill.distill_grids(1000, steps)
    ref = jax_distill.two_step_teacher_target(
        jsched, stand_in_pair(jnp, jsched), jnp.asarray(z), *jt,
        jnp.asarray(y, jnp.int32))
    ours = distill.two_step_teacher_target(
        sched, stand_in_pair(torch, sched), torch.from_numpy(z), *tt,
        torch.from_numpy(y))
    assert tt[2][-1].item() == -1
    assert max_rel(ours, ref) <= 1e-5
    loss_ref = jax_distill.student_distill_loss(
        jsched, stand_in_pair(jnp, jsched), ref, jnp.asarray(z), jt[0],
        jnp.asarray(y, jnp.int32))
    loss = distill.student_distill_loss(
        sched, stand_in_pair(torch, sched), ours, torch.from_numpy(z), tt[0],
        torch.from_numpy(y))
    assert max_rel(loss, loss_ref) <= 1e-5


# ------------------------------------------------------------ trainers
@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """A JAX `.ckpt` of the small conditional UNet, dropout 0, perturbed
    weights: (path, params, flax model, config)."""
    model, params, config = traced_unet(seed=5)
    config = dict(config, model_params=dict(config["model_params"],
                                            dropout=0.0),
                  cfg_dropout_prob=0.2)
    path = tmp_path_factory.mktemp("teacher") / "teacher.ckpt"
    jax_save_checkpoint(path, epoch=1, params=params, opt_state=None,
                        best_loss=1.0, config=config)
    return path, params, model, config


def distill_config(tmp_path, teacher_path, **changes):
    return dict(teacher_checkpoint=str(teacher_path), optimizer="adamw",
                learning_rate=1e-3, weight_decay=1e-4, use_scheduler=False,
                epochs=1, batch_size=B, save_dir=str(tmp_path / "out"),
                seed=0, **changes)


def step_inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(
        x0=rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
        noise=rng.standard_normal((B, H, W, 3)).astype(np.float32),
        labels=rng.integers(0, 10, B).astype(np.int64),
        drop=rng.uniform(size=B) < 0.3)


def compare_step(trainer, config, b, idx, refs):
    """One `train_step` against JAX's (loss, gradients, student, EMA)."""
    loss_ref, grads_ref, p_ref, ema_ref = refs
    grads = recording_gradients(trainer)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss = trainer.train_step(tb["x0"], tb["labels"], torch.from_numpy(idx),
                              tb["noise"], tb["drop"])
    assert trainer.optimizer.count == 1
    assert max_rel(loss, loss_ref) <= 2e-4
    for name, want in state_dict_from_jax(grads_ref, config).items():
        assert max_rel(grads[name], want) <= 2e-4, name
    for what, ours, ref in (("student", trainer.model, p_ref),
                            ("ema", trainer.ema_model, ema_ref)):
        check_first_adam_update(what, ours.state_dict(),
                                state_dict_from_jax(ref, config), grads,
                                trainer.config["learning_rate"])


def jax_pair(model, jsched, p):
    return jax_base.wrap_model_as_eps_x0(
        jsched, lambda x, t, y=None: model.apply({"params": p}, x, t, y),
        "eps")


def test_one_progressive_step_matches_jax(teacher, tmp_path):
    path, params, model, t_cfg = teacher
    config = distill_config(tmp_path, path, distill_steps=4, ema_decay=0.9)
    jsched, sched = shared_schedule()
    b = step_inputs(0)
    idx = np.array([0, 3, 1, 3])  # 3: the terminal t_next = -1
    grids = [np.asarray(g)[idx] for g in jax_distill.distill_grids(1000, 4)]
    y = np.where(b["drop"], 0, b["labels"] + 1).astype(np.int32)
    tx, _, _ = jax_build_optimizer(config, 1)

    @jax.jit
    def step(p):
        z = jax_base.q_sample(jsched, b["x0"], grids[0], b["noise"])
        target = jax.lax.stop_gradient(jax_distill.two_step_teacher_target(
            jsched, jax_pair(model, jsched, p), z, *grids, y))
        loss, grads = jax.value_and_grad(
            lambda pp: jax_distill.student_distill_loss(
                jsched, jax_pair(model, jsched, pp), target, z, grids[0],
                y))(p)
        updates, opt_state = tx.update(grads, tx.init(p), p)
        new = optax.apply_updates(p, updates)
        return (loss, grads, new,
                jax_gated_ema_update(tx, opt_state, p, new, 0.9))

    refs = step(jax.tree_util.tree_map(jnp.asarray, params))
    trainer = DistillationTrainer([None], config, "cpu")
    trainer.start_stage(4)
    trainer.schedule = sched
    compare_step(trainer, t_cfg, b, idx, refs)


def test_one_guided_consistency_distillation_step_matches_jax(teacher,
                                                              tmp_path):
    path, params, model, t_cfg = teacher
    config = distill_config(tmp_path, path, distill_cfg_scale=3.0,
                            consistency_grid_size=10, target_ema_decay=0.9)
    jsched, sched = shared_schedule()
    b = step_inputs(1)
    idx = np.array([8, 0, 4, 2])
    t, t_next = (np.asarray(g)[idx] for g in jax_cons.cd_grids(1000, 10))
    y = np.where(b["drop"], 0, b["labels"] + 1).astype(np.int32)
    tx, _, _ = jax_build_optimizer(config, 1)

    @jax.jit
    def step(p):
        z = jax_base.q_sample(jsched, b["x0"], t, b["noise"])
        pair = jax_pair(model, jsched, p)
        loss, grads = jax.value_and_grad(
            lambda pp: jax_cons.consistency_distill_loss(
                jsched, jax_pair(model, jsched, pp), pair, pair, z, t, t_next,
                y, sigma_data=0.5, timestep_scaling=10.0,
                distill_cfg_scale=3.0))(p)
        updates, opt_state = tx.update(grads, tx.init(p), p)
        new = optax.apply_updates(p, updates)
        return (loss, grads, new,
                jax_gated_ema_update(tx, opt_state, p, new, 0.9))

    refs = step(jax.tree_util.tree_map(jnp.asarray, params))
    trainer = ConsistencyDistillationTrainer([None], config, "cpu")
    trainer.schedule = sched
    compare_step(trainer, t_cfg, b, idx, refs)


# --------------------------------------------------------- the tool
def tiny_teacher(tmp_path, **changes):
    """A DDPM UNet trained one epoch on 8x8 synthetic data by the port's
    `train` (the `.pth` a user would distill), and its config."""
    config = {
        "model_type": "unet",
        "model_params": {"image_size": (8, 8), "in_channels": 3,
                         "model_channels": 16, "out_channels": 3,
                         "num_res_blocks": 1, "attention_resolutions": (4,),
                         "dropout": 0.1, "channel_mult": (1, 2),
                         "use_attention": True},
        "dataset": "synthetic", "image_size": (8, 8), "conditional": True,
        "num_classes": 10, "num_timesteps": 20, "beta_start": 0.0001,
        "beta_end": 0.02, "beta_schedule": "linear", "epochs": 1,
        "batch_size": 128, "num_workers": 0, "optimizer": "adamw",
        "learning_rate": 1e-3, "use_ema": True, "ema_decay": 0.9,
        "sample_start_epoch": 10, "save_dir": str(tmp_path / "teacher"),
        "seed": 0, **changes}
    path = tmp_path / "teacher.json"
    path.write_text(json.dumps(config))
    train.main(["--config", str(path), "--device", "cpu"])
    return tmp_path / "teacher" / "current_model.pth", config


def run_tool(tmp_path, config):
    path = tmp_path / f"distill_{config['distill_method']}.json"
    path.write_text(json.dumps(config))
    return tool.main(["--config", str(path), "--device", "cpu"])


def test_distill_tool_runs_both_methods_and_sample_runs_the_results(
        tmp_path):
    ckpt, t_cfg = tiny_teacher(tmp_path)
    common = dict(t_cfg, teacher_checkpoint=str(ckpt), epochs=2,
                  ema_decay=0.9)
    trainer = run_tool(tmp_path, dict(
        common, distill_method="progressive", distill_steps=4,
        distill_stages=2, save_dir=str(tmp_path / "pd")))
    assert isinstance(trainer, DistillationTrainer)
    assert trainer.global_step == 2 * 2 * 4  # stages x epochs x batches
    for steps in (4, 2):
        path = tmp_path / "pd" / f"distilled_{steps:04d}step.pth"
        cfg = torch.load(path, weights_only=True)["config"]
        assert (cfg["num_inference_steps"], cfg["distilled_steps"]) == (
            steps, steps)
        assert isinstance(get_diffusion(cfg, "ddim"), DDIM)
        result = sample.main([
            "--checkpoint", str(path), "--sampling_method", "ddim",
            "--num_inference_steps", str(steps), "--num_samples", "3",
            "--batch_size", "3", "--cfg_scale", "1.5", "--use_ema",
            "--device", "cpu", "--output_dir", str(tmp_path / f"s{steps}")])
        assert np.isfinite(result["samples"]).all()

    trainer = run_tool(tmp_path, dict(
        common, distill_method="consistency", distill_cfg_scale=2.0,
        consistency_grid_size=6, save_dir=str(tmp_path / "cd")))
    assert isinstance(trainer, ConsistencyDistillationTrainer)
    path = tmp_path / "cd" / "consistency_model.pth"
    assert (tmp_path / "cd" / "current_model.pth").is_file()
    cfg = torch.load(path, weights_only=True)["config"]
    assert {k: cfg[k] for k in ("diffusion_type", "num_inference_steps",
                                "distilled_cfg_scale", "cfg_scale")} == {
        "diffusion_type": "consistency", "num_inference_steps": 2,
        "distilled_cfg_scale": 2.0, "cfg_scale": 1.0}
    assert isinstance(get_diffusion(cfg, "ddim"), ConsistencyModel)
    result = sample.main([
        "--checkpoint", str(path), "--num_samples", "3", "--batch_size", "3",
        "--use_ema", "--device", "cpu", "--output_dir", str(tmp_path / "c")])
    assert np.isfinite(result["samples"]).all()


@pytest.fixture(scope="module")
def teachers(teacher, tmp_path_factory):
    """JAX `.ckpt` teachers the validations refuse: unconditional, flow
    matching, super-resolution (the weights are the small UNet's; each
    check runs before they are used)."""
    _, params, _, config = teacher
    out = {"vp": teacher[0]}
    root = tmp_path_factory.mktemp("teachers")
    for name, changes in (("unconditional", {"conditional": False}),
                          ("flow", {"diffusion_type": "flow_matching"}),
                          ("sr", {"super_resolution": {"factor": 2}})):
        out[name] = root / f"{name}.ckpt"
        jax_save_checkpoint(out[name], epoch=1, params=params,
                            opt_state=None, best_loss=1.0,
                            config=dict(config, **changes))
    return out


@pytest.mark.parametrize("method,which,changes", [
    ("progressive", "vp", {"distill_steps": 3}),
    ("progressive", "vp", {"distill_steps": 4, "distill_stages": 4}),
    ("progressive", "flow", {}),
    ("progressive", "sr", {}),
    ("consistency", "flow", {}),
    ("consistency", "sr", {}),
    ("consistency", "unconditional", {"distill_cfg_scale": 2.0}),
])
def test_validation_matches_jax(teachers, tmp_path, method, which, changes):
    config = distill_config(tmp_path, teachers[which], **changes)
    jax_class, port_class = {
        "progressive": (jax_dt.DistillationTrainer, DistillationTrainer),
        "consistency": (jax_ct.ConsistencyDistillationTrainer,
                        ConsistencyDistillationTrainer)}[method]
    with pytest.raises(ValueError) as ref:
        jax_class([], config)
    with pytest.raises(ValueError) as ours:
        port_class([], config, "cpu")
    assert str(ours.value) == str(ref.value)


def test_tool_refuses_an_unknown_method(tmp_path):
    with pytest.raises(ValueError, match="Unknown distill_method: 'nope'"):
        run_tool(tmp_path, {"distill_method": "nope", "image_size": 8})


def test_tool_refuses_a_torchrun_world(tmp_path, monkeypatch):
    """The tool joins no process group: under torchrun at WORLD_SIZE 2 every
    rank would run the whole distillation and write the same files, so it
    raises, naming the ROADMAP item of data parallelism outside train,
    before it reads its config."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="item 15d"):
        tool.main(["--config", str(tmp_path / "absent.py"), "--device",
                   "cpu"])
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(FileNotFoundError):  # one process goes on to read it
        tool.main(["--config", str(tmp_path / "absent.py"), "--device",
                   "cpu"])
