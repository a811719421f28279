"""The PyTorch port's consistency models against the JAX package, on the
CPU: `diffusion/consistency.py` (scalings, grids, pseudo-Huber, the
distillation and training losses, the multistep sampler),
`utils/ema.py`'s gated lerp, and `ConsistencyTrainingTrainer` through
`train`, `sample`, resume, staged grids, the checkpoint interval and its
validations. Inputs come from numpy (or jax.random for the sampler's
re-noising draws) and go to both sides.

Bars, max|port - jax| / max|jax|:
  * scalings, grids, pseudo-Huber: 1e-6 (grids equal);
  * the losses through the small UNet (three perturbed weight sets:
    student, target, teacher) on one shared schedule (the port's
    NoiseSchedule holding the JAX arrays): 2e-4, the forward bar;
  * the multistep sampler at 1, 2 and 4 steps, unguided and CFG 3, fed
    JAX's own re-noising draws, each side on its own schedule: 5e-4, the
    sampling bar (a stand-in model affine in x, t and y, and the UNet);
  * one CT trainer step against JAX's loss and the same Optax update and
    gated EMA: the loss and every gradient 2e-4; the updated parameters
    and target 2e-4 where the gradient decides Adam's first update
    (`torch_port_helpers.check_first_adam_update`), 2 lr elsewhere.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_models_collection_tpu import factory as jax_factory
from diffusion_models_collection_tpu.diffusion import (
    consistency as jax_cons,
)
from diffusion_models_collection_tpu.diffusion import base as jax_base
from diffusion_models_collection_tpu.utils import (
    consistency_trainer as jax_ct,
)
from diffusion_models_collection_tpu.utils.ema import (
    gated_ema_update as jax_gated_ema_update,
)
from diffusion_models_collection_tpu.utils.trainer import (
    TrainState,
    build_optimizer as jax_build_optimizer,
)
from diffusion_models_collection_tpu_torch import factory, sample, train
from diffusion_models_collection_tpu_torch.diffusion import (
    ConsistencyModel,
    base,
)
from diffusion_models_collection_tpu_torch.diffusion import consistency
from diffusion_models_collection_tpu_torch.utils import checkpoint
from diffusion_models_collection_tpu_torch.utils.consistency_trainer import (
    ConsistencyTrainingTrainer,
)
from diffusion_models_collection_tpu_torch.utils.ema import gated_ema_update
from diffusion_models_collection_tpu_torch.utils.trainer import (
    build_optimizer,
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
    torch_unet,
    traced_unet,
)

SD, TS = 0.5, 10.0
B = 4


def rng_batch(seed, n=B):
    rng = np.random.default_rng(seed)
    return dict(
        x0=rng.uniform(-1, 1, (n, H, W, 3)).astype(np.float32),
        noise=rng.standard_normal((n, H, W, 3)).astype(np.float32),
        labels=rng.integers(0, 10, n).astype(np.int64),
        drop=rng.uniform(size=n) < 0.3)


# ------------------------------------------------------------ formulas
@pytest.mark.parametrize("sd,ts", [(0.5, 10.0), (0.25, 1.0)])
def test_scalings_match_jax_with_the_exact_boundary(sd, ts):
    t = np.array([0, 1, 7, 500, 999])
    ref = jax_cons.consistency_scalings(jnp.asarray(t), 4, sd, ts)
    ours = consistency.consistency_scalings(torch.from_numpy(t), 4, sd, ts)
    for a, b in zip(ours, ref):
        assert a.shape == (5, 1, 1, 1)
        assert max_rel(a, b) <= 1e-6
    assert ours[0][0].item() == 1.0 and ours[1][0].item() == 0.0


@pytest.mark.parametrize("num_timesteps,size", [(1000, 2), (1000, 3),
                                                (1000, 50), (100, 10)])
def test_cd_grids_equal_jax(num_timesteps, size):
    ours = consistency.cd_grids(num_timesteps, size)
    ref = jax_cons.cd_grids(num_timesteps, size)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ours[1][-1].item() == 0
    with pytest.raises(ValueError, match=">= 2 points"):
        consistency.cd_grids(num_timesteps, 1)


def test_pseudo_huber_matches_jax():
    diff = np.random.default_rng(0).standard_normal((3, 4, 4, 3)).astype(
        np.float32) * np.array([1e-3, 1.0, 30.0], np.float32)[:, None,
                                                            None, None]
    for c in (0.03, 1.0):
        ref = jax_cons.pseudo_huber(jnp.asarray(diff), c)
        ours = consistency.pseudo_huber(torch.from_numpy(diff), c)
        assert max_rel(ours, ref) <= 1e-6


# ------------------------------------------------------------ the losses
@pytest.fixture(scope="module")
def models():
    """The small UNet in three perturbed weight sets (student, target,
    teacher), both frameworks, dropout 0 on the port's side (JAX's eval
    mode)."""
    model, student, config = traced_unet(seed=1)
    _, target, _ = traced_unet(seed=2)
    _, teacher, _ = traced_unet(seed=3)
    config = dict(config, model_params=dict(config["model_params"],
                                            dropout=0.0))
    return dict(model=model, config=config,
                jax=dict(student=student, target=target, teacher=teacher),
                torch={k: torch_unet(p, config) for k, p in
                       (("student", student), ("target", target),
                        ("teacher", teacher))})


# each loss type, each CT weighting, CD guided and not
LOSS_CASES = [("cd", "huber", 0.0), ("cd", "l2", 3.0),
              ("ct", "huber", "inverse_gap"), ("ct", "l2", "uniform")]


@pytest.fixture(scope="module")
def jax_losses(models):
    """Every case of LOSS_CASES from one jitted JAX computation, and its
    inputs."""
    jsched, _ = shared_schedule()
    model, p = models["model"], models["jax"]
    b = rng_batch(0)
    t_arr, t_next_arr = jax_cons.cd_grids(1000, 10)
    idx = np.array([0, 3, 8, 5])
    t, t_next = np.asarray(t_arr)[idx], np.asarray(t_next_arr)[idx]
    y = np.where(b["drop"], 0, b["labels"] + 1).astype(np.int32)
    z = np.asarray(jax_base.q_sample(jsched, b["x0"], t, b["noise"]))

    def pair(params):
        return jax_base.wrap_model_as_eps_x0(
            jsched, lambda x, tt, yy=None: model.apply({"params": params},
                                                      x, tt, yy), "eps")

    @jax.jit
    def run(ps, pt, pte):
        out = {}
        for kind, loss, w in LOSS_CASES:
            common = dict(sigma_data=SD, timestep_scaling=TS,
                          loss_type=loss)
            if kind == "cd":
                out[(kind, loss, w)] = jax_cons.consistency_distill_loss(
                    jsched, pair(ps), pair(pt), pair(pte), z, t, t_next, y,
                    distill_cfg_scale=w, **common)
            else:
                out[(kind, loss, w)] = jax_cons.consistency_training_loss(
                    jsched, pair(ps), pair(pt), b["x0"], b["noise"], t,
                    t_next, y, weighting=w, **common)
        return out

    inputs = dict(b, z=z, t=t, t_next=t_next, y=y)
    return run(p["student"], p["target"], p["teacher"]), inputs


@pytest.mark.parametrize("kind,loss,w", LOSS_CASES)
def test_losses_match_jax_on_the_same_weights(models, jax_losses, kind,
                                              loss, w):
    refs, b = jax_losses
    _, sched = shared_schedule()
    pair = {k: base.wrap_model_as_eps_x0(sched, m, "eps")
            for k, m in models["torch"].items()}
    tt = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    y = tt["y"].to(torch.int64)
    common = dict(sigma_data=SD, timestep_scaling=TS, loss_type=loss)
    if kind == "cd":
        ours = consistency.consistency_distill_loss(
            sched, pair["student"], pair["target"], pair["teacher"], tt["z"],
            tt["t"], tt["t_next"], y, distill_cfg_scale=w, **common)
    else:
        ours = consistency.consistency_training_loss(
            sched, pair["student"], pair["target"], tt["x0"], tt["noise"],
            tt["t"], tt["t_next"], y, weighting=w, **common)
    assert ours.requires_grad  # the student's side only carries a gradient
    assert max_rel(ours.detach(), refs[(kind, loss, w)]) <= 2e-4


def test_loss_validation_matches_jax():
    _, sched = shared_schedule(100)
    jsched, _ = shared_schedule(100)
    x = np.zeros((2, 4, 4, 3), np.float32)
    t = np.array([10, 10])

    def jpair(xx, tt, yy=None):
        return jnp.zeros_like(xx), jnp.zeros_like(xx)

    def tpair(xx, tt, yy=None):
        return torch.zeros_like(xx), torch.zeros_like(xx)

    for key, value in (("loss_type", "nope"), ("weighting", "nope")):
        with pytest.raises(ValueError) as ref:
            jax_cons.consistency_training_loss(
                jsched, jpair, jpair, x, x, t, t, None, sigma_data=SD,
                timestep_scaling=TS, **{key: value})
        with pytest.raises(ValueError) as ours:
            consistency.consistency_training_loss(
                sched, tpair, tpair, torch.from_numpy(x), torch.from_numpy(x),
                torch.from_numpy(t), torch.from_numpy(t), None,
                sigma_data=SD, timestep_scaling=TS, **{key: value})
        assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="guided distillation needs"):
        consistency.consistency_distill_loss(
            sched, tpair, tpair, tpair, torch.from_numpy(x),
            torch.from_numpy(t), torch.from_numpy(t), None, sigma_data=SD,
            timestep_scaling=TS, distill_cfg_scale=2.0)


# ------------------------------------------------------------ the sampler
def jax_renoise_draws(key, steps, shape):
    """The re-noising draws of the JAX sampler called with `key` and an
    init noise: after `_run`'s split, each step splits its key."""
    rng, _ = jax.random.split(key)
    out = []
    for _ in range(steps - 1):
        rng, noise_rng = jax.random.split(rng)
        out.append(torch.tensor(np.asarray(jax.random.normal(
            noise_rng, shape, jnp.float32))))
    return out


@pytest.mark.parametrize("steps", [1, 2, 4])
@pytest.mark.parametrize("cfg_scale", [None, 3.0])
def test_sampler_matches_jax_on_its_draws(steps, cfg_scale):
    shape = (3, 8, 8, 3)
    init = np.random.default_rng(steps).standard_normal(shape).astype(
        np.float32)
    y = np.array([1, 4, 9])
    key = jax.random.PRNGKey(steps)
    jcm = jax_cons.ConsistencyModel(num_timesteps=1000,
                                    num_inference_steps=steps)
    cm = ConsistencyModel(num_timesteps=1000, num_inference_steps=steps)
    np.testing.assert_array_equal(cm.inference_timesteps.numpy(),
                                  np.asarray(jcm.inference_timesteps))
    noises = jax_renoise_draws(key, steps, shape)
    jfn = jax.tree_util.Partial(lambda x, t, yy: affine_xty(x, t, yy, jnp))

    def tfn(x, t, yy):
        return affine_xty(x, t, yy, torch)
    if cfg_scale is None:
        ref = jcm.sample(jfn, shape, key, y=jnp.asarray(y, jnp.int32),
                         init_noise=jnp.asarray(init),
                         return_all_timesteps=True)
        ours = cm.sample(tfn, shape, y=torch.from_numpy(y),
                         init_noise=torch.from_numpy(init), noises=noises,
                         return_all_timesteps=True)
    else:
        ref = jcm.sample_with_cfg(jfn, shape, jnp.asarray(y, jnp.int32), key,
                                  cfg_scale=cfg_scale,
                                  init_noise=jnp.asarray(init),
                                  return_all_timesteps=True)
        ours = cm.sample_with_cfg(tfn, shape, torch.from_numpy(y),
                                  cfg_scale=cfg_scale,
                                  init_noise=torch.from_numpy(init),
                                  noises=noises, return_all_timesteps=True)
    assert ours.shape == (steps, *shape)
    assert max_rel(ours, ref) <= 5e-4


def test_sampler_through_the_unet_matches_jax(models):
    """2 steps with CFG 3 through the small UNet (the target weights)."""
    shape = (2, H, W, 3)
    init = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    y = np.array([3, 8])
    key = jax.random.PRNGKey(11)
    model, params = models["model"], models["jax"]["target"]
    ref = jax_cons.ConsistencyModel(num_inference_steps=2).sample_with_cfg(
        jax.tree_util.Partial(lambda x, t, yy: model.apply(
            {"params": params}, x, t, yy)), shape, jnp.asarray(y, jnp.int32),
        key, cfg_scale=3.0, init_noise=jnp.asarray(init))
    ours = ConsistencyModel(num_inference_steps=2).sample_with_cfg(
        models["torch"]["target"], shape, torch.from_numpy(y), cfg_scale=3.0,
        init_noise=torch.from_numpy(init),
        noises=jax_renoise_draws(key, 2, shape))
    assert np.isfinite(ours.numpy()).all()
    assert max_rel(ours, ref) <= 5e-4


def test_sampler_scale_one_is_the_conditional_model_and_validates():
    cm = ConsistencyModel(num_timesteps=100, num_inference_steps=2,
                          clip_sample=False)
    gen = torch.Generator().manual_seed(0)
    init = torch.randn(3, 4, 4, 3, generator=gen)
    noises = [torch.randn(3, 4, 4, 3, generator=gen)]
    y = torch.tensor([1, 2, 3])

    def fn(x, t, yy):
        return affine_xty(x, t, yy, torch)
    cond = cm.sample_with_cfg(fn, init.shape, y, cfg_scale=1.0,
                              p_threshold=None, init_noise=init,
                              noises=noises)
    plain = cm.sample(fn, init.shape, y=y, init_noise=init, noises=noises)
    torch.testing.assert_close(cond, plain, rtol=0, atol=0)
    with pytest.raises(ValueError, match="prediction type"):
        ConsistencyModel(prediction_type="nope")
    with pytest.raises(ValueError, match=">= 1"):
        ConsistencyModel(num_inference_steps=0)
    with pytest.raises(ValueError, match="noises: 2 given for 1 steps"):
        cm.sample(fn, init.shape, y=y, init_noise=init, noises=noises * 2)


# ------------------------------------------------------------ the trainer
def ct_config(tmp_path, **changes):
    """A consistency-training config of the small UNet, dropout 0."""
    config = dict(
        small_config(), diffusion_type="consistency",
        consistency_grid_size=10, consistency_sample_steps=2,
        target_ema_decay=0.9, cfg_dropout_prob=0.1, epochs=2, batch_size=B,
        optimizer="adamw", learning_rate=1e-3, weight_decay=1e-4,
        use_scheduler=False, save_dir=str(tmp_path / "ct"), seed=0)
    config["model_params"] = dict(config["model_params"], dropout=0.0)
    config.update(changes)
    return config


def test_gated_ema_freezes_on_accumulation_micro_steps():
    params = [torch.nn.Parameter(torch.ones(3))]
    ema = [torch.zeros(3)]
    opt = build_optimizer({"learning_rate": 0.1, "optimizer": "adamw",
                           "gradient_accumulation_steps": 2}, params, 1)
    params[0].grad = torch.ones(3)
    applied = opt.step()
    gated_ema_update(applied, ema, params, 0.5)
    assert not applied and ema[0].abs().max().item() == 0.0
    params[0].grad = torch.ones(3)
    applied = opt.step()
    gated_ema_update(applied, ema, params, 0.5)
    assert applied
    torch.testing.assert_close(ema[0], 0.5 * params[0].detach())


def test_one_ct_trainer_step_matches_jax(models, tmp_path):
    config = ct_config(tmp_path)
    model, params = models["model"], models["jax"]["student"]
    jsched, sched = shared_schedule()
    b = rng_batch(3)
    idx = np.array([1, 0, 8, 4])
    t_arr, t_next_arr = jax_cons.cd_grids(1000, 10)
    t, t_next = np.asarray(t_arr)[idx], np.asarray(t_next_arr)[idx]
    y = np.where(b["drop"], 0, b["labels"] + 1).astype(np.int32)
    tx, _, _ = jax_build_optimizer(config, 1)

    def pair(p):
        return jax_base.wrap_model_as_eps_x0(
            jsched, lambda x, tt, yy=None: model.apply({"params": p}, x, tt,
                                                      yy), "eps")

    @jax.jit
    def step(p, ema):
        def loss_fn(pp):
            return jax_cons.consistency_training_loss(
                jsched, pair(pp), pair(jax.lax.stop_gradient(ema)), b["x0"],
                b["noise"], t, t_next, y, sigma_data=SD, timestep_scaling=TS)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, opt_state = tx.update(grads, tx.init(p), p)
        new = optax.apply_updates(p, updates)
        return (loss, grads, new,
                jax_gated_ema_update(tx, opt_state, ema, new, 0.9))

    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    loss_ref, grads_ref, p_ref, ema_ref = step(p_j, p_j)

    student = factory.get_model(config)  # dropout 0: JAX's eval mode
    student.load_state_dict(state_dict_from_jax(params, config))
    trainer = ConsistencyTrainingTrainer(student, [None], config, "cpu")
    trainer.schedule = sched
    grads = recording_gradients(trainer)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    loss = trainer.train_step(tb["x0"], tb["labels"], torch.from_numpy(idx),
                              tb["noise"], tb["drop"])
    assert trainer.optimizer.count == 1
    assert max_rel(loss, loss_ref) <= 2e-4
    for name, want in state_dict_from_jax(grads_ref, config).items():
        assert max_rel(grads[name], want) <= 2e-4, name
    for what, ours, ref in (("params", trainer.model, p_ref),
                            ("target", trainer.ema_model, ema_ref)):
        check_first_adam_update(what, ours.state_dict(),
                                state_dict_from_jax(ref, config), grads,
                                config["learning_rate"])


# --------------------------------------------------------- entry points
def tiny_config(tmp_path, **changes):
    """An 8x8 synthetic consistency config that trains in seconds: 512
    images at batch 128, 4 steps an epoch."""
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
        "diffusion_type": "consistency", "consistency_grid_size": 6,
        "consistency_sample_steps": 2, "target_ema_decay": 0.9,
        "cfg_dropout_prob": 0.1, "epochs": 2, "batch_size": 128,
        "num_workers": 0, "optimizer": "adamw", "learning_rate": 1e-3,
        "save_dir": str(tmp_path / "ct"), "seed": 0,
    }
    config.update(changes)
    path = tmp_path / f"config_{len(list(tmp_path.glob('config_*')))}.json"
    path.write_text(json.dumps(config))
    return str(path), config


def test_train_cli_trains_consistency_and_sample_runs_it(tmp_path):
    cfg_path, config = tiny_config(tmp_path)
    trainer = train.main(["--config", cfg_path, "--device", "cpu"])
    assert isinstance(trainer, ConsistencyTrainingTrainer)
    assert (trainer.global_step, trainer.optimizer.count) == (8, 8)
    ckpt = tmp_path / "ct" / "consistency_model.pth"
    payload = torch.load(ckpt, weights_only=True)
    assert (tmp_path / "ct" / "current_model.pth").is_file()
    assert payload["epoch"] == 2
    assert {k: payload["config"][k] for k in (
        "diffusion_type", "num_inference_steps", "sigma_data",
        "timestep_scaling")} == {"diffusion_type": "consistency",
                                 "num_inference_steps": 2,
                                 "sigma_data": 0.5, "timestep_scaling": 10.0}
    moved = max((a - b).abs().max().item() for a, b in zip(
        payload["model_state_dict"].values(),
        payload["ema_model_state_dict"].values()))
    assert moved > 0  # the target lags the student
    for flags, steps in (([], 2), (["--num_inference_steps", "1"], 1)):
        result = sample.main([
            "--checkpoint", str(ckpt), "--num_samples", "3",
            "--batch_size", "3", "--cfg_scale", "2", "--use_ema",
            "--sampling_method", "ddim", "--device", "cpu",
            "--output_dir", str(tmp_path / f"s{steps}"), *flags])
        assert result["samples"].shape == (3, 8, 8, 3)
        assert np.isfinite(result["samples"]).all()


def test_a_checkpoint_of_the_jax_trainer_samples_as_in_jax(
        models, tmp_path, monkeypatch):
    """The JAX trainer's own `_save` writes a `.ckpt`; the port loads it,
    its factory builds the sampler, and 2 unguided steps from the target
    network, fed JAX's draws, equal JAX's."""
    _, params, _ = traced_unet(seed=1)
    _, ema, _ = traced_unet(seed=2)
    config = ct_config(tmp_path)
    monkeypatch.setattr(jax_factory, "init_model_params",
                        lambda *a, **k: params)
    jt = jax_ct.ConsistencyTrainingTrainer(
        jax_factory.get_model(config), [], config,
        rng=jax.random.PRNGKey(0), tracker=jax_ct.NullTracker())
    jt.optimizer, _, _ = jax_build_optimizer(config, 1)
    jt._save(3, TrainState(params=params, opt_state=jt.optimizer.init(params),
                           ema_params=ema), 0.25)
    path = tmp_path / "ct" / "consistency_model.ckpt"
    payload = checkpoint.load_checkpoint(path)
    cfg = dict(payload["config"])
    assert payload["epoch"] == 3 and cfg["diffusion_type"] == "consistency"
    model = factory.load_model_for_inference(payload, cfg, True, "cpu")
    cm = factory.get_diffusion(cfg, "ddpm")
    assert isinstance(cm, ConsistencyModel) and cm.num_inference_steps == 2
    shape = (2, H, W, 3)
    init = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    y = np.array([2, 5])
    key = jax.random.PRNGKey(4)
    jmodel = models["model"]
    ref = jax_factory.get_diffusion(cfg).sample(
        jax.tree_util.Partial(lambda x, t, yy: jmodel.apply(
            {"params": ema}, x, t, yy)), shape, key,
        y=jnp.asarray(y, jnp.int32), init_noise=jnp.asarray(init))
    ours = cm.sample(model, shape, y=torch.from_numpy(y),
                     init_noise=torch.from_numpy(init),
                     noises=jax_renoise_draws(key, 2, shape))
    assert max_rel(ours, ref) <= 5e-4


def test_resume_continues_the_epoch_count_and_refuses_other_checkpoints(
        tmp_path):
    cfg_path, config = tiny_config(tmp_path, epochs=1)
    train.main(["--config", cfg_path, "--device", "cpu"])
    ckpt = tmp_path / "ct" / "current_model.pth"
    cfg_path, _ = tiny_config(tmp_path, epochs=2, resume_path=str(ckpt))
    resumed = train.main(["--config", cfg_path, "--device", "cpu"])
    assert (resumed.start_epoch, resumed.global_step) == (1, 8)
    assert resumed.optimizer.count == 8
    assert torch.load(ckpt, weights_only=True)["epoch"] == 2
    other = tmp_path / "ddpm.pth"
    payload = torch.load(ckpt, weights_only=True)
    checkpoint.save_checkpoint(other, payload["model_state_dict"],
                               dict(config, diffusion_type="ddpm"))
    cfg_path, _ = tiny_config(tmp_path, resume_path=str(other))
    with pytest.raises(ValueError, match="not a consistency checkpoint"):
        train.main(["--config", cfg_path, "--device", "cpu"])


def test_grid_stages_and_target_decay_zero(tmp_path):
    """ct_grid_schedule [4, 8] over 3 epochs: 1 epoch on 4 points, 2 on 8
    (the remainder to the last stage); mu 0 keeps the target at the
    student."""
    cfg_path, _ = tiny_config(tmp_path, ct_grid_schedule=[4, 8], epochs=3,
                              target_ema_decay=0.0,
                              ct_weighting="inverse_gap")
    trainer = train.main(["--config", cfg_path, "--device", "cpu"])
    assert trainer.grid_for_epoch() == [4, 8, 8]
    assert trainer.grid_size == 8 and len(trainer.grid[0]) == 7
    for a, b in zip(trainer.model.state_dict().values(),
                    trainer.ema_model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    sizes = [json.loads(line)["ct/grid_size"] for line in (
        tmp_path / "ct" / "run.metrics.jsonl").read_text().splitlines()
        if "ct/grid_size" in line]
    assert sizes == [4, 8, 8]


def test_save_current_interval_limits_the_writes(tmp_path, monkeypatch):
    _, config = tiny_config(tmp_path, epochs=3, save_current_interval=2)
    trainer = ConsistencyTrainingTrainer(
        factory.get_model(config), [], config, "cpu")
    saved = []
    monkeypatch.setattr(trainer, "save",
                        lambda names, epoch, best, cfg: saved.append(epoch))
    monkeypatch.setattr(trainer, "run_epoch", lambda *a: 0.5)
    trainer.train()
    assert saved == [2, 3]


@pytest.mark.parametrize("changes", [
    {"ct_weighting": "nope"}, {"target_ema_decay": 1.0},
    {"ct_grid_schedule": [1]}, {"zero_terminal_snr": True},
    {"epochs": 2, "ct_grid_schedule": [4, 8, 16]},
    {"super_resolution": {"factor": 2}},
])
def test_trainer_validation_matches_jax(tmp_path, changes):
    config = ct_config(tmp_path, **changes)
    with pytest.raises(ValueError) as ref:
        jax_ct.ConsistencyTrainingTrainer(None, [], config)
    with pytest.raises(ValueError) as ours:
        ConsistencyTrainingTrainer(None, [], config, "cpu")
    assert str(ours.value) == str(ref.value)
