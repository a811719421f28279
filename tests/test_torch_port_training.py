"""The PyTorch port's training path against the JAX package's, on the CPU.

Held against the JAX code it replaces, with numpy inputs from a fixed seed
given to both sides (the two frameworks' generators never agree):

* `q_sample` and `p_losses` for every loss type, prediction type and loss
  weighting (both sides on the JAX schedule's arrays, so only the loss
  arithmetic is compared): max-rel 1e-6;
* the five learning-rate schedules over the first three epochs: 1e-7;
* `posterior_step` and a 10-step DDPM CFG trajectory from passed-in noises,
  each side on its own schedule: 5e-4, the sampling bar;
* the small UNet's loss and every gradient (dropout 0): 2e-4, the forward
  bar;
* two train steps from the same params, batch, t, noise and CFG drop mask
  (AdamW with weight decay, clip 1.0, warmup-cosine, EMA), without and with
  two-step gradient accumulation: loss, params and EMA against the JAX
  trainer's pieces (`build_optimizer`, `p_losses`, the gated EMA): 2e-4;
* a `.pth` written by the port's trainer, read by the JAX package's
  `load_checkpoint`: the JAX forward equals the port's within 2e-4;
* the entry points on a tiny synthetic config: `train.main` for two epochs,
  resume with epoch extension, a diverged run that stops before the
  checkpoints rotate, resume from a JAX checkpoint, and `sample.main` from
  the trained checkpoint with DDIM and DDPM.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_models_collection_tpu.diffusion import base as jax_base
from diffusion_models_collection_tpu.diffusion import ddpm as jax_ddpm
from diffusion_models_collection_tpu.diffusion import (
    schedule as jax_schedule,
)
from diffusion_models_collection_tpu.utils import (
    lr_schedules as jax_lr_schedules,
)
from diffusion_models_collection_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from diffusion_models_collection_tpu.utils.ema import gated_ema_update
from diffusion_models_collection_tpu.utils.trainer import (
    build_optimizer as jax_build_optimizer,
)
from diffusion_models_collection_tpu_torch import sample, train
from diffusion_models_collection_tpu_torch.diffusion import (
    DDPM,
    NoiseSchedule,
    base,
    posterior_step,
)
from diffusion_models_collection_tpu_torch.models import UNet
from diffusion_models_collection_tpu_torch.utils import lr_schedules
from diffusion_models_collection_tpu_torch.utils.trainer import (
    DiffusionTrainer,
    build_optimizer,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    H,
    MODEL_PARAMS,
    W,
    jax_unet,
    max_rel,
    one_torch_thread,
    shared_schedule,
    small_config,
)


def affine_model(x, t, y, lib):
    """A stand-in model both frameworks run: affine in x and t."""
    tt = t.astype(lib.float32) if lib is jnp else t.to(torch.float32)
    return 0.7 * x - 0.3 + 1e-3 * tt[:, None, None, None]


def batch(seed, n=4, num_timesteps=1000):
    """x0 in [-1, 1], labels 0..9, t, noise and a CFG drop mask."""
    rng = np.random.default_rng(seed)
    return dict(
        x0=rng.uniform(-1, 1, (n, H, W, 3)).astype(np.float32),
        labels=rng.integers(0, 10, n).astype(np.int64),
        t=rng.integers(0, num_timesteps, n).astype(np.int64),
        noise=rng.standard_normal((n, H, W, 3)).astype(np.float32),
        drop=rng.uniform(size=n) < 0.3,
    )


# ------------------------------------------------------------- objective
def test_q_sample_matches_jax():
    jsched, sched = shared_schedule()
    b = batch(0)
    ref = jax_base.q_sample(jsched, b["x0"], b["t"], b["noise"])
    ours = base.q_sample(sched, torch.from_numpy(b["x0"]),
                         torch.from_numpy(b["t"]), torch.from_numpy(b["noise"]))
    assert max_rel(ours, ref) <= 1e-6


@pytest.mark.parametrize("weighting", ["uniform", "snr", "min_snr"])
@pytest.mark.parametrize("prediction_type", ["eps", "v", "x0"])
@pytest.mark.parametrize("loss_type", ["l1", "l2", "huber"])
def test_p_losses_matches_jax(loss_type, prediction_type, weighting):
    jsched, sched = shared_schedule()
    b = batch(1)
    kw = dict(loss_type=loss_type, prediction_type=prediction_type,
              weighting=weighting, snr_gamma=5.0)
    ref = jax_base.p_losses(
        jsched, lambda x, t, y: affine_model(x, t, y, jnp), b["x0"], b["t"],
        b["noise"], **kw)
    ours = base.p_losses(
        sched, lambda x, t, y: affine_model(x, t, y, torch),
        torch.from_numpy(b["x0"]), torch.from_numpy(b["t"]),
        torch.from_numpy(b["noise"]), **kw)
    assert max_rel(ours, ref) <= 1e-6


@pytest.mark.parametrize("scheduler", [
    {"use_scheduler": False},
    {"scheduler_type": "cosine"},
    {"scheduler_type": "linear"},
    {"scheduler_type": "step", "step_size": 2, "gamma": 0.5},
    {"scheduler_type": "warmup_cosine", "warmup_epochs": 2,
     "warmup_start_factor": 0.01},
])
def test_lr_schedules_match_jax(scheduler):
    config = {"learning_rate": 2e-4, "epochs": 7, "use_scheduler": True,
              **scheduler}
    upe = 3
    ours = lr_schedules.build_lr_schedule(config, upe)
    ref = jax_lr_schedules.build_lr_schedule(config, upe)
    counts = range(3 * upe + 1)
    got = [ours(c) for c in counts]
    want = [float(ref(jnp.asarray(c))) for c in counts]
    assert max_rel(got, want) <= 1e-7
    assert (len(set(want)) > 1) == config["use_scheduler"]


def test_posterior_step_matches_jax():
    rng = np.random.default_rng(2)
    x, x0, noise = (rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
                    for _ in range(3))
    t = np.array([999, 500, 1, 0])
    ref = jax_ddpm.posterior_step(jax_schedule.NoiseSchedule.create(1000),
                                  x, t, x0, noise)
    ours = posterior_step(NoiseSchedule.create(1000), torch.from_numpy(x),
                          torch.from_numpy(t), torch.from_numpy(x0),
                          torch.from_numpy(noise))
    assert max_rel(ours, ref) <= 5e-4


@pytest.fixture(scope="module")
def small_models():
    """The small JAX UNet with perturbed params, and the port's UNet with
    the same weights and dropout 0."""
    model, params, config = jax_unet(conditional=True, seed=7)
    tmodel = UNet(**dict(MODEL_PARAMS, dropout=0.0), num_classes=10)
    tmodel.load_state_dict(state_dict_from_jax(params, config), strict=True)
    return model, params, config, tmodel


def test_ddpm_cfg_trajectory_from_passed_noises_matches_jax(small_models):
    model, params, _, tmodel = small_models
    steps = 10
    rng = np.random.default_rng(3)
    init = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    y = np.array([3, 8], np.int64)
    key = jax.random.PRNGKey(0)
    # the JAX sampler's draws: step t uses normal(fold_in(key', t)) with
    # key' the first half of split(key)
    step_key = jax.random.split(key)[0]
    noises = [torch.tensor(np.asarray(jax.random.normal(
        jax.random.fold_in(step_key, t), init.shape, jnp.float32)))
        for t in range(steps - 1, -1, -1)]
    ref = jax_ddpm.DDPM(num_timesteps=steps).sample_with_cfg(
        jax.tree_util.Partial(
            lambda x, t, yy: model.apply({"params": params}, x, t, yy)),
        init.shape, jnp.asarray(y, jnp.int32), key, cfg_scale=3.0,
        init_noise=jnp.asarray(init))
    tmodel.eval()
    ours = DDPM(num_timesteps=steps).sample_with_cfg(
        tmodel, init.shape, torch.from_numpy(y), cfg_scale=3.0,
        init_noise=torch.from_numpy(init), noises=noises)
    assert np.isfinite(ours.numpy()).all()
    assert max_rel(ours, ref) <= 5e-4


# ------------------------------------------------------------ loss, grads
@pytest.fixture(scope="module")
def jax_value_and_grad(small_models):
    """(params, batch) -> (loss, grads) of the JAX DDPM eps-loss of the
    small UNet, jitted once for the module."""
    model = small_models[0]
    ddpm = jax_ddpm.DDPM(num_timesteps=1000)

    @jax.jit
    def value_and_grad(params, x0, t, noise, y):
        def loss_fn(p):
            return ddpm.p_losses(
                lambda x, tt, yy: model.apply({"params": p}, x, tt, yy),
                x0, t, noise, y=y)
        return jax.value_and_grad(loss_fn)(params)

    def run(params, b):
        y = np.where(b["drop"], 0, b["labels"] + 1).astype(np.int32)
        return value_and_grad(params, b["x0"], b["t"].astype(np.int32),
                              b["noise"], y)

    return run


def torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def test_unet_loss_and_every_gradient_match_jax(small_models,
                                               jax_value_and_grad):
    _, params, config, tmodel = small_models
    b = batch(4)
    loss_ref, grads = jax_value_and_grad(params, b)
    grads_ref = state_dict_from_jax(grads, config)
    tb = torch_batch(b)
    y = torch.where(tb["drop"], 0, tb["labels"] + 1)
    tmodel.eval()
    tmodel.zero_grad()
    loss = DDPM(num_timesteps=1000).p_losses(tmodel, tb["x0"], tb["t"],
                                              tb["noise"], y=y)
    loss.backward()
    assert max_rel(loss.detach(), loss_ref) <= 2e-4
    named = dict(tmodel.named_parameters())
    assert set(named) == set(grads_ref)
    for name, g in grads_ref.items():
        assert max_rel(named[name].grad, g) <= 2e-4, name


# ------------------------------------------------------------ train steps
def train_config(tmp_path, accum):
    return dict(
        small_config(), optimizer="adamw", learning_rate=1e-3,
        weight_decay=1e-4, use_scheduler=True, scheduler_type="warmup_cosine",
        epochs=4, warmup_epochs=2, warmup_start_factor=0.1, use_ema=True,
        ema_decay=0.9, cfg_dropout_prob=0.2, gradient_accumulation_steps=accum,
        loss_type="l2", batch_size=4, save_dir=str(tmp_path / "ckpt"),
        sample_dir=str(tmp_path / "samples"), seed=0)


def small_trainer(tmp_path, params, config):
    tmodel = UNet(**dict(MODEL_PARAMS, dropout=0.0), num_classes=10)
    tmodel.load_state_dict(state_dict_from_jax(params, config), strict=True)
    # one batch per epoch per accumulation step: the loader is only measured
    loader = [None] * int(config["gradient_accumulation_steps"])
    return DiffusionTrainer(tmodel, DDPM(num_timesteps=1000), loader, config,
                            "cpu")


@pytest.mark.parametrize("accum", [1, 2])
def test_two_train_steps_match_the_jax_pieces(small_models,
                                              jax_value_and_grad, tmp_path,
                                              accum):
    _, params, _, _ = small_models
    config = train_config(tmp_path, accum)
    batches = [batch(10), batch(11)]

    # JAX: the pieces the JAX trainer's train step composes
    tx, _, _ = jax_build_optimizer(config, 1)

    @jax.jit
    def update(p, opt_state, ema, grads):
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        return p, opt_state, gated_ema_update(tx, opt_state, ema, p,
                                              config["ema_decay"])

    p_j = ema_j = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(p_j)
    losses_ref = []
    for b in batches:
        loss, grads = jax_value_and_grad(p_j, b)
        p_j, opt_state, ema_j = update(p_j, opt_state, ema_j, grads)
        losses_ref.append(float(loss))

    # the port's trainer, with the same draws passed in
    trainer = small_trainer(tmp_path, params, config)
    losses = []
    for b in batches:
        tb = torch_batch(b)
        losses.append(trainer.train_step(tb["x0"], tb["labels"], tb["t"],
                                         tb["noise"], tb["drop"]).item())
    assert trainer.optimizer.count == 2 // accum
    assert max_rel(losses, losses_ref) <= 2e-4
    # every element is compared: Adam's first update is about lr * sign(g),
    # but no gradient here is near enough to zero for its sign to flip
    for what, ours, ref in (
            ("params", trainer.model.state_dict(),
             state_dict_from_jax(p_j, config)),
            ("ema", trainer.ema_model.state_dict(),
             state_dict_from_jax(ema_j, config))):
        for name, want in ref.items():
            assert max_rel(ours[name], want) <= 2e-4, (what, name)


def test_port_checkpoint_loads_in_the_jax_package(small_models, tmp_path):
    model, params, _, _ = small_models
    config = train_config(tmp_path, 1)
    trainer = small_trainer(tmp_path, params, config)
    tb = torch_batch(batch(12))
    trainer.train_step(tb["x0"], tb["labels"], tb["t"], tb["noise"],
                       tb["drop"])
    trainer.save_checkpoint(1)
    path = Path(config["save_dir"]) / "current_model.pth"
    payload = torch.load(path, weights_only=True)
    assert {"epoch", "model_state_dict", "optimizer_state_dict",
            "ema_model_state_dict", "best_loss", "config",
            "global_step"} <= set(payload)
    assert payload["global_step"] == 1
    jax_payload = jax_load_checkpoint(path)
    x = np.random.default_rng(13).standard_normal((2, H, W, 3)).astype(
        np.float32)
    t, y = np.array([10, 700]), np.array([0, 4])
    apply = jax.jit(model.apply)
    for key, tmodel in (("model_state_dict", trainer.model),
                        ("ema_model_state_dict", trainer.ema_model)):
        ref = apply({"params": jax_payload[key]}, jnp.asarray(x),
                    jnp.asarray(t), jnp.asarray(y))
        with torch.no_grad():
            ours = tmodel.eval()(torch.from_numpy(x), torch.from_numpy(t),
                                 torch.from_numpy(y))
        assert max_rel(ours, ref) <= 2e-4, key


# ------------------------------------------------------------ entry points
def tiny_config(tmp_path, **overrides):
    """A synthetic 8x8 config that trains in seconds on the CPU: 512 images
    at batch 128, so 4 steps an epoch."""
    config = {
        "model_type": "unet",
        "model_params": {"image_size": (8, 8), "in_channels": 3,
                         "model_channels": 16, "out_channels": 3,
                         "num_res_blocks": 1, "attention_resolutions": (4,),
                         "dropout": 0.1, "channel_mult": (1, 2),
                         "use_attention": True},
        "dataset": "synthetic", "image_size": (8, 8), "conditional": True,
        "num_classes": 10, "num_timesteps": 20, "beta_start": 0.0001,
        "beta_end": 0.02, "beta_schedule": "linear", "loss_type": "l2",
        "cfg_scale": 1.4, "num_inference_steps": 5, "epochs": 2,
        "batch_size": 128, "num_workers": 0, "optimizer": "adamw",
        "learning_rate": 1e-3, "weight_decay": 1e-4, "use_ema": True,
        "ema_decay": 0.99, "cfg_dropout_prob": 0.2, "use_scheduler": True,
        "scheduler_type": "warmup_cosine", "warmup_epochs": 1,
        "save_dir": str(tmp_path / "ckpt"),
        "sample_dir": str(tmp_path / "samples"), "save_interval": 2,
        "sample_interval": 2, "sample_start_epoch": 2, "num_samples": 4,
        "seed": 42,
    }
    config.update(overrides)
    path = tmp_path / f"config_{len(list(tmp_path.glob('config_*')))}.json"
    path.write_text(json.dumps(config))
    return str(path), config


def read_metrics(save_dir):
    return [json.loads(line) for line in
            (Path(save_dir) / "run.metrics.jsonl").read_text().splitlines()]


def test_train_cli_trains_resumes_with_extension_and_samples(tmp_path):
    cfg_path, config = tiny_config(tmp_path,
                                   profile_dir=str(tmp_path / "profile"))
    save_dir = Path(config["save_dir"])
    trainer = train.main(["--config", cfg_path, "--device", "cpu"])
    assert (trainer.global_step, trainer.optimizer.count) == (8, 8)
    assert (tmp_path / "profile" / "trace.json").is_file()  # first epoch
    for name in ("current_model.pth", "best_model.pth",
                 "model_epoch_0002.pth"):
        assert (save_dir / name).is_file(), name
    assert (Path(config["sample_dir"]) / "epoch_0002.png").is_file()
    losses = [r["train/loss"] for r in read_metrics(save_dir)
              if "train/loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()

    # resuming past the configured epochs extends the run by that many
    cfg_path, _ = tiny_config(
        tmp_path, epochs=1, sample_start_epoch=100, save_best=False,
        resume_path=str(save_dir / "current_model.pth"))
    resumed = train.main(["--config", cfg_path, "--device", "cpu"])
    assert (resumed.start_epoch, resumed.epochs) == (3, 4)
    assert (resumed.global_step, resumed.optimizer.count) == (16, 16)
    ckpt = torch.load(save_dir / "current_model.pth", weights_only=True)
    assert (ckpt["epoch"], ckpt["global_step"]) == (4, 16)
    best = torch.load(save_dir / "best_model.pth", weights_only=True)
    assert best["epoch"] <= 2  # save_best false: no copy after the resume

    for method in ("ddim", "ddpm"):
        out = tmp_path / method
        result = sample.main([
            "--checkpoint", str(save_dir / "current_model.pth"),
            "--sampling_method", method, "--num_samples", "3",
            "--batch_size", "3", "--cfg_scale", "2", "--use_ema",
            "--device", "cpu", "--output_dir", str(out)])
        samples = result["samples"]
        assert samples.shape == (3, 8, 8, 3) and np.isfinite(samples).all()
        assert (out / "samples.png").is_file()


def test_non_finite_loss_stops_before_the_checkpoints_rotate(
        tmp_path, monkeypatch):
    cfg_path, config = tiny_config(tmp_path, epochs=3, save_interval=1,
                                   sample_start_epoch=100)
    real = DDPM.p_losses
    calls = []

    def diverging(self, *args, **kwargs):
        calls.append(1)
        loss = real(self, *args, **kwargs)
        return loss * float("nan") if len(calls) > 4 else loss

    monkeypatch.setattr(DDPM, "p_losses", diverging)
    trainer = train.main(["--config", cfg_path, "--device", "cpu"])
    save_dir = Path(config["save_dir"])
    ckpt = torch.load(save_dir / "current_model.pth", weights_only=True)
    assert ckpt["epoch"] == 1 and np.isfinite(ckpt["best_loss"])
    assert not (save_dir / "model_epoch_0002.pth").exists()
    assert trainer.global_step == 8  # epoch 2 ran, epoch 3 did not
    assert {"train/diverged_epoch": 2}.items() <= read_metrics(
        save_dir)[-1].items()


def test_resume_from_a_jax_checkpoint_starts_a_fresh_optimizer(
        small_models, tmp_path, capsys):
    _, params, config, _ = small_models
    ckpt = tmp_path / "current_model.ckpt"
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    jax_save_checkpoint(ckpt, epoch=3, params=params,
                        opt_state=optax.adamw(1e-4).init(p_j), best_loss=0.5,
                        config=config, ema_params=params,
                        extra={"global_step": 30})
    config = dict(train_config(tmp_path, 1), epochs=10)
    tmodel = UNet(**MODEL_PARAMS, num_classes=10)
    trainer = DiffusionTrainer(tmodel, DDPM(num_timesteps=1000), [None],
                               config, "cpu", resume_path=str(ckpt))
    assert "reinitializing the optimizer" in capsys.readouterr().out
    assert (trainer.start_epoch, trainer.global_step, trainer.best_loss) == (
        4, 30, 0.5)
    want = state_dict_from_jax(params, config)
    for name, value in trainer.model.state_dict().items():
        torch.testing.assert_close(value, want[name], rtol=0, atol=0)


@pytest.mark.parametrize("change", [
    {"tensor_parallel": 2}, {"pipeline_parallel": 2},
    {"sequence_parallel": 2}, {"expert_parallel": 2}, {"fsdp": True},
    {"checkpoint_format": "orbax"},
])
def test_trainer_raises_on_what_is_not_ported(tmp_path, change):
    config = dict(train_config(tmp_path, 1), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DiffusionTrainer(UNet(**MODEL_PARAMS, num_classes=10),
                         DDPM(num_timesteps=10), [None], config, "cpu")


@pytest.mark.parametrize("name", ["adafactor", "lion"])
def test_optimizers_not_ported_raise(name):
    """Adafactor and Lion, which raised until they were ported, build and
    step behind the clip (their formulas against Optax:
    test_torch_port_optimizers.py)."""
    param = torch.nn.Parameter(torch.ones(2))
    opt = build_optimizer({"learning_rate": 1e-3, "optimizer": name},
                          [param], 1)
    param.grad = torch.tensor([3.0, -4.0])
    assert opt.step() and opt.count == 1
    assert param.grad is None
    assert param[0].item() < 1.0 < param[1].item()


def test_train_refuses_cuda_when_absent(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_path, _ = tiny_config(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--config", cfg_path])
