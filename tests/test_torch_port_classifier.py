"""The port's classifier guidance against the JAX package's, on the CPU: the
noise-conditional classifier (`models/classifier.py`) and its weight bridge,
its trainer (`utils/classifier_trainer.py`), the guided eps
(`diffusion/guidance.py`) and a guided DDIM trajectory, and the wiring of
`sample --classifier_checkpoint/--classifier_scale` and `train`.

The same seeded numpy inputs, t, noise and initial noise go to both sides;
the JAX parameters are perturbed (`torch_port_helpers.perturbed`) and carried
over by `utils/weights.py`. Bars, max|port - jax| / max|jax|:

* a classifier forward (logits), with and without `remat`: 2e-4;
* one train step's cross-entropy and every gradient: 2e-4;
* the guided eps on B rows and on a fused-CFG batch of 2B rows: 2e-4, on
  one shared schedule (`shared_schedule`), so only the arithmetic differs;
* a guided DDIM-10 trajectory with CFG: 5e-4.

Scale 0 is the unguided model bit for bit. The SystemExit rules of the
pipeline's `build_classifier` and the trainer's ValueErrors are held to the
JAX package's messages by calling both with the same inputs; a JAX `.ckpt`
classifier guides the port's `sample`.
"""

import functools
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_models_collection_tpu import pipeline as jax_pipeline
from diffusion_models_collection_tpu.diffusion import DDIM as JaxDDIM
from diffusion_models_collection_tpu.diffusion import base as jax_base
from diffusion_models_collection_tpu.diffusion.guidance import (
    classifier_guided_model_fn as jax_guided,
)
from diffusion_models_collection_tpu.diffusion.schedule import (
    NoiseSchedule as JaxSchedule,
)
from diffusion_models_collection_tpu.models import UNet as JaxUNet
from diffusion_models_collection_tpu.models.classifier import (
    NoisyClassifier as JaxClassifier,
)
from diffusion_models_collection_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from diffusion_models_collection_tpu.utils.classifier_trainer import (
    ClassifierTrainer as JaxClassifierTrainer,
)
from diffusion_models_collection_tpu_torch import factory, pipeline, sample
from diffusion_models_collection_tpu_torch import train
from diffusion_models_collection_tpu_torch.diffusion import DDIM
from diffusion_models_collection_tpu_torch.diffusion.guidance import (
    classifier_guided_model_fn,
)
from diffusion_models_collection_tpu_torch.models import NoisyClassifier
from diffusion_models_collection_tpu_torch.utils.classifier_trainer import (
    ClassifierTrainer,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    MODEL_PARAMS,
    max_rel,
    one_torch_thread,
    perturbed,
    shared_schedule,
    small_config,
)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "data"
HW = 16
CLS_PARAMS = dict(in_channels=3, model_channels=16, num_res_blocks=1,
                  attention_resolutions=(8,), channel_mult=(1, 2),
                  use_attention=True)


def cls_config(dropout=0.1, remat=False, **changes):
    config = {"model_type": "classifier",
              "model_params": dict(CLS_PARAMS, dropout=dropout),
              "image_size": (HW, HW), "conditional": True, "num_classes": 10,
              "num_timesteps": 1000, "beta_start": 0.0001, "beta_end": 0.02,
              "beta_schedule": "linear", "mixed_precision": "none",
              "remat": remat}
    config.update(changes)
    return config


@functools.lru_cache(maxsize=None)
def jax_classifier(remat=False, dropout=0.1, seed=0):
    """(flax classifier, perturbed params as numpy), initialised once."""
    model = JaxClassifier(image_size=(HW, HW), num_classes=10,
                          dropout=dropout, remat=remat, **CLS_PARAMS)
    params = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, HW, HW, 3)), jnp.zeros((1,), jnp.int32)))(
            jax.random.PRNGKey(seed))["params"]  # jitted: eager is slower
    return model, perturbed(params, seed)


def port_classifier(params, config):
    """The port's classifier through the factory, the JAX weights loaded
    strictly, eval mode."""
    model = factory.get_model(config)
    model.load_state_dict(state_dict_from_jax(params, config), strict=True)
    return model.eval()


@functools.lru_cache(maxsize=None)
def jax_unet(seed=4):
    """(flax conditional UNet of `torch_port_helpers`, perturbed params),
    its init jitted."""
    model = JaxUNet(**MODEL_PARAMS, num_classes=10)
    params = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, HW, HW, 3)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1,), jnp.int32)))(jax.random.PRNGKey(seed))["params"]
    return model, perturbed(params, seed)


def port_unet(params):
    model = factory.get_model(small_config())
    model.load_state_dict(state_dict_from_jax(params, small_config()),
                          strict=True)
    return model.eval()


def inputs(batch=4, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, HW, HW, 3)).astype(np.float32)
    t = rng.integers(0, 1000, batch).astype(np.int64)
    y = rng.integers(0, 10, batch).astype(np.int64)
    return x, t, y


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("remat", [False, True])
def test_forward_matches_jax(remat):
    model, params = jax_classifier(remat=remat)
    ours = port_classifier(params, cls_config(remat=remat))
    assert isinstance(ours, NoisyClassifier) and ours.remat == remat
    x, t, _ = inputs()
    ref = jax.jit(lambda p, *a: model.apply({"params": p}, *a))(
        params, jnp.asarray(x), jnp.asarray(t, jnp.int32))
    with torch.no_grad():
        got = ours(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    assert max_rel(got.numpy(), ref) <= 2e-4


def test_bridge_reads_both_namings_and_refuses_a_wrong_config():
    """Under remat the JAX classifier names its blocks ResidualBlock_N, as
    without: one tree shape, so one bridge."""
    _, plain = jax_classifier(remat=False)
    _, remat = jax_classifier(remat=True)
    assert (jax.tree_util.tree_structure(plain)
            == jax.tree_util.tree_structure(remat))
    assert {"ResidualBlock_0", "ResidualBlock_1", "AttentionBlock_0",
            "Downsample_0"} <= set(remat)
    sd = state_dict_from_jax(remat, cls_config())
    assert set(sd) == set(factory.get_model(cls_config()).state_dict())
    wrong = cls_config(model_params=dict(CLS_PARAMS, num_res_blocks=2))
    with pytest.raises(KeyError):
        state_dict_from_jax(plain, wrong)
    fewer = cls_config(model_params=dict(CLS_PARAMS, channel_mult=(1,),
                                         attention_resolutions=(16,)))
    with pytest.raises(ValueError, match="does not match the checkpoint"):
        state_dict_from_jax(plain, fewer)


def test_factory_rules_match_jax():
    from diffusion_models_collection_tpu.factory import (
        get_model as jax_get_model,
    )
    model = factory.get_model(cls_config())
    assert (model.image_size, model.num_classes) == ((HW, HW), 10)
    for change in ({"num_classes": 1}, {"num_classes": None},
                   {"super_resolution": {"factor": 2}}):
        config = cls_config(**change)
        with pytest.raises(ValueError) as ours:
            factory.get_model(config)
        with pytest.raises(ValueError) as ref:
            jax_get_model(config)
        assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="Unknown model type: moe"):
        factory.get_model(dict(cls_config(), model_type="moe"))


def test_bf16_logits_are_float32():
    _, params = jax_classifier()
    ours = port_classifier(params, cls_config(mixed_precision="bf16"))
    x, t, _ = inputs()
    with torch.no_grad():
        got = ours(torch.from_numpy(x), torch.from_numpy(t))
        want = port_classifier(params, cls_config())(
            torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32
    assert max_rel(got.numpy(), want.numpy()) <= 5e-2


# ----------------------------------------------------------------- train
def jax_ce_and_grads(model, params, x_t, t, y):
    def loss(p):
        logits = model.apply({"params": p}, x_t, t, train=False)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=-1))
    return jax.jit(jax.value_and_grad(loss))(params)


def test_train_step_loss_and_gradients_match_jax():
    """One step without dropout: q_sample on the config's schedule, the
    cross-entropy on raw labels and each gradient (the JAX gradient tree
    through the bridge is the port's layout), then `train_step` with the
    same t and noise returns that cross-entropy and its accuracy."""
    model, params = jax_classifier(dropout=0.0)
    config = cls_config(dropout=0.0, learning_rate=1e-3, seed=0)
    x, t, y = inputs(6, seed=3)
    noise = np.random.default_rng(4).standard_normal(x.shape).astype(
        np.float32)
    sched = JaxSchedule.create(1000, 0.0001, 0.02, "linear")
    x_t = jax_base.q_sample(sched, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                            jnp.asarray(noise))
    ce, grads = jax_ce_and_grads(model, params, x_t,
                                 jnp.asarray(t, jnp.int32),
                                 jnp.asarray(y, jnp.int32))
    logits = jax.jit(lambda p, *a: model.apply({"params": p}, *a))(
        params, x_t, jnp.asarray(t, jnp.int32))
    acc = float(np.mean(np.argmax(np.asarray(logits), -1) == y))

    ours = port_classifier(params, config)
    trainer = ClassifierTrainer(ours, [None] * 3, config, "cpu")
    x_t_ours = torch.from_numpy(np.array(x_t))
    loss = torch.nn.functional.cross_entropy(
        ours(x_t_ours, torch.from_numpy(t)), torch.from_numpy(y))
    loss.backward()
    assert max_rel(loss.item(), ce) <= 2e-4
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                               config)
    for name, p in ours.named_parameters():
        assert max_rel(p.grad.numpy(), want[name].numpy()) <= 2e-4, name
        p.grad = None
    got = trainer.train_step(torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(t), torch.from_numpy(noise))
    assert max_rel(got[0].item(), ce) <= 2e-4
    assert got[1].item() == pytest.approx(acc)
    assert trainer.global_step == 1 and trainer.optimizer.count == 1


def test_trainer_draws_t_then_noise_from_its_generator():
    config = cls_config(learning_rate=1e-3, seed=0)
    trainer = ClassifierTrainer(factory.get_model(config), [None], config,
                                "cpu", generator=torch.Generator()
                                .manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    want_t = torch.randint(0, 1000, (3,), generator=gen)
    want_noise = torch.randn((3, HW, HW, 3), generator=gen)
    t, noise = trainer.draw((3, HW, HW, 3))
    assert torch.equal(t, want_t) and torch.equal(noise, want_noise)


@pytest.mark.parametrize("change", [
    {"conditional": False},
    {"super_resolution": {"factor": 2}},
    {"latent_diffusion": True},
    {"num_classes": 1},
])
def test_trainer_raises_where_jax_raises(change):
    config = dict(cls_config(), **change)
    with pytest.raises(ValueError) as ref:
        JaxClassifierTrainer(None, [None], config)
    with pytest.raises(ValueError) as ours:
        ClassifierTrainer(NoisyClassifier(), [None], config, "cpu")
    assert str(ours.value) == str(ref.value)


def test_trainer_refuses_another_checkpoint_format():
    config = cls_config(checkpoint_format="orbax")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ClassifierTrainer(NoisyClassifier(), [None], config, "cpu")


def tiny_train_config(tmp_path, **changes):
    """A classifier on the committed CIFAR-10 fixtures at 8x8: 200 images
    at batch 64, 3 steps an epoch."""
    config = dict(
        cls_config(image_size=8, model_params=dict(
            CLS_PARAMS, attention_resolutions=(4,), dropout=0.1)),
        dataset="cifar10", data_root=str(FIXTURES), epochs=2, batch_size=64,
        num_workers=0, optimizer="adamw", learning_rate=1e-3,
        weight_decay=0.05, use_ema=True, ema_decay=0.9, use_scheduler=True,
        scheduler_type="warmup_cosine", warmup_epochs=1,
        save_dir=str(tmp_path / "cls"), save_interval=2, seed=42)
    config.update(changes)
    path = tmp_path / f"cls_{len(list(tmp_path.glob('cls_*.json')))}.json"
    path.write_text(json.dumps(config))
    return str(path), config


def test_train_cli_trains_and_resumes_without_extension(tmp_path):
    cfg_path, config = tiny_train_config(tmp_path)
    trainer = train.main(["--config", cfg_path, "--device", "cpu"])
    assert isinstance(trainer, ClassifierTrainer)
    assert (trainer.global_step, trainer.optimizer.count) == (6, 6)
    save_dir = Path(config["save_dir"])
    for name in ("current_model.pth", "best_model.pth",
                 "model_epoch_0002.pth"):
        assert (save_dir / name).is_file(), name
    logged = [json.loads(line) for line in
              (save_dir / "run.metrics.jsonl").read_text().splitlines()]
    logged = [m for m in logged if "train/loss" in m]
    assert len(logged) == 2
    for m in logged:
        assert np.isfinite(m["train/loss"]) and 0 <= m["train/accuracy"] <= 1
    ckpt = torch.load(save_dir / "current_model.pth", weights_only=True)
    assert ckpt["config"]["model_type"] == "classifier"
    assert {"ema_model_state_dict", "optimizer_state_dict",
            "global_step"} <= set(ckpt)
    # resumed at or past its epochs, it trains nothing (the JAX rule)
    cfg_path, _ = tiny_train_config(
        tmp_path, epochs=2, resume_path=str(save_dir / "current_model.pth"))
    resumed = train.main(["--config", cfg_path, "--device", "cpu"])
    assert (resumed.start_epoch, resumed.epochs, resumed.global_step) == (
        3, 2, 6)


def test_non_finite_loss_stops_before_the_checkpoints_rotate(
        tmp_path, monkeypatch):
    cfg_path, config = tiny_train_config(tmp_path, epochs=3, save_interval=1)
    calls = []
    real = torch.nn.functional.cross_entropy

    def diverging(logits, y):
        calls.append(1)
        ce = real(logits, y)
        return ce * float("nan") if len(calls) > 3 else ce

    monkeypatch.setattr(torch.nn.functional, "cross_entropy", diverging)
    trainer = train.main(["--config", cfg_path, "--device", "cpu"])
    save_dir = Path(config["save_dir"])
    assert torch.load(save_dir / "current_model.pth",
                      weights_only=True)["epoch"] == 1
    assert not (save_dir / "model_epoch_0002.pth").exists()
    assert trainer.global_step == 6


# -------------------------------------------------------------- guidance
def jax_classifier_fn(model, params):
    return jax.tree_util.Partial(
        lambda x, t: model.apply({"params": params}, x, t))


def jax_unet_fn(model, params):
    return jax.tree_util.Partial(
        lambda x, t, y: model.apply({"params": params}, x, t, y))


@pytest.mark.parametrize("cfg_batch", [False, True])
def test_guided_eps_matches_jax(cfg_batch):
    """eps - s sqrt(1 - acp_t) grad_x log p(y | x_t, t), on B rows and on a
    fused-CFG [x; x] batch, where the gradient of the first B rows is
    tiled."""
    cmodel, cparams = jax_classifier()
    umodel, uparams = jax_unet()
    jsched, sched = shared_schedule()
    x, t, targets = inputs(3, seed=6)
    y = targets + 1
    if cfg_batch:
        x, t = np.concatenate([x, x]), np.concatenate([t, t])
        y = np.concatenate([y, np.zeros_like(y)])
    jfn = jax_guided(jax_unet_fn(umodel, uparams),
                     jax_classifier_fn(cmodel, cparams), targets, 2.5, jsched)
    ref = jax.jit(lambda *a: jfn(*a))(
        jnp.asarray(x), jnp.asarray(t, jnp.int32), jnp.asarray(y, jnp.int32))
    classifier = port_classifier(cparams, cls_config())
    unet = port_unet(uparams)
    fn = classifier_guided_model_fn(unet, classifier,
                                    torch.from_numpy(targets), 2.5, sched)
    with torch.no_grad():
        got = fn(torch.from_numpy(x), torch.from_numpy(t),
                 torch.from_numpy(y))
        plain = unet(torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(y))
    assert max_rel(got.numpy(), ref) <= 2e-4
    assert max_rel(got.numpy(), plain.numpy()) > 1e-3  # the guidance acts
    assert all(p.grad is None for p in classifier.parameters())


def test_scale_zero_is_the_model_and_the_batch_rules_hold():
    _, cparams = jax_classifier()
    _, uparams = jax_unet()
    _, sched = shared_schedule()
    classifier = port_classifier(cparams, cls_config())
    unet = port_unet(uparams)
    x, t, targets = (torch.from_numpy(a) for a in inputs(2, seed=8))
    with torch.no_grad():
        fn = classifier_guided_model_fn(unet, classifier, targets, 0.0, sched)
        assert torch.equal(fn(x, t, targets + 1), unet(x, t, targets + 1))
        with pytest.raises(ValueError, match="not a multiple"):
            fn(torch.cat([x, x[:1]]), torch.cat([t, t[:1]]),
               torch.cat([targets, targets[:1]]))
    for labels in (targets[None], targets.float()):
        with pytest.raises(ValueError, match="1-D int"):
            classifier_guided_model_fn(unet, classifier, labels, 1.0, sched)


def test_guided_ddim_10_cfg_trajectory_matches_jax():
    """Classifier guidance at scale 2 over DDIM-10 with CFG 3 from the same
    initial noise: the guidance composes after CFG's fused batch."""
    cmodel, cparams = jax_classifier()
    umodel, uparams = jax_unet()
    noise, _, targets = inputs(3, seed=9)
    jfn = jax_guided(jax_unet_fn(umodel, uparams),
                     jax_classifier_fn(cmodel, cparams), targets, 2.0,
                     JaxDDIM(num_inference_steps=10).schedule)
    ref = JaxDDIM(num_inference_steps=10).sample_with_cfg(
        jfn, noise.shape, jnp.asarray(targets + 1, jnp.int32),
        jax.random.PRNGKey(0), cfg_scale=3.0, init_noise=jnp.asarray(noise))
    ddim = DDIM(num_inference_steps=10)
    fn = classifier_guided_model_fn(
        port_unet(uparams), port_classifier(cparams, cls_config()),
        torch.from_numpy(targets), 2.0, ddim.schedule)
    ours = ddim.sample_with_cfg(fn, noise.shape,
                                torch.from_numpy(targets + 1), cfg_scale=3.0,
                                init_noise=torch.from_numpy(noise))
    assert np.isfinite(ours.numpy()).all()
    assert max_rel(ours.numpy(), ref) <= 5e-4


# -------------------------------------------------------- sample wiring
@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """JAX-format checkpoints of the small conditional UNet and of the
    classifier (EMA weights differing from the model's), written by the JAX
    package's `save_checkpoint`."""
    tmp = tmp_path_factory.mktemp("cls_ckpts")
    _, uparams = jax_unet()
    _, cparams = jax_classifier()
    _, cema = jax_classifier(seed=5)
    unet = tmp / "unet.ckpt"
    jax_save_checkpoint(unet, epoch=1, params=uparams,
                        opt_state=optax.adamw(1e-4).init(uparams),
                        best_loss=0.1, config=small_config())
    cls = tmp / "classifier.ckpt"
    jax_save_checkpoint(cls, epoch=1, params=cparams,
                        opt_state=optax.adamw(1e-4).init(cparams),
                        best_loss=0.1, config=cls_config(), ema_params=cema)
    return unet, cls


def sample_args(**changes):
    args = dict(classifier_checkpoint=None, classifier_scale=1.0,
                use_ema=False, labels=None, num_samples=4, seed=0,
                sampling_method="ddim")
    args.update(changes)
    return SimpleNamespace(**args)


@pytest.mark.parametrize("case", [
    "flow", "edm", "consistency", "v_prediction", "latent",
    "not_a_classifier",
    "num_timesteps", "beta_start", "beta_end", "beta_schedule",
    "label_range",
])
def test_build_classifier_exits_as_jax(checkpoints, case):
    unet, cls = checkpoints
    config = small_config()
    flags = (False, False, False)
    labels = np.array([1, 2, 3, 4])
    args = sample_args(classifier_checkpoint=str(cls))
    if case in ("flow", "edm", "consistency"):
        flags = (case == "flow", case == "edm", case == "consistency")
    elif case == "v_prediction":
        config["prediction_type"] = "v"
    elif case == "latent":
        config["latent_diffusion"] = True
    elif case == "not_a_classifier":
        args.classifier_checkpoint = str(unet)
    elif case == "label_range":
        labels = np.array([1, 11, 3, 4])
    else:
        config[case] = {"num_timesteps": 500, "beta_start": 0.001,
                        "beta_end": 0.01, "beta_schedule": "cosine"}[case]
    with pytest.raises(SystemExit) as ref:
        jax_pipeline._build_classifier(args, config, flags, 2, 2,
                                       labels.astype(np.int32))
    with pytest.raises(SystemExit) as ours:
        pipeline.build_classifier(args, config, flags, 2, 2, labels, "cpu")
    assert str(ours.value) == str(ref.value)


def test_build_classifier_targets_and_ema(checkpoints, capsys):
    _, cls = checkpoints
    config = small_config()
    for use_ema, seed in ((False, 0), (True, 5)):
        args = sample_args(classifier_checkpoint=str(cls), use_ema=use_ema)
        classifier, targets = pipeline.build_classifier(
            args, config, (False, False, False), 2, 2, np.array([1, 2, 3, 4]),
            "cpu")
        assert targets.tolist() == [0, 1, 2, 3]
        assert not any(p.requires_grad for p in classifier.parameters())
        want = state_dict_from_jax(jax_classifier(seed=seed)[1],
                                   cls_config())
        for name, value in classifier.state_dict().items():
            torch.testing.assert_close(value, want[name], rtol=0, atol=0)
    # an unconditional checkpoint: the targets are built as JAX builds them
    args = sample_args(classifier_checkpoint=str(cls), labels="7,2")
    _, targets = pipeline.build_classifier(
        args, dict(config, conditional=False), (False, False, False), 2, 2,
        None, "cpu")
    ref = jax_pipeline.build_labels(
        args, {"conditional": True, "num_classes": 10}, 2, 2) - 1
    assert targets.tolist() == ref.tolist() == [7, 7, 2, 2]
    assert "Classifier guidance: scale 1.0, 10 classes" in capsys.readouterr(
        ).out


def run_sample(ckpt, tmp_path, *flags):
    return sample.main(["--checkpoint", str(ckpt), "--sampling_method",
                        "ddim", "--num_inference_steps", "4",
                        "--num_samples", "4", "--batch_size", "3",
                        "--cfg_scale", "2", "--labels", "1,5",
                        "--device", "cpu", "--output_dir",
                        str(tmp_path), *flags])["samples"]


def test_sample_cli_guides_with_a_jax_classifier_checkpoint(checkpoints,
                                                            tmp_path):
    unet, cls = checkpoints
    plain = run_sample(unet, tmp_path)
    zero = run_sample(unet, tmp_path, "--classifier_checkpoint", str(cls),
                      "--classifier_scale", "0")
    guided = run_sample(unet, tmp_path, "--classifier_checkpoint", str(cls),
                        "--classifier_scale", "50", "--use_ema")
    assert np.array_equal(zero, plain)
    assert guided.shape == (4, HW, HW, 3) and np.isfinite(guided).all()
    assert np.abs(guided - plain).max() > 1e-3


@pytest.mark.parametrize("flags,message", [
    (["--deepcache", "2"], "--deepcache does not compose with classifier "
                           "guidance"),
])
def test_sample_cli_refuses_what_jax_refuses(checkpoints, tmp_path, flags,
                                             message):
    unet, cls = checkpoints
    with pytest.raises(SystemExit, match=message):
        run_sample(unet, tmp_path, "--classifier_checkpoint", str(cls),
                   *flags)
    # a classifier checkpoint given as --checkpoint
    with pytest.raises(SystemExit, match="CLASSIFIER checkpoint"):
        run_sample(cls, tmp_path)
