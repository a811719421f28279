"""The port's KL-VAE (`models/vae.py`), its weight bridge and its trainer
(`utils/vae_trainer.py`) against the JAX package's, on the CPU, at the JAX
package's test size (`tests/test_vae.py`): base 8, channel_mult (1, 2), 2
latent channels, 1 res block, 8x8 images, with and without attention.

The same seeded numpy inputs and posterior noise go to both sides; the JAX
parameters are perturbed (`torch_port_helpers.perturbed`) and carried over
by `utils/weights.py`, under both of Flax's block namings (`VAEResBlock_N`,
and `CheckpointVAEResBlock_N` under `remat: true`):

* `encode`, `decode`, `forward` and `kl_divergence` in float32: max-rel
  2e-4, the bar of one forward;
* the same in `mixed_precision: 'bf16'` against JAX's bf16 and float32
  runs, at bars measured here and checked to be no looser than twice JAX's
  own bf16-vs-float32 distance (`test_torch_port_bf16_models.check_bar`);
* the loss, its reconstruction and KL terms and every gradient of one step:
  2e-4; then `VAETrainer.train_step` against the JAX trainer's pieces
  (`build_optimizer`, the loss of its step, the gated EMA): loss, params
  and EMA at 2e-4 (both at base 16, `TRAIN_BASE` says why);
* the full-width parameter count of `configs/cifar10_vae.py` (2,385,227)
  and the bridge's refusal of a config that does not describe the tree;
* `train.main` on a tiny VAE config on the committed CIFAR-10 fixtures:
  checkpoints, the reconstruction grid (one batch, kept across epochs), the
  per-epoch log, resume without the epoch extension (the JAX VAE trainer's
  rule), and the stop before the checkpoints rotate on a non-finite loss.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_models_collection_tpu.models.vae import VAE as JaxVAE
from diffusion_models_collection_tpu.models.vae import (
    kl_divergence as jax_kl,
)
from diffusion_models_collection_tpu.utils.ema import gated_ema_update
from diffusion_models_collection_tpu.utils.trainer import (
    build_optimizer as jax_build_optimizer,
)
from diffusion_models_collection_tpu_torch import factory, train
from diffusion_models_collection_tpu_torch.models import vae as vae_mod
from diffusion_models_collection_tpu_torch.models.vae import VAE
from diffusion_models_collection_tpu_torch.utils import vae_trainer
from diffusion_models_collection_tpu_torch.utils.helpers import load_config
from diffusion_models_collection_tpu_torch.utils.vae_trainer import (
    VAETrainer,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from test_torch_port_bf16_models import check_bar
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    max_rel,
    one_torch_thread,
    perturbed,
)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "data"
HW, LATENT_HW = 8, 4
VAE_PARAMS = dict(in_channels=3, base_channels=8, channel_mult=(1, 2),
                  latent_channels=2, num_res_blocks=1)

# The bf16 bars, fixed by measurement on this file's inputs (in brackets:
# the port's bf16 run against JAX's bf16 and float32 runs, then JAX's own
# bf16-vs-float32 distance, on the CPU); `check_bar` asserts each is at most
# twice JAX's own distance.
BF16_BAR = {
    "mean": 1.3e-2,  # (1.08e-2, 1.10e-2; 6.53e-3)
    "logvar": 1.4e-2,  # (1.15e-2, 7.66e-3; 7.04e-3)
    "decode": 2.3e-2,  # (1.77e-2, 1.11e-2; 1.19e-2)
    "recon": 3e-2,  # (2.22e-2, 1.72e-2; 1.53e-2)
}


def vae_config(use_attention=True, remat=False, base=8, **changes):
    config = {"model_type": "vae",
              "model_params": dict(VAE_PARAMS, use_attention=use_attention,
                                   dropout=0.0, base_channels=base),
              "image_size": (HW, HW), "conditional": False,
              "mixed_precision": "none", "remat": remat}
    config.update(changes)
    return config


@functools.lru_cache(maxsize=None)
def jax_vae(use_attention=True, remat=False, seed=0, base=8):
    """(flax VAE, perturbed params as numpy), initialised once a module."""
    model = JaxVAE(image_size=(HW, HW), **dict(VAE_PARAMS, base_channels=base),
                   use_attention=use_attention, remat=remat)
    params = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, HW, HW, 3)),
        jnp.zeros((1, LATENT_HW, LATENT_HW, 2))))(
            jax.random.PRNGKey(seed))["params"]  # jitted: eager init is slower
    return model, perturbed(params, seed)


def port_vae(params, config):
    """The port's VAE through the factory, the JAX weights loaded strictly,
    eval mode."""
    model = factory.get_model(config)
    model.load_state_dict(state_dict_from_jax(params, config), strict=True)
    return model.eval()


def inputs(seed=1, n=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, HW, HW, 3)).astype(np.float32)
    noise = rng.standard_normal((n, LATENT_HW, LATENT_HW, 2)).astype(
        np.float32)
    return x, noise


def jax_run(model, params, x, noise):
    """(mean, logvar, decode(noise), reconstruction, kl) of the JAX VAE."""
    def run(p, xx, nn_):
        mean, logvar = model.apply({"params": p}, xx, method=model.encode)
        dec = model.apply({"params": p}, nn_, method=model.decode)
        recon, _, _ = model.apply({"params": p}, xx, nn_)
        return mean, logvar, dec, recon, jax_kl(mean, logvar)
    return [np.asarray(a) for a in jax.jit(run)(params, x, noise)]


def port_run(model, x, noise):
    with torch.no_grad():
        xt, nt = torch.from_numpy(x), torch.from_numpy(noise)
        mean, logvar = model.encode(xt)
        dec = model.decode(nt)
        recon, mean2, logvar2 = model(xt, nt)
        torch.testing.assert_close(mean2, mean, rtol=0, atol=0)
        torch.testing.assert_close(logvar2, logvar, rtol=0, atol=0)
        return [a.numpy() for a in (mean, logvar, dec, recon,
                                    vae_mod.kl_divergence(mean, logvar))]


NAMES = ("mean", "logvar", "decode", "recon", "kl")


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("use_attention", [True, False])
def test_vae_matches_jax(use_attention, remat):
    model, params = jax_vae(use_attention, remat)
    if remat:  # the tree under remat names its blocks differently
        assert "CheckpointVAEResBlock_0" in params["encoder"]
    config = vae_config(use_attention, remat)
    x, noise = inputs()
    ref = jax_run(model, params, x, noise)
    ours = port_run(port_vae(params, config), x, noise)
    assert ours[0].shape == (3, LATENT_HW, LATENT_HW, 2)
    assert ours[3].shape == (3, HW, HW, 3)
    for name, a, b in zip(NAMES, ours, ref):
        assert a.dtype == np.float32
        assert max_rel(a, b) <= 2e-4, name


def test_vae_logvar_is_clamped():
    """The encoder bounds logvar to [-30, 20] (LDM's clamp)."""
    model, params = jax_vae()
    config = vae_config()
    vae = port_vae(params, config)
    with torch.no_grad():
        vae.encoder.conv_out.bias[2:] += 100.0  # the logvar half
        _, logvar = vae.encode(torch.from_numpy(inputs()[0]))
    assert float(logvar.max()) == 20.0


def test_vae_in_bf16_matches_jax():
    model, params = jax_vae()
    config = vae_config(mixed_precision="bf16")
    x, noise = inputs(seed=2)
    jax32 = jax_run(model, params, x, noise)
    jax16 = jax_run(model.clone(dtype=jnp.bfloat16), params, x, noise)
    model16 = port_vae(params, config)
    assert all(p.dtype == torch.float32 for p in model16.parameters())
    ours = port_run(model16, x, noise)
    ours32 = port_run(port_vae(params, vae_config()), x, noise)
    assert all(a.dtype == np.float32 for a in ours)
    for i, name in enumerate(NAMES[:4]):
        check_bar(BF16_BAR[name], name, ours[i], ours32[i], jax16[i],
                  jax32[i])


def test_full_width_parameter_count_and_bridge_mismatch():
    config = load_config(REPO / "configs" / "cifar10_vae.py")
    config["image_size"] = (32, 32)
    vae = factory.get_model(config)
    assert isinstance(vae, VAE)
    assert sum(p.numel() for p in vae.parameters()) == 2_385_227
    assert vae.latent_hw() == (16, 16) and vae.downsample_factor == 2
    # a tree with more blocks than the config says is refused
    _, params = jax_vae()
    with pytest.raises(ValueError, match="does not match"):
        state_dict_from_jax(params, vae_config(
            model_params=dict(VAE_PARAMS, num_res_blocks=0,
                              use_attention=True)))
    with pytest.raises(ValueError, match="not divisible"):
        VAE(image_size=(9, 8), **VAE_PARAMS)


# ------------------------------------------------------------- training
def jax_loss_and_grad(model, kl_weight):
    """The loss of the JAX VAE trainer's step (`vae_trainer.py`), with the
    noise passed in."""
    @jax.jit
    def run(params, images, noise):
        def loss_fn(p):
            recon, mean, logvar = model.apply({"params": p}, images, noise,
                                              train=True)
            rec = jnp.mean((recon - images) ** 2)
            kl = jax_kl(mean, logvar)
            return rec + kl_weight * kl, (rec, kl)
        return jax.value_and_grad(loss_fn, has_aux=True)(params)
    return run


KL_WEIGHT = 0.05  # large enough that the KL term moves the loss
# The training tests run at base 16. At base 8 GroupNorm(8) normalises each
# channel on its own, so it removes the bias of the conv before it: that
# bias's gradient is exactly 0, both sides return rounding noise, and Adam
# turns noise into a full step of either sign. At 16, two channels a group,
# every gradient is a real one.
TRAIN_BASE = 16


def test_vae_loss_and_every_gradient_match_jax():
    model, params = jax_vae(base=TRAIN_BASE)
    config = vae_config(base=TRAIN_BASE)
    x, noise = inputs(seed=3)
    (loss_ref, (rec_ref, kl_ref)), grads = jax_loss_and_grad(
        model, KL_WEIGHT)(params, x, noise)
    grads_ref = state_dict_from_jax(grads, config)
    vae = port_vae(params, config).train()
    recon, mean, logvar = vae(torch.from_numpy(x), torch.from_numpy(noise))
    rec = torch.mean((recon - torch.from_numpy(x)) ** 2)
    kl = vae_mod.kl_divergence(mean, logvar)
    loss = rec + KL_WEIGHT * kl
    loss.backward()
    for name, ours, ref in (("loss", loss, loss_ref), ("rec", rec, rec_ref),
                            ("kl", kl, kl_ref)):
        assert max_rel(ours.detach(), ref) <= 2e-4, name
    named = dict(vae.named_parameters())
    assert set(named) == set(grads_ref)
    for name, g in grads_ref.items():
        assert max_rel(named[name].grad, g) <= 2e-4, name


def trainer_config(tmp_path):
    return dict(vae_config(base=TRAIN_BASE), optimizer="adamw", learning_rate=1e-3,
                weight_decay=1e-4, use_scheduler=True,
                scheduler_type="cosine", epochs=2, use_ema=True,
                ema_decay=0.9, kl_weight=KL_WEIGHT, batch_size=3,
                save_dir=str(tmp_path / "ckpt"),
                sample_dir=str(tmp_path / "samples"), seed=0)


def test_vae_train_steps_match_the_jax_pieces(tmp_path):
    model, params = jax_vae(base=TRAIN_BASE)
    config = trainer_config(tmp_path)
    batches = [inputs(seed=s) for s in (4, 5)]

    tx, _, _ = jax_build_optimizer(config, 1)

    @jax.jit
    def update(p, opt_state, ema, grads):
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        return p, opt_state, gated_ema_update(tx, opt_state, ema, p,
                                              config["ema_decay"])

    value_and_grad = jax_loss_and_grad(model, KL_WEIGHT)
    p_j = ema_j = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(p_j)
    refs = []
    for x, noise in batches:
        (loss, (rec, kl)), grads = value_and_grad(p_j, x, noise)
        p_j, opt_state, ema_j = update(p_j, opt_state, ema_j, grads)
        refs.append([float(loss), float(rec), float(kl)])

    vae = factory.get_model(config)
    vae.load_state_dict(state_dict_from_jax(params, config), strict=True)
    trainer = VAETrainer(vae, [None], config, "cpu")
    ours = [trainer.train_step(torch.from_numpy(x), None,
                               torch.from_numpy(noise)).tolist()
            for x, noise in batches]
    assert trainer.optimizer.count == 2 and trainer.global_step == 2
    assert max_rel(ours, refs) <= 2e-4
    for what, got, ref in (
            ("params", trainer.model.state_dict(),
             state_dict_from_jax(p_j, config)),
            ("ema", trainer.ema_model.state_dict(),
             state_dict_from_jax(ema_j, config))):
        for name, want in ref.items():
            assert max_rel(got[name], want) <= 2e-4, (what, name)


def test_vae_trainer_draws_its_noise_from_its_generator():
    _, params = jax_vae()
    config = dict(vae_config(), learning_rate=1e-3, seed=0)
    vae = factory.get_model(config)
    trainer = VAETrainer(vae, [None], config, "cpu",
                         generator=torch.Generator().manual_seed(7))
    want = torch.randn((3, LATENT_HW, LATENT_HW, 2),
                       generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(trainer.draw((3, HW, HW, 3)), want,
                               rtol=0, atol=0)


# ------------------------------------------------------------ train CLI
def tiny_vae_config(tmp_path, **changes):
    """A tiny VAE on the committed CIFAR-10 fixtures at 8x8: 200 images at
    batch 64, 3 steps an epoch."""
    config = dict(
        vae_config(), dataset="cifar10", data_root=str(FIXTURES),
        image_size=HW, kl_weight=1e-4, epochs=2, batch_size=64,
        num_workers=0, optimizer="adamw", learning_rate=1e-3,
        weight_decay=1e-4, use_ema=True, ema_decay=0.99, use_scheduler=True,
        scheduler_type="cosine", save_dir=str(tmp_path / "vae"),
        save_interval=2, sample_dir=str(tmp_path / "vae_samples"),
        sample_interval=1, sample_start_epoch=2, num_samples=4, seed=42)
    config.update(changes)
    path = tmp_path / f"vae_{len(list(tmp_path.glob('vae_*.json')))}.json"
    path.write_text(json.dumps(config))
    return str(path), config


def metrics(save_dir):
    return [json.loads(line) for line in
            (Path(save_dir) / "run.metrics.jsonl").read_text().splitlines()]


def test_train_cli_trains_the_vae_and_resumes(tmp_path):
    cfg_path, config = tiny_vae_config(tmp_path)
    trainer = train.main(["--config", cfg_path, "--device", "cpu"])
    save_dir = Path(config["save_dir"])
    assert isinstance(trainer, VAETrainer)
    assert (trainer.global_step, trainer.optimizer.count) == (6, 6)
    for name in ("current_model.pth", "best_model.pth",
                 "model_epoch_0002.pth"):
        assert (save_dir / name).is_file(), name
    assert (Path(config["sample_dir"]) / "vae_epoch_0002.png").is_file()
    assert not (Path(config["sample_dir"]) / "vae_epoch_0001.png").exists()
    # the grid's batch is drawn once and kept, whatever the loader's epoch
    kept = trainer.grid_batch
    trainer.train_loader.set_epoch(7)
    trainer.sample_images(7)
    assert trainer.grid_batch is kept
    logged = [m for m in metrics(save_dir) if "train/loss" in m]
    assert len(logged) == 2
    for m in logged:
        assert np.isfinite([m["train/loss"], m["train/recon_loss"],
                            m["train/kl"]]).all()
        assert m["train/loss"] == pytest.approx(
            m["train/recon_loss"] + 1e-4 * m["train/kl"], rel=1e-5)
    ckpt = torch.load(save_dir / "current_model.pth", weights_only=True)
    assert ckpt["config"]["model_type"] == "vae"
    assert {"epoch", "model_state_dict", "ema_model_state_dict",
            "optimizer_state_dict", "global_step"} <= set(ckpt)

    # the JAX VAE trainer's rule: a resume at or past `epochs` trains no
    # epoch (no extension, unlike the diffusion trainer)
    cfg_path, _ = tiny_vae_config(
        tmp_path, epochs=1, sample_start_epoch=100, save_best=False,
        save_interval=100, resume_path=str(save_dir / "current_model.pth"))
    resumed = train.main(["--config", cfg_path, "--device", "cpu"])
    assert (resumed.start_epoch, resumed.epochs) == (3, 1)
    assert resumed.global_step == 6
    assert torch.load(save_dir / "current_model.pth",
                      weights_only=True)["epoch"] == 2
    # before its `epochs` it trains on to them
    cfg_path, _ = tiny_vae_config(
        tmp_path, epochs=3, sample_start_epoch=100, save_best=False,
        save_interval=100, resume_path=str(save_dir / "current_model.pth"))
    resumed = train.main(["--config", cfg_path, "--device", "cpu"])
    assert (resumed.start_epoch, resumed.epochs) == (3, 3)
    assert resumed.global_step == 9
    assert torch.load(save_dir / "current_model.pth",
                      weights_only=True)["epoch"] == 3


def test_vae_non_finite_loss_stops_before_the_checkpoints_rotate(
        tmp_path, monkeypatch):
    cfg_path, config = tiny_vae_config(tmp_path, epochs=3, save_interval=1,
                                       sample_start_epoch=100)
    calls = []

    def diverging(mean, logvar):
        calls.append(1)
        kl = vae_mod.kl_divergence(mean, logvar)
        return kl * float("nan") if len(calls) > 3 else kl

    monkeypatch.setattr(vae_trainer, "kl_divergence", diverging)
    trainer = train.main(["--config", cfg_path, "--device", "cpu"])
    save_dir = Path(config["save_dir"])
    ckpt = torch.load(save_dir / "current_model.pth", weights_only=True)
    assert ckpt["epoch"] == 1 and np.isfinite(ckpt["best_loss"])
    assert not (save_dir / "model_epoch_0002.pth").exists()
    assert trainer.global_step == 6
    assert {"train/diverged_epoch": 2}.items() <= metrics(
        save_dir)[-1].items()
