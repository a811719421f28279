"""The PyTorch port's DiM against the JAX package's, on the CPU, at a small
size: hidden 64 (d_inner 128, so the JAX gate takes its Pallas scan
kernels), depth 2, state 16, patch 2 on 16x16 (L = 64) and 20x20 images
(L = 100, the JAX package's K4 case).

The JAX side runs its Pallas kernels in interpret mode under
`dispatch.use_pallas(True)`, as tests/test_pallas_kernels.py does, each
model call as one jitted computation (`run_pallas_interpreted`); the
trajectory and the training steps, which jit whole loops, take the JAX
package's own plain path on the CPU (the XLA scan, its reference for the
kernels). Inputs and noises come from numpy with a fixed seed. Bars, as
max|port - jax| / max|jax|: 2e-4 for a forward, a loss, its gradients and
two train steps (the repo's forward bar, tests/test_torch_import.py:63);
5e-4 for a DDIM-10 CFG trajectory.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_models_collection_tpu.diffusion import ddpm as jax_ddpm
from diffusion_models_collection_tpu.diffusion.ddim import DDIM as JaxDDIM
from diffusion_models_collection_tpu.models import dim as jax_dim_mod
from diffusion_models_collection_tpu.models import layers as jax_layers
from diffusion_models_collection_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from diffusion_models_collection_tpu.utils.ema import gated_ema_update
from diffusion_models_collection_tpu.utils.torch_export import (
    export_torch_state_dict,
)
from diffusion_models_collection_tpu.utils.trainer import (
    build_optimizer as jax_build_optimizer,
)
from diffusion_models_collection_tpu_torch import factory, sample, train
from diffusion_models_collection_tpu_torch.diffusion import DDIM, DDPM
from diffusion_models_collection_tpu_torch.models import DiM, layers
from diffusion_models_collection_tpu_torch.ops import selective_scan as ss
from diffusion_models_collection_tpu_torch.utils.helpers import load_config
from diffusion_models_collection_tpu_torch.utils.trainer import (
    DiffusionTrainer,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from torch_port_helpers import (
    DIM_PARAMS,
    jax_dim,
    max_rel,
    run_pallas_interpreted,
    small_dim_config,
    torch_dim,
)

TOL = 2e-4
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cond16():
    return jax_dim(conditional=True, seed=0, size=16)


# ----------------------------------------------------------- weight bridge
@pytest.mark.parametrize("conditional", [True, False])
def test_weight_bridge_equals_jax_exporter_and_loads_strict(conditional):
    _, params, config = jax_dim(conditional, seed=2)
    ours = state_dict_from_jax(params, config)
    ref = export_torch_state_dict(params, "dim", config)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    model = DiM(img_size=(16, 16), **DIM_PARAMS,
                num_classes=10 if conditional else None)
    result = model.load_state_dict(ours, strict=True)
    assert not result.missing_keys and not result.unexpected_keys


def test_full_width_dim_has_the_jax_parameters():
    """configs/cifar10_dim.py at full width: the factory's DiM takes the
    bridged JAX tree (shapes only, zeros) with strict=True, parameter for
    parameter."""
    config = load_config(REPO / "configs" / "cifar10_dim.py")
    model = factory.get_model(config)
    mp = dict(config["model_params"], num_classes=10)
    shapes = jax.eval_shape(
        lambda: jax_dim_mod.DiM(**mp).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
            jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32)))["params"]
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    model.load_state_dict(state_dict_from_jax(zeros, config), strict=True)
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    mamba = model.blocks[0].mamba_block.mamba
    assert (mamba.dt_rank, mamba.x_proj.out_features) == (24, 56)


# ------------------------------------------------------------- the layers
def test_dit_time_embedding_and_unpatchify_match_jax():
    t = np.array([0, 1, 17, 250, 999], np.int64)
    for dim in (256, 7):
        ref = jax_layers.sinusoidal_time_embedding_dit(jnp.asarray(t), dim)
        ours = layers.sinusoidal_time_embedding_dit(torch.from_numpy(t), dim)
        # trig of arguments up to 999 rad: compare absolutely, as the UNet's
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-4)
    tokens = np.random.default_rng(0).standard_normal((2, 12, 12)).astype(
        np.float32)
    np.testing.assert_array_equal(
        layers.unpatchify(torch.from_numpy(tokens), 3, 4, 2, 3).numpy(),
        np.asarray(jax_layers.unpatchify(jnp.asarray(tokens), 3, 4, 2, 3)))


@pytest.mark.parametrize("size", [16, 20])
@pytest.mark.parametrize("module", ["Mamba", "MambaBlock", "DiMBlock"])
def test_dim_modules_match_jax(module, size):
    _, params, config = jax_dim(True, seed=1, size=size)
    block = torch_dim(params, config).blocks[0]
    rng = np.random.default_rng(size)
    length = (size // 2) ** 2
    x = rng.standard_normal((2, length, 64)).astype(np.float32)
    c = rng.standard_normal((2, 64)).astype(np.float32)
    p = params["DiMBlock_0"]
    if module == "Mamba":
        jax_mod, jp = jax_dim_mod.Mamba(64, 16), p["MambaBlock_0"]["Mamba_0"]
        ours_mod, args = block.mamba_block.mamba, (x,)
    elif module == "MambaBlock":
        jax_mod, jp = jax_dim_mod.MambaBlock(64, 16), p["MambaBlock_0"]
        ours_mod, args = block.mamba_block, (x, c)
    else:
        jax_mod, jp = jax_dim_mod.DiMBlock(64, 16), p
        ours_mod, args = block, (x, c)
    ref = run_pallas_interpreted(
        lambda p, *a: jax_mod.apply({"params": p}, *a), jp, *args)
    with torch.no_grad():
        ours = ours_mod(*map(torch.from_numpy, args))
    assert ours.shape == ref.shape
    assert max_rel(ours, ref) <= TOL


def forward_both(model, params, tmodel, x, t, y):
    yj = None if y is None else jnp.asarray(y, jnp.int32)
    ref = run_pallas_interpreted(
        lambda p, xx, tt: model.apply({"params": p}, xx, tt, yj), params,
        jnp.asarray(x), jnp.asarray(t, jnp.int32))
    with torch.no_grad():
        ours = tmodel(torch.from_numpy(x), torch.from_numpy(t),
                      None if y is None else torch.from_numpy(y))
    return ours.numpy(), np.asarray(ref)


@pytest.mark.parametrize("size", [16, 20])
@pytest.mark.parametrize("labels", ["conditional", "null"])
def test_dim_forward_matches_jax(labels, size):
    model, params, config = jax_dim(True, seed=3, size=size)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, size, size, 3)).astype(np.float32)
    t = np.array([0, 10, 500, 999], np.int64)
    y = (np.array([1, 4, 7, 10], np.int64) if labels == "conditional"
         else np.zeros(4, np.int64))
    ours, ref = forward_both(model, params, torch_dim(params, config), x, t, y)
    assert ours.shape == ref.shape == (4, size, size, 3)
    assert ours.dtype == np.float32
    assert max_rel(ours, ref) <= TOL


def test_unconditional_dim_forward_matches_jax():
    model, params, config = jax_dim(False, seed=5)
    x = np.random.default_rng(5).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    t = np.array([3, 700], np.int64)
    ours, ref = forward_both(model, params, torch_dim(params, config), x, t,
                             None)
    assert max_rel(ours, ref) <= TOL


def test_ddim_10_step_cfg_trajectory_matches_jax(cond16):
    model, params, config = cond16
    tmodel = torch_dim(params, config)
    noise = np.random.default_rng(6).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    y = np.array([3, 8], np.int64)
    ref = JaxDDIM(num_timesteps=1000, num_inference_steps=10).sample_with_cfg(
        jax.tree_util.Partial(
            lambda x, t, yy: model.apply({"params": params}, x, t, yy)),
        noise.shape, jnp.asarray(y, jnp.int32), jax.random.PRNGKey(0),
        cfg_scale=3.0, init_noise=jnp.asarray(noise))
    ours = DDIM(num_timesteps=1000, num_inference_steps=10).sample_with_cfg(
        tmodel, noise.shape, torch.from_numpy(y), cfg_scale=3.0,
        init_noise=torch.from_numpy(noise))
    assert np.isfinite(ours.numpy()).all()
    assert max_rel(ours.numpy(), ref) <= 5e-4


# ------------------------------------------------------------ loss, grads
def batch(seed, n=4):
    """x0 in [-1, 1], labels 0..9, t, noise and a CFG drop mask."""
    rng = np.random.default_rng(seed)
    return dict(
        x0=rng.uniform(-1, 1, (n, 16, 16, 3)).astype(np.float32),
        labels=rng.integers(0, 10, n).astype(np.int64),
        t=rng.integers(0, 1000, n).astype(np.int64),
        noise=rng.standard_normal((n, 16, 16, 3)).astype(np.float32),
        drop=rng.uniform(size=n) < 0.3,
    )


def torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@pytest.fixture(scope="module")
def jax_value_and_grad(cond16):
    """(params, batch) -> (loss, grads) of the JAX DDPM eps-loss of the
    small DiM, jitted once for the module."""
    model = cond16[0]
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


def test_dim_loss_and_every_gradient_match_jax(cond16):
    """The JAX side's custom_vjp here runs K6 and K8 in interpret mode."""
    model, params, config = cond16
    b = batch(7)
    y = np.where(b["drop"], 0, b["labels"] + 1).astype(np.int32)
    ddpm = jax_ddpm.DDPM(num_timesteps=1000)

    def loss_fn(p):
        return ddpm.p_losses(
            lambda x, tt, yy: model.apply({"params": p}, x, tt, yy),
            b["x0"], b["t"].astype(np.int32), b["noise"], y=y)

    loss_ref, grads = run_pallas_interpreted(jax.value_and_grad(loss_fn),
                                             params)
    grads_ref = state_dict_from_jax(grads, config)
    tmodel = torch_dim(params, config, dropout=0.0)
    tb = torch_batch(b)
    loss = DDPM(num_timesteps=1000).p_losses(
        tmodel, tb["x0"], tb["t"], tb["noise"], y=torch.from_numpy(y).long())
    loss.backward()
    assert max_rel(loss.detach(), loss_ref) <= TOL
    named = dict(tmodel.named_parameters())
    assert set(named) == set(grads_ref)
    for name, g in grads_ref.items():
        assert max_rel(named[name].grad, g) <= TOL, name


def test_two_train_steps_match_the_jax_pieces(cond16, jax_value_and_grad,
                                              tmp_path):
    _, params, config = cond16
    config = dict(
        config, optimizer="adamw", learning_rate=1e-3, weight_decay=1e-4,
        use_scheduler=True, scheduler_type="warmup_cosine", epochs=4,
        warmup_epochs=2, warmup_start_factor=0.1, use_ema=True,
        ema_decay=0.9, cfg_dropout_prob=0.2, gradient_accumulation_steps=1,
        loss_type="l2", batch_size=4, save_dir=str(tmp_path / "ckpt"),
        sample_dir=str(tmp_path / "samples"), seed=0)
    batches = [batch(10), batch(11)]

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

    trainer = DiffusionTrainer(torch_dim(params, config, dropout=0.0),
                               DDPM(num_timesteps=1000), [None], config,
                               "cpu")
    losses = []
    for b in batches:
        tb = torch_batch(b)
        losses.append(trainer.train_step(tb["x0"], tb["labels"], tb["t"],
                                         tb["noise"], tb["drop"]).item())
    assert max_rel(losses, losses_ref) <= TOL
    for what, ours, ref in (
            ("params", trainer.model.state_dict(),
             state_dict_from_jax(p_j, config)),
            ("ema", trainer.ema_model.state_dict(),
             state_dict_from_jax(ema_j, config))):
        for name, want in ref.items():
            assert max_rel(ours[name], want) <= TOL, (what, name)


# ------------------------------------------------------------ entry points
def tiny_dim_config(tmp_path):
    """A synthetic 8x8 DiM config (L = 16) that trains in seconds on the
    CPU: 512 images at batch 128, one epoch."""
    config = {
        "model_type": "dim",
        "model_params": {"img_size": (8, 8), "patch_size": 2,
                         "in_channels": 3, "hidden_size": 32, "depth": 2,
                         "state_size": 8, "mlp_ratio": 2.0, "dropout": 0.1},
        "dataset": "synthetic", "image_size": (8, 8), "conditional": True,
        "num_classes": 10, "num_timesteps": 20, "beta_start": 0.0001,
        "beta_end": 0.02, "beta_schedule": "linear", "loss_type": "l2",
        "cfg_scale": 1.4, "num_inference_steps": 5, "epochs": 1,
        "batch_size": 128, "num_workers": 0, "optimizer": "adamw",
        "learning_rate": 1e-3, "weight_decay": 1e-4, "use_ema": True,
        "ema_decay": 0.99, "cfg_dropout_prob": 0.2, "use_scheduler": True,
        "scheduler_type": "warmup_cosine", "warmup_epochs": 1,
        "save_dir": str(tmp_path / "ckpt"),
        "sample_dir": str(tmp_path / "samples"), "save_interval": 1,
        "sample_interval": 1, "sample_start_epoch": 1, "num_samples": 4,
        "seed": 42,
    }
    path = tmp_path / "dim.json"
    path.write_text(json.dumps(config))
    return str(path), config


def test_train_and_sample_clis_run_a_tiny_dim(tmp_path):
    cfg_path, config = tiny_dim_config(tmp_path)
    before = (ss.FWD_LAUNCHES, ss.BWD_LAUNCHES)
    trainer = train.main(["--config", cfg_path, "--device", "cpu"])
    assert isinstance(trainer.model, DiM)
    assert trainer.global_step == 4
    assert (Path(config["sample_dir"]) / "epoch_0001.png").is_file()
    ckpt = Path(config["save_dir"]) / "current_model.pth"
    out = tmp_path / "out"
    result = sample.main([
        "--checkpoint", str(ckpt), "--sampling_method", "ddim",
        "--num_inference_steps", "3", "--num_samples", "3",
        "--batch_size", "3", "--cfg_scale", "2", "--use_ema",
        "--device", "cpu", "--output_dir", str(out)])
    samples = result["samples"]
    assert samples.shape == (3, 8, 8, 3) and np.isfinite(samples).all()
    assert (out / "samples.png").is_file()
    assert (ss.FWD_LAUNCHES, ss.BWD_LAUNCHES) == before  # CPU: plain


def test_sample_cli_from_a_jax_dim_checkpoint(cond16, tmp_path):
    _, params, config = cond16
    ckpt = tmp_path / "current_model.ckpt"
    opt_state = optax.adamw(1e-4).init(
        jax.tree_util.tree_map(jnp.asarray, params))
    jax_save_checkpoint(ckpt, epoch=1, params=params, opt_state=opt_state,
                        best_loss=1.0, config=config, ema_params=params)
    out = tmp_path / "out"
    result = sample.main([
        "--checkpoint", str(ckpt), "--sampling_method", "ddim",
        "--num_inference_steps", "2", "--num_samples", "2",
        "--batch_size", "2", "--cfg_scale", "3", "--labels", "1,7",
        "--use_ema", "--device", "cpu", "--output_dir", str(out)])
    samples = result["samples"]
    assert samples.shape == (2, 16, 16, 3) and np.isfinite(samples).all()
    assert (out / "samples.npy").is_file()


# ------------------------------------------------------------ not ported
@pytest.mark.parametrize("knob", [dict(use_attention_fallback=True),
                                  dict(remat=True)])
def test_dim_raises_on_knobs_not_ported(knob):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DiM(img_size=(16, 16), **DIM_PARAMS, **knob)


def test_bridge_raises_on_the_attention_fallback_mixer():
    model = jax_dim_mod.DiM(img_size=(8, 8), **DIM_PARAMS, num_classes=None,
                            use_attention_fallback=True)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
                        jnp.zeros((1,), jnp.int32))["params"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        state_dict_from_jax(params, small_dim_config(False, 8))


def test_factory_builds_dim_with_injected_size_and_classes():
    config = dict(small_dim_config(True, 16), image_size=20)
    config["model_params"].pop("img_size")
    model = factory.get_model(config)
    assert isinstance(model, DiM) and model.tokens_hw == (10, 10)
    assert model.y_embedder is not None
    model = factory.get_model(dict(config, conditional=False))
    assert model.y_embedder is None
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        factory.get_model(dict(config, remat=True))
