"""The PyTorch port's DiT (and the DiM's attention fallback, which shares its
`SelfAttention`) against the JAX package's, on the CPU, at a small size:
hidden 64 in 4 heads, depth 2, patch 2 on 16x16 images (L = 64) and 8x8
ones for the CLIs.

The JAX DiT's attention is its plain XLA path (the Pallas flash kernel is
opt-in there), the port's runs the plain versions of its kernels on CPU
tensors. Inputs and noises come from numpy with a fixed seed; the
comparisons run with dropout off (eval mode, or dropout 0 where a gradient
is taken), since JAX's and torch's generators never agree: the attention's
dropout against JAX is `tests/test_torch_port_attn_dropout.py`'s. Bars, as
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
from diffusion_models_collection_tpu.models import dit as jax_dit_mod
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
from diffusion_models_collection_tpu_torch.models import DiM, DiT
from diffusion_models_collection_tpu_torch.ops import attention
from diffusion_models_collection_tpu_torch.ops import flash_attention as fa
from diffusion_models_collection_tpu_torch.utils.helpers import load_config
from diffusion_models_collection_tpu_torch.utils.trainer import (
    DiffusionTrainer,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from torch_port_helpers import (
    DIM_PARAMS,
    DIT_PARAMS,
    jax_dit,
    max_rel,
    perturbed,
    small_dim_config,
    torch_dit,
)

TOL = 2e-4
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cond16():
    return jax_dit(conditional=True, seed=0, size=16)


# ----------------------------------------------------------- weight bridge
@pytest.mark.parametrize("conditional", [True, False])
def test_weight_bridge_equals_jax_exporter_and_loads_strict(conditional):
    _, params, config = jax_dit(conditional, seed=2)
    ours = state_dict_from_jax(params, config)
    ref = export_torch_state_dict(params, "dit", config)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    model = DiT(img_size=(16, 16), **DIT_PARAMS,
                num_classes=10 if conditional else None)
    result = model.load_state_dict(ours, strict=True)
    assert not result.missing_keys and not result.unexpected_keys


def test_full_width_dit_has_the_jax_parameters():
    """configs/cifar10_dit.py at full width (hidden 384, depth 12, 6 heads,
    L 256): the factory's DiT takes the bridged JAX tree (shapes only,
    zeros) with strict=True, parameter for parameter: 32,573,964."""
    config = load_config(REPO / "configs" / "cifar10_dit.py")
    model = factory.get_model(config)
    mp = dict(config["model_params"], num_classes=10)
    shapes = jax.eval_shape(
        lambda: jax_dit_mod.DiT(**mp).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
            jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32)))["params"]
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    model.load_state_dict(state_dict_from_jax(zeros, config), strict=True)
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_jax == 32_573_964
    attn = model.blocks[0].attn
    assert attn.num_heads == 6 and attn.in_proj_weight.shape == (1152, 384)
    assert model.tokens_hw == (16, 16)


# ------------------------------------------------------------- the layers
@pytest.mark.parametrize("module", ["SelfAttention", "DiTBlock",
                                    "FinalLayer"])
def test_dit_modules_match_jax(module):
    _, params, config = jax_dit(True, seed=1)
    tmodel = torch_dit(params, config)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 64)).astype(np.float32)
    c = rng.standard_normal((2, 64)).astype(np.float32)
    if module == "SelfAttention":
        jax_mod, jp = jax_dit_mod.SelfAttention(4), params["DiTBlock_0"][
            "SelfAttention_0"]
        ours_mod, args = tmodel.blocks[0].attn, (x,)
    elif module == "DiTBlock":
        jax_mod, jp = jax_dit_mod.DiTBlock(64, 4), params["DiTBlock_1"]
        ours_mod, args = tmodel.blocks[1], (x, c)
    else:
        jax_mod, jp = jax_dit_mod.FinalLayer(64, 2, 3), params["FinalLayer_0"]
        ours_mod, args = tmodel.final_layer, (x, c)
    ref = jax_mod.apply({"params": jp}, *args)
    with torch.no_grad():
        ours = ours_mod(*map(torch.from_numpy, args))
    assert ours.shape == ref.shape
    assert max_rel(ours, ref) <= TOL


def forward_both(model, params, tmodel, x, t, y):
    yj = None if y is None else jnp.asarray(y, jnp.int32)
    ref = jax.jit(lambda p, xx, tt: model.apply({"params": p}, xx, tt, yj))(
        params, jnp.asarray(x), jnp.asarray(t, jnp.int32))
    with torch.no_grad():
        ours = tmodel(torch.from_numpy(x), torch.from_numpy(t),
                      None if y is None else torch.from_numpy(y))
    return ours.numpy(), np.asarray(ref)


@pytest.mark.parametrize("labels", ["conditional", "null"])
def test_dit_forward_matches_jax(cond16, labels):
    model, params, config = cond16
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    t = np.array([0, 10, 500, 999], np.int64)
    y = (np.array([1, 4, 7, 10], np.int64) if labels == "conditional"
         else np.zeros(4, np.int64))
    ours, ref = forward_both(model, params, torch_dit(params, config), x, t, y)
    assert ours.shape == ref.shape == (4, 16, 16, 3)
    assert ours.dtype == np.float32
    assert max_rel(ours, ref) <= TOL


def test_unconditional_dit_forward_matches_jax():
    model, params, config = jax_dit(False, seed=5)
    x = np.random.default_rng(5).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    t = np.array([3, 700], np.int64)
    ours, ref = forward_both(model, params, torch_dit(params, config), x, t,
                             None)
    assert max_rel(ours, ref) <= TOL


def test_ddim_10_step_cfg_trajectory_matches_jax(cond16):
    model, params, config = cond16
    tmodel = torch_dit(params, config)
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


def cfg_labels(b):
    return np.where(b["drop"], 0, b["labels"] + 1).astype(np.int32)


@pytest.fixture(scope="module")
def jax_value_and_grad(cond16):
    """(params, batch) -> (loss, grads) of the JAX DDPM eps-loss of the
    small DiT (dropout off: `train` False), jitted once for the module."""
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
        return value_and_grad(params, b["x0"], b["t"].astype(np.int32),
                              b["noise"], cfg_labels(b))

    return run


def test_dit_loss_and_every_gradient_match_jax(cond16, jax_value_and_grad):
    _, params, config = cond16
    b = batch(7)
    loss_ref, grads = jax_value_and_grad(params, b)
    grads_ref = state_dict_from_jax(grads, config)
    tmodel = torch_dit(params, config, dropout=0.0).train()
    tb = torch_batch(b)
    loss = DDPM(num_timesteps=1000).p_losses(
        tmodel, tb["x0"], tb["t"], tb["noise"],
        y=torch.from_numpy(cfg_labels(b)).long())
    loss.backward()
    assert max_rel(loss.detach(), loss_ref) <= TOL
    named = dict(tmodel.named_parameters())
    assert set(named) == set(grads_ref)
    for name, g in grads_ref.items():
        assert max_rel(named[name].grad, g) <= TOL, name


def train_config(config, tmp_path):
    return dict(
        config, optimizer="adamw", learning_rate=1e-3, weight_decay=1e-4,
        use_scheduler=True, scheduler_type="warmup_cosine", epochs=4,
        warmup_epochs=2, warmup_start_factor=0.1, use_ema=True,
        ema_decay=0.9, cfg_dropout_prob=0.2, gradient_accumulation_steps=1,
        loss_type="l2", batch_size=4, save_dir=str(tmp_path / "ckpt"),
        sample_dir=str(tmp_path / "samples"), seed=0)


def test_two_train_steps_match_the_jax_pieces(cond16, jax_value_and_grad,
                                              tmp_path):
    _, params, config = cond16
    config = train_config(config, tmp_path)
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

    trainer = DiffusionTrainer(torch_dit(params, config, dropout=0.0),
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


def loss_and_grads(model, b, seed):
    """Loss and gradients in train mode; `seed` fixes the dropout draws,
    the attention's seeds (the CPU generator) among them."""
    model.zero_grad(set_to_none=True)
    tb = torch_batch(b)
    torch.manual_seed(seed)
    loss = DDPM(num_timesteps=1000).p_losses(
        model, tb["x0"], tb["t"], tb["noise"],
        y=torch.from_numpy(cfg_labels(b)).long())
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def test_remat_dit_with_dropout_gives_the_loss_and_gradients_without(
        cond16, monkeypatch):
    """Dropout 0.1 on, attention's and the MLP's: under `remat` each block's
    recompute draws the same attention seed (the checkpoint restores the CPU
    generator), so the same masks, and the loss and every gradient equal
    the model's without remat."""
    _, params, config = cond16
    plain = torch_dit(params, config).train()
    remat = torch_dit(params, config, remat=True).train()
    seeds = []
    real_draw = attention.draw_seed

    def draw(generator=None):
        seeds.append(real_draw(generator))
        return seeds[-1]

    monkeypatch.setattr(attention, "draw_seed", draw)
    b = batch(12)
    loss, grads = loss_and_grads(plain, b, seed=5)
    first = list(seeds)
    seeds.clear()
    loss_r, grads_r = loss_and_grads(remat, b, seed=5)
    # the forward's draws, then the recompute's, block by block backwards
    assert len(first) == 2 and seeds == first + first[::-1]
    assert max_rel(loss_r, loss) <= 1e-6
    for name, g in grads.items():
        assert max_rel(grads_r[name], g) <= 1e-5, name
    # the draws matter: another seed gives another loss
    other, _ = loss_and_grads(plain, b, seed=6)
    assert max_rel(other, loss) > 1e-4


def test_eval_mode_draws_no_dropout_seed(cond16, monkeypatch):
    _, params, config = cond16
    model = torch_dit(params, config)
    monkeypatch.setattr(attention, "draw_seed",
                        lambda generator=None: pytest.fail("drew a seed"))
    x = torch.zeros(1, 16, 16, 3)
    with torch.no_grad():
        model(x, torch.tensor([5]), torch.tensor([1]))


# -------------------------------------------- DiM with attention fallback
def jax_dim_fallback(seed=0):
    model = jax_dim_mod.DiM(img_size=(16, 16), **DIM_PARAMS, num_classes=10,
                            use_attention_fallback=True)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3)),
                        jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1,), jnp.int32))["params"]
    return model, perturbed(params, seed), small_dim_config(True, 16)


def torch_dim_fallback(params, config, **overrides):
    model = DiM(img_size=(16, 16), **dict(DIM_PARAMS, **overrides),
                num_classes=10, use_attention_fallback=True)
    model.load_state_dict(state_dict_from_jax(params, config), strict=True)
    return model.eval()


def test_dim_attention_fallback_forward_matches_jax():
    model, params, config = jax_dim_fallback(seed=8)
    tmodel = torch_dim_fallback(params, config)
    assert set(state_dict_from_jax(params, config)) == set(
        export_torch_state_dict(params, "dim", config))
    mixer = tmodel.blocks[0].mamba_block.mamba
    assert mixer.num_heads == 8 and mixer.dropout == DIM_PARAMS["dropout"]
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    t = np.array([1, 300, 999], np.int64)
    y = np.array([0, 2, 9], np.int64)
    ours, ref = forward_both(model, params, tmodel, x, t, y)
    assert max_rel(ours, ref) <= TOL


def test_dim_attention_fallback_loss_and_gradients_match_jax():
    model, params, config = jax_dim_fallback(seed=9)
    b = batch(9)
    ddpm = jax_ddpm.DDPM(num_timesteps=1000)

    def loss_fn(p):
        return ddpm.p_losses(
            lambda x, tt, yy: model.apply({"params": p}, x, tt, yy),
            b["x0"], b["t"].astype(np.int32), b["noise"], y=cfg_labels(b))

    loss_ref, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    grads_ref = state_dict_from_jax(grads, config)
    tmodel = torch_dim_fallback(params, config, dropout=0.0).train()
    tb = torch_batch(b)
    loss = DDPM(num_timesteps=1000).p_losses(
        tmodel, tb["x0"], tb["t"], tb["noise"],
        y=torch.from_numpy(cfg_labels(b)).long())
    loss.backward()
    assert max_rel(loss.detach(), loss_ref) <= TOL
    named = dict(tmodel.named_parameters())
    assert set(named) == set(grads_ref)
    for name, g in grads_ref.items():
        assert max_rel(named[name].grad, g) <= TOL, name


# ------------------------------------------------------------ entry points
def tiny_dit_config(tmp_path, **changes):
    """A synthetic 8x8 DiT config (L = 16) that trains in seconds on the
    CPU: 512 images at batch 128, one epoch, dropout 0.1 on."""
    config = {
        "model_type": "dit", "experiment_name": "tiny-dit",
        "model_params": {"img_size": (8, 8), "patch_size": 2,
                         "in_channels": 3, "hidden_size": 32, "depth": 2,
                         "num_heads": 4, "mlp_ratio": 2.0, "dropout": 0.1},
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
        "seed": 42, **changes,
    }
    path = tmp_path / "dit.json"
    path.write_text(json.dumps(config))
    return str(path), config


@pytest.mark.parametrize("remat", [False, True])
def test_train_and_sample_clis_run_a_tiny_dit(tmp_path, remat):
    cfg_path, config = tiny_dit_config(tmp_path, remat=remat)
    before = (fa.LAUNCHES, fa.BWD_LAUNCHES)
    trainer = train.main(["--config", cfg_path, "--device", "cpu"])
    assert isinstance(trainer.model, DiT) and trainer.model.remat is remat
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
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == before  # CPU: plain


def test_sample_cli_from_a_jax_dit_checkpoint(cond16, tmp_path):
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
        "--batch_size", "2", "--cfg_scale", "3",
        "--labels", "1,7", "--use_ema", "--device", "cpu",
        "--output_dir", str(out)])
    samples = result["samples"]
    assert samples.shape == (2, 16, 16, 3) and np.isfinite(samples).all()
    assert (out / "samples.npy").is_file()


# ---------------------------------------------------------------- factory
def test_factory_builds_dit_with_injected_size_and_classes():
    config = {"model_type": "dit", "image_size": 20, "conditional": True,
              "num_classes": 10, "model_params": dict(DIT_PARAMS)}
    model = factory.get_model(config)
    assert isinstance(model, DiT) and model.tokens_hw == (10, 10)
    assert model.y_embedder is not None and not model.remat
    assert factory.get_model(dict(config, conditional=False)).y_embedder is None
    assert factory.get_model(dict(config, remat=True)).remat


@pytest.mark.parametrize("knob", [dict(num_experts=4), dict(tome_ratio=0.5),
                                  dict(quant="int8"),
                                  dict(pag_perturb=True, quant="int8")])
def test_dit_raises_on_knobs_not_ported(knob):
    """The DiT's last three families (MoE, token merging, int8), which
    raised until they were ported, build and run an eval forward, also
    beside `pag_perturb`; what still raises is int8 in training mode (their
    parity with JAX: tests/test_torch_port_moe.py, test_torch_port_tome.py,
    test_torch_port_quant.py)."""
    model = DiT(img_size=(16, 16), **DIT_PARAMS, num_classes=10, **knob)
    x = torch.randn(2, 16, 16, 3)
    t, y = torch.tensor([3, 700]), torch.tensor([1, 0])
    with torch.no_grad():
        out = model.eval()(x, t, y)
    assert out.shape == (2, 16, 16, 3) and torch.isfinite(out).all()
    assert model.num_experts == knob.get("num_experts", 0)
    assert model.quant == knob.get("quant")
    assert (model.tome is not None) == ("tome_ratio" in knob)
    if "quant" in knob:
        with pytest.raises(ValueError, match="inference-only"):
            model.train()(x, t, y)
    assert DiT(img_size=(16, 16), **DIT_PARAMS, pag_perturb=True).pag_perturb


def test_bridge_raises_on_a_moe_dit():
    """A Flax MoE DiT, which the bridge refused until the MoE MLP was
    ported, bridges to the port's names and loads strict."""
    model = jax_dit_mod.DiT(img_size=(8, 8), **DIT_PARAMS, num_experts=2)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
                        jnp.zeros((1,), jnp.int32))["params"]
    config = dict(small_dim_config(False, 8), model_type="dit")
    sd = state_dict_from_jax(params, config)
    assert sd["blocks.1.mlp.w1"].shape == (2, 64, 256)
    DiT(img_size=(8, 8), **DIT_PARAMS, num_experts=2).load_state_dict(
        sd, strict=True)
