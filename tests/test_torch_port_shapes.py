"""The widths that the port's kernels once refused, against the JAX package
on the CPU at a small size: a DiM with 64 states a channel (more than the
32 a scan kernel's walk holds: the card runs them in chunks of 32) and DiTs
whose heads are 64, 32 and 136 wide (num_heads 1 and 2 at hidden 64, and
one head at hidden 136, past the 128 of the attention kernels' one-tile
forms: the card runs their wide forms). Here both sides run the plain
versions of the kernels; `cuda` tests in tests/test_torch_port_kernels.py
hold the kernels to those plain versions on the card.

Weights go through the weight bridge (`utils/weights.py`), inputs and noises
come from numpy with a fixed seed and go to both sides. The JAX DiM at 64
states runs its XLA scan (its Pallas gate stops at 32). The DiT's training
step runs with dropout 0.1 on both sides and the masks passed explicitly:
the port's through its replay hooks (`SelfAttention.replayed_seed`,
`Dropout.replayed`), JAX's by `jax.random.bernoulli` replaced in the test
with a function that returns the same masks in the order the model draws
them (the JAX package is not edited). Bars, as max|port - jax| / max|jax|:
2e-4 for a forward, a loss and its gradients (the repo's forward bar,
tests/test_torch_import.py:63), 5e-4 for a DDIM-10 CFG trajectory, and for
the stated scan 1e-5 forward and 1e-4 for its gradients (the scan's bars,
tests/test_torch_port_faults.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.diffusion import ddpm as jax_ddpm
from diffusion_models_collection_tpu.diffusion.ddim import DDIM as JaxDDIM
from diffusion_models_collection_tpu.models import DiM as JaxDiM
from diffusion_models_collection_tpu.models import DiT as JaxDiT
from diffusion_models_collection_tpu.ops.selective_scan import (
    selective_scan_with_state as jax_scan_with_state,
)
from diffusion_models_collection_tpu_torch.diffusion import DDIM, DDPM
from diffusion_models_collection_tpu_torch.models import DiM, DiT
from diffusion_models_collection_tpu_torch.models.layers import Dropout
from diffusion_models_collection_tpu_torch.ops import flash_attention as fa
from diffusion_models_collection_tpu_torch.ops import selective_scan as ss
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    DIM_PARAMS,
    DIT_PARAMS,
    max_rel,
    one_torch_thread,
    perturbed,
    small_config,
)

TOL = 2e-4
TOL_TRAJ = 5e-4
SIZE = 16
N_STATE = 64
P = 0.1  # the DiT's dropout in its training step


def dim_config(remat=False):
    params = dict(DIM_PARAMS, state_size=N_STATE, img_size=(SIZE, SIZE))
    return dict(small_config(True), model_type="dim", model_params=params,
                image_size=(SIZE, SIZE), remat=remat)


def dit_config(hidden, heads):
    params = dict(DIT_PARAMS, hidden_size=hidden, num_heads=heads,
                  img_size=(SIZE, SIZE))
    return dict(small_config(True), model_type="dit", model_params=params,
                image_size=(SIZE, SIZE))


def jax_model(cls, config, seed, **extra):
    """(flax model, perturbed numpy params) of `config`'s model_params."""
    kw = dict(config["model_params"])
    model = cls(**kw, num_classes=10, **extra)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, SIZE, SIZE, 3)),
                        jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1,), jnp.int32))["params"]
    return model, perturbed(params, seed)


def torch_model(cls, config, params, **extra):
    kw = dict(config["model_params"])
    model = cls(**kw, num_classes=10, **extra)
    model.load_state_dict(state_dict_from_jax(params, config), strict=True)
    return model


@pytest.fixture(scope="module")
def dim64():
    config = dim_config()
    model, params = jax_model(JaxDiM, config, 3)
    return model, params, config


def batch(seed, n=4):
    """x0 in [-1, 1], t, noise and labels 0..10 (0: the null label)."""
    rng = np.random.default_rng(seed)
    return dict(
        x0=rng.uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32),
        t=rng.integers(0, 1000, n).astype(np.int64),
        noise=rng.standard_normal((n, SIZE, SIZE, 3)).astype(np.float32),
        y=rng.integers(0, 11, n).astype(np.int64),
    )


def jax_loss_and_grads(apply, params, b):
    """JAX's DDPM eps-loss of `apply(params, x, t, y)` and its gradients."""
    ddpm = jax_ddpm.DDPM(num_timesteps=1000)

    def loss_fn(p):
        return ddpm.p_losses(lambda x, tt, yy: apply(p, x, tt, yy),
                             b["x0"], b["t"].astype(np.int32), b["noise"],
                             y=b["y"].astype(np.int32))

    return jax.value_and_grad(loss_fn)(params)


def torch_loss_and_grads(model, b):
    model.zero_grad(set_to_none=True)
    loss = DDPM(num_timesteps=1000).p_losses(
        model, *(torch.from_numpy(b[k]) for k in ("x0", "t", "noise")),
        y=torch.from_numpy(b["y"]))
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


def check_loss_and_grads(ours, ref, config):
    loss, grads = ours
    loss_ref, grads_ref = ref[0], state_dict_from_jax(ref[1], config)
    assert max_rel(loss, loss_ref) <= TOL
    assert set(grads) == set(grads_ref)
    for name, g in grads_ref.items():
        assert max_rel(grads[name], g) <= TOL, name


# ----------------------------------------------------------- the DiM, N 64
def test_dim_with_64_states_forward_matches_jax(dim64):
    model, params, config = dim64
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, SIZE, SIZE, 3)).astype(np.float32)
    t = np.array([0, 10, 500, 999], np.int64)
    y = np.array([1, 4, 7, 0], np.int64)
    ref = model.apply({"params": params}, jnp.asarray(x),
                      jnp.asarray(t, jnp.int32), jnp.asarray(y, jnp.int32))
    ours = torch_model(DiM, config, params).eval()
    with torch.no_grad():
        out = ours(*map(torch.from_numpy, (x, t, y)))
    assert out.shape == ref.shape == (4, SIZE, SIZE, 3)
    assert max_rel(out.numpy(), ref) <= TOL


@pytest.mark.parametrize("remat", [False, True])
def test_dim_with_64_states_loss_and_gradients_match_jax(dim64, remat):
    """One training step's loss and every gradient, without and with
    `remat` on both sides (the port's remat DiM keeps no scan states and
    rebuilds them in the backward)."""
    _, params, config = dim64
    model = JaxDiM(**config["model_params"], num_classes=10, remat=remat)
    b = batch(9)
    ref = jax_loss_and_grads(
        lambda p, x, t, y: model.apply({"params": p}, x, t, y), params, b)
    ours = torch_model(DiM, config, params, remat=remat).eval()
    check_loss_and_grads(torch_loss_and_grads(ours, b), ref, config)


def test_dim_with_64_states_ddim_10_cfg_trajectory_matches_jax(dim64):
    model, params, config = dim64
    noise = np.random.default_rng(10).standard_normal(
        (2, SIZE, SIZE, 3)).astype(np.float32)
    y = np.array([3, 8], np.int64)
    ref = JaxDDIM(num_timesteps=1000, num_inference_steps=10).sample_with_cfg(
        jax.tree_util.Partial(
            lambda x, t, yy: model.apply({"params": params}, x, t, yy)),
        noise.shape, jnp.asarray(y, jnp.int32), jax.random.PRNGKey(0),
        cfg_scale=3.0, init_noise=jnp.asarray(noise))
    ours = DDIM(num_timesteps=1000, num_inference_steps=10).sample_with_cfg(
        torch_model(DiM, config, params).eval(), noise.shape,
        torch.from_numpy(y), cfg_scale=3.0, init_noise=torch.from_numpy(noise))
    assert np.isfinite(ours.numpy()).all()
    assert max_rel(ours.numpy(), ref) <= TOL_TRAJ


@pytest.mark.parametrize("length", [32, 50])
def test_stated_scan_at_48_states_matches_jax(length):
    """E4 (the sequence-parallel DiM's building block) at 48 states, a
    chunk of 32 and one of 16 on the card: y and h_out from a state h_in,
    and the gradients of x, dt, A, B, C and h_in under cotangents of both
    outputs."""
    rng = np.random.default_rng(length)
    n = 48
    x = rng.standard_normal((2, length, 24)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal(x.shape) - 1)).astype(np.float32)
    A = -np.exp(rng.standard_normal((24, n))).astype(np.float32)
    B, C = (rng.standard_normal((2, length, n)).astype(np.float32)
            for _ in range(2))
    h_in = 0.5 * rng.standard_normal((2, 24, n)).astype(np.float32)
    g_y = rng.standard_normal(x.shape).astype(np.float32)
    g_h = rng.standard_normal(h_in.shape).astype(np.float32)
    args = (x, dt, A, B, C, h_in)
    (y_ref, h_ref), vjp = jax.vjp(jax_scan_with_state,
                                  *map(jnp.asarray, args))
    grads_ref = vjp((jnp.asarray(g_y), jnp.asarray(g_h)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, h_out = ss.selective_scan_with_state(*leaves)
    assert max_rel(y.detach().numpy(), y_ref) <= 1e-5
    assert max_rel(h_out.detach().numpy(), h_ref) <= 1e-5
    grads = torch.autograd.grad((y, h_out), leaves,
                                (torch.from_numpy(g_y), torch.from_numpy(g_h)))
    for name, got, want in zip(("x", "dt", "A", "B", "C", "h_in"), grads,
                               grads_ref):
        assert max_rel(got.numpy(), want) <= 1e-4, name


# -------------------------------------------- DiTs at head_dim 64, 32, 136
DIT_WIDTHS = [(64, 1), (64, 2), (136, 1)]  # (hidden, heads): head_dim 64,
# 32 and 136


@pytest.fixture(scope="module", params=DIT_WIDTHS,
                ids=[f"head_dim{h // n}" for h, n in DIT_WIDTHS])
def dit_wide(request):
    hidden, heads = request.param
    config = dit_config(hidden, heads)
    model, params = jax_model(JaxDiT, config, 4)
    return model, params, config


def test_dit_forward_at_its_head_width_matches_jax(dit_wide):
    model, params, config = dit_wide
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, SIZE, SIZE, 3)).astype(np.float32)
    t = np.array([0, 10, 500, 999], np.int64)
    y = np.array([1, 4, 7, 0], np.int64)
    ref = model.apply({"params": params}, jnp.asarray(x),
                      jnp.asarray(t, jnp.int32), jnp.asarray(y, jnp.int32))
    ours = torch_model(DiT, config, params).eval()
    with torch.no_grad():
        out = ours(*map(torch.from_numpy, (x, t, y)))
    assert out.shape == ref.shape == (4, SIZE, SIZE, 3)
    assert max_rel(out.numpy(), ref) <= TOL


def dropout_draws(config, n, seed):
    """For each block in the order the model draws them: the attention's
    seed and its keep mask (n, heads, L, L), and the MLP's two keep masks,
    Bernoulli(1 - P) from numpy."""
    kw = config["model_params"]
    heads, hidden = kw["num_heads"], kw["hidden_size"]
    length = (SIZE // kw["patch_size"]) ** 2
    width = int(hidden * kw["mlp_ratio"])
    rng = np.random.default_rng(seed)
    draws = []
    for _ in range(kw["depth"]):
        attn_seed = int(rng.integers(0, 2**63 - 1))
        attn = fa.philox_keep_mask(attn_seed, n * heads, length, length,
                                   P).numpy().reshape(n, heads, length, length)
        mlp = [rng.uniform(size=(n, length, w)) >= P
               for w in (width, hidden)]
        draws.append((attn_seed, attn, mlp))
    return draws


def test_dit_train_step_with_dropout_masks_matches_jax(dit_wide, monkeypatch):
    """The loss and every gradient of one training step with dropout 0.1 in
    the attention and the MLP, the masks handed to both sides."""
    model, params, config = dit_wide
    b = batch(12)
    draws = dropout_draws(config, len(b["t"]), 13)
    masks = [m for _, attn, mlp in draws for m in (attn, *mlp)]
    taken = []

    def bernoulli(key, p, shape):
        mask = masks[len(taken)]
        taken.append((p, tuple(shape)))
        return jnp.asarray(mask.reshape(shape))

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    ref = jax_loss_and_grads(
        lambda p, x, t, y: model.apply(
            {"params": p}, x, t, y, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}),
        params, b)
    assert [shape for _, shape in taken] == [m.shape for m in masks]
    assert all(p == pytest.approx(1 - P) for p, _ in taken)

    ours = torch_model(DiT, config, params).train()
    for block, (attn_seed, _, mlp) in zip(ours.blocks, draws):
        block.attn.replayed_seed = attn_seed
        dropouts = [m for m in block.mlp.modules() if isinstance(m, Dropout)]
        assert len(dropouts) == 2
        for module, keep in zip(dropouts, mlp):
            module.replayed = torch.from_numpy(keep)
    check_loss_and_grads(torch_loss_and_grads(ours, b), ref, config)
    # and the draws did act: without them the loss differs
    ours.eval()
    with torch.no_grad():
        plain = DDPM(num_timesteps=1000).p_losses(
            ours, *(torch.from_numpy(b[k]) for k in ("x0", "t", "noise")),
            y=torch.from_numpy(b["y"]))
    assert abs(float(plain) - float(ref[0])) > 1e-4 * abs(float(ref[0]))
