"""The port's models in mixed precision (`mixed_precision: 'bf16'`) against
the JAX package's, on the CPU, at tiny widths: the UNet, the DiT
(conditional, null label, unconditional) and the DiM (its Mamba mixer and its
attention fallback), with the JAX package's parameters carried over by
`utils/weights.py` and perturbed as `torch_port_helpers.perturbed` does.

Both sides run the JAX policy (`factory.py:125-133`, `models/layers.py:19-24`
of the JAX package): float32 parameters, bf16 convs, linears and
activations, float32 norms' statistics and scan, float32 eps. They round at
different places (flax's Dense adds its bias after rounding the product; the
JAX attention computes its softmax in bf16 where the port's kernels compute
in float32), so no float32 bar applies. Each bar below was fixed by
measurement on these inputs and is checked, in the test, to be no looser
than twice JAX's own distance between its bf16 and float32 runs of the same
input, and the port's bf16 run is held to it against both JAX runs. So
that a port which ran float32 under `mixed_precision: 'bf16'` cannot pass
(it would sit within the bar of both), the port's bf16 run must also lie at
least half JAX's own distance from the port's float32 run, and in the
forward every cast linear, conv and layer norm of the port must return
bf16. Distances are max|a - b| / max|b| (of the train steps' changes:
`rel_norm`); the float32 bars of the other port tests (2e-4, 5e-4) do not
move.

The trajectory is DDIM-10 with CFG 3 from one noise; two train steps are
tests/test_torch_port_bf16_training.py's, with this file's bars.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.diffusion.ddim import DDIM as JaxDDIM
from diffusion_models_collection_tpu.models import dim as jax_dim_mod
from diffusion_models_collection_tpu_torch import factory
from diffusion_models_collection_tpu_torch.diffusion import DDIM
from diffusion_models_collection_tpu_torch.models.layers import (
    CastConv1d,
    CastConv2d,
    CastLayerNorm,
    CastLinear,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from torch_port_helpers import (
    jax_dim,
    jax_dit,
    jax_unet,
    max_rel,
    perturbed,
    small_dim_config,
)

BF16 = jnp.bfloat16

# The bars, fixed by measurement on this file's inputs (in brackets: the
# port's bf16 run against JAX's bf16 and float32 runs, then JAX's own
# bf16-vs-float32 distance, on the CPU). `check_bar` asserts each bar is at
# most twice JAX's own distance.
FORWARD_BAR = {
    "unet": 2e-2,  # (1.43e-2, 1.27e-2; 1.23e-2)
    "dit": 1.5e-2,  # (1.01e-2, 8.68e-3; 7.94e-3)
    "dit_null": 1.3e-2,  # (9.71e-3, 7.42e-3; 6.90e-3)
    "dit_uncond": 1.5e-2,  # (8.98e-3, 9.72e-3; 8.82e-3)
    "dim": 1.2e-2,  # (8.46e-3, 6.20e-3; 7.71e-3)
    "dim_fallback": 1.6e-2,  # (1.23e-2, 7.31e-3; 9.06e-3)
}
# Ten CFG-3 steps of a random (perturbed) network amplify each step's bf16
# rounding: JAX's own runs end 0.81 apart in the UNet's case, of samples
# clipped to [-1, 1].
TRAJECTORY_BAR = {
    "unet": 1.0,  # (0.852, 0.811; 0.811)
    "dit": 0.1,  # (6.95e-2, 6.17e-2; 7.56e-2)
    "dim": 0.2,  # (9.12e-2, 0.144; 0.130)
    "dim_fallback": 7e-2,  # (4.64e-2, 4.79e-2; 4.43e-2)
}
# The change that two steps make to the parameters and to the EMA (each
# bar: parameters, EMA), in the distance `rel_norm`. AdamW scales each
# coordinate's step to about the learning rate whatever its gradient, so a
# coordinate whose gradient is at the level of the rounding takes a full
# step of either sign: JAX's own two runs differ by up to 1.9 of the largest
# change in some coordinate, and a max bar would pass a trainer that made
# no update. The norm of the difference over the norm of the change holds
# the update as a whole (no update: 1).
TRAIN_BAR = {
    "unet": (8e-2, 9e-2),  # params (5.70e-2, 4.78e-2; 5.07e-2), EMA
    # (6.96e-2, 5.96e-2; 6.32e-2)
    "dit": (7e-2, 8e-2),  # (5.08e-2, 4.29e-2; 4.64e-2), (6.00e-2,
    # 5.30e-2; 5.67e-2)
    "dim": (6e-2, 7e-2),  # (3.92e-2, 3.20e-2; 3.83e-2), (5.12e-2, 4.30e-2;
    # 4.96e-2)
    "dim_fallback": (7e-2, 8e-2),  # (5.24e-2, 4.16e-2; 4.41e-2), (6.09e-2,
    # 5.10e-2; 5.38e-2)
}
# The two losses. A loss is one scalar mean over 3072 squared errors: its
# bf16 noise is about twice the eps distance over sqrt(3072), 4e-4 here, and
# JAX's own two losses are one draw of it (1.2e-4 to 4.3e-4 apart), too
# small a sample to set a bar. So the losses are held to twice that
# estimate, 1e-3 (measured: 3.9e-4, 4.9e-4 for the UNet; 2.3e-4 at most for
# the others), which the test asserts is at most a tenth of the model's
# forward bar, the rounding the loss averages.
LOSS_BAR = 1e-3


def jax_dim_fallback(seed):
    model = jax_dim_mod.DiM(img_size=(16, 16), patch_size=2, in_channels=3,
                            hidden_size=64, depth=2, state_size=16,
                            mlp_ratio=4.0, dropout=0.1, num_classes=10,
                            use_attention_fallback=True)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3)),
                        jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1,), jnp.int32))["params"]
    config = small_dim_config(True, 16)
    config["model_params"]["use_attention_fallback"] = True
    return model, perturbed(params, seed), config


@functools.lru_cache(maxsize=None)
def built(name):
    """(flax model, perturbed params, config) of a tiny model: 16x16 images,
    the UNet at 32 channels (attention at 8x8), the DiT and DiM at hidden 64,
    depth 2 (L = 64)."""
    if name == "unet":
        return jax_unet(True, seed=0)
    if name == "dit":
        return jax_dit(True, seed=0)
    if name == "dit_uncond":
        return jax_dit(False, seed=5)
    if name == "dim":
        return jax_dim(True, seed=3)
    return jax_dim_fallback(seed=8)


def port_model(params, config, dropout=None, mixed_precision="bf16"):
    """The port's model in bf16 (`mixed_precision: 'bf16'` through the
    factory, or as `mixed_precision` says) with the JAX parameters, eval
    mode; `dropout` overrides the config's."""
    config = dict(config, mixed_precision=mixed_precision)
    if dropout is not None:
        config["model_params"] = dict(config["model_params"], dropout=dropout)
    model = factory.get_model(config)
    model.load_state_dict(state_dict_from_jax(params, config), strict=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    return model.eval()


def jax_apply(model, params, x, t, y):
    yj = None if y is None else jnp.asarray(y, jnp.int32)
    return np.asarray(jax.jit(
        lambda p, xx, tt: model.apply({"params": p}, xx, tt, yj))(
            params, jnp.asarray(x), jnp.asarray(t, jnp.int32)))


def rel_norm(ours, ref):
    return np.linalg.norm(ours - ref) / max(np.linalg.norm(ref), 1e-30)


def check_bar(bar, name, ours, ours32, jax16, jax32, distance=max_rel):
    """The port's bf16 result `ours` against JAX's bf16 and float32 results,
    within the measured bar, which is no looser than twice JAX's own
    bf16-vs-float32 distance; and at least half that distance from the
    port's float32 result `ours32`, so that the port did round."""
    own = distance(jax16, jax32)
    to16, to32 = distance(ours, jax16), distance(ours, jax32)
    rounded = distance(ours, ours32)
    print(f"{name}: port-vs-jax-bf16 {to16:.3e}, port-vs-jax-fp32 {to32:.3e},"
          f" jax bf16-vs-fp32 {own:.3e}, port bf16-vs-fp32 {rounded:.3e}")
    assert bar <= 2 * own, (bar, own)
    assert to16 <= bar and to32 <= bar, (to16, to32, bar)
    assert rounded >= own / 2, (rounded, own)


def bf16_outputs_checked(model):
    """Hooks on every cast linear, conv and layer norm of `model` that
    record whether each returned bf16, as flax's `dtype=bf16` modules do
    (an autocast-style policy returns float32 from the norms)."""
    dtypes = []
    for module in model.modules():
        if isinstance(module, (CastLinear, CastConv1d, CastConv2d,
                               CastLayerNorm)):
            module.register_forward_hook(
                lambda mod, args, out: dtypes.append((type(mod).__name__,
                                                      out.dtype)))
    return dtypes


# name, labels: (built model, labels) of each forward case
FORWARD_CASES = [("unet", "conditional"), ("dit", "conditional"),
                 ("dit_null", "null"), ("dit_uncond", None),
                 ("dim", "conditional"), ("dim_fallback", "conditional")]


@pytest.mark.parametrize("name,labels", FORWARD_CASES)
def test_bf16_forward_matches_jax(name, labels):
    model, params, config = built("dit" if name == "dit_null" else name)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    t = np.array([0, 10, 500, 999], np.int64)
    y = {"conditional": np.array([1, 4, 7, 10], np.int64),
         "null": np.zeros(4, np.int64), None: None}[labels]
    jax32 = jax_apply(model, params, x, t, y)
    jax16 = jax_apply(model.clone(dtype=BF16), params, x, t, y)
    args = (torch.from_numpy(x), torch.from_numpy(t),
            None if y is None else torch.from_numpy(y))
    model16 = port_model(params, config)
    dtypes = bf16_outputs_checked(model16)
    with torch.no_grad():
        ours = model16(*args)
        ours32 = port_model(params, config, mixed_precision="none")(*args)
    assert dtypes and all(dt == torch.bfloat16 for _, dt in dtypes), dtypes
    assert ours.dtype == torch.float32 and jax16.dtype == np.float32
    assert ours.shape == (4, 16, 16, 3)
    check_bar(FORWARD_BAR[name], name, ours.numpy(), ours32.numpy(), jax16,
              jax32)


TRAIN_NAMES = ["unet", "dit", "dim", "dim_fallback"]


@pytest.mark.parametrize("name", TRAIN_NAMES)
def test_bf16_ddim_10_cfg_trajectory_matches_jax(name):
    model, params, config = built(name)
    noise = np.random.default_rng(6).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    y = np.array([3, 8], np.int64)

    def jax_run(m):
        return np.asarray(JaxDDIM(num_timesteps=1000,
                                  num_inference_steps=10).sample_with_cfg(
            jax.tree_util.Partial(
                lambda x, t, yy: m.apply({"params": params}, x, t, yy)),
            noise.shape, jnp.asarray(y, jnp.int32), jax.random.PRNGKey(0),
            cfg_scale=3.0, init_noise=jnp.asarray(noise)))

    def port_run(mixed_precision):
        return DDIM(num_timesteps=1000,
                    num_inference_steps=10).sample_with_cfg(
            port_model(params, config, mixed_precision=mixed_precision),
            noise.shape, torch.from_numpy(y), cfg_scale=3.0,
            init_noise=torch.from_numpy(noise))

    ours = port_run("bf16")
    assert ours.dtype == torch.float32 and np.isfinite(ours.numpy()).all()
    check_bar(TRAJECTORY_BAR[name], name, ours.numpy(),
              port_run("none").numpy(), jax_run(model.clone(dtype=BF16)),
              jax_run(model))
