"""Shared set-up of the PyTorch port's parity tests: a small JAX UNet and a
small JAX DiM with seeded, perturbed params, their configs, and the port's
models with the same weights through the weight bridge."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.pallas import tpu as pltpu

from diffusion_models_collection_tpu.models import DiM as JaxDiM
from diffusion_models_collection_tpu.models import UNet as JaxUNet
from diffusion_models_collection_tpu.ops import dispatch
from diffusion_models_collection_tpu_torch.models import DiM, UNet
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)

H = W = 16
MODEL_PARAMS = dict(image_size=(H, W), in_channels=3, model_channels=32,
                    out_channels=3, num_res_blocks=1,
                    attention_resolutions=(8,), dropout=0.1,
                    channel_mult=(1, 2), use_attention=True)


def small_config(conditional=True):
    return {
        "model_type": "unet",
        "model_params": dict(MODEL_PARAMS),
        "image_size": (H, W),
        "conditional": conditional,
        "num_classes": 10,
        "num_timesteps": 1000,
        "beta_start": 0.0001,
        "beta_end": 0.02,
        "beta_schedule": "linear",
        "num_inference_steps": 10,
        "ddim_eta": 0.0,
        "mixed_precision": "none",
    }


def jax_unet(conditional=True, seed=0):
    """(flax model, params as numpy, config). Every param is perturbed by
    seeded noise, so norms are not the identity and the null label's row 0
    is not zero (both sides must mask it at lookup)."""
    num_classes = 10 if conditional else None
    model = JaxUNet(**MODEL_PARAMS, num_classes=num_classes)
    y = jnp.zeros((1,), jnp.int32) if conditional else None
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)),
                        jnp.zeros((1,), jnp.int32), y)["params"]
    return model, perturbed(params, seed), small_config(conditional)


def torch_unet(params, config):
    """The port's UNet with the same weights, strict load, eval mode."""
    num_classes = 10 if config["conditional"] else None
    model = UNet(**MODEL_PARAMS, num_classes=num_classes)
    model.load_state_dict(state_dict_from_jax(params, config), strict=True)
    return model.eval()


def perturbed(params, seed):
    """Every param plus seeded noise (0.05 std), as numpy: norms are not the
    identity, adaLN and the output layers are not zero, and the null
    label's row 0 is not zero (both sides must mask it at lookup)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(
            np.float32), params)


# hidden 64: d_inner 128, so the JAX gate takes its Pallas scan kernels
DIM_PARAMS = dict(patch_size=2, in_channels=3, hidden_size=64, depth=2,
                  state_size=16, mlp_ratio=4.0, dropout=0.1)


def small_dim_config(conditional=True, size=16):
    return dict(small_config(conditional), model_type="dim",
                model_params=dict(DIM_PARAMS, img_size=(size, size)),
                image_size=(size, size))


def jax_dim(conditional=True, seed=0, size=16):
    """(flax DiM, perturbed params as numpy, config) at size x size, so
    L = (size / 2)^2 tokens."""
    num_classes = 10 if conditional else None
    model = JaxDiM(img_size=(size, size), **DIM_PARAMS,
                   num_classes=num_classes)
    y = jnp.zeros((1,), jnp.int32) if conditional else None
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, size, size, 3)),
                        jnp.zeros((1,), jnp.int32), y)["params"]
    return model, perturbed(params, seed), small_dim_config(conditional, size)


def torch_dim(params, config, **overrides):
    """The port's DiM with the same weights, strict load, eval mode."""
    num_classes = 10 if config["conditional"] else None
    model = DiM(img_size=config["image_size"],
                **dict(DIM_PARAMS, **overrides), num_classes=num_classes)
    model.load_state_dict(state_dict_from_jax(params, config), strict=True)
    return model.eval()


def max_rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30)


def run_pallas_interpreted(fn, *args):
    """`fn(*args)` with the JAX package's Pallas kernels on (also where a
    model reaches them through `ops.dispatch`) and run by the interpreter,
    as one jitted computation that is waited for before anything else is
    dispatched. The interpreter's callbacks dispatch JAX ops of their own;
    called eagerly, a model's next op, dispatched from the test's thread
    while those callbacks run, can deadlock both threads."""
    with dispatch.use_pallas(True), pltpu.force_tpu_interpret_mode():
        return jax.block_until_ready(jax.jit(fn)(*args))
