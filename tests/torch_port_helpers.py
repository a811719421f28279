"""Shared set-up of the PyTorch port's parity tests: a small JAX UNet with
seeded, perturbed params, its config, and the port's UNet with the same
weights through the weight bridge."""

import jax
import jax.numpy as jnp
import numpy as np

from diffusion_models_collection_tpu.models import UNet as JaxUNet
from diffusion_models_collection_tpu_torch.models import UNet
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
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(
            np.float32), params)
    return model, params, small_config(conditional)


def torch_unet(params, config):
    """The port's UNet with the same weights, strict load, eval mode."""
    num_classes = 10 if config["conditional"] else None
    model = UNet(**MODEL_PARAMS, num_classes=num_classes)
    model.load_state_dict(state_dict_from_jax(params, config), strict=True)
    return model.eval()


def max_rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30)
