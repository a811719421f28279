"""The sampler export (`serving.py`) for every denoiser family the port's
factory builds, on the CPU: the DiT, the DiM at a length that is no
multiple of 16 (L 100) and the latent UNet with its decode against the JAX
package's exported programs on the same weights and JAX's draws (as
`tests/test_torch_port_export.py`, bar 5e-4). The MoE, ToMe, int8 and bf16
families are `tests/test_torch_port_export_live.py`'s."""

import jax.numpy as jnp
import optax
import pytest

from diffusion_models_collection_tpu.models import DiM as JaxDiM
from diffusion_models_collection_tpu.models import DiT as JaxDiT
from diffusion_models_collection_tpu.models import UNet as JaxUNet
from diffusion_models_collection_tpu.models.vae import VAE as JaxVAE
from diffusion_models_collection_tpu.utils import checkpoint as jax_ckpt
from diffusion_models_collection_tpu_torch import factory
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from test_torch_port_export import port_and_jax
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    DIM_PARAMS,
    DIT_PARAMS,
    max_rel,
    one_torch_thread,
    small_dim_config,
    small_dit_config,
    torch_dim,
    torch_dit,
    traced_params,
)


def init_inputs(size, channels=3):
    return (jnp.zeros((1, size, size, channels)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1,), jnp.int32))


def test_dit_program_matches_jax():
    config = dict(small_dit_config(True), num_inference_steps=4,
                  cfg_scale=3.0)
    jmodel = JaxDiT(img_size=(16, 16), **DIT_PARAMS, num_classes=10)
    jparams = traced_params(jmodel, init_inputs(16), seed=21)
    ours, ref = port_and_jax(jmodel, jparams, torch_dit(jparams, config),
                             config, seed=22)
    assert max_rel(ours, ref) <= 5e-4


def test_dim_program_at_a_ragged_length_matches_jax():
    """20x20 images in patches of 2: L 100, whose last scan block is
    short."""
    config = dict(small_dim_config(True, size=20), num_inference_steps=4,
                  cfg_scale=3.0)
    jmodel = JaxDiM(img_size=(20, 20), **DIM_PARAMS, num_classes=10)
    jparams = traced_params(jmodel, init_inputs(20), seed=23)
    ours, ref = port_and_jax(jmodel, jparams, torch_dim(jparams, config),
                             config, seed=24)
    assert max_rel(ours, ref) <= 5e-4


HW, LHW, LC = 8, 4, 2  # pixels 8x8x3, latents 4x4x2
VAE_PARAMS = dict(in_channels=3, base_channels=8, channel_mult=(1, 2),
                  latent_channels=LC, num_res_blocks=1, use_attention=True)
UNET_PARAMS = dict(model_channels=32, num_res_blocks=1,
                   attention_resolutions=(2,), dropout=0.0,
                   channel_mult=(1, 2), use_attention=True)


@pytest.fixture(scope="module")
def vae_ckpt(tmp_path_factory):
    """A JAX-format VAE checkpoint, read by both packages' codecs."""
    model = JaxVAE(image_size=(HW, HW), **VAE_PARAMS)
    params = traced_params(model, (jnp.zeros((1, HW, HW, 3)),
                                   jnp.zeros((1, LHW, LHW, LC))), seed=25)
    path = tmp_path_factory.mktemp("vae") / "best_model.ckpt"
    jax_ckpt.save_checkpoint(
        path, epoch=1, params=params,
        opt_state=optax.adamw(1e-4).init(params), best_loss=0.1,
        config={"model_type": "vae", "image_size": HW, "conditional": False,
                "model_params": dict(VAE_PARAMS, dropout=0.0),
                "mixed_precision": "none"},
        ema_params=params)
    return path


def test_latent_unet_program_with_its_decode_matches_jax(vae_ckpt):
    config = {"model_type": "unet", "model_params": dict(UNET_PARAMS),
              "latent_diffusion": True, "vae_checkpoint": str(vae_ckpt),
              "latent_scale_factor": 0.7, "image_size": HW,
              "conditional": True, "num_classes": 10, "num_timesteps": 1000,
              "beta_start": 0.0001, "beta_end": 0.02,
              "beta_schedule": "linear", "num_inference_steps": 4,
              "ddim_eta": 0.0, "cfg_scale": 3.0, "mixed_precision": "none"}
    jmodel = JaxUNet(image_size=(LHW, LHW), in_channels=LC, out_channels=LC,
                     num_classes=10, **UNET_PARAMS)
    jparams = traced_params(jmodel, init_inputs(LHW, LC), seed=26)
    model = factory.get_model(config)
    model.load_state_dict(state_dict_from_jax(jparams, config), strict=True)
    ours, ref = port_and_jax(jmodel, jparams, model.eval(), config, seed=27)
    assert ours.shape == (2, HW, HW, 3)
    assert max_rel(ours, ref) <= 5e-4
