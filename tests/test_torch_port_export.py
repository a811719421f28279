"""The sampler export (`serving.py`) against the JAX package's, on the CPU:
the UNet with DDIM and classifier-free guidance and with DDPM unguided at
T 8, one blob run with two parameter sets, the refusals; and the 64x64 DiT
(L 1024) forward.

Each parity case exports both packages' trajectories at a tiny size on the
same weights (the JAX params through the weight bridge, `utils/weights.py`)
and runs the loaded programs on JAX's own draws: `jax.random.split(rng)`,
the initial image from the second key, DDPM's step noise
`normal(fold_in(first key, t))` (JAX `diffusion/ddim.py:250-257`,
`ddpm.py:276-285`), handed to the port's program as its x_T and noises.
Bars, as max|port - jax| / max|jax|: 5e-4 for a trajectory (the other
parity tests' bar), 2e-4 for a forward. The port's program against the
port's live sampler is bit for bit: the same operations in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.models import DiT as JaxDiT
from diffusion_models_collection_tpu.serving import (
    export_sampler as jax_export_sampler,
)
from diffusion_models_collection_tpu.serving import (
    run_exported as jax_run_exported,
)
from diffusion_models_collection_tpu_torch import factory, serving
from diffusion_models_collection_tpu_torch.models import DiT
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    DIT_PARAMS,
    max_rel,
    one_torch_thread,
    small_dit_config,
    torch_unet,
    traced_params,
    traced_unet,
)

BATCH = 2
LABELS = np.array([1, 3], np.int32)


def ddpm_noises(steps):
    """JAX DDPM's step noises from the key left after the initial split, in
    the order the steps run (t = T - 1 down to 0)."""
    def draw(rng, shape):
        return torch.stack([torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(rng, t), shape, jnp.float32)))
            for t in range(steps - 1, -1, -1)])
    return draw


def port_and_jax(jmodel, jparams, model, config, seed, method="ddim",
                 noises=None):
    """(the port's images, the JAX package's) from each package's exported
    program on JAX's draws for PRNGKey(seed): x_T from the second key of
    `jax.random.split`, and `noises(first key, shape)` where the sampler
    draws per step."""
    key = jax.random.PRNGKey(seed)
    jblob = jax_export_sampler(jmodel, jparams, config, batch_size=BATCH,
                               sampling_method=method)
    ref = np.asarray(jax_run_exported(jblob, jparams, key,
                                      jnp.asarray(LABELS)))
    params = dict(model.named_parameters())
    blob = serving.export_sampler(model, params, config, batch_size=BATCH,
                                  sampling_method=method, device="cpu")
    _, meta = serving.load_exported(blob)
    shape = tuple(meta["shape"])
    rng, init_rng = jax.random.split(key)
    x_T = torch.from_numpy(np.array(
        jax.random.normal(init_rng, shape, jnp.float32)))
    draws = None if noises is None else noises(rng, shape)
    assert meta["draws"] == (0 if draws is None else len(draws))
    ours = serving.run_exported(blob, params, None, LABELS, init_noise=x_T,
                                noises=draws, device="cpu")
    assert ours.shape == ref.shape
    return ours.numpy(), ref


def test_unet_ddim_cfg_program_matches_jax():
    jmodel, jparams, config = traced_unet(True, seed=1)
    config = dict(config, num_inference_steps=5, cfg_scale=3.0)
    ours, ref = port_and_jax(jmodel, jparams, torch_unet(jparams, config),
                             config, seed=7)
    assert 0.0 <= ours.min() and ours.max() <= 1.0
    assert max_rel(ours, ref) <= 5e-4


def test_unet_ddpm_unguided_program_matches_jax():
    jmodel, jparams, config = traced_unet(False, seed=2)
    config = dict(config, num_timesteps=8)
    ours, ref = port_and_jax(jmodel, jparams, torch_unet(jparams, config),
                             config, seed=8, method="ddpm",
                             noises=ddpm_noises(8))
    assert max_rel(ours, ref) <= 5e-4


def test_one_blob_runs_each_parameter_set_as_its_live_sampler():
    _, jparams, config = traced_unet(True, seed=3)
    config = dict(config, num_inference_steps=4, cfg_scale=2.0)
    models = [torch_unet(jparams, config), torch_unet(jparams, config)]
    with torch.no_grad():
        for p in models[1].parameters():
            p.mul_(1.1)
    blob = serving.export_sampler(models[0],
                                  dict(models[0].named_parameters()), config,
                                  batch_size=BATCH, device="cpu")
    x_T = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (BATCH, 16, 16, 3)).astype(np.float32))
    ddim = factory.get_diffusion(config, "ddim")
    outs = []
    for model in models:
        got = serving.run_exported(blob, model.state_dict(), None, LABELS,
                                   init_noise=x_T, device="cpu")
        with torch.no_grad():
            live = ddim.sample_with_cfg(model, x_T.shape,
                                        torch.from_numpy(LABELS),
                                        cfg_scale=2.0, init_noise=x_T)
        torch.testing.assert_close(got, torch.clamp((live + 1) * 0.5, 0, 1),
                                   rtol=0, atol=0)
        outs.append(got)
    assert (outs[0] - outs[1]).abs().max() > 1e-3


def test_the_generator_draws_what_the_caller_does_not_pass():
    _, jparams, config = traced_unet(False, seed=4)
    config = dict(config, num_timesteps=6)
    model = torch_unet(jparams, config)
    params = dict(model.named_parameters())
    blob = serving.export_sampler(model, params, config, batch_size=BATCH,
                                  sampling_method="ddpm", device="cpu")
    drawn = serving.run_exported(blob, params,
                                 torch.Generator().manual_seed(9), LABELS,
                                 device="cpu")
    gen = torch.Generator().manual_seed(9)
    x_T = torch.randn((BATCH, 16, 16, 3), generator=gen)
    noises = torch.randn((6, BATCH, 16, 16, 3), generator=gen)
    given = serving.run_exported(blob, params, None, LABELS, init_noise=x_T,
                                 noises=noises, device="cpu")
    torch.testing.assert_close(drawn, given, rtol=0, atol=0)
    with pytest.raises(ValueError, match="pass a torch.Generator"):
        serving.run_exported(blob, params, None, LABELS, init_noise=x_T,
                             device="cpu")


def test_refusals():
    _, jparams, config = traced_unet(True, seed=5)
    model = torch_unet(jparams, config)
    params = dict(model.named_parameters())
    sr = dict(config, super_resolution={"factor": 2})
    with pytest.raises(ValueError, match="super-resolution checkpoints are "
                                         "not exportable"):
        serving.export_sampler(model, params, sr, batch_size=BATCH,
                               device="cpu")
    with pytest.raises(KeyError, match="lacks"):
        serving.export_sampler(model, {}, config, batch_size=BATCH,
                               device="cpu")
    blob = serving.export_sampler(model, params, dict(config,
                                                      num_inference_steps=2),
                                  batch_size=BATCH, device="cpu")
    with pytest.raises(ValueError, match="exported for cpu"):
        serving.run_exported(blob, params, None, LABELS, device="cuda")


def test_export_runs_on_the_card_unless_told_otherwise():
    """No silent CPU path: the default device is the card, which this
    machine does not have."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, jparams, config = traced_unet(True, seed=6)
    model = torch_unet(jparams, config)
    with pytest.raises((RuntimeError, AssertionError)):
        serving.export_sampler(model, dict(model.named_parameters()), config,
                               batch_size=BATCH)


def test_64x64_dit_forward_matches_jax():
    """The DiT at img_size (64, 64), tiny width: L 1024 tokens, the length
    the 64x64 DiT's attention runs at."""
    config = small_dit_config(True, size=64)
    jmodel = JaxDiT(img_size=(64, 64), **DIT_PARAMS, num_classes=10)
    jparams = traced_params(
        jmodel, (jnp.zeros((1, 64, 64, 3)), jnp.zeros((1,), jnp.int32),
                 jnp.zeros((1,), jnp.int32)), seed=11)
    model = DiT(img_size=(64, 64), **DIT_PARAMS, num_classes=10)
    model.load_state_dict(state_dict_from_jax(jparams, config), strict=True)
    model.eval()
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    t = np.array([3, 700])
    y = np.array([0, 4])
    ref = jmodel.apply({"params": jparams}, jnp.asarray(x),
                       jnp.asarray(t, jnp.int32), jnp.asarray(y, jnp.int32),
                       train=False)
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(y))
    assert ours.shape == (2, 64, 64, 3)
    assert max_rel(ours.numpy(), np.asarray(ref)) <= 2e-4
