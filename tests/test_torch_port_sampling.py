"""The PyTorch port's schedule, guidance and DDIM sampler against the JAX
package, on the CPU. Noise is made with numpy and handed to both sides:
jax.random and torch.Generator never agree by seed.

Tolerances, max|port - jax| / max|jax| unless stated:
  * schedule arrays, over the finite entries (zero-terminal-SNR puts inf at
    the last step on both sides): betas and alphas_cumprod 1e-5, since a
    float32 cumprod over 1000 steps in another association order drifts by
    a few ulp; the arrays built on 1 - acp 5e-4, since near t = 0 that
    difference cancels to ~1e-4 of its operands and turns an ulp of acp
    into ~1e-4 relative;
  * single formulas (ddim_step, thresholding, guidance) 1e-6;
  * a 10-step DDIM trajectory with CFG through the small UNet 5e-4, the
    trajectory bar of tests/test_torch_import.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.diffusion import DDIM as JaxDDIM
from diffusion_models_collection_tpu.diffusion import base as jax_base
from diffusion_models_collection_tpu.diffusion import ddim as jax_ddim
from diffusion_models_collection_tpu.diffusion import schedule as jax_schedule
from diffusion_models_collection_tpu_torch.diffusion import DDIM, base, schedule
from diffusion_models_collection_tpu_torch.diffusion.ddim import ddim_step
from torch_port_helpers import jax_unet, max_rel, torch_unet

SCHEDULES = [("linear", False), ("cosine", False), ("quadratic", False),
             ("linear", True)]


@pytest.mark.parametrize("kind,zero_snr", SCHEDULES)
def test_schedule_arrays_match_jax(kind, zero_snr):
    ref = jax_schedule.NoiseSchedule.create(1000, 1e-4, 0.02, kind,
                                            zero_terminal_snr=zero_snr)
    ours = schedule.NoiseSchedule.create(1000, 1e-4, 0.02, kind,
                                         zero_terminal_snr=zero_snr)
    for field in ("betas", "alphas", "alphas_cumprod", "alphas_cumprod_prev",
                  "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                  "sqrt_recip_alphas", "sqrt_recip_alphas_cumprod",
                  "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                  "posterior_log_variance_clipped", "posterior_mean_coef1",
                  "posterior_mean_coef2"):
        a = getattr(ours, field)
        assert a.dtype == torch.float32
        a, r = a.numpy(), np.asarray(getattr(ref, field))
        finite = np.isfinite(r)
        np.testing.assert_array_equal(a[~finite], r[~finite], err_msg=field)
        tol = 1e-5 if field in ("betas", "alphas", "alphas_cumprod") else 5e-4
        assert max_rel(a[finite], r[finite]) <= tol, field


@pytest.mark.parametrize("steps", [(1000, 50), (1000, 10), (1000, 1000),
                                   (1000, 3), (1000, 7), (1000, 25), (100, 8),
                                   (37, 13), (10, 1)])
def test_ddim_timesteps_equal_jax(steps):
    ref = np.asarray(jax_schedule.ddim_timesteps(*steps))
    ours = schedule.ddim_timesteps(*steps).numpy()
    np.testing.assert_array_equal(ours, ref)


def test_ddim_step_with_eta_and_explicit_noise_matches_jax():
    rng = np.random.default_rng(0)
    x, eps, x0, noise = (rng.standard_normal((3, 8, 8, 3)).astype(np.float32)
                         for _ in range(4))
    t = np.array([999, 500, 20])
    t_next = np.array([979, 480, -1])
    jsched = jax_schedule.NoiseSchedule.create(1000)
    ref = jax_ddim.ddim_step(jsched, jnp.asarray(x), jnp.asarray(t),
                             jnp.asarray(t_next), jnp.asarray(eps),
                             jnp.asarray(x0), 0.7, jnp.asarray(noise))
    ours = ddim_step(schedule.NoiseSchedule.create(1000), torch.from_numpy(x),
                     torch.from_numpy(t), torch.from_numpy(t_next),
                     torch.from_numpy(eps), torch.from_numpy(x0), 0.7,
                     torch.from_numpy(noise))
    assert max_rel(ours.numpy(), ref) <= 1e-6


def test_dynamic_threshold_matches_jax():
    x0 = (np.random.default_rng(1).standard_normal((4, 8, 8, 3)) * 1.5).astype(
        np.float32)
    ref = jax_base.dynamic_threshold(jnp.asarray(x0), 0.995)
    ours = base.dynamic_threshold(torch.from_numpy(x0), 0.995)
    assert max_rel(ours.numpy(), ref) <= 1e-6


def _affine_model(x, t, y, lib):
    """A stand-in model both frameworks can run: affine in x, t and y."""
    tt = t.astype(lib.float32) if lib is jnp else t.to(torch.float32)
    yy = y.astype(lib.float32) if lib is jnp else y.to(torch.float32)
    return 0.6 * x + 1e-3 * tt[:, None, None, None] - 0.05 * yy[:, None, None,
                                                                 None]


@pytest.mark.parametrize("prediction_type", ["eps", "v", "x0"])
@pytest.mark.parametrize("rescale,interval", [(0.0, None), (0.7, (100, 600))])
def test_cfg_eps_x0_matches_jax(prediction_type, rescale, interval):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    t = np.array([999, 500, 300, 20])
    y = np.array([1, 2, 3, 10])
    jsched = jax_schedule.NoiseSchedule.create(1000)
    sched = schedule.NoiseSchedule.create(1000)
    jpair = jax_base.wrap_model_as_eps_x0(
        jsched, lambda a, b, c: _affine_model(a, b, c, jnp), prediction_type)
    pair = base.wrap_model_as_eps_x0(
        sched, lambda a, b, c: _affine_model(a, b, c, torch), prediction_type)
    ref = jax_base.cfg_eps_x0(jpair, jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(y), 2.5, guidance_rescale=rescale,
                              schedule=jsched, cfg_interval=interval)
    ours = base.cfg_eps_x0(pair, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(y), 2.5, guidance_rescale=rescale,
                           schedule=sched, cfg_interval=interval)
    for o, r in zip(ours, ref):
        assert max_rel(o.numpy(), r) <= 1e-5


@pytest.fixture(scope="module")
def small_models():
    model, params, config = jax_unet(conditional=True, seed=4)
    return model, params, torch_unet(params, config)


@pytest.mark.parametrize("cfg", [True, False])
def test_ddim_10_step_trajectory_matches_jax(small_models, cfg):
    model, params, tmodel = small_models
    noise = np.random.default_rng(5).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    y = np.array([3, 8], np.int64)

    def jax_fn(x, t, yy):
        return model.apply({"params": params}, x, t, yy)

    jddim = JaxDDIM(num_timesteps=1000, num_inference_steps=10)
    ddim = DDIM(num_timesteps=1000, num_inference_steps=10)
    if cfg:
        ref = jddim.sample_with_cfg(
            jax.tree_util.Partial(jax_fn), noise.shape,
            jnp.asarray(y, jnp.int32), jax.random.PRNGKey(0), cfg_scale=3.0,
            init_noise=jnp.asarray(noise))
        ours = ddim.sample_with_cfg(tmodel, noise.shape, torch.from_numpy(y),
                                    cfg_scale=3.0,
                                    init_noise=torch.from_numpy(noise))
    else:
        ref = jddim.sample(
            jax.tree_util.Partial(jax_fn), noise.shape, jax.random.PRNGKey(0),
            y=jnp.asarray(y, jnp.int32), init_noise=jnp.asarray(noise))
        ours = ddim.sample(tmodel, noise.shape, y=torch.from_numpy(y),
                           init_noise=torch.from_numpy(noise))
    assert np.isfinite(ours.numpy()).all()
    assert max_rel(ours.numpy(), ref) <= 5e-4


def test_ddim_eta_draws_noise_from_the_callers_generator(small_models):
    _, _, tmodel = small_models
    ddim = DDIM(num_timesteps=1000, num_inference_steps=3, eta=1.0)
    y = torch.tensor([1, 2])

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return ddim.sample_with_cfg(tmodel, (2, 16, 16, 3), y, gen)

    torch.testing.assert_close(run(0), run(0), rtol=0, atol=0)
    assert not torch.equal(run(0), run(1))
