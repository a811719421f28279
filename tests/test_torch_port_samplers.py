"""The PyTorch port's fast VP samplers against the JAX package, on the CPU:
the Karras grid, DPM-Solver++ (2M and SDE), UniPC, DDIM on a Karras grid,
the single-step APIs, the eps views of `base`, and the factory's choice of
process. Noise is made with numpy or drawn by jax.random and handed to both
sides: jax.random and torch.Generator never agree by seed.

Bars, max|port - jax| / max|jax|:
  * Karras grids: equal;
  * single formulas and steps on one shared schedule (the port's
    NoiseSchedule holding the JAX arrays, so only the step arithmetic is
    compared): 1e-6;
  * whole trajectories through the small UNet, each side on its own
    schedule, 10 steps or fewer: 5e-4, the sampling bar of
    tests/test_torch_port_sampling.py. The port's float32 arrays built on
    1 - acp drift by up to ~1.5e-4 relative from JAX's near t = 0 (another
    cumprod association), which lambda = log(alpha / sigma) carries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu import factory as jax_factory
from diffusion_models_collection_tpu.diffusion import DDIM as JaxDDIM
from diffusion_models_collection_tpu.diffusion import DDPM as JaxDDPM
from diffusion_models_collection_tpu.diffusion import (
    DPMSolverPP as JaxDPMSolverPP,
)
from diffusion_models_collection_tpu.diffusion import UniPC as JaxUniPC
from diffusion_models_collection_tpu.diffusion import base as jax_base
from diffusion_models_collection_tpu.diffusion import dpm_solver as jax_dpm
from diffusion_models_collection_tpu.diffusion import schedule as jax_schedule
from diffusion_models_collection_tpu_torch import factory
from diffusion_models_collection_tpu_torch.diffusion import (
    DDIM,
    DDPM,
    DPMSolverPP,
    UniPC,
    base,
    dpm_solver,
    schedule,
)
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    affine_xty,
    jax_dim,
    jax_dit,
    jax_unet,
    max_rel,
    normal_arrays,
    one_torch_thread,
    shared_schedule,
    small_config,
    torch_dim,
    torch_dit,
    torch_unet,
)


# ------------------------------------------------------------- Karras grid
@pytest.mark.parametrize("kind", ["linear", "cosine", "quadratic"])
@pytest.mark.parametrize("num_timesteps", [1000, 100, 37])
def test_karras_grids_equal_jax(kind, num_timesteps):
    ours_sched = schedule.NoiseSchedule.create(num_timesteps, 1e-4, 0.02, kind)
    ref_sched = jax_schedule.NoiseSchedule.create(num_timesteps, 1e-4, 0.02,
                                                  kind)
    for steps in (1, 2, 3, 5, 10, 18, 20, 33, 50, 59):
        for rho in (7.0, 3.0):
            ours = schedule.karras_timesteps(ours_sched, steps, rho)
            ref = np.asarray(jax_schedule.karras_timesteps(ref_sched, steps,
                                                           rho))
            assert ours.dtype == torch.int64
            np.testing.assert_array_equal(ours.numpy(), ref,
                                          err_msg=f"S={steps} rho={rho}")


@pytest.mark.filterwarnings("ignore:divide by zero")
@pytest.mark.filterwarnings("ignore:invalid value")
def test_karras_grid_under_zero_terminal_snr_equals_jax():
    """sigma is inf at the last step: both sides give what the NaN grid
    maps to."""
    ours_sched = schedule.NoiseSchedule.create(1000, zero_terminal_snr=True)
    ref_sched = jax_schedule.NoiseSchedule.create(1000,
                                                  zero_terminal_snr=True)
    for steps in (2, 10, 50):
        np.testing.assert_array_equal(
            schedule.karras_timesteps(ours_sched, steps).numpy(),
            np.asarray(jax_schedule.karras_timesteps(ref_sched, steps)))


def test_karras_grid_may_be_shorter_than_asked():
    sched = schedule.NoiseSchedule.create(37)
    grid = schedule.karras_timesteps(sched, 59)
    assert len(grid) < 59
    assert torch.all(grid[1:] < grid[:-1])
    process = DPMSolverPP(num_timesteps=37, num_inference_steps=59,
                          timestep_spacing="karras")
    assert torch.equal(process.inference_timesteps, grid)


# -------------------------------------------------------- single formulas
@pytest.mark.parametrize("h,h_prev,have_prev,final", [
    (0.4, 0.3, True, False), (0.05, 0.7, True, False),
    (0.4, 0.3, False, False), (0.4, 0.3, True, True),
    (0.0, 0.3, True, False)])
def test_multistep_D_matches_jax(h, h_prev, have_prev, final):
    x0, x0_prev = normal_arrays(0, 2)
    ref = jax_dpm.multistep_D(jnp.asarray(x0), jnp.asarray(x0_prev),
                              jnp.float32(h), jnp.float32(h_prev),
                              jnp.bool_(have_prev), jnp.bool_(final))
    ours = dpm_solver.multistep_D(torch.from_numpy(x0),
                                  torch.from_numpy(x0_prev), h, h_prev,
                                  have_prev, final)
    assert max_rel(ours.numpy(), ref) <= 1e-6


@pytest.mark.parametrize("prediction_type", ["eps", "v", "x0"])
def test_eps_from_prediction_and_wrap_model_as_eps_match_jax(
        prediction_type):
    jsched, sched = shared_schedule()
    x, out = normal_arrays(1, 2)
    t = np.array([999, 400, 3])
    y = np.array([1, 4, 10])
    ref = jax_base.eps_from_prediction(jsched, jnp.asarray(x), jnp.asarray(t),
                                       jnp.asarray(out), prediction_type)
    ours = base.eps_from_prediction(sched, torch.from_numpy(x),
                                    torch.from_numpy(t), torch.from_numpy(out),
                                    prediction_type)
    assert max_rel(ours.numpy(), ref) <= 1e-6
    jfn = jax_base.wrap_model_as_eps(
        jsched, lambda a, b, c: affine_xty(a, b, c, jnp), prediction_type)
    fn = base.wrap_model_as_eps(
        sched, lambda a, b, c: affine_xty(a, b, c, torch), prediction_type)
    ref = jfn(jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    ours = fn(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y))
    assert max_rel(ours.numpy(), ref) <= 1e-6


@pytest.mark.parametrize("p_threshold", [None, 0.995, 0.9])
def test_apply_x0_constraint_matches_jax(p_threshold):
    (x0,) = normal_arrays(2, 1)
    x0 = 1.7 * x0
    ref = jax_base.apply_x0_constraint(jnp.asarray(x0), p_threshold)
    ours = base.apply_x0_constraint(torch.from_numpy(x0), p_threshold)
    assert max_rel(ours.numpy(), ref) <= 1e-6


def test_cfg_eps_matches_jax():
    (x,) = normal_arrays(3, 1)
    t = np.array([999, 500, 20])
    y = np.array([1, 2, 10])
    ref = jax_base.cfg_eps(lambda a, b, c: affine_xty(a, b, c, jnp),
                           jnp.asarray(x), jnp.asarray(t), jnp.asarray(y), 2.5)
    ours = base.cfg_eps(lambda a, b, c: affine_xty(a, b, c, torch),
                        torch.from_numpy(x), torch.from_numpy(t),
                        torch.from_numpy(y), 2.5)
    assert max_rel(ours.numpy(), ref) <= 1e-6


def sde_noises(rng, grid, shape):
    """The draws JAX's SDE-DPM-Solver++ makes: the key after `_run`'s split,
    folded with each step's timestep."""
    key, _ = jax.random.split(rng)
    return [np.asarray(jax.random.normal(jax.random.fold_in(key, int(t)),
                                         shape, jnp.float32))
            for t in np.asarray(grid)]


@pytest.mark.parametrize("cls,jcls,kwargs", [
    (DPMSolverPP, JaxDPMSolverPP, {}),
    (DPMSolverPP, JaxDPMSolverPP, {"sde": True}),
    (UniPC, JaxUniPC, {}),
], ids=["dpm++", "dpm++sde", "unipc"])
def test_solver_steps_match_jax_on_a_shared_schedule(cls, jcls, kwargs):
    """Every step's state of a 4-step run with the affine model: the first
    (first order), two multistep (and, for UniPC, corrected) steps and the
    final one that returns D. The model predicts x0: under eps-prediction
    x0 = c1 x - c2 eps cancels to ~1/200 of its terms at t = 999, where
    XLA's fused multiply-add alone moves it by ~2e-6 relative, and the
    step arithmetic is what is compared here (the trajectories below run
    eps-prediction)."""
    jsched, sched = shared_schedule()
    (noise,) = normal_arrays(4, 1)
    y = np.array([1, 5, 9])
    ours_p = cls(num_inference_steps=4, prediction_type="x0", **kwargs)
    ours_p.schedule = sched
    ref_p = jcls(num_inference_steps=4, prediction_type="x0", **kwargs)
    rng = jax.random.PRNGKey(3)
    ref = ref_p.sample(jax.tree_util.Partial(
        lambda a, b, c: affine_xty(a, b, c, jnp)), noise.shape, rng,
        y=jnp.asarray(y), init_noise=jnp.asarray(noise),
        return_all_timesteps=True)
    noises = [torch.from_numpy(z) for z in
              sde_noises(rng, ref_p.inference_timesteps, noise.shape)]
    ours = ours_p.sample(lambda a, b, c: affine_xty(a, b, c, torch), noise.shape,
                         y=torch.from_numpy(y),
                         init_noise=torch.from_numpy(noise),
                         noises=noises if kwargs.get("sde") else None,
                         return_all_timesteps=True)
    assert ours.shape == (4, *noise.shape)
    for step in range(4):
        assert max_rel(ours[step].numpy(), ref[step]) <= 1e-6, step


def test_ddpm_and_ddim_p_sample_match_jax():
    jsched, sched = shared_schedule()
    x, noise = normal_arrays(5, 2)
    t = np.array([999, 500, 0])
    t_next = np.array([979, 480, -1])
    y = np.array([1, 5, 9])
    jfn = jax.tree_util.Partial(lambda a, b, c: affine_xty(a, b, c, jnp))

    def fn(a, b, c):
        return affine_xty(a, b, c, torch)

    jddpm, ddpm = JaxDDPM(num_timesteps=1000), DDPM(num_timesteps=1000)
    ddpm.schedule = sched
    key = jax.random.PRNGKey(0)
    ref = jddpm.p_sample(jfn, jnp.asarray(x), jnp.asarray(t), key,
                         y=jnp.asarray(y))
    draw = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    ours = ddpm.p_sample(fn, torch.from_numpy(x), torch.from_numpy(t),
                         torch.from_numpy(draw), y=torch.from_numpy(y))
    assert max_rel(ours.numpy(), ref) <= 1e-6
    for eta in (0.0, 0.5):
        jddim = JaxDDIM(num_timesteps=1000, eta=eta)
        ddim = DDIM(num_timesteps=1000, eta=eta)
        ddim.schedule = sched
        ref = jddim.p_sample(jfn, jnp.asarray(x), jnp.asarray(t),
                             jnp.asarray(t_next), rng=key, y=jnp.asarray(y))
        ours = ddim.p_sample(fn, torch.from_numpy(x), torch.from_numpy(t),
                             torch.from_numpy(t_next),
                             noise=torch.from_numpy(draw),
                             y=torch.from_numpy(y))
        assert max_rel(ours.numpy(), ref) <= 1e-6, eta


@pytest.mark.parametrize("weighting", ["uniform", "min_snr"])
def test_ddim_training_api_matches_jax(weighting):
    jsched, sched = shared_schedule()
    x0, noise = normal_arrays(6, 2)
    t = np.array([999, 500, 3])
    y = np.array([1, 5, 9])
    jddim = JaxDDIM(prediction_type="v", loss_weighting=weighting)
    ddim = DDIM(prediction_type="v", loss_weighting=weighting)
    ddim.schedule = sched
    ref = jddim.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    ours = ddim.q_sample(torch.from_numpy(x0), torch.from_numpy(t),
                         torch.from_numpy(noise))
    assert max_rel(ours.numpy(), ref) <= 1e-6
    ref = jddim.p_losses(lambda a, b, c: affine_xty(a, b, c, jnp),
                         jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise),
                         y=jnp.asarray(y))
    ours = ddim.p_losses(lambda a, b, c: affine_xty(a, b, c, torch),
                         torch.from_numpy(x0), torch.from_numpy(t),
                         torch.from_numpy(noise), y=torch.from_numpy(y))
    assert max_rel(ours.numpy(), ref) <= 1e-6


# ---------------------------------------------------- whole trajectories
@pytest.fixture(scope="module")
def small_models():
    model, params, config = jax_unet(conditional=True, seed=4)
    return model, params, torch_unet(params, config)


SAMPLERS = {
    "dpm++": (DPMSolverPP, JaxDPMSolverPP, dict(num_inference_steps=8)),
    "dpm++sde": (DPMSolverPP, JaxDPMSolverPP,
                 dict(num_inference_steps=8, sde=True)),
    "unipc": (UniPC, JaxUniPC, dict(num_inference_steps=6)),
    "ddim_karras": (DDIM, JaxDDIM, dict(num_inference_steps=10,
                                         timestep_spacing="karras")),
}
# (sampler, cfg_scale or None, guidance_rescale): each sampler unguided and
# with CFG and the rescale; CFG without the rescale (the DDIM trajectory of
# tests/test_torch_port_sampling.py takes it too) once
CASES = [(name, None, 0.0) for name in SAMPLERS]
CASES += [(name, 3.0, 0.7) for name in SAMPLERS] + [("dpm++", 3.0, 0.0)]


@pytest.mark.parametrize("name,cfg_scale,rescale", CASES)
def test_trajectory_matches_jax(small_models, name, cfg_scale, rescale):
    model, params, tmodel = small_models
    cls, jcls, kwargs = SAMPLERS[name]
    noise = np.random.default_rng(5).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    y = np.array([3, 8], np.int64)
    jfn = jax.tree_util.Partial(
        lambda x, t, yy: model.apply({"params": params}, x, t, yy))
    ref_p = jcls(num_timesteps=1000, guidance_rescale=rescale, **kwargs)
    ours_p = cls(num_timesteps=1000, guidance_rescale=rescale, **kwargs)
    rng = jax.random.PRNGKey(7)
    noises = [torch.from_numpy(z) for z in
              sde_noises(rng, ref_p.inference_timesteps, noise.shape)]
    if cfg_scale is None:
        ref = ref_p.sample(jfn, noise.shape, rng, y=jnp.asarray(y, jnp.int32),
                           init_noise=jnp.asarray(noise))
        ours = ours_p.sample(tmodel, noise.shape, y=torch.from_numpy(y),
                             init_noise=torch.from_numpy(noise),
                             noises=noises if name == "dpm++sde" else None)
    else:
        ref = ref_p.sample_with_cfg(jfn, noise.shape,
                                    jnp.asarray(y, jnp.int32), rng,
                                    cfg_scale=cfg_scale,
                                    init_noise=jnp.asarray(noise))
        ours = ours_p.sample_with_cfg(
            tmodel, noise.shape, torch.from_numpy(y), cfg_scale=cfg_scale,
            init_noise=torch.from_numpy(noise),
            noises=noises if name == "dpm++sde" else None)
    assert np.isfinite(ours.numpy()).all()
    assert max_rel(ours.numpy(), ref) <= 5e-4


@pytest.mark.parametrize("family", ["dim", "dit"])
def test_fast_sampler_through_the_dim_and_the_dit_matches_jax(family):
    """The DiM (its scans) and the DiT under DPM-Solver++ with CFG."""
    if family == "dim":
        model, params, config = jax_dim(conditional=True, seed=9)
        tmodel = torch_dim(params, config)
    else:
        model, params, config = jax_dit(conditional=True, seed=9)
        tmodel = torch_dit(params, config)
    noise = np.random.default_rng(10).standard_normal(
        (2, 16, 16, 3)).astype(np.float32)
    y = np.array([2, 9], np.int64)
    jfn = jax.tree_util.Partial(
        lambda x, t, yy: model.apply({"params": params}, x, t, yy))
    ref = JaxDPMSolverPP(num_inference_steps=4).sample_with_cfg(
        jfn, noise.shape, jnp.asarray(y, jnp.int32), jax.random.PRNGKey(0),
        cfg_scale=3.0, init_noise=jnp.asarray(noise))
    ours = DPMSolverPP(num_inference_steps=4).sample_with_cfg(
        tmodel, noise.shape, torch.from_numpy(y), cfg_scale=3.0,
        init_noise=torch.from_numpy(noise))
    assert np.isfinite(ours.numpy()).all()
    assert max_rel(ours.numpy(), ref) <= 5e-4


def test_sde_noise_comes_from_the_callers_generator(small_models):
    _, _, tmodel = small_models
    sde = DPMSolverPP(num_timesteps=1000, num_inference_steps=3, sde=True)
    y = torch.tensor([1, 2])

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return sde.sample_with_cfg(tmodel, (2, 16, 16, 3), y, gen)

    first = run(0)
    torch.testing.assert_close(run(0), first, rtol=0, atol=0)
    assert not torch.equal(run(1), first)


@pytest.mark.parametrize("name", ["ddpm", "ddim", "dpm++", "unipc"])
def test_return_all_timesteps_stacks_every_step(small_models, name):
    _, _, tmodel = small_models
    process = factory.get_diffusion(
        dict(small_config(), num_timesteps=6, num_inference_steps=3), name)
    noise = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    frames = process.sample_with_cfg(tmodel, noise.shape, torch.tensor([1, 2]),
                                     gen, init_noise=noise,
                                     return_all_timesteps=True)
    steps = 6 if name == "ddpm" else 3
    assert frames.shape == (steps, *noise.shape)
    last = process.sample_with_cfg(tmodel, noise.shape, torch.tensor([1, 2]),
                                   torch.Generator().manual_seed(1),
                                   init_noise=noise)
    torch.testing.assert_close(frames[-1], last, rtol=0, atol=0)


# ------------------------------------------------------------- factory
ALIASES = {
    "ddim": ("DDIM", None, 50), "dpm++": ("DPMSolverPP", False, 20),
    "dpmpp": ("DPMSolverPP", False, 20),
    "dpm_solver++": ("DPMSolverPP", False, 20),
    "dpm-solver++": ("DPMSolverPP", False, 20),
    "unipc": ("UniPC", None, 10), "uni-pc": ("UniPC", None, 10),
    "uni_pc": ("UniPC", None, 10), "dpm++sde": ("DPMSolverPP", True, 20),
    "dpmpp_sde": ("DPMSolverPP", True, 20),
    "sde-dpm++": ("DPMSolverPP", True, 20),
    "dpm++_sde": ("DPMSolverPP", True, 20), "DPM++": ("DPMSolverPP", False, 20),
    "ddpm": ("DDPM", None, None), "euler_a": ("DDPM", None, None),
}


@pytest.mark.parametrize("method", list(ALIASES))
def test_factory_method_aliases_match_jax(method):
    """Each alias builds the JAX factory's class with its default step
    count, the SDE flag where it has one and the config's grid; an unknown
    name falls back to DDPM on both sides."""
    config = dict(small_config(), timestep_spacing="karras", karras_rho=5.0)
    del config["num_inference_steps"]
    ours = factory.get_diffusion(config, method)
    ref = jax_factory.get_diffusion(config, method)
    name, sde, steps = ALIASES[method]
    assert type(ours).__name__ == type(ref).__name__ == name
    if sde is not None:
        assert ours.sde is ref.sde is sde
    if steps is not None:
        assert ours.num_inference_steps == ref.num_inference_steps == steps
        assert ours.timestep_spacing == "karras" and ours.karras_rho == 5.0
        np.testing.assert_array_equal(ours.inference_timesteps.numpy(),
                                      np.asarray(ref.inference_timesteps))


@pytest.mark.parametrize("change", [
    {"diffusion_type": "flow_matching", "loss_weighting": "snr"},
    {"diffusion_type": "flow", "guidance_rescale": 0.5},
    {"diffusion_type": "rectified_flow", "cfg_interval": (1, 5)},
    {"diffusion_type": "edm", "loss_weighting": "min_snr"},
    {"diffusion_type": "edm", "prediction_type": "v"},
    {"diffusion_type": "edm", "cfg_interval": (1, 5)},
    {"diffusion_type": "score_sde"},
])
def test_factory_value_errors_match_jax(change):
    config = dict(small_config(), **change)
    with pytest.raises(ValueError) as ref:
        jax_factory.get_diffusion(config, "ddim")
    with pytest.raises(ValueError) as ours:
        factory.get_diffusion(config, "ddim")
    assert str(ours.value).split(" ")[:3] == str(ref.value).split(" ")[:3]


@pytest.mark.parametrize("change,name,steps", [
    ({"diffusion_type": "flow_matching"}, "FlowMatching", 50),
    ({"diffusion_type": "edm"}, "EDM", 18),
])
def test_factory_flow_and_edm_own_the_stack(change, name, steps):
    config = dict(small_config(), **change)
    del config["num_inference_steps"]
    for method in ("ddpm", "ddim", "dpm++"):
        ours = factory.get_diffusion(config, method)
        ref = jax_factory.get_diffusion(config, method)
        assert type(ours).__name__ == type(ref).__name__ == name
        assert ours.num_inference_steps == ref.num_inference_steps == steps
