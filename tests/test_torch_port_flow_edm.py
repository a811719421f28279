"""The PyTorch port's flow-matching and EDM processes against the JAX
package, on the CPU: their formulas, losses and samplers, the fractional
timestep EDM gives the network, and the train CLI on a flow and an EDM
config. Noise is made with numpy or drawn by jax.random and handed to both
sides: jax.random and torch.Generator never agree by seed.

Bars, max|port - jax| / max|jax|:
  * single formulas (interpolate, the velocity constraint, sigma_of_t,
    EDM's preconditioning, its grid): 1e-6;
  * one p_losses through the small UNet: 2e-4, the forward bar of
    tests/test_torch_port_unet.py;
  * forwards of the small UNet and DiT at fractional and out-of-range t:
    2e-4;
  * whole trajectories through the small UNet, 10 steps or fewer: 5e-4.

EDM without churn is held against the JAX package's Heun step run eagerly
(`jax_heun_without_churn`), not against its compiled sampler: on the CPU,
XLA contracts `sigma_hat**2 - sigma**2` in `edm._scan_segment` into a fused
multiply-add, so where sigma_hat == sigma the difference is the rounding
residual of sigma^2, not 0, and the compiled sampler adds noise of std
sqrt(residual), about 5e-3 at sigma 24.4, with s_churn = 0
(`test_jax_edm_sampler_adds_noise_without_churn` pins it). The port keeps
churn_std exactly 0 there.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.diffusion import EDM as JaxEDM
from diffusion_models_collection_tpu.diffusion import base as jax_base
from diffusion_models_collection_tpu.diffusion import (
    FlowMatching as JaxFlowMatching,
)
from diffusion_models_collection_tpu.diffusion import edm as jax_edm
from diffusion_models_collection_tpu.diffusion import (
    flow_matching as jax_flow,
)
from diffusion_models_collection_tpu_torch import sample, train
from diffusion_models_collection_tpu_torch.diffusion import (
    EDM,
    FlowMatching,
    edm,
    flow_matching,
)
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    affine_xty,
    jax_dit,
    jax_unet,
    max_rel,
    normal_arrays,
    one_torch_thread,
    torch_dit,
    torch_unet,
)


# ---------------------------------------------------------- formulas
def test_interpolate_and_q_sample_match_jax():
    x0, noise = normal_arrays(0, 2)
    t = np.array([0, 500, 999])
    ref = jax_flow.interpolate(jnp.asarray(x0), jnp.asarray([0.0, 0.3, 1.0]),
                               jnp.asarray(noise))
    ours = flow_matching.interpolate(torch.from_numpy(x0),
                                     torch.tensor([0.0, 0.3, 1.0]),
                                     torch.from_numpy(noise))
    assert max_rel(ours.numpy(), ref) <= 1e-6
    ref = JaxFlowMatching().q_sample(jnp.asarray(x0), jnp.asarray(t),
                                     jnp.asarray(noise))
    ours = FlowMatching().q_sample(torch.from_numpy(x0), torch.from_numpy(t),
                                   torch.from_numpy(noise))
    assert max_rel(ours.numpy(), ref) <= 1e-6


@pytest.mark.parametrize("tau", [0.7, 0.05, 1e-5])
@pytest.mark.parametrize("p_threshold,clip", [(None, True), (0.995, True),
                                              (None, False)])
def test_constrained_velocity_matches_jax(tau, p_threshold, clip):
    x, v = normal_arrays(1, 2)
    x = 2.0 * x
    ref = jax_flow._constrained_velocity(
        jnp.asarray(x), jnp.full((3,), tau, jnp.float32), jnp.asarray(v),
        p_threshold, clip)
    ours = flow_matching._constrained_velocity(
        torch.from_numpy(x), float(np.float32(tau)), torch.from_numpy(v),
        p_threshold, clip)
    assert max_rel(ours.numpy(), ref) <= 1e-6


def test_sigma_of_t_matches_jax():
    t = np.arange(0, 1000, 7)
    ref = JaxEDM().sigma_of_t(jnp.asarray(t))
    ours = EDM().sigma_of_t(torch.from_numpy(t))
    assert max_rel(ours.numpy(), ref) <= 1e-6
    ref = JaxEDM(num_timesteps=5, p_mean=0.3).sigma_of_t(jnp.arange(5))
    ours = EDM(num_timesteps=5, p_mean=0.3).sigma_of_t(torch.arange(5))
    assert max_rel(ours.numpy(), ref) <= 1e-6


@pytest.mark.parametrize("kwargs", [
    {}, {"num_inference_steps": 1}, {"num_inference_steps": 7, "rho": 3.0},
    {"s_churn": 10.0, "s_min": 0.05, "s_max": 20.0},
    {"s_churn": 80.0, "num_inference_steps": 5}])
def test_edm_grid_equals_jax(kwargs):
    ref, ours = JaxEDM(**kwargs), EDM(**kwargs)
    np.testing.assert_array_equal(ours.sigmas.numpy(), np.asarray(ref.sigmas))
    _, sig, sig_hat, sig_next = ref._scan_rows
    np.testing.assert_array_equal(
        ours.rows, np.stack([np.asarray(sig), np.asarray(sig_hat),
                             np.asarray(sig_next)], axis=1))


def test_edm_preconditioning_matches_jax():
    x, _ = normal_arrays(2, 2)
    sigma = np.array([80.0, 0.5, 0.002], np.float32)
    y = np.array([1, 0, 7])
    kwargs = dict(sigma_data=0.6, sigma_min=0.01, sigma_max=50.0,
                  num_timesteps=200)
    seen = {}

    def jfn(a, b, c):
        seen["jax"] = b
        return affine_xty(a, b, c, jnp)

    def fn(a, b, c):
        seen["ours"] = b
        return affine_xty(a, b, c, torch)

    ref = JaxEDM(**kwargs).denoiser_fn(jfn)(jnp.asarray(x),
                                            jnp.asarray(sigma),
                                            jnp.asarray(y))
    ours = EDM(**kwargs).denoiser_fn(fn)(torch.from_numpy(x),
                                         torch.from_numpy(sigma),
                                         torch.from_numpy(y))
    assert max_rel(ours.numpy(), ref) <= 1e-6
    assert seen["ours"].dtype == torch.float32  # a continuous t
    assert max_rel(seen["ours"].numpy(), seen["jax"]) <= 1e-6
    t_ref = jax_edm._t_of_sigma(jnp.asarray(sigma), 0.01, 50.0, 200)
    t_ours = edm._t_of_sigma(torch.from_numpy(sigma), 0.01, 50.0, 200)
    assert max_rel(t_ours.numpy(), t_ref) <= 1e-6


def test_img2img_waits_for_its_roadmap_item():
    """img2img is ported (its trajectories are held against JAX in
    tests/test_torch_port_editing.py): a strength outside [0, 1] raises the
    JAX process's ValueError, and strength 0 returns the input."""
    image = torch.zeros(1, 8, 8, 3)
    for process in (FlowMatching(), EDM()):
        with pytest.raises(ValueError, match="strength must be in"):
            process.img2img(None, image, None, strength=1.5)
        assert torch.equal(process.img2img(None, image, None, strength=0.0),
                           image)


# ---------------------------------------------------- models and losses
@pytest.fixture(scope="module")
def small_models():
    model, params, config = jax_unet(conditional=True, seed=4)
    return model, params, torch_unet(params, config)


@pytest.mark.parametrize("process,loss_type", [
    ("flow", "l2"), ("edm", "l2"), ("edm", "huber")])
def test_p_losses_match_jax(small_models, process, loss_type):
    model, params, tmodel = small_models
    x0 = np.random.default_rng(6).uniform(-1, 1, (4, 16, 16, 3)).astype(
        np.float32)
    (noise,) = normal_arrays(7, 1, (4, 16, 16, 3))
    t = np.array([0, 13, 500, 999])
    y = np.array([0, 3, 7, 10])
    ref_p, ours_p = ((JaxFlowMatching(), FlowMatching()) if process == "flow"
                     else (JaxEDM(), EDM()))
    ref = jax.jit(lambda *args: ref_p.p_losses(
        lambda a, b, c: model.apply({"params": params}, a, b, c), *args,
        loss_type=loss_type))(jnp.asarray(x0), jnp.asarray(t),
                              jnp.asarray(noise), jnp.asarray(y))
    ours = ours_p.p_losses(tmodel, torch.from_numpy(x0), torch.from_numpy(t),
                           torch.from_numpy(noise), y=torch.from_numpy(y),
                           loss_type=loss_type)
    assert max_rel(ours.detach().numpy(), ref) <= 2e-4


@pytest.mark.parametrize("family", ["unet", "dit"])
def test_fractional_and_out_of_range_t_forward_matches_jax(family):
    """EDM gives the network t(sigma): fractional, and at sigma 1e-12 (the
    last Heun step's placeholder) far below 0."""
    if family == "unet":
        model, params, config = jax_unet(conditional=True, seed=8)
        tmodel = torch_unet(params, config)
    else:
        model, params, config = jax_dit(conditional=True, seed=8)
        tmodel = torch_dit(params, config)
    (x,) = normal_arrays(9, 1, (4, 16, 16, 3))
    sigma = np.array([80.0, 1.3, 0.002, 1e-12], np.float32)
    t = np.asarray(jax_edm._t_of_sigma(jnp.asarray(sigma), 0.002, 80.0, 1000))
    assert t[1] % 1 != 0 and t[3] < -100
    y = np.array([0, 2, 5, 10])
    ref = jax.jit(model.apply)({"params": params}, jnp.asarray(x),
                               jnp.asarray(t), jnp.asarray(y))
    with torch.no_grad():
        ours = tmodel(torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(y))
    assert max_rel(ours.numpy(), ref) <= 2e-4


# ---------------------------------------------------- whole trajectories
def churn_noises(rng, steps, shape):
    """The draws JAX's EDM sampler makes: the key after `_run`'s split,
    folded with each step's index."""
    key, _ = jax.random.split(rng)
    return [torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), shape, jnp.float32)))
        for i in range(steps)]


PROCESSES = {
    "flow_euler": (FlowMatching, JaxFlowMatching,
                   dict(num_inference_steps=8)),
    "flow_heun": (FlowMatching, JaxFlowMatching,
                  dict(num_inference_steps=5, solver="heun")),
    "edm": (EDM, JaxEDM, dict(num_inference_steps=6)),
    "edm_churn": (EDM, JaxEDM, dict(num_inference_steps=6, s_churn=20.0,
                                    s_min=0.05, s_max=50.0)),
}
# (process, cfg_scale or None, guidance_rescale): each unguided and with
# CFG; EDM's CFG with the rescale (flow matching takes none), and once
# without it
CASES = [(name, None, 0.0) for name in PROCESSES]
CASES += [("flow_euler", 3.0, 0.0), ("flow_heun", 3.0, 0.0),
          ("edm", 3.0, 0.0), ("edm", 3.0, 0.7), ("edm_churn", 3.0, 0.7)]


def jax_heun_without_churn(ref_p, jfn, noise, y, cfg_scale):
    """The JAX package's EDM sampler with s_churn = 0, step by step and
    eagerly: its denoiser, guidance and x0 constraint, and the Heun update
    of `edm._scan_segment` without the churn term, which is 0 there."""
    d_fn = ref_p.denoiser_fn(jfn)
    batch = noise.shape[0]
    p_threshold = jax_base.resolve_p_threshold(jax_base.AUTO_THRESHOLD,
                                               ref_p.clip_sample)

    @jax.jit
    def denoise(x, sigma_value):
        sigma = jnp.full((batch,), sigma_value, jnp.float32)
        if cfg_scale is None:
            return jnp.clip(d_fn(x, sigma, y), -1.0, 1.0)
        d = jax_edm._cfg_denoised(d_fn, x, sigma, y, jnp.float32(cfg_scale),
                                  ref_p.guidance_rescale)
        return jax_base.constrain_x0(d, p_threshold, ref_p.clip_sample)

    _, sigmas, sigma_hats, sigma_nexts = ref_p._scan_rows
    x = sigmas[0] * jnp.asarray(noise)
    for sigma, sigma_hat, sigma_next in zip(sigmas, sigma_hats, sigma_nexts):
        assert sigma_hat == sigma
        d1 = (x - denoise(x, sigma_hat)) / sigma_hat
        h = sigma_next - sigma_hat
        x_euler = x + h * d1
        if sigma_next > 0:
            d2 = (x_euler - denoise(x_euler, sigma_next)) / sigma_next
            x = x + h * 0.5 * (d1 + d2)
        else:
            x = x_euler
    return np.asarray(x)


def test_jax_edm_sampler_adds_noise_without_churn(small_models):
    """The compiled JAX sampler with s_churn = 0 moves away from its own
    Heun step by more than the trajectory bar, and depends on the key."""
    model, params, _ = small_models
    jfn = jax.tree_util.Partial(
        lambda x, t, yy: model.apply({"params": params}, x, t, yy))
    noise = np.random.default_rng(5).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    y = jnp.asarray([3, 8], jnp.int32)
    ref_p = JaxEDM(num_inference_steps=6)
    runs = [np.asarray(ref_p.sample(jfn, noise.shape, jax.random.PRNGKey(k),
                                    y=y, init_noise=jnp.asarray(noise)))
            for k in (11, 12)]
    eager = jax_heun_without_churn(ref_p, jfn, noise, y, None)
    assert max_rel(runs[0], eager) > 5e-4
    assert not np.array_equal(runs[0], runs[1])


@pytest.mark.parametrize("name,cfg_scale,rescale", CASES)
def test_trajectory_matches_jax(small_models, name, cfg_scale, rescale):
    model, params, tmodel = small_models
    cls, jcls, kwargs = PROCESSES[name]
    if rescale:
        kwargs = dict(kwargs, guidance_rescale=rescale)
    noise = np.random.default_rng(5).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    y = np.array([3, 8], np.int64)
    jfn = jax.tree_util.Partial(
        lambda x, t, yy: model.apply({"params": params}, x, t, yy))
    ref_p, ours_p = jcls(**kwargs), cls(**kwargs)
    rng = jax.random.PRNGKey(11)
    extra = {}
    if cls is EDM:
        extra["noises"] = churn_noises(rng, ours_p.num_inference_steps,
                                       noise.shape)
    calls = []

    def counted(x, t, yy):
        calls.append(t.dtype)
        return tmodel(x, t, yy)

    if name == "edm":
        ref = jax_heun_without_churn(ref_p, jfn, noise,
                                     jnp.asarray(y, jnp.int32), cfg_scale)
    elif cfg_scale is None:
        ref = ref_p.sample(jfn, noise.shape, rng, y=jnp.asarray(y, jnp.int32),
                           init_noise=jnp.asarray(noise))
    else:
        ref = ref_p.sample_with_cfg(jfn, noise.shape,
                                    jnp.asarray(y, jnp.int32), rng,
                                    cfg_scale=cfg_scale,
                                    init_noise=jnp.asarray(noise))
    if cfg_scale is None:
        ours = ours_p.sample(counted, noise.shape, y=torch.from_numpy(y),
                             init_noise=torch.from_numpy(noise), **extra)
    else:
        ours = ours_p.sample_with_cfg(
            counted, noise.shape, torch.from_numpy(y), cfg_scale=cfg_scale,
            init_noise=torch.from_numpy(noise), **extra)
    assert np.isfinite(ours.numpy()).all()
    assert max_rel(ours.numpy(), ref) <= 5e-4
    # the discarded corrector of the last Heun step is not evaluated
    steps = kwargs["num_inference_steps"]
    heun = cls is EDM or kwargs.get("solver") == "heun"
    assert len(calls) == (2 * steps - 1 if heun else steps)
    assert set(calls) == {torch.float32 if cls is EDM else torch.int64}


def test_edm_churn_noise_comes_from_the_callers_generator(small_models):
    _, _, tmodel = small_models
    process = EDM(num_inference_steps=3, s_churn=20.0)
    y = torch.tensor([1, 2])

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return process.sample_with_cfg(tmodel, (2, 16, 16, 3), y, gen)

    first = run(0)
    torch.testing.assert_close(run(0), first, rtol=0, atol=0)
    assert not torch.equal(run(1), first)


# ------------------------------------------------------------ entry points
def tiny_config(tmp_path, **overrides):
    """A synthetic 8x8 config: 512 images at batch 256, two steps an
    epoch, one epoch, then the in-training sample grid."""
    config = {
        "model_type": "unet",
        "model_params": {"image_size": (8, 8), "in_channels": 3,
                         "model_channels": 16, "out_channels": 3,
                         "num_res_blocks": 1, "attention_resolutions": (4,),
                         "dropout": 0.1, "channel_mult": (1, 2),
                         "use_attention": True},
        "dataset": "synthetic", "image_size": (8, 8), "conditional": True,
        "num_classes": 10, "num_timesteps": 20, "beta_start": 0.0001,
        "beta_end": 0.02, "beta_schedule": "linear", "loss_type": "l2",
        "cfg_scale": 1.4, "num_inference_steps": 3, "epochs": 1,
        "batch_size": 256, "num_workers": 0, "optimizer": "adamw",
        "learning_rate": 1e-3, "use_ema": True, "ema_decay": 0.99,
        "save_dir": str(tmp_path / "ckpt"),
        "sample_dir": str(tmp_path / "samples"), "save_interval": 1,
        "sample_interval": 1, "sample_start_epoch": 1, "num_samples": 4,
        "seed": 42,
    }
    config.update(overrides)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    return str(path), config


@pytest.mark.parametrize("change,process", [
    ({"diffusion_type": "flow_matching", "flow_solver": "heun"},
     FlowMatching),
    ({"diffusion_type": "edm", "s_churn": 5.0}, EDM),
])
def test_train_and_sample_cli_on_flow_and_edm_configs(tmp_path, change,
                                                      process):
    cfg_path, config = tiny_config(tmp_path, **change)
    trainer = train.main(["--config", cfg_path, "--device", "cpu"])
    assert isinstance(trainer.diffusion, process)
    assert trainer.global_step == 2
    assert (tmp_path / "samples" / "epoch_0001.png").is_file()
    ckpt = tmp_path / "ckpt" / "current_model.pth"
    result = sample.main([
        "--checkpoint", str(ckpt), "--sampling_method", "ddim",
        "--num_samples", "2", "--batch_size", "2", "--cfg_scale", "2",
        "--use_ema", "--device", "cpu", "--output_dir",
        str(tmp_path / "out")])
    samples = result["samples"]
    assert samples.shape == (2, 8, 8, 3) and np.isfinite(samples).all()
