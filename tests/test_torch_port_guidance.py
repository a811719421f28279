"""The PyTorch port's training-free sampling knobs against the JAX package, on
the CPU: FreeU's Fourier low-pass (`ops/fourier.py`), the UNet's and the
DiT's perturbed attention (`pag_perturb`), FreeU in the UNet, its DeepCache
views (`deepcache_mode` 'full' and 'shallow' at depth 1 and 2), PAG over a
DDIM trajectory (`diffusion/pag.py`) and DeepCache sampling
(`diffusion/deepcache.py`), with the JAX package's weights carried over by
`utils/weights.py`.

Bars, max|port - jax| / max|jax|:
  * `fourier_lowpass_scale` on random maps: 1e-5 (two FFTs in float32);
  * one forward of a small UNet or DiT: 2e-4, the forward bar of
    tests/test_torch_port_unet.py;
  * whole trajectories, 10 steps or fewer: 5e-4;
  * bf16 (FreeU, DeepCache 'shallow'): bars fixed by measurement under the
    rule of tests/test_torch_port_bf16_models.py (`check_bar`: at most twice
    JAX's own bf16-vs-float32 distance, and the port's bf16 run at least
    half that distance from its float32 run), `BF16_BAR`.
DeepCache at interval 1 is the port's own DDIM bit for bit. The port's
DeepCache cache is the UNet's NCHW feature; JAX's is NHWC.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.diffusion import DDIM as JaxDDIM
from diffusion_models_collection_tpu.diffusion import deepcache as jax_dc
from diffusion_models_collection_tpu.diffusion import pag as jax_pag
from diffusion_models_collection_tpu.models import DiT as JaxDiT
from diffusion_models_collection_tpu.models import UNet as JaxUNet
from diffusion_models_collection_tpu.ops import fourier as jax_fourier
from diffusion_models_collection_tpu_torch.diffusion import DDIM
from diffusion_models_collection_tpu_torch.diffusion.deepcache import (
    deepcache_sample,
)
from diffusion_models_collection_tpu_torch.diffusion.pag import pag_model_fn
from diffusion_models_collection_tpu_torch.models import DiT, UNet
from diffusion_models_collection_tpu_torch.ops.fourier import (
    fourier_lowpass_scale,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from test_torch_port_bf16_models import check_bar
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    DIT_PARAMS,
    MODEL_PARAMS,
    jax_dit,
    max_rel,
    one_torch_thread,
    perturbed,
    small_config,
    torch_dit,
)

# three levels (16, 8, 4), so DeepCache runs at depth 1 and 2
UNET3_PARAMS = dict(MODEL_PARAMS, channel_mult=(1, 2, 2))
FREEU = (1.1, 1.2, 0.9, 0.2)
# measured on this file's inputs on the CPU (the port's bf16 run against
# JAX's bf16 and float32 runs; JAX's own bf16-vs-float32 distance): FreeU
# the UNet forward's bar of tests/test_torch_port_bf16_models.py
BF16_BAR = {
    "freeu": 2e-2,  # (1.72e-2, 1.03e-2; 1.31e-2)
    "shallow": 1.2e-2,  # (8.04e-3, 8.06e-3; 8.04e-3)
}


@functools.lru_cache(maxsize=None)
def unet3():
    """(flax UNet, perturbed params, config) of the three-level UNet."""
    model = JaxUNet(**UNET3_PARAMS, num_classes=10)
    params = model.init(jax.random.PRNGKey(2), jnp.zeros((1, 16, 16, 3)),
                        jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1,), jnp.int32))["params"]
    return model, perturbed(params, 2), dict(small_config(),
                                             model_params=UNET3_PARAMS)


def port_unet(params, config, **knobs):
    model = UNet(**UNET3_PARAMS, num_classes=10, **knobs)
    model.load_state_dict(state_dict_from_jax(params, config), strict=True)
    return model.eval()


def jax_apply(model, params, *args, **kwargs):
    return jax.jit(lambda p, *a: model.apply({"params": p}, *a, **kwargs))(
        params, *args)


def inputs(batch=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 16, 16, 3)).astype(np.float32)
    t = np.array([0, 500, 999][:batch], np.int64)
    y = np.array([1, 4, 0][:batch], np.int64)
    return x, t, y


def as_torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# -------------------------------------------------------------- fourier
@pytest.mark.parametrize("shape,threshold,scale", [
    ((2, 8, 8, 4), 1, 0.5),  # the UNet's 8x8 FreeU level
    ((2, 4, 4, 6), 1, 0.2),  # its 4x4 level
    ((2, 7, 9, 3), 2, 0.3),  # odd H and W
    ((1, 5, 6, 3), 10, 2.0),  # a threshold covering the whole spectrum
])
def test_fourier_lowpass_scale_matches_jax(shape, threshold, scale):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax_fourier.fourier_lowpass_scale(jnp.asarray(x),
                                                       threshold, scale))
    ours = fourier_lowpass_scale(torch.from_numpy(x).permute(0, 3, 1, 2),
                                 threshold, scale).permute(0, 2, 3, 1)
    assert ours.dtype == torch.float32
    assert max_rel(ours.numpy(), ref) <= 1e-5
    if threshold == 10:  # the whole map, scaled
        assert max_rel(ours.numpy(), scale * x) <= 1e-5


def test_fourier_lowpass_scale_keeps_dtype_and_checks_threshold():
    x = torch.randn(1, 3, 4, 4).to(torch.bfloat16)
    assert fourier_lowpass_scale(x, 1, 0.5).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="threshold must be >= 1"):
        fourier_lowpass_scale(x, 0, 0.5)


# -------------------------------------------------------------- forwards
def test_unet_pag_perturb_forward_matches_jax():
    model, params, config = unet3()
    x, t, y = inputs()
    ref = jax_apply(model.clone(pag_perturb=True), params, x, t, y)
    plain = jax_apply(model, params, x, t, y)
    tmodel = port_unet(params, config)
    with torch.no_grad():
        ours = tmodel(*as_torch(x, t, y), pag_perturb=True)
        built = port_unet(params, config, pag_perturb=True)(*as_torch(x, t, y))
    assert max_rel(ours.numpy(), ref) <= 2e-4
    assert torch.equal(ours, built)
    assert max_rel(np.asarray(ref), plain) > 1e-2  # the knob does something


def test_dit_pag_perturb_forward_matches_jax():
    model, params, config = jax_dit(conditional=True, seed=3)
    x, t, y = inputs()
    ref = jax_apply(JaxDiT(img_size=(16, 16), **DIT_PARAMS, num_classes=10,
                           pag_perturb=True), params, x, t, y)
    tmodel = torch_dit(params, config)
    with torch.no_grad():
        ours = tmodel(*as_torch(x, t, y), pag_perturb=True)
        plain = tmodel(*as_torch(x, t, y))
        built = torch_dit(params, config, pag_perturb=True)(*as_torch(x, t, y))
    assert max_rel(ours.numpy(), ref) <= 2e-4
    assert torch.equal(ours, built)
    assert max_rel(plain.numpy(), np.asarray(ref)) > 1e-2


def test_unet_freeu_forward_matches_jax():
    model, params, config = unet3()
    x, t, y = inputs()
    ref = jax_apply(model.clone(freeu=FREEU), params, x, t, y)
    tmodel = port_unet(params, config, freeu=FREEU)
    with torch.no_grad():
        ours = tmodel(*as_torch(x, t, y))
        plain = port_unet(params, config)(*as_torch(x, t, y))
    assert max_rel(ours.numpy(), ref) <= 2e-4
    assert max_rel(plain.numpy(), np.asarray(ref)) > 1e-2


@pytest.mark.parametrize("depth", [1, 2])
def test_deepcache_views_match_jax(depth):
    """'full' returns the forward and the feature entering up level
    n_levels - depth; 'shallow' from JAX's cache reruns the outer levels."""
    model, params, config = unet3()
    x, t, y = inputs()
    ref, ref_cache = jax_apply(
        model.clone(deepcache_mode="full", deepcache_depth=depth), params,
        x, t, y)
    ref_shallow = jax_apply(
        model.clone(deepcache_mode="shallow", deepcache_depth=depth),
        params, x, t, y, cache=ref_cache)
    tmodel = port_unet(params, config)
    cache_nchw = torch.from_numpy(
        np.ascontiguousarray(np.transpose(np.asarray(ref_cache),
                                          (0, 3, 1, 2))))
    with torch.no_grad():
        ours, cache = tmodel(*as_torch(x, t, y), deepcache_mode="full",
                             deepcache_depth=depth)
        shallow = tmodel(*as_torch(x, t, y), cache_nchw,
                         deepcache_mode="shallow", deepcache_depth=depth)
        plain = tmodel(*as_torch(x, t, y))
    assert torch.equal(ours, plain)
    assert max_rel(ours.numpy(), ref) <= 2e-4
    assert max_rel(cache.permute(0, 2, 3, 1).numpy(), ref_cache) <= 2e-4
    assert max_rel(shallow.numpy(), ref_shallow) <= 2e-4


def test_views_load_the_same_state_dict_strict():
    """Every view is the same module: the bridged weights load with
    strict=True and the keys are the plain model's."""
    _, params, config = unet3()
    state = state_dict_from_jax(params, config)
    keys = set(UNet(**UNET3_PARAMS, num_classes=10).state_dict())
    for knobs in (dict(pag_perturb=True), dict(freeu=FREEU),
                  dict(deepcache_mode="full", deepcache_depth=2),
                  dict(deepcache_mode="shallow")):
        model = UNet(**UNET3_PARAMS, num_classes=10, **knobs)
        model.load_state_dict(state, strict=True)
        assert set(model.state_dict()) == keys
    _, dit_params, dit_config = jax_dit(conditional=True, seed=3)
    dit = DiT(img_size=(16, 16), **DIT_PARAMS, num_classes=10,
              pag_perturb=True)
    dit.load_state_dict(state_dict_from_jax(dit_params, dit_config),
                        strict=True)
    assert set(dit.state_dict()) == set(
        DiT(img_size=(16, 16), **DIT_PARAMS, num_classes=10).state_dict())


@pytest.mark.parametrize("knobs", [
    dict(freeu=(1.0, 1.0, 1.0)),
    dict(freeu=(1.0, float("nan"), 1.0, 1.0)),
    dict(freeu=(1.0, "2", 1.0, 1.0)),
    dict(deepcache_mode="middle"),
    dict(deepcache_mode="full", deepcache_depth=3),
    dict(deepcache_mode="full", deepcache_depth=0),
    dict(deepcache_mode="shallow"),
])
def test_unet_knob_errors_match_jax(knobs):
    """The JAX UNet's ValueErrors, with its messages, at build or call."""
    model, params, config = unet3()
    x, t, y = inputs(1)
    with pytest.raises(ValueError) as ref:
        model.clone(**knobs).apply({"params": params}, x, t, y)
    with pytest.raises(ValueError) as ours:
        UNet(**UNET3_PARAMS, num_classes=10, **knobs)(*as_torch(x, t, y))
    assert str(ours.value) == str(ref.value)


# ---------------------------------------------------------- trajectories
def jax_fn(model, params, **fields):
    view = model.clone(**fields) if fields else model
    return jax.tree_util.Partial(
        lambda x, t, yy: view.apply({"params": params}, x, t, yy))


def test_pag_model_fn_is_the_jax_formula():
    def base(x, t, y):
        return 2 * x

    def perturbed_fn(x, t, y):
        return x + 1
    x = np.linspace(-1, 1, 12, dtype=np.float32).reshape(1, 2, 2, 3)
    ref = jax_pag.pag_model_fn(base, perturbed_fn, 1.5)(jnp.asarray(x), 0)
    ours = pag_model_fn(base, perturbed_fn, 1.5)(torch.from_numpy(x), 0)
    assert max_rel(ours.numpy(), ref) <= 1e-6


@pytest.mark.parametrize("family", ["unet", "dit"])
def test_pag_ddim_10_cfg_trajectory_matches_jax(family):
    """PAG at scale 2 over DDIM-10 with CFG 3: both branches of the fused
    [cond; uncond] batch rectified, on the same weights. The UNet's case
    runs without the x0 constraint (`clip_sample: False`): under PAG the
    perturbed random UNet's x0 sits far beyond the dynamic threshold every
    step, whose data-dependent scale then doubles a float32 error a step,
    so a 1e-6 relative change of the initial noise alone moves the port's
    own result by 1.2e-3 (against 4.5e-6 without the constraint; the DiT's
    thresholded trajectory moves 1.1e-5), and no comparison of two float32
    programs could hold 5e-4 there."""
    clip = family == "dit"
    if family == "unet":
        model, params, config = unet3()
        tmodel = port_unet(params, config)
    else:
        model, params, config = jax_dit(conditional=True, seed=3)
        tmodel = torch_dit(params, config)
    noise, _, _ = inputs(2, seed=5)
    y = np.array([3, 8], np.int64)
    jfn = jax_pag.pag_model_fn(jax_fn(model, params),
                               jax_fn(model, params, pag_perturb=True), 2.0)
    ref = JaxDDIM(num_inference_steps=10, clip_sample=clip).sample_with_cfg(
        jfn, noise.shape, jnp.asarray(y, jnp.int32), jax.random.PRNGKey(0),
        cfg_scale=3.0, init_noise=jnp.asarray(noise))

    def perturbed_fn(x, t, yy=None):
        return tmodel(x, t, yy, pag_perturb=True)
    ours = DDIM(num_inference_steps=10, clip_sample=clip).sample_with_cfg(
        pag_model_fn(tmodel, perturbed_fn, 2.0), noise.shape,
        torch.from_numpy(y), cfg_scale=3.0,
        init_noise=torch.from_numpy(noise))
    assert np.isfinite(ours.numpy()).all()
    assert max_rel(ours.numpy(), ref) <= 5e-4


def port_views(tmodel, depth):
    def full_fn(x, t, y):
        return tmodel(x, t, y, deepcache_mode="full", deepcache_depth=depth)

    def shallow_fn(x, t, y, cache):
        return tmodel(x, t, y, cache, deepcache_mode="shallow",
                      deepcache_depth=depth)
    return full_fn, shallow_fn


@pytest.mark.parametrize("depth,cfg_scale", [(1, 3.0), (2, None)])
def test_deepcache_sample_matches_jax(depth, cfg_scale):
    """DDIM-10 at interval 3: chunks of one full and two shallow steps and
    a one-step tail."""
    model, params, config = unet3()
    tmodel = port_unet(params, config)
    noise, _, _ = inputs(2, seed=6)
    y = np.array([2, 9], np.int64)
    full = model.clone(deepcache_mode="full", deepcache_depth=depth)
    shallow = model.clone(deepcache_mode="shallow", deepcache_depth=depth)
    ref = jax_dc.deepcache_sample(
        JaxDDIM(num_inference_steps=10),
        jax.tree_util.Partial(lambda x, t, yy: full.apply(
            {"params": params}, x, t, yy)),
        jax.tree_util.Partial(lambda x, t, yy, c: shallow.apply(
            {"params": params}, x, t, yy, cache=c)),
        noise.shape, jax.random.PRNGKey(0), y=jnp.asarray(y, jnp.int32),
        cfg_scale=cfg_scale, interval=3, init_noise=jnp.asarray(noise))
    ours = deepcache_sample(
        DDIM(num_inference_steps=10), *port_views(tmodel, depth),
        noise.shape, y=torch.from_numpy(y), cfg_scale=cfg_scale, interval=3,
        init_noise=torch.from_numpy(noise))
    assert np.isfinite(ours.numpy()).all()
    assert max_rel(ours.numpy(), ref) <= 5e-4


@pytest.mark.parametrize("cfg_scale", [None, 3.0])
def test_deepcache_interval_1_is_ddim_bit_for_bit(cfg_scale):
    _, params, config = unet3()
    tmodel = port_unet(params, config)
    noise, _, _ = inputs(2, seed=7)
    y = torch.tensor([1, 5])
    ddim = DDIM(num_inference_steps=6, guidance_rescale=0.5)
    ours = deepcache_sample(ddim, *port_views(tmodel, 1), noise.shape, y=y,
                            cfg_scale=cfg_scale, interval=1,
                            init_noise=torch.from_numpy(noise))
    if cfg_scale is None:
        ref = ddim.sample(tmodel, noise.shape, y=y,
                          init_noise=torch.from_numpy(noise))
    else:
        ref = ddim.sample_with_cfg(tmodel, noise.shape, y, cfg_scale=cfg_scale,
                                   init_noise=torch.from_numpy(noise))
    assert torch.equal(ours, ref)


def test_deepcache_sample_errors_match_jax():
    for kwargs in (dict(interval=0), dict(interval=2, cfg_scale=3.0)):
        with pytest.raises(ValueError) as ref:
            jax_dc.deepcache_sample(JaxDDIM(num_inference_steps=4), None,
                                    None, (1, 4, 4, 3), jax.random.PRNGKey(0),
                                    **kwargs)
        with pytest.raises(ValueError) as ours:
            deepcache_sample(DDIM(num_inference_steps=4), None, None,
                             (1, 4, 4, 3), torch.Generator(), **kwargs)
        assert str(ours.value) == str(ref.value)


# ----------------------------------------------------------------- bf16
@pytest.mark.parametrize("view", ["freeu", "shallow"])
def test_bf16_freeu_and_deepcache_shallow_match_jax(view):
    """In `mixed_precision: 'bf16'` (the casts of the port's bf16 UNet
    against flax's `dtype=bfloat16`), within the UNet's bf16 forward bar."""
    model, params, config = unet3()
    x, t, y = inputs(3, seed=4)
    fields = (dict(freeu=FREEU) if view == "freeu"
              else dict(deepcache_mode="shallow", deepcache_depth=1))
    _, cache = jax_apply(model.clone(deepcache_mode="full"), params, x, t, y)
    extra = {} if view == "freeu" else dict(cache=cache)
    jax32 = np.asarray(jax_apply(model.clone(**fields), params, x, t, y,
                                 **extra))
    jax16 = np.asarray(jax_apply(model.clone(dtype=jnp.bfloat16, **fields),
                                 params, x, t, y, **extra))
    cache_nchw = torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(cache), (0, 3, 1, 2))))
    args = [*as_torch(x, t, y)] + ([] if view == "freeu" else [cache_nchw])
    state = state_dict_from_jax(params, config)
    outs = {}
    for dtype in (torch.bfloat16, None):
        tmodel = UNet(**UNET3_PARAMS, num_classes=10, dtype=dtype, **fields)
        tmodel.load_state_dict(state, strict=True)
        with torch.no_grad():
            outs[dtype] = tmodel.eval()(*args).numpy()
    assert outs[torch.bfloat16].dtype == np.float32
    check_bar(BF16_BAR[view], f"unet {view}", outs[torch.bfloat16],
              outs[None], jax16, jax32)
