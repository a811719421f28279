"""The PyTorch port's image editing against the JAX package, on the CPU:
img2img (SDEdit) and inpainting on DDPM, DDIM, flow matching and EDM,
RePaint's resampling on DDPM, DDIM inversion and restart sampling, every
ValueError of those methods, and the PNG reader behind `--init_image` and
`--mask` against the JAX pipeline's Pillow loaders.

jax.random and torch.Generator never agree by seed, so the JAX package's
draws are made here, from its keys as it folds them, and handed to the port:
the start's `q_sample` noise, each ancestral step's (`fold_in` by the
timestep), each inpainting projection's (timestep + 1_000_000), RePaint's
segment keys (5_000_000 + hop) and renoise hops (3_000_000 + hop), the
restart hops (7_000_000 + k), EDM's churn (the grid index) and its
projection (index + 1_000_000).

Bars, max|port - jax| / max|jax|: whole trajectories through the small UNet,
a dozen steps or fewer, 5e-4; the PNG loaders bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_models_collection_tpu import pipeline as jax_pipeline
from diffusion_models_collection_tpu.diffusion import DDIM as JaxDDIM
from diffusion_models_collection_tpu.diffusion import DDPM as JaxDDPM
from diffusion_models_collection_tpu.diffusion import EDM as JaxEDM
from diffusion_models_collection_tpu.diffusion import (
    FlowMatching as JaxFlowMatching,
)
from diffusion_models_collection_tpu_torch.diffusion import (
    DDIM,
    DDPM,
    EDM,
    FlowMatching,
)
from diffusion_models_collection_tpu_torch.utils import helpers
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    jax_unet,
    max_rel,
    one_torch_thread,
    torch_unet,
)


@pytest.fixture(scope="module")
def small_models():
    model, params, config = jax_unet(conditional=True, seed=4)
    jfn = jax.tree_util.Partial(
        lambda x, t, yy: model.apply({"params": params}, x, t, yy))
    return jfn, torch_unet(params, config)


SHAPE = (2, 16, 16, 3)
LABELS = np.array([3, 8], np.int64)


def image_and_mask(seed=0):
    """An init image in [-1, 1] and a mask keeping the left half (0) and
    regenerating the right (1), broadcast over channels."""
    rng = np.random.default_rng(seed)
    image = np.clip(rng.standard_normal(SHAPE) * 0.5, -1, 1).astype(
        np.float32)
    mask = np.zeros((1, 16, 16, 1), np.float32)
    mask[:, :, 8:] = 1.0
    return image, mask


def normal(key, shape=SHAPE):
    return np.array(jax.random.normal(key, shape, jnp.float32))


def folded(key, offsets):
    return [torch.from_numpy(normal(jax.random.fold_in(key, int(o))))
            for o in offsets]


def guidance(cfg_scale):
    """(JAX kwargs, port kwargs) of an unguided or CFG run."""
    if cfg_scale is None:
        return {}, {}
    return (dict(y=jnp.asarray(LABELS, jnp.int32), cfg_scale=cfg_scale),
            dict(y=torch.from_numpy(LABELS), cfg_scale=cfg_scale))


def check(ours, ref, mask=None, image=None):
    ours = ours.numpy()
    assert np.isfinite(ours).all()
    assert max_rel(ours, ref) <= 5e-4
    if mask is not None:  # the kept pixels end at the original exactly
        keep = np.broadcast_to(mask, ours.shape) == 0
        np.testing.assert_array_equal(ours[keep], image[keep])


# ------------------------------------------------------------------ DDPM
@pytest.mark.parametrize("cfg_scale,masked", [(None, False), (3.0, True)])
def test_ddpm_img2img_matches_jax(small_models, cfg_scale, masked):
    """strength 0.01: t0 = 10, eleven ancestral steps."""
    jfn, tmodel = small_models
    image, mask = image_and_mask()
    rng = jax.random.PRNGKey(11)
    jkw, kw = guidance(cfg_scale)
    ref = JaxDDPM().img2img(jfn, jnp.asarray(image), rng, strength=0.01,
                            mask=jnp.asarray(mask) if masked else None, **jkw)
    key, start_key = jax.random.split(rng)
    steps = range(10, -1, -1)
    ours = DDPM().img2img(
        tmodel, torch.from_numpy(image), strength=0.01,
        mask=torch.from_numpy(mask) if masked else None,
        start_noise=torch.from_numpy(normal(start_key)),
        noises=folded(key, steps),
        known_noises=folded(key, [i + 1_000_000 for i in steps]), **kw)
    check(ours, ref, mask if masked else None, image)


def repaint_noises(rng, t0, jump, resample):
    """JAX's RePaint draws in the order the port takes them: each
    segment's step and projection noises from fold_in(rng, 5_000_000 +
    hop), each renoise hop's from fold_in(rng, 3_000_000 + hop)."""
    key, start_key = jax.random.split(rng)
    ts = list(range(t0, -1, -1))
    noises, known, renoise = [], [], []
    hop = 0
    for pos in range(0, len(ts), jump):
        chunk = ts[pos:pos + jump]
        for rep in range(resample):
            seg = jax.random.fold_in(key, 5_000_000 + hop)
            hop += 1
            noises += folded(seg, chunk)
            known += folded(seg, [i + 1_000_000 for i in chunk])
            if rep < resample - 1:
                renoise += folded(key, [3_000_000 + hop])
                hop += 1
    return torch.from_numpy(normal(start_key)), noises, known, renoise


def test_repaint_matches_jax(small_models):
    """jump 2, resample 2 from t0 = 5 (strength 0.005): chunks (5, 4),
    (3, 2), (1, 0), each run twice with a renoise hop between."""
    jfn, tmodel = small_models
    image, mask = image_and_mask(1)
    rng = jax.random.PRNGKey(12)
    jkw, kw = guidance(3.0)
    ref = JaxDDPM().img2img(jfn, jnp.asarray(image), rng, strength=0.005,
                            mask=jnp.asarray(mask), repaint_jump=2,
                            repaint_resample=2, return_all_timesteps=True,
                            **jkw)
    start, noises, known, renoise = repaint_noises(rng, 5, 2, 2)
    ours = DDPM().img2img(
        tmodel, torch.from_numpy(image), strength=0.005,
        mask=torch.from_numpy(mask), repaint_jump=2, repaint_resample=2,
        start_noise=start, noises=noises, known_noises=known,
        renoise_noises=renoise, return_all_timesteps=True, **kw)
    assert ours.shape == (12, *SHAPE) == ref.shape
    check(ours[-1], ref[-1], mask, image)
    assert max_rel(ours.numpy(), ref) <= 5e-4


# ------------------------------------------------------------------ DDIM
@pytest.mark.parametrize("cfg_scale,masked,eta", [
    (3.0, False, 0.0), (None, True, 0.0), (3.0, True, 0.5)])
def test_ddim_img2img_matches_jax(small_models, cfg_scale, masked, eta):
    """A 10-step grid cut at strength 0.5: five steps from t = 444."""
    jfn, tmodel = small_models
    image, mask = image_and_mask(2)
    rng = jax.random.PRNGKey(13)
    jkw, kw = guidance(cfg_scale)
    ref = JaxDDIM(num_inference_steps=10, eta=eta).img2img(
        jfn, jnp.asarray(image), rng, strength=0.5,
        mask=jnp.asarray(mask) if masked else None, **jkw)
    key, start_key = jax.random.split(rng)
    key, _ = jax.random.split(key)  # `DDIM._run` splits once more
    ours = DDIM(num_inference_steps=10, eta=eta).img2img(
        tmodel, torch.from_numpy(image), strength=0.5,
        mask=torch.from_numpy(mask) if masked else None,
        start_noise=torch.from_numpy(normal(start_key)),
        noises=folded(key, range(5)),
        known_noises=folded(key, [i + 1_000_000 for i in range(5)]), **kw)
    check(ours, ref, mask if masked else None, image)


@pytest.mark.parametrize("num_steps", [None, 6])
def test_ddim_invert_matches_jax(small_models, num_steps):
    jfn, tmodel = small_models
    image, _ = image_and_mask(3)
    ref = JaxDDIM(num_inference_steps=8).invert(
        jfn, jnp.asarray(image), y=jnp.asarray(LABELS, jnp.int32),
        num_steps=num_steps)
    ours = DDIM(num_inference_steps=8).invert(
        tmodel, torch.from_numpy(image), y=torch.from_numpy(LABELS),
        num_steps=num_steps)
    check(ours, ref)


@pytest.mark.parametrize("cfg_scale", [None, 3.0])
def test_sample_restart_matches_jax(small_models, cfg_scale):
    """DDIM-10 (999, 888, ..., 111, 0) with two restarts in (100, 400): down
    to 111, twice back to 333 and down again, then to 0. Unguided, the x0
    clamp is off (`clip_sample: False`): there the random UNet's x0 is
    clamped nearly everywhere, and a 1e-6 relative change of the initial
    noise alone moves the port's own result by 5.6e-4 over these 14 calls
    (1.4e-6 without the clamp; 3.1e-5 with CFG and its threshold, the
    other case), beyond what any two float32 programs could agree on."""
    jfn, tmodel = small_models
    noise, _ = image_and_mask(4)
    rng = jax.random.PRNGKey(14)
    jkw, kw = guidance(cfg_scale)
    clip = cfg_scale is not None
    ref = JaxDDIM(num_inference_steps=10, clip_sample=clip).sample_restart(
        jfn, SHAPE, rng, restart_interval=(100, 400), restarts=2,
        init_noise=jnp.asarray(noise), **jkw)
    key, _ = jax.random.split(rng)
    ours = DDIM(num_inference_steps=10, clip_sample=clip).sample_restart(
        tmodel, SHAPE, restart_interval=(100, 400), restarts=2,
        init_noise=torch.from_numpy(noise),
        restart_noises=folded(key, [7_000_000, 7_000_001]), **kw)
    check(ours, ref)


@pytest.mark.parametrize("cfg_scale", [None, 3.0])
def test_restarts_0_is_ddim_bit_for_bit(small_models, cfg_scale):
    _, tmodel = small_models
    noise = torch.from_numpy(image_and_mask(5)[0])
    ddim = DDIM(num_inference_steps=6)
    _, kw = guidance(cfg_scale)
    ours = ddim.sample_restart(tmodel, SHAPE, restarts=0, init_noise=noise,
                               **kw)
    if cfg_scale is None:
        ref = ddim.sample(tmodel, SHAPE, init_noise=noise)
    else:
        ref = ddim.sample_with_cfg(tmodel, SHAPE, kw["y"], cfg_scale=3.0,
                                   init_noise=noise)
    assert torch.equal(ours, ref)


# ------------------------------------------------------ flow and EDM
def test_flow_img2img_with_mask_matches_jax(small_models):
    """Euler and Heun over ceil(0.5 * 8) = 4 steps from tau 0.5, CFG 3."""
    jfn, tmodel = small_models
    image, mask = image_and_mask(6)
    rng = jax.random.PRNGKey(15)
    jkw, kw = guidance(3.0)
    _, start_key = jax.random.split(rng)
    for solver in ("euler", "heun"):
        ref = JaxFlowMatching(num_inference_steps=8, solver=solver).img2img(
            jfn, jnp.asarray(image), rng, strength=0.5,
            mask=jnp.asarray(mask), **jkw)
        ours = FlowMatching(num_inference_steps=8, solver=solver).img2img(
            tmodel, torch.from_numpy(image), strength=0.5,
            mask=torch.from_numpy(mask),
            start_noise=torch.from_numpy(normal(start_key)), **kw)
        check(ours, ref, mask, image)


def test_edm_img2img_with_mask_matches_jax(small_models):
    """The 8-step Karras grid entered at strength 0.6, with churn (without
    it JAX's compiled sampler on the CPU adds noise of its own:
    tests/test_torch_port_flow_edm.py), CFG 3."""
    jfn, tmodel = small_models
    image, mask = image_and_mask(7)
    rng = jax.random.PRNGKey(16)
    jkw, kw = guidance(3.0)
    jedm = JaxEDM(num_inference_steps=8, s_churn=2.0)
    ref = jedm.img2img(jfn, jnp.asarray(image), rng, strength=0.6,
                       mask=jnp.asarray(mask), **jkw)
    edm = EDM(num_inference_steps=8, s_churn=2.0)
    first = int(np.argmax(edm.rows[:, 0] <= 0.002 * (80 / 0.002) ** 0.6
                          + 1e-12))
    assert 0 < first < 7
    key, start_key = jax.random.split(rng)
    key, _ = jax.random.split(key)  # `EDM._run` splits once more
    idx = range(first, 8)
    ours = edm.img2img(tmodel, torch.from_numpy(image), strength=0.6,
                       mask=torch.from_numpy(mask),
                       start_noise=torch.from_numpy(normal(start_key)),
                       noises=folded(key, idx),
                       known_noises=folded(key, [i + 1_000_000 for i in idx]),
                       **kw)
    check(ours, ref, mask, image)


# ---------------------------------------------------------------- errors
IMG = np.zeros((1, 4, 4, 3), np.float32)
MASK = np.ones((1, 4, 4, 1), np.float32)


@pytest.mark.parametrize("cls,jcls,method,kwargs", [
    (DDPM, JaxDDPM, "img2img", dict(strength=1.5)),
    (DDPM, JaxDDPM, "img2img", dict(strength=-0.1)),
    (DDPM, JaxDDPM, "img2img", dict(repaint_resample=0)),
    (DDPM, JaxDDPM, "img2img", dict(repaint_resample=2, repaint_jump=2)),
    (DDPM, JaxDDPM, "img2img", dict(repaint_resample=2, mask=MASK)),
    (DDPM, JaxDDPM, "img2img", dict(cfg_scale=3.0)),
    (DDIM, JaxDDIM, "img2img", dict(strength=2.0)),
    (DDIM, JaxDDIM, "img2img", dict(cfg_scale=3.0)),
    (FlowMatching, JaxFlowMatching, "img2img", dict(strength=1.1)),
    (FlowMatching, JaxFlowMatching, "img2img", dict(cfg_scale=3.0)),
    (EDM, JaxEDM, "img2img", dict(strength=-1.0)),
    (EDM, JaxEDM, "img2img", dict(cfg_scale=3.0)),
    (DDIM, JaxDDIM, "invert", dict(eta=0.5)),
    (DDIM, JaxDDIM, "restart", dict(eta=0.5)),
    (DDIM, JaxDDIM, "restart", dict(restarts=-1)),
    (DDIM, JaxDDIM, "restart", dict(restart_interval=(300, 300))),
    (DDIM, JaxDDIM, "restart", dict(restart_interval=(0, 1000))),
    (DDIM, JaxDDIM, "restart", dict(restart_interval=(10, 15))),
    (DDIM, JaxDDIM, "restart", dict(cfg_scale=3.0)),
])
def test_editing_value_errors_match_jax(cls, jcls, method, kwargs):
    """Each ValueError of JAX's img2img, invert and sample_restart, with
    its message (an identity model: each error comes before a call)."""
    kwargs = dict(kwargs)
    init = {"eta": kwargs.pop("eta")} if "eta" in kwargs else {}
    if method == "restart":
        kwargs.setdefault("restart_interval", (1, 300))

    def call(process, lib, rng):
        model = lambda x, t, y=None: x  # noqa: E731
        mask = kwargs.get("mask")
        extra = dict(kwargs, **({"mask": lib.asarray(mask)} if mask is not None
                                else {}))
        if method == "img2img":
            return process.img2img(model, lib.asarray(IMG), rng, **extra)
        if method == "invert":
            return process.invert(model, lib.asarray(IMG))
        return process.sample_restart(model, IMG.shape, rng,
                                      init_noise=lib.asarray(IMG), **extra)

    with pytest.raises(ValueError) as ref:
        call(jcls(**init), jnp, jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as ours:
        call(cls(**init), torch, torch.Generator())
    assert str(ours.value) == str(ref.value)


def test_strength_0_returns_the_input():
    image = torch.from_numpy(image_and_mask(8)[0])
    for process in (DDPM(), DDIM(), FlowMatching(), EDM()):
        assert torch.equal(process.img2img(None, image, None, strength=0.0),
                           image)


# ------------------------------------------------------------------ PNG
def pillow_files(tmp_path, size=(16, 16)):
    """PNGs that Pillow writes (its own filters): gray, RGB, RGBA and gray
    + alpha, each of random content."""
    rng = np.random.default_rng(9)
    h, w = size
    files = {}
    for mode, channels in (("L", 1), ("RGB", 3), ("RGBA", 4), ("LA", 2)):
        data = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
        if mode != "L":  # smooth rows too, so Pillow picks other filters
            data[: h // 2] = np.cumsum(data[: h // 2] // 16, axis=1,
                                       dtype=np.uint8)
        image = Image.fromarray(data[..., 0] if channels == 1 else data)
        assert image.mode == mode
        files[mode] = tmp_path / f"{mode}.png"
        image.save(files[mode])
    return files


def test_read_png_equals_pillow(tmp_path):
    for mode, path in pillow_files(tmp_path, (13, 21)).items():
        ref = np.asarray(Image.open(path))
        ours = helpers.read_png(path)
        np.testing.assert_array_equal(ours, ref.reshape(ours.shape))
    image = np.random.default_rng(2).integers(0, 256, (5, 7, 3),
                                              dtype=np.uint8)
    helpers.write_png(tmp_path / "own.png", image)
    np.testing.assert_array_equal(helpers.read_png(tmp_path / "own.png"),
                                  image)


@pytest.mark.parametrize("size", [(16, 16), (12, 20)])
def test_image_and_mask_loaders_equal_jax(tmp_path, size):
    """At the model's size the port reads the file itself; at another
    size it resizes through Pillow as JAX does: equal bit for bit."""
    for mode, path in pillow_files(tmp_path).items():
        for channels in (1, 3):
            ref = jax_pipeline.load_image_for_model(path, size, channels)
            ours = helpers.load_image_for_model(path, size, channels)
            assert ours.dtype == ref.dtype == np.float32
            np.testing.assert_array_equal(ours, ref, err_msg=mode)
        ref = jax_pipeline.load_mask_for_model(path, size)
        ours = helpers.load_mask_for_model(path, size)
        np.testing.assert_array_equal(ours, ref, err_msg=mode)
        assert ours.shape == (1, *size, 1)


def test_loader_without_pillow_names_it(tmp_path, monkeypatch):
    path = pillow_files(tmp_path)["RGB"]
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    assert helpers.load_image_for_model(path, (16, 16), 3).shape == (
        1, 16, 16, 3)
    with pytest.raises(SystemExit, match="Pillow"):
        helpers.load_image_for_model(path, (8, 8), 3)
    with pytest.raises(SystemExit, match="Pillow"):
        helpers.load_mask_for_model(path, (8, 8))
