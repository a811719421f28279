"""SR3 super-resolution in the port against the JAX package's, on the CPU:
the conditioning (`utils/sr.py`), the doubled-channel UNet through the
factory and the weight bridge, a conditioned DDIM trajectory, one train
step, the trainer's grids, and the wiring of `sample --sr_source`,
`evaluate` and `tools/cascade.py`.

The same seeded numpy images, t, noise, initial noise and conditioning noise
(JAX's own draws, passed to the port) go to both sides. Bars,
max|port - jax| / max|jax|:

* `SRSpec` validation: the JAX messages, called with the same configs;
* `downsample`, `upsample` (bilinear and nearest, every pixel including the
  edges) and `make_condition`/`batch_condition`: 1e-6 absolute, against
  `jax.image.resize` and the JAX helpers (edge padding, `cycle`);
* the UNet forward on [x ; condition] (6 channels in, 3 out): 2e-4;
* a DDIM-10 trajectory conditioned on LR images: 5e-4;
* one SR train step's loss (`DiffusionTrainer.train_step`, JAX's
  `noise_aug` draw passed in): 2e-4.

The refusals are the JAX package's: SR on the VAE, with latent diffusion,
on the classifier; `--sr_source` without an SR checkpoint and an SR
checkpoint without it; `--deepcache` with either; the cascade's stage check
at 16 -> 32.
"""

import functools
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu import pipeline as jax_pipeline
from diffusion_models_collection_tpu.diffusion import DDIM as JaxDDIM
from diffusion_models_collection_tpu.diffusion import DDPM as JaxDDPM
from diffusion_models_collection_tpu.factory import get_model as jax_get_model
from diffusion_models_collection_tpu.utils import sr as jax_sr
from diffusion_models_collection_tpu_torch import (evaluate, factory,
                                                   pipeline, sample, train)
from diffusion_models_collection_tpu_torch.diffusion import DDIM, DDPM
from diffusion_models_collection_tpu_torch.tools import cascade
from diffusion_models_collection_tpu_torch.utils import checkpoint
from diffusion_models_collection_tpu_torch.utils import sr
from diffusion_models_collection_tpu_torch.utils.helpers import write_png
from diffusion_models_collection_tpu_torch.utils.trainer import (
    DiffusionTrainer,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    MODEL_PARAMS,
    max_rel,
    one_torch_thread,
    perturbed,
    small_config,
)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "data"
HW, LR = 16, 8
SR_BLOCK = {"factor": 2, "noise_aug": 0.1, "upsample": "bilinear"}


def sr_config(dropout=0.1, **changes):
    """The small UNet of `torch_port_helpers` as an unconditional SR stage
    at 16x16 from 8x8."""
    config = dict(small_config(conditional=False),
                  model_params=dict(MODEL_PARAMS, dropout=dropout),
                  super_resolution=dict(SR_BLOCK))
    config.update(changes)
    return config


@functools.lru_cache(maxsize=None)
def jax_sr_unet(dropout=0.1, seed=0):
    """(flax SR UNet from the JAX factory, perturbed params), init jitted."""
    model = jax_get_model(sr_config(dropout))
    params = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, HW, HW, 6)), jnp.zeros((1,), jnp.int32)))(
            jax.random.PRNGKey(seed))["params"]
    return model, perturbed(params, seed)


def port_sr_unet(params, config):
    model = factory.get_model(config)
    model.load_state_dict(state_dict_from_jax(params, config), strict=True)
    return model.eval()


def images(n=3, hw=HW, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, hw, hw, 3)).astype(np.float32)


def t_(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------- conditioning
@pytest.mark.parametrize("block", [
    True, {"factor": 1}, {}, {"factor": 2, "noise_aug": -0.1},
    {"factor": 2, "upsample": "bicubic"}, {"factor": 3},
])
def test_spec_validation_matches_jax(block):
    config = {"image_size": (HW, HW), "super_resolution": block}
    if block == {}:  # an empty block is no SR stage on both sides
        assert sr.SRSpec.from_config(config) is None
        assert jax_sr.SRSpec.from_config(config) is None
        return
    with pytest.raises(ValueError) as ours:
        sr.SRSpec.from_config(config)
    with pytest.raises(ValueError) as ref:
        jax_sr.SRSpec.from_config(config)
    assert str(ours.value) == str(ref.value)


def test_spec_reads_the_block():
    spec = sr.SRSpec.from_config(sr_config())
    assert spec == sr.SRSpec(2, 0.1, "bilinear")
    assert spec.lr_hw((HW, HW)) == (LR, LR)
    assert sr.SRSpec.from_config(small_config()) is None


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("src,dst", [((8, 8), (16, 16)), ((5, 3), (10, 12)),
                                     ((4, 6), (12, 18)), ((7, 7), (8, 9))])
def test_downsample_and_upsample_match_jax_at_every_pixel(method, src, dst):
    x = np.random.default_rng(1).uniform(-1, 1, (2, *src, 3)).astype(
        np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, *dst, 3), method=method)
    got = sr.upsample(t_(x), dst, method)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-6
    hr = images(2)
    np.testing.assert_allclose(sr.downsample(t_(hr), 2).numpy(),
                               jax_sr.downsample(jnp.asarray(hr), 2),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="must divide"):
        sr.downsample(t_(hr), 3)


@pytest.mark.parametrize("noise_aug", [0.0, 0.1])
def test_make_condition_matches_jax(noise_aug):
    spec = sr.SRSpec(2, noise_aug)
    jspec = jax_sr.SRSpec(2, noise_aug)
    hr, rng = images(3), jax.random.PRNGKey(3)
    noise = jax.random.normal(rng, (3, HW, HW, 3))
    for kw in ({"hr_images": hr}, {"lr_images": hr[:, ::2, ::2]}):
        ref = jax_sr.make_condition(
            jspec, (HW, HW), rng=rng,
            **{k: jnp.asarray(v) for k, v in kw.items()})
        got = sr.make_condition(spec, (HW, HW), noise=t_(noise),
                                **{k: t_(v) for k, v in kw.items()})
        assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-6
    with pytest.raises(ValueError, match="exactly one"):
        sr.make_condition(spec, (HW, HW))
    with pytest.raises(ValueError, match="LR conditioning images must be"):
        sr.make_condition(spec, (HW, HW), lr_images=t_(hr))
    if noise_aug:
        with pytest.raises(ValueError, match="requires a generator"):
            sr.make_condition(spec, (HW, HW), hr_images=t_(hr))
        gen = torch.Generator().manual_seed(5)
        got = sr.make_condition(spec, (HW, HW), hr_images=t_(hr),
                                generator=gen)
        want = torch.randn((3, HW, HW, 3),
                           generator=torch.Generator().manual_seed(5))
        clean = sr.make_condition(sr.SRSpec(2), (HW, HW), hr_images=t_(hr))
        torch.testing.assert_close(got, clean + noise_aug * want)


@pytest.mark.parametrize("source_is_hr,cycle,start,end", [
    (False, False, 0, 3), (False, False, 3, 5), (True, True, 4, 9),
    (True, False, 2, 5)])
def test_batch_condition_pads_and_cycles_as_jax(source_is_hr, cycle, start,
                                                end):
    spec, jspec = sr.SRSpec(2, 0.1), jax_sr.SRSpec(2, 0.1)
    source = images(5, HW if source_is_hr else LR, seed=2)
    rng = jax.random.PRNGKey(7)
    ref = jax_sr.batch_condition(jspec, (HW, HW), source, start, end, 4, rng,
                                 source_is_hr=source_is_hr, cycle=cycle)
    noise = jax.random.normal(jax.random.fold_in(rng, 17), ref.shape)
    got = sr.batch_condition(spec, (HW, HW), source, start, end, 4, None,
                             source_is_hr=source_is_hr, cycle=cycle,
                             noise=t_(noise))
    assert got.shape == ref.shape == (max(4, end - start), HW, HW, 3)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-6
    with pytest.raises(ValueError, match="is empty for a source"):
        sr.batch_condition(spec, (HW, HW), source, 6, 8, 4, None,
                           source_is_hr=source_is_hr, noise=t_(noise))
    with pytest.raises(ValueError, match="source is empty"):
        sr.batch_condition(spec, (HW, HW), source[:0], 0, 1, 4, None)


def test_wrap_model_fn_concatenates_on_channels_and_tiles_for_cfg():
    seen = []

    def model(x, t, y=None):
        seen.append(x)
        return x[..., :3] * 2 + x[..., 3:]

    def jax_model(x, t, y):
        return x[..., :3] * 2 + x[..., 3:]

    cond, x = images(2, seed=3), images(4, seed=4)
    fn = sr.wrap_model_fn(model, t_(cond))
    t = torch.zeros(4, dtype=torch.int64)
    got = fn(t_(x), t)
    ref = jax_sr.wrap_model_fn(jax.tree_util.Partial(jax_model),
                               jnp.asarray(cond))(jnp.asarray(x), t.numpy(),
                                                  None)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    assert seen[0].shape == (4, HW, HW, 6)
    np.testing.assert_array_equal(seen[0][2:, ..., 3:].numpy(), cond)
    with pytest.raises(ValueError, match="not a multiple of the "
                                         "conditioning batch"):
        fn(t_(x[:3]), t[:3])


# ------------------------------------------------------------ the model
def test_factory_doubles_the_input_channels_and_refuses_as_jax(tmp_path):
    model = factory.get_model(sr_config())
    assert model.in_channels == 6 and model.input_conv.in_channels == 6
    assert model.output[2].out_channels == 3
    vae = {"model_type": "vae", "image_size": (HW, HW),
           "model_params": {"in_channels": 3, "base_channels": 8,
                            "channel_mult": (1, 2), "latent_channels": 2},
           "super_resolution": SR_BLOCK}
    latent = sr_config(latent_diffusion=True, vae_checkpoint="none.pth")
    for config in (vae, latent):
        with pytest.raises(ValueError) as ours:
            factory.get_model(config)
        with pytest.raises(ValueError) as ref:
            jax_get_model(config)
        assert str(ours.value) == str(ref.value)


def test_forward_on_the_condition_matches_jax():
    model, params = jax_sr_unet()
    ours = port_sr_unet(params, sr_config())
    x, cond = images(3, seed=5), images(3, seed=6)
    t = np.array([0, 400, 999])
    ref = jax.jit(lambda p, *a: model.apply({"params": p}, *a))(
        params, jnp.concatenate([x, cond], -1), jnp.asarray(t, jnp.int32),
        None)
    with torch.no_grad():
        got = sr.wrap_model_fn(ours, t_(cond))(t_(x), t_(t))
    assert got.shape == (3, HW, HW, 3)
    assert max_rel(got.numpy(), ref) <= 2e-4


def test_ddim_10_trajectory_on_lr_images_matches_jax():
    model, params = jax_sr_unet()
    noise, lr = images(2, seed=7), images(2, LR, seed=8)
    rng = jax.random.PRNGKey(2)
    cond = jax_sr.make_condition(jax_sr.SRSpec(2, 0.1), (HW, HW),
                                 lr_images=jnp.asarray(lr), rng=rng)
    jfn = jax_sr.wrap_model_fn(jax.tree_util.Partial(
        lambda x, t, y: model.apply({"params": params}, x, t, y)), cond)
    ref = JaxDDIM(num_inference_steps=10).sample(
        jfn, noise.shape, jax.random.PRNGKey(0),
        init_noise=jnp.asarray(noise))
    ours_cond = sr.make_condition(
        sr.SRSpec(2, 0.1), (HW, HW), lr_images=t_(lr),
        noise=t_(jax.random.normal(rng, cond.shape)))
    ours = DDIM(num_inference_steps=10).sample(
        sr.wrap_model_fn(port_sr_unet(params, sr_config()), ours_cond),
        noise.shape, init_noise=t_(noise))
    assert np.isfinite(ours.numpy()).all()
    assert max_rel(ours.numpy(), ref) <= 5e-4


def test_train_step_loss_matches_jax():
    """The step conditions on its own batch, downsampled, with the
    `noise_aug` draw passed in (JAX's), without dropout."""
    model, params = jax_sr_unet(dropout=0.0)
    config = sr_config(dropout=0.0, learning_rate=1e-3, seed=0)
    hr = images(4, seed=9)
    rng = np.random.default_rng(10)
    t = rng.integers(0, 1000, 4)
    noise = rng.standard_normal(hr.shape).astype(np.float32)
    sr_noise = rng.standard_normal(hr.shape).astype(np.float32)
    # JAX's `make_condition` with its draw replaced by `sr_noise`
    jcond = (jax_sr.upsample(jax_sr.downsample(jnp.asarray(hr), 2), (HW, HW))
             + 0.1 * jnp.asarray(sr_noise))
    jfn = jax_sr.wrap_model_fn(jax.tree_util.Partial(
        lambda x, tt, y: model.apply({"params": params}, x, tt, y)), jcond)
    ref = jax.jit(lambda *a: JaxDDPM().p_losses(jfn, *a))(
        jnp.asarray(hr), jnp.asarray(t, jnp.int32), jnp.asarray(noise))
    trainer = DiffusionTrainer(port_sr_unet(params, config), DDPM(), [None],
                               config, "cpu")
    loss = trainer.train_step(t_(hr), torch.zeros(4, dtype=torch.int64),
                              t=t_(t), noise=t_(noise), sr_noise=t_(sr_noise))
    assert max_rel(loss.item(), float(ref)) <= 2e-4


def test_an_sr_step_draws_its_noise_after_the_others():
    """Without SR the generator's stream is what it was; with `noise_aug`
    the condition's noise is drawn after t and the noise."""
    for block, extra in ((None, False), (SR_BLOCK, True)):
        config = sr_config(learning_rate=1e-3, super_resolution=block)
        model = factory.get_model(config)
        trainer = DiffusionTrainer(model, DDPM(num_timesteps=10), [None],
                                   config, "cpu",
                                   generator=torch.Generator().manual_seed(3))
        seen = {}
        real = trainer.diffusion.p_losses

        def spy(model_fn, x, t, noise, **kw):
            seen.update(t=t, noise=noise)
            return real(model_fn, x, t, noise, **kw)

        trainer.diffusion.p_losses = spy
        trainer.train_step(t_(images(2)), torch.zeros(2, dtype=torch.int64))
        gen = torch.Generator().manual_seed(3)
        t = torch.randint(0, 10, (2,), generator=gen)
        noise = torch.randn((2, HW, HW, 3), generator=gen)
        assert torch.equal(seen["t"], t) and torch.equal(seen["noise"], noise)
        after = torch.randn((1,), generator=gen)
        nxt = torch.randn((1,), generator=trainer.generator)
        # SR drew one (2, 16, 16, 3) tensor more from the stream
        assert torch.equal(nxt, after) is not extra


def test_trainer_grids_condition_on_the_first_batch(tmp_path, capsys):
    config = dict(
        sr_config(), dataset="cifar10", data_root=str(FIXTURES),
        epochs=1, batch_size=64, num_workers=0, learning_rate=1e-3,
        use_ema=True, ema_decay=0.9, save_dir=str(tmp_path / "sr"),
        sample_dir=str(tmp_path / "sr_samples"), sample_start_epoch=1,
        sample_interval=1, num_samples=4, num_timesteps=20, seed=0)
    path = tmp_path / "sr.json"
    path.write_text(json.dumps(config))
    model = factory.get_model(config)
    early = DiffusionTrainer(model, DDPM(num_timesteps=20), [None], config,
                             "cpu")
    assert early.sample_images(1) is None
    assert "SR sample grid skipped" in capsys.readouterr().out
    trainer = train.main(["--config", str(path), "--device", "cpu"])
    assert trainer.global_step == 3
    for name in ("epoch_0001.png", "sr_condition.png"):
        assert (tmp_path / "sr_samples" / name).is_file(), name
    assert trainer.sr_cond_images.shape == (4, HW, HW, 3)
    samples = trainer.sample_images(2)
    assert samples.shape == (4, HW, HW, 3) and np.isfinite(samples).all()


def test_trainer_refuses_sr_with_latent_diffusion(tmp_path):
    vae_cfg = {"model_type": "vae", "image_size": (HW, HW),
               "model_params": {"in_channels": 3, "base_channels": 8,
                                "channel_mult": (1, 2), "latent_channels": 2,
                                "num_res_blocks": 1}}
    vae = tmp_path / "vae.pth"
    checkpoint.save_checkpoint(vae, factory.get_model(vae_cfg).state_dict(),
                               vae_cfg)
    config = sr_config(latent_diffusion=True, vae_checkpoint=str(vae))
    with pytest.raises(ValueError, match="pixel-space diffusion only"):
        DiffusionTrainer(factory.get_model(small_config(False)),
                         DDPM(num_timesteps=10), [None], config, "cpu")


# ----------------------------------------------------------- the CLIs
@pytest.fixture(scope="module")
def sr_ckpt(tmp_path_factory):
    """A `.pth` of the small SR UNet with the JAX weights, and an LR PNG."""
    tmp = tmp_path_factory.mktemp("sr")
    _, params = jax_sr_unet()
    config = sr_config()
    path = tmp / "sr.pth"
    checkpoint.save_checkpoint(path, port_sr_unet(params, config).state_dict(),
                               config)
    write_png(tmp / "lr.png", ((images(1, LR, seed=11)[0] + 1) * 127.5)
              .round().astype(np.uint8))
    return path, tmp / "lr.png"


def sample_argv(ckpt, out, *flags):
    return ["--checkpoint", str(ckpt), "--sampling_method", "ddim",
            "--num_inference_steps", "3", "--num_samples", "3",
            "--batch_size", "2", "--device", "cpu", "--output_dir",
            str(out), *flags]


def test_sample_cli_super_resolves_a_png(sr_ckpt, tmp_path, capsys):
    ckpt, png = sr_ckpt
    out = sample.main(sample_argv(ckpt, tmp_path, "--sr_source", str(png)))
    assert out["samples"].shape == (3, HW, HW, 3)
    assert np.isfinite(out["samples"]).all()
    assert ("Super-resolving 3 conditioning images (8, 8) -> (16, 16) "
            "(factor 2)") in capsys.readouterr().out
    # a directory of images, cycled, and the JAX loader's array
    src = tmp_path / "lr_dir"
    src.mkdir()
    (src / "a.png").write_bytes(png.read_bytes())
    ours = pipeline.load_sr_sources(src, (LR, LR), 3, 3)
    ref = jax_pipeline.load_sr_sources(src, (LR, LR), 3, 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["no_source", "no_sr", "missing",
                                  "empty_dir"])
def test_build_sr_exits_as_jax(sr_ckpt, tmp_path, case):
    _, png = sr_ckpt
    config, source = sr_config(), str(png)
    if case == "no_source":
        source = None
    elif case == "no_sr":
        config = small_config(False)
    elif case == "missing":
        source = str(tmp_path / "none.png")
    else:
        (tmp_path / "empty").mkdir()
        source = str(tmp_path / "empty")
    args = SimpleNamespace(sr_source=source, num_samples=2)
    with pytest.raises(SystemExit) as ref:
        jax_pipeline._build_sr(args, config, 3)
    with pytest.raises(SystemExit) as ours:
        pipeline.build_sr(args, config, 3)
    assert str(ours.value) == str(ref.value)


def test_deepcache_refuses_super_resolution(sr_ckpt, tmp_path):
    ckpt, png = sr_ckpt
    with pytest.raises(SystemExit, match="--deepcache does not compose with "
                                         "super-resolution"):
        sample.main(sample_argv(ckpt, tmp_path, "--sr_source", str(png),
                                "--deepcache", "2"))
    with pytest.raises(SystemExit, match="--deepcache does not compose with "
                                         "super-resolution checkpoints"):
        evaluate.main(["--checkpoint", str(ckpt), "--config",
                       eval_config(ckpt, tmp_path), "--deepcache", "2",
                       "--sampling_method", "ddim", "--num_samples", "2",
                       "--device", "cpu", "--output",
                       str(tmp_path / "m.json")])


def eval_config(ckpt, tmp_path):
    """The checkpoint's config on the committed CIFAR-10 fixtures."""
    config = dict(torch.load(ckpt, weights_only=True)["config"],
                  dataset="cifar10", data_root=str(FIXTURES))
    path = tmp_path / "sr_eval.json"
    path.write_text(json.dumps(config))
    return str(path)


def test_evaluate_conditions_on_the_real_images(sr_ckpt, tmp_path,
                                                monkeypatch):
    """Each batch conditions on the real images, downsampled, cycled over
    the eval set; the metric stages are stubbed (their own tests hold
    them)."""
    ckpt, _ = sr_ckpt
    cfg_path = eval_config(ckpt, tmp_path)
    calls = []
    real = sr.batch_condition

    def spy(*args, **kw):
        calls.append((args[3:6], kw["source_is_hr"], kw["cycle"],
                      len(args[2])))
        return real(*args, **kw)

    monkeypatch.setattr(sr, "batch_condition", spy)
    monkeypatch.setattr(evaluate, "calculate_all_metrics",
                        lambda *a, **k: {"fid": 0.0})
    report = evaluate.main(["--checkpoint", str(ckpt), "--config",
                            cfg_path, "--sampling_method", "ddim",
                            "--num_inference_steps", "2", "--num_samples",
                            "5", "--batch_size", "3", "--no_swd",
                            "--device", "cpu", "--output",
                            str(tmp_path / "m.json")])
    assert report == {"fid": 0.0}
    assert calls == [((0, 3, 3), True, True, 5), ((3, 5, 3), True, True, 5)]


def save_unet(path, config):
    torch.manual_seed(0)
    checkpoint.save_checkpoint(path, factory.get_model(config).state_dict(),
                               config)
    return path


def test_cascade_checks_each_stage_and_runs_16_to_32(tmp_path):
    base = save_unet(tmp_path / "base.pth", small_config())
    up = dict(sr_config(), image_size=(32, 32),
              model_params=dict(MODEL_PARAMS, image_size=(32, 32)))
    good = save_unet(tmp_path / "sr32.pth", up)
    argv = ["--base_checkpoint", str(base), "--num_samples", "3",
            "--batch_size", "2", "--num_inference_steps", "3",
            "--sr_num_inference_steps", "3", "--cfg_scale", "2",
            "--labels", "1,4", "--device", "cpu", "--output_dir",
            str(tmp_path / "out")]
    outs = cascade.main(argv + ["--sr_checkpoint", str(good)])
    assert [o.shape for o in outs] == [(3, 16, 16, 3), (3, 32, 32, 3)]
    for name in ("cascade_stage0.png", "cascade_stage1.png", "cascade.png"):
        assert (tmp_path / "out" / name).is_file(), name
    bad = save_unet(tmp_path / "sr32x4.pth",
                    dict(up, super_resolution={"factor": 4}))
    with pytest.raises(SystemExit, match=r"SR stage 1 expects LR \(8, 8\) "
                                         r"but the previous stage produces "
                                         r"\(16, 16\)"):
        cascade.main(argv + ["--sr_checkpoint", str(bad)])
    with pytest.raises(SystemExit, match="has no super_resolution"):
        cascade.main(argv + ["--sr_checkpoint", str(base)])
    with pytest.raises(SystemExit, match="must be a from-noise checkpoint"):
        cascade.main(["--base_checkpoint", str(good), "--sr_checkpoint",
                      str(good), "--device", "cpu"])
    with pytest.raises(SystemExit, match=r"label 12 out of range \[0, 10\)"):
        cascade.main(argv + ["--sr_checkpoint", str(good), "--labels", "12"])
