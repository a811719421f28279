"""Latent diffusion in the PyTorch port against the JAX package's, on the
CPU: the codec (`utils/latent.py`), the factory's latent geometry, a latent
DDIM trajectory with CFG and its decode, one latent train step, and the
entry points end to end (`train` for both stages, `sample`, `evaluate`,
`serve`, `tools/compute_latent_scale`).

* The codec: one JAX-format VAE checkpoint, written by the JAX package's
  `save_checkpoint` with EMA weights beside the model's, loads in both
  packages; `encode` (JAX's posterior draw passed to the port), `encode_mode`,
  `decode` and `decode_trajectory` agree at max-rel 2e-4. Its gates: a
  checkpoint that is not a VAE, no `vae_checkpoint`, a scale <= 0, and the
  missing `.ckpt` with a `.pth` of the same stem beside it.
* The factory: the denoiser's size and channels are the VAE's latent ones,
  a conflicting `in_channels` raises, and so do super-resolution with latent
  diffusion and on the VAE; `clip_sample` is false under latent.
* A DDIM-10 CFG-3 trajectory of a tiny latent UNet from passed-in noise,
  decoded, at 5e-4; the port's bridge reads the JAX UNet at the latent size.
* Two latent train steps (the encoder noise JAX's `_encode_impl` draws,
  passed to the port) against the JAX trainer's pieces: loss, params and
  EMA at 2e-4. The trainer's random stream: a pixel-space step draws t, the
  noise and the CFG mask in that order, as before latent diffusion came; a
  latent step draws the same three at the latent shape and then the
  encoder's noise.
* The CLIs on the committed CIFAR-10 fixtures at 8x8 (4x4x2 latents), each
  with `--device cpu`: pixel outputs of the right shape, finite.
"""

import functools
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_models_collection_tpu.diffusion import ddpm as jax_ddpm
from diffusion_models_collection_tpu.diffusion.ddim import DDIM as JaxDDIM
from diffusion_models_collection_tpu.models import UNet as JaxUNet
from diffusion_models_collection_tpu.models.vae import VAE as JaxVAE
from diffusion_models_collection_tpu.utils import (
    checkpoint as jax_ckpt,
)
from diffusion_models_collection_tpu.utils.ema import gated_ema_update
from diffusion_models_collection_tpu.utils.latent import (
    LatentCodec as JaxCodec,
)
from diffusion_models_collection_tpu.utils.trainer import (
    build_optimizer as jax_build_optimizer,
)
from diffusion_models_collection_tpu_torch import (
    evaluate,
    factory,
    sample,
    serve,
    train,
)
from diffusion_models_collection_tpu_torch.diffusion import DDPM
from diffusion_models_collection_tpu_torch.tools import compute_latent_scale
from diffusion_models_collection_tpu_torch.utils import checkpoint
from diffusion_models_collection_tpu_torch.utils.helpers import write_png
from diffusion_models_collection_tpu_torch.utils.latent import LatentCodec
from diffusion_models_collection_tpu_torch.utils.trainer import (
    DiffusionTrainer,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from test_torch_port_serve import Server
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    max_rel,
    one_torch_thread,
    perturbed,
)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "data"
HW, LHW, LC = 8, 4, 2  # pixels 8x8x3, latents 4x4x2
SCALE = 0.7
VAE_PARAMS = dict(in_channels=3, base_channels=8, channel_mult=(1, 2),
                  latent_channels=LC, num_res_blocks=1, use_attention=True)
UNET_PARAMS = dict(model_channels=32, num_res_blocks=1,
                   attention_resolutions=(2,), dropout=0.0,
                   channel_mult=(1, 2), use_attention=True)


def vae_config():
    return {"model_type": "vae", "image_size": HW, "conditional": False,
            "model_params": dict(VAE_PARAMS, dropout=0.0),
            "mixed_precision": "none"}


@pytest.fixture(scope="module")
def vae_ckpt(tmp_path_factory):
    """A JAX-format VAE checkpoint (the JAX package's `save_checkpoint`)
    whose EMA weights differ from its model weights; returns its path."""
    model = JaxVAE(image_size=(HW, HW), **VAE_PARAMS)
    params = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, HW, HW, 3)), jnp.zeros((1, LHW, LHW, LC))))(
            jax.random.PRNGKey(0))["params"]  # jitted: eager init is slower
    path = tmp_path_factory.mktemp("vae") / "best_model.ckpt"
    jax_ckpt.save_checkpoint(
        path, epoch=3, params=perturbed(params, 1),
        opt_state=optax.adamw(1e-4).init(params), best_loss=0.1,
        config=vae_config(), ema_params=perturbed(params, 2))
    return path


def latent_config(vae_path, **changes):
    config = {"model_type": "unet", "model_params": dict(UNET_PARAMS),
              "latent_diffusion": True, "vae_checkpoint": str(vae_path),
              "latent_scale_factor": SCALE, "image_size": HW,
              "conditional": True, "num_classes": 10, "num_timesteps": 1000,
              "beta_start": 0.0001, "beta_end": 0.02,
              "beta_schedule": "linear", "num_inference_steps": 10,
              "ddim_eta": 0.0, "mixed_precision": "none"}
    config.update(changes)
    return config


def pixels(seed, n=3):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, HW, HW, 3)).astype(np.float32)


# ---------------------------------------------------------------- codec
def test_codec_matches_jax_on_a_jax_checkpoint(vae_ckpt):
    jc = JaxCodec(vae_ckpt, scale_factor=SCALE)
    pc = LatentCodec(vae_ckpt, scale_factor=SCALE, device="cpu")
    assert (pc.latent_hw(), pc.latent_channels, pc.in_channels) == (
        (LHW, LHW), LC, 3)
    assert pc.latent_shape(5) == jc.latent_shape(5) == (5, LHW, LHW, LC)
    x = pixels(1)
    rng = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(rng, (3, LHW, LHW, LC),
                                         jnp.float32))
    xt = torch.from_numpy(x)
    enc = pc.encode(xt, noise=torch.from_numpy(noise))
    assert max_rel(enc, jc.encode(jnp.asarray(x), rng)) <= 2e-4
    mode = pc.encode_mode(xt)
    assert max_rel(mode, jc.encode_mode(jnp.asarray(x))) <= 2e-4
    assert not torch.equal(enc, mode)
    z = np.random.default_rng(2).standard_normal(
        (2, 3, LHW, LHW, LC)).astype(np.float32)
    dec = pc.decode(torch.from_numpy(z[0]))
    assert dec.shape == (3, HW, HW, 3)
    assert max_rel(dec, jc.decode(jnp.asarray(z[0]))) <= 2e-4
    traj = pc.decode_trajectory(torch.from_numpy(z))
    assert traj.shape == (2, 3, HW, HW, 3) and traj.device.type == "cpu"
    assert max_rel(traj, jc.decode_trajectory(jnp.asarray(z))) <= 2e-4
    # the codec is frozen and prefers the EMA weights
    assert not any(p.requires_grad for p in pc.model.parameters())
    ema = checkpoint.load_checkpoint(vae_ckpt)["ema_model_state_dict"]
    torch.testing.assert_close(pc.model.state_dict()["encoder.conv_in.weight"],
                               ema["encoder.conv_in.weight"])
    # one load per process, file and device
    assert LatentCodec(vae_ckpt, device="cpu").model is pc.model


def test_codec_gates(vae_ckpt, tmp_path, capsys):
    assert LatentCodec.from_config({"model_type": "unet"},
                                   device="cpu") is None
    with pytest.raises(ValueError, match="vae_checkpoint"):
        LatentCodec.from_config({"latent_diffusion": True}, device="cpu")
    for scale in (0.0, -1.0):
        with pytest.raises(ValueError, match="must be positive"):
            LatentCodec(vae_ckpt, scale, device="cpu")
    unet = tmp_path / "unet.pth"
    config = latent_config(vae_ckpt, latent_diffusion=False,
                           model_params=dict(UNET_PARAMS, in_channels=3,
                                             out_channels=3))
    checkpoint.save_checkpoint(unet, factory.get_model(config).state_dict(),
                               config)
    with pytest.raises(ValueError, match="is not a VAE checkpoint"):
        LatentCodec(unet, device="cpu")
    # the JAX config names best_model.ckpt; the port's trainers write .pth,
    # which is read in its place
    want = LatentCodec(vae_ckpt, device="cpu").model
    checkpoint.save_checkpoint(tmp_path / "best_model.pth", want.state_dict(),
                               vae_config())
    capsys.readouterr()
    got = LatentCodec(tmp_path / "best_model.ckpt", device="cpu").model
    assert "best_model.pth" in capsys.readouterr().out
    for a, b in zip(got.state_dict().values(), want.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        LatentCodec(tmp_path / "none.ckpt", device="cpu")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        LatentCodec(tmp_path / "none.pth", device="cpu")


def test_factory_reads_the_latent_geometry(vae_ckpt):
    model = factory.get_model(latent_config(vae_ckpt))
    assert (model.image_size, model.in_channels) == ((LHW, LHW), LC)
    assert model.output[2].out_channels == LC
    assert factory.get_model(latent_config(
        vae_ckpt, model_params=dict(UNET_PARAMS, in_channels=LC)))
    with pytest.raises(ValueError, match="conflicts with the VAE's"):
        factory.get_model(latent_config(
            vae_ckpt, model_params=dict(UNET_PARAMS, in_channels=3)))
    with pytest.raises(ValueError, match="pixel-space diffusion only"):
        factory.get_model(latent_config(vae_ckpt,
                                        super_resolution={"factor": 2}))
    with pytest.raises(ValueError, match="not the VAE stage"):
        factory.get_model(dict(vae_config(), super_resolution={"factor": 2}))
    dit = factory.get_model(latent_config(
        vae_ckpt, model_type="dit",
        model_params=dict(patch_size=2, hidden_size=32, depth=1,
                          num_heads=2)))
    assert dit.in_channels == LC and dit.out_channels == LC
    # dynamic thresholding would corrupt latents
    for method in ("ddpm", "ddim"):
        assert not factory.get_diffusion(latent_config(vae_ckpt),
                                         method).clip_sample
        assert factory.get_diffusion(
            latent_config(vae_ckpt, latent_diffusion=False),
            method).clip_sample


# ------------------------------------------------------------ sampling
@functools.lru_cache(maxsize=None)
def jax_latent_unet():
    """(flax UNet at the latent size, perturbed params as numpy)."""
    model = JaxUNet(image_size=(LHW, LHW), in_channels=LC, out_channels=LC,
                    num_classes=10, **UNET_PARAMS)
    params = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, LHW, LHW, LC)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1,), jnp.int32)))(jax.random.PRNGKey(3))["params"]
    return model, perturbed(params, 3)


def port_latent_unet(vae_ckpt, **changes):
    config = latent_config(vae_ckpt, **changes)
    _, params = jax_latent_unet()
    model = factory.get_model(config)
    model.load_state_dict(state_dict_from_jax(params, config), strict=True)
    return model.eval(), config


def test_latent_ddim_cfg_trajectory_decoded_matches_jax(vae_ckpt):
    jmodel, params = jax_latent_unet()
    model, config = port_latent_unet(vae_ckpt)
    noise = np.random.default_rng(4).standard_normal(
        (4, LHW, LHW, LC)).astype(np.float32)
    y = np.array([1, 4, 7, 10])
    jddim = JaxDDIM(num_timesteps=1000, num_inference_steps=10,
                    clip_sample=False)
    jlat = jddim.sample_with_cfg(
        lambda x, t, yy: jmodel.apply({"params": params}, x, t, yy),
        noise.shape, jnp.asarray(y, jnp.int32), jax.random.PRNGKey(0),
        cfg_scale=3.0, init_noise=jnp.asarray(noise))
    ref = np.asarray(JaxCodec(vae_ckpt, SCALE).decode(jlat))
    ddim = factory.get_diffusion(config, "ddim")
    with torch.no_grad():
        lat = ddim.sample_with_cfg(model, noise.shape, torch.from_numpy(y),
                                   cfg_scale=3.0,
                                   init_noise=torch.from_numpy(noise))
        ours = LatentCodec.from_config(config, device="cpu").decode(lat)
    assert ours.shape == (4, HW, HW, 3)
    assert max_rel(lat, jlat) <= 5e-4
    assert max_rel(ours, ref) <= 5e-4


# ------------------------------------------------------------ training
def train_config(vae_ckpt, tmp_path):
    return latent_config(
        vae_ckpt, optimizer="adamw", learning_rate=1e-3, weight_decay=1e-4,
        use_scheduler=True, scheduler_type="warmup_cosine", epochs=4,
        warmup_epochs=2, warmup_start_factor=0.1, use_ema=True,
        ema_decay=0.9, cfg_dropout_prob=0.2, loss_type="l2", batch_size=3,
        save_dir=str(tmp_path / "ckpt"), sample_dir=str(tmp_path / "s"),
        seed=0)


def step_inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(
        x=pixels(seed), labels=rng.integers(0, 10, 3).astype(np.int64),
        t=rng.integers(0, 1000, 3).astype(np.int64),
        noise=rng.standard_normal((3, LHW, LHW, LC)).astype(np.float32),
        drop=rng.uniform(size=3) < 0.3, enc_rng=jax.random.PRNGKey(seed))


def test_two_latent_train_steps_match_the_jax_pieces(vae_ckpt, tmp_path):
    jmodel, params = jax_latent_unet()
    config = train_config(vae_ckpt, tmp_path)
    jcodec = JaxCodec(vae_ckpt, SCALE)
    ddpm = jax_ddpm.DDPM(num_timesteps=1000)
    tx, _, _ = jax_build_optimizer(config, 1)

    @jax.jit
    def step(p, opt_state, ema, x, enc_rng, t, noise, y):
        z = jcodec._encode_impl(x, enc_rng)  # the JAX train step's encode
        loss, grads = jax.value_and_grad(lambda pp: ddpm.p_losses(
            lambda xx, tt, yy: jmodel.apply({"params": pp}, xx, tt, yy),
            z, t, noise, y=y))(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        return p, opt_state, gated_ema_update(
            tx, opt_state, ema, p, config["ema_decay"]), loss

    batches = [step_inputs(s) for s in (10, 11)]
    p_j = ema_j = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(p_j)
    refs = []
    for b in batches:
        y = np.where(b["drop"], 0, b["labels"] + 1).astype(np.int32)
        p_j, opt_state, ema_j, loss = step(
            p_j, opt_state, ema_j, b["x"], b["enc_rng"],
            b["t"].astype(np.int32), b["noise"], y)
        refs.append(float(loss))

    model, _ = port_latent_unet(vae_ckpt)
    trainer = DiffusionTrainer(model, DDPM(num_timesteps=1000), [None],
                               config, "cpu")
    assert (trainer.image_size, trainer.in_channels) == ((LHW, LHW), LC)
    losses = []
    for b in batches:
        # what `_encode_impl` draws from the step's encoder key
        enc = np.asarray(jax.random.normal(b["enc_rng"], (3, LHW, LHW, LC),
                                           jnp.float32))
        losses.append(trainer.train_step(
            torch.from_numpy(b["x"]), torch.from_numpy(b["labels"]),
            torch.from_numpy(b["t"]), torch.from_numpy(b["noise"]),
            torch.from_numpy(b["drop"]), torch.from_numpy(enc)).item())
    assert max_rel(losses, refs) <= 2e-4
    for what, got, ref in (
            ("params", trainer.model.state_dict(),
             state_dict_from_jax(p_j, config)),
            ("ema", trainer.ema_model.state_dict(),
             state_dict_from_jax(ema_j, config))):
        for name, want in ref.items():
            assert max_rel(got[name], want) <= 2e-4, (what, name)
    # no gradient reached the frozen VAE
    assert not any(p.requires_grad or p.grad is not None
                   for p in trainer.latent.model.parameters())


@pytest.mark.parametrize("latent", [False, True])
def test_the_trainer_draws_in_its_order(vae_ckpt, tmp_path, monkeypatch,
                                        latent):
    """t, the noise and the CFG mask, in that order, from the trainer's
    generator (a pixel-space run's stream as before latent diffusion
    came); under latent at the latent shape, then the encoder's noise."""
    config = train_config(vae_ckpt, tmp_path)
    if not latent:
        config = dict(config, latent_diffusion=False,
                      model_params=dict(UNET_PARAMS, in_channels=3,
                                        out_channels=3))
    seen = {}
    real_p_losses = DDPM.p_losses

    def spy(self, model_fn, x_start, t, noise, y=None, loss_type="l2"):
        seen.update(x_start=x_start, t=t, noise=noise, y=y)
        return real_p_losses(self, model_fn, x_start, t, noise, y=y,
                             loss_type=loss_type)

    monkeypatch.setattr(DDPM, "p_losses", spy)
    trainer = DiffusionTrainer(factory.get_model(config),
                               DDPM(num_timesteps=1000), [None], config,
                               "cpu", generator=torch.Generator().manual_seed(5))
    b = step_inputs(12)
    x, labels = torch.from_numpy(b["x"]), torch.from_numpy(b["labels"])
    trainer.train_step(x, labels)
    gen = torch.Generator().manual_seed(5)
    shape = (3, LHW, LHW, LC) if latent else (3, HW, HW, 3)
    t = torch.randint(0, 1000, (3,), generator=gen)
    noise = torch.randn(shape, generator=gen)
    drop = torch.rand(3, generator=gen) < 0.2
    torch.testing.assert_close(seen["t"], t, rtol=0, atol=0)
    torch.testing.assert_close(seen["noise"], noise, rtol=0, atol=0)
    torch.testing.assert_close(seen["y"], torch.where(drop, 0, labels + 1),
                               rtol=0, atol=0)
    want = (trainer.latent.encode(x, noise=torch.randn(shape, generator=gen))
            if latent else x)
    torch.testing.assert_close(seen["x_start"], want, rtol=0, atol=0)


# ------------------------------------------------------------ the CLIs
def write_config(path, config):
    path.write_text(json.dumps(config))
    return str(path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both stages trained by the port's `train` on the fixtures at 8x8: a
    VAE (two epochs), then a conditional latent UNet (two epochs, T 50)
    whose config names the VAE's `.pth`; returns (tmp dir, latent config,
    its checkpoint)."""
    tmp = tmp_path_factory.mktemp("stages")
    common = dict(dataset="cifar10", data_root=str(FIXTURES), image_size=HW,
                  epochs=2, batch_size=64, num_workers=0, optimizer="adamw",
                  learning_rate=1e-3, weight_decay=1e-4, use_ema=True,
                  ema_decay=0.9, use_scheduler=False, save_interval=100,
                  sample_start_epoch=2, sample_interval=2, num_samples=4,
                  seed=42)
    vae = dict(vae_config(), kl_weight=1e-4, save_dir=str(tmp / "vae"),
               sample_dir=str(tmp / "vae_samples"), **common)
    trainer = train.main(["--config", write_config(tmp / "vae.json", vae),
                          "--device", "cpu"])
    assert trainer.global_step == 6
    assert (tmp / "vae_samples" / "vae_epoch_0002.png").is_file()
    config = latent_config(
        tmp / "vae" / "best_model.pth", num_timesteps=50, cfg_scale=2.0,
        cfg_dropout_prob=0.2, loss_type="l2", save_dir=str(tmp / "latent"),
        sample_dir=str(tmp / "latent_samples"), **common)
    trainer = train.main(["--config",
                          write_config(tmp / "latent.json", config),
                          "--device", "cpu"])
    assert trainer.global_step == 6
    assert (tmp / "latent_samples" / "epoch_0002.png").is_file()
    return tmp, config, tmp / "latent" / "current_model.pth"


def run_sample(ckpt, out, *flags):
    return sample.main([
        "--checkpoint", str(ckpt), "--sampling_method", "ddim",
        "--num_inference_steps", "4", "--num_samples", "5", "--batch_size",
        "4", "--cfg_scale", "2", "--use_ema", "--device", "cpu",
        "--output_dir", str(out), *flags])["samples"]


def test_sample_cli_decodes_latents(trained):
    tmp, _, ckpt = trained
    samples = run_sample(ckpt, tmp / "plain")
    assert samples.shape == (5, HW, HW, 3) and np.isfinite(samples).all()
    assert (tmp / "plain" / "samples.png").is_file()
    again = run_sample(ckpt, tmp / "inter", "--save_intermediate")
    np.testing.assert_allclose(again, samples, rtol=0, atol=1e-6)
    steps = np.load(tmp / "inter" / "intermediate" / "steps.npy")
    assert steps.shape == (4, 5, HW, HW, 3)
    np.testing.assert_allclose(steps[-1], samples, rtol=0, atol=1e-6)


def test_sample_cli_img2img_encodes_and_mask_raises(trained):
    tmp, _, ckpt = trained
    image = (pixels(20, 1)[0] * 127.5 + 127.5).round().astype(np.uint8)
    write_png(tmp / "init.png", image)
    write_png(tmp / "mask.png", np.full((HW, HW), 255, np.uint8))
    out = run_sample(ckpt, tmp / "img2img", "--init_image",
                     str(tmp / "init.png"), "--strength", "0.5")
    assert out.shape == (5, HW, HW, 3) and np.isfinite(out).all()
    with pytest.raises(SystemExit, match="--mask is not supported with "
                                         "latent-diffusion checkpoints"):
        run_sample(ckpt, tmp / "mask", "--init_image", str(tmp / "init.png"),
                   "--mask", str(tmp / "mask.png"))


def test_evaluate_cli_decodes_latents(trained):
    tmp, _, ckpt = trained
    report = evaluate.main([
        "--checkpoint", str(ckpt), "--use_ema", "--sampling_method", "ddim",
        "--num_inference_steps", "3", "--cfg_scale", "2", "--num_samples",
        "8", "--batch_size", "8", "--device", "cpu", "--swd",
        "--save_images_dir", str(tmp / "eval_images"),
        "--output", str(tmp / "eval.json")])
    assert np.isfinite(report["swd_avg"])
    assert len(list((tmp / "eval_images" / "generate").glob(
        "generate_*.png"))) == 8


@pytest.mark.parametrize("continuous", [False, True])
def test_serve_decodes_each_request(trained, continuous):
    _, _, ckpt = trained
    service = serve.SamplerService(str(ckpt), sampling_method="ddim",
                                   num_inference_steps=4, batch_size=4,
                                   continuous=continuous, device="cpu")
    server = Server(service)
    try:
        status, _, data = server.request("GET", "/healthz")
        assert status == 200 and json.loads(data)["image_size"] == [HW, HW]
        status, _, data = server.request(
            "POST", "/generate", {"num_samples": 3, "labels": [1, 2, 3],
                                  "seed": 7, "cfg_scale": 2.0,
                                  "format": "npy"})
        assert status == 200
        images = np.load(io.BytesIO(data))
        y = torch.tensor([2, 3, 4])
        with torch.no_grad():
            if continuous:  # the request's own draw, its k rows
                noise = service.initial_noise((3, LHW, LHW, LC), 7)
                lat = service.diffusion.sample_with_cfg(
                    service.model, noise.shape, y, cfg_scale=2.0,
                    init_noise=noise)
            else:  # the serving batch's draw, padded with null labels
                lat = service.diffusion.sample_with_cfg(
                    service.model, (4, LHW, LHW, LC),
                    torch.cat([y, torch.zeros(1, dtype=y.dtype)]),
                    torch.Generator().manual_seed(7), cfg_scale=2.0)[:3]
            ref = service.codec.decode(lat).numpy()
        ref = np.clip((ref + 1) / 2, 0, 1)
        assert images.shape == (3, HW, HW, 3)
        np.testing.assert_allclose(images, ref, rtol=0,
                                   atol=1e-5 if continuous else 0)
    finally:
        server.close()


def test_serve_answers_a_decode_failure_with_500(trained, monkeypatch):
    _, _, ckpt = trained
    service = serve.SamplerService(str(ckpt), sampling_method="ddim",
                                   num_inference_steps=2, batch_size=2,
                                   continuous=True, device="cpu")
    server = Server(service)
    try:
        def broken(z):
            raise ValueError("no decode")
        monkeypatch.setattr(service.codec, "decode", broken)
        status, _, data = server.request(
            "POST", "/generate", {"num_samples": 1, "format": "npy"})
        assert status == 500 and b"no decode" in data
    finally:
        server.close()


def test_compute_latent_scale(trained):
    tmp, config, _ = trained
    out = compute_latent_scale.main([
        "--config", write_config(tmp / "scale.json", config),
        "--batches", "2", "--device", "cpu"])
    assert out["batches"] == 2 and out["elements"] == 2 * 64 * LHW * LHW * LC
    assert np.isfinite(out["latent_std"]) and out["latent_scale_factor"] > 0
    assert out["latent_scale_factor"] == pytest.approx(
        1 / out["latent_std"], rel=1e-4)
