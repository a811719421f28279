"""The PyTorch port's entry point, `python -m
diffusion_models_collection_tpu_torch.sample`, on the CPU.

The end-to-end test writes a JAX `.ckpt` with the JAX package's
`save_checkpoint` (optax state included), samples from it in a fresh
`python -X importtime -m ...` process, and asserts the outputs and, from
the import log, that the process never imported jax, flax or optax. The
flag tests hold the port's parser to the root `sample.py`'s: the default
sampler and the two classifier-free-guidance knobs, which must reach
`base.cfg_eps_x0`, and the editing and training-free knobs (img2img,
inpainting, RePaint, restarts, PAG, DeepCache, FreeU): their defaults, the
JAX pipeline's SystemExit rules with their messages, and one CPU run of
each flag family.
"""

import argparse
import ast
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from diffusion_models_collection_tpu import factory as jax_factory
from diffusion_models_collection_tpu import pipeline as jax_pipeline
from diffusion_models_collection_tpu.pipeline import (
    _apply_steps_and_precision as jax_apply_steps_and_precision,
)
from diffusion_models_collection_tpu.pipeline import (
    build_labels as jax_build_labels,
)
from diffusion_models_collection_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from diffusion_models_collection_tpu_torch import factory, pipeline, sample
from diffusion_models_collection_tpu_torch.diffusion import (
    DDIM,
    ConsistencyModel,
    base,
)
from diffusion_models_collection_tpu_torch.pipeline import (
    apply_steps_and_precision,
    build_labels,
)
from diffusion_models_collection_tpu_torch.utils import checkpoint
from diffusion_models_collection_tpu_torch.utils.helpers import (
    make_grid,
    write_png,
)
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    jax_unet,
    one_torch_thread,
    small_config,
    small_dit_config,
)

REPO = Path(__file__).resolve().parent.parent

FORBIDDEN = ("jax", "jaxlib", "flax", "optax")


def imported_modules(importtime_log: str):
    """Module names from `python -X importtime` output: every module the
    process imported, one line each."""
    names = []
    for line in importtime_log.splitlines():
        if line.startswith("import time:") and "|" in line:
            name = line.rsplit("|", 1)[1].strip()
            if name != "imported package":
                names.append(name)
    return names


def test_sample_cli_from_jax_checkpoint_without_jax(tmp_path):
    _, params, config = jax_unet(conditional=True, seed=6)
    ckpt = tmp_path / "current_model.ckpt"
    opt_state = optax.adamw(1e-4).init(
        jax.tree_util.tree_map(jnp.asarray, params))
    jax_save_checkpoint(ckpt, epoch=1, params=params, opt_state=opt_state,
                        best_loss=1.0, config=config, ema_params=params)
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "diffusion_models_collection_tpu_torch.sample", "--checkpoint", str(ckpt),
         "--sampling_method", "ddim", "--num_inference_steps", "3",
         "--num_samples", "5", "--batch_size", "2", "--cfg_scale", "3",
         "--labels", "1,7", "--use_ema", "--device", "cpu",
         "--output_dir", str(out), "--output_name", "grid.png"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    modules = imported_modules(proc.stderr)
    assert "diffusion_models_collection_tpu_torch.pipeline" in modules
    assert not [m for m in modules if m.split(".")[0] in FORBIDDEN]
    assert "Using EMA model" in proc.stdout
    samples = np.load(out / "grid.npy")
    assert samples.shape == (5, 16, 16, 3) and samples.dtype == np.float32
    assert np.isfinite(samples).all()
    assert 0.0 <= samples.min() and samples.max() <= 1.0
    grid = np.asarray(Image.open(out / "grid.png"))
    assert grid.shape == (3 * 16 + 4 * 2, 2 * 16 + 3 * 2, 3)  # 3 rows of 2


def test_sample_refuses_cuda_when_absent(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample.main(["--checkpoint", str(tmp_path / "none.pth")])


@pytest.mark.parametrize("labels", [None, "3", "0,9,4"])
@pytest.mark.parametrize("num_samples", [1, 7, 16])
def test_build_labels_matches_jax(labels, num_samples):
    args = SimpleNamespace(labels=labels, num_samples=num_samples, seed=11)
    config = {"conditional": True, "num_classes": 10}
    nrow = max(1, int(np.sqrt(num_samples)))
    num_rows = -(-num_samples // nrow)
    np.testing.assert_array_equal(
        build_labels(args, config, nrow, num_rows),
        jax_build_labels(args, config, nrow, num_rows))


def test_png_writer_round_trips_through_pillow(tmp_path):
    rng = np.random.default_rng(0)
    for shape in [(5, 7, 3), (4, 6), (3, 2, 4)]:
        image = rng.integers(0, 256, shape, dtype=np.uint8)
        write_png(tmp_path / "x.png", image)
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "x.png")), image)
    grid = make_grid(np.ones((3, 2, 2, 1)), nrow=2, padding=1)
    assert grid.shape == (7, 7, 1) and grid.sum() == 12


# The DiT's MoE and ToMe configs and consistency checkpoints, which raised
# until they were ported, build (as the classifier and SR3 did before them:
# their tests are test_torch_port_classifier.py and test_torch_port_sr.py)
@pytest.mark.parametrize("change,ported", [
    ({"model_type": "dit", "model_params": dict(
        small_dit_config()["model_params"], num_experts=4)}, "moe"),
    ({"diffusion_type": "consistency"}, "consistency"),
    ({"model_type": "dit", "model_params": dict(
        small_dit_config()["model_params"], tome_ratio=0.5)}, "tome"),
])
def test_factory_raises_on_what_is_not_ported(change, ported):
    config = dict(small_config(), **change)
    model = factory.get_model(config)
    diffusion = factory.get_diffusion(config, "ddim")
    if ported == "consistency":
        assert isinstance(diffusion, ConsistencyModel)
    else:
        assert model.num_experts or model.tome is not None
        assert isinstance(diffusion, DDIM)


@pytest.mark.parametrize("steps", [None, 3])
def test_factory_raises_on_samplers_not_ported(steps):
    """A consistency checkpoint owns its stack for every sampling method:
    the JAX factory's ConsistencyModel, its step count the config's (2
    without the key)."""
    config = dict(small_config(), diffusion_type="consistency",
                  sigma_data=0.25, timestep_scaling=4.0)
    config.pop("num_inference_steps")
    if steps is not None:
        config["num_inference_steps"] = steps
    for method in ("ddpm", "ddim", "dpm++", "dpm++sde", "unipc"):
        ours = factory.get_diffusion(config, method)
        ref = jax_factory.get_diffusion(config, method)
        assert isinstance(ours, ConsistencyModel)
        for key in ("num_inference_steps", "sigma_data", "timestep_scaling",
                    "prediction_type", "clip_sample"):
            assert getattr(ours, key) == getattr(ref, key), key
        np.testing.assert_array_equal(ours.inference_timesteps.numpy(),
                                      np.asarray(ref.inference_timesteps))


# -------------------------------- the flags shared with the root `sample.py`
def root_sample_parser():
    """The root CLI's `build_parser()`, taken from its source: importing
    `sample.py` itself would configure the JAX platform as a side effect."""
    tree = ast.parse((REPO / "sample.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "build_parser")
    scope = {"argparse": argparse}
    exec(compile(ast.Module([fn], []), "sample.py", "exec"), scope)
    return scope["build_parser"]()


def test_sampling_method_defaults_to_ddpm_on_both_sides():
    argv = ["--checkpoint", "x"]
    ours = sample.build_parser().parse_args(argv)
    root = root_sample_parser().parse_args(argv)
    assert ours.sampling_method == root.sampling_method == "ddpm"
    choices = [next(a.choices for a in p._actions
                    if a.dest == "sampling_method")
               for p in (sample.build_parser(), root_sample_parser())]
    assert choices[0] == choices[1] == ["ddpm", "ddim", "dpm++", "dpm++sde",
                                        "unipc"]
    for flag in ("save_intermediate", "create_gif", "gif_fps",
                 "gif_final_seconds"):
        assert (getattr(ours, flag) == getattr(root, flag)), flag


@pytest.mark.parametrize("diffusion_type", ["ddpm", "flow_matching", "edm",
                                            "consistency"])
@pytest.mark.parametrize("steps", [None, 7])
@pytest.mark.parametrize("method", ["ddpm", "ddim", "dpm++", "dpm++sde",
                                    "unipc"])
def test_step_count_rule_matches_jax(method, steps, diffusion_type):
    """--num_inference_steps and the DDIM default of 50, case by case
    against the JAX pipeline's `_apply_steps_and_precision`."""
    args = SimpleNamespace(sampling_method=method, num_inference_steps=steps,
                           mixed_precision=None)
    ours = dict(small_config(), diffusion_type=diffusion_type)
    flags = pipeline.process_flags(ours)
    ref = dict(ours)
    apply_steps_and_precision(args, ours, flags)
    jax_apply_steps_and_precision(args, ref, flags)
    assert ours == ref
    assert ours["num_inference_steps"] == (
        steps if steps is not None and (method != "ddpm" or any(flags))
        else 50 if method == "ddim" and not any(flags) else 10)


def tiny_checkpoint(tmp_path, **changes):
    """A `.pth` of the small conditional UNet's random weights, T = 10."""
    config = dict(small_config(), num_timesteps=10, **changes)
    torch.manual_seed(0)
    ckpt = tmp_path / "model.pth"
    checkpoint.save_checkpoint(ckpt, factory.get_model(config).state_dict(),
                               config)
    return ckpt


@pytest.mark.parametrize("method,spacing", [
    ("dpm++", "uniform"), ("dpm++sde", "uniform"), ("unipc", "uniform"),
    ("ddim", "karras")])
def test_fast_samplers_run_through_the_cli(tmp_path, method, spacing):
    ckpt = tiny_checkpoint(tmp_path, timestep_spacing=spacing)
    result = sample.main([
        "--checkpoint", str(ckpt), "--sampling_method", method,
        "--num_inference_steps", "4", "--num_samples", "3", "--batch_size",
        "2", "--cfg_scale", "3", "--device", "cpu", "--output_dir",
        str(tmp_path / "out")])
    samples = result["samples"]
    assert samples.shape == (3, 16, 16, 3) and np.isfinite(samples).all()
    assert (tmp_path / "out" / "samples.png").is_file()


def test_save_intermediate_writes_every_step(tmp_path):
    ckpt = tiny_checkpoint(tmp_path)
    out = tmp_path / "out"
    result = sample.main([
        "--checkpoint", str(ckpt), "--sampling_method", "unipc",
        "--num_inference_steps", "3", "--num_samples", "3", "--batch_size",
        "2", "--cfg_scale", "3", "--device", "cpu", "--output_dir", str(out),
        "--save_intermediate", "--create_gif", "--gif_fps", "5"])
    frames = np.load(out / "intermediate" / "steps.npy")
    assert frames.shape == (3, 3, 16, 16, 3)
    np.testing.assert_array_equal(frames[-1], result["samples"])
    assert sorted(p.name for p in (out / "intermediate").glob("*.png")) == [
        "step_0000.png", "step_0001.png", "step_0002.png"]
    gif = Image.open(out / "samples.gif")
    assert gif.n_frames == 3  # Pillow merges the held copies of the last


def test_create_gif_stops_where_pillow_is_absent(monkeypatch, tmp_path):
    ckpt = tiny_checkpoint(tmp_path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(SystemExit, match="Pillow"):
        sample.main(["--checkpoint", str(ckpt), "--sampling_method", "ddim",
                     "--device", "cpu", "--output_dir", str(tmp_path),
                     "--create_gif"])


@pytest.mark.parametrize("argv,rescale,interval", [
    ([], None, None),
    (["--guidance_rescale", "0.7", "--cfg_interval", "100,600"], 0.7,
     "100,600"),
    (["--guidance_rescale", "0"], 0.0, None),
])
def test_cfg_knobs_parse_as_the_root_cli_parses_them(argv, rescale, interval):
    argv = ["--checkpoint", "x", *argv]
    ours = sample.build_parser().parse_args(argv)
    root = root_sample_parser().parse_args(argv)
    assert (ours.guidance_rescale, ours.cfg_interval) == (rescale, interval)
    assert (root.guidance_rescale, root.cfg_interval) == (rescale, interval)


@pytest.mark.parametrize("argv,value", [
    ([], None), (["--mixed_precision", "bf16"], "bf16"),
    (["--mixed_precision", "none"], "none"),
])
def test_mixed_precision_parses_as_the_root_cli_parses_it(argv, value):
    argv = ["--checkpoint", "x", *argv]
    ours = sample.build_parser().parse_args(argv)
    root = root_sample_parser().parse_args(argv)
    assert ours.mixed_precision == root.mixed_precision == value
    for parser in (sample.build_parser(), root_sample_parser()):
        with pytest.raises(SystemExit):
            parser.parse_args(["--checkpoint", "x", "--mixed_precision",
                               "fp16"])


@pytest.mark.parametrize("flags,built", [
    ([], "none"), (["--mixed_precision", "bf16"], "bf16"),
])
def test_mixed_precision_flag_overrides_the_checkpoint_config(
        monkeypatch, tmp_path, flags, built):
    """`--mixed_precision` reaches `factory.get_model` as the config's key
    (the JAX pipeline's override); without it the checkpoint's own key
    stands; the bf16 model samples on the CPU."""
    config = dict(small_config(), num_timesteps=10)
    torch.manual_seed(0)
    ckpt = tmp_path / "model.pth"
    checkpoint.save_checkpoint(ckpt, factory.get_model(config).state_dict(),
                               config)
    seen = []
    real = factory.get_model

    def recording(cfg):
        model = real(cfg)
        seen.append((cfg["mixed_precision"], model.input_conv.compute_dtype))
        return model

    monkeypatch.setattr(factory, "get_model", recording)
    result = sample.main([
        "--checkpoint", str(ckpt), "--sampling_method", "ddim",
        "--num_inference_steps", "2", "--num_samples", "2", "--batch_size",
        "2", "--cfg_scale", "3", "--device", "cpu", "--output_dir",
        str(tmp_path / "out"), *flags])
    dtype = torch.bfloat16 if built == "bf16" else None
    assert seen == [(built, dtype)]
    samples = result["samples"]
    assert samples.shape == (2, 16, 16, 3) and np.isfinite(samples).all()


@pytest.mark.parametrize("method", ["ddim", "ddpm"])
@pytest.mark.parametrize("flags,rescale,interval", [
    ([], 0.0, None),
    (["--guidance_rescale", "0.7", "--cfg_interval", "3,8"], 0.7, (3, 8)),
])
def test_cfg_knobs_reach_cfg_eps_x0(monkeypatch, tmp_path, method, flags,
                                    rescale, interval):
    config = dict(small_config(), num_timesteps=10)
    torch.manual_seed(0)
    ckpt = tmp_path / "model.pth"
    checkpoint.save_checkpoint(ckpt, factory.get_model(config).state_dict(),
                               config)
    seen = []
    real = base.cfg_eps_x0

    def recording(*args, **kwargs):
        seen.append((kwargs["guidance_rescale"], kwargs["cfg_interval"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(base, "cfg_eps_x0", recording)
    result = sample.main([
        "--checkpoint", str(ckpt), "--sampling_method", method,
        "--num_inference_steps", "2", "--num_samples", "2", "--batch_size",
        "2", "--cfg_scale", "2", *flags, "--device", "cpu", "--output_dir",
        str(tmp_path / "out")])
    assert np.isfinite(result["samples"]).all()
    assert len(seen) == (2 if method == "ddim" else 10)
    assert set(seen) == {(rescale, interval)}


# ------ editing and training-free knobs (ROADMAP queue 1 item 10)
EDITING_FLAGS = ("init_image", "strength", "mask", "repaint_jump",
                 "repaint_resample", "restarts", "restart_interval",
                 "pag_scale", "deepcache", "deepcache_depth", "freeu")


@pytest.mark.parametrize("argv", [
    [],
    ["--init_image", "a.png", "--strength", "0.3", "--mask", "m.png",
     "--repaint_jump", "4", "--repaint_resample", "3"],
    ["--restarts", "2", "--restart_interval", "10,300", "--pag_scale", "1.5",
     "--deepcache", "3", "--deepcache_depth", "2", "--freeu",
     "1.1,1.2,0.9,0.2"],
])
def test_editing_flags_parse_as_the_root_cli_parses_them(argv):
    argv = ["--checkpoint", "x", *argv]
    ours = sample.build_parser().parse_args(argv)
    root = root_sample_parser().parse_args(argv)
    for flag in EDITING_FLAGS:
        assert getattr(ours, flag) == getattr(root, flag), flag


def namespace(argv=()):
    """The port's parsed flags (the root CLI's, by the test above)."""
    return sample.build_parser().parse_args(["--checkpoint", "x", *argv])


# (rule, flags, config changes, flow/edm/cm): each a SystemExit of the JAX
# pipeline's `_apply_freeu`, `_wrap_pag`, `_build_deepcache` and
# `_validate_editing`
PIPELINE_RULES = [
    ("freeu", ["--freeu", "1,2,3"], {}, None),
    ("freeu", ["--freeu", "a,b,c,d"], {}, None),
    ("freeu", ["--freeu", "1,1,1,1"], {"model_type": "dit"}, None),
    ("pag", ["--pag_scale", "-1"], {}, None),
    ("pag", ["--pag_scale", "2"], {}, "flow"),
    ("pag", ["--pag_scale", "2"], {}, "edm"),
    ("pag", ["--pag_scale", "2"], {}, "cm"),
    ("pag", ["--pag_scale", "2"], {"prediction_type": "v"}, None),
    ("pag", ["--pag_scale", "2"], {"model_type": "dim"}, None),
    ("pag", ["--pag_scale", "2"],
     {"model_params": dict(small_config()["model_params"],
                           use_attention=False)}, None),
    ("deepcache", ["--deepcache", "2"], {"model_type": "dit"}, None),
    ("deepcache", ["--deepcache", "2", "--sampling_method", "dpm++"], {},
     None),
    ("deepcache", ["--deepcache", "2", "--sampling_method", "ddim"], {},
     "flow"),
    ("deepcache", ["--deepcache", "2", "--sampling_method", "ddim"], {},
     "cm"),
    ("deepcache", ["--deepcache", "2", "--sampling_method", "ddim",
                   "--save_intermediate"], {}, None),
    ("deepcache", ["--deepcache", "2", "--sampling_method", "ddim",
                   "--init_image", "a.png"], {}, None),
    ("deepcache", ["--deepcache", "2", "--sampling_method", "ddim",
                   "--restarts", "1"], {}, None),
    ("deepcache", ["--deepcache", "2", "--sampling_method", "ddim",
                   "--pag_scale", "1"], {}, None),
    ("deepcache_wrapped", ["--deepcache", "2", "--sampling_method", "ddim"],
     {}, None),
    ("deepcache", ["--deepcache", "2", "--sampling_method", "ddim",
                   "--deepcache_depth", "2"], {}, None),
    ("deepcache", ["--deepcache", "2", "--sampling_method", "ddim",
                   "--deepcache_depth", "0"], {}, None),
    ("editing", ["--mask", "m.png"], {}, None),
    ("editing", ["--init_image", "a.png", "--repaint_resample", "2"], {},
     None),
    ("editing", ["--restarts", "1"], {}, None),
    ("editing", ["--restarts", "1", "--sampling_method", "ddim"], {}, "edm"),
    ("editing", ["--restarts", "1", "--sampling_method", "ddim"], {}, "cm"),
    ("editing", ["--init_image", "a.png"], {}, "cm"),
    ("editing", ["--restarts", "1", "--sampling_method", "ddim",
                 "--init_image", "a.png"], {}, None),
    ("editing", ["--restarts", "1", "--sampling_method", "ddim"],
     {"ddim_eta": 0.5}, None),
    ("editing", ["--init_image", "a.png", "--sampling_method", "unipc"], {},
     None),
    ("editing", ["--init_image", "a.png", "--strength", "0"], {}, None),
    ("editing", ["--init_image", "a.png", "--strength", "1.5"], {}, None),
    ("editing", ["--init_image", "a.png", "--mask", "m.png",
                 "--repaint_resample", "2", "--repaint_jump", "2",
                 "--sampling_method", "ddim"], {}, None),
    ("editing", ["--init_image", "a.png", "--mask", "m.png",
                 "--repaint_resample", "2"], {}, None),
]


@pytest.mark.parametrize("rule,argv,changes,kind", PIPELINE_RULES)
def test_pipeline_rules_match_jax(rule, argv, changes, kind):
    """Each SystemExit of the JAX pipeline's knob rules, with its message,
    from the same flags and config (the rules run before any model)."""
    args = namespace(argv)
    config = dict(small_config(), **changes)
    flags = (kind == "flow", kind == "edm", kind == "cm")
    wrapped = rule == "deepcache_wrapped"
    calls = {
        "freeu": (lambda: jax_pipeline._apply_freeu(args, dict(config)),
                  lambda: pipeline.apply_freeu(args, dict(config))),
        "pag": (lambda: jax_pipeline._wrap_pag(args, config, None, None,
                                               flags),
                lambda: pipeline.wrap_pag(args, config, None, flags)),
        "deepcache": (lambda: jax_pipeline._build_deepcache(
            args, config, None, flags, wrapped),
            lambda: pipeline.build_deepcache(args, config, None, flags,
                                             wrapped)),
        "editing": (lambda: jax_pipeline._validate_editing(
            args, config, flags, None, 3),
            lambda: pipeline.validate_editing(args, config, flags, 3)),
    }
    ref_call, our_call = calls["deepcache" if wrapped else rule]
    with pytest.raises(SystemExit) as ref:
        ref_call()
    with pytest.raises(SystemExit) as ours:
        our_call()
    assert str(ours.value) == str(ref.value)


def editing_files(tmp_path):
    """A 16x16 RGB init image and a mask regenerating its right half, as
    the port writes PNGs."""
    image = np.random.default_rng(0).integers(0, 256, (16, 16, 3),
                                              dtype=np.uint8)
    mask = np.zeros((16, 16), np.uint8)
    mask[:, 8:] = 255
    write_png(tmp_path / "init.png", image)
    write_png(tmp_path / "mask.png", mask)
    return image, mask


# flag family: (its flags, the line it prints)
FLAG_FAMILIES = {
    "img2img": (["--sampling_method", "ddim", "--num_inference_steps", "4",
                 "--strength", "0.5", "--init_image", "{dir}/init.png"],
                "img2img from"),
    "inpainting": (["--sampling_method", "ddim", "--num_inference_steps",
                    "4", "--strength", "0.5", "--init_image",
                    "{dir}/init.png", "--mask", "{dir}/mask.png"],
                   "with inpainting mask"),
    "repaint": (["--sampling_method", "ddpm", "--strength", "0.5",
                 "--init_image", "{dir}/init.png", "--mask", "{dir}/mask.png",
                 "--repaint_jump", "2", "--repaint_resample", "2"],
                "[RePaint]"),
    "restarts": (["--sampling_method", "ddim", "--num_inference_steps", "6",
                  "--restarts", "1", "--restart_interval", "1,8"],
                 "Restart sampling batch"),
    "pag": (["--sampling_method", "ddim", "--num_inference_steps", "3",
             "--pag_scale", "2"], "Perturbed Attention Guidance: scale 2.0"),
    "deepcache": (["--sampling_method", "ddim", "--num_inference_steps", "5",
                   "--deepcache", "2", "--deepcache_depth", "1"],
                  "DeepCache: full pass every 2 steps, depth 1"),
    "freeu": (["--sampling_method", "ddim", "--num_inference_steps", "3",
               "--freeu", "1.1,1.2,0.9,0.2"], "FreeU: b1,b2=1.1,1.2"),
}


@pytest.mark.parametrize("family", list(FLAG_FAMILIES))
def test_editing_and_guidance_flags_run_through_the_cli(tmp_path, capsys,
                                                        family):
    """One CPU run of `sample.main` a flag family, CFG 3, on the tiny UNet
    (T = 10); with a mask the kept half comes back as the init image."""
    ckpt = tiny_checkpoint(tmp_path)
    image, mask = editing_files(tmp_path)
    flags, line = FLAG_FAMILIES[family]
    result = sample.main([
        "--checkpoint", str(ckpt), "--num_samples", "3", "--batch_size", "2",
        "--cfg_scale", "3", "--device", "cpu", "--output_dir",
        str(tmp_path / "out"), *(f.format(dir=tmp_path) for f in flags)])
    assert line in capsys.readouterr().out
    samples = result["samples"]
    assert samples.shape == (3, 16, 16, 3) and np.isfinite(samples).all()
    if "--mask" in flags:
        kept = np.broadcast_to(mask[None, :, :, None] == 0, samples.shape)
        np.testing.assert_allclose(
            samples[kept], np.broadcast_to(image / 255.0, samples.shape)[kept],
            atol=1e-6)
