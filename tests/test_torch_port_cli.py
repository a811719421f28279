"""The PyTorch port's entry point, `python -m
diffusion_models_collection_tpu_torch.sample`, on the CPU.

The end-to-end test writes a JAX `.ckpt` with the JAX package's
`save_checkpoint` (optax state included), samples from it in a fresh
`python -X importtime -m ...` process, and asserts the outputs and, from
the import log, that the process never imported jax, flax or optax.
"""

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

from diffusion_models_collection_tpu.pipeline import (
    build_labels as jax_build_labels,
)
from diffusion_models_collection_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from diffusion_models_collection_tpu_torch import factory, sample
from diffusion_models_collection_tpu_torch.pipeline import build_labels
from diffusion_models_collection_tpu_torch.utils.helpers import (
    make_grid,
    write_png,
)
from torch_port_helpers import jax_unet, small_config

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


@pytest.mark.parametrize("change", [
    {"model_type": "dit"},
    {"mixed_precision": "bf16"},
    {"latent_diffusion": True},
    {"diffusion_type": "flow_matching"},
    {"timestep_spacing": "karras"},
])
def test_factory_raises_on_what_is_not_ported(change):
    config = dict(small_config(), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        factory.get_model(config)
        factory.get_diffusion(config, "ddim")


def test_factory_raises_on_samplers_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        factory.get_diffusion(small_config(), "dpm++")
