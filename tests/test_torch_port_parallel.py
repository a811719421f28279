"""The port's data parallelism (DDP over 'data' for every trainer; the
process group and the batch split of `parallel/mesh.py`) against the JAX
package's data-parallel step and the port's own one-device step, on the
CPU; and the port's multi-process dry run (`tools/dryrun_multichip.py`).

The JAX side runs on its virtual CPU devices (`tests/conftest.py`). The
port runs in a gloo world of 2 processes (one torch thread each, started
once for the file, importing no JAX: `torch_parallel_jobs.py`). Every rank
draws the global batch's draws and keeps its rows, and dropout masks are
drawn over the global batch (and keyed on the global (batch, head) in
attention, E7), so a data-parallel step with dropout 0.1 on is the
one-device step on the same global batch. Bars in
`torch_parallel_helpers.py`.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from diffusion_models_collection_tpu_torch.diffusion import DDPM
from diffusion_models_collection_tpu_torch.models import UNet
from diffusion_models_collection_tpu_torch.models.layers import Dropout
from diffusion_models_collection_tpu_torch.parallel import check_config
from diffusion_models_collection_tpu_torch.parallel.mesh import Layout
from diffusion_models_collection_tpu_torch.parallel import plan as plan_mod
from diffusion_models_collection_tpu_torch.parallel.plan import ParallelPlan
from diffusion_models_collection_tpu_torch.utils.trainer import (
    DiffusionTrainer,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from torch_parallel_helpers import (
    check_against_jax,
    check_against_one_device,
    jax_sharded_steps,
    numpy_state,
    run_world,
    train_config,
)
from torch_parallel_jobs import batches, train_job
from torch_port_helpers import (  # noqa: F401 (autouse: one torch thread)
    MODEL_PARAMS,
    jax_dit,
    jax_unet,
    one_torch_thread,
)

REPO = Path(__file__).resolve().parent.parent
VAE_CONFIG = {"model_type": "vae", "image_size": (8, 8),
              "conditional": False, "mixed_precision": "none",
              "model_params": dict(in_channels=3, base_channels=16,
                                   channel_mult=(1, 2), latent_channels=2,
                                   num_res_blocks=1, use_attention=True,
                                   dropout=0.1)}
CLASSIFIER_CONFIG = {
    "model_type": "classifier", "image_size": (16, 16), "conditional": True,
    "num_classes": 10, "num_timesteps": 1000, "beta_start": 0.0001,
    "beta_end": 0.02, "beta_schedule": "linear", "mixed_precision": "none",
    "model_params": dict(in_channels=3, model_channels=16, num_res_blocks=1,
                         attention_resolutions=(8,), channel_mult=(1, 2),
                         use_attention=True, dropout=0.1)}


def no_dropout(config):
    return dict(config, model_params=dict(config["model_params"],
                                          dropout=0.0))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    unet_model, unet_params, unet_cfg = jax_unet(True, seed=2)
    _, dit_params, dit_cfg = jax_dit(True, seed=4, size=16)
    data = batches(9, 2, (4, 16, 16, 3))
    unet = dict(state=numpy_state(state_dict_from_jax(unet_params, unet_cfg)),
                config=train_config(unet_cfg, tmp / "unet"))
    dit = dict(state=numpy_state(state_dict_from_jax(dit_params, dit_cfg)),
               config=train_config(dit_cfg, tmp / "dit"))
    jobs = {
        "unet_jax": dict(config=no_dropout(unet["config"]),
                         state=unet["state"], batches=data, seed=3),
        "unet": dict(config=unet["config"], state=unet["state"],
                     batches=data, seed=3),
        "dit": dict(config=dit["config"], state=dit["state"], batches=data,
                    seed=5),
        "accum": dict(config=dict(unet["config"],
                                  gradient_accumulation_steps=2),
                      state=unet["state"], batches=data, seed=3),
        "vae": dict(kind="vae", config=train_config(VAE_CONFIG, tmp / "vae"),
                    state=None, seed=7,
                    batches=batches(11, 2, (4, 8, 8, 3),
                                    latent=(4, 4, 4, 2))),
        "classifier": dict(kind="classifier",
                           config=train_config(CLASSIFIER_CONFIG,
                                               tmp / "cls"),
                           state=None, batches=data, seed=8),
        "consistency": dict(kind="consistency", config=train_config(
            unet_cfg, tmp / "ct", diffusion_type="consistency",
            consistency_grid_size=10, consistency_sample_steps=2),
            state=unet["state"], batches=data, seed=9),
    }
    results = dict(zip(jobs, run_world(2, list(jobs.values()))))
    refs = {name: train_job(job) for name, job in jobs.items()
            if name != "unet_jax"}
    return dict(model=unet_model, params=unet_params, unet=unet, data=data,
                results=results, refs=refs)


def test_rows_are_the_ranks_block_of_the_global_batch():
    x = torch.arange(8 * 2).reshape(8, 2)
    assert torch.equal(Layout(dp=2, dp_rank=1).rows(x), x[4:])
    assert torch.equal(Layout(dp=4, dp_rank=2, tp=2).rows(x), x[4:6])
    assert Layout().rows(x) is x
    with pytest.raises(ValueError, match="does not split"):
        Layout(dp=3).rows(x)


def test_draws_are_the_global_draws_cut_to_the_ranks_rows(tmp_path):
    """A rank's (t, noise, drop) are its rows of what one device draws for
    the global batch from the same generator state."""
    config = train_config({"model_type": "unet", "conditional": True,
                           "num_classes": 10, "image_size": (16, 16),
                           "model_params": dict(MODEL_PARAMS)}, tmp_path)

    def trainer():
        return DiffusionTrainer(UNet(**MODEL_PARAMS, num_classes=10),
                                DDPM(num_timesteps=1000), [None], config,
                                "cpu")

    one = trainer().draw((8, 16, 16, 3))
    for rank in range(2):
        sharded = trainer()
        sharded.plan.layout = Layout(dp=2, dp_rank=rank)
        mine = sharded.draw((4, 16, 16, 3))
        for got, want in zip(mine, one):
            assert torch.equal(got, want[4 * rank:4 * rank + 4])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_is_its_slice_of_the_global_mask_and_saves_one_byte(dtype):
    """A data-parallel rank's (and a tensor-parallel rank's) dropout is its
    slice of the one-device mask on the global tensor, scaled by 1 / (1 -
    p) both ways, and autograd saves the bool mask alone for it, as
    `F.dropout` saves its mask on the card (not x)."""
    def run(x, **place):
        drop = Dropout(0.25).train()
        for key, value in place.items():
            setattr(drop, key, value)
        x = x.clone().requires_grad_(True)
        saved = []
        torch.manual_seed(5)
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t.dtype) or t, lambda t: t):
            y = drop(x)
        y.float().sum().backward()
        return y, x.grad, saved

    x = torch.randn(8, 3, 6).to(dtype)
    y, grad, saved = run(x)
    keep = y != 0
    # two roundings to the dtype, of 1 / (1 - p) and of the product
    rtol = torch.finfo(dtype).eps
    assert saved == [torch.bool]
    torch.testing.assert_close(
        y.float(), torch.where(keep, x.float() / 0.75, 0.0), rtol=rtol,
        atol=0.0)
    torch.testing.assert_close(grad.float(), keep.float() / 0.75, rtol=rtol,
                               atol=0.0)
    for rank in range(2):
        mine, _, saved = run(x[4 * rank:4 * rank + 4], data_rank=rank,
                             data_ranks=2)
        assert saved == [torch.bool]
        assert torch.equal(mine, y[4 * rank:4 * rank + 4])
    cols, _, _ = run(x[..., 2:4], features=(2, 6))
    assert torch.equal(cols, y[..., 2:4])


def test_dp_unet_step_matches_the_jax_data_parallel_step(world):
    losses, params = jax_sharded_steps(
        world["model"], world["params"], no_dropout(world["unet"]["config"]),
        world["data"], dp=2)
    check_against_jax(world["results"]["unet_jax"], losses, params,
                      world["unet"]["config"])


@pytest.mark.parametrize("name", ["unet", "dit", "accum", "vae",
                                  "classifier", "consistency"])
def test_dp_step_with_dropout_is_the_one_device_step(world, name):
    """DDP over two ranks, dropout 0.1 on, against one process on the same
    global batches: the diffusion trainer (UNet; DiT, whose attention masks
    are keyed on the global batch row), gradient accumulation (DDP's
    `no_sync` on the first micro-step), and the VAE, classifier and
    consistency trainers, data parallel as in the JAX package."""
    check_against_one_device(world["results"][name], world["refs"][name])


def test_data_parallel_only_trainers_refuse_model_layouts(monkeypatch):
    """The VAE, classifier and few-step trainers are data parallel only
    (the JAX trainers' 'data' mesh); tensor_parallel needs as many
    processes; Adafactor's whole-tensor factors refuse tensor_parallel."""
    for changes in ({"fsdp": True}, {"tensor_parallel": 1, "fsdp": True}):
        with pytest.raises(ValueError, match="data-parallel only"):
            ParallelPlan(changes, torch.nn.Module(), "cpu",
                         model_parallel=False)
    with pytest.raises(ValueError, match="does not divide 1 devices"):
        check_config({"tensor_parallel": 2})
    monkeypatch.setattr(plan_mod, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="adafactor"):
        check_config({"tensor_parallel": 2, "optimizer": "adafactor"})


def test_dryrun_multichip_legs():
    """The port's dry run in a subprocess: every leg at 4 ranks, each
    printing its OK line with its loss (the DP grid: its distance) beside
    its reference."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m",
         "diffusion_models_collection_tpu_torch.tools.dryrun_multichip", "4"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for leg in ("unet DP loss=", "unet DP sample 8 images", "dit TP loss=",
                "dim TP loss=", "dit FSDP", "dit hybrid FSDPxTP",
                "dit SP loss=", "dim SP distributed scan loss=",
                "dim SPxTP loss=",
                "dit PP loss=", "dit PPxTP loss=", "dim PP loss=",
                "dit-moe EP loss="):
        assert f"dryrun_multichip(4): OK, {leg}" in proc.stdout, (
            leg, proc.stdout[-3000:])
