"""The port's FSDP (ZeRO-3: FSDP2 per block and on the root, over 'data')
against the JAX package's sharded step and the port's own one-device step,
on the CPU: the sharding rule (`tests/test_fsdp.py`'s in the torch layout),
a DiT and a UNet step with dropout 0 against JAX and with dropout 0.1
against one device, the moments and the EMA kept sharded, Adafactor's
whole-tensor factors, checkpoints that interchange with one-device runs
both ways, and the exclusions of the JAX trainer. The port's ranks run in
a gloo world of 2 processes (`torch_parallel_jobs.py`, no JAX); bars in
`torch_parallel_helpers.py`.
"""

import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu_torch.diffusion import DDPM
from diffusion_models_collection_tpu_torch.models import DiT
from diffusion_models_collection_tpu_torch.parallel import check_config
from diffusion_models_collection_tpu_torch.parallel.fsdp import fsdp_dim
from diffusion_models_collection_tpu_torch.utils import checkpoint as ckpt
from diffusion_models_collection_tpu_torch.utils.trainer import (
    DiffusionTrainer,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from torch_parallel_helpers import (
    LR,
    check_against_jax,
    check_against_one_device,
    jax_sharded_steps,
    max_rel,
    numpy_state,
    run_world,
    train_config,
)
from torch_parallel_jobs import batches, train_job
from torch_port_helpers import (  # noqa: F401 (autouse: one torch thread)
    jax_dit,
    jax_unet,
    one_torch_thread,
)

MIN_SIZE = 512  # the JAX FSDP tests' fsdp_min_size at these widths


def no_dropout(config):
    return dict(config, model_params=dict(config["model_params"],
                                          dropout=0.0))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    dit_model, dit_params, dit_cfg = jax_dit(True, seed=0, size=16)
    unet_model, unet_params, unet_cfg = jax_unet(True, seed=1)
    data = batches(7, 2, (4, 16, 16, 3))
    setups = {}
    for name, model, params, cfg in (("dit", dit_model, dit_params, dit_cfg),
                                     ("unet", unet_model, unet_params,
                                      unet_cfg)):
        setups[name] = dict(model=model, params=params,
                            state=numpy_state(state_dict_from_jax(params,
                                                                  cfg)),
                            config=train_config(cfg, tmp / name))
    fs = dict(fsdp=True, fsdp_min_size=MIN_SIZE)

    def job(name, dropout=True, **changes):
        config = dict(setups[name]["config"], **changes)
        if not dropout:
            config = no_dropout(config)
        return dict(config=config, state=setups[name]["state"],
                    batches=data, seed=13)

    jobs = {
        "dit_jax": job("dit", False, **fs),
        "unet_jax": job("unet", False, **fs),
        "dit": job("dit", **fs),
        "unet": job("unet", **fs),
        "adafactor": job("dit", optimizer="adafactor", **fs),
        "save": dict(job("dit", save_dir=str(tmp / "fsdp_ckpt"), **fs),
                     batches=data[:1], save=True),
    }
    results = dict(zip(jobs, run_world(2, list(jobs.values()))))
    refs = {name: train_job(dict(jobs[name], config={
        k: v for k, v in jobs[name]["config"].items()
        if k not in ("fsdp", "fsdp_min_size")}))
        for name in ("dit", "unet", "adafactor")}
    return dict(setups=setups, data=data, results=results, refs=refs,
                tmp=tmp)


def test_fsdp_dim_rule():
    """`tests/test_fsdp.py::test_fsdp_spec_rule` in the torch layout, whose
    axes are Flax's reversed for a linear (out, in) and a conv (out, in,
    kh, kw): the largest axis the shards divide, ties toward the torch
    first (Flax's last); small, indivisible and scalar leaves stay
    replicated (None)."""
    assert fsdp_dim((1024, 256), 8, min_size=1) == 0
    assert fsdp_dim((256, 1024), 8, min_size=1) == 1
    assert fsdp_dim((512, 512), 8, min_size=1) == 0
    assert fsdp_dim((128, 64, 3, 3), 8, min_size=1) == 0
    assert fsdp_dim((257, 129), 8, min_size=1) is None
    assert fsdp_dim((64,), 8, min_size=1000) is None
    assert fsdp_dim((), 8, min_size=1) is None
    assert fsdp_dim((8,), 8, min_size=1) == 0


@pytest.mark.parametrize("name", ["dit", "unet"])
def test_fsdp_step_matches_the_jax_sharded_step(world, name):
    s = world["setups"][name]
    losses, params = jax_sharded_steps(
        s["model"], s["params"], no_dropout(s["config"]), world["data"],
        dp=2, fsdp=True, min_size=MIN_SIZE)
    check_against_jax(world["results"][f"{name}_jax"], losses, params,
                      s["config"])


@pytest.mark.parametrize("name", ["dit", "unet"])
def test_fsdp_step_with_dropout_is_the_one_device_step(world, name):
    check_against_one_device(world["results"][name], world["refs"][name])


def test_parameters_moments_and_ema_are_sharded(world):
    result = world["results"]["dit"]
    assert result["sharded"] > 0.5, result["sharded"]
    # AdamW's two moments of every sharded parameter are DTensors too
    assert result["dtensor_states"] > 0
    shapes = result["local_shapes"]
    assert shapes["blocks.0.mlp.0.weight"] == (128, 64)  # (256, 64) / 2
    assert shapes["blocks.0.attn.in_proj_bias"] == (192,)  # < min_size


def test_adafactor_under_fsdp_is_the_one_device_step(world):
    """Adafactor's factored row and column means and its RMS clip span the
    whole tensor, not a rank's shard: the step equals one device's."""
    check_against_one_device(world["results"]["adafactor"],
                             world["refs"]["adafactor"], what=("params",),
                             move=3 * LR)


def test_fsdp_checkpoint_interchange(world):
    """`tests/test_fsdp.py::test_fsdp_checkpoint_interchange`: an FSDP run's
    file is the full model (strict load into a one-device DiT, and a
    one-device trainer resumes it with identical parameters); a one-device
    run's file re-shards under FSDP and trains on."""
    tmp = world["tmp"]
    path = tmp / "fsdp_ckpt" / "current_model.pth"
    payload = ckpt.load_checkpoint(path)
    saved = world["results"]["save"]
    for name, value in saved["params"].items():
        assert max_rel(payload["model_state_dict"][name], value) == 0.0
    cfg = world["setups"]["dit"]["config"]
    params = {k: v for k, v in cfg["model_params"].items() if k != "img_size"}
    model = DiT(img_size=(16, 16), **params, num_classes=10)
    model.load_state_dict(payload["model_state_dict"], strict=True)
    one = DiffusionTrainer(DiT(img_size=(16, 16), **params, num_classes=10),
                           DDPM(num_timesteps=1000), [None],
                           dict(cfg, save_dir=str(tmp / "one")), "cpu",
                           resume_path=str(path))
    assert one.start_epoch == 2
    for name, value in one.model.state_dict().items():
        assert max_rel(value, payload["model_state_dict"][name]) == 0.0
    one.save_checkpoint(epoch=2, is_last=True)
    back = str(tmp / "one" / "current_model.pth")
    resumed = run_world(2, [dict(
        config=dict(cfg, fsdp=True, fsdp_min_size=MIN_SIZE,
                    resume_path=back, save_dir=str(tmp / "again")),
        state=None, batches=world["data"][:1], seed=0)])[0]
    for name, value in one.model.state_dict().items():
        assert max_rel(resumed["loaded"][name], value) == 0.0, name
    assert resumed["sharded"] > 0.5
    assert np.isfinite(resumed["losses"]).all()


@pytest.mark.parametrize("key", ["pipeline_parallel", "sequence_parallel",
                                 "expert_parallel"])
def test_fsdp_rejects_model_sharding_combos(key):
    """`tests/test_fsdp.py::test_fsdp_rejects_model_sharding_combos`, with
    the JAX trainer's message; fsdp + tensor_parallel is allowed."""
    with pytest.raises(ValueError, match="fsdp cannot be combined"):
        check_config({"fsdp": True, key: 2})
    check_config({"fsdp": True, "tensor_parallel": 1})
