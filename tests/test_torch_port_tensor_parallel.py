"""The port's Megatron tensor parallelism of the DiT and the DiM, and its
hybrid with FSDP, against the JAX package's sharded steps and against the
port's own one-device step, on the CPU.

The JAX side runs on its virtual CPU devices (`tests/conftest.py`), with its
parameters placed by the JAX rules (`parallel/tensor_parallel.py`
`tp_shardings`). The port runs in a gloo world of processes (one torch
thread each, started once per world for the whole file, importing no JAX:
`torch_parallel_jobs.py`), each rank holding its slices
(`parallel/tensor_parallel.py`) of numpy-seeded weights carried from JAX by
`utils/weights.py`. Against JAX the models run with dropout 0 (the JAX
model's masks are its own); against the port's one-device step, with
dropout 0.1: the attention's masks keyed on the global head (E7) and the
MLP's drawn over the whole hidden width must give the same step. Bars in
`torch_parallel_helpers.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.models import DiM as JaxDiM
from diffusion_models_collection_tpu.ops.selective_scan import (
    scan_tensor_parallel as jax_scan_tensor_parallel,
)
from diffusion_models_collection_tpu.parallel.tensor_parallel import (
    data_model_mesh,
)
from diffusion_models_collection_tpu_torch.models import DiM, DiT
from diffusion_models_collection_tpu_torch.parallel import tensor_parallel
from diffusion_models_collection_tpu_torch.parallel.tensor_parallel import (
    split_tensor,
    tp_rule,
)
from diffusion_models_collection_tpu_torch.utils import checkpoint as ckpt
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
    tp_gather_state_dicts,
    tp_shard_state_dict,
)
from torch_parallel_helpers import (
    TOL_PARAMS,
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
    one_torch_thread,
    perturbed,
    small_dim_config,
)

# hidden 32: d_inner 64, below the JAX Pallas gate, so JAX scans in XLA
DIM_TP_PARAMS = dict(patch_size=2, in_channels=3, hidden_size=32, depth=2,
                     state_size=8, mlp_ratio=4.0, dropout=0.1)


def jax_dim32():
    model = JaxDiM(img_size=(16, 16), **DIM_TP_PARAMS, num_classes=10)
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)),
                        jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1,), jnp.int32))["params"]
    config = dict(small_dim_config(True),
                  model_params=dict(DIM_TP_PARAMS, img_size=(16, 16)))
    return model, perturbed(params, 3), config


def no_dropout(config):
    return dict(config, model_params=dict(config["model_params"],
                                          dropout=0.0))


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    dit_model, dit_params, dit_cfg = jax_dit(True, seed=0, size=16)
    dim_model, dim_params, dim_cfg = jax_dim32()
    data = batches(5, 2, (4, 16, 16, 3))
    out = {}
    for name, (model, params, cfg) in (
            ("dit", (dit_model, dit_params, dit_cfg)),
            ("dim", (dim_model, dim_params, dim_cfg))):
        state = numpy_state(state_dict_from_jax(params, cfg))
        out[name] = dict(model=model, params=params, state=state,
                         config=train_config(cfg, tmp / name))
    out["data"] = data
    out["tmp"] = tmp
    return out


def job(setup, data, dropout=True, **changes):
    config = dict(setup["config"], **changes)
    if not dropout:
        config = no_dropout(config)
    return dict(config=config, state=setup["state"], batches=data, seed=11)


@pytest.fixture(scope="module")
def world2(setups):
    """Rank 0's results of the (1 data, 2 model) jobs, and the one-device
    references of the same jobs without `tensor_parallel`."""
    data = setups["data"]
    ckpt_dir = setups["tmp"] / "tp_ckpt"
    jobs = {
        "dit_jax": job(setups["dit"], data, False, tensor_parallel=2),
        "dit": job(setups["dit"], data, tensor_parallel=2),
        "dim_jax": job(setups["dim"], data, False, tensor_parallel=2),
        "dim": job(setups["dim"], data, tensor_parallel=2),
        "dit_save": dict(job(setups["dit"], data[:1], tensor_parallel=2,
                             save_dir=str(ckpt_dir)), save=True),
    }
    results = dict(zip(jobs, run_world(2, list(jobs.values()))))
    refs = {}
    for name in ("dit", "dim"):
        one = dict(jobs[name], config={k: v for k, v in
                                       jobs[name]["config"].items()
                                       if k != "tensor_parallel"})
        refs[name] = train_job(one)
    return results, refs, ckpt_dir


@pytest.fixture(scope="module")
def world4(setups):
    """The hybrid (2 data, 2 model, FSDP over 'data') jobs."""
    data = setups["data"]
    hybrid = dict(tensor_parallel=2, fsdp=True, fsdp_min_size=256)
    jobs = [job(setups["dit"], data, False, **hybrid),
            job(setups["dit"], data, **hybrid)]
    results = run_world(4, jobs)
    return results


# ------------------------------------------------------------------ rules
def test_dit_rules_mirror_the_jax_specs():
    """`tests/test_tensor_parallel.py`'s rules in the torch layout: qkv and
    MLP-in column-parallel (rows of a torch weight), attention-out and
    MLP-out row-parallel (its columns); the rest replicated."""
    assert tp_rule("blocks.0.attn.in_proj_weight") == (0, 3)
    assert tp_rule("blocks.0.attn.in_proj_bias") == (0, 3)
    assert tp_rule("blocks.0.attn.out_proj.weight") == (1, 1)
    assert tp_rule("blocks.0.attn.out_proj.bias") is None
    assert tp_rule("blocks.0.mlp.0.weight") == (0, 1)
    assert tp_rule("blocks.0.mlp.3.weight") == (1, 1)
    for name in ("pos_embed", "x_embedder.proj.weight",
                 "blocks.0.adaLN_modulation.1.weight",
                 "final_layer.linear.weight", "blocks.0.mlp.router.weight"):
        assert tp_rule(name) is None, name


def test_dim_rules_mirror_the_jax_specs():
    mamba = "blocks.0.mamba_block.mamba."
    assert tp_rule(mamba + "in_proj.weight") == (0, 2)
    for leaf in ("conv1d.weight", "conv1d.bias", "dt_proj.weight",
                 "dt_proj.bias", "A_log", "D"):
        assert tp_rule(mamba + leaf) == (0, 1), leaf
    assert tp_rule(mamba + "x_proj.weight") == (1, 1)
    assert tp_rule(mamba + "out_proj.weight") == (1, 1)
    assert tp_rule("blocks.0.ff_block.mlp.0.weight") == (0, 1)
    assert tp_rule("blocks.0.ff_block.mlp.3.weight") == (1, 1)
    assert tp_rule("blocks.0.mamba_block.adaLN_modulation.1.weight") is None


def test_qkv_split_per_head_and_xz_per_channel():
    """Rank r's in_proj rows are heads r H/tp .. of each of q, k and v (not
    a contiguous cut across them), and a Mamba's are channels r d/tp .. of
    each of x and z; the ranks' slices join back to the full tensor."""
    dim, heads, tp = 8, 4, 2
    qkv = torch.arange(3 * dim * 2.0).reshape(3 * dim, 2)
    for rank in range(tp):
        mine = split_tensor(qkv, 0, 3, rank, tp)
        rows = [part * dim + rank * dim // tp + i for part in range(3)
                for i in range(dim // tp)]
        torch.testing.assert_close(mine, qkv[rows])
        # whole heads: rows of head h are h * d / H .. of each part
        assert (dim // tp) % (dim // heads) == 0
    xz = torch.arange(2 * 6 * 3.0).reshape(12, 3)
    mine = split_tensor(xz, 0, 2, 1, 3)
    torch.testing.assert_close(mine, xz[[2, 3, 8, 9]])
    parts = [split_tensor(qkv, 0, 3, r, tp) for r in range(tp)]
    torch.testing.assert_close(tensor_parallel.join_tensors(parts, 0, 3), qkv)


@pytest.mark.parametrize("name", ["dit", "dim"])
def test_state_dict_shards_and_gathers_back(setups, name):
    """`utils/weights.py` cuts the JAX bridge's state dict to each rank's
    layout, which loads strict into the rank's model, and joins back."""
    state = {k: torch.as_tensor(v) for k, v in setups[name]["state"].items()}
    shards = [tp_shard_state_dict(state, r, 2) for r in range(2)]
    back = tp_gather_state_dicts(shards)
    assert set(back) == set(state)
    for key, value in state.items():
        torch.testing.assert_close(back[key], value, rtol=0, atol=0)
    qkv = ("blocks.0.attn.in_proj_weight" if name == "dit" else
           "blocks.0.mamba_block.mamba.in_proj.weight")
    assert shards[1][qkv].shape[0] == state[qkv].shape[0] // 2


# ------------------------------------------------------------ against JAX
def test_dit_tp_step_matches_the_jax_sharded_step(setups, world2):
    s = setups["dit"]
    losses, params = jax_sharded_steps(
        s["model"], s["params"], no_dropout(s["config"]), setups["data"],
        dp=1, tp=2)
    check_against_jax(world2[0]["dit_jax"], losses, params, s["config"])


def test_dim_tp_step_matches_the_jax_sharded_step(setups, world2):
    s = setups["dim"]
    mesh = data_model_mesh(1, 2, jax.devices()[:2])
    with jax_scan_tensor_parallel(mesh, "model"):
        losses, params = jax_sharded_steps(
            s["model"], s["params"], no_dropout(s["config"]),
            setups["data"], dp=1, tp=2)
    check_against_jax(world2[0]["dim_jax"], losses, params, s["config"])


def test_hybrid_fsdp_tp_step_matches_the_jax_sharded_step(setups, world4):
    s = setups["dit"]
    losses, params = jax_sharded_steps(
        s["model"], s["params"], no_dropout(s["config"]), setups["data"],
        dp=2, tp=2, fsdp=True, min_size=256)
    check_against_jax(world4[0], losses, params, s["config"])
    assert world4[0]["sharded"] > 0.5


# ------------------------------------------------ against the one device
@pytest.mark.parametrize("name", ["dit", "dim"])
def test_tp_step_with_dropout_is_the_one_device_step(world2, name):
    results, refs, _ = world2
    check_against_one_device(results[name], refs[name])


def test_hybrid_step_with_dropout_is_the_one_device_step(world2, world4):
    check_against_one_device(world4[1], world2[1]["dit"])


def test_a_rank_holds_its_slices(world2):
    shapes = world2[0]["dit"]["local_shapes"]
    assert shapes["blocks.0.attn.in_proj_weight"] == (3 * 32, 64)
    assert shapes["blocks.0.attn.out_proj.weight"] == (64, 32)
    assert shapes["blocks.0.mlp.0.weight"] == (128, 64)
    assert shapes["pos_embed"] == (1, 64, 64)
    shapes = world2[0]["dim"]["local_shapes"]
    assert shapes["blocks.0.mamba_block.mamba.in_proj.weight"] == (64, 32)
    assert shapes["blocks.0.mamba_block.mamba.A_log"] == (32, 8)
    assert shapes["blocks.0.mamba_block.mamba.x_proj.weight"] == (2 + 16, 32)


def test_tp_checkpoint_is_the_full_model_and_loads_strict(setups, world2):
    """Rank 0 writes the gathered state: the single-device names and
    shapes, loading with strict=True into a one-device DiT; a one-device
    trainer resumes from it, and a TP trainer re-shards it."""
    _, _, ckpt_dir = world2
    payload = ckpt.load_checkpoint(ckpt_dir / "current_model.pth")
    cfg = setups["dit"]["config"]
    model = DiT(img_size=(16, 16), **{k: v for k, v in
                                      cfg["model_params"].items()
                                      if k != "img_size"}, num_classes=10)
    model.load_state_dict(payload["model_state_dict"], strict=True)
    model.load_state_dict(payload["ema_model_state_dict"], strict=True)
    assert payload["optimizer_state_dict"]["state"]
    path = str(ckpt_dir / "current_model.pth")
    resumed = run_world(2, [dict(config=dict(cfg, tensor_parallel=2,
                                             resume_path=path,
                                             save_dir=str(ckpt_dir / "r")),
                                 state=None, batches=[], seed=0)])[0]
    for name, value in payload["model_state_dict"].items():
        assert max_rel(resumed["loaded"][name], value) == 0.0, name
    assert payload["optimizer_state_dict"]["state"].keys() == \
        resumed["opt"]["state"].keys()
    for index, entry in payload["optimizer_state_dict"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert max_rel(resumed["opt"]["state"][index][key],
                           entry[key]) <= TOL_PARAMS
