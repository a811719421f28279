"""`batch_size` is the global batch in the port's `train`, as in the JAX
package (F8): under torchrun each data-parallel rank loads `max(1,
batch_size // dp)` images, dp = world / (tensor_parallel x
sequence_parallel x pipeline_parallel), every rank under expert_parallel,
so a run at any world takes the JAX run's global batch and steps an epoch.

A gloo world of two processes runs the port's `train` CLI on the CPU
(`torch_parallel_jobs.cli_job`, importing no JAX) on a UNet config (two
data-parallel ranks), on a DiT config at `tensor_parallel: 2` and at
`pipeline_parallel: 2` (one data rank, which loads the whole global batch)
and on a MoE DiT config at `expert_parallel: 2` (two data ranks); the JAX
package's
`factory.get_dataloader` on the same config, with its process count and
index set to the world's data ranks, gives the rule each rank's loader is
held to: the same batch, the same batches an epoch, and as many steps.
"""

import json

import pytest

from diffusion_models_collection_tpu import factory as jax_factory
from diffusion_models_collection_tpu.parallel import mesh as jax_mesh
from diffusion_models_collection_tpu_torch.tools.dryrun_multichip import (
    launch,
)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

WORLD = 2


def config(tmp_path, name, **changes):
    """configs/synthetic_smoke.py's model and data (a 512-image synthetic
    set), one epoch at a global batch of 24, no sampling."""
    out = {
        "model_type": "unet",
        "model_params": {"image_size": (8, 8), "in_channels": 3,
                         "model_channels": 16, "out_channels": 3,
                         "num_res_blocks": 1, "attention_resolutions": (),
                         "dropout": 0.0, "channel_mult": (1, 2)},
        "dataset": "synthetic", "image_size": (8, 8),
        "conditional": True, "num_classes": 10, "num_timesteps": 50,
        "beta_start": 1e-4, "beta_end": 0.02, "beta_schedule": "linear",
        "loss_type": "l2", "epochs": 1, "batch_size": 24,
        "optimizer": "adamw", "learning_rate": 1e-3, "use_ema": False,
        "use_scheduler": False, "cfg_dropout_prob": 0.2,
        "save_dir": str(tmp_path / name / "ckpt"),
        "sample_dir": str(tmp_path / name / "samples"),
        "sample_interval": 1000, "sample_start_epoch": 1000, "seed": 0,
        "use_swanlab": False, "progress": False, **changes}
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(out))
    return out, str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("f8")
    unet, unet_path = config(tmp, "unet")
    dit, dit_path = config(
        tmp, "dit", model_type="dit", tensor_parallel=2,
        model_params={"in_channels": 3, "patch_size": 4, "hidden_size": 32,
                      "depth": 1, "num_heads": 4, "dropout": 0.0})
    dit_params = {"in_channels": 3, "patch_size": 4, "hidden_size": 32,
                  "depth": 2, "num_heads": 4, "dropout": 0.0}
    pp, pp_path = config(tmp, "pp", model_type="dit", pipeline_parallel=2,
                         model_params=dit_params)
    ep, ep_path = config(tmp, "ep", model_type="dit", expert_parallel=2,
                         model_params=dict(dit_params, num_experts=4))
    ranks = launch(WORLD, "torch_parallel_jobs.cli_job",
                   [unet_path, dit_path, pp_path, ep_path], timeout=300)
    return [unet, dit, pp, ep], ranks


def jax_rule(config, monkeypatch, data_ranks, index):
    """The JAX package's loader of `config` in process `index` of
    `data_ranks` (its `factory.get_dataloader`, `factory.py:341-356`)."""
    monkeypatch.setattr(jax_mesh, "process_count", lambda: data_ranks)
    monkeypatch.setattr(jax_mesh, "process_index", lambda: index)
    loader = jax_factory.get_dataloader(
        config, jax_factory.get_dataset(config, train=True), train=True,
        seed=config["seed"])
    return loader.batch_size, len(loader)


@pytest.mark.parametrize("which,group", [(0, 1), (1, 2), (2, 2), (3, 1)])
def test_train_takes_the_jax_global_batch(runs, monkeypatch, which, group):
    """Data parallel, the two ranks are two data ranks, each loading 24 // 2
    images a step, and so are they at expert_parallel 2; at tensor_parallel
    2 or pipeline_parallel 2 (`group` ranks a model group) one data rank
    loads all 24 (a model group shares its rows). Each rank's batch and
    batches an epoch are the JAX loader's for that many processes, and one
    epoch takes that many steps."""
    configs, ranks = runs
    cfg = configs[which]
    data_ranks = WORLD // group
    for rank in range(WORLD):
        got = ranks[rank][which]
        want = jax_rule(cfg, monkeypatch, data_ranks, rank // group)
        assert got["dp"] == data_ranks
        assert (got["batch"], got["batches"]) == want, (rank, got, want)
        assert got["batch"] * data_ranks == cfg["batch_size"]
        assert got["steps"] == got["batches"]
