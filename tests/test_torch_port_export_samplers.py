"""The sampler export (`serving.py`) for every sampler, on the CPU: flow
matching (Euler) and the consistency sampler against the JAX package's
exported programs on the same weights and JAX's draws (as
`tests/test_torch_port_export.py`, bar 5e-4: the flow sampler draws only
x_T; the consistency sampler's re-noising takes a key split off the one
before, JAX `diffusion/consistency.py:273`). The other samplers are
`tests/test_torch_port_export_live.py`'s.

DDIM's and DDPM's step is traced once, inside a scan; the other samplers
are traced step by step, unrolled: the node counts below show the
difference."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffusion_models_collection_tpu_torch import serving
from test_torch_port_export import BATCH, port_and_jax
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    max_rel,
    one_torch_thread,
    torch_unet,
    traced_unet,
)


def test_flow_matching_program_matches_jax():
    jmodel, jparams, config = traced_unet(True, seed=41)
    config = dict(config, diffusion_type="flow_matching",
                  num_inference_steps=4, cfg_scale=3.0)
    ours, ref = port_and_jax(jmodel, jparams, torch_unet(jparams, config),
                             config, seed=42)
    assert max_rel(ours, ref) <= 5e-4


def consistency_noises(rng, shape):
    """The consistency sampler's re-noising draw of its second step: the
    key split off the one left after the initial split."""
    _, noise_rng = jax.random.split(rng)
    return torch.from_numpy(np.array(jax.random.normal(
        noise_rng, shape, jnp.float32)))[None]


def test_consistency_program_matches_jax():
    jmodel, jparams, config = traced_unet(True, seed=43)
    config = dict(config, diffusion_type="consistency",
                  num_inference_steps=2, cfg_scale=3.0)
    ours, ref = port_and_jax(jmodel, jparams, torch_unet(jparams, config),
                             config, seed=44, noises=consistency_noises)
    assert max_rel(ours, ref) <= 5e-4


def graph_nodes(program) -> int:
    return sum(len(m.graph.nodes) for m in program.graph_module.modules()
               if hasattr(m, "graph"))


def test_scan_traces_the_step_once():
    """DDIM's program does not grow with its steps; an unrolled sampler's
    grows by one step's graph a step."""
    _, jparams, config = traced_unet(True, seed=46)
    model = torch_unet(jparams, config)
    params = dict(model.named_parameters())

    def nodes(**changes):
        blob = serving.export_sampler(model, params, dict(config, **changes),
                                      batch_size=BATCH, device="cpu")
        return graph_nodes(serving.load_exported(blob)[0])
    assert nodes(num_inference_steps=2) == nodes(num_inference_steps=6)
    flow = dict(diffusion_type="flow_matching")
    assert (nodes(num_inference_steps=2, **flow)
            > nodes(num_inference_steps=1, **flow))
