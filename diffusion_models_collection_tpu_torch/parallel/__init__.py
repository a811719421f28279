"""Parallel training of the port: data parallelism for every trainer, FSDP
(ZeRO-3) and Megatron tensor parallelism of the DiT and the DiM, and their
hybrid.

Counterpart of `diffusion_models_collection_tpu/parallel/` for the layouts
of the parameters: `mesh.py` (process groups, the (data, model) mesh, the
batch split), `fsdp.py`, `tensor_parallel.py`, and `plan.py`, which the
trainers use. Pipeline, sequence and expert parallelism (and the JAX
package's data-parallel split of sampling and metrics) are not ported
yet: their config keys raise (ROADMAP queue 1 item 15).
"""

from .fsdp import fsdp_dim, sharded_fraction
from .mesh import (DATA_AXIS, MODEL_AXIS, Layout, init_process_group,
                   is_main_process, make_layout, process_count,
                   process_index)
from .plan import ParallelPlan, check_config
from .tensor_parallel import shard_model, tp_rule

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Layout", "ParallelPlan", "check_config",
    "fsdp_dim", "init_process_group", "is_main_process", "make_layout",
    "process_count", "process_index", "shard_model", "sharded_fraction",
    "tp_rule",
]
