"""Parallel training of the port: data parallelism for every trainer, FSDP
(ZeRO-3) and Megatron tensor parallelism of the DiT and the DiM, their
hybrid, and sequence parallelism of the DiT and the DiM (with tensor
parallelism too).

Counterpart of `diffusion_models_collection_tpu/parallel/`: `mesh.py`
(process groups, the (data, [seq,] model) mesh, the batch split),
`fsdp.py`, `tensor_parallel.py`, `sequence_parallel.py`,
`dim_sequence_parallel.py`, and `plan.py`, which the trainers use. Pipeline
and expert parallelism (and the JAX package's data-parallel split of
sampling and metrics) are not ported yet: their config keys raise (ROADMAP
queue 1 item 15).
"""

from .dim_sequence_parallel import (distributed_selective_scan,
                                    make_dim_sequence_parallel_apply)
from .fsdp import fsdp_dim, sharded_fraction
from .mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Layout, data_seq_mesh,
                   data_seq_model_mesh, init_process_group, is_main_process,
                   make_layout, process_count, process_index)
from .plan import ParallelPlan, check_config
from .sequence_parallel import make_sequence_parallel_apply
from .tensor_parallel import shard_model, tp_rule

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "Layout", "ParallelPlan",
    "check_config", "data_seq_mesh", "data_seq_model_mesh",
    "distributed_selective_scan", "fsdp_dim", "init_process_group",
    "is_main_process", "make_dim_sequence_parallel_apply", "make_layout",
    "make_sequence_parallel_apply", "process_count", "process_index",
    "shard_model", "sharded_fraction", "tp_rule",
]
