"""Parallel training of the port: data parallelism for every trainer, FSDP
(ZeRO-3) and Megatron tensor parallelism of the DiT and the DiM, their
hybrid, sequence parallelism of the DiT and the DiM (with tensor
parallelism too), pipeline parallelism (GPipe) of the DiT and the DiM (the
DiT's with tensor parallelism too), and expert parallelism of the MoE DiT;
and outside training, sampling, evaluation, the in-training grid and the
distill and reflow tools split over the ranks of a world.

Counterpart of `diffusion_models_collection_tpu/parallel/`: `mesh.py`
(process groups, the (data, [seq | stage,] model) and (data, expert)
meshes, the batch split, `join_world` and `data_layout` of the entry
points), `fsdp.py`, `tensor_parallel.py`, `sequence_parallel.py`,
`dim_sequence_parallel.py`, `pipeline_parallel.py`, `expert_parallel.py`,
and `plan.py`, which the trainers use; `data_parallel.py` is the JAX
package's data-parallel split of sampling and metric batches
(`factory.py` `dp_sampling_sharding`, `mesh.py` `dp_batch_sharding`).
"""

from .data_parallel import DataParallelApply, gather_rows
from .dim_sequence_parallel import (distributed_selective_scan,
                                    make_dim_sequence_parallel_apply)
from .expert_parallel import ExpertGroup, shard_experts
from .fsdp import fsdp_dim, sharded_fraction
from .mesh import (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, SEQ_AXIS, STAGE_AXIS,
                   Layout, data_expert_mesh, data_layout, data_seq_mesh,
                   data_seq_model_mesh, data_stage_mesh,
                   data_stage_model_mesh, init_process_group,
                   is_main_process, join_world, make_layout, process_count,
                   process_index)
from .pipeline_parallel import (Pipeline, StageBlocks, make_pipeline_apply,
                                split_model)
from .plan import ParallelPlan, check_config
from .sequence_parallel import make_sequence_parallel_apply
from .tensor_parallel import shard_model, tp_rule

__all__ = [
    "DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "SEQ_AXIS", "STAGE_AXIS",
    "DataParallelApply", "ExpertGroup", "Layout", "ParallelPlan",
    "Pipeline", "StageBlocks", "check_config", "data_expert_mesh",
    "data_layout", "data_seq_mesh", "data_seq_model_mesh",
    "data_stage_mesh", "data_stage_model_mesh",
    "distributed_selective_scan", "fsdp_dim", "gather_rows",
    "init_process_group", "is_main_process", "join_world",
    "make_dim_sequence_parallel_apply", "make_layout",
    "make_pipeline_apply", "make_sequence_parallel_apply", "process_count",
    "process_index", "shard_experts", "shard_model", "sharded_fraction",
    "split_model", "tp_rule",
]
