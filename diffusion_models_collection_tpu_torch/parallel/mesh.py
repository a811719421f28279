"""Process groups, the device mesh and the batch split of a parallel run.

Counterpart of `diffusion_models_collection_tpu/parallel/mesh.py` (and the
multi-process launch of its `train.py`). The JAX package lays a batch over a
`jax.sharding.Mesh` and lets XLA insert the collectives; here each rank is a
process with one device, torchrun's (or a test's) process group joins them,
and the port's code calls the collectives itself.

* `init_process_group` joins the default group, from torchrun's environment
  (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`) or from explicit arguments and a
  store. NCCL on `cuda:LOCAL_RANK`; gloo only for a CPU device (or when a
  caller names it, as a test of two ranks on one card does).
* `Layout` is a run's (data, model) mesh: `tensor_parallel` ranks a model
  group (consecutive ranks, as the JAX `data_model_mesh` reshapes its
  devices (dp, tp)), `world / tensor_parallel` model replicas over 'data'.
  With `sequence_parallel` S it is the (data, seq, model) mesh of the JAX
  `data_seq_model_mesh` (`data_seq_mesh` at tp 1), 'model' innermost: rank
  (d S + s) tp + m; the S seq ranks of a model group share its rows and
  hold its tokens s L / S .., and `replica_group` joins the ranks of one
  model index, over which a sequence-parallel run sums its gradients.
  With `pipeline_parallel` S it is the (data, stage, model) mesh of the JAX
  `data_stage_model_mesh` (`data_stage_mesh` at tp 1), 'model' innermost:
  rank (d S + s) tp + m; the S stage ranks of a model group share its rows,
  stage s holds blocks s depth / S .., `stage_group` joins them, the 'data'
  group joins the ranks of one (stage, model) index, and `replica_group`
  the (data, stage) ranks of one model index. With `expert_parallel` E it
  is the (data, expert) mesh of the JAX `data_expert_mesh`, rank d E + e:
  every rank is a data-parallel rank of the global batch (`dp` is the
  world, `dp_group` every rank), `expert_group` joins the E ranks whose
  experts make up one bank, `expert_data_group` the ranks that hold the
  same experts.
  Without a process group it is the one-device layout, and every collective
  of the port is skipped.
* Every rank draws the step's draws for the global batch from a generator
  seeded alike and keeps its rows (`Layout.rows`, the JAX `shard_batch`): a
  data-parallel run at world N takes the steps that one device takes on the
  same global batch.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SEQ_AXIS = "seq"
STAGE_AXIS = "stage"
EXPERT_AXIS = "expert"
MODEL_AXIS = "model"


def distributed_env() -> Optional[tuple]:
    """(rank, world size, local rank) from torchrun's environment, or None
    when the process was not started by it."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return rank, world, int(os.environ.get("LOCAL_RANK", rank))


def init_process_group(device: torch.device, *, rank: Optional[int] = None,
                       world_size: Optional[int] = None, store=None,
                       backend: Optional[str] = None) -> bool:
    """Join the default process group unless one is joined: with `rank` and
    `world_size` given (and a `store`, e.g. `dist.FileStore`), or from
    torchrun's environment. The backend is NCCL for a CUDA device, gloo for
    the CPU, unless `backend` names one. Returns whether a group is joined
    (False: a single process, nothing to join)."""
    if dist.is_available() and dist.is_initialized():
        return True
    if rank is None:
        env = distributed_env()
        if env is None:
            return False
        rank, world_size, _ = env
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {} if store is None else {"store": store}
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            **kwargs)
    return True


def refuse_process_world(tool: str) -> None:
    """Raise when `tool`, which joins no process group, runs in a torchrun
    world of several processes: each would run the whole run on one card
    and write the same files."""
    env = distributed_env()
    if env is not None and env[1] > 1:
        raise NotImplementedError(
            f"{tool} runs in one process: data parallelism outside train is "
            "not ported yet (ROADMAP queue 1 item 15d); under torchrun each "
            f"of the {env[1]} processes would run the whole run and write "
            "the same files")


def local_device(device: torch.device) -> torch.device:
    """`cuda` as this process's card, `cuda:LOCAL_RANK`, under torchrun;
    any other device as it is."""
    device = torch.device(device)
    env = distributed_env()
    if device.type == "cuda" and device.index is None and env is not None:
        return torch.device("cuda", env[2])
    return device


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def is_main_process() -> bool:
    """Rank 0: the process that prints, writes files and logs."""
    return process_index() == 0


def staged_on_host(tensor: torch.Tensor, group=None) -> bool:
    """Whether a point-to-point transfer of `tensor` within `group` goes
    through host memory: a CUDA tensor under gloo, whose `send`/`recv`
    abort on a device pointer (its collectives copy through the host
    themselves; NCCL takes the device's own)."""
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


@dataclass
class Layout:
    """A run's place on the (data, [seq | stage,] model) or (data, expert)
    mesh: `dp` replicas over 'data' times `sp` seq ranks or `pp` stages
    times `tp` ranks a model group; this rank's `dp_rank`, `sp_rank`,
    `pp_rank` and `tp_rank`; the mesh and its groups (None in the one-device
    layout), and with `sp` or `pp` > 1 `replica_group`, the (data, seq) or
    (data, stage) ranks of this rank's model index. Under expert parallelism
    `dp` counts every rank (each holds its rows of the global batch),
    `dp_group` is `batch_group`, every rank, and `ep_rank` of `ep` places
    the rank in its expert group."""

    dp: int = 1
    tp: int = 1
    dp_rank: int = 0
    tp_rank: int = 0
    mesh: object = None  # torch.distributed.device_mesh.DeviceMesh
    sp: int = 1
    sp_rank: int = 0
    replica_group: object = None
    pp: int = 1
    pp_rank: int = 0
    ep: int = 1
    ep_rank: int = 0
    batch_group: object = None

    @property
    def dp_group(self):
        if self.batch_group is not None:
            return self.batch_group
        return None if self.mesh is None else self.mesh.get_group(DATA_AXIS)

    @property
    def stage_group(self):
        return None if self.pp == 1 else self.mesh.get_group(STAGE_AXIS)

    @property
    def expert_group(self):
        return None if self.ep == 1 else self.mesh.get_group(EXPERT_AXIS)

    @property
    def expert_data_group(self):
        """The ranks that hold this rank's experts (the mesh's 'data'
        axis)."""
        return None if self.ep == 1 else self.mesh.get_group(DATA_AXIS)

    @property
    def tp_group(self):
        if self.mesh is None or MODEL_AXIS not in self.mesh.mesh_dim_names:
            return None  # the (data, expert) mesh has no model group
        return self.mesh.get_group(MODEL_AXIS)

    @property
    def sp_group(self):
        return None if self.sp == 1 else self.mesh.get_group(SEQ_AXIS)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor over the global batch (dp equal
        blocks along axis 0, in rank order)."""
        if self.dp == 1:
            return x
        if x.shape[0] % self.dp:
            raise ValueError(f"a global batch of {x.shape[0]} rows does not "
                             f"split over {self.dp} data-parallel ranks")
        n = x.shape[0] // self.dp
        return x[self.dp_rank * n:(self.dp_rank + 1) * n]

    def mean_over_data(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of `x` over the data-parallel ranks (the reference's
        `dist.all_reduce` of the logged loss); `x` itself at dp 1."""
        if self.dp == 1:
            return x
        x = x.detach().clone()
        dist.all_reduce(x, group=self.dp_group)
        return x / self.dp


def data_seq_model_mesh(device_type: str, dp: int, sp: int, tp: int):
    """The (data, seq, model) `DeviceMesh` over ranks 0 .. dp sp tp - 1,
    'model' innermost (the JAX `data_seq_model_mesh`: the per-block
    tensor-parallel all-reduces on the nearest ranks, the sequence gathers
    next, the gradient sum over 'data' farthest)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dp, sp, tp),
                            mesh_dim_names=(DATA_AXIS, SEQ_AXIS, MODEL_AXIS))


def data_seq_mesh(device_type: str, dp: int, sp: int):
    """The (data, seq, model) mesh with one rank a model group (the JAX
    `data_seq_mesh`)."""
    return data_seq_model_mesh(device_type, dp, sp, 1)


def data_stage_model_mesh(device_type: str, dp: int, pp: int, tp: int):
    """The (data, stage, model) `DeviceMesh`, 'model' innermost (the JAX
    `data_stage_model_mesh`: the per-block tensor-parallel all-reduces on
    the nearest ranks, the per-microbatch stage hand-off next, the gradient
    sum over 'data' farthest)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dp, pp, tp),
                            mesh_dim_names=(DATA_AXIS, STAGE_AXIS,
                                            MODEL_AXIS))


def data_stage_mesh(device_type: str, dp: int, pp: int):
    """The (data, stage, model) mesh with one rank a model group (the JAX
    `data_stage_mesh`)."""
    return data_stage_model_mesh(device_type, dp, pp, 1)


def data_expert_mesh(device_type: str, dp: int, ep: int):
    """The (data, expert) `DeviceMesh`, rank d ep + e (the JAX
    `data_expert_mesh`): an expert group is ep consecutive ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dp, ep),
                            mesh_dim_names=(DATA_AXIS, EXPERT_AXIS))


def check_devices(world: int, tp: int = 1, sp: int = 1, pp: int = 1,
                  ep: int = 1) -> None:
    """The JAX trainer's rule that each layout's model group divides the
    devices, with its messages."""
    if world % tp:
        raise ValueError(f"tensor_parallel={tp} does not divide {world} "
                         "devices")
    for key, size in (("sequence_parallel", sp), ("pipeline_parallel", pp)):
        if size > 1 and tp > 1 and world % (size * tp):
            raise ValueError(f"{key}={size} x tensor_parallel={tp} does not "
                             f"divide {world} devices")
    for key, size in (("pipeline_parallel", pp), ("sequence_parallel", sp),
                      ("expert_parallel", ep)):
        if world % size:
            raise ValueError(f"{key}={size} does not divide {world} "
                             "devices")


def make_layout(device: torch.device, tensor_parallel: int = 1,
                sequence_parallel: int = 1, pipeline_parallel: int = 1,
                expert_parallel: int = 1) -> Layout:
    """The layout of this process: one device without a process group, else
    the (world / tensor_parallel, tensor_parallel) mesh over the group (at
    world 1 too), on `device`'s type, with axes 'data' and 'model'; with
    `sequence_parallel` > 1 the (data, seq, model) mesh, with
    `pipeline_parallel` > 1 the (data, stage, model) mesh, with
    `expert_parallel` > 1 the (data, expert) mesh."""
    tp = int(tensor_parallel or 1)
    sp = int(sequence_parallel or 1)
    pp = int(pipeline_parallel or 1)
    ep = int(expert_parallel or 1)
    world = process_count()
    check_devices(world, tp, sp, pp, ep)
    if not (dist.is_available() and dist.is_initialized()):
        if tp > 1:
            raise ValueError(f"tensor_parallel={tp} needs {tp} processes "
                             "(torchrun --nproc_per_node N)")
        return Layout()
    device_type = torch.device(device).type
    rank = process_index()
    if ep > 1:
        mesh = data_expert_mesh(device_type, world // ep, ep)
        return Layout(dp=world, dp_rank=rank, mesh=mesh, ep=ep,
                      ep_rank=rank % ep, batch_group=dist.group.WORLD)
    if pp > 1:
        dp = world // (pp * tp)
        mesh = data_stage_model_mesh(device_type, dp, pp, tp)
        # the (data, stage) ranks of each model index: every rank makes
        # every group, in one order
        replicas = [dist.new_group([(d * pp + s) * tp + m for d in range(dp)
                                    for s in range(pp)]) for m in range(tp)]
        return Layout(dp=dp, tp=tp, dp_rank=rank // (pp * tp),
                      tp_rank=rank % tp, mesh=mesh, pp=pp,
                      pp_rank=(rank // tp) % pp,
                      replica_group=replicas[rank % tp])
    if sp == 1:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh(device_type, (world // tp, tp),
                                mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
        return Layout(dp=world // tp, tp=tp, dp_rank=rank // tp,
                      tp_rank=rank % tp, mesh=mesh)
    dp = world // (sp * tp)
    mesh = data_seq_model_mesh(device_type, dp, sp, tp)
    # the (data, seq) ranks of each model index: every rank makes every
    # group, in one order
    replicas = [dist.new_group([(d * sp + s) * tp + m for d in range(dp)
                                for s in range(sp)]) for m in range(tp)]
    return Layout(dp=dp, tp=tp, dp_rank=rank // (sp * tp), tp_rank=rank % tp,
                  mesh=mesh, sp=sp, sp_rank=(rank // tp) % sp,
                  replica_group=replicas[rank % tp])
