"""What a trainer does differently on a parallel layout.

The JAX trainers place a `TrainState` on a mesh and jit one step; the
port's trainers hand their model, optimizer and checkpoints to a
`ParallelPlan`, built from the config keys the JAX trainer reads
(`tensor_parallel`, `sequence_parallel`, `fsdp`, `fsdp_min_size`) and the
process group (`parallel/mesh.py`):

* `prepare` cuts a DiT/DiM to its tensor-parallel rank
  (`parallel/tensor_parallel.py`) and tells every dropout its rows of the
  global batch (and, under sequence parallelism, its tokens);
* `wrap` shards the model (and its EMA) with FSDP (`parallel/fsdp.py`), or
  puts DDP around it over 'data', or, under `sequence_parallel`, returns the
  model's forward given this rank's 'seq' group
  (`parallel/sequence_parallel.py`); the trainer trains through the
  result;
* `sync` is DDP's `no_sync` (FSDP's gradient sync switch) for the
  accumulation micro-steps of `MultiSteps`; under sequence parallelism
  `average_replicated_grads` sums every gradient over 'seq' (each seq rank
  holds its tokens' share) and averages it over 'data', once an update;
* `grad_groups` tells the global-norm clip which groups hold the pieces of
  each gradient, and `replicated` which gradients FSDP leaves to average;
* `gather`, `full_state_dict` and `full_optimizer_state` gather a tensor,
  the full model and optimizer state (every rank takes part, rank 0
  writes), under the single-device names and shapes; `load_state_dict` and
  `load_optimizer_state` re-shard a full one.

Without a process group the plan is the one-device layout and changes
nothing.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..models.dit import SelfAttention
from ..models.layers import Dropout
from . import fsdp as fsdp_lib
from . import tensor_parallel as tp_lib
from .mesh import Layout, make_layout, process_count


def check_config(config: dict, model: Optional[nn.Module] = None) -> None:
    """The JAX trainer's exclusions among the parallel layouts, with its
    messages; with `model`, its rules for the model under
    `sequence_parallel` too."""
    pp, sp, ep = (int(config.get(k, 1) or 1) for k in (
        "pipeline_parallel", "sequence_parallel", "expert_parallel"))
    tp = int(config.get("tensor_parallel", 1) or 1)
    if ep > 1 and (tp > 1 or pp > 1 or sp > 1):
        raise ValueError(
            "expert_parallel composes with plain data parallelism only — "
            "not tensor/pipeline/sequence parallelism")
    if sp > 1 and pp > 1:
        raise ValueError(
            "sequence_parallel cannot be combined with pipeline_parallel "
            "(both own the block-stack dataflow)")
    if (model is not None and int(getattr(model, "num_experts", 0) or 0) > 0
            and (pp > 1 or sp > 1)):
        raise ValueError(
            "MoE models (num_experts > 0) do not support pipeline/sequence "
            "parallelism (their shard_map bodies drop the sown load-balance "
            "loss); use expert_parallel, tensor_parallel, fsdp or plain data "
            "parallelism")
    if config.get("fsdp") and (pp > 1 or sp > 1 or ep > 1):
        raise ValueError(
            "fsdp cannot be combined with pipeline_parallel, "
            "sequence_parallel or expert_parallel (those strategies "
            "define their own parameter layouts); fsdp + "
            "tensor_parallel is supported")
    if sp > 1 and model is not None:
        _check_sequence_parallel(model, sp)
    world = process_count()
    if tp > 1 and world % tp:
        raise ValueError(f"tensor_parallel={tp} does not divide {world} "
                         "devices")
    if tp > 1 and str(config.get("optimizer", "adamw")).lower() == \
            "adafactor":
        raise ValueError(
            "optimizer 'adafactor' factors its second moment over whole "
            "tensors, which tensor_parallel splits; use adamw, adam or lion "
            "(fsdp takes adafactor)")


def _check_sequence_parallel(model: nn.Module, sp: int) -> None:
    """The JAX trainer's rules for a model under `sequence_parallel`: a
    model that runs on a rank's tokens says so with its own
    `check_sequence_parallel`, which holds its rules."""
    check = getattr(model, "check_sequence_parallel", None)
    if check is None:
        raise ValueError("sequence_parallel supports the DiT and DiM "
                         f"backbones (got {type(model).__name__})")
    check(sp)


def _check_data_axis(config: dict, dp: int) -> None:
    """Under sequence parallelism the global batch and the sample grid split
    over 'data' evenly (the JAX trainer's check, with its messages)."""
    global_batch = int(config.get("batch_size", 0) or 0)
    if global_batch and global_batch % dp:
        raise ValueError(
            f"global batch size {global_batch} not divisible by the "
            f"data-axis size {dp} required by sequence_parallel")
    num_samples = int(config.get("num_samples", 16))
    if num_samples % dp:
        raise ValueError(
            f"num_samples {num_samples} not divisible by the data-axis size "
            f"{dp} required by sequence_parallel (in-training sample grids "
            "run through shard_map)")


class ParallelPlan:
    """The layout of one trainer's model (see the module docstring).
    `model_parallel=False` (the VAE, classifier and few-step trainers, data
    parallel only as in the JAX package) refuses `tensor_parallel`,
    `sequence_parallel` and `fsdp`."""

    def __init__(self, config: dict, model: nn.Module, device,
                 model_parallel: bool = True):
        self.tp = int(config.get("tensor_parallel", 1) or 1)
        self.sp = int(config.get("sequence_parallel", 1) or 1)
        self.fsdp = bool(config.get("fsdp", False))
        if not model_parallel and (self.tp > 1 or self.sp > 1 or self.fsdp):
            raise ValueError(
                f"{type(model).__name__}'s trainer is data-parallel only: "
                "tensor_parallel, sequence_parallel and fsdp apply to the "
                "diffusion trainer")
        check_config(config, model if model_parallel else None)
        min_size = config.get("fsdp_min_size")
        self.fsdp_min_size = (fsdp_lib.DEFAULT_MIN_SIZE if min_size is None
                              else int(min_size))
        self.device = torch.device(device)
        self.layout: Layout = make_layout(self.device, self.tp, self.sp)
        if self.sp > 1:
            _check_data_axis(config, self.layout.dp)
        # the state-dict entries `prepare` split over 'model' (none for a
        # UNet, whose parameters stay replicated)
        self.splits: Dict[str, tuple] = {}
        self.replicated: List[nn.Parameter] = []
        self.model_params: List[nn.Parameter] = []
        self.names: Dict[int, str] = {}

    @property
    def distributed(self) -> bool:
        return self.layout.mesh is not None

    @property
    def is_main(self) -> bool:
        lay = self.layout
        return lay.dp_rank == 0 and lay.sp_rank == 0 and lay.tp_rank == 0

    # ------------------------------------------------------------- model
    def prepare(self, model: nn.Module) -> nn.Module:
        """`model` cut to this rank's tensor-parallel slices under
        `tensor_parallel` (in place), its dropouts told this rank's rows (and
        tokens under `sequence_parallel`)."""
        lay = self.layout
        self.splits = tp_lib.shard_model(model, lay.tp_group, lay.tp_rank,
                                         lay.tp)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.data_rank, m.data_ranks = lay.dp_rank, lay.dp
                m.token_rank, m.token_ranks = lay.sp_rank, lay.sp
            elif isinstance(m, SelfAttention):
                m.data_rank = lay.dp_rank
        return model

    def wrap(self, model: nn.Module,
             ema: Optional[nn.Module] = None) -> nn.Module:
        """Shard `model` and `ema` (in place) with FSDP, or return DDP
        around `model` over 'data'; the module the trainer trains through.
        The one-device layout returns `model`; `sequence_parallel` returns
        the model's forward given this rank's 'seq' group."""
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.model_params = list(model.parameters())
        if not self.distributed:
            return model
        if self.sp > 1:
            from .sequence_parallel import make_sequence_parallel_apply

            return make_sequence_parallel_apply(model, self.layout)
        if self.fsdp:
            mesh = self.layout.mesh["data"]
            self.replicated = fsdp_lib.shard_model(model, mesh,
                                                   self.fsdp_min_size)
            if ema is not None:
                fsdp_lib.shard_model(ema, mesh, self.fsdp_min_size)
            self.names = {id(p): n for n, p in model.named_parameters()}
            return model
        from torch.nn.parallel import DistributedDataParallel

        return DistributedDataParallel(
            model, process_group=self.layout.dp_group,
            device_ids=([self.device] if self.device.type == "cuda" else
                        None))

    def sync(self, train_model: nn.Module, sync: bool):
        """A context for one backward: gradients synchronised over 'data'
        only when `sync` (the accumulation's last micro-step). Under
        sequence parallelism the sum runs at the update
        (`average_replicated_grads`)."""
        if not self.distributed or sync or self.sp > 1:
            if self.fsdp and self.distributed:
                train_model.set_requires_gradient_sync(True)
            return contextlib.nullcontext()
        if self.fsdp:
            train_model.set_requires_gradient_sync(False)
            return contextlib.nullcontext()
        return train_model.no_sync()

    def split(self, param: torch.Tensor) -> Optional[tuple]:
        """(axis, blocks) of a parameter of the wrapped model split over
        'model', or None."""
        return self.splits.get(self.names.get(id(param), ""))

    def grad_groups(self, params) -> List[tuple]:
        """For each parameter, the groups over which its gradient's pieces
        lie (FSDP's 'data', the model group of a tensor-parallel slice):
        the clip sums their squares over those groups."""
        out = []
        for p in params:
            groups = ()
            if fsdp_lib.is_sharded(p):
                groups += (self.layout.dp_group,)
            if self.split(p) is not None:
                groups += (self.layout.tp_group,)
            out.append(groups)
        return out

    @torch.no_grad()
    def average_replicated_grads(self) -> None:
        """The gradients the layout leaves to the update, each one
        all-reduce of their concatenation: FSDP's replicated ones averaged
        over 'data'; under sequence parallelism every gradient summed over
        'seq' and averaged over 'data' (over the ranks of this rank's model
        index, `Layout.replica_group`: a tensor-parallel slice with the
        ranks that hold the same slice)."""
        lay = self.layout
        if self.sp > 1 and self.distributed:
            params, group = self.model_params, lay.replica_group
        else:
            params, group = self.replicated, lay.dp_group
        grads = [p.grad for p in params if p.grad is not None]
        if not grads or (self.sp == 1 and lay.dp == 1):
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= lay.dp
        for g, new in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(new.view_as(g))

    # -------------------------------------------------------- full state
    def gather(self, name: str, tensor: torch.Tensor,
               like: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The full tensor of this rank's piece of entry `name` (a
        parameter's, or an optimizer state of a parameter's shape): a copy
        on the CPU."""
        tensor = fsdp_lib.full_tensor(tensor).detach()
        rule = self.splits.get(name)
        if rule is not None and (like is None or tensor.shape == like.shape):
            parts = [torch.empty_like(tensor) for _ in range(self.layout.tp)]
            dist.all_gather(parts, tensor.contiguous(),
                            group=self.layout.tp_group)
            tensor = tp_lib.join_tensors(parts, *rule)
        return tensor.to("cpu", copy=True)

    def full_state_dict(self, module: nn.Module) -> Dict[str, torch.Tensor]:
        """`module`'s state dict under the single-device names and shapes,
        gathered on every rank (a collective: every rank calls it); copies
        on the CPU."""
        if not self.distributed:
            return {name: t.detach().to("cpu", copy=True)
                    for name, t in module.state_dict().items()}
        return {name: self.gather(name, t)
                for name, t in module.state_dict().items()}

    def _piece(self, name: str, full: torch.Tensor,
               like: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the full tensor of entry `name`, laid out as
        `like` (a parameter of the wrapped model, or its state)."""
        rule = self.splits.get(name)
        if rule is not None:
            full = tp_lib.split_tensor(full, *rule, self.layout.tp_rank,
                                       self.layout.tp)
        full = full.to(device=fsdp_lib.local(like).device, dtype=like.dtype)
        if not hasattr(like, "placements"):
            return full
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(
            fsdp_lib.local_piece(full, like).contiguous(), like.device_mesh,
            like.placements, run_check=False)

    @torch.no_grad()
    def load_state_dict(self, module: nn.Module, state: Dict) -> None:
        """Load a full (single-device) state dict into `module`, re-sharded
        to this rank's layout."""
        if not self.distributed:
            module.load_state_dict(state)
            return
        own = module.state_dict()
        missing = set(own) ^ set(state)
        if missing:
            raise KeyError(f"state dict keys differ: {sorted(missing)}")
        for name, target in own.items():
            piece = self._piece(name, torch.as_tensor(state[name]), target)
            fsdp_lib.local(target).copy_(fsdp_lib.local(piece))

    def full_optimizer_state(self, optimizer: torch.optim.Optimizer,
                             params) -> dict:
        """`optimizer.state_dict()` with every state tensor of a
        parameter's layout gathered to the full parameter's (a
        collective)."""
        state = optimizer.state_dict()
        if not self.distributed:
            return state
        params = list(params)
        out = {}
        for index, entry in state["state"].items():
            p = params[index]
            name = self.names.get(id(p), "")
            out[index] = {
                k: (self.gather(name, v, p)
                    if torch.is_tensor(v) and v.dim() > 0 else v)
                for k, v in entry.items()}
        return {"state": out, "param_groups": state["param_groups"]}

    def load_optimizer_state(self, optimizer: torch.optim.Optimizer,
                             params, state: dict) -> None:
        """Load a full optimizer state, each tensor of a parameter's shape
        re-sharded like its parameter."""
        if not self.distributed or getattr(optimizer, "full_state", False):
            optimizer.load_state_dict(state)
            return
        params = list(params)
        sharded = {}
        for index, entry in state["state"].items():
            p = params[int(index)]
            name = self.names.get(id(p), "")
            sharded[index] = {
                k: (self._piece(name, v, p)
                    if torch.is_tensor(v) and v.dim() > 0 else v)
                for k, v in entry.items()}
        optimizer.load_state_dict({"state": sharded,
                                   "param_groups": state["param_groups"]})
