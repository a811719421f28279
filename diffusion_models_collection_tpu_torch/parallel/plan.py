"""What a trainer does differently on a parallel layout.

The JAX trainers place a `TrainState` on a mesh and jit one step; the
port's trainers hand their model, optimizer and checkpoints to a
`ParallelPlan`, built from the config keys the JAX trainer reads
(`tensor_parallel`, `sequence_parallel`, `pipeline_parallel`,
`pp_microbatches`, `expert_parallel`, `fsdp`, `fsdp_min_size`) and the
process group (`parallel/mesh.py`):

* `prepare` cuts a DiT/DiM to its pipeline stage's blocks
  (`parallel/pipeline_parallel.py`) and to its tensor-parallel rank
  (`parallel/tensor_parallel.py`), a MoE DiT to its expert-parallel rank's
  experts (`parallel/expert_parallel.py`), tells every dropout its rows of
  the global batch (and, under sequence parallelism, its tokens), and
  every MoE the data-parallel group its load-balance loss averages over;
* `wrap` shards the model (and its EMA) with FSDP (`parallel/fsdp.py`), or
  puts DDP around it over 'data', or, under `sequence_parallel`, returns the
  model's forward given this rank's 'seq' group
  (`parallel/sequence_parallel.py`), or under `pipeline_parallel` the
  stage's pipeline; the trainer trains through the result, and samples
  through `forward_fn`'s (under DDP and FSDP each data rank's rows of every
  model call, `parallel/data_parallel.py`);
* `sync` is DDP's `no_sync` (FSDP's gradient sync switch) for the
  accumulation micro-steps of `MultiSteps`; under sequence, pipeline and
  expert parallelism `average_replicated_grads` reduces the gradients once
  an update (sequence: every gradient summed over 'seq' and averaged over
  'data'; pipeline: a block's averaged over 'data', a replicated one summed
  over 'stage' and averaged over 'data'; expert: a dense one averaged over
  every rank, an expert's summed over the ranks that hold it and divided by
  the world);
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
from ..models.moe import MoeMlp
from . import expert_parallel as ep_lib
from . import fsdp as fsdp_lib
from . import pipeline_parallel as pp_lib
from . import tensor_parallel as tp_lib
from .data_parallel import DataParallelApply
from .mesh import Layout, check_devices, make_layout, process_count

# the config keys of the layouts that only the diffusion trainer takes
MODEL_PARALLEL_KEYS = ("tensor_parallel", "sequence_parallel",
                       "pipeline_parallel", "expert_parallel")


def check_config(config: dict, model: Optional[nn.Module] = None) -> None:
    """The JAX trainer's exclusions among the parallel layouts, with its
    messages and in its order; with `model`, its rules for the model under
    `expert_parallel`, `pipeline_parallel` and `sequence_parallel` too."""
    pp, sp, ep = (int(config.get(k, 1) or 1) for k in (
        "pipeline_parallel", "sequence_parallel", "expert_parallel"))
    tp = int(config.get("tensor_parallel", 1) or 1)
    if ep > 1:
        if tp > 1 or pp > 1 or sp > 1:
            raise ValueError(
                "expert_parallel composes with plain data parallelism only — "
                "not tensor/pipeline/sequence parallelism")
        if model is not None:
            ep_lib.check_expert_parallel(model, ep)
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
    if pp > 1 and model is not None:
        pp_lib.check_pipeline(model, pp, tp)
    if sp > 1 and model is not None:
        _check_sequence_parallel(model, sp)
    check_devices(process_count(), tp, sp, pp, ep)
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


def _check_data_axis(config: dict, dp: int,
                     which: str = "sequence_parallel") -> None:
    """Under sequence or pipeline parallelism (`which`) the global batch
    and the sample grid split over 'data' evenly (the JAX trainer's check,
    with its messages)."""
    global_batch = int(config.get("batch_size", 0) or 0)
    if global_batch and global_batch % dp:
        raise ValueError(
            f"global batch size {global_batch} not divisible by the "
            f"data-axis size {dp} required by {which}")
    num_samples = int(config.get("num_samples", 16))
    if num_samples % dp:
        raise ValueError(
            f"num_samples {num_samples} not divisible by the data-axis size "
            f"{dp} required by {which} (in-training sample grids run "
            "through shard_map)")


def _check_microbatches(config: dict, dp: int, microbatches: int) -> None:
    """A data rank's rows of a train step and of the in-training grid's
    model call (2 num_samples rows under CFG) split into the
    microbatches: the JAX pipeline's reshape, checked up front."""
    batch = max(1, int(config.get("batch_size", 0) or 0) // dp)
    pp_lib.check_microbatches(batch, microbatches,
                              f"batch_size {config.get('batch_size')}")
    samples = int(config.get("num_samples", 16))
    if config.get("conditional") and config.get("num_classes"):
        samples *= 2  # the CFG call's conditional and null halves
    pp_lib.check_microbatches(samples // dp, microbatches,
                              f"the sample grid's model call of {samples} "
                              "rows")


class ParallelPlan:
    """The layout of one trainer's model (see the module docstring).
    `model_parallel=False` (the VAE, classifier and few-step trainers, data
    parallel only as in the JAX package) refuses `tensor_parallel`,
    `sequence_parallel`, `pipeline_parallel`, `expert_parallel` and
    `fsdp`."""

    def __init__(self, config: dict, model: nn.Module, device,
                 model_parallel: bool = True):
        self.tp, self.sp, self.pp, self.ep = (
            int(config.get(k, 1) or 1) for k in MODEL_PARALLEL_KEYS)
        self.fsdp = bool(config.get("fsdp", False))
        if not model_parallel and (max(self.tp, self.sp, self.pp, self.ep)
                                   > 1 or self.fsdp):
            raise ValueError(
                f"{type(model).__name__}'s trainer is data-parallel only: "
                "tensor_parallel, sequence_parallel, pipeline_parallel, "
                "expert_parallel and fsdp apply to the diffusion trainer")
        check_config(config, model if model_parallel else None)
        min_size = config.get("fsdp_min_size")
        self.fsdp_min_size = (fsdp_lib.DEFAULT_MIN_SIZE if min_size is None
                              else int(min_size))
        self.microbatches = int(config.get("pp_microbatches") or self.pp)
        self.device = torch.device(device)
        self.layout: Layout = make_layout(self.device, self.tp, self.sp,
                                          self.pp, self.ep)
        if self.sp > 1:
            _check_data_axis(config, self.layout.dp)
        if self.pp > 1:
            _check_data_axis(config, self.layout.dp, "pipeline_parallel")
            _check_microbatches(config, self.layout.dp, self.microbatches)
        # the state-dict entries `prepare` split over 'model' or 'expert'
        # (none for a UNet, whose parameters stay replicated)
        self.splits: Dict[str, tuple] = {}
        self.replicated: List[nn.Parameter] = []
        self.model_params: List[nn.Parameter] = []
        self.names: Dict[int, str] = {}
        self.depth = 0

    @property
    def distributed(self) -> bool:
        return self.layout.mesh is not None

    @property
    def is_main(self) -> bool:
        lay = self.layout
        return (lay.dp_rank == 0 and lay.sp_rank == 0 and lay.pp_rank == 0
                and lay.tp_rank == 0)

    # the group over which the split entries lie: 'expert' or 'model'
    @property
    def split_group(self):
        lay = self.layout
        return lay.expert_group if self.ep > 1 else lay.tp_group

    @property
    def split_size(self) -> int:
        return self.ep if self.ep > 1 else self.layout.tp

    @property
    def split_rank(self) -> int:
        lay = self.layout
        return lay.ep_rank if self.ep > 1 else lay.tp_rank

    # ------------------------------------------------------------- model
    def prepare(self, model: nn.Module) -> nn.Module:
        """`model` cut to this rank's pipeline stage and tensor-parallel
        slices, or expert-parallel experts (in place), its dropouts told
        this rank's rows (and tokens under `sequence_parallel`), its MoE
        banks their groups."""
        lay = self.layout
        if self.pp > 1:
            pp_lib.split_model(model, lay.pp, lay.pp_rank)
            self.depth = model.depth
        self.splits = tp_lib.shard_model(model, lay.tp_group, lay.tp_rank,
                                         lay.tp)
        if self.ep > 1:
            self.splits = ep_lib.shard_experts(model, lay.ep_rank, lay.ep)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.data_rank, m.data_ranks = lay.dp_rank, lay.dp
                m.token_rank, m.token_ranks = lay.sp_rank, lay.sp
                if m.experts is not None and self.ep > 1:
                    # the expert buffer holds its expert group's rows
                    total = m.experts[1]
                    m.experts = (lay.ep_rank * total // lay.ep, total)
                    m.data_rank = lay.dp_rank // lay.ep
                    m.data_ranks = lay.dp // lay.ep
            elif isinstance(m, SelfAttention):
                m.data_rank = lay.dp_rank
            elif isinstance(m, MoeMlp):
                if lay.dp > 1:
                    m.balance_group = ep_lib.GroupMean(lay.dp_group, lay.dp)
                if self.ep > 1:
                    m.expert_group = ep_lib.ExpertGroup(lay.expert_group,
                                                        lay.ep)
        return model

    def wrap(self, model: nn.Module,
             ema: Optional[nn.Module] = None) -> nn.Module:
        """Shard `model` and `ema` (in place) with FSDP, or return DDP
        around `model` over 'data'; the module the trainer trains through.
        The one-device layout returns `model`; `sequence_parallel` returns
        the model's forward given this rank's 'seq' group,
        `pipeline_parallel` the stage's pipeline, `expert_parallel` the
        model (its gradients reduce at the update)."""
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.model_params = list(model.parameters())
        if not self.distributed:
            return model
        if self.pp > 1:
            return pp_lib.make_pipeline_apply(model, self.layout,
                                              self.microbatches)
        if self.sp > 1:
            from .sequence_parallel import make_sequence_parallel_apply

            return make_sequence_parallel_apply(model, self.layout)
        if self.ep > 1:
            return model
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

    def forward_fn(self, module: nn.Module):
        """The callable that samples with `module` (the model or its EMA):
        under `pipeline_parallel` its pipeline over every row given, each
        data rank on its rows; under DDP and FSDP at dp > 1 the module on
        each data rank's rows of every call, gathered
        (`data_parallel.DataParallelApply`, the JAX trainer's
        `_dp_sampling_inputs`); else (tensor, sequence and expert
        parallelism, and one data rank) the module itself, every rank on
        the whole grid, as in the JAX trainer."""
        if self.pp > 1 and self.distributed:
            return pp_lib.make_sampling_apply(module, self.layout,
                                              self.microbatches)
        if (self.distributed and self.layout.dp > 1
                and max(self.tp, self.sp, self.ep) == 1):
            return DataParallelApply(module, self.layout)
        return module

    def sync(self, train_model: nn.Module, sync: bool):
        """A context for one backward: gradients synchronised over 'data'
        only when `sync` (the accumulation's last micro-step). Under
        sequence, pipeline and expert parallelism the reduction runs at the
        update (`average_replicated_grads`)."""
        if (not self.distributed or sync
                or max(self.sp, self.pp, self.ep) > 1):
            if self.fsdp and self.distributed:
                train_model.set_requires_gradient_sync(True)
            return contextlib.nullcontext()
        if self.fsdp:
            train_model.set_requires_gradient_sync(False)
            return contextlib.nullcontext()
        return train_model.no_sync()

    def split(self, param: torch.Tensor) -> Optional[tuple]:
        """(axis, blocks) of a parameter of the wrapped model split over
        'model' or 'expert', or None."""
        return self.splits.get(self.names.get(id(param), ""))

    def is_block(self, param: torch.Tensor) -> bool:
        """Whether a pipeline stage holds `param` alone (a block's)."""
        return self.names.get(id(param), "").startswith("blocks.")

    def grad_groups(self, params) -> List[tuple]:
        """For each parameter, the groups over which its gradient's pieces
        lie (FSDP's 'data', a pipeline block's 'stage', the model or expert
        group of a split entry): the clip sums their squares over those
        groups."""
        out = []
        for p in params:
            groups = ()
            if fsdp_lib.is_sharded(p):
                groups += (self.layout.dp_group,)
            if self.pp > 1 and self.is_block(p):
                groups += (self.layout.stage_group,)
            if self.split(p) is not None:
                groups += (self.split_group,)
            out.append(groups)
        return out

    def _reductions(self) -> list:
        """(parameters, group) of each all-reduce at the update (see
        `average_replicated_grads`)."""
        lay, params = self.layout, self.model_params
        if self.pp > 1:
            return [([p for p in params if not self.is_block(p)],
                     lay.replica_group),
                    ([p for p in params if self.is_block(p)], lay.dp_group)]
        if self.ep > 1:
            return [([p for p in params if self.split(p) is None],
                     lay.dp_group),
                    ([p for p in params if self.split(p) is not None],
                     lay.expert_data_group)]
        if self.sp > 1:
            return [(params, lay.replica_group)]
        return [(self.replicated, lay.dp_group)]

    @torch.no_grad()
    def average_replicated_grads(self) -> None:
        """The gradients the layout leaves to the update, each group's one
        all-reduce of their concatenation, divided by the data-parallel
        ranks: FSDP's replicated ones over 'data'; under sequence
        parallelism every gradient over (data, seq) of its model index
        (`Layout.replica_group`: a tensor-parallel slice with the ranks
        that hold the same slice); under pipeline parallelism a replicated
        one over (data, stage) of its model index and a block's over
        'data' (a replicated gradient that only some stages hold is 0 on
        the others); under expert parallelism a dense one over every rank
        and an expert's over the ranks that hold its experts."""
        if not self.distributed or (self.sp == 1 and self.pp == 1
                                    and self.ep == 1
                                    and self.layout.dp == 1):
            return
        for params, group in self._reductions():
            if self.pp > 1:
                self._fill_missing_grads(params, group)
            grads = [p.grad for p in params if p.grad is not None]
            if not grads:
                continue
            flat = torch.cat([g.reshape(-1) for g in grads])
            if dist.get_world_size(group) > 1:
                dist.all_reduce(flat, group=group)
            flat /= self.layout.dp
            for g, new in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(new.view_as(g))

    def _fill_missing_grads(self, params, group) -> None:
        """A zero gradient for each of `params` that another rank of
        `group` holds a gradient of (a pipeline's final layer before the
        last stage), so every rank reduces the same list."""
        has = torch.tensor([p.grad is not None for p in params],
                           dtype=torch.float32, device=self.device)
        dist.all_reduce(has, group=group)
        for p, n in zip(params, has.tolist()):
            if n and p.grad is None:
                p.grad = torch.zeros_like(p)

    # -------------------------------------------------------- full state
    def gather(self, name: str, tensor: torch.Tensor,
               like: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The full tensor of this rank's piece of entry `name` (a
        parameter's, or an optimizer state of a parameter's shape): a copy
        on the CPU. A pipeline stage's block entries stay its own
        (`full_state_dict` gathers the stages)."""
        tensor = fsdp_lib.full_tensor(tensor).detach()
        rule = self.splits.get(name)
        if rule is not None and (like is None or tensor.shape == like.shape):
            parts = [torch.empty_like(tensor)
                     for _ in range(self.split_size)]
            dist.all_gather(parts, tensor.contiguous(),
                            group=self.split_group)
            tensor = tp_lib.join_tensors(parts, *rule)
        return tensor.to("cpu", copy=True)

    def _expand_blocks(self, names: List[str]) -> List[str]:
        """The single-device order of a stage's entry names: those before
        its blocks, every block's (the stage's first block's suffixes),
        those after."""
        first = self.layout.pp_rank * (self.depth // self.pp)
        head, suffixes, tail = [], [], []
        for name in names:
            if name.startswith("blocks."):
                index, suffix = name[len("blocks."):].split(".", 1)
                if int(index) == first:
                    suffixes.append(suffix)
            else:
                (tail if suffixes else head).append(name)
        return head + [f"blocks.{i}.{s}" for i in range(self.depth)
                       for s in suffixes] + tail

    def _gather_stages(self, entries: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """A stage's entries {name: CPU tensor} with every stage's blocks,
        in the single-device order (a collective over 'stage')."""
        per = self.depth // self.pp
        first = self.layout.pp_rank * per
        full = {}
        for name in self._expand_blocks(list(entries)):
            if not name.startswith("blocks."):
                full[name] = entries[name]
                continue
            index, suffix = name[len("blocks."):].split(".", 1)
            if int(index) >= per:
                continue  # filled by the gather of block index % per
            mine = entries[f"blocks.{first + int(index)}.{suffix}"]
            parts = [torch.empty_like(mine, device=self.device)
                     for _ in range(self.pp)]
            dist.all_gather(parts, mine.to(self.device).contiguous(),
                            group=self.layout.stage_group)
            for stage, part in enumerate(parts):
                full[f"blocks.{stage * per + int(index)}.{suffix}"] = \
                    part.to("cpu", copy=True)
        return {name: full[name] for name in self._expand_blocks(
            list(entries))}

    def full_state_dict(self, module: nn.Module) -> Dict[str, torch.Tensor]:
        """`module`'s state dict under the single-device names and shapes,
        gathered on every rank (a collective: every rank calls it); copies
        on the CPU."""
        if not self.distributed:
            return {name: t.detach().to("cpu", copy=True)
                    for name, t in module.state_dict().items()}
        out = {name: self.gather(name, t)
               for name, t in module.state_dict().items()}
        return self._gather_stages(out) if self.pp > 1 else out

    def full_gradients(self, module: nn.Module) -> Dict[str, torch.Tensor]:
        """The gradients of `module`'s parameters that have one, under the
        single-device names and shapes, gathered on every rank (a
        collective); copies on the CPU."""
        out = {name: self.gather(name, p.grad)
               for name, p in module.named_parameters()
               if p.grad is not None}
        return self._gather_stages(out) if self.pp > 1 else out

    def _piece(self, name: str, full: torch.Tensor,
               like: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the full tensor of entry `name`, laid out as
        `like` (a parameter of the wrapped model, or its state)."""
        rule = self.splits.get(name)
        if rule is not None:
            full = tp_lib.split_tensor(full, *rule, self.split_rank,
                                       self.split_size)
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
        want = self._expand_blocks(list(own)) if self.pp > 1 else own
        missing = set(want) ^ set(state)
        if missing:
            raise KeyError(f"state dict keys differ: {sorted(missing)}")
        for name, target in own.items():
            piece = self._piece(name, torch.as_tensor(state[name]), target)
            fsdp_lib.local(target).copy_(fsdp_lib.local(piece))

    def _param_names(self, params) -> List[str]:
        return [self.names.get(id(p), "") for p in params]

    def full_optimizer_state(self, optimizer: torch.optim.Optimizer,
                             params) -> dict:
        """`optimizer.state_dict()` with every state tensor of a
        parameter's layout gathered to the full parameter's, indexed as the
        single-device model's parameters (a collective)."""
        state = optimizer.state_dict()
        if not self.distributed:
            return state
        params = list(params)
        names = self._param_names(params)
        out = {}
        for index, entry in state["state"].items():
            p = params[index]
            out[index] = {
                k: (self.gather(names[index], v, p)
                    if torch.is_tensor(v) and v.dim() > 0 else v)
                for k, v in entry.items()}
        if self.pp == 1:
            return {"state": out, "param_groups": state["param_groups"]}
        # every stage's blocks, each state key gathered like the parameters
        by_name = {names[i]: entry for i, entry in out.items()}
        full_names = self._expand_blocks(names)
        keys = [k for entry in by_name.values() for k in entry]
        full = {name: {} for name in full_names}
        for key in dict.fromkeys(keys):
            tensors = {n: e[key] for n, e in by_name.items()
                       if torch.is_tensor(e.get(key)) and e[key].dim() > 0}
            if tensors:
                for n, v in self._gather_stages(tensors).items():
                    full[n][key] = v
        per, first = self.depth // self.pp, self.layout.pp_rank * (
            self.depth // self.pp)
        for name in full_names:  # the scalars of the stage's own block
            own = name
            if name.startswith("blocks."):
                index, suffix = name[len("blocks."):].split(".", 1)
                own = f"blocks.{first + int(index) % per}.{suffix}"
            for k, v in by_name.get(own, {}).items():
                full[name].setdefault(k, v)
        groups = [dict(g, params=list(range(len(full_names))))
                  for g in state["param_groups"]]
        return {"state": {i: full[n] for i, n in enumerate(full_names)
                          if full[n]},
                "param_groups": groups}

    def load_optimizer_state(self, optimizer: torch.optim.Optimizer,
                             params, state: dict) -> None:
        """Load a full optimizer state, each tensor of a parameter's shape
        re-sharded like its parameter (a pipeline stage takes its own
        parameters' entries)."""
        if not self.distributed or (getattr(optimizer, "full_state", False)
                                    and self.pp == 1):
            optimizer.load_state_dict(state)
            return
        params = list(params)
        names = self._param_names(params)
        full_names = (self._expand_blocks(names) if self.pp > 1 else names)
        local = {name: i for i, name in enumerate(names)}
        sharded = {}
        for index, entry in state["state"].items():
            name = full_names[int(index)]
            if name not in local:
                continue  # another stage's block
            p = params[local[name]]
            sharded[local[name]] = {
                k: (self._piece(name, v, p)
                    if torch.is_tensor(v) and v.dim() > 0 else v)
                for k, v in entry.items()}
        groups = state["param_groups"]
        if self.pp > 1:  # the stage's own parameters
            groups = [dict(g, params=list(range(len(params))))
                      for g in groups]
        optimizer.load_state_dict({"state": sharded, "param_groups": groups})
