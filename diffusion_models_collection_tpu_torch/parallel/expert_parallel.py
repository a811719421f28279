"""Expert parallelism of the MoE DiT over a (data, expert) layout.

Counterpart of `diffusion_models_collection_tpu/parallel/expert_parallel.py`.
The JAX package shards the stacked expert weights' leading axis over an
'expert' mesh axis and lets XLA insert the token all-to-alls around the
expert einsums. Here each rank is a process (`parallel/mesh.py`: rank
d ep + e, every rank a data-parallel rank of the global batch) that holds
experts e E / ep .. (e + 1) E / ep - 1 of every `MoeMlp` (`w1`, `b1`, `w2`,
`b2`, `shard_experts`) and everything else whole, and the MoE calls the
all-to-alls itself (`ExpertGroup`):

* the port's dispatch buffer is expert-major (`models/moe.py`: slot
  (expert B + row) C + pos), so a rank's share for rank j is one
  contiguous chunk of experts; `dispatch` sends each chunk to its owner and
  returns (E / ep, ep B C, d), the rows of the group's ranks in rank order
  for this rank's experts; `combine` sends the experts' outputs back, (E,
  B C, d) on each rank; the spare row of dropped slots stays home;
* both are one `all_to_all_single` whose backward is the same exchange the
  other way, so an expert weight's gradient gathers its group's tokens;
* the routing and the capacity (per batch row) are unchanged.

Gradients (`parallel/plan.py`, at the update): the dense parameters'
average over every rank (the 'expert' axis is more data parallelism); an
expert weight's sum over the ranks that hold it ('data'), divided by the
world: each rank's loss is the mean over its rows. The load-balance loss is
the global batch's (`MoeMlp.balance_group`, every rank). Dropout draws the
one-device masks: the expert buffer's over (E, B_global C, H), of which a
rank keeps its experts and its group's rows (`models/layers.Dropout`).
Checkpoints gather the experts to the single-device names.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn

# the expert-stacked parameters of a MoeMlp (leading expert axis)
EXPERT_PARAMS = ("w1", "b1", "w2", "b2")


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """`all_to_all_single` of x over `group`: its first axis in equal
    chunks, chunk j to rank j of the group, chunk j of the result from rank
    j (NCCL and gloo both take CUDA tensors here)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """`all_to_all`, whose backward is the exchange of the cotangent the
    other way (equal chunks: the same call)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


class GroupMean:
    """A data-parallel group a module holds (copies share it): `mean` of a
    tensor over its `size` ranks, without a gradient."""

    def __init__(self, group, size: int):
        self.group, self.size = group, size

    def __deepcopy__(self, memo):
        return self

    @torch.no_grad()
    def mean(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous().clone()
        dist.all_reduce(x, group=self.group)
        return x / self.size


class ExpertGroup:
    """The expert group of a rank, `size` ranks whose experts make up one
    bank: `dispatch` and `combine` of the MoE's expert-major buffers."""

    def __init__(self, group, size: int):
        self.group, self.size = group, size

    def __deepcopy__(self, memo):
        return self

    def dispatch(self, x: torch.Tensor) -> torch.Tensor:
        """(E, n, d), this rank's n buffer rows of every expert -> (E /
        size, size n, d), every rank's rows of this rank's experts."""
        experts, n = x.shape[:2]
        y = _AllToAll.apply(x, self.group)
        y = y.view(self.size, experts // self.size, n, *x.shape[2:])
        return y.transpose(0, 1).reshape(experts // self.size,
                                         self.size * n, *x.shape[2:])

    def combine(self, y: torch.Tensor) -> torch.Tensor:
        """The inverse of `dispatch`: (E / size, size n, d) -> (E, n, d)."""
        local, rows = y.shape[:2]
        n = rows // self.size
        y = y.view(local, self.size, n, *y.shape[2:]).transpose(0, 1)
        y = _AllToAll.apply(y.contiguous(), self.group)
        return y.reshape(self.size * local, n, *y.shape[3:])


def check_expert_parallel(model: nn.Module, ep: int) -> None:
    """The JAX trainer's rules for `expert_parallel`, with its messages: a
    MoE model whose experts split evenly."""
    num_experts = int(getattr(model, "num_experts", 0) or 0)
    if num_experts <= 0:
        raise ValueError("expert_parallel > 1 needs a MoE model (DiT with "
                         "num_experts > 0)")
    if num_experts % ep:
        raise ValueError(f"num_experts {num_experts} not divisible by "
                         f"expert_parallel={ep}")


def shard_experts(model: nn.Module, rank: int,
                  size: int) -> Dict[str, Tuple[int, int]]:
    """Cut every `MoeMlp` of `model` to rank `rank`'s experts of `size`
    ranks, in place (its own weights' slices along the expert axis), and
    return the state-dict entries split, {name: (0, 1)} (the axis and
    blocks of `tensor_parallel.split_tensor`), which the gathers and the
    clip read."""
    from ..models.moe import MoeMlp

    splits = {}
    for name, module in model.named_modules():
        if not isinstance(module, MoeMlp):
            continue
        local = module.num_experts // size
        for key in EXPERT_PARAMS:
            full = getattr(module, key)
            setattr(module, key, nn.Parameter(
                full.detach()[rank * local:(rank + 1) * local].clone()))
            splits[f"{name}.{key}"] = (0, 1)
    return splits
