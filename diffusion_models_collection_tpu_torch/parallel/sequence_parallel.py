"""Sequence parallelism of the DiT over a (data, seq) layout.

Counterpart of `diffusion_models_collection_tpu/parallel/sequence_parallel.py`.
The patch-token axis is split over the 'seq' ranks of a model group
(`parallel/mesh.py`: the S seq ranks share their data rank's rows, rank s
holding tokens s L / S .. (s + 1) L / S - 1). Everything token-local
(LayerNorm, adaLN modulation, the MLP) runs on a rank's L / S tokens;
attention keeps the rank's queries and all-gathers K and V over 'seq' in
each block (`gather_tokens`), so a rank's attention is Lq = L / S queries
against Lk = L keys: the kernels' E6 form (`ops/flash_attention.py`), its
dropout rows keyed on the global token row (`row0`). The prologue (patch
embedding, position embedding, timestep and label embeddings) runs whole on
every rank, as in JAX; the final layer runs on the rank's tokens and its
output is gathered over 'seq' (`gather_output`) before the unpatchify, so
every rank returns the whole eps of its rows.

The backward: the K/V gather sums each rank's dK and dV back to their
owners (an all-reduce and this rank's slice: gloo has no reduce-scatter);
the output gather hands back this rank's slice of the cotangent, unsummed,
because every seq rank computes the loss on the whole gathered eps alike.
Each rank is then left with its tokens' share of every parameter's
gradient (the conditioning feeds every token, so its share too), and the
plan (`parallel/plan.py`) sums the gradients over 'seq' before it averages
them over 'data'. Parameters stay replicated: checkpoints, EMA and optimizer
state keep the single-device names, and rank 0 writes them.

Dropout: the attention's masks by the kernels' global (batch, head, row)
key; an activation dropout draws the single-device mask over the global
batch and all L tokens and keeps its rows and tokens (`models/layers.Dropout`
with `token_rank`), so a sharded step with dropout on is the one-device
step. `remat` checkpoints each block as the JAX apply does.

The models run it themselves: `DiT.forward` and `DiM.forward` take `seq`,
this rank's `SeqGroup`, and then slice the tokens, hand the group to their
blocks and gather the output. `make_sequence_parallel_apply(model, layout)`
returns apply(x, t, y=None) -> eps on the rank's rows, the forward with the
group, for either model.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from .mesh import Layout


class SeqGroup:
    """The 'seq' group of a rank: its process group, its rank in it and the
    group's size. A module may hold it (copies share it, as `GroupRef`)."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def __deepcopy__(self, memo):
        return self

    @classmethod
    def of(cls, layout: Layout) -> "SeqGroup":
        return cls(layout.sp_group, layout.sp_rank, layout.sp)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's tokens of x (B, L, ...) (`token_slice`)."""
        return token_slice(x, self)

    def gather_kv(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's tokens of K or V (`gather_tokens`)."""
        return gather_tokens(x, self)

    def gather_output(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's tokens of the final layer's output
        (`gather_output`)."""
        return gather_output(x, self)


def all_gather(x: torch.Tensor, seq: SeqGroup) -> list:
    """Every rank's x over the group, in rank order (no gradient)."""
    parts = [torch.empty_like(x) for _ in range(seq.size)]
    dist.all_gather(parts, x.contiguous(), group=seq.group)
    return parts


def _own(x: torch.Tensor, seq: SeqGroup, dim: int) -> torch.Tensor:
    return x.chunk(seq.size, dim)[seq.rank].contiguous()


class _GatherTokens(torch.autograd.Function):
    """All-gather along `dim` (tiled); backward: the sum of every rank's
    cotangent of this rank's slice (all-reduce, then the slice)."""

    @staticmethod
    def forward(ctx, x, seq, dim):
        ctx.seq, ctx.dim = seq, dim
        return torch.cat(all_gather(x, seq), dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.seq.group)
        return _own(g, ctx.seq, ctx.dim), None, None


class _GatherOutput(torch.autograd.Function):
    """All-gather along `dim` (tiled); backward: this rank's slice of the
    cotangent, which every rank holds alike."""

    @staticmethod
    def forward(ctx, x, seq, dim):
        ctx.seq, ctx.dim = seq, dim
        return torch.cat(all_gather(x, seq), dim)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.seq, ctx.dim), None, None


def gather_tokens(x: torch.Tensor, seq: SeqGroup, dim: int = 1):
    """Every rank's tokens of x in rank order (the JAX `all_gather(...,
    tiled=True)` of K and V), whose gradient sums back to each owner."""
    return _GatherTokens.apply(x, seq, dim)


def gather_output(x: torch.Tensor, seq: SeqGroup, dim: int = 1):
    """Every rank's tokens of an output that every rank then uses alike
    (the final layer's): the gradient of this rank's slice is its slice of
    the cotangent."""
    return _GatherOutput.apply(x, seq, dim)


def token_slice(x: torch.Tensor, seq: SeqGroup) -> torch.Tensor:
    """This rank's tokens s L / S .. of x (B, L, ...)."""
    n = x.shape[1] // seq.size
    return x[:, seq.rank * n:(seq.rank + 1) * n]


def check_tokens(num_patches: int, sp: int) -> int:
    """The tokens a rank holds; the JAX assertion's message when L does not
    divide by S."""
    if num_patches % sp:
        raise ValueError(f"{num_patches} patch tokens not divisible by "
                         f"sequence_parallel={sp}")
    return num_patches // sp


def make_sequence_parallel_apply(model: nn.Module,
                                 layout: Layout) -> Callable:
    """apply(x, t, y=None) -> eps of a DiT or a DiM over `layout`'s (data,
    seq) ranks (JAX `make_sequence_parallel_apply`, with the scaffold of its
    `make_token_sharded_apply`): the model's own forward given this rank's
    'seq' group, after the model's own checks (`check_sequence_parallel`).
    The forward runs the prologue whole, the blocks on the rank's tokens
    (the DiT's attention with K and V gathered, the DiM's mixer with the
    conv's halo and the distributed scan), each under checkpointing with
    `model.remat`, and the final layer, whose output it gathers."""
    model.check_sequence_parallel(layout.sp)
    return functools.partial(model, seq=SeqGroup.of(layout))
