"""Sequence parallelism of the DiM (Mamba) over a (data, seq) layout.

Counterpart of `diffusion_models_collection_tpu/parallel/dim_sequence_parallel
.py`. The tokens split over 'seq' as the DiT's do (`parallel/sequence_parallel
.py`: `DiM.forward` given the rank's group slices them, runs the blocks on
them and gathers the final layer's output), and `models/dim.py`'s `Mamba`,
given the group, runs on a rank's L / S tokens with the pieces of this
module:

* the causal depthwise conv takes a halo of the last `CONV_HALO` tokens of
  the left neighbour (zeros on rank 0: the causal padding), in place of the
  left padding of `models/dim.py`'s `Mamba`; its backward returns the
  halo's gradient to the neighbour (`halo_exchange`);
* the selective scan runs distributed (`distributed_selective_scan`): each
  rank scans its tokens from a zero state for its end state h_tot, with a_tot
  = exp(A sum_t dt_t) the product of its decays; the (a_tot, h_tot) of every
  rank are gathered, the exclusive combine over the ranks before this one
  gives the state entering it, h_in, and a second scan from h_in gives y.
  Both scans are the stated kernels (E4, `ops/selective_scan.py`
  `selective_scan_end_state`, `selective_scan_with_state`), the first
  without y. The cross-rank step (`_CarryIn`) is one autograd Function whose
  backward every rank runs: each rank's cotangents of the gathered pairs are
  summed over 'seq' (an all-reduce) and each rank keeps its own pair's.

Under `remat` each block is checkpointed; its stated scans keep their block
states (there is no stated K7): the recompute holds them only inside the
block's backward. Parameters stay replicated, as the DiT's. `check_halo` is
the rule that a rank holds at least the halo.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import selective_scan as scan_ops
from .sequence_parallel import (SeqGroup, all_gather,
                                make_sequence_parallel_apply)

# The DiM builds its Mamba with d_conv 4 (models/dim.py); the halo is the
# d_conv - 1 tokens the causal conv reads before a rank's first token.
D_CONV = 4
CONV_HALO = D_CONV - 1

# The stated scans' call sites, which `ops.plain.plain_kernels` reroutes.
selective_scan_with_state = scan_ops.selective_scan_with_state
selective_scan_end_state = scan_ops.selective_scan_end_state


def affine_combine(left, right):
    """The affine maps h -> a h + b composed, left then right (JAX
    `_affine_combine`)."""
    a_l, b_l = left
    a_r, b_r = right
    return a_r * a_l, a_r * b_l + b_r


def _carry_in(a_all: torch.Tensor, h_all: torch.Tensor,
              rank: int) -> torch.Tensor:
    """The state entering rank `rank`: the inclusive combine of ranks 0 ..
    rank - 1 (zeros for rank 0)."""
    if rank == 0:
        return torch.zeros_like(h_all[0])
    acc = (a_all[0], h_all[0])
    for r in range(1, rank):
        acc = affine_combine(acc, (a_all[r], h_all[r]))
    return acc[1]


class _CarryIn(torch.autograd.Function):
    """h_in of this rank from every rank's (a_tot, h_tot), gathered over
    'seq'; the backward sums the pairs' cotangents over 'seq'."""

    @staticmethod
    def forward(ctx, a_tot, h_tot, seq):
        ctx.seq = seq
        a_all = torch.stack(all_gather(a_tot, seq))
        h_all = torch.stack(all_gather(h_tot, seq))
        ctx.save_for_backward(a_all, h_all)
        return _carry_in(a_all, h_all, seq.rank)

    @staticmethod
    def backward(ctx, g):
        a_all, h_all = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            h_in = _carry_in(a_all, h_all, ctx.seq.rank)
        if h_in.requires_grad:
            ga, gh = torch.autograd.grad(h_in, (a_all, h_all), g,
                                         allow_unused=True)
        else:  # rank 0: nothing before it
            ga = gh = None
        grads = torch.stack([torch.zeros_like(a_all) if ga is None else ga,
                             torch.zeros_like(h_all) if gh is None else gh])
        dist.all_reduce(grads, group=ctx.seq.group)
        return grads[0, ctx.seq.rank], grads[1, ctx.seq.rank], None


def distributed_selective_scan(x, dt, A, B, C, D=None, *, seq: SeqGroup):
    """The selective scan of a sequence split over `seq`'s ranks (JAX
    `distributed_selective_scan`): x, dt (batch, L / S, D), B, C (batch,
    L / S, N) a rank's tokens; y (with the D skip when given) of those
    tokens, the whole sequence's scan regrouped at the shard edges."""
    zero = x.new_zeros(x.shape[0], x.shape[2], A.shape[1])
    # the rank's decay product exp(A sum_t dt_t) and end state from zero
    a_tot = torch.exp(torch.einsum("bld,dn->bdn", dt, A))
    h_tot = selective_scan_end_state(x, dt, A, B, C, zero)
    h_in = _CarryIn.apply(a_tot, h_tot, seq)
    y, _ = selective_scan_with_state(x, dt, A, B, C, h_in)
    if D is not None:
        y = y + x * D
    return y


class _Halo(torch.autograd.Function):
    """The left neighbour's last CONV_HALO tokens (zeros on rank 0); the
    backward hands each rank's halo gradient back to its neighbour."""

    @staticmethod
    def forward(ctx, tail, seq):
        ctx.seq = seq
        parts = all_gather(tail, seq)
        return (parts[seq.rank - 1] if seq.rank > 0
                else torch.zeros_like(tail))

    @staticmethod
    def backward(ctx, g):
        seq = ctx.seq
        parts = all_gather(g, seq)
        return (parts[seq.rank + 1] if seq.rank + 1 < seq.size
                else torch.zeros_like(g)), None


def halo_exchange(x: torch.Tensor, seq: SeqGroup) -> torch.Tensor:
    """x (B, l, C) of a rank with the left neighbour's last CONV_HALO tokens
    before it: (B, CONV_HALO + l, C)."""
    return torch.cat([_Halo.apply(x[:, -CONV_HALO:], seq), x], dim=1)


def check_halo(num_patches: int, sp: int) -> None:
    """A rank must hold at least the halo: the exchange reads the immediate
    left neighbour only."""
    if num_patches // sp < CONV_HALO:
        raise ValueError(f"{num_patches // sp} local tokens per shard < the "
                         f"causal-conv halo ({CONV_HALO}) — lower "
                         "sequence_parallel")


# The DiM's apply is the shared one: `DiM.forward` with the 'seq' group runs
# each `Mamba` through `halo_exchange` and `distributed_selective_scan`.
make_dim_sequence_parallel_apply = make_sequence_parallel_apply
