"""Mixture-of-Experts MLP of the DiT (DiT-MoE style).

Counterpart of `diffusion_models_collection_tpu/models/moe.py` (`MoeMlp`,
`moe_capacity`): each block's dense MLP becomes a bank of `num_experts`
expert MLPs behind a top-k router, with the same semantics:

* the router is a float32 Linear(d, E) on x in float32, also under bf16, so
  routing decisions do not flip with the compute type; softmax, then top-k;
* capacity: each expert takes at most C = max(1, ceil(k S capacity_factor /
  E)) tokens of a batch row; positions are counted slot-major, then
  token-major (slot 0 of every token before slot 1 of any), and a
  (token, slot) past C contributes 0 (the block's residual carries it);
* the load-balance loss E sum_e f_e P_e (Switch Transformer eq. 4, 1 at
  perfect balance), with f_e the share of all routed slots choosing expert e
  before the capacity cut and P_e the mean router probability; the forward
  returns it beside its output (the JAX module sows it);
* experts: stacked w1 (E, d, h), b1 (E, h), w2 (E, h, d), b2 (E, d), exact
  GELU, dropout after the GELU and on the output; their products in the
  compute dtype.

Dispatch goes by index where the JAX module forms (B, S, E, C) one-hot
tensors for two einsums (shapes XLA tiles on the TPU's matrix unit): each
kept (token, slot) is copied into an (E, B * C, d) buffer, the expert MLPs
are two `torch.bmm`s over the expert axis, and each token gathers its slots'
outputs back and sums them, weighted by the gate values, in slot order (no
atomics: the same on every run). Empty buffer rows are zeros, and nobody
reads their outputs. At the CIFAR config's sampling batch (160 rows of 256
tokens, 8 experts, C 80) the one-hot tensors would be 105 MB a block and
each dispatch einsum about 20 GFLOP. These products are XLA einsums in the
JAX package, not Pallas kernels, so `torch.bmm` is their counterpart.

Under data parallelism (DDP, FSDP, and the data x expert ranks of expert
parallelism) the load-balance loss is the global batch's, as in the JAX
step, which is one program over the global batch: f and P are averaged over
the data-parallel group (`balance_group`, which the plan sets) before their
product, and every rank holds the same loss. Its gradient reaches each
rank's P as E f (not E f / N): the data-parallel average of the gradients
then applies the global loss's gradient once. Under expert parallelism
(`parallel/expert_parallel.py`) the module holds its rank's experts and
`expert_group`, which takes each chunk of the expert-major buffer to the
rank that holds its experts and the outputs back (two all-to-alls); the
routing is unchanged.

Parameter names are the port's own, since the reference has no MoE (the JAX
package's exporter refuses a MoE DiT): `router.weight` (E, d),
`router.bias` (E), `w1`, `b1`, `w2`, `b2` under `blocks.{i}.mlp`
(`utils/weights.py` maps the Flax `MoeMlp_0` onto them).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dropout


def moe_capacity(seq_len: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Per-group (per batch row) expert capacity, >= 1."""
    return max(1, math.ceil(top_k * seq_len * capacity_factor / num_experts))


def _expert_xavier_(t: torch.Tensor) -> torch.Tensor:
    """Xavier-uniform of each expert's (fan_in, fan_out) slice, as flax's
    `xavier_uniform(batch_axis=0)`."""
    fan_in, fan_out = t.shape[1], t.shape[2]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-bound, bound)


class MoeMlp(nn.Module):
    """Routed expert MLPs in place of the DiT's `Mlp`: (B, S, d) -> ((B, S,
    d), the call's load-balance loss, a differentiable float32 scalar)."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: int,
                 num_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if out_dim != dim:
            raise ValueError("MoeMlp requires out_dim == model dim "
                             f"({out_dim} != {dim})")
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"moe_top_k must lie in [1, {num_experts}], "
                             f"got {top_k}")
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.router = nn.Linear(dim, num_experts)
        nn.init.normal_(self.router.weight, std=0.02)
        nn.init.zeros_(self.router.bias)
        self.w1 = nn.Parameter(_expert_xavier_(
            torch.empty(num_experts, dim, hidden_dim)))
        self.b1 = nn.Parameter(torch.zeros(num_experts, hidden_dim))
        self.w2 = nn.Parameter(_expert_xavier_(
            torch.empty(num_experts, hidden_dim, dim)))
        self.b2 = nn.Parameter(torch.zeros(num_experts, dim))
        self.hidden_dropout = Dropout(dropout)
        self.hidden_dropout.experts = (0, num_experts)  # expert-major
        self.out_dropout = Dropout(dropout)
        # set by a parallel layout (`parallel/plan.py`): the data-parallel
        # group the load-balance loss averages over, and the expert group
        self.balance_group = None
        self.expert_group = None

    def route(self, x: torch.Tensor, expert: Optional[torch.Tensor] = None):
        """The routing of (B, S, d) tokens: gate values and experts (B, S,
        k) in top-k order, each (token, slot)'s position in its expert, and
        the load-balance loss. `expert` imposes the choices (a caller that
        holds two runs of one network to one routing, where near-ties could
        choose apart); the gates are then those experts' probabilities."""
        E, k = self.num_experts, self.top_k
        batch, seq = x.shape[:2]
        probs = torch.softmax(self.router(x.float()), dim=-1)  # (B, S, E)
        if expert is None:
            gate, expert = probs.topk(k, dim=-1)
        else:
            gate = probs.gather(-1, expert)
        onehot = F.one_hot(expert, E)  # (B, S, k, E)
        # tokens ahead of each (token, slot) at its expert, slot-major
        flat = onehot.transpose(1, 2).reshape(batch, k * seq, E)
        ahead = (flat.cumsum(dim=1) - flat).reshape(batch, k, seq, E)
        position = (ahead.transpose(1, 2) * onehot).sum(dim=-1)  # (B, S, k)
        f = onehot.sum(dim=2).float().mean(dim=(0, 1)) / k
        p_mean = probs.mean(dim=(0, 1))
        if self.balance_group is not None and self.training:
            # the global batch's f and P; P's gradient passes to this rank's
            # P unscaled (see the module docstring)
            both = self.balance_group.mean(torch.stack([f, p_mean.detach()]))
            f, p_mean = both[0], p_mean + (both[1] - p_mean).detach()
        load_balance = E * (f * p_mean).sum()
        return gate, expert, position, load_balance

    def forward(self, x: torch.Tensor):
        batch, seq, dim = x.shape
        E = self.num_experts
        cap = moe_capacity(seq, E, self.top_k, self.capacity_factor)
        gate, expert, position, load_balance = self.route(x)
        cdt = self.dtype or x.dtype
        keep = position < cap
        # each (token, slot)'s row of the (E, B * C) expert buffer; a dropped
        # one is copied to one spare row past it, which no expert reads (no
        # boolean indexing: the sizes stay static, nothing waits for the card)
        rows = torch.arange(batch, device=x.device)[:, None, None]
        slot = (expert * batch + rows) * cap + position.clamp(max=cap - 1)
        spare = E * batch * cap
        token = rows * seq + torch.arange(seq, device=x.device)[None, :, None]
        tokens = x.to(cdt).reshape(batch * seq, dim)
        buf = tokens.new_zeros(spare + 1, dim).index_copy(
            0, torch.where(keep, slot, spare).reshape(-1),
            tokens.index_select(0, token.expand_as(slot).reshape(-1)))
        expert_in = buf[:spare].view(E, batch * cap, dim)
        if self.expert_group is not None:  # this rank's experts' rows
            expert_in = self.expert_group.dispatch(expert_in)
        h = torch.baddbmm(self.b1.to(cdt)[:, None, :], expert_in,
                          self.w1.to(cdt))
        h = self.hidden_dropout(F.gelu(h, approximate="none"))
        out_e = torch.baddbmm(self.b2.to(cdt)[:, None, :], h,
                              self.w2.to(cdt))
        if self.expert_group is not None:  # every expert's, this rank's rows
            out_e = self.expert_group.combine(out_e)
        out_e = out_e.reshape(E * batch * cap, dim)
        # each token's slots, weighted by their gates; a dropped slot weighs 0
        weight = torch.where(keep, gate, torch.zeros_like(gate)).to(cdt)
        picked = out_e[slot.reshape(-1)].view(batch, seq, self.top_k, dim)
        out = (picked * weight[..., None]).sum(dim=2)
        return self.out_dropout(out), load_balance
