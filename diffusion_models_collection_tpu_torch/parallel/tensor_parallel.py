"""Megatron tensor parallelism of the DiT and the DiM over the 'model' axis.

Counterpart of `diffusion_models_collection_tpu/parallel/tensor_parallel.py`.
The JAX package writes the Megatron rules as GSPMD shardings and XLA inserts
one all-reduce a block half. Here a rank holds its slices as plain
parameters and computes on them: `shard_model` cuts each attention, MLP
and Mamba mixer to its slices in place, their own forwards unchanged, and
puts the collectives (Megatron's f and g: `copy_to_model`, identity forward
and all-reduce backward, before a column-parallel product;
`reduce_from_model`, all-reduce forward and identity backward, after a
row-parallel one) into the linears it swaps in, and into the attention's
fused in-projection through its `model_group`.

The rules (`tp_rule`, by state-dict name, the JAX `_spec_for_path`):

* DiT attention: `in_proj_weight` (3D, D) and its bias split per head within
  each of q, k and v (rows [q; k; v]: rank r holds heads r H/tp .. (r + 1)
  H/tp - 1 of each), so the port's fused projection is not cut across q and
  k; `out_proj` row-parallel, its bias added once after the reduce.
* MLP (the DiT's, the DiM's feed-forward): fc1 (`mlp.0`) column-parallel,
  fc2 (`mlp.3`) row-parallel; the hidden dropout draws the columns of the
  whole hidden width that the rank holds (`models/layers.Dropout`).
* DiM Mamba: `in_proj` (2 d_inner, D) split per channel within each of x
  and z; `conv1d`, `A_log`, `D` and `dt_proj` per channel; `x_proj`
  row-parallel, its (dt, B, C) all-reduced before the scan and reduced
  again in the backward (every rank's channels read them); `out_proj`
  row-parallel. The scan runs unchanged on the rank's d_inner / tp
  channels (`ops/selective_scan.py`).
* Embedders, adaLN, norms, the final layer and a MoE bank stay replicated:
  every rank of a model group computes them alike, and their gradients are
  the same on each.

Attention dropout keys each head's mask on its global head (`head0`), so a
rank draws the single-device run's masks for its heads.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..models.dim import Mamba
from ..models.dit import Mlp, SelfAttention
from ..models.layers import CastConv1d, CastLinear, Dropout, cast_linear


# ------------------------------------------------------------ collectives
class GroupRef:
    """A process group held by a module: a copy of the module (the EMA's
    `deepcopy`) shares the group, which cannot be copied. `copy_to_model`
    is f on it (what `SelfAttention` calls before its in-projection)."""

    def __init__(self, group):
        self.group = group

    def __deepcopy__(self, memo):
        return self

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to_model(x, self)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity gradient."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group: GroupRef) -> torch.Tensor:
    """The input of a column-parallel product (f)."""
    return _CopyToModel.apply(x, group.group)


def reduce_from_model(x: torch.Tensor, group: GroupRef) -> torch.Tensor:
    """The sum over the model group of a row-parallel product's partial
    outputs (g)."""
    return _ReduceFromModel.apply(x, group.group)


# ------------------------------------------------------------------ rules
_RULES = (
    # (name pattern, split axis, blocks along it)
    (r"(attn|mamba)\.in_proj_(weight|bias)$", 0, 3),
    (r"(attn|mamba)\.out_proj\.weight$", 1, 1),
    (r"mlp\.0\.(weight|bias)$", 0, 1),
    (r"mlp\.3\.weight$", 1, 1),
    (r"mamba\.in_proj\.weight$", 0, 2),
    (r"mamba\.(conv1d\.(weight|bias)|dt_proj\.(weight|bias)|A_log|D)$", 0, 1),
    (r"mamba\.x_proj\.weight$", 1, 1),
)


def tp_rule(name: str) -> Optional[Tuple[int, int]]:
    """(axis, blocks) of a DiT/DiM state-dict entry split over the model
    group, or None for a replicated one: the axis is cut into `blocks` equal
    blocks (q, k, v; or x, z) and each block into tp slices, rank r taking
    slice r of every block."""
    if not name.startswith("blocks."):
        return None
    for pattern, axis, blocks in _RULES:
        if re.search(pattern, name):
            return axis, blocks
    return None


def split_tensor(full: torch.Tensor, axis: int, blocks: int, rank: int,
                 size: int) -> torch.Tensor:
    """Rank `rank`'s slice of `full` under (axis, blocks) at `size` ranks."""
    if full.shape[axis] % (blocks * size):
        raise ValueError(f"axis {axis} of {tuple(full.shape)} does not split "
                         f"into {blocks} blocks over {size} ranks")
    parts = [block.chunk(size, axis)[rank]
             for block in full.chunk(blocks, axis)]
    return torch.cat(parts, axis).contiguous()


def join_tensors(parts: Sequence[torch.Tensor], axis: int,
                 blocks: int) -> torch.Tensor:
    """The full tensor of every rank's slice, in rank order (the inverse of
    `split_tensor`)."""
    pieces = [p.chunk(blocks, axis) for p in parts]
    return torch.cat([pieces[r][b] for b in range(blocks)
                      for r in range(len(parts))], axis)


# ---------------------------------------------------------------- modules
class ColumnParallelLinear(CastLinear):
    """A linear whose output features are this rank's slice: f on the
    input, then the local product."""

    def __init__(self, in_features: int, out_features: int, group,
                 bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias,
                         compute_dtype=compute_dtype)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(copy_to_model(x, self.group))


class RowParallelLinear(CastLinear):
    """A linear whose input features are this rank's slice: the local
    product, the all-reduce (g), then the bias, once."""

    def __init__(self, in_features: int, out_features: int, group,
                 bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias,
                         compute_dtype=compute_dtype)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = reduce_from_model(
            cast_linear(x, self.weight, None, self.compute_dtype), self.group)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class SharedRowParallelLinear(RowParallelLinear):
    """A row-parallel product whose sum every rank's channels read (the
    DiM's x_proj: dt, B and C): reduced in the forward (g), and its gradient
    reduced in the backward (f)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to_model(super().forward(x), self.group)


def _local_parameter(param: nn.Parameter, rows: int) -> nn.Parameter:
    """An uninitialised parameter of `param`'s shape with `rows` rows."""
    return nn.Parameter(param.new_empty((rows, *param.shape[1:])))


def _tp_attention(attn: SelfAttention, group, rank: int, size: int) -> None:
    """`attn` on heads r H/tp .. (r + 1) H/tp - 1, in place: its fused
    (3 D/tp, D) in-projection takes f (`model_group`), `out_proj` turns
    row-parallel."""
    if attn.num_heads % size:
        raise ValueError(f"{attn.num_heads} heads do not split over "
                         f"tensor_parallel={size}")
    if attn.quant is not None:
        raise ValueError("quant='int8' is inference-only and has no "
                         "tensor-parallel form")
    dim = attn.in_proj_weight.shape[1]
    local = dim // size
    attn.total_heads = attn.num_heads
    attn.num_heads //= size
    attn.head0 = rank * attn.num_heads
    attn.model_group = group
    attn.in_proj_weight = _local_parameter(attn.in_proj_weight, 3 * local)
    attn.in_proj_bias = _local_parameter(attn.in_proj_bias, 3 * local)
    attn.out_proj = RowParallelLinear(local, dim, group,
                                      compute_dtype=attn.dtype)


def _tp_mamba(mamba: Mamba, group, size: int) -> None:
    """`mamba` on its rank's d_inner / tp channels, in place: in_proj
    column-parallel (x and z each cut per channel), conv1d, dt_proj, A_log
    and D per channel, x_proj and out_proj row-parallel."""
    d_inner, d_state = mamba.A_log.shape
    if d_inner % size:
        raise ValueError(f"d_inner {d_inner} does not split over "
                         f"tensor_parallel={size}")
    local = d_inner // size
    dtype = mamba.in_proj.compute_dtype
    d_model = mamba.in_proj.in_features
    d_conv = mamba.conv1d.kernel_size[0]
    mamba.in_proj = ColumnParallelLinear(d_model, 2 * local, group,
                                         bias=False, compute_dtype=dtype)
    mamba.conv1d = CastConv1d(local, local, d_conv, groups=local,
                              padding=d_conv - 1, compute_dtype=dtype)
    mamba.x_proj = SharedRowParallelLinear(local, mamba.dt_rank + 2 * d_state,
                                           group, bias=False,
                                           compute_dtype=dtype)
    mamba.dt_proj = CastLinear(mamba.dt_rank, local, compute_dtype=dtype)
    mamba.A_log = _local_parameter(mamba.A_log, local)
    mamba.D = _local_parameter(mamba.D, local)
    mamba.out_proj = RowParallelLinear(local, d_model, group, bias=False,
                                       compute_dtype=dtype)


def _tp_mlp(mlp: Mlp, group, rank: int, size: int) -> None:
    """`mlp` with fc1 column-parallel and fc2 row-parallel, in place."""
    fc1, drop, fc2 = mlp[0], mlp[2], mlp[3]
    hidden = fc1.out_features
    if hidden % size:
        raise ValueError(f"MLP width {hidden} does not split over "
                         f"tensor_parallel={size}")
    local = hidden // size
    mlp[0] = ColumnParallelLinear(fc1.in_features, local, group,
                                  compute_dtype=fc1.compute_dtype)
    mlp[3] = RowParallelLinear(local, fc2.out_features, group,
                               compute_dtype=fc2.compute_dtype)
    if isinstance(drop, Dropout):
        drop.features = (rank * local, hidden)
        drop.width = local


def shard_model(model: nn.Module, group, rank: int,
                size: int) -> Dict[str, Tuple[int, int]]:
    """Cut `model` (on the CPU or its device) to rank `rank`'s
    tensor-parallel slices over `group` of `size` ranks, in place: each
    attention, MLP and Mamba mixer of its blocks cut as the rules say,
    holding `split_tensor` of the model's own weights. Returns the
    state-dict entries it split, {name: (axis, blocks)}, which the gathers
    and the clip read. A model without such blocks (a UNet) is left whole
    and returns {}: its parameters stay replicated, as the JAX rules leave
    them."""
    if size == 1:
        return {}
    from ..utils.weights import tp_shard_state_dict

    group = GroupRef(group)
    full = {k: v.detach().clone() for k, v in model.state_dict().items()}
    device = next(model.parameters()).device
    # the new modules' throwaway init must not move torch's generator, which
    # draws the dropout masks alike on every rank
    cut = False
    with torch.random.fork_rng(devices=[]):
        for name, module in list(model.named_modules()):
            if not name.startswith("blocks."):
                continue
            if isinstance(module, SelfAttention):
                _tp_attention(module, group, rank, size)
            elif isinstance(module, Mamba):
                _tp_mamba(module, group, size)
            elif isinstance(module, Mlp):
                _tp_mlp(module, group, rank, size)
            else:
                continue
            cut = True
    if not cut:
        return {}
    model.to(device)
    model.load_state_dict(tp_shard_state_dict(full, rank, size))
    return {name: rule for name in full
            if (rule := tp_rule(name)) is not None}
