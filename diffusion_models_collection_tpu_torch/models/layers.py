"""Shared building blocks of the denoiser backbones.

Counterpart of `diffusion_models_collection_tpu/models/layers.py`: the
UNet's time embedding, and the patch-token scaffolding that DiT and DiM
share (timestep embedder, patch embedding, `unpatchify`, adaLN modulation).
Module and parameter names follow the PyTorch reference, so the reference's
`state_dict` keys load with `strict=True`. Images are NHWC, tokens (B, L, D).

Mixed precision, as the JAX package's `dtype` field (`models/layers.py`):
a module built with a compute `dtype` (torch.bfloat16) runs its linears,
convolutions and activations in that type while its parameters stay float32:
`CastLinear`, `CastConv1d`, `CastConv2d` cast the input, weight and bias at
each call, as flax's `Dense`/`Conv(dtype=...)` do, and `CastLayerNorm`
normalises in float32 and casts only its output, as flax's
`LayerNorm(dtype=...)`. `dtype=None` is float32, unchanged. Sinusoidal
embeddings compute their trig in float32 and cast only the result.

`Dropout` is every model's activation dropout: its mask is drawn over the
global batch of a data-parallel run (over the whole last axis of a
tensor-parallel one, over all the tokens of a sequence-parallel one, over
every expert and row of a MoE's expert buffer), so a sharded run draws the
single-device run's masks; a pipeline stage draws them in the one-device
order before its microbatches run.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


def cast_linear(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor],
                dtype: Optional[torch.dtype]) -> torch.Tensor:
    """`F.linear` in `dtype`: x, weight and bias cast to it (None: as they
    are)."""
    if dtype is None:
        return F.linear(x, weight, bias)
    return F.linear(x.to(dtype), weight.to(dtype),
                    None if bias is None else bias.to(dtype))


class _MaskedScale(torch.autograd.Function):
    """x * keep * scale with a bool `keep`: `F.dropout`'s own masked scale
    (`native_dropout_backward`) each way, with only the one-byte mask saved
    for the backward, as `F.dropout` saves it (autograd's formula for
    `native_dropout_backward` called directly would also save x)."""

    @staticmethod
    def forward(ctx, x, keep, scale):
        ctx.save_for_backward(keep)
        ctx.scale = scale
        return torch.ops.aten.native_dropout_backward(x, keep, scale)

    @staticmethod
    def backward(ctx, grad):
        keep, = ctx.saved_tensors
        return (torch.ops.aten.native_dropout_backward(grad, keep, ctx.scale),
                None, None)


class Dropout(nn.Dropout):
    """`nn.Dropout` (no parameters, the same place in a state dict) whose
    mask is one bool Bernoulli(1 - p) draw from torch's generator over the
    global tensor: a data-parallel rank, `data_rank` of `data_ranks`, draws
    the mask of all ranks' rows, (data_ranks * B, ...), and keeps a copy of
    rows data_rank * B ..; with `features` = (first, total), a
    tensor-parallel rank's last axis is columns first .. of `total`. Every
    rank seeds that generator alike, so a sharded run draws exactly the
    masks the single-device run draws on the same global batch, and no two
    ranks share one: what the JAX package's dropout does under GSPMD. A
    sequence-parallel rank, `token_rank` of `token_ranks`, holds tokens
    token_rank * l .. of a (B, l, ...) tensor: its mask is the slice of one
    drawn over all token_ranks * l tokens. Kept
    values are scaled by 1 / (1 - p) in `F.dropout`'s own masked scale,
    which saves the one-byte mask as `F.dropout` does. One device draws only
    its own mask; a sharded rank draws the global mask for the moment of
    the draw (data_ranks times its own) and keeps a copy of its slice.

    A MoE's expert buffer (E, rows * C, H) is expert-major: `experts` =
    (first, total) says so, and that the tensor holds experts first .. of
    `total`. Its mask is the one-device draw (total, data_ranks * rows * C,
    H), of which the rank keeps its experts and rows data_rank * rows * C ..
    (an expert-parallel rank: its group's rows, `data_rank` its group).

    A pipeline stage (`parallel/pipeline_parallel.py`) draws the step's
    masks before its forward, in the one-device order, and hands this
    module its rows of the mask (`replayed`, `draw` gives it); each
    microbatch call then takes rows `replay_row0` .. of it. `width` is the
    last axis of the tensors the module is given (the owner sets it), which
    such a draw needs."""

    def __init__(self, p: float = 0.5):
        super().__init__(p)
        self.data_rank, self.data_ranks = 0, 1
        self.token_rank, self.token_ranks = 0, 1
        self.features: Optional[tuple] = None
        self.experts: Optional[tuple] = None
        self.width: Optional[int] = None
        self.replayed: Optional[torch.Tensor] = None
        self.replay_row0 = 0

    def draw(self, shape, device) -> torch.Tensor:
        """This rank's mask of a tensor of `shape`, sliced from the one draw
        of the global tensor (see the class docstring)."""
        if self.experts is not None:
            first, total = self.experts
            n = shape[1]
            keep = torch.empty((total, n * self.data_ranks, *shape[2:]),
                               dtype=torch.bool, device=device
                               ).bernoulli_(1.0 - self.p)
            if self.data_ranks > 1 or shape[0] != total:
                keep = keep[first:first + shape[0],
                            self.data_rank * n:(self.data_rank + 1) * n
                            ].contiguous()
            return keep
        rows, width = shape[0], shape[-1]
        first, total = self.features or (0, width)
        mid = list(shape[1:-1])
        tokens = self.token_ranks > 1 and len(mid) > 0
        if tokens:
            mid[0] *= self.token_ranks
        keep = torch.empty((rows * self.data_ranks, *mid, total),
                           dtype=torch.bool, device=device
                           ).bernoulli_(1.0 - self.p)
        if tokens:
            n = shape[1]
            keep = keep[:, self.token_rank * n:(self.token_rank + 1) * n]
        if self.data_ranks > 1 or total != width or tokens:
            keep = keep[self.data_rank * rows:(self.data_rank + 1) * rows,
                        ..., first:first + width].contiguous()
        return keep

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.replayed is not None:
            keep = self.replayed[self.replay_row0:
                                 self.replay_row0 + x.shape[0]]
        else:
            keep = self.draw(x.shape, x.device)
        return _MaskedScale.apply(x, keep, 1.0 / (1.0 - self.p))


class CastLinear(nn.Linear):
    """`nn.Linear` (same parameters and names) that computes in
    `compute_dtype` when one is given (flax `Dense(dtype=...)`)."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return cast_linear(x, self.weight, self.bias, self.compute_dtype)


class _CastConv:
    """The cast of `CastConv1d` and `CastConv2d` (flax `Conv(dtype=...)`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return self._conv_forward(
            x.to(dt), self.weight.to(dt),
            None if self.bias is None else self.bias.to(dt))


class CastConv1d(_CastConv, nn.Conv1d):
    """`nn.Conv1d` that computes in `compute_dtype` when one is given."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype


class CastConv2d(_CastConv, nn.Conv2d):
    """`nn.Conv2d` that computes in `compute_dtype` when one is given."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype


class CastLayerNorm(nn.LayerNorm):
    """`nn.LayerNorm` whose statistics, normalisation and affine run in
    float32 on the (widened) input, the result cast to `compute_dtype` when
    one is given (flax `LayerNorm(dtype=...)`)."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


def run_block(block: nn.Module, remat: bool, *args):
    """`block(*args)`; with `remat` and a gradient being recorded, under
    gradient checkpointing (the JAX package's `nn.remat(Block)`): the
    block's activations are dropped after the forward and recomputed in the
    backward, with the dropout draws of the first run. The block's
    parameter names are untouched, so checkpoints load either way."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False)
    return block(*args)


def sinusoidal_time_embedding_unet(t: torch.Tensor, dim: int) -> torch.Tensor:
    """UNet-style sinusoidal embedding: freqs exp(-arange(half) *
    ln(10000) / (half - 1)), concat [sin, cos]. The trig runs in float32
    whatever the model's compute type: t spans [0, 1000)."""
    half = dim // 2
    scale = math.log(10000.0) / (half - 1)
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device) * -scale)
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class SinusoidalTimeEmbedding(nn.Module):
    """(B,) timesteps -> (B, dim) sinusoidal features; no parameters."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return sinusoidal_time_embedding_unet(t, self.dim)


class UNetTimeEmbed(nn.Sequential):
    """Sinusoidal features -> Linear -> SiLU -> Linear, to 4 * model_channels
    (the reference's `time_embed` Sequential, so its keys are
    `time_embed.1.*` and `time_embed.3.*`); the linears in `dtype`."""

    def __init__(self, model_channels: int,
                 dtype: Optional[torch.dtype] = None):
        dim = model_channels * 4
        super().__init__(
            SinusoidalTimeEmbedding(model_channels),
            CastLinear(model_channels, dim, compute_dtype=dtype),
            nn.SiLU(),
            CastLinear(dim, dim, compute_dtype=dtype),
        )


class LabelEmbedder(nn.Module):
    """Class-label table with the CFG null label at row 0.

    Labels arrive shifted by +1; 0 is the unconditional label. Row 0 is zero
    at init and the lookup output is masked where y == 0, as the JAX package
    does (`models/layers.py:127-129`): torch's `padding_idx` only freezes
    the row's gradient, so it agrees only while the row stays zero.
    """

    def __init__(self, num_classes: int, hidden_size: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.weight = nn.Parameter(torch.randn(num_classes + 1, hidden_size))
        with torch.no_grad():
            self.weight[0].zero_()

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        y = y.clamp(0, self.num_classes)
        table = self.weight if self.dtype is None else self.weight.to(
            self.dtype)  # cast before the lookup, as the JAX package
        emb = F.embedding(y, table)
        return emb * (y != 0).to(emb.dtype)[:, None]


def sinusoidal_time_embedding_dit(t: torch.Tensor, dim: int,
                                  max_period: float = 10000.0) -> torch.Tensor:
    """DiT-style sinusoidal embedding: freqs exp(-ln(max_period) *
    arange(half) / half), concat [cos, sin], a zero column for odd dim.
    float32 trig whatever the model's compute type."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    """(B,) timesteps -> sinusoidal features (256) -> Linear -> SiLU ->
    Linear (keys `mlp.0`, `mlp.2`), xavier weights and zero biases as the
    JAX package; the linears in `dtype`."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp = nn.Sequential(
            CastLinear(frequency_embedding_size, hidden_size,
                       compute_dtype=dtype), nn.SiLU(),
            CastLinear(hidden_size, hidden_size, compute_dtype=dtype))
        for layer in (self.mlp[0], self.mlp[2]):
            xavier_linear_(layer)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.mlp(sinusoidal_time_embedding_dit(
            t, self.frequency_embedding_size))


class LabelTable(nn.Module):
    """Holds the `LabelEmbedder` under the reference's DiT/DiM name, so its
    key is `y_embedder.embedding_table.weight`."""

    def __init__(self, num_classes: int, hidden_size: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embedding_table = LabelEmbedder(num_classes, hidden_size, dtype)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return self.embedding_table(y)


class PatchEmbed(nn.Module):
    """NHWC image -> (B, (H/p) (W/p), embed_dim) tokens in row-major patch
    order, through a stride-p Conv2d (`proj`, torch's default init) in
    `dtype`."""

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.proj = CastConv2d(in_channels, embed_dim, patch_size,
                               stride=patch_size, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.proj(x.to(torch.float32).permute(0, 3, 1, 2))
        return h.flatten(2).transpose(1, 2)


def unpatchify(x: torch.Tensor, h_tokens: int, w_tokens: int,
               patch_size: int, channels: int) -> torch.Tensor:
    """Tokens (B, h w, p p C) -> NHWC image (B, h p, w p, C)."""
    p = patch_size
    x = x.reshape(x.shape[0], h_tokens, w_tokens, p, p, channels)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(x.shape[0], h_tokens * p, w_tokens * p, channels)


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation x (1 + scale) + shift, (B, D) over the tokens."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class AdaLNModulation(nn.Sequential):
    """SiLU -> Linear(n_chunks * dim) in `dtype`, zero-initialised (keys
    `adaLN_modulation.1.*`), split into n_chunks (B, dim) tensors."""

    def __init__(self, dim: int, n_chunks: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(nn.SiLU(),
                         CastLinear(dim, n_chunks * dim, compute_dtype=dtype))
        self.n_chunks = n_chunks
        nn.init.zeros_(self[1].weight)
        nn.init.zeros_(self[1].bias)

    def forward(self, c: torch.Tensor):
        return super().forward(c).chunk(self.n_chunks, dim=-1)


def xavier_linear_(layer: nn.Linear) -> nn.Linear:
    """Xavier-uniform weight and zero bias (JAX `init.xavier_uniform`,
    `init.zeros`)."""
    nn.init.xavier_uniform_(layer.weight)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)
    return layer
