"""UNet denoiser.

Counterpart of `diffusion_models_collection_tpu/models/unet.py`, with the
PyTorch reference's module names (`down_blocks.{g}.{j}`, `middle_block.{j}`,
`up_blocks.{g}.{j}`, `time_embed`, `label_embed`, `input_conv`, `output`), so
reference `.pth` weights and JAX checkpoints bridged by `utils/weights.py`
load with `strict=True`.

Contract: `model(x, t, y) -> eps` with x (B, H, W, C) float32, t (B,) int,
y (B,) int labels shifted by +1 with 0 the CFG null label. Inside, the NHWC
input is viewed as NCHW with channels-last strides, so cuDNN runs the convs
in NHWC and GroupNorm+SiLU reads a contiguous (B, H*W, C) block, the layout
its kernel (`ops/fused_norm.py`) takes. Attention goes through the
flash-attention kernels (`ops/attention.py`). Both are autograd Functions,
so a loss reaches every parameter.

`dtype=torch.bfloat16` is the JAX model's mixed precision
(`mixed_precision: 'bf16'`): the input is cast to bf16, every conv and
linear runs in bf16 on float32 parameters (`layers.CastConv2d`,
`CastLinear`), GroupNorm+SiLU takes and returns bf16 (its kernel's bf16
form: statistics in float32), the attention block's GroupNorm runs in
float32 on the widened input and its attention on bf16 q, k, v, the residual
adds run in bf16, and eps comes back float32.

`remat=True` runs each `ResidualBlock` under gradient checkpointing, as the
JAX model's `nn.remat(ResidualBlock)`.

The JAX model's three training-free sampling knobs, each a constructor field
(so a config's `model_params` builds them) and, for PAG and DeepCache, also
a call-time argument of `forward`, so that one module with one set of
weights serves every view:
  * `pag_perturb`: every attention map is the identity, so an attention
    block's output is its v (Perturbed Attention Guidance,
    `diffusion/pag.py`);
  * `freeu` (b1, b2, s1, s2): at the two deepest up levels the backbone's
    first half of channels is scaled by b and the skip's lowest spatial
    frequencies by s (`ops/fourier.py`);
  * `deepcache_mode` 'full' returns `(eps, cache)`, the up-path feature
    entering up level n_levels - `deepcache_depth`; 'shallow' runs only
    the outermost `deepcache_depth` levels and splices a `cache` from a
    'full' call in place of everything deeper (`diffusion/deepcache.py`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multihead_attention
from ..ops.fourier import fourier_lowpass_scale
from ..ops.fused_norm import group_norm_silu
from .layers import (
    CastConv2d,
    CastLinear,
    Dropout,
    LabelEmbedder,
    UNetTimeEmbed,
    run_block,
)


class FusedGroupNormSiLU(nn.Module):
    """GroupNorm(num_groups, eps 1e-5) + SiLU in one kernel. Owns the same
    `weight` and `bias` as `nn.GroupNorm`; takes and returns NCHW tensors,
    channels-last in memory, of `dtype` (float32 when None). Statistics
    always in float32."""

    def __init__(self, num_channels: int, num_groups: int = 8,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_groups = num_groups
        self.dtype = dtype or torch.float32
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a no-op copy for a channels-last x: the permute is contiguous
        x_nhwc = x.permute(0, 2, 3, 1).to(self.dtype).contiguous()
        y = group_norm_silu(x_nhwc, self.weight, self.bias, self.num_groups)
        return y.permute(0, 3, 1, 2)


class ResidualBlock(nn.Module):
    """GroupNorm(8)+SiLU+Conv twice, with additive time and label terms.

    The reference's Sequentials are kept for their key names; the SiLU slot
    after each norm holds an Identity because the kernel applies SiLU.
    """

    def __init__(self, in_ch: int, out_ch: int, time_dim: int,
                 conditional: bool, dropout: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = nn.Sequential(
            FusedGroupNormSiLU(in_ch, dtype=dtype), nn.Identity(),
            CastConv2d(in_ch, out_ch, 3, padding=1, compute_dtype=dtype))
        self.time_mlp = nn.Sequential(
            nn.SiLU(), CastLinear(time_dim, out_ch, compute_dtype=dtype))
        self.label_proj = (
            nn.Sequential(nn.SiLU(), CastLinear(time_dim, out_ch, bias=False,
                                                compute_dtype=dtype))
            if conditional else None)
        self.conv2 = nn.Sequential(
            FusedGroupNormSiLU(out_ch, dtype=dtype), nn.Identity(),
            Dropout(dropout),
            CastConv2d(out_ch, out_ch, 3, padding=1, compute_dtype=dtype))
        self.shortcut = (CastConv2d(in_ch, out_ch, 1, compute_dtype=dtype)
                         if in_ch != out_ch else nn.Identity())

    def forward(self, x, t_emb, y_emb=None):
        h = self.conv1(x)
        h = h + self.time_mlp(t_emb)[:, :, None, None]
        if self.label_proj is not None and y_emb is not None:
            h = h + self.label_proj(y_emb)[:, :, None, None]
        h = self.conv2(h)
        return h + self.shortcut(x)


class AttentionBlock(nn.Module):
    """Self-attention over the H*W positions: GroupNorm(8), a 1x1 conv to
    q, k, v (split as `reshape(b, hw, 3, c)`, as the JAX package does),
    multi-head attention, a 1x1 projection and the residual. The norm is
    float32 whatever `dtype` (the JAX block's plain `nn.GroupNorm` on
    `x.astype(f32)`); the convs and the attention run in `dtype`. With
    `perturb` the attention map is the identity: the output is v (PAG)."""

    def __init__(self, channels: int, num_heads: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.norm = nn.GroupNorm(8, channels, eps=1e-5)
        self.qkv = CastConv2d(channels, 3 * channels, 1, compute_dtype=dtype)
        self.proj = CastConv2d(channels, channels, 1, compute_dtype=dtype)

    def forward(self, x, perturb: bool = False):
        b, c, h, w = x.shape
        hidden = self.norm(x.to(torch.float32))
        qkv = self.qkv(hidden).permute(0, 2, 3, 1).reshape(b, h * w, 3, c)
        q, k, v = qkv.unbind(2)
        out = v if perturb else multihead_attention(q, k, v, self.num_heads)
        out = out.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + self.proj(out)


class Downsample(nn.Module):
    """Stride-2 3x3 conv."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = CastConv2d(channels, channels, 3, stride=2, padding=1,
                               compute_dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = CastConv2d(channels, channels, 3, padding=1,
                               compute_dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNet(nn.Module):
    """UNet for diffusion; constructor parity with the JAX `UNet`.

    `num_classes=None` builds the unconditional variant. The block layout
    replays the reference constructor, including its attention placement on
    the up path: the resolution is doubled only after a level's upsample is
    built, so that level's attention check sees the lower resolution.
    """

    def __init__(
        self,
        image_size: Tuple[int, int] = (32, 32),
        in_channels: int = 3,
        model_channels: int = 128,
        out_channels: int = 3,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (16, 8),
        dropout: float = 0.1,
        channel_mult: Sequence[int] = (1, 2, 2, 2),
        num_classes: Optional[int] = None,
        use_attention: bool = True,
        dtype: Optional[torch.dtype] = None,
        remat: bool = False,
        pag_perturb: bool = False,
        freeu=None,
        deepcache_mode: Optional[str] = None,
        deepcache_depth: int = 1,
    ):
        super().__init__()
        n_levels = len(channel_mult)
        check_deepcache(deepcache_mode, deepcache_depth, channel_mult)
        self.pag_perturb = bool(pag_perturb)
        self.freeu = check_freeu(freeu)
        self.deepcache_mode = deepcache_mode
        self.deepcache_depth = int(deepcache_depth)
        self.channel_mult = tuple(channel_mult)
        self.num_res_blocks = num_res_blocks
        self.dtype = dtype
        self.image_size = tuple(image_size)
        self.remat = remat
        self.in_channels = in_channels
        self.num_classes = num_classes
        conditional = num_classes is not None
        time_dim = model_channels * 4

        def attend(resolution):
            return use_attention and (
                resolution[0] in attention_resolutions
                or resolution[1] in attention_resolutions)

        def res(cin, cout):
            return ResidualBlock(cin, cout, time_dim, conditional, dropout,
                                 dtype)

        self.time_embed = UNetTimeEmbed(model_channels, dtype)
        self.label_embed = (LabelEmbedder(num_classes, time_dim, dtype)
                            if conditional else None)
        self.input_conv = CastConv2d(in_channels, model_channels, 3,
                                     padding=1, compute_dtype=dtype)

        resolution = list(self.image_size)
        ch = model_channels
        skip_channels = [ch]
        self.down_blocks = nn.ModuleList()
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                group = [res(ch, model_channels * mult)]
                ch = model_channels * mult
                if attend(resolution):
                    group.append(AttentionBlock(ch, dtype=dtype))
                self.down_blocks.append(nn.ModuleList(group))
                skip_channels.append(ch)
            if level != n_levels - 1:
                self.down_blocks.append(nn.ModuleList([Downsample(ch, dtype)]))
                skip_channels.append(ch)
                resolution = [r // 2 for r in resolution]

        middle = [res(ch, ch)]
        if use_attention:
            middle.append(AttentionBlock(ch, dtype=dtype))
        middle.append(res(ch, ch))
        self.middle_block = nn.ModuleList(middle)

        self.up_blocks = nn.ModuleList()
        for level, mult in enumerate(reversed(channel_mult)):
            for i in range(num_res_blocks + 1):
                group = [res(ch + skip_channels.pop(), model_channels * mult)]
                ch = model_channels * mult
                if attend(resolution):
                    group.append(AttentionBlock(ch, dtype=dtype))
                if level != n_levels - 1 and i == num_res_blocks:
                    group.append(Upsample(ch, dtype))
                    resolution = [r * 2 for r in resolution]
                self.up_blocks.append(nn.ModuleList(group))

        self.output = nn.Sequential(
            FusedGroupNormSiLU(ch, dtype=dtype), nn.Identity(),
            CastConv2d(ch, out_channels, 3, padding=1, compute_dtype=dtype))
        # channels-last conv weights: cuDNN then runs every conv in NHWC
        self.to(memory_format=torch.channels_last)

    def _run(self, group, h, t_emb, y_emb, perturb=False):
        for layer in group:
            if isinstance(layer, ResidualBlock):
                h = run_block(layer, self.remat, h, t_emb, y_emb)
            elif isinstance(layer, AttentionBlock):
                h = layer(h, perturb)
            else:
                h = layer(h)
        return h

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: Optional[torch.Tensor] = None,
                cache: Optional[torch.Tensor] = None, *,
                pag_perturb: Optional[bool] = None,
                deepcache_mode: Optional[str] = None,
                deepcache_depth: Optional[int] = None):
        """eps (B, H, W, C) float32; with DeepCache 'full' `(eps, cache)`.
        `pag_perturb`, `deepcache_mode` and `deepcache_depth` override the
        module's fields for this call (None keeps them)."""
        perturb = self.pag_perturb if pag_perturb is None else pag_perturb
        mode = self.deepcache_mode if deepcache_mode is None else deepcache_mode
        depth = (self.deepcache_depth if deepcache_depth is None
                 else int(deepcache_depth))
        check_deepcache(mode, depth, self.channel_mult)
        if mode == "shallow" and cache is None:
            raise ValueError("deepcache_mode 'shallow' needs the cache tensor "
                             "from a 'full' forward")
        n_levels = len(self.channel_mult)
        t_emb = self.time_embed(t)
        y_emb = (self.label_embed(y)
                 if self.label_embed is not None and y is not None else None)
        h = self.input_conv(x.to(torch.float32).permute(0, 3, 1, 2))
        hs = [h]
        # each level is num_res_blocks groups and a Downsample; 'shallow'
        # runs the outermost `depth` levels but the last one's Downsample,
        # whose output only the cached region reads
        groups_a_level = self.num_res_blocks + 1
        down = (self.down_blocks[:depth * groups_a_level - 1]
                if mode == "shallow" else self.down_blocks)
        for group in down:
            h = self._run(group, h, t_emb, y_emb, perturb)
            hs.append(h)
        if mode == "shallow":
            h = cache if self.dtype is None else cache.to(self.dtype)
        else:
            h = self._run(self.middle_block, h, t_emb, y_emb, perturb)
        # the first up group outside the cached region
        first_live = (n_levels - depth) * groups_a_level
        deep_cache = None
        for i, group in enumerate(self.up_blocks):
            if mode == "shallow" and i < first_live:
                continue
            if mode == "full" and i == first_live:
                deep_cache = h
            level = i // groups_a_level
            skip = hs.pop()
            if self.freeu is not None and level < 2:
                h, skip = freeu_scale(h, skip, self.freeu[level],
                                      self.freeu[2 + level])
            h = torch.cat([h, skip], dim=1)
            h = self._run(group, h, t_emb, y_emb, perturb)
        h = self.output(h)
        # eps in float32 whatever the compute type, as the JAX model
        out = h.permute(0, 2, 3, 1).to(torch.float32).contiguous()
        return (out, deep_cache) if mode == "full" else out


def check_deepcache(mode: Optional[str], depth: int,
                    channel_mult: Sequence[int]) -> None:
    """The JAX model's rules for `deepcache_mode` and `deepcache_depth`."""
    n_levels = len(channel_mult)
    if mode not in (None, "full", "shallow"):
        raise ValueError(f"deepcache_mode must be None, 'full' or 'shallow', "
                         f"got {mode!r}")
    if mode is not None and not 1 <= int(depth) <= n_levels - 1:
        raise ValueError(
            f"deepcache_depth must be in [1, {n_levels - 1}] for "
            f"channel_mult {tuple(channel_mult)}, got {depth}")


def check_freeu(freeu) -> Optional[Tuple[float, float, float, float]]:
    """`freeu` as four floats, or None; the JAX model's errors."""
    if freeu is None:
        return None
    if len(freeu) != 4:
        raise ValueError(f"freeu must be (b1, b2, s1, s2), got {freeu!r}")
    for v in freeu:
        if not isinstance(v, (int, float)) or not math.isfinite(v):
            raise ValueError(
                f"freeu factors must be finite numbers, got {freeu!r}")
    return tuple(float(v) for v in freeu)


def freeu_scale(h: torch.Tensor, skip: torch.Tensor, b: float,
                s: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """FreeU at one up block: the backbone's first half of channels times
    b, the skip's low spatial frequencies (threshold 1) times s; a factor
    of 1 leaves its tensor as it is."""
    if b != 1.0:
        half = h.shape[1] // 2
        h = torch.cat([h[:, :half] * b, h[:, half:]], dim=1)
    if s != 1.0:
        skip = fourier_lowpass_scale(skip, 1, s).contiguous(
            memory_format=torch.channels_last)
    return h, skip
