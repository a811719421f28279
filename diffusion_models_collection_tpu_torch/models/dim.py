"""DiM, the diffusion Mamba.

Counterpart of `diffusion_models_collection_tpu/models/dim.py`, with the
PyTorch reference's module names (`x_embedder`, `pos_embed`, `t_embedder`,
`y_embedder`, `blocks.{i}.mamba_block.mamba.*`, `blocks.{i}.ff_block.*`,
`final_layer`), the names `utils/torch_export.py` writes, so its state dicts
and JAX checkpoints bridged by `utils/weights.py` load with `strict=True`.

Contract: `model(x, t, y) -> eps` with x (B, H, W, C) float32, t (B,) int,
y (B,) int labels shifted by +1 with 0 the CFG null label; float32 NHWC out.
The Mamba mixer's recurrence runs through `ops.selective_scan` (the forward
kernel, and under a gradient the forward with saved states and the backward
kernel), which `ops.plain.plain_kernels` reroutes through this module's
`selective_scan` name.

Init follows the JAX package, not the reference's xavier-everything: A_log
is log(1..N) per channel, dt_proj's weight U(+-dt_rank^-0.5) and its bias
the inverse softplus of a log-uniform dt in [1e-3, 0.1]; the Mamba linears
and the conv take torch's defaults (the same U(+-1/sqrt(fan_in)) as the JAX
`torch_default_*`); the MLP and timestep linears are xavier with zero
biases; adaLN and the final projection are zero; pos_embed is N(0, 0.02).

Not ported, and raising when asked for: `use_attention_fallback` (it needs
DiT's `SelfAttention` with dropout on the probabilities, ROADMAP queue 1
item 8) and `remat` (item 4).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.selective_scan import selective_scan
from .dit import Mlp
from .layers import (
    AdaLNModulation,
    LabelTable,
    PatchEmbed,
    TimestepEmbedder,
    modulate,
    unpatchify,
)


def dt_bias_init(d_inner: int, dt_min: float = 1e-3, dt_max: float = 0.1,
                 dt_init_floor: float = 1e-4) -> torch.Tensor:
    """softplus^-1 of dt drawn log-uniform in [dt_min, dt_max], floored."""
    u = torch.rand(d_inner)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min))
                   + math.log(dt_min)).clamp(min=dt_init_floor)
    return dt + torch.log(-torch.expm1(-dt))


class Mamba(nn.Module):
    """Selective-SSM sequence mixer (mamba_ssm's Mamba with d_conv 4,
    expand 2): a fused in_proj to [x; z], a causal depthwise conv and SiLU
    on x, x_proj to (dt, B, C), dt_proj and softplus, the scan with the D
    skip, y * SiLU(z), out_proj."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2):
        super().__init__()
        d_inner = expand * d_model
        self.d_state = d_state
        self.dt_rank = math.ceil(d_model / 16)
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        self.conv1d = nn.Conv1d(d_inner, d_inner, d_conv, groups=d_inner,
                                padding=d_conv - 1)
        self.x_proj = nn.Linear(d_inner, self.dt_rank + 2 * d_state,
                                bias=False)
        self.dt_proj = nn.Linear(self.dt_rank, d_inner)
        self.A_log = nn.Parameter(torch.log(torch.arange(
            1, d_state + 1, dtype=torch.float32).repeat(d_inner, 1)))
        self.D = nn.Parameter(torch.ones(d_inner))
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)
        with torch.no_grad():
            bound = self.dt_rank ** -0.5
            self.dt_proj.weight.uniform_(-bound, bound)
            self.dt_proj.bias.copy_(dt_bias_init(d_inner))

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        length = u.shape[1]
        x, z = self.in_proj(u).chunk(2, dim=-1)
        # causal: padded by d_conv - 1 on both sides, cut to the first L
        x = F.silu(self.conv1d(x.transpose(1, 2))[..., :length]).transpose(1, 2)
        dt, B, C = self.x_proj(x).split(
            [self.dt_rank, self.d_state, self.d_state], dim=-1)
        dt = F.softplus(self.dt_proj(dt))
        A = -torch.exp(self.A_log)
        y = selective_scan(x, dt, A, B, C, self.D)
        return self.out_proj(y * F.silu(z))


class MambaBlock(nn.Module):
    """adaLN-modulated Mamba mixer: x + gate * Mamba(modulate(LN(x)))."""

    def __init__(self, hidden_size: int, state_size: int = 16):
        super().__init__()
        self.norm = nn.LayerNorm(hidden_size, eps=1e-6)
        self.adaLN_modulation = AdaLNModulation(hidden_size, 3)
        self.mamba = Mamba(hidden_size, state_size)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale, gate = self.adaLN_modulation(c)
        h = self.mamba(modulate(self.norm(x), shift, scale))
        return x + gate[:, None, :] * h


class FeedForward(nn.Module):
    """adaLN-modulated MLP: x + gate * Mlp(modulate(LN(x)))."""

    def __init__(self, hidden_size: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.1):
        super().__init__()
        self.norm = nn.LayerNorm(hidden_size, eps=1e-6)
        self.adaLN_modulation = AdaLNModulation(hidden_size, 3)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio), hidden_size,
                       dropout)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale, gate = self.adaLN_modulation(c)
        h = self.mlp(modulate(self.norm(x), shift, scale))
        return x + gate[:, None, :] * h


class DiMBlock(nn.Module):
    """Mamba mixer, then the feed-forward."""

    def __init__(self, hidden_size: int, state_size: int = 16,
                 mlp_ratio: float = 4.0, dropout: float = 0.1):
        super().__init__()
        self.mamba_block = MambaBlock(hidden_size, state_size)
        self.ff_block = FeedForward(hidden_size, mlp_ratio, dropout)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        return self.ff_block(self.mamba_block(x, c), c)


class DiMFinalLayer(nn.Module):
    """adaLN-modulated LayerNorm and a zero-initialised projection to the
    patch pixels."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int):
        super().__init__()
        self.norm_final = nn.LayerNorm(hidden_size, eps=1e-6)
        self.linear = nn.Linear(hidden_size,
                                patch_size * patch_size * out_channels)
        self.adaLN_modulation = AdaLNModulation(hidden_size, 2)
        nn.init.zeros_(self.linear.weight)
        nn.init.zeros_(self.linear.bias)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(c)
        return self.linear(modulate(self.norm_final(x), shift, scale))


class DiM(nn.Module):
    """Diffusion Mamba; constructor parity with the JAX `DiM`.
    `num_classes=None` builds the unconditional variant."""

    def __init__(
        self,
        img_size: Union[int, Tuple[int, int]] = (32, 32),
        patch_size: int = 2,
        in_channels: int = 3,
        hidden_size: int = 768,
        depth: int = 12,
        state_size: int = 16,
        mlp_ratio: float = 4.0,
        num_classes: Optional[int] = None,
        dropout: float = 0.1,
        use_attention_fallback: bool = False,
        remat: bool = False,
        out_channels: Optional[int] = None,
    ):
        super().__init__()
        if use_attention_fallback:
            raise NotImplementedError(
                "use_attention_fallback is not ported yet: it needs DiT's "
                "SelfAttention with dropout on the probabilities (ROADMAP "
                "queue 1 item 8)")
        if remat:
            raise NotImplementedError(
                "remat (gradient checkpointing) is not ported yet (ROADMAP "
                "queue 1 item 4)")
        img_h, img_w = ((img_size, img_size) if isinstance(img_size, int)
                        else tuple(img_size))
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.out_channels = out_channels or in_channels
        self.num_classes = num_classes
        self.tokens_hw = (img_h // patch_size, img_w // patch_size)
        num_patches = self.tokens_hw[0] * self.tokens_hw[1]

        self.x_embedder = PatchEmbed(patch_size, in_channels, hidden_size)
        self.pos_embed = nn.Parameter(
            torch.randn(1, num_patches, hidden_size) * 0.02)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.y_embedder = (LabelTable(num_classes, hidden_size)
                           if num_classes is not None else None)
        self.blocks = nn.ModuleList(
            DiMBlock(hidden_size, state_size, mlp_ratio, dropout)
            for _ in range(depth))
        self.final_layer = DiMFinalLayer(hidden_size, patch_size,
                                         self.out_channels)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.x_embedder(x) + self.pos_embed
        c = self.t_embedder(t)
        if self.y_embedder is not None and y is not None:
            c = c + self.y_embedder(y)
        for block in self.blocks:
            h = block(h, c)
        h = self.final_layer(h, c)
        return unpatchify(h, *self.tokens_hw, self.patch_size,
                          self.out_channels).contiguous()
