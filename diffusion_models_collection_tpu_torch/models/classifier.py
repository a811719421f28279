"""Noise-conditional classifier p(y | x_t, t) for classifier guidance.

Counterpart of `diffusion_models_collection_tpu/models/classifier.py`
(Dhariwal & Nichol 2021): the UNet's encoder half, built from the UNet's own
blocks (`ResidualBlock`, `AttentionBlock`, `Downsample`, `FusedGroupNormSiLU`,
its time embedding and 3x3 input conv), then GroupNorm(8)+SiLU, a mean over
H and W and a linear head. On a card its GroupNorm+SiLU and attention run
the kernels, forward and backward, as the UNet's do; classifier guidance
(`diffusion/guidance.py`) takes its gradient with respect to x inside every
guided sampling step.

Contract: `model(x, t, y=None) -> logits (B, num_classes)` float32 whatever
`dtype`, with x the NOISY image (B, H, W, C) at timestep t. `y` is accepted
and ignored (the uniform `(x, t, y)` call shape). Labels are raw 0..K-1:
the classifier has no CFG null class. `remat=True` runs each ResidualBlock
under gradient checkpointing.

The JAX package gives the classifier no PyTorch reference names, so the key
names are the port's: `time_embed.{1,3}`, `input_conv`, `blocks.{i}` (the
ResidualBlocks, AttentionBlocks and Downsamples in call order), `norm_out`
and `head`. `utils/weights.py` bridges a Flax classifier's tree onto them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .layers import CastConv2d, CastLinear, UNetTimeEmbed, run_block
from .unet import AttentionBlock, Downsample, FusedGroupNormSiLU, ResidualBlock


def classifier_plan(image_size: Tuple[int, int], num_res_blocks: int,
                    attention_resolutions: Sequence[int],
                    channel_mult: Sequence[int],
                    use_attention: bool) -> list:
    """The encoder's layers in call order: ('res', level), ('attn', level)
    or ('down', level). The weight bridge walks the same list."""
    plan = []
    resolution = list(image_size)
    for level in range(len(channel_mult)):
        for _ in range(num_res_blocks):
            plan.append(("res", level))
            if use_attention and (resolution[0] in attention_resolutions
                                  or resolution[1] in attention_resolutions):
                plan.append(("attn", level))
        if level != len(channel_mult) - 1:
            plan.append(("down", level))
            resolution = [r // 2 for r in resolution]
    return plan


class NoisyClassifier(nn.Module):
    """UNet-encoder classifier over noisy images; constructor parity with
    the JAX `NoisyClassifier`."""

    def __init__(
        self,
        image_size: Tuple[int, int] = (32, 32),
        in_channels: int = 3,
        model_channels: int = 64,
        num_classes: int = 10,
        num_res_blocks: int = 1,
        attention_resolutions: Sequence[int] = (8,),
        channel_mult: Sequence[int] = (1, 2, 2),
        dropout: float = 0.1,
        use_attention: bool = True,
        dtype: Optional[torch.dtype] = None,
        remat: bool = False,
    ):
        super().__init__()
        self.image_size = tuple(image_size)
        self.in_channels = in_channels
        self.num_classes = num_classes
        self.dtype = dtype
        self.remat = remat
        time_dim = model_channels * 4
        self.time_embed = UNetTimeEmbed(model_channels, dtype)
        self.input_conv = CastConv2d(in_channels, model_channels, 3,
                                     padding=1, compute_dtype=dtype)
        ch = model_channels
        self.blocks = nn.ModuleList()
        for kind, level in classifier_plan(
                self.image_size, num_res_blocks, tuple(attention_resolutions),
                tuple(channel_mult), use_attention):
            if kind == "res":
                out_ch = model_channels * channel_mult[level]
                self.blocks.append(ResidualBlock(ch, out_ch, time_dim, False,
                                                 dropout, dtype))
                ch = out_ch
            elif kind == "attn":
                self.blocks.append(AttentionBlock(ch, dtype=dtype))
            else:
                self.blocks.append(Downsample(ch, dtype))
        self.norm_out = FusedGroupNormSiLU(ch, dtype=dtype)
        self.head = CastLinear(ch, num_classes, compute_dtype=dtype)
        # channels-last conv weights: cuDNN then runs every conv in NHWC
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits (B, num_classes), float32."""
        del y
        t_emb = self.time_embed(t)
        h = self.input_conv(x.to(torch.float32).permute(0, 3, 1, 2))
        for block in self.blocks:
            if isinstance(block, ResidualBlock):
                h = run_block(block, self.remat, h, t_emb)
            else:
                h = block(h)
        h = self.norm_out(h).mean(dim=(2, 3))  # global average pool
        return self.head(h).to(torch.float32)
