"""Convolutional KL-VAE, the first stage of latent diffusion.

Counterpart of `diffusion_models_collection_tpu/models/vae.py`. The encoder
downsamples by f = 2^(len(channel_mult) - 1) to a (H/f, W/f,
latent_channels) diagonal Gaussian posterior; the decoder mirrors it. A
diffusion config with `latent_diffusion: true` then runs its denoiser in that
latent space (`utils/latent.py`).

Built from the UNet's blocks (`models/unet.py`): GroupNorm+SiLU through the
fused kernel (`FusedGroupNormSiLU`), the attention block through the flash
attention kernels, the stride-2 conv down and the nearest x2 + conv up.
Images are NHWC float32 at the interface, viewed as NCHW with channels-last
strides inside, as in the UNet. `dtype=torch.bfloat16` is the JAX model's
mixed precision: convs and activations in bf16 on float32 parameters; the
encoder splits its 2C output into (mean, logvar) in float32 and the decoder
returns float32. `remat=True` checkpoints each `VAEResBlock`.

The JAX package gives the VAE no PyTorch reference names, so the key names
are the port's: `encoder.conv_in`, `encoder.down.{i}` (the blocks and the
Downsample in call order), `encoder.mid`, `encoder.attn`, `encoder.norm_out`,
`encoder.conv_out`, and the decoder's `conv_in`, `mid`, `attn`, `up.{i}`,
`norm_out`, `conv_out`; a block's `norm1`, `conv1`, `norm2`, `conv2` and
`shortcut`. `utils/weights.py` bridges a Flax VAE's tree onto them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .layers import CastConv2d, Dropout, run_block
from .unet import AttentionBlock, Downsample, FusedGroupNormSiLU, Upsample


class VAEResBlock(nn.Module):
    """GroupNorm+SiLU+Conv twice with a residual, unconditioned (the VAE has
    no timestep or label inputs); a 1x1 shortcut where the width changes."""

    def __init__(self, in_ch: int, out_ch: int, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm1 = FusedGroupNormSiLU(in_ch, dtype=dtype)
        self.conv1 = CastConv2d(in_ch, out_ch, 3, padding=1,
                                compute_dtype=dtype)
        self.norm2 = FusedGroupNormSiLU(out_ch, dtype=dtype)
        self.dropout = Dropout(dropout)
        self.conv2 = CastConv2d(out_ch, out_ch, 3, padding=1,
                                compute_dtype=dtype)
        self.shortcut = (CastConv2d(in_ch, out_ch, 1, compute_dtype=dtype)
                         if in_ch != out_ch else nn.Identity())

    def forward(self, x):
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.dropout(self.norm2(h)))
        return h + self.shortcut(x)


class _Coder(nn.Module):
    """What the encoder and the decoder share: running a list of blocks
    and resamplers, each VAEResBlock under `remat` when asked."""

    remat: bool

    def _run(self, layers, h):
        for layer in layers:
            if isinstance(layer, VAEResBlock):
                h = run_block(layer, self.remat, h)
            else:
                h = layer(h)
        return h


class _Encoder(_Coder):
    def __init__(self, in_channels: int, base_channels: int,
                 channel_mult: Sequence[int], latent_channels: int,
                 num_res_blocks: int, use_attention: bool, dropout: float,
                 dtype: Optional[torch.dtype], remat: bool):
        super().__init__()
        self.remat = remat
        self.latent_channels = latent_channels
        ch = base_channels * channel_mult[0]
        self.conv_in = CastConv2d(in_channels, ch, 3, padding=1,
                                  compute_dtype=dtype)
        down = []
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                down.append(VAEResBlock(ch, base_channels * mult, dropout,
                                        dtype))
                ch = base_channels * mult
            if level != len(channel_mult) - 1:
                down.append(Downsample(ch, dtype))
        self.down = nn.ModuleList(down)
        self.mid = VAEResBlock(ch, ch, dropout, dtype)
        self.attn = AttentionBlock(ch, dtype=dtype) if use_attention else None
        self.norm_out = FusedGroupNormSiLU(ch, dtype=dtype)
        # 2C output: [mean, logvar] of the diagonal Gaussian posterior
        self.conv_out = CastConv2d(ch, 2 * latent_channels, 3, padding=1,
                                   compute_dtype=dtype)

    def forward(self, x):
        h = self._run(self.down, self.conv_in(x))
        h = run_block(self.mid, self.remat, h)
        if self.attn is not None:
            h = self.attn(h)
        h = self.conv_out(self.norm_out(h)).to(torch.float32)
        mean, logvar = h.split(self.latent_channels, dim=1)
        # bound the posterior variance (LDM clamps to [-30, 20])
        return mean, logvar.clamp(-30.0, 20.0)


class _Decoder(_Coder):
    def __init__(self, out_channels: int, base_channels: int,
                 channel_mult: Sequence[int], latent_channels: int,
                 num_res_blocks: int, use_attention: bool, dropout: float,
                 dtype: Optional[torch.dtype], remat: bool):
        super().__init__()
        self.remat = remat
        ch = base_channels * channel_mult[-1]
        self.conv_in = CastConv2d(latent_channels, ch, 3, padding=1,
                                  compute_dtype=dtype)
        self.mid = VAEResBlock(ch, ch, dropout, dtype)
        self.attn = AttentionBlock(ch, dtype=dtype) if use_attention else None
        up = []
        for level, mult in reversed(list(enumerate(channel_mult))):
            for _ in range(num_res_blocks):
                up.append(VAEResBlock(ch, base_channels * mult, dropout,
                                      dtype))
                ch = base_channels * mult
            if level != 0:
                up.append(Upsample(ch, dtype))
        self.up = nn.ModuleList(up)
        self.norm_out = FusedGroupNormSiLU(ch, dtype=dtype)
        self.conv_out = CastConv2d(ch, out_channels, 3, padding=1,
                                   compute_dtype=dtype)

    def forward(self, z):
        h = run_block(self.mid, self.remat, self.conv_in(z))
        if self.attn is not None:
            h = self.attn(h)
        h = self._run(self.up, h)
        return self.conv_out(self.norm_out(h)).to(torch.float32)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class VAE(nn.Module):
    """KL-regularised convolutional autoencoder; constructor parity with the
    JAX `VAE`.

    `forward(x, noise)` -> (reconstruction, mean, logvar) with the
    reparameterised z = mean + exp(logvar / 2) * noise, `noise` an explicit
    standard normal (B, H/f, W/f, latent_channels) input. `encode(x)` ->
    (mean, logvar), `decode(z)` -> image; all NHWC float32.
    """

    def __init__(
        self,
        image_size: Tuple[int, int] = (32, 32),
        in_channels: int = 3,
        base_channels: int = 64,
        channel_mult: Sequence[int] = (1, 2),
        latent_channels: int = 4,
        num_res_blocks: int = 1,
        use_attention: bool = False,
        dropout: float = 0.0,
        dtype: Optional[torch.dtype] = None,
        remat: bool = False,
    ):
        super().__init__()
        self.image_size = tuple(image_size)
        self.in_channels = in_channels
        self.channel_mult = tuple(channel_mult)
        self.latent_channels = latent_channels
        self.dtype = dtype
        self.latent_hw()  # the divisibility check, at construction
        kw = dict(base_channels=base_channels, channel_mult=self.channel_mult,
                  latent_channels=latent_channels,
                  num_res_blocks=num_res_blocks, use_attention=use_attention,
                  dropout=dropout, dtype=dtype, remat=remat)
        self.encoder = _Encoder(in_channels, **kw)
        self.decoder = _Decoder(in_channels, **kw)
        # channels-last conv weights: cuDNN then runs every conv in NHWC
        self.to(memory_format=torch.channels_last)

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.channel_mult) - 1)

    def latent_hw(self) -> Tuple[int, int]:
        f = self.downsample_factor
        h, w = self.image_size
        if h % f or w % f:
            raise ValueError(f"image size {self.image_size} not divisible by "
                             f"the downsample factor {f}")
        return h // f, w // f

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, H, W, C) -> (mean, logvar) of the latent posterior, each
        (B, H/f, W/f, latent_channels) float32."""
        mean, logvar = self.encoder(_nchw(x))
        return _nhwc(mean), _nhwc(logvar)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latent z (B, H/f, W/f, latent_channels) -> image (B, H, W, C)
        float32."""
        return _nhwc(self.decoder(_nchw(z)))

    def forward(self, x: torch.Tensor, noise: torch.Tensor):
        mean, logvar = self.encode(x)
        z = mean + torch.exp(0.5 * logvar) * noise
        return self.decode(z), mean, logvar


def kl_divergence(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Mean per-element KL(q(z|x) || N(0, I)) over the batch:
    0.5 * (mean^2 + var - 1 - logvar)."""
    return 0.5 * torch.mean(mean ** 2 + torch.exp(logvar) - 1.0 - logvar)
