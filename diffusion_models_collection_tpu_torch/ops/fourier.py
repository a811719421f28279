"""Spatial Fourier low-pass scaling: FreeU's damping of the skip features.

Counterpart of `diffusion_models_collection_tpu/ops/fourier.py` (FreeU, Si
et al. 2023): the lowest spatial frequencies of a skip feature map are
scaled by a factor s. The JAX package computes it with XLA's FFT, not in a
Pallas kernel, so no hand-written kernel is owed here: the port's
counterpart is `torch.fft` (cuFFT on the card). The maps FreeU touches are
the UNet's two deepest up levels (4x4 and 8x8 at CIFAR scale), so the FFT
is small beside the convs around it.
"""

from __future__ import annotations

import torch


def fourier_lowpass_scale(x: torch.Tensor, threshold: int,
                          scale: float) -> torch.Tensor:
    """Scale the centred (2 threshold, 2 threshold) block of the spectrum of
    an NCHW map over H, W by `scale`, in float32; the result has `x`'s
    dtype. `scale == 1` is the identity, and a threshold that covers the
    whole spectrum scales the whole map."""
    if threshold < 1:
        raise ValueError(f"threshold must be >= 1, got {threshold}")
    h, w = x.shape[2:]
    xf = torch.fft.fftn(x.to(torch.float32), dim=(2, 3))
    xf = torch.fft.fftshift(xf, dim=(2, 3))
    crow, ccol = h // 2, w // 2
    r0, r1 = max(crow - threshold, 0), min(crow + threshold, h)
    c0, c1 = max(ccol - threshold, 0), min(ccol + threshold, w)
    mask = torch.ones((1, 1, h, w), dtype=torch.float32, device=x.device)
    mask[:, :, r0:r1, c0:c1] = float(scale)
    xf = torch.fft.ifftshift(xf * mask, dim=(2, 3))
    return torch.fft.ifftn(xf, dim=(2, 3)).real.to(x.dtype)
