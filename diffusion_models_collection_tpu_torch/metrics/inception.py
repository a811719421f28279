"""InceptionV3 feature extractor (the pytorch-fid-style torchvision
InceptionV3), the features behind FID, KID, precision/recall and the
Inception Score.

Counterpart of `diffusion_models_collection_tpu/metrics/inception.py`.
Eval-mode-only torchvision `inception_v3` graph (transform_input=False):
BasicConv2d = conv(bias=False) + frozen BatchNorm (eps=1e-3) + ReLU,
Inception A/B/C/D/E blocks, the 2048-d global-average pool features (FID)
and the 1000-way fc logits (Inception Score). NCHW inside, NHWC at the API.

Weights: the module's `state_dict` keys are torchvision's `inception_v3`
keys without `AuxLogits.*` and `*.num_batches_tracked`, the keys the JAX
converter drops, so a torchvision `.pth` (read with
`torch.load(weights_only=True)`) or an `.npz` of the same keys loads with
`strict=True` on the rest. Without a weights file the parameters take
the distribution of flax's default init (lecun-normal kernels, zero biases,
BatchNorm at identity), drawn from `torch.Generator` seed 0, every conv
kernel scaled by sqrt(2), and `calibrated` is False: the same distribution
as the JAX package's fallback, other draws (no seed agrees between
jax.random and torch), so the relative-only numbers of the two packages
differ.
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.data_parallel import gather_rows
from ..parallel.mesh import data_layout

WEIGHTS_ENV_VAR = "DMC_TPU_INCEPTION_WEIGHTS"

Pad = Union[int, Tuple[int, int]]


class FrozenBatchNorm2d(nn.Module):
    """Eval-mode BatchNorm with torchvision's parameter and buffer names and
    no `num_batches_tracked`."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def per_channel(v):
            return v[None, :, None, None]

        return ((x - per_channel(self.running_mean))
                * per_channel(torch.rsqrt(self.running_var + self.eps))
                * per_channel(self.weight) + per_channel(self.bias))


class BasicConv2d(nn.Module):
    """conv(bias=False) + frozen BatchNorm(eps=0.001) + relu."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Sequence[int], stride: int = 1, padding: Pad = 0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, tuple(kernel),
                              stride=stride, padding=padding, bias=False)
        self.bn = FrozenBatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """avg_pool2d(kernel=3, stride=1, padding=1), count_include_pad=True."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, in_channels: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 64, (1, 1))
        self.branch5x5_1 = BasicConv2d(in_channels, 48, (1, 1))
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=1)
        self.branch_pool = BasicConv2d(in_channels, pool_features, (1, 1))

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_channels: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_channels, 192, (1, 1))
        self.branch7x7_1 = BasicConv2d(in_channels, c7, (1, 1))
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_channels, 192, (1, 1))

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                     self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = conv(bd)
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, (1, 1))
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for conv in (self.branch7x7x3_1, self.branch7x7x3_2,
                     self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 320, (1, 1))
        self.branch3x3_1 = BasicConv2d(in_channels, 384, (1, 1))
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_channels, 192, (1, 1))

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([self.branch1x1(x), b3, bd, bp], dim=1)


class InceptionV3(nn.Module):
    """torchvision inception_v3 graph, eval mode.

    `forward(x)` with x (B, 299, 299, 3) NHWC in [-1, 1] returns
    (pool_features_2048, logits_1000)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, 1000)

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
        x = _max_pool(x)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d,
                      self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                      self.Mixed_6d, self.Mixed_6e, self.Mixed_7a,
                      self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        pooled = x.mean(dim=(2, 3))  # adaptive avg pool to 1x1
        return pooled, self.fc(pooled)


def resize_bilinear(images: torch.Tensor, size=(299, 299)) -> torch.Tensor:
    """Bilinear resize of NHWC images, torch interpolate(align_corners=
    False) without antialiasing."""
    out = F.interpolate(images.permute(0, 3, 1, 2), size=tuple(size),
                        mode="bilinear", align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1)


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) in [0, 1] -> (B, 299, 299, 3) in [-1, 1], grayscale
    broadcast to RGB."""
    if images.shape[-1] == 1:
        images = images.repeat(1, 1, 1, 3)
    return resize_bilinear(images) * 2.0 - 1.0


_BN_NAMES = ("weight", "bias", "running_mean", "running_var")


def _kept(key: str) -> bool:
    """Whether the JAX converter keeps a torchvision key: fc's weight and
    bias, every conv weight and the four BatchNorm tensors, outside the
    auxiliary classifier (so not `AuxLogits.*` nor `num_batches_tracked`)."""
    parts = key.split(".")
    if parts[0] == "AuxLogits" or len(parts) < 2:
        return False
    if parts[0] == "fc":
        return parts[1] in ("weight", "bias")
    return ((parts[-2] == "conv" and parts[-1] == "weight")
            or (parts[-2] == "bn" and parts[-1] in _BN_NAMES))


def convert_torchvision_state(state) -> Dict[str, torch.Tensor]:
    """A torchvision inception_v3 state mapping (torch tensors or numpy
    arrays) as this module's state dict: the keys the JAX converter keeps,
    as float32 tensors."""
    return {key: torch.as_tensor(np.asarray(value), dtype=torch.float32)
            for key, value in state.items() if _kept(key)}


def load_torchvision_weights(path) -> Dict[str, torch.Tensor]:
    """torchvision inception_v3 weights from the original .pth state dict
    or a converted .npz of the same keys, as this module's state dict."""
    if Path(path).suffix == ".npz":
        with np.load(path) as data:
            state = dict(data)
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
    return convert_torchvision_state(state)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator
                  ) -> torch.Tensor:
    """flax's default kernel init: variance 1 / fan_in, a normal truncated
    to two standard deviations (its std divided by the truncation's
    0.8796...), for a conv (O, I, kh, kw) or linear (out, in) weight."""
    std = math.sqrt(1.0 / weight[0].numel()) / .87962566103423978
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def flax_default_init_(model: nn.Module, seed: int = 0,
                       conv_scale: float = 1.0) -> nn.Module:
    """Every conv and linear weight lecun-normal from `torch.Generator`
    seed `seed` (conv weights times `conv_scale`), in `named_modules`
    order, every bias zero; BatchNorms stay at identity."""
    generator = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            lecun_normal_(module.weight.data, generator)
            if isinstance(module, nn.Conv2d):
                module.weight.data.mul_(conv_scale)
            if module.bias is not None:
                module.bias.data.zero_()
    return model


def batched_numpy(fn: Callable, images, batch_size: int) -> np.ndarray:
    """`fn` over `images` in batches, the results on the host, concatenated
    along the batch."""
    out = [torch.as_tensor(fn(images[start:start + batch_size])).detach()
           .float().cpu().numpy()
           for start in range(0, len(images), batch_size)]
    return np.concatenate(out, axis=0)


class InceptionFeatures:
    """Batched feature/logit extractor on `device`, float32.

    `weights_path` (or env DMC_TPU_INCEPTION_WEIGHTS) loads the torchvision
    weights; otherwise the parameters are random (flax's default
    distribution from seed 0, conv kernels times sqrt(2): without it the
    activations halve at every ReLU through InceptionV3's ~94 convs and the
    pool features collapse to a constant, so FID reads ~0 for any pair of
    image sets) and `self.calibrated` is False. In a world of processes
    every call splits its batch over the ranks and gathers the features
    and logits in rank order (`parallel/data_parallel.gather_rows`, as the
    JAX extractor shards each batch over a 'data' mesh); every rank must
    call it with the same images."""

    def __init__(self, weights_path: Optional[str] = None,
                 device: Union[str, torch.device] = "cpu"):
        self.device = torch.device(device)
        model = InceptionV3()
        weights_path = weights_path or os.environ.get(WEIGHTS_ENV_VAR)
        if weights_path and Path(weights_path).exists():
            model.load_state_dict(load_torchvision_weights(weights_path),
                                  strict=True)
            self.calibrated = True
        else:
            flax_default_init_(model, seed=0, conv_scale=math.sqrt(2.0))
            self.calibrated = False
        self.model = model.to(self.device).eval().requires_grad_(False)

    def __call__(self, images01) -> Tuple[torch.Tensor, torch.Tensor]:
        """images01: (B, H, W, C) in [0, 1] (numpy or torch) ->
        (features_2048, logits_1000), float32 on the extractor's device."""
        x = torch.as_tensor(images01).to(self.device, torch.float32)
        with torch.inference_mode():
            return gather_rows(lambda b: self.model(preprocess(b)),
                               data_layout(), x)
