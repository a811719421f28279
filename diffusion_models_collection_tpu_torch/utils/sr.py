"""Super-resolution conditioning (SR3-style cascaded diffusion).

Counterpart of `diffusion_models_collection_tpu/utils/sr.py` (Saharia et al.
2021 "SR3"; Ho et al. 2021 "Cascaded Diffusion Models"): a denoiser trained
to produce the high-resolution image conditioned on its low-resolution
version, fed by concatenating the upsampled LR image to x_t on the channel
axis. A base checkpoint and SR checkpoints form a cascade
(`tools/cascade.py`); `sample --sr_source` super-resolves user images.

Config schema, one top-level key beside the standard config at the HIGH
resolution:

    'super_resolution': {
        'factor': 2,            # LR = image_size / factor (must divide)
        'noise_aug': 0.0,       # conditioning-noise std in [-1, 1] space,
                                # the same fixed level at train and sampling
        'upsample': 'bilinear', # LR -> HR interpolation fed to the model
    }

Images are NHWC float32 tensors, as the port's samplers hold them.
`upsample` is `F.interpolate` with half-pixel centres and no antialiasing,
the same as `jax.image.resize` when it magnifies; the conditioning noise is
drawn from an explicit generator (or passed in, as the parity tests do).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .helpers import resolve_image_size

_UPSAMPLE_METHODS = ("bilinear", "nearest")


@dataclasses.dataclass(frozen=True)
class SRSpec:
    """The validated `super_resolution` config block."""

    factor: int
    noise_aug: float = 0.0
    upsample: str = "bilinear"

    @staticmethod
    def from_config(config: dict) -> Optional["SRSpec"]:
        block = config.get("super_resolution")
        if not block:
            return None
        if not isinstance(block, dict):
            raise ValueError("super_resolution must be a dict like "
                             "{'factor': 2, 'noise_aug': 0.0}")
        factor = int(block.get("factor", 0))
        if factor < 2:
            raise ValueError("super_resolution.factor must be an int >= 2, "
                             f"got {block.get('factor')!r}")
        noise_aug = float(block.get("noise_aug", 0.0))
        if noise_aug < 0:
            raise ValueError("super_resolution.noise_aug must be >= 0")
        upsample = str(block.get("upsample", "bilinear")).lower()
        if upsample not in _UPSAMPLE_METHODS:
            raise ValueError(
                f"super_resolution.upsample must be one of "
                f"{_UPSAMPLE_METHODS}, got {upsample!r}")
        h, w = resolve_image_size(config["image_size"])
        if h % factor or w % factor:
            raise ValueError(f"super_resolution.factor={factor} must divide "
                             f"image_size {(h, w)}")
        return SRSpec(factor=factor, noise_aug=noise_aug, upsample=upsample)

    def lr_hw(self, hw) -> tuple:
        return (hw[0] // self.factor, hw[1] // self.factor)


def downsample(images: torch.Tensor, factor: int) -> torch.Tensor:
    """Exact area downsample (average pooling) of NHWC images, by a
    reshape-mean."""
    n, h, w, c = images.shape
    if h % factor or w % factor:
        raise ValueError(f"factor {factor} must divide spatial dims {(h, w)}")
    x = images.reshape(n, h // factor, factor, w // factor, factor, c)
    return x.mean(dim=(2, 4))


def upsample(images: torch.Tensor, hw, method: str = "bilinear"
             ) -> torch.Tensor:
    """NHWC images resized to spatial size `hw`: bilinear with half-pixel
    centres and edge clamping, or nearest (source index floor((i + 0.5) *
    in / out), `nearest-exact`), as `jax.image.resize` magnifies."""
    x = images.permute(0, 3, 1, 2)
    if method == "bilinear":
        y = F.interpolate(x, size=tuple(hw), mode="bilinear",
                          align_corners=False, antialias=False)
    elif method == "nearest":
        y = F.interpolate(x, size=tuple(hw), mode="nearest-exact")
    else:
        raise ValueError(f"upsample method must be one of "
                         f"{_UPSAMPLE_METHODS}, got {method!r}")
    return y.permute(0, 2, 3, 1).contiguous()


def make_condition(spec: SRSpec, hw, *,
                   hr_images: Optional[torch.Tensor] = None,
                   lr_images: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The HR-size conditioning tensor from HR images (training and
    evaluation: LR by area downsample) or LR images (user inputs, cascade
    stages). With `noise_aug` > 0 one noise draw per call is added (from
    `generator` on the images' device, unless `noise` is given)."""
    if (hr_images is None) == (lr_images is None):
        raise ValueError("pass exactly one of hr_images / lr_images")
    if hr_images is not None:
        lr_images = downsample(hr_images.to(torch.float32), spec.factor)
    else:
        lr_images = lr_images.to(torch.float32)
        expect = (hw[0] // spec.factor, hw[1] // spec.factor)
        if tuple(lr_images.shape[1:3]) != expect:
            raise ValueError(
                f"LR conditioning images must be {expect} for factor "
                f"{spec.factor} at size {tuple(hw)}, got "
                f"{tuple(lr_images.shape[1:3])}")
    cond = upsample(lr_images, hw, spec.upsample)
    if spec.noise_aug > 0:
        if noise is None:
            if generator is None:
                raise ValueError("noise_aug > 0 requires a generator")
            noise = torch.randn(cond.shape, generator=generator,
                                device=cond.device)
        cond = cond + spec.noise_aug * noise.to(cond.device)
    return cond


def batch_condition(spec: SRSpec, hw, source, start: int, end: int,
                    batch_size: int, generator: Optional[torch.Generator],
                    *, source_is_hr: bool = False, cycle: bool = False,
                    device=None, noise: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The CLIs' helper: `source[start:end]` (host arrays of LR images, or
    of HR images to downsample with `source_is_hr`), edge-padded to
    `batch_size` rows, as conditioning on `device`. `cycle=True` wraps the
    indices modulo len(source)."""
    source = np.asarray(source, np.float32)
    if len(source) == 0:
        raise ValueError("SR conditioning source is empty")
    if cycle:
        batch = source[np.arange(start, end) % len(source)]
    else:
        batch = source[start:end]
    if len(batch) == 0:
        raise ValueError(
            f"SR conditioning slice [{start}:{end}] is empty for a source of "
            f"{len(source)} images (pass cycle=True to wrap)")
    if len(batch) < batch_size:  # pad with the last image
        batch = np.concatenate(
            [batch, np.repeat(batch[-1:], batch_size - len(batch), axis=0)])
    images = torch.as_tensor(batch, device=device)
    kw = {"hr_images" if source_is_hr else "lr_images": images}
    return make_condition(spec, hw, generator=generator, noise=noise, **kw)


def wrap_model_fn(model_fn: Callable, cond: torch.Tensor) -> Callable:
    """`(x, t, y) -> eps` that calls `model_fn` on [x ; cond] concatenated
    on the last (channel) axis. A fused-CFG batch of a multiple of cond's
    rows sees cond tiled: the same LR image conditions both branches."""

    def fn(x, t, y=None):
        c = cond.to(x.dtype)
        if x.shape[0] != c.shape[0]:
            if x.shape[0] % c.shape[0]:
                raise ValueError(
                    f"model batch {x.shape[0]} is not a multiple of the "
                    f"conditioning batch {c.shape[0]}")
            c = c.repeat(x.shape[0] // c.shape[0], 1, 1, 1)
        return model_fn(torch.cat([x, c], dim=-1), t, y)

    return fn
