"""Image transforms (parity target: reference datasets/base_dataset.py:96-128
and custom_dataset.py:148-170 torchvision pipelines), implemented on
numpy/PIL with a vectorized fast path.

Semantics preserved: Resize to exact (H, W) bilinear, CenterCrop (no-op
after exact resize, kept for parity), RandomHorizontalFlip p=0.5 on train
RGB, scale to [0,1], normalize to [-1,1]. Output layout is NHWC float32 —
the models' layout, normalized once on the host so the device step is
pure compute.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def resize_image(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Resize HWC uint8 to exact (H, W) with PIL bilinear (torchvision
    Resize((h,w)) semantics). No-op when already the target size."""
    h, w = size
    if img.shape[0] == h and img.shape[1] == w:
        return img
    from PIL import Image

    squeeze = img.ndim == 3 and img.shape[2] == 1
    pil = Image.fromarray(img[..., 0] if squeeze else img)
    pil = pil.resize((w, h), Image.BILINEAR)
    out = np.asarray(pil)
    if squeeze:
        out = out[..., None]
    return out


def center_crop(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    h, w = size
    ih, iw = img.shape[:2]
    if ih == h and iw == w:
        return img
    top = max(0, (ih - h) // 2)
    left = max(0, (iw - w) // 2)
    out = img[top : top + h, left : left + w]
    if out.shape[0] != h or out.shape[1] != w:  # pad if image smaller
        pad_h, pad_w = h - out.shape[0], w - out.shape[1]
        out = np.pad(
            out,
            ((pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2))
            + ((0, 0),) * (out.ndim - 2),
        )
    return out


class ImageTransform:
    """Deterministic per-image preprocessing + stochastic batch-level flip.

    `__call__(img_uint8_hwc) -> float32 HWC in [-1, 1]` applies resize/crop/
    normalize; the random horizontal flip is applied vectorized at batch
    level by the loader via `flip_batch` (keeps per-item work cheap and the
    RNG stream seedable per epoch).
    """

    def __init__(
        self,
        image_size: Tuple[int, int],
        train: bool = True,
        grayscale: bool = False,
        random_flip: Optional[bool] = None,
    ):
        self.image_size = tuple(image_size)
        self.train = train
        self.grayscale = grayscale
        # parity: flip only for train RGB (base_dataset.py:106-121)
        self.random_flip = (
            random_flip if random_flip is not None else (train and not grayscale)
        )

    def __call__(self, img: np.ndarray) -> np.ndarray:
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[..., None]
        img = resize_image(img, self.image_size)
        img = center_crop(img, self.image_size)
        return img.astype(np.float32) / 255.0 * 2.0 - 1.0


def flip_batch(batch: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Random horizontal flip, p=0.5 per image, vectorized over the batch."""
    mask = rng.random(batch.shape[0]) < 0.5
    if not mask.any():
        return batch
    out = batch.copy()
    out[mask] = out[mask, :, ::-1]
    return out
