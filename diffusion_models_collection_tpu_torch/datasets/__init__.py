"""Datasets and the loader (parity: reference datasets/__init__.py:6-9).

The port's own copy of `diffusion_models_collection_tpu/datasets/`: numpy,
ctypes and the standard library only (Pillow lazily, for resizing), so the
port imports nothing of the JAX package. Batches are bit-for-bit those of
the original for the same seed.
"""

from .base_dataset import DiffusionDataset
from .custom_dataset import CustomImageDataset
from .loader import DataLoader
from .transforms import ImageTransform, flip_batch

__all__ = [
    "DiffusionDataset",
    "CustomImageDataset",
    "DataLoader",
    "ImageTransform",
    "flip_batch",
]
