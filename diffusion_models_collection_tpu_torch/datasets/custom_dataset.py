"""Custom image-folder dataset (parity target: reference
datasets/custom_dataset.py:14-170). Three load modes with identical
semantics: flat folder (unconditional), subdirectories-as-classes, and a
JSON label file with labels remapped to consecutive indices.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from .transforms import ImageTransform


class CustomImageDataset:
    SUPPORTED_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".webp")

    def __init__(
        self,
        root: str,
        transform: Optional[Callable] = None,
        conditional: bool = False,
        label_file: Optional[str] = None,
        use_subdirs: bool = False,
    ):
        self.root = Path(root)
        self.transform = transform
        self.conditional = conditional
        self.use_subdirs = use_subdirs

        self.images = []
        self.labels = []
        self.class_to_idx = {}

        if self.conditional and not (use_subdirs or label_file):
            raise ValueError(
                "CustomImageDataset with conditional=True requires either "
                "use_subdirs=True or a label_file."
            )

        # parity quirk preserved (custom_dataset.py:83-91): label sources are
        # scanned when configured even if conditional=False.
        if use_subdirs:
            self._load_with_subdirs()
        elif label_file:
            self._load_with_json(label_file)
        else:
            self._load_images_only()

    def _load_images_only(self):
        for path in self.root.iterdir():
            if path.is_file() and path.suffix.lower() in self.SUPPORTED_EXTENSIONS:
                self.images.append(path)

    def _load_with_subdirs(self):
        classes = sorted(p for p in self.root.iterdir() if p.is_dir())
        self.class_to_idx = {cls.name: idx for idx, cls in enumerate(classes)}
        for class_dir in classes:
            class_idx = self.class_to_idx[class_dir.name]
            for img_path in class_dir.iterdir():
                if (
                    img_path.is_file()
                    and img_path.suffix.lower() in self.SUPPORTED_EXTENSIONS
                ):
                    self.images.append(img_path)
                    self.labels.append(class_idx)

    def _load_with_json(self, label_file):
        with Path(label_file).open("r", encoding="utf-8") as f:
            labels_dict = json.load(f)
        for filename, label in labels_dict.items():
            img_path = self.root / filename
            if img_path.exists():
                self.images.append(img_path)
                self.labels.append(label)
        unique_labels = sorted(set(self.labels))
        self.class_to_idx = {label: idx for idx, label in enumerate(unique_labels)}
        self.labels = [self.class_to_idx[l] for l in self.labels]

    def __len__(self):
        return len(self.images)

    def raw_image(self, idx, min_hw=None) -> np.ndarray:
        """JPEGs decode through the native GIL-free libjpeg path
        (datasets/native.py); other formats / failures fall back to PIL.
        `min_hw` opts into DCT-scaled decode — a per-call hint from the
        loader that owns the decode policy (never dataset state)."""
        from . import native

        img = native.decode_image_file(self.images[idx], min_hw=min_hw)
        if img is not None:
            return img
        from PIL import Image

        return np.asarray(Image.open(self.images[idx]).convert("RGB"))

    def item(self, idx, decode_min_hw=None):
        """__getitem__ with an explicit decode hint (loader fast path)."""
        img = self.raw_image(idx, min_hw=decode_min_hw)
        if self.transform is not None:
            img = self.transform(img)
        if self.conditional:
            return img, int(self.labels[idx])
        return img

    def __getitem__(self, idx):
        return self.item(idx)

    @property
    def num_classes(self) -> int:
        """Parity: custom_dataset.py:142-147."""
        if self.conditional:
            return len(self.class_to_idx)
        return 0

    @staticmethod
    def get_default_transform(image_size, dataset_type="rgb", train=True):
        """Parity: custom_dataset.py:148-170."""
        if isinstance(image_size, int):
            image_size = (image_size, image_size)
        return ImageTransform(image_size, train=train, grayscale=False)
