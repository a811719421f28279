"""Standard-dataset readers (parity target: reference
datasets/base_dataset.py — the torchvision-backed `DiffusionDataset`).

torchvision is not a dependency here; each dataset's on-disk format is read
natively (IDX for MNIST/FashionMNIST, python-pickle batches for CIFAR,
image folder + partition file for CelebA) from the standard torchvision
directory layout, so data prepared for the reference works unchanged.
`download=True` is accepted for API parity but cannot fetch (dataset files
must exist on disk); a 'synthetic' dataset is added for tests/benchmarks.

Whole datasets are materialized as uint8 NHWC arrays in host RAM (CIFAR-10
is 150 MB) — batch assembly is then pure numpy slicing, which feeds the
device far faster than per-item decode pipelines.
"""

from __future__ import annotations

import gzip
import pickle
import struct
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from .transforms import ImageTransform


def _read_idx(path: Path) -> np.ndarray:
    """Read an IDX-format file (MNIST), gzip or raw."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        data = f.read()
    magic, = struct.unpack(">i", data[:4])
    ndim = magic & 0xFF
    dims = struct.unpack(">" + "i" * ndim, data[4 : 4 + 4 * ndim])
    return np.frombuffer(data[4 + 4 * ndim :], dtype=np.uint8).reshape(dims)


def _find_file(roots, names):
    for root in roots:
        for name in names:
            for cand in (Path(root) / name, Path(root) / (name + ".gz")):
                if cand.exists():
                    return cand
    return None


def _load_mnist_style(root: str, subdir: str, train: bool):
    split = "train" if train else "t10k"
    roots = [Path(root) / subdir / "raw", Path(root) / subdir, Path(root)]
    img_path = _find_file(roots, [f"{split}-images-idx3-ubyte"])
    lbl_path = _find_file(roots, [f"{split}-labels-idx1-ubyte"])
    if img_path is None or lbl_path is None:
        raise FileNotFoundError(
            f"MNIST-format files for split '{split}' not found under {root} "
            f"(expected {subdir}/raw/{split}-images-idx3-ubyte[.gz]); this "
            "environment cannot download datasets."
        )
    images = _read_idx(img_path)[..., None]  # (N, 28, 28, 1)
    labels = _read_idx(lbl_path).astype(np.int64)
    return images, labels


def _load_cifar10(root: str, train: bool):
    base = Path(root) / "cifar-10-batches-py"
    if not base.exists():
        base = Path(root)
    files = (
        [base / f"data_batch_{i}" for i in range(1, 6)]
        if train
        else [base / "test_batch"]
    )
    imgs, labels = [], []
    for f in files:
        if not f.exists():
            raise FileNotFoundError(
                f"CIFAR-10 batch {f} not found; this environment cannot "
                "download datasets."
            )
        with f.open("rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        imgs.append(np.asarray(d[b"data"], dtype=np.uint8))
        labels.extend(d[b"labels"])
    data = np.concatenate(imgs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(data), np.asarray(labels, dtype=np.int64)


def _load_cifar100(root: str, train: bool):
    base = Path(root) / "cifar-100-python"
    if not base.exists():
        base = Path(root)
    f = base / ("train" if train else "test")
    if not f.exists():
        raise FileNotFoundError(
            f"CIFAR-100 file {f} not found; this environment cannot "
            "download datasets."
        )
    with f.open("rb") as fh:
        d = pickle.load(fh, encoding="bytes")
    data = (
        np.asarray(d[b"data"], dtype=np.uint8)
        .reshape(-1, 3, 32, 32)
        .transpose(0, 2, 3, 1)
    )
    return np.ascontiguousarray(data), np.asarray(d[b"fine_labels"], dtype=np.int64)


def _load_celeba(root: str, train: bool):
    """CelebA from the torchvision layout: img_align_celeba/ + partition
    file. Images are decoded lazily (218x178 JPEGs are too large to
    materialize); returns (paths, labels) with labels all zero — CelebA has
    no class labels (reference base_dataset.py:84-89)."""
    base = Path(root) / "celeba"
    if not base.exists():
        base = Path(root)
    img_dir = base / "img_align_celeba"
    if not img_dir.exists():
        raise FileNotFoundError(
            f"CelebA images not found under {img_dir}; this environment "
            "cannot download datasets."
        )
    part_file = base / "list_eval_partition.txt"
    want = 0 if train else 2
    if part_file.exists():
        names = []
        for line in part_file.read_text().splitlines():
            parts = line.split()
            if len(parts) == 2 and int(parts[1]) == want:
                names.append(parts[0])
    else:
        names = sorted(p.name for p in img_dir.iterdir())
    paths = [img_dir / n for n in names]
    return paths, np.zeros(len(paths), dtype=np.int64)


def _synthetic(train: bool, image_size=(32, 32), channels=3, num_classes=10,
               n_train=512, n_test=128, seed=0):
    """Procedural dataset for tests/benchmarks: class-dependent gradients
    plus deterministic noise."""
    n = n_train if train else n_test
    rng = np.random.default_rng(seed if train else seed + 1)
    labels = rng.integers(0, num_classes, size=n)
    h, w = image_size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (xx / max(w - 1, 1) + yy / max(h - 1, 1)) / 2
    imgs = np.empty((n, h, w, channels), dtype=np.uint8)
    for i in range(n):
        phase = labels[i] / max(num_classes, 1)
        img = 0.5 + 0.5 * np.sin(2 * np.pi * (base + phase))
        noise = rng.normal(0, 0.05, size=(h, w, 1)).astype(np.float32)
        arr = np.clip(img[..., None] + noise, 0, 1)
        imgs[i] = (np.repeat(arr, channels, axis=2) * 255).astype(np.uint8)
    return imgs, labels


class DiffusionDataset:
    """Dataset wrapper (API parity: reference base_dataset.py:11-94).

    `__getitem__` returns a float32 HWC image in [-1, 1], or
    (image, label) when conditional.
    """

    SUPPORTED_DATASETS = (
        "cifar10",
        "cifar100",
        "mnist",
        "fashionmnist",
        "celeba",
        "synthetic",
    )

    def __init__(
        self,
        dataset_name: str,
        root: str = "./data",
        train: bool = True,
        transform: Optional[Callable] = None,
        download: bool = True,  # accepted for parity; cannot fetch
        conditional: bool = False,
        **synthetic_kwargs,
    ):
        dataset_name = dataset_name.lower()
        if dataset_name not in self.SUPPORTED_DATASETS:
            raise ValueError(
                f"Dataset {dataset_name} not supported. Supported datasets: "
                f"{list(self.SUPPORTED_DATASETS)}"
            )
        self.dataset_name = dataset_name
        self.conditional = conditional
        self.transform = transform
        self._lazy_paths = None

        if dataset_name == "mnist":
            self.images, self.labels = _load_mnist_style(root, "MNIST", train)
        elif dataset_name == "fashionmnist":
            self.images, self.labels = _load_mnist_style(
                root, "FashionMNIST", train
            )
        elif dataset_name == "cifar10":
            self.images, self.labels = _load_cifar10(root, train)
        elif dataset_name == "cifar100":
            self.images, self.labels = _load_cifar100(root, train)
        elif dataset_name == "celeba":
            self._lazy_paths, self.labels = _load_celeba(root, train)
            self.images = None
        elif dataset_name == "synthetic":
            self.images, self.labels = _synthetic(train, **synthetic_kwargs)

    def __len__(self):
        if self._lazy_paths is not None:
            return len(self._lazy_paths)
        return len(self.images)

    def raw_image(self, idx, min_hw=None) -> np.ndarray:
        """uint8 HWC image before transform. JPEGs decode through the
        native GIL-free libjpeg path (datasets/native.py) with PIL as the
        fallback for other formats / failures. `min_hw` opts into
        DCT-scaled decode (decode at the coarsest 1/denom scale covering
        min_hw) — passed per call by the loader that owns the decode
        policy, never stored on the (shareable) dataset."""
        if self._lazy_paths is not None:
            from . import native

            img = native.decode_image_file(self._lazy_paths[idx],
                                           min_hw=min_hw)
            if img is not None:
                return img
            from PIL import Image

            return np.asarray(Image.open(self._lazy_paths[idx]).convert("RGB"))
        return self.images[idx]

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

    @staticmethod
    def get_default_transform(image_size, dataset_name="cifar10", train=True):
        """Parity: base_dataset.py:96-128 — grayscale datasets skip the
        flip; train adds RandomHorizontalFlip (applied batch-level by the
        loader)."""
        dataset_name = dataset_name.lower()
        grayscale = dataset_name in ("mnist", "fashionmnist")
        if isinstance(image_size, int):
            image_size = (image_size, image_size)
        return ImageTransform(image_size, train=train, grayscale=grayscale)

    @staticmethod
    def get_num_classes(dataset_name: str) -> int:
        """Parity: base_dataset.py:131-142."""
        return {
            "cifar10": 10,
            "cifar100": 100,
            "mnist": 10,
            "fashionmnist": 10,
            "celeba": 0,
            "synthetic": 10,
        }.get(dataset_name.lower(), 0)

    @staticmethod
    def get_image_channels(dataset_name: str) -> int:
        """Parity: base_dataset.py:144-150."""
        if dataset_name.lower() in ("mnist", "fashionmnist"):
            return 1
        return 3
