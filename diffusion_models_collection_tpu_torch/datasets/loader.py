"""Batched data loader with per-process sharding and background prefetch.

Numpy replacement for torch DataLoader + DistributedSampler
(reference train.py:107-128, utils/trainer.py:210-211): per-epoch seeded
shuffling, disjoint per-process index shards (the DistributedSampler
contract), drop_last for training, batch-level vectorized horizontal flip,
and a background thread that assembles the next batches while the device
computes — host input pipeline and device step overlap.
"""

from __future__ import annotations

import concurrent.futures
import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from . import native
from .transforms import ImageTransform, flip_batch


class DataLoader:
    """Iterates numpy batches: images (B, H, W, C) float32 in [-1, 1], and
    labels (B,) int64 when the dataset is conditional.

    Args:
      dataset: object with __len__ and __getitem__ -> img or (img, label).
      batch_size: per-iteration LOCAL batch size.
      shuffle: reshuffle each epoch with seed `seed + epoch`
        (set_epoch parity: utils/trainer.py:210-211).
      drop_last: drop the trailing partial batch (train parity).
      process_index / process_count: shard indices across hosts
        (DistributedSampler parity: disjoint strided shards).
      random_flip: apply batch-level horizontal flip with p=0.5.
      prefetch: number of batches assembled ahead in a background thread.
      num_workers: decode threads for per-item (lazy file-backed) datasets
        — CelebA JPEGs / custom folders. PIL's libjpeg decode releases the
        GIL, so threads scale (reference analog: DataLoader num_workers,
        train.py:107-128). 0/1 = serial; default auto (min(8, cpus)).
      cache_decoded: decode the ENTIRE lazy dataset once (parallel, at the
        transform's target size) into a uint8 array and serve every epoch
        from the fused native fast path. Costs N*H*W*3 bytes of host RAM
        (CelebA-64: ~2.3 GB) and one up-front decode pass; epochs after
        the first are array-speed. No effect on array-backed datasets.
      fast_jpeg_decode: decode JPEGs at the coarsest DCT scale (1/2, 1/4,
        1/8 straight out of the entropy decoder) that still covers the
        transform's target size — the resize then only ever downscales.
        Pixel values differ slightly from a full decode (the scaled IDCT
        is its own resampling filter), so this is opt-in: fine for
        training augmentation throughput, off for bit-parity evaluation.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        random_flip: Optional[bool] = None,
        prefetch: int = 2,
        num_workers: Optional[int] = None,
        cache_decoded: bool = False,
        fast_jpeg_decode: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        self.prefetch = prefetch
        transform = getattr(dataset, "transform", None)
        self.random_flip = (
            random_flip
            if random_flip is not None
            else bool(getattr(transform, "random_flip", False))
        )
        self.conditional = bool(getattr(dataset, "conditional", False))

        # Native fast path: for datasets materialized as uint8 NHWC arrays
        # with the standard transform, whole batches are assembled by the
        # fused C++ gather+resize+normalize+flip kernels (native/
        # dmc_native.cpp) instead of the per-item Python path.
        images = getattr(dataset, "images", None)
        self._fast_images = None
        self._pool = None
        self._decode_min_hw = None
        if (
            isinstance(images, np.ndarray)
            and images.dtype == np.uint8
            and images.ndim == 4
            and isinstance(transform, ImageTransform)
        ):
            self._fast_images = images
            self._fast_size = transform.image_size
        elif isinstance(transform, ImageTransform):
            # lazy file-backed dataset (CelebA / custom folder)
            if fast_jpeg_decode and hasattr(dataset, "item"):
                # the decode policy lives HERE, passed per call — storing
                # it on the dataset would leak scaled decode into other
                # loaders sharing the same dataset object
                self._decode_min_hw = tuple(transform.image_size)
            if num_workers is None:
                num_workers = min(8, os.cpu_count() or 1)
            if cache_decoded:
                self._fast_images = self._decode_all(num_workers)
                self._fast_size = transform.image_size
            elif num_workers > 1:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=num_workers,
                    thread_name_prefix="dmc-decode",
                )

    def _decode_all(self, num_workers: int) -> np.ndarray:
        """Parallel one-time decode of a lazy dataset to target-size uint8
        (resize via the per-item transform path, normalization deferred to
        the fused native kernel at batch time)."""
        n = len(self.dataset)
        h, w = self.dataset.transform.image_size
        out = np.empty((n, h, w, 3), dtype=np.uint8)
        gb = out.nbytes / 1e9
        if gb > 0.5:
            print(f"Decoding {n} images to a {gb:.1f} GB uint8 cache...")
        from .transforms import center_crop, resize_image

        def decode(i):
            if self._decode_min_hw is not None:
                img = self.dataset.raw_image(i, min_hw=self._decode_min_hw)
            else:
                img = self.dataset.raw_image(i)
            img = resize_image(img, (h, w))
            out[i] = center_crop(img, (h, w))

        with concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, num_workers)
        ) as pool:
            list(pool.map(decode, range(n), chunksize=256))
        return out

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        # strided shard per process (DistributedSampler semantics); pad so
        # every process sees the same number of samples
        if self.process_count > 1:
            per = -(-n // self.process_count)
            padded = np.concatenate([idx, idx[: per * self.process_count - n]])
            idx = padded[self.process_index :: self.process_count]
        return idx

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _assemble(self, indices: np.ndarray, flip_rng) -> Tuple:
        if self._fast_images is not None:
            mask = (
                (flip_rng.random(len(indices)) < 0.5).astype(np.uint8)
                if self.random_flip
                else None
            )
            h, w = self._fast_size
            src = self._fast_images
            if src.shape[1] != h or src.shape[2] != w:
                src = native.resize_bilinear_batch(
                    np.ascontiguousarray(src[indices]), h, w
                )
                idx = np.arange(len(indices), dtype=np.int64)
            else:
                idx = np.asarray(indices, dtype=np.int64)
            imgs = native.gather_normalize(src, idx, mask)
            if self.conditional:
                labels = np.asarray(self.dataset.labels)[indices].astype(
                    np.int64
                )
                return imgs, labels
            return imgs, None

        if self._decode_min_hw is not None:
            hint = self._decode_min_hw
            getter = lambda i: self.dataset.item(i, hint)  # noqa: E731
        else:
            getter = self.dataset.__getitem__
        if self._pool is not None:
            items = list(self._pool.map(getter, [int(i) for i in indices]))
        else:
            items = [getter(int(i)) for i in indices]
        has_label = isinstance(items[0], tuple)
        imgs = np.empty(
            (len(indices),)
            + np.asarray(items[0][0] if has_label else items[0]).shape,
            dtype=np.float32,
        )
        labels = np.empty((len(indices),), dtype=np.int64) if has_label else None
        for j, item in enumerate(items):
            if has_label:
                imgs[j], labels[j] = item
            else:
                imgs[j] = item
        if self.random_flip:
            imgs = flip_batch(imgs, flip_rng)
        return (imgs, labels) if has_label else (imgs, None)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        indices = self._epoch_indices()
        nb = len(self)
        flip_rng = np.random.default_rng(self.seed * 7919 + self.epoch)

        if self.prefetch <= 0:
            for b in range(nb):
                yield self._assemble(
                    indices[b * self.batch_size : (b + 1) * self.batch_size],
                    flip_rng,
                )
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for b in range(nb):
                    if stop.is_set():
                        return
                    batch = self._assemble(
                        indices[b * self.batch_size : (b + 1) * self.batch_size],
                        flip_rng,
                    )
                    q.put(batch)
                q.put(None)
            except BaseException as e:  # surface worker errors to consumer
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
