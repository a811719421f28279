"""Improved precision & recall for generative models (Kynkaanniemi et al.
2019).

Counterpart of `diffusion_models_collection_tpu/metrics/precision_recall.py`.
A set's support is the union of balls centred on each feature vector with
radius the distance to its k-th nearest neighbour (k = 3 in the paper):
precision is the fraction of fake features inside the real manifold,
recall the fraction of real features inside the fake manifold. The
pairwise distances are one matrix product each, on the device.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from .inception import InceptionFeatures, batched_numpy

# Below this many samples per set the k=3 manifold estimate cannot rank
# similar generators: any generator whose features sit outside the
# reference manifold scores exactly 0. The paper protocol uses N >= 10k;
# `calculate_all_metrics` skips P&R below this bound.
MIN_SAMPLES_RECOMMENDED = 1000


def _pairwise_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distances (N, M) via one matmul."""
    a2 = torch.sum(a ** 2, dim=1, keepdim=True)
    b2 = torch.sum(b ** 2, dim=1, keepdim=True)
    sq = a2 + b2.T - 2.0 * (a @ b.T)
    return torch.sqrt(torch.clamp(sq, min=0.0))


def _coverage(ref: torch.Tensor, query: torch.Tensor, *, k: int
              ) -> torch.Tensor:
    """Fraction of `query` points inside the k-NN manifold of `ref`."""
    # row-sorted: index 0 is the self-distance (0), so index k is the k-th
    # nearest other point, the paper's radius
    radii = torch.sort(_pairwise_dist(ref, ref), dim=1).values[:, k]
    inside = (_pairwise_dist(query, ref) <= radii[None, :]).any(dim=1)
    return torch.mean(inside.to(torch.float32))


class PrecisionRecall:
    """k-NN manifold precision/recall on InceptionV3 pool features."""

    def __init__(
        self,
        k: int = 3,
        feature_fn: Optional[Callable] = None,
        weights_path: Optional[str] = None,
        inception: Optional[InceptionFeatures] = None,
        device: Union[str, torch.device] = "cpu",
    ):
        self.k = int(k)
        if self.k < 1:
            raise ValueError("k must be >= 1")
        self.device = torch.device(device)
        if feature_fn is None:
            self._inception = inception or InceptionFeatures(weights_path,
                                                             device)
            feature_fn = lambda batch: self._inception(batch)[0]
        self.feature_fn = feature_fn

    def extract_features(self, images, batch_size: int = 50) -> np.ndarray:
        return batched_numpy(self.feature_fn, images, batch_size)

    def compute_from_features(self, real_features, fake_features) -> tuple:
        """(precision, recall) from precomputed feature arrays."""
        real = torch.as_tensor(np.asarray(real_features, np.float32),
                               device=self.device)
        fake = torch.as_tensor(np.asarray(fake_features, np.float32),
                               device=self.device)
        for name, arr in (("real", real), ("fake", fake)):
            if arr.shape[0] <= self.k:
                raise ValueError(
                    f"need more than k={self.k} {name} samples for the "
                    f"k-NN radius (got {arr.shape[0]})"
                )
        precision = float(_coverage(real, fake, k=self.k))
        recall = float(_coverage(fake, real, k=self.k))
        return precision, recall

    def compute(self, real_images, fake_images, batch_size: int = 50):
        """(precision, recall) from image arrays in [0, 1]."""
        return self.compute_from_features(
            self.extract_features(real_images, batch_size),
            self.extract_features(fake_images, batch_size),
        )
