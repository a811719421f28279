"""Kernel Inception Distance (Bińkowski et al. 2018, "Demystifying MMD
GANs").

Counterpart of `diffusion_models_collection_tpu/metrics/kid.py`. KID is the
squared maximum mean discrepancy between real and fake InceptionV3 pool
features under the cubic polynomial kernel k(x, y) = (x·y / d + 1)^3, by
its unbiased estimator, averaged over random subsets: `subsets` draws of
`subset_size` features each (clamped to the smaller set), reported as
mean ± std of the per-subset MMD^2 (torch-fidelity's convention: diagonal
excluded on the within-set terms, full mean on the cross term).

The subsets come from `np.random.default_rng(seed)`, the same draws as the
JAX package's; the per-subset loop runs on the device, one kernel matrix
live at a time.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from .inception import InceptionFeatures, batched_numpy


def polynomial_kernel(a: torch.Tensor, b: torch.Tensor, degree: int = 3,
                      coef0: float = 1.0) -> torch.Tensor:
    """(N, M) cubic polynomial kernel matrix; gamma = 1/d (the paper's k)."""
    gamma = 1.0 / a.shape[1]
    return (gamma * (a @ b.T) + coef0) ** degree


def _mmd2_unbiased(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Unbiased MMD^2 between equal-size feature subsets (m, d)."""
    m = x.shape[0]
    kxx = polynomial_kernel(x, x)
    kyy = polynomial_kernel(y, y)
    kxy = polynomial_kernel(x, y)
    sum_off_xx = torch.sum(kxx) - torch.trace(kxx)
    sum_off_yy = torch.sum(kyy) - torch.trace(kyy)
    return (sum_off_xx + sum_off_yy) / (m * (m - 1)) - 2.0 * torch.mean(kxy)


class KIDScore:
    """KID calculator on InceptionV3 pool features.

    `feature_fn`: optional override mapping (B, H, W, C) images in [0, 1]
    to (B, D) features (same contract as FIDScore / PrecisionRecall).
    """

    def __init__(
        self,
        subset_size: int = 1000,
        subsets: int = 100,
        feature_fn: Optional[Callable] = None,
        weights_path: Optional[str] = None,
        inception: Optional[InceptionFeatures] = None,
        seed: int = 0,
        device: Union[str, torch.device] = "cpu",
    ):
        if subset_size < 2:
            raise ValueError("subset_size must be >= 2 (unbiased MMD "
                             "divides by m(m-1))")
        if subsets < 1:
            raise ValueError("subsets must be >= 1")
        self.subset_size = int(subset_size)
        self.subsets = int(subsets)
        self.seed = int(seed)
        self.device = torch.device(device)
        if feature_fn is None:
            self._inception = inception or InceptionFeatures(weights_path,
                                                             device)
            feature_fn = lambda batch: self._inception(batch)[0]
        self.feature_fn = feature_fn

    def extract_features(self, images, batch_size: int = 50) -> np.ndarray:
        return batched_numpy(self.feature_fn, images, batch_size)

    def compute_from_features(self, real_features, fake_features) -> tuple:
        """(KID_mean, KID_std) over random subsets, each drawn without
        replacement and redrawn independently per subset."""
        real = np.asarray(real_features, np.float32)
        fake = np.asarray(fake_features, np.float32)
        if real.ndim != 2 or fake.ndim != 2:
            raise ValueError("features must be (N, D) arrays")
        m = min(self.subset_size, len(real), len(fake))
        if m < 2:
            raise ValueError("need at least 2 real and 2 fake features")
        rng = np.random.default_rng(self.seed)
        idx_real = np.stack(
            [rng.choice(len(real), m, replace=False)
             for _ in range(self.subsets)]
        )
        idx_fake = np.stack(
            [rng.choice(len(fake), m, replace=False)
             for _ in range(self.subsets)]
        )
        real_t = torch.from_numpy(real).to(self.device)
        fake_t = torch.from_numpy(fake).to(self.device)
        idx_real = torch.from_numpy(idx_real).to(self.device)
        idx_fake = torch.from_numpy(idx_fake).to(self.device)
        vals = torch.stack([_mmd2_unbiased(real_t[ir], fake_t[jf])
                            for ir, jf in zip(idx_real, idx_fake)])
        vals = vals.cpu().numpy()
        return float(np.mean(vals)), float(np.std(vals))

    def compute_kid(self, real_images, fake_images,
                    batch_size: int = 50) -> tuple:
        """(KID_mean, KID_std); images are (N, H, W, C) in [0, 1]."""
        real = self.extract_features(real_images, batch_size)
        fake = self.extract_features(fake_images, batch_size)
        return self.compute_from_features(real, fake)
