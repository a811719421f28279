"""Fréchet Inception Distance.

Counterpart of `diffusion_models_collection_tpu/metrics/fid.py`. Feature
extraction runs batched on the device through the InceptionV3 port; the
2048x2048 Gaussian statistics and the scipy matrix square root stay on the
host in float64, as in the JAX package and the PyTorch reference (including
the eps-offset retry and the imaginary-component check).
`trace_sqrtm_newton_schulz` is the on-device float32 alternative, not the
default.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch
from scipy import linalg

from .inception import InceptionFeatures, batched_numpy


class FIDScore:
    """FID calculator.

    `feature_fn`: optional override mapping (B, H, W, C) images in [0, 1]
    to (B, D) features; defaults to InceptionV3 pool features on `device`.
    `inception` lets callers share one extractor between metrics.
    """

    def __init__(
        self,
        feature_fn: Optional[Callable] = None,
        weights_path: Optional[str] = None,
        inception: Optional[InceptionFeatures] = None,
        device: Union[str, torch.device] = "cpu",
    ):
        if feature_fn is None:
            self._inception = inception or InceptionFeatures(weights_path,
                                                             device)
            if not self._inception.calibrated:
                print(
                    "WARNING: InceptionV3 weights not found — FID values are "
                    "uncalibrated (set DMC_TPU_INCEPTION_WEIGHTS to a "
                    "torchvision inception_v3 .pth to calibrate)."
                )
            feature_fn = lambda batch: self._inception(batch)[0]
        self.feature_fn = feature_fn

    def compute_statistics(self, images, batch_size: int = 50):
        """Feature mean/covariance. `images` is (N, H, W, C) in [0, 1]."""
        features = batched_numpy(self.feature_fn, images, batch_size)
        mu = np.mean(features, axis=0)
        sigma = np.cov(features, rowvar=False)
        return mu, sigma

    @staticmethod
    def trace_sqrtm_newton_schulz(sigma_prod: np.ndarray, iters: int = 30,
                                  device: Union[str, torch.device] = "cpu"
                                  ) -> float:
        """tr(sqrtm(S)) by Newton–Schulz iteration in float32 on `device`:
        the alternative to scipy's host sqrtm, for the symmetric-PSD
        products FID needs."""
        s = torch.as_tensor(np.asarray(sigma_prod), dtype=torch.float32,
                            device=device)
        dim = s.shape[0]
        norm = torch.sqrt(torch.sum(s * s))
        y = s / norm
        z = torch.eye(dim, dtype=torch.float32, device=device)
        eye3 = 3.0 * torch.eye(dim, dtype=torch.float32, device=device)
        for _ in range(iters):
            t = 0.5 * (eye3 - z @ y)
            y, z = y @ t, t @ z
        return float(torch.trace(y) * torch.sqrt(norm))

    @staticmethod
    def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6):
        """Closed-form Fréchet distance between Gaussians (the JAX
        package's numpy code, line for line, but for scipy's `disp=False`:
        SciPy 1.18 removed the argument, and without it `sqrtm` returns the
        same array, less an error estimate that nothing here reads)."""
        mu1 = np.atleast_1d(mu1)
        mu2 = np.atleast_1d(mu2)
        sigma1 = np.atleast_2d(sigma1)
        sigma2 = np.atleast_2d(sigma2)
        diff = mu1 - mu2

        covmean = linalg.sqrtm(sigma1.dot(sigma2))
        if not np.isfinite(covmean).all():
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))

        if np.iscomplexobj(covmean):
            if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
                m = np.max(np.abs(covmean.imag))
                raise ValueError(f"Imaginary component {m}")
            covmean = covmean.real

        return (
            diff.dot(diff)
            + np.trace(sigma1)
            + np.trace(sigma2)
            - 2 * np.trace(covmean)
        )

    def compute_fid(self, real_images, fake_images, batch_size: int = 50):
        print("Computing statistics for real images...")
        mu_r, sig_r = self.compute_statistics(real_images, batch_size)
        print("Computing statistics for generated images...")
        mu_f, sig_f = self.compute_statistics(fake_images, batch_size)
        print("Calculating FID score...")
        return self.calculate_frechet_distance(mu_r, sig_r, mu_f, sig_f)
