"""Inception Score.

Counterpart of `diffusion_models_collection_tpu/metrics/inception_score.py`.
Class probabilities come batched from the device (InceptionV3 logits,
softmax); the split/KL computation stays in numpy as in the JAX package
and the PyTorch reference: 10 splits, exp(mean KL(p(y|x) || p(y))). With
fewer images than splits the split size is 0 and the score is NaN, as there.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from .inception import InceptionFeatures, batched_numpy


class InceptionScore:
    """IS calculator.

    `logits_fn`: optional override mapping (B, H, W, C) [0,1] images to
    (B, K) class logits; defaults to the InceptionV3 port on `device`.
    """

    def __init__(
        self,
        logits_fn: Optional[Callable] = None,
        weights_path: Optional[str] = None,
        inception: Optional[InceptionFeatures] = None,
        device: Union[str, torch.device] = "cpu",
    ):
        if logits_fn is None:
            self._inception = inception or InceptionFeatures(weights_path,
                                                             device)
            if not self._inception.calibrated:
                print(
                    "WARNING: InceptionV3 weights not found — IS values are "
                    "uncalibrated."
                )
            logits_fn = lambda batch: self._inception(batch)[1]
        self.logits_fn = logits_fn

    def compute_inception_score(self, images, batch_size: int = 32,
                                splits: int = 10):
        n = len(images)
        preds = batched_numpy(
            lambda batch: torch.softmax(
                torch.as_tensor(self.logits_fn(batch)), dim=1),
            images, batch_size)

        split_scores = []
        split_size = n // splits
        for k in range(splits):
            part = preds[k * split_size : (k + 1) * split_size]
            py = np.mean(part, axis=0)
            kl = part * (np.log(part + 1e-10) - np.log(py + 1e-10))
            kl = np.mean(np.sum(kl, axis=1))
            split_scores.append(np.exp(kl))
        return np.mean(split_scores), np.std(split_scores)
