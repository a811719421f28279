"""LPIPS perceptual metric and `calculate_all_metrics`.

Counterpart of `diffusion_models_collection_tpu/metrics/lpips_score.py`:
`lpips.LPIPS(net='alex')`. AlexNet conv features at the 5 ReLU taps,
channel-unit-normalized, squared-difference weighted by the learned 1x1
"lin" layers, spatially averaged, summed over taps; inputs scaled to
[-1, 1] and then by the lpips package's shift/scale. The AlexNet is
torchvision's `features` trunk with its indices, so a torchvision alexnet
state loads natively.

Weights: `weights_path` / env DMC_TPU_LPIPS_WEIGHTS pointing at the lpips
package's combined state, a torchvision alexnet state or a converted
`.npz`. Without weights the AlexNet takes flax's default init (lecun-normal
kernels, zero biases; not scaled) from `torch.Generator` seed 0 and the
lins are uniform 1/C: uncalibrated, still a consistent diversity
statistic. As in the reference, `calculate_all_metrics` computes LPIPS
diversity only (random distinct pairs of generated images).
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.data_parallel import gather_rows
from ..parallel.mesh import data_layout
from ..utils.weights import ALEXNET_CONV_IDS, alexnet_state_dict_from_jax
from .inception import flax_default_init_

WEIGHTS_ENV_VAR = "DMC_TPU_LPIPS_WEIGHTS"

# lpips package ScalingLayer constants
_SHIFT = np.array([-0.030, -0.088, -0.188], dtype=np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], dtype=np.float32)

_ALEX_CHANNELS = (64, 192, 384, 256, 256)
_TAP_IDS = tuple(i + 1 for i in ALEXNET_CONV_IDS)  # the ReLU after each conv


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet `features` trunk; `forward` takes NCHW and
    returns the 5 ReLU taps."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(),
        )

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in _TAP_IDS:
                taps.append(x)
        return taps


def _normalize_tensor(feat: torch.Tensor, eps: float = 1e-10
                      ) -> torch.Tensor:
    """Unit norm over the channels (dim 1 of NCHW)."""
    norm = torch.sqrt(torch.sum(feat ** 2, dim=1, keepdim=True))
    return feat / (norm + eps)


def load_lpips_weights(path) -> Dict:
    """lpips-package weights as {"alex": AlexNetFeatures state dict,
    "lins": [w0..w4]}: an .npz with keys conv{i}_kernel (HWIO), conv{i}_bias
    and lin{i}, or a torch state dict in either layout of
    `convert_lpips_state`."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as data:
            tree = {f"conv{i}": {"kernel": data[f"conv{i}_kernel"],
                                 "bias": data[f"conv{i}_bias"]}
                    for i in range(1, 6)}
            lins = [torch.from_numpy(np.asarray(data[f"lin{i}"]))
                    for i in range(5)]
        alex = {k: torch.from_numpy(v)
                for k, v in alexnet_state_dict_from_jax(tree).items()}
        return {"alex": alex, "lins": lins}
    state = torch.load(path, map_location="cpu", weights_only=True)
    return convert_lpips_state(state, source=str(path))


def convert_lpips_state(state, source="<state>") -> Dict:
    """Parse an LPIPS/AlexNet state mapping (torch tensors or numpy).

    Two layouts are understood; the original AlexNet conv indices
    {0,3,6,8,10} identify the 5 taps in both:
      * lpips package: `net.sliceK.N.{weight,bias}` (the slice modules
        keep the original feature indices) + `linJ.model.1.weight`
        (1,C,1,1) lin layers;
      * torchvision alexnet: `features.N.{weight,bias}` (lins absent ->
        uniform 1/C).
    """
    feature_ids = {str(i) for i in ALEXNET_CONV_IDS}
    alex: Dict[str, torch.Tensor] = {}
    lins = [None] * 5
    for key, tensor in state.items():
        arr = torch.as_tensor(np.asarray(tensor), dtype=torch.float32)
        parts = key.split(".")
        if parts[0].startswith("lin") and parts[0][3:].isdigit():
            lins[int(parts[0][3:])] = arr.reshape(-1)
            continue
        # conv layer index: element after 'features' or after 'net.sliceK'
        fid = None
        if "features" in parts:
            fid = parts[parts.index("features") + 1]
        elif parts[0] == "net" and parts[1].startswith("slice"):
            fid = parts[2]
        if fid in feature_ids and parts[-1] in ("weight", "bias"):
            alex[f"features.{fid}.{parts[-1]}"] = arr
    if len(alex) != 10:
        raise ValueError(f"Could not parse LPIPS weights from {source}")
    if any(lin is None for lin in lins):
        lins = [torch.ones(c) / c for c in _ALEX_CHANNELS]
    return {"alex": alex, "lins": lins}


class LPIPSScore:
    """LPIPS calculator on `device`, float32."""

    def __init__(self, net: str = "alex", weights_path: Optional[str] = None,
                 device: Union[str, torch.device] = "cpu"):
        if net != "alex":
            raise ValueError("Only net='alex' is supported (reference default)")
        self.device = torch.device(device)
        model = AlexNetFeatures()
        weights_path = weights_path or os.environ.get(WEIGHTS_ENV_VAR)
        if weights_path and Path(weights_path).exists():
            loaded = load_lpips_weights(weights_path)
            model.load_state_dict(loaded["alex"], strict=True)
            lins = loaded["lins"]
            self.calibrated = True
        else:
            flax_default_init_(model, seed=0)
            lins = [torch.ones(c) / c for c in _ALEX_CHANNELS]
            self.calibrated = False
            print(
                "WARNING: LPIPS weights not found — values are uncalibrated "
                "(set DMC_TPU_LPIPS_WEIGHTS)."
            )
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.lins = [lin.to(self.device, torch.float32) for lin in lins]
        self.shift = torch.from_numpy(_SHIFT).to(self.device)[None, :, None,
                                                              None]
        self.scale = torch.from_numpy(_SCALE).to(self.device)[None, :, None,
                                                              None]

    def _prep(self, x) -> torch.Tensor:
        """(B, H, W, C) in [0, 1] -> NCHW, [-1, 1], shifted and scaled."""
        x = torch.as_tensor(x).to(self.device, torch.float32)
        x = (x * 2.0 - 1.0).permute(0, 3, 1, 2)  # ScalingLayer wants [-1, 1]
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        # AlexNet's stride-4 stem and pools need >= 16 px inputs (the torch
        # reference errors below that): upsample tiny images
        h, w = x.shape[2:]
        if h < 16 or w < 16:
            x = F.interpolate(x, size=(max(h, 32), max(w, 32)),
                              mode="bilinear", align_corners=False)
        return (x - self.shift) / self.scale

    def distance(self, x1, x2) -> torch.Tensor:
        """Per-pair LPIPS of two (B, H, W, C) batches in [0, 1]."""
        with torch.inference_mode():
            taps1 = self.model(self._prep(x1))
            taps2 = self.model(self._prep(x2))
            total = 0.0
            for f1, f2, lin in zip(taps1, taps2, self.lins):
                d = (_normalize_tensor(f1) - _normalize_tensor(f2)) ** 2
                weighted = torch.sum(d * lin[None, :, None, None], dim=1)
                total = total + torch.mean(weighted, dim=(1, 2))
            return total

    def compute_lpips(self, images1, images2, batch_size: int = 32) -> float:
        """Mean LPIPS between paired sets, inputs (N, H, W, C) in [0, 1]. In
        a world of processes each batch of pairs splits over the ranks and
        the distances are gathered in rank order
        (`parallel/data_parallel.gather_rows`, as the JAX score shards each
        batch over a 'data' mesh); every rank must call it with the same
        images."""
        assert len(images1) == len(images2), "Number of images must match"
        layout = data_layout()
        dists = []
        for start in range(0, len(images1), batch_size):
            pair = (torch.as_tensor(images[start:start + batch_size])
                    for images in (images1, images2))
            dists.append(gather_rows(self.distance, layout, *pair)
                         .cpu().numpy())
        return float(np.mean(np.concatenate(dists)))

    def compute_lpips_diversity(self, images, num_pairs: int = 1000,
                                batch_size: int = 32, seed: int = 0) -> float:
        """Mean LPIPS over random distinct pairs (the JAX package's numpy
        draws)."""
        n = len(images)
        rng = np.random.default_rng(seed)
        idx1 = rng.integers(0, n, size=num_pairs)
        idx2 = rng.integers(0, n, size=num_pairs)
        while (idx1 == idx2).any():
            mask = idx1 == idx2
            idx2[mask] = rng.integers(0, n, size=int(mask.sum()))
        images = np.asarray(images)
        return self.compute_lpips(images[idx1], images[idx2], batch_size)


def calculate_all_metrics(real_images, fake_images, weights_path=None,
                          lpips_weights_path=None,
                          device: Union[str, torch.device] = "cpu",
                          seconds: Optional[Dict[str, float]] = None) -> Dict:
    """FID, improved precision/recall (or the marker that skipped them),
    KID, IS and LPIPS diversity of the fake set, in the JAX package's order
    and keys, all metric networks on `device` in float32. One InceptionV3
    serves FID, P&R, KID and IS, and each set's pool features are extracted
    once. `seconds`, when given, receives each stage's wall time:
    inception_build (its weights drawn or loaded), features, FID (mostly
    the host sqrtm), precision_recall, KID, IS, LPIPS."""
    from .fid import FIDScore
    from .inception import InceptionFeatures
    from .inception_score import InceptionScore
    from .kid import KIDScore
    from .precision_recall import MIN_SAMPLES_RECOMMENDED, PrecisionRecall

    metrics = {}
    seconds = {} if seconds is None else seconds
    clock = [time.perf_counter()]

    def lap(stage):
        now = time.perf_counter()
        seconds[stage] = now - clock[0]
        clock[0] = now

    inception = InceptionFeatures(weights_path, device)
    pr = PrecisionRecall(inception=inception, device=device)
    lap("inception_build")

    print("\n=== Extracting features ===")
    real_feats = pr.extract_features(real_images)
    fake_feats = pr.extract_features(fake_images)
    lap("features")

    print("\n=== Computing FID ===")
    fid = FIDScore.calculate_frechet_distance(
        np.mean(real_feats, axis=0), np.cov(real_feats, rowvar=False),
        np.mean(fake_feats, axis=0), np.cov(fake_feats, rowvar=False),
    )
    metrics["FID"] = float(fid)
    print(f"FID: {fid:.4f}")
    lap("FID")

    n_min = min(len(real_feats), len(fake_feats))
    if n_min >= MIN_SAMPLES_RECOMMENDED:
        print("\n=== Computing precision/recall ===")
        precision, recall = pr.compute_from_features(real_feats, fake_feats)
        metrics["precision"] = precision
        metrics["recall"] = recall
        print(f"Precision: {precision:.4f}  Recall: {recall:.4f}")
    else:
        # the k-NN manifold has no ranking resolution at small N: skip, and
        # say so in the schema rather than drop the keys
        metrics["precision_recall_skipped_below_n"] = MIN_SAMPLES_RECOMMENDED
        print(
            f"\nSkipping precision/recall: {n_min} samples < "
            f"{MIN_SAMPLES_RECOMMENDED} minimum for a meaningful k-NN "
            "manifold estimate (use metrics.PrecisionRecall directly to "
            "override)."
        )
    lap("precision_recall")

    print("\n=== Computing KID ===")
    kid_mean, kid_std = KIDScore(
        inception=inception, device=device).compute_from_features(
            real_feats, fake_feats)
    metrics["KID_mean"] = kid_mean
    metrics["KID_std"] = kid_std
    print(f"KID: {kid_mean:.6f} ± {kid_std:.6f}")
    lap("KID")

    print("\n=== Computing IS ===")
    is_mean, is_std = InceptionScore(
        inception=inception, device=device).compute_inception_score(
            fake_images)
    metrics["IS_mean"] = float(is_mean)
    metrics["IS_std"] = float(is_std)
    print(f"IS: {is_mean:.4f} ± {is_std:.4f}")
    lap("IS")

    print("\n=== Computing LPIPS ===")
    lpips_calculator = LPIPSScore(weights_path=lpips_weights_path,
                                  device=device)
    lpips_div = lpips_calculator.compute_lpips_diversity(fake_images)
    metrics["LPIPS_diversity"] = float(lpips_div)
    print(f"LPIPS Diversity: {lpips_div:.4f}")
    lap("LPIPS")

    # Calibration manifest (private key, popped by evaluate): every metric
    # computed from random-init features is a relative statistic only
    uncalibrated = []
    if not inception.calibrated:
        uncalibrated += [
            k for k in ("FID", "KID_mean", "KID_std", "IS_mean", "IS_std",
                        "precision", "recall")
            if k in metrics
        ]
    if not lpips_calculator.calibrated:
        uncalibrated += ["LPIPS_diversity"]
    if uncalibrated:
        metrics["_uncalibrated"] = uncalibrated

    return metrics
