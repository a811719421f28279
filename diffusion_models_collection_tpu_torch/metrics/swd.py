"""Sliced Wasserstein Distance on Laplacian-pyramid patches.

Counterpart of `diffusion_models_collection_tpu/metrics/swd.py`: the
multi-scale SWD protocol of Karras et al. 2018 (Progressive GAN, appendix
A). Descriptors are 7x7xC patches drawn from each level of a Laplacian
pyramid, standardized with the real set's statistics, projected onto random
unit directions; the distance per level is the mean L1 gap between the
sorted projections of the real and fake patch sets (the 1-D
Wasserstein-1 distance, averaged over directions), reported x1e3 per level
with the level average. It needs no learned features, so it is calibrated
by construction: the metric to trust when the Inception and LPIPS weights
are absent.

The patch positions, the subsampling permutations and the projections are
drawn from a `torch.Generator` seeded with `seed` (on the host, so every
device draws the same); the internal functions take the draws as arguments.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

PATCH = 7  # descriptor side (Karras et al. 2018 use 7x7)


def _blur(x: torch.Tensor) -> torch.Tensor:
    """The paper's 5x5 binomial blur ([1,4,6,4,1]/16, separable), zero
    padded to the same size, per channel of NHWC images: a depthwise
    conv."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32)
    k2 = np.outer(k, k)
    c = x.shape[-1]
    kern = torch.from_numpy(k2 / k2.sum()).to(x.device, x.dtype)
    kern = kern.expand(c, 1, 5, 5)
    out = F.conv2d(x.permute(0, 3, 1, 2), kern, padding=2, groups=c)
    return out.permute(0, 2, 3, 1)


def _downsample(x: torch.Tensor) -> torch.Tensor:
    return _blur(x)[:, ::2, ::2, :]


def _upsample(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    up = x.new_zeros((b, 2 * h, 2 * w, c))
    up[:, ::2, ::2, :] = x
    # 4x compensates the 3/4 zeros introduced by the dilation
    return 4.0 * _blur(up)


def laplacian_pyramid(x: torch.Tensor, levels: int):
    """[finest residual, ..., coarsest residual, low-pass base] of NHWC
    images."""
    pyr = []
    cur = x
    for _ in range(levels - 1):
        down = _downsample(cur)
        pyr.append(cur - _upsample(down))
        cur = down
    pyr.append(cur)
    return pyr


def _extract_patches(level: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B * P, PATCH*PATCH*C): the patches whose top-left
    corners are (ys, xs), each (B, P) (the same positions for every
    channel of an image)."""
    b, _, _, c = level.shape
    offsets = torch.arange(PATCH, device=level.device)
    rows = (ys[:, :, None, None] + offsets[:, None])  # (B, P, 7, 1)
    cols = (xs[:, :, None, None] + offsets[None, :])  # (B, P, 1, 7)
    batch = torch.arange(b, device=level.device)[:, None, None, None]
    patches = level[batch, rows, cols]  # (B, P, 7, 7, C)
    return patches.reshape(-1, PATCH * PATCH * c)


def _sliced_w1(real_desc: torch.Tensor, fake_desc: torch.Tensor,
               dirs: torch.Tensor) -> torch.Tensor:
    """Mean over the directions `dirs` (D, n_projections; normalized here)
    of W1 between the projected sets. Descriptors are standardized per
    feature with the real set's statistics (sharing them keeps the metric
    sensitive to mean/scale drift in fakes)."""
    mu = torch.mean(real_desc, dim=0, keepdim=True)
    sd = torch.std(real_desc, dim=0, keepdim=True, correction=0) + 1e-8
    r = (real_desc - mu) / sd
    f = (fake_desc - mu) / sd
    dirs = dirs / (torch.linalg.norm(dirs, dim=0, keepdim=True) + 1e-12)
    pr = torch.sort(r @ dirs, dim=0).values  # (P, D) sorted per direction
    pf = torch.sort(f @ dirs, dim=0).values
    return torch.mean(torch.abs(pr - pf))


class SWDScore:
    """Multi-scale sliced Wasserstein distance (x1e3, lower is better),
    computed on `device`."""

    def __init__(self, patches_per_image: int = 64,
                 n_projections: int = 256, seed: int = 0,
                 device: Union[str, torch.device] = "cpu"):
        self.patches_per_image = int(patches_per_image)
        self.n_projections = int(n_projections)
        self.seed = int(seed)
        self.device = torch.device(device)

    def compute(self, real01, fake01,
                levels: Optional[int] = None) -> Dict[str, float]:
        """images in [0, 1], NHWC (grayscale tolerated). Returns
        {"swd_<res>x<res>": x1e3 per level, "swd_avg": mean}."""
        real = torch.as_tensor(np.asarray(real01, np.float32),
                               device=self.device)
        fake = torch.as_tensor(np.asarray(fake01, np.float32),
                               device=self.device)
        if real.ndim == 3:
            real = real[..., None]
        if fake.ndim == 3:
            fake = fake[..., None]
        # the level count derives from the real set's height and the two
        # pyramids are zipped: mismatched resolutions would silently
        # compare different scales (descriptor dims still match)
        if tuple(real.shape[1:3]) != tuple(fake.shape[1:3]):
            raise ValueError(
                "SWD requires equal real/fake resolutions, got "
                f"real {tuple(real.shape[1:3])} vs "
                f"fake {tuple(fake.shape[1:3])}; resize one set first."
            )
        h = int(real.shape[1])
        if levels is None:
            # pyramid down to 16px, the paper's coarsest level (min 1)
            levels = max(1, int(np.log2(max(h, PATCH * 2) / 16)) + 1)
        gen = torch.Generator().manual_seed(self.seed)

        def draw_positions(lvl):
            b, hh, ww = lvl.shape[:3]
            shape = (b, self.patches_per_image)
            ys = torch.randint(0, hh - PATCH + 1, shape, generator=gen)
            xs = torch.randint(0, ww - PATCH + 1, shape, generator=gen)
            return ys.to(self.device), xs.to(self.device)

        out = {}
        vals = []
        pyr_r = laplacian_pyramid(real, levels)
        pyr_f = laplacian_pyramid(fake, levels)
        for lr, lf in zip(pyr_r, pyr_f):
            res = int(lr.shape[1])
            if res < PATCH:
                continue
            dr = _extract_patches(lr, *draw_positions(lr))
            df = _extract_patches(lf, *draw_positions(lf))
            # the sorted-projection W1 pairs same-rank quantiles, so both
            # descriptor sets must be the same size: subsample the larger
            n = min(dr.shape[0], df.shape[0])
            if dr.shape[0] > n:
                dr = dr[torch.randperm(dr.shape[0], generator=gen)[:n]
                        .to(self.device)]
            if df.shape[0] > n:
                df = df[torch.randperm(df.shape[0], generator=gen)[:n]
                        .to(self.device)]
            dirs = torch.randn(dr.shape[1], self.n_projections,
                               generator=gen).to(self.device)
            val = float(_sliced_w1(dr, df, dirs)) * 1e3
            out[f"swd_{res}x{res}"] = val
            vals.append(val)
        out["swd_avg"] = float(np.mean(vals)) if vals else float("nan")
        return out


def compute_swd(real01, fake01, **kwargs) -> Dict[str, float]:
    """Functional wrapper: multi-scale SWD x1e3 (lower is better)."""
    return SWDScore(**kwargs).compute(real01, fake01)
