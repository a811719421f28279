"""DeepCache (Ma et al. 2023): DDIM sampling that reuses the UNet's deep
features across steps.

Counterpart of `diffusion_models_collection_tpu/diffusion/deepcache.py`.
The deep, low-resolution features of the UNet change slowly from one step
to the next. Every `interval`-th step runs the whole network and keeps the
up-path feature entering its outermost `deepcache_depth` levels
(`deepcache_mode='full'`); the steps between run only those outer levels
and splice the kept feature in for everything deeper
(`deepcache_mode='shallow'`). The JAX package compiles the trajectory as
one scan over chunks of one full and `interval - 1` shallow steps with an
unrolled tail; here it is a Python loop on the host, one model call a step,
step i full when i % interval == 0 (the same chunks, tail included).

Guidance, thresholding, `guidance_rescale`, `cfg_interval`, eta noise and
v/x0 prediction go through the same `base.cfg_eps_x0` and
`base.wrap_model_as_eps_x0` as the plain samplers, so `interval` 1 is
`DDIM.sample` and `DDIM.sample_with_cfg` exactly.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from . import base
from .ddim import ddim_step


def _pair_from_raw(schedule, raw, x, t, prediction_type):
    """(eps, x0) of a model output already computed."""
    return base.wrap_model_as_eps_x0(
        schedule, lambda _x, _t, _y=None: raw, prediction_type)(x, t, None)


@torch.no_grad()
def deepcache_sample(ddim, full_fn: Callable, shallow_fn: Callable, shape,
                     generator: Optional[torch.Generator] = None, y=None,
                     cfg_scale: Optional[float] = None, interval: int = 3,
                     p_threshold=base.AUTO_THRESHOLD, init_noise=None,
                     noises: Optional[Sequence] = None) -> torch.Tensor:
    """A DDIM trajectory of `ddim` (its grid, eta, constraints, guidance
    knobs and prediction type) with DeepCache: `full_fn(x, t, y) -> (raw,
    cache)` is the model with `deepcache_mode='full'`, `shallow_fn(x, t, y,
    cache) -> raw` the same weights with 'shallow' at the same depth.
    `cfg_scale` None samples unguided. eta > 0 takes noises[i] at step i,
    or draws from `generator`. Returns the final images."""
    interval = int(interval)
    if interval < 1:
        raise ValueError(f"interval must be >= 1, got {interval}")
    steps = ddim.inference_timesteps.tolist()
    # beyond the grid's length: one full step, then all shallow
    interval = min(interval, len(steps))
    use_cfg = cfg_scale is not None
    if use_cfg and y is None:
        raise ValueError("CFG sampling requires class labels y.")
    if ddim.eta > 0:
        base.check_noises(noises, len(steps))
    img = base.initial_image(shape, generator, init_noise)
    device = img.device
    schedule = ddim.schedule_on(device)
    if y is not None:
        y = torch.as_tensor(y, device=device)
    p_threshold = (base.resolve_p_threshold(p_threshold, ddim.clip_sample)
                   if use_cfg else None)
    batch = img.shape[0]
    cache = None

    def raw_call(x, t, labels, full):
        nonlocal cache
        if full:
            raw, cache = full_fn(x, t, labels)
            return raw
        return shallow_fn(x, t, labels, cache)

    for i, t_i in enumerate(steps):
        t_next_i = steps[i + 1] if i + 1 < len(steps) else -1
        t = torch.full((batch,), t_i, dtype=torch.int64, device=device)
        t_next = torch.full((batch,), t_next_i, dtype=torch.int64,
                            device=device)
        full = i % interval == 0

        def pair_fn(x, tt, labels):
            return _pair_from_raw(schedule, raw_call(x, tt, labels, full), x,
                                  tt, ddim.prediction_type)

        if use_cfg:
            eps, x0 = base.cfg_eps_x0(
                pair_fn, img, t, y, float(cfg_scale),
                guidance_rescale=ddim.guidance_rescale, schedule=schedule,
                cfg_interval=ddim.cfg_interval)
            x0 = base.constrain_x0(x0, p_threshold, ddim.clip_sample)
        else:
            eps, x0 = pair_fn(img, t, y)
            if ddim.clip_sample:
                x0 = torch.clamp(x0, -1.0, 1.0)
        noise = (base.step_noise(noises, i, img, generator)
                 if ddim.eta > 0 else None)
        img = ddim_step(schedule, img, t, t_next, eps, x0, ddim.eta, noise)
    return img
