"""Classifier guidance (Dhariwal & Nichol 2021, Alg. 2).

Counterpart of `diffusion_models_collection_tpu/diffusion/guidance.py`. The
eps prediction is shifted by a noise-conditional classifier's score
(`models/classifier.py`),

    eps'(x_t, t) = eps(x_t, t) - s * sqrt(1 - acp_t) * grad_x log p(y | x_t, t),

which samples from p(x) p(y|x)^s. It wraps the model callable, where SR
conditioning (`utils/sr.py`) and PAG wrap it too, so every VP sampler
(DDPM, DDIM, DPM-Solver++, UniPC) is guided without a change of its own.
Defined on the eps parameterization of the VP processes: `sample` refuses
it for flow, EDM and v/x0-predicting checkpoints.

The samplers run under `torch.no_grad()`; the gradient is taken under
`torch.enable_grad()` on a detached copy of x that requires grad, so on a
card the classifier's forward runs the GroupNorm+SiLU and attention kernels
and its backward their backward kernels, whatever the caller's grad mode.
The classifier's parameters are not differentiated.
"""

from __future__ import annotations

from typing import Callable

import torch

from .schedule import NoiseSchedule, extract


def classifier_guided_model_fn(model_fn: Callable, classifier_fn: Callable,
                               labels: torch.Tensor, scale: float,
                               schedule: NoiseSchedule) -> Callable:
    """Wrap an eps-predicting `(x, t, y) -> eps` denoiser with classifier
    guidance toward `labels` (raw 0..K-1, one per sample: not the +1-shifted
    CFG labels) at strength `scale`. `classifier_fn(x, t)` returns logits.

    A call at len(labels) rows guides each row. A call at a multiple of it
    (the samplers' fused-CFG batch [x ; x]) holds duplicates of the same
    images: the gradient is taken once on the first B rows and tiled.
    """
    labels = torch.as_tensor(labels)
    if labels.ndim != 1 or labels.is_floating_point() or labels.is_complex():
        raise ValueError("guidance labels must be a 1-D int tensor")
    labels = labels.to(torch.int64)
    scale = float(scale)
    b = labels.shape[0]
    schedules = {}

    def fn(x, t, y=None):
        eps = model_fn(x, t, y)
        reps = 1
        if x.shape[0] != b:
            if x.shape[0] % b:
                raise ValueError(
                    f"model batch {x.shape[0]} is not a multiple of the "
                    f"guidance-label batch {b}")
            reps = x.shape[0] // b
        key = str(x.device)
        if key not in schedules:
            schedules[key] = schedule.to(x.device)
        target = labels.to(x.device)
        with torch.enable_grad():
            x_b = x[:b].detach().to(torch.float32).requires_grad_(True)
            logits = classifier_fn(x_b, t[:b])
            logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            picked = logp.gather(1, target[:, None]).sum()
            grad, = torch.autograd.grad(picked, x_b)
        if reps > 1:
            grad = grad.repeat(reps, *([1] * (grad.ndim - 1)))
        s = extract(schedules[key].sqrt_one_minus_alphas_cumprod, t, x.ndim)
        return eps - scale * s * grad

    return fn
