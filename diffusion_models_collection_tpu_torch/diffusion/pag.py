"""Perturbed Attention Guidance (Ahn et al. 2024).

Counterpart of `diffusion_models_collection_tpu/diffusion/pag.py`. The same
checkpoint runs twice a step, once as it is and once with every
self-attention map the identity (`pag_perturb` of the UNet and the DiT: an
attention block's output is its v), and the prediction is pushed away from
the degraded one:

    eps'(x_t, t) = eps(x_t, t) + s (eps(x_t, t) - eps_perturbed(x_t, t)).

It needs no labels and stacks with classifier-free guidance: the wrapper
sits where the samplers call the model, so on the fused [cond; uncond]
batch both branches are rectified before the guidance combines them.
Defined on the eps parameterization of the VP processes (`sample` rejects
the others).
"""

from __future__ import annotations

from typing import Callable


def pag_model_fn(model_fn: Callable, perturbed_fn: Callable,
                 scale: float) -> Callable:
    """The PAG-rectified `(x, t, y) -> eps` of two callables on the same
    weights: `perturbed_fn` is the model with `pag_perturb=True`."""
    s = float(scale)

    def fn(x, t, y=None):
        eps = model_fn(x, t, y)
        eps_p = perturbed_fn(x, t, y)
        return eps + s * (eps - eps_p)

    return fn
