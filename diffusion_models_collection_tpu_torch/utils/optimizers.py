"""Adafactor and Lion as the JAX package builds them with Optax 0.2.6.

`build_optimizer` (`utils/trainer.py`) puts either behind the global-norm
clip and the accumulation of `Optimizer`, as it does AdamW, and sets each
group's `lr` from the schedule before every update. The formulas are
Optax's, not `torch.optim.Adafactor`'s (which scales and clips otherwise):

* `optax.adafactor(lr, weight_decay_rate=wd or None,
  multiply_by_parameter_scale=False)`: at update k (from 0) the decay is
  1 - (k + 1)^-0.8; g^2 + 1e-30 feeds the second moment, factored into
  row and column means over the two largest axes when the second largest
  has at least 128 entries, a full-size moment otherwise; the update
  g / sqrt(v_hat) is clipped to an RMS of at most 1 per tensor, times lr,
  plus wd * p when wd is set (not times lr), subtracted from p.
* `optax.lion(lr, weight_decay=wd)`: p -= lr (sign((1 - b1) g + b1 m) +
  wd p), then m = b2 m + (1 - b2) g, with b1 0.9 and b2 0.99.

Axes: a torch weight's two largest axes are the same logical pair as its
Flax layout's (a conv's (out, in, kh, kw) against (kh, kw, in, out), a
linear's (out, in) against (in, out)); which of the pair is the row is
picked by `np.argsort` over the torch shape, as Optax does over Flax's, and
the factored estimate v_row[i] v_col[j] / mean(v_row) is symmetric in the
pair, since both means start at 0 and track the same total.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel.fsdp import full_tensor, local, local_piece


# Optax's adafactor defaults, the JAX package's choice
DECAY_RATE, EPS, CLIPPING_THRESHOLD, MIN_DIM_SIZE_TO_FACTOR = (0.8, 1e-30,
                                                                1.0, 128)
LION_BETAS = (0.9, 0.99)


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """(d1, d0), the second largest and the largest axis, or None when the
    tensor has fewer than two axes or the second largest is too small."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """Optax's adafactor chain without the parameter-scale multiply. A
    parameter sharded by FSDP (a DTensor) is updated from its whole
    gradient, gathered: the factored means and the RMS clip span the whole
    tensor, as the JAX package's do under GSPMD. Its moments are then kept
    whole on every rank (`full_state`: they are a row and a column, or a
    small tensor's), and the update's local piece applied."""

    full_state = True

    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = full_tensor(p.grad)  # an FSDP shard's whole
                state = self.state[p]
                dims = factored_dims(p.shape)
                if not state:
                    state["step"] = 0
                    if dims is None:
                        state["v"] = torch.zeros_like(g)
                    else:
                        d1, d0 = dims
                        state["v_row"] = g.new_zeros(g.mean(d0).shape)
                        state["v_col"] = g.new_zeros(g.mean(d1).shape)
                decay = 1.0 - (state["step"] + 1.0) ** -DECAY_RATE
                g_sq = g * g + EPS
                if dims is None:
                    v = state["v"].mul_(decay).add_(g_sq, alpha=1.0 - decay)
                    u = g * v.rsqrt()
                else:
                    d1, d0 = dims
                    v_row = state["v_row"].mul_(decay).add_(
                        g_sq.mean(d0), alpha=1.0 - decay)
                    v_col = state["v_col"].mul_(decay).add_(
                        g_sq.mean(d1), alpha=1.0 - decay)
                    # v_row lacks axis d0: d1 moves down one when d1 > d0
                    row_mean = v_row.mean(d1 - 1 if d1 > d0 else d1,
                                          keepdim=True)
                    u = (g * (v_row / row_mean).rsqrt().unsqueeze(d0)
                         * v_col.rsqrt().unsqueeze(d1))
                rms = torch.sqrt(torch.mean(u * u))
                u = u / torch.clamp(rms / CLIPPING_THRESHOLD, min=1.0)
                u = u * group["lr"]
                u = local_piece(u, p)
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * local(p)
                local(p).sub_(u)
                state["step"] += 1


class Lion(torch.optim.Optimizer):
    """Optax's lion: sign updates from an interpolated momentum."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        b1, b2 = LION_BETAS
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p)
                m = state["exp_avg"]
                u = torch.sign((1.0 - b1) * g + b1 * m)
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                p.sub_(group["lr"] * u)
                m.mul_(b2).add_(g, alpha=1.0 - b2)
