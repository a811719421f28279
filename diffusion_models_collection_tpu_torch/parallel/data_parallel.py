"""Data parallelism outside training: a sampling run's model calls and the
metric networks' batches split over the ranks of a world.

Counterpart of `diffusion_models_collection_tpu/factory.py`
`dp_sampling_sharding` and `sharded_init_noise` and of its
`parallel/mesh.py` `dp_batch_sharding`. The JAX package places each
sampling or metric batch over a 'data' mesh of one process's devices and
lets the jitted program run SPMD, with the trajectories of one device. Here
each rank is a process with one device (`mesh.join_world`), and the split
is of the model call, not of the trajectory: every rank holds the sampler's
state over the whole batch and draws every noise of it from a generator
seeded alike, runs the model on its contiguous rows of each call, and the
outputs are gathered in rank order. Every sampler (its initial noise and
per-step noise drawn over the whole batch) then takes the one-process
trajectory, but for the float rounding of the model on fewer rows (cuDNN,
cuBLAS and oneDNN pick kernels by the batch): a world of N ranks gives bit
for bit what one process gives when it runs each call on the same row
blocks in turn.

* `DataParallelApply(fn, layout)` is `fn(x, t, y=None, *rest, **kw)` so
  split: x, t, y and every keyword tensor with the call's batch axis are
  cut to this rank's rows; `rest` (the DeepCache features of this rank's
  rows, from its last 'full' call) and anything else (`pag_perturb`,
  `deepcache_mode`) pass as they are; of a tuple output (DeepCache's
  'full' `(eps, cache)`) the first is gathered and the rest stays this
  rank's.
* `gather_rows(fn, layout, *batches)` is the same split of a metric
  network's batch (InceptionV3's features and logits, LPIPS's distances).
* A call whose rows do not divide by the world runs whole on every rank,
  the JAX rule (`dp_batch_sharding` is None when `batch % ndev`).

Both run without gradients. The gather is one `all_gather` of the output
(NCCL on the device; gloo carries CUDA tensors through the host itself).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .mesh import Layout


def splits(rows: int, layout: Layout) -> bool:
    """Whether a call of `rows` rows splits over the layout's data ranks."""
    return layout.dp > 1 and rows % layout.dp == 0


def gather(out: torch.Tensor, layout: Layout) -> torch.Tensor:
    """Every data rank's rows of `out`, concatenated in rank order."""
    parts = [torch.empty_like(out) for _ in range(layout.dp)]
    dist.all_gather(parts, out.contiguous(), group=layout.dp_group)
    return torch.cat(parts)


def _cutter(rows: int, layout: Layout) -> Callable:
    def cut(a):
        if torch.is_tensor(a) and a.dim() > 0 and a.shape[0] == rows:
            return layout.rows(a)
        return a
    return cut


def gather_rows(fn: Callable, layout: Layout, *batches):
    """`fn(*batches)` over the whole batch, each rank on its rows: a tensor
    or a tuple of tensors, every one with the batch axis first."""
    rows = batches[0].shape[0]
    if not splits(rows, layout):
        return fn(*batches)
    cut = _cutter(rows, layout)
    with torch.no_grad():
        out = fn(*(cut(b) for b in batches))
        if isinstance(out, tuple):
            return tuple(gather(o, layout) for o in out)
        return gather(out, layout)


class DataParallelApply:
    """`fn` (a model) with each call's rows split over the layout's data
    ranks and the output gathered (see the module docstring)."""

    def __init__(self, fn: Callable, layout: Layout):
        self.fn, self.layout = fn, layout

    def __call__(self, x, t, y=None, *rest, **kw):
        rows = x.shape[0]
        if not splits(rows, self.layout):
            return self.fn(x, t, y, *rest, **kw)
        cut = _cutter(rows, self.layout)
        with torch.no_grad():
            out = self.fn(cut(x), cut(t), cut(y), *rest,
                          **{k: cut(v) for k, v in kw.items()})
            if isinstance(out, tuple):
                return (gather(out[0], self.layout),) + tuple(out[1:])
            return gather(out, self.layout)
