"""FSDP / ZeRO-3: parameters, optimizer moments and the EMA stored sharded
over the 'data' axis.

Counterpart of `diffusion_models_collection_tpu/parallel/fsdp.py`. The JAX
package gives every leaf a sharding and XLA derives the all-gathers and
reduce-scatters; here FSDP2 (`torch.distributed.fsdp.fully_shard`) does it,
wrapped per block of a DiT/DiM (each block's parameters gathered just before
it runs and freed after) and on the root. Its parameters become DTensors
sharded on one axis; in forward and backward the modules see the gathered
plain tensors, which the kernels take as they are. The optimizer and the EMA
run on the shards (elementwise, or through DTensor's reductions: Adafactor's
factored means span the whole tensor).

JAX's rule for which axis, kept (`fsdp_dim`): the largest axis that the
number of shards divides, ties toward the first axis of the torch layout
(the last of Flax's, the JAX tie-break); a leaf under `min_size` elements
(`fsdp_min_size`, 2^15 by default) or with no such axis stays replicated,
its gradient averaged over 'data' by the optimizer (`utils/trainer.py`
`Optimizer`). Checkpoints gather to the full state dict, so FSDP and
single-device runs interchange files (`parallel/plan.py`). With
`tensor_parallel` (hybrid ZeRO x Megatron) FSDP shards each rank's
tensor-parallel slices over 'data' the same way.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn

DEFAULT_MIN_SIZE = 2 ** 15


def fsdp_dim(shape, n_shards: int,
             min_size: int = DEFAULT_MIN_SIZE) -> Optional[int]:
    """The axis of a leaf of `shape` sharded over `n_shards` ranks, or None
    to keep it replicated (under `min_size` elements, or no axis divisible
    by `n_shards`)."""
    shape = tuple(shape)
    numel = 1
    for extent in shape:
        numel *= extent
    if n_shards <= 1 or not shape or numel < min_size:
        return None
    best = None
    for dim, extent in enumerate(shape):
        if extent % n_shards == 0 and extent >= n_shards:
            if best is None or extent > shape[best]:
                best = dim
    return best


def shard_model(model: nn.Module, mesh,
                min_size: int = DEFAULT_MIN_SIZE) -> List[nn.Parameter]:
    """`fully_shard` each block of `model` (its `blocks`, when it has them)
    and the root over the 1-D `mesh`, each parameter on its `fsdp_dim`.
    Returns the parameters left replicated."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    n = mesh.size()
    replicated = [p for p in model.parameters()
                  if fsdp_dim(p.shape, n, min_size) is None]
    with torch.no_grad():  # FSDP2 shards contiguous parameters only (a
        for p in model.parameters():  # channels-last conv weight is not)
            if fsdp_dim(p.shape, n, min_size) is not None:
                p.data = p.data.contiguous()

    def placement(param):
        return Shard(fsdp_dim(param.shape, n, min_size))

    kwargs = dict(mesh=mesh, shard_placement_fn=placement,
                  ignored_params=set(replicated))
    for block in getattr(model, "blocks", ()):
        fully_shard(block, **kwargs)
    fully_shard(model, **kwargs)
    return replicated


def is_sharded(tensor) -> bool:
    """Whether `tensor` is a DTensor with a sharded placement."""
    placements = getattr(tensor, "placements", ())
    return any(p.is_shard() for p in placements)


def sharded_fraction(module: nn.Module) -> float:
    """The fraction of `module`'s parameter elements stored sharded over
    'data' (diagnostics, as the JAX `sharded_fraction`)."""
    total = sharded = 0
    for p in module.parameters():
        total += p.numel()
        sharded += p.numel() if is_sharded(p) else 0
    return sharded / total if total else 0.0


def local(tensor: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (a view of its storage), any other
    tensor as it is."""
    return tensor.to_local() if hasattr(tensor, "to_local") else tensor


def full_tensor(tensor: torch.Tensor) -> torch.Tensor:
    """The whole of a DTensor that FSDP shards (`fsdp_dim`: equal shards),
    its shards gathered by `dist.all_gather`, which gloo also takes on CUDA
    tensors (DTensor's own `full_tensor` goes through the functional
    collectives, which crash there); any other tensor as it is. A
    collective: every rank of the mesh calls it."""
    if not hasattr(tensor, "placements"):
        return tensor
    whole = tensor.to_local()
    mesh = tensor.device_mesh
    for axis, place in enumerate(tensor.placements):
        if place.is_shard():
            n = mesh.size(axis)
            if tensor.shape[place.dim] % n:
                raise ValueError(f"axis {place.dim} of {tuple(tensor.shape)}"
                                 f" does not shard evenly over {n} ranks")
            parts = [torch.empty_like(whole) for _ in range(n)]
            dist.all_gather(parts, whole.contiguous(),
                            group=mesh.get_group(axis))
            whole = torch.cat(parts, place.dim)
    return whole


def local_piece(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's piece of `full` as `like` (a DTensor) holds it: the
    chunk of each sharded axis; `full` itself for a plain `like`."""
    for axis, place in enumerate(getattr(like, "placements", ())):
        if place.is_shard():
            mesh = like.device_mesh
            full = full.chunk(mesh.size(axis), place.dim)[
                mesh.get_local_rank(axis)]
    return full
