"""Checkpoint loading and saving.

Counterpart of `diffusion_models_collection_tpu/utils/checkpoint.py`. Two
formats load:

* a PyTorch reference checkpoint (`.pth`/`.pt`, `torch.save` of
  {epoch, model_state_dict, optimizer_state_dict, best_loss, config,
  [ema_model_state_dict], [global_step]}), read with
  `torch.load(weights_only=True)`;
* a JAX checkpoint (any other suffix), a pickle of the same keys with Flax
  param trees of numpy arrays. It is read by a restricted unpickler:
  containers and numpy arrays are rebuilt, Optax/Flax/JAX value classes
  (optimizer-state namedtuples, FrozenDict) become inert placeholders, so
  nothing imports jax; any other global is refused. The param trees then go
  through the weight bridge (`utils/weights.py`).

Either way `load_checkpoint` returns state dicts in the port's key names.
`save_checkpoint` writes the reference `torch.save` schema, which the JAX
package's loader also reads.
"""

from __future__ import annotations

import collections
import functools
import importlib
import pickle
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Union

import torch

from .weights import state_dict_from_jax

_SAFE_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "complex",
                  "slice", "bytearray", "range"}
_SAFE_NUMPY = {"_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer"}
_NUMPY_MODULES = {"numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.dtypes", "numpy.core.numeric", "numpy._core.numeric"}
_STATE_ROOTS = ("optax", "flax", "jax")


class InertTuple(tuple):
    """Stands in for an Optax/Flax/JAX namedtuple (optimizer state): keeps
    the fields as a plain tuple, runs no code of the original class."""

    def __new__(cls, *fields, **_):
        return super().__new__(cls, fields)


class InertDict(dict):
    """Stands in for Flax's FrozenDict."""


@functools.lru_cache(maxsize=None)
def _placeholder(module: str, name: str) -> type:
    base = InertDict if name == "FrozenDict" else InertTuple
    return type(name, (base,), {"__module__": f"inert.{module}"})


class _JaxCheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):  # noqa: D102
        if module == "builtins" and name in _SAFE_BUILTINS:
            return getattr(__import__("builtins"), name)
        if module == "collections" and name in ("OrderedDict", "defaultdict"):
            return getattr(collections, name)
        if module in _NUMPY_MODULES and (name in _SAFE_NUMPY
                                         or name.endswith("DType")):
            return getattr(importlib.import_module(module), name)
        if module.split(".")[0] in _STATE_ROOTS:
            return _placeholder(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint references disallowed global {module}.{name}")


def load_checkpoint(path: Union[str, Path],
                    config: Optional[dict] = None) -> Dict[str, Any]:
    """Load a reference `.pth`/`.pt` or a JAX pickle checkpoint. State dicts
    come back in the port's key names; a JAX checkpoint's params are bridged
    with `config`, or with the config embedded in the checkpoint."""
    path = Path(path)
    if path.suffix.lower() in (".pth", ".pt"):
        return torch.load(path, map_location="cpu", weights_only=True)
    with path.open("rb") as f:
        payload = _JaxCheckpointUnpickler(f).load()
    config = config if config is not None else payload.get("config")
    if config is None:
        raise ValueError(f"{path} embeds no config; pass one")
    for key in ("model_state_dict", "ema_model_state_dict"):
        if payload.get(key) is not None:
            payload[key] = state_dict_from_jax(payload[key], config)
    return payload


def save_checkpoint(path: Union[str, Path], model_state_dict: Mapping,
                    config: dict, ema_model_state_dict: Optional[Mapping] = None,
                    epoch: int = 0, best_loss: float = float("inf"),
                    optimizer_state_dict: Optional[Mapping] = None,
                    global_step: Optional[int] = None) -> None:
    """Write the reference trainer's `torch.save` schema {epoch,
    model_state_dict, best_loss, config, [optimizer_state_dict],
    [ema_model_state_dict], [global_step]}, all of it loadable with
    `weights_only=True`. The file is written beside `path` and renamed over
    it, so a crash never leaves a torn checkpoint."""
    def plain(sd):
        return {k: v.detach().cpu().contiguous() for k, v in sd.items()}

    payload = {"epoch": int(epoch), "model_state_dict": plain(model_state_dict),
               "best_loss": float(best_loss), "config": config}
    if optimizer_state_dict is not None:
        payload["optimizer_state_dict"] = optimizer_state_dict
    if ema_model_state_dict is not None:
        payload["ema_model_state_dict"] = plain(ema_model_state_dict)
    if global_step is not None:
        payload["global_step"] = int(global_step)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, tmp)
    tmp.replace(path)
