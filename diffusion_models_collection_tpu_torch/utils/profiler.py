"""Profiling hooks: a trace of a block, device time from a trace, and a
per-step wall-time collector.

Counterpart of `diffusion_models_collection_tpu/utils/profiler.py`.
`profile_trace` records a `torch.profiler` trace (host and CUDA activity)
in place of the JAX package's `jax.profiler` one; `device_time` reads a
profile's CUDA kernels into busy time and time by kind (the
`tools/profile_torch_*.py` scripts). `StepTimer` times host wall time per
step: on a CUDA device a step returns when its work is queued, so the
device catches up at the epoch's one loss read, which the epoch time
includes.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """Trace the enclosed block with `torch.profiler` into
    `<logdir>/trace.json` (Chrome trace format) when `logdir` is set
    (config key `profile_dir`); no-op otherwise."""
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def device_time(prof, kinds: Sequence[Tuple[str, Sequence[str]]],
                rest: str) -> Tuple[float, Dict[str, float]]:
    """From a finished `torch.profiler.profile`: the milliseconds in which
    some CUDA kernel ran (the union of their intervals), and kernel time by
    kind, a kernel taking the first kind one of whose keys its lower-cased
    name contains, else `rest`. Raises if the profile holds no kernel."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    busy_ms = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels]) / 1e3
    by_kind: Dict[str, float] = {}
    for e in kernels:
        name = e.name.lower()
        kind = next((k for k, keys in kinds if any(key in name for key in keys)),
                    rest)
        by_kind[kind] = by_kind.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3
    return busy_ms, dict(sorted(by_kind.items(), key=lambda kv: -kv[1]))


class StepTimer:
    """Per-step wall-time collector with a percentile summary."""

    def __init__(self):
        self._times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self._times.append(time.perf_counter() - self._t0)
            self._t0 = None

    @contextlib.contextmanager
    def step(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "steps": int(arr.size),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "p99_s": float(np.percentile(arr, 99)),
            "total_s": float(arr.sum()),
        }

    def reset(self):
        self._times.clear()
        self._t0 = None
