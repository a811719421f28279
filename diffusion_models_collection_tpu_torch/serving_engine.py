"""Continuous-batching serving engine.

Counterpart of `diffusion_models_collection_tpu/serving_engine.py`. A fixed
pool of B slots, each with its OWN position on the sampler's grid: one model
call a step on the whole pool ([cond; uncond], 2 B rows under CFG), in which
every active, unfinished slot takes one deterministic DDIM (eta = 0) step at
its own timestep. A request is admitted into free slots at the next tick and
its slots are freed the tick it finishes, so under load the card never idles
between requests.

Device state, on the model's device:
    x      [B, H, W, C] float32  each slot's image (float32 under bf16 too)
    pos    [B] int64             grid index (0..S); S means done or idle
    y      [B] int64             label (+1 shifted; 0 = unconditional null)
    cfg    [B] float32           per-slot CFG scale
    active [B] bool              slot occupied

Each step is `ddim_step` with the guided, constrained (eps, x0) of
`DDIM.sample_with_cfg` (or `sample`) at per-slot t and t_next, so a slot's
trajectory is that sampler's on the same noise, row for row: the model works
per image (GroupNorm, attention, adaLN and the time embedding per row).

The host never waits for the card within a tick: the grid position is
gathered on the card, completion is read from a host-side shadow of `pos`
that advances as the card's does, and admissions travel through pinned
memory without a sync. The only transfer to the host is a finished
request's images. Where the JAX engine pads each admission to B rows and
reads back the whole pool (each distinct size compiled a new XLA program),
this one writes k rows and gathers only the finished slots: PyTorch compiles
nothing per size, and the results are the same.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .diffusion import base
from .diffusion.ddim import DDIM, ddim_step
from .diffusion.schedule import NoiseSchedule


def device_context(device: torch.device):
    """The CUDA device made current in this thread for `device` (the kernels
    launch on the thread's current device), else nothing."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def tick(schedule: NoiseSchedule, x: torch.Tensor, pos: torch.Tensor,
         active: torch.Tensor, grid: torch.Tensor, eps_x0: Callable,
         steps: int = 1):
    """Advance every active, unfinished slot by `steps` DDIM eta = 0 steps,
    each one model call on the pool through `eps_x0` (the sampler's guided,
    constrained (eps, x0) view of the pool); a slot that finishes mid-tick
    stops. Returns the new (x, pos). No value is read back to the host."""
    n_steps = grid.shape[0]
    bshape = (-1, *((1,) * (x.ndim - 1)))
    terminal = torch.full_like(grid[:1], -1)
    for _ in range(steps):
        idx = pos.clamp(0, n_steps - 1)
        t = grid[idx]
        # the last transition goes to t_next = -1 (alpha_bar = 1), as in the
        # grid samplers
        t_next = torch.where(idx + 1 < n_steps,
                             grid[(idx + 1).clamp(max=n_steps - 1)], terminal)
        eps, x0 = eps_x0(x, t)
        x_new = ddim_step(schedule, x, t, t_next, eps, x0, 0.0, None)
        running = active & (pos < n_steps)
        x = torch.where(running.reshape(bshape), x_new, x)
        pos = torch.where(running, pos + 1, pos)
    return x, pos


def admit(x, pos, y, cfg, active, slots, noise, labels, scales):
    """Write fresh requests into slots `slots` (in place): their noise,
    labels, CFG scales, position 0 and active."""
    x[slots] = noise
    pos[slots] = 0
    y[slots] = labels
    cfg[slots] = scales
    active[slots] = True


@dataclass
class _Request:
    noise: torch.Tensor         # (k, H, W, C) float32
    labels: torch.Tensor        # (k,) int64, already +1 shifted
    cfg_scale: float
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    slots: Optional[np.ndarray] = None
    error: Optional[Exception] = None
    cancelled: bool = False     # submit() timed out; drop on admission


class ContinuousBatchingEngine:
    """Slot-based stepwise DDIM engine; thread-safe `submit`.

    Steps `model_fn` (an eval-mode model on `device`) as `ddim` would: its
    schedule, grid (Karras spacing too), guidance rescale, CFG interval and
    x0 clamp, and under CFG the dynamic threshold of `sample_with_cfg`. The
    engine thread ticks only while slots are active, so an idle server
    launches nothing.
    """

    def __init__(
        self,
        ddim: DDIM,
        model_fn: Callable,
        *,
        image_shape,             # (H, W, C)
        num_slots: int = 16,
        conditional: bool = False,
        steps_per_tick: int = 1,
        device="cpu",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.schedule = ddim.schedule_on(self.device)
        self.num_slots = int(num_slots)
        self.conditional = bool(conditional)
        self.grid = torch.as_tensor(ddim.inference_timesteps,
                                    dtype=torch.int64).to(self.device)
        self.num_steps = int(self.grid.shape[0])
        # k > 1 launches k steps a tick at the cost of admission and
        # completion granularity of k steps
        self.steps_per_tick = int(steps_per_tick)
        if not 1 <= self.steps_per_tick <= self.num_steps:
            raise ValueError(
                f"steps_per_tick must be in [1, {self.num_steps}], got "
                f"{steps_per_tick}")
        h, w, c = image_shape
        self.image_shape = (h, w, c)
        b, dev = self.num_slots, self.device
        self._x = torch.zeros((b, h, w, c), dtype=torch.float32, device=dev)
        # idle slots park at pos = S (finished)
        self._pos = torch.full((b,), self.num_steps, dtype=torch.int64,
                               device=dev)
        # The host's copy of pos: a tick moves each running slot by the
        # steps it ran, clamped at S, on both sides, so completion is read
        # here and the card's pos is never read back
        self._shadow_pos = np.full((b,), self.num_steps, np.int64)
        self._y = torch.zeros((b,), dtype=torch.int64, device=dev)
        self._cfg = torch.ones((b,), dtype=torch.float32, device=dev)
        self._active = torch.zeros((b,), dtype=torch.bool, device=dev)
        # the pool's labels and scales, which `admit` rewrites in place
        self._eps_x0 = ddim.eps_x0_fn(
            model_fn, dev, self._y, self._cfg.view(-1, 1, 1, 1),
            use_cfg=self.conditional,
            p_threshold=base.resolve_p_threshold(base.AUTO_THRESHOLD,
                                                 ddim.clip_sample))

        self._free = list(range(b))
        self._pending: list[_Request] = []
        self._inflight: dict[int, _Request] = {}  # slot -> request
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = False
        self._error: Optional[Exception] = None  # engine-fatal failure
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0          # denoising steps run (model calls)

    # ------------------------------------------------------------- public
    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop = True
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def submit(self, noise, labels=None, cfg_scale: float = 1.0,
               timeout: float = 300.0) -> np.ndarray:
        """Block until the request's images are ready; returns (k, H, W, C)
        float32 model-space images (as `DDIM.sample`). `noise` is the
        request's initial noise (k, H, W, C), a tensor or an array; `labels`
        are +1-shifted ints or None (unconditional)."""
        noise = torch.as_tensor(noise, dtype=torch.float32)
        k = int(noise.shape[0])
        if k < 1 or k > self.num_slots:
            raise ValueError(f"request size must be in [1, {self.num_slots}]")
        if tuple(noise.shape[1:]) != self.image_shape:
            raise ValueError(f"noise must be (k, *{self.image_shape}), got "
                             f"{tuple(noise.shape)}")
        labels = torch.as_tensor(
            np.zeros((k,), np.int64) if labels is None else labels,
            dtype=torch.int64)
        if tuple(labels.shape) != (k,):
            raise ValueError(f"labels must be ({k},), got "
                             f"{tuple(labels.shape)}")
        req = _Request(noise=noise, labels=labels, cfg_scale=float(cfg_scale))
        with self._lock:
            if self._error is not None:
                raise RuntimeError(
                    f"serving engine is dead: {self._error!r}"
                ) from self._error
            self._pending.append(req)
        self._work.set()
        if not req.event.wait(timeout):
            # drop the abandoned request so it cannot take slots later; if
            # it was already admitted, its slots finish and recycle
            with self._lock:
                req.cancelled = True
                if req in self._pending:
                    self._pending.remove(req)
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        return req.result

    # -------------------------------------------------------------- loop
    def _try_admit_locked(self):
        """Assign free slots to pending requests (FIFO, all or nothing per
        request, so one large request is not starved by small ones)."""
        admitted = []
        while self._pending and len(self._free) >= len(
                self._pending[0].labels):
            req = self._pending.pop(0)
            if req.cancelled:  # submit() timed out while queued
                continue
            k = len(req.labels)
            req.slots = np.asarray([self._free.pop() for _ in range(k)],
                                   np.int64)
            for s in req.slots:
                self._inflight[int(s)] = req
            admitted.append(req)
        return admitted

    def _loop(self):
        try:
            with device_context(self.device), torch.no_grad():
                self._loop_body()
        except Exception as e:  # engine-fatal: fail every request loudly
            with self._lock:
                self._error = e
                doomed = list(self._inflight.values()) + self._pending
                self._inflight.clear()
                self._pending.clear()
            for req in {id(r): r for r in doomed}.values():
                req.error = RuntimeError(f"serving engine died: {e!r}")
                req.event.set()

    def _to_device(self, tensor: torch.Tensor) -> torch.Tensor:
        """`tensor` on the engine's device; from the host through pinned
        memory, so the copy is queued behind the ticks without waiting for
        them."""
        if self.device.type != "cuda" or tensor.device.type != "cpu":
            return tensor.to(self.device)
        return tensor.pin_memory().to(self.device, non_blocking=True)

    def _admit(self, req: _Request):
        """Write an admitted request into its slots: its k rows only, where
        the JAX engine pads to the pool (one XLA program for every size)."""
        admit(self._x, self._pos, self._y, self._cfg, self._active,
              self._to_device(torch.from_numpy(req.slots)),
              self._to_device(req.noise), self._to_device(req.labels),
              torch.full((len(req.slots),), req.cfg_scale,
                         dtype=torch.float32, device=self.device))
        self._shadow_pos[req.slots] = 0

    def _gather(self, slots: np.ndarray) -> torch.Tensor:
        """The images of `slots` on the host, where the JAX engine reads
        back the whole pool; this waits for the ticks queued before it."""
        return self._x[self._to_device(torch.from_numpy(slots))].cpu()

    def _loop_body(self):
        while not self._stop:
            with self._lock:
                admitted = self._try_admit_locked()
                running = np.zeros((self.num_slots,), bool)
                running[list(self._inflight)] = True
            for req in admitted:
                self._admit(req)
            if not running.any():
                self._work.wait(timeout=0.1)
                self._work.clear()
                continue

            # up to k steps, no more than the furthest running slot needs
            # (the steps after it would move no slot)
            steps = min(self.steps_per_tick, int(
                (self.num_steps - self._shadow_pos[running]).max()))
            self._x, self._pos = tick(self.schedule, self._x, self._pos,
                                      self._active, self.grid, self._eps_x0,
                                      steps=steps)
            self.ticks += steps
            self._shadow_pos[running] = np.minimum(
                self._shadow_pos[running] + steps, self.num_steps)
            done = np.nonzero(running
                              & (self._shadow_pos >= self.num_steps))[0]
            if not done.size:
                continue
            with self._lock:
                finished = {}
                for s in done:
                    req = self._inflight.pop(int(s))
                    finished[id(req)] = req
            # a request's slots share one grid, so they finish on one tick
            images = self._gather(done)
            rows = {int(s): i for i, s in enumerate(done)}
            with self._lock:
                # a retired slot keeps its pos = S and stays inert in tick
                # until an admission rewrites it
                self._free.extend(int(s) for s in done)
            for req in finished.values():
                req.result = images[[rows[int(s)] for s in req.slots]].numpy()
                req.event.set()
