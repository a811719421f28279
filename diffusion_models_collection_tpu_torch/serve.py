"""Serving daemon of the PyTorch port.

    python -m diffusion_models_collection_tpu_torch.serve \\
        --checkpoint best_model.pth --port 8000 \\
        --sampling_method ddim --num_inference_steps 50 --use_ema

    GET  /healthz            -> {"status": "ok", ...}
    POST /generate           JSON {"num_samples": 4, "labels": [0,1,2,3],
                                   "seed": 7, "cfg_scale": 1.8,
                                   "format": "png"|"npy"}
      -> image/png grid (or application/octet-stream .npy of
         (N, H, W, C) float32 in [0, 1])

Counterpart of the repository's `serve.py`, with its flags and HTTP
interface. Batched mode (the default): every request pads to the fixed
`--batch_size` and runs the whole trajectory of `--sampling_method` (ddpm,
ddim, dpm++, dpm++sde, unipc; flow-matching, EDM and consistency checkpoints
with their own solver) under one lock, its images copied to the host inside the lock,
so two trajectories never share the card. Its initial noise (and DDPM's and
the SDE's per-step noise) comes from a `torch.Generator` on the device
seeded with the request's `seed`, so a seed gives the same images on every
call. `--continuous`: the continuous-batching DDIM engine
(`serving_engine.py`) over `--batch_size` slots, which requests join
between steps. `/healthz` and refusals stay responsive on their own
threads; generates beyond `--max_queue` get 503, malformed requests 400,
other failures 500.

A latent-diffusion checkpoint samples the latents of the VAE its config
names (the sampler and the engine work at the latent geometry; `/healthz`
reports pixels) and decodes each result before it is answered: in the
batched mode inside the lock, in `--continuous` on the request's own thread
after the engine returns it, with the model's device made current there.

`--device` defaults to `cuda` and fails when CUDA is absent; the CPU runs
only when asked for with `--device cpu`. `--mixed_precision bf16` overrides
the checkpoint config's compute dtype (the engine's images stay float32).
`--tome_ratio` (with `--tome_mlp`) and `--quantize int8` serve a DiT
through token merging and the int8 products, and compose with each other
and with bf16. `--continuous` steps DDIM only: it refuses flow-matching, EDM
and consistency checkpoints with the root daemon's `ValueError`.

Under torchrun (`torchrun --nproc_per_node N -m
diffusion_models_collection_tpu_torch.serve ...`) the batched daemon splits
each trajectory's model calls over the ranks, as the JAX root `serve.py`
spreads each batch over the host's devices (`dp_sampling_sharding`). Every
rank joins the world (`mesh.join_world`: `cuda:LOCAL_RANK`, NCCL on the
card, gloo on the CPU), loads the checkpoint and builds the same service,
its model wrapped by `pipeline.split_model_calls`. Rank 0 alone binds
`--host`/`--port` and answers HTTP; it checks each request first (a 400
never leaves it), then, inside the service lock and so in the order its
trajectories run, hands the request on to every rank (`ServingWorld`: the
labels, seed and CFG scale, written to the default group's store). Every
rank then runs the whole padded trajectory from the same seeded draws, each
model call on its rows in rank order, all-gathered (`DataParallelApply`: a
call whose rows do not divide by N runs whole on every rank); a latent
checkpoint's decode of the request's rows is split the same way
(`gather_rows`). Rank 0 answers; the others drop their copy. The images
are what one process gives when it runs each call on the ranks' row blocks
in turn: the JAX rule looks at `batch_size % ndev` once, the port at each
call's rows, which gives the same images up to float rounding (a call on
fewer rows may take other cuDNN, cuBLAS or oneDNN kernels). The warm-up is
rank 0's first request, so every rank runs it.

The other ranks wait for the next request on the store in a loop of waits
of `CONTROL_TIMEOUT` seconds, never in a collective: a server idles for
hours, and a collective of the default group ends the process when its
timeout expires (NCCL's watchdog after 10 minutes). Model tensors go over
the default group. When rank 0's server stops (KeyboardInterrupt, SIGTERM,
`server.shutdown()`), it hands on a stop after the last trajectory and
every rank returns from `main` (`__main__` then leaves the world) and
exits 0; the other ranks ignore SIGINT and SIGTERM and leave when rank 0
says. A rank whose trajectory fails writes the failure to the store and
raises; rank 0 answers that request with a 500 and every rank ends with a
non-zero exit, rank 0 when its server has stopped, the others as soon as
they read the failure. Each trajectory runs on a thread of its own, which
the rank waits for while a thread watching the store finds no failure:
under NCCL a rank held by a dead peer sits in a collective, or in a kernel
launch once the collectives have filled the card's queue, until the
group's timeout. `python -m` (`cli`) then ends the process at once (exit
code 1) rather than wait for that thread. A rank killed outright leaves no failure
in the store: gloo's collectives then raise at once, NCCL's at its
watchdog's timeout.
`--continuous` runs in one process, as the JAX engine runs on one device:
under a world of several processes it raises `ValueError`. In one process
too, SIGTERM stops the daemon as Ctrl-C does.
Super-resolution checkpoints are refused, as the root daemon refuses them:
each request would need an LR image (`sample --sr_source` and
`tools/cascade.py` run them).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import signal
import sys
import threading
import time
import traceback
from datetime import timedelta
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .diffusion import DDIM
from .factory import get_diffusion, load_model_for_inference
from .parallel.data_parallel import gather_rows
from .parallel.mesh import (Layout, distributed_env, join_world,
                            leave_world, main_process_output, world_store)
from .pipeline import split_model_calls
from .serving_engine import ContinuousBatchingEngine, device_context
from .utils.checkpoint import load_checkpoint
from .utils.helpers import (encode_png, make_grid, resolve_device,
                            resolve_image_size)
from .utils.latent import LatentCodec


# seconds a rank other than 0 waits on the store for the next request
# before it looks for a failure and waits again
CONTROL_TIMEOUT = 60.0
WATCH_SECONDS = 0.1  # how often each rank looks for another rank's failure
DRAIN_SECONDS = 10.0  # rank 0's wait for the answers in flight at its end


class ServingWorld:
    """The batched daemon's ranks under torchrun: rank 0 hands each checked
    request on to the others, in the order of its trajectories, as keys of
    the default group's store (`mesh.world_store`), and every rank can
    mark the world failed. Keys live under `dmc_serve/<start>/`, `<start>`
    counting the daemons this rank has started, so a process that serves
    again in the same world reads no old key; the last rank to read a
    request deletes it."""

    def __init__(self, layout: Layout):
        self.layout = layout
        self.rank, self.size = layout.dp_rank, layout.dp
        self.store = world_store()
        start = self.store.add(f"dmc_serve/starts/{self.rank}", 1)
        self.prefix = f"dmc_serve/{start}/"
        self.seq = 0
        self.failure = None  # the first failure this rank has seen
        self.stopping = False
        self._closed = threading.Event()
        self._failing = threading.Lock()
        self._on_failure = None
        self._watching = None

    @property
    def leads(self) -> bool:
        return self.rank == 0

    def _key(self, seq: int) -> str:
        return f"{self.prefix}request/{seq}"

    def check(self) -> None:
        """Raise if a rank has failed: the world can no longer run a
        collective."""
        if self.failure is not None:
            raise RuntimeError(f"the serving world has failed: "
                               f"{self.failure}")

    def run(self, fn):
        """`fn()` on a thread of its own, waited for while no rank has
        failed. A rank held by a dead peer waits in a collective, or, under
        NCCL, in a kernel launch once the collective has filled the card's
        queue: its trajectory's thread stays there, and this raises."""
        out = {}

        def target():
            try:
                out["value"] = fn()
            except BaseException as e:  # noqa: BLE001 - raised below
                out["error"] = e

        thread = threading.Thread(target=target, name="serve-trajectory",
                                  daemon=True)
        thread.start()
        while thread.is_alive():
            thread.join(WATCH_SECONDS)
            self.check()
        if "error" in out:
            raise out["error"]
        return out["value"]

    def hand_on(self, request: dict) -> None:
        """(Rank 0, inside the service lock.) `request` to every rank."""
        self.check()
        if self.stopping:
            raise RuntimeError("the server is stopping")
        self.seq += 1
        self.store.set(self._key(self.seq), json.dumps(request))

    def stop(self) -> None:
        """(Rank 0, inside the service lock.) A stop to every rank, unless
        the world failed; returns when the last rank to read it has made
        its last store call, deleting the stop's key (the store may live in
        this process), or after CONTROL_TIMEOUT."""
        self.stopping = True
        if self.failure is not None:
            return
        self.seq += 1
        key = self._key(self.seq)
        self.store.set(key, json.dumps(None))
        deadline = time.monotonic() + CONTROL_TIMEOUT
        while self.store.check([key]) and time.monotonic() < deadline:
            time.sleep(0.01)

    def next_request(self):
        """(A rank other than 0.) The next request rank 0 hands on, or None
        at a stop. Waits without a deadline, CONTROL_TIMEOUT at a time,
        and raises when another rank has failed."""
        self.seq += 1
        key = self._key(self.seq)
        while True:
            try:
                self.store.wait([key], timedelta(seconds=CONTROL_TIMEOUT))
                break
            except RuntimeError as e:  # the store's wait timed out
                if "timeout" not in str(e).lower():
                    raise
            # the watch thread may not have had the store: look here
            if self.store.check([self.prefix + "failed"]):
                self._failed(self.store.get(self.prefix + "failed").decode())
            self.check()
        request = json.loads(self.store.get(key))
        if self.store.add(key + "/read", 1) == self.size - 1:
            # the key rank 0's `stop` waits on goes last: at a stop, rank 0
            # (which may host the store) leaves once it is gone, so no store
            # call of this rank may follow it
            self.store.delete_key(key + "/read")
            self.store.delete_key(key)
        return request

    def _failed(self, message: str) -> None:
        """Record the world's first failure (`check` raises from then on)
        and call the watch's `on_failure` once."""
        with self._failing:
            if self.failure is not None:
                return
            self.failure = message
        if self._on_failure is not None:
            self._on_failure(message)

    def fail(self, error: BaseException) -> None:
        """Mark the world failed by this rank's `error`."""
        self._failed(f"rank {self.rank}: {type(error).__name__}: {error}")
        with contextlib.suppress(RuntimeError):  # the store's host is gone
            self.store.set(self.prefix + "failed", self.failure)

    def watch(self, on_failure=None) -> None:
        """From a thread of its own, until `close`: record a failure that
        another rank marks (`_failed`). `on_failure(message)` is called
        once at the world's first failure, whichever rank saw it."""
        key = self.prefix + "failed"
        self._on_failure = on_failure

        def watching():
            while not self._closed.wait(WATCH_SECONDS):
                try:
                    if not self.store.check([key]):
                        continue
                    message = self.store.get(key).decode()
                except RuntimeError:  # the store's host has left
                    return
                self._failed(message)
                return

        self._watching = threading.Thread(target=watching,
                                          name="serve-world-watch",
                                          daemon=True)
        self._watching.start()

    def close(self) -> None:
        """End the watch and wait for its thread: a daemon thread still in a
        store call when the interpreter exits aborts the process (SIGABRT,
        "terminate called without an active exception")."""
        self._closed.set()
        if self._watching is not None:
            self._watching.join(CONTROL_TIMEOUT)


class SamplerService:
    """Owns the model, the sampler and, with `continuous`, the engine;
    under torchrun, this rank's part of the batched trajectories
    (`world`)."""

    def __init__(self, checkpoint_path: str, *, sampling_method: str = "ddim",
                 num_inference_steps: int | None = None, batch_size: int = 16,
                 use_ema: bool = False, config: dict | None = None,
                 mixed_precision: str | None = None, max_queue: int = 8,
                 continuous: bool = False, steps_per_tick: int = 1,
                 tome_ratio: float = 0.0, tome_mlp: bool = False,
                 quantize: str | None = None, device: str = "cuda",
                 world: ServingWorld | None = None):
        self.device = resolve_device(str(device), "serve")
        self.world = world
        self.layout = world.layout if world is not None else Layout()
        payload = load_checkpoint(checkpoint_path, config)
        self.config = dict(config or payload.get("config") or {})
        if not self.config:
            raise ValueError("checkpoint has no embedded config; pass one")
        if mixed_precision is not None:
            self.config["mixed_precision"] = mixed_precision
        model_type = str(self.config.get("model_type", "")).lower()
        # ToMe and int8 are DiT knobs, as in the root daemon: model fields,
        # any checkpoint's weights as they are; int8 composes with ToMe
        if tome_ratio > 0:
            if model_type != "dit":
                raise ValueError("tome_ratio applies to DiT checkpoints")
            mp = dict(self.config.get("model_params", {}),
                      tome_ratio=float(tome_ratio))
            if tome_mlp:
                mp["tome_mlp"] = True
            self.config["model_params"] = mp
        if quantize:
            if model_type != "dit":
                raise ValueError("quantize applies to DiT checkpoints")
            self.config["model_params"] = dict(
                self.config.get("model_params", {}), quant=str(quantize))
        if self.config.get("super_resolution"):
            raise ValueError(
                "super-resolution checkpoints are not servable: each "
                "request would need an LR conditioning image (use "
                "sample.py --sr_source or tools/cascade.py)")
        self.model = load_model_for_inference(payload, self.config, use_ema,
                                              self.device)
        # what the batched trajectories call: in a world, each call on this
        # rank's rows, gathered
        self.sampler_model = split_model_calls(self.model, self.layout)
        self.diffusion = get_diffusion(self.config, sampling_method)
        if num_inference_steps and hasattr(self.diffusion,
                                           "set_inference_steps"):
            self.diffusion.set_inference_steps(num_inference_steps)
        self.batch_size = int(batch_size)
        self.codec = LatentCodec.from_config(self.config, device=self.device)
        self.pixel_hw = resolve_image_size(self.config["image_size"])
        if self.codec is not None:
            # the sampler works at the latent geometry; /healthz and the
            # answers speak pixels
            self.image_hw = self.codec.latent_hw()
            self.channels = self.codec.latent_channels
        else:
            self.image_hw = self.pixel_hw
            self.channels = self.config.get("model_params", {}).get(
                "in_channels", 3)
        self.conditional = bool(self.config.get("conditional", False))
        self.num_classes = self.config.get("num_classes")
        self.default_cfg = float(self.config.get("cfg_scale", 1.8))
        self._lock = threading.Lock()  # one trajectory on the card at a time
        # generates in flight or waiting; beyond this -> 503
        self._max_queue = max(1, int(max_queue))
        self._slots = threading.BoundedSemaphore(self._max_queue)

        self.engine = None
        if continuous:
            if sampling_method != "ddim":
                raise ValueError(
                    "--continuous runs the stepwise DDIM engine; pass "
                    "--sampling_method ddim")
            # flow-matching, EDM and consistency checkpoints get their own
            # process whatever sampling_method says: DDIM updates on them
            # would silently produce garbage
            if not isinstance(self.diffusion, DDIM):
                raise ValueError(
                    "--continuous requires a VP (DDPM/DDIM-family) "
                    "checkpoint; this one has diffusion_type="
                    f"{self.config.get('diffusion_type', 'ddpm')!r}")
            if float(self.diffusion.eta) != 0.0:
                raise ValueError(
                    "--continuous is the deterministic (eta = 0) engine; "
                    f"this config sets ddim_eta={self.diffusion.eta}")
            h, w = self.image_hw
            self.engine = ContinuousBatchingEngine(
                self.diffusion, self.model, image_shape=(h, w, self.channels),
                num_slots=self.batch_size, conditional=self.conditional,
                steps_per_tick=steps_per_tick, device=self.device,
            ).start()

    def close(self):
        """Stop the engine thread, if any; in a world, rank 0 hands on a
        stop after the trajectory in flight, and this rank stops watching
        for failures."""
        if self.engine is not None:
            self.engine.stop()
        if self.world is not None:
            if self.world.leads:
                with self._lock:
                    self.world.stop()
                # the handlers in flight write their answers (a 500 after a
                # failure) before the process ends
                deadline = time.monotonic() + DRAIN_SECONDS
                for _ in range(self._max_queue):
                    self._slots.acquire(
                        timeout=max(0.0, deadline - time.monotonic()))
            self.world.close()

    def _resolve_labels(self, num_samples: int, labels):
        """Default and validate request labels (both modes)."""
        if labels is None:
            # round robin, wrapping at num_classes (sample.py's per-row
            # convention)
            labels = [i % (self.num_classes or 1) for i in range(num_samples)]
        if len(labels) != num_samples:
            raise ValueError("labels length must equal num_samples")
        if self.num_classes and any(
                not (0 <= l < self.num_classes) for l in labels):
            raise ValueError(f"labels must be in [0, {self.num_classes})")
        return labels

    def warmup(self):
        """One generate: builds the kernels and warms cuDNN at the serving
        batch before the first request."""
        t0 = time.time()
        self.generate(1, labels=[0] if self.conditional else None, seed=0)
        return time.time() - t0

    def initial_noise(self, shape, seed: int) -> torch.Tensor:
        """The standard normal draw of `shape` from a generator on the
        device seeded with `seed`."""
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        return torch.randn(shape, generator=generator, device=self.device)

    def generate(self, num_samples: int, labels=None, seed: int = 0,
                 cfg_scale: float | None = None) -> np.ndarray:
        """Images (num_samples, H, W, C) float32 in [0, 1]."""
        if not (1 <= num_samples <= self.batch_size):
            raise ValueError(f"num_samples must be in [1, {self.batch_size}]")
        if labels is not None and (
                not isinstance(labels, (list, tuple))
                or not all(isinstance(l, int) for l in labels)):
            raise ValueError("labels must be a list of integers")
        if self.conditional:
            labels = self._resolve_labels(num_samples, labels)
            scale = float(self.default_cfg if cfg_scale is None
                          else cfg_scale)
        elif labels is not None or cfg_scale is not None:
            raise ValueError("this model is unconditional: labels/cfg_scale "
                             "are not supported")
        h, w = self.image_hw
        with device_context(self.device), torch.no_grad():
            if self.engine is not None:
                # no padding, no service lock: the engine interleaves slots
                noise = self.initial_noise((num_samples, h, w, self.channels),
                                           seed)
                if self.conditional:
                    out = self.engine.submit(
                        noise, np.asarray(labels, np.int64) + 1,
                        cfg_scale=scale)
                else:
                    out = self.engine.submit(noise)
                if self.codec is not None:
                    out = self._decode(out)
            else:
                out = self._generate_batch(num_samples, labels, seed,
                                           scale if self.conditional else None)
        return np.clip((out + 1.0) / 2.0, 0.0, 1.0).astype(np.float32)

    def _generate_batch(self, num_samples, labels, seed, cfg_scale):
        """The first `num_samples` images of one trajectory of the fixed
        serving batch, as a host array; labels beyond them are the null
        label. In a world rank 0 first hands the request on, and a failure
        marks the world failed."""
        with self._lock:
            if self.world is not None and self.world.leads:
                self.world.hand_on({"num_samples": num_samples,
                                    "labels": labels, "seed": seed,
                                    "cfg_scale": cfg_scale})
            if self.world is None:
                return self._trajectory(num_samples, labels, seed, cfg_scale)

            def trajectory():
                with device_context(self.device):
                    return self._trajectory(num_samples, labels, seed,
                                            cfg_scale)
            try:
                return self.world.run(trajectory)
            except BaseException as e:
                self.world.fail(e)
                raise

    def _trajectory(self, num_samples, labels, seed, cfg_scale):
        shape = (self.batch_size, *self.image_hw, self.channels)
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        if cfg_scale is not None:
            y = np.zeros((self.batch_size,), np.int64)
            y[:num_samples] = np.asarray(labels) + 1  # 0 = null
            out = self.diffusion.sample_with_cfg(
                self.sampler_model, shape,
                torch.from_numpy(y).to(self.device), generator,
                cfg_scale=cfg_scale)
        else:
            out = self.diffusion.sample(self.sampler_model, shape, generator)
        out = out[:num_samples]
        if self.codec is not None:
            out = gather_rows(self.codec.decode, self.layout, out)
        # copied inside the lock: launches are asynchronous, so the card
        # runs the trajectory (and the decode) until this copy returns
        return out.float().cpu().numpy()

    def _decode(self, latents: np.ndarray) -> np.ndarray:
        """A finished request's latents decoded on the model's device, on
        the calling thread (made current by `generate`) while the engine
        goes on stepping. Any failure is the server's: a RuntimeError, so
        that the request gets a 500 whatever was raised."""
        try:
            return self.codec.decode(torch.as_tensor(latents)).cpu().numpy()
        except Exception as e:
            raise RuntimeError(f"decoding the latents failed: "
                               f"{type(e).__name__}: {e}") from e

    def try_acquire_slot(self) -> bool:
        return self._slots.acquire(blocking=False)

    def release_slot(self):
        self._slots.release()


def png_grid(images: np.ndarray) -> bytes:
    """(N, H, W, C) images in [0, 1] as one PNG grid, about square."""
    nrow = max(1, int(np.ceil(np.sqrt(len(images)))))
    grid = make_grid((np.clip(images, 0, 1) * 255).round().astype(np.uint8),
                     nrow=nrow)
    return encode_png(grid)


def make_handler(service: SamplerService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                h, w = service.pixel_hw
                self._send_json(200, {
                    "status": "ok",
                    "model_type": service.config.get("model_type"),
                    "image_size": [h, w],
                    "conditional": service.conditional,
                    "num_classes": service.num_classes,
                    "max_batch": service.batch_size,
                })
            else:
                self._send_json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._send_json(404, {"error": "not found"})
                return
            if not service.try_acquire_slot():
                self._send_json(503, {"error": "server overloaded"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("request body must be a JSON object")
                t0 = time.time()
                images = service.generate(
                    int(req.get("num_samples", 1)),
                    labels=req.get("labels"),
                    seed=int(req.get("seed", 0)),
                    cfg_scale=req.get("cfg_scale"),
                )
                elapsed = time.time() - t0
                if req.get("format", "png") == "npy":
                    buf = io.BytesIO()
                    np.save(buf, images)
                    self._send(200, buf.getvalue(),
                               "application/octet-stream")
                else:
                    self._send(200, png_grid(images), "image/png")
                print(f"generated {len(images)} in {elapsed:.2f}s",
                      flush=True)
            except (ValueError, TypeError, KeyError,
                    json.JSONDecodeError) as e:
                self._send_json(400, {"error": str(e)})
            except Exception as e:  # a failed generate is the server's fault
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            finally:
                service.release_slot()

    return Handler


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Serve a diffusion model (PyTorch port)")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--batch_size", type=int, default=16,
                        help="Fixed serving batch (requests pad to it)")
    parser.add_argument("--sampling_method", type=str, default="ddim",
                        choices=["ddpm", "ddim", "dpm++", "dpm++sde",
                                 "unipc"])
    parser.add_argument("--num_inference_steps", type=int, default=None)
    parser.add_argument("--use_ema", action="store_true")
    parser.add_argument("--mixed_precision", type=str, default=None,
                        choices=["bf16", "none"],
                        help="Override the checkpoint config's compute "
                             "dtype (bf16 inference on fp32 checkpoints)")
    parser.add_argument("--max_queue", type=int, default=8,
                        help="Max queued generate requests before 503")
    parser.add_argument("--continuous", action="store_true",
                        help="Continuous batching: a stepwise DDIM engine "
                             "over --batch_size slots; requests join "
                             "between steps instead of waiting for whole "
                             "batch trajectories")
    parser.add_argument("--steps_per_tick", type=int, default=1,
                        help="with --continuous: denoising steps per engine "
                             "tick, at the cost of admission granularity "
                             "of that many steps")
    parser.add_argument("--tome_ratio", type=float, default=0.0,
                        help="Token Merging (DiT checkpoints): merge this "
                             "fraction of patch tokens per block — "
                             "training-free serving speedup; 0 = off")
    parser.add_argument("--tome_mlp", action="store_true",
                        help="extend --tome_ratio merging to block MLPs")
    parser.add_argument("--quantize", type=str, default=None,
                        choices=["int8"],
                        help="w8a8 int8 serving (DiT checkpoints): block "
                             "products through the int8 path")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default), cuda:N or cpu")
    return parser


@contextlib.contextmanager
def signals_handled(handler):
    """SIGINT and SIGTERM go to `handler` within it (in the main thread;
    elsewhere nothing changes)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    saved = {sig: signal.signal(sig, handler)
             for sig in (signal.SIGINT, signal.SIGTERM)}
    try:
        yield
    finally:
        for sig, previous in saved.items():
            signal.signal(sig, previous)


def interrupt(signum, frame):
    raise KeyboardInterrupt


def follow(service: SamplerService) -> None:
    """A rank other than 0: run every request rank 0 hands on, in its
    order, until rank 0 stops; raise when a rank has failed."""
    world = service.world
    world.watch()
    try:
        with signals_handled(signal.SIG_IGN):
            while (request := world.next_request()) is not None:
                service._generate_batch(**request)
    finally:
        world.close()


def serve_http(args, service: SamplerService, device) -> None:
    """Rank 0 (or the one process): warm up, bind, answer until the server
    stops; in a world, raise when a rank failed."""
    world, server = service.world, None

    def on_failure(message):
        print(f"serve: stopping, {message}", file=sys.stderr, flush=True)
        if server is not None:
            threading.Thread(target=server.shutdown, daemon=True).start()

    if world is not None:
        world.watch(on_failure)
    try:
        print("Warming up (building the kernels)...", flush=True)
        dt = service.warmup()
        print(f"Warmup done in {dt:.1f}s on {device}"
              + (f" and {world.size - 1} more processes" if world else ""),
              flush=True)
        server = ThreadingHTTPServer((args.host, args.port),
                                     make_handler(service))
        print(f"Serving on http://{args.host}:{server.server_address[1]}",
              flush=True)
        try:
            with signals_handled(interrupt):
                if world is None or world.failure is None:
                    server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
    finally:
        service.close()
    if world is not None:
        world.check()


def main(argv=None):
    args = build_parser().parse_args(argv)
    env = distributed_env()
    if args.continuous and env is not None and env[1] > 1:
        raise ValueError(
            "--continuous runs in one process, as the JAX engine runs on "
            f"one device; under torchrun each of the {env[1]} processes "
            "would serve on its own: start it without torchrun, or drop "
            "--continuous for the batched daemon, which splits each batch "
            "over the processes")
    device, layout = join_world(resolve_device(args.device, "serve"))
    world = ServingWorld(layout) if layout.dp > 1 else None
    try:
        with main_process_output():
            service = SamplerService(
                args.checkpoint,
                sampling_method=args.sampling_method,
                num_inference_steps=args.num_inference_steps,
                batch_size=args.batch_size,
                use_ema=args.use_ema,
                mixed_precision=args.mixed_precision,
                max_queue=args.max_queue,
                continuous=args.continuous,
                steps_per_tick=args.steps_per_tick,
                tome_ratio=args.tome_ratio,
                tome_mlp=args.tome_mlp,
                quantize=args.quantize,
                device=str(device),
                world=world,
            )
            if world is not None and not world.leads:
                follow(service)
            else:
                serve_http(args, service, device)
    except BaseException as e:
        if world is not None and not isinstance(e, KeyboardInterrupt):
            world.fail(e)
        raise


def cli(argv=None):
    """`python -m diffusion_models_collection_tpu_torch.serve`: `main`,
    then leave the world. When `main` raises, the process ends at once with
    exit code 1: a failed world may leave a trajectory's thread held on the
    card by a dead peer, and the group's teardown waiting for it."""
    try:
        main(argv)
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    leave_world()


if __name__ == "__main__":
    cli(sys.argv[1:])
