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
and consistency checkpoints with the root daemon's `ValueError`. One
process: under torchrun (`WORLD_SIZE` > 1) it raises, naming ROADMAP queue
1 item 15e, the batched daemon's split of each batch over the ranks (JAX
root `serve.py:244-260`), which needs rank 0 to hand every request to the
others.
Super-resolution checkpoints are refused, as the root daemon refuses them:
each request would need an LR image (`sample --sr_source` and
`tools/cascade.py` run them).
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .diffusion import DDIM
from .factory import get_diffusion, load_model_for_inference
from .parallel.mesh import refuse_process_world
from .serving_engine import ContinuousBatchingEngine, device_context
from .utils.checkpoint import load_checkpoint
from .utils.helpers import (encode_png, make_grid, resolve_device,
                            resolve_image_size)
from .utils.latent import LatentCodec


class SamplerService:
    """Owns the model, the sampler and, with `continuous`, the engine."""

    def __init__(self, checkpoint_path: str, *, sampling_method: str = "ddim",
                 num_inference_steps: int | None = None, batch_size: int = 16,
                 use_ema: bool = False, config: dict | None = None,
                 mixed_precision: str | None = None, max_queue: int = 8,
                 continuous: bool = False, steps_per_tick: int = 1,
                 tome_ratio: float = 0.0, tome_mlp: bool = False,
                 quantize: str | None = None, device: str = "cuda"):
        self.device = resolve_device(str(device), "serve")
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
        self._slots = threading.BoundedSemaphore(max(1, int(max_queue)))

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
        """Stop the engine thread, if any."""
        if self.engine is not None:
            self.engine.stop()

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
        label."""
        shape = (self.batch_size, *self.image_hw, self.channels)
        with self._lock:
            generator = torch.Generator(device=self.device).manual_seed(
                int(seed))
            if cfg_scale is not None:
                y = np.zeros((self.batch_size,), np.int64)
                y[:num_samples] = np.asarray(labels) + 1  # 0 = null
                out = self.diffusion.sample_with_cfg(
                    self.model, shape, torch.from_numpy(y).to(self.device),
                    generator, cfg_scale=cfg_scale)
            else:
                out = self.diffusion.sample(self.model, shape, generator)
            out = out[:num_samples]
            if self.codec is not None:
                out = self.codec.decode(out)
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


def main(argv=None):
    args = build_parser().parse_args(argv)
    refuse_process_world(
        "serve", "15e", "the batched daemon's split of each batch over the "
        "processes is not ported yet")
    device = resolve_device(args.device, "serve")
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
    )
    try:
        print("Warming up (building the kernels)...", flush=True)
        dt = service.warmup()
        print(f"Warmup done in {dt:.1f}s on {device}", flush=True)
        server = ThreadingHTTPServer((args.host, args.port),
                                     make_handler(service))
        print(f"Serving on http://{args.host}:{server.server_address[1]}",
              flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
    finally:
        service.close()


if __name__ == "__main__":
    main(sys.argv[1:])
