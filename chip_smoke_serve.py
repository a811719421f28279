"""`chip_smoke.py`'s phase of the batched `serve` daemon split over a torchrun
world (`phase_serve_data_parallel`): `serve.main` of the fp32 UNet of
`configs/cifar10_unet.py` (the weights `phase_train_main` trained) at
`--batch_size 16`, DDIM-50, in a gloo world of two processes on the one
card (`tools/dryrun_multichip.py` `launch`; NCCL refuses two ranks on one
device), rank 0 answering HTTP on 127.0.0.1:

* /healthz, then REQUESTS (1, 5 and 16 images, one without labels, which
  takes the round-robin labels and the config's CFG scale; npy and png),
  each answer held bit for bit against this process's run of the same
  request through a `SamplerService` whose model runs each call on the
  ranks' row blocks in turn (`chip_smoke_data.rows_in_blocks`: the same
  float work); the distance to one process on whole calls is printed;
* each rank's K1 and K2 launches for each request equal to one process's
  on whole calls: every request pads to the batch of 16, so 50 CFG calls of
  32 rows, 16 a rank, `chip_smoke.UNET_FORWARD` each (2250 K1, 550 K2);
* the daemon idles IDLE seconds, longer than its control channel's timeout
  (`serve.CONTROL_TIMEOUT`, set to CONTROL_TIMEOUT for the phase), the
  worker's wait on the store times out and waits again, and one more
  request is exact; then SIGTERM to rank 0 stops every rank, and both exit
  0;
* images/s and the p50 of a request over the timed requests, at world 2
  and for one process serving the same requests over HTTP on whole calls,
  each with the card's name and power limit.

Every failure raises; nothing falls back to the CPU or to a plain version.
Alone, after `phase_build` (with a `.pth` of configs/cifar10_unet.py), from
a script whose main module is guarded (the ranks are spawned):

    import chip_smoke as c, chip_smoke_serve as s
    if __name__ == "__main__":
        smi = c.device_line(); c.phase_build()
        s.phase_serve_data_parallel(smi, "unet.pth")
"""

from __future__ import annotations

import concurrent.futures
import io
import json
import os
import signal
import socket
import statistics
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as c
import chip_smoke_data
from diffusion_models_collection_tpu_torch import serve
from diffusion_models_collection_tpu_torch.parallel.mesh import process_index

WORLD = 2
TIMEOUT = 300
BATCH = 16  # `--batch_size`: every request pads to it
CONTROL_TIMEOUT = 1.0  # the phase's `serve.CONTROL_TIMEOUT`
IDLE = 3.0  # a FileStore's wait may take twice its timeout
REQUESTS = [
    {"num_samples": 1, "labels": [3], "seed": 21, "cfg_scale": c.CFG_SCALE,
     "format": "npy"},
    {"num_samples": 5, "labels": [0, 2, 4, 6, 8], "seed": 22,
     "cfg_scale": 2.0, "format": "png"},
    {"num_samples": 16, "labels": [i % 10 for i in range(16)], "seed": 23,
     "cfg_scale": c.CFG_SCALE, "format": "npy"},
    {"num_samples": 5, "seed": 24, "format": "npy"},
]
AFTER_IDLE = {"num_samples": 16, "labels": [9 - i % 10 for i in range(16)],
              "seed": 25, "cfg_scale": c.CFG_SCALE, "format": "npy"}


class CountingStore:
    """The default group's store with its timed-out waits counted."""

    def __init__(self, store):
        self.store, self.timeouts = store, 0

    def wait(self, keys, timeout):
        try:
            return self.store.wait(keys, timeout)
        except RuntimeError:
            self.timeouts += 1
            raise

    def __getattr__(self, name):
        return getattr(self.store, name)


def serve_rank(job):
    """(In each rank of the gloo world.) `serve.main(job["argv"])` with
    every trajectory's launches and the store's timed-out waits counted;
    rank 0 writes its pid. This rank's record."""
    torch.cuda.set_device(0)
    launches, stores = [], []
    trajectory, store = serve.SamplerService._trajectory, serve.world_store

    def counted(self, *args, **kwargs):
        torch.cuda.synchronize()
        c.reset_launches()
        out = trajectory(self, *args, **kwargs)
        launches.append(c.read_launches())
        return out

    def counting_store():
        stores.append(CountingStore(store()))
        return stores[-1]

    serve.CONTROL_TIMEOUT = job["control_timeout"]
    serve.SamplerService._trajectory = counted
    serve.world_store = counting_store
    if process_index() == 0:
        (Path(job["out"]) / "pid").write_text(str(os.getpid()))
    try:
        serve.main(job["argv"])
    finally:
        serve.SamplerService._trajectory = trajectory
        serve.world_store = store
    return {"launches": launches, "timeouts": stores[0].timeouts}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def healthz(port, alive):
    deadline = time.monotonic() + TIMEOUT
    while alive() and time.monotonic() < deadline:
        try:
            status, _, data = c.http_request(("127.0.0.1", port), "GET",
                                             "/healthz")
            if status == 200:
                return json.loads(data)
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"serve data parallel: no daemon on port {port}")


def timed_requests(port, bodies, counts=False):
    """Each of `bodies` in turn: [(answer, seconds, launches or None)]."""
    out = []
    for body in bodies:
        if counts:
            torch.cuda.synchronize()
            c.reset_launches()
        start = time.perf_counter()
        answer = c.http_request(("127.0.0.1", port), "POST", "/generate",
                                body)
        seconds = time.perf_counter() - start
        if answer[0] != 200:
            raise AssertionError(f"serve data parallel {body}: {answer[0]} "
                                 f"{answer[2][:200]}")
        out.append((answer, seconds, c.read_launches() if counts else None))
    return out


def rates(runs, bodies):
    latencies = [sec for _, sec, _ in runs]
    images = sum(b["num_samples"] for b in bodies)
    return {"p50_ms": 1e3 * statistics.median(latencies),
            "images_per_s": images / sum(latencies),
            "ms": [round(1e3 * s, 1) for s in latencies]}


def one_process(ckpt, bodies):
    """One process serving `bodies` over HTTP on whole calls: the runs
    with their launches."""
    service = serve.SamplerService(
        str(ckpt), sampling_method="ddim", num_inference_steps=c.STEPS,
        batch_size=BATCH, device="cuda")
    service.warmup()
    httpd = serve.ThreadingHTTPServer(("127.0.0.1", 0),
                                      serve.make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever)
    thread.start()
    try:
        return timed_requests(httpd.server_address[1], bodies, counts=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def images_of(answer):
    status, ctype, data = answer
    return np.load(io.BytesIO(data)) if ctype == "application/octet-stream" \
        else data


def phase_serve_data_parallel(smi, unet_ckpt):
    """Item 15e on the card: the checks of the module docstring. Returns
    the figures."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bodies = REQUESTS + [AFTER_IDLE]
    per_request = c.scaled(c.UNET_FORWARD, c.STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        job = {"argv": ["--checkpoint", str(unet_ckpt), "--port", str(port),
                        "--batch_size", str(BATCH), "--sampling_method",
                        "ddim", "--num_inference_steps", str(c.STEPS),
                        "--device", "cuda"],
               "out": tmp, "control_timeout": CONTROL_TIMEOUT}
        pool = concurrent.futures.ThreadPoolExecutor(1)
        start = time.perf_counter()
        codes = []
        world = pool.submit(c.launch, WORLD, "chip_smoke_serve.serve_rank",
                            job, device="cuda", backend="gloo",
                            timeout=TIMEOUT, exit_codes=codes)
        try:
            # the references while the ranks start
            with chip_smoke_data.rows_in_blocks():
                service = serve.SamplerService(
                    str(unet_ckpt), sampling_method="ddim",
                    num_inference_steps=c.STEPS, batch_size=BATCH,
                    device="cuda")
                refs = [service.generate(
                    b["num_samples"], labels=b.get("labels"), seed=b["seed"],
                    cfg_scale=b.get("cfg_scale")) for b in bodies]
                del service
            health = healthz(port, lambda: not world.done())
            runs = timed_requests(port, REQUESTS)
            time.sleep(IDLE)
            runs += timed_requests(port, [AFTER_IDLE])
        finally:  # rank 0 stops the world, whatever happened here
            pid = Path(tmp) / "pid"
            if pid.exists():
                os.kill(int(pid.read_text()), signal.SIGTERM)
        records = world.result()
        world_seconds = time.perf_counter() - start
        pool.shutdown()
    whole = one_process(unet_ckpt, bodies)

    errs, whole_errs = [], []
    for body, ref, (answer, _, _), (plain, _, _) in zip(bodies, refs, runs,
                                                        whole):
        got = images_of(answer)
        if body["format"] == "png":
            errs.append(0.0 if got == serve.png_grid(ref) else float("inf"))
            continue
        errs.append(float(np.abs(got - ref).max()))
        whole_errs.append(float(np.abs(got - images_of(plain)).max()))
    world_rates, one_rates = rates(runs, bodies), rates(whole, bodies)
    rank_launches = [r["launches"] for r in records]
    print(f"serve data parallel: world {WORLD} (gloo, one card), "
          f"--batch_size {BATCH} DDIM-{c.STEPS}; /healthz {health}; "
          f"{len(bodies)} requests of {[b['num_samples'] for b in bodies]} "
          f"images against one process on the ranks' row blocks: max_abs "
          f"{errs} (png bytes equal: 0.0), bit-equal expected; against one "
          f"process on whole calls {whole_errs}; on {smi}")
    print(f"serve data parallel: launches a request, rank 0 "
          f"{[nonzero(n) for n in rank_launches[0][1:]]}, rank 1 "
          f"{[nonzero(n) for n in rank_launches[1][1:]]}, one process "
          f"{[nonzero(w[2]) for w in whole]} (expected {nonzero(per_request)}"
          f" each; the warm-up's {nonzero(rank_launches[0][0])}); the "
          f"worker's store waits "
          f"timed out {records[1]['timeouts']} times in the {IDLE:g} s "
          f"idle gap (control timeout {CONTROL_TIMEOUT:g} s); exit codes "
          f"{codes}; on {smi}")
    print(f"serve data parallel: world {WORLD} p50 "
          f"{world_rates['p50_ms']:.1f} ms, {world_rates['images_per_s']:.2f}"
          f" images/s (requests {world_rates['ms']} ms); one process on "
          f"whole calls p50 {one_rates['p50_ms']:.1f} ms, "
          f"{one_rates['images_per_s']:.2f} images/s (requests "
          f"{one_rates['ms']} ms); "
          f"{world_rates['images_per_s'] / one_rates['images_per_s']:.3f}x "
          f"the images/s; the world's run {world_seconds:.1f} s; on {smi}")
    if not (max(errs) == 0.0 and health["max_batch"] == BATCH
            and all(len(r) == 1 + len(bodies) for r in rank_launches)
            and all(n == per_request for r in rank_launches for n in r)
            and all(w[2] == per_request for w in whole)
            and records[1]["timeouts"] >= 1 and codes == [0] * WORLD
            and all(np.isfinite(e) for e in whole_errs)):
        raise AssertionError(
            f"serve data parallel: max_abs {errs}, launches "
            f"{rank_launches}, one process {[w[2] for w in whole]}, "
            f"timeouts {records[1]['timeouts']}, exit codes {codes}")
    return {"world": world_rates, "one": one_rates,
            "world_seconds": world_seconds, "whole_errs": whole_errs,
            "launches": rank_launches[0][1]}
