"""The PyTorch port's batched `serve` daemon at several world sizes, as
torchrun starts it: one process for each rank with RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT set (NCCL on the cards, one card a
rank; gloo with `--device cpu`), rank 0 answering HTTP on 127.0.0.1.

    python tools/serve_torch_world.py [--worlds 1,2,4] [--device cuda] \\
        [--config configs/cifar10_unet.py] [--steps 50] [--batch_size 16] \\
        [--failure] [--output serve_world.json]

For each world size: the daemon on a checkpoint of random weights (torch
seed 0) of `--config`, /healthz, then REQUESTS in turn (1, 5, 16 and 5
images, npy), each request's seconds; SIGTERM to rank 0, and every rank's
exit code (0 expected). Prints each world's p50 and images/s beside world
1's, and the largest distance of its images from world 1's (a call on
fewer rows may take other kernels, which a clamped CFG trajectory grows).
With `--failure`, a world of 2 whose rank 1 raises in its second
trajectory (the first after the warm-up): the status of the request that
meets it (500 expected), every rank's exit code (non-zero) and the seconds
from the request to the last exit. A line per world and a JSON summary,
with the card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import os
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
REQUESTS = [
    {"num_samples": 1, "labels": [3], "seed": 21, "cfg_scale": 3.0},
    {"num_samples": 5, "labels": [0, 2, 4, 6, 8], "seed": 22,
     "cfg_scale": 2.0},
    {"num_samples": 16, "labels": [i % 10 for i in range(16)], "seed": 23,
     "cfg_scale": 3.0},
    {"num_samples": 5, "seed": 24},
]
WAIT = 300  # seconds a daemon may take to come up, answer or end
FAILURE_WAIT = 60  # seconds the failing world's ranks may take to end


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        conn.request("POST", "/generate", body=json.dumps(body))
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def healthy(port, procs):
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline and all(p.poll() is None
                                              for p in procs):
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("GET", "/healthz")
            if conn.getresponse().status == 200:
                return
        except OSError:
            time.sleep(0.2)
    raise RuntimeError(f"no daemon answered on port {port}: exit codes "
                       f"{[p.poll() for p in procs]}")


def start(world, argv, log_dir, failing=False):
    """The ranks of a world of `world` processes (one plain process at 1),
    each logging to `log_dir/rank<r>.txt`."""
    port, master = free_ports(2)
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        if world > 1:
            env.update(RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(master))
        cmd = ([__file__, "--failing-rank"] if failing and rank == 1 else
               ["-m", "diffusion_models_collection_tpu_torch.serve"])
        with open(Path(log_dir) / f"rank{rank}.txt", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, *cmd, *argv, "--port", str(port)],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    return port, procs


def ended(procs, seconds):
    deadline = time.monotonic() + seconds
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(max(0.1, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            codes.append(None)  # killed at the deadline
    return codes


def run_world(world, argv, log_dir):
    port, procs = start(world, argv, log_dir)
    try:
        start_up = time.monotonic()
        healthy(port, procs)
        start_up = time.monotonic() - start_up
        latencies, images = [], []
        for body in REQUESTS:
            t0 = time.perf_counter()
            status, data = post(port, dict(body, format="npy"))
            latencies.append(time.perf_counter() - t0)
            if status != 200:
                raise RuntimeError(f"world {world}: {status} {data[:300]}")
            images.append(np.load(io.BytesIO(data)))
    finally:
        procs[0].send_signal(signal.SIGTERM)
        codes = ended(procs, WAIT)
    n = sum(b["num_samples"] for b in REQUESTS)
    return {"world": world, "start_seconds": start_up,
            "ms": [1e3 * s for s in latencies],
            "p50_ms": 1e3 * statistics.median(latencies),
            "images_per_s": n / sum(latencies), "exit_codes": codes,
            "images": images}


def run_failure(argv, log_dir):
    port, procs = start(2, argv, log_dir, failing=True)
    healthy(port, procs)
    t0 = time.monotonic()
    try:
        status = post(port, {"num_samples": 1, "format": "npy"})[0]
    except (OSError, http.client.HTTPException) as e:
        status = type(e).__name__
    codes = ended(procs, FAILURE_WAIT)
    return {"status": status, "exit_codes": codes,
            "seconds": time.monotonic() - t0}


def failing_rank(argv):
    """A rank whose second trajectory raises; otherwise `python -m
    ...serve` (`serve.cli`)."""
    sys.path.insert(0, str(ROOT))
    from diffusion_models_collection_tpu_torch import serve

    trajectory, calls = serve.SamplerService._trajectory, []

    def failing(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("rank 1's trajectory failed")
        return trajectory(self, *args, **kwargs)

    serve.SamplerService._trajectory = failing
    serve.cli(argv)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--failing-rank":
        return failing_rank(argv[1:])
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--worlds", default="1,2,4")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--config", default="configs/cifar10_unet.py")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--failure", action="store_true")
    parser.add_argument("--output", default=None)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from diffusion_models_collection_tpu_torch.factory import get_model
    from diffusion_models_collection_tpu_torch.utils.checkpoint import (
        save_checkpoint,
    )
    from diffusion_models_collection_tpu_torch.utils.helpers import (
        load_config,
    )

    card = "cpu"
    if args.device == "cuda":
        from diffusion_models_collection_tpu_torch.ops import _build

        _build.library()  # built once here; the ranks load it
        card = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    worlds = [int(w) for w in args.worlds.split(",")]
    summary = {"device": card, "worlds": []}
    with tempfile.TemporaryDirectory() as tmp:
        config = load_config(ROOT / args.config)
        torch.manual_seed(0)
        ckpt = Path(tmp) / "model.pth"
        save_checkpoint(ckpt, get_model(config).state_dict(), config)
        argv = ["--checkpoint", str(ckpt), "--device", args.device,
                "--batch_size", str(args.batch_size), "--sampling_method",
                "ddim", "--num_inference_steps", str(args.steps)]
        runs = {}
        for world in worlds:
            log_dir = Path(tmp) / f"world{world}"
            log_dir.mkdir()
            try:
                runs[world] = run_world(world, argv, log_dir)
            except RuntimeError:
                for log in sorted(log_dir.glob("rank*.txt")):
                    print(f"--- {log.name}\n{log.read_text()[-3000:]}")
                raise
        one = runs[worlds[0]]
        for run in runs.values():
            run["max_abs_from_first"] = max(
                float(np.abs(a - b).max())
                for a, b in zip(run["images"], one["images"]))
        for world, run in runs.items():
            summary["worlds"].append(run)
            print(f"serve world {world} ({args.device}): p50 "
                  f"{run['p50_ms']:.1f} ms, {run['images_per_s']:.2f} "
                  f"images/s ({run['images_per_s'] / one['images_per_s']:.3f}"
                  f"x world {worlds[0]}), requests "
                  f"{[round(m, 1) for m in run['ms']]} ms, max_abs from "
                  f"world {worlds[0]}'s images {run['max_abs_from_first']:.3e}"
                  f", up in {run['start_seconds']:.1f} s, exit codes "
                  f"{run['exit_codes']}; on {card}", flush=True)
        for run in runs.values():
            del run["images"]
        if args.failure:
            log_dir = Path(tmp) / "failure"
            log_dir.mkdir()
            summary["failure"] = run_failure(argv, log_dir)
            print(f"serve world 2 ({args.device}) with rank 1 failing: "
                  f"request status {summary['failure']['status']}, exit "
                  f"codes {summary['failure']['exit_codes']}, every rank "
                  f"ended {summary['failure']['seconds']:.1f} s after the "
                  f"request; on {card}", flush=True)
            for log in sorted(log_dir.glob("rank*.txt")):
                print(f"--- {log.name} (tail)\n{log.read_text()[-1500:]}")
    print(json.dumps(summary))
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(json.dumps(summary, indent=1))
    bad = [r for r in summary["worlds"] if r["exit_codes"] != [0] * r["world"]]
    failure = summary.get("failure")
    if bad or (failure and (failure["status"] not in (500,
                                                      "RemoteDisconnected",
                                                      "ConnectionResetError")
                            or None in failure["exit_codes"]
                            or 0 in failure["exit_codes"])):
        raise SystemExit(f"serve world: exit codes {bad}, failure {failure}")


if __name__ == "__main__":
    main()
