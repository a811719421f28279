"""The batched `serve` daemon of the PyTorch port split over a torchrun world,
on the CPU: every rank runs each request's trajectory, each model call on
its rows in rank order (`parallel/data_parallel.py`), and rank 0 alone
answers HTTP on 127.0.0.1.

* One gloo world of 2 processes (`tools/dryrun_multichip.launch`, the rank
  job `torch_serve_jobs.serve_rank`, one torch thread a rank) runs four
  daemons in turn, each stopped by SIGTERM to rank 0: the small UNet with
  CFG (`--use_ema`, `--max_queue 3`), an unconditional UNet, a DiT with
  `--tome_ratio 0.5 --quantize int8`, and a latent UNet whose decode is
  split too. Each answer is held bit for bit against this process's
  `SamplerService` whose model runs each call on the ranks' row blocks in
  turn (`torch_data_parallel_jobs.rows_in_blocks`: the same float work), and
  the UNet's against JAX's `DDIM.sample_with_cfg` on the same weights and
  initial noise at the trajectory bar. The UNet's daemon also answers a
  400 that never leaves rank 0, idles longer than its control timeout (set
  to CONTROL_TIMEOUT seconds), and, with its worker held in a trajectory,
  answers a 503 at `--max_queue` while two queued requests keep their
  order.
* Three worlds of 2 processes started as torchrun starts them (RANK,
  WORLD_SIZE, MASTER_ADDR and MASTER_PORT: the default group's TCPStore on
  rank 0), with every rank given the same `--port`: `python -m
  diffusion_models_collection_tpu_torch.serve` on both ranks, stopped by
  SIGTERM to rank 0, each rank exiting 0; the same with the worker held
  before each store call after it reads the stop
  (`torch_serve_jobs.stop_held_worker`), each rank exiting 0 too; and one
  whose worker's second trajectory raises while rank 0's is held, as a dead
  peer holds an NCCL rank (`torch_serve_jobs.failing_worker`,
  `held_leader`): the client gets a 500 or a refused connection and every
  rank ends non-zero within FAILURE_SECONDS.

Every world starts in the background while the references run here.
"""

import concurrent.futures
import contextlib
import http.client
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.diffusion.ddim import DDIM as JaxDDIM
from diffusion_models_collection_tpu_torch import serve
from diffusion_models_collection_tpu_torch.factory import get_model
from diffusion_models_collection_tpu_torch.tools.dryrun_multichip import (
    launch,
)
from diffusion_models_collection_tpu_torch.utils.checkpoint import (
    save_checkpoint,
)
from torch_data_parallel_jobs import rows_in_blocks
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    H,
    W,
    jax_unet,
    max_rel,
    one_torch_thread,
    small_config,
    small_dit_config,
    torch_unet,
)

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
STEPS = 3
CONTROL_TIMEOUT = 1.0
# the UNet daemon's idle gap: a FileStore's wait may take twice its timeout
IDLE = 3.0
TRAJECTORY_BAR = 5e-4  # max-rel, a whole DDIM trajectory against JAX
FAILURE_SECONDS = 30  # a worker's failure to every rank's exit
WAIT = 120  # seconds a daemon may take to come up or answer
LATENT_HW, LATENT_SCALE = 8, 0.7
VAE_PARAMS = dict(in_channels=3, base_channels=8, channel_mult=(1, 2),
                  latent_channels=2, num_res_blocks=1, use_attention=True)


def free_ports(n: int) -> list:
    """`n` distinct free ports of 127.0.0.1 (held together while chosen)."""
    with contextlib.ExitStack() as stack:
        socks = [stack.enter_context(socket.socket()) for _ in range(n)]
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]


def request(port, method, path, body=None):
    """(status, content type, body) of one HTTP call to 127.0.0.1:port."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def generate(port, body):
    return request(port, "POST", "/generate", body)


def healthz(port, alive=lambda: True) -> dict:
    """/healthz of the daemon on `port` once it answers."""
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline and alive():
        try:
            status, _, data = request(port, "GET", "/healthz")
            assert status == 200
            return json.loads(data)
        except OSError:
            time.sleep(0.05)
    raise AssertionError(f"no daemon answered on port {port}")


def npy(answer):
    status, ctype, data = answer
    assert status == 200 and ctype == "application/octet-stream", answer
    return np.load(io.BytesIO(data))


def perturbed_state(config, seed):
    """The port's model of `config` with every parameter moved by seeded
    noise (the DiT's adaLN-Zero init would give zeros)."""
    torch.manual_seed(seed)
    model = get_model(config)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    return model.state_dict()


def checkpoints(root):
    """(The flax UNet and params, every daemon's checkpoint path.)"""
    model, params, config = jax_unet(True, seed=0)
    state = torch_unet(params, config).state_dict()
    paths = {name: root / f"{name}.pth" for name in (
        "unet", "uncond", "dit", "vae", "latent")}
    # the EMA weights are the model's: `--use_ema` reads them
    save_checkpoint(paths["unet"], state, config, ema_model_state_dict=state)
    uncond = small_config(False)
    save_checkpoint(paths["uncond"], perturbed_state(uncond, 1), uncond)
    dit = small_dit_config()
    save_checkpoint(paths["dit"], perturbed_state(dit, 2), dit)
    vae = {"model_type": "vae", "image_size": LATENT_HW,
           "conditional": False, "mixed_precision": "none",
           "model_params": dict(VAE_PARAMS, dropout=0.0)}
    save_checkpoint(paths["vae"], perturbed_state(vae, 3), vae)
    latent = dict(small_config(), image_size=LATENT_HW,
                  latent_diffusion=True, vae_checkpoint=str(paths["vae"]),
                  latent_scale_factor=LATENT_SCALE,
                  model_params=dict(small_config()["model_params"],
                                    image_size=(2, 2), in_channels=2,
                                    out_channels=2,
                                    attention_resolutions=(2,)))
    save_checkpoint(paths["latent"], perturbed_state(latent, 4), latent)
    return (model, params), paths


# each daemon's flags (as `SamplerService` keywords) and requests
FLAGS = {
    "unet": dict(batch_size=4, use_ema=True, max_queue=3),
    "uncond": dict(batch_size=4),
    "dit": dict(batch_size=3, tome_ratio=0.5, quantize="int8"),
    "latent": dict(batch_size=4),
}
REQUESTS = {
    "unet": {
        "a": {"num_samples": 2, "labels": [0, 9], "seed": 5,
              "cfg_scale": 2.5, "format": "npy"},
        # default labels 0, 1, 2 and the config's CFG scale
        "b": {"num_samples": 3, "seed": 1, "format": "png"},
        # after the idle gap
        "c": {"num_samples": 4, "labels": [3, 1, 4, 1], "seed": 9,
              "cfg_scale": 1.5, "format": "npy"},
        # held in the worker's trajectory while e, f, g arrive
        "d": {"num_samples": 1, "labels": [7], "seed": 3, "format": "npy"},
        "e": {"num_samples": 2, "labels": [2, 2], "seed": 10,
              "format": "npy"},
        "f": {"num_samples": 3, "seed": 11, "format": "npy"},
        "g": {"num_samples": 1, "labels": [5], "seed": 12, "cfg_scale": 4.0,
              "format": "npy"},
    },
    "uncond": {"a": {"num_samples": 3, "seed": 2, "format": "npy"}},
    "dit": {"a": {"num_samples": 2, "labels": [3, 8], "seed": 4,
                  "cfg_scale": 2.0, "format": "npy"}},
    # 2 rows decode split, 3 whole on each rank
    "latent": {"a": {"num_samples": 2, "labels": [1, 2], "seed": 7,
                     "cfg_scale": 2.0, "format": "npy"},
               "b": {"num_samples": 3, "seed": 8, "format": "npy"}},
}
BAD = {"num_samples": 1, "labels": [10], "format": "npy"}


def argv_of(path, port, flags):
    argv = ["--checkpoint", str(path), "--port", str(port),
            "--sampling_method", "ddim", "--num_inference_steps", str(STEPS),
            "--batch_size", str(flags["batch_size"])]
    for key in ("max_queue", "tome_ratio", "quantize"):
        if key in flags:
            argv += [f"--{key}", str(flags[key])]
    return argv + (["--use_ema"] if flags.get("use_ema") else [])


def torchrun_world(argv, log, master, jobs=(None, None)):
    """Two processes as torchrun starts them, on the CPU, both given
    `argv`: rank r runs `torch_serve_jobs.<jobs[r]>`, or `python -m
    ...serve` where that is None."""
    procs = []
    for rank, job in enumerate(jobs):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(WORLD),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(master), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(REPO),
                                               str(REPO / "tests")]))
        if job is not None:
            cmd = ["-c", "import sys, torch_serve_jobs as j; "
                   f"j.{job}(sys.argv[1:])"]
        else:
            cmd = ["-m", "diffusion_models_collection_tpu_torch.serve"]
        out = open(f"{log}{rank}.txt", "w")
        procs.append(subprocess.Popen(
            [sys.executable, *cmd, *argv, "--device", "cpu"], cwd=REPO,
            env=env, stdout=out, stderr=subprocess.STDOUT))
        out.close()
    return procs


def ended(procs, seconds):
    """Every process's exit code, or None for one still running after
    `seconds` (then killed)."""
    deadline = time.monotonic() + seconds
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(max(0.1, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            codes.append(None)
    return codes


def drive_unet(port, out, answers, jax_reference):
    """The UNet daemon's client: a, a 400, b; `jax_reference()` and the
    rest of the idle gap; c; then d held by the worker while e, f, g
    arrive (exactly one of them finds --max_queue full)."""
    reqs = REQUESTS["unet"]
    answers["health"] = healthz(port)
    answers["a"] = generate(port, reqs["a"])
    answers["bad"] = generate(port, BAD)
    answers["b"] = generate(port, reqs["b"])
    start = time.monotonic()
    answers["jax"] = jax_reference()
    time.sleep(max(0.0, IDLE - (time.monotonic() - start)))
    answers["idle_seconds"] = time.monotonic() - start
    answers["c"] = generate(port, reqs["c"])
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        held = pool.submit(generate, port, reqs["d"])
        deadline = time.monotonic() + WAIT
        while not (out / "paused_unet").exists():
            assert time.monotonic() < deadline and not held.done()
            time.sleep(0.01)
        queued = {k: pool.submit(generate, port, reqs[k]) for k in "efg"}
        done, _ = concurrent.futures.wait(
            queued.values(), WAIT, concurrent.futures.FIRST_COMPLETED)
        answers["held_done_early"] = held.done()
        (out / "go_unet").touch()
        answers["d"] = held.result(WAIT)
        for k, f in queued.items():
            answers[k] = f.result(WAIT)


def drive(port, name, answers):
    answers["health"] = healthz(port)
    if name == "uncond":
        answers["bad"] = generate(port, {"num_samples": 1, "labels": [0]})
    for key, body in REQUESTS[name].items():
        answers[key] = generate(port, body)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every world's answers, records and exit codes, and the references:
    a dict by daemon."""
    root = tmp_path_factory.mktemp("serve_world")
    (jax_model, jax_params), paths = checkpoints(root)
    (*daemon_ports, clean_port, fail_port, held_port, clean_master,
     fail_master, held_master) = free_ports(len(FLAGS) + 6)
    ports = dict(zip(FLAGS, daemon_ports))
    daemons = [{"name": name, "argv": argv_of(paths[name], ports[name], f),
                "control_timeout": (CONTROL_TIMEOUT if name == "unet"
                                    else serve.CONTROL_TIMEOUT),
                **({"pause": 5} if name == "unet" else {})}
               for name, f in FLAGS.items()]
    pool = concurrent.futures.ThreadPoolExecutor(1)
    start = time.monotonic()
    world = pool.submit(launch, WORLD, "torch_serve_jobs.serve_rank",
                        daemons, str(root), timeout=WAIT)
    clean = torchrun_world(argv_of(paths["unet"], clean_port,
                                   dict(batch_size=2)), root / "clean",
                           clean_master)
    failing = torchrun_world(argv_of(paths["unet"], fail_port,
                                     dict(batch_size=2)), root / "failing",
                             fail_master, ("held_leader", "failing_worker"))
    held = torchrun_world(argv_of(paths["unet"], held_port,
                                  dict(batch_size=2)), root / "held",
                          held_master, (None, "stop_held_worker"))

    result = {"paths": paths, "ports": ports}

    def jax_reference():
        """JAX's DDIM CFG trajectory of request a on the serving batch's
        seeded draw."""
        body = REQUESTS["unet"]["a"]
        noise = serve.SamplerService.initial_noise(
            SimpleNamespace(device=torch.device("cpu")), (4, H, W, 3),
            body["seed"])
        y = np.zeros(4, np.int32)
        y[:2] = np.asarray(body["labels"]) + 1
        out = JaxDDIM(num_timesteps=1000,
                      num_inference_steps=STEPS).sample_with_cfg(
            jax.tree_util.Partial(
                lambda x, t, yy: jax_model.apply({"params": jax_params}, x,
                                                 t, yy)),
            noise.shape, jnp.asarray(y), jax.random.PRNGKey(0),
            cfg_scale=body["cfg_scale"], init_noise=jnp.asarray(noise.numpy()))
        return np.clip((np.asarray(out)[:2] + 1) / 2, 0, 1), noise.numpy()

    try:
        for name in FLAGS:
            answers = result.setdefault(name, {})
            if name == "unet":
                drive_unet(ports[name], root, answers, jax_reference)
            else:
                drive(ports[name], name, answers)
            os.kill(int((root / "pid").read_text()), signal.SIGTERM)
        records = world.result()
        result["world_seconds"] = time.monotonic() - start
        result["records"] = records

        # the torchrun worlds: a request each, then SIGTERM or the failure
        health = healthz(clean_port, lambda: clean[0].poll() is None)
        result["clean"] = {"health": health,
                           "a": generate(clean_port,
                                         {"num_samples": 2, "labels": [1, 2],
                                          "seed": 3, "format": "npy"})}
        clean[0].send_signal(signal.SIGTERM)
        result["clean"]["codes"] = ended(clean, WAIT)
        result["clean"]["logs"] = [(root / f"clean{r}.txt").read_text()
                                   for r in range(WORLD)]
        healthz(held_port, lambda: held[0].poll() is None)
        held[0].send_signal(signal.SIGTERM)
        result["held"] = {"codes": ended(held, WAIT),
                          "logs": [(root / f"held{r}.txt").read_text()
                                   for r in range(WORLD)]}
        healthz(fail_port, lambda: failing[0].poll() is None)
        t0 = time.monotonic()
        try:
            status = generate(fail_port, {"num_samples": 1})[0]
        except (OSError, http.client.HTTPException) as e:
            status = type(e).__name__
        result["failing"] = {"status": status,
                             "codes": ended(failing, FAILURE_SECONDS),
                             "seconds": time.monotonic() - t0,
                             "logs": [(root / f"failing{r}.txt").read_text()
                                      for r in range(WORLD)]}

    finally:  # no rank outlives the fixture
        for proc in clean + failing + held:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        pool.shutdown(wait=False)

    # the one-process row-block runs of every request
    refs = {}
    with rows_in_blocks(WORLD):
        for name, flags in FLAGS.items():
            service = serve.SamplerService(
                str(paths[name]), sampling_method="ddim",
                num_inference_steps=STEPS, device="cpu", **flags)
            refs[name] = {key: service.generate(
                body["num_samples"], labels=body.get("labels"),
                seed=body["seed"], cfg_scale=body.get("cfg_scale"))
                for key, body in REQUESTS[name].items()}
        service = serve.SamplerService(str(paths["unet"]), device="cpu",
                                       num_inference_steps=STEPS,
                                       batch_size=2)
        refs["clean"] = service.generate(2, labels=[1, 2], seed=3)
    result["root"] = root
    result["refs"] = refs
    return result


# ------------------------------------------------------------ the answers
def test_unet_cfg_answers_equal_the_row_block_run(served):
    """npy, png (default labels and CFG scale) and, after the idle gap, npy
    again: bit for bit the one process on the ranks' row blocks."""
    got, refs = served["unet"], served["refs"]["unet"]
    assert got["health"] == {
        "status": "ok", "model_type": "unet", "image_size": [H, W],
        "conditional": True, "num_classes": 10, "max_batch": 4}
    for key in "ac":
        images = npy(got[key])
        assert images.shape == refs[key].shape and images.dtype == np.float32
        np.testing.assert_array_equal(images, refs[key])
    status, ctype, data = got["b"]
    assert status == 200 and ctype == "image/png"
    assert data == serve.png_grid(refs["b"])


def test_unet_cfg_matches_jax_sample_with_cfg(served):
    """Request a against JAX's `DDIM.sample_with_cfg` on the same weights
    and the initial noise of the service's generator seeded with the
    request's seed, at the trajectory bar."""
    ref, noise = served["unet"]["jax"]
    images = npy(served["unet"]["a"])
    assert noise.shape == (4, H, W, 3)
    assert max_rel(images, ref) <= TRAJECTORY_BAR, max_rel(images, ref)


def test_an_unconditional_model_splits_its_calls(served):
    got, refs = served["uncond"], served["refs"]["uncond"]
    assert got["health"]["conditional"] is False
    status, _, data = got["bad"]
    assert status == 400 and b"unconditional" in data
    np.testing.assert_array_equal(npy(got["a"]), refs["a"])


@pytest.mark.parametrize("name", ["dit", "latent"])
def test_dit_tome_int8_and_latent_equal_the_row_block_run(served, name):
    """The DiT with token merging and int8 products (3 rows a request, 6
    a CFG call), and the latent UNet with its decode split (2 rows) or run
    whole on each rank (3 rows): bit for bit the row-block run."""
    got, refs = served[name], served["refs"][name]
    for key in REQUESTS[name]:
        images = npy(got[key])
        assert images.shape[1:] == ((LATENT_HW, LATENT_HW, 3)
                                    if name == "latent" else (H, W, 3))
        np.testing.assert_array_equal(images, refs[key])


# ------------------------------------------------------------ the control
def test_a_400_never_leaves_rank_0(served):
    """A bad label is answered 400 before any rank hears of it: the
    worker ran the warm-up and the requests alone, and the next request
    (b) is still exact."""
    status, _, data = served["unet"]["bad"]
    assert status == 400 and b"labels" in data
    answered = sum(served["unet"][k][0] == 200 for k in REQUESTS["unet"])
    assert served["records"][1][0]["trajectories"] == 1 + answered
    assert served["unet"]["b"][2] == serve.png_grid(
        served["refs"]["unet"]["b"])


def test_max_queue_is_503_and_queued_requests_keep_their_order(served):
    """With the worker held in d's trajectory (rank 0 waits for it in the
    gather), d holds one of the 3 slots: of e, f, g sent together, one
    finds the queue full (503) and the other two queue for the lock; when
    the worker goes on, d and both queued requests are exact, so every
    rank ran them in rank 0's order."""
    got, refs = served["unet"], served["refs"]["unet"]
    assert not got["held_done_early"]
    statuses = {k: got[k][0] for k in "efg"}
    assert sorted(statuses.values()) == [200, 200, 503], statuses
    for key in "defg":
        if got[key][0] == 503:
            assert b"overloaded" in got[key][2]
            continue
        np.testing.assert_array_equal(npy(got[key]), refs[key])


def test_the_worker_waits_out_its_control_timeout(served):
    """The UNet daemon idled longer than its control timeout: the worker's
    wait on the store timed out and waited again, and c after it is
    exact."""
    assert served["unet"]["idle_seconds"] >= IDLE
    assert served["records"][1][0]["timeouts"] >= 1
    np.testing.assert_array_equal(npy(served["unet"]["c"]),
                                  served["refs"]["unet"]["c"])


def test_only_rank_0_binds_and_a_sigterm_stops_every_rank(served):
    """`python -m ...serve` on two ranks under torchrun's environment, both
    given the same --port: rank 0 alone binds and prints, its answer is the
    row-block run's, and after SIGTERM to rank 0 every rank exits 0."""
    clean = served["clean"]
    assert clean["health"]["max_batch"] == 2
    np.testing.assert_array_equal(npy(clean["a"]), served["refs"]["clean"])
    assert clean["codes"] == [0, 0], clean["logs"]
    assert "Serving on" in clean["logs"][0]
    assert "Serving on" not in clean["logs"][1], clean["logs"][1]
    # the world's four daemons each stopped by SIGTERM too, every rank
    # returning from `main`
    assert len(served["records"][0]) == len(served["records"][1]) == len(
        FLAGS)


def test_a_worker_held_at_the_stop_still_exits_0(served):
    """A worker held HOLD seconds before each store call it makes after
    reading the stop (`torch_serve_jobs.stop_held_worker`): rank 0 waits
    for the worker's last store call before it leaves with the store, so
    after SIGTERM to rank 0 every rank exits 0. With the stop's key deleted
    before the worker's last call, the worker found the store gone and
    exited 1."""
    held = served["held"]
    assert held["codes"] == [0, 0], held["logs"]
    assert "Serving on" in held["logs"][0]


def test_a_failed_worker_ends_every_rank_non_zero(served):
    """The worker's second trajectory raises while rank 0's is held (it
    learns of the failure from the store alone): the client gets a 500 or
    a refused connection, and every rank ends non-zero, none of them
    killed at the deadline."""
    failing = served["failing"]
    assert failing["status"] in (500, "RemoteDisconnected",
                                 "ConnectionResetError",
                                 "ConnectionRefusedError"), failing
    assert None not in failing["codes"], failing["logs"]
    assert all(code != 0 for code in failing["codes"]), failing["logs"]
    assert failing["seconds"] < FAILURE_SECONDS
    assert "a worker's trajectory failed" in failing["logs"][1]


def test_close_waits_for_the_watch_thread_in_a_store_call():
    """`ServingWorld.close` returns only when its watch thread has ended,
    also when that thread is inside a slow store call: a daemon thread still
    in a store call at the interpreter's exit aborted a stopped worker
    (exit -6, "terminate called without an active exception") in about one
    run of the worlds above in four. A store whose `check` takes 0.5 s holds
    the thread there while `close` is called."""
    class SlowStore:
        def check(self, keys):
            time.sleep(0.5)
            return False

    world = serve.ServingWorld.__new__(serve.ServingWorld)
    world.prefix, world.store, world.failure = "dmc_serve/1/", SlowStore(), None
    world._closed, world._failing = threading.Event(), threading.Lock()
    world._on_failure = world._watching = None
    world.watch()
    time.sleep(0.3)  # past the first WATCH_SECONDS: inside `check`
    watching = [t for t in threading.enumerate()
                if t.name == "serve-world-watch"]
    assert watching
    world.close()
    assert not any(t.is_alive() for t in watching)
