"""The PyTorch port's serving daemon, `python -m
diffusion_models_collection_tpu_torch.serve`, on the CPU; the counterpart of
tests/test_serve.py, against an in-process server on 127.0.0.1:0.

The parser is held to the root `serve.py`'s (the same flag names and
defaults, and `--device`). The batched mode's images are the port's own
`sample_with_cfg` on the request's seeded draw, bit for bit; the continuous
mode goes through the engine (tests/test_torch_port_serving_engine.py holds
it against JAX) and refuses what the root daemon refuses; `--mixed_precision
bf16` runs the bf16 model, held against JAX's bf16 and float32 trajectories
at the bar of tests/test_torch_port_bf16_models.py on the same inputs; what
the port does not have yet raises, naming its ROADMAP item.
"""

import argparse
import ast
import http.client
import io
import json
import threading
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.diffusion.ddim import DDIM as JaxDDIM
from diffusion_models_collection_tpu_torch import factory, serve
from diffusion_models_collection_tpu_torch.diffusion import ConsistencyModel
from diffusion_models_collection_tpu_torch.utils import checkpoint
from diffusion_models_collection_tpu_torch.utils.helpers import read_png
from test_torch_port_bf16_models import TRAJECTORY_BAR, check_bar
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    jax_unet,
    one_torch_thread,
    small_config,
    small_dit_config,
    torch_unet,
)

REPO = Path(__file__).resolve().parent.parent
ROOT_SERVE = REPO / "serve.py"
STEPS = 3
WAIT = 300  # seconds an HTTP call may take


def root_serve_parser() -> argparse.ArgumentParser:
    """The root daemon's parser, rebuilt from the statements of its `main()`
    up to `parse_args`: importing `serve.py` itself would import JAX's
    compile cache set-up."""
    tree = ast.parse(ROOT_SERVE.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "main")
    body = []
    for stmt in fn.body:
        if "parse_args" in ast.unparse(stmt):
            break
        body.append(stmt)
    body.append(ast.parse("result = parser").body[0])
    scope = {"argparse": argparse}
    exec(compile(ast.Module(body, []), "serve.py", "exec"), scope)
    return scope["result"]


def test_parser_matches_the_root_cli():
    ours = {a.dest: a for a in serve.build_parser()._actions}
    root = {a.dest: a for a in root_serve_parser()._actions}
    assert set(ours) == set(root) | {"device"}
    for dest, action in root.items():
        mine = ours[dest]
        assert mine.option_strings == action.option_strings, dest
        assert type(mine) is type(action), dest
        assert mine.choices == action.choices, dest
        assert mine.type == action.type, dest
        assert mine.required == action.required, dest
        assert mine.default == action.default, dest
    assert ours["device"].default == "cuda"


@pytest.fixture(scope="module")
def unet(tmp_path_factory):
    """(flax UNet, its perturbed params, config, checkpoint path): the small
    conditional UNet of the bf16 trajectory test (seed 0), saved as a .pth
    with its weights also as the EMA weights."""
    model, params, config = jax_unet(True, seed=0)
    state = torch_unet(params, config).state_dict()
    path = tmp_path_factory.mktemp("serve") / "unet.pth"
    checkpoint.save_checkpoint(path, state, config,
                               ema_model_state_dict=state)
    return model, params, config, path


def make_service(path, **kwargs):
    kwargs.setdefault("num_inference_steps", STEPS)
    return serve.SamplerService(str(path), device="cpu", use_ema=True,
                                **kwargs)


class Server:
    """`service` behind a ThreadingHTTPServer on 127.0.0.1, port 0, in a
    thread."""

    def __init__(self, service):
        self.service = service
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                         serve.make_handler(service))
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def request(self, method, path, body=None, raw=None):
        conn = http.client.HTTPConnection(*self.httpd.server_address,
                                          timeout=WAIT)
        conn.request(method, path,
                     body=raw if raw is not None else
                     (json.dumps(body) if body is not None else None))
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, resp.getheader("Content-Type"), data

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(WAIT)
        self.service.close()


@pytest.fixture(scope="module")
def server(unet):
    server = Server(make_service(unet[3], batch_size=4))
    yield server
    server.close()


def port_reference(service, labels, seed, cfg_scale):
    """The port's `sample_with_cfg` of the serving batch on the request's
    draw (labels beyond the request's are the null label 0), in [0, 1]."""
    y = np.zeros((service.batch_size,), np.int64)
    y[:len(labels)] = np.asarray(labels) + 1
    shape = (service.batch_size, *service.image_hw, service.channels)
    out = service.diffusion.sample_with_cfg(
        service.model, shape, torch.from_numpy(y),
        torch.Generator().manual_seed(seed), cfg_scale=cfg_scale)
    return np.clip((out[:len(labels)].numpy() + 1) / 2, 0, 1)


def test_healthz(server):
    status, ctype, data = server.request("GET", "/healthz")
    assert status == 200 and ctype == "application/json"
    assert json.loads(data) == {
        "status": "ok", "model_type": "unet", "image_size": [16, 16],
        "conditional": True, "num_classes": 10, "max_batch": 4}
    assert server.request("GET", "/nowhere")[0] == 404


def test_generate_npy_equals_sample_with_cfg(server):
    body = {"num_samples": 2, "labels": [0, 9], "seed": 5, "cfg_scale": 2.5,
            "format": "npy"}
    status, ctype, data = server.request("POST", "/generate", body)
    assert status == 200 and ctype == "application/octet-stream", data
    images = np.load(io.BytesIO(data))
    assert images.shape == (2, 16, 16, 3) and images.dtype == np.float32
    np.testing.assert_array_equal(
        images, port_reference(server.service, [0, 9], 5, 2.5))
    # the same seed, the same images
    again = np.load(io.BytesIO(server.request("POST", "/generate", body)[2]))
    np.testing.assert_array_equal(images, again)


def test_generate_png_is_the_grid_of_the_images(server, tmp_path):
    status, ctype, data = server.request(
        "POST", "/generate", {"num_samples": 3, "seed": 1})
    assert status == 200 and ctype == "image/png"
    (tmp_path / "grid.png").write_bytes(data)
    # the default CFG scale is the config's, else 1.8; labels 0, 1, 2
    images = port_reference(server.service, [0, 1, 2], 1, 1.8)
    np.testing.assert_array_equal(
        read_png(tmp_path / "grid.png"),
        serve.make_grid((images * 255).round().astype(np.uint8), nrow=2))


def test_default_labels_wrap_at_num_classes(unet):
    service = make_service(unet[3], batch_size=12, num_inference_steps=2)
    images = service.generate(12, seed=3)
    np.testing.assert_array_equal(
        images, port_reference(service, [i % 10 for i in range(12)], 3, 1.8))


@pytest.mark.parametrize("body,match", [
    ({"num_samples": 99}, b"num_samples"),
    ({"num_samples": 0}, b"num_samples"),
    ({"num_samples": 1, "labels": [10]}, b"labels"),
    ({"num_samples": 2, "labels": [1]}, b"labels length"),
    ({"num_samples": 1, "labels": 5}, b"list of integers"),
    ({"num_samples": 1, "labels": ["a"]}, b"list of integers"),
    ({"num_samples": "x"}, b"invalid literal"),
])
def test_invalid_requests_are_400(server, body, match):
    status, _, data = server.request("POST", "/generate", body)
    assert status == 400 and match in data, data


@pytest.mark.parametrize("raw", [b"[1, 2]", b"{not json", b'"text"'])
def test_malformed_bodies_are_400(server, raw):
    status, _, data = server.request("POST", "/generate", raw=raw)
    assert status == 400 and b"error" in data


def test_queue_cap_is_503(unet):
    """Beyond --max_queue generates in flight, the server sheds load."""
    server = Server(make_service(unet[3], batch_size=2, max_queue=1,
                                 num_inference_steps=1))
    try:
        assert server.service.try_acquire_slot()  # one generate in flight
        status, _, data = server.request("POST", "/generate",
                                         {"num_samples": 1})
        assert status == 503 and b"overloaded" in data
        server.service.release_slot()
        assert server.request("POST", "/generate",
                              {"num_samples": 1})[0] == 200
    finally:
        server.close()


def test_unconditional_model_rejects_labels_and_cfg_scale(tmp_path):
    _, params, config = jax_unet(False, seed=1)
    path = tmp_path / "uncond.pth"
    checkpoint.save_checkpoint(path, torch_unet(params, config).state_dict(),
                               config)
    server = Server(serve.SamplerService(str(path), device="cpu",
                                         num_inference_steps=2, batch_size=2))
    try:
        for body in ({"num_samples": 1, "labels": [0]},
                     {"num_samples": 1, "cfg_scale": 2.0}):
            status, _, data = server.request("POST", "/generate", body)
            assert status == 400 and b"unconditional" in data
        status, _, data = server.request(
            "POST", "/generate", {"num_samples": 1, "seed": 2,
                                  "format": "npy"})
        assert status == 200
        service = server.service
        ref = service.diffusion.sample(
            service.model, (2, 16, 16, 3), torch.Generator().manual_seed(2))
        np.testing.assert_array_equal(
            np.load(io.BytesIO(data)),
            np.clip((ref[:1].numpy() + 1) / 2, 0, 1))
    finally:
        server.close()


def test_healthz_responsive_during_generate(server, monkeypatch):
    """/healthz answers while a generate holds the generation lock: the lock
    is instrumented so that the health check runs inside the generate's
    critical section (a single-threaded server or a handler-wide lock would
    time out here)."""
    in_generate = threading.Event()
    release = threading.Event()
    real_lock = server.service._lock

    class SignallingLock:
        def __enter__(self):
            real_lock.acquire()
            in_generate.set()
            release.wait(WAIT)
            return self

        def __exit__(self, *exc):
            real_lock.release()
            return False

    monkeypatch.setattr(server.service, "_lock", SignallingLock())
    results = {}

    def generate():
        results["gen"] = server.request(
            "POST", "/generate", {"num_samples": 2, "format": "npy"})

    thread = threading.Thread(target=generate)
    thread.start()
    assert in_generate.wait(WAIT), "generate never reached the lock"
    assert server.request("GET", "/healthz")[0] == 200
    release.set()
    thread.join(WAIT)
    assert not thread.is_alive() and results["gen"][0] == 200


def test_continuous_mode_through_the_service(unet):
    """The engine's images, on the request's seeded draw, are the port's
    `sample_with_cfg` at the pool's shape with that draw in the request's
    slots (row independence); a seed gives the same images again."""
    server = Server(make_service(unet[3], batch_size=4, continuous=True,
                                 steps_per_tick=2))
    service = server.service
    try:
        body = {"num_samples": 3, "labels": [1, 4, 7], "seed": 7,
                "cfg_scale": 2.0, "format": "npy"}
        status, _, data = server.request("POST", "/generate", body)
        assert status == 200, data
        images = np.load(io.BytesIO(data))
        again = np.load(io.BytesIO(server.request("POST", "/generate",
                                                  body)[2]))
        status, _, data = server.request(
            "POST", "/generate", {"num_samples": 3, "labels": [1, 2]})
        assert status == 400 and b"labels length" in data
        assert service.engine.ticks == 2 * STEPS
    finally:
        server.close()
    np.testing.assert_array_equal(images, again)
    slots = [3, 2, 1]  # taken from the end of the free list
    pool = torch.zeros(4, 16, 16, 3)
    pool[slots] = service.initial_noise((3, 16, 16, 3), 7)
    y = torch.zeros(4, dtype=torch.int64)
    y[slots] = torch.tensor([2, 5, 8])
    ref = service.diffusion.sample_with_cfg(service.model, pool.shape, y,
                                            cfg_scale=2.0, init_noise=pool)
    np.testing.assert_allclose(
        images, np.clip((ref[slots].numpy() + 1) / 2, 0, 1), rtol=0,
        atol=1e-6)


def test_a_dead_engine_answers_500_at_once(unet):
    """A failure on the engine thread reaches the waiting request as a 500
    (not a hang until its timeout), and every later request too."""
    server = Server(make_service(unet[3], batch_size=2, continuous=True))

    def broken(x, t, y=None):
        raise RuntimeError("kernel failed")

    # the engine calls the service's model on its own thread
    server.service.model.forward = broken
    try:
        status, _, data = server.request("POST", "/generate",
                                          {"num_samples": 1})
        assert status == 500 and b"engine died" in data, data
        status, _, data = server.request("POST", "/generate",
                                         {"num_samples": 1})
        assert status == 500 and b"engine is dead" in data, data
    finally:
        server.close()


def save_config(tmp_path, name, config, state=None):
    path = tmp_path / f"{name}.pth"
    if state is None:
        torch.manual_seed(0)
        state = factory.get_model(config).state_dict()
    checkpoint.save_checkpoint(path, state, config)
    return path


@pytest.mark.parametrize("change,flags,match", [
    ({}, {"sampling_method": "dpm++"}, "sampling_method ddim"),
    ({"diffusion_type": "flow_matching"}, {}, "VP .*flow_matching"),
    ({"ddim_eta": 0.5}, {}, "eta = 0"),
])
def test_continuous_mode_rejections(unet, tmp_path, change, flags, match):
    config = dict(unet[2], **change)
    path = save_config(tmp_path, "m", config,
                       torch_unet(unet[1], unet[2]).state_dict())
    with pytest.raises(ValueError, match=match):
        serve.SamplerService(str(path), device="cpu", continuous=True,
                             **flags)


def test_bf16_serving_matches_jax_at_the_bf16_bar(unet):
    """`--mixed_precision bf16`: the batched mode's images are the bf16
    model's `sample_with_cfg`, bit for bit, and the engine's trajectory on
    the inputs of tests/test_torch_port_bf16_models.py's DDIM-10 CFG-3 case
    lies within its bar of JAX's bf16 and float32 runs, and away from the
    port's float32 run by at least half JAX's own bf16 distance."""
    model, params, config, path = unet
    batched = make_service(path, batch_size=2, num_inference_steps=10,
                           mixed_precision="bf16")
    assert batched.model.dtype == torch.bfloat16
    images = batched.generate(2, labels=[2, 7], seed=4, cfg_scale=3.0)
    np.testing.assert_array_equal(
        images, port_reference(batched, [2, 7], 4, 3.0))

    noise = np.random.default_rng(6).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    y = np.array([3, 8], np.int64)
    results = {}
    for precision in ("bf16", "none"):
        service = make_service(path, batch_size=2, num_inference_steps=10,
                               mixed_precision=precision, continuous=True)
        try:
            results[precision] = service.engine.submit(noise, y, cfg_scale=3.0,
                                                       timeout=WAIT)
        finally:
            service.close()

    def jax_run(m):
        return np.asarray(JaxDDIM(num_timesteps=1000,
                                  num_inference_steps=10).sample_with_cfg(
            jax.tree_util.Partial(
                lambda x, t, yy: m.apply({"params": params}, x, t, yy)),
            noise.shape, jnp.asarray(y, jnp.int32), jax.random.PRNGKey(0),
            cfg_scale=3.0, init_noise=jnp.asarray(noise)))

    assert results["bf16"].dtype == np.float32
    check_bar(TRAJECTORY_BAR["unet"], "unet served in bf16", results["bf16"],
              results["none"], jax_run(model.clone(dtype=jnp.bfloat16)),
              jax_run(model))


# a DiT's --tome_ratio and --quantize, which raised until they were ported,
# serve: the next test; a consistency checkpoint serves batched
# (test_consistency_checkpoints_serve_batched) and `--continuous` refuses it
@pytest.mark.parametrize("case,flags,error,match", [
    ("unet", ["--tome_ratio", "0.5"], ValueError, "DiT"),
    ("unet", ["--quantize", "int8"], ValueError, "DiT"),
    ("consistency", ["--continuous", "--sampling_method", "ddim"], ValueError,
     "requires a VP .*'consistency'"),
    ("super_resolution", [], ValueError, "super-resolution"),
])
def test_what_is_not_ported_raises(tmp_path, case, flags, error, match):
    config = {"unet": small_config(), "dit": small_dit_config(),
              "consistency": dict(small_config(),
                                  diffusion_type="consistency"),
              "super_resolution": dict(small_config(),
                                       super_resolution=True)}[case]
    state = (factory.get_model(small_config()).state_dict()
             if case in ("super_resolution", "consistency") else None)
    path = save_config(tmp_path, case, config, state)
    with pytest.raises(error, match=match):
        serve.main(["--checkpoint", str(path), "--device", "cpu", *flags])


def test_consistency_checkpoints_serve_batched(unet, tmp_path):
    """A consistency checkpoint of the small UNet's weights serves in the
    batched mode with its own sampler at its step count (a request's
    `num_inference_steps` is the daemon's flag, 1 here): the images are the
    port's `sample_with_cfg` of the serving batch on the request's draw."""
    state = torch.load(unet[3], weights_only=True)["model_state_dict"]
    path = save_config(tmp_path, "consistency",
                       dict(unet[2], diffusion_type="consistency",
                            num_inference_steps=2), state)
    for steps in (None, 1):
        server = Server(make_service(path, batch_size=2,
                                     num_inference_steps=steps))
        try:
            service = server.service
            assert isinstance(service.diffusion, ConsistencyModel)
            assert service.diffusion.num_inference_steps == (steps or 2)
            body = {"num_samples": 2, "labels": [1, 7], "seed": 3,
                    "cfg_scale": 2.0, "format": "npy"}
            status, _, data = server.request("POST", "/generate", body)
            assert status == 200, data
            np.testing.assert_array_equal(
                np.load(io.BytesIO(data)),
                port_reference(service, [1, 7], 3, 2.0))
        finally:
            server.close()


@pytest.mark.parametrize("knobs,continuous", [
    (dict(tome_ratio=0.5), False),
    (dict(quantize="int8"), False),
    (dict(quantize="int8", tome_ratio=0.5, tome_mlp=True), True),
])
def test_tome_and_int8_serve_a_dit(tmp_path, knobs, continuous):
    """A DiT served with token merging, int8 products or both (composed, as
    the root daemon composes them): the service's model carries the fields,
    and a request's images are the port's `sample_with_cfg` of that model on
    the request's draw (in the continuous engine, at the pool's shape)."""
    path = save_config(tmp_path, "dit", small_dit_config())
    server = Server(make_service(path, batch_size=2, continuous=continuous,
                                 **knobs))
    service = server.service
    try:
        body = {"num_samples": 2, "labels": [3, 8], "seed": 4,
                "cfg_scale": 2.0, "format": "npy"}
        status, _, data = server.request("POST", "/generate", body)
        assert status == 200, data
    finally:
        server.close()
    images = np.load(io.BytesIO(data))
    assert service.model.quant == knobs.get("quantize")
    assert (service.model.tome is not None) == ("tome_ratio" in knobs)
    if continuous:
        slots = [1, 0]  # taken from the end of the free list
        pool = torch.zeros(2, 16, 16, 3)
        pool[slots] = service.initial_noise((2, 16, 16, 3), 4)
        y = torch.zeros(2, dtype=torch.int64)
        y[slots] = torch.tensor([4, 9])
        ref = service.diffusion.sample_with_cfg(
            service.model, pool.shape, y, cfg_scale=2.0, init_noise=pool)
        np.testing.assert_allclose(
            images, np.clip((ref[slots].numpy() + 1) / 2, 0, 1), rtol=0,
            atol=1e-6)
    else:
        np.testing.assert_array_equal(
            images, port_reference(service, [3, 8], 4, 2.0))


def test_device_cuda_raises_where_cuda_is_absent(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--checkpoint", str(tmp_path / "none.pth")])


def test_main_warms_up_serves_and_stops_the_engine(unet, monkeypatch):
    """`main` end to end in continuous mode: warm-up, a server on the given
    address answering /healthz and /generate, and the engine stopped when
    the server returns."""
    answers = []

    class OneShotServer(ThreadingHTTPServer):
        def serve_forever(self, poll_interval=0.5):
            thread = threading.Thread(target=super().serve_forever)
            thread.start()
            client = Server.__new__(Server)
            client.httpd = self
            answers.append(client.request("GET", "/healthz")[0])
            answers.append(client.request(
                "POST", "/generate", {"num_samples": 2, "format": "npy"})[0])
            self.shutdown()
            thread.join(WAIT)

    stopped = []
    monkeypatch.setattr(serve, "ThreadingHTTPServer", OneShotServer)
    monkeypatch.setattr(serve.SamplerService, "close",
                        lambda self: stopped.append(self.engine.ticks)
                        or self.engine.stop())
    serve.main(["--checkpoint", str(unet[3]), "--device", "cpu", "--port",
                "0", "--continuous", "--batch_size", "2",
                "--num_inference_steps", str(STEPS)])
    assert answers == [200, 200]
    # the warm-up's request and the served one, STEPS steps each
    assert stopped == [2 * STEPS]
