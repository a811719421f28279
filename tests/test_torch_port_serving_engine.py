"""The PyTorch port's continuous-batching engine
(`diffusion_models_collection_tpu_torch/serving_engine.py`) against the JAX
package, on the CPU, at tiny widths; the counterpart of
tests/test_serving_engine.py.

The engine runs the small UNet (and a tiny DiT and DiM, whose adaLN takes
the per-slot timestep) with the JAX package's weights through the weight
bridge, T 50 and 6 DDIM steps; each request's images are held against the
JAX `DDIM.sample_with_cfg` (or `sample`, unconditional) on the same noise,
made with numpy, and labels, at the trajectory bar max-rel 5e-4 (ROADMAP,
"How each part is held"). Staggered admissions are made deterministic by a
gate in the model: the first request's steps stop after two model calls
until the second request is queued, so the second joins a pool whose other
slots are at other timesteps.
"""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.diffusion import DDIM as JaxDDIM
from diffusion_models_collection_tpu_torch.diffusion import DDIM
from diffusion_models_collection_tpu_torch.serving_engine import (
    ContinuousBatchingEngine,
)
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    jax_dim,
    jax_dit,
    jax_unet,
    max_rel,
    one_torch_thread,
    torch_dim,
    torch_dit,
    torch_unet,
)

H = W = 16
C = 3
T = 50
STEPS = 6
TOL = 5e-4  # a whole trajectory, the bar of the port's other trajectory tests
WAIT = 120  # seconds any join or wait may take


class Models:
    """A JAX model and the port's with the same weights, built once each."""

    _built = {}

    @classmethod
    def get(cls, kind):
        if kind not in cls._built:
            build, to_torch = {
                "unet": (lambda: jax_unet(True, seed=3), torch_unet),
                "unet_uncond": (lambda: jax_unet(False, seed=3), torch_unet),
                "dit": (lambda: jax_dit(True, seed=3), torch_dit),
                "dim": (lambda: jax_dim(True, seed=3), torch_dim),
            }[kind]
            model, params, config = build()
            fn = jax.tree_util.Partial(
                lambda x, t, y: model.apply({"params": params}, x, t, y))
            cls._built[kind] = (fn, to_torch(params, config))
        return cls._built[kind]


_references = {}


def jax_reference(kind, noise, labels=None, scale=None, **ddim_kwargs):
    """The JAX DDIM trajectory of `noise` (CFG at `scale` on `labels`, or
    unguided), computed once per input."""
    key = (kind, noise.tobytes(), None if labels is None else labels.tobytes(),
           scale, tuple(sorted(ddim_kwargs.items())))
    if key not in _references:
        fn, _ = Models.get(kind)
        ddim = JaxDDIM(num_timesteps=T, num_inference_steps=STEPS,
                       **ddim_kwargs)
        if labels is None:
            out = ddim.sample(fn, noise.shape, jax.random.PRNGKey(0),
                              init_noise=jnp.asarray(noise))
        else:
            out = ddim.sample_with_cfg(
                fn, noise.shape, jnp.asarray(labels, jnp.int32),
                jax.random.PRNGKey(0), cfg_scale=scale,
                init_noise=jnp.asarray(noise))
        _references[key] = np.asarray(out)
    return _references[key]


def noise(seed, k):
    return np.random.default_rng(seed).standard_normal(
        (k, H, W, C)).astype(np.float32)


class CountingModel:
    """The port's model, counting its calls; with `gate_after`, the call
    after that many waits for `release` to be set."""

    def __init__(self, model, gate_after=None):
        self.model = model
        self.calls = 0
        self.gate_after = gate_after
        self.release = threading.Event()

    def __call__(self, x, t, y=None):
        if self.gate_after is not None and self.calls == self.gate_after:
            assert self.release.wait(WAIT), "the gate was never released"
        self.calls += 1
        return self.model(x, t, y)


def make_engine(model_fn, *, conditional=True, num_slots=4,
                steps_per_tick=1, ddim=None):
    ddim = ddim or DDIM(num_timesteps=T, num_inference_steps=STEPS)
    return ContinuousBatchingEngine(
        ddim, model_fn, image_shape=(H, W, C), num_slots=num_slots,
        conditional=conditional, steps_per_tick=steps_per_tick)


def run_staggered(engine, model, first, second):
    """Submit `first` ((noise, labels, scale)), and `second` once the first
    has taken two steps; the second is admitted while the first's slots are
    at another timestep. Returns both results."""
    results = {}

    def submit(name, request):
        results[name] = engine.submit(request[0], request[1],
                                      cfg_scale=request[2], timeout=WAIT)

    a = threading.Thread(target=submit, args=("a", first))
    a.start()
    deadline = time.monotonic() + WAIT
    while model.calls < model.gate_after and time.monotonic() < deadline:
        time.sleep(0.001)
    b = threading.Thread(target=submit, args=("b", second))
    b.start()
    # queued, or already admitted beside the first's slots
    while (not engine._pending and len(engine._inflight) == len(first[1])
           and time.monotonic() < deadline):
        time.sleep(0.001)
    model.release.set()
    a.join(WAIT)
    b.join(WAIT)
    assert not a.is_alive() and not b.is_alive()
    return results["a"], results["b"]


FIRST = (noise(2, 2), np.array([1, 2], np.int64), 1.5)
# every reference is a batch of two: one JAX compile a model
SECOND = (noise(3, 2), np.array([3, 10], np.int64), 2.5)


def test_solo_request_matches_jax_cfg():
    model = CountingModel(Models.get("unet")[1])
    engine = make_engine(model).start()
    try:
        x, labels = noise(1, 2), np.array([1, 7], np.int64)
        out = engine.submit(x, labels, cfg_scale=2.0, timeout=WAIT)
    finally:
        engine.stop()
    assert out.shape == (2, H, W, C) and out.dtype == np.float32
    assert max_rel(out, jax_reference("unet", x, labels, 2.0)) <= TOL
    assert engine.ticks == model.calls == STEPS


def test_solo_request_matches_jax_unconditional():
    model = Models.get("unet_uncond")[1]
    engine = make_engine(model, conditional=False).start()
    try:
        x = noise(0, 2)
        out = engine.submit(x, timeout=WAIT)
    finally:
        engine.stop()
    assert max_rel(out, jax_reference("unet_uncond", x)) <= TOL


@pytest.mark.parametrize("steps_per_tick", [1, 3, STEPS])
def test_staggered_admission_matches_jax(steps_per_tick):
    """Two requests admitted on different ticks, the second while the
    first's slots are mid-trajectory: mixed timesteps and CFG scales in one
    batch, each request still on its own JAX trajectory (k steps a tick;
    with k = S the first finishes before the second starts)."""
    model = CountingModel(Models.get("unet")[1], gate_after=2)
    engine = make_engine(model, num_slots=6,
                         steps_per_tick=steps_per_tick).start()
    try:
        a, b = run_staggered(engine, model, FIRST, SECOND)
    finally:
        engine.stop()
    for name, out, (x, labels, scale) in (("a", a, FIRST), ("b", b, SECOND)):
        rel = max_rel(out, jax_reference("unet", x, labels, scale))
        assert rel <= TOL, (name, rel)
    assert engine.ticks == model.calls


@pytest.mark.parametrize("kind", ["dit", "dim"])
def test_staggered_admission_matches_jax_adaln_models(kind):
    """The DiT and the DiM take the timestep through adaLN, per row."""
    model = CountingModel(Models.get(kind)[1], gate_after=2)
    engine = make_engine(model, num_slots=6).start()
    try:
        a, b = run_staggered(engine, model, FIRST, SECOND)
    finally:
        engine.stop()
    for name, out, (x, labels, scale) in (("a", a, FIRST), ("b", b, SECOND)):
        rel = max_rel(out, jax_reference(kind, x, labels, scale))
        assert rel <= TOL, (kind, name, rel)


def test_staggered_slot_matches_the_ports_pool_shaped_sampler():
    """Row independence: a request that joins a busy pool gets the images of
    the port's own `sample_with_cfg` run at the pool's shape with its noise
    in its slot's rows."""
    model = CountingModel(Models.get("unet")[1], gate_after=2)
    engine = make_engine(model, num_slots=6).start()
    try:
        _, b = run_staggered(engine, model, FIRST, SECOND)
    finally:
        engine.stop()
    # slots are taken from the end of the free list: 5, 4 for the first
    # request, then 3, 2
    slots = [3, 2]
    x, labels, scale = SECOND
    pool_x = torch.from_numpy(noise(9, 6))
    pool_y = torch.arange(1, 7)
    pool_x[slots] = torch.from_numpy(x)
    pool_y[slots] = torch.from_numpy(labels)
    ref = DDIM(num_timesteps=T, num_inference_steps=STEPS).sample_with_cfg(
        Models.get("unet")[1], pool_x.shape, pool_y, cfg_scale=scale,
        init_noise=pool_x)
    np.testing.assert_allclose(b, ref[slots].numpy(), rtol=0, atol=1e-6)


def test_slot_reuse_across_many_requests():
    """More images than slots: slots recycle and every request delivers, in
    order."""
    model = Models.get("unet_uncond")[1]
    engine = make_engine(model, conditional=False, num_slots=2).start()
    try:
        outs = [engine.submit(noise(10 + i, 2), timeout=WAIT)
                for i in range(5)]
        assert sorted(engine._free) == [0, 1]
        assert engine.ticks == 5 * STEPS
    finally:
        engine.stop()
    for i, out in enumerate(outs):
        assert max_rel(out, jax_reference("unet_uncond",
                                          noise(10 + i, 2))) <= TOL


def test_karras_grid_guidance_rescale_and_cfg_interval_match_jax():
    knobs = dict(timestep_spacing="karras", guidance_rescale=0.5,
                 cfg_interval=(5, 40))
    ddim = DDIM(num_timesteps=T, num_inference_steps=STEPS, **knobs)
    engine = make_engine(Models.get("unet")[1], ddim=ddim).start()
    try:
        x, labels = noise(4, 2), np.array([1, 2], np.int64)
        out = engine.submit(x, labels, cfg_scale=3.0, timeout=WAIT)
    finally:
        engine.stop()
    assert engine.num_steps == len(ddim.inference_timesteps)
    assert max_rel(out, jax_reference("unet", x, labels, 3.0, **knobs)) <= TOL


def test_ticks_count_steps_and_an_idle_engine_launches_nothing():
    """`ticks` counts denoising steps (model calls), not ticks: at k = 4
    over 6 steps a request takes a tick of 4 and one of 2, since the steps
    after every slot has finished would move nothing."""
    model = CountingModel(Models.get("unet")[1])
    engine = make_engine(model, steps_per_tick=4).start()
    try:
        engine.submit(noise(5, 1), np.array([3]), cfg_scale=2.0, timeout=WAIT)
        assert engine.ticks == model.calls == STEPS
        time.sleep(0.3)
        assert model.calls == STEPS
    finally:
        engine.stop()


def test_malformed_requests_are_rejected_and_the_engine_lives_on():
    engine = make_engine(Models.get("unet")[1], num_slots=2).start()
    try:
        with pytest.raises(ValueError, match=r"\[1, 2\]"):
            engine.submit(noise(0, 3))
        with pytest.raises(ValueError, match="noise must be"):
            engine.submit(np.zeros((1, 8, 8, 3), np.float32))
        with pytest.raises(ValueError, match="labels must be"):
            engine.submit(noise(0, 2), np.array([1]))
        # the engine lives on: a well-formed request still completes
        assert engine.submit(noise(0, 1), np.array([1]),
                             timeout=WAIT).shape == (1, H, W, C)
    finally:
        engine.stop()


def test_steps_per_tick_validation():
    model = Models.get("unet")[1]
    with pytest.raises(ValueError, match="steps_per_tick"):
        make_engine(model, steps_per_tick=0)
    with pytest.raises(ValueError, match="steps_per_tick"):
        make_engine(model, steps_per_tick=STEPS + 1)


def test_engine_death_fails_requests_loudly():
    """An error on the engine thread fails the waiting requests with its
    cause at once (not at their timeout), and later submits raise."""

    def broken(x, t, y=None):
        raise RuntimeError("boom")

    engine = make_engine(broken, num_slots=2).start()
    try:
        start = time.monotonic()
        with pytest.raises(RuntimeError, match="engine died.*boom"):
            engine.submit(noise(0, 1), np.array([1]), timeout=WAIT)
        assert time.monotonic() - start < WAIT / 2
        with pytest.raises(RuntimeError, match="engine is dead"):
            engine.submit(noise(1, 1), np.array([1]))
    finally:
        engine.stop()


def test_timed_out_request_is_dropped_from_the_queue():
    """A submit that times out while queued is never admitted."""
    model = CountingModel(Models.get("unet_uncond")[1], gate_after=1)
    engine = make_engine(model, conditional=False, num_slots=1).start()
    try:
        results = {}
        a = threading.Thread(target=lambda: results.setdefault(
            "a", engine.submit(noise(0, 1), timeout=WAIT)))
        a.start()
        deadline = time.monotonic() + WAIT
        while model.calls < 1 and time.monotonic() < deadline:
            time.sleep(0.001)
        with pytest.raises(TimeoutError):
            engine.submit(noise(1, 1), timeout=0.01)
        assert engine._pending == []
        model.release.set()
        a.join(WAIT)
        assert not a.is_alive() and "a" in results
        time.sleep(0.3)
        assert not engine._inflight and engine.ticks == STEPS
    finally:
        engine.stop()


def analytic_model(x, t, y=None):
    """A smooth stand-in denoiser, elementwise per row (as the JAX engine
    tests' model)."""
    c = (t.to(torch.float32) + 1.0) / T
    out = torch.tanh(x) * c.reshape(-1, 1, 1, 1) * 0.5
    return out + 0.01 * y.to(torch.float32).reshape(-1, 1, 1, 1)


def test_many_clients_stress():
    """More client threads than cores submit concurrently into a small pool,
    with the interpreter switching threads every microsecond: every request
    gets its own trajectory, every slot comes back to the free list once,
    and the steps counted are the model calls made."""
    model = CountingModel(analytic_model)
    engine = make_engine(model, num_slots=3).start()
    ddim = DDIM(num_timesteps=T, num_inference_steps=STEPS)
    # 24 requests of one or two images, labels 1-10, scales 1-1.75
    requests = [(noise(100 + i, 1 + i % 2),
                 np.array([1 + i % 10, 10 - i % 10][:1 + i % 2]),
                 1.0 + 0.25 * (i % 4)) for i in range(24)]
    results = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client(i):
            x, y, scale = requests[i]
            results[i] = engine.submit(x, y, cfg_scale=scale, timeout=WAIT)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(requests))]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(WAIT)
        assert not any(thread.is_alive() for thread in threads)
    finally:
        sys.setswitchinterval(interval)
        engine.stop()
    assert sorted(engine._free) == [0, 1, 2] and not engine._inflight
    assert engine.ticks == model.calls
    for i, (x, y, scale) in enumerate(requests):
        ref = ddim.sample_with_cfg(analytic_model, x.shape,
                                   torch.from_numpy(y), cfg_scale=scale,
                                   init_noise=torch.from_numpy(x))
        np.testing.assert_allclose(results[i], ref.numpy(), rtol=0,
                                   atol=1e-6, err_msg=f"request {i}")
