"""The port's sequence parallelism of the DiM
(`parallel/dim_sequence_parallel.py`) and the scan form it runs on (E4: a
scan that takes and returns a state), against the JAX package and against
the port's own one-device step, on the CPU.

The JAX side runs on its virtual CPU devices (`tests/conftest.py`): its
`selective_scan_with_state`, `selective_scan_xla(..., chunk_size=)`,
`distributed_selective_scan` and `make_dim_sequence_parallel_apply` step
(`torch_parallel_helpers.jax_sp_steps`). The port runs in one gloo world of
four processes for the whole file (`torch_parallel_jobs.py`, importing no
JAX). Bars: 2e-5 relative for the scans' outputs and 1e-4 for their
gradients against JAX (the port's scan bars: the same math in another
association); the trainer bars of `torch_parallel_helpers.py`.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from diffusion_models_collection_tpu.models import DiM as JaxDiM
from diffusion_models_collection_tpu.parallel.dim_sequence_parallel import (
    data_seq_mesh,
    distributed_selective_scan as jax_distributed_scan,
)
from diffusion_models_collection_tpu_torch.factory import get_model
from diffusion_models_collection_tpu_torch.parallel.dim_sequence_parallel \
    import CONV_HALO, affine_combine
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from torch_parallel_helpers import (
    check_against_jax,
    check_against_one_device,
    jax_sp_steps,
    max_rel,
    numpy_state,
    run_world,
    train_config,
)
from torch_parallel_jobs import batches, train_job
from torch_port_helpers import (  # noqa: F401 (autouse: one torch thread)
    one_torch_thread,
    perturbed,
    small_dim_config,
)

jax_ss = importlib.import_module(
    "diffusion_models_collection_tpu.ops.selective_scan")
ss = importlib.import_module(
    "diffusion_models_collection_tpu_torch.ops.selective_scan")

TOL_Y = 2e-5
TOL_GRAD = 1e-4
# hidden 32: d_inner 64 (the JAX sequence-parallel scan is XLA's anyway)
DIM_SP_PARAMS = dict(patch_size=2, in_channels=3, hidden_size=32, depth=2,
                     state_size=8, mlp_ratio=4.0, dropout=0.1)


def scan_inputs(batch, length, d_inner, n, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((batch, length, d_inner)).astype(np.float32),
        dt=rng.uniform(0.01, 0.2, (batch, length, d_inner)).astype(
            np.float32),
        A=-rng.uniform(0.5, 2.0, (d_inner, n)).astype(np.float32),
        B=rng.standard_normal((batch, length, n)).astype(np.float32),
        C=rng.standard_normal((batch, length, n)).astype(np.float32),
        D=rng.standard_normal((d_inner,)).astype(np.float32),
        h=rng.standard_normal((batch, d_inner, n)).astype(np.float32),
        gy=rng.standard_normal((batch, length, d_inner)).astype(np.float32),
        gh=rng.standard_normal((batch, d_inner, n)).astype(np.float32))


# ------------------------------------------------------------------- E4
@pytest.mark.parametrize("shape", [(2, 6, 3, 2), (2, 16, 8, 4),
                                   (1, 40, 24, 5)])
def test_scan_with_state_matches_jax(shape):
    """y and h_out of the stated scan from h_in, and the gradients of x,
    dt, A, B, C and h_in under cotangents on both y and h_out, against JAX
    `selective_scan_with_state` (L 40: a ragged last time block). The
    state-only form gives the same h_out and gradients under a cotangent
    on h_out alone."""
    a = scan_inputs(*shape)
    names = ("x", "dt", "A", "B", "C", "h")
    jargs = [jnp.asarray(a[k]) for k in names]
    cotangents = (jnp.asarray(a["gy"]), jnp.asarray(a["gh"]))

    @jax.jit
    def jax_side(*z):
        out, vjp = jax.vjp(jax_ss.selective_scan_with_state, *z)
        # the state-only cotangent: h_out's alone
        return out, vjp(cotangents), vjp((jnp.zeros_like(out[0]),
                                          cotangents[1]))

    (y_j, h_j), grads_j, grads_h = jax_side(*jargs)
    ts = [torch.tensor(a[k], requires_grad=True) for k in names]
    y, h_out = ss.selective_scan_with_state(*ts)
    torch.autograd.backward((y, h_out), (torch.as_tensor(a["gy"]),
                                         torch.as_tensor(a["gh"])))
    assert max_rel(y, np.asarray(y_j)) <= TOL_Y
    assert max_rel(h_out, np.asarray(h_j)) <= TOL_Y
    for t, g in zip(ts, grads_j):
        assert max_rel(t.grad, np.asarray(g)) <= TOL_GRAD

    ts = [torch.tensor(a[k], requires_grad=True) for k in names]
    h_end = ss.selective_scan_end_state(*ts)
    h_end.backward(torch.as_tensor(a["gh"]))
    assert max_rel(h_end, np.asarray(h_j)) <= TOL_Y
    for name, t, g in zip(names, ts, grads_h):
        if name == "C":  # y is not formed: C gets no gradient
            assert not t.grad.abs().max()
        else:
            assert max_rel(t.grad, np.asarray(g)) <= TOL_GRAD


@pytest.mark.parametrize("chunk", [4, 8, 20])
def test_chunk_size_matches_jax_and_the_whole_scan(chunk):
    """`chunk_size` scans the chunks in turn through the stated scan: the
    output and gradients of JAX `selective_scan_xla(..., chunk_size=)`, and
    the port's unchunked scan to float rounding."""
    a = scan_inputs(2, 40, 16, 4, seed=1)
    names = ("x", "dt", "A", "B", "C", "D")
    jargs = [jnp.asarray(a[k]) for k in names]

    @jax.jit
    def jax_side(*z):
        y, vjp = jax.vjp(
            lambda *w: jax_ss.selective_scan_xla(*w, chunk_size=chunk), *z)
        return y, vjp(jnp.asarray(a["gy"]))

    y_j, grads_j = jax_side(*jargs)
    ts = [torch.tensor(a[k], requires_grad=True) for k in names]
    y = ss.selective_scan(*ts[:5], ts[5], chunk_size=chunk)
    y.backward(torch.as_tensor(a["gy"]))
    assert max_rel(y, np.asarray(y_j)) <= TOL_Y
    for t, g in zip(ts, grads_j):
        assert max_rel(t.grad, np.asarray(g)) <= TOL_GRAD
    whole = ss.selective_scan(*(torch.as_tensor(a[k]) for k in names[:5]),
                              torch.as_tensor(a["D"]))
    assert max_rel(y.detach(), whole) <= TOL_Y
    with pytest.raises(ValueError, match="must divide chunk_size"):
        ss.selective_scan(*(torch.as_tensor(a[k]) for k in names[:5]),
                          chunk_size=7)


def test_affine_combine_is_the_jax_combine():
    rng = np.random.default_rng(2)
    pairs = [tuple(rng.standard_normal(3).astype(np.float32)
                   for _ in range(2)) for _ in range(2)]
    got = affine_combine(*[tuple(map(torch.as_tensor, p)) for p in pairs])
    want = jax_ss._affine_combine(*[tuple(map(jnp.asarray, p))
                                    for p in pairs])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# ------------------------------------------------------------ the world
def jax_dim(conditional, size=16, seed=3):
    model = JaxDiM(img_size=(size, size), **DIM_SP_PARAMS,
                   num_classes=10 if conditional else None)
    y = jnp.zeros((1,), jnp.int32) if conditional else None
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, size, size, 3)),
                        jnp.zeros((1,), jnp.int32), y)["params"]
    config = dict(small_dim_config(conditional),
                  model_params=dict(DIM_SP_PARAMS, img_size=(size, size)))
    return model, perturbed(params, seed), config


def halo_setup(tmp):
    """A DiM of 12 tokens (6 x 8 pixels, patch 2): at sequence_parallel 4,
    each rank holds exactly CONV_HALO tokens. Weights from the port's
    init, perturbed (numpy seed) so the adaLN-Zero layers carry signal."""
    size = (6, 8)
    config = dict(small_dim_config(True),
                  model_params=dict(DIM_SP_PARAMS, img_size=size),
                  image_size=size)
    torch.manual_seed(0)
    rng = np.random.default_rng(4)
    state = {k: v.numpy() + 0.05 * rng.standard_normal(v.shape).astype(
        np.float32) for k, v in get_model(config).state_dict().items()}
    return dict(state=state, config=train_config(config, tmp / "halo"))


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dimsp")
    out = {"data": batches(5, 2, (4, 16, 16, 3)),
           "halo_data": batches(6, 2, (4, 6, 8, 3)), "tmp": tmp,
           "halo": halo_setup(tmp),
           "scan": {s: scan_inputs(2, 16, 8, 4, seed=s) for s in (2, 4)}}
    for name, conditional in (("dim", True), ("uncond", False)):
        model, params, cfg = jax_dim(conditional)
        out[name] = dict(model=model, params=params,
                         state=numpy_state(state_dict_from_jax(params, cfg)),
                         config=train_config(cfg, tmp / name))
    return out


def job(setup, data, dropout=True, **changes):
    config = dict(setup["config"], **changes)
    if not dropout:
        config = dict(config, model_params=dict(config["model_params"],
                                                dropout=0.0))
    return dict(config=config, state=setup["state"], batches=data, seed=11)


def one_device(j):
    config = {k: v for k, v in j["config"].items()
              if k not in ("sequence_parallel", "tensor_parallel")}
    return train_job(dict(j, config=config))


@pytest.fixture(scope="module")
def world4(setups):
    data = setups["data"]
    d, u = setups["dim"], setups["uncond"]
    jobs = {
        "jax": job(d, data, False, sequence_parallel=2),
        "uncond_jax": job(u, data, False, sequence_parallel=2),
        "sptp_jax": job(d, data, False, sequence_parallel=2,
                        tensor_parallel=2),
        "sp2": job(d, data, sequence_parallel=2),
        "remat": job(d, data, sequence_parallel=2, remat=True),
        "sptp": job(d, data, sequence_parallel=2, tensor_parallel=2),
        "halo": job(setups["halo"], setups["halo_data"],
                    sequence_parallel=4),
    }
    scans = [dict(setups["scan"][s], kind="scan", sp=s) for s in (2, 4)]
    results = run_world(4, list(jobs.values()) + scans)
    return jobs, dict(zip(jobs, results)), dict(zip((2, 4), results[-2:]))


@pytest.mark.parametrize("sp", [2, 4])
def test_distributed_scan_matches_jax(setups, world4, sp):
    """The distributed scan over S seq ranks (the halves of the world at S
    2): y and the gradients of x, dt, A, B, C, D under a cotangent of y,
    against JAX `distributed_selective_scan` over a (1, S) mesh."""
    a = setups["scan"][sp]
    names = ("x", "dt", "A", "B", "C", "D")
    fn = jax.shard_map(
        lambda *z: jax_distributed_scan(*z, axis="seq"),
        mesh=data_seq_mesh(1, sp, jax.devices()[:sp]),
        in_specs=(P(None, "seq"), P(None, "seq"), P(), P(None, "seq"),
                  P(None, "seq"), P()),
        out_specs=P(None, "seq"), check_vma=False)
    args = [jnp.asarray(a[k]) for k in names]
    gy = jnp.asarray(a["gy"])
    y_j = jax.jit(fn)(*args)
    grads_j = jax.jit(jax.grad(lambda *z: jnp.sum(fn(*z) * gy),
                               argnums=tuple(range(6))))(*args)
    got = world4[2][sp]
    assert max_rel(got["y"], np.asarray(y_j)) <= TOL_Y
    for name, g in zip(names, grads_j):
        assert max_rel(got[name], np.asarray(g)) <= TOL_GRAD, name


@pytest.mark.parametrize("name,dp,sp,tp", [
    ("jax", 2, 2, 1), ("uncond_jax", 2, 2, 1), ("sptp_jax", 1, 2, 2)])
def test_dim_sp_step_matches_the_jax_sequence_parallel_step(
        setups, world4, name, dp, sp, tp):
    """(2 data, 2 seq), unconditional too, and (1 data, 2 seq, 2 model)
    against the JAX package's `make_dim_sequence_parallel_apply` step on
    the same mesh: losses and parameters after two steps at 2e-4."""
    jobs, results, _ = world4
    s = setups["uncond" if name.startswith("uncond") else "dim"]
    config = jobs[name]["config"]
    losses, params = jax_sp_steps(s["model"], s["params"], config,
                                  setups["data"], dp=dp, sp=sp, tp=tp)
    check_against_jax(results[name], losses, params, config)


@pytest.mark.parametrize("name", ["sp2", "remat", "sptp", "halo"])
def test_dim_sp_step_with_dropout_is_the_one_device_step(world4, name):
    """With dropout 0.1 (the feed-forward's masks drawn over the global
    tokens), each layout's two steps are the one-device steps: under remat,
    under SP x TP, and at 12 tokens over 4 ranks, where a rank's tokens are
    exactly the conv's halo (its halo is all of its left neighbour's
    tokens, and the last rank's halo gradient goes to rank 2)."""
    jobs, results, _ = world4
    assert jobs["halo"]["config"]["image_size"] == (6, 8)
    assert 6 * 8 // 4 // 4 == CONV_HALO
    check_against_one_device(results[name], one_device(jobs[name]))
