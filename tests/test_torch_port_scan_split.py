"""The port's last three scan ops against the JAX package's, on the CPU:
the backward with no saved states (K7) and the time-split forward and
backward (K9, K10).

The JAX side runs its Pallas kernels in interpret mode, each call jitted and
waited for (`run_pallas_interpreted`); the port's wrappers run their plain
versions on CPU tensors, which for K9 and K10 do the split arithmetic
(chunks scanned from zero, a serial carry, the chunks completed), so the
split algorithm itself is held against the JAX grid kernels. Inputs come
from numpy with a fixed seed. Max-rel is max|port - jax| / max|jax|: 2e-5
on the forward (float32, the same recurrence, the chunk's decay as exp(A *
sum dt) instead of a product), 1e-4 on the gradients (the adjoint sums over
L steps and over D).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.ops import selective_scan_pallas as ssp
from diffusion_models_collection_tpu.ops.selective_scan import (
    selective_scan_sequential as jax_sequential,
)
from diffusion_models_collection_tpu_torch.ops import selective_scan as ss
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    max_rel,
    one_torch_thread,
    record_scan_calls,
    run_pallas_interpreted,
)

TOL_FWD = 2e-5
TOL_BWD = 1e-4
GRADS = ("dx", "ddt", "dA", "dB", "dC")
# (batch, L, D, N): L 64 is two time blocks, L 512 sixteen (the least that
# the split rules take); the JAX kernels take L % 16 == 0 only
SHAPES = [(2, 64, 128, 16), (2, 512, 128, 16), (1, 96, 256, 16)]


def scan_inputs(batch, length, d_inner, n_state, seed=0):
    """x, dt > 0 (mostly below 1), A < 0, B, C and an output gradient g."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, length, d_inner)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal(x.shape) - 2)).astype(np.float32)
    A = -np.exp(rng.standard_normal((d_inner, n_state))).astype(np.float32)
    B, C = (rng.standard_normal((batch, length, n_state)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal(x.shape).astype(np.float32)
    return x, dt, A, B, C, g


def torch_args(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def assert_grads_close(ours, refs, tol=TOL_BWD):
    for name, o, r in zip(GRADS, ours, refs):
        assert tuple(o.shape) == tuple(r.shape), name
        assert max_rel(o, r) <= tol, (name, max_rel(o, r))


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_without_states_matches_the_pallas_kernel(shape):
    x, dt, A, B, C, g = scan_inputs(*shape, seed=1)
    refs = run_pallas_interpreted(ssp.selective_scan_bwd_pallas, x, dt, A, B,
                                  C, g)
    ours = ss.selective_scan_bwd_nostate(*torch_args(x, dt, A, B, C, g))
    assert_grads_close(ours, refs)


@pytest.mark.parametrize("shape", SHAPES)
def test_split_forward_matches_the_pallas_grid_kernel(shape):
    x, dt, A, B, C, _ = scan_inputs(*shape, seed=2)
    y_ref, bound_ref = run_pallas_interpreted(
        ssp.selective_scan_fwd_ckpt_pallas_grid, x, dt, A, B, C)
    y, bound = ss.selective_scan_fwd_split(*torch_args(x, dt, A, B, C))
    assert tuple(bound.shape) == tuple(bound_ref.shape) == (
        shape[0], shape[1] // ss.t_block_for(shape[1]), shape[3], shape[2])
    assert max_rel(y, y_ref) <= TOL_FWD
    assert max_rel(bound, bound_ref) <= TOL_FWD


@pytest.mark.parametrize("shape", SHAPES)
def test_split_backward_matches_the_pallas_grid_kernel(shape):
    x, dt, A, B, C, g = scan_inputs(*shape, seed=3)
    _, bound = run_pallas_interpreted(
        ssp.selective_scan_fwd_ckpt_pallas_grid, x, dt, A, B, C)
    refs = run_pallas_interpreted(
        ssp.selective_scan_bwd_from_ckpt_pallas_grid, x, dt, A, B, C, g, bound)
    ours = ss.selective_scan_bwd_split(*torch_args(x, dt, A, B, C, g, bound))
    assert_grads_close(ours, refs)


@pytest.mark.parametrize("chunk_blocks", [1, 2, 3, 8])
@pytest.mark.parametrize("length", [64, 100, 1000])
def test_split_plain_versions_agree_with_the_unsplit_ones(
        length, chunk_blocks, monkeypatch):
    """Any chunking gives the function of the unsplit versions, ragged last
    block and ragged last chunk included."""
    for rule in ("fwd_chunk_blocks", "bwd_chunk_blocks"):
        monkeypatch.setattr(ss, rule, lambda *shape: chunk_blocks)
    args = torch_args(*scan_inputs(2, length, 24, 4, seed=4))
    x, dt, A, B, C, g = args
    y_ref, bound_ref = ss.selective_scan_fwd_ref(x, dt, A, B, C, True)
    y, bound = ss.selective_scan_fwd_split_ref(x, dt, A, B, C)
    assert max_rel(y, y_ref) <= TOL_FWD and max_rel(bound, bound_ref) <= TOL_FWD
    refs = ss.selective_scan_bwd_ref(*args, bound_ref)
    ours = ss.selective_scan_bwd_split_ref(*args, bound_ref)
    assert_grads_close(ours, refs)


# L 100 and 1000: a ragged last time block (and at 1000 a ragged last chunk);
# 1024: whole blocks of 32 steps; the chunks are `fwd_chunk_blocks`'s own
@pytest.mark.parametrize("batch,length,d_inner,n_state", [
    (2, 100, 8, 4), (1, 1000, 8, 4), (2, 1024, 8, 4), (3, 1024, 6, 16),
    (48, 1024, 2, 3)])
def test_split_plain_forward_matches_sequential_and_jax_at_long_lengths(
        batch, length, d_inner, n_state):
    arrays = scan_inputs(batch, length, d_inner, n_state, seed=length)[:5]
    args = torch_args(*arrays)
    y, bound = ss.selective_scan_fwd_split_ref(*args)
    assert bound.shape == (batch, len(ss._blocks(length)), n_state, d_inner)
    assert max_rel(y, ss.selective_scan_sequential(*args)) <= TOL_FWD
    assert max_rel(y, jax_sequential(*map(jnp.asarray, arrays))) <= TOL_FWD
    y_whole, bound_whole = ss.selective_scan_fwd_ref(*args, True)
    assert max_rel(y, y_whole) <= TOL_FWD
    assert max_rel(bound, bound_whole) <= TOL_FWD


@pytest.mark.parametrize("length", [64, 512, 100])
@pytest.mark.parametrize("route", ["nostate", "split"])
def test_grads_match_jax_grad_of_the_sequential_scan(route, length):
    x, dt, A, B, C, g = scan_inputs(2, length, 16, 4, seed=5)
    y_ref = jax_sequential(*map(jnp.asarray, (x, dt, A, B, C)))
    refs = jax.grad(
        lambda *a: jnp.sum(jax_sequential(*a) * g), argnums=(0, 1, 2, 3, 4))(
            *map(jnp.asarray, (x, dt, A, B, C)))
    args = torch_args(x, dt, A, B, C)
    if route == "nostate":
        y, _ = ss.selective_scan_fwd(*args)
        ours = ss.selective_scan_bwd_nostate(*args, torch.from_numpy(g))
    else:
        y, bound = ss.selective_scan_fwd_split(*args)
        ours = ss.selective_scan_bwd_split(*args, torch.from_numpy(g), bound)
    assert max_rel(y, y_ref) <= TOL_FWD
    assert_grads_close(ours, refs)


@pytest.mark.parametrize("length", [64, 512, 100])
@pytest.mark.parametrize("save_states", [True, False])
def test_selective_scan_grads_match_autograd_of_sequential(save_states, length):
    """The entry point under autograd, states saved (K6/K8, or K9/K10 at
    L 512) and not (K5/K7), against autograd through the O(L) reference."""
    x, dt, A, B, C, g = scan_inputs(2, length, 128, 4, seed=6)
    D = np.linspace(0.5, 1.5, 128).astype(np.float32)

    def run(fn, **kwargs):
        leaves = [t.requires_grad_()
                  for t in torch_args(x, dt, np.log(-A), B, C, D)]
        xx, dtt, al, bb, cc, dd = leaves
        y = fn(xx, dtt, -torch.exp(al), bb, cc, dd, **kwargs)
        return y.detach(), torch.autograd.grad(y, leaves, torch.from_numpy(g))

    y, grads = run(ss.selective_scan, save_states=save_states)
    y_ref, grads_ref = run(ss.selective_scan_sequential)
    assert max_rel(y, y_ref) <= TOL_FWD
    for name, o, r in zip(("x", "dt", "A_log", "B", "C", "D"), grads,
                          grads_ref):
        assert o.abs().max() > 0, name
        assert max_rel(o, r) <= TOL_BWD, (name, max_rel(o, r))


@pytest.mark.parametrize("rule,shape,expected", [
    # the forward (K9 rather than K6): at least 16 time blocks and three
    # chunks, so at most 264 (row, 64-channel) tiles
    ("split_forward", (128, 256, 768), False),  # CIFAR training: 8 blocks
    ("split_forward", (160, 256, 768), False),
    ("split_forward", (16, 1024, 768), True),   # the 64x64 DiM at batch 16
    ("split_forward", (1, 1024, 768), True),
    ("split_forward", (22, 1024, 768), True),   # 264 tiles: three chunks
    ("split_forward", (23, 1024, 768), False),  # 276: two
    ("split_forward", (128, 1024, 768), False),
    ("split_forward", (16, 512, 768), True),    # 16 time blocks, the least
    ("split_forward", (16, 480, 768), False),   # 15
    ("split_forward", (16, 250, 768), True),    # T = 16: 16 blocks
    ("split_forward", (264, 512, 64), True),    # one tile a row
    ("split_forward", (265, 512, 64), False),
    ("split_forward", (2, 512, 128), True),
    # the backward (K10 rather than K8): at least 16 time blocks and at most
    # 48 (row, 128-channel) tiles
    ("split_backward", (128, 256, 768), False),
    ("split_backward", (16, 1024, 768), False),  # the 64x64 DiM: K8
    ("split_backward", (8, 1024, 768), True),    # 48 tiles, the most
    ("split_backward", (9, 1024, 768), False),
    ("split_backward", (1, 1024, 768), True),
    ("split_backward", (48, 512, 100), True),   # D below one tile takes one
    ("split_backward", (49, 512, 100), False),
    ("split_backward", (2, 480, 768), False),   # 15 time blocks
    ("split_backward", (2, 250, 768), True),
])
def test_time_split_is_a_function_of_the_shape(rule, shape, expected):
    assert getattr(ss, rule)(*shape) is expected


@pytest.mark.parametrize("rule,shape,expected", [
    # the forward: the most chunks for which each launch's (chunks - 1) x
    # (row, 64-channel) tiles fit four thread blocks an SM (528)
    ("fwd_chunk_blocks", (16, 1024, 768), 11),
    ("fwd_chunk_blocks", (1, 1024, 768), 1),
    ("fwd_chunk_blocks", (2, 1024, 768), 2),
    ("fwd_chunk_blocks", (4, 1024, 768), 3),
    ("fwd_chunk_blocks", (8, 1024, 768), 6),
    ("fwd_chunk_blocks", (32, 1024, 768), 16),
    ("fwd_chunk_blocks", (64, 1024, 768), 32),
    ("fwd_chunk_blocks", (16, 512, 768), 6),
    # the backward: 8, halved while under four thread blocks an SM
    ("bwd_chunk_blocks", (16, 1024, 768), 4),
    ("bwd_chunk_blocks", (2, 1024, 768), 1),
    ("bwd_chunk_blocks", (44, 1024, 768), 8),
    ("bwd_chunk_blocks", (4, 1024, 768), 1),
    ("bwd_chunk_blocks", (8, 1024, 768), 2),
    ("bwd_chunk_blocks", (16, 512, 768), 2)
])
def test_chunk_blocks_keep_four_thread_blocks_an_sm(rule, shape, expected):
    assert getattr(ss, rule)(*shape) == expected
    if rule == "fwd_chunk_blocks":
        batch, length, d_inner = shape
        chunks = -(-len(ss._blocks(length)) // expected)
        assert (chunks - 1) * batch * -(-d_inner // 64) <= 528


BRANCHES = [
    # (batch, L, D), save_states -> the wrappers called, in order
    ((2, 64, 128), True, [("selective_scan_fwd", True),
                          ("selective_scan_bwd",)]),
    ((2, 512, 128), True, [("selective_scan_fwd_split",),
                           ("selective_scan_bwd_split",)]),
    # the forward time-split and the backward not, K8 from K9's states
    ((56, 512, 32), True, [("selective_scan_fwd_split",),
                           ("selective_scan_bwd",)]),
    ((2, 64, 128), False, [("selective_scan_fwd", False),
                           ("selective_scan_bwd_nostate",)]),
    ((2, 512, 128), False, [("selective_scan_fwd", False),
                            ("selective_scan_bwd_nostate",)]),
]


@pytest.mark.parametrize("suffix,entry", [("", ss.selective_scan),
                                          ("_ref", ss.selective_scan_ref)])
@pytest.mark.parametrize("shape,save_states,expected", BRANCHES)
def test_selective_scan_takes_each_branch(monkeypatch, shape, save_states,
                                          expected, suffix, entry):
    calls = record_scan_calls(monkeypatch, suffix)
    x, dt, A, B, C, _ = torch_args(*scan_inputs(*shape, 4, seed=7))
    x.requires_grad_()
    y = entry(x, dt, A, B, C, save_states=save_states)
    y.sum().backward()
    # the plain version without states goes on to call the plain forward
    # and backward itself: only what the Function called first counts
    assert calls[:2] == expected
    assert len(calls) == (4 if suffix and not save_states else 2)
    assert x.grad.abs().max() > 0


def test_no_states_are_saved_without_a_gradient(monkeypatch):
    calls = record_scan_calls(monkeypatch)
    x, dt, A, B, C, _ = torch_args(*scan_inputs(2, 512, 128, 4, seed=8))
    ss.selective_scan(x, dt, A, B, C)
    x.requires_grad_()
    with torch.no_grad():
        ss.selective_scan(x, dt, A, B, C)
    assert calls == [("selective_scan_fwd", False)] * 2


def test_cpu_wrappers_run_the_plain_versions_and_count_no_launch():
    def counts():
        return (ss.FWD_LAUNCHES, ss.FWD_STATES_LAUNCHES, ss.BWD_LAUNCHES,
                ss.BWD_NOSTATE_LAUNCHES, ss.FWD_SPLIT_LAUNCHES,
                ss.BWD_SPLIT_LAUNCHES)

    before = counts()
    x, dt, A, B, C, g = torch_args(*scan_inputs(2, 100, 8, 4, seed=9))
    y, bound = ss.selective_scan_fwd_split(x, dt, A, B, C)
    y_ref, bound_ref = ss.selective_scan_fwd_split_ref(x, dt, A, B, C)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    torch.testing.assert_close(bound, bound_ref, rtol=0, atol=0)
    pairs = [(ss.selective_scan_bwd_split(x, dt, A, B, C, g, bound),
              ss.selective_scan_bwd_split_ref(x, dt, A, B, C, g, bound)),
             (ss.selective_scan_bwd_nostate(x, dt, A, B, C, g),
              ss.selective_scan_bwd_nostate_ref(x, dt, A, B, C, g))]
    for ours, refs in pairs:
        for o, r in zip(ours, refs):
            torch.testing.assert_close(o, r, rtol=0, atol=0)
    assert counts() == before


@pytest.mark.parametrize("op", ["fwd_split", "bwd_split", "bwd_nostate"])
@pytest.mark.parametrize("case", ["float64", "strided", "A", "B", "state",
                                  "g", "bound"])
def test_wrappers_reject_what_the_kernels_do_not_take(op, case):
    x, dt, A, B, C, g = torch_args(*scan_inputs(2, 16, 8, 4))
    bound = torch.zeros(2, 1, 4, 8)
    if case == "float64":
        x = x.double()
    elif case == "strided":
        dt = dt.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "A":
        A = torch.zeros(9, 4)
    elif case == "B":
        B = torch.zeros(2, 16, 5)
    elif case == "state":
        A, B, C = torch.zeros(8, 33), torch.zeros(2, 16, 33), torch.zeros(
            2, 16, 33)
        bound = torch.zeros(2, 1, 33, 8)
    elif case == "g":
        g = torch.zeros(2, 15, 8)
    else:
        bound = torch.zeros(2, 2, 4, 8)
    args = {"fwd_split": (x, dt, A, B, C),
            "bwd_split": (x, dt, A, B, C, g, bound),
            "bwd_nostate": (x, dt, A, B, C, g)}[op]
    if (op == "fwd_split" and case in ("g", "bound")) or (
            op == "bwd_nostate" and case == "bound"):
        getattr(ss, "selective_scan_" + op)(*args)  # not an input of this op
        return
    if case == "state":
        # more than STATE_CHUNK states: the card's kernels walk them in
        # chunks; the plain versions on the CPU take any state size whole
        assert A.shape[1] > ss.STATE_CHUNK
        outs = getattr(ss, "selective_scan_" + op)(*args)
        assert outs[0].shape == x.shape
        return
    with pytest.raises((ValueError, TypeError)):
        getattr(ss, "selective_scan_" + op)(*args)
