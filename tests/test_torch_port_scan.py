"""The PyTorch port's selective scan against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas_kernels.py does, each call jitted and waited for
(`run_pallas_interpreted`); the port's wrappers run their plain
versions on CPU tensors. Inputs come from numpy with a fixed seed. Max-rel
is max|port - jax| / max|jax|:

* forward, y and the saved block states against `selective_scan_pallas`
  (K5) and `selective_scan_fwd_ckpt_pallas` (K6) at (batch, L, D, N) =
  (2, 32, 128, 8) and (2, 64, 256, 16), and y against `_scan_pallas_call`
  (K4) at L = 40: 1e-5 (float32, the same recurrence, sums over N in other
  orders);
* backward against `selective_scan_bwd_from_ckpt_pallas` (K8) and against
  `jax.grad` of `selective_scan_sequential`, including the ragged L = 40
  and 100 that the JAX kernels do not take: 1e-4 (the adjoint sums over L
  steps and over D);
* the autograd wiring: `SelectiveScan` against autograd through the port's
  `selective_scan_sequential`, 1e-5 on y and 1e-4 on the gradients,
  reaching x, dt, A_log, B, C and D.
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
from torch_port_helpers import max_rel, run_pallas_interpreted

TOL_FWD = 1e-5
TOL_BWD = 1e-4


def scan_inputs(batch, length, d_inner, n_state, seed=0):
    """x, dt > 0, A < 0, B, C and an output gradient g, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, length, d_inner)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal(x.shape))).astype(np.float32)
    A = -np.exp(rng.standard_normal((d_inner, n_state))).astype(np.float32)
    B, C = (rng.standard_normal((batch, length, n_state)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal(x.shape).astype(np.float32)
    return x, dt, A, B, C, g


def torch_args(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def close(ours, ref, tol):
    """max-rel within tol; an all-zero reference must be matched exactly."""
    ref = np.asarray(ref)
    if not np.abs(ref).max():
        return not np.abs(np.asarray(ours)).max()
    return max_rel(ours, ref) <= tol


@pytest.mark.parametrize("shape", [(2, 32, 128, 8), (2, 64, 256, 16)])
def test_forward_and_block_states_match_the_pallas_kernels(shape):
    x, dt, A, B, C, _ = scan_inputs(*shape)
    y_k5 = run_pallas_interpreted(
        lambda *a: ssp.selective_scan_pallas(*a, None), x, dt, A, B, C)
    y_k6, bound_ref = run_pallas_interpreted(
        ssp.selective_scan_fwd_ckpt_pallas, x, dt, A, B, C)
    y, bound = ss.selective_scan_fwd(*torch_args(x, dt, A, B, C),
                                     save_states=True)
    assert bound.shape == bound_ref.shape == (
        shape[0], shape[1] // ss.t_block_for(shape[1]), shape[3], shape[2])
    assert close(y, y_k5, TOL_FWD) and close(y, y_k6, TOL_FWD)
    assert close(bound, bound_ref, TOL_FWD)
    y_only, none = ss.selective_scan_fwd(*torch_args(x, dt, A, B, C))
    assert none is None
    torch.testing.assert_close(y_only, y, rtol=0, atol=0)


def test_ragged_forward_matches_the_step_kernel():
    """L = 40: the JAX package runs K4, one step at a time; the port's
    blocks are 16, 16 and a ragged 8."""
    x, dt, A, B, C, _ = scan_inputs(2, 40, 128, 8, seed=1)
    ref = run_pallas_interpreted(ssp._scan_pallas_call, dt, dt * x, B, C,
                                 A.T)
    y, bound = ss.selective_scan_fwd(*torch_args(x, dt, A, B, C),
                                     save_states=True)
    assert close(y, ref, TOL_FWD)
    assert bound.shape == (2, 3, 8, 128)


@pytest.mark.parametrize("shape", [(2, 32, 128, 8), (2, 64, 256, 16)])
def test_backward_matches_the_pallas_kernel(shape):
    x, dt, A, B, C, g = scan_inputs(*shape, seed=2)
    _, bound = run_pallas_interpreted(ssp.selective_scan_fwd_ckpt_pallas,
                                      x, dt, A, B, C)
    refs = run_pallas_interpreted(ssp.selective_scan_bwd_from_ckpt_pallas,
                                  x, dt, A, B, C, g, bound)
    ours = ss.selective_scan_bwd(*torch_args(x, dt, A, B, C, g,
                                             np.array(bound)))
    for name, o, r in zip(("dx", "ddt", "dA", "dB", "dC"), ours, refs):
        assert o.shape == r.shape, name
        assert close(o, r, TOL_BWD), name


@pytest.mark.parametrize("shape", [(2, 64, 128, 16), (1, 40, 24, 4),
                                   (2, 100, 16, 3)])
def test_backward_matches_jax_grad_of_the_sequential_scan(shape):
    x, dt, A, B, C, g = scan_inputs(*shape, seed=3)
    refs = jax.grad(
        lambda *a: jnp.sum(jax_sequential(*a) * g), argnums=(0, 1, 2, 3, 4))(
            *map(jnp.asarray, (x, dt, A, B, C)))
    args = torch_args(x, dt, A, B, C)
    _, bound = ss.selective_scan_fwd(*args, save_states=True)
    ours = ss.selective_scan_bwd(*args, torch.from_numpy(g), bound)
    # (dx, ddt, dA, dB, dC) against jax.grad's (x, dt, A, B, C)
    for name, o, r in zip(("dx", "ddt", "dA", "dB", "dC"), ours, refs):
        assert close(o, r, TOL_BWD), name


def test_sequential_reference_matches_jax():
    x, dt, A, B, C, _ = scan_inputs(2, 20, 12, 5, seed=4)
    D = np.linspace(0.5, 1.5, 12).astype(np.float32)
    ref = jax_sequential(*map(jnp.asarray, (x, dt, A, B, C, D)))
    ours = ss.selective_scan_sequential(*torch_args(x, dt, A, B, C, D))
    assert close(ours, ref, TOL_FWD)


@pytest.mark.parametrize("length", [48, 100])
def test_selective_scan_function_grads_match_autograd_of_sequential(length):
    x, dt, A, B, C, g = scan_inputs(2, length, 16, 4, seed=5)
    D = np.linspace(0.5, 1.5, 16).astype(np.float32)
    a_log = np.log(-A)

    def run(fn):
        leaves = [t.requires_grad_() for t in torch_args(x, dt, a_log, B, C,
                                                         D)]
        xx, dtt, al, bb, cc, dd = leaves
        y = fn(xx, dtt, -torch.exp(al), bb, cc, dd)
        return y, torch.autograd.grad(y, leaves, torch.from_numpy(g))

    y, grads = run(ss.selective_scan)
    y_ref, grads_ref = run(ss.selective_scan_sequential)
    assert close(y.detach(), y_ref.detach(), TOL_FWD)
    for name, o, r in zip(("x", "dt", "A_log", "B", "C", "D"), grads,
                          grads_ref):
        assert o.abs().max() > 0, name
        assert close(o, r, TOL_BWD), name


def test_selective_scan_is_an_autograd_function_reaching_every_input():
    x, dt, A, B, C, _ = scan_inputs(1, 16, 8, 4, seed=6)
    leaves = [t.requires_grad_() for t in torch_args(x, dt, np.log(-A), B, C,
                                                     np.ones(8, np.float32))]
    core = ss.SelectiveScan.apply(
        leaves[0], leaves[1], -torch.exp(leaves[2]), leaves[3], leaves[4],
        True)
    assert type(core.grad_fn).__name__ == "SelectiveScanBackward"
    y = ss.selective_scan(leaves[0], leaves[1], -torch.exp(leaves[2]),
                          leaves[3], leaves[4], leaves[5])
    y.square().sum().backward()
    for t in leaves:
        assert t.grad is not None and t.grad.abs().max() > 0


def test_states_are_saved_only_when_a_gradient_is_wanted(monkeypatch):
    calls = []
    real = ss.selective_scan_fwd

    def recording(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(ss, "selective_scan_fwd", recording)
    x, dt, A, B, C, _ = (torch.from_numpy(a) for a in scan_inputs(1, 8, 4, 2))
    ss.selective_scan(x, dt, A, B, C)
    x.requires_grad_()
    with torch.no_grad():
        ss.selective_scan(x, dt, A, B, C)
    ss.selective_scan(x, dt, A, B, C)
    assert calls == [False, False, True]


def test_cpu_wrappers_run_the_plain_versions_and_count_no_launch():
    before = (ss.FWD_LAUNCHES, ss.FWD_STATES_LAUNCHES, ss.BWD_LAUNCHES)
    x, dt, A, B, C, g = torch_args(*scan_inputs(2, 48, 8, 4, seed=7))
    y, bound = ss.selective_scan_fwd(x, dt, A, B, C, True)
    y_ref, bound_ref = ss.selective_scan_fwd_ref(x, dt, A, B, C, True)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    torch.testing.assert_close(bound, bound_ref, rtol=0, atol=0)
    for o, r in zip(ss.selective_scan_bwd(x, dt, A, B, C, g, bound),
                    ss.selective_scan_bwd_ref(x, dt, A, B, C, g, bound)):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    assert (ss.FWD_LAUNCHES, ss.FWD_STATES_LAUNCHES, ss.BWD_LAUNCHES) == before


@pytest.mark.parametrize("case", ["float64", "strided", "A", "B", "state",
                                  "bound"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    x, dt, A, B, C, g = torch_args(*scan_inputs(2, 16, 8, 4))
    bound = torch.zeros(2, 1, 4, 8)
    if case == "float64":
        x = x.double()
    elif case == "strided":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "A":
        A = torch.zeros(9, 4)
    elif case == "B":
        B = torch.zeros(2, 16, 5)
    elif case == "state":
        A, B, C = torch.zeros(8, 33), torch.zeros(2, 16, 33), torch.zeros(
            2, 16, 33)
        bound = torch.zeros(2, 1, 33, 8)
    else:
        bound = torch.zeros(2, 2, 4, 8)
    if case == "state":
        # more than STATE_CHUNK states: the card's kernels walk them in
        # chunks (`cuda` tests in test_torch_port_kernels.py), the plain
        # versions on the CPU take them whole, as the JAX package's XLA scan
        # does
        assert A.shape[1] > ss.STATE_CHUNK
        y, saved = ss.selective_scan_fwd(x, dt, A, B, C, True)
        assert y.shape == x.shape and saved.shape == bound.shape
        grads = ss.selective_scan_bwd(x, dt, A, B, C, g, bound)
        assert [t.shape for t in grads] == [t.shape for t in (x, dt, A, B, C)]
        return
    with pytest.raises((ValueError, TypeError)):
        ss.selective_scan_bwd(x, dt, A, B, C, g, bound)
    if case != "bound":
        with pytest.raises((ValueError, TypeError)):
            ss.selective_scan_fwd(x, dt, A, B, C, True)


def test_pieces_not_ported_raise():
    """The sequence-parallel pieces, which raised until the
    sequence-parallel slice ported them, run: `chunk_size` gives the whole
    scan, and `selective_scan_with_state` from a zero state gives it too
    (their parity with JAX: test_torch_port_dim_sequence_parallel.py); the
    tensor-parallel scope is a no-op around the unchanged scan."""
    x, dt, A, B, C, _ = torch_args(*scan_inputs(1, 8, 4, 2))
    whole = ss.selective_scan(x, dt, A, B, C)
    torch.testing.assert_close(ss.selective_scan(x, dt, A, B, C,
                                                 chunk_size=4), whole)
    y, h = ss.selective_scan_with_state(x, dt, A, B, C,
                                        torch.zeros(1, 4, 2))
    torch.testing.assert_close(y, whole)
    assert h.shape == (1, 4, 2)
    with ss.scan_tensor_parallel(None):
        y = ss.selective_scan(x, dt, A, B, C)
    torch.testing.assert_close(y, ss.selective_scan(x, dt, A, B, C),
                               rtol=0, atol=0)
