"""The port against the JAX package, on the CPU, at the shapes whose card
kernels take the backward's large forms: GroupNorm + SiLU at the 64x64 SR
UNet's four GroupNorm shapes whose float32 group outgrows one SM's shared
memory (the backward's cluster form on the card), and the scan's backward
entries past 32 states (the wide sweep on the card: N 64 is one launch of
it, N 65 one of 64 states and one of 1).

Here the port's wrappers run their plain versions on CPU tensors; the JAX
side is `jax.vjp` of the JAX package's functions (its XLA GroupNorm + SiLU,
whose Pallas kernel has no backward, and its XLA scan, which is what the
JAX package runs past 32 states). Inputs come from numpy with a fixed seed.
Max-rel is max|port - jax| / max|jax|: 1e-5 for GroupNorm + SiLU (float32,
the same formulas, sums over a group of up to 196,608 values or a channel's
4096 rows in other orders), 2e-5 on the scan's forward and 1e-4 on its
gradients (the adjoint sums over L steps and over D), the bars of
tests/test_torch_port_norm_bwd.py and tests/test_torch_port_scan_split.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.ops.fused_norm import (
    group_norm_silu as jax_group_norm_silu,
)
from diffusion_models_collection_tpu.ops.selective_scan import (
    selective_scan as jax_selective_scan,
    selective_scan_with_state as jax_selective_scan_with_state,
)
from diffusion_models_collection_tpu_torch.ops import fused_norm
from diffusion_models_collection_tpu_torch.ops import selective_scan as ss
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    max_rel,
    one_torch_thread,
)

TOL_GN = 1e-5
TOL_FWD = 2e-5
TOL_BWD = 1e-4
# (B, H, W, C), 8 groups: the SR step's GroupNorm shapes past one SM's
# shared memory in float32, at batch 1
SR_GENERIC_SHAPES = [(1, 64, 64, 128), (1, 64, 64, 256), (1, 64, 64, 384),
                     (1, 32, 32, 512)]
# (N, L, D): L 64 in two time blocks of 32, L 50 in four of 16 with a
# ragged last one; D 16 and 32
WIDE_STATE_CASES = [(64, 64, 16), (64, 50, 32), (65, 64, 32), (65, 50, 16)]


def gn_case(shape):
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, g


@pytest.mark.parametrize("shape", SR_GENERIC_SHAPES)
def test_group_norm_silu_at_the_sr_generic_shapes_matches_jax(shape):
    x, scale, bias, g = gn_case(shape)
    ref, vjp = jax.vjp(lambda *a: jax_group_norm_silu(*a, 8),
                       *map(jnp.asarray, (x, scale, bias)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    out = fused_norm.group_norm_silu(*leaves, 8)
    assert max_rel(out.detach().numpy(), ref) <= TOL_GN
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, ours, want in zip(("dx", "dscale", "dbias"), got,
                                vjp(jnp.asarray(g))):
        assert ours.shape == want.shape, name
        assert max_rel(ours.numpy(), want) <= TOL_GN, name


def scan_case(n_state, length, d_inner):
    rng = np.random.default_rng(n_state + length + d_inner)
    x = rng.standard_normal((2, length, d_inner)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal(x.shape) - 2)).astype(np.float32)
    A = -np.exp(rng.standard_normal((d_inner, n_state))).astype(np.float32)
    B, C = (rng.standard_normal((2, length, n_state)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal(x.shape).astype(np.float32)
    return x, dt, A, B, C, g


@pytest.mark.parametrize("entry", ["bwd", "bwd_nostate", "bwd_split"])
@pytest.mark.parametrize("n_state,length,d_inner", WIDE_STATE_CASES)
def test_scan_backward_past_32_states_matches_jax(entry, n_state, length,
                                                  d_inner):
    """K8 from the forward's block states, K7 with none and K10 in time
    chunks against the vjp of the JAX package's scan."""
    *args, g = scan_case(n_state, length, d_inner)
    ref, vjp = jax.vjp(jax_selective_scan, *map(jnp.asarray, args))
    x, dt, A, B, C, g_t = map(torch.from_numpy, (*args, g))
    y, bound = ss.selective_scan_fwd(x, dt, A, B, C, True)
    assert max_rel(y.numpy(), ref) <= TOL_FWD
    grads = {"bwd": lambda: ss.selective_scan_bwd(x, dt, A, B, C, g_t, bound),
             "bwd_nostate": lambda: ss.selective_scan_bwd_nostate(
                 x, dt, A, B, C, g_t),
             "bwd_split": lambda: ss.selective_scan_bwd_split(
                 x, dt, A, B, C, g_t, bound)}[entry]()
    for name, ours, want in zip(("dx", "ddt", "dA", "dB", "dC"), grads,
                                vjp(jnp.asarray(g))):
        assert tuple(ours.shape) == want.shape, name
        assert max_rel(ours.numpy(), want) <= TOL_BWD, name


@pytest.mark.parametrize("n_state,length,d_inner", WIDE_STATE_CASES[::3])
def test_stated_scan_backward_past_32_states_matches_jax(n_state, length,
                                                         d_inner):
    """E4's backward (the cotangent of h_out in, dh_in out) against the vjp
    of the JAX package's `selective_scan_with_state`."""
    *args, g = scan_case(n_state, length, d_inner)
    rng = np.random.default_rng(n_state)
    h_in = (0.5 * rng.standard_normal((2, d_inner, n_state))).astype(
        np.float32)
    g_h = rng.standard_normal(h_in.shape).astype(np.float32)
    (y_ref, h_ref), vjp = jax.vjp(jax_selective_scan_with_state,
                                  *map(jnp.asarray, (*args, h_in)))
    x, dt, A, B, C, h, g_t, g_ht = map(torch.from_numpy,
                                        (*args, h_in, g, g_h))
    y, bound, h_out = ss.selective_scan_fwd_state(x, dt, A, B, C, h)
    assert max_rel(y.numpy(), y_ref) <= TOL_FWD
    assert max_rel(h_out.numpy(), h_ref) <= TOL_FWD
    grads = ss.selective_scan_bwd_state(x, dt, A, B, C, g_t, bound, g_ht)
    for name, ours, want in zip(("dx", "ddt", "dA", "dB", "dC", "dh_in"),
                                grads, vjp((jnp.asarray(g),
                                            jnp.asarray(g_h)))):
        assert tuple(ours.shape) == want.shape, name
        assert max_rel(ours.numpy(), want) <= TOL_BWD, name
