"""The plain backward of GroupNorm + SiLU (`group_norm_silu_bwd_ref`, the
version beside the backward kernel K1b) and the forward's saved statistics,
on the CPU, at even and ragged shapes.

Held to (a) autograd through the plain forward `group_norm_silu_ref`, the
recompute that the backward was before and that the JAX package's
`_core_bwd` still is, and (b) `jax.grad` of the JAX package's
`group_norm_silu`, once through its XLA reference and once through its
Pallas kernel in interpret mode. Inputs come from numpy with a fixed seed.
Tolerance: max|port - reference| / max|reference| <= 1e-5 (float32 on both
sides, sums over a group or over batch and HW in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.ops.fused_norm import (
    group_norm_silu as jax_group_norm_silu,
)
from diffusion_models_collection_tpu_torch.ops import fused_norm
from torch_port_helpers import max_rel, run_pallas_interpreted

TOL = 1e-5
# (B, H, W, C), 8 groups: rows of 16, 8, 24 and 3 floats; H*W odd; C / G = 3
# and 1 are no whole 16-byte vectors (the card's generic kernels)
SHAPES = [(2, 16, 16, 128), (2, 8, 8, 64), (3, 4, 4, 192), (2, 5, 7, 24),
          (3, 3, 3, 8), (1, 1, 2, 16)]


def case(shape, seed=0):
    rng = np.random.default_rng(seed + sum(shape))
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, g


def plain_backward(x, scale, bias, g):
    x, scale, bias, g = map(torch.from_numpy, (x, scale, bias, g))
    stats = fused_norm.group_norm_silu_stats_ref(x, 8)
    return fused_norm.group_norm_silu_bwd_ref(x, scale, bias, g, stats, 8)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_autograd_of_the_plain_forward(shape):
    x, scale, bias, g = case(shape)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    want = torch.autograd.grad(
        fused_norm.group_norm_silu_ref(*leaves, 8), leaves,
        torch.from_numpy(g))
    for name, got, ref in zip(("dx", "dscale", "dbias"),
                              plain_backward(x, scale, bias, g), want):
        assert got.shape == ref.shape, name
        assert max_rel(got, ref) <= TOL, name


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("shape", SHAPES[:4])
def test_plain_backward_matches_jax_grad(shape, pallas):
    x, scale, bias, g = case(shape, seed=1)

    def grads(*args):
        return jax.grad(
            lambda *a: jnp.sum(jax_group_norm_silu(*a, 8) * g),
            argnums=(0, 1, 2))(*args)

    args = tuple(map(jnp.asarray, (x, scale, bias)))
    want = run_pallas_interpreted(grads, *args) if pallas else grads(*args)
    for name, got, ref in zip(("dx", "dscale", "dbias"),
                              plain_backward(x, scale, bias, g), want):
        assert max_rel(got, ref) <= TOL, name


@pytest.mark.parametrize("shape", SHAPES)
def test_saved_statistics_are_the_groups_mean_and_inverse_sigma(shape):
    x, scale, bias, _ = case(shape, seed=2)
    y, stats = fused_norm.group_norm_silu_fwd_stats(
        *map(torch.from_numpy, (x, scale, bias)), 8)
    b, h, w, c = shape
    groups = x.reshape(b, h * w, 8, c // 8).astype(np.float64)
    mean = groups.mean(axis=(1, 3))
    rstd = 1.0 / np.sqrt(groups.var(axis=(1, 3)) + fused_norm.EPS)
    assert stats.shape == (2, b, 8) and stats.dtype == torch.float32
    assert max_rel(stats[0], mean) <= TOL and max_rel(stats[1], rstd) <= TOL
    torch.testing.assert_close(
        y, fused_norm.group_norm_silu_ref(
            *map(torch.from_numpy, (x, scale, bias)), 8), rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["group_norm_silu", "group_norm_silu_plain"])
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[3]])
def test_both_functions_run_the_plain_backward_on_cpu(entry, shape):
    """`GroupNormSiLU` (on a CPU tensor) and `GroupNormSiLURef`, which
    `plain_kernels()` swaps in, give the plain backward's gradients bit for
    bit, for an output gradient in a channels-first layout, and count no
    launch."""
    x, scale, bias, g = case(shape, seed=3)
    before = (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    y = getattr(fused_norm, entry)(*leaves, 8)
    g_t = torch.from_numpy(g).permute(0, 3, 1, 2).contiguous().permute(
        0, 2, 3, 1)
    assert not g_t.is_contiguous()
    got = torch.autograd.grad(y, leaves, g_t)
    for ours, ref in zip(got, plain_backward(x, scale, bias, g)):
        torch.testing.assert_close(ours, ref, rtol=0, atol=0)
    assert (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES) == before


@pytest.mark.parametrize("case_name", ["g", "stats", "float64", "strided"])
def test_backward_wrapper_rejects_what_the_kernel_does_not_take(case_name):
    x, scale, bias, g = map(torch.from_numpy, case((2, 4, 4, 16)))
    stats = fused_norm.group_norm_silu_stats_ref(x, 8)
    if case_name == "g":
        g = g[:, :3].contiguous()
    elif case_name == "stats":
        stats = stats[:, :1].contiguous()
    elif case_name == "float64":
        g = g.double()
    else:
        g = g.transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        fused_norm.group_norm_silu_bwd(x, scale, bias, g, stats, 8)
