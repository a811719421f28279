"""The PyTorch port's ops against the JAX package's, on the CPU.

The port's plain GroupNorm+SiLU and attention (what its wrappers run for a
CPU tensor) are held against the JAX reference functions and against the
Pallas kernels in interpret mode, as tests/test_pallas_kernels.py runs
them. Inputs come from numpy with a fixed seed and go to both sides.

Tolerance: max|port - jax| / max|jax| <= 1e-5. Both sides are float32 and
sum in different orders; float32 rounding of a GroupNorm over a few
thousand elements or an attention row of 256 keys stays near 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffusion_models_collection_tpu.ops import attention as jax_attention
from diffusion_models_collection_tpu.ops import flash_attention as jax_flash
from diffusion_models_collection_tpu.ops.fused_norm import (
    _gn_silu_pallas,
    group_norm_silu_xla,
)
from diffusion_models_collection_tpu_torch.ops import (
    flash_attention,
    fused_norm,
    multihead_attention,
)

TOL = 1e-5


def max_rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30)


def gn_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


def qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (2, 4, 4, 256),
                                   (1, 16, 16, 384), (3, 5, 7, 24)])
def test_group_norm_silu_plain_matches_jax_reference(shape):
    x, scale, bias = gn_inputs(shape)
    ours = fused_norm.group_norm_silu(torch.from_numpy(x),
                                      torch.from_numpy(scale),
                                      torch.from_numpy(bias), 8)
    ref = group_norm_silu_xla(jnp.asarray(x), jnp.asarray(scale),
                              jnp.asarray(bias), 8)
    assert max_rel(ours.numpy(), ref) <= TOL


@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (2, 4, 4, 256)])
def test_group_norm_silu_plain_matches_pallas_kernel_interpret(shape):
    x, scale, bias = gn_inputs(shape, seed=1)
    b, h, w, c = shape
    with pltpu.force_tpu_interpret_mode():
        pal = _gn_silu_pallas(jnp.asarray(x.reshape(b, h * w, c)),
                              jnp.asarray(scale), jnp.asarray(bias), 8)
    ours = fused_norm.group_norm_silu_ref(torch.from_numpy(x),
                                          torch.from_numpy(scale),
                                          torch.from_numpy(bias), 8)
    assert max_rel(ours.numpy(), np.asarray(pal).reshape(shape)) <= TOL


def test_flash_attention_plain_matches_pallas_kernel_interpret():
    q, k, v = qkv((2, 256, 64))
    with pltpu.force_tpu_interpret_mode():
        o_ref, lse_ref = jax_flash._flash_fwd_bh(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 256, 256)
    o, lse = flash_attention.flash_attention_fwd(
        *(torch.from_numpy(a) for a in (q, k, v)))
    assert lse.shape == tuple(lse_ref.shape) == (2, 256, 1)
    assert max_rel(o.numpy(), o_ref) <= TOL
    assert max_rel(lse.numpy(), lse_ref) <= TOL


@pytest.mark.parametrize("seq_len", [64, 16])
def test_flash_attention_plain_matches_dot_product_attention(seq_len):
    # (B, H, L, d) as the JAX function takes it; the port works on (B*H, L, d)
    q, k, v = qkv((2, 4, seq_len, 64), seed=seq_len)
    ref = jax_attention.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(64.0)
    lse_ref = jax.nn.logsumexp(logits, axis=-1)[..., None]
    o, lse = flash_attention.flash_attention_fwd(
        *(torch.from_numpy(a.reshape(8, seq_len, 64)) for a in (q, k, v)))
    assert max_rel(o.numpy().reshape(q.shape), ref) <= TOL
    assert max_rel(lse.numpy().reshape(2, 4, seq_len, 1), lse_ref) <= TOL


@pytest.mark.parametrize("seq_len", [64, 16])
def test_multihead_attention_matches_jax(seq_len):
    q, k, v = qkv((2, seq_len, 256), seed=3)
    ref = jax_attention.multihead_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4)
    ours = multihead_attention(*(torch.from_numpy(a) for a in (q, k, v)), 4)
    assert max_rel(ours.numpy(), ref) <= TOL
