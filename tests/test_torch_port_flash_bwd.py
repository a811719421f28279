"""The PyTorch port's differentiable kernel ops against the JAX package's
backward passes, on the CPU.

* `flash_attention_bwd_ref`, the plain version beside the backward kernel
  (K3), against the JAX Pallas backward `_flash_bwd_bh` in interpret mode
  and its XLA form `_bwd_jnp`;
* the `FlashAttention` Function's gradients against autograd through the
  plain forward, at lengths that are not tile multiples;
* the `GroupNormSiLU` Function's gradients against `jax.vjp` of the JAX
  package's `group_norm_silu`.

Inputs come from numpy with a fixed seed and go to both sides. Tolerance:
max|port - reference| / max|reference| <= 1e-5: float32 on both sides,
sums of a few hundred terms in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffusion_models_collection_tpu.ops import flash_attention as jax_flash
from diffusion_models_collection_tpu.ops.fused_norm import (
    group_norm_silu as jax_group_norm_silu,
)
from diffusion_models_collection_tpu_torch.ops import (
    flash_attention,
    fused_norm,
)

TOL = 1e-5


def max_rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30)


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_flash_attention_bwd_ref_matches_the_jax_kernel_and_xla_form():
    rng = np.random.default_rng(0)
    q, k, v, do = (randn(rng, 2, 128, 64) for _ in range(4))
    with pltpu.force_tpu_interpret_mode():
        o, lse = jax_flash._flash_fwd_bh(q, k, v, 128, 128)
        kernel = jax_flash._flash_bwd_bh(q, k, v, o, do, lse)
    xla = jax_flash._bwd_jnp(q, k, v, o, do, lse)
    ours = flash_attention.flash_attention_bwd(
        *(torch.tensor(np.asarray(a)) for a in (q, k, v, o, do, lse)))
    for name, got, want_kernel, want_xla in zip(("dq", "dk", "dv"), ours,
                                                kernel, xla):
        assert max_rel(got, want_kernel) <= TOL, name
        assert max_rel(got, want_xla) <= TOL, name


@pytest.mark.parametrize("seq_len", [16, 64, 100])
def test_flash_attention_function_grads_match_autograd(seq_len):
    rng = np.random.default_rng(seq_len)
    q, k, v, do = (torch.from_numpy(randn(rng, 3, seq_len, 32))
                   for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_()
    out = flash_attention.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(flash_attention.flash_attention_ref(q, k, v),
                               (q, k, v), do)
    for g, w in zip(got, want):
        assert max_rel(g, w) <= TOL


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (2, 8, 8, 128),
                                   (3, 4, 4, 192), (2, 5, 7, 24)])
def test_group_norm_silu_function_grads_match_jax_vjp(shape):
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = randn(rng, *shape) * 2 + 0.5
    scale = 1 + 0.1 * randn(rng, c)
    bias = 0.1 * randn(rng, c)
    g = randn(rng, *shape)
    _, vjp = jax.vjp(lambda *a: jax_group_norm_silu(*a, 8), jnp.asarray(x),
                     jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jnp.asarray(g))
    inputs = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    y = fused_norm.group_norm_silu(*inputs, 8)
    assert type(y.grad_fn).__name__ == "GroupNormSiLUBackward"
    # the incoming gradient in a channels-first layout, as a conv hands it
    g_t = torch.from_numpy(g).permute(0, 3, 1, 2).contiguous().permute(
        0, 2, 3, 1)
    got = torch.autograd.grad(y, inputs, g_t)
    for name, ours, ref in zip(("dx", "dscale", "dbias"), got, want):
        assert max_rel(ours, ref) <= TOL, name
