"""The bf16 forms of the port's GroupNorm+SiLU and attention against the
JAX package, on the CPU.

Under `mixed_precision: 'bf16'` the JAX UNet calls its GroupNorm+SiLU on
`x.astype(f32)` and casts the result to bf16 (`models/unet.py:50-54`), and
the flash kernels compute in float32 from bf16 q, k, v and return their type
(`ops/flash_attention.py:67-73, 91, 131-155`). The port's bf16 forms, here
through the plain versions that the wrappers run on the CPU, do the same:
upcast, the float32 formulas, outputs rounded to bf16. Inputs come from numpy
with a fixed seed, rounded to bf16 once, and go to both sides.

Bars. A bf16 output of the two sides is the rounding of two float32 results
that differ by float32 rounding (about 1e-6 of the largest value), so they
are equal or one bf16 step apart where the two float32 values straddle a
rounding boundary: `within_bf16_steps` counts the bf16 values between them
and allows `steps` of them, measured here at 1 (GroupNorm+SiLU, the
attention forward) and 2 (the attention backward, whose dS is a difference
of two products), except for elements far below the largest, held to the
float32 bar of the largest instead. The float32 outputs (statistics, lse, dscale, dbias) keep
the float32 bars of tests/test_torch_port_ops.py: 1e-5 relative to the
largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.ops import attention as jax_attention
from diffusion_models_collection_tpu.ops import flash_attention as jax_flash
from diffusion_models_collection_tpu.ops.fused_norm import (
    _gn_silu_pallas,
    group_norm_silu as jax_group_norm_silu,
)
from diffusion_models_collection_tpu_torch.ops import (
    flash_attention,
    fused_norm,
)
from torch_port_helpers import max_rel, run_pallas_interpreted

TOL_F32 = 1e-5
BF16 = jnp.bfloat16


def bf16_steps(ours, ref):
    """The number of bf16 values from one array to the other, elementwise
    (0: equal). Both hold bf16 values; their bit patterns, as ordered
    integers, count the steps."""
    def ordered(a):
        bits = (np.asarray(a, np.float32).view(np.uint32) >> 16).astype(
            np.int64)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)
    return np.abs(ordered(ours) - ordered(ref))


def within_bf16_steps(ours, ref, steps):
    """Every element within `steps` bf16 values of the reference, or, for an
    element far smaller than the largest, within the float32 bar of the
    largest: there the two float32 results differ by the rounding of terms
    of the largest size (the backward's dS = P (dP - delta) cancels), which
    is many bf16 steps of the small element's own."""
    ours = np.asarray(torch.as_tensor(ours).float())
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    close = np.abs(ours - ref) <= TOL_F32 * np.abs(ref).max()
    return bool(((bf16_steps(ours, ref) <= steps) | close).all())


def bf16_array(rng, *shape, scale=1.0, shift=0.0):
    """numpy float32 values that are exactly bf16 values."""
    x = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


def gn_case(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = bf16_array(rng, *shape, scale=2.0, shift=0.5)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    g = bf16_array(rng, *shape)
    return x, scale, bias, g


def as_bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


# (3, 5, 7, 24): C / G = 3 channels, no whole 16-byte vector of bf16 (the
# kernels' generic form on the card)
@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (3, 5, 7, 24)])
def test_group_norm_silu_bf16_matches_the_pallas_kernel(shape):
    x, scale, bias, _ = gn_case(shape, seed=0)
    b, h, w, c = shape

    def jax_fwd(x, scale, bias):
        y = _gn_silu_pallas(x.astype(jnp.float32).reshape(b, h * w, c),
                            scale, bias, 8)
        return y.reshape(shape).astype(BF16)

    ref = run_pallas_interpreted(jax_fwd, jnp.asarray(x, BF16), scale, bias)
    y, stats = fused_norm.group_norm_silu_fwd_stats(
        as_bf16(x), torch.from_numpy(scale), torch.from_numpy(bias), 8)
    assert y.dtype == torch.bfloat16 and stats.dtype == torch.float32
    assert within_bf16_steps(y, ref, 1)
    groups = x.reshape(b, h * w, 8, c // 8).astype(np.float64)
    mean = groups.mean(axis=(1, 3))
    rstd = 1 / np.sqrt(groups.var(axis=(1, 3)) + fused_norm.EPS)
    assert max_rel(stats[0].numpy(), mean) <= TOL_F32
    assert max_rel(stats[1].numpy(), rstd) <= TOL_F32


@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (3, 5, 7, 24)])
def test_group_norm_silu_bf16_backward_matches_jax_vjp(shape):
    """dx against `jax.vjp` of `group_norm_silu(x.astype(f32))
    .astype(bf16)` (the JAX UNet's cast points), dscale and dbias float32,
    through the backward's plain version and through autograd of the
    `GroupNormSiLU` Function."""
    x, scale, bias, g = gn_case(shape, seed=1)

    def jax_fn(x, scale, bias):
        return jax_group_norm_silu(x.astype(jnp.float32), scale, bias,
                                   8).astype(BF16)

    _, vjp = jax.vjp(jax_fn, jnp.asarray(x, BF16), scale, bias)
    dx_ref, dscale_ref, dbias_ref = vjp(jnp.asarray(g, BF16))
    assert dx_ref.dtype == BF16
    xt, st, bt = (as_bf16(x).requires_grad_(),
                  torch.from_numpy(scale).requires_grad_(),
                  torch.from_numpy(bias).requires_grad_())
    y = fused_norm.group_norm_silu(xt, st, bt, 8)
    y.backward(as_bf16(g))
    _, stats = fused_norm.group_norm_silu_fwd_stats(xt.detach(), st.detach(),
                                                    bt.detach(), 8)
    plain = fused_norm.group_norm_silu_bwd(xt.detach(), st.detach(),
                                           bt.detach(), as_bf16(g), stats, 8)
    for dx, dscale, dbias in (plain, (xt.grad, st.grad, bt.grad)):
        assert dx.dtype == torch.bfloat16 and dscale.dtype == torch.float32
        assert within_bf16_steps(dx, dx_ref, 1)
        assert max_rel(dscale.numpy(), dscale_ref) <= TOL_F32
        assert max_rel(dbias.numpy(), dbias_ref) <= TOL_F32


def attention_case(seq_len, seed, bh=2, d=64):
    rng = np.random.default_rng(seed)
    return [bf16_array(rng, bh, seq_len, d) for _ in range(4)]


def jax_reference(q, k, v, do, seq_len):
    """(o, lse, dq, dk, dv) of the JAX package on bf16 inputs: the Pallas
    kernels in interpret mode at L 64 and 256; at another L, the XLA forms
    (`dot_product_attention`, `_bwd_jnp`) on the inputs widened to float32
    and their outputs cast to bf16, which is what the kernels do at their
    loads and stores (`_bwd_jnp` called on bf16 itself would round the
    scores to bf16 in its first einsum)."""
    q, k, v, do = (jnp.asarray(a, BF16) for a in (q, k, v, do))
    if seq_len in (64, 256):
        def fwd_bwd(q, k, v, do):
            o, lse = jax_flash._flash_fwd_bh(q, k, v, seq_len, seq_len)
            return (o, lse, *jax_flash._flash_bwd_bh(q, k, v, o, do, lse))
        return run_pallas_interpreted(fwd_bwd, q, k, v, do)
    wide = [a.astype(jnp.float32) for a in (q, k, v)]
    o = jax_attention.dot_product_attention(
        *(a[None] for a in wide))[0].astype(BF16)
    logits = jnp.einsum("bqd,bkd->bqk", wide[0], wide[1]) / np.sqrt(
        q.shape[-1])
    lse = jax.nn.logsumexp(logits, axis=-1)[..., None]
    grads = jax_flash._bwd_jnp(*wide, o.astype(jnp.float32),
                               do.astype(jnp.float32), lse)
    return (o, lse, *(g.astype(BF16) for g in grads))


@pytest.mark.parametrize("seq_len", [64, 256, 100])
def test_flash_attention_bf16_matches_the_jax_kernels(seq_len):
    q, k, v, do = attention_case(seq_len, seed=seq_len)
    o_ref, lse_ref, *grads_ref = jax_reference(q, k, v, do, seq_len)
    assert o_ref.dtype == BF16 and grads_ref[0].dtype == BF16
    o, lse = flash_attention.flash_attention_fwd(as_bf16(q), as_bf16(k),
                                                 as_bf16(v))
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert within_bf16_steps(o, o_ref, 1)
    assert max_rel(lse.numpy(), lse_ref) <= TOL_F32
    # the backward from JAX's o and lse, so both sides start from one input
    grads = flash_attention.flash_attention_bwd(
        as_bf16(q), as_bf16(k), as_bf16(v), as_bf16(o_ref), as_bf16(do),
        torch.tensor(np.asarray(lse_ref)))
    for name, got, want in zip(("dq", "dk", "dv"), grads, grads_ref):
        assert got.dtype == torch.bfloat16, name
        assert within_bf16_steps(got, want, 2), name


def test_flash_attention_bf16_autograd_gives_the_backward_of_its_forward():
    """`FlashAttention` on bf16 tensors on the CPU: o and the gradients in
    bf16, equal to the wrappers' forward and backward on the same inputs,
    with dropout (the mask does not depend on the dtype)."""
    q, k, v, do = (as_bf16(a) for a in attention_case(100, seed=7, d=48))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention.flash_attention(*leaves, 0.1, 1234)
    out.backward(do)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, 0.1, 1234)
    grads = flash_attention.flash_attention_bwd(q, k, v, o, do, lse, 0.1,
                                                1234)
    assert out.dtype == torch.bfloat16 and torch.equal(out.detach(), o)
    for leaf, want in zip(leaves, grads):
        assert leaf.grad.dtype == torch.bfloat16
        assert torch.equal(leaf.grad, want)
    wide = flash_attention.flash_attention_fwd(q.float(), k.float(),
                                               v.float(), 0.1, 1234)[0]
    assert torch.equal(o, wide.bfloat16())


def test_the_kernels_take_float32_or_bf16_of_one_type():
    """The wrappers raise on another dtype, on mixed activations and on
    bf16 statistics or parameters (float32 only)."""
    q = torch.zeros(2, 16, 8)
    with pytest.raises(TypeError):
        flash_attention.flash_attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        flash_attention.flash_attention_fwd(q.bfloat16(), q, q)
    lse = torch.zeros(2, 16, 1)
    with pytest.raises(TypeError):
        flash_attention.flash_attention_bwd(*[q.bfloat16()] * 5,
                                            lse.bfloat16())
    x = torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fused_norm.group_norm_silu_fwd(x, torch.ones(16).bfloat16(),
                                       torch.zeros(16), 8)
    stats = torch.zeros(2, 1, 8)
    with pytest.raises(TypeError):
        fused_norm.group_norm_silu_bwd(x, torch.ones(16), torch.zeros(16),
                                       x.float(), stats, 8)
