"""The numerical design of the bf16 attention kernels on the tensor cores,
on the CPU, before any card runs them.

The JAX kernels upcast bf16 q, k, v, o and dO to float32 and compute every
product in float32 (`ops/flash_attention.py:67,72-73,131-135`). The port's
bf16 forms (`csrc/flash_attn.cu`, `csrc/flash_attn_bwd.cu`) run their
products on the tensor cores, whose operands are bf16: q, k, v and dO are
bf16 already and go in as they are, so S = q k^T and dP = dO v^T are the
float32 results; the operands the kernels make themselves, P (dropped out)
and dS, go in as two bf16 terms each, hi = bf16(x) and lo = bf16(x - hi),
whose two products with the same exact operand sum to the float32 product
(`csrc/bf16_mma.cuh`). `emulate_fwd` and `emulate_bwd` compute exactly that
with plain torch: products of the rounded operands in float64, rounded to
float32, the softmax and dS in float32, outputs rounded to bf16 once.

They are held to the JAX package at the bars the kernels are held to on the
card (1 bf16 step for o, 2 for dq, dk, dv, or the float32 bar of the
largest value where an element is far below it): at p = 0 against the
Pallas kernels in interpret mode at L 64 and 256 and against the XLA forms
at L 16 and 100 (d 48), as `test_torch_port_bf16_ops.jax_reference` does;
with dropout against `dot_product_attention` (XLA; the Pallas kernels have
no dropout) with `jax.random.bernoulli` replaced in the test by the port's
Philox mask, and its `jax.vjp`, delta then taken from that float32 o on
both sides. One bf16 term for P instead of two misses the bar: that is why
the kernels split it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.ops import attention as jax_attention
from diffusion_models_collection_tpu_torch.ops import flash_attention
from test_torch_port_bf16_ops import (
    TOL_F32,
    as_bf16,
    attention_case,
    jax_reference,
    within_bf16_steps,
)
from torch_port_helpers import max_rel

P, SEED = 0.1, 0x0123_4567_89AB_CDEF


def split_terms(x, terms):
    """x (float32) as `terms` bf16 values, each as float64: bf16(x), then
    bf16 of what is left."""
    out = []
    for _ in range(terms):
        head = x.bfloat16().float()
        out.append(head.double())
        x = x - head
    return out


def split_matmul(a, b, terms=2):
    """a @ b as the tensor cores take it: a (float32) in `terms` bf16 terms,
    b exact bf16, each product exact (float64), the sum rounded to
    float32."""
    return sum(t @ b.double() for t in split_terms(a, terms)).float()


def exact_matmul(a, b):
    """a @ b of bf16 values with float32 accumulation: the products are
    exact, the sum rounds to float32."""
    return (a.double() @ b.double()).float()


def emulate_fwd(q, k, v, dropout_p=0.0, seed=None, terms=2):
    """o (float32, before the kernel's one rounding to bf16) and lse of the
    bf16 forward kernel on bf16 (BH, L, d) inputs."""
    q, k, v = q.float(), k.float(), v.float()
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = exact_matmul(q, k.transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_p > 0.0:
        p = p * flash_attention.dropout_factor(seed, dropout_p, p.shape)
    return split_matmul(p, v, terms) / l, m + torch.log(l)


def emulate_bwd(q, k, v, o, do, lse, dropout_p=0.0, seed=None, terms=2):
    """dq, dk, dv of the bf16 backward kernel from bf16 q, k, v, dO, the
    forward's o (its delta = rowsum(dO o)) and float32 lse (BH, L, 1)."""
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    scale = 1.0 / np.sqrt(q.shape[-1])
    p = torch.exp(exact_matmul(q, k.transpose(-1, -2)) * scale - lse)
    dp = exact_matmul(do, v.transpose(-1, -2))
    pz = p
    if dropout_p > 0.0:
        z = flash_attention.dropout_factor(seed, dropout_p, p.shape)
        pz, dp = p * z, dp * z
    ds = p * (dp - (do * o).sum(dim=-1, keepdim=True)) * scale
    dq = split_matmul(ds, k, terms)
    dk = split_matmul(ds.transpose(-1, -2), q, terms)
    dv = split_matmul(pz.transpose(-1, -2), do, terms)
    return tuple(t.bfloat16() for t in (dq, dk, dv))


def jax_dropout_reference(monkeypatch, q, k, v, do):
    """o (float32), lse and the float32 gradients of the JAX package's XLA
    attention with dropout p on bf16 inputs widened to float32, the port's
    mask in place of `jax.random.bernoulli`'s."""
    bh, seq_len, _ = q.shape
    keep = flash_attention.philox_keep_mask(SEED, bh, seq_len, seq_len, P)

    def bernoulli(key, prob, shape):
        return jnp.asarray(keep.numpy().reshape(shape))

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)

    def attn(q, k, v):
        return jax_attention.dot_product_attention(
            q[None], k[None], v[None], dropout_rate=P, deterministic=False,
            dropout_rng=jax.random.PRNGKey(0))[0]

    wide = [jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)
            for a in (q, k, v)]
    @jax.jit
    def fwd_bwd(q, k, v, do):
        o, vjp = jax.vjp(attn, q, k, v)
        logits = jnp.einsum("bqd,bkd->bqk", q, k) / np.sqrt(q.shape[-1])
        lse = jax.nn.logsumexp(logits, axis=-1)[..., None]
        return o, lse, vjp(do)

    return fwd_bwd(*wide, jnp.asarray(do, jnp.bfloat16).astype(jnp.float32))


# (L, d): the Pallas kernels' lengths at d 64, then the XLA forms' at the
# DiM fallback's d 48
@pytest.mark.parametrize("dropout", [0.0, P])
@pytest.mark.parametrize("seq_len,head_dim", [(64, 64), (256, 64), (16, 48),
                                              (100, 48)])
def test_split_operands_hold_the_kernel_bars_against_jax(
        monkeypatch, seq_len, head_dim, dropout):
    q, k, v, do = attention_case(seq_len, seed=seq_len + head_dim,
                                 d=head_dim)
    qt, kt, vt, dot = (as_bf16(a) for a in (q, k, v, do))
    if dropout:
        o_wide, lse_ref, grads = jax_dropout_reference(monkeypatch, q, k, v,
                                                       do)
        o_ref = o_wide.astype(jnp.bfloat16)
        grads_ref = [g.astype(jnp.bfloat16) for g in grads]
        # delta from the float32 o that JAX's vjp differentiates through
        o_for_delta = torch.tensor(np.asarray(o_wide))
    else:
        o_ref, lse_ref, *grads_ref = jax_reference(q, k, v, do, seq_len)
        o_for_delta = as_bf16(o_ref)
    o, lse = emulate_fwd(qt, kt, vt, dropout, SEED)
    assert within_bf16_steps(o.bfloat16(), o_ref, 1)
    assert max_rel(lse.numpy(), lse_ref) <= TOL_F32
    grads = emulate_bwd(qt, kt, vt, o_for_delta, dot,
                        torch.tensor(np.asarray(lse_ref)), dropout, SEED)
    for name, got, want in zip(("dq", "dk", "dv"), grads, grads_ref):
        assert within_bf16_steps(got, want, 2), name


def test_one_bf16_term_for_p_misses_the_bar():
    """Rounding P once to bf16 moves o (before its own rounding) by far
    more than the kernels' float32 bar of 2e-5 of the largest value, and
    the rounded o by more than one bf16 step; the two-term split stays
    within both."""
    q, k, v, _ = (as_bf16(a) for a in attention_case(256, seed=3))
    wide = flash_attention.flash_attention_fwd_ref(q.float(), k.float(),
                                                   v.float())[0]
    want = flash_attention.flash_attention_fwd_ref(q, k, v)[0].float()
    two, _ = emulate_fwd(q, k, v)
    one, _ = emulate_fwd(q, k, v, terms=1)
    assert max_rel(two, wide) <= 2e-5 / 4 < 10 * 2e-5 <= max_rel(one, wide)
    assert within_bf16_steps(two.bfloat16(), want.numpy(), 1)
    assert not within_bf16_steps(one.bfloat16(), want.numpy(), 1)


@pytest.mark.parametrize("dtype,head_dim,padded", [
    (torch.bfloat16, 8, 16), (torch.bfloat16, 24, 32),
    (torch.bfloat16, 48, 48), (torch.bfloat16, 121, 128),
    (torch.float32, 4, 8), (torch.float32, 24, 24), (torch.float32, 48, 48)])
def test_padded_head_dim_is_the_mma_depth_in_bf16(dtype, head_dim, padded):
    """bf16 pads head_dim to a multiple of 16 (the depth of a tensor-core
    product), float32 to one of 8; `_pad_heads` follows the tensors'
    dtype."""
    assert flash_attention.padded_head_dim(head_dim, dtype) == padded
    q = torch.randn(2, 3, head_dim).to(dtype)
    (p,) = flash_attention._pad_heads(head_dim, q)
    assert p.shape == (2, 3, padded) and p.dtype == dtype
    assert torch.equal(p[..., :head_dim], q) and not p[..., head_dim:].any()
