"""Attention dropout in the PyTorch port, on the CPU: the Philox4x32-10
keep mask that the flash kernels and their plain versions share, and the
port's attention with dropout against the JAX package's.

JAX's threefry and the port's Philox never agree by seed, so the JAX side
gets the port's mask: `jax.random.bernoulli`, which the JAX
`dot_product_attention` calls for its keep mask, is replaced in the test by
a function that returns it (the JAX package is not edited). Bars, as
max|port - jax| / max|jax|: 2e-4 for the forward and its gradients (the
repo's forward bar, tests/test_torch_import.py:63).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.ops import attention as jax_attention
from diffusion_models_collection_tpu_torch.ops import attention
from diffusion_models_collection_tpu_torch.ops import flash_attention as fa
from torch_port_helpers import max_rel

TOL = 2e-4
P = 0.1

MASK32 = 0xFFFFFFFF


# Random123's published known answers for Philox4x32-10
@pytest.mark.parametrize("counter,key,out", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((MASK32,) * 4, (MASK32, MASK32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, out):
    words = fa.philox4x32(counter, key)
    assert tuple(int(w) for w in words) == out


def test_mask_words_are_the_philox_counters_of_each_key():
    """Key col of row r of head h: word col & 3 of the call at counter
    (col >> 2, r, h, 0) under (seed lo, seed hi), kept below the
    threshold."""
    seed = 0x0123_4567_89AB_CDEF
    mask = fa.philox_keep_mask(seed, 3, 5, 11, P)
    threshold = fa.dropout_threshold(P)
    assert threshold == int(0.9 * 2**32)
    for h, r, col in [(0, 0, 0), (2, 4, 10), (1, 3, 7), (2, 0, 5)]:
        word = fa.philox4x32((col >> 2, r, h, 0),
                             (seed & MASK32, seed >> 32))[col & 3]
        assert bool(mask[h, r, col]) == (int(word) < threshold)


@pytest.mark.parametrize("bh0,row0,col0,bh,lq,lk", [
    (0, 0, 0, 6, 40, 40), (1, 5, 9, 2, 7, 13), (3, 17, 2, 1, 1, 1),
    (2, 0, 33, 4, 40, 7),
])
def test_mask_of_a_sub_block_is_the_slice_of_the_whole(bh0, row0, col0, bh,
                                                        lq, lk):
    """Tile by tile, any tiling gives the same mask: the kernels' forms
    and the backward's regeneration agree with the whole."""
    seed = 987654321987654321
    whole = fa.philox_keep_mask(seed, 6, 40, 40, P)
    sub = fa.philox_keep_mask(seed, bh, lq, lk, P, bh0=bh0, row0=row0,
                              col0=col0)
    assert torch.equal(sub, whole[bh0:bh0 + bh, row0:row0 + lq,
                                  col0:col0 + lk])


def test_mask_keeps_one_minus_p_of_a_million_draws():
    keep = fa.philox_keep_mask(2024, 4, 500, 500, P)
    assert keep.numel() == 10**6
    assert abs(keep.float().mean().item() - (1 - P)) <= 0.01 * (1 - P)


def test_mask_changes_with_the_seed_head_and_row():
    a = fa.philox_keep_mask(1, 2, 8, 64, 0.5)
    assert not torch.equal(a, fa.philox_keep_mask(2, 2, 8, 64, 0.5))
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a[:, 0], a[:, 1])


def qkv(seed, batch, length, dim):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, length, dim)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("batch,length,heads,dim", [(2, 16, 4, 64),
                                                    (3, 37, 2, 24)])
def test_attention_with_dropout_matches_jax_with_the_ports_mask(
        monkeypatch, batch, length, heads, dim):
    q, k, v, g = qkv(length, batch, length, dim)
    seed = attention.draw_seed(torch.Generator().manual_seed(7))
    keep = fa.philox_keep_mask(seed, batch * heads, length, length, P)
    drawn = []

    def bernoulli(key, p, shape):
        drawn.append((p, shape))
        return jnp.asarray(keep.numpy().reshape(shape))

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)

    def jax_attn(q, k, v):
        return jax_attention.multihead_attention(
            q, k, v, heads, dropout_rate=P, deterministic=False,
            dropout_rng=jax.random.PRNGKey(0))

    out_ref, vjp = jax.vjp(jax_attn, q, k, v)
    grads_ref = vjp(jnp.asarray(g))
    assert drawn and drawn[0] == (pytest.approx(1 - P),
                                  (batch, heads, length, length))

    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = attention.multihead_attention(
        *leaves, heads, dropout_rate=P, deterministic=False,
        generator=torch.Generator().manual_seed(7))
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert max_rel(out.detach(), out_ref) <= TOL
    for name, got, want in zip("qkv", grads, grads_ref):
        assert max_rel(got, want) <= TOL, name
    # and without the mask the outputs differ: the dropout was applied
    plain = attention.multihead_attention(*leaves, heads).detach()
    assert max_rel(plain, out_ref) > 1e-2


@pytest.mark.parametrize("length,dim", [(16, 64), (100, 48), (300, 8)])
def test_plain_backward_with_dropout_matches_autograd(length, dim):
    rng = np.random.default_rng(length)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (3, length, dim)).astype(np.float32)) for _ in range(4))
    drop = (P, 0xDEADBEEF_0BADF00D)
    o, lse = fa.flash_attention_fwd_ref(q, k, v, *drop)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_ref(*leaves, *drop),
                               leaves, do)
    got = fa.flash_attention_bwd_ref(q, k, v, o, do, lse, *drop)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert max_rel(g, w) <= 1e-5, name
    # lse is the undropped softmax's
    _, lse0 = fa.flash_attention_fwd_ref(q, k, v)
    torch.testing.assert_close(lse, lse0, rtol=0, atol=0)


def test_seed_comes_from_the_generator_and_only_in_training():
    q, k, v, _ = (torch.from_numpy(t) for t in qkv(0, 2, 16, 32))

    def run(**kw):
        return attention.multihead_attention(q, k, v, 4, dropout_rate=P, **kw)

    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = run(deterministic=False, generator=gen())
    torch.testing.assert_close(run(deterministic=False, generator=gen()), a,
                               rtol=0, atol=0)
    assert not torch.equal(run(deterministic=False), a)
    # the default is torch's CPU generator, which `torch.manual_seed` seeds
    torch.manual_seed(11)
    b = run(deterministic=False)
    torch.manual_seed(11)
    torch.testing.assert_close(run(deterministic=False), b, rtol=0, atol=0)
    # deterministic: no dropout and no draw
    state = torch.get_rng_state()
    torch.testing.assert_close(run(), attention.multihead_attention(q, k, v, 4),
                               rtol=0, atol=0)
    assert torch.equal(torch.get_rng_state(), state)


def test_function_saves_p_and_seed_for_its_backward():
    q, k, v, g = (torch.from_numpy(t) for t in qkv(1, 4, 20, 16))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, P, 42)
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_ref(*ref_leaves, P, 42),
                               ref_leaves, g)
    for a, b in zip(got, want):
        assert max_rel(a, b) <= 1e-5
