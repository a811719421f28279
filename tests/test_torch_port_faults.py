"""Shapes that the JAX package computes and the port once refused, on the
CPU: a UNet whose attention heads are 4 wide (no multiple of 8, which the
attention kernels pad to on the card) and a DiM with 40 states a channel
(more than the scan kernels' 32, which the JAX package sends to its XLA
scan). Both run the plain versions here and are held to the JAX models with
the same weights at 2e-4, the forward bar of tests/test_torch_port_unet.py
and tests/test_torch_port_dim.py; the wrappers themselves are held to their
plain versions and to JAX at those shapes. On the card the same shapes pad
(head_dim) or run in chunks of 32 states (state size): `cuda` tests in
tests/test_torch_port_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.models import DiM as JaxDiM
from diffusion_models_collection_tpu.models import UNet as JaxUNet
from diffusion_models_collection_tpu.ops import attention as jax_attention
from diffusion_models_collection_tpu.ops.selective_scan import (
    selective_scan as jax_selective_scan,
)
from diffusion_models_collection_tpu_torch.models import DiM, UNet
from diffusion_models_collection_tpu_torch.ops import (
    attention,
    flash_attention,
)
from diffusion_models_collection_tpu_torch.ops import selective_scan as ss
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    DIM_PARAMS,
    MODEL_PARAMS,
    max_rel,
    one_torch_thread,
    perturbed,
    small_config,
    small_dim_config,
)

TOL = 2e-4


def model_inputs(seed, batch=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 16, 16, 3)).astype(np.float32)
    t = np.array([0, 10, 500, 999][:batch], np.int64)
    y = np.array([1, 4, 7, 10][:batch], np.int64)
    return x, t, y


def test_unet_with_head_dim_4_matches_jax():
    """16 channels at the attention level, 4 heads: head_dim 4."""
    params_kw = dict(MODEL_PARAMS, model_channels=16, channel_mult=(1, 1))
    config = dict(small_config(), model_params=params_kw)
    model = JaxUNet(**params_kw, num_classes=10)
    x, t, y = model_inputs(0)
    params = perturbed(model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))["params"], 0)
    ref = model.apply({"params": params}, jnp.asarray(x),
                      jnp.asarray(t, jnp.int32), jnp.asarray(y, jnp.int32))
    ours = UNet(**params_kw, num_classes=10)
    ours.load_state_dict(state_dict_from_jax(params, config), strict=True)
    seen = []
    real = flash_attention.flash_attention_fwd

    def recording(q, k, v, *dropout):
        seen.append(q.shape[-1])
        return real(q, k, v, *dropout)

    flash_attention.flash_attention_fwd = recording
    try:
        with torch.no_grad():
            out = ours.eval()(torch.from_numpy(x), torch.from_numpy(t),
                              torch.from_numpy(y))
    finally:
        flash_attention.flash_attention_fwd = real
    assert seen and set(seen) == {4}
    assert out.shape == ref.shape == (4, 16, 16, 3)
    assert max_rel(out.numpy(), ref) <= TOL


@pytest.mark.parametrize("head_dim", [4, 12, 20, 136])
def test_attention_of_any_head_dim_matches_jax_and_its_gradients(head_dim):
    rng = np.random.default_rng(head_dim)
    q, k, v, do = (rng.standard_normal((2, 10, 2 * head_dim)).astype(
        np.float32) for _ in range(4))
    ref, vjp = jax.vjp(
        lambda *a: jax_attention.multihead_attention(*a, 2),
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = attention.multihead_attention(*leaves, 2)
    assert max_rel(out.detach().numpy(), ref) <= 1e-5
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for got, want in zip(grads, vjp(jnp.asarray(do))):
        assert max_rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("head_dim,padded", [(4, 8), (8, 8), (12, 16),
                                             (64, 64), (121, 128)])
def test_padded_head_dim_is_the_next_multiple_of_8(head_dim, padded):
    assert flash_attention.padded_head_dim(head_dim) == padded
    q = torch.randn(2, 3, head_dim)
    (p,) = flash_attention._pad_heads(head_dim, q)
    assert p.shape == (2, 3, padded)
    assert torch.equal(p[..., :head_dim], q) and not p[..., head_dim:].any()
    (back,) = flash_attention._cut_heads(head_dim, p)
    assert torch.equal(back, q) and back.is_contiguous()
    # zero columns change no score, and the scale stays 1 / sqrt(head_dim)
    o, lse = flash_attention.flash_attention_fwd_ref(q, q, q)
    scale = (padded / head_dim) ** 0.5
    o_pad, lse_pad = flash_attention.flash_attention_fwd_ref(p * scale, p, p)
    torch.testing.assert_close(o_pad[..., :head_dim], o, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse_pad, lse, rtol=1e-5, atol=1e-6)


def test_dim_with_40_states_matches_jax():
    dim_kw = dict(DIM_PARAMS, state_size=40)
    config = small_dim_config()
    config["model_params"] = dict(dim_kw, img_size=(16, 16))
    model = JaxDiM(img_size=(16, 16), **dim_kw, num_classes=10)
    x, t, y = model_inputs(1)
    params = perturbed(model.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))["params"], 1)
    ref = model.apply({"params": params}, jnp.asarray(x),
                      jnp.asarray(t, jnp.int32), jnp.asarray(y, jnp.int32))
    ours = DiM(img_size=(16, 16), **dim_kw, num_classes=10)
    ours.load_state_dict(state_dict_from_jax(params, config), strict=True)
    with torch.no_grad():
        out = ours.eval()(torch.from_numpy(x), torch.from_numpy(t),
                          torch.from_numpy(y))
    assert out.shape == ref.shape == (4, 16, 16, 3)
    assert max_rel(out.numpy(), ref) <= TOL


@pytest.mark.parametrize("n_state,length", [(33, 32), (40, 100), (64, 20)])
def test_scan_beyond_32_states_matches_jax_and_its_gradients(n_state, length):
    assert n_state > ss.STATE_CHUNK
    rng = np.random.default_rng(n_state)
    x = rng.standard_normal((2, length, 24)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal(x.shape))).astype(np.float32)
    A = -np.exp(rng.standard_normal((24, n_state))).astype(np.float32)
    B, C = (rng.standard_normal((2, length, n_state)).astype(np.float32)
            for _ in range(2))
    D = np.linspace(0.5, 1.5, 24).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    args = (x, dt, A, B, C, D)
    ref, vjp = jax.vjp(jax_selective_scan, *map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    for save_states in (True, False):
        out = ss.selective_scan(*leaves, save_states=save_states)
        assert max_rel(out.detach().numpy(), ref) <= 1e-5
        grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
        for got, want in zip(grads, vjp(jnp.asarray(g))):
            assert max_rel(got.numpy(), want) <= 1e-4
