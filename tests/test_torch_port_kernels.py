"""The port's kernel wrappers: what they accept, and on a CUDA card, the
hand-written kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on the GPU machine, where the
JAX package is absent:

    python -m pytest --noconftest tests/test_torch_port_kernels.py

Tests marked `cuda` skip where no CUDA device is present. On the card the
tolerance is max|kernel - plain| / max|plain| <= 2e-5 for the forwards
(float32 on both sides, TF32 off, sums in different orders), <= 1e-5
absolute on lse, and <= 1e-4 for the attention backward, whose dS sums a
difference of two products over L keys, and for the scan backward, whose
adjoint runs over L steps and whose dB, dC sum over the D channels.
"""

import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu_torch.models import DiM, UNet
from diffusion_models_collection_tpu_torch.models import dim as dim_mod
from diffusion_models_collection_tpu_torch.models import unet as unet_mod
from diffusion_models_collection_tpu_torch.ops import (
    attention as attention_mod,
    flash_attention,
    fused_norm,
)
from diffusion_models_collection_tpu_torch.ops import (
    selective_scan as scan_mod,
)
from diffusion_models_collection_tpu_torch.ops.plain import plain_kernels

TOL = 2e-5
TOL_LSE = 1e-5
TOL_BWD = 1e-4


def max_rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# ------------------------------------------------------------------ any host
def test_wrappers_on_cpu_run_the_plain_versions_and_count_no_launch():
    gn_before, fa_before = fused_norm.LAUNCHES, flash_attention.LAUNCHES
    x = torch.randn(2, 4, 4, 16)
    scale, bias = torch.rand(16), torch.rand(16)
    torch.testing.assert_close(
        fused_norm.group_norm_silu(x, scale, bias, 8),
        fused_norm.group_norm_silu_ref(x, scale, bias, 8), rtol=0, atol=0)
    q = torch.randn(3, 10, 16)
    for got, want in zip(flash_attention.flash_attention_fwd(q, q, q),
                         flash_attention.flash_attention_fwd_ref(q, q, q)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (fused_norm.LAUNCHES, flash_attention.LAUNCHES) == (gn_before,
                                                               fa_before)


@pytest.mark.parametrize("case", ["float64", "strided", "groups", "scale"])
def test_group_norm_silu_rejects_what_the_kernel_does_not_take(case):
    x = torch.randn(2, 4, 4, 16)
    scale, bias = torch.ones(16), torch.zeros(16)
    groups = 8
    if case == "float64":
        x = x.double()
    elif case == "strided":
        x = x.transpose(1, 2)
    elif case == "groups":
        groups = 3
    else:
        scale = torch.ones(8)
    with pytest.raises((ValueError, TypeError)):
        fused_norm.group_norm_silu(x, scale, bias, groups)


@pytest.mark.parametrize("shape", [(2, 8, 136), (2, 8, 12), (2, 8)])
def test_flash_attention_rejects_what_the_kernel_does_not_take(shape):
    q = torch.randn(shape)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_fwd(q, q, q)
    q = torch.randn(2, 8, 16)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_fwd(q, q, torch.randn(2, 9, 16))


def test_attention_raises_on_paths_not_ported():
    q = torch.randn(1, 4, 8)
    with pytest.raises(NotImplementedError):
        attention_mod.multihead_attention(q, q, q, 2, dropout_rate=0.1,
                                          deterministic=False)
    with pytest.raises(NotImplementedError):
        attention_mod.multihead_attention(q, q, q, 2,
                                          key_sizes=torch.ones(1, 4))


def test_plain_kernels_reroutes_the_call_sites_and_restores_them():
    wrappers = (unet_mod.group_norm_silu, attention_mod.flash_attention,
                dim_mod.selective_scan)
    with pytest.raises(RuntimeError):
        with plain_kernels():
            assert unet_mod.group_norm_silu is fused_norm.group_norm_silu_ref
            assert (attention_mod.flash_attention
                    is flash_attention.flash_attention_ref)
            assert dim_mod.selective_scan is scan_mod.selective_scan_ref
            raise RuntimeError("leaves the context early")
    assert (unet_mod.group_norm_silu, attention_mod.flash_attention,
            dim_mod.selective_scan) == wrappers
    assert wrappers == (fused_norm.group_norm_silu,
                        flash_attention.flash_attention,
                        scan_mod.selective_scan)


def test_kernel_ops_are_autograd_functions_that_reach_every_input():
    """The wrappers once returned a fresh tensor with no grad_fn, so on the
    card a loss stopped at them and only the output conv trained; on the
    CPU the plain versions hid that. The ops are now autograd Functions on
    both devices."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 4, 16, generator=gen, requires_grad=True)
    scale = torch.rand(16, generator=gen, requires_grad=True)
    bias = torch.rand(16, generator=gen, requires_grad=True)
    y = fused_norm.group_norm_silu(x, scale, bias, 8)
    assert type(y.grad_fn).__name__ == "GroupNormSiLUBackward"
    q, k, v = (torch.randn(3, 10, 16, generator=gen, requires_grad=True)
               for _ in range(3))
    o = flash_attention.flash_attention(q, k, v)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    (y.square().sum() + o.square().sum()).backward()
    for t in (x, scale, bias, q, k, v):
        assert t.grad is not None and t.grad.abs().max() > 0


def test_flash_attention_bwd_rejects_a_wrong_lse():
    q = torch.randn(2, 8, 16)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_bwd(q, q, q, q, q, torch.zeros(2, 8))
    with pytest.raises(ValueError):
        flash_attention.flash_attention_bwd(q, q, q, q, q.transpose(1, 2),
                                            torch.zeros(2, 8, 1))


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 32, 32, 128), (4, 16, 16, 384),
                                   (4, 4, 4, 512), (3, 5, 7, 24),
                                   (2, 1, 1, 8)])
def test_gn_silu_kernel_matches_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(0)
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=cuda) * 2 + 0.5
    scale = 1 + 0.1 * torch.randn(c, generator=gen, device=cuda)
    bias = 0.1 * torch.randn(c, generator=gen, device=cuda)
    before = fused_norm.LAUNCHES
    y = fused_norm.group_norm_silu_fwd(x, scale, bias, 8)
    torch.cuda.synchronize()
    assert fused_norm.LAUNCHES == before + 1
    assert max_rel(y, fused_norm.group_norm_silu_ref(x, scale, bias, 8)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("seq_len", [256, 64, 16, 100, 1])
@pytest.mark.parametrize("head_dim", [64, 8, 40, 128])
def test_flash_attention_kernel_matches_plain(cuda, seq_len, head_dim):
    gen = torch.Generator(device=cuda).manual_seed(seq_len + head_dim)
    q, k, v = (torch.randn(6, seq_len, head_dim, generator=gen, device=cuda)
               for _ in range(3))
    before = flash_attention.LAUNCHES
    o, lse = flash_attention.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == before + 1
    o_ref, lse_ref = flash_attention.flash_attention_fwd_ref(q, k, v)
    assert max_rel(o, o_ref) <= TOL
    assert (lse - lse_ref).abs().max().item() <= TOL_LSE


@pytest.mark.cuda
def test_small_unet_forward_kernels_match_plain(cuda):
    torch.manual_seed(0)
    model = UNet(image_size=(16, 16), model_channels=32, num_res_blocks=1,
                 attention_resolutions=(8,), channel_mult=(1, 2),
                 num_classes=10).to(cuda).eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        rng.standard_normal((4, 16, 16, 3)).astype(np.float32)).to(cuda)
    t = torch.tensor([0, 10, 500, 999], device=cuda)
    y = torch.tensor([0, 1, 5, 10], device=cuda)
    with torch.no_grad():
        out = model(x, t, y)
        with plain_kernels():
            ref = model(x, t, y)
    assert max_rel(out, ref) <= 1e-4


def attention_bwd_inputs(bh, seq_len, head_dim, gen, device):
    """q, k, v, the forward's o and lse, and an output gradient dO."""
    q, k, v, do = (torch.randn(bh, seq_len, head_dim, generator=gen,
                               device=device) for _ in range(4))
    o, lse = flash_attention.flash_attention_fwd_ref(q, k, v)
    return q, k, v, o, do, lse


@pytest.mark.cuda
@pytest.mark.parametrize("bh,seq_len,head_dim", [
    (128, 256, 64), (128, 64, 64), (128, 16, 64), (128, 100, 64),
    (128, 256, 32), (128, 256, 128), (6, 3, 8), (6, 70, 40),
    (512, 256, 64), (512, 64, 64), (512, 16, 64),
])
def test_flash_attention_bwd_kernel_matches_plain(cuda, bh, seq_len,
                                                  head_dim):
    gen = torch.Generator(device=cuda).manual_seed(seq_len + head_dim)
    args = attention_bwd_inputs(bh, seq_len, head_dim, gen, cuda)
    before = flash_attention.BWD_LAUNCHES
    grads = flash_attention.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    assert flash_attention.BWD_LAUNCHES == before + 1
    for got, want in zip(grads, flash_attention.flash_attention_bwd_ref(*args)):
        assert max_rel(got, want) <= TOL_BWD


@pytest.mark.cuda
def test_flash_attention_function_grads_match_autograd_on_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(8, 100, 64, generator=gen, device=cuda,
                           requires_grad=True) for _ in range(3))
    do = torch.randn(8, 100, 64, generator=gen, device=cuda)
    got = torch.autograd.grad(flash_attention.flash_attention(q, k, v),
                              (q, k, v), do)
    want = torch.autograd.grad(flash_attention.flash_attention_ref(q, k, v),
                               (q, k, v), do)
    for g, w in zip(got, want):
        assert max_rel(g, w) <= TOL_BWD


@pytest.mark.cuda
def test_every_unet_parameter_gets_a_gradient_on_the_card(cuda):
    """The fault the autograd Functions repair: with it, only `output.2`
    (the conv after the last GN+SiLU) had a gradient on the card."""
    torch.manual_seed(0)
    model = UNet(image_size=(16, 16), model_channels=32, num_res_blocks=1,
                 attention_resolutions=(8,), channel_mult=(1, 2),
                 num_classes=10).to(cuda).train()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        rng.standard_normal((4, 16, 16, 3)).astype(np.float32)).to(cuda)
    t = torch.tensor([0, 10, 500, 999], device=cuda)
    y = torch.tensor([0, 1, 5, 10], device=cuda)
    gn, fwd, bwd = (fused_norm.LAUNCHES, flash_attention.LAUNCHES,
                    flash_attention.BWD_LAUNCHES)
    model(x, t, y).square().mean().backward()
    torch.cuda.synchronize()
    assert fused_norm.LAUNCHES > gn and flash_attention.LAUNCHES > fwd
    assert flash_attention.BWD_LAUNCHES > bwd
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        if name == "label_embed.weight":
            # row 0, the null label, is masked at lookup
            assert p.grad[0].abs().max() == 0 and p.grad[1:].abs().max() > 0
        else:
            assert p.grad.abs().max() > 0, name


@pytest.mark.cuda
def test_small_unet_loss_and_grads_kernels_match_plain(cuda):
    torch.manual_seed(0)
    model = UNet(image_size=(16, 16), model_channels=32, num_res_blocks=1,
                 attention_resolutions=(8,), channel_mult=(1, 2),
                 num_classes=10).to(cuda).eval()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(
        rng.standard_normal((4, 16, 16, 3)).astype(np.float32)).to(cuda)
    t = torch.tensor([0, 10, 500, 999], device=cuda)
    y = torch.tensor([0, 1, 5, 10], device=cuda)

    def loss_and_grads():
        model.zero_grad()
        loss = model(x, t, y).square().mean()
        loss.backward()
        return loss.detach(), torch.cat(
            [p.grad.flatten() for p in model.parameters()])

    loss, grads = loss_and_grads()
    with plain_kernels():
        loss_ref, grads_ref = loss_and_grads()
    assert max_rel(loss, loss_ref) <= 1e-5
    assert max_rel(grads, grads_ref) <= 1e-4


# ------------------------------------------------------ the selective scan
def scan_inputs(batch, length, d_inner, n_state, gen, device):
    """x, dt > 0, A < 0 (S4D-like, down to -n_state), B, C and an output
    gradient g, on `device`."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    x = randn(batch, length, d_inner)
    dt = torch.nn.functional.softplus(randn(batch, length, d_inner) - 2)
    A = -torch.exp(randn(d_inner, n_state) * 0.5) * torch.arange(
        1, n_state + 1, device=device)
    return x, dt, A, randn(batch, length, n_state), randn(
        batch, length, n_state), randn(batch, length, d_inner)


def test_scan_ref_function_matches_the_kernel_function_on_cpu():
    """`SelectiveScanRef`, the scan that `plain_kernels()` runs, equals
    `SelectiveScan` on the CPU (both run the plain versions there)."""
    gen = torch.Generator().manual_seed(0)
    args = [t.requires_grad_() for t in scan_inputs(2, 40, 8, 4, gen,
                                                    "cpu")[:5]]
    got = scan_mod.selective_scan(*args)
    want = scan_mod.selective_scan_ref(*args)
    assert type(want.grad_fn).__name__ == "SelectiveScanRefBackward"
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for g, w in zip(torch.autograd.grad(got.sum(), args),
                    torch.autograd.grad(want.sum(), args)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,length,d_inner,n_state", [
    (32, 256, 768, 16), (8, 48, 768, 16), (8, 100, 768, 16),
    (3, 1, 100, 16), (2, 37, 200, 4), (2, 64, 130, 20), (2, 33, 64, 32),
])
def test_scan_fwd_kernel_matches_plain(cuda, batch, length, d_inner,
                                       n_state):
    gen = torch.Generator(device=cuda).manual_seed(length + d_inner)
    x, dt, A, B, C, _ = scan_inputs(batch, length, d_inner, n_state, gen,
                                    cuda)
    for save in (False, True):
        before = (scan_mod.FWD_LAUNCHES, scan_mod.FWD_STATES_LAUNCHES)
        y, bound = scan_mod.selective_scan_fwd(x, dt, A, B, C, save)
        torch.cuda.synchronize()
        assert (scan_mod.FWD_LAUNCHES, scan_mod.FWD_STATES_LAUNCHES) == (
            before[0] + 1, before[1] + save)
        y_ref, bound_ref = scan_mod.selective_scan_fwd_ref(x, dt, A, B, C,
                                                           save)
        assert max_rel(y, y_ref) <= TOL
        if save:
            assert bound.shape == bound_ref.shape
            assert (bound - bound_ref).abs().max().item() <= TOL * max(
                bound_ref.abs().max().item(), 1.0)
        else:
            assert bound is None


@pytest.mark.cuda
@pytest.mark.parametrize("batch,length,d_inner,n_state", [
    (32, 256, 768, 16), (8, 48, 768, 16), (8, 100, 768, 16),
    (3, 1, 100, 16), (2, 37, 200, 4), (2, 64, 130, 20), (2, 33, 64, 32),
])
def test_scan_bwd_kernel_matches_plain(cuda, batch, length, d_inner,
                                       n_state):
    gen = torch.Generator(device=cuda).manual_seed(length + d_inner + 1)
    x, dt, A, B, C, g = scan_inputs(batch, length, d_inner, n_state, gen,
                                    cuda)
    _, bound = scan_mod.selective_scan_fwd_ref(x, dt, A, B, C, True)
    before = scan_mod.BWD_LAUNCHES
    grads = scan_mod.selective_scan_bwd(x, dt, A, B, C, g, bound)
    torch.cuda.synchronize()
    assert scan_mod.BWD_LAUNCHES == before + 1
    refs = scan_mod.selective_scan_bwd_ref(x, dt, A, B, C, g, bound)
    for name, got, want in zip(("dx", "ddt", "dA", "dB", "dC"), grads, refs):
        assert got.shape == want.shape, name
        assert max_rel(got, want) <= TOL_BWD, name


def small_dim(device):
    torch.manual_seed(0)
    return DiM(img_size=(16, 16), patch_size=2, hidden_size=64, depth=2,
               state_size=16, num_classes=10).to(device)


def perturb_(model, seed=0):
    """Seeded noise on every parameter, so adaLN gates and the output
    projection are not zero and every parameter sees a gradient."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen).to(p.device))
    return model


@pytest.mark.cuda
def test_small_dim_forward_kernels_match_plain(cuda):
    model = perturb_(small_dim(cuda)).eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        rng.standard_normal((4, 16, 16, 3)).astype(np.float32)).to(cuda)
    t = torch.tensor([0, 10, 500, 999], device=cuda)
    y = torch.tensor([0, 1, 5, 10], device=cuda)
    before = scan_mod.FWD_LAUNCHES
    with torch.no_grad():
        out = model(x, t, y)
        assert scan_mod.FWD_LAUNCHES == before + 2
        with plain_kernels():
            ref = model(x, t, y)
    assert scan_mod.FWD_LAUNCHES == before + 2
    assert max_rel(out, ref) <= 1e-4


@pytest.mark.cuda
def test_every_dim_parameter_gets_a_gradient_on_the_card(cuda):
    model = perturb_(small_dim(cuda)).train()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(
        rng.standard_normal((4, 16, 16, 3)).astype(np.float32)).to(cuda)
    t = torch.tensor([0, 10, 500, 999], device=cuda)
    y = torch.tensor([0, 1, 5, 10], device=cuda)
    fwd, saved, bwd = (scan_mod.FWD_LAUNCHES, scan_mod.FWD_STATES_LAUNCHES,
                       scan_mod.BWD_LAUNCHES)
    model(x, t, y).square().mean().backward()
    torch.cuda.synchronize()
    assert (scan_mod.FWD_LAUNCHES - fwd, scan_mod.FWD_STATES_LAUNCHES - saved,
            scan_mod.BWD_LAUNCHES - bwd) == (2, 2, 2)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        if name == "y_embedder.embedding_table.weight":
            # row 0, the null label, is masked at lookup
            assert p.grad[0].abs().max() == 0 and p.grad[1:].abs().max() > 0
        else:
            assert p.grad.abs().max() > 0, name


@pytest.mark.cuda
def test_small_dim_loss_and_grads_kernels_match_plain(cuda):
    model = perturb_(small_dim(cuda), seed=1).eval()
    rng = np.random.default_rng(2)
    x = torch.from_numpy(
        rng.standard_normal((4, 16, 16, 3)).astype(np.float32)).to(cuda)
    t = torch.tensor([0, 10, 500, 999], device=cuda)
    y = torch.tensor([0, 1, 5, 10], device=cuda)

    def loss_and_grads():
        model.zero_grad()
        loss = model(x, t, y).square().mean()
        loss.backward()
        return loss.detach(), torch.cat(
            [p.grad.flatten() for p in model.parameters()])

    loss, grads = loss_and_grads()
    with plain_kernels():
        loss_ref, grads_ref = loss_and_grads()
    assert max_rel(loss, loss_ref) <= 1e-5
    assert max_rel(grads, grads_ref) <= 1e-4
