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
adjoint runs over L steps and whose dB, dC sum over the D channels. The
GroupNorm+SiLU backward is held to 2e-5 like the forwards: its sums run
over one group or over one channel's rows.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu_torch.models import DiM, DiT, UNet
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
    if q.dim() == 3:
        # a head_dim past 128 or no multiple of 8: the wide forms or padded
        # on the card (`cuda` tests below); the plain version on the CPU
        # takes any head_dim
        for got, want in zip(flash_attention.flash_attention_fwd(q, q, q),
                             flash_attention.flash_attention_fwd_ref(q, q, q)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        with pytest.raises(ValueError):
            flash_attention.flash_attention_fwd(q, q, q)
    q = torch.randn(2, 8, 16)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_fwd(q, q, torch.randn(2, 9, 16))


def test_attention_raises_on_paths_not_ported():
    """Proportional attention (`key_sizes`, ToMe) is ported: log(sizes) is
    the kernels' key bias, and the wrappers refuse a bias of another shape,
    type or layout. What the attention still refuses is below."""
    q = torch.randn(1, 4, 8)
    sizes = torch.tensor([[1.0, 3.0, 2.0, 1.0]])
    got = attention_mod.multihead_attention(q, q, q, 2, key_sizes=sizes)
    split = q.reshape(1, 4, 2, 4).transpose(1, 2).reshape(2, 4, 4)
    split = split.contiguous()
    want = flash_attention.flash_attention_ref(split, split, split,
                                               bias=torch.log(sizes))
    torch.testing.assert_close(
        got, want.reshape(1, 2, 4, 4).transpose(1, 2).reshape(1, 4, 8),
        rtol=0, atol=0)
    for bad in (torch.zeros(1, 5), torch.zeros(3, 4), torch.zeros(4)):
        with pytest.raises(ValueError):
            flash_attention.flash_attention(split, split, split, bias=bad)
    with pytest.raises(TypeError):
        flash_attention.flash_attention(split, split, split,
                                        bias=torch.zeros(1, 4).double())
    with pytest.raises(ValueError):
        flash_attention.flash_attention(split, split, split,
                                        bias=torch.zeros(1, 8)[:, ::2])
    # attention dropout is ported; what it refuses: p outside [0, 1), a
    # seed that is no int, a generator off the host
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q, q, 1.0, 3)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_fwd(q, q, q, 0.1, None)
    on_the_card = SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError):
        attention_mod.draw_seed(on_the_card)


def test_plain_kernels_reroutes_the_call_sites_and_restores_them():
    wrappers = (unet_mod.group_norm_silu, attention_mod.flash_attention,
                dim_mod.selective_scan)
    with pytest.raises(RuntimeError):
        with plain_kernels():
            assert unet_mod.group_norm_silu is fused_norm.group_norm_silu_plain
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


# (L, d) of every attention of a CIFAR-10 UNet train step and of the 64x64
# DiT's (L 1024), then the edges of the two choices: L 32 | 33 (tile 32 |
# 64), d 64 | 72 (the 32-row form ends at d 64), L 1024 | 1025 (fused | two
# kernels)
@pytest.mark.parametrize("seq_len,head_dim,tile,fused", [
    (256, 64, 64, True), (64, 64, 64, True), (16, 64, 32, True),
    (1, 8, 32, True), (32, 64, 32, True), (33, 64, 64, True),
    (32, 72, 64, True), (16, 128, 64, True), (100, 32, 64, True),
    (257, 64, 64, True), (1024, 64, 64, True), (1025, 64, 64, False),
    (4096, 128, 64, False),
])
def test_attention_bwd_tile_and_form_over_the_main_path_and_its_edges(
        seq_len, head_dim, tile, fused):
    assert flash_attention.bwd_tile(seq_len, head_dim) == tile
    assert flash_attention.bwd_fused(seq_len) is fused
    # the fused form's dq shares: at most 16, a scratch of at most 16 x dq
    tiles = -(-seq_len // tile)
    assert (tiles <= 16) or not fused
    assert flash_attention.FUSED_MAX_LEN == 1024


# (L, d) of every attention of a CIFAR-10 UNet forward (L 256, 64 and 16 at
# d 64), then the edges: L 64 | 65 (tile 32 | 128), d 64 | 72 (both forms end
# at d 64, beyond it tiles of 64), one row, long sequences
@pytest.mark.parametrize("seq_len,head_dim,tile", [
    (256, 64, 128), (64, 64, 32), (16, 64, 32), (65, 64, 128), (33, 64, 32),
    (1, 8, 32), (15, 32, 32), (32, 72, 64), (16, 128, 64), (1024, 64, 128),
    (1024, 128, 64), (100, 40, 128),
])
def test_attention_fwd_tile_over_the_main_path_and_its_edges(seq_len, head_dim,
                                                             tile):
    assert flash_attention.fwd_tile(seq_len, head_dim) == tile


@pytest.mark.parametrize("fused", [None, True, False])
def test_attention_bwd_form_is_ignored_by_the_plain_version_on_cpu(fused):
    gen = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(3, 70, 16, generator=gen) for _ in range(4))
    o, lse = flash_attention.flash_attention_fwd_ref(q, k, v)
    before = flash_attention.BWD_LAUNCHES
    got = flash_attention.flash_attention_bwd(q, k, v, o, do, lse,
                                              fused=fused)
    assert flash_attention.BWD_LAUNCHES == before
    for g, w in zip(got, flash_attention.flash_attention_bwd_ref(
            q, k, v, o, do, lse)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


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


# K2 in every form `fwd_tile` gives it: tiles of 32 rows (L <= 64) and of 128
# at d <= 64, of 64 beyond; d padded to 32, 64 and 128 columns (4, 12 and 20
# padded to 8, 16 and 24 first), one key tile and many, a ragged last tile
@pytest.mark.cuda
@pytest.mark.parametrize("seq_len", [256, 64, 16, 100, 1, 15, 17, 33, 257,
                                     1024])
@pytest.mark.parametrize("head_dim", [64, 8, 40, 128, 32, 4, 12, 20])
def test_flash_attention_kernel_matches_plain(cuda, seq_len, head_dim):
    gen = torch.Generator(device=cuda).manual_seed(seq_len + head_dim)
    q, k, v = (torch.randn(6, seq_len, head_dim, generator=gen, device=cuda)
               for _ in range(3))
    before = flash_attention.LAUNCHES
    o, lse = flash_attention.flash_attention_fwd(q, k, v)
    again, lse_again = flash_attention.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == before + 2
    o_ref, lse_ref = flash_attention.flash_attention_fwd_ref(q, k, v)
    assert o.shape == q.shape and lse.shape == (6, seq_len, 1)
    assert max_rel(o, o_ref) <= TOL
    assert (lse - lse_ref).abs().max().item() <= TOL_LSE
    assert torch.equal(o, again) and torch.equal(lse, lse_again)


@pytest.mark.cuda
def test_flash_attention_fwd_takes_views_that_are_not_16_byte_aligned(cuda):
    """q, k, v 4 bytes into their storage: the wrapper copies them to an
    aligned tensor for the kernel's 16-byte copies."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    inputs = [torch.randn(3, 40, 16, generator=gen, device=cuda)
              for _ in range(3)]
    shifted = []
    for t in inputs:
        flat = torch.empty(t.numel() + 1, device=cuda)
        flat[1:] = t.flatten()
        shifted.append(flat[1:].view(t.shape))
        assert shifted[-1].data_ptr() % 16 == 4
    o, lse = flash_attention.flash_attention_fwd(*shifted)
    o_ref, lse_ref = flash_attention.flash_attention_fwd_ref(*inputs)
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
@pytest.mark.parametrize("fused", [None, True, False])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("seq_len", [1, 16, 64, 100, 256, 257, 1024])
def test_flash_attention_bwd_forms_match_plain(cuda, seq_len, head_dim,
                                               fused):
    """Both forms of the backward kernel (fused, with the dq shares summed
    by a second kernel when L spans several key tiles; two kernels) at both
    tile heights, against the plain version, and equal bit for bit from one
    launch to the next."""
    gen = torch.Generator(device=cuda).manual_seed(seq_len + head_dim)
    args = attention_bwd_inputs(6, seq_len, head_dim, gen, cuda)
    before = flash_attention.BWD_LAUNCHES
    grads = flash_attention.flash_attention_bwd(*args, fused=fused)
    again = flash_attention.flash_attention_bwd(*args, fused=fused)
    torch.cuda.synchronize()
    assert flash_attention.BWD_LAUNCHES == before + 2
    refs = flash_attention.flash_attention_bwd_ref(*args)
    for name, got, twice, want in zip(("dq", "dk", "dv"), grads, again, refs):
        # with one key P = 1 and dS = 0: dq and dk are rounding noise around
        # zero, held to dv's size
        scale = (refs[2] if seq_len == 1 else want).abs().max()
        assert (got - want).abs().max() <= TOL_BWD * scale, name
        assert torch.equal(got, twice), name


DROPOUT_P, DROPOUT_SEED = 0.1, 0x1234_5678_9ABC_DEF0


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [None, False])
@pytest.mark.parametrize("head_dim", [48, 64])
@pytest.mark.parametrize("seq_len", [16, 64, 100, 256, 300])
def test_flash_attention_dropout_forms_match_plain(cuda, seq_len, head_dim,
                                                   fused):
    """K2's and K3's dropout forms (every tile form of the forward, the
    fused and the two-kernel backward) against the plain versions with the
    same seed, so the same mask, within the p = 0 forms' bars."""
    gen = torch.Generator(device=cuda).manual_seed(seq_len + head_dim)
    q, k, v, do = (torch.randn(6, seq_len, head_dim, generator=gen,
                               device=cuda) for _ in range(4))
    drop = (DROPOUT_P, DROPOUT_SEED)
    counts = (flash_attention.DROPOUT_LAUNCHES,
              flash_attention.BWD_DROPOUT_LAUNCHES)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, *drop)
    grads = flash_attention.flash_attention_bwd(q, k, v, o, do, lse, *drop,
                                                fused=fused)
    torch.cuda.synchronize()
    assert (flash_attention.DROPOUT_LAUNCHES,
            flash_attention.BWD_DROPOUT_LAUNCHES) == (counts[0] + 1,
                                                      counts[1] + 1)
    o_ref, lse_ref = flash_attention.flash_attention_fwd_ref(q, k, v, *drop)
    assert max_rel(o, o_ref) <= TOL
    assert (lse - lse_ref).abs().max() <= TOL_LSE
    refs = flash_attention.flash_attention_bwd_ref(q, k, v, o_ref, do,
                                                   lse_ref, *drop)
    for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
        assert max_rel(got, want) <= TOL_BWD, name


@pytest.mark.cuda
def test_flash_attention_dropout_mask_reads_back_bit_for_bit(cuda):
    """With v = I, o = P o Z exactly: its zeros are the dropped keys, which
    must be those of `philox_keep_mask`, and about p of them."""
    bh, seq_len = 64, 64
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k = (torch.randn(bh, seq_len, seq_len, generator=gen, device=cuda)
            for _ in range(2))
    v = torch.eye(seq_len, device=cuda).expand(bh, -1, -1).contiguous()
    o, _ = flash_attention.flash_attention_fwd(q, k, v, DROPOUT_P,
                                               DROPOUT_SEED)
    keep = flash_attention.philox_keep_mask(DROPOUT_SEED, bh, seq_len,
                                            seq_len, DROPOUT_P, device=cuda)
    assert torch.equal(o != 0, keep)
    assert abs(keep.float().mean().item() - (1 - DROPOUT_P)) <= 0.005 * (
        1 - DROPOUT_P)


@pytest.mark.cuda
def test_flash_attention_at_p_0_is_the_form_without_dropout(cuda):
    gen = torch.Generator(device=cuda).manual_seed(10)
    q, k, v = (torch.randn(12, 256, 64, generator=gen, device=cuda,
                           requires_grad=True) for _ in range(3))
    counts = (flash_attention.DROPOUT_LAUNCHES,
              flash_attention.BWD_DROPOUT_LAUNCHES)
    outs = [flash_attention.flash_attention(q, k, v, *drop)
            for drop in ((), (0.0, DROPOUT_SEED))]
    grads = [torch.autograd.grad(o.square().sum(), (q, k, v)) for o in outs]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert (flash_attention.DROPOUT_LAUNCHES,
            flash_attention.BWD_DROPOUT_LAUNCHES) == counts


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
def test_every_dit_parameter_gets_a_gradient_on_the_card(cuda):
    """A small DiT in training mode, dropout 0.1 on: its attentions run K2
    and K3 in the dropout form, and every parameter gets a gradient."""
    torch.manual_seed(0)
    model = DiT(img_size=(16, 16), patch_size=2, hidden_size=64, depth=2,
                num_heads=4, num_classes=10).to(cuda)
    perturb_(model).train()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(
        rng.standard_normal((4, 16, 16, 3)).astype(np.float32)).to(cuda)
    t = torch.tensor([0, 10, 500, 999], device=cuda)
    y = torch.tensor([0, 1, 5, 10], device=cuda)
    before = (flash_attention.DROPOUT_LAUNCHES,
              flash_attention.BWD_DROPOUT_LAUNCHES)
    model(x, t, y).square().mean().backward()
    torch.cuda.synchronize()
    assert (flash_attention.DROPOUT_LAUNCHES - before[0],
            flash_attention.BWD_DROPOUT_LAUNCHES - before[1]) == (2, 2)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        if name == "y_embedder.embedding_table.weight":
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


# ------------------------- the scan backward with no saved states (K7), and
# ------------------------- the time-split forward and backward (K9, K10)
def scan_launch_counts():
    return {name: getattr(scan_mod, name) for name in (
        "FWD_LAUNCHES", "FWD_STATES_LAUNCHES", "BWD_LAUNCHES",
        "BWD_NOSTATE_LAUNCHES", "FWD_SPLIT_LAUNCHES", "BWD_SPLIT_LAUNCHES")}


def launched_since(before):
    return {name: count - before[name]
            for name, count in scan_launch_counts().items()
            if count != before[name]}


# L 256 keeps the rebuilt states in shared memory (N 32: all of its budget),
# L 1024 in a device-memory scratch; L 100, 37 and 33 end in a ragged time
# block; D 200 and 130 are no multiple of the sweep's 64-channel tile
NOSTATE_SHAPES = [(32, 256, 768, 16), (4, 1024, 768, 16), (8, 100, 768, 16),
                  (3, 1, 100, 16), (2, 37, 200, 4), (2, 64, 130, 20),
                  (2, 33, 64, 32), (2, 256, 256, 32)]
# K9 at every chunk count `fwd_chunk_blocks` takes at L 1024, D 768 (32, 16,
# 11, 6, 3, 2 and 1 chunks at batch 1 to 48) and K10's chunks of 4, 1, 8, 2
# and 8 time blocks (`bwd_chunk_blocks`); a ragged last block (L 1000, 100,
# 37) and a ragged last chunk (L 1000: 63 blocks of 16 steps, 8 a chunk for
# K10, three chunks of 21 for K9); N 4, 5, 16, 20 and 32; D 201 and others
# no multiple of a tile
SPLIT_SHAPES = [(16, 1024, 768, 16), (2, 1024, 768, 16), (16, 1000, 768, 16),
                (8, 1024, 768, 16), (48, 1024, 640, 16), (8, 100, 768, 16),
                (3, 1, 100, 16), (2, 37, 200, 4), (2, 640, 130, 20),
                (2, 528, 64, 32), (1, 1024, 768, 16), (4, 1024, 768, 16),
                (32, 1024, 768, 16), (2, 1024, 201, 5), (3, 1024, 768, 32),
                (4, 1000, 201, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,length,d_inner,n_state", NOSTATE_SHAPES)
def test_scan_bwd_nostate_kernel_matches_plain(cuda, batch, length, d_inner,
                                               n_state):
    gen = torch.Generator(device=cuda).manual_seed(length + d_inner + 2)
    args = scan_inputs(batch, length, d_inner, n_state, gen, cuda)
    before = scan_launch_counts()
    grads = scan_mod.selective_scan_bwd_nostate(*args)
    torch.cuda.synchronize()
    assert launched_since(before) == {"BWD_NOSTATE_LAUNCHES": 1}
    refs = scan_mod.selective_scan_bwd_nostate_ref(*args)
    for name, got, want in zip(("dx", "ddt", "dA", "dB", "dC"), grads, refs):
        assert got.shape == want.shape, name
        assert max_rel(got, want) <= TOL_BWD, name


@pytest.mark.cuda
@pytest.mark.parametrize("batch,length,d_inner,n_state", SPLIT_SHAPES)
def test_scan_split_kernels_match_plain_and_the_unsplit_kernels(
        cuda, batch, length, d_inner, n_state):
    gen = torch.Generator(device=cuda).manual_seed(length + d_inner + 3)
    x, dt, A, B, C, g = scan_inputs(batch, length, d_inner, n_state, gen,
                                    cuda)
    before = scan_launch_counts()
    y, bound = scan_mod.selective_scan_fwd_split(x, dt, A, B, C)
    again, bound_again = scan_mod.selective_scan_fwd_split(x, dt, A, B, C)
    torch.cuda.synchronize()
    assert launched_since(before) == {"FWD_SPLIT_LAUNCHES": 2}
    assert torch.equal(y, again) and torch.equal(bound, bound_again)
    y_k6, bound_k6 = scan_mod.selective_scan_fwd(x, dt, A, B, C, True)
    for y_ref, bound_ref in (
            scan_mod.selective_scan_fwd_split_ref(x, dt, A, B, C),
            (y_k6, bound_k6)):
        assert max_rel(y, y_ref) <= TOL
        assert bound.shape == bound_ref.shape
        assert (bound - bound_ref).abs().max().item() <= TOL * max(
            bound_ref.abs().max().item(), 1.0)

    before = scan_launch_counts()
    grads = scan_mod.selective_scan_bwd_split(x, dt, A, B, C, g, bound_k6)
    torch.cuda.synchronize()
    assert launched_since(before) == {"BWD_SPLIT_LAUNCHES": 1}
    for refs in (
            scan_mod.selective_scan_bwd_split_ref(x, dt, A, B, C, g, bound_k6),
            scan_mod.selective_scan_bwd(x, dt, A, B, C, g, bound_k6)):
        for name, got, want in zip(("dx", "ddt", "dA", "dB", "dC"), grads,
                                   refs):
            assert got.shape == want.shape, name
            assert max_rel(got, want) <= TOL_BWD, name


# The reverse sweep that K8, K7 and K10 share: a ragged last time block
# (L 37, 100, 1000; T 16), whole blocks of 32 (L 256, 1024), N below, at and
# above a lane's four states of sixteen, D a multiple of the sweep's
# 64-channel tile and not
SWEEP_SHAPES = [(length, d_inner, n_state)
                for length in (37, 100, 256, 1000, 1024)
                for d_inner, n_state in ((768, 16), (200, 8), (200, 32),
                                         (768, 32))]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["bwd", "bwd_nostate", "bwd_split"])
@pytest.mark.parametrize("length,d_inner,n_state", SWEEP_SHAPES)
def test_scan_sweep_matches_plain_through_every_kernel(cuda, kernel, length,
                                                       d_inner, n_state):
    gen = torch.Generator(device=cuda).manual_seed(length + d_inner + n_state)
    x, dt, A, B, C, g = scan_inputs(2, length, d_inner, n_state, gen, cuda)
    _, bound = scan_mod.selective_scan_fwd_ref(x, dt, A, B, C, True)
    args = (x, dt, A, B, C, g) + (() if kernel == "bwd_nostate" else (bound,))
    fn = getattr(scan_mod, "selective_scan_" + kernel)
    grads = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    refs = scan_mod.selective_scan_bwd_ref(x, dt, A, B, C, g, bound)
    for name, got, twice, want in zip(("dx", "ddt", "dA", "dB", "dC"), grads,
                                      again, refs):
        assert got.shape == want.shape, name
        assert max_rel(got, want) <= TOL_BWD, name
        assert torch.equal(got, twice), name


@pytest.mark.cuda
@pytest.mark.parametrize("shape,save_states,expected", [
    ((4, 256, 256), True, {"FWD_LAUNCHES": 1, "FWD_STATES_LAUNCHES": 1,
                           "BWD_LAUNCHES": 1}),
    ((4, 1024, 256), True, {"FWD_SPLIT_LAUNCHES": 1, "BWD_SPLIT_LAUNCHES": 1}),
    # the 64x64 DiM's train step: K9, then K8 from its states
    ((16, 1024, 768), True, {"FWD_SPLIT_LAUNCHES": 1, "BWD_LAUNCHES": 1}),
    ((4, 256, 256), False, {"FWD_LAUNCHES": 1, "BWD_NOSTATE_LAUNCHES": 1}),
    ((4, 1024, 256), False, {"FWD_LAUNCHES": 1, "BWD_NOSTATE_LAUNCHES": 1}),
])
def test_selective_scan_branches_on_the_card(cuda, shape, save_states,
                                             expected):
    """Each branch of `SelectiveScan` launches its own kernels and no
    other, takes a non-contiguous output gradient, and agrees with the
    plain Function."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x, dt, A, B, C, g = scan_inputs(*shape, 16, gen, cuda)
    D = torch.rand(shape[2], generator=gen, device=cuda) + 0.5
    g_strided = g.transpose(0, 1).contiguous().transpose(0, 1)
    assert not g_strided.is_contiguous()

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C, D)]
        y = fn(*leaves, save_states=save_states)
        return y.detach(), torch.autograd.grad(y, leaves, g_strided)

    before = scan_launch_counts()
    y, grads = run(scan_mod.selective_scan)
    torch.cuda.synchronize()
    assert launched_since(before) == expected
    before = scan_launch_counts()
    y_ref, grads_ref = run(scan_mod.selective_scan_ref)
    assert launched_since(before) == {}
    assert max_rel(y, y_ref) <= TOL
    for name, got, want in zip(("x", "dt", "A", "B", "C", "D"), grads,
                               grads_ref):
        assert max_rel(got, want) <= TOL_BWD, name


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["bwd_split", "bwd_nostate", "fwd_split"])
def test_scan_wrappers_raise_on_the_card_and_count_no_launch(cuda, op):
    gen = torch.Generator(device=cuda).manual_seed(8)
    x, dt, A, B, C, g = scan_inputs(2, 64, 128, 16, gen, cuda)
    before = scan_launch_counts()
    with pytest.raises(ValueError):
        if op == "bwd_split":  # 2 time blocks, not 3
            scan_mod.selective_scan_bwd_split(
                x, dt, A, B, C, g, torch.zeros(2, 3, 16, 128, device=cuda))
        elif op == "bwd_nostate":
            scan_mod.selective_scan_bwd_nostate(x, dt, A, B, C, g[:, :32])
        else:
            scan_mod.selective_scan_fwd_split(x, dt, A, B.cpu(), C)
    assert launched_since(before) == {}


@pytest.mark.cuda
def test_remat_dim_launches_and_matches_the_dim_without(cuda):
    """A DiM under `remat` runs K5 twice a block (forward and recompute)
    and K7 once, saves no states, and gives the loss and gradients of the
    same model without remat (dropout on, the same draws)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(
        rng.standard_normal((4, 16, 16, 3)).astype(np.float32)).to(cuda)
    t = torch.tensor([0, 10, 500, 999], device=cuda)
    y = torch.tensor([0, 1, 5, 10], device=cuda)
    results = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = DiM(img_size=(16, 16), patch_size=2, hidden_size=64, depth=2,
                    state_size=16, num_classes=10, remat=remat).to(cuda)
        perturb_(model).train()
        before = scan_launch_counts()
        torch.manual_seed(1)
        loss = model(x, t, y).square().mean()
        loss.backward()
        torch.cuda.synchronize()
        assert launched_since(before) == (
            {"FWD_LAUNCHES": 4, "BWD_NOSTATE_LAUNCHES": 2} if remat else
            {"FWD_LAUNCHES": 2, "FWD_STATES_LAUNCHES": 2, "BWD_LAUNCHES": 2})
        results.append((loss.detach(), torch.cat(
            [p.grad.flatten() for p in model.parameters()])))
    (loss, grads), (loss_remat, grads_remat) = results
    assert max_rel(loss_remat, loss) <= 1e-5
    assert max_rel(grads_remat, grads) <= 1e-4


# ----------------- GroupNorm + SiLU: the forward's forms, its statistics and
# ----------------- the backward kernel (K1b)
# every form of `csrc/gn_silu.cu`: one warp (1 KB and 4 KB groups), 128 to
# 1024 threads, rows of 12 vectors (C / G = 48), the backward with dxh and xh
# in shared memory and (from 32 x 32 x 32 floats a group) with dxh alone; the
# generic kernels for rows that are no whole vectors (C / G = 3, 1, 2) and
# for a group beyond shared memory (64 x 64 x 16 floats)
GN_KERNEL_SHAPES = [(3, 4, 4, 256), (3, 4, 4, 512), (3, 8, 8, 256),
                    (3, 16, 16, 128), (3, 16, 16, 384), (3, 16, 16, 512),
                    (3, 32, 32, 128), (3, 32, 32, 256), (3, 32, 32, 384),
                    (2, 3, 3, 1024), (3, 5, 7, 24), (2, 2, 3, 16),
                    (2, 64, 64, 128), (2, 7, 9, 8)]


def gn_inputs(shape, gen, device):
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=device) * 2 + 0.5
    scale = 1 + 0.1 * torch.randn(c, generator=gen, device=device)
    bias = 0.1 * torch.randn(c, generator=gen, device=device)
    return x, scale, bias, torch.randn(shape, generator=gen, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GN_KERNEL_SHAPES)
def test_gn_silu_forward_and_statistics_match_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x, scale, bias, _ = gn_inputs(shape, gen, cuda)
    before = (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES)
    y, stats = fused_norm.group_norm_silu_fwd_stats(x, scale, bias, 8)
    torch.cuda.synchronize()
    assert (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES) == (before[0] + 1,
                                                              before[1])
    assert max_rel(y, fused_norm.group_norm_silu_ref(x, scale, bias, 8)) <= TOL
    assert stats.shape == (2, shape[0], 8)
    assert max_rel(stats, fused_norm.group_norm_silu_stats_ref(x, 8)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GN_KERNEL_SHAPES)
def test_gn_silu_bwd_kernel_matches_plain_and_autograd(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + 1)
    x, scale, bias, g = gn_inputs(shape, gen, cuda)
    _, stats = fused_norm.group_norm_silu_fwd_stats(x, scale, bias, 8)
    before = (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES)
    grads = fused_norm.group_norm_silu_bwd(x, scale, bias, g, stats, 8)
    again = fused_norm.group_norm_silu_bwd(x, scale, bias, g, stats, 8)
    torch.cuda.synchronize()
    assert (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES) == (before[0],
                                                              before[1] + 2)
    plain = fused_norm.group_norm_silu_bwd_ref(
        x, scale, bias, g, fused_norm.group_norm_silu_stats_ref(x, 8), 8)
    leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
    auto = torch.autograd.grad(fused_norm.group_norm_silu_ref(*leaves, 8),
                               leaves, g)
    for name, got, twice, want, want_auto in zip(
            ("dx", "dscale", "dbias"), grads, again, plain, auto):
        assert got.shape == want.shape, name
        assert max_rel(got, want) <= TOL, name
        assert max_rel(got, want_auto) <= TOL, name
        assert torch.equal(got, twice), name  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2, 2, 2048), (2, 1, 3, 4096)])
def test_gn_silu_kernels_take_rows_wider_than_the_block_for_their_size(
        cuda, shape):
    """A small group in rows of 64 and 128 vectors: the block grows to a
    row's vectors, past what the group's size alone would pick."""
    gen = torch.Generator(device=cuda).manual_seed(shape[-1])
    x, scale, bias, g = gn_inputs(shape, gen, cuda)
    y, stats = fused_norm.group_norm_silu_fwd_stats(x, scale, bias, 8)
    grads = fused_norm.group_norm_silu_bwd(x, scale, bias, g, stats, 8)
    torch.cuda.synchronize()
    assert max_rel(y, fused_norm.group_norm_silu_ref(x, scale, bias, 8)) <= TOL
    for got, want in zip(grads, fused_norm.group_norm_silu_bwd_ref(
            x, scale, bias, g, stats, 8)):
        assert max_rel(got, want) <= TOL


# K1b's cluster form: a group whose float32 copy outgrows one SM's shared
# memory, its rows split over a thread block cluster. The first group past
# one float32 copy (61 x 60 x 16 floats) and the first past two (43 x 43 x
# 16, dxh alone in one block), rows no multiple of the cluster (63 x 65),
# the SR step's four shapes at batch 2 (64 x 64 x 128, 256, 384; 32 x 32 x
# 512) and groups of 128 x 128 and 256 x 128 x 16 floats: every cluster
# size the rule picks
GN_CLUSTER_SHAPES = [(2, 61, 60, 128), (2, 43, 43, 128), (2, 63, 65, 128),
                     (2, 64, 64, 128), (2, 64, 64, 256), (2, 64, 64, 384),
                     (2, 32, 32, 512), (1, 128, 128, 128), (1, 256, 128, 128)]


def cluster_size(shape, dtype):
    """The blocks of the backward's cluster form at this shape, or None
    where it takes another form."""
    form = fused_norm.kernel_form(shape, 8, True, dtype)
    return int(form.split()[2]) if form.startswith("cluster") else None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_silu_bwd_cluster_form_takes_every_cluster_size(cuda, dtype):
    assert cluster_size((2, 43, 43, 128), dtype) is None
    assert cluster_size((2, 61, 60, 128), dtype) is not None
    for shape in GN_CLUSTER_SHAPES[3:7]:
        assert cluster_size(shape, dtype) is not None, shape
    assert {cluster_size(s, dtype) for s in GN_CLUSTER_SHAPES} >= {2, 4, 8,
                                                                   16}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GN_CLUSTER_SHAPES)
def test_gn_silu_bwd_cluster_form_matches_plain_and_autograd(cuda, shape,
                                                             dtype):
    """Against the plain backward and (float32) autograd through the plain
    forward; two launches bit for bit (the cluster's sums in rank order)."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + 2)
    x, scale, bias, g = gn_inputs(shape, gen, cuda)
    x, g = x.to(dtype), g.to(dtype)
    _, stats = fused_norm.group_norm_silu_fwd_stats(x, scale, bias, 8)
    before = fused_norm.BWD_LAUNCHES
    grads = fused_norm.group_norm_silu_bwd(x, scale, bias, g, stats, 8)
    again = fused_norm.group_norm_silu_bwd(x, scale, bias, g, stats, 8)
    torch.cuda.synchronize()
    assert fused_norm.BWD_LAUNCHES == before + 2
    for name, got, twice in zip(("dx", "dscale", "dbias"), grads, again):
        assert torch.equal(got, twice), name  # no atomics
    plain = fused_norm.group_norm_silu_bwd_ref(
        x, scale, bias, g, fused_norm.group_norm_silu_stats_ref(x, 8), 8)
    if dtype == torch.bfloat16:
        assert_bf16_close(grads[0], plain[0], 1, TOL)
        for name, got, want in zip(("dscale", "dbias"), grads[1:], plain[1:]):
            assert max_rel(got, want) <= TOL, name
        return
    leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
    auto = torch.autograd.grad(fused_norm.group_norm_silu_ref(*leaves, 8),
                               leaves, g)
    for name, got, want, want_auto in zip(("dx", "dscale", "dbias"), grads,
                                          plain, auto):
        assert max_rel(got, want) <= TOL, name
        assert max_rel(got, want_auto) <= TOL, name


@pytest.mark.cuda
def test_gn_silu_bwd_takes_views_that_are_not_16_byte_aligned(cuda):
    """x and g 4 bytes off a 16-byte boundary at a shape of the cluster form:
    the scalar generic kernel, against the plain backward and the cluster
    form on aligned copies."""
    shape = (2, 64, 64, 128)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x, scale, bias, g = gn_inputs(shape, gen, cuda)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    xs, g_s = shifted(x), shifted(g)
    assert xs.is_contiguous() and xs.data_ptr() % 16 and g_s.data_ptr() % 16
    _, stats = fused_norm.group_norm_silu_fwd_stats(x, scale, bias, 8)
    got = fused_norm.group_norm_silu_bwd(xs, scale, bias, g_s, stats, 8)
    aligned = fused_norm.group_norm_silu_bwd(x, scale, bias, g, stats, 8)
    torch.cuda.synchronize()
    plain = fused_norm.group_norm_silu_bwd_ref(x, scale, bias, g, stats, 8)
    for name, ours, theirs, want in zip(("dx", "dscale", "dbias"), got,
                                        aligned, plain):
        assert max_rel(ours, want) <= TOL, name
        assert max_rel(ours, theirs) <= TOL, name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 16, 16, 128), (3, 5, 7, 24)])
def test_group_norm_silu_function_grads_on_the_card(cuda, shape):
    """The CUDA branch of `GroupNormSiLU`: one forward and one backward
    launch, an output gradient in a channels-first layout, the gradients of
    autograd through the plain forward."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x, scale, bias, g = gn_inputs(shape, gen, cuda)
    g_t = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not g_t.is_contiguous()
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    before = (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES)
    y = fused_norm.group_norm_silu(*leaves, 8)
    got = torch.autograd.grad(y, leaves, g_t)
    torch.cuda.synchronize()
    assert (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES) == (before[0] + 1,
                                                              before[1] + 1)
    ref_leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    want = torch.autograd.grad(
        fused_norm.group_norm_silu_ref(*ref_leaves, 8), ref_leaves, g_t)
    assert (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES) == (before[0] + 1,
                                                              before[1] + 1)
    for name, ours, ref in zip(("dx", "dscale", "dbias"), got, want):
        assert max_rel(ours, ref) <= TOL, name
    with plain_kernels():
        plain_leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
        plain = torch.autograd.grad(
            unet_mod.group_norm_silu(*plain_leaves, 8), plain_leaves, g_t)
    assert (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES) == (before[0] + 1,
                                                              before[1] + 1)
    for ours, ref in zip(got, plain):
        assert max_rel(ours, ref) <= TOL


# ------------- attention with a head_dim the kernels pad, or take wide
@pytest.mark.cuda
@pytest.mark.parametrize("seq_len", [1, 16, 100, 300])
@pytest.mark.parametrize("head_dim", [4, 12, 20, 121])
def test_flash_attention_pads_a_head_dim_that_is_no_multiple_of_8(
        cuda, seq_len, head_dim):
    gen = torch.Generator(device=cuda).manual_seed(seq_len + head_dim)
    args = attention_bwd_inputs(6, seq_len, head_dim, gen, cuda)
    q, k, v = args[:3]
    before = (flash_attention.LAUNCHES, flash_attention.BWD_LAUNCHES)
    o, lse = flash_attention.flash_attention_fwd(q, k, v)
    grads = flash_attention.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    assert (flash_attention.LAUNCHES, flash_attention.BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    o_ref, lse_ref = flash_attention.flash_attention_fwd_ref(q, k, v)
    assert o.shape == q.shape and o.is_contiguous()
    assert max_rel(o, o_ref) <= TOL
    assert (lse - lse_ref).abs().max().item() <= TOL_LSE
    refs = flash_attention.flash_attention_bwd_ref(*args)
    for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
        assert got.shape == q.shape and got.is_contiguous(), name
        scale = (refs[2] if seq_len == 1 else want).abs().max()
        assert (got - want).abs().max() <= TOL_BWD * scale, name


@pytest.mark.cuda
def test_flash_attention_refuses_a_head_dim_beyond_its_limit_on_the_card(cuda):
    """There is no such limit any more: a head_dim past 128 (here 136),
    once refused, takes the wide forms, one launch each way, and what they
    refuse is what every form refuses (keys of another length than the
    values raise)."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    q, k, v, do = (torch.randn(2, 8, 136, generator=gen, device=cuda)
                   for _ in range(4))
    before = (flash_attention.WIDE_LAUNCHES, flash_attention.BWD_WIDE_LAUNCHES)
    o, lse = flash_attention.flash_attention_fwd(q, k, v)
    grads = flash_attention.flash_attention_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    assert (flash_attention.WIDE_LAUNCHES,
            flash_attention.BWD_WIDE_LAUNCHES) == (before[0] + 1,
                                                   before[1] + 1)
    o_ref, _ = flash_attention.flash_attention_fwd_ref(q, k, v)
    assert max_rel(o, o_ref) <= TOL
    refs = flash_attention.flash_attention_bwd_ref(q, k, v, o, do, lse)
    for got, want in zip(grads, refs):
        assert max_rel(got, want) <= TOL_BWD
    with pytest.raises(ValueError):
        flash_attention.flash_attention_fwd(q, q, torch.randn(
            2, 9, 136, device=cuda))


# ------------------- the scan forward's forms: states off and states on
# N below, at and above a lane's four states of sixteen (eight of thirty-two);
# D a multiple of the 64-channel tile, of 4 only, and of neither (4-byte
# copies); L with whole blocks of 32, of 16, and a ragged last block
SCAN_FWD_SHAPES = [(8, 256, 768, 16), (3, 1024, 768, 16), (2, 1000, 200, 32),
                   (4, 48, 768, 16), (8, 100, 200, 8), (2, 1024, 201, 5),
                   (3, 1, 100, 16), (2, 37, 130, 20), (2, 33, 64, 32),
                   (1, 1024, 768, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("save_states", [False, True])
@pytest.mark.parametrize("batch,length,d_inner,n_state", SCAN_FWD_SHAPES)
def test_scan_fwd_forms_match_plain(cuda, batch, length, d_inner, n_state,
                                    save_states):
    gen = torch.Generator(device=cuda).manual_seed(length + d_inner + 4)
    inputs = scan_inputs(batch, length, d_inner, n_state, gen, cuda)[:5]
    before = scan_launch_counts()
    y, bound = scan_mod.selective_scan_fwd(*inputs, save_states)
    again, _ = scan_mod.selective_scan_fwd(*inputs, save_states)
    torch.cuda.synchronize()
    expected = {"FWD_LAUNCHES": 2}
    if save_states:
        expected["FWD_STATES_LAUNCHES"] = 2
    assert launched_since(before) == expected
    y_ref, bound_ref = scan_mod.selective_scan_fwd_ref(*inputs, True)
    assert max_rel(y, y_ref) <= TOL
    assert torch.equal(y, again)
    if save_states:
        assert (bound - bound_ref).abs().max().item() <= TOL * max(
            bound_ref.abs().max().item(), 1.0)
    else:
        assert bound is None


@pytest.mark.cuda
def test_scan_fwd_takes_views_that_are_not_16_byte_aligned(cuda):
    """Inputs 4 bytes into their storage: the copies fall back to 4 bytes."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    inputs = scan_inputs(2, 100, 128, 16, gen, cuda)[:5]
    shifted = []
    for t in inputs:
        flat = torch.empty(t.numel() + 1, device=cuda)
        flat[1:] = t.flatten()
        shifted.append(flat[1:].view(t.shape))
        assert shifted[-1].data_ptr() % 16 == 4
    for save_states in (False, True):
        y, _ = scan_mod.selective_scan_fwd(*shifted, save_states)
        y_ref, _ = scan_mod.selective_scan_fwd_ref(*inputs, False)
        assert max_rel(y, y_ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["fwd", "fwd_split", "bwd", "bwd_nostate",
                                "bwd_split"])
def test_scan_takes_33_states_in_one_counted_launch_on_the_card(cuda, op):
    """33 states, once refused on the card, run (the forwards in chunks of
    32 and 1, the backwards in one launch of the wide sweep), one counted
    launch a call, and match the plain versions, which the CPU runs on the
    same inputs."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    x, dt, A, B, C, g = scan_inputs(2, 32, 64, 33, gen, cuda)
    _, bound = scan_mod.selective_scan_fwd_ref(x, dt, A, B, C, True)
    args = {"fwd": (x, dt, A, B, C), "fwd_split": (x, dt, A, B, C),
            "bwd": (x, dt, A, B, C, g, bound),
            "bwd_nostate": (x, dt, A, B, C, g),
            "bwd_split": (x, dt, A, B, C, g, bound)}[op]
    before = scan_launch_counts()
    got = getattr(scan_mod, "selective_scan_" + op)(*args)
    torch.cuda.synchronize()
    assert sum(launched_since(before).values()) == 1
    cpu = [t.cpu() for t in args]  # the plain versions take it
    want = getattr(scan_mod, "selective_scan_" + op)(*cpu)
    bar = TOL if op.startswith("fwd") else TOL_BWD
    assert max_rel(got[0].cpu(), want[0]) <= bar


# ------------------------------------------------------------ bf16 forms
# A bf16 form and its plain version compute in float32 from the same bf16
# inputs and round once, so their outputs are equal or one bf16 step apart
# where the two float32 values straddle a rounding boundary (two steps for
# the attention backward's dS, a difference of two products); an element far
# below the largest is held to the float32 bar of the largest instead, the
# size of the float32 rounding it carries. Float32 outputs (statistics, lse,
# dscale, dbias) keep the float32 bars.
def bf16_steps(a, b):
    """The number of bf16 values between a and b, elementwise."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


def assert_bf16_close(got, want, steps, tol):
    assert got.dtype == want.dtype == torch.bfloat16
    near = (got.float() - want.float()).abs() <= tol * want.float().abs().max()
    assert ((bf16_steps(got, want) <= steps) | near).all(), (
        bf16_steps(got, want).max().item())


def bf16_launch_counts():
    return (fused_norm.BF16_LAUNCHES, fused_norm.BWD_BF16_LAUNCHES,
            flash_attention.BF16_LAUNCHES, flash_attention.BWD_BF16_LAUNCHES)


def test_bf16_wrappers_on_cpu_count_no_launch():
    before = bf16_launch_counts()
    x = torch.randn(2, 4, 4, 16, dtype=torch.bfloat16)
    scale, bias = torch.rand(16), torch.rand(16)
    y = fused_norm.group_norm_silu(x, scale, bias, 8)
    assert y.dtype == torch.bfloat16
    q = torch.randn(3, 10, 16, dtype=torch.bfloat16)
    assert flash_attention.flash_attention(q, q, q).dtype == torch.bfloat16
    assert bf16_launch_counts() == before


# the UNet's shapes, a ragged one and C / G = 3 (the generic kernels), C / G
# = 4 (whole float32 vectors, no whole bf16 one), and a group of 64 x 64 x
# 16 values, too large for shared memory in float32, not in bf16
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 32, 32, 128), (4, 16, 16, 384),
                                   (4, 4, 4, 512), (3, 5, 7, 24),
                                   (2, 8, 8, 32), (2, 64, 64, 128),
                                   (2, 1, 1, 8)])
def test_gn_silu_bf16_kernels_match_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(1)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=cuda) * 2 + 0.5).bfloat16()
    scale = 1 + 0.1 * torch.randn(c, generator=gen, device=cuda)
    bias = 0.1 * torch.randn(c, generator=gen, device=cuda)
    g = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    before = bf16_launch_counts()
    y, stats = fused_norm.group_norm_silu_fwd_stats(x, scale, bias, 8)
    dx, dscale, dbias = fused_norm.group_norm_silu_bwd(x, scale, bias, g,
                                                       stats, 8)
    torch.cuda.synchronize()
    assert bf16_launch_counts()[:2] == (before[0] + 1, before[1] + 1)
    stats_ref = fused_norm.group_norm_silu_stats_ref(x, 8)
    assert_bf16_close(y, fused_norm.group_norm_silu_ref(x, scale, bias, 8), 1,
                      TOL)
    assert max_rel(stats, stats_ref) <= TOL
    dx_ref, dscale_ref, dbias_ref = fused_norm.group_norm_silu_bwd_ref(
        x, scale, bias, g, stats_ref, 8)
    if shape[1] * shape[2] * c > 8:
        assert_bf16_close(dx, dx_ref, 1, TOL)
    else:  # one value a group: dx is 0, both sides give its rounding noise
        assert dx.float().abs().max() <= 1e-4
    assert dscale.dtype == dbias.dtype == torch.float32
    assert max_rel(dscale, dscale_ref) <= TOL
    assert max_rel(dbias, dbias_ref) <= TOL


# K2 and K3's bf16 forms in every tile form, one key tile and many, ragged
# tiles (L 17, 65, 129 past the tiles of 16 and 64), the two-kernel
# backward, head_dims padded to the mma's depth of 16 (8, 12, 24, 40), with
# and without dropout
@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("fused", [None, False])
@pytest.mark.parametrize("seq_len,head_dim", [
    (256, 64), (64, 64), (16, 64), (100, 64), (1, 8), (33, 32), (257, 64),
    (1024, 64), (256, 128), (100, 48), (40, 12), (17, 8), (65, 24),
    (129, 40), (129, 64), (17, 128)])
def test_flash_attention_bf16_kernels_match_plain(cuda, seq_len, head_dim,
                                                  fused, dropout):
    gen = torch.Generator(device=cuda).manual_seed(seq_len + head_dim)
    q, k, v, do = (torch.randn(6, seq_len, head_dim, generator=gen,
                               device=cuda).bfloat16() for _ in range(4))
    drop = (dropout, 77) if dropout else (0.0, None)
    before = bf16_launch_counts()
    o, lse = flash_attention.flash_attention_fwd(q, k, v, *drop)
    grads = flash_attention.flash_attention_bwd(q, k, v, o, do, lse, *drop,
                                                fused=fused)
    torch.cuda.synchronize()
    assert bf16_launch_counts()[2:] == (before[2] + 1, before[3] + 1)
    o_ref, lse_ref = flash_attention.flash_attention_fwd_ref(q, k, v, *drop)
    assert_bf16_close(o, o_ref, 1, TOL)
    assert lse.dtype == torch.float32
    assert (lse - lse_ref).abs().max().item() <= TOL_LSE
    refs = flash_attention.flash_attention_bwd_ref(q, k, v, o, do, lse, *drop)
    for got, want in zip(grads, refs):
        assert_bf16_close(got, want, 2, TOL_BWD)


@pytest.mark.cuda
def test_flash_attention_bf16_dropout_mask_reads_back_bit_for_bit(cuda):
    """The bf16 forms' dropout: with v = I, o = P o Z to within its two-term
    split and bf16 rounding, so its zeros are the dropped keys, which must be
    those of `philox_keep_mask`; the backward's dv = (P o Z)^T dO with dO =
    I has the same zeros, transposed."""
    bh, seq_len = 64, 64
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k = (torch.randn(bh, seq_len, seq_len, generator=gen,
                        device=cuda).bfloat16() for _ in range(2))
    eye = torch.eye(seq_len, device=cuda, dtype=torch.bfloat16).expand(
        bh, -1, -1).contiguous()
    o, lse = flash_attention.flash_attention_fwd(q, k, eye, DROPOUT_P,
                                                 DROPOUT_SEED)
    _, _, dv = flash_attention.flash_attention_bwd(q, k, eye, o, eye, lse,
                                                   DROPOUT_P, DROPOUT_SEED)
    keep = flash_attention.philox_keep_mask(DROPOUT_SEED, bh, seq_len,
                                            seq_len, DROPOUT_P, device=cuda)
    assert torch.equal(o != 0, keep)
    assert torch.equal(dv != 0, keep.transpose(1, 2))


@pytest.mark.parametrize("seq_len,head_dim,fwd,bwd", [
    (16, 64, 16, 16), (1, 16, 16, 16), (17, 64, 64, 64), (64, 64, 64, 64),
    (65, 64, 128, 64), (256, 64, 128, 64), (256, 48, 128, 64),
    (16, 128, 64, 64), (1024, 128, 64, 64)])
def test_attention_bf16_tiles_over_the_main_path_and_its_edges(
        seq_len, head_dim, fwd, bwd):
    """The bf16 forms' tile rules (the UNet's L 256, 64, 16 and the DiT's
    256 at d 64, the DiM fallback's d 48, and the edges of each choice)."""
    dtype = torch.bfloat16
    assert flash_attention.fwd_tile(seq_len, head_dim, dtype) == fwd
    assert flash_attention.bwd_tile(seq_len, head_dim, dtype) == bwd


@pytest.mark.cuda
def test_bf16_attention_runs_only_its_tensor_core_forms(cuda):
    """Autograd through `flash_attention` on bf16 tensors launches one
    forward and one backward, both in the bf16 form, and those forms are
    the tensor cores': every bf16 attention kernel of the built library has
    HMMA instructions in its SASS, and no float32 one has any."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(8, 100, 64, generator=gen, device=cuda).bfloat16()
               .requires_grad_() for _ in range(3))
    before = (flash_attention.LAUNCHES, flash_attention.BWD_LAUNCHES,
              *bf16_launch_counts()[2:])
    o = flash_attention.flash_attention(q, k, v, DROPOUT_P, DROPOUT_SEED)
    torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
    after = (flash_attention.LAUNCHES, flash_attention.BWD_LAUNCHES,
             *bf16_launch_counts()[2:])
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]
    products = flash_attention.tensor_core_products()
    bf16 = {name: n for name, n in products.items() if "_bf16_" in name}
    assert bf16 and all(bf16.values()), bf16
    assert not any(n for name, n in products.items() if name not in bf16)


@pytest.mark.cuda
def test_bf16_autograd_functions_run_the_bf16_backward_on_the_card(cuda):
    """`GroupNormSiLU` and `FlashAttention` on bf16 tensors on the card:
    GroupNorm+SiLU's gradients against autograd through the plain version,
    in the parameters' float32 and the input's bf16; the attention's, which
    take delta = rowsum(dO o) from the bf16 o as the JAX backward does,
    against the wrapper's backward bit for bit and its plain version (the
    same formulas) within the bf16 bar."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = (torch.randn(4, 16, 16, 128, generator=gen, device=cuda) * 2
         ).bfloat16().requires_grad_()
    scale = (1 + 0.1 * torch.randn(128, generator=gen, device=cuda)
             ).requires_grad_()
    bias = (0.1 * torch.randn(128, generator=gen, device=cuda)
            ).requires_grad_()
    g = torch.randn(4, 16, 16, 128, generator=gen, device=cuda).bfloat16()
    got = torch.autograd.grad(fused_norm.group_norm_silu(x, scale, bias, 8),
                              (x, scale, bias), g)
    want = torch.autograd.grad(
        fused_norm.group_norm_silu_plain(x, scale, bias, 8), (x, scale, bias),
        g)
    assert_bf16_close(got[0], want[0], 1, TOL)
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32 and max_rel(a, b) <= TOL
    q, k, v = (torch.randn(8, 100, 64, generator=gen, device=cuda).bfloat16()
               .requires_grad_() for _ in range(3))
    do = torch.randn(8, 100, 64, generator=gen, device=cuda).bfloat16()
    before = bf16_launch_counts()
    got = torch.autograd.grad(flash_attention.flash_attention(q, k, v),
                              (q, k, v), do)
    assert bf16_launch_counts()[2:] == (before[2] + 1, before[3] + 1)
    o, lse = flash_attention.flash_attention_fwd(q.detach(), k.detach(),
                                                 v.detach())
    args = (q.detach(), k.detach(), v.detach(), o, do, lse)
    for a, b, c in zip(got, flash_attention.flash_attention_bwd(*args),
                       flash_attention.flash_attention_bwd_ref(*args)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        assert_bf16_close(a, c, 2, TOL_BWD)


# A bf16 model's kernel and plain runs differ where a GroupNorm+SiLU or an
# attention output rounds to the other bf16 neighbour (2^-8 relative), and
# the bf16 layers after it carry that on: the bars are of bf16 size.
# (chip_smoke.py reads up to 1.0e-2 and 4.5e-3 at full width on an H100)
TOL_BF16_MODEL, TOL_BF16_GRAD = 2e-2, 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["unet", "dit", "dim", "dim_fallback"])
def test_small_bf16_models_run_the_bf16_kernels_and_match_plain(cuda, kind):
    """A small bf16 model (float32 parameters) on the card: its forward and
    its loss's gradients through the bf16 kernels against the same inside
    `plain_kernels()`, every GroupNorm+SiLU and attention launch in the bf16
    form, the scans in float32, eps float32."""
    torch.manual_seed(0)
    common = dict(patch_size=2, hidden_size=64, depth=2, num_classes=10,
                  dropout=0.0, dtype=torch.bfloat16)
    model = {
        "unet": lambda: UNet(image_size=(16, 16), model_channels=32,
                             num_res_blocks=1, attention_resolutions=(8,),
                             channel_mult=(1, 2), num_classes=10,
                             dtype=torch.bfloat16),
        "dit": lambda: DiT(img_size=(16, 16), num_heads=4, **common),
        "dim": lambda: DiM(img_size=(16, 16), **common),
        "dim_fallback": lambda: DiM(img_size=(16, 16),
                                    use_attention_fallback=True, **common),
    }[kind]().to(cuda)
    perturb_(model).eval()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    rng = np.random.default_rng(2)
    x = torch.from_numpy(
        rng.standard_normal((4, 16, 16, 3)).astype(np.float32)).to(cuda)
    t = torch.tensor([0, 10, 500, 999], device=cuda)
    y = torch.tensor([0, 1, 5, 10], device=cuda)

    def run():
        model.zero_grad()
        out = model(x, t, y)
        out.square().mean().backward()
        return out.detach(), torch.cat(
            [p.grad.flatten() for p in model.parameters()])

    before = (bf16_launch_counts(), fused_norm.LAUNCHES,
              flash_attention.LAUNCHES, scan_launch_counts())
    out, grads = run()
    torch.cuda.synchronize()
    bf16 = [a - b for a, b in zip(bf16_launch_counts(), before[0])]
    total = [fused_norm.LAUNCHES - before[1],
             flash_attention.LAUNCHES - before[2]]
    assert bf16[0] == bf16[1] == total[0]  # every GN+SiLU call in bf16
    assert bf16[2] == bf16[3] == total[1]  # every attention call in bf16
    assert (total[0] > 0) == (kind == "unet")
    assert (total[1] > 0) == (kind != "dim")
    assert bool(launched_since(before[3])) == (kind == "dim")
    with plain_kernels():
        out_ref, grads_ref = run()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert max_rel(out, out_ref) <= TOL_BF16_MODEL
    assert max_rel(grads, grads_ref) <= TOL_BF16_GRAD


# K2 and K3's key-bias forms (ToMe's proportional attention), float32 and
# bf16, with and without dropout, at ToMe's merged lengths on the CIFAR DiT
# (L' 128 at ratio 0.5, 179 at 0.3: a ragged last tile) with d 64, at a
# head_dim that is no multiple of 16 (40) and a short sequence in the
# smallest tiles; the fused and the two-kernel backward. The bias rows are
# log of merged sizes in 1 .. 8, one row per batch item of 3, shared by its
# two heads; the bars are the forms' own without a bias.
@pytest.mark.cuda
@pytest.mark.parametrize("fused", [None, False])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq_len,head_dim", [
    (179, 64), (128, 64), (179, 40), (12, 64), (300, 64)])
def test_flash_attention_bias_forms_match_plain(cuda, seq_len, head_dim,
                                                dtype, dropout, fused):
    dtype = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(seq_len + head_dim)
    q, k, v, do = (torch.randn(6, seq_len, head_dim, generator=gen,
                               device=cuda).to(dtype) for _ in range(4))
    sizes = torch.randint(1, 9, (3, seq_len), generator=gen, device=cuda)
    bias = torch.log(sizes.float())
    drop = (dropout, 77) if dropout else (0.0, None)
    before = (flash_attention.BIAS_LAUNCHES, flash_attention.BWD_BIAS_LAUNCHES)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, *drop, bias=bias)
    grads = flash_attention.flash_attention_bwd(q, k, v, o, do, lse, *drop,
                                                fused=fused, bias=bias)
    torch.cuda.synchronize()
    assert (flash_attention.BIAS_LAUNCHES,
            flash_attention.BWD_BIAS_LAUNCHES) == (before[0] + 1,
                                                   before[1] + 1)
    o_ref, lse_ref = flash_attention.flash_attention_fwd_ref(q, k, v, *drop,
                                                             bias=bias)
    assert (lse - lse_ref).abs().max().item() <= TOL_LSE
    refs = flash_attention.flash_attention_bwd_ref(q, k, v, o, do, lse, *drop,
                                                   bias=bias)
    if dtype == torch.bfloat16:
        assert_bf16_close(o, o_ref, 1, TOL)
        for got, want in zip(grads, refs):
            assert_bf16_close(got, want, 2, TOL_BWD)
    else:
        assert max_rel(o, o_ref) <= TOL
        for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
            assert max_rel(got, want) <= TOL_BWD, name


@pytest.mark.cuda
def test_flash_attention_bias_of_zeros_is_the_form_without_one(cuda):
    """A bias of zeros gives what the form without a bias gives, to the
    rounding of one more add: the bias forms change nothing else."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(12, 179, 64, generator=gen, device=cuda)
               .requires_grad_() for _ in range(3))
    zeros = torch.zeros(2, 179, device=cuda)
    outs = []
    for bias in (None, zeros):
        o = flash_attention.flash_attention(q, k, v, bias=bias)
        outs.append((o, *torch.autograd.grad(o, (q, k, v),
                                             torch.ones_like(o))))
    for got, want in zip(*outs):
        assert max_rel(got, want) <= TOL


# ------------------- head_dim past 128 and more than 32 states (F11, F10)
# K2 and K3's wide forms: head_dim 136 (a second column block of 8), 144 (one
# 16-column block past 128), 192 (the CIFAR-10 DiT at two heads; the
# one-block forms' narrower width), 256 (the TPU kernel's widest, the
# one-block forms' wider width), 264 and 384 (the chunked forms past 256);
# L 256, a ragged 200 and 1000 (16 key tiles, fused); float32 and bf16, p 0
# and 0.1, the fused and the two-kernel backward
WIDE_HEAD_DIMS = [136, 144, 192, 256, 264, 384]


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [None, False])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq_len", [256, 200, 1000])
@pytest.mark.parametrize("head_dim", WIDE_HEAD_DIMS)
def test_flash_attention_wide_forms_match_plain(cuda, head_dim, seq_len,
                                                dtype, dropout, fused):
    gen = torch.Generator(device=cuda).manual_seed(head_dim + seq_len)
    q, k, v, do = (torch.randn(6, seq_len, head_dim, generator=gen,
                               device=cuda).to(dtype) for _ in range(4))
    drop = (dropout, 77) if dropout else (0.0, None)
    before = (flash_attention.WIDE_LAUNCHES, flash_attention.BWD_WIDE_LAUNCHES)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, *drop)
    grads = flash_attention.flash_attention_bwd(q, k, v, o, do, lse, *drop,
                                                fused=fused)
    torch.cuda.synchronize()
    assert (flash_attention.WIDE_LAUNCHES,
            flash_attention.BWD_WIDE_LAUNCHES) == (before[0] + 1,
                                                   before[1] + 1)
    o_ref, lse_ref = flash_attention.flash_attention_fwd_ref(q, k, v, *drop)
    assert (lse - lse_ref).abs().max().item() <= TOL_LSE
    refs = flash_attention.flash_attention_bwd_ref(q, k, v, o, do, lse, *drop)
    if dtype == torch.bfloat16:
        assert_bf16_close(o, o_ref, 1, TOL)
        for got, want in zip(grads, refs):
            assert_bf16_close(got, want, 2, TOL_BWD)
    else:
        assert max_rel(o, o_ref) <= TOL
        for got, want in zip(grads, refs):
            assert max_rel(got, want) <= TOL_BWD


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [None, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["bias", "cross", "head_grid", "long",
                                  "unpadded", "bias144", "bias256",
                                  "cross144", "cross256", "heads70"])
def test_flash_attention_wide_forms_in_every_variant(cuda, case, dtype,
                                                     fused):
    """The wide forms with the key bias, Lq 128 against Lk 256 (E6, row0 =
    128), both also at head_dim 144 and 256, at a tensor-parallel rank's
    head grid (E7), at 70 heads (no multiple of a tile) at another rank's,
    at L 1024 (16 key tiles) and at a head_dim the wrapper pads (196 in
    float32 to 200, 184 in bf16 to 192), each with dropout and in both
    backward forms, against the plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    lq = lk = 1024 if case == "long" else 256
    if case.startswith("cross"):
        lq = 128
    d = {"unpadded": 196 if dtype == torch.float32 else 184}.get(
        case, 144 if case.endswith("144") else 256 if case.endswith("256")
        else 192)
    bh = {"long": 4, "heads70": 70}.get(case, 6)
    q, do = (torch.randn(bh, lq, d, generator=gen, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(bh, lk, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    bias = (torch.randn(2, lk, generator=gen, device=cuda)
            if case.startswith("bias") else None)
    grid = {"head_grid": (3, 6, 1, 3), "heads70": (5, 10, 3, 5)}.get(
        case, flash_attention.ONE_DEVICE)
    row0 = lk - lq
    drop = (0.1, 1234)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, *drop, bias=bias,
                                                 head_grid=grid, row0=row0)
    grads = flash_attention.flash_attention_bwd(q, k, v, o, do, lse, *drop,
                                                fused=fused, bias=bias,
                                                head_grid=grid, row0=row0)
    o_ref, lse_ref = flash_attention.flash_attention_fwd_ref(
        q, k, v, *drop, bias, grid, row0)
    refs = flash_attention.flash_attention_bwd_ref(q, k, v, o, do, lse, *drop,
                                                   bias, grid, row0)
    assert (lse - lse_ref).abs().max().item() <= TOL_LSE
    if dtype == torch.bfloat16:
        assert_bf16_close(o, o_ref, 1, TOL)
        for got, want in zip(grads, refs):
            assert_bf16_close(got, want, 2, TOL_BWD)
    else:
        assert max_rel(o, o_ref) <= TOL
        for got, want in zip(grads, refs):
            assert max_rel(got, want) <= TOL_BWD


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq_len,head_dim,place", [
    (256, 256, None), (192, 192, None), (144, 200, "rank")])
def test_flash_attention_wide_forward_draws_the_plain_mask(
        cuda, seq_len, head_dim, place, dtype):
    """With q = k = 0 every probability is 1 / L, and with v the identity
    in its first L columns o[r, c] = Z[r, c] / L: the forward's keep bits
    read back bit for bit as the plain version's `philox_keep_mask`, also at
    a rank's head grid and first row."""
    bh, p, seed = 6, 0.1, 2024
    grid, row0 = ((3, 6, 1, 3), 64) if place else (flash_attention.ONE_DEVICE,
                                                  0)
    q = torch.zeros(bh, seq_len, head_dim, device=cuda, dtype=dtype)
    v = torch.eye(seq_len, head_dim, device=cuda, dtype=dtype).expand(
        bh, -1, -1).contiguous()
    before = flash_attention.WIDE_LAUNCHES
    o, _ = flash_attention.flash_attention_fwd(q, q, v, p, seed,
                                               head_grid=grid, row0=row0)
    torch.cuda.synchronize()
    assert flash_attention.WIDE_LAUNCHES == before + 1
    keep = flash_attention.philox_keep_mask(seed, bh, seq_len, seq_len, p,
                                            row0=row0, head_grid=grid,
                                            device=cuda)
    got = o[..., :seq_len].float()
    assert torch.equal(got > 0, keep)
    assert (got[..., :][~keep] == 0).all()


# more than 32 states: 33, 48, 64 (the DiM at state_size 64), 65 and 96
# (the backward in two launches of the wide sweep, the second of 1 and 32
# states) and 128 (two of 64); L 256, a ragged 100, 37 and 300 and 1024; D
# 768, 200 and 130
WIDE_STATE_SHAPES = [(4, 256, 768, 64), (2, 100, 200, 33), (2, 1024, 768, 64),
                     (3, 37, 130, 48), (2, 256, 768, 128), (2, 100, 200, 65),
                     (3, 300, 200, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,length,d_inner,n_state", WIDE_STATE_SHAPES)
def test_scan_kernels_take_more_than_32_states(cuda, batch, length, d_inner,
                                               n_state):
    """Every scan entry past 32 states against its plain version: K5, K6
    (bound), K8, K7, K9 and K10, and E4's stated forward (y, bound, h_out),
    its state-only form and its backward (dh_in among the gradients)."""
    gen = torch.Generator(device=cuda).manual_seed(length + n_state)
    x, dt, A, B, C, g = scan_inputs(batch, length, d_inner, n_state, gen,
                                    cuda)
    args = (x, dt, A, B, C)
    y_ref, bound_ref = scan_mod.selective_scan_fwd_ref(*args, True)
    bar = TOL * max(bound_ref.abs().max().item(), 1.0)
    before = scan_launch_counts()
    y, _ = scan_mod.selective_scan_fwd(*args, False)
    y_states, bound = scan_mod.selective_scan_fwd(*args, True)
    y_split, bound_split = scan_mod.selective_scan_fwd_split(*args)
    grads = {"bwd": scan_mod.selective_scan_bwd(*args, g, bound),
             "bwd_nostate": scan_mod.selective_scan_bwd_nostate(*args, g),
             "bwd_split": scan_mod.selective_scan_bwd_split(*args, g, bound)}
    torch.cuda.synchronize()
    assert launched_since(before) == {
        "FWD_LAUNCHES": 2, "FWD_STATES_LAUNCHES": 1, "FWD_SPLIT_LAUNCHES": 1,
        "BWD_LAUNCHES": 1, "BWD_NOSTATE_LAUNCHES": 1, "BWD_SPLIT_LAUNCHES": 1}
    for got in (y, y_states, y_split):
        assert max_rel(got, y_ref) <= TOL
    for got in (bound, bound_split):
        assert (got - bound_ref).abs().max().item() <= bar
    refs = scan_mod.selective_scan_bwd_ref(*args, g, bound_ref)
    for kernel, got in grads.items():
        for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), got, refs):
            assert max_rel(a, b) <= TOL_BWD, (kernel, name)

    h_in = 0.5 * torch.randn(batch, d_inner, n_state, generator=gen,
                             device=cuda)
    g_h = torch.randn_like(h_in)
    y_s, bound_s, h_out = scan_mod.selective_scan_fwd_state(*args, h_in)
    _, bound_end, h_end = scan_mod.selective_scan_fwd_state(*args, h_in,
                                                            with_y=False)
    stated = scan_mod.selective_scan_bwd_state(*args, g, bound_s, g_h)
    refs_s = scan_mod.selective_scan_fwd_state_ref(*args, h_in)
    assert max_rel(y_s, refs_s[0]) <= TOL
    for got in (bound_s, bound_end):
        assert (got - refs_s[1]).abs().max().item() <= TOL * max(
            refs_s[1].abs().max().item(), 1.0)
    for got in (h_out, h_end):
        assert max_rel(got, refs_s[2]) <= TOL
    for a, b in zip(stated, scan_mod.selective_scan_bwd_state_ref(
            *args, g, refs_s[1], g_h)):
        assert max_rel(a, b) <= TOL_BWD
