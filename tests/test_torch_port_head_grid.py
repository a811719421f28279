"""The attention dropout's masks keyed on the global (batch, head): the
`head_grid` of K2's and K3's dropout forms (`csrc/philox.cuh`), which a
data-parallel rank (its first row `batch0`) and a tensor-parallel rank (its
first head `head0` of `total_heads`) pass, so that they draw the masks the
single-device run draws for the same rows and heads.

This file imports no JAX, so it also runs on the GPU machine:

    python -m pytest --noconftest tests/test_torch_port_head_grid.py

On the CPU: the mapping, the plain mask of a rank against the slice of the
single-device mask, a sharded attention's output and gradients against the
slice of the single-device one, the operators' schemas (opcheck). Marked
`cuda` (skipped without a card): every dropout form of the kernels, float32
and bfloat16, with and without the key bias, fused and two-kernel backward,
against the plain versions at a rank's grid, and the v = I read-back of the
kernel's mask against `philox_keep_mask`'s slice; bars as
`tests/test_torch_port_kernels.py` (2e-5 forward, 1e-5 lse, 1e-4 backward
in float32; the bf16 forms one bf16 step of the largest value, two for the
backward).
"""

import pytest
import torch

from diffusion_models_collection_tpu_torch.ops import _library
from diffusion_models_collection_tpu_torch.ops import flash_attention as fa

P, SEED = 0.1, 2**63 + 12345
TOL, TOL_LSE, TOL_BWD = 2e-5, 1e-5, 1e-4
BF16_STEP = 2.0 ** -8


def max_rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def rank_slices(batch, heads, dp_rank, dp, tp_rank, tp):
    """(rows, heads) of the global (batch * dp, heads * tp) grid that a rank
    at (dp_rank, tp_rank) holds, as a flat index of the global BH axis, and
    its head grid."""
    total = heads * tp
    grid = (heads, total, dp_rank * batch, tp_rank * heads)
    index = [(dp_rank * batch + b) * total + tp_rank * heads + h
             for b in range(batch) for h in range(heads)]
    return torch.tensor(index), grid


@pytest.mark.parametrize("dp_rank,dp,tp_rank,tp", [
    (0, 1, 0, 1), (1, 2, 0, 1), (0, 1, 1, 2), (1, 2, 1, 2), (3, 4, 2, 3)])
def test_global_heads_index_the_single_device_heads(dp_rank, dp, tp_rank,
                                                    tp):
    index, grid = rank_slices(3, 2, dp_rank, dp, tp_rank, tp)
    torch.testing.assert_close(fa.global_heads(6, grid), index)


def test_the_one_device_grid_is_the_identity_and_bit_equal():
    """(1, 1, 0, 0), and any (H, H, 0, 0), map head bh to itself: a
    single-device call's mask is the one it was before the grid."""
    assert fa.ONE_DEVICE == (1, 1, 0, 0)
    for grid in (fa.ONE_DEVICE, (4, 4, 0, 0)):
        torch.testing.assert_close(fa.global_heads(8, grid),
                                   torch.arange(8))
    words = fa.philox4x32(
        (torch.arange(4)[None, None, :], torch.arange(5)[None, :, None],
         torch.arange(8)[:, None, None], 0),
        (SEED & 0xFFFFFFFF, SEED >> 32))
    words = torch.stack(torch.broadcast_tensors(*words), -1).reshape(8, 5, 16)
    assert torch.equal(fa.philox_keep_mask(SEED, 8, 5, 16, P),
                       words < fa.dropout_threshold(P))


@pytest.mark.parametrize("dp_rank,dp,tp_rank,tp", [
    (1, 2, 0, 1), (0, 1, 1, 2), (1, 2, 1, 2)])
def test_a_ranks_mask_is_its_slice_of_the_single_device_mask(dp_rank, dp,
                                                             tp_rank, tp):
    batch, heads, length = 2, 3, 12
    full = fa.philox_keep_mask(SEED, batch * dp * heads * tp, length, length,
                               P)
    index, grid = rank_slices(batch, heads, dp_rank, dp, tp_rank, tp)
    mine = fa.philox_keep_mask(SEED, batch * heads, length, length, P,
                               head_grid=grid)
    assert torch.equal(mine, full[index])


def test_a_sharded_attention_is_its_slice_of_the_single_device_one():
    """Forward and backward of a (dp 2, tp 2) rank's heads with dropout, the
    plain versions, against the rows and heads of the single-device call."""
    gen = torch.Generator().manual_seed(0)
    batch, heads, length, d = 2, 2, 16, 8
    qkv = [torch.randn(batch * 2 * heads * 2, length, d, generator=gen,
                       requires_grad=True) for _ in range(3)]
    out = fa.flash_attention(*qkv, P, SEED)
    out.square().sum().backward()
    index, grid = rank_slices(batch, heads, 1, 2, 1, 2)
    mine = [t.detach()[index].clone().requires_grad_() for t in qkv]
    out_r = fa.flash_attention(*mine, P, SEED, head_grid=grid)
    out_r.square().sum().backward()
    torch.testing.assert_close(out_r, out[index], rtol=0, atol=0)
    for ours, whole in zip(mine, qkv):
        torch.testing.assert_close(ours.grad, whole.grad[index], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("grid", [(4, 8, 0, 4), (2, 4, 0, 3), (3, 3, -1, 0)])
def test_bad_head_grids_raise(grid):
    q = torch.zeros(6, 4, 8)
    with pytest.raises(ValueError, match="head_grid"):
        fa.flash_attention_fwd(q, q, q, P, SEED, head_grid=grid)


@pytest.mark.parametrize("name", ["flash_attn_fwd", "flash_attn_bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_with_a_head_grid(name, dtype):
    gen = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn(8, 33, 16, generator=gen).to(dtype)
                   for _ in range(4))
    grid = [4, 8, 6, 4]
    seed = fa._signed_seed(SEED)
    if name == "flash_attn_fwd":
        args = (q, k, v, P, seed, None, grid)
    else:
        o, lse = fa.flash_attention_fwd(q, k, v, P, SEED, head_grid=grid)
        args = (q, k, v, o, do, lse, P, seed, None, None, grid)
    torch.library.opcheck(_library.OPS[name], args)


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CARD_CASES = [(seq, d, dtype, bias, fused)
              for seq, d in ((256, 64), (100, 64), (300, 32))
              for dtype in (torch.float32, torch.bfloat16)
              for bias in (False, True)
              for fused in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("seq,d,dtype,bias,fused", CARD_CASES)
def test_dropout_forms_at_a_ranks_grid_match_plain(cuda, seq, d, dtype,
                                                   bias, fused):
    """K2 and K3 in their dropout forms at a (dp 2, tp 2) rank's grid (the
    DiT's 6 heads: 3 a rank) against the plain versions at the same grid."""
    gen = torch.Generator(device=cuda).manual_seed(seq + d)
    batch, heads = 4, 3
    grid = (heads, 2 * heads, batch, heads)
    q, k, v, do = (torch.randn(batch * heads, seq, d, generator=gen,
                               device=cuda).to(dtype) for _ in range(4))
    key_bias = (torch.rand(batch, seq, generator=gen, device=cuda).log()
                if bias else None)
    counts = (fa.DROPOUT_LAUNCHES, fa.BWD_DROPOUT_LAUNCHES)
    o, lse = fa.flash_attention_fwd(q, k, v, P, SEED, key_bias,
                                    head_grid=grid)
    grads = fa.flash_attention_bwd(q, k, v, o, do, lse, P, SEED, fused=fused,
                                   bias=key_bias, head_grid=grid)
    torch.cuda.synchronize()
    assert (fa.DROPOUT_LAUNCHES, fa.BWD_DROPOUT_LAUNCHES) == (
        counts[0] + 1, counts[1] + 1)
    o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v, P, SEED, key_bias,
                                                grid)
    refs = fa.flash_attention_bwd_ref(q, k, v, o_ref, do, lse_ref, P, SEED,
                                      key_bias, grid)
    bf16 = dtype == torch.bfloat16
    assert max_rel(o, o_ref) <= (BF16_STEP if bf16 else TOL)
    assert (lse - lse_ref).abs().max() <= TOL_LSE
    for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
        assert max_rel(got, want) <= (2 * BF16_STEP if bf16 else TOL_BWD), \
            name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_mask_at_a_ranks_grid_reads_back_its_slice(cuda, dtype):
    """With v = I, o's zeros are the dropped keys: at a tensor-parallel
    rank's grid, the slice of the single-device mask for its heads."""
    batch, heads, seq = 4, 3, 64
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k = (torch.randn(batch * heads, seq, seq, generator=gen,
                        device=cuda).to(dtype) for _ in range(2))
    v = torch.eye(seq, device=cuda, dtype=dtype).expand(
        batch * heads, -1, -1).contiguous()
    index, grid = rank_slices(batch, heads, 0, 1, 1, 2)
    o, _ = fa.flash_attention_fwd(q, k, v, P, SEED, head_grid=grid)
    full = fa.philox_keep_mask(SEED, batch * 2 * heads, seq, seq, P,
                               device=cuda)
    assert torch.equal(o != 0, full[index.to(cuda)])
