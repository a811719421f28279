"""Flash attention over (B*H, L, d), forward and backward.

Counterpart of `diffusion_models_collection_tpu/ops/flash_attention.py`:
`flash_attention_fwd` (`_flash_fwd_bh`) returns the output and the row
logsumexp; `flash_attention_bwd` (`_flash_bwd_bh`, `_bwd_jnp`) recomputes the
probabilities from them and returns dq, dk and dv. Each is a `torch.library`
operator (`dmc::flash_attn_fwd`, `dmc::flash_attn_bwd`, `ops/_library.py`)
that launches its kernel (`csrc/flash_attn.cu`, `csrc/flash_attn_bwd.cu`) on
a CUDA tensor and runs its plain version (`flash_attention_fwd_ref`,
`flash_attention_bwd_ref`) on a CPU tensor. `FlashAttention` joins the two as the JAX package's `_flash_core`
custom_vjp does; `flash_attention` is its entry point and
`flash_attention_ref` the plain differentiable attention it is held against.

The forward kernel walks query tiles of `fwd_tile` rows: 128 or, for a
short sequence, 32 at head_dim <= 64, else 64 (bf16: 16, 64 or 128). The
backward kernel has two
forms (`csrc/flash_attn_bwd.cu`). The fused one computes the scores once:
each (head, key tile) block also forms its share of dq, which a scratch
buffer of (BH, key tiles, L, d) floats carries to a sum kernel when there
is more than one key tile. `bwd_fused` takes it up to
`FUSED_MAX_LEN` (L 1024); beyond, the scratch would grow with L^2 and the
two-kernel form, which recomputes the scores for dq, runs instead. `bwd_tile` is the
tile height both forms walk in.

The plain versions take any head_dim. The kernels take multiples of 8 (bf16:
16, the depth of a tensor-core product) up to `MAX_HEAD_DIM`: on a CUDA
tensor the wrappers pad another head_dim to that multiple (`padded_head_dim`)
with zero columns, which changes no score (the softmax
scale is an argument of the kernels and stays 1 / sqrt(head_dim)) and adds
only zero columns to o, dq, dk and dv, sliced off again; a head_dim beyond
`MAX_HEAD_DIM` raises there.

Dropout on the probabilities (`dropout_p` > 0 with a 64-bit `seed`), as the
JAX package's `dot_product_attention` applies it in training: o = (P o Z) V
with Z = keep / (1 - p), lse that of the undropped P. `philox_keep_mask` is
the one definition of the mask, a pure function of (seed, head, row, key)
through Philox4x32-10, which the kernels (`csrc/philox.cuh`) compute tile by
tile and the backward regenerates, so nothing of size (BH, L, L) is stored.

q, k, v (o, dO, dq, dk, dv) are float32 or bfloat16, lse float32. A
bfloat16 input takes the kernels' bf16 form, as the JAX kernels run on the
bf16 q, k, v of the models' mixed precision: every product, the softmax and
lse in float32 from the exact bf16 inputs, and o, dq, dk, dv rounded to
bfloat16 at their store. Each plain version does the same: it upcasts, runs
the float32 formulas and rounds its outputs to q's type. The bf16 forms run
their products on the tensor cores with bf16 operands: q, k, v and dO as they
are, and each float32 operand that the products make (the probabilities P,
dropped out, and dS) split into two bf16 terms, hi = bf16(x) and lo =
bf16(x - hi), whose two products with the same exact operand keep float32
accuracy (`csrc/bf16_mma.cuh`).

A per-key additive bias (`bias`, float32 (B, L) with BH = B * H: ToMe's
proportional attention, log of each merged key's size, `ops/attention.py`)
joins every scaled score before the softmax: s = q k^T / sqrt(d) + bias[b,
key] for head bh of batch item b = bh // H. lse includes it, so the backward
recomputes the forward's P from the same definition; the bias gets no
gradient. On a CUDA tensor it takes the kernels' bias forms
(`csrc/key_bias.cuh`, entries `flash_attn_fwd_bias`, `flash_attn_bwd_bias`),
which read row bh / H themselves: the wrapper passes H and never expands the
bias to (BH, L).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build, _library

MAX_HEAD_DIM = 128

# Kernel launches since the process started (or since a caller reset them):
# the forward's and the backward's, and of those the ones in the dropout
# form, the ones in the bf16 form and the ones with a key bias.
LAUNCHES = 0
BWD_LAUNCHES = 0
DROPOUT_LAUNCHES = 0
BWD_DROPOUT_LAUNCHES = 0
BF16_LAUNCHES = 0
BWD_BF16_LAUNCHES = 0
BIAS_LAUNCHES = 0
BWD_BIAS_LAUNCHES = 0

_MASK32 = 0xFFFFFFFF
# Philox4x32's multipliers and key increments (Random123)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)

# The longest sequence whose backward runs fused: 16 key tiles of 64, the
# 64x64 DiT's L 1024, where its dq shares (16 x dq in float32, 3 GiB at BH
# 768) cost less than the two-kernel form's recomputed scores: on an H100
# at BH 768, d 64, fused against two kernels 16.84 against 22.20 ms fp32
# and 17.54 against 23.79 at p 0.1; bf16 5.31 against 5.64 at p 0.1 (the
# DiT's training), 4.67 against 3.85 at p 0 (`chip_smoke.py`'s
# `phase_k3_sweep`; PERF.md). Every attention of the CIFAR-10 UNet (L 64,
# 256) and DiT (L 256) lies below it too.
FUSED_MAX_LEN = 1024


def fwd_tile(seq_len: int, head_dim: int,
             dtype: torch.dtype = torch.float32) -> int:
    """Rows of a query tile of the forward kernel. float32, at head_dim <= 64,
    where the kernel has these forms: 128 (key tiles of 64, eight rows and
    keys a thread) for a sequence longer than 64, else 32 (key tiles of 32),
    so that a short sequence does not compute mostly masked rows. Beyond 64:
    64 (key tiles of 64). Set by `tools/profile_torch_kernels.py --only
    attn_fwd`, which times every form at the UNet's shapes. bfloat16 (16
    rows a warp, key tiles of 64): 16 (one warp, key tiles of 16) for a
    sequence that fits them, 64 up to L 64 or beyond head_dim 64, else 128;
    set by `--only bf16`."""
    if dtype == torch.bfloat16:
        if head_dim > 64:
            return 64
        if seq_len <= 16:
            return 16
        return 64 if seq_len <= 64 else 128
    if head_dim > 64:
        return 64
    return 128 if seq_len > 64 else 32


def bwd_tile(seq_len: int, head_dim: int,
             dtype: torch.dtype = torch.float32) -> int:
    """Rows of a query or key tile of the backward kernel: 64, or for a
    sequence that fits a smaller tile (at head_dim <= 64, where the kernel
    has that form) 32 in float32 and 16 in bfloat16, so that a short
    sequence does not pay a mostly empty tile."""
    small = 16 if dtype == torch.bfloat16 else 32
    return small if seq_len <= small and head_dim <= 64 else 64


def bwd_fused(seq_len: int) -> bool:
    """Whether the backward of this length runs the fused form."""
    return seq_len <= FUSED_MAX_LEN


def tensor_core_products() -> dict:
    """The tensor-core products (`HMMA` instructions) in the SASS of each
    attention kernel of the built library, by mangled name: every bf16 form
    (`*_bf16_*`) has them, the float32 forms and the delta and dq-sum
    kernels none. Needs the card's toolkit (`cuobjdump`)."""
    return {name: text.count("HMMA")
            for name, text in _build.kernel_sass().items()
            if "flash_" in name}


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The high and low 32 bits of a * b for a 32-bit constant a and a tensor
    of 32-bit values held in int64, from b's 16-bit halves: no product
    reaches 2^63."""
    high = a * (b >> 16)
    low = a * (b & 0xFFFF) + ((high & 0xFFFF) << 16)
    return (high >> 16) + (low >> 32), low & _MASK32


def philox4x32(counter, key):
    """Philox4x32-10 (Random123) of four counter words (int64 tensors, or
    ints, of 32-bit values; broadcast together) under two key words (ints);
    returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def dropout_threshold(dropout_p: float) -> int:
    """A key is kept iff its Philox word is below floor((1 - p) 2^32)."""
    return min(math.floor((1.0 - dropout_p) * 2.0**32), _MASK32)


def philox_keep_mask(seed: int, bh: int, lq: int, lk: int, dropout_p: float,
                     *, bh0: int = 0, row0: int = 0, col0: int = 0,
                     device=None) -> torch.Tensor:
    """The keep mask of attention dropout, bool (bh, lq, lk): heads bh0 ..,
    query rows row0 .., keys col0 .. . Key `col` of row `row` of head `h` is
    kept iff word col & 3 of Philox4x32-10 at counter (col >> 2, row, h, 0)
    under key (seed & 0xFFFFFFFF, seed >> 32) is below
    `dropout_threshold(dropout_p)`: what the kernels compute, tile by tile."""
    g0, g1 = col0 >> 2, ((col0 + lk - 1) >> 2) + 1
    arange = partial(torch.arange, dtype=torch.int64, device=device)
    words = philox4x32(
        (arange(g0, g1)[None, None, :], arange(row0, row0 + lq)[None, :, None],
         arange(bh0, bh0 + bh)[:, None, None], 0),
        (seed & _MASK32, (seed >> 32) & _MASK32))
    words = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    words = words.reshape(bh, lq, 4 * (g1 - g0))[..., col0 - 4 * g0:][..., :lk]
    return words < dropout_threshold(dropout_p)


def dropout_factor(seed: int, dropout_p: float, shape,
                   device=None) -> torch.Tensor:
    """Z = keep / (1 - p) over (BH, L, L) scores, float32: 1 / (1 - p) rounded
    to float32 where kept, as the kernels multiply."""
    keep = philox_keep_mask(seed, *shape, dropout_p, device=device)
    return keep.to(torch.float32) * torch.tensor(
        1.0 / (1.0 - dropout_p), dtype=torch.float32, device=device)


def _check_dropout(name: str, dropout_p: float, seed: Optional[int]) -> None:
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"{name}: dropout_p must lie in [0, 1), got "
                         f"{dropout_p}")
    if dropout_p > 0.0 and not isinstance(seed, int):
        raise ValueError(f"{name}: dropout needs an int seed, got {seed!r}")


def _head_bias(bias: torch.Tensor, bh: int) -> torch.Tensor:
    """The (B, L) key bias as (BH, 1, L): row b for the heads of item b."""
    return bias.repeat_interleave(bh // bias.shape[0], dim=0)[:, None, :]


def flash_attention_fwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    dropout_p: float = 0.0, seed: Optional[int] = None,
    bias: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention: o = (softmax(s) o Z) v with s = q k^T /
    sqrt(d) (+ the key bias), Z the dropout factor (none at p = 0), and lse
    = logsumexp(s) of shape (BH, L, 1); in float32, o rounded to q's
    type."""
    _check_dropout("flash_attention_fwd_ref", dropout_p, seed)
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + _head_bias(bias, q.shape[0])
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        probs = probs * dropout_factor(seed, dropout_p, probs.shape, q.device)
    o = torch.matmul(probs, v)
    return o.to(dtype), torch.logsumexp(logits, dim=-1, keepdim=True)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dropout_p: float = 0.0, seed: Optional[int] = None,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch attention output, differentiable by autograd (through
    the casts of a bfloat16 input: gradients in its type)."""
    return flash_attention_fwd_ref(q, k, v, dropout_p, seed, bias)[0]


def flash_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, dropout_p: float = 0.0,
    seed: Optional[int] = None, bias: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward (the JAX package's `_bwd_jnp`): P from lse
    (and the forward's key bias),
    dv = (P o Z)^T dO, dS = P (dO v^T o Z - rowsum(dO o)) / sqrt(d),
    dq = dS k, dk = dS^T q, with Z the forward's dropout factor (1 at
    p = 0); in float32, the gradients rounded to q's type."""
    _check_dropout("flash_attention_bwd_ref", dropout_p, seed)
    dtype = q.dtype
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + _head_bias(bias, q.shape[0])
    p = torch.exp(logits - lse)
    dp = torch.matmul(do, v.transpose(-1, -2))
    p_kept = p
    if dropout_p > 0.0:
        z = dropout_factor(seed, dropout_p, p.shape, q.device)
        p_kept, dp = p * z, dp * z
    dv = torch.matmul(p_kept.transpose(-1, -2), do)
    delta = (do * o).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    return tuple(t.to(dtype) for t in (
        torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q), dv))


def _check_shapes(name: str, q: torch.Tensor, *others: torch.Tensor) -> None:
    """q and every other tensor one (BH, L, d) shape; on the card d at most
    MAX_HEAD_DIM and the tensors 32-bit indexable."""
    if q.dim() != 3 or any(t.shape != q.shape for t in others):
        raise ValueError(
            f"{name}: the inputs must share one (BH, L, d) shape, got "
            + ", ".join(str(tuple(t.shape)) for t in (q, *others)))
    head_dim = q.shape[-1]
    if head_dim < 1:
        raise ValueError(f"{name}: head_dim must be at least 1")
    if q.device.type != "cuda":
        return
    if head_dim > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {head_dim} exceeds the kernel's "
                         f"limit of {MAX_HEAD_DIM}")
    if q.shape[0] * q.shape[1] * padded_head_dim(head_dim, q.dtype) >= 2**31:
        raise ValueError(f"{name}: shape {tuple(q.shape)} exceeds the "
                         "kernel's 32-bit indexing")


def _check_bias(name: str, bias: Optional[torch.Tensor],
                q: torch.Tensor) -> None:
    """The key bias: None, or float32 (B, L) on q's device, contiguous, with B
    dividing q's BH (the kernels' bias forms read row bh / (BH / B))."""
    if bias is None:
        return
    bh, seq_len = q.shape[0], q.shape[1]
    if (bias.dim() != 2 or bias.shape[1] != seq_len or bias.shape[0] < 1
            or bh % bias.shape[0]):
        raise ValueError(f"{name}: the key bias must be (B, {seq_len}) with B "
                         f"dividing {bh}, got {tuple(bias.shape)}")
    if bias.dtype != torch.float32 or bias.device != q.device:
        raise TypeError(f"{name}: the key bias must be float32 on "
                        f"{q.device}, got {bias.dtype} on {bias.device}")
    if not bias.is_contiguous():
        raise ValueError(f"{name}: the key bias must be contiguous")


def padded_head_dim(head_dim: int,
                    dtype: torch.dtype = torch.float32) -> int:
    """The head_dim the kernels run at: the next multiple of 8, or in
    bfloat16 of 16, the depth of a tensor-core product."""
    step = 16 if dtype == torch.bfloat16 else 8
    return -(-head_dim // step) * step


def _pad_heads(head_dim: int, *tensors: torch.Tensor):
    """The tensors with zero columns up to `padded_head_dim` of their dtype
    (as they are when head_dim is a multiple of it)."""
    extra = padded_head_dim(head_dim, tensors[0].dtype) - head_dim
    if not extra:
        return tensors
    return tuple(F.pad(t, (0, extra)) for t in tensors)


def _cut_heads(head_dim: int, *tensors: torch.Tensor):
    """Undo `_pad_heads` on the kernels' outputs."""
    if tensors[0].shape[-1] == head_dim:
        return tensors
    return tuple(t[..., :head_dim].contiguous() for t in tensors)


def _dropout_args(dropout_p: float, seed: Optional[int]):
    """The kernels' trailing dropout arguments: (on, threshold, 1 / (1 - p),
    seed as an unsigned 64-bit int)."""
    if dropout_p == 0.0:
        return 0, 0, 1.0, 0
    return (1, dropout_threshold(dropout_p), 1.0 / (1.0 - dropout_p),
            seed & 0xFFFFFFFFFFFFFFFF)


def _signed_seed(seed: Optional[int]) -> Optional[int]:
    """A dropout seed as the operators' 64-bit signed int: the same 64 bits,
    so the same mask (`philox_keep_mask` reads its low and high words)."""
    if seed is None:
        return None
    seed &= 0xFFFFFFFFFFFFFFFF
    return seed - 2**64 if seed >= 2**63 else seed


def _fwd_cuda(q, k, v, dropout_p: float, seed: Optional[int],
              bias: Optional[torch.Tensor]):
    """The forward kernel's launch: (o, lse)."""
    global LAUNCHES, DROPOUT_LAUNCHES, BF16_LAUNCHES, BIAS_LAUNCHES
    bf16 = q.dtype == torch.bfloat16
    bh, seq_len, head_dim = q.shape
    lib = _build.library()
    q, k, v = _pad_heads(head_dim, q, k, v)
    # the kernel copies 16 bytes at a time: a view that starts elsewhere in
    # its storage is copied to a fresh (aligned) tensor first
    q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((bh, seq_len, 1), dtype=torch.float32, device=q.device)
    if q.numel():
        width = q.shape[-1]
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), bh, seq_len, width, 1.0 / math.sqrt(head_dim),
                fwd_tile(seq_len, width, q.dtype),
                *_dropout_args(dropout_p, seed), int(bf16))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            if bias is None:
                err = lib.flash_attn_fwd(*args, stream)
            else:
                err = lib.flash_attn_fwd_bias(*args, bias.data_ptr(),
                                              bh // bias.shape[0], stream)
        _build.check(err, "flash_attn_fwd")
        LAUNCHES += 1
        DROPOUT_LAUNCHES += dropout_p > 0.0
        BF16_LAUNCHES += bf16
        BIAS_LAUNCHES += bias is not None
    return (*_cut_heads(head_dim, o), lse)


_FWD = _library.define(
    "flash_attn_fwd(Tensor q, Tensor k, Tensor v, float dropout_p, "
    "int? seed, Tensor? bias) -> (Tensor, Tensor)",
    cpu=flash_attention_fwd_ref,
    cuda=_fwd_cuda,
    fake=lambda q, k, v, dropout_p, seed, bias: (
        torch.empty_like(q),
        q.new_empty((q.shape[0], q.shape[1], 1), dtype=torch.float32)))


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    dropout_p: float = 0.0, seed: Optional[int] = None,
    bias: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward over (BH, L, d) float32 or bfloat16, square scores,
    with dropout on the probabilities when `dropout_p` > 0 (the mask of
    `philox_keep_mask(seed, ...)`) and the key bias when one is given, the
    operator `dmc::flash_attn_fwd`: the kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (o, lse), o of q's type and lse float32
    of shape (BH, L, 1), the JAX kernel's layout."""
    _build.check_io_dtype("flash_attention_fwd", (q, k, v))
    _check_shapes("flash_attention_fwd", q, k, v)
    _check_dropout("flash_attention_fwd", dropout_p, seed)
    _check_bias("flash_attention_fwd", bias, q)
    return _FWD(q, k, v, float(dropout_p), _signed_seed(seed), bias)


def _bwd_cpu(q, k, v, o, dout, lse, dropout_p: float, seed: Optional[int],
             fused: Optional[bool], bias: Optional[torch.Tensor]):
    return flash_attention_bwd_ref(q, k, v, o, dout, lse, dropout_p, seed,
                                   bias)


def _bwd_cuda(q, k, v, o, do, lse, dropout_p: float, seed: Optional[int],
              fused: Optional[bool], bias: Optional[torch.Tensor]):
    """The backward kernel's launch in the form `fused` picks (None:
    `bwd_fused`): (dq, dk, dv)."""
    global BWD_LAUNCHES, BWD_DROPOUT_LAUNCHES, BWD_BF16_LAUNCHES
    global BWD_BIAS_LAUNCHES
    bf16 = q.dtype == torch.bfloat16
    bh, seq_len, head_dim = q.shape
    q, k, v, o, do = _pad_heads(head_dim, q, k, v, o, do)
    if any(t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError("flash_attention_bwd: q, k, v and dO must be "
                         "16-byte aligned")
    lib = _build.library()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((bh, seq_len), dtype=torch.float32, device=q.device)
    if q.numel():
        if fused is None:
            fused = bwd_fused(seq_len)
        width = q.shape[-1]
        tile = bwd_tile(seq_len, width, q.dtype)
        tiles = -(-seq_len // tile)
        partial = None
        if fused and tiles > 1:
            partial = torch.empty((bh, tiles, seq_len, width),
                                  dtype=torch.float32, device=q.device)
        # autograd runs a backward on its own thread: take that thread's
        # current stream for the device here, at the launch
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                None if partial is None else partial.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, seq_len,
                width, 1.0 / math.sqrt(head_dim), tile, int(fused),
                *_dropout_args(dropout_p, seed), int(bf16))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            if bias is None:
                err = lib.flash_attn_bwd(*args, stream)
            else:
                err = lib.flash_attn_bwd_bias(*args, bias.data_ptr(),
                                              bh // bias.shape[0], stream)
        _build.check(err, "flash_attn_bwd")
        BWD_LAUNCHES += 1
        BWD_DROPOUT_LAUNCHES += dropout_p > 0.0
        BWD_BF16_LAUNCHES += bf16
        BWD_BIAS_LAUNCHES += bias is not None
    return _cut_heads(head_dim, dq, dk, dv)


_BWD = _library.define(
    "flash_attn_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor dout, "
    "Tensor lse, float dropout_p, int? seed, bool? fused, Tensor? bias) "
    "-> (Tensor, Tensor, Tensor)",
    cpu=_bwd_cpu,
    cuda=_bwd_cuda,
    fake=lambda q, *args: tuple(torch.empty_like(q) for _ in range(3)))


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, dropout_p: float = 0.0,
    seed: Optional[int] = None, fused: Optional[bool] = None,
    bias: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention backward over (BH, L, d) float32 or bfloat16 (q, k, v, o
    and dO of one type) from the forward's o and float32 lse (BH, L, 1) and
    its `dropout_p`, `seed` and key `bias`, the operator
    `dmc::flash_attn_bwd`: the kernel for CUDA tensors, the plain version
    for CPU tensors. Returns (dq, dk, dv) of q's type. `fused` picks the
    kernel's form; None leaves it to `bwd_fused`."""
    _build.check_io_dtype("flash_attention_bwd", (q, k, v, o, do), (lse,))
    _check_shapes("flash_attention_bwd", q, k, v, o, do)
    _check_dropout("flash_attention_bwd", dropout_p, seed)
    _check_bias("flash_attention_bwd", bias, q)
    bh, seq_len, _ = q.shape
    if lse.shape != (bh, seq_len, 1):
        raise ValueError(f"flash_attention_bwd: lse must be ({bh}, {seq_len}, "
                         f"1), got {tuple(lse.shape)}")
    return _BWD(q, k, v, o, do, lse, float(dropout_p), _signed_seed(seed),
                fused, bias)


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is `flash_attention_fwd` and whose backward
    is `flash_attention_bwd`, from the residuals (q, k, v, o, lse), the
    dropout's (p, seed) and the key bias, as the JAX package's `_flash_core`
    (`_flash_core_fwd`, `_flash_core_bwd`). The bias gets no gradient: it
    is the log of merged tokens' counts."""

    @staticmethod
    def forward(ctx, q, k, v, dropout_p=0.0, seed=None, bias=None):
        o, lse = flash_attention_fwd(q, k, v, dropout_p, seed, bias)
        ctx.save_for_backward(q, k, v, o, lse, bias)
        ctx.dropout = (dropout_p, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, bias = ctx.saved_tensors
        # autograd hands dO over in the layout of the caller's reshapes
        grads = flash_attention_bwd(q, k, v, o, do.contiguous(), lse,
                                    *ctx.dropout, bias=bias)
        return (*grads, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    dropout_p: float = 0.0, seed: Optional[int] = None,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable attention over (BH, L, d) float32 or bfloat16 through
    the forward and backward kernels (their plain versions on the CPU), with
    dropout on the probabilities when `dropout_p` > 0 and the key bias (B, L)
    when one is given; o of q's type."""
    return FlashAttention.apply(q, k, v, dropout_p, seed, bias)
