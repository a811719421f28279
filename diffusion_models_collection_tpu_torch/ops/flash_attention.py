"""Flash attention over (B*H, L, d), forward and backward.

Counterpart of `diffusion_models_collection_tpu/ops/flash_attention.py`:
`flash_attention_fwd` (`_flash_fwd_bh`) returns the output and the row
logsumexp; `flash_attention_bwd` (`_flash_bwd_bh`, `_bwd_jnp`) recomputes the
probabilities from them and returns dq, dk and dv. Each launches its kernel
(`csrc/flash_attn.cu`, `csrc/flash_attn_bwd.cu`) on a CUDA tensor and runs
its plain version (`flash_attention_fwd_ref`, `flash_attention_bwd_ref`) on a
CPU tensor. `FlashAttention` joins the two as the JAX package's `_flash_core`
custom_vjp does; `flash_attention` is its entry point and
`flash_attention_ref` the plain differentiable attention it is held against.

The forward kernel walks query tiles of `fwd_tile` rows: 128 or, for a
short sequence, 32 at head_dim <= 64, else 64. The backward kernel has two
forms (`csrc/flash_attn_bwd.cu`). The fused one computes the scores once:
each (head, key tile) block also forms its share of dq, which a scratch
buffer of (BH, key tiles, L, d) floats carries to a sum kernel when there
is more than one key tile. `bwd_fused` takes it up to
`FUSED_MAX_LEN`; beyond, the scratch would grow with L^2 and the two-kernel
form, which recomputes the scores for dq, runs instead. `bwd_tile` is the
tile height both forms walk in.

The plain versions take any head_dim. The kernels take multiples of 8 up to
`MAX_HEAD_DIM`: on a CUDA tensor the wrappers pad another head_dim to the
next multiple of 8 with zero columns, which changes no score (the softmax
scale is an argument of the kernels and stays 1 / sqrt(head_dim)) and adds
only zero columns to o, dq, dk and dv, sliced off again; a head_dim beyond
`MAX_HEAD_DIM` raises there.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

MAX_HEAD_DIM = 128

# Kernel launches since the process started (or since a caller reset them):
# the forward's and the backward's.
LAUNCHES = 0
BWD_LAUNCHES = 0

# The longest sequence whose backward runs fused: four key tiles of 64, so
# the dq shares cost as much traffic as one more pass over q, k, v and dO.
# Every attention of the CIFAR-10 UNet (L 64, 256) lies below it.
FUSED_MAX_LEN = 256


def fwd_tile(seq_len: int, head_dim: int) -> int:
    """Rows of a query tile of the forward kernel. At head_dim <= 64, where
    the kernel has these forms: 128 (key tiles of 64, eight rows and keys a
    thread) for a sequence longer than 64, else 32 (key tiles of 32), so
    that a short sequence does not compute mostly masked rows. Beyond 64:
    64 (key tiles of 64). Set by `tools/profile_torch_kernels.py --only
    attn_fwd`, which times every form at the UNet's shapes."""
    if head_dim > 64:
        return 64
    return 128 if seq_len > 64 else 32


def bwd_tile(seq_len: int, head_dim: int) -> int:
    """Rows of a query or key tile of the backward kernel: 64, or 32 for a
    sequence that fits 32 rows (at head_dim <= 64, where the kernel has
    that form), so that a short sequence does not pay a mostly empty tile."""
    return 32 if seq_len <= 32 and head_dim <= 64 else 64


def bwd_fused(seq_len: int) -> bool:
    """Whether the backward of this length runs the fused form."""
    return seq_len <= FUSED_MAX_LEN


def flash_attention_fwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention: o = softmax(q k^T / sqrt(d)) v and
    lse = logsumexp(q k^T / sqrt(d)) of shape (BH, L, 1)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    o = torch.matmul(torch.softmax(logits, dim=-1), v)
    return o, torch.logsumexp(logits, dim=-1, keepdim=True)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch attention output, differentiable by autograd."""
    return flash_attention_fwd_ref(q, k, v)[0]


def flash_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward (the JAX package's `_bwd_jnp`): P from lse,
    dv = P^T dO, dS = P (dO v^T - rowsum(dO o)) / sqrt(d), dq = dS k,
    dk = dS^T q."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * scale - lse)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    delta = (do * o).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    return (torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q), dv)


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
    if q.shape[0] * q.shape[1] * padded_head_dim(head_dim) >= 2**31:
        raise ValueError(f"{name}: shape {tuple(q.shape)} exceeds the "
                         "kernel's 32-bit indexing")


def padded_head_dim(head_dim: int) -> int:
    """The head_dim the kernels run at: the next multiple of 8."""
    return -(-head_dim // 8) * 8


def _pad_heads(head_dim: int, *tensors: torch.Tensor):
    """The tensors with zero columns up to `padded_head_dim` (as they are
    when head_dim is a multiple of 8)."""
    extra = padded_head_dim(head_dim) - head_dim
    if not extra:
        return tensors
    return tuple(F.pad(t, (0, extra)) for t in tensors)


def _cut_heads(head_dim: int, *tensors: torch.Tensor):
    """Undo `_pad_heads` on the kernels' outputs."""
    if tensors[0].shape[-1] == head_dim:
        return tensors
    return tuple(t[..., :head_dim].contiguous() for t in tensors)


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward over (BH, L, d) float32, square scores: the kernel
    for CUDA tensors, the plain version for CPU tensors. Returns (o, lse)
    with lse of shape (BH, L, 1), the JAX kernel's layout."""
    global LAUNCHES
    _build.check_inputs("flash_attention_fwd", q, k, v)
    _check_shapes("flash_attention_fwd", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v)
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
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     o.data_ptr(), lse.data_ptr(), bh, seq_len,
                                     width, 1.0 / math.sqrt(head_dim),
                                     fwd_tile(seq_len, width), stream)
        _build.check(err, "flash_attn_fwd")
        LAUNCHES += 1
    return (*_cut_heads(head_dim, o), lse)


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, fused: Optional[bool] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention backward over (BH, L, d) float32 from the forward's o and
    lse (BH, L, 1): the kernel for CUDA tensors, the plain version for CPU
    tensors. Returns (dq, dk, dv). `fused` picks the kernel's form; None
    leaves it to `bwd_fused`."""
    global BWD_LAUNCHES
    _build.check_inputs("flash_attention_bwd", q, k, v, o, do, lse)
    _check_shapes("flash_attention_bwd", q, k, v, o, do)
    bh, seq_len, head_dim = q.shape
    if lse.shape != (bh, seq_len, 1):
        raise ValueError(f"flash_attention_bwd: lse must be ({bh}, {seq_len}, "
                         f"1), got {tuple(lse.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do, lse)
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
        tile = bwd_tile(seq_len, width)
        tiles = -(-seq_len // tile)
        partial = None
        if fused and tiles > 1:
            partial = torch.empty((bh, tiles, seq_len, width),
                                  dtype=torch.float32, device=q.device)
        # autograd runs a backward on its own thread: take that thread's
        # current stream for the device here, at the launch
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.flash_attn_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                None if partial is None else partial.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, seq_len,
                width, 1.0 / math.sqrt(head_dim), tile, int(fused), stream)
        _build.check(err, "flash_attn_bwd")
        BWD_LAUNCHES += 1
    return _cut_heads(head_dim, dq, dk, dv)


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is `flash_attention_fwd` and whose backward
    is `flash_attention_bwd`, from the residuals (q, k, v, o, lse), as the
    JAX package's `_flash_core` (`_flash_core_fwd`, `_flash_core_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd hands dO over in the layout of the caller's reshapes
        return flash_attention_bwd(q, k, v, o, do.contiguous(), lse)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Differentiable attention over (BH, L, d) float32 through the
    forward and backward kernels (their plain versions on the CPU)."""
    return FlashAttention.apply(q, k, v)
