"""Flash-attention forward over (B*H, L, d).

Counterpart of the forward half of
`diffusion_models_collection_tpu/ops/flash_attention.py` (`_flash_fwd_bh`):
returns the output and the row logsumexp, which a backward recomputes the
probabilities from. `flash_attention_fwd` launches `csrc/flash_attn.cu` on a
CUDA tensor and runs `flash_attention_fwd_ref` on a CPU tensor. The
backward kernel belongs to the training slice.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _build

MAX_HEAD_DIM = 128

# Kernel launches since the process started (or since a caller reset it).
LAUNCHES = 0


def flash_attention_fwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention: o = softmax(q k^T / sqrt(d)) v and
    lse = logsumexp(q k^T / sqrt(d)) of shape (BH, L, 1)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    o = torch.matmul(torch.softmax(logits, dim=-1), v)
    return o, torch.logsumexp(logits, dim=-1, keepdim=True)


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward over (BH, L, d) float32, square scores: the kernel
    for CUDA tensors, the plain version for CPU tensors. Returns (o, lse)
    with lse of shape (BH, L, 1), the JAX kernel's layout."""
    global LAUNCHES
    _build.check_inputs("flash_attention_fwd", q, k, v)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "flash_attention_fwd: q, k, v must share one (BH, L, d) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, seq_len, head_dim = q.shape
    if head_dim % 8 or not 0 < head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_fwd: head_dim {head_dim} must be a "
                         f"multiple of 8 in [8, {MAX_HEAD_DIM}]")
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v)
    if bh * seq_len * head_dim >= 2**31:
        raise ValueError(f"flash_attention_fwd: shape {tuple(q.shape)} "
                         "exceeds the kernel's 32-bit indexing")
    lib = _build.library()
    o = torch.empty_like(q)
    lse = torch.empty((bh, seq_len, 1), dtype=torch.float32, device=q.device)
    if q.numel():
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     o.data_ptr(), lse.data_ptr(), bh, seq_len,
                                     head_dim, 1.0 / math.sqrt(head_dim),
                                     stream)
        _build.check(err, "flash_attn_fwd")
        LAUNCHES += 1
    return o, lse
