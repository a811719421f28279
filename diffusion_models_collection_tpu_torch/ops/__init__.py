"""Ops with hand-written Hopper kernels, each beside its plain PyTorch
version. Kernels build at their first launch on CUDA, never at import."""

from .attention import multihead_attention
from .flash_attention import flash_attention_fwd, flash_attention_fwd_ref
from .fused_norm import group_norm_silu, group_norm_silu_ref

__all__ = [
    "flash_attention_fwd",
    "flash_attention_fwd_ref",
    "group_norm_silu",
    "group_norm_silu_ref",
    "multihead_attention",
]
