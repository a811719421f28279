"""Ops with hand-written Hopper kernels, each beside its plain PyTorch
version. Kernels build at their first launch on CUDA, never at import.
The differentiable attention is `flash_attention.flash_attention`; it is
not re-exported here, where its name would hide its module's."""

from .attention import multihead_attention
from .flash_attention import (
    FlashAttention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_fwd,
    flash_attention_fwd_ref,
    flash_attention_ref,
)
from .fused_norm import (
    GroupNormSiLU,
    group_norm_silu,
    group_norm_silu_bwd,
    group_norm_silu_bwd_ref,
    group_norm_silu_fwd,
    group_norm_silu_ref,
)

__all__ = [
    "FlashAttention",
    "GroupNormSiLU",
    "flash_attention_bwd",
    "flash_attention_bwd_ref",
    "flash_attention_fwd",
    "flash_attention_fwd_ref",
    "flash_attention_ref",
    "group_norm_silu",
    "group_norm_silu_bwd",
    "group_norm_silu_bwd_ref",
    "group_norm_silu_fwd",
    "group_norm_silu_ref",
    "multihead_attention",
]
