"""Run the port's models on the plain PyTorch versions of its kernels.

For comparisons and measurements only: `chip_smoke.py`, the kernel tests
and the profiling tools hold a run through the kernels against the same run
inside `plain_kernels()`. The sampling and training paths never enter it,
and the kernel wrappers keep no switch of their own: on a CUDA tensor they
launch their kernel or raise.
"""

import contextlib

from ..models import unet
from . import attention, flash_attention, fused_norm


@contextlib.contextmanager
def plain_kernels():
    """Point the kernels' call sites (the UNet's GroupNorm+SiLU, the
    attention) at plain PyTorch versions that autograd differentiates, so
    neither the forward kernels nor the backward kernel run; restore them
    on exit."""
    saved = (unet.group_norm_silu, attention.flash_attention)
    unet.group_norm_silu = fused_norm.group_norm_silu_ref
    attention.flash_attention = flash_attention.flash_attention_ref
    try:
        yield
    finally:
        unet.group_norm_silu, attention.flash_attention = saved
