"""Run the port's models on the plain PyTorch versions of its kernels.

For comparisons and measurements only: `chip_smoke.py`, the kernel tests
and the profiling tools hold a run through the kernels against the same run
inside `plain_kernels()`. The sampling and training paths never enter it,
and the kernel wrappers keep no switch of their own: on a CUDA tensor they
launch their kernel or raise.
"""

import contextlib

from ..models import dim, unet
from . import attention, flash_attention, fused_norm, selective_scan


@contextlib.contextmanager
def plain_kernels():
    """Point the kernels' call sites (the UNet's GroupNorm+SiLU, the
    attention, the DiM's selective scan) at plain PyTorch versions, so
    neither the forward kernels nor the backward kernels run; restore them
    on exit. GroupNorm+SiLU and attention become plain code that autograd
    differentiates; the scan becomes `SelectiveScanRef`, an autograd
    Function over the plain forward and backward, because autograd through
    its L-step loop would hold every step's (batch, D, N) state."""
    saved = (unet.group_norm_silu, attention.flash_attention,
             dim.selective_scan)
    unet.group_norm_silu = fused_norm.group_norm_silu_ref
    attention.flash_attention = flash_attention.flash_attention_ref
    dim.selective_scan = selective_scan.selective_scan_ref
    try:
        yield
    finally:
        (unet.group_norm_silu, attention.flash_attention,
         dim.selective_scan) = saved
