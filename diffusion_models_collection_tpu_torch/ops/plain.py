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
    on exit. Attention becomes plain code that autograd differentiates,
    called with the same dropout arguments (so the same seed gives the same
    mask, `flash_attention.philox_keep_mask`);
    GroupNorm+SiLU becomes `GroupNormSiLURef` and the scan
    `SelectiveScanRef`, autograd Functions over the plain forward and
    backward: they do the kernels' passes, and autograd through the scan's
    L-step loop would hold every step's (batch, D, N) state."""
    saved = (unet.group_norm_silu, attention.flash_attention,
             dim.selective_scan)
    unet.group_norm_silu = fused_norm.group_norm_silu_plain
    attention.flash_attention = flash_attention.flash_attention_ref
    dim.selective_scan = selective_scan.selective_scan_ref
    try:
        yield
    finally:
        (unet.group_norm_silu, attention.flash_attention,
         dim.selective_scan) = saved
