"""Fused GroupNorm + SiLU for NHWC activations.

Counterpart of `diffusion_models_collection_tpu/ops/fused_norm.py`. The UNet
applies GroupNorm(8) + SiLU before both convs of every residual block and at
the output head; `group_norm_silu_fwd` computes it in one kernel
(`csrc/gn_silu.cu`) on a CUDA tensor and through `group_norm_silu_ref` on a
CPU tensor. `group_norm_silu` is the differentiable op (`GroupNormSiLU`):
as the JAX package's `_group_norm_silu_core` custom_vjp, its backward
recomputes through the plain version and takes that one's vjp. The JAX
package has no backward kernel, so neither has the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

EPS = 1e-5

# Kernel launches since the process started (or since a caller reset it).
LAUNCHES = 0


def group_norm_silu_ref(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """Plain PyTorch GroupNorm (eps 1e-5, biased variance) followed by SiLU,
    on (B, H, W, C)."""
    b, h, w, c = x.shape
    xg = x.reshape(b, h * w, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + EPS)).reshape(b, h, w, c)
    return F.silu(y * scale + bias)


def group_norm_silu_fwd(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """GroupNorm + SiLU on (B, H, W, C) float32: the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    global LAUNCHES
    _build.check_inputs("group_norm_silu", x, scale, bias)
    if x.dim() != 4:
        raise ValueError(f"group_norm_silu: x must be (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    b, h, w, c = x.shape
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"group_norm_silu: scale and bias must be ({c},)")
    if num_groups < 1 or c % num_groups:
        raise ValueError(f"group_norm_silu: C={c} is not divisible by "
                         f"num_groups={num_groups}")
    if x.device.type == "cpu":
        return group_norm_silu_ref(x, scale, bias, num_groups)
    if b * num_groups >= 2**31 or h * w * c >= 2**31:
        raise ValueError(f"group_norm_silu: shape {tuple(x.shape)} exceeds "
                         "the kernel's 32-bit indexing")
    lib = _build.library()
    y = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.gn_silu_fwd(x.data_ptr(), scale.data_ptr(),
                                  bias.data_ptr(), y.data_ptr(), b, h * w, c,
                                  num_groups, EPS, stream)
        _build.check(err, "gn_silu_fwd")
        LAUNCHES += 1
    return y


class GroupNormSiLU(torch.autograd.Function):
    """GroupNorm + SiLU whose forward is `group_norm_silu_fwd` and whose
    backward recomputes `group_norm_silu_ref` from the residuals
    (x, scale, bias) and takes its vjp, as the JAX package's `_core_bwd`."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups):
        ctx.num_groups = num_groups
        ctx.save_for_backward(x, scale, bias)
        return group_norm_silu_fwd(x, scale, bias, num_groups)

    @staticmethod
    def backward(ctx, g):
        # g follows the consumer's layout; the recompute takes any layout
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = group_norm_silu_ref(*inputs, ctx.num_groups)
            grads = torch.autograd.grad(y, inputs, g)
        return (*grads, None)


def group_norm_silu(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """Differentiable GroupNorm + SiLU on (B, H, W, C) float32 through the
    forward kernel (its plain version on the CPU)."""
    return GroupNormSiLU.apply(x, scale, bias, num_groups)
