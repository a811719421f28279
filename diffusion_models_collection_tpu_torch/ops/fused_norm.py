"""Fused GroupNorm + SiLU for NHWC activations, forward and backward.

Counterpart of `diffusion_models_collection_tpu/ops/fused_norm.py`. The UNet
applies GroupNorm(8) + SiLU before both convs of every residual block and at
the output head.

* `group_norm_silu_fwd_stats` (the operator `dmc::gn_silu_fwd`,
  `ops/_library.py`) computes it in one kernel (`csrc/gn_silu.cu`)
  on a CUDA tensor and through `group_norm_silu_ref` on a CPU tensor, and
  also returns `stats` (2, B, G): each (image, group)'s mean and 1 / sigma;
  `group_norm_silu_fwd` returns the output alone.
* `group_norm_silu_bwd` (`dmc::gn_silu_bwd`) is the backward from those
  statistics: one kernel
  of `csrc/gn_silu.cu` on a CUDA tensor (a group too large for one SM's
  shared memory spread over a thread block cluster; `kernel_form` names the
  form), `group_norm_silu_bwd_ref` (the same
  formulas on whole tensors) on a CPU tensor. The JAX package has no
  backward kernel: its `_core_bwd` recomputes the plain forward and takes
  that one's vjp, which on the card costs more than the forward kernel
  saves. The tests hold both backward versions to that recompute.
* `group_norm_silu` is the differentiable op (`GroupNormSiLU`), as the JAX
  package's `_group_norm_silu_core` custom_vjp; `group_norm_silu_plain` is
  the same over the plain versions on any device (`GroupNormSiLURef`), for
  `ops.plain.plain_kernels`.

x (and the gradient g) are float32 or bfloat16; scale, bias, `stats` and
the dscale, dbias they give are float32. A bfloat16 x takes the kernels'
bf16 form, which is the JAX package's `group_norm_silu(x.astype(f32))
.astype(bf16)` (the UNet's mixed precision) and its autodiff: statistics and
arithmetic in float32, y and dx rounded to bfloat16. Each plain version does
the same: it upcasts, runs the float32 formulas and rounds its outputs to x's
type.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build, _library

EPS = 1e-5

# Kernel launches since the process started (or since a caller reset them):
# the forward's and the backward's, and of those the ones in the bf16 form.
LAUNCHES = 0
BWD_LAUNCHES = 0
BF16_LAUNCHES = 0
BWD_BF16_LAUNCHES = 0


def _grouped(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h * w, num_groups, c // num_groups)


def group_norm_silu_stats_ref(x: torch.Tensor, num_groups: int
                              ) -> torch.Tensor:
    """`stats` (2, B, G) of (B, H, W, C): each (image, group)'s mean, then
    its 1 / sqrt(biased variance + eps), float32."""
    xg = _grouped(x.float(), num_groups)
    mean = xg.mean(dim=(1, 3))
    var = ((xg - mean[:, None, :, None]) ** 2).mean(dim=(1, 3))
    return torch.stack([mean, torch.rsqrt(var + EPS)])


def group_norm_silu_ref(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """Plain PyTorch GroupNorm (eps 1e-5, biased variance) followed by SiLU,
    on (B, H, W, C), in float32 and rounded to x's type."""
    b, h, w, c = x.shape
    xg = _grouped(x.float(), num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + EPS)).reshape(b, h, w, c)
    return F.silu(y * scale + bias).to(x.dtype)


def group_norm_silu_bwd_ref(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
    stats: torch.Tensor, num_groups: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward from the forward's `stats` (mean, rstd), the
    kernel's formulas on whole tensors: with xh = (x - mean) rstd, z = xh scale +
    bias, s = sigmoid(z): dz = g s (1 + z (1 - s)); dbias = sum dz, dscale =
    sum dz xh over batch and HW; dxh = dz scale; dx = (dxh - mean_g(dxh) -
    xh mean_g(dxh xh)) rstd, the means over the group; in float32, dx
    rounded to x's type. Returns (dx, dscale, dbias)."""
    shape, dtype = x.shape, x.dtype
    x, g = x.float(), g.float()
    mean, rstd = stats
    xh = ((_grouped(x, num_groups) - mean[:, None, :, None])
          * rstd[:, None, :, None]).reshape(shape)
    z = xh * scale + bias
    s = torch.sigmoid(z)
    dz = g * s * (1 + z * (1 - s))
    dbias = dz.sum(dim=(0, 1, 2))
    dscale = (dz * xh).sum(dim=(0, 1, 2))
    dxh = _grouped(dz * scale, num_groups)
    xh = _grouped(xh, num_groups)
    m1 = dxh.mean(dim=(1, 3), keepdim=True)
    m2 = (dxh * xh).mean(dim=(1, 3), keepdim=True)
    dx = (dxh - m1 - xh * m2) * rstd[:, None, :, None]
    return dx.reshape(shape).to(dtype), dscale, dbias


def _check(name: str, x, scale, bias, num_groups: int, *others) -> None:
    """Checks the inputs (x and, in the backward, g float32 or bfloat16 of
    one type; scale, bias, stats float32)."""
    _build.check_io_dtype(name, (x, *others[:1]), (scale, bias, *others[1:]))
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    b, h, w, c = x.shape
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"{name}: scale and bias must be ({c},)")
    if num_groups < 1 or c % num_groups:
        raise ValueError(f"{name}: C={c} is not divisible by "
                         f"num_groups={num_groups}")
    if x.device.type == "cuda" and (b * num_groups >= 2**31
                                    or h * w * c >= 2**31):
        raise ValueError(f"{name}: shape {tuple(x.shape)} exceeds the "
                         "kernel's 32-bit indexing")


def _fwd_cuda(x, scale, bias, num_groups: int):
    """The forward kernel's launch: (y, stats)."""
    global LAUNCHES, BF16_LAUNCHES
    bf16 = x.dtype == torch.bfloat16
    b, h, w, c = x.shape
    lib = _build.library()
    y = torch.empty_like(x)
    stats = torch.empty((2, b, num_groups), dtype=torch.float32,
                        device=x.device)
    if x.numel():
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            mean = stats.data_ptr()
            err = lib.gn_silu_fwd(x.data_ptr(), scale.data_ptr(),
                                  bias.data_ptr(), y.data_ptr(), mean,
                                  mean + 4 * b * num_groups, b, h * w, c,
                                  num_groups, EPS, int(bf16), stream)
        _build.check(err, "gn_silu_fwd")
        LAUNCHES += 1
        BF16_LAUNCHES += bf16
    return y, stats


_FWD = _library.define(
    "gn_silu_fwd(Tensor x, Tensor scale, Tensor bias, int num_groups) "
    "-> (Tensor, Tensor)",
    cpu=lambda x, scale, bias, num_groups: (
        group_norm_silu_ref(x, scale, bias, num_groups),
        group_norm_silu_stats_ref(x, num_groups)),
    cuda=_fwd_cuda,
    fake=lambda x, scale, bias, num_groups: (
        torch.empty_like(x),
        x.new_empty((2, x.shape[0], num_groups), dtype=torch.float32)))


def group_norm_silu_fwd_stats(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm + SiLU on (B, H, W, C) float32 or bfloat16, the operator
    `dmc::gn_silu_fwd`: the kernel for a CUDA tensor, the plain version for
    a CPU tensor. Returns (y, stats), y of x's type, `stats` (2, B, G) the
    groups' float32 means and 1 / sigma."""
    _check("group_norm_silu", x, scale, bias, num_groups)
    return _FWD(x, scale, bias, num_groups)


def group_norm_silu_fwd(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """`group_norm_silu_fwd_stats` without the statistics."""
    return group_norm_silu_fwd_stats(x, scale, bias, num_groups)[0]


def _bwd_cpu(x, scale, bias, g, stats, num_groups: int):
    dx, dscale, dbias = group_norm_silu_bwd_ref(x, scale, bias, g, stats,
                                                num_groups)
    return dx, torch.stack([dscale, dbias])


def _bwd_cuda(x, scale, bias, g, stats, num_groups: int):
    """The backward kernel's launch: (dx, [dscale; dbias]). The kernel
    writes dscale and dbias per image, (B, C), summed over the batch here."""
    global BWD_LAUNCHES, BWD_BF16_LAUNCHES
    bf16 = x.dtype == torch.bfloat16
    b, h, w, c = x.shape
    dx = torch.empty_like(x)
    if not x.numel():
        return dx, scale.new_zeros((2, c))
    lib = _build.library()
    rows = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    # autograd runs a backward on its own thread: take that thread's current
    # stream for the device here, at the launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        mean, sums = stats.data_ptr(), rows.data_ptr()
        err = lib.gn_silu_bwd(x.data_ptr(), g.data_ptr(), scale.data_ptr(),
                              bias.data_ptr(), mean,
                              mean + 4 * b * num_groups, dx.data_ptr(), sums,
                              sums + 4 * b * c, b, h * w, c, num_groups,
                              int(bf16), stream)
    _build.check(err, "gn_silu_bwd")
    BWD_LAUNCHES += 1
    BWD_BF16_LAUNCHES += bf16
    return dx, rows.sum(1)


_BWD = _library.define(
    "gn_silu_bwd(Tensor x, Tensor scale, Tensor bias, Tensor g, "
    "Tensor stats, int num_groups) -> (Tensor, Tensor)",
    cpu=_bwd_cpu,
    cuda=_bwd_cuda,
    fake=lambda x, scale, bias, g, stats, num_groups: (
        torch.empty_like(x),
        scale.new_empty((2, x.shape[-1]), dtype=torch.float32)))


def group_norm_silu_bwd(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
    stats: torch.Tensor, num_groups: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GroupNorm + SiLU backward from the forward's `stats`, for the
    output gradient g (B, H, W, C), the operator `dmc::gn_silu_bwd`: the
    kernel for CUDA tensors, the plain version for CPU tensors. Returns (dx,
    dscale, dbias): dx of x's type (float32 or bfloat16; g of the same),
    dscale and dbias float32 (the operator returns them stacked, (2, C))."""
    name = "group_norm_silu_bwd"
    _check(name, x, scale, bias, num_groups, g, stats)
    want = (2, x.shape[0], num_groups)
    if g.shape != x.shape or stats.shape != want:
        raise ValueError(
            f"{name}: g must be {tuple(x.shape)} and stats {want}, got "
            f"{tuple(g.shape)} and {tuple(stats.shape)}")
    dx, sums = _BWD(x, scale, bias, g, stats, num_groups)
    return dx, sums[0], sums[1]


def kernel_form(x_shape, num_groups: int, backward: bool = False,
                dtype: torch.dtype = torch.float32) -> str:
    """In words, the form `csrc/gn_silu.cu` takes for a (B, H, W, C) shape
    of `dtype` (it builds the kernels on first use)."""
    _, h, w, c = x_shape
    code = _build.library().gn_silu_form(h * w, c, num_groups, int(backward),
                                         int(dtype == torch.bfloat16))
    blocks, code = divmod(code, 100000)
    form, threads = divmod(code, 10000)
    what = {0: "generic, the group read from device memory each pass",
            1: ("dxh in shared memory, x read twice" if backward
                else "the group in shared memory"),
            2: "dxh and xh in shared memory",
            3: f"cluster of {blocks} blocks, dxh of a block's rows in shared "
               "memory, x read twice",
            4: f"cluster of {blocks} blocks, dxh and xh of a block's rows in "
               "shared memory"}[form]
    return f"{what}, {threads} threads"


class GroupNormSiLU(torch.autograd.Function):
    """GroupNorm + SiLU whose forward is `group_norm_silu_fwd_stats` and
    whose backward is `group_norm_silu_bwd`, from the residuals (x, scale,
    bias, stats)."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups):
        ctx.num_groups = num_groups
        y, stats = group_norm_silu_fwd_stats(x, scale, bias, num_groups)
        ctx.save_for_backward(x, scale, bias, stats)
        return y

    @staticmethod
    def backward(ctx, g):
        # autograd hands g over in the consumer's layout (a convolution's,
        # mostly contiguous already); the kernel walks contiguous rows
        x, scale, bias, stats = ctx.saved_tensors
        return (*group_norm_silu_bwd(x, scale, bias, g.contiguous(), stats,
                                     ctx.num_groups), None)


class GroupNormSiLURef(torch.autograd.Function):
    """`GroupNormSiLU` over the plain versions on any device, for
    `ops.plain.plain_kernels`."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups):
        ctx.num_groups = num_groups
        ctx.save_for_backward(x, scale, bias,
                              group_norm_silu_stats_ref(x, num_groups))
        return group_norm_silu_ref(x, scale, bias, num_groups)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, stats = ctx.saved_tensors
        return (*group_norm_silu_bwd_ref(x, scale, bias, g.contiguous(),
                                         stats, ctx.num_groups), None)


def group_norm_silu(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """Differentiable GroupNorm + SiLU on (B, H, W, C) float32 or bfloat16
    through the forward and backward kernels (their plain versions on the
    CPU); y of x's type."""
    return GroupNormSiLU.apply(x, scale, bias, num_groups)


def group_norm_silu_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """`group_norm_silu` through the plain versions (`GroupNormSiLURef`)."""
    return GroupNormSiLURef.apply(x, scale, bias, num_groups)
