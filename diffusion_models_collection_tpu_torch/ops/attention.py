"""Multi-head attention for the denoiser backbones.

Counterpart of `diffusion_models_collection_tpu/ops/attention.py`. Every
call goes through the differentiable flash attention
(`ops/flash_attention.py`: the forward kernel, and the backward kernel under
autograd); the JAX package kept those kernels behind an opt-in flag, which
answered a TPU trade-off and has no counterpart here. Attention dropout runs
in the same kernels: each call with dropout draws one 64-bit seed on the
host, from a `torch.Generator` on the CPU (torch's default generator unless
the caller passes one), and the kernels derive the mask from it (a CPU draw:
no device sync). `torch.utils.checkpoint` restores the CPU generator's state
for its recompute, so a checkpointed block draws the same seed, and the same
mask, again. Proportional attention (`key_sizes`, ToMe, `ops/tome.py`)
adds log(size) of each key to its logits, so a merged key that stands for s
tokens draws softmax mass as if present s times: the kernels' key-bias forms,
with the float32 bias log(key_sizes) of shape (B, Lk) shared by the heads.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention


def draw_seed(generator: Optional[torch.Generator] = None) -> int:
    """One attention call's dropout seed, from `generator` (a CPU generator)
    or torch's default CPU generator."""
    if generator is not None and generator.device.type != "cpu":
        raise ValueError("the attention dropout seed is drawn on the host: "
                         "pass a CPU generator, got one on "
                         f"{generator.device}")
    return int(torch.randint(0, 2**63 - 1, (), dtype=torch.int64,
                             generator=generator))


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    *,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    key_sizes: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Attention over (B, L, D) tensors split into `num_heads` heads, with
    dropout on the probabilities at `dropout_rate` unless `deterministic`,
    and proportional attention over `key_sizes` (B, L) when given."""
    batch, length, dim = q.shape
    head_dim = dim // num_heads
    dropout_p = 0.0 if deterministic else float(dropout_rate)
    seed = draw_seed(generator) if dropout_p > 0.0 else None

    def split(x):
        x = x.reshape(batch, -1, num_heads, head_dim).transpose(1, 2)
        return x.reshape(batch * num_heads, -1, head_dim).contiguous()

    bias = None
    if key_sizes is not None:
        bias = torch.log(key_sizes.to(torch.float32)).contiguous()
    out = flash_attention(split(q), split(k), split(v), dropout_p, seed, bias)
    out = out.reshape(batch, num_heads, length, head_dim).transpose(1, 2)
    return out.reshape(batch, length, dim)
