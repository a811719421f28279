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

The dropout masks are keyed on the global (batch, head) of each head
(`flash_attention`'s `head_grid`): a data-parallel rank passes its first
row `batch0` in the global batch, a tensor-parallel rank its first head
`head0` of `total_heads`, so a sharded run draws the single-device run's
masks (every rank draws the same seed: torch's CPU generator, seeded alike).
A sequence-parallel rank passes its own queries against the keys and values
gathered from every rank (k, v longer than q) and `row0`, the global index
of its first query token, which keys each query row's mask on its global
row (E6).
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import ONE_DEVICE, flash_attention


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
    batch0: int = 0,
    head0: int = 0,
    total_heads: Optional[int] = None,
    row0: int = 0,
    seed: Optional[int] = None,
) -> torch.Tensor:
    """Attention of q (B, Lq, D) against k, v (B, Lk, D), split into
    `num_heads` heads, with dropout on the probabilities at `dropout_rate`
    unless `deterministic`, and proportional attention over `key_sizes` (B,
    Lk) when given. The call's rows are rows `batch0` .. of the global batch,
    its heads heads `head0` .. of the model's `total_heads` (default
    `num_heads`) and its query tokens tokens `row0` .. of the sequence: the
    place of its dropout masks. `seed` is the dropout's seed when the
    caller drew it (a pipeline stage replays the one-device draws); else
    the call draws one."""
    batch, length, dim = q.shape
    head_dim = dim // num_heads
    dropout_p = 0.0 if deterministic else float(dropout_rate)
    if dropout_p == 0.0:
        seed = None
    elif seed is None:
        seed = draw_seed(generator)

    def split(x):
        x = x.reshape(batch, -1, num_heads, head_dim).transpose(1, 2)
        return x.reshape(batch * num_heads, -1, head_dim).contiguous()

    bias = None
    if key_sizes is not None:
        bias = torch.log(key_sizes.to(torch.float32)).contiguous()
    total_heads = num_heads if total_heads is None else total_heads
    grid = ((num_heads, total_heads, batch0, head0)
            if (batch0, head0, total_heads) != (0, 0, num_heads)
            else ONE_DEVICE)
    out = flash_attention(split(q), split(k), split(v), dropout_p, seed, bias,
                          grid, row0)
    out = out.reshape(batch, num_heads, length, head_dim).transpose(1, 2)
    return out.reshape(batch, length, dim)
