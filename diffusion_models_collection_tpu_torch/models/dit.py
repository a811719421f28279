"""DiT, the diffusion transformer, and the pieces DiM shares with it.

Counterpart of `diffusion_models_collection_tpu/models/dit.py`, with the
PyTorch reference's module names (`x_embedder`, `pos_embed`, `t_embedder`,
`y_embedder`, `blocks.{i}.attn.*` as `nn.MultiheadAttention` names them,
`blocks.{i}.mlp.*`, `blocks.{i}.adaLN_modulation.*`, `final_layer`), the
names `utils/torch_export.py` writes, so its state dicts and JAX checkpoints
bridged by `utils/weights.py` load with `strict=True`.

Contract: `model(x, t, y) -> eps` with x (B, H, W, C) float32, t (B,) int,
y (B,) int labels shifted by +1 with 0 the CFG null label; float32 NHWC out.
adaLN-Zero blocks over patch tokens: affine-free LayerNorms (the DiM's are
affine), self-attention through `ops.multihead_attention` (the flash
kernels, with the attention dropout inside them in training), the exact-erf
GELU MLP. Init as the JAX package: xavier-uniform linears with zero biases,
pos_embed N(0, 0.02), zero adaLN and final projection, so the model starts
as an identity-residual network and its output is exactly 0. `remat=True`
runs each block under gradient checkpointing (`layers.run_block`), whose
recompute draws the same dropout masks. `dtype=torch.bfloat16` is the JAX
model's mixed precision: linears, the patch conv and the activations in bf16
on float32 parameters (`layers.CastLinear`, `CastConv2d`), LayerNorms in
float32 with a bf16 result (`layers.CastLayerNorm`), attention on bf16 q, k,
v (the kernels' bf16 form), eps float32.

`pag_perturb` (a constructor field, and a call-time argument of `forward`
so one module serves both views) makes every attention map the identity:
each block's attention output is its v, through the out projection
(Perturbed Attention Guidance, `diffusion/pag.py`). Not ported, and raising
when asked for: MoE MLPs (`num_experts`), token merging (`tome_ratio`) and
`quant` (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..ops.attention import multihead_attention
from .layers import (
    AdaLNModulation,
    CastLayerNorm,
    CastLinear,
    LabelTable,
    PatchEmbed,
    TimestepEmbedder,
    modulate,
    run_block,
    unpatchify,
    cast_linear,
    xavier_linear_,
)


class Mlp(nn.Sequential):
    """Linear -> GELU (exact erf) -> Dropout -> Linear -> Dropout (keys
    `0` and `3`), xavier weights and zero biases as the JAX package; in
    `dtype`."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__(
            xavier_linear_(CastLinear(in_dim, hidden_dim,
                                      compute_dtype=dtype)),
            nn.GELU(approximate="none"),
            nn.Dropout(dropout),
            xavier_linear_(CastLinear(hidden_dim, out_dim,
                                      compute_dtype=dtype)),
            nn.Dropout(dropout),
        )


class SelfAttention(nn.Module):
    """QKV self-attention with `nn.MultiheadAttention`'s parameter names (a
    fused (3D, D) `in_proj_weight` with rows [q; k; v], `in_proj_bias`,
    `out_proj`), xavier weights and zero biases; dropout on the attention
    probabilities in training mode only; projections and attention in
    `dtype`. With `perturb` the attention map is the identity: the out
    projection runs on v (PAG)."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"hidden size {dim} is not a multiple of "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.dropout = dropout
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = xavier_linear_(CastLinear(dim, dim,
                                                  compute_dtype=dtype))
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, perturb: bool = False) -> torch.Tensor:
        q, k, v = cast_linear(x, self.in_proj_weight, self.in_proj_bias,
                              self.dtype).chunk(3, dim=-1)
        out = v if perturb else multihead_attention(
            q, k, v, self.num_heads, dropout_rate=self.dropout,
            deterministic=not self.training)
        return self.out_proj(out)


def _layer_norm(hidden_size: int,
                dtype: Optional[torch.dtype] = None) -> nn.LayerNorm:
    return CastLayerNorm(hidden_size, eps=1e-6, elementwise_affine=False,
                         compute_dtype=dtype)


class DiTBlock(nn.Module):
    """adaLN-Zero transformer block: six modulations from the conditioning,
    x + gate_msa * attn(modulate(LN(x))), then x + gate_mlp *
    mlp(modulate(LN(x)))."""

    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm1 = _layer_norm(hidden_size, dtype)
        self.attn = SelfAttention(hidden_size, num_heads, dropout, dtype)
        self.norm2 = _layer_norm(hidden_size, dtype)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio), hidden_size,
                       dropout, dtype)
        self.adaLN_modulation = AdaLNModulation(hidden_size, 6, dtype)

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                perturb: bool = False) -> torch.Tensor:
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = self.adaLN_modulation(c)
        x = x + gate_msa[:, None, :] * self.attn(
            modulate(self.norm1(x), shift_msa, scale_msa), perturb)
        return x + gate_mlp[:, None, :] * self.mlp(
            modulate(self.norm2(x), shift_mlp, scale_mlp))


class FinalLayer(nn.Module):
    """Two adaLN modulations, an affine-free LayerNorm and a zero-initialised
    projection to the patch pixels."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm_final = _layer_norm(hidden_size, dtype)
        self.linear = CastLinear(hidden_size,
                                 patch_size * patch_size * out_channels,
                                 compute_dtype=dtype)
        self.adaLN_modulation = AdaLNModulation(hidden_size, 2, dtype)
        nn.init.zeros_(self.linear.weight)
        nn.init.zeros_(self.linear.bias)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(c)
        return self.linear(modulate(self.norm_final(x), shift, scale))


class DiT(nn.Module):
    """Diffusion transformer; constructor parity with the JAX `DiT`.
    `num_classes=None` builds the unconditional variant."""

    def __init__(
        self,
        img_size: Union[int, Tuple[int, int]] = (32, 32),
        patch_size: int = 2,
        in_channels: int = 3,
        hidden_size: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        num_classes: Optional[int] = None,
        dropout: float = 0.1,
        dtype: Optional[torch.dtype] = None,
        remat: bool = False,
        out_channels: Optional[int] = None,
        num_experts: int = 0,
        moe_top_k: int = 2,
        moe_capacity_factor: float = 1.25,
        tome_ratio: float = 0.0,
        tome_sx: int = 2,
        tome_sy: int = 2,
        tome_mlp: bool = False,
        quant: Optional[str] = None,
        pag_perturb: bool = False,
    ):
        super().__init__()
        for name, value in (("num_experts", num_experts),
                            ("tome_ratio", tome_ratio), ("quant", quant)):
            if value:
                raise NotImplementedError(
                    f"DiT {name}={value!r} is not ported yet (ROADMAP queue 1 "
                    "item 11)")
        self.pag_perturb = bool(pag_perturb)
        self.remat = remat
        img_h, img_w = ((img_size, img_size) if isinstance(img_size, int)
                        else tuple(img_size))
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.out_channels = out_channels or in_channels
        self.num_classes = num_classes
        self.tokens_hw = (img_h // patch_size, img_w // patch_size)
        num_patches = self.tokens_hw[0] * self.tokens_hw[1]

        self.x_embedder = PatchEmbed(patch_size, in_channels, hidden_size,
                                     dtype)
        self.pos_embed = nn.Parameter(
            torch.randn(1, num_patches, hidden_size) * 0.02)
        self.t_embedder = TimestepEmbedder(hidden_size, dtype=dtype)
        self.y_embedder = (LabelTable(num_classes, hidden_size, dtype)
                           if num_classes is not None else None)
        self.blocks = nn.ModuleList(
            DiTBlock(hidden_size, num_heads, mlp_ratio, dropout, dtype)
            for _ in range(depth))
        self.final_layer = FinalLayer(hidden_size, patch_size,
                                      self.out_channels, dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: Optional[torch.Tensor] = None, *,
                pag_perturb: Optional[bool] = None) -> torch.Tensor:
        """eps (B, H, W, C) float32; `pag_perturb` overrides the module's
        field for this call (None keeps it)."""
        perturb = self.pag_perturb if pag_perturb is None else pag_perturb
        h = self.x_embedder(x)
        h = h + self.pos_embed.to(h.dtype)
        c = self.t_embedder(t)
        if self.y_embedder is not None and y is not None:
            c = c + self.y_embedder(y)
        for block in self.blocks:
            h = run_block(block, self.remat, h, c, perturb)
        h = self.final_layer(h, c)
        # eps in float32 whatever the compute type, as the JAX model
        return unpatchify(h, *self.tokens_hw, self.patch_size,
                          self.out_channels).to(torch.float32).contiguous()
