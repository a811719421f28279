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
(Perturbed Attention Guidance, `diffusion/pag.py`).

The JAX DiT's three extensions:

* `num_experts` > 0 makes every block's MLP a routed Mixture-of-Experts bank
  (`models/moe.py`, top `moe_top_k` of `num_experts`, capacity factor
  `moe_capacity_factor`); a forward given a list in `moe_losses` appends to
  it the mean over blocks of their load-balance losses (the JAX model sows
  them into its 'losses' collection), which the trainer weighs by
  `moe_aux_weight`. Each block returns its loss beside its output, so a
  block under gradient checkpointing gives the same loss and gradient, and
  the model keeps no tensor of a call.
* `tome_ratio` > 0 merges that fraction of the patch tokens before every
  block's attention and unmerges after (`ops/tome.py`, one plan a block from
  the modulated tokens; proportional attention through the kernels' key-bias
  forms); with `tome_mlp`, again around the MLP with a fresh plan. Under PAG
  the identity attention is not merged. Meant for inference: merging in
  training changes the objective.
* `quant='int8'` runs the four products of every block (the qkv and out
  projections, the dense MLP's two) through the int8 product of
  `ops/quant.py`, each weight quantized once and cached; the MoE MLP, adaLN
  and the final layer stay in float. Inference only: the forward raises in
  training mode, with the JAX message.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..ops import tome as tome_ops
from ..ops.attention import multihead_attention
from ..ops.quant import Int8Weights, check_quant, int8_linear
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
from .moe import MoeMlp


class QuantLinear(CastLinear):
    """`CastLinear` that runs through the int8 product when `quant` is
    'int8' (the JAX `dense_layer` switch); same parameters and names."""

    def __init__(self, *args, quant: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant
        self.int8 = Int8Weights()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant is None:
            return super().forward(x)
        return int8_linear(x, self.weight, self.bias, self.compute_dtype,
                           self.int8)


class Mlp(nn.Sequential):
    """Linear -> GELU (exact erf) -> Dropout -> Linear -> Dropout (keys
    `0` and `3`), xavier weights and zero biases as the JAX package; in
    `dtype`."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None,
                 quant: Optional[str] = None):
        super().__init__(
            xavier_linear_(QuantLinear(in_dim, hidden_dim,
                                       compute_dtype=dtype, quant=quant)),
            nn.GELU(approximate="none"),
            nn.Dropout(dropout),
            xavier_linear_(QuantLinear(hidden_dim, out_dim,
                                       compute_dtype=dtype, quant=quant)),
            nn.Dropout(dropout),
        )


class SelfAttention(nn.Module):
    """QKV self-attention with `nn.MultiheadAttention`'s parameter names (a
    fused (3D, D) `in_proj_weight` with rows [q; k; v], `in_proj_bias`,
    `out_proj`), xavier weights and zero biases; dropout on the attention
    probabilities in training mode only; projections and attention in
    `dtype`, or through the int8 product with `quant`. With `perturb` the
    attention map is the identity: the out projection runs on v (PAG).
    `key_sizes` (B, L) makes it proportional attention over merged tokens
    (ToMe)."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None,
                 quant: Optional[str] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"hidden size {dim} is not a multiple of "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.dropout = dropout
        self.dtype = dtype
        self.quant = quant
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.in_proj_int8 = Int8Weights()
        self.out_proj = xavier_linear_(QuantLinear(dim, dim,
                                                   compute_dtype=dtype,
                                                   quant=quant))
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, perturb: bool = False,
                key_sizes: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.quant is None:
            qkv = cast_linear(x, self.in_proj_weight, self.in_proj_bias,
                              self.dtype)
        else:
            qkv = int8_linear(x, self.in_proj_weight, self.in_proj_bias,
                              self.dtype, self.in_proj_int8)
        q, k, v = qkv.chunk(3, dim=-1)
        out = v if perturb else multihead_attention(
            q, k, v, self.num_heads, dropout_rate=self.dropout,
            deterministic=not self.training, key_sizes=key_sizes)
        return self.out_proj(out)


def _layer_norm(hidden_size: int,
                dtype: Optional[torch.dtype] = None) -> nn.LayerNorm:
    return CastLayerNorm(hidden_size, eps=1e-6, elementwise_affine=False,
                         compute_dtype=dtype)


class DiTBlock(nn.Module):
    """adaLN-Zero transformer block: six modulations from the conditioning,
    x + gate_msa * attn(modulate(LN(x))), then x + gate_mlp *
    mlp(modulate(LN(x))). `num_experts` > 0 makes the MLP a `MoeMlp`, whose
    load-balance loss the block returns beside x; `tome` merges the tokens
    around the attention (and with `tome_mlp` around the MLP); `quant`
    routes the attention's and the dense MLP's products through int8."""

    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None, num_experts: int = 0,
                 moe_top_k: int = 2, moe_capacity_factor: float = 1.25,
                 tome: Optional[tome_ops.ToMeSpec] = None,
                 tome_mlp: bool = False, quant: Optional[str] = None):
        super().__init__()
        self.tome = tome
        self.tome_mlp = tome_mlp
        self.quant = quant
        self.norm1 = _layer_norm(hidden_size, dtype)
        self.attn = SelfAttention(hidden_size, num_heads, dropout, dtype,
                                  quant)
        self.norm2 = _layer_norm(hidden_size, dtype)
        hidden = int(hidden_size * mlp_ratio)
        self.mlp = (MoeMlp(hidden_size, hidden, hidden_size, num_experts,
                           moe_top_k, moe_capacity_factor, dropout, dtype)
                    if num_experts > 0 else
                    Mlp(hidden_size, hidden, hidden_size, dropout, dtype,
                        quant))
        self.adaLN_modulation = AdaLNModulation(hidden_size, 6, dtype)

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                perturb: bool = False):
        """x after the block; with a MoE MLP, (x, its load-balance loss)."""
        if self.quant is not None and self.training:
            raise ValueError(
                "quant='int8' is inference-only (rounding has no "
                "gradient); train with fp32/bf16 and quantize at serving")
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = self.adaLN_modulation(c)
        h = modulate(self.norm1(x), shift_msa, scale_msa)
        if self.tome is not None and not perturb:
            # (identity attention is token-local: merging would only change
            # the degradation, not save work, so PAG bypasses it)
            plan = tome_ops.build_plan(h, self.tome)
            h = tome_ops.unmerge(plan, self.attn(
                tome_ops.merge(plan, h), key_sizes=tome_ops.sizes(plan)))
        else:
            h = self.attn(h, perturb)
        x = x + gate_msa[:, None, :] * h
        h = modulate(self.norm2(x), shift_mlp, scale_mlp)
        if self.tome is not None and self.tome_mlp:
            plan = tome_ops.build_plan(h, self.tome)
            h = self.mlp(tome_ops.merge(plan, h))
        else:
            plan = None
            h = self.mlp(h)
        loss = None
        if isinstance(self.mlp, MoeMlp):
            h, loss = h
        if plan is not None:
            h = tome_ops.unmerge(plan, h)
        x = x + gate_mlp[:, None, :] * h
        return x if loss is None else (x, loss)


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
        self.pag_perturb = bool(pag_perturb)
        self.num_experts = int(num_experts or 0)
        self.quant = check_quant(quant)
        self.remat = remat
        img_h, img_w = ((img_size, img_size) if isinstance(img_size, int)
                        else tuple(img_size))
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.out_channels = out_channels or in_channels
        self.num_classes = num_classes
        self.tokens_hw = (img_h // patch_size, img_w // patch_size)
        num_patches = self.tokens_hw[0] * self.tokens_hw[1]
        self.tome = (tome_ops.ToMeSpec.from_ratio(*self.tokens_hw, tome_ratio,
                                                  tome_sx, tome_sy)
                     if tome_ratio else None)

        self.x_embedder = PatchEmbed(patch_size, in_channels, hidden_size,
                                     dtype)
        self.pos_embed = nn.Parameter(
            torch.randn(1, num_patches, hidden_size) * 0.02)
        self.t_embedder = TimestepEmbedder(hidden_size, dtype=dtype)
        self.y_embedder = (LabelTable(num_classes, hidden_size, dtype)
                           if num_classes is not None else None)
        self.blocks = nn.ModuleList(
            DiTBlock(hidden_size, num_heads, mlp_ratio, dropout, dtype,
                     num_experts=self.num_experts, moe_top_k=moe_top_k,
                     moe_capacity_factor=moe_capacity_factor,
                     tome=self.tome, tome_mlp=tome_mlp, quant=self.quant)
            for _ in range(depth))
        self.final_layer = FinalLayer(hidden_size, patch_size,
                                      self.out_channels, dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: Optional[torch.Tensor] = None, *,
                pag_perturb: Optional[bool] = None,
                moe_losses: Optional[list] = None) -> torch.Tensor:
        """eps (B, H, W, C) float32; `pag_perturb` overrides the module's
        field for this call (None keeps it). A MoE DiT appends the mean of
        its blocks' load-balance losses (a float32 scalar) to `moe_losses`
        when that is a list."""
        perturb = self.pag_perturb if pag_perturb is None else pag_perturb
        h = self.x_embedder(x)
        h = h + self.pos_embed.to(h.dtype)
        c = self.t_embedder(t)
        if self.y_embedder is not None and y is not None:
            c = c + self.y_embedder(y)
        aux = []
        for block in self.blocks:
            h = run_block(block, self.remat, h, c, perturb)
            if self.num_experts:
                h, loss = h
                aux.append(loss)
        if aux and moe_losses is not None:
            moe_losses.append(torch.stack(aux).mean())
        h = self.final_layer(h, c)
        # eps in float32 whatever the compute type, as the JAX model
        return unpatchify(h, *self.tokens_hw, self.patch_size,
                          self.out_channels).to(torch.float32).contiguous()
