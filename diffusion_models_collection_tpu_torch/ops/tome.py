"""Token Merging (ToMe) for DiT inference.

Counterpart of `diffusion_models_collection_tpu/ops/tome.py` (Bolya &
Hoffman 2023, "Token Merging for Fast Stable Diffusion"): before a block's
attention the r most redundant patch tokens merge into their most similar
destination, the attention runs on L - r tokens, and its output is copied
back (unmerged) so the residual stream keeps every token. Training-free and
parameter-free: any DiT checkpoint samples with merging switched on.

Matching is bipartite soft matching over a 2-D strided partition:
destinations are the top-left anchor of each sy x sx region of the token
grid, every other token is a source; each source is scored against the
destinations by cosine similarity, and the r best-scoring sources merge into
their best destination by size-weighted mean. The attention adds log(size)
to each key's logits (`ops/attention.py`, the kernels' key-bias forms), so a
destination that swallowed s tokens counts s times: with exactly duplicated
tokens merged attention is exact.

The merged sequence's layout is the JAX package's, [kept sources ;
destinations]. The plan's index arrays equal the JAX package's: its
`argsort` is stable, so this one passes `stable=True`, and both `argmax`es
return the first maximum. Merging is a gather of the kept sources and a
scatter-add (`scatter_add_`) of the merged sources onto their destinations;
unmerging is one gather. The JAX package forms both as products with a
one-hot (B, L, L - r) matrix, which suited the TPU's matrix unit; here the
gather and the scatter move only the rows they need. On a card the
scatter's float sum order is not fixed, so a merged row may differ in its
last bits from run to run: ToMe is held to a tolerance, never to bit
equality.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ToMeSpec:
    """Static merge geometry: `r` of the h * w patch tokens merge per
    application; destinations are the top-left anchors of the sy x sx
    regions."""

    h: int
    w: int
    r: int
    sx: int = 2
    sy: int = 2

    def __post_init__(self):
        if self.sx < 1 or self.sy < 1:
            raise ValueError("tome strides must be >= 1")
        if self.r < 0:
            raise ValueError("tome r must be >= 0")
        if self.r > self.num_src:
            raise ValueError(
                f"tome r={self.r} exceeds the {self.num_src} source "
                f"tokens of a {self.h}x{self.w}/{self.sy}x{self.sx} layout")

    @property
    def num_dst(self) -> int:
        return ((self.h + self.sy - 1) // self.sy) * (
            (self.w + self.sx - 1) // self.sx)

    @property
    def num_src(self) -> int:
        return self.h * self.w - self.num_dst

    @classmethod
    def from_ratio(cls, h: int, w: int, ratio: float, sx: int = 2,
                   sy: int = 2) -> Optional["ToMeSpec"]:
        """ratio = the fraction of all h * w tokens to merge, clamped to
        the sources there are; None when it rounds to no merge."""
        if not 0.0 <= ratio < 1.0:
            raise ValueError(f"tome_ratio must be in [0, 1), got {ratio}")
        spec = cls(h, w, 0, sx, sy)  # the layout only, for num_src
        r = min(int(round(ratio * h * w)), spec.num_src)
        if r == 0:
            return None
        return cls(h, w, r, sx, sy)


def _layout(spec: ToMeSpec, device: torch.device):
    """The partition's indices on `device` (destinations, sources) and the
    map from a token to its column of [sources ; destinations]: built once
    per geometry and device (`_cached_layout`), not at every plan; built
    anew in a run that `torch.export` traces, where cached tensors would be
    constants of the program, which the scan of `serving.py` refuses in its
    step."""
    if torch.compiler.is_exporting():
        return _build_layout(spec, device)
    return _cached_layout(spec, device)


def _build_layout(spec: ToMeSpec, device: torch.device):
    """Destinations are the top-left anchors of the sy x sx regions; the
    sources, in token order, are the positions a stable sort of the
    destination flags puts first."""
    rows = torch.arange(0, spec.h, spec.sy, device=device)
    cols = torch.arange(0, spec.w, spec.sx, device=device)
    idx_dst = (rows[:, None] * spec.w + cols[None, :]).reshape(-1)
    flags = torch.zeros(spec.h * spec.w, dtype=torch.int64,
                        device=device).index_fill(0, idx_dst, 1)
    idx_src = torch.argsort(flags, stable=True)[:spec.num_src]
    inv = torch.empty(spec.h * spec.w, dtype=torch.int64, device=device)
    inv = inv.index_copy(0, idx_src, torch.arange(spec.num_src,
                                                  device=device))
    inv = inv.index_copy(0, idx_dst, spec.num_src + torch.arange(
        spec.num_dst, device=device))
    return idx_dst, idx_src, inv


_cached_layout = functools.lru_cache(maxsize=16)(_build_layout)


def build_plan(metric: torch.Tensor, spec: ToMeSpec) -> Dict[str, torch.Tensor]:
    """The per-item merge assignment from similarity features `metric`
    (B, L, D), the tensor the block is about to attend over. Returns index
    arrays (int64) for `merge`, `unmerge` and `sizes`, under the JAX plan's
    names: `kept` (B, Ns - r) and `merged` (B, r) source rows in score
    order, `dst_assign` (B, r) the destination of each merged source,
    `counts` (B, Nd) float32 1 + the sources merged into each destination,
    `gather` (B, L) the merged-sequence row of every token, and the static
    `idx_dst`, `idx_src`. No gradient flows through the plan."""
    if metric.dim() != 3 or metric.shape[1] != spec.h * spec.w:
        raise ValueError(f"metric must be (B, {spec.h * spec.w}, D), got "
                         f"{tuple(metric.shape)}")
    device = metric.device
    idx_dst, idx_src, inv = _layout(spec, device)
    nd, ns, r = spec.num_dst, spec.num_src, spec.r
    with torch.no_grad():
        m = metric.float()
        xn = m / (torch.linalg.vector_norm(m, dim=-1, keepdim=True) + 1e-8)
        scores = torch.matmul(xn[:, idx_src], xn[:, idx_dst].transpose(1, 2))
        node_max, node_idx = scores.max(dim=-1)  # (B, Ns): the first maximum
        order = torch.argsort(-node_max, dim=-1, stable=True)
        merged = order[:, :r]
        kept = order[:, r:]
        dst_assign = torch.gather(node_idx, 1, merged)
        counts = torch.ones(metric.shape[0], nd, dtype=torch.float32,
                            device=device)
        counts.scatter_add_(1, dst_assign,
                            torch.ones_like(dst_assign, dtype=torch.float32))
        # the merged-sequence row of each token ([kept ; dsts]): a source of
        # rank < r its destination's row, of rank >= r its own kept row
        rank = torch.argsort(order, dim=-1, stable=True)
        row_src = torch.where(rank < r, (ns - r) + node_idx, rank - r)
        row_dst = ((ns - r) + torch.arange(nd, device=device)).expand(
            metric.shape[0], nd)
        gather = torch.cat([row_src, row_dst], dim=1)[:, inv]
    return {"kept": kept, "merged": merged, "dst_assign": dst_assign,
            "counts": counts, "gather": gather, "idx_dst": idx_dst,
            "idx_src": idx_src}


def sizes(plan: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B, L - r) float32 multiplicities of the merged sequence, for
    proportional attention: kept sources 1, destinations 1 + merged-in."""
    counts = plan["counts"]
    ones = torch.ones(counts.shape[0], plan["kept"].shape[1],
                      dtype=counts.dtype, device=counts.device)
    return torch.cat([ones, counts], dim=1)


def _rows(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """t[b, index[b, i], :] for (B, n) indices."""
    return torch.gather(t, 1, index[..., None].expand(-1, -1, t.shape[-1]))


def merge(plan: Dict[str, torch.Tensor], t: torch.Tensor,
          mode: str = "mean") -> torch.Tensor:
    """(B, L, C) -> (B, L - r, C): each destination summed with its merged
    sources (divided by its size for `mean`), kept sources as they are;
    layout [kept sources ; destinations]. In t's type."""
    if mode not in ("mean", "sum"):
        raise ValueError(f"Unknown merge mode: {mode!r}")
    src = t[:, plan["idx_src"]]
    dst = t[:, plan["idx_dst"]].clone()
    dst.scatter_add_(1, plan["dst_assign"][..., None].expand(
        -1, -1, t.shape[-1]), _rows(src, plan["merged"]))
    if mode == "mean":
        dst = dst / plan["counts"][..., None].to(t.dtype)
    return torch.cat([_rows(src, plan["kept"]), dst], dim=1)


def unmerge(plan: Dict[str, torch.Tensor], t: torch.Tensor) -> torch.Tensor:
    """(B, L - r, C) -> (B, L, C): every token takes its representative's
    row (kept tokens their own, merged tokens their destination's)."""
    return _rows(t, plan["gather"])
