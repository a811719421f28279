// A per-key additive bias on the attention scores, shared by the
// flash-attention forward (flash_attn.cu) and backward (flash_attn_bwd.cu):
// proportional attention of token merging (ToMe), where a merged key that
// stands for s tokens gets log(s) added to its logits, so it draws softmax
// mass as if it were present s times.
//
// The bias is float32 (B, L), one row per batch item, shared by the item's
// heads: head bh reads row bh / heads (the (B * H, L, d) layout of
// `ops/attention.py`). It is read from device memory where a tile needs it
// (B L floats, which stay in L2), never expanded to (BH, L). The forms with
// a bias are template instantiations of their own, compiled in their own
// translation units (flash_attn_bias.cu, flash_attn_bwd_bias.cu): the forms
// without one are unchanged and nvcc builds the two sets in parallel.

#pragma once

#include <cstddef>

struct KeyBias {
  const float* ptr;  // (B, L) float32; null in the forms without a bias
  int heads;         // heads a batch item: row bh / heads for head bh
};

// The bias row of head bh.
__device__ __forceinline__ const float* key_bias_row(const KeyBias& kb, int bh,
                                                     int L) {
  return kb.ptr + (size_t)(bh / kb.heads) * L;
}

// The bias of `key`, times `factor` (log2(e) for the base-2 softmax); 0 for a
// key past L, whose score the caller masks or whose K and V rows are 0.
__device__ __forceinline__ float key_bias_at(const float* row, int key, int L,
                                             float factor) {
  return key < L ? factor * __ldg(row + key) : 0.f;
}
