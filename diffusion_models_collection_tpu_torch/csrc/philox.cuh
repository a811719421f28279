// Attention dropout's keep mask, shared by the flash-attention forward
// (flash_attn.cu) and backward (flash_attn_bwd.cu).
//
// The mask is a pure function of (seed, head, query row, key column), so the
// backward regenerates exactly the forward's mask in whatever tiles it walks,
// and nothing of size (BH, L, L) is ever stored. Philox4x32-10 (Salmon et
// al., SC 2011, as Random123 defines it): key = the 64-bit seed as (lo, hi),
// counter = (col >> 2, row, bh, 0); word col & 3 of the output decides
// column col, kept iff it is below threshold = floor((1 - p) 2^32), which the
// host computes once. An integer compare leaves no float rounding for the
// kernels and `ops/flash_attention.py:philox_keep_mask`, the plain version,
// to disagree on.
//
// The tiles give a thread the keys tx + TX b of a row (a stride that keeps
// their shared loads on disjoint banks), so the four aligned columns of one
// Philox call belong to the four neighbouring lanes tx & ~3 .. tx | 3 of the
// same row. Each lane computes a quarter of those calls and a 4 x 4 exchange
// by shuffles hands every lane its words: one call per four keys, none
// wasted.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

struct DropoutParams {
  uint32_t threshold;  // keep iff the Philox word is below it
  float keep_scale;    // 1 / (1 - p), the factor of a kept probability
  uint32_t seed_lo, seed_hi;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ uint32_t philox_word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// Bit b of the result keeps key k0 + tx + TX b of query row `row` of head
// `bh`, b < KB. k0 % 4 == 0; every lane of the warp calls this together (the
// exchange shuffles), the four lanes of a quad with the same row.
template <int TX, int KB>
__device__ __forceinline__ uint32_t dropout_keep_bits(const DropoutParams& dp,
                                                      uint32_t bh, uint32_t row,
                                                      int k0, int tx) {
  static_assert(TX % 4 == 0 && KB % 4 == 0, "four aligned keys a quad");
  const int j = tx & 3;
  uint32_t bits = 0;
#pragma unroll
  for (int bb = 0; bb < KB / 4; ++bb) {
    // this lane's call: the four columns of key b = j + 4 bb of the quad
    const uint32_t group =
        (uint32_t)((k0 >> 2) + (tx >> 2) + (TX / 4) * (j + 4 * bb));
    const uint4 w =
        philox4x32_10(make_uint4(group, row, bh, 0u), dp.seed_lo, dp.seed_hi);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // lane i = j ^ r computed the call of key i + 4 bb and sends its word
      // i ^ r = j, the word of this lane's column of that key
      uint32_t v = philox_word(w, j ^ r);
      if (r) v = __shfl_xor_sync(0xffffffffu, v, r);
      bits |= (uint32_t)(v < dp.threshold) << ((j ^ r) + 4 * bb);
    }
  }
  return bits;
}
