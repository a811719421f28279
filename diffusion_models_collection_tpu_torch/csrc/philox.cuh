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
// wasted. The bf16 kernels' tensor-core layouts have their own exchanges
// (`dropout_keep_bits_rows`, `dropout_keep_bits_cols`), with the same rule:
// each call once.

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

__device__ __forceinline__ uint32_t keep_nibble(const uint4& w,
                                                uint32_t threshold) {
  return (uint32_t)(w.x < threshold) | (uint32_t)(w.y < threshold) << 1 |
         (uint32_t)(w.z < threshold) << 2 | (uint32_t)(w.w < threshold) << 3;
}

// The bf16 kernels' layout (bf16_mma.cuh): scores of 16 query rows row0 + g,
// row0 + g + 8 (lane = 4 g + t) against keys k0 + 8 j + 2 t, + 1 in n8
// tile j < NB <= 8. Bit 4 j + e of the result keeps element e of tile j's
// accumulator: row g for e < 2, row g + 8 for e >= 2, key k0 + 8 j + 2 t +
// (e & 1). k0 % 4 == 0. The four keys of one Philox call (8 j + 4 (t >> 1)
// ..) of one row lie in lanes t and t ^ 1: the even lane computes row g's
// call, the odd lane row g + 8's, and one shuffle of every tile's keep bits
// at once swaps the halves, so each call is made once.
template <int NB>
__device__ __forceinline__ uint32_t dropout_keep_bits_rows(
    const DropoutParams& dp, uint32_t bh, int row0, int k0, int lane) {
  static_assert(NB <= 8, "four bits a tile in one word");
  const int g = lane >> 2, t = lane & 3;
  const uint32_t row = (uint32_t)(row0 + g + 8 * (t & 1));
  uint32_t own = 0;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const uint32_t group = (uint32_t)((k0 >> 2) + 2 * j + (t >> 1));
    own |= keep_nibble(philox4x32_10(make_uint4(group, row, bh, 0u),
                                     dp.seed_lo, dp.seed_hi),
                       dp.threshold)
           << (4 * j);
  }
  const uint32_t other = __shfl_xor_sync(0xffffffffu, own, 1);
  const uint32_t top = (t & 1) ? other : own;  // row g's nibbles
  const uint32_t bottom = (t & 1) ? own : other;  // row g + 8's
  const int word = 2 * (t & 1);  // keys 2t, 2t+1 are words 0, 1 or 2, 3
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < NB; ++j)
    bits |= ((top >> (4 * j + word)) & 3u) << (4 * j) |
            ((bottom >> (4 * j + word)) & 3u) << (4 * j + 2);
  return bits;
}

// The transposed layout of the bf16 backward: keys along the rows, 16 keys
// key0 + g, key0 + g + 8 against queries q0 + 8 j + 2 t, + 1 in n8 tile j <
// NB <= 8; bit 4 j + e keeps element e (key g for e < 2, g + 8 for e >= 2,
// query q0 + 8 j + 2 t + (e & 1)). key0 % 4 == 0. The warp's 4 key groups x 8
// queries of a tile are 32 Philox calls: lane l computes the call of group l
// & 3 and query l >> 2 for every tile, and four shuffles hand each lane the
// keep bits of its two keys and two queries.
template <int NB>
__device__ __forceinline__ uint32_t dropout_keep_bits_cols(
    const DropoutParams& dp, uint32_t bh, int key0, int q0, int lane) {
  static_assert(NB <= 8, "four bits a tile in one word");
  const uint32_t group = (uint32_t)((key0 >> 2) + (lane & 3));
  uint32_t mine = 0;
#pragma unroll
  for (int j = 0; j < NB; ++j)
    mine |= keep_nibble(
                philox4x32_10(
                    make_uint4(group, (uint32_t)(q0 + 8 * j + (lane >> 2)),
                               bh, 0u),
                    dp.seed_lo, dp.seed_hi),
                dp.threshold)
            << (4 * j);
  const int g = lane >> 2, t = lane & 3;
  const int src = 8 * t + (g >> 2);  // key group g >> 2, query 2t
  uint32_t w[4];
  w[0] = __shfl_sync(0xffffffffu, mine, src);      // key g, query 2t
  w[1] = __shfl_sync(0xffffffffu, mine, src + 4);  // key g, query 2t + 1
  w[2] = __shfl_sync(0xffffffffu, mine, src + 2);  // key g + 8, query 2t
  w[3] = __shfl_sync(0xffffffffu, mine, src + 6);  // key g + 8, query 2t + 1
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      bits |= ((w[e] >> (4 * j + (g & 3))) & 1u) << (4 * j + e);
  return bits;
}
