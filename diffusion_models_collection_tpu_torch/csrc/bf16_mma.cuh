// Tensor-core building blocks of the bf16 attention kernels (flash_attn.cu,
// flash_attn_bwd.cu): mma.sync m16n8k16 on bf16 operands with float32
// accumulators, ldmatrix loads of its fragments from bf16 tiles in shared
// memory, cp.async copies into those tiles, and the two-term split that
// keeps a float32 operand float32-accurate.
//
// Fragments of mma.m16n8k16 (PTX ISA), lane = 4 g + t, two bf16 a register
// (the lower column in the lower half):
//   A, 16 x 16:  a0 (row g, cols 2t, 2t+1)  a1 (row g+8, 2t..)
//                a2 (row g, cols 8+2t..)    a3 (row g+8, 8+2t..)
//   B, 16 x 8:   b0 (k 2t, 2t+1; n g)  b1 (k 8+2t..; n g)
//   C, 16 x 8:   c0 c1 (row g, cols 2t, 2t+1)  c2 c3 (row g+8, ...)
// So the C fragments of two neighbouring n8 tiles are, packed in pairs, the
// A fragment of one k16 step: a product's result is the next product's A
// operand without leaving the registers (`split_a`).
//
// Tiles in shared memory are row-major bf16 with the row stride padded by 8
// elements (16 bytes): for every stride here (80, 144, 272 or 48 bytes)
// the eight rows of one 8 x 8 matrix that ldmatrix reads start in eight
// different 16-byte groups of banks, so the read has no bank conflict. ldmatrix.x4 reads four 8 x 8 matrices, lane l giving the address
// of row l & 7 of matrix l >> 3. Two lane patterns cover every fragment here:
//   `lane_off_a`: A from a [m][k] tile, or B from a [k][n] tile by .trans;
//   `lane_off_b`: B from a [n][k] tile, or A from a [k][m] tile by .trans,
// each at the origin of a 16 x 16 block (B: two n8 tiles of one k16 step,
// registers 0, 1 for the first and 2, 3 for the second).
//
// The split: a float32 x is hi + lo with hi = bf16(x) and lo = bf16(x - hi)
// (x - hi is exact in float32), so |x - (hi + lo)| <= 2^-16 |x| where one
// bf16 rounding leaves up to 2^-8 |x|. Two products, hi and lo against the
// same exact bf16 operand, give the product of x to about float32 accuracy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from device to shared memory, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, or 4 zero bytes when !valid
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_groups() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^x on the exponential unit alone (relative error about 2e-7; 2^-inf = 0)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b on the tensor cores (bf16 operands, float32 accumulators)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += (hi + lo) b: the product of a float32 operand split in two
__device__ __forceinline__ void mma_bf16_split(float (&c)[4],
                                               const uint32_t (&hi)[4],
                                               const uint32_t (&lo)[4],
                                               uint32_t b0, uint32_t b1) {
  mma_bf16(c, hi, b0, b1);
  mma_bf16(c, lo, b0, b1);
}

// Per-lane element offsets of ldmatrix.x4 at the origin of a 16 x 16 block
// of a tile with row stride `stride` (see above).
__device__ __forceinline__ int lane_off_a(int lane, int stride) {
  return (lane & 15) * stride + (lane >> 4) * 8;
}

__device__ __forceinline__ int lane_off_b(int lane, int stride) {
  return ((lane & 7) + (lane >> 4) * 8) * stride + ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x0, x1 rounded to bf16 (nearest even), x0 in the lower half
__device__ __forceinline__ uint32_t pack_bf16x2(float x0, float x1) {
  return bf16x2_bits(__floats2bfloat162_rn(x0, x1));
}

// x0, x1 as hi + lo, each a bf16 pair
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 back = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = pack_bf16x2(x0 - back.x, x1 - back.y);
}

// The A fragment of one k16 step, split in hi and lo, from the float32 C
// fragments of its two n8 tiles: c0 holds columns 0-7 of the step, c1
// columns 8-15.
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4], uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_bf16x2(c0[0], c0[1], hi[0], lo[0]);
  split_bf16x2(c0[2], c0[3], hi[1], lo[1]);
  split_bf16x2(c1[0], c1[1], hi[2], lo[2]);
  split_bf16x2(c1[2], c1[3], hi[3], lo[3]);
}

// Request rows r0 .. r0 + ROWS - 1 of a bf16 matrix with rows ld apart into
// a (ROWS, DMAX + 8) tile by cp.async, 16 bytes a piece, zero past L and past
// column ncols (ncols % 8 == 0). A thread requests pieces tid, tid + NT, ...
template <int DMAX, int ROWS, int NT>
__device__ __forceinline__ void request_bf16_cols(bf16* dst,
                                                  const bf16* __restrict__ src,
                                                  int r0, int L, int ld,
                                                  int ncols, int tid) {
  constexpr int V = DMAX / 8;  // pieces of a row
#pragma unroll
  for (int j = 0; j < (ROWS * V + NT - 1) / NT; ++j) {
    const int i = tid + j * NT;
    if (ROWS * V % NT != 0 && i >= ROWS * V) break;
    const int r = i / V;
    const int c = (i - r * V) * 8;
    const bool ok = r0 + r < L && c < ncols;
    cp_async16_zfill(dst + r * (DMAX + 8) + c,
                     ok ? src + (size_t)(r0 + r) * ld + c : src, ok);
  }
}

// The same for one head's (L, d) bf16 matrix (d % 8 == 0).
template <int DMAX, int ROWS, int NT>
__device__ __forceinline__ void request_bf16_rows(bf16* dst,
                                                  const bf16* __restrict__ src,
                                                  int r0, int L, int d,
                                                  int tid) {
  request_bf16_cols<DMAX, ROWS, NT>(dst, src, r0, L, d, d, tid);
}

// Head dimensions past 128 (the wide forms of flash_attn.cu and
// flash_attn_bwd.cu): up to kWideMax a block owns every column of d, which
// it pads to kWideMid or kWideMax; past it a block owns kWideCols output
// columns and sums each product over d in chunks of as many.
constexpr int kWideMax = 256;
constexpr int kWideMid = 192;  // the one-block forms' narrower DMAX
constexpr int kWideCols = 128;
