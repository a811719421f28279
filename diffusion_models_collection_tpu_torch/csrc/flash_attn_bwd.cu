// Flash-attention backward on (BH, L, d) float32 or bfloat16: from q, k, v,
// the forward's output o and float32 row logsumexp lse, and the output
// gradient dO, compute
//   P  = exp(q k^T * scale - lse)
//   dV = P^T dO
//   dS = P o (dO V^T - rowsum(dO o O)) * scale
//   dQ = dS K,  dK = dS^T Q.
//
// Replaces diffusion_models_collection_tpu/ops/flash_attention.py:_bwd_kernel.
//
// What bounds it on an H100: in float32 without TF32 there are no tensor
// cores, so the five L x L x d products run on CUDA-core FMAs (67 TFLOP/s)
// with both operands in shared memory; an SM starts four warp-FMAs for each
// warp-wide shared load, so the shape of the inner loops decides. What the
// design does about it:
// * Every operand is read with 16-byte shared loads, eight FMAs to a load.
//   All tiles are row-major with the row stride padded by four floats
//   (DMAX + 4, BT + 4): rows stay 16-byte aligned, and the eight lanes of a
//   quarter warp that read eight consecutive rows at one column hit
//   disjoint banks. Q K^T and dO V^T read both operands along the reduction
//   index (a thread owns rows ty + TX a and keys tx + TX b, so a quarter warp
//   reads one Q row, broadcast, and eight consecutive K rows); dV, dK and dQ
//   read P, dS along the key index and dO, Q, K along the thread's own
//   contiguous columns.
// * S and dP are computed once. One block per (head, key tile of BT keys)
//   keeps K_j, V_j in shared memory and dK_j, dV_j in registers, walks the
//   query tiles, and also forms this key tile's share of dQ_i = dS K_j. With
//   one key tile (L <= BT) that is dQ itself; with more, the shares go to a
//   scratch buffer (BH, tiles, L, d) that `flash_bwd_dq_sum_kernel` adds up in
//   a fixed order. The wrapper takes this fused form while the scratch is
//   small (L <= 256: four shares, as much traffic as one more read and
//   write of q, k, v and dO); for longer L the two-kernel form stays, where
//   a second kernel per (head, query tile) walks the key tiles, recomputes
//   dS and keeps dQ_i in registers: seven products with the same inner
//   loops, and no scratch that grows with L^2 / BT.
// * Tiles arrive by cp.async (16 bytes, zero-filled past L and past d). The
//   next Q and dO tiles are requested as soon as the dV/dK loop has read the
//   current ones, so they fly during the dQ product; the dQ kernel holds two
//   K tiles and requests the next K and V during its dQ product.
// * BT is 64 (256 threads, two blocks an SM at d <= 64), or 32 (64 threads)
//   when L <= 32, which wastes a quarter of the tile at L 16 where 64 wasted
//   fifteen sixteenths.
// delta = rowsum(dO o O) stays a launch of its own: every key tile of a head
// needs it, and it reads o, which no other kernel here touches.
// No atomics: every output element is written by one thread and the dQ
// shares are summed in tile order, so results are equal bit for bit from run
// to run. A query row past L gets lse = +inf, so its P and dS are 0; a key
// past L has K = V = 0, so its dS meets a zero K row in dQ and its own dK,
// dV rows are never written. Any L >= 1 runs; any d % 8 == 0 up to 128 runs,
// zero-padded to DMAX of 32, 64 or 128, and any wider d in the wide forms (the
// section "head dimensions past 128").
// Dropout on the probabilities (a template flag; the form without it is
// unchanged): with Z = keep / (1 - p) from `philox.cuh`, regenerated for each
// tile from (seed, head, row, key) exactly as the forward drew it,
//   dV = (P o Z)^T dO,  dP = (dO V^T) o Z,  dS = P o (dP - delta) * scale,
// and delta = rowsum(dO o O) stays right, since rowsum(P o dP) = rowsum(dO o
// O) when O = (P o Z) V. Both forms take it.
// A per-key additive bias (ToMe's proportional attention, key_bias.cuh; a
// template flag, so the forms without it are unchanged): P = exp(S scale +
// bias[key] - lse) with the forward's lse, which includes the bias; dS keeps
// its formula and the bias gets no gradient (it is the log of a count).
// These forms compile in flash_attn_bwd_bias.cu, which includes this file
// with DMC_FLASH_BIAS_FORMS defined.
// Float32 form read by chip_smoke.py on an H100 80GB HBM3 at 700 W: 0.85 ms
// a call at BH 512, L 256, d 64 (fused; 1.02 ms with the two-kernel form
// forced), 4.9 ms for the 11 calls of a UNet train step against a bound of
// 1.7 ms.
//
// bfloat16 (the models' mixed precision), kernels of their own on the
// tensor cores. They replace the same _bwd_kernel (flash_attention.py:126)
// under the casts of the bf16 policy: the JAX kernel upcasts bf16 q, k, v,
// o and dO to float32, computes every product in float32 and returns dq, dk,
// dv in their types.
// What bounds it on an H100: the bytes, in principle. At the DiT's train
// step (BH 768, L 256, d 64) q, k, v, o, dO, dq, dk, dv in bf16 take 0.060
// ms a call at 3.35 TB/s; the products at the tensor cores' 989 TFLOP/s
// 0.052 ms with the split below, which makes the five products eight (1.6x
// the work). In practice the instructions issued per score bound it (an
// exponential alone moved it by a fifth). What the design does
// (bf16_mma.cuh has the fragment layouts):
// * mma.sync m16n8k16, bf16 operands, float32 accumulators. q, k, v and dO
//   are exact operands: S^T = K Q^T and dP^T = V dO^T come out float32, keys
//   along the rows (K and V fragments by ldmatrix, Q and dO by ldmatrix as
//   the col-major B operand).
// * P o Z and dS are float32 and no bf16 value: each is split into hi =
//   bf16(x) and lo = bf16(x - hi), taken as A fragments straight from the
//   accumulators, and dV += (P o Z)^T dO and dK += dS^T Q are two products
//   each against one fragment of dO or Q, read by ldmatrix.trans.
// * The dQ share dS K_j needs dS query-major: its hi and lo are stored to
//   shared memory as bf16 (BT, BQ + 8) and read back by ldmatrix.trans,
//   against K by ldmatrix.trans. With one key tile that is dq; with more,
//   the float32 shares go to the scratch and `flash_bwd_dq_sum_kernel` sums
//   them in tile order, no atomics, equal bit for bit from run to run. (A
//   sum across a cluster of the head's key-tile blocks through distributed
//   shared memory was measured and lost: its barrier a query tile kept the
//   blocks in step.)
// * Per score: P is one FMA and one ex2.approx, from lse turned to base 2
//   once a tile (+inf past L, so no select); dS's scale multiplies dK and
//   the dQ share once, at their stores; dropout draws each Philox call once
//   a warp (`dropout_keep_bits_cols`: 16 keys x 8 queries a tile are 32
//   calls, one a lane, and four shuffles a query tile).
// * One block of four warps (16 keys each) per (head, key tile of 64) walks
//   query tiles of 64 (32 at d > 64, where dK and dV take twice the
//   registers), three blocks an SM at d <= 64; one warp per 16 keys and 16
//   queries for L <= 16. Q, dO, lse and delta are double-buffered by
//   cp.async; the tiles are bf16 with rows padded by 16 bytes.
// * The two-kernel form (L > 256): the same key-tile kernel without dQ, and
//   a dQ kernel of four warps (16 query rows each) walking key tiles of 64
//   (32 at d > 64): S and dP query-major from Q and dO fragments held in
//   registers, dS split from the accumulators against K by ldmatrix.trans.
// bf16 takes d % 16 == 0 (the mma's depth; the wrapper pads) up to 128, past
// it the wide forms.
// Queries and keys of their own lengths (E6, flash_attn.cu): q, o, dO and dq
// of Lq rows, k, v, dk and dv of Lk; the key-tile blocks walk Lq's query
// tiles, the dq blocks Lk's key tiles, the fused form's dq shares are one a
// key tile (`bwd_fused` reads Lk), and `row0` keys the dropout rows.
// bf16 measured on an H100 80GB HBM3 at 700 W (tools/profile_torch_kernels.py
// --only bf16, from a CUDA graph): 0.384 ms a call at the DiT's train step
// (BH 768, L 256, d 64, p 0.1; 4.61 ms for its 12 calls) against a bound of
// 0.060 ms (bytes); 1.36 ms for the 11 calls of a UNet train step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

#include "bf16_mma.cuh"
#include "key_bias.cuh"
#include "philox.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr int kDeltaThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Tile geometry for a head dimension padded to DMAX and tiles of BT rows.
template <int DMAX, int BT>
struct Cfg {
  static constexpr int TX = BT / 4;       // threads along keys / columns
  static constexpr int NT = TX * TX;      // threads of a block
  static constexpr int P = DMAX + 4;      // row stride of Q, dO, K, V tiles
  static constexpr int SP = BT + 4;       // row stride of the P and dS tiles
  static constexpr int DC = DMAX / TX;    // columns of d a thread owns
  static constexpr int VW = DC >= 4 ? 4 : DC;  // floats per vector access
  static constexpr int G = DC / VW;       // vector groups per thread
  static constexpr int TILE = BT * P;     // floats of one Q, dO, K or V tile
  static constexpr int STILE = BT * SP;   // floats of the P or dS tile
  // K, V, Q, dO, P, dS and the rows' lse and delta; the dQ kernel: two K
  // tiles, V, Q, dO, dS and the same
  static constexpr size_t SMEM_DKDV =
      sizeof(float) * (4 * (size_t)TILE + 2 * (size_t)STILE + 2 * BT);
  static constexpr size_t SMEM_DQ =
      sizeof(float) * (5 * (size_t)TILE + (size_t)STILE + 2 * BT);
  static_assert(DC % VW == 0 && (VW == 2 || VW == 4), "column ownership");
};

template <typename T>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ o,
                                       const T* __restrict__ dout,
                                       float* __restrict__ delta, int rows, int d) {
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const T* orow = o + (size_t)row * d;
  const T* drow = dout + (size_t)row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32)
    s = fmaf(to_float(orow[c]), to_float(drow[c]), s);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

// four floats rounded to bf16 (nearest even) in one 8-byte store
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                 *reinterpret_cast<const unsigned*>(&hi));
}

// dq = the sum over the key tiles, in tile order, of their float32 shares in
// `partial` (bh, tiles, L * d); four floats a thread.
template <typename T>
__global__ void flash_bwd_dq_sum_kernel(const float4* __restrict__ partial,
                                        T* __restrict__ dq, size_t head4,
                                        int tiles, size_t total4) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total4) return;
  const size_t bh = i / head4;
  const size_t e = i - bh * head4;
  const float4* p = partial + bh * tiles * head4 + e;
  float4 acc = p[0];
  for (int t = 1; t < tiles; ++t) {
    const float4 v = p[(size_t)t * head4];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  store4(dq + 4 * i, acc);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Request rows r0 .. r0 + BT - 1 of a matrix with rows ld apart into a
// (BT, DMAX + 4) tile by cp.async, zero past L and past column ncols (ncols
// % 4 == 0).
template <int DMAX, int BT>
__device__ __forceinline__ void request_tile_cols(float* dst,
                                                  const float* __restrict__ src,
                                                  int r0, int L, int ld,
                                                  int ncols, int tid) {
  using C = Cfg<DMAX, BT>;
  constexpr int V = DMAX / 4;  // pieces of a row
  for (int i = tid; i < BT * V; i += C::NT) {
    const int r = i / V;
    const int c = (i - r * V) * 4;
    const bool ok = r0 + r < L && c < ncols;
    cp_async16(dst + r * C::P + c, ok ? src + (size_t)(r0 + r) * ld + c : src,
               ok);
  }
}

// The same for one head's (L, d) matrix (d % 4 == 0).
template <int DMAX, int BT>
__device__ __forceinline__ void request_tile(float* dst,
                                             const float* __restrict__ src,
                                             int r0, int L, int d, int tid) {
  request_tile_cols<DMAX, BT>(dst, src, r0, L, d, d, tid);
}

// lse and delta of query rows q0 .. q0 + BT - 1; rows past L get lse = +inf,
// so their probabilities, and with them their share of dK and dV, are 0
template <int BT>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* dl_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               size_t base, int q0, int L, int tid) {
  if (tid < BT) {
    const int row = q0 + tid;
    lse_s[tid] = row < L ? lse[base + row] : INFINITY;
    dl_s[tid] = row < L ? delta[base + row] : 0.f;
  }
}

template <int VW>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (VW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(float* dst, const float* src) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  }
}

// out[a][b] = As[row ty + TX a] . Bs[row tx + TX b] over the DMAX columns of
// two (BT, DMAX + 4) tiles, four columns to a shared load
template <int DMAX, int BT>
__device__ __forceinline__ void rows_dot(const float* As, const float* Bs, int ty,
                                         int tx, float out[4][4]) {
  using C = Cfg<DMAX, BT>;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) out[a][b] = 0.f;
  const float* ap = As + ty * C::P;
  const float* bp = Bs + tx * C::P;
#pragma unroll 2
  for (int c = 0; c < DMAX; c += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      av[a] = *reinterpret_cast<const float4*>(ap + a * C::TX * C::P + c);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      bv[b] = *reinterpret_cast<const float4*>(bp + b * C::TX * C::P + c);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float s = out[a][b];
        s = fmaf(av[a].x, bv[b].x, s);
        s = fmaf(av[a].y, bv[b].y, s);
        s = fmaf(av[a].z, bv[b].z, s);
        s = fmaf(av[a].w, bv[b].w, s);
        out[a][b] = s;
      }
  }
}

// From S = Q K^T and dP = dO V^T of a tile (query rows from q0, keys from k0
// of head bh; rows ty + TX a, keys tx + TX b): P (stored when Ps is given;
// P o Z with DROPOUT) and dS into their (BT, BT + 4) tiles
template <int DMAX, int BT, bool DROPOUT, bool BIAS>
__device__ __forceinline__ void probs_from(const float (&s)[4][4],
                                           const float (&dpv)[4][4],
                                           const float* lse_s, const float* dl_s,
                                           float* Ps, float* dSs, int ty, int tx,
                                           float scale, const DropoutParams& dp,
                                           const float* brow, int Lk, int bh,
                                           int q0, int k0) {
  using C = Cfg<DMAX, BT>;
  float kbias[4] = {};  // the keys' bias (0 past Lk, where K = V = 0)
  if constexpr (BIAS) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      kbias[b] = key_bias_at(brow, k0 + tx + C::TX * b, Lk, 1.f);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + C::TX * a;
    const float lr = lse_s[r];
    const float dl = dl_s[r];
    uint32_t keep = 0;
    if constexpr (DROPOUT)
      keep = dropout_keep_bits<C::TX, 4>(dp, bh, q0 + r, k0, tx);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int col = tx + C::TX * b;
      const float p = expf(BIAS ? fmaf(s[a][b], scale, kbias[b]) - lr
                                : s[a][b] * scale - lr);
      float z = 1.f;
      if constexpr (DROPOUT) z = (keep >> b) & 1u ? dp.keep_scale : 0.f;
      if (Ps != nullptr) Ps[r * C::SP + col] = DROPOUT ? p * z : p;
      dSs[r * C::SP + col] =
          p * ((DROPOUT ? dpv[a][b] * z : dpv[a][b]) - dl) * scale;
    }
  }
}

// S and dP of the current tiles, then `probs_from`
template <int DMAX, int BT, bool DROPOUT, bool BIAS>
__device__ __forceinline__ void probs_tile(const float* Qs, const float* dOs,
                                           const float* Ks, const float* Vs,
                                           const float* lse_s, const float* dl_s,
                                           float* Ps, float* dSs, int ty, int tx,
                                           float scale, const DropoutParams& dp,
                                           const float* brow, int Lk, int bh,
                                           int q0, int k0) {
  float s[4][4], dpv[4][4];
  rows_dot<DMAX, BT>(Qs, Ks, ty, tx, s);
  rows_dot<DMAX, BT>(dOs, Vs, ty, tx, dpv);
  probs_from<DMAX, BT, DROPOUT, BIAS>(s, dpv, lse_s, dl_s, Ps, dSs, ty, tx,
                                      scale, dp, brow, Lk, bh, q0, k0);
}

// dV_j += sum_r P[r, j] dO[r, :],  dK_j += sum_r dS[r, j] Q[r, :] over the
// tile's rows: keys 4 ty .. + 3, the thread's columns
template <int DMAX, int BT>
__device__ __forceinline__ void dkdv_tile(const float* Ps, const float* dSs,
                                          const float* Qs, const float* dOs,
                                          int ty, int tx,
                                          float (&dk_acc)[4][Cfg<DMAX, BT>::DC],
                                          float (&dv_acc)[4][Cfg<DMAX,
                                                                 BT>::DC]) {
  using C = Cfg<DMAX, BT>;
#pragma unroll 2
  for (int r = 0; r < BT; ++r) {
    float pv[4], dsv[4], dov[C::DC], qv[C::DC];
    load_vec<4>(pv, Ps + r * C::SP + 4 * ty);
    load_vec<4>(dsv, dSs + r * C::SP + 4 * ty);
#pragma unroll
    for (int g = 0; g < C::G; ++g) {
      const int c = C::VW * (tx + C::TX * g);
      load_vec<C::VW>(dov + g * C::VW, dOs + r * C::P + c);
      load_vec<C::VW>(qv + g * C::VW, Qs + r * C::P + c);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < C::DC; ++b) {
        dv_acc[a][b] = fmaf(pv[a], dov[b], dv_acc[a][b]);
        dk_acc[a][b] = fmaf(dsv[a], qv[b], dk_acc[a][b]);
      }
  }
}

// acc[a][.] += sum_j dS[row ty + TX a][j] K[j][the thread's columns]
template <int DMAX, int BT>
__device__ __forceinline__ void dq_product(const float* dSs, const float* Ks,
                                           int ty, int tx,
                                           float acc[4][Cfg<DMAX, BT>::DC]) {
  using C = Cfg<DMAX, BT>;
#pragma unroll 2
  for (int j = 0; j < BT; j += 4) {
    float dsv[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      load_vec<4>(dsv[a], dSs + (ty + C::TX * a) * C::SP + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float kv[C::DC];
#pragma unroll
      for (int g = 0; g < C::G; ++g)
        load_vec<C::VW>(kv + g * C::VW,
                        Ks + (j + jj) * C::P + C::VW * (tx + C::TX * g));
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < C::DC; ++b)
          acc[a][b] = fmaf(dsv[a][jj], kv[b], acc[a][b]);
    }
  }
}

// rows r0 + ty + TX a (< L) of `acc` into a matrix with rows ld apart at the
// thread's columns below ncols
template <int DMAX, int BT>
__device__ __forceinline__ void store_rows_cols(
    float* __restrict__ dst, const float acc[4][Cfg<DMAX, BT>::DC], int r0,
    int L, int ld, int ncols, int ty, int tx) {
  using C = Cfg<DMAX, BT>;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = r0 + ty + C::TX * a;
    if (row < L) {
#pragma unroll
      for (int g = 0; g < C::G; ++g) {
        const int c = C::VW * (tx + C::TX * g);
        if (c < ncols)
          store_vec<C::VW>(dst + (size_t)row * ld + c, acc[a] + g * C::VW);
      }
    }
  }
}

// the same into a head's (L, d) matrix
template <int DMAX, int BT>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float acc[4][Cfg<DMAX, BT>::DC],
                                           int r0, int L, int d, int ty, int tx) {
  store_rows_cols<DMAX, BT>(dst, acc, r0, L, d, d, ty, tx);
}

// keys k0 + 4 ty + a (< Lk) of dK and dV into matrices with rows ld apart at
// the thread's columns below ncols
template <int DMAX, int BT>
__device__ __forceinline__ void store_key_rows(
    float* __restrict__ dk, float* __restrict__ dv,
    const float (&dk_acc)[4][Cfg<DMAX, BT>::DC],
    const float (&dv_acc)[4][Cfg<DMAX, BT>::DC], int k0, int Lk, int ld,
    int ncols, int ty, int tx) {
  using C = Cfg<DMAX, BT>;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = k0 + 4 * ty + a;
    if (row < Lk) {
#pragma unroll
      for (int g = 0; g < C::G; ++g) {
        const int c = C::VW * (tx + C::TX * g);
        if (c < ncols) {
          store_vec<C::VW>(dk + (size_t)row * ld + c, dk_acc[a] + g * C::VW);
          store_vec<C::VW>(dv + (size_t)row * ld + c, dv_acc[a] + g * C::VW);
        }
      }
    }
  }
}

// One block per (head, key tile): dK_j, dV_j and, when WITH_DQ, this key
// tile's share of every dQ_i, into dq_out (the head's rows at
// (bh * gridDim.y + tile) * L * d: the shares, or dq itself when there is one
// key tile).
template <int DMAX, int BT, bool WITH_DQ, bool DROPOUT, bool BIAS>
__global__ void __launch_bounds__(Cfg<DMAX, BT>::NT,
                                  (DMAX <= 64 && BT == 64) ? 2 : 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dq_out, float* __restrict__ dk,
                      float* __restrict__ dv, int Lq, int Lk, int d,
                      float scale, DropoutParams dp, KeyBias kb) {
  using C = Cfg<DMAX, BT>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + C::TILE;
  float* Qs = Vs + C::TILE;
  float* dOs = Qs + C::TILE;
  float* Ps = dOs + C::TILE;
  float* dSs = Ps + C::STILE;
  float* lse_s = dSs + C::STILE;
  float* dl_s = lse_s + BT;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int tx = tid % C::TX;
  const int ty = tid / C::TX;
  const size_t head = (size_t)bh * Lq * d;    // q, dO, dq
  const size_t khead = (size_t)bh * Lk * d;   // k, v, dk, dv
  const size_t base = (size_t)bh * Lq;
  const float* brow = BIAS ? key_bias_row(kb, bh, Lk) : nullptr;

  request_tile<DMAX, BT>(Ks, k + khead, k0, Lk, d, tid);
  request_tile<DMAX, BT>(Vs, v + khead, k0, Lk, d, tid);
  request_tile<DMAX, BT>(Qs, q + head, 0, Lq, d, tid);
  request_tile<DMAX, BT>(dOs, dout + head, 0, Lq, d, tid);
  load_row_stats<BT>(lse_s, dl_s, lse, delta, base, 0, Lq, tid);

  // keys k0 + 4 ty .. + 3, columns VW (tx + TX g) .. + VW - 1
  float dk_acc[4][C::DC], dv_acc[4][C::DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < C::DC; ++b) {
      dk_acc[a][b] = 0.f;
      dv_acc[a][b] = 0.f;
    }
  float* dq_head = nullptr;
  if constexpr (WITH_DQ)
    dq_head = dq_out + ((size_t)bh * gridDim.y + blockIdx.y) * Lq * d;

  for (int q0 = 0; q0 < Lq; q0 += BT) {
    cp_async_wait_all();
    __syncthreads();  // the tiles and row stats are in; dSs is read

    probs_tile<DMAX, BT, DROPOUT, BIAS>(Qs, dOs, Ks, Vs, lse_s, dl_s, Ps, dSs,
                                        ty, tx, scale, dp, brow, Lk, bh, q0, k0);
    __syncthreads();

    dkdv_tile<DMAX, BT>(Ps, dSs, Qs, dOs, ty, tx, dk_acc, dv_acc);
    __syncthreads();  // Qs, dOs and the row stats are read

    if (q0 + BT < Lq) {  // the next tiles fly during the dQ product
      request_tile<DMAX, BT>(Qs, q + head, q0 + BT, Lq, d, tid);
      request_tile<DMAX, BT>(dOs, dout + head, q0 + BT, Lq, d, tid);
      load_row_stats<BT>(lse_s, dl_s, lse, delta, base, q0 + BT, Lq, tid);
    }
    if constexpr (WITH_DQ) {
      float acc[4][C::DC];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < C::DC; ++b) acc[a][b] = 0.f;
      dq_product<DMAX, BT>(dSs, Ks, ty, tx, acc);
      store_rows<DMAX, BT>(dq_head, acc, q0, Lq, d, ty, tx);
    }
  }

  store_key_rows<DMAX, BT>(dk + khead, dv + khead, dk_acc, dv_acc, k0, Lk, d,
                           d, ty, tx);
}

// The two-kernel form's dQ: one block per (head, query tile) walks the key
// tiles, recomputes dS and keeps dQ_i in registers.
template <int DMAX, int BT, bool DROPOUT, bool BIAS>
__global__ void __launch_bounds__(Cfg<DMAX, BT>::NT,
                                  (DMAX <= 64 && BT == 64) ? 2 : 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int Lq, int Lk, int d,
                    float scale, DropoutParams dp, KeyBias kb) {
  using C = Cfg<DMAX, BT>;
  extern __shared__ __align__(16) float smem[];
  float* Kbuf = smem;  // two K tiles
  float* Vs = Kbuf + 2 * C::TILE;
  float* Qs = Vs + C::TILE;
  float* dOs = Qs + C::TILE;
  float* dSs = dOs + C::TILE;
  float* lse_s = dSs + C::STILE;
  float* dl_s = lse_s + BT;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int tx = tid % C::TX;
  const int ty = tid / C::TX;
  const size_t head = (size_t)bh * Lq * d;
  const size_t khead = (size_t)bh * Lk * d;
  const float* brow = BIAS ? key_bias_row(kb, bh, Lk) : nullptr;

  request_tile<DMAX, BT>(Qs, q + head, q0, Lq, d, tid);
  request_tile<DMAX, BT>(dOs, dout + head, q0, Lq, d, tid);
  request_tile<DMAX, BT>(Kbuf, k + khead, 0, Lk, d, tid);
  request_tile<DMAX, BT>(Vs, v + khead, 0, Lk, d, tid);
  load_row_stats<BT>(lse_s, dl_s, lse, delta, (size_t)bh * Lq, q0, Lq, tid);

  // query rows q0 + ty + TX a, columns VW (tx + TX g) .. + VW - 1
  float acc[4][C::DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < C::DC; ++b) acc[a][b] = 0.f;

  int cur = 0;
  for (int k0 = 0; k0 < Lk; k0 += BT, cur ^= 1) {
    const float* Ks = Kbuf + cur * C::TILE;
    cp_async_wait_all();
    __syncthreads();  // the tiles are in; dSs and the other K tile are read

    probs_tile<DMAX, BT, DROPOUT, BIAS>(Qs, dOs, Ks, Vs, lse_s, dl_s, nullptr,
                                        dSs, ty, tx, scale, dp, brow, Lk, bh,
                                        q0, k0);
    __syncthreads();  // Vs is read

    if (k0 + BT < Lk) {  // the next tiles fly during the dQ product
      request_tile<DMAX, BT>(Kbuf + (cur ^ 1) * C::TILE, k + khead, k0 + BT,
                             Lk, d, tid);
      request_tile<DMAX, BT>(Vs, v + khead, k0 + BT, Lk, d, tid);
    }
    dq_product<DMAX, BT>(dSs, Ks, ty, tx, acc);
  }
  store_rows<DMAX, BT>(dq + head, acc, q0, Lq, d, ty, tx);
}

// The opt-in to more than 48 KiB of dynamic shared memory holds per kernel
// and device: set it at the first launch on each device, not every launch.
template <typename Kernel>
int opt_in(Kernel kernel, std::atomic<bool>* done, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    done[dev].store(true, std::memory_order_release);
  }
  return 0;
}

// ------------------------------------------------------------ bf16 forms
// The bf16 form's geometry: a block of BT / 16 warps, 16 keys each, keeps
// K_j, V_j of BT keys and walks query tiles of BQ rows, at a head dimension
// padded to DMAX. Its dQ share: BQ / 16 groups of 16 query rows, each
// taken by WPR warps that split d's n8 tiles.
template <int DMAX, int BT, int BQ>
struct Bf16Cfg {
  static constexpr int NW = BT / 16;
  static constexpr int NT = 32 * NW;
  static constexpr int S = DMAX + 8;    // row stride of the K, V, Q, dO tiles
  static constexpr int SQ = BQ + 8;     // row stride of the dS tiles
  static constexpr int KD = DMAX / 16;  // k16 steps (16-column blocks) of d
  static constexpr int NB = BQ / 8;     // n8 tiles of the transposed scores
  static constexpr int ND = DMAX / 8;   // n8 tiles of dK, dV
  static constexpr int RG = BQ / 16;    // query groups of the dQ share
  static constexpr int WPR = NW / RG;   // warps a group
  static constexpr int NDW = ND / WPR;  // n8 tiles of d a warp's dQ share
  // K, V; two Q and two dO tiles; dS as hi and lo (BT, BQ + 8); two tiles'
  // lse and delta
  static constexpr size_t SMEM =
      sizeof(bf16) * ((size_t)(2 * BT + 4 * BQ) * S + 2 * (size_t)BT * SQ) +
      sizeof(float) * 4 * BQ;
  static_assert(NW % RG == 0 && NDW % 2 == 0 && NB <= 8, "tile shape");
};

// lse and delta of query rows q0 .. q0 + BQ - 1 by cp.async (rows past L:
// zeros); a thread requests rows tid, tid + NT, ..., and `base2_row_stats`
// turns the same rows' lse to base 2 once they are in
template <int BQ, int NT>
__device__ __forceinline__ void request_row_stats(float* lse_s, float* dl_s,
                                                  const float* __restrict__ lse,
                                                  const float* __restrict__ delta,
                                                  size_t base, int q0, int L,
                                                  int tid) {
  for (int i = tid; i < BQ; i += NT) {
    const bool ok = q0 + i < L;
    cp_async4_zfill(lse_s + i, ok ? lse + base + q0 + i : lse, ok);
    cp_async4_zfill(dl_s + i, ok ? delta + base + q0 + i : delta, ok);
  }
}

// lse log2(e) for the rows < L and +inf past L, so that P = 2^(S scale
// log2(e) - lse log2(e)) is one FMA and one ex2.approx, and 0 past L
template <int BQ, int NT>
__device__ __forceinline__ void base2_row_stats(float* lse_s, int q0, int L,
                                                int tid) {
  for (int i = tid; i < BQ; i += NT)
    lse_s[i] = q0 + i < L ? kLog2e * lse_s[i] : INFINITY;
}

// rows r0 + g and r0 + g + 8 (lane = 4 g + t; those < L) of a float32
// accumulator set `acc` (n8 tiles n0 ..), times `scale`, into a head's (L, d)
// matrix: float32 (the dq shares) or rounded to bf16 (nearest even)
__device__ __forceinline__ void store_pair(float* dst, float x0, float x1) {
  *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
}

__device__ __forceinline__ void store_pair(bf16* dst, float x0, float x1) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(x0, x1);
}

template <typename T, int N>
__device__ __forceinline__ void store_acc_cols(T* __restrict__ dst,
                                               const float (&acc)[N][4],
                                               float scale, int r0, int n0,
                                               int L, int ld, int ncols,
                                               int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + (lane >> 2) + 8 * r;
    if (row >= L) continue;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int c = 8 * (n0 + n) + 2 * (lane & 3);
      if (c < ncols)
        store_pair(dst + (size_t)row * ld + c, scale * acc[n][2 * r],
                   scale * acc[n][2 * r + 1]);
    }
  }
}

// the same into a head's (L, d) matrix
template <typename T, int N>
__device__ __forceinline__ void store_acc(T* __restrict__ dst,
                                          const float (&acc)[N][4], float scale,
                                          int r0, int n0, int L, int d,
                                          int lane) {
  store_acc_cols(dst, acc, scale, r0, n0, L, d, d, lane);
}

// From S^T and dP^T of a warp's 16 keys against a query tile (keys along the
// rows; queries 8 j + 2 t and + 1 of n8 tile j): P^T o Z into st and dS^T /
// scale into dpt, in float32 (a query past L has lse +inf, so P = 0). lse_s
// holds the tile's lse in base 2, dl_s its delta; kbias the lane's two keys'
// bias in base 2.
template <int NB, bool DROPOUT, bool BIAS>
__device__ __forceinline__ void bf16_probs_t(float (&st)[NB][4],
                                             float (&dpt)[NB][4],
                                             const float* lse_s,
                                             const float* dl_s,
                                             const float (&kbias)[2],
                                             uint32_t keep, int t,
                                             float scale_log2,
                                             const DropoutParams& dp) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    // the lse and delta of queries 8 j + 2 t, + 1
    const float2 lq = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
    const float2 dq2 = *reinterpret_cast<const float2*>(dl_s + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lqe = (e & 1) ? lq.y : lq.x;
      const float p = ex2_approx(fmaf(
          st[j][e], scale_log2, BIAS ? kbias[e >> 1] - lqe : -lqe));
      float z = 1.f;
      if constexpr (DROPOUT)
        z = (keep >> (4 * j + e)) & 1u ? dp.keep_scale : 0.f;
      dpt[j][e] = p * ((DROPOUT ? dpt[j][e] * z : dpt[j][e]) -
                       ((e & 1) ? dq2.y : dq2.x));
      st[j][e] = DROPOUT ? p * z : p;
    }
  }
}

// dV += (P o Z)^T dO, dK += dS^T Q over a query tile for a warp's 16 keys kw
// ..: both A operands from the registers (st, dpt), split in hi + lo; dO and
// Q by ldmatrix.trans, `steps` k16 steps of their columns. With WITH_DQ dS^T
// goes to shared memory too (dSh, dSl), for the dQ share.
template <typename C, bool WITH_DQ>
__device__ __forceinline__ void bf16_dkdv_tile(
    const float (&st)[C::NB][4], const float (&dpt)[C::NB][4],
    const bf16* Qs, const bf16* dOs, bf16* dSh, bf16* dSl,
    float (&dk_acc)[C::ND][4], float (&dv_acc)[C::ND][4], int kw, int q0,
    int Lq, int steps, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int off_a = lane_off_a(lane, C::S);
#pragma unroll
  for (int c = 0; c < C::NB / 2; ++c) {
    uint32_t ph[4], pl[4], sh[4], sl[4];
    split_a(st[2 * c], st[2 * c + 1], ph, pl);
    split_a(dpt[2 * c], dpt[2 * c + 1], sh, sl);
    if constexpr (WITH_DQ) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // a fragment's (row, column) block
        const int at = (kw + g + 8 * (r & 1)) * C::SQ + 16 * c +
                       8 * (r >> 1) + 2 * t;
        *reinterpret_cast<uint32_t*>(dSh + at) = sh[r];
        *reinterpret_cast<uint32_t*>(dSl + at) = sl[r];
      }
    }
    if (q0 + 16 * c >= Lq) continue;  // queries past Lq: P and dS are 0
#pragma unroll
    for (int np = 0; np < C::KD; ++np) {
      if (np < steps) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, dOs + 16 * c * C::S + 16 * np + off_a);
        mma_bf16_split(dv_acc[2 * np], ph, pl, b[0], b[1]);
        mma_bf16_split(dv_acc[2 * np + 1], ph, pl, b[2], b[3]);
        ldmatrix_x4_trans(b, Qs + 16 * c * C::S + 16 * np + off_a);
        mma_bf16_split(dk_acc[2 * np], sh, sl, b[0], b[1]);
        mma_bf16_split(dk_acc[2 * np + 1], sh, sl, b[2], b[3]);
      }
    }
  }
}

// A warp's part of the dQ share dS K_j of a query tile (dS^T whole in dSh,
// dSl): dS query-major by ldmatrix.trans of dS^T, K by ldmatrix.trans, `steps`
// k16 steps of K's columns; query rows q0 + 16 rg .., d's n8 tiles part *
// NDW .., stored times `scale` at the columns below ncols of rows ld apart
// from `dst`.
template <typename C, typename DQ>
__device__ __forceinline__ void bf16_dq_share(const bf16* dSh, const bf16* dSl,
                                              const bf16* Ks, DQ* dst,
                                              float scale, int k0, int Lk,
                                              int q0, int Lq, int ld,
                                              int ncols, int steps, int warp,
                                              int lane) {
  const int rg = warp % C::RG, part = warp / C::RG;
  const int off_sq = lane_off_b(lane, C::SQ);
  const int off_a = lane_off_a(lane, C::S);
  float acc[C::NDW][4];
#pragma unroll
  for (int n = 0; n < C::NDW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < C::NW; ++kc) {
    if (k0 + 16 * kc >= Lk) break;  // keys past Lk: no dS was written
    uint32_t ah[4], al[4];
    ldmatrix_x4_trans(ah, dSh + 16 * kc * C::SQ + 16 * rg + off_sq);
    ldmatrix_x4_trans(al, dSl + 16 * kc * C::SQ + 16 * rg + off_sq);
#pragma unroll
    for (int np = 0; np < C::NDW / 2; ++np) {
      const int n16 = part * (C::NDW / 2) + np;  // d's 16-column block
      if (n16 < steps) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Ks + 16 * kc * C::S + 16 * n16 + off_a);
        mma_bf16_split(acc[2 * np], ah, al, b[0], b[1]);
        mma_bf16_split(acc[2 * np + 1], ah, al, b[2], b[3]);
      }
    }
  }
  store_acc_cols(dst, acc, scale, q0 + 16 * rg, part * C::NDW, Lq, ld, ncols,
                 lane);
}

// One block per (head, key tile of BT keys), each warp 16 keys: dK_j and dV_j
// in registers from S^T = K Q^T and dP^T = V dO^T (exact bf16 operands), and
// when WITH_DQ this key tile's share of every dQ_i = dS K_j into dq_out (the
// head's rows at (bh * gridDim.y + tile) * L * d: float32 shares, or dq
// itself, bf16, when there is one key tile; DQ is its element type).
// At BT 64, d <= 64 three blocks share an SM (at most 170 registers; 74.75 KB
// of shared memory each): the dropout form needs 183 unbounded, and two
// blocks an SM leave it waiting on its own instructions.
template <typename DQ, int DMAX, int BT, int BQ, bool WITH_DQ, bool DROPOUT,
          bool BIAS>
__global__ void __launch_bounds__(2 * BT, BT == 64 && DMAX <= 64 ? 3 : 1)
flash_bwd_bf16_kv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         DQ* __restrict__ dq_out, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int Lq, int Lk, int d,
                         float scale, DropoutParams dp, KeyBias kb) {
  using C = Bf16Cfg<DMAX, BT, BQ>;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_bf16);
  bf16* Vs = Ks + BT * C::S;
  bf16* Qb = Vs + BT * C::S;      // Q tiles: buffer (tile index & 1)
  bf16* dOb = Qb + 2 * BQ * C::S;
  bf16* dSh = dOb + 2 * BQ * C::S;  // dS^T as hi + lo, (BT, BQ + 8)
  bf16* dSl = dSh + BT * C::SQ;
  float* stats = reinterpret_cast<float*>(dSl + BT * C::SQ);  // lse, delta

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = 16 * warp;  // the warp's keys: k0 + kw + g, + 8
  const bool live = k0 + kw < Lk;
  // P = 2^(S scale log2(e) - lse log2(e)), one ex2.approx an entry
  const float scale_log2 = scale * kLog2e;
  // the bias of the lane's two keys, base 2: the same for every query tile
  float kbias[2] = {};
  if constexpr (BIAS) {
    const float* brow = key_bias_row(kb, bh, Lk);
    kbias[0] = key_bias_at(brow, k0 + kw + g, Lk, kLog2e);
    kbias[1] = key_bias_at(brow, k0 + kw + g + 8, Lk, kLog2e);
  }
  const int steps = d >> 4;
  const size_t head = (size_t)bh * Lq * d;    // q, dO, dq
  const size_t khead = (size_t)bh * Lk * d;   // k, v, dk, dv
  const size_t base = (size_t)bh * Lq;
  const int off_a = lane_off_a(lane, C::S);
  const int off_b = lane_off_b(lane, C::S);
  DQ* dq_head = nullptr;
  if constexpr (WITH_DQ)
    dq_head = dq_out + ((size_t)bh * gridDim.y + blockIdx.y) * Lq * d;

  request_bf16_rows<DMAX, BT, C::NT>(Ks, k + khead, k0, Lk, d, tid);
  request_bf16_rows<DMAX, BT, C::NT>(Vs, v + khead, k0, Lk, d, tid);
  request_bf16_rows<DMAX, BQ, C::NT>(Qb, q + head, 0, Lq, d, tid);
  request_bf16_rows<DMAX, BQ, C::NT>(dOb, dout + head, 0, Lq, d, tid);
  request_row_stats<BQ, C::NT>(stats, stats + 2 * BQ, lse, delta, base, 0, Lq,
                               tid);
  cp_async_commit_group();

  float dk_acc[C::ND][4], dv_acc[C::ND][4];
#pragma unroll
  for (int n = 0; n < C::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[n][e] = 0.f;
      dv_acc[n][e] = 0.f;
    }
  for (int q0 = 0, it = 0; q0 < Lq; q0 += BQ, ++it) {
    const int buf = it & 1;
    const bf16* Qs = Qb + buf * BQ * C::S;
    const bf16* dOs = dOb + buf * BQ * C::S;
    float* lse_s = stats + buf * BQ;
    const float* dl_s = stats + (2 + buf) * BQ;
    cp_async_wait_groups();
    base2_row_stats<BQ, C::NT>(lse_s, q0, Lq, tid);
    __syncthreads();  // this tile is in; every warp is past the last one
    if (q0 + BQ < Lq) {  // the next tile flies during this one's products
      const int nb = buf ^ 1;
      request_bf16_rows<DMAX, BQ, C::NT>(Qb + nb * BQ * C::S, q + head,
                                         q0 + BQ, Lq, d, tid);
      request_bf16_rows<DMAX, BQ, C::NT>(dOb + nb * BQ * C::S, dout + head,
                                         q0 + BQ, Lq, d, tid);
      request_row_stats<BQ, C::NT>(stats + nb * BQ, stats + (2 + nb) * BQ,
                                   lse, delta, base, q0 + BQ, Lq, tid);
      cp_async_commit_group();
    }
    if (live) {
      // the dropout's keep bits first: Philox's integer work does not wait
      // on the products
      uint32_t keep = 0;
      if constexpr (DROPOUT)
        keep = dropout_keep_bits_cols<C::NB>(dp, bh, k0 + kw, q0, lane);
      // S^T = K Q^T and dP^T = V dO^T, keys along the rows
      float st[C::NB][4], dpt[C::NB][4];
#pragma unroll
      for (int j = 0; j < C::NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[j][e] = 0.f;
          dpt[j][e] = 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < C::KD; ++kk) {
        if (kk < steps) {
          uint32_t ak[4], av[4];
          ldmatrix_x4(ak, Ks + kw * C::S + 16 * kk + off_a);
          ldmatrix_x4(av, Vs + kw * C::S + 16 * kk + off_a);
#pragma unroll
          for (int jj = 0; jj < C::NB / 2; ++jj) {
            uint32_t b[4];
            ldmatrix_x4(b, Qs + 16 * jj * C::S + 16 * kk + off_b);
            mma_bf16(st[2 * jj], ak, b[0], b[1]);
            mma_bf16(st[2 * jj + 1], ak, b[2], b[3]);
            ldmatrix_x4(b, dOs + 16 * jj * C::S + 16 * kk + off_b);
            mma_bf16(dpt[2 * jj], av, b[0], b[1]);
            mma_bf16(dpt[2 * jj + 1], av, b[2], b[3]);
          }
        }
      }
      // P^T o Z into st and dS^T / scale into dpt (the scale multiplies dK
      // and the dQ share once, at their stores), then dV and dK
      bf16_probs_t<C::NB, DROPOUT, BIAS>(st, dpt, lse_s, dl_s, kbias, keep, t,
                                         scale_log2, dp);
      bf16_dkdv_tile<C, WITH_DQ>(st, dpt, Qs, dOs, dSh, dSl, dk_acc, dv_acc,
                                 kw, q0, Lq, steps, lane);
    }
    if constexpr (WITH_DQ) {
      __syncthreads();  // dS^T is whole
      bf16_dq_share<C>(dSh, dSl, Ks, dq_head, scale, k0, Lk, q0, Lq, d, d,
                       steps, warp, lane);
    }
  }
  if (live) {
    store_acc(dk + khead, dk_acc, scale, k0 + kw, 0, Lk, d, lane);
    store_acc(dv + khead, dv_acc, 1.f, k0 + kw, 0, Lk, d, lane);
  }
}

// The two-kernel form's dQ: one block of NW warps per (head, 16 NW query
// rows), each warp 16 rows, walks key tiles of BK keys; S and dP
// query-major from exact operands, dS from the registers, split in hi + lo,
// against K by ldmatrix.trans; dQ_i in registers.
template <int DMAX, int NW, int BK>
struct Bf16DqCfg {
  static constexpr int BQ = 16 * NW;
  static constexpr int NT = 32 * NW;
  static constexpr int S = DMAX + 8;
  static constexpr int KD = DMAX / 16;
  static constexpr int NB = BK / 8;
  static constexpr int ND = DMAX / 8;
  // Q, dO, two K tiles and two V tiles
  static constexpr size_t SMEM = sizeof(bf16) * (size_t)(2 * BQ + 4 * BK) * S;
  static_assert(BK % 16 == 0 && NB <= 8, "tile shape");
};

// From S and dP of a warp's 16 query rows against a key tile (queries along
// the rows; keys k0 + 8 j + 2 t and + 1 of n8 tile j): dS / scale into s, in
// float32. lr holds the rows' lse in base 2 (+inf past L), dl their delta. A
// key past Lk has K = V = 0: its dS meets a zero K row in the product.
template <int NB, bool DROPOUT, bool BIAS>
__device__ __forceinline__ void bf16_ds_rows(float (&s)[NB][4],
                                             const float (&dp_)[NB][4],
                                             const float (&lr)[2],
                                             const float (&dl)[2],
                                             const float* brow, int k0, int Lk,
                                             int t, uint32_t keep,
                                             float scale_log2,
                                             const DropoutParams& dp) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    // the bias of keys 8 j + 2 t and + 1, base 2
    float kbias[2] = {};
    if constexpr (BIAS) {
      kbias[0] = key_bias_at(brow, k0 + 8 * j + 2 * t, Lk, kLog2e);
      kbias[1] = key_bias_at(brow, k0 + 8 * j + 2 * t + 1, Lk, kLog2e);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2_approx(fmaf(
          s[j][e], scale_log2, BIAS ? kbias[e & 1] - lr[e >> 1] : -lr[e >> 1]));
      float z = 1.f;
      if constexpr (DROPOUT)
        z = (keep >> (4 * j + e)) & 1u ? dp.keep_scale : 0.f;
      s[j][e] = p * ((DROPOUT ? dp_[j][e] * z : dp_[j][e]) - dl[e >> 1]);
    }
  }
}

// dQ += dS K_j for a warp's 16 query rows: dS from the registers, split in
// hi + lo, against K by ldmatrix.trans, `steps` k16 steps of K's columns.
template <typename C>
__device__ __forceinline__ void bf16_dq_tile(const float (&s)[C::NB][4],
                                             const bf16* Ks,
                                             float (&acc)[C::ND][4], int k0,
                                             int Lk, int steps, int lane) {
  const int off_a = lane_off_a(lane, C::S);
#pragma unroll
  for (int c = 0; c < C::NB / 2; ++c) {
    if (k0 + 16 * c >= Lk) break;
    uint32_t hi[4], lo[4];
    split_a(s[2 * c], s[2 * c + 1], hi, lo);
#pragma unroll
    for (int np = 0; np < C::KD; ++np) {
      if (np < steps) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Ks + 16 * c * C::S + 16 * np + off_a);
        mma_bf16_split(acc[2 * np], hi, lo, b[0], b[1]);
        mma_bf16_split(acc[2 * np + 1], hi, lo, b[2], b[3]);
      }
    }
  }
}

template <int DMAX, int NW, int BK, bool DROPOUT, bool BIAS>
__global__ void __launch_bounds__(32 * NW)
flash_bwd_bf16_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dq,
                         int Lq, int Lk, int d, float scale, DropoutParams dp,
                         KeyBias kb) {
  using C = Bf16DqCfg<DMAX, NW, BK>;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_bf16);
  bf16* dOs = Qs + C::BQ * C::S;
  bf16* Kb = dOs + C::BQ * C::S;  // K tiles: buffer (tile index & 1)
  bf16* Vb = Kb + 2 * BK * C::S;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * C::BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = q0 + 16 * warp;  // the warp's rows: row0 + g, + 8
  const int steps = d >> 4;
  const size_t head = (size_t)bh * Lq * d;
  const bf16* kh = k + (size_t)bh * Lk * d;
  const bf16* vh = v + (size_t)bh * Lk * d;
  const float* brow = BIAS ? key_bias_row(kb, bh, Lk) : nullptr;
  const int t = lane & 3;  // the lane's keys in an n8 tile: 2 t, 2 t + 1
  const int off_a = lane_off_a(lane, C::S);
  const int off_b = lane_off_b(lane, C::S);

  request_bf16_rows<DMAX, C::BQ, C::NT>(Qs, q + head, q0, Lq, d, tid);
  request_bf16_rows<DMAX, C::BQ, C::NT>(dOs, dout + head, q0, Lq, d, tid);
  request_bf16_rows<DMAX, BK, C::NT>(Kb, kh, 0, Lk, d, tid);
  request_bf16_rows<DMAX, BK, C::NT>(Vb, vh, 0, Lk, d, tid);
  cp_async_commit_group();

  // the rows' lse in base 2 (rows past L: +inf, so P = 0) and delta
  const float scale_log2 = scale * kLog2e;
  float lr[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    lr[r] = row < Lq ? kLog2e * lse[(size_t)bh * Lq + row] : INFINITY;
    dl[r] = row < Lq ? delta[(size_t)bh * Lq + row] : 0.f;
  }
  uint32_t qf[C::KD][4], dof[C::KD][4];
  float acc[C::ND][4];
#pragma unroll
  for (int n = 0; n < C::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int k0 = 0, it = 0; k0 < Lk; k0 += BK, ++it) {
    const bf16* Ks = Kb + (it & 1) * BK * C::S;
    const bf16* Vs = Vb + (it & 1) * BK * C::S;
    cp_async_wait_groups();
    __syncthreads();  // this tile is in; every warp is past the last one
    if (k0 + BK < Lk) {  // the next tile flies during this one's products
      request_bf16_rows<DMAX, BK, C::NT>(Kb + ((it + 1) & 1) * BK * C::S, kh,
                                         k0 + BK, Lk, d, tid);
      request_bf16_rows<DMAX, BK, C::NT>(Vb + ((it + 1) & 1) * BK * C::S, vh,
                                         k0 + BK, Lk, d, tid);
      cp_async_commit_group();
    }
    if (row0 >= Lq) continue;  // no real row: only the barriers
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < C::KD; ++kk) {
        ldmatrix_x4(qf[kk], Qs + 16 * warp * C::S + 16 * kk + off_a);
        ldmatrix_x4(dof[kk], dOs + 16 * warp * C::S + 16 * kk + off_a);
      }
    }
    uint32_t keep = 0;  // first, as in the forward
    if constexpr (DROPOUT)
      keep = dropout_keep_bits_rows<C::NB>(dp, bh, row0, k0, lane);
    float s[C::NB][4], dp_[C::NB][4];
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp_[j][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk) {
      if (kk < steps) {
#pragma unroll
        for (int jj = 0; jj < C::NB / 2; ++jj) {
          uint32_t b[4];
          ldmatrix_x4(b, Ks + 16 * jj * C::S + 16 * kk + off_b);
          mma_bf16(s[2 * jj], qf[kk], b[0], b[1]);
          mma_bf16(s[2 * jj + 1], qf[kk], b[2], b[3]);
          ldmatrix_x4(b, Vs + 16 * jj * C::S + 16 * kk + off_b);
          mma_bf16(dp_[2 * jj], dof[kk], b[0], b[1]);
          mma_bf16(dp_[2 * jj + 1], dof[kk], b[2], b[3]);
        }
      }
    }
    bf16_ds_rows<C::NB, DROPOUT, BIAS>(s, dp_, lr, dl, brow, k0, Lk, t, keep,
                                       scale_log2, dp);
    bf16_dq_tile<C>(s, Ks, acc, k0, Lk, steps, lane);
  }
  if (row0 < Lq) store_acc(dq + head, acc, scale, row0, 0, Lq, d, lane);
}

template <typename T>
int launch_delta(const T* o, const T* dout, float* delta, int rows, int d,
                 cudaStream_t stream) {
  const int rows_per_block = kDeltaThreads / 32;
  flash_bwd_delta_kernel<T>
      <<<(rows + rows_per_block - 1) / rows_per_block, kDeltaThreads, 0,
         stream>>>(o, dout, delta, rows, d);
  return (int)cudaGetLastError();
}

// dq (bh, Lq, d) from the float32 shares of `tiles` key tiles in `partial`
template <typename T>
int launch_dq_sum(const float* partial, T* dq, int bh, int Lq, int d,
                  int tiles, cudaStream_t stream) {
  const size_t head4 = (size_t)Lq * d / 4;
  const size_t total4 = head4 * bh;
  flash_bwd_dq_sum_kernel<T><<<(unsigned)((total4 + 255) / 256), 256, 0,
                               stream>>>((const float4*)partial, dq, head4,
                                         tiles, total4);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ head dimensions past 128
// The wide forms (entries `flash_attn_bwd_wide`, `flash_attn_bwd_wide_bias`,
// compiled in flash_attn_bwd_wide.cu and flash_attn_bwd_wide_bias.cu so that
// the forms up to 128 stay as they were). Up to 256 the one-block forms
// below this section run; the chunked forms here take d past 256. Each
// block owns one block of
// kWideCols columns of d (blockIdx.z, c0 = 128 z) of its outputs: dK_j, dV_j
// and the dQ shares in the key-tile kernels, dQ_i in the dQ kernels. For
// each tile pair it sums S = Q K^T and dP = dO V^T over all of d, 128
// columns at a time through single Q, dO, K and V tiles, taking its own
// columns last, so that they stay in shared memory for the products that
// make its outputs: P and dS are computed in full by every column block (the
// dropout mask has no column in it), and only the products with Q, dO and K
// are split over the blocks. The geometry is that of the forms at DMAX 128:
// float32 tiles of 64 (256 threads, four by four a thread); bf16 key tiles
// of 64 (four warps) walking query tiles of 32, and the dQ kernel's four
// warps of 16 query rows walking key tiles of 32. Every chunk waits for its
// copies and Q, dO, K, V are read again for every tile pair.
// What bounds it on an H100: as the forms up to 128, plus the chunk loop's
// waits and the scores computed once for every column block.

// The opt-in to more than 48 KiB of dynamic shared memory, once per kernel
// and device.
template <auto Kernel>
int opt_in_once(size_t smem) {
  static std::atomic<bool> done[kMaxDevices];
  return opt_in(Kernel, done, smem);
}

// S = Q K^T and dP = dO V^T of one (query tile from q0, key tile from k0)
// pair of head bh's rows (q_head, k_head: the head's first rows), summed over
// all of d, 128 columns at a time through the four (64, 132) tiles; the
// column block `own` comes last, so its tiles stay in shared memory. Every
// thread of the block calls it.
__device__ __forceinline__ void wide_scores(
    float* Ks, float* Vs, float* Qs, float* dOs, const float* __restrict__ q,
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, int q0, int k0, int Lq, int Lk, int d,
    int own, int chunks, int ty, int tx, int tid, float (&s)[4][4],
    float (&dpv)[4][4]) {
  constexpr int BT = 64;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dpv[a][b] = 0.f;
  for (int j = 1; j <= chunks; ++j) {
    const int c = (own + j) % chunks * kWideCols;
    __syncthreads();  // every thread is past its reads of the tiles
    request_tile_cols<kWideCols, BT>(Ks, k + c, k0, Lk, d, d - c, tid);
    request_tile_cols<kWideCols, BT>(Vs, v + c, k0, Lk, d, d - c, tid);
    request_tile_cols<kWideCols, BT>(Qs, q + c, q0, Lq, d, d - c, tid);
    request_tile_cols<kWideCols, BT>(dOs, dout + c, q0, Lq, d, d - c, tid);
    cp_async_wait_all();
    __syncthreads();
    float ps[4][4], pd[4][4];
    rows_dot<kWideCols, BT>(Qs, Ks, ty, tx, ps);
    rows_dot<kWideCols, BT>(dOs, Vs, ty, tx, pd);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] += ps[a][b];
        dpv[a][b] += pd[a][b];
      }
  }
}

template <bool WITH_DQ, bool DROPOUT, bool BIAS>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkdv_wide_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq_out, float* __restrict__ dk,
                           float* __restrict__ dv, int Lq, int Lk, int d,
                           float scale, DropoutParams dp, KeyBias kb) {
  constexpr int BT = 64;
  using C = Cfg<kWideCols, BT>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + C::TILE;
  float* Qs = Vs + C::TILE;
  float* dOs = Qs + C::TILE;
  float* Ps = dOs + C::TILE;
  float* dSs = Ps + C::STILE;
  float* lse_s = dSs + C::STILE;
  float* dl_s = lse_s + BT;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BT;
  const int cb = blockIdx.z, chunks = gridDim.z;
  const int c0 = cb * kWideCols;  // the block's columns
  const int tid = threadIdx.x;
  const int tx = tid % C::TX;
  const int ty = tid / C::TX;
  const size_t head = (size_t)bh * Lq * d;    // q, dO, dq
  const size_t khead = (size_t)bh * Lk * d;   // k, v, dk, dv
  const size_t base = (size_t)bh * Lq;
  const float* brow = BIAS ? key_bias_row(kb, bh, Lk) : nullptr;

  float dk_acc[4][C::DC] = {}, dv_acc[4][C::DC] = {};
  float* dq_head = nullptr;
  if constexpr (WITH_DQ)
    dq_head = dq_out + ((size_t)bh * gridDim.y + blockIdx.y) * Lq * d;

  for (int q0 = 0; q0 < Lq; q0 += BT) {
    // the last tile's readers of the row stats are past a barrier
    load_row_stats<BT>(lse_s, dl_s, lse, delta, base, q0, Lq, tid);
    float s[4][4], dpv[4][4];
    wide_scores(Ks, Vs, Qs, dOs, q + head, k + khead, v + khead, dout + head,
                q0, k0, Lq, Lk, d, cb, chunks, ty, tx, tid, s, dpv);
    probs_from<kWideCols, BT, DROPOUT, BIAS>(s, dpv, lse_s, dl_s, Ps, dSs, ty,
                                             tx, scale, dp, brow, Lk, bh, q0,
                                             k0);
    __syncthreads();  // P and dS are whole
    dkdv_tile<kWideCols, BT>(Ps, dSs, Qs, dOs, ty, tx, dk_acc, dv_acc);
    if constexpr (WITH_DQ) {
      float acc[4][C::DC] = {};
      dq_product<kWideCols, BT>(dSs, Ks, ty, tx, acc);
      store_rows_cols<kWideCols, BT>(dq_head + c0, acc, q0, Lq, d, d - c0, ty,
                                     tx);
    }
  }
  store_key_rows<kWideCols, BT>(dk + khead + c0, dv + khead + c0, dk_acc,
                                dv_acc, k0, Lk, d, d - c0, ty, tx);
}

// The two-kernel form's dQ, wide: one block per (head, query tile, 128
// columns) walks the key tiles.
template <bool DROPOUT, bool BIAS>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dq_wide_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int Lq, int Lk, int d,
                         float scale, DropoutParams dp, KeyBias kb) {
  constexpr int BT = 64;
  using C = Cfg<kWideCols, BT>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + C::TILE;
  float* Qs = Vs + C::TILE;
  float* dOs = Qs + C::TILE;
  float* dSs = dOs + C::TILE;
  float* lse_s = dSs + C::STILE;
  float* dl_s = lse_s + BT;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BT;
  const int cb = blockIdx.z, chunks = gridDim.z;
  const int c0 = cb * kWideCols;
  const int tid = threadIdx.x;
  const int tx = tid % C::TX;
  const int ty = tid / C::TX;
  const size_t head = (size_t)bh * Lq * d;
  const size_t khead = (size_t)bh * Lk * d;
  const float* brow = BIAS ? key_bias_row(kb, bh, Lk) : nullptr;

  load_row_stats<BT>(lse_s, dl_s, lse, delta, (size_t)bh * Lq, q0, Lq, tid);
  float acc[4][C::DC] = {};
  for (int k0 = 0; k0 < Lk; k0 += BT) {
    float s[4][4], dpv[4][4];
    wide_scores(Ks, Vs, Qs, dOs, q + head, k + khead, v + khead, dout + head,
                q0, k0, Lq, Lk, d, cb, chunks, ty, tx, tid, s, dpv);
    probs_from<kWideCols, BT, DROPOUT, BIAS>(s, dpv, lse_s, dl_s, nullptr,
                                             dSs, ty, tx, scale, dp, brow, Lk,
                                             bh, q0, k0);
    __syncthreads();  // dS is whole
    dq_product<kWideCols, BT>(dSs, Ks, ty, tx, acc);
  }
  store_rows_cols<kWideCols, BT>(dq + head + c0, acc, q0, Lq, d, d - c0, ty,
                                 tx);
}

// bf16, wide: key tiles of 64 (four warps of 16 keys) walking query tiles of
// 32; dq_out as flash_bwd_bf16_kv_kernel's.
template <typename DQ, bool WITH_DQ, bool DROPOUT, bool BIAS>
__global__ void __launch_bounds__(128)
flash_bwd_bf16_kv_wide_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              DQ* __restrict__ dq_out, bf16* __restrict__ dk,
                              bf16* __restrict__ dv, int Lq, int Lk, int d,
                              float scale, DropoutParams dp, KeyBias kb) {
  constexpr int BT = 64, BQ = 32;
  using C = Bf16Cfg<kWideCols, BT, BQ>;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_bf16);
  bf16* Vs = Ks + BT * C::S;
  bf16* Qs = Vs + BT * C::S;
  bf16* dOs = Qs + BQ * C::S;
  bf16* dSh = dOs + BQ * C::S;  // dS^T as hi + lo, (BT, BQ + 8)
  bf16* dSl = dSh + BT * C::SQ;
  float* lse_s = reinterpret_cast<float*>(dSl + BT * C::SQ);
  float* dl_s = lse_s + BQ;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BT;
  const int cb = blockIdx.z, chunks = gridDim.z;
  const int c0 = cb * kWideCols;  // the block's columns
  const int own_steps = min(C::KD, (d - c0) >> 4);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = 16 * warp;  // the warp's keys: k0 + kw + g, + 8
  const bool live = k0 + kw < Lk;
  const float scale_log2 = scale * kLog2e;
  float kbias[2] = {};
  if constexpr (BIAS) {
    const float* brow = key_bias_row(kb, bh, Lk);
    kbias[0] = key_bias_at(brow, k0 + kw + g, Lk, kLog2e);
    kbias[1] = key_bias_at(brow, k0 + kw + g + 8, Lk, kLog2e);
  }
  const size_t head = (size_t)bh * Lq * d;    // q, dO, dq
  const size_t khead = (size_t)bh * Lk * d;   // k, v, dk, dv
  const size_t base = (size_t)bh * Lq;
  const int off_a = lane_off_a(lane, C::S);
  const int off_b = lane_off_b(lane, C::S);
  DQ* dq_head = nullptr;
  if constexpr (WITH_DQ)
    dq_head = dq_out + ((size_t)bh * gridDim.y + blockIdx.y) * Lq * d;

  float dk_acc[C::ND][4] = {}, dv_acc[C::ND][4] = {};
  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    float st[C::NB][4] = {}, dpt[C::NB][4] = {};
    for (int j = 1; j <= chunks; ++j) {
      const int c = (cb + j) % chunks * kWideCols;  // the block's own last
      const int steps = min(C::KD, (d - c) >> 4);
      __syncthreads();  // every warp is past its reads of the tiles
      request_bf16_cols<kWideCols, BT, C::NT>(Ks, k + khead + c, k0, Lk, d,
                                              d - c, tid);
      request_bf16_cols<kWideCols, BT, C::NT>(Vs, v + khead + c, k0, Lk, d,
                                              d - c, tid);
      request_bf16_cols<kWideCols, BQ, C::NT>(Qs, q + head + c, q0, Lq, d,
                                              d - c, tid);
      request_bf16_cols<kWideCols, BQ, C::NT>(dOs, dout + head + c, q0, Lq, d,
                                              d - c, tid);
      if (j == 1)
        request_row_stats<BQ, C::NT>(lse_s, dl_s, lse, delta, base, q0, Lq,
                                     tid);
      cp_async_commit_group();
      cp_async_wait_groups();
      if (j == 1) base2_row_stats<BQ, C::NT>(lse_s, q0, Lq, tid);
      __syncthreads();
      if (!live) continue;
      // S^T = K Q^T and dP^T = V dO^T over these columns, keys along the rows
#pragma unroll
      for (int kk = 0; kk < C::KD; ++kk) {
        if (kk < steps) {
          uint32_t ak[4], av[4];
          ldmatrix_x4(ak, Ks + kw * C::S + 16 * kk + off_a);
          ldmatrix_x4(av, Vs + kw * C::S + 16 * kk + off_a);
#pragma unroll
          for (int jj = 0; jj < C::NB / 2; ++jj) {
            uint32_t b[4];
            ldmatrix_x4(b, Qs + 16 * jj * C::S + 16 * kk + off_b);
            mma_bf16(st[2 * jj], ak, b[0], b[1]);
            mma_bf16(st[2 * jj + 1], ak, b[2], b[3]);
            ldmatrix_x4(b, dOs + 16 * jj * C::S + 16 * kk + off_b);
            mma_bf16(dpt[2 * jj], av, b[0], b[1]);
            mma_bf16(dpt[2 * jj + 1], av, b[2], b[3]);
          }
        }
      }
    }
    if (live) {
      uint32_t keep = 0;
      if constexpr (DROPOUT)
        keep = dropout_keep_bits_cols<C::NB>(dp, bh, k0 + kw, q0, lane);
      bf16_probs_t<C::NB, DROPOUT, BIAS>(st, dpt, lse_s, dl_s, kbias, keep, t,
                                         scale_log2, dp);
      bf16_dkdv_tile<C, WITH_DQ>(st, dpt, Qs, dOs, dSh, dSl, dk_acc, dv_acc,
                                 kw, q0, Lq, own_steps, lane);
    }
    if constexpr (WITH_DQ) {
      __syncthreads();  // dS^T is whole
      bf16_dq_share<C>(dSh, dSl, Ks, dq_head + c0, scale, k0, Lk, q0, Lq, d,
                       d - c0, own_steps, warp, lane);
    }
  }
  if (live) {
    store_acc_cols(dk + khead + c0, dk_acc, scale, k0 + kw, 0, Lk, d, d - c0,
                   lane);
    store_acc_cols(dv + khead + c0, dv_acc, 1.f, k0 + kw, 0, Lk, d, d - c0,
                   lane);
  }
}

// bf16, wide, the two-kernel form's dQ: four warps of 16 query rows walking
// key tiles of 32.
template <bool DROPOUT, bool BIAS>
__global__ void __launch_bounds__(128)
flash_bwd_bf16_dq_wide_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dq, int Lq, int Lk, int d,
                              float scale, DropoutParams dp, KeyBias kb) {
  constexpr int BK = 32;
  using C = Bf16DqCfg<kWideCols, 4, BK>;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_bf16);
  bf16* dOs = Qs + C::BQ * C::S;
  bf16* Ks = dOs + C::BQ * C::S;
  bf16* Vs = Ks + BK * C::S;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * C::BQ;
  const int cb = blockIdx.z, chunks = gridDim.z;
  const int c0 = cb * kWideCols;
  const int own_steps = min(C::KD, (d - c0) >> 4);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = q0 + 16 * warp;  // the warp's rows: row0 + g, + 8
  const int t = lane & 3;
  const size_t head = (size_t)bh * Lq * d;
  const bf16* kh = k + (size_t)bh * Lk * d;
  const bf16* vh = v + (size_t)bh * Lk * d;
  const float* brow = BIAS ? key_bias_row(kb, bh, Lk) : nullptr;
  const int off_a = lane_off_a(lane, C::S);
  const int off_b = lane_off_b(lane, C::S);
  const float scale_log2 = scale * kLog2e;
  float lr[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    lr[r] = row < Lq ? kLog2e * lse[(size_t)bh * Lq + row] : INFINITY;
    dl[r] = row < Lq ? delta[(size_t)bh * Lq + row] : 0.f;
  }
  float acc[C::ND][4] = {};

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    float s[C::NB][4] = {}, dp_[C::NB][4] = {};
    for (int j = 1; j <= chunks; ++j) {
      const int c = (cb + j) % chunks * kWideCols;  // the block's own last
      const int steps = min(C::KD, (d - c) >> 4);
      __syncthreads();  // every warp is past its reads of the tiles
      request_bf16_cols<kWideCols, C::BQ, C::NT>(Qs, q + head + c, q0, Lq, d,
                                                 d - c, tid);
      request_bf16_cols<kWideCols, C::BQ, C::NT>(dOs, dout + head + c, q0, Lq,
                                                 d, d - c, tid);
      request_bf16_cols<kWideCols, BK, C::NT>(Ks, kh + c, k0, Lk, d, d - c,
                                              tid);
      request_bf16_cols<kWideCols, BK, C::NT>(Vs, vh + c, k0, Lk, d, d - c,
                                              tid);
      cp_async_commit_group();
      cp_async_wait_groups();
      __syncthreads();
      if (row0 >= Lq) continue;  // no real row: only the barriers
#pragma unroll
      for (int kk = 0; kk < C::KD; ++kk) {
        if (kk < steps) {
          uint32_t qf[4], dof[4];
          ldmatrix_x4(qf, Qs + 16 * warp * C::S + 16 * kk + off_a);
          ldmatrix_x4(dof, dOs + 16 * warp * C::S + 16 * kk + off_a);
#pragma unroll
          for (int jj = 0; jj < C::NB / 2; ++jj) {
            uint32_t b[4];
            ldmatrix_x4(b, Ks + 16 * jj * C::S + 16 * kk + off_b);
            mma_bf16(s[2 * jj], qf, b[0], b[1]);
            mma_bf16(s[2 * jj + 1], qf, b[2], b[3]);
            ldmatrix_x4(b, Vs + 16 * jj * C::S + 16 * kk + off_b);
            mma_bf16(dp_[2 * jj], dof, b[0], b[1]);
            mma_bf16(dp_[2 * jj + 1], dof, b[2], b[3]);
          }
        }
      }
    }
    if (row0 >= Lq) continue;
    uint32_t keep = 0;
    if constexpr (DROPOUT)
      keep = dropout_keep_bits_rows<C::NB>(dp, bh, row0, k0, lane);
    bf16_ds_rows<C::NB, DROPOUT, BIAS>(s, dp_, lr, dl, brow, k0, Lk, t, keep,
                                       scale_log2, dp);
    bf16_dq_tile<C>(s, Ks, acc, k0, Lk, own_steps, lane);
  }
  if (row0 < Lq)
    store_acc_cols(dq + head + c0, acc, scale, row0, 0, Lq, d, d - c0, lane);
}

// ---------------------------- head dimensions past 128, up to 256: one block
// The wide forms up to kWideMax (256, the TPU kernel's widest head_dim).
// They replace the same _bwd_kernel (flash_attention.py:126) at those widths.
// A block owns every column of its outputs, so S, P (with the dropout mask),
// dP and dS are computed once for each (query tile, key tile) pair, whatever
// d is; only the products that make the outputs (dV, dK and the dQ share;
// dQ in the dQ kernels) are split over the block's warps. d is padded to
// DMAX 192 (kWideMid, d <= 192) or 256, so every loop over the columns has a
// fixed count. The tiles of one head are neighbouring blocks (blockIdx.x = bh
// tiles + tile), so the tiles a head's blocks share are read from device
// memory about once and from the L2 cache after.
// * bfloat16: what bounds it on an H100 is the bytes and the instructions
//   around the tensor-core products (q, k, v, o, dO, dq, dk, dv in bf16 take
//   0.060 ms at BH 256, L 256, d 192 at 3.35 TB/s). A block of eight warps
//   (two warpgroups) keeps K_j, V_j of 64 keys and walks query tiles of 32,
//   Q, dO, lse and delta double-buffered by cp.async (the next tile's copies
//   fly during this tile's products). dK and dV of 64 keys at 256 columns
//   would take 256 accumulator registers a lane over four warps, so the
//   eight warps split them: warp w keeps keys 16 (w % 4) .. of the column
//   half w / 4 (96 or 128 registers a lane). The scores are not split with
//   them: warp w computes S^T and dP^T of its 16 keys against 16 of the
//   tile's 32 queries (16 (w / 4) ..), over all of d, makes P o Z and dS in
//   float32 and shares them through shared memory as bf16 hi + lo (four (64,
//   40) tiles), from which each warp reads the A fragments of its keys' dV
//   and dK products. The dQ share dS K_j reads dS from the same tiles; each warp
//   takes 16 queries and DMAX / 4 columns of it. Shared memory 121 or 153
//   KB, one block an SM; two barriers a query tile.
// * float32: what bounds it is the CUDA-core FMAs (the five products at 67
//   TFLOP/s: 0.48 ms at BH 256, L 256, d 192). 256 threads keep K_j, V_j of
//   64 keys and walk query tiles of 32: S and dP two rows by four keys a
//   thread, P and dS through shared memory, dV and dK four keys by DMAX / 16
//   columns a thread and the dQ share two rows by DMAX / 16 columns. K, V,
//   Q, dO, P and dS take 164 or 212 KB of shared memory, so Q and dO are
//   single tiles: the next ones fly during the dQ share's product (in the
//   two-kernel form, whose key-tile kernel has no dQ product, the copies are
//   waited for).
// * The two-kernel form's dQ kernels own every column of dQ too: bf16 eight
//   warps of 16 query rows (128 rows), key tiles of 32 in two stages, Q's
//   and dO's fragments read from shared memory at each k16 step (dQ's
//   accumulators take 128 registers a lane); float32 query tiles of 64 rows
//   against key tiles of 32, S and dP two rows by four keys a thread, dQ four
//   rows by DMAX / 16 columns, V's next tile flying during the dQ product.
// d past 256 keeps the chunked forms above. Measured on an H100 80GB HBM3 at
// 700 W (tools/profile_torch_kernels.py --only wide, from a CUDA graph), ms
// a call at BH 256, L 256, d 192, p 0.1, fused: bf16 0.453 against the
// chunked form's 0.655, the library's backward's 0.27-0.32 (in a row) and a
// bound of 0.060 (bytes); float32 1.38 against 2.33, 1.34 and 0.48
// (operations).

// The bf16 key-tile kernel's geometry: a key tile of BT keys, query tiles of
// BQ, head_dim padded to DMAX; HN n8 tiles of d in a warp's half of dK, dV;
// `bf16_dq_share` reads NW (16-key chunks), RG (16-query groups) and NDW
// (n8 tiles of d a warp's share takes, eight warps).
template <int DMAX>
struct Bf16WideCfg {
  static constexpr int BT = 64, BQ = 32, NT = 256;
  static constexpr int S = DMAX + 8;   // row stride of K, V, Q, dO
  static constexpr int SQ = BQ + 8;    // row stride of the P, dS tiles
  static constexpr int KD = DMAX / 16;
  static constexpr int HN = DMAX / 16;
  static constexpr int NW = BT / 16, RG = BQ / 16;
  static constexpr int NDW = DMAX / 8 / (NT / 32 / RG);
  // K, V; two Q and two dO tiles; (P o Z)^T and dS^T as hi + lo; two tiles'
  // lse and delta
  static constexpr size_t SMEM =
      sizeof(bf16) * ((size_t)(2 * BT + 4 * BQ) * S + 4 * (size_t)BT * SQ) +
      sizeof(float) * 4 * BQ;
};

// The float32 forms' tiles: a key tile of BT keys and query tiles of BQ in
// the key-tile kernel; query tiles of DQ_BQ rows and key tiles of DQ_BK in
// the dQ kernel; rows of DMAX + 4 floats, a thread's columns in G groups of
// four, 4 (tx + 16 g).
template <int DMAX>
struct F32WideCfg {
  static constexpr int BT = 64, BQ = 32, NT = 256;
  static constexpr int DQ_BQ = 64, DQ_BK = 32;
  static constexpr int P = DMAX + 4;
  static constexpr int G = DMAX / 64;
  static constexpr int SP = BT + 4;        // the key-tile kernel's P, dS
  static constexpr int DQ_SP = DQ_BK + 4;  // the dQ kernel's dS
  // K, V, Q, dO, P, dS and the rows' lse and delta
  static constexpr size_t SMEM =
      sizeof(float) *
      ((size_t)(2 * BT + 2 * BQ) * P + 2 * (size_t)BQ * SP + 2 * BQ);
  // Q, dO, K, V, dS, lse and delta
  static constexpr size_t DQ_SMEM =
      sizeof(float) * ((size_t)(2 * DQ_BQ + 2 * DQ_BK) * P +
                       (size_t)DQ_BQ * DQ_SP + 2 * DQ_BQ);
};

// Request rows r0 .. r0 + ROWS - 1 of a head's (L, d) float32 matrix into a
// (ROWS, DMAX + 4) tile by cp.async, zero past L and past column d; 256
// threads.
template <int DMAX, int ROWS>
__device__ __forceinline__ void request_wide_rows(float* dst,
                                                  const float* __restrict__ src,
                                                  int r0, int L, int d,
                                                  int tid) {
  constexpr int V = DMAX / 4;  // pieces of a row
  for (int i = tid; i < ROWS * V; i += F32WideCfg<DMAX>::NT) {
    const int r = i / V;
    const int c = (i - r * V) * 4;
    const bool ok = r0 + r < L && c < d;
    cp_async16(dst + r * F32WideCfg<DMAX>::P + c,
               ok ? src + (size_t)(r0 + r) * d + c : src, ok);
  }
}

// out[a][b] = A[row ty + TY a] . B[row tx + TX b] over the DMAX columns of
// two tiles with rows DMAX + 4 apart (zero past d)
template <int DMAX, int RA, int KB, int TX, int TY>
__device__ __forceinline__ void wide_dot(const float* A, const float* B,
                                         int ty, int tx,
                                         float (&out)[RA][KB]) {
  constexpr int P = F32WideCfg<DMAX>::P;
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < KB; ++b) out[a][b] = 0.f;
#pragma unroll 2
  for (int c = 0; c < DMAX; c += 4) {
    float4 bv[KB];
#pragma unroll
    for (int b = 0; b < KB; ++b)
      bv[b] = *reinterpret_cast<const float4*>(B + (tx + TX * b) * P + c);
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const float4 av =
          *reinterpret_cast<const float4*>(A + (ty + TY * a) * P + c);
#pragma unroll
      for (int b = 0; b < KB; ++b) {
        float x = out[a][b];
        x = fmaf(av.x, bv[b].x, x);
        x = fmaf(av.y, bv[b].y, x);
        x = fmaf(av.z, bv[b].z, x);
        x = fmaf(av.w, bv[b].w, x);
        out[a][b] = x;
      }
    }
  }
}

// From S and dP of query rows ty + TY a, keys tx + TX b of a tile (query
// rows from q0, keys from k0 of head bh): P (stored when Ps is given; P o Z
// with DROPOUT) and dS into their tiles with rows SP apart, as `probs_from`
template <int RA, int KB, int TX, int TY, int SP, bool DROPOUT, bool BIAS>
__device__ __forceinline__ void wide_probs(
    const float (&s)[RA][KB], const float (&dpv)[RA][KB], const float* lse_s,
    const float* dl_s, float* Ps, float* dSs, int ty, int tx, float scale,
    const DropoutParams& dp, const float* brow, int Lk, int bh, int q0,
    int k0) {
  float kbias[KB] = {};  // the keys' bias (0 past Lk, where K = V = 0)
  if constexpr (BIAS) {
#pragma unroll
    for (int b = 0; b < KB; ++b)
      kbias[b] = key_bias_at(brow, k0 + tx + TX * b, Lk, 1.f);
  }
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int r = ty + TY * a;
    const float lr = lse_s[r];
    const float dl = dl_s[r];
    uint32_t keep = 0;
    if constexpr (DROPOUT)
      keep = dropout_keep_bits<TX, KB>(dp, bh, q0 + r, k0, tx);
#pragma unroll
    for (int b = 0; b < KB; ++b) {
      const int col = tx + TX * b;
      const float p = expf(BIAS ? fmaf(s[a][b], scale, kbias[b]) - lr
                                : s[a][b] * scale - lr);
      float z = 1.f;
      if constexpr (DROPOUT) z = (keep >> b) & 1u ? dp.keep_scale : 0.f;
      if (Ps != nullptr) Ps[r * SP + col] = DROPOUT ? p * z : p;
      dSs[r * SP + col] = p * ((DROPOUT ? dpv[a][b] * z : dpv[a][b]) - dl) *
                          scale;
    }
  }
}

// acc[a][4 g + e] += sum_j X[row ty + TY a][j] Y[j][4 (tx + 16 g) + e] over
// the J columns of X (rows SX apart) and the rows of Y (rows DMAX + 4 apart)
template <int DMAX, int RA, int TY, int SX, int J>
__device__ __forceinline__ void wide_rows_product(
    const float* X, const float* Y, int ty, int tx,
    float (&acc)[RA][4 * F32WideCfg<DMAX>::G]) {
  using C = F32WideCfg<DMAX>;
#pragma unroll 2
  for (int j = 0; j < J; j += 4) {
    float xv[RA][4];
#pragma unroll
    for (int a = 0; a < RA; ++a)
      load_vec<4>(xv[a], X + (ty + TY * a) * SX + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int g = 0; g < C::G; ++g) {
        float yv[4];
        load_vec<4>(yv, Y + (j + jj) * C::P + 4 * (tx + 16 * g));
#pragma unroll
        for (int a = 0; a < RA; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[a][4 * g + e] = fmaf(xv[a][jj], yv[e], acc[a][4 * g + e]);
      }
    }
  }
}

// rows r0 + ty + TY a (< L) of acc at columns 4 (tx + 16 g) (< ncols) into
// a head's (L, ncols) matrix
template <int G, int RA, int TY>
__device__ __forceinline__ void wide_store_rows(float* __restrict__ dst,
                                                const float (&acc)[RA][4 * G],
                                                int r0, int L, int ncols,
                                                int ty, int tx) {
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int row = r0 + ty + TY * a;
    if (row >= L) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c = 4 * (tx + 16 * g);
      if (c < ncols) store_vec<4>(dst + (size_t)row * ncols + c, acc[a] + 4 * g);
    }
  }
}

template <int DMAX, bool WITH_DQ, bool DROPOUT, bool BIAS>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkdv_wide256_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dq_out,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int Lq, int Lk, int d, float scale,
                              DropoutParams dp, KeyBias kb) {
  using C = F32WideCfg<DMAX>;
  constexpr int BT = C::BT, BQ = C::BQ;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * C::P;
  float* Qs = Vs + BT * C::P;
  float* dOs = Qs + BQ * C::P;
  float* Ps = dOs + BQ * C::P;  // (BQ, BT + 4)
  float* dSs = Ps + BQ * C::SP;
  float* lse_s = dSs + BQ * C::SP;
  float* dl_s = lse_s + BQ;

  const int tiles = (Lk + BT - 1) / BT;
  const int bh = blockIdx.x / tiles;
  const int tile = blockIdx.x - bh * tiles;
  const int k0 = tile * BT;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const size_t head = (size_t)bh * Lq * d;   // q, dO, dq
  const size_t khead = (size_t)bh * Lk * d;  // k, v, dk, dv
  const size_t base = (size_t)bh * Lq;
  const float* brow = BIAS ? key_bias_row(kb, bh, Lk) : nullptr;
  float* dq_head = nullptr;
  if constexpr (WITH_DQ) dq_head = dq_out + ((size_t)bh * tiles + tile) * Lq * d;

  request_wide_rows<DMAX, BT>(Ks, k + khead, k0, Lk, d, tid);
  request_wide_rows<DMAX, BT>(Vs, v + khead, k0, Lk, d, tid);
  request_wide_rows<DMAX, BQ>(Qs, q + head, 0, Lq, d, tid);
  request_wide_rows<DMAX, BQ>(dOs, dout + head, 0, Lq, d, tid);
  load_row_stats<BQ>(lse_s, dl_s, lse, delta, base, 0, Lq, tid);

  // keys k0 + 4 ty + a, columns 4 (tx + 16 g) .. + 3
  float dk_acc[4][4 * C::G], dv_acc[4][4 * C::G];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4 * C::G; ++b) dk_acc[a][b] = dv_acc[a][b] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    cp_async_wait_all();
    __syncthreads();  // the tiles and row stats are in; dSs is read
    {  // S and dP: rows ty + 16 a, keys tx + 16 b
      float s[2][4], dpv[2][4];
      wide_dot<DMAX, 2, 4, 16, 16>(Qs, Ks, ty, tx, s);
      wide_dot<DMAX, 2, 4, 16, 16>(dOs, Vs, ty, tx, dpv);
      wide_probs<2, 4, 16, 16, C::SP, DROPOUT, BIAS>(
          s, dpv, lse_s, dl_s, Ps, dSs, ty, tx, scale, dp, brow, Lk, bh, q0,
          k0);
    }
    __syncthreads();  // P and dS are whole
    // dV += P^T dO, dK += dS^T Q over the tile's rows
    const int rows = min(BQ, Lq - q0);
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      float pv[4], dsv[4];
      load_vec<4>(pv, Ps + r * C::SP + 4 * ty);
      load_vec<4>(dsv, dSs + r * C::SP + 4 * ty);
#pragma unroll
      for (int g = 0; g < C::G; ++g) {
        const int c = 4 * (tx + 16 * g);
        float ov[4], qv[4];
        load_vec<4>(ov, dOs + r * C::P + c);
        load_vec<4>(qv, Qs + r * C::P + c);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dv_acc[a][4 * g + e] = fmaf(pv[a], ov[e], dv_acc[a][4 * g + e]);
            dk_acc[a][4 * g + e] = fmaf(dsv[a], qv[e], dk_acc[a][4 * g + e]);
          }
      }
    }
    __syncthreads();  // Qs, dOs and the row stats are read
    if (q0 + BQ < Lq) {  // the next tiles fly during the dQ share
      request_wide_rows<DMAX, BQ>(Qs, q + head, q0 + BQ, Lq, d, tid);
      request_wide_rows<DMAX, BQ>(dOs, dout + head, q0 + BQ, Lq, d, tid);
      load_row_stats<BQ>(lse_s, dl_s, lse, delta, base, q0 + BQ, Lq, tid);
    }
    if constexpr (WITH_DQ) {  // rows ty + 16 a, columns 4 (tx + 16 g)
      float acc[2][4 * C::G];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4 * C::G; ++b) acc[a][b] = 0.f;
      wide_rows_product<DMAX, 2, 16, C::SP, BT>(dSs, Ks, ty, tx, acc);
      wide_store_rows<C::G, 2, 16>(dq_head, acc, q0, Lq, d, ty, tx);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = k0 + 4 * ty + a;
    if (row >= Lk) continue;
#pragma unroll
    for (int g = 0; g < C::G; ++g) {
      const int c = 4 * (tx + 16 * g);
      if (c < d) {
        store_vec<4>(dk + khead + (size_t)row * d + c, dk_acc[a] + 4 * g);
        store_vec<4>(dv + khead + (size_t)row * d + c, dv_acc[a] + 4 * g);
      }
    }
  }
}

// The two-kernel form's dQ, float32: one block per (head, query tile of 64)
// walks key tiles of 32.
template <int DMAX, bool DROPOUT, bool BIAS>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dq_wide256_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int Lq, int Lk, int d,
                            float scale, DropoutParams dp, KeyBias kb) {
  using C = F32WideCfg<DMAX>;
  constexpr int BQ = C::DQ_BQ, BK = C::DQ_BK;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * C::P;
  float* Ks = dOs + BQ * C::P;
  float* Vs = Ks + BK * C::P;
  float* dSs = Vs + BK * C::P;  // (BQ, BK + 4)
  float* lse_s = dSs + BQ * C::DQ_SP;
  float* dl_s = lse_s + BQ;

  const int tiles = (Lq + BQ - 1) / BQ;
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - bh * tiles) * BQ;
  const int tid = threadIdx.x;
  const size_t head = (size_t)bh * Lq * d;
  const size_t khead = (size_t)bh * Lk * d;
  const float* brow = BIAS ? key_bias_row(kb, bh, Lk) : nullptr;

  request_wide_rows<DMAX, BQ>(Qs, q + head, q0, Lq, d, tid);
  request_wide_rows<DMAX, BQ>(dOs, dout + head, q0, Lq, d, tid);
  request_wide_rows<DMAX, BK>(Ks, k + khead, 0, Lk, d, tid);
  request_wide_rows<DMAX, BK>(Vs, v + khead, 0, Lk, d, tid);
  load_row_stats<BQ>(lse_s, dl_s, lse, delta, (size_t)bh * Lq, q0, Lq, tid);

  // query rows ty + 16 a, columns 4 (tx + 16 g) .. + 3
  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4 * C::G];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4 * C::G; ++b) acc[a][b] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    cp_async_wait_all();
    __syncthreads();  // K, V and the row stats are in; dSs and K are read
    {  // S and dP: rows (tid >> 3) + 32 a, keys (tid & 7) + 8 b
      float s[2][4], dpv[2][4];
      wide_dot<DMAX, 2, 4, 8, 32>(Qs, Ks, tid >> 3, tid & 7, s);
      wide_dot<DMAX, 2, 4, 8, 32>(dOs, Vs, tid >> 3, tid & 7, dpv);
      wide_probs<2, 4, 8, 32, C::DQ_SP, DROPOUT, BIAS>(
          s, dpv, lse_s, dl_s, nullptr, dSs, tid >> 3, tid & 7, scale, dp,
          brow, Lk, bh, q0, k0);
    }
    __syncthreads();  // dS is whole; V is read
    if (k0 + BK < Lk)  // the next V tile flies during the dQ product
      request_wide_rows<DMAX, BK>(Vs, v + khead, k0 + BK, Lk, d, tid);
    wide_rows_product<DMAX, 4, 16, C::DQ_SP, BK>(dSs, Ks, ty, tx, acc);
    __syncthreads();  // K is read
    if (k0 + BK < Lk)
      request_wide_rows<DMAX, BK>(Ks, k + khead, k0 + BK, Lk, d, tid);
  }
  wide_store_rows<C::G, 4, 16>(dq + head, acc, q0, Lq, d, ty, tx);
}

// bf16: one block per (head, key tile of 64) of eight warps; dq_out as
// flash_bwd_bf16_kv_kernel's.
template <typename DQ, int DMAX, bool WITH_DQ, bool DROPOUT, bool BIAS>
__global__ void __launch_bounds__(256, 1)
flash_bwd_bf16_kv_wide256_kernel(const bf16* __restrict__ q,
                                 const bf16* __restrict__ k,
                                 const bf16* __restrict__ v,
                                 const bf16* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 DQ* __restrict__ dq_out,
                                 bf16* __restrict__ dk, bf16* __restrict__ dv,
                                 int Lq, int Lk, int d, float scale,
                                 DropoutParams dp, KeyBias kb) {
  using C = Bf16WideCfg<DMAX>;
  constexpr int BT = C::BT, BQ = C::BQ;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_bf16);
  bf16* Vs = Ks + BT * C::S;
  bf16* Qb = Vs + BT * C::S;  // Q tiles: buffer (tile index & 1)
  bf16* dOb = Qb + 2 * BQ * C::S;
  bf16* Ph = dOb + 2 * BQ * C::S;  // (P o Z)^T and dS^T as hi + lo, (BT, BQ + 8)
  bf16* Pl = Ph + BT * C::SQ;
  bf16* dSh = Pl + BT * C::SQ;
  bf16* dSl = dSh + BT * C::SQ;
  float* stats = reinterpret_cast<float*>(dSl + BT * C::SQ);  // lse, delta

  const int tiles = (Lk + BT - 1) / BT;
  const int bh = blockIdx.x / tiles;
  const int tile = blockIdx.x - bh * tiles;
  const int k0 = tile * BT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = 16 * (warp & 3);   // the warp's keys: k0 + kw + g, + 8
  const int qw = 16 * (warp >> 2);  // its 16 queries of a tile's scores
  const int half = warp >> 2;       // its half of d for dK and dV
  const bool live = k0 + kw < Lk;
  const float scale_log2 = scale * kLog2e;
  float kbias[2] = {};  // the lane's two keys' bias, base 2
  if constexpr (BIAS) {
    const float* brow = key_bias_row(kb, bh, Lk);
    kbias[0] = key_bias_at(brow, k0 + kw + g, Lk, kLog2e);
    kbias[1] = key_bias_at(brow, k0 + kw + g + 8, Lk, kLog2e);
  }
  const int steps = d >> 4;
  const size_t head = (size_t)bh * Lq * d;   // q, dO, dq
  const size_t khead = (size_t)bh * Lk * d;  // k, v, dk, dv
  const size_t base = (size_t)bh * Lq;
  const int off_a = lane_off_a(lane, C::S);
  const int off_b = lane_off_b(lane, C::S);
  const int off_p = lane_off_a(lane, C::SQ);
  DQ* dq_head = nullptr;
  if constexpr (WITH_DQ)
    dq_head = dq_out + ((size_t)bh * tiles + tile) * Lq * d;

  request_bf16_rows<DMAX, BT, C::NT>(Ks, k + khead, k0, Lk, d, tid);
  request_bf16_rows<DMAX, BT, C::NT>(Vs, v + khead, k0, Lk, d, tid);
  request_bf16_rows<DMAX, BQ, C::NT>(Qb, q + head, 0, Lq, d, tid);
  request_bf16_rows<DMAX, BQ, C::NT>(dOb, dout + head, 0, Lq, d, tid);
  request_row_stats<BQ, C::NT>(stats, stats + 2 * BQ, lse, delta, base, 0, Lq,
                               tid);
  cp_async_commit_group();

  // keys kw + g, + 8 at the n8 tiles HN half .. of d
  float dk_acc[C::HN][4], dv_acc[C::HN][4];
#pragma unroll
  for (int n = 0; n < C::HN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int q0 = 0, it = 0; q0 < Lq; q0 += BQ, ++it) {
    const int buf = it & 1;
    const bf16* Qs = Qb + buf * BQ * C::S;
    const bf16* dOs = dOb + buf * BQ * C::S;
    float* lse_s = stats + buf * BQ;
    const float* dl_s = stats + (2 + buf) * BQ;
    cp_async_wait_groups();
    base2_row_stats<BQ, C::NT>(lse_s, q0, Lq, tid);
    __syncthreads();  // this tile is in; every warp is past the last one
    if (q0 + BQ < Lq) {  // the next tile flies during this one's products
      const int nb = buf ^ 1;
      request_bf16_rows<DMAX, BQ, C::NT>(Qb + nb * BQ * C::S, q + head,
                                         q0 + BQ, Lq, d, tid);
      request_bf16_rows<DMAX, BQ, C::NT>(dOb + nb * BQ * C::S, dout + head,
                                         q0 + BQ, Lq, d, tid);
      request_row_stats<BQ, C::NT>(stats + nb * BQ, stats + (2 + nb) * BQ,
                                   lse, delta, base, q0 + BQ, Lq, tid);
      cp_async_commit_group();
    }
    if (live) {
      // the scores of the warp's 16 keys against queries qw .. + 15, once
      uint32_t keep = 0;
      if constexpr (DROPOUT)
        keep = dropout_keep_bits_cols<2>(dp, bh, k0 + kw, q0 + qw, lane);
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::KD; ++kk) {
        if (kk < steps) {
          uint32_t ak[4], av[4], b[4];
          ldmatrix_x4(ak, Ks + kw * C::S + 16 * kk + off_a);
          ldmatrix_x4(av, Vs + kw * C::S + 16 * kk + off_a);
          ldmatrix_x4(b, Qs + qw * C::S + 16 * kk + off_b);
          mma_bf16(st[0], ak, b[0], b[1]);
          mma_bf16(st[1], ak, b[2], b[3]);
          ldmatrix_x4(b, dOs + qw * C::S + 16 * kk + off_b);
          mma_bf16(dpt[0], av, b[0], b[1]);
          mma_bf16(dpt[1], av, b[2], b[3]);
        }
      }
      // P^T o Z into st and dS^T / scale into dpt, then both as hi + lo into
      // the shared tiles at (key, query)
      bf16_probs_t<2, DROPOUT, BIAS>(st, dpt, lse_s + qw, dl_s + qw, kbias,
                                     keep, t, scale_log2, dp);
      uint32_t ph[4], pl[4], sh[4], sl[4];
      split_a(st[0], st[1], ph, pl);
      split_a(dpt[0], dpt[1], sh, sl);
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // a fragment's (row, column) block
        const int at = (kw + g + 8 * (r & 1)) * C::SQ + qw + 8 * (r >> 1) +
                       2 * t;
        *reinterpret_cast<uint32_t*>(Ph + at) = ph[r];
        *reinterpret_cast<uint32_t*>(Pl + at) = pl[r];
        *reinterpret_cast<uint32_t*>(dSh + at) = sh[r];
        *reinterpret_cast<uint32_t*>(dSl + at) = sl[r];
      }
    }
    __syncthreads();  // P o Z and dS are whole
    if (live) {
      // dV += (P o Z)^T dO, dK += dS^T Q for the warp's keys at its half of
      // d: the A fragments from the shared tiles, dO and Q by ldmatrix.trans
#pragma unroll
      for (int c = 0; c < BQ / 16; ++c) {
        if (q0 + 16 * c >= Lq) break;  // queries past Lq: P and dS are 0
        uint32_t ph[4], pl[4], sh[4], sl[4];
        const int at = kw * C::SQ + 16 * c + off_p;
        ldmatrix_x4(ph, Ph + at);
        ldmatrix_x4(pl, Pl + at);
        ldmatrix_x4(sh, dSh + at);
        ldmatrix_x4(sl, dSl + at);
#pragma unroll
        for (int np = 0; np < C::HN / 2; ++np) {
          const int n16 = C::HN / 2 * half + np;  // d's 16-column block
          if (n16 < steps) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, dOs + 16 * c * C::S + 16 * n16 + off_a);
            mma_bf16_split(dv_acc[2 * np], ph, pl, b[0], b[1]);
            mma_bf16_split(dv_acc[2 * np + 1], ph, pl, b[2], b[3]);
            ldmatrix_x4_trans(b, Qs + 16 * c * C::S + 16 * n16 + off_a);
            mma_bf16_split(dk_acc[2 * np], sh, sl, b[0], b[1]);
            mma_bf16_split(dk_acc[2 * np + 1], sh, sl, b[2], b[3]);
          }
        }
      }
    }
    if constexpr (WITH_DQ)
      bf16_dq_share<C>(dSh, dSl, Ks, dq_head, scale, k0, Lk, q0, Lq, d, d,
                       steps, warp, lane);
  }
  if (live) {
    store_acc_cols(dk + khead, dk_acc, scale, k0 + kw, C::HN * half, Lk, d,
                   d, lane);
    store_acc_cols(dv + khead, dv_acc, 1.f, k0 + kw, C::HN * half, Lk, d, d,
                   lane);
  }
}

// bf16, the two-kernel form's dQ: eight warps of 16 query rows (128 rows)
// walk key tiles of 32 in two stages; every column of dQ in each warp.
template <int DMAX, bool DROPOUT, bool BIAS>
__global__ void __launch_bounds__(256, 1)
flash_bwd_bf16_dq_wide256_kernel(const bf16* __restrict__ q,
                                 const bf16* __restrict__ k,
                                 const bf16* __restrict__ v,
                                 const bf16* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 bf16* __restrict__ dq, int Lq, int Lk, int d,
                                 float scale, DropoutParams dp, KeyBias kb) {
  constexpr int BK = 32;
  using C = Bf16DqCfg<DMAX, 8, BK>;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_bf16);
  bf16* dOs = Qs + C::BQ * C::S;
  bf16* Kb = dOs + C::BQ * C::S;  // K tiles: buffer (tile index & 1)
  bf16* Vb = Kb + 2 * BK * C::S;

  const int tiles = (Lq + C::BQ - 1) / C::BQ;
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - bh * tiles) * C::BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = q0 + 16 * warp;  // the warp's rows: row0 + g, + 8
  const int steps = d >> 4;
  const size_t head = (size_t)bh * Lq * d;
  const bf16* kh = k + (size_t)bh * Lk * d;
  const bf16* vh = v + (size_t)bh * Lk * d;
  const float* brow = BIAS ? key_bias_row(kb, bh, Lk) : nullptr;
  const int t = lane & 3;  // the lane's keys in an n8 tile: 2 t, 2 t + 1
  const int off_a = lane_off_a(lane, C::S);
  const int off_b = lane_off_b(lane, C::S);

  request_bf16_rows<DMAX, C::BQ, C::NT>(Qs, q + head, q0, Lq, d, tid);
  request_bf16_rows<DMAX, C::BQ, C::NT>(dOs, dout + head, q0, Lq, d, tid);
  request_bf16_rows<DMAX, BK, C::NT>(Kb, kh, 0, Lk, d, tid);
  request_bf16_rows<DMAX, BK, C::NT>(Vb, vh, 0, Lk, d, tid);
  cp_async_commit_group();

  // the rows' lse in base 2 (rows past L: +inf, so P = 0) and delta
  const float scale_log2 = scale * kLog2e;
  float lr[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    lr[r] = row < Lq ? kLog2e * lse[(size_t)bh * Lq + row] : INFINITY;
    dl[r] = row < Lq ? delta[(size_t)bh * Lq + row] : 0.f;
  }
  float acc[C::ND][4];
#pragma unroll
  for (int n = 0; n < C::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int k0 = 0, it = 0; k0 < Lk; k0 += BK, ++it) {
    const bf16* Ks = Kb + (it & 1) * BK * C::S;
    const bf16* Vs = Vb + (it & 1) * BK * C::S;
    cp_async_wait_groups();
    __syncthreads();  // this tile is in; every warp is past the last one
    if (k0 + BK < Lk) {  // the next tile flies during this one's products
      request_bf16_rows<DMAX, BK, C::NT>(Kb + ((it + 1) & 1) * BK * C::S,
                                             kh, k0 + BK, Lk, d, tid);
      request_bf16_rows<DMAX, BK, C::NT>(Vb + ((it + 1) & 1) * BK * C::S,
                                             vh, k0 + BK, Lk, d, tid);
      cp_async_commit_group();
    }
    if (row0 >= Lq) continue;  // no real row: only the barriers
    uint32_t keep = 0;  // first, as in the forward
    if constexpr (DROPOUT)
      keep = dropout_keep_bits_rows<C::NB>(dp, bh, row0, k0, lane);
    float s[C::NB][4], dp_[C::NB][4];
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp_[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk) {
      if (kk < steps) {
        uint32_t qa[4], da[4];  // Q's and dO's fragments of this k16 step
        ldmatrix_x4(qa, Qs + 16 * warp * C::S + 16 * kk + off_a);
        ldmatrix_x4(da, dOs + 16 * warp * C::S + 16 * kk + off_a);
#pragma unroll
        for (int jj = 0; jj < C::NB / 2; ++jj) {
          uint32_t b[4];
          ldmatrix_x4(b, Ks + 16 * jj * C::S + 16 * kk + off_b);
          mma_bf16(s[2 * jj], qa, b[0], b[1]);
          mma_bf16(s[2 * jj + 1], qa, b[2], b[3]);
          ldmatrix_x4(b, Vs + 16 * jj * C::S + 16 * kk + off_b);
          mma_bf16(dp_[2 * jj], da, b[0], b[1]);
          mma_bf16(dp_[2 * jj + 1], da, b[2], b[3]);
        }
      }
    }
    bf16_ds_rows<C::NB, DROPOUT, BIAS>(s, dp_, lr, dl, brow, k0, Lk, t, keep,
                                       scale_log2, dp);
    bf16_dq_tile<C>(s, Ks, acc, k0, Lk, steps, lane);
  }
  if (row0 < Lq) store_acc(dq + head, acc, scale, row0, 0, Lq, d, lane);
}

// The launches up to kWideMax, at a head_dim padded to DMAX (192 or 256):
// delta, then the key-tile kernel over (head, key tile of 64), fused (dq itself with one key tile, else shares summed
// into dq in tile order) or followed by the dQ kernel.
template <int DMAX, bool DROPOUT, bool BIAS>
int launch_wide256(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta,
                   float* partial, void* dq, void* dk, void* dv, int bh,
                   int Lq, int Lk, int d, float scale, int fused,
                   int bf16_form, const DropoutParams& dp, const KeyBias& kb,
                   cudaStream_t stream) {
  constexpr int BT = 64;
  const int tiles = (Lk + BT - 1) / BT;  // key tiles
  if (fused && tiles > 1 && partial == nullptr)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)bh * tiles;
  int rc;
  if (bf16_form) {
    using C = Bf16WideCfg<DMAX>;
    using CQ = Bf16DqCfg<DMAX, 8, 32>;
    const bf16 *qb = (const bf16*)q, *kbp = (const bf16*)k,
               *vb = (const bf16*)v, *db = (const bf16*)dout;
    rc = launch_delta<bf16>((const bf16*)o, db, delta, bh * Lq, d, stream);
    if (rc != 0) return rc;
    if (fused && tiles == 1) {  // dq itself
      constexpr auto kernel =
          flash_bwd_bf16_kv_wide256_kernel<bf16, DMAX, true, DROPOUT, BIAS>;
      if ((rc = opt_in_once<kernel>(C::SMEM)) != 0) return rc;
      kernel<<<blocks, C::NT, C::SMEM, stream>>>(
          qb, kbp, vb, db, lse, delta, (bf16*)dq, (bf16*)dk, (bf16*)dv, Lq,
          Lk, d, scale, dp, kb);
      return (int)cudaGetLastError();
    }
    if (fused) {  // float32 shares, summed into dq in tile order
      constexpr auto kernel =
          flash_bwd_bf16_kv_wide256_kernel<float, DMAX, true, DROPOUT, BIAS>;
      if ((rc = opt_in_once<kernel>(C::SMEM)) != 0) return rc;
      kernel<<<blocks, C::NT, C::SMEM, stream>>>(qb, kbp, vb, db, lse, delta,
                                                 partial, (bf16*)dk,
                                                 (bf16*)dv, Lq, Lk, d, scale,
                                                 dp, kb);
      if ((rc = (int)cudaGetLastError()) != 0) return rc;
      return launch_dq_sum<bf16>(partial, (bf16*)dq, bh, Lq, d, tiles, stream);
    }
    constexpr auto kv =
        flash_bwd_bf16_kv_wide256_kernel<bf16, DMAX, false, DROPOUT, BIAS>;
    constexpr auto dq_kernel = flash_bwd_bf16_dq_wide256_kernel<DMAX, DROPOUT, BIAS>;
    if ((rc = opt_in_once<kv>(C::SMEM)) != 0) return rc;
    if ((rc = opt_in_once<dq_kernel>(CQ::SMEM)) != 0) return rc;
    kv<<<blocks, C::NT, C::SMEM, stream>>>(qb, kbp, vb, db, lse, delta,
                                           (bf16*)nullptr, (bf16*)dk,
                                           (bf16*)dv, Lq, Lk, d, scale, dp,
                                           kb);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
    dq_kernel<<<(unsigned)bh * ((Lq + CQ::BQ - 1) / CQ::BQ), CQ::NT,
                CQ::SMEM, stream>>>(qb, kbp, vb, db, lse, delta, (bf16*)dq,
                                    Lq, Lk, d, scale, dp, kb);
    return (int)cudaGetLastError();
  }
  using C = F32WideCfg<DMAX>;
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v, *df = (const float*)dout;
  rc = launch_delta<float>((const float*)o, df, delta, bh * Lq, d, stream);
  if (rc != 0) return rc;
  if (fused) {  // dq itself with one key tile, else shares summed into dq
    constexpr auto kernel = flash_bwd_dkdv_wide256_kernel<DMAX, true, DROPOUT, BIAS>;
    if ((rc = opt_in_once<kernel>(C::SMEM)) != 0) return rc;
    kernel<<<blocks, C::NT, C::SMEM, stream>>>(
        qf, kf, vf, df, lse, delta, tiles == 1 ? (float*)dq : partial,
        (float*)dk, (float*)dv, Lq, Lk, d, scale, dp, kb);
    if ((rc = (int)cudaGetLastError()) != 0 || tiles == 1) return rc;
    return launch_dq_sum<float>(partial, (float*)dq, bh, Lq, d, tiles, stream);
  }
  constexpr auto dkdv = flash_bwd_dkdv_wide256_kernel<DMAX, false, DROPOUT, BIAS>;
  constexpr auto dq_kernel = flash_bwd_dq_wide256_kernel<DMAX, DROPOUT, BIAS>;
  if ((rc = opt_in_once<dkdv>(C::SMEM)) != 0) return rc;
  if ((rc = opt_in_once<dq_kernel>(C::DQ_SMEM)) != 0) return rc;
  dkdv<<<blocks, C::NT, C::SMEM, stream>>>(qf, kf, vf, df, lse, delta,
                                           nullptr, (float*)dk, (float*)dv,
                                           Lq, Lk, d, scale, dp, kb);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  dq_kernel<<<(unsigned)bh * ((Lq + C::DQ_BQ - 1) / C::DQ_BQ), C::NT,
              C::DQ_SMEM, stream>>>(qf, kf, vf, df, lse, delta, (float*)dq,
                                    Lq, Lk, d, scale, dp, kb);
  return (int)cudaGetLastError();
}

// The wide forms' launches: delta, then the key-tile kernel over (head, key
// tile of 64, 128 columns), fused (dq itself with one key tile, else shares
// summed into dq) or followed by the dQ kernel.
template <bool DROPOUT, bool BIAS>
int launch_wide(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta,
                float* partial, void* dq, void* dk, void* dv, int bh, int Lq,
                int Lk, int d, float scale, int fused, int bf16_form,
                const DropoutParams& dp, const KeyBias& kb,
                cudaStream_t stream) {
  constexpr int BT = 64;
  const int tiles = (Lk + BT - 1) / BT;  // key tiles
  if (fused && tiles > 1 && partial == nullptr)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(bh, tiles, (d + kWideCols - 1) / kWideCols);
  int rc;
  if (bf16_form) {
    using C = Bf16Cfg<kWideCols, BT, 32>;
    using CQ = Bf16DqCfg<kWideCols, 4, 32>;
    constexpr size_t smem =
        sizeof(bf16) * ((size_t)(2 * BT + 2 * 32) * C::S +
                        2 * (size_t)BT * C::SQ) +
        sizeof(float) * 2 * 32;
    constexpr size_t smem_dq = sizeof(bf16) * (size_t)(2 * CQ::BQ + 2 * 32) *
                               CQ::S;
    const bf16 *qb = (const bf16*)q, *kbp = (const bf16*)k,
               *vb = (const bf16*)v, *db = (const bf16*)dout;
    rc = launch_delta<bf16>((const bf16*)o, db, delta, bh * Lq, d, stream);
    if (rc != 0) return rc;
    if (fused && tiles == 1) {  // dq itself
      constexpr auto kernel =
          flash_bwd_bf16_kv_wide_kernel<bf16, true, DROPOUT, BIAS>;
      if ((rc = opt_in_once<kernel>(smem)) != 0) return rc;
      kernel<<<grid, C::NT, smem, stream>>>(qb, kbp, vb, db, lse, delta,
                                            (bf16*)dq, (bf16*)dk, (bf16*)dv,
                                            Lq, Lk, d, scale, dp, kb);
      return (int)cudaGetLastError();
    }
    if (fused) {  // float32 shares, summed into dq in tile order
      constexpr auto kernel =
          flash_bwd_bf16_kv_wide_kernel<float, true, DROPOUT, BIAS>;
      if ((rc = opt_in_once<kernel>(smem)) != 0) return rc;
      kernel<<<grid, C::NT, smem, stream>>>(qb, kbp, vb, db, lse, delta,
                                            partial, (bf16*)dk, (bf16*)dv, Lq,
                                            Lk, d, scale, dp, kb);
      if ((rc = (int)cudaGetLastError()) != 0) return rc;
      return launch_dq_sum<bf16>(partial, (bf16*)dq, bh, Lq, d, tiles, stream);
    }
    constexpr auto kv =
        flash_bwd_bf16_kv_wide_kernel<bf16, false, DROPOUT, BIAS>;
    constexpr auto dq_kernel = flash_bwd_bf16_dq_wide_kernel<DROPOUT, BIAS>;
    if ((rc = opt_in_once<kv>(smem)) != 0) return rc;
    if ((rc = opt_in_once<dq_kernel>(smem_dq)) != 0) return rc;
    kv<<<grid, C::NT, smem, stream>>>(qb, kbp, vb, db, lse, delta,
                                      (bf16*)nullptr, (bf16*)dk, (bf16*)dv, Lq,
                                      Lk, d, scale, dp, kb);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
    dq_kernel<<<dim3(bh, (Lq + CQ::BQ - 1) / CQ::BQ, grid.z), CQ::NT, smem_dq,
                stream>>>(qb, kbp, vb, db, lse, delta, (bf16*)dq, Lq, Lk, d,
                          scale, dp, kb);
    return (int)cudaGetLastError();
  }
  using C = Cfg<kWideCols, BT>;
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v, *df = (const float*)dout;
  rc = launch_delta<float>((const float*)o, df, delta, bh * Lq, d, stream);
  if (rc != 0) return rc;
  if (fused) {  // dq itself with one key tile, else shares summed into dq
    constexpr auto kernel = flash_bwd_dkdv_wide_kernel<true, DROPOUT, BIAS>;
    if ((rc = opt_in_once<kernel>(C::SMEM_DKDV)) != 0) return rc;
    kernel<<<grid, C::NT, C::SMEM_DKDV, stream>>>(
        qf, kf, vf, df, lse, delta, tiles == 1 ? (float*)dq : partial,
        (float*)dk, (float*)dv, Lq, Lk, d, scale, dp, kb);
    if ((rc = (int)cudaGetLastError()) != 0 || tiles == 1) return rc;
    return launch_dq_sum<float>(partial, (float*)dq, bh, Lq, d, tiles, stream);
  }
  constexpr auto dkdv = flash_bwd_dkdv_wide_kernel<false, DROPOUT, BIAS>;
  constexpr auto dq_kernel = flash_bwd_dq_wide_kernel<DROPOUT, BIAS>;
  if ((rc = opt_in_once<dkdv>(C::SMEM_DKDV)) != 0) return rc;
  if ((rc = opt_in_once<dq_kernel>(C::SMEM_DKDV)) != 0) return rc;
  dkdv<<<grid, C::NT, C::SMEM_DKDV, stream>>>(qf, kf, vf, df, lse, delta,
                                              nullptr, (float*)dk, (float*)dv,
                                              Lq, Lk, d, scale, dp, kb);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  dq_kernel<<<dim3(bh, (Lq + BT - 1) / BT, grid.z), C::NT, C::SMEM_DKDV,
              stream>>>(qf, kf, vf, df, lse, delta, (float*)dq, Lq, Lk, d,
                        scale, dp, kb);
  return (int)cudaGetLastError();
}

template <int DMAX, int BT, bool DROPOUT, bool BIAS>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* delta, float* partial,
           float* dq, float* dk, float* dv, int bh, int Lq, int Lk, int d,
           float scale, int fused, const DropoutParams& dp, const KeyBias& kb,
           cudaStream_t stream) {
  using C = Cfg<DMAX, BT>;
  static std::atomic<bool> opted_fused[kMaxDevices], opted_dkdv[kMaxDevices],
      opted_dq[kMaxDevices];
  const int tiles = (Lk + BT - 1) / BT;  // key tiles
  if (fused && tiles > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;

  int rc = launch_delta<float>(o, dout, delta, bh * Lq, d, stream);
  if (rc != 0) return rc;

  const dim3 grid(bh, tiles);
  cudaError_t err;
  if (fused) {  // dq itself with one key tile, else shares summed into dq
    rc = opt_in(flash_bwd_dkdv_kernel<DMAX, BT, true, DROPOUT, BIAS>,
                opted_fused, C::SMEM_DKDV);
    if (rc != 0) return rc;
    flash_bwd_dkdv_kernel<DMAX, BT, true, DROPOUT, BIAS>
        <<<grid, C::NT, C::SMEM_DKDV, stream>>>(
            q, k, v, dout, lse, delta, tiles == 1 ? dq : partial, dk, dv, Lq,
            Lk, d, scale, dp, kb);
    err = cudaGetLastError();
    if (err != cudaSuccess || tiles == 1) return (int)err;
    return launch_dq_sum<float>(partial, dq, bh, Lq, d, tiles, stream);
  }
  rc = opt_in(flash_bwd_dkdv_kernel<DMAX, BT, false, DROPOUT, BIAS>, opted_dkdv,
              C::SMEM_DKDV);
  if (rc != 0) return rc;
  rc = opt_in(flash_bwd_dq_kernel<DMAX, BT, DROPOUT, BIAS>, opted_dq, C::SMEM_DQ);
  if (rc != 0) return rc;
  flash_bwd_dkdv_kernel<DMAX, BT, false, DROPOUT, BIAS>
      <<<grid, C::NT, C::SMEM_DKDV, stream>>>(
          q, k, v, dout, lse, delta, nullptr, dk, dv, Lq, Lk, d, scale, dp,
          kb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<DMAX, BT, DROPOUT, BIAS>
      <<<dim3(bh, (Lq + BT - 1) / BT), C::NT, C::SMEM_DQ, stream>>>(
          q, k, v, dout, lse, delta, dq, Lq, Lk, d, scale, dp, kb);
  return (int)cudaGetLastError();
}

template <bool DROPOUT, bool BIAS>
int launch_form(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta,
                float* partial, void* dq, void* dk, void* dv, int bh, int Lq,
                int Lk, int d, float scale, int tile, int fused,
                const DropoutParams& dp, const KeyBias& kb,
                cudaStream_t stream) {
  auto f = &launch<128, 64, DROPOUT, BIAS>;
  if (tile == 32)
    f = d <= 32 ? &launch<32, 32, DROPOUT, BIAS>
                : &launch<64, 32, DROPOUT, BIAS>;
  else if (d <= 32)
    f = &launch<32, 64, DROPOUT, BIAS>;
  else if (d <= 64)
    f = &launch<64, 64, DROPOUT, BIAS>;
  return f((const float*)q, (const float*)k, (const float*)v, (const float*)o,
           (const float*)dout, lse, delta, partial, (float*)dq, (float*)dk,
           (float*)dv, bh, Lq, Lk, d, scale, fused, dp, kb, stream);
}

// The bf16 forms: key tiles of BT keys walking query tiles of BQ; the
// two-kernel form's dQ in blocks of four warps (64 query rows) walking key
// tiles of 64 keys (32 at DMAX 128, where dQ's accumulators are twice as
// many).
template <int DMAX, int BT, int BQ, bool DROPOUT, bool BIAS>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                const bf16* dout, const float* lse, float* delta,
                float* partial, bf16* dq, bf16* dk, bf16* dv, int bh, int Lq,
                int Lk, int d, float scale, int fused, const DropoutParams& dp,
                const KeyBias& kb, cudaStream_t stream) {
  using C = Bf16Cfg<DMAX, BT, BQ>;
  constexpr int kDqWarps = 4, kDqKeys = DMAX > 64 ? 32 : 64;
  using CQ = Bf16DqCfg<DMAX, kDqWarps, kDqKeys>;
  static std::atomic<bool> opted_one[kMaxDevices], opted_fused[kMaxDevices],
      opted_kv[kMaxDevices], opted_dq[kMaxDevices];
  const int tiles = (Lk + BT - 1) / BT;  // key tiles
  if (fused && tiles > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;

  int rc = launch_delta<bf16>(o, dout, delta, bh * Lq, d, stream);
  if (rc != 0) return rc;

  const dim3 grid(bh, tiles);
  cudaError_t err;
  if (fused && tiles == 1) {  // dq itself
    auto kernel = flash_bwd_bf16_kv_kernel<bf16, DMAX, BT, BQ, true, DROPOUT, BIAS>;
    rc = opt_in(kernel, opted_one, C::SMEM);
    if (rc != 0) return rc;
    kernel<<<grid, C::NT, C::SMEM, stream>>>(q, k, v, dout, lse, delta, dq,
                                             dk, dv, Lq, Lk, d, scale, dp, kb);
    return (int)cudaGetLastError();
  }
  if (fused) {  // float32 shares, summed into dq in tile order
    auto kernel = flash_bwd_bf16_kv_kernel<float, DMAX, BT, BQ, true, DROPOUT,
                                           BIAS>;
    rc = opt_in(kernel, opted_fused, C::SMEM);
    if (rc != 0) return rc;
    kernel<<<grid, C::NT, C::SMEM, stream>>>(q, k, v, dout, lse, delta,
                                             partial, dk, dv, Lq, Lk, d, scale,
                                             dp, kb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return launch_dq_sum<bf16>(partial, dq, bh, Lq, d, tiles, stream);
  }
  auto kv = flash_bwd_bf16_kv_kernel<bf16, DMAX, BT, BQ, false, DROPOUT, BIAS>;
  auto dq_kernel = flash_bwd_bf16_dq_kernel<DMAX, kDqWarps, kDqKeys, DROPOUT,
                                            BIAS>;
  rc = opt_in(kv, opted_kv, C::SMEM);
  if (rc != 0) return rc;
  rc = opt_in(dq_kernel, opted_dq, CQ::SMEM);
  if (rc != 0) return rc;
  kv<<<grid, C::NT, C::SMEM, stream>>>(q, k, v, dout, lse, delta,
                                       (bf16*)nullptr, dk, dv, Lq, Lk, d,
                                       scale, dp, kb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<<<dim3(bh, (Lq + CQ::BQ - 1) / CQ::BQ), CQ::NT, CQ::SMEM, stream>>>(
      q, k, v, dout, lse, delta, dq, Lq, Lk, d, scale, dp, kb);
  return (int)cudaGetLastError();
}

// The bf16 forms by tile: 16 keys and queries (one warp, d <= 64) or 64 keys
// walking 64 queries (32 at d > 64, where dK and dV take twice the
// registers).
template <bool DROPOUT, bool BIAS>
int launch_form_bf16(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* delta, float* partial, void* dq, void* dk,
                     void* dv, int bh, int Lq, int Lk, int d, float scale,
                     int tile, int fused, const DropoutParams& dp,
                     const KeyBias& kb, cudaStream_t stream) {
  auto f = d <= 32   ? &launch_bf16<32, 64, 64, DROPOUT, BIAS>
           : d <= 64 ? &launch_bf16<64, 64, 64, DROPOUT, BIAS>
                     : &launch_bf16<128, 64, 32, DROPOUT, BIAS>;
  if (tile == 16)
    f = d <= 32 ? &launch_bf16<32, 16, 16, DROPOUT, BIAS>
                : &launch_bf16<64, 16, 16, DROPOUT, BIAS>;
  return f((const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
           (const bf16*)dout, lse, delta, partial, (bf16*)dq, (bf16*)dk,
           (bf16*)dv, bh, Lq, Lk, d, scale, fused, dp, kb, stream);
}

// The checks and the choice of form of both entries; BIAS picks the set of
// forms that this translation unit compiles.
template <bool BIAS>
int backward(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* delta, void* partial,
             void* dq, void* dk, void* dv, int bh, int Lq, int Lk, int d,
             float scale, int tile, int fused, int dropout,
             unsigned threshold, float keep_scale, unsigned long long seed,
             const unsigned* grid, int bf16_form,
             const KeyBias& kb, void* stream) {
  const bool ok = Lq >= 1 && Lk >= 1 &&
                  (bf16_form ? d >= 16 && d % 16 == 0 && d <= 128 &&
                                   (tile == 64 || (tile == 16 && d <= 64))
                             : d >= 8 && d % 8 == 0 && d <= 128 &&
                                   (tile == 64 || (tile == 32 && d <= 64)));
  if (!ok || (BIAS && (kb.ptr == nullptr || kb.heads < 1 || bh % kb.heads)))
    return (int)cudaErrorInvalidValue;
  if (dropout && (grid[0] < 1 || bh % grid[0]))
    return (int)cudaErrorInvalidValue;
  const DropoutParams dp{threshold, keep_scale, (uint32_t)seed,
                         (uint32_t)(seed >> 32), grid[0], grid[1], grid[2],
                         grid[3], grid[4]};
  auto f = bf16_form ? (dropout ? &launch_form_bf16<true, BIAS>
                                : &launch_form_bf16<false, BIAS>)
                     : (dropout ? &launch_form<true, BIAS>
                                : &launch_form<false, BIAS>);
  return f(q, k, v, o, dout, (const float*)lse, (float*)delta,
           (float*)partial, dq, dk, dv, bh, Lq, Lk, d, scale, tile, fused, dp,
           kb, (cudaStream_t)stream);
}

// The checks of the wide entries: d past 128, a multiple of 8 (bf16: 16),
// tiles of 64.
template <bool BIAS>
int backward_wide(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const void* lse, void* delta,
                  void* partial, void* dq, void* dk, void* dv, int bh, int Lq,
                  int Lk, int d, float scale, int tile, int fused, int dropout,
                  unsigned threshold, float keep_scale,
                  unsigned long long seed, const unsigned* grid,
                  int bf16_form, const KeyBias& kb, void* stream) {
  const bool ok = Lq >= 1 && Lk >= 1 && d > 128 && tile == 64 &&
                  d % (bf16_form ? 16 : 8) == 0;
  if (!ok || (BIAS && (kb.ptr == nullptr || kb.heads < 1 || bh % kb.heads)))
    return (int)cudaErrorInvalidValue;
  if (dropout && (grid[0] < 1 || bh % grid[0]))
    return (int)cudaErrorInvalidValue;
  const DropoutParams dp{threshold, keep_scale, (uint32_t)seed,
                         (uint32_t)(seed >> 32), grid[0], grid[1], grid[2],
                         grid[3], grid[4]};
  auto f = d <= kWideMid   ? (dropout ? &launch_wide256<kWideMid, true, BIAS>
                                       : &launch_wide256<kWideMid, false, BIAS>)
           : d <= kWideMax ? (dropout ? &launch_wide256<kWideMax, true, BIAS>
                                       : &launch_wide256<kWideMax, false, BIAS>)
                           : (dropout ? &launch_wide<true, BIAS>
                                      : &launch_wide<false, BIAS>);
  return f(q, k, v, o, dout, (const float*)lse, (float*)delta,
           (float*)partial, dq, dk, dv, bh, Lq, Lk, d, scale, fused,
           bf16_form, dp, kb, (cudaStream_t)stream);
}

}  // namespace

// q, o, dout, dq: (bh, Lq, d) and k, v, dk, dv: (bh, Lk, d), contiguous,
// 16-byte aligned (Lq == Lk is self-attention; Lq < Lk a sequence-parallel
// rank's queries against the gathered keys); lse and the scratch delta:
// (bh, Lq) float32; `partial` float32. float32 (`bf16_form` == 0): d % 8 ==
// 0, d <= 128, `tile` (the tile height of queries and keys) 64, or 32 for d
// <= 64. bfloat16 (`bf16_form` != 0): d % 16 == 0, d <= 128, `tile` 64, or
// 16 for d <= 64. A wider d takes `flash_attn_bwd_wide`
// (flash_attn_bwd_wide.cu), with the same arguments. `fused` != 0 takes the
// one-pass form, which needs the scratch `partial` (bh, ceil(Lk / tile), Lq,
// d) when Lk > tile; `fused` == 0 the two-kernel form (`partial` unused).
// `dropout` != 0 takes the dropout form with the forward's `threshold`,
// `keep_scale`, `seed`, head grid (heads, total_heads, batch0, head0) and
// first global query row `row0` (flash_attn.cu). Returns the CUDA error of
// the launches.
#if !defined(DMC_FLASH_BIAS_FORMS) && !defined(DMC_FLASH_WIDE_FORMS)
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout, const void* lse,
                              void* delta, void* partial, void* dq, void* dk,
                              void* dv, int bh, int Lq, int Lk, int d,
                              float scale, int tile, int fused, int dropout,
                              unsigned threshold, float keep_scale,
                              unsigned long long seed, unsigned heads,
                              unsigned total_heads, unsigned batch0,
                              unsigned head0, unsigned row0, int bf16_form,
                              void* stream) {
  const unsigned grid[5] = {heads, total_heads, batch0, head0, row0};
  return backward<false>(q, k, v, o, dout, lse, delta, partial, dq, dk, dv, bh,
                         Lq, Lk, d, scale, tile, fused, dropout, threshold,
                         keep_scale, seed, grid, bf16_form,
                         KeyBias{nullptr, 1}, stream);
}
#elif !defined(DMC_FLASH_WIDE_FORMS)
// flash_attn_bwd with the forward's per-key bias (key_bias.cuh): float32
// (bh / bias_heads, Lk), row bh / bias_heads for head bh; `bias_heads`
// divides bh. lse is the forward's, which includes the bias.
extern "C" int flash_attn_bwd_bias(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* partial, void* dq,
                                   void* dk, void* dv, int bh, int Lq, int Lk,
                                   int d, float scale, int tile, int fused,
                                   int dropout, unsigned threshold,
                                   float keep_scale, unsigned long long seed,
                                   unsigned heads, unsigned total_heads,
                                   unsigned batch0, unsigned head0,
                                   unsigned row0, int bf16_form,
                                   const void* bias, int bias_heads,
                                   void* stream) {
  const unsigned grid[5] = {heads, total_heads, batch0, head0, row0};
  return backward<true>(q, k, v, o, dout, lse, delta, partial, dq, dk, dv, bh,
                        Lq, Lk, d, scale, tile, fused, dropout, threshold,
                        keep_scale, seed, grid, bf16_form,
                        KeyBias{(const float*)bias, bias_heads}, stream);
}
#elif !defined(DMC_FLASH_BIAS_FORMS)
// flash_attn_bwd's arguments at d > 128 (d % 8 == 0, bf16 d % 16 == 0;
// `tile` 64; `partial` (bh, ceil(Lk / 64), Lq, d) when fused and Lk > 64):
// the wide forms.
extern "C" int flash_attn_bwd_wide(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* partial, void* dq,
    void* dk, void* dv, int bh, int Lq, int Lk, int d, float scale, int tile,
    int fused, int dropout, unsigned threshold, float keep_scale,
    unsigned long long seed, unsigned heads, unsigned total_heads,
    unsigned batch0, unsigned head0, unsigned row0, int bf16_form,
    void* stream) {
  const unsigned grid[5] = {heads, total_heads, batch0, head0, row0};
  return backward_wide<false>(q, k, v, o, dout, lse, delta, partial, dq, dk,
                              dv, bh, Lq, Lk, d, scale, tile, fused, dropout,
                              threshold, keep_scale, seed, grid, bf16_form,
                              KeyBias{nullptr, 1}, stream);
}
#else
// flash_attn_bwd_bias's arguments at d > 128: the wide forms with the key
// bias.
extern "C" int flash_attn_bwd_wide_bias(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* partial, void* dq,
    void* dk, void* dv, int bh, int Lq, int Lk, int d, float scale, int tile,
    int fused, int dropout, unsigned threshold, float keep_scale,
    unsigned long long seed, unsigned heads, unsigned total_heads,
    unsigned batch0, unsigned head0, unsigned row0, int bf16_form,
    const void* bias, int bias_heads, void* stream) {
  const unsigned grid[5] = {heads, total_heads, batch0, head0, row0};
  return backward_wide<true>(q, k, v, o, dout, lse, delta, partial, dq, dk, dv,
                             bh, Lq, Lk, d, scale, tile, fused, dropout,
                             threshold, keep_scale, seed, grid, bf16_form,
                             KeyBias{(const float*)bias, bias_heads}, stream);
}
#endif
