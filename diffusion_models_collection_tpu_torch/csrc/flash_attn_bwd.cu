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
// zero-padded to DMAX of 32, 64 or 128.
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
// bf16 takes d % 16 == 0 (the mma's depth; the wrapper pads) up to 128.
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

// Request rows r0 .. r0 + BT - 1 of one head's (L, d) matrix into a
// (BT, DMAX + 4) tile by cp.async, zero past L and past d (d % 4 == 0).
template <int DMAX, int BT>
__device__ __forceinline__ void request_tile(float* dst,
                                             const float* __restrict__ src,
                                             int r0, int L, int d, int tid) {
  using C = Cfg<DMAX, BT>;
  constexpr int V = DMAX / 4;  // pieces of a row
  for (int i = tid; i < BT * V; i += C::NT) {
    const int r = i / V;
    const int c = (i - r * V) * 4;
    const bool ok = r0 + r < L && c < d;
    cp_async16(dst + r * C::P + c, ok ? src + (size_t)(r0 + r) * d + c : src,
               ok);
  }
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

// S = Q K^T and dP = dO V^T of the current tiles (query rows from q0, keys
// from k0 of head bh), then P (stored when Ps is given; P o Z with DROPOUT)
// and dS into their (BT, BT + 4) tiles: rows ty + TX a, keys tx + TX b
template <int DMAX, int BT, bool DROPOUT, bool BIAS>
__device__ __forceinline__ void probs_tile(const float* Qs, const float* dOs,
                                           const float* Ks, const float* Vs,
                                           const float* lse_s, const float* dl_s,
                                           float* Ps, float* dSs, int ty, int tx,
                                           float scale, const DropoutParams& dp,
                                           const float* brow, int L, int bh,
                                           int q0, int k0) {
  using C = Cfg<DMAX, BT>;
  float s[4][4], dpv[4][4];
  rows_dot<DMAX, BT>(Qs, Ks, ty, tx, s);
  rows_dot<DMAX, BT>(dOs, Vs, ty, tx, dpv);
  float kbias[4] = {};  // the keys' bias (0 past L, where K = V = 0)
  if constexpr (BIAS) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      kbias[b] = key_bias_at(brow, k0 + tx + C::TX * b, L, 1.f);
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

// rows r0 + ty + TX a (< L) of `acc` into a head's (L, d) matrix at the
// thread's columns
template <int DMAX, int BT>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float acc[4][Cfg<DMAX, BT>::DC],
                                           int r0, int L, int d, int ty, int tx) {
  using C = Cfg<DMAX, BT>;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = r0 + ty + C::TX * a;
    if (row < L) {
#pragma unroll
      for (int g = 0; g < C::G; ++g) {
        const int c = C::VW * (tx + C::TX * g);
        if (c < d) store_vec<C::VW>(dst + (size_t)row * d + c, acc[a] + g * C::VW);
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
                      float* __restrict__ dv, int L, int d, float scale,
                      DropoutParams dp, KeyBias kb) {
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
  const size_t head = (size_t)bh * L * d;
  const size_t base = (size_t)bh * L;
  const float* brow = BIAS ? key_bias_row(kb, bh, L) : nullptr;

  request_tile<DMAX, BT>(Ks, k + head, k0, L, d, tid);
  request_tile<DMAX, BT>(Vs, v + head, k0, L, d, tid);
  request_tile<DMAX, BT>(Qs, q + head, 0, L, d, tid);
  request_tile<DMAX, BT>(dOs, dout + head, 0, L, d, tid);
  load_row_stats<BT>(lse_s, dl_s, lse, delta, base, 0, L, tid);

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
    dq_head = dq_out + ((size_t)bh * gridDim.y + blockIdx.y) * L * d;

  for (int q0 = 0; q0 < L; q0 += BT) {
    cp_async_wait_all();
    __syncthreads();  // the tiles and row stats are in; dSs is read

    probs_tile<DMAX, BT, DROPOUT, BIAS>(Qs, dOs, Ks, Vs, lse_s, dl_s, Ps, dSs,
                                        ty, tx, scale, dp, brow, L, bh, q0, k0);
    __syncthreads();

    // dV_j += sum_r P[r, j] dO[r, :],  dK_j += sum_r dS[r, j] Q[r, :]
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
    __syncthreads();  // Qs, dOs and the row stats are read

    if (q0 + BT < L) {  // the next tiles fly during the dQ product
      request_tile<DMAX, BT>(Qs, q + head, q0 + BT, L, d, tid);
      request_tile<DMAX, BT>(dOs, dout + head, q0 + BT, L, d, tid);
      load_row_stats<BT>(lse_s, dl_s, lse, delta, base, q0 + BT, L, tid);
    }
    if constexpr (WITH_DQ) {
      float acc[4][C::DC];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < C::DC; ++b) acc[a][b] = 0.f;
      dq_product<DMAX, BT>(dSs, Ks, ty, tx, acc);
      store_rows<DMAX, BT>(dq_head, acc, q0, L, d, ty, tx);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = k0 + 4 * ty + a;
    if (row < L) {
#pragma unroll
      for (int g = 0; g < C::G; ++g) {
        const int c = C::VW * (tx + C::TX * g);
        if (c < d) {
          store_vec<C::VW>(dk + head + (size_t)row * d + c, dk_acc[a] + g * C::VW);
          store_vec<C::VW>(dv + head + (size_t)row * d + c, dv_acc[a] + g * C::VW);
        }
      }
    }
  }
}

// The two-kernel form's dQ: one block per (head, query tile) walks the key
// tiles, recomputes dS and keeps dQ_i in registers.
template <int DMAX, int BT, bool DROPOUT, bool BIAS>
__global__ void __launch_bounds__(Cfg<DMAX, BT>::NT,
                                  (DMAX <= 64 && BT == 64) ? 2 : 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int L, int d, float scale,
                    DropoutParams dp, KeyBias kb) {
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
  const size_t head = (size_t)bh * L * d;
  const float* brow = BIAS ? key_bias_row(kb, bh, L) : nullptr;

  request_tile<DMAX, BT>(Qs, q + head, q0, L, d, tid);
  request_tile<DMAX, BT>(dOs, dout + head, q0, L, d, tid);
  request_tile<DMAX, BT>(Kbuf, k + head, 0, L, d, tid);
  request_tile<DMAX, BT>(Vs, v + head, 0, L, d, tid);
  load_row_stats<BT>(lse_s, dl_s, lse, delta, (size_t)bh * L, q0, L, tid);

  // query rows q0 + ty + TX a, columns VW (tx + TX g) .. + VW - 1
  float acc[4][C::DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < C::DC; ++b) acc[a][b] = 0.f;

  int cur = 0;
  for (int k0 = 0; k0 < L; k0 += BT, cur ^= 1) {
    const float* Ks = Kbuf + cur * C::TILE;
    cp_async_wait_all();
    __syncthreads();  // the tiles are in; dSs and the other K tile are read

    probs_tile<DMAX, BT, DROPOUT, BIAS>(Qs, dOs, Ks, Vs, lse_s, dl_s, nullptr,
                                        dSs, ty, tx, scale, dp, brow, L, bh,
                                        q0, k0);
    __syncthreads();  // Vs is read

    if (k0 + BT < L) {  // the next tiles fly during the dQ product
      request_tile<DMAX, BT>(Kbuf + (cur ^ 1) * C::TILE, k + head, k0 + BT, L,
                             d, tid);
      request_tile<DMAX, BT>(Vs, v + head, k0 + BT, L, d, tid);
    }
    dq_product<DMAX, BT>(dSs, Ks, ty, tx, acc);
  }
  store_rows<DMAX, BT>(dq + head, acc, q0, L, d, ty, tx);
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
__device__ __forceinline__ void store_acc(T* __restrict__ dst,
                                          const float (&acc)[N][4], float scale,
                                          int r0, int n0, int L, int d,
                                          int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + (lane >> 2) + 8 * r;
    if (row >= L) continue;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int c = 8 * (n0 + n) + 2 * (lane & 3);
      if (c < d)
        store_pair(dst + (size_t)row * d + c, scale * acc[n][2 * r],
                   scale * acc[n][2 * r + 1]);
    }
  }
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
                         bf16* __restrict__ dv, int L, int d, float scale,
                         DropoutParams dp, KeyBias kb) {
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
  const bool live = k0 + kw < L;
  // P = 2^(S scale log2(e) - lse log2(e)), one ex2.approx an entry
  const float scale_log2 = scale * kLog2e;
  // the bias of the lane's two keys, base 2: the same for every query tile
  float kbias[2] = {};
  if constexpr (BIAS) {
    const float* brow = key_bias_row(kb, bh, L);
    kbias[0] = key_bias_at(brow, k0 + kw + g, L, kLog2e);
    kbias[1] = key_bias_at(brow, k0 + kw + g + 8, L, kLog2e);
  }
  const int steps = d >> 4;
  const size_t head = (size_t)bh * L * d;
  const size_t base = (size_t)bh * L;
  const int off_a = lane_off_a(lane, C::S);
  const int off_b = lane_off_b(lane, C::S);
  DQ* dq_head = nullptr;
  if constexpr (WITH_DQ)
    dq_head = dq_out + ((size_t)bh * gridDim.y + blockIdx.y) * L * d;

  request_bf16_rows<DMAX, BT, C::NT>(Ks, k + head, k0, L, d, tid);
  request_bf16_rows<DMAX, BT, C::NT>(Vs, v + head, k0, L, d, tid);
  request_bf16_rows<DMAX, BQ, C::NT>(Qb, q + head, 0, L, d, tid);
  request_bf16_rows<DMAX, BQ, C::NT>(dOb, dout + head, 0, L, d, tid);
  request_row_stats<BQ, C::NT>(stats, stats + 2 * BQ, lse, delta, base, 0, L,
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
  for (int q0 = 0, it = 0; q0 < L; q0 += BQ, ++it) {
    const int buf = it & 1;
    const bf16* Qs = Qb + buf * BQ * C::S;
    const bf16* dOs = dOb + buf * BQ * C::S;
    float* lse_s = stats + buf * BQ;
    const float* dl_s = stats + (2 + buf) * BQ;
    cp_async_wait_groups();
    base2_row_stats<BQ, C::NT>(lse_s, q0, L, tid);
    __syncthreads();  // this tile is in; every warp is past the last one
    if (q0 + BQ < L) {  // the next tile flies during this one's products
      const int nb = buf ^ 1;
      request_bf16_rows<DMAX, BQ, C::NT>(Qb + nb * BQ * C::S, q + head,
                                         q0 + BQ, L, d, tid);
      request_bf16_rows<DMAX, BQ, C::NT>(dOb + nb * BQ * C::S, dout + head,
                                         q0 + BQ, L, d, tid);
      request_row_stats<BQ, C::NT>(stats + nb * BQ, stats + (2 + nb) * BQ,
                                   lse, delta, base, q0 + BQ, L, tid);
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
      // P^T o Z into st and dS^T / scale into dpt, in float32 (the scale
      // multiplies dK and the dQ share once, at their stores; a query past L
      // has lse +inf, so P = 0)
#pragma unroll
      for (int j = 0; j < C::NB; ++j) {
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
      // dV += (P o Z)^T dO, dK += dS^T Q: both A operands from the
      // registers, split in hi + lo; dO and Q by ldmatrix.trans. dS^T goes
      // to shared memory too, for the dQ share.
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
        if (q0 + 16 * c >= L) continue;  // queries past L: P and dS are 0
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
    if constexpr (WITH_DQ) {
      __syncthreads();  // dS^T is whole
      // dQ_i share = dS K_j: dS query-major by ldmatrix.trans of dS^T, K by
      // ldmatrix.trans; query rows q0 + 16 rg .., d's n8 tiles part * NDW ..
      const int rg = warp % C::RG, part = warp / C::RG;
      const int off_sq = lane_off_b(lane, C::SQ);
      float acc[C::NDW][4];
#pragma unroll
      for (int n = 0; n < C::NDW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < C::NW; ++kc) {
        if (k0 + 16 * kc >= L) break;  // keys past L: no dS was written
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
      store_acc(dq_head, acc, scale, q0 + 16 * rg, part * C::NDW, L, d, lane);
    }
  }
  if (live) {
    store_acc(dk + head, dk_acc, scale, k0 + kw, 0, L, d, lane);
    store_acc(dv + head, dv_acc, 1.f, k0 + kw, 0, L, d, lane);
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

template <int DMAX, int NW, int BK, bool DROPOUT, bool BIAS>
__global__ void __launch_bounds__(32 * NW)
flash_bwd_bf16_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dq,
                         int L, int d, float scale, DropoutParams dp,
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
  const size_t head = (size_t)bh * L * d;
  const bf16* kh = k + head;
  const bf16* vh = v + head;
  const float* brow = BIAS ? key_bias_row(kb, bh, L) : nullptr;
  const int t = lane & 3;  // the lane's keys in an n8 tile: 2 t, 2 t + 1
  const int off_a = lane_off_a(lane, C::S);
  const int off_b = lane_off_b(lane, C::S);

  request_bf16_rows<DMAX, C::BQ, C::NT>(Qs, q + head, q0, L, d, tid);
  request_bf16_rows<DMAX, C::BQ, C::NT>(dOs, dout + head, q0, L, d, tid);
  request_bf16_rows<DMAX, BK, C::NT>(Kb, kh, 0, L, d, tid);
  request_bf16_rows<DMAX, BK, C::NT>(Vb, vh, 0, L, d, tid);
  cp_async_commit_group();

  // the rows' lse in base 2 (rows past L: +inf, so P = 0) and delta
  const float scale_log2 = scale * kLog2e;
  float lr[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    lr[r] = row < L ? kLog2e * lse[(size_t)bh * L + row] : INFINITY;
    dl[r] = row < L ? delta[(size_t)bh * L + row] : 0.f;
  }
  uint32_t qf[C::KD][4], dof[C::KD][4];
  float acc[C::ND][4];
#pragma unroll
  for (int n = 0; n < C::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int k0 = 0, it = 0; k0 < L; k0 += BK, ++it) {
    const bf16* Ks = Kb + (it & 1) * BK * C::S;
    const bf16* Vs = Vb + (it & 1) * BK * C::S;
    cp_async_wait_groups();
    __syncthreads();  // this tile is in; every warp is past the last one
    if (k0 + BK < L) {  // the next tile flies during this one's products
      request_bf16_rows<DMAX, BK, C::NT>(Kb + ((it + 1) & 1) * BK * C::S, kh,
                                         k0 + BK, L, d, tid);
      request_bf16_rows<DMAX, BK, C::NT>(Vb + ((it + 1) & 1) * BK * C::S, vh,
                                         k0 + BK, L, d, tid);
      cp_async_commit_group();
    }
    if (row0 >= L) continue;  // no real row: only the barriers
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
#pragma unroll
    for (int j = 0; j < C::NB; ++j) {
      // the bias of keys 8 j + 2 t and + 1, base 2
      float kbias[2] = {};
      if constexpr (BIAS) {
        kbias[0] = key_bias_at(brow, k0 + 8 * j + 2 * t, L, kLog2e);
        kbias[1] = key_bias_at(brow, k0 + 8 * j + 2 * t + 1, L, kLog2e);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a key past L has K = V = 0: its dS meets a zero K row below
        const float p = ex2_approx(fmaf(
            s[j][e], scale_log2,
            BIAS ? kbias[e & 1] - lr[e >> 1] : -lr[e >> 1]));
        float z = 1.f;
        if constexpr (DROPOUT)
          z = (keep >> (4 * j + e)) & 1u ? dp.keep_scale : 0.f;
        s[j][e] = p * ((DROPOUT ? dp_[j][e] * z : dp_[j][e]) - dl[e >> 1]);
      }
    }
#pragma unroll
    for (int c = 0; c < C::NB / 2; ++c) {
      if (k0 + 16 * c >= L) break;
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
  if (row0 < L) store_acc(dq + head, acc, scale, row0, 0, L, d, lane);
}

template <int DMAX, int BT, bool DROPOUT, bool BIAS>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* delta, float* partial,
           float* dq, float* dk, float* dv, int bh, int L, int d, float scale,
           int fused, const DropoutParams& dp, const KeyBias& kb,
           cudaStream_t stream) {
  using C = Cfg<DMAX, BT>;
  static std::atomic<bool> opted_fused[kMaxDevices], opted_dkdv[kMaxDevices],
      opted_dq[kMaxDevices];
  const int tiles = (L + BT - 1) / BT;
  if (fused && tiles > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;

  const int rows = bh * L;
  const int rows_per_block = kDeltaThreads / 32;
  flash_bwd_delta_kernel<float>
      <<<(rows + rows_per_block - 1) / rows_per_block, kDeltaThreads, 0,
         stream>>>(o, dout, delta, rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid(bh, tiles);
  if (fused) {  // dq itself with one key tile, else shares summed into dq
    int rc = opt_in(flash_bwd_dkdv_kernel<DMAX, BT, true, DROPOUT, BIAS>,
                    opted_fused, C::SMEM_DKDV);
    if (rc != 0) return rc;
    flash_bwd_dkdv_kernel<DMAX, BT, true, DROPOUT, BIAS>
        <<<grid, C::NT, C::SMEM_DKDV, stream>>>(
            q, k, v, dout, lse, delta, tiles == 1 ? dq : partial, dk, dv, L, d,
            scale, dp, kb);
    err = cudaGetLastError();
    if (err != cudaSuccess || tiles == 1) return (int)err;
    const size_t head4 = (size_t)L * d / 4;
    const size_t total4 = head4 * bh;
    flash_bwd_dq_sum_kernel<float>
        <<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
            (const float4*)partial, dq, head4, tiles, total4);
    return (int)cudaGetLastError();
  }
  int rc = opt_in(flash_bwd_dkdv_kernel<DMAX, BT, false, DROPOUT, BIAS>, opted_dkdv,
                  C::SMEM_DKDV);
  if (rc != 0) return rc;
  rc = opt_in(flash_bwd_dq_kernel<DMAX, BT, DROPOUT, BIAS>, opted_dq, C::SMEM_DQ);
  if (rc != 0) return rc;
  flash_bwd_dkdv_kernel<DMAX, BT, false, DROPOUT, BIAS>
      <<<grid, C::NT, C::SMEM_DKDV, stream>>>(
          q, k, v, dout, lse, delta, nullptr, dk, dv, L, d, scale, dp, kb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<DMAX, BT, DROPOUT, BIAS><<<grid, C::NT, C::SMEM_DQ, stream>>>(
      q, k, v, dout, lse, delta, dq, L, d, scale, dp, kb);
  return (int)cudaGetLastError();
}

template <bool DROPOUT, bool BIAS>
int launch_form(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta,
                float* partial, void* dq, void* dk, void* dv, int bh, int L,
                int d, float scale, int tile, int fused,
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
           (float*)dv, bh, L, d, scale, fused, dp, kb, stream);
}

// The bf16 forms: key tiles of BT keys walking query tiles of BQ; the
// two-kernel form's dQ in blocks of four warps (64 query rows) walking key
// tiles of 64 keys (32 at DMAX 128, where dQ's accumulators are twice as
// many).
template <int DMAX, int BT, int BQ, bool DROPOUT, bool BIAS>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                const bf16* dout, const float* lse, float* delta,
                float* partial, bf16* dq, bf16* dk, bf16* dv, int bh, int L,
                int d, float scale, int fused, const DropoutParams& dp,
                const KeyBias& kb, cudaStream_t stream) {
  using C = Bf16Cfg<DMAX, BT, BQ>;
  constexpr int kDqWarps = 4, kDqKeys = DMAX > 64 ? 32 : 64;
  using CQ = Bf16DqCfg<DMAX, kDqWarps, kDqKeys>;
  static std::atomic<bool> opted_one[kMaxDevices], opted_fused[kMaxDevices],
      opted_kv[kMaxDevices], opted_dq[kMaxDevices];
  const int tiles = (L + BT - 1) / BT;
  if (fused && tiles > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;

  const int rows = bh * L;
  const int rows_per_block = kDeltaThreads / 32;
  flash_bwd_delta_kernel<bf16>
      <<<(rows + rows_per_block - 1) / rows_per_block, kDeltaThreads, 0,
         stream>>>(o, dout, delta, rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid(bh, tiles);
  if (fused && tiles == 1) {  // dq itself
    auto kernel = flash_bwd_bf16_kv_kernel<bf16, DMAX, BT, BQ, true, DROPOUT, BIAS>;
    const int rc = opt_in(kernel, opted_one, C::SMEM);
    if (rc != 0) return rc;
    kernel<<<grid, C::NT, C::SMEM, stream>>>(q, k, v, dout, lse, delta, dq,
                                             dk, dv, L, d, scale, dp, kb);
    return (int)cudaGetLastError();
  }
  if (fused) {  // float32 shares, summed into dq in tile order
    auto kernel = flash_bwd_bf16_kv_kernel<float, DMAX, BT, BQ, true, DROPOUT,
                                           BIAS>;
    const int rc = opt_in(kernel, opted_fused, C::SMEM);
    if (rc != 0) return rc;
    kernel<<<grid, C::NT, C::SMEM, stream>>>(q, k, v, dout, lse, delta,
                                             partial, dk, dv, L, d, scale, dp,
                                             kb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t head4 = (size_t)L * d / 4;
    const size_t total4 = head4 * bh;
    flash_bwd_dq_sum_kernel<bf16>
        <<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
            (const float4*)partial, dq, head4, tiles, total4);
    return (int)cudaGetLastError();
  }
  auto kv = flash_bwd_bf16_kv_kernel<bf16, DMAX, BT, BQ, false, DROPOUT, BIAS>;
  auto dq_kernel = flash_bwd_bf16_dq_kernel<DMAX, kDqWarps, kDqKeys, DROPOUT,
                                            BIAS>;
  int rc = opt_in(kv, opted_kv, C::SMEM);
  if (rc != 0) return rc;
  rc = opt_in(dq_kernel, opted_dq, CQ::SMEM);
  if (rc != 0) return rc;
  kv<<<grid, C::NT, C::SMEM, stream>>>(q, k, v, dout, lse, delta,
                                       (bf16*)nullptr, dk, dv, L, d, scale, dp,
                                       kb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<<<dim3(bh, (L + CQ::BQ - 1) / CQ::BQ), CQ::NT, CQ::SMEM, stream>>>(
      q, k, v, dout, lse, delta, dq, L, d, scale, dp, kb);
  return (int)cudaGetLastError();
}

// The bf16 forms by tile: 16 keys and queries (one warp, d <= 64) or 64 keys
// walking 64 queries (32 at d > 64, where dK and dV take twice the
// registers).
template <bool DROPOUT, bool BIAS>
int launch_form_bf16(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* delta, float* partial, void* dq, void* dk,
                     void* dv, int bh, int L, int d, float scale, int tile,
                     int fused, const DropoutParams& dp, const KeyBias& kb,
                     cudaStream_t stream) {
  auto f = d <= 32   ? &launch_bf16<32, 64, 64, DROPOUT, BIAS>
           : d <= 64 ? &launch_bf16<64, 64, 64, DROPOUT, BIAS>
                     : &launch_bf16<128, 64, 32, DROPOUT, BIAS>;
  if (tile == 16)
    f = d <= 32 ? &launch_bf16<32, 16, 16, DROPOUT, BIAS>
                : &launch_bf16<64, 16, 16, DROPOUT, BIAS>;
  return f((const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
           (const bf16*)dout, lse, delta, partial, (bf16*)dq, (bf16*)dk,
           (bf16*)dv, bh, L, d, scale, fused, dp, kb, stream);
}

// The checks and the choice of form of both entries; BIAS picks the set of
// forms that this translation unit compiles.
template <bool BIAS>
int backward(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* delta, void* partial,
             void* dq, void* dk, void* dv, int bh, int L, int d, float scale,
             int tile, int fused, int dropout, unsigned threshold,
             float keep_scale, unsigned long long seed, int bf16_form,
             const KeyBias& kb, void* stream) {
  const bool ok = bf16_form ? d >= 16 && d % 16 == 0 && d <= 128 &&
                                  (tile == 64 || (tile == 16 && d <= 64))
                            : d >= 8 && d % 8 == 0 && d <= 128 &&
                                  (tile == 64 || (tile == 32 && d <= 64));
  if (!ok || (BIAS && (kb.ptr == nullptr || kb.heads < 1 || bh % kb.heads)))
    return (int)cudaErrorInvalidValue;
  const DropoutParams dp{threshold, keep_scale, (uint32_t)seed,
                         (uint32_t)(seed >> 32)};
  auto f = bf16_form ? (dropout ? &launch_form_bf16<true, BIAS>
                                : &launch_form_bf16<false, BIAS>)
                     : (dropout ? &launch_form<true, BIAS>
                                : &launch_form<false, BIAS>);
  return f(q, k, v, o, dout, (const float*)lse, (float*)delta,
           (float*)partial, dq, dk, dv, bh, L, d, scale, tile, fused, dp, kb,
           (cudaStream_t)stream);
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (bh, L, d), contiguous, 16-byte aligned;
// lse and the scratch delta: (bh, L) float32; `partial` float32. float32
// (`bf16_form` == 0): d % 8 == 0, d <= 128, `tile` (the tile height) 64, or
// 32 for d <= 64. bfloat16 (`bf16_form` != 0): d % 16 == 0, d <= 128,
// `tile` 64, or 16 for d <= 64. `fused` != 0 takes the one-pass form, which
// needs the scratch `partial` (bh, ceil(L / tile), L, d) when L > tile;
// `fused` == 0 the two-kernel form (`partial` unused). `dropout` != 0 takes the dropout
// form with the forward's `threshold`, `keep_scale` and `seed`
// (flash_attn.cu). Returns the CUDA error of the launches.
#ifndef DMC_FLASH_BIAS_FORMS
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout, const void* lse,
                              void* delta, void* partial, void* dq, void* dk,
                              void* dv, int bh, int L, int d, float scale,
                              int tile, int fused, int dropout,
                              unsigned threshold, float keep_scale,
                              unsigned long long seed, int bf16_form,
                              void* stream) {
  return backward<false>(q, k, v, o, dout, lse, delta, partial, dq, dk, dv, bh,
                         L, d, scale, tile, fused, dropout, threshold,
                         keep_scale, seed, bf16_form, KeyBias{nullptr, 1},
                         stream);
}
#else
// flash_attn_bwd with the forward's per-key bias (key_bias.cuh): float32
// (bh / heads, L), row bh / heads for head bh; `heads` divides bh. lse is the
// forward's, which includes the bias.
extern "C" int flash_attn_bwd_bias(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* partial, void* dq,
                                   void* dk, void* dv, int bh, int L, int d,
                                   float scale, int tile, int fused,
                                   int dropout, unsigned threshold,
                                   float keep_scale, unsigned long long seed,
                                   int bf16_form, const void* bias, int heads,
                                   void* stream) {
  return backward<true>(q, k, v, o, dout, lse, delta, partial, dq, dk, dv, bh,
                        L, d, scale, tile, fused, dropout, threshold,
                        keep_scale, seed, bf16_form,
                        KeyBias{(const float*)bias, heads}, stream);
}
#endif
