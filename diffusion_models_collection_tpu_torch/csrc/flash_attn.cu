// Flash-attention forward on (BH, L, d) float32 or bfloat16 q, k, v: o =
// softmax(q k^T / sqrt(d)) v and the float32 row logsumexp lse =
// log(sum(exp(q k^T / sqrt(d)))), (BH, L). The backward (flash_attn_bwd.cu)
// recomputes P from lse.
//
// Replaces diffusion_models_collection_tpu/ops/flash_attention.py:_fwd_kernel.
//
// What bounds it on an H100: in float32 without TF32 there are no tensor
// cores, so the two L x L x d products run on CUDA-core FMAs (67 TFLOP/s)
// with both operands in shared memory. A 16-byte shared load takes the
// shared-memory pipe four cycles a warp, an SM's FMA pipes retire four warp
// instructions a cycle, so the FMAs a thread gets out of each loaded float
// decide how close the products come to the FMA rate. What the design does:
// * One block per (head, query tile of BQ rows) walks the key tiles of BK
//   keys; a thread owns RA rows and KB keys of the scores and the same RA
//   rows of the output. Every operand is read with 16-byte shared loads from
//   row-major tiles whose row stride is padded by four floats (DMAX + 4,
//   BK + 4): rows stay 16-byte aligned and the eight lanes of a quarter
//   warp that read eight rows at one column hit disjoint banks. Q K^T reads
//   both operands along d (rows ty + TY a, keys tx + TX b); P V reads P along
//   the keys and V along the thread's own contiguous columns.
// * Three forms (`flash_attention.fwd_tile`). At d <= 64 and L > 64: 128
//   query rows, key tiles of 64, eight rows and eight keys a thread (128
//   threads, 254 registers, two blocks an SM): each loaded float feeds
//   eight FMAs, where the four-by-four form of the backward feeds four. At
//   d <= 64 and L <= 64: tiles of 32 rows and keys (64 threads), so a short
//   sequence does not compute mostly masked rows. At d > 64: tiles of 64,
//   four by four a thread (256 threads).
// * The scores stay in registers. The TX threads that share a row are
//   neighbouring lanes of one warp, so the row max is three or four
//   shuffles; the row sum stays a per-thread partial, rescaled with the
//   output, and is summed over the lanes once, at the end. The only
//   shared-memory pass of the probabilities is P as the A operand of P V: a
//   thread needs whole rows of P, which lie in the registers of TX threads,
//   and one 16-byte shared load brings four of them where a shuffle brings
//   one. A barrier a key tile orders P's stores before its loads.
// * The softmax runs in base 2: log2(e) is folded into the scale, so a
//   probability and a rescale factor are one ex2.approx each.
// * K and V arrive by cp.async (16 bytes, zero-filled past L and past d),
//   each into one buffer, staggered: V's tile is requested as Q K^T starts
//   and flies during it and the softmax; the next K tile is requested as P V
//   starts and flies during it. Two barriers a key tile, and shared memory
//   for Q, K, V and P alone (104 KB in the 128-row form).
// The (L, L) score matrix never reaches device memory. Rows and keys past L
// are masked, so any L >= 1 runs (the TPU kernel needed L % 128 == 0); any
// d % 8 == 0 up to 128 runs, zero-padded to DMAX of 32, 64 or 128, and any
// wider d in the wide forms (the section "head dimensions past 128").
// Dropout on the probabilities (the DiT's training attention; a template
// flag, so the form without it is unchanged): the running max and sum stay
// those of the undropped P, so lse is unchanged, and only the values that
// enter P V, where P is written to shared memory, are multiplied by keep / (1
// - p), keep from `philox.cuh`: o = (P o Z) V.
// A per-key additive bias (ToMe's proportional attention, key_bias.cuh; a
// template flag, so the forms without it are unchanged): log2(e) bias[key]
// joins each scaled score before the running max and sum, so lse includes it
// and the backward's P = exp(S scale + bias - lse) is the forward's. Keys
// past L are masked as before. These forms compile in flash_attn_bias.cu,
// which includes this file with DMC_FLASH_BIAS_FORMS defined.
// Measured on an H100 80GB HBM3 at 700 W (tools/profile_torch_kernels.py,
// from a CUDA graph): 0.29 ms a call at BH 640, L 256, d 64 against 0.36 for
// the four-by-four form and a bound of 0.16 ms (operations).
//
// bfloat16 (the models' mixed precision), a kernel of its own on the tensor
// cores. It replaces the same _fwd_kernel (flash_attention.py:65) under the
// casts of the bf16 policy: the JAX kernel upcasts bf16 q, k, v to float32,
// computes every product in float32 and returns q's type.
// What bounds it on an H100: the bytes. q, k, v and o in bf16 at 3.35 TB/s
// take 0.025 ms a call at BH 640, L 256, d 64; the products at the tensor
// cores' 989 TFLOP/s take 0.016 ms with the split below, which makes P V two
// products (1.5x the work of Q K^T and P V once). What the design does
// (bf16_mma.cuh has the fragment layouts):
// * mma.sync m16n8k16, bf16 operands, float32 accumulators. q, k and v are
//   bf16 already, so as operands they are exact, and S = Q K^T comes out in
//   float32 as in the float32 form. The scale and log2(e) multiply S in
//   float32 (never folded into Q, which would round it).
// * P is no bf16 value. Rounded once to bf16 it would leave an error of
//   1e-3 of o's largest value (50 times the 2e-5 the form is held to), so P
//   is split into hi = bf16(P) and lo = bf16(P - hi) and P V is two
//   products with one V fragment: |P - hi - lo| <= 2^-16 P, and o keeps
//   float32 accuracy. P comes from the accumulators: the C fragments of two
//   n8 score tiles are the A fragment of a k16 step, so P never leaves the
//   registers.
// * Each warp owns 16 query rows; a block of 1, 4 or 8 warps (16, 64 or 128
//   rows, `flash_attention.fwd_tile`) walks key tiles of 64 keys (16 in the
//   one-warp form, for L <= 16). The row max and sum are taken over a row's
//   four lanes by two shuffles; o accumulates in float32 and is rounded to
//   bf16 once, at its store; lse as in the float32 form.
// * Q, K and V sit in shared memory as bf16, rows padded by 16 bytes so
//   that ldmatrix is free of bank conflicts. Q's fragments are loaded once,
//   K's by ldmatrix, V's by ldmatrix.trans. K and V are double-buffered:
//   the next tile's cp.async copies fly during this tile's products, one
//   barrier a key tile.
// * Dropout: the accumulator layout gives a lane two neighbouring keys of
//   two rows, so lanes t and t ^ 1 share each Philox call; each is computed
//   once and one shuffle a key tile swaps the halves
//   (`dropout_keep_bits_rows`, philox.cuh).
// bf16 takes d % 16 == 0 (the mma's depth; the wrapper pads with zero
// columns) up to 128, past it the wide forms; warps whose rows all lie past L
// skip the products, and
// key blocks of 16 past L skip P V.
// Queries and keys of their own lengths (E6, no TPU counterpart: the JAX
// package's sequence-parallel attention is XLA's): q and o of Lq rows, k and
// v of Lk; every form walks Lq in query tiles and Lk in key tiles and masks
// each ragged tail on its own length. A sequence-parallel rank passes its
// Lq = L / S queries against the L keys gathered from every rank, and
// `row0`, its first query's global row, which keys the dropout mask
// (philox.cuh), so its rows draw the one-device mask.
// bf16 measured on an H100 80GB HBM3 at 700 W (tools/profile_torch_kernels.py
// --only bf16, from a CUDA graph): 0.110 ms a call at the DiT's sampling
// shape (BH 960, L 256, d 64) against 0.055 for PyTorch's flash kernel and a
// bound of 0.038 ms (bytes); 0.43 ms for the 11 calls of a UNet forward.

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
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

// Tile geometry: a block of BQ query rows walks the key tiles of BK keys, at
// a head dimension padded to DMAX; a thread owns RA rows and KB keys of the
// scores, and the same RA rows at DC columns of the output.
template <int DMAX, int BQ, int BK, int RA, int KB>
struct Cfg {
  static constexpr int TX = BK / KB;      // threads along the keys of a row
  static constexpr int TY = BQ / RA;      // threads along the rows
  static constexpr int NT = TX * TY;      // threads of a block
  static constexpr int P = DMAX + 4;      // row stride of the Q, K, V tiles
  static constexpr int SP = BK + 4;       // row stride of the P tile
  static constexpr int DC = DMAX / TX;    // columns of d a thread owns
  static constexpr int VW = DC >= 4 ? 4 : DC;  // floats per vector access
  static constexpr int G = DC / VW;       // vector groups per thread
  // Q, K, V and P
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)(BQ + 2 * BK) * P + (size_t)BQ * SP);
  // blocks an SM is asked to hold (the registers a thread may take follow)
  static constexpr int MIN_BLOCKS = NT == 128 ? 2 : 1;
  static_assert(32 % TX == 0, "the threads of a row share a warp");
  static_assert(DC % VW == 0 && (VW == 2 || VW == 4), "column ownership");
};

// 2^x on the exponential unit alone (relative error about 2e-7; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Request rows r0 .. r0 + ROWS - 1 of a matrix with rows ld apart into the
// (ROWS, DMAX + 4) tile `dst`, zero past L and past column ncols (ncols % 4
// == 0). A thread requests pieces tid, tid + NT, ...
template <int DMAX, int ROWS, int NT>
__device__ __forceinline__ void request_cols(float* dst,
                                             const float* __restrict__ src,
                                             int r0, int L, int ld, int ncols,
                                             int tid) {
  constexpr int V = DMAX / 4;  // pieces of a row
  for (int i = tid; i < ROWS * V; i += NT) {
    const int r = i / V;
    const int c = (i - r * V) * 4;
    const bool ok = r0 + r < L && c < ncols;
    cp_async16(dst + r * (DMAX + 4) + c,
               ok ? src + (size_t)(r0 + r) * ld + c : src, ok);
  }
}

// The same for one head's (L, d) matrix (d % 4 == 0).
template <int DMAX, int ROWS, int NT>
__device__ __forceinline__ void request_rows(float* dst,
                                             const float* __restrict__ src,
                                             int r0, int L, int d, int tid) {
  request_cols<DMAX, ROWS, NT>(dst, src, r0, L, d, d, tid);
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

// out[a][b] = Qs[row ty + TY a] . Ks[row tx + TX b] over the DMAX columns,
// four columns to a shared load
template <int DMAX, int BQ, int BK, int RA, int KB>
__device__ __forceinline__ void rows_dot(const float* Qs, const float* Ks,
                                         int ty, int tx, float (&out)[RA][KB]) {
  using C = Cfg<DMAX, BQ, BK, RA, KB>;
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < KB; ++b) out[a][b] = 0.f;
  const float* qp = Qs + ty * C::P;
  const float* kp = Ks + tx * C::P;
#pragma unroll 2
  for (int c = 0; c < DMAX; c += 4) {
    float4 kv[KB];
#pragma unroll
    for (int b = 0; b < KB; ++b)
      kv[b] = *reinterpret_cast<const float4*>(kp + b * C::TX * C::P + c);
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const float4 qv =
          *reinterpret_cast<const float4*>(qp + a * C::TY * C::P + c);
#pragma unroll
      for (int b = 0; b < KB; ++b) {
        float s = out[a][b];
        s = fmaf(qv.x, kv[b].x, s);
        s = fmaf(qv.y, kv[b].y, s);
        s = fmaf(qv.z, kv[b].z, s);
        s = fmaf(qv.w, kv[b].w, s);
        out[a][b] = s;
      }
    }
  }
}

// acc[a][.] += sum_j P[row ty + TY a][j] V[j][the thread's columns]
template <int DMAX, int BQ, int BK, int RA, int KB>
__device__ __forceinline__ void pv_product(
    const float* Ps, const float* Vs, int ty, int tx,
    float (&acc)[RA][Cfg<DMAX, BQ, BK, RA, KB>::DC]) {
  using C = Cfg<DMAX, BQ, BK, RA, KB>;
#pragma unroll 2
  for (int j = 0; j < BK; j += 4) {
    float pv[RA][4];
#pragma unroll
    for (int a = 0; a < RA; ++a)
      load_vec<4>(pv[a], Ps + (ty + C::TY * a) * C::SP + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float vv[C::DC];
#pragma unroll
      for (int g = 0; g < C::G; ++g)
        load_vec<C::VW>(vv + g * C::VW,
                        Vs + (j + jj) * C::P + C::VW * (tx + C::TX * g));
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int b = 0; b < C::DC; ++b)
          acc[a][b] = fmaf(pv[a][jj], vv[b], acc[a][b]);
    }
  }
}

// One key tile's online softmax: the scores s (rows q0 + ty + TY a, keys
// k0 + tx + TX b) scaled to base 2, biased and masked past Lk; the running
// max m, this thread's share of the running sum l and the output acc
// rescaled; P (with DROPOUT, P o Z) into the thread's entries of the P tile.
template <int DMAX, int BQ, int BK, int RA, int KB, bool DROPOUT, bool BIAS>
__device__ __forceinline__ void softmax_tile(
    float (&s)[RA][KB], float (&m)[RA], float (&l)[RA],
    float (&acc)[RA][Cfg<DMAX, BQ, BK, RA, KB>::DC], float* Ps,
    const float* brow, int bh, int q0, int k0, int Lk, int ty, int tx,
    float scale_log2, const DropoutParams& dp) {
  using C = Cfg<DMAX, BQ, BK, RA, KB>;
  float kbias[KB] = {};  // this thread's keys' bias, base 2
  if constexpr (BIAS) {
#pragma unroll
    for (int b = 0; b < KB; ++b)
      kbias[b] = key_bias_at(brow, k0 + tx + C::TX * b, Lk, kLog2e);
  }
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    float mx = -INFINITY;
#pragma unroll
    for (int b = 0; b < KB; ++b) {
      // key k0 (tx 0, b 0) is always real, so the row's max is finite
      s[a][b] = k0 + tx + C::TX * b < Lk
                    ? (BIAS ? fmaf(s[a][b], scale_log2, kbias[b])
                            : s[a][b] * scale_log2)
                    : -INFINITY;
      mx = fmaxf(mx, s[a][b]);
    }
#pragma unroll
    for (int off = C::TX / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m[a], mx);
    const float alpha = fast_exp2(m[a] - m_new);  // 0 on the first tile
    m[a] = m_new;
    l[a] *= alpha;
#pragma unroll
    for (int b = 0; b < C::DC; ++b) acc[a][b] *= alpha;
    float* prow = Ps + (ty + C::TY * a) * C::SP + tx;
    uint32_t keep = 0;
    if constexpr (DROPOUT)
      keep = dropout_keep_bits<C::TX, KB>(dp, bh, q0 + ty + C::TY * a, k0, tx);
#pragma unroll
    for (int b = 0; b < KB; ++b) {
      const float p = fast_exp2(s[a][b] - m_new);
      l[a] += p;
      if constexpr (DROPOUT)
        prow[C::TX * b] = (keep >> b) & 1u ? p * dp.keep_scale : 0.f;
      else
        prow[C::TX * b] = p;
    }
  }
}

// The rows q0 + ty + TY a (< Lq) of the output, divided by their sums, at
// the thread's columns below ncols of rows ld apart from `out`, and (where
// lse_row is given) their lse.
template <int DMAX, int BQ, int BK, int RA, int KB>
__device__ __forceinline__ void store_output(
    float (&acc)[RA][Cfg<DMAX, BQ, BK, RA, KB>::DC], const float (&m)[RA],
    const float (&l)[RA], float* __restrict__ out, float* __restrict__ lse_row,
    int q0, int Lq, int ld, int ncols, int ty, int tx) {
  using C = Cfg<DMAX, BQ, BK, RA, KB>;
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    float sum = l[a];
#pragma unroll
    for (int off = C::TX / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int row = q0 + ty + C::TY * a;
    if (row < Lq) {
      const float inv = 1.f / sum;
#pragma unroll
      for (int b = 0; b < C::DC; ++b) acc[a][b] *= inv;
#pragma unroll
      for (int g = 0; g < C::G; ++g) {
        const int c = C::VW * (tx + C::TX * g);
        if (c < ncols)
          store_vec<C::VW>(out + (size_t)row * ld + c, acc[a] + g * C::VW);
      }
      if (lse_row != nullptr && tx == 0)
        lse_row[row] = m[a] * kLn2 + logf(sum);
    }
  }
}

template <int DMAX, int BQ, int BK, int RA, int KB, bool DROPOUT, bool BIAS>
__global__ void __launch_bounds__(Cfg<DMAX, BQ, BK, RA, KB>::NT,
                                  Cfg<DMAX, BQ, BK, RA, KB>::MIN_BLOCKS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Lq, int Lk, int d,
                 float scale_log2, DropoutParams dp, KeyBias kb) {
  using C = Cfg<DMAX, BQ, BK, RA, KB>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * C::P;
  float* Vs = Ks + BK * C::P;
  float* Ps = Vs + BK * C::P;  // probabilities, (BQ, BK + 4)

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % C::TX;
  const int ty = tid / C::TX;
  const size_t head = (size_t)bh * Lq * d;  // q and o
  const float* kh = k + (size_t)bh * Lk * d;
  const float* vh = v + (size_t)bh * Lk * d;
  const float* brow = BIAS ? key_bias_row(kb, bh, Lk) : nullptr;

  request_rows<DMAX, BQ, C::NT>(Qs, q + head, q0, Lq, d, tid);
  request_rows<DMAX, BK, C::NT>(Ks, kh, 0, Lk, d, tid);
  cp_async_commit();

  // rows q0 + ty + TY a: the output at columns VW (tx + TX g) .. + VW - 1,
  // the running max (base 2, the same in the row's TX lanes) and this
  // thread's share of the running sum
  float acc[RA][C::DC], m[RA], l[RA];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int b = 0; b < C::DC; ++b) acc[a][b] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    cp_async_wait_all();
    __syncthreads();  // this K tile is in; every thread is past the last P V
    // V flies during Q K^T and the softmax
    request_rows<DMAX, BK, C::NT>(Vs, vh, k0, Lk, d, tid);
    cp_async_commit();

    float s[RA][KB];
    rows_dot<DMAX, BQ, BK, RA, KB>(Qs, Ks, ty, tx, s);
    softmax_tile<DMAX, BQ, BK, RA, KB, DROPOUT, BIAS>(
        s, m, l, acc, Ps, brow, bh, q0, k0, Lk, ty, tx, scale_log2, dp);
    cp_async_wait_all();
    __syncthreads();  // P is whole and V is in; the K tile is read
    if (k0 + BK < Lk) {  // the next K tile flies during P V
      request_rows<DMAX, BK, C::NT>(Ks, kh, k0 + BK, Lk, d, tid);
      cp_async_commit();
    }
    pv_product<DMAX, BQ, BK, RA, KB>(Ps, Vs, ty, tx, acc);
  }
  store_output<DMAX, BQ, BK, RA, KB>(acc, m, l, o + head, lse + (size_t)bh * Lq,
                                     q0, Lq, d, d, ty, tx);
}

// The bf16 form's geometry: NW warps of 16 query rows each (BQ rows a
// block) walk the key tiles of BK keys at a head dimension padded to DMAX.
template <int DMAX, int NW, int BK>
struct Bf16Cfg {
  static constexpr int BQ = 16 * NW;
  static constexpr int NT = 32 * NW;
  static constexpr int S = DMAX + 8;    // row stride of the bf16 tiles
  static constexpr int KD = DMAX / 16;  // k16 steps of Q K^T
  static constexpr int NB = BK / 8;     // n8 tiles of the scores
  static constexpr int ND = DMAX / 8;   // n8 tiles of the output
  // Q, two K tiles and two V tiles
  static constexpr size_t SMEM = sizeof(bf16) * (size_t)(BQ + 4 * BK) * S;
  static_assert(BK % 16 == 0 && DMAX % 16 == 0 && NB <= 8, "tile shape");
};

// One key tile's online softmax in the accumulator layout (a lane's rows g
// and g + 8, keys k0 + 8 j + 2 t and + 1 of n8 tile j < NB): S scaled to base
// 2 in float32, biased and masked past Lk; the running max m (the same in a
// row's four lanes: two shuffles), this lane's share of the running sum l and
// the output acc rescaled; s left holding P (with DROPOUT, P o Z by the
// keep bits).
template <int NB, int ND, bool DROPOUT, bool BIAS>
__device__ __forceinline__ void softmax_bf16_tile(
    float (&s)[NB][4], float (&m)[2], float (&l)[2], float (&acc)[ND][4],
    uint32_t keep, const float* brow, int k0, int Lk, int t, float scale_log2,
    const DropoutParams& dp) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
  if constexpr (BIAS) {  // keys 8 j + 2 t and + 1 of both rows
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float b = key_bias_at(brow, k0 + 8 * j + 2 * t + c, Lk, kLog2e);
        s[j][c] += b;
        s[j][c + 2] += b;
      }
  }
  if (k0 + 8 * NB > Lk) {  // keys past Lk (only in the last tile) weigh nothing
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + 2 * t + (e & 1) >= Lk) s[j][e] = -INFINITY;
  }
  // key k0 (t 0, j 0, e 0) is always real, so a row's max is finite
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    const float alpha = ex2_approx(m[r] - m_new);  // 0 on the first tile
    m[r] = m_new;
    l[r] *= alpha;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][2 * r] *= alpha;
      acc[n][2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2_approx(s[j][e] - m[e >> 1]);
      l[e >> 1] += p;
      if constexpr (DROPOUT)
        s[j][e] = (keep >> (4 * j + e)) & 1u ? p * dp.keep_scale : 0.f;
      else
        s[j][e] = p;
    }
}

// The warp's rows row0 + g and + 8 (< Lq) of the output, divided by their
// sums and rounded to bf16 once, at the columns below ncols of rows ld apart
// from `out`, and (where lse_row is given) their lse.
template <int ND>
__device__ __forceinline__ void store_output_bf16(
    const float (&acc)[ND][4], const float (&m)[2], const float (&l)[2],
    bf16* __restrict__ out, float* __restrict__ lse_row, int row0, int Lq,
    int ld, int ncols, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = row0 + (lane >> 2) + 8 * r;
    if (row < Lq) {
      const float inv = 1.f / sum;
      bf16* orow = out + (size_t)row * ld;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int c = 8 * n + 2 * t;
        if (c < ncols)  // o is rounded to bf16 here, once
          *reinterpret_cast<uint32_t*>(orow + c) =
              pack_bf16x2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
      }
      if (lse_row != nullptr && t == 0) lse_row[row] = m[r] * kLn2 + logf(sum);
    }
  }
}

template <int DMAX, int NW, int BK, bool DROPOUT, bool BIAS>
__global__ void __launch_bounds__(32 * NW)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int Lq, int Lk, int d,
                      float scale_log2, DropoutParams dp, KeyBias kb) {
  using C = Bf16Cfg<DMAX, NW, BK>;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_bf16);
  bf16* Kb = Qs + C::BQ * C::S;  // K tiles: buffer (tile index & 1)
  bf16* Vb = Kb + 2 * BK * C::S;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * C::BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int row0 = q0 + 16 * warp;  // the warp's rows: row0 + g, row0 + g + 8
  const int steps = d >> 4;         // k16 steps (and 16-column blocks) of d
  const size_t head = (size_t)bh * Lq * d;  // q and o
  const bf16* kh = k + (size_t)bh * Lk * d;
  const bf16* vh = v + (size_t)bh * Lk * d;
  const float* brow = BIAS ? key_bias_row(kb, bh, Lk) : nullptr;
  const int off_a = lane_off_a(lane, C::S);
  const int off_b = lane_off_b(lane, C::S);

  request_bf16_rows<DMAX, C::BQ, C::NT>(Qs, q + head, q0, Lq, d, tid);
  request_bf16_rows<DMAX, BK, C::NT>(Kb, kh, 0, Lk, d, tid);
  request_bf16_rows<DMAX, BK, C::NT>(Vb, vh, 0, Lk, d, tid);
  cp_async_commit_group();

  // rows g and g + 8: Q's A fragments, the output's accumulators, the
  // running max (base 2, the same in the row's four lanes) and this lane's
  // share of the running sum
  uint32_t qf[C::KD][4];
  float acc[C::ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
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
      for (int kk = 0; kk < C::KD; ++kk)
        ldmatrix_x4(qf[kk], Qs + 16 * warp * C::S + 16 * kk + off_a);
    }

    // the dropout's keep bits first: Philox's integer work does not wait on
    // the products
    uint32_t keep = 0;
    if constexpr (DROPOUT)
      keep = dropout_keep_bits_rows<C::NB>(dp, bh, row0, k0, lane);

    // S = Q K^T from exact bf16 operands, float32 sums
    float s[C::NB][4];
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk) {
      if (kk < steps) {
#pragma unroll
        for (int jj = 0; jj < C::NB / 2; ++jj) {
          uint32_t b[4];
          ldmatrix_x4(b, Ks + 16 * jj * C::S + 16 * kk + off_b);
          mma_bf16(s[2 * jj], qf[kk], b[0], b[1]);
          mma_bf16(s[2 * jj + 1], qf[kk], b[2], b[3]);
        }
      }
    }

    // online softmax in base 2, the scale applied to S in float32
    softmax_bf16_tile<C::NB, C::ND, DROPOUT, BIAS>(s, m, l, acc, keep, brow,
                                                   k0, Lk, t, scale_log2, dp);

    // O += (P o Z) V: P from the accumulators, split in hi + lo, against
    // V's fragments by ldmatrix.trans
#pragma unroll
    for (int c = 0; c < C::NB / 2; ++c) {
      if (k0 + 16 * c >= Lk) break;  // keys past Lk: P is 0
      uint32_t hi[4], lo[4];
      split_a(s[2 * c], s[2 * c + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < C::KD; ++np) {
        if (np < steps) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, Vs + 16 * c * C::S + 16 * np + off_a);
          mma_bf16_split(acc[2 * np], hi, lo, b[0], b[1]);
          mma_bf16_split(acc[2 * np + 1], hi, lo, b[2], b[3]);
        }
      }
    }
  }
  if (row0 >= Lq) return;
  store_output_bf16<C::ND>(acc, m, l, o + head, lse + (size_t)bh * Lq, row0,
                           Lq, d, d, lane);
}

// ------------------------------------------------ head dimensions past 128
// The wide forms (entries `flash_attn_fwd_wide`, `flash_attn_fwd_wide_bias`,
// compiled in flash_attn_wide.cu and flash_attn_wide_bias.cu so that the
// forms up to 128 stay as they were). Up to 256 the one-block forms below
// this section run; the chunked forms here take d past 256. A block owns one
// block of output columns (blockIdx.z, c0 = z kWideOutF32 in float32, z
// kWideCols in bf16) of one (head, query tile of 64). For each key tile it
// sums S = Q K^T over all of d, 128 columns at a time through single Q and
// K tiles in shared memory, then runs the online softmax and P V over its
// own columns of V, which arrive with the first chunk. Every column block of
// a row computes the same S, P and dropout mask (the mask is a function of
// (seed, head, row, key), with no column in it), so they agree on the
// running max and sum; block 0 writes lse. The float32 form keeps the
// geometry of the d <= 128 form at DMAX 128 for S (64 rows, key tiles of
// 64, four by four a thread) and owns 256 output columns, 16 a thread; the
// bf16 form keeps that of its DMAX 128 form (four warps of 16 rows, key
// tiles of 64; 128 output columns, whose accumulators take 64 registers a
// lane), with Q's fragments loaded from shared memory for each chunk. Every chunk waits for its
// copies (no double buffering), and Q is read again for every key tile.
// What bounds it on an H100: as the forms up to 128 (float32 the CUDA-core
// FMAs, bf16 the bytes and the instructions around the products), plus the
// barriers and the waits of the chunk loop and Q read ceil(L / 64) times.
constexpr int kWideOutF32 = 256;

// Shared memory of the float32 wide form: the Q and K chunk tiles, the V
// tile of the block's output columns and P.
constexpr size_t kWideF32Smem =
    sizeof(float) * ((size_t)2 * 64 * (kWideCols + 4) +
                     (size_t)64 * (kWideOutF32 + 4) + (size_t)64 * (64 + 4));

template <bool DROPOUT, bool BIAS>
__global__ void __launch_bounds__(256, 1)
flash_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int Lq, int Lk, int d,
                      float scale_log2, DropoutParams dp, KeyBias kb) {
  constexpr int BQ = 64, BK = 64, RA = 4, KB = 4;
  using C = Cfg<kWideCols, BQ, BK, RA, KB>;     // the Q, K chunk tiles
  using CO = Cfg<kWideOutF32, BQ, BK, RA, KB>;  // V, P and the output
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * C::P;
  float* Vs = Ks + BK * C::P;
  float* Ps = Vs + BK * CO::P;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int c0 = blockIdx.z * kWideOutF32;  // the block's output columns
  const int tid = threadIdx.x;
  const int tx = tid % C::TX;
  const int ty = tid / C::TX;
  const float* qh = q + (size_t)bh * Lq * d;
  const float* kh = k + (size_t)bh * Lk * d;
  const float* vh = v + (size_t)bh * Lk * d;
  const float* brow = BIAS ? key_bias_row(kb, bh, Lk) : nullptr;

  float acc[RA][CO::DC], m[RA], l[RA];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int b = 0; b < CO::DC; ++b) acc[a][b] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    float s[RA][KB] = {};
    for (int c = 0; c < d; c += kWideCols) {
      __syncthreads();  // every thread is past its reads of the tiles
      request_cols<kWideCols, BQ, C::NT>(Qs, qh + c, q0, Lq, d, d - c, tid);
      request_cols<kWideCols, BK, C::NT>(Ks, kh + c, k0, Lk, d, d - c, tid);
      if (c == 0)
        request_cols<kWideOutF32, BK, C::NT>(Vs, vh + c0, k0, Lk, d, d - c0,
                                             tid);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      float part[RA][KB];
      rows_dot<kWideCols, BQ, BK, RA, KB>(Qs, Ks, ty, tx, part);
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int b = 0; b < KB; ++b) s[a][b] += part[a][b];
    }
    softmax_tile<kWideOutF32, BQ, BK, RA, KB, DROPOUT, BIAS>(
        s, m, l, acc, Ps, brow, bh, q0, k0, Lk, ty, tx, scale_log2, dp);
    __syncthreads();  // P is whole
    pv_product<kWideOutF32, BQ, BK, RA, KB>(Ps, Vs, ty, tx, acc);
  }
  store_output<kWideOutF32, BQ, BK, RA, KB>(
      acc, m, l, o + (size_t)bh * Lq * d + c0,
      blockIdx.z == 0 ? lse + (size_t)bh * Lq : nullptr, q0, Lq, d, d - c0, ty,
      tx);
}

template <bool DROPOUT, bool BIAS>
__global__ void __launch_bounds__(128)
flash_fwd_bf16_wide_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           float* __restrict__ lse, int Lq, int Lk, int d,
                           float scale_log2, DropoutParams dp, KeyBias kb) {
  using C = Bf16Cfg<kWideCols, 4, 64>;
  constexpr int BK = 64;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_bf16);
  bf16* Ks = Qs + C::BQ * C::S;
  bf16* Vs = Ks + BK * C::S;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * C::BQ;
  const int c0 = blockIdx.z * kWideCols;  // the block's output columns
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int row0 = q0 + 16 * warp;  // the warp's rows: row0 + g, row0 + g + 8
  const int vsteps = min(C::KD, (d - c0) >> 4);  // k16 steps of V's columns
  const bf16* qh = q + (size_t)bh * Lq * d;
  const bf16* kh = k + (size_t)bh * Lk * d;
  const bf16* vh = v + (size_t)bh * Lk * d;
  const float* brow = BIAS ? key_bias_row(kb, bh, Lk) : nullptr;
  const int off_a = lane_off_a(lane, C::S);
  const int off_b = lane_off_b(lane, C::S);

  float acc[C::ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < C::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    float s[C::NB][4] = {};
    for (int c = 0; c < d; c += kWideCols) {
      __syncthreads();  // every warp is past its reads of the tiles
      request_bf16_cols<kWideCols, C::BQ, C::NT>(Qs, qh + c, q0, Lq, d, d - c,
                                                 tid);
      request_bf16_cols<kWideCols, BK, C::NT>(Ks, kh + c, k0, Lk, d, d - c,
                                              tid);
      if (c == 0)
        request_bf16_cols<kWideCols, BK, C::NT>(Vs, vh + c0, k0, Lk, d,
                                                d - c0, tid);
      cp_async_commit_group();
      cp_async_wait_groups();
      __syncthreads();
      if (row0 >= Lq) continue;  // no real row: only the barriers
      const int steps = min(C::KD, (d - c) >> 4);
#pragma unroll
      for (int kk = 0; kk < C::KD; ++kk) {
        if (kk < steps) {
          uint32_t qf[4];
          ldmatrix_x4(qf, Qs + 16 * warp * C::S + 16 * kk + off_a);
#pragma unroll
          for (int jj = 0; jj < C::NB / 2; ++jj) {
            uint32_t b[4];
            ldmatrix_x4(b, Ks + 16 * jj * C::S + 16 * kk + off_b);
            mma_bf16(s[2 * jj], qf, b[0], b[1]);
            mma_bf16(s[2 * jj + 1], qf, b[2], b[3]);
          }
        }
      }
    }
    if (row0 >= Lq) continue;
    uint32_t keep = 0;
    if constexpr (DROPOUT)
      keep = dropout_keep_bits_rows<C::NB>(dp, bh, row0, k0, lane);
    softmax_bf16_tile<C::NB, C::ND, DROPOUT, BIAS>(s, m, l, acc, keep, brow,
                                                   k0, Lk, t, scale_log2, dp);
    // O += (P o Z) V over the block's columns of V
#pragma unroll
    for (int cc = 0; cc < C::NB / 2; ++cc) {
      if (k0 + 16 * cc >= Lk) break;  // keys past Lk: P is 0
      uint32_t hi[4], lo[4];
      split_a(s[2 * cc], s[2 * cc + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < C::KD; ++np) {
        if (np < vsteps) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, Vs + 16 * cc * C::S + 16 * np + off_a);
          mma_bf16_split(acc[2 * np], hi, lo, b[0], b[1]);
          mma_bf16_split(acc[2 * np + 1], hi, lo, b[2], b[3]);
        }
      }
    }
  }
  if (row0 >= Lq) return;
  store_output_bf16<C::ND>(acc, m, l, o + (size_t)bh * Lq * d + c0,
                           blockIdx.z == 0 ? lse + (size_t)bh * Lq : nullptr,
                           row0, Lq, d, d - c0, lane);
}

// ---------------------------- head dimensions past 128, up to 256: one block
// The wide forms up to kWideMax (256, the TPU kernel's widest head_dim).
// They replace the same _fwd_kernel (flash_attention.py:65) at those widths.
// A block owns every column of its query rows, so it computes S, the online
// softmax and the dropout mask once for each (query tile, key tile) pair,
// whatever d is; only P V runs over the columns. d is padded to DMAX 192
// (kWideMid, d <= 192: the DiT at two heads) or 256, so every loop over the
// columns has a fixed count and the accumulators of the narrower form take
// three quarters of the registers. Q is copied into shared memory once.
// * bfloat16: what bounds it on an H100 is the bytes and the instructions
//   around the tensor-core products (at BH 256, L 256, d 192: q, k, v, o
//   take 0.030 ms at 3.35 TB/s; Q K^T and the two P V products, hi and lo,
//   0.020 ms at 989 TFLOP/s). The query tiles of one head are neighbouring
//   blocks (blockIdx.x = bh tiles + tile), so a head's K and V are read from
//   device memory about once and from the L2 cache by its other tiles.
//   Eight warps of 16 query rows (128 rows; the float32 accumulators of DMAX
//   columns take 96 or 128 registers a lane, so Q's fragments are read from
//   shared memory at each k16 step rather than held); key tiles of 64
//   through two stages of K and V, the next tile's cp.async copies in
//   flight during this tile's products, one barrier a key tile. Q plus two
//   stages is 150 or 198 KB of shared memory: one block an SM. The arithmetic is the d <= 128 form's: exact bf16 operands, P in
//   hi + lo, the same Philox calls and keep bits (`dropout_keep_bits_rows`).
// * float32: what bounds it is the CUDA-core FMAs (the two products at 67
//   TFLOP/s: 0.19 ms at BH 256, L 256, d 192). The d <= 128 form's kernel,
//   `flash_fwd_kernel`, at DMAX: 64 query rows, key tiles of 64, four by
//   four scores and four rows of DMAX / 16 columns a thread (256 threads).
//   Two stages of K and V do not fit beside Q at 64-key tiles (Q, K, V and P
//   are 164 or 212 KB), so the copies are staggered as that kernel's are:
//   V's tile flies during Q K^T and the softmax, the next K tile during P V,
//   one copy in flight under every product. A kernel of its own whose query
//   tiles of a head were neighbouring blocks read the same times (within 3
//   %), so there is none.
// d past 256 keeps the chunked forms above. Measured on an H100 80GB HBM3 at
// 700 W (tools/profile_torch_kernels.py --only wide, from a CUDA graph), ms
// a call at BH 256, L 256, d 192, p 0.1: bf16 0.146 against the chunked
// form's 0.293, PyTorch's flash kernel's 0.061 and a bound of 0.030 (bytes);
// float32 0.46 against 0.65, the library's 0.42 and 0.19 (operations). Four
// warps over key tiles of 32, two blocks an SM, read 0.153 in bf16.

template <int DMAX, bool DROPOUT, bool BIAS>
__global__ void __launch_bounds__(256, 1)
flash_fwd_bf16_wide256_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              bf16* __restrict__ o, float* __restrict__ lse,
                              int Lq, int Lk, int d, float scale_log2,
                              DropoutParams dp, KeyBias kb) {
  constexpr int BK = 64;
  using C = Bf16Cfg<DMAX, 8, BK>;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_bf16);
  bf16* Kb = Qs + C::BQ * C::S;  // K tiles: buffer (tile index & 1)
  bf16* Vb = Kb + 2 * BK * C::S;

  const int tiles = (Lq + C::BQ - 1) / C::BQ;
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - bh * tiles) * C::BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int row0 = q0 + 16 * warp;  // the warp's rows: row0 + g, row0 + g + 8
  const int steps = d >> 4;         // k16 steps (and 16-column blocks) of d
  const size_t head = (size_t)bh * Lq * d;  // q and o
  const bf16* kh = k + (size_t)bh * Lk * d;
  const bf16* vh = v + (size_t)bh * Lk * d;
  const float* brow = BIAS ? key_bias_row(kb, bh, Lk) : nullptr;
  const int off_a = lane_off_a(lane, C::S);
  const int off_b = lane_off_b(lane, C::S);

  request_bf16_rows<DMAX, C::BQ, C::NT>(Qs, q + head, q0, Lq, d, tid);
  request_bf16_rows<DMAX, BK, C::NT>(Kb, kh, 0, Lk, d, tid);
  request_bf16_rows<DMAX, BK, C::NT>(Vb, vh, 0, Lk, d, tid);
  cp_async_commit_group();

  // rows g and g + 8: the output's accumulators, the running max (base 2,
  // the same in the row's four lanes) and this lane's share of the sum
  float acc[C::ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
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

    uint32_t keep = 0;  // first: Philox's integer work does not wait
    if constexpr (DROPOUT)
      keep = dropout_keep_bits_rows<C::NB>(dp, bh, row0, k0, lane);

    // S = Q K^T from exact bf16 operands, float32 sums; Q's fragment of
    // each k16 step from shared memory
    float s[C::NB][4];
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk) {
      if (kk < steps) {
        uint32_t qa[4];
        ldmatrix_x4(qa, Qs + 16 * warp * C::S + 16 * kk + off_a);
#pragma unroll
        for (int jj = 0; jj < C::NB / 2; ++jj) {
          uint32_t b[4];
          ldmatrix_x4(b, Ks + 16 * jj * C::S + 16 * kk + off_b);
          mma_bf16(s[2 * jj], qa, b[0], b[1]);
          mma_bf16(s[2 * jj + 1], qa, b[2], b[3]);
        }
      }
    }

    softmax_bf16_tile<C::NB, C::ND, DROPOUT, BIAS>(s, m, l, acc, keep, brow,
                                                   k0, Lk, t, scale_log2, dp);

    // O += (P o Z) V over every column: P split in hi + lo, V's fragments
    // by ldmatrix.trans
#pragma unroll
    for (int c = 0; c < C::NB / 2; ++c) {
      if (k0 + 16 * c >= Lk) break;  // keys past Lk: P is 0
      uint32_t hi[4], lo[4];
      split_a(s[2 * c], s[2 * c + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < C::KD; ++np) {
        if (np < steps) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, Vs + 16 * c * C::S + 16 * np + off_a);
          mma_bf16_split(acc[2 * np], hi, lo, b[0], b[1]);
          mma_bf16_split(acc[2 * np + 1], hi, lo, b[2], b[3]);
        }
      }
    }
  }
  if (row0 >= Lq) return;
  store_output_bf16<C::ND>(acc, m, l, o + head, lse + (size_t)bh * Lq, row0,
                           Lq, d, d, lane);
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

template <int DMAX, int BQ, int BK, int RA, int KB, bool DROPOUT, bool BIAS>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int bh, int Lq, int Lk, int d, float scale,
           const DropoutParams& dp, const KeyBias& kb, cudaStream_t stream) {
  using C = Cfg<DMAX, BQ, BK, RA, KB>;
  static std::atomic<bool> opted_in[kMaxDevices];
  const int rc = opt_in(flash_fwd_kernel<DMAX, BQ, BK, RA, KB, DROPOUT, BIAS>,
                        opted_in, C::SMEM);
  if (rc != 0) return rc;
  const dim3 grid(bh, (Lq + BQ - 1) / BQ);
  flash_fwd_kernel<DMAX, BQ, BK, RA, KB, DROPOUT, BIAS>
      <<<grid, C::NT, C::SMEM, stream>>>(q, k, v, o, lse, Lq, Lk, d,
                                         scale * kLog2e, dp, kb);
  return (int)cudaGetLastError();
}

template <bool DROPOUT, bool BIAS>
int launch_form(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int Lq, int Lk, int d, float scale,
                int tile, const DropoutParams& dp, const KeyBias& kb,
                cudaStream_t stream) {
  auto f = &launch<128, 64, 64, 4, 4, DROPOUT, BIAS>;
  if (tile == 32)
    f = d <= 32 ? &launch<32, 32, 32, 4, 4, DROPOUT, BIAS>
                : &launch<64, 32, 32, 4, 4, DROPOUT, BIAS>;
  else if (tile == 128)
    f = d <= 32 ? &launch<32, 128, 64, 8, 8, DROPOUT, BIAS>
                : &launch<64, 128, 64, 8, 8, DROPOUT, BIAS>;
  return f((const float*)q, (const float*)k, (const float*)v, (float*)o, lse,
           bh, Lq, Lk, d, scale, dp, kb, stream);
}

template <int DMAX, int NW, int BK, bool DROPOUT, bool BIAS>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                float* lse, int bh, int Lq, int Lk, int d, float scale,
                const DropoutParams& dp, const KeyBias& kb,
                cudaStream_t stream) {
  using C = Bf16Cfg<DMAX, NW, BK>;
  static std::atomic<bool> opted_in[kMaxDevices];
  const int rc = opt_in(flash_fwd_bf16_kernel<DMAX, NW, BK, DROPOUT, BIAS>,
                        opted_in, C::SMEM);
  if (rc != 0) return rc;
  const dim3 grid(bh, (Lq + C::BQ - 1) / C::BQ);
  flash_fwd_bf16_kernel<DMAX, NW, BK, DROPOUT, BIAS>
      <<<grid, C::NT, C::SMEM, stream>>>(q, k, v, o, lse, Lq, Lk, d,
                                         scale * kLog2e, dp, kb);
  return (int)cudaGetLastError();
}

// The bf16 forms by query tile: 16 rows (one warp, key tiles of 16) and 128
// (eight warps) at d <= 64, 64 (four warps) at any d; key tiles of 64.
template <bool DROPOUT, bool BIAS>
int launch_form_bf16(const void* q, const void* k, const void* v, void* o,
                     float* lse, int bh, int Lq, int Lk, int d, float scale,
                     int tile, const DropoutParams& dp, const KeyBias& kb,
                     cudaStream_t stream) {
  auto f = d <= 32   ? &launch_bf16<32, 4, 64, DROPOUT, BIAS>
           : d <= 64 ? &launch_bf16<64, 4, 64, DROPOUT, BIAS>
                     : &launch_bf16<128, 4, 64, DROPOUT, BIAS>;
  if (tile == 16)
    f = d <= 32 ? &launch_bf16<32, 1, 16, DROPOUT, BIAS>
                : &launch_bf16<64, 1, 16, DROPOUT, BIAS>;
  else if (tile == 128)
    f = d <= 32 ? &launch_bf16<32, 8, 64, DROPOUT, BIAS>
                : &launch_bf16<64, 8, 64, DROPOUT, BIAS>;
  return f((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, bh,
           Lq, Lk, d, scale, dp, kb, stream);
}

// The checks and the choice of form of both entries; BIAS picks the set of
// forms that this translation unit compiles.
template <bool BIAS>
int forward(const void* q, const void* k, const void* v, void* o, void* lse,
            int bh, int Lq, int Lk, int d, float scale, int tile, int dropout,
            unsigned threshold, float keep_scale, unsigned long long seed,
            const unsigned* grid, int bf16_form, const KeyBias& kb,
            void* stream) {
  const bool ok =
      Lq >= 1 && Lk >= 1 &&
      (bf16_form ? d >= 16 && d % 16 == 0 && d <= 128 &&
                       (tile == 64 || (d <= 64 && (tile == 16 || tile == 128)))
                 : d >= 8 && d % 8 == 0 && d <= 128 &&
                       (d <= 64 ? tile == 32 || tile == 128 : tile == 64));
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
  return f(q, k, v, o, (float*)lse, bh, Lq, Lk, d, scale, tile, dp, kb,
           (cudaStream_t)stream);
}

// The one-block bf16 wide form's launch at a head_dim padded to DMAX: a
// block per (head, query tile of 128 rows), blockIdx.x = bh tiles + tile.
template <int DMAX, bool DROPOUT, bool BIAS>
int launch_wide256_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int bh, int Lq, int Lk, int d,
                        float scale_log2, const DropoutParams& dp,
                        const KeyBias& kb, cudaStream_t stream) {
  using C = Bf16Cfg<DMAX, 8, 64>;
  constexpr auto kernel = flash_fwd_bf16_wide256_kernel<DMAX, DROPOUT, BIAS>;
  static std::atomic<bool> opted_in[kMaxDevices];
  const int rc = opt_in(kernel, opted_in, C::SMEM);
  if (rc != 0) return rc;
  kernel<<<(unsigned)bh * ((Lq + C::BQ - 1) / C::BQ), C::NT, C::SMEM,
           stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                     (bf16*)o, lse, Lq, Lk, d, scale_log2, dp, kb);
  return (int)cudaGetLastError();
}

// The wide forms' launch: up to kWideMax a block per (head, query tile of
// 128 rows in bf16, 64 in float32); past it a block per (head, query tile of
// 64, 256 output columns; bf16 128).
template <bool DROPOUT, bool BIAS>
int launch_wide(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int Lq, int Lk, int d, float scale,
                int bf16_form, const DropoutParams& dp, const KeyBias& kb,
                cudaStream_t stream) {
  if (d <= kWideMax && bf16_form) {  // one block a query tile of 128 rows
    auto f = d <= kWideMid ? &launch_wide256_bf16<kWideMid, DROPOUT, BIAS>
                           : &launch_wide256_bf16<kWideMax, DROPOUT, BIAS>;
    return f(q, k, v, o, lse, bh, Lq, Lk, d, scale * kLog2e, dp, kb, stream);
  }
  if (d <= kWideMax) {  // the d <= 128 form's kernel at DMAX 192 or 256
    auto f = d <= kWideMid ? &launch<kWideMid, 64, 64, 4, 4, DROPOUT, BIAS>
                           : &launch<kWideMax, 64, 64, 4, 4, DROPOUT, BIAS>;
    return f((const float*)q, (const float*)k, (const float*)v, (float*)o,
             lse, bh, Lq, Lk, d, scale, dp, kb, stream);
  }
  // past 256: the chunked forms
  const int out_cols = bf16_form ? kWideCols : kWideOutF32;
  const dim3 grid(bh, (Lq + 63) / 64, (d + out_cols - 1) / out_cols);
  if (bf16_form) {
    using C = Bf16Cfg<kWideCols, 4, 64>;
    constexpr size_t smem = sizeof(bf16) * (size_t)(C::BQ + 2 * 64) * C::S;
    static std::atomic<bool> opted_in[kMaxDevices];
    const int rc =
        opt_in(flash_fwd_bf16_wide_kernel<DROPOUT, BIAS>, opted_in, smem);
    if (rc != 0) return rc;
    flash_fwd_bf16_wide_kernel<DROPOUT, BIAS><<<grid, C::NT, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, Lq, Lk,
        d, scale * kLog2e, dp, kb);
    return (int)cudaGetLastError();
  }
  using C = Cfg<kWideCols, 64, 64, 4, 4>;
  static std::atomic<bool> opted_in[kMaxDevices];
  const int rc = opt_in(flash_fwd_wide_kernel<DROPOUT, BIAS>, opted_in,
                        kWideF32Smem);
  if (rc != 0) return rc;
  flash_fwd_wide_kernel<DROPOUT, BIAS>
      <<<grid, C::NT, kWideF32Smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, Lq,
      Lk, d, scale * kLog2e, dp, kb);
  return (int)cudaGetLastError();
}

// The checks of the wide entries: d past 128, a multiple of 8 (bf16: 16),
// query tiles of 64.
template <bool BIAS>
int forward_wide(const void* q, const void* k, const void* v, void* o,
                 void* lse, int bh, int Lq, int Lk, int d, float scale,
                 int tile, int dropout, unsigned threshold, float keep_scale,
                 unsigned long long seed, const unsigned* grid, int bf16_form,
                 const KeyBias& kb, void* stream) {
  const bool ok = Lq >= 1 && Lk >= 1 && d > 128 && tile == 64 &&
                  d % (bf16_form ? 16 : 8) == 0;
  if (!ok || (BIAS && (kb.ptr == nullptr || kb.heads < 1 || bh % kb.heads)))
    return (int)cudaErrorInvalidValue;
  if (dropout && (grid[0] < 1 || bh % grid[0]))
    return (int)cudaErrorInvalidValue;
  const DropoutParams dp{threshold, keep_scale, (uint32_t)seed,
                         (uint32_t)(seed >> 32), grid[0], grid[1], grid[2],
                         grid[3], grid[4]};
  auto f = dropout ? &launch_wide<true, BIAS> : &launch_wide<false, BIAS>;
  return f(q, k, v, o, (float*)lse, bh, Lq, Lk, d, scale, bf16_form, dp, kb,
           (cudaStream_t)stream);
}

}  // namespace

// q, o: (bh, Lq, d) and k, v: (bh, Lk, d), contiguous, 16-byte aligned; lse:
// (bh, Lq) float32. Lq == Lk is self-attention; Lq < Lk a sequence-parallel
// rank's own queries against the keys gathered from every rank.
// float32 (`bf16_form` == 0): d % 8 == 0, d <= 128, `tile` (the query tile
// height) 32 or 128 for d <= 64, 64 for d > 64. bfloat16 (`bf16_form` != 0):
// d % 16 == 0, d <= 128, `tile` 16 or 128 for d <= 64, or 64. A wider d takes
// `flash_attn_fwd_wide` (flash_attn_wide.cu), with the same arguments.
// `dropout` != 0 takes the dropout form: a key is kept iff its Philox word
// (philox.cuh, from `seed`) is below `threshold`, and a kept probability is
// multiplied by `keep_scale`; (heads, total_heads, batch0, head0) place the
// launch's heads in the model's global (batch, head) grid, whose index keys
// the mask (philox.cuh; (1, 1, 0, 0) on one device), and `heads` divides
// bh; `row0` is the global index of query row 0, which keys the mask of each
// row (0 on one device). Returns the CUDA error of the launch.
#if !defined(DMC_FLASH_BIAS_FORMS) && !defined(DMC_FLASH_WIDE_FORMS)
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int Lq, int Lk,
                              int d, float scale, int tile, int dropout,
                              unsigned threshold, float keep_scale,
                              unsigned long long seed, unsigned heads,
                              unsigned total_heads, unsigned batch0,
                              unsigned head0, unsigned row0, int bf16_form,
                              void* stream) {
  const unsigned grid[5] = {heads, total_heads, batch0, head0, row0};
  return forward<false>(q, k, v, o, lse, bh, Lq, Lk, d, scale, tile, dropout,
                        threshold, keep_scale, seed, grid, bf16_form,
                        KeyBias{nullptr, 1}, stream);
}

// Message of a CUDA error code returned by the entries above.
extern "C" const char* dmc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
#elif !defined(DMC_FLASH_WIDE_FORMS)
// flash_attn_fwd with a per-key bias (key_bias.cuh): float32 (bh / heads,
// Lk), added to every scaled score of head bh's row bh / bias_heads before
// the softmax; lse includes it. `bias_heads` divides bh.
extern "C" int flash_attn_fwd_bias(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int bh, int Lq, int Lk,
                                   int d, float scale, int tile, int dropout,
                                   unsigned threshold, float keep_scale,
                                   unsigned long long seed, unsigned heads,
                                   unsigned total_heads, unsigned batch0,
                                   unsigned head0, unsigned row0,
                                   int bf16_form, const void* bias,
                                   int bias_heads, void* stream) {
  const unsigned grid[5] = {heads, total_heads, batch0, head0, row0};
  return forward<true>(q, k, v, o, lse, bh, Lq, Lk, d, scale, tile, dropout,
                       threshold, keep_scale, seed, grid, bf16_form,
                       KeyBias{(const float*)bias, bias_heads}, stream);
}
#elif !defined(DMC_FLASH_BIAS_FORMS)
// flash_attn_fwd's arguments at d > 128 (d % 8 == 0, bf16 d % 16 == 0;
// `tile` 64): the wide forms.
extern "C" int flash_attn_fwd_wide(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int bh, int Lq, int Lk,
                                   int d, float scale, int tile, int dropout,
                                   unsigned threshold, float keep_scale,
                                   unsigned long long seed, unsigned heads,
                                   unsigned total_heads, unsigned batch0,
                                   unsigned head0, unsigned row0,
                                   int bf16_form, void* stream) {
  const unsigned grid[5] = {heads, total_heads, batch0, head0, row0};
  return forward_wide<false>(q, k, v, o, lse, bh, Lq, Lk, d, scale, tile,
                             dropout, threshold, keep_scale, seed, grid,
                             bf16_form, KeyBias{nullptr, 1}, stream);
}
#else
// flash_attn_fwd_bias's arguments at d > 128: the wide forms with the key
// bias.
extern "C" int flash_attn_fwd_wide_bias(
    const void* q, const void* k, const void* v, void* o, void* lse, int bh,
    int Lq, int Lk, int d, float scale, int tile, int dropout,
    unsigned threshold, float keep_scale, unsigned long long seed,
    unsigned heads, unsigned total_heads, unsigned batch0, unsigned head0,
    unsigned row0, int bf16_form, const void* bias, int bias_heads,
    void* stream) {
  const unsigned grid[5] = {heads, total_heads, batch0, head0, row0};
  return forward_wide<true>(q, k, v, o, lse, bh, Lq, Lk, d, scale, tile,
                            dropout, threshold, keep_scale, seed, grid,
                            bf16_form,
                            KeyBias{(const float*)bias, bias_heads}, stream);
}
#endif
