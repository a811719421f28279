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
// bfloat16 (the models' mixed precision; the JAX kernel computes in float32
// from bf16 inputs and returns dq, dk, dv in their types): the element type T
// of q, k, v, o, dO, dq, dk and dv is a template parameter of the same
// kernels. A bf16 tile is widened to float32 by the thread that loads it, as
// it goes from device memory into the float32 shared tile (exact): two
// blocks an SM leave no room for a bf16 staging buffer beside the tiles, so
// these loads are plain loads, not cp.async. delta, lse, the dq shares and
// all arithmetic stay float32; dq, dk and dv are rounded to bf16 at their
// one store (the fused form's dq in the share-sum kernel when there is more
// than one key tile).
// Read by chip_smoke.py on an H100 80GB HBM3 at 700 W: 0.85 ms a call at
// BH 512, L 256, d 64 (fused; 1.02 ms with the two-kernel form forced),
// 4.9 ms for the 11 calls of a UNet train step against a bound of 1.7 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr int kDeltaThreads = 256;

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
// (BT, DMAX + 4) tile, zero past L and past d: float32 by cp.async (d % 4 ==
// 0); bf16 (d % 8 == 0) loaded 16 bytes at a time, widened and stored here.
template <typename T, int DMAX, int BT>
__device__ __forceinline__ void request_tile(float* dst,
                                             const T* __restrict__ src,
                                             int r0, int L, int d, int tid) {
  using C = Cfg<DMAX, BT>;
  constexpr int E = 16 / sizeof(T);  // elements of a 16-byte piece
  constexpr int V = DMAX / E;        // pieces of a row
  if constexpr (sizeof(T) == 4) {
    for (int i = tid; i < BT * V; i += C::NT) {
      const int r = i / V;
      const int c = (i - r * V) * E;
      const bool ok = r0 + r < L && c < d;
      cp_async16(dst + r * C::P + c, ok ? src + (size_t)(r0 + r) * d + c : src,
                 ok);
    }
  } else {
    // one piece in registers at a time: the accumulators are live here
#pragma unroll 1
    for (int i = tid; i < BT * V; i += C::NT) {
      const int r = i / V;
      const int c = (i - r * V) * E;
      const bool ok = r0 + r < L && c < d;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (ok) w = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * d + c);
      float* out = dst + r * C::P + c;
      *reinterpret_cast<float4*>(out) =
          make_float4(__uint_as_float(w.x << 16),
                      __uint_as_float(w.x & 0xffff0000u),
                      __uint_as_float(w.y << 16),
                      __uint_as_float(w.y & 0xffff0000u));
      *reinterpret_cast<float4*>(out + 4) =
          make_float4(__uint_as_float(w.z << 16),
                      __uint_as_float(w.z & 0xffff0000u),
                      __uint_as_float(w.w << 16),
                      __uint_as_float(w.w & 0xffff0000u));
    }
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

// VW floats rounded to bf16 (nearest even) in one 8- or 4-byte store
template <int VW>
__device__ __forceinline__ void store_vec(__nv_bfloat16* dst, const float* src) {
  unsigned w[VW / 2];
#pragma unroll
  for (int i = 0; i < VW / 2; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  if constexpr (VW == 4)
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<unsigned*>(dst) = w[0];
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
template <int DMAX, int BT, bool DROPOUT>
__device__ __forceinline__ void probs_tile(const float* Qs, const float* dOs,
                                           const float* Ks, const float* Vs,
                                           const float* lse_s, const float* dl_s,
                                           float* Ps, float* dSs, int ty, int tx,
                                           float scale, const DropoutParams& dp,
                                           int bh, int q0, int k0) {
  using C = Cfg<DMAX, BT>;
  float s[4][4], dpv[4][4];
  rows_dot<DMAX, BT>(Qs, Ks, ty, tx, s);
  rows_dot<DMAX, BT>(dOs, Vs, ty, tx, dpv);
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
      const float p = expf(s[a][b] * scale - lr);
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
template <int DMAX, int BT, typename O>
__device__ __forceinline__ void store_rows(O* __restrict__ dst,
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
// (bh * gridDim.y + tile) * L * d: float32 shares, or dq itself, of type T,
// when there is one key tile; DQ is its element type).
template <typename T, typename DQ, int DMAX, int BT, bool WITH_DQ, bool DROPOUT>
__global__ void __launch_bounds__(Cfg<DMAX, BT>::NT,
                                  (DMAX <= 64 && BT == 64) ? 2 : 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      DQ* __restrict__ dq_out, T* __restrict__ dk,
                      T* __restrict__ dv, int L, int d, float scale,
                      DropoutParams dp) {
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

  request_tile<T, DMAX, BT>(Ks, k + head, k0, L, d, tid);
  request_tile<T, DMAX, BT>(Vs, v + head, k0, L, d, tid);
  request_tile<T, DMAX, BT>(Qs, q + head, 0, L, d, tid);
  request_tile<T, DMAX, BT>(dOs, dout + head, 0, L, d, tid);
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
  DQ* dq_head = nullptr;
  if constexpr (WITH_DQ)
    dq_head = dq_out + ((size_t)bh * gridDim.y + blockIdx.y) * L * d;

  for (int q0 = 0; q0 < L; q0 += BT) {
    cp_async_wait_all();
    __syncthreads();  // the tiles and row stats are in; dSs is read

    probs_tile<DMAX, BT, DROPOUT>(Qs, dOs, Ks, Vs, lse_s, dl_s, Ps, dSs, ty, tx,
                                  scale, dp, bh, q0, k0);
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
      request_tile<T, DMAX, BT>(Qs, q + head, q0 + BT, L, d, tid);
      request_tile<T, DMAX, BT>(dOs, dout + head, q0 + BT, L, d, tid);
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
template <typename T, int DMAX, int BT, bool DROPOUT>
__global__ void __launch_bounds__(Cfg<DMAX, BT>::NT,
                                  (DMAX <= 64 && BT == 64) ? 2 : 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int L, int d, float scale,
                    DropoutParams dp) {
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

  request_tile<T, DMAX, BT>(Qs, q + head, q0, L, d, tid);
  request_tile<T, DMAX, BT>(dOs, dout + head, q0, L, d, tid);
  request_tile<T, DMAX, BT>(Kbuf, k + head, 0, L, d, tid);
  request_tile<T, DMAX, BT>(Vs, v + head, 0, L, d, tid);
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

    probs_tile<DMAX, BT, DROPOUT>(Qs, dOs, Ks, Vs, lse_s, dl_s, nullptr, dSs, ty,
                                  tx, scale, dp, bh, q0, k0);
    __syncthreads();  // Vs is read

    if (k0 + BT < L) {  // the next tiles fly during the dQ product
      request_tile<T, DMAX, BT>(Kbuf + (cur ^ 1) * C::TILE, k + head, k0 + BT,
                                L, d, tid);
      request_tile<T, DMAX, BT>(Vs, v + head, k0 + BT, L, d, tid);
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

template <typename T, int DMAX, int BT, bool DROPOUT>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dout,
           const float* lse, float* delta, float* partial, T* dq, T* dk, T* dv,
           int bh, int L, int d, float scale, int fused,
           const DropoutParams& dp, cudaStream_t stream) {
  using C = Cfg<DMAX, BT>;
  static std::atomic<bool> opted_fused[kMaxDevices], opted_one[kMaxDevices],
      opted_dkdv[kMaxDevices], opted_dq[kMaxDevices];
  const int tiles = (L + BT - 1) / BT;
  if (fused && tiles > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;

  const int rows = bh * L;
  const int rows_per_block = kDeltaThreads / 32;
  flash_bwd_delta_kernel<T><<<(rows + rows_per_block - 1) / rows_per_block,
                              kDeltaThreads, 0, stream>>>(o, dout, delta, rows,
                                                          d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid(bh, tiles);
  if (fused && tiles == 1) {  // dq itself, in T
    int rc = opt_in(flash_bwd_dkdv_kernel<T, T, DMAX, BT, true, DROPOUT>,
                    opted_one, C::SMEM_DKDV);
    if (rc != 0) return rc;
    flash_bwd_dkdv_kernel<T, T, DMAX, BT, true, DROPOUT>
        <<<grid, C::NT, C::SMEM_DKDV, stream>>>(q, k, v, dout, lse, delta, dq,
                                                dk, dv, L, d, scale, dp);
    return (int)cudaGetLastError();
  }
  if (fused) {  // float32 shares, summed into dq
    int rc = opt_in(flash_bwd_dkdv_kernel<T, float, DMAX, BT, true, DROPOUT>,
                    opted_fused, C::SMEM_DKDV);
    if (rc != 0) return rc;
    flash_bwd_dkdv_kernel<T, float, DMAX, BT, true, DROPOUT>
        <<<grid, C::NT, C::SMEM_DKDV, stream>>>(
            q, k, v, dout, lse, delta, partial, dk, dv, L, d, scale, dp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t head4 = (size_t)L * d / 4;
    const size_t total4 = head4 * bh;
    flash_bwd_dq_sum_kernel<T>
        <<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
            (const float4*)partial, dq, head4, tiles, total4);
    return (int)cudaGetLastError();
  }
  int rc = opt_in(flash_bwd_dkdv_kernel<T, T, DMAX, BT, false, DROPOUT>,
                  opted_dkdv, C::SMEM_DKDV);
  if (rc != 0) return rc;
  rc = opt_in(flash_bwd_dq_kernel<T, DMAX, BT, DROPOUT>, opted_dq, C::SMEM_DQ);
  if (rc != 0) return rc;
  flash_bwd_dkdv_kernel<T, T, DMAX, BT, false, DROPOUT>
      <<<grid, C::NT, C::SMEM_DKDV, stream>>>(
          q, k, v, dout, lse, delta, (T*)nullptr, dk, dv, L, d, scale, dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T, DMAX, BT, DROPOUT><<<grid, C::NT, C::SMEM_DQ, stream>>>(
      q, k, v, dout, lse, delta, dq, L, d, scale, dp);
  return (int)cudaGetLastError();
}

template <typename T, bool DROPOUT>
int launch_form(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta,
                float* partial, void* dq, void* dk, void* dv, int bh, int L,
                int d, float scale, int tile, int fused,
                const DropoutParams& dp, cudaStream_t stream) {
  auto f = &launch<T, 128, 64, DROPOUT>;
  if (tile == 32)
    f = d <= 32 ? &launch<T, 32, 32, DROPOUT> : &launch<T, 64, 32, DROPOUT>;
  else if (d <= 32)
    f = &launch<T, 32, 64, DROPOUT>;
  else if (d <= 64)
    f = &launch<T, 64, 64, DROPOUT>;
  return f((const T*)q, (const T*)k, (const T*)v, (const T*)o,
           (const T*)dout, lse, delta, partial, (T*)dq, (T*)dk, (T*)dv, bh, L,
           d, scale, fused, dp, stream);
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (bh, L, d), contiguous, 16-byte aligned,
// float32 or (`bf16` != 0) bfloat16; lse and the scratch delta: (bh, L)
// float32; `partial` float32. d % 8 == 0 and
// d <= 128. `tile` is the tile height, 64, or 32 for d <= 64. `fused` != 0
// takes the one-pass form, which needs the scratch `partial` (bh,
// ceil(L / tile), L, d) when L > tile; `fused` == 0 the two-kernel form
// (`partial` unused). `dropout` != 0 takes the dropout form with the
// forward's `threshold`, `keep_scale` and `seed` (flash_attn.cu). Returns the
// CUDA error of the launches.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout, const void* lse,
                              void* delta, void* partial, void* dq, void* dk,
                              void* dv, int bh, int L, int d, float scale,
                              int tile, int fused, int dropout,
                              unsigned threshold, float keep_scale,
                              unsigned long long seed, int bf16,
                              void* stream) {
  if (d < 8 || d % 8 || d > 128 || (tile != 64 && !(tile == 32 && d <= 64)))
    return (int)cudaErrorInvalidValue;
  const DropoutParams dp{threshold, keep_scale, (uint32_t)seed,
                         (uint32_t)(seed >> 32)};
  auto f = bf16 ? (dropout ? &launch_form<__nv_bfloat16, true>
                           : &launch_form<__nv_bfloat16, false>)
                : (dropout ? &launch_form<float, true>
                           : &launch_form<float, false>);
  return f(q, k, v, o, dout, (const float*)lse, (float*)delta,
           (float*)partial, dq, dk, dv, bh, L, d, scale, tile, fused, dp,
           (cudaStream_t)stream);
}
