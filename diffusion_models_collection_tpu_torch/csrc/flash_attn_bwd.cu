// Flash-attention backward on (BH, L, d) float32: from q, k, v, the forward's
// output o and row logsumexp lse, and the output gradient dO, compute
//   P  = exp(q k^T * scale - lse)
//   dV = P^T dO
//   dS = P o (dO V^T - rowsum(dO o O)) * scale
//   dQ = dS K,  dK = dS^T Q.
//
// Replaces diffusion_models_collection_tpu/ops/flash_attention.py:_bwd_kernel.
//
// What bounds it on an H100: in float32 without TF32 there are no tensor
// cores, so the five products run on CUDA-core FMAs from shared memory, and
// shared-memory bandwidth bounds the inner loops, as in the forward
// (flash_attn.cu). The TPU kernel held the whole L x L block of one head in
// VMEM; a block here has at most 227 KB of shared memory, so the backward is
// tiled FlashAttention-2 style in three launches:
//   1. delta[bh, i] = sum_d dO * O, one warp per row;
//   2. dK/dV: one block of 256 threads per (bh, 64-key tile). K_j and V_j stay
//      in shared memory; the block walks the 64-row Q/dO tiles, recomputes P
//      and dS for the tile from lse and delta, and accumulates dK_j and dV_j
//      in registers (each thread a 4 x DMAX/16 tile of each);
//   3. dQ: one block per (bh, 64-query tile) that walks the key tiles.
// No atomics: every output element is written by one thread, so the result is
// deterministic. Shared-memory rows are padded to DMAX + 1, so the column
// reads of the score products do not collide in a bank; the (64, 64) tile of
// P or dS is padded to 65. Keys and query rows past L are masked (a row past
// L gets lse = +inf, so its P is 0), so any L >= 1 runs; any d % 8 == 0 up to
// 128 runs, zero-padded to DMAX of 32, 64 or 128. About 83 KB of shared
// memory at DMAX = 64, two blocks per SM.

#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kSP = kBK + 1;   // padded row stride of the P / dS tile
constexpr int kMaxDevices = 64;

// Q, dO, K and V tiles of (64, DMAX + 1), one (64, 65) tile of P or dS, and
// lse and delta of the current query rows.
template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * (size_t)kBQ * (DMAX + 1) + (size_t)kBQ * kSP + 2 * kBQ);
}

__global__ void flash_bwd_delta_kernel(const float* __restrict__ o,
                                       const float* __restrict__ dout,
                                       float* __restrict__ delta, int rows, int d) {
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const float* orow = o + (size_t)row * d;
  const float* drow = dout + (size_t)row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(orow[c], drow[c], s);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// rows r0 .. r0 + 63 of one head's (L, d) matrix into a (64, DMAX + 1) tile,
// zero past L and past d
template <int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int r0, int L, int d, int tid) {
  constexpr int P = DMAX + 1;
  for (int i = tid; i < kBQ * DMAX; i += kThreads) {
    const int r = i / DMAX;
    const int c = i - r * DMAX;
    const int row = r0 + r;
    dst[r * P + c] = (row < L && c < d) ? src[(size_t)row * d + c] : 0.f;
  }
}

// s[a][b] = Q_r . K_j and dp[a][b] = dO_r . V_j for query rows r = ty + 16 a
// and keys j = tx + 16 b of the current tiles
template <int DMAX>
__device__ __forceinline__ void score_tiles(const float* Qs, const float* dOs,
                                            const float* Ks, const float* Vs,
                                            int ty, int tx, float s[4][4],
                                            float dp[4][4]) {
  constexpr int P = DMAX + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      s[a][b] = 0.f;
      dp[a][b] = 0.f;
    }
#pragma unroll 4
  for (int c = 0; c < DMAX; ++c) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qv[a] = Qs[(ty + 16 * a) * P + c];
      dov[a] = dOs[(ty + 16 * a) * P + c];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kv[b] = Ks[(tx + 16 * b) * P + c];
      vv[b] = Vs[(tx + 16 * b) * P + c];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(qv[a], kv[b], s[a][b]);
        dp[a][b] = fmaf(dov[a], vv[b], dp[a][b]);
      }
  }
}

// lse and delta of query rows q0 .. q0 + 63; rows past L get lse = +inf, so
// their probabilities, and with them their share of dK and dV, are 0
__device__ __forceinline__ void load_row_stats(float* lse_s, float* dl_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               size_t base, int q0, int L, int tid) {
  if (tid < kBQ) {
    const int row = q0 + tid;
    lse_s[tid] = row < L ? lse[base + row] : INFINITY;
    dl_s[tid] = row < L ? delta[base + row] : 0.f;
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int L, int d,
                      float scale) {
  constexpr int P = DMAX + 1;
  constexpr int DC = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;              // kBK x P
  float* Vs = Ks + kBK * P;      // kBK x P
  float* Qs = Vs + kBK * P;      // kBQ x P
  float* dOs = Qs + kBQ * P;     // kBQ x P
  float* Ss = dOs + kBQ * P;     // kBQ x kSP: P, then dS
  float* lse_s = Ss + kBQ * kSP;
  float* dl_s = lse_s + kBQ;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t head = (size_t)bh * L * d;
  const size_t base = (size_t)bh * L;

  load_tile<DMAX>(Ks, k + head, k0, L, d, tid);
  load_tile<DMAX>(Vs, v + head, k0, L, d, tid);

  // keys k0 + ty + 16 a, columns tx + 16 b
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < DC; ++b) {
      dk_acc[a][b] = 0.f;
      dv_acc[a][b] = 0.f;
    }

  for (int q0 = 0; q0 < L; q0 += kBQ) {
    __syncthreads();  // the previous tile's Qs, dOs, Ss and row stats are read
    load_tile<DMAX>(Qs, q + head, q0, L, d, tid);
    load_tile<DMAX>(dOs, dout + head, q0, L, d, tid);
    load_row_stats(lse_s, dl_s, lse, delta, base, q0, L, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tiles<DMAX>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    float ds[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const float lr = lse_s[r];
      const float dl = dl_s[r];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = expf(s[a][b] * scale - lr);
        Ss[r * kSP + tx + 16 * b] = p;
        ds[a][b] = p * (dp[a][b] - dl) * scale;
      }
    }
    __syncthreads();

    // dV_j += sum_r P[r, j] dO[r, :]
#pragma unroll 4
    for (int r = 0; r < kBQ; ++r) {
      float pv[4], dov[DC];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = Ss[r * kSP + ty + 16 * a];
#pragma unroll
      for (int b = 0; b < DC; ++b) dov[b] = dOs[r * P + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < DC; ++b) dv_acc[a][b] = fmaf(pv[a], dov[b], dv_acc[a][b]);
    }
    __syncthreads();  // P is read; the tile takes dS

#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) Ss[(ty + 16 * a) * kSP + tx + 16 * b] = ds[a][b];
    __syncthreads();

    // dK_j += sum_r dS[r, j] Q[r, :]
#pragma unroll 4
    for (int r = 0; r < kBQ; ++r) {
      float dsv[4], qv[DC];
#pragma unroll
      for (int a = 0; a < 4; ++a) dsv[a] = Ss[r * kSP + ty + 16 * a];
#pragma unroll
      for (int b = 0; b < DC; ++b) qv[b] = Qs[r * P + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < DC; ++b) dk_acc[a][b] = fmaf(dsv[a], qv[b], dk_acc[a][b]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = k0 + ty + 16 * a;
    if (row < L) {
#pragma unroll
      for (int b = 0; b < DC; ++b) {
        const int c = tx + 16 * b;
        if (c < d) {
          dk[head + (size_t)row * d + c] = dk_acc[a][b];
          dv[head + (size_t)row * d + c] = dv_acc[a][b];
        }
      }
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int L, int d, float scale) {
  constexpr int P = DMAX + 1;
  constexpr int DC = DMAX / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // kBQ x P
  float* dOs = Qs + kBQ * P;     // kBQ x P
  float* Ks = dOs + kBQ * P;     // kBK x P
  float* Vs = Ks + kBK * P;      // kBK x P
  float* Ss = Vs + kBK * P;      // kBQ x kSP: dS
  float* lse_s = Ss + kBQ * kSP;
  float* dl_s = lse_s + kBQ;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t head = (size_t)bh * L * d;
  const size_t base = (size_t)bh * L;

  load_tile<DMAX>(Qs, q + head, q0, L, d, tid);
  load_tile<DMAX>(dOs, dout + head, q0, L, d, tid);
  load_row_stats(lse_s, dl_s, lse, delta, base, q0, L, tid);

  // query rows q0 + ty + 16 a, columns tx + 16 b
  float acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < DC; ++b) acc[a][b] = 0.f;

  for (int k0 = 0; k0 < L; k0 += kBK) {
    __syncthreads();  // the previous tile's Ks and Ss are read
    load_tile<DMAX>(Ks, k + head, k0, L, d, tid);
    load_tile<DMAX>(Vs, v + head, k0, L, d, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tiles<DMAX>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const float lr = lse_s[r];
      const float dl = dl_s[r];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = tx + 16 * b;
        const float p = (k0 + col < L) ? expf(s[a][b] * scale - lr) : 0.f;
        Ss[r * kSP + col] = p * (dp[a][b] - dl) * scale;
      }
    }
    __syncthreads();

    // dQ_r += sum_j dS[r, j] K[j, :]
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float dsv[4], kv[DC];
#pragma unroll
      for (int a = 0; a < 4; ++a) dsv[a] = Ss[(ty + 16 * a) * kSP + j];
#pragma unroll
      for (int b = 0; b < DC; ++b) kv[b] = Ks[j * P + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < DC; ++b) acc[a][b] = fmaf(dsv[a], kv[b], acc[a][b]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row < L) {
#pragma unroll
      for (int b = 0; b < DC; ++b) {
        const int c = tx + 16 * b;
        if (c < d) dq[head + (size_t)row * d + c] = acc[a][b];
      }
    }
  }
}

template <int DMAX>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* delta, float* dq, float* dk,
           float* dv, int bh, int L, int d, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DMAX>();
  // The opt-in to more than 48 KiB of dynamic shared memory holds per kernel
  // and device: set it at the first launch on each device, not every launch.
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<DMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev].store(true, std::memory_order_release);
  }
  const int rows = bh * L;
  const int rows_per_block = kThreads / 32;
  flash_bwd_delta_kernel<<<(rows + rows_per_block - 1) / rows_per_block, kThreads, 0,
                           stream>>>(o, dout, delta, rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (L + kBQ - 1) / kBQ);
  flash_bwd_dkdv_kernel<DMAX><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, L, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<DMAX><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, L, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (bh, L, d) float32, contiguous; lse and the
// scratch delta: (bh, L) float32. d % 8 == 0 and d <= 128. Returns the CUDA
// error of the launches.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout, const void* lse,
                              void* delta, void* dq, void* dk, void* dv, int bh,
                              int L, int d, float scale, void* stream) {
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const float* of = (const float*)o;
  const float* df = (const float*)dout;
  const float* lf = (const float*)lse;
  float* delf = (float*)delta;
  float* dqf = (float*)dq;
  float* dkf = (float*)dk;
  float* dvf = (float*)dv;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 32)
    return launch<32>(qf, kf, vf, of, df, lf, delf, dqf, dkf, dvf, bh, L, d, scale, s);
  if (d <= 64)
    return launch<64>(qf, kf, vf, of, df, lf, delf, dqf, dkf, dvf, bh, L, d, scale, s);
  if (d <= 128)
    return launch<128>(qf, kf, vf, of, df, lf, delf, dqf, dkf, dvf, bh, L, d, scale, s);
  return (int)cudaErrorInvalidValue;
}
