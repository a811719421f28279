// Flash-attention forward on (BH, L, d) float32 q, k, v: o = softmax(q k^T /
// sqrt(d)) v and the row logsumexp lse = log(sum(exp(q k^T / sqrt(d)))),
// (BH, L). The backward of a later change recomputes P from lse.
//
// Replaces diffusion_models_collection_tpu/ops/flash_attention.py:_fwd_kernel.
//
// What bounds it on an H100: in float32 without TF32 there are no tensor
// cores, so the two products run on CUDA-core FMAs from shared memory, and
// shared-memory bandwidth bounds the inner loops. Design: one block of 256
// threads per (b*h, 64-row q tile); K and V stream through shared memory in
// 64-row tiles; each thread keeps a 4x4 tile of scores and a 4 x (DMAX/16)
// tile of the output in registers, reading q and k along padded rows (stride
// DMAX + 1) so the column reads do not collide in a bank. The softmax is the
// online one: a float32 running max and sum per row, the output rescaled by
// exp(m_old - m_new) per tile. The (L, L) score matrix never reaches device
// memory. Rows and keys past L are masked, so any L >= 1 runs (the TPU kernel
// needed L % 128 == 0); any d % 8 == 0 up to 128 runs, zero-padded to DMAX
// of 32, 64 or 128.

#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per streamed tile
constexpr int kThreads = 256; // 16 x 16 threads
constexpr int kSP = kBK + 1;  // padded row stride of the score tile

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (DMAX + 1) + (size_t)kBK * (DMAX + 1) +
                          (size_t)kBK * DMAX + (size_t)kBQ * kSP + 3 * kBQ);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int L, int d, float scale) {
  constexpr int QP = DMAX + 1;
  constexpr int DC = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // kBQ x QP, pre-scaled by `scale`
  float* Ks = Qs + kBQ * QP;    // kBK x QP
  float* Vs = Ks + kBK * QP;    // kBK x DMAX
  float* Ss = Vs + kBK * DMAX;  // kBQ x kSP: scores, then probabilities
  float* m_s = Ss + kBQ * kSP;  // running max per row
  float* l_s = m_s + kBQ;       // running sum per row
  float* a_s = l_s + kBQ;       // rescale factor of the current tile

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t head = (size_t)bh * L * d;
  const float* qh = q + head;
  const float* kh = k + head;
  const float* vh = v + head;

  for (int i = tid; i < kBQ * DMAX; i += kThreads) {
    const int r = i / DMAX;
    const int c = i - r * DMAX;
    const int row = q0 + r;
    Qs[r * QP + c] = (row < L && c < d) ? qh[(size_t)row * d + c] * scale : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < L; k0 += kBK) {
    __syncthreads();  // the previous tile's Ks, Vs and Ss are no longer read
    for (int i = tid; i < kBK * DMAX; i += kThreads) {
      const int r = i / DMAX;
      const int c = i - r * DMAX;
      const int row = k0 + r;
      const bool ok = row < L && c < d;
      Ks[r * QP + c] = ok ? kh[(size_t)row * d + c] : 0.f;
      Vs[r * DMAX + c] = ok ? vh[(size_t)row * d + c] : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DMAX; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        Ss[(ty + 16 * i) * kSP + col] = (k0 + col < L) ? s[i][j] : -INFINITY;
      }
    __syncthreads();

    // online softmax: four neighbouring lanes per row, 16 columns each
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      float* srow = Ss + r * kSP + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, srow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      // column k0 is always a real key, so m_new is finite
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = expf(srow[j] - m_new);
        srow[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // the row's four lanes have read m_s[r]
      if (part == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        a_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V for rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * kSP + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = Vs[kk * DMAX + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    if (row < L) {
      const float inv_l = 1.f / l_s[r];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int c = tx + 16 * j;
        if (c < d) o[head + (size_t)row * d + c] = acc[i][j] * inv_l;
      }
    }
  }
  if (tid < kBQ && q0 + tid < L) {
    lse[(size_t)bh * L + q0 + tid] = m_s[tid] + logf(l_s[tid]);
  }
}

constexpr int kMaxDevices = 64;

template <int DMAX>
int launch(const float* q, const float* k, const float* v, float* o, float* lse,
           int bh, int L, int d, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DMAX>();
  // The opt-in to more than 48 KiB of dynamic shared memory holds per kernel
  // and device: set it at the first launch on each device, not every launch.
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<DMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev].store(true, std::memory_order_release);
  }
  const dim3 grid(bh, (L + kBQ - 1) / kBQ);
  flash_fwd_kernel<DMAX><<<grid, kThreads, smem, stream>>>(q, k, v, o, lse, L, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (bh, L, d) float32, contiguous; lse: (bh, L) float32.
// d % 8 == 0 and d <= 128. Returns the CUDA error of the launch.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                              void* lse, int bh, int L, int d, float scale,
                              void* stream) {
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 32) return launch<32>(qf, kf, vf, (float*)o, (float*)lse, bh, L, d, scale, s);
  if (d <= 64) return launch<64>(qf, kf, vf, (float*)o, (float*)lse, bh, L, d, scale, s);
  if (d <= 128) return launch<128>(qf, kf, vf, (float*)o, (float*)lse, bh, L, d, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Message of a CUDA error code returned by the entries above.
extern "C" const char* dmc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
