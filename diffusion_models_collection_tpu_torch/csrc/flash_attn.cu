// Flash-attention forward on (BH, L, d) float32 q, k, v: o = softmax(q k^T /
// sqrt(d)) v and the row logsumexp lse = log(sum(exp(q k^T / sqrt(d)))),
// (BH, L). The backward (flash_attn_bwd.cu) recomputes P from lse.
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
// d % 8 == 0 up to 128 runs, zero-padded to DMAX of 32, 64 or 128.
// Measured on an H100 80GB HBM3 at 700 W (tools/profile_torch_kernels.py,
// from a CUDA graph): 0.29 ms a call at BH 640, L 256, d 64 against 0.36 for
// the four-by-four form and a bound of 0.16 ms (operations).

#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

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

// Request rows r0 .. r0 + ROWS - 1 of one head's (L, d) matrix into a
// (ROWS, DMAX + 4) tile, zero past L and past d. d % 4 == 0.
template <int DMAX, int ROWS, int NT>
__device__ __forceinline__ void request_rows(float* dst,
                                             const float* __restrict__ src,
                                             int r0, int L, int d, int tid) {
  constexpr int V = DMAX / 4;  // 16-byte pieces of a row
  for (int i = tid; i < ROWS * V; i += NT) {
    const int r = i / V;
    const int c = (i - r * V) * 4;
    const bool ok = r0 + r < L && c < d;
    cp_async16(dst + r * (DMAX + 4) + c,
               ok ? src + (size_t)(r0 + r) * d + c : src, ok);
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

template <int DMAX, int BQ, int BK, int RA, int KB>
__global__ void __launch_bounds__(Cfg<DMAX, BQ, BK, RA, KB>::NT,
                                  Cfg<DMAX, BQ, BK, RA, KB>::MIN_BLOCKS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int L, int d, float scale_log2) {
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
  const size_t head = (size_t)bh * L * d;
  const float* kh = k + head;
  const float* vh = v + head;

  request_rows<DMAX, BQ, C::NT>(Qs, q + head, q0, L, d, tid);
  request_rows<DMAX, BK, C::NT>(Ks, kh, 0, L, d, tid);
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

  for (int k0 = 0; k0 < L; k0 += BK) {
    cp_async_wait_all();
    __syncthreads();  // this K tile is in; every thread is past the last P V
    // V flies during Q K^T and the softmax
    request_rows<DMAX, BK, C::NT>(Vs, vh, k0, L, d, tid);
    cp_async_commit();

    float s[RA][KB];
    rows_dot<DMAX, BQ, BK, RA, KB>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int b = 0; b < KB; ++b) {
        // key k0 (tx 0, b 0) is always real, so the row's max is finite
        s[a][b] = k0 + tx + C::TX * b < L ? s[a][b] * scale_log2 : -INFINITY;
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
#pragma unroll
      for (int b = 0; b < KB; ++b) {
        const float p = fast_exp2(s[a][b] - m_new);
        l[a] += p;
        prow[C::TX * b] = p;
      }
    }
    cp_async_wait_all();
    __syncthreads();  // P is whole and V is in; the K tile is read
    if (k0 + BK < L) {  // the next K tile flies during P V
      request_rows<DMAX, BK, C::NT>(Ks, kh, k0 + BK, L, d, tid);
      cp_async_commit();
    }
    pv_product<DMAX, BQ, BK, RA, KB>(Ps, Vs, ty, tx, acc);
  }

#pragma unroll
  for (int a = 0; a < RA; ++a) {
    float sum = l[a];
#pragma unroll
    for (int off = C::TX / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int row = q0 + ty + C::TY * a;
    if (row < L) {
      const float inv = 1.f / sum;
#pragma unroll
      for (int b = 0; b < C::DC; ++b) acc[a][b] *= inv;
#pragma unroll
      for (int g = 0; g < C::G; ++g) {
        const int c = C::VW * (tx + C::TX * g);
        if (c < d)
          store_vec<C::VW>(o + head + (size_t)row * d + c, acc[a] + g * C::VW);
      }
      if (tx == 0) lse[(size_t)bh * L + row] = m[a] * kLn2 + logf(sum);
    }
  }
}

template <int DMAX, int BQ, int BK, int RA, int KB>
int launch(const float* q, const float* k, const float* v, float* o, float* lse,
           int bh, int L, int d, float scale, cudaStream_t stream) {
  using C = Cfg<DMAX, BQ, BK, RA, KB>;
  // The opt-in to more than 48 KiB of dynamic shared memory holds per kernel
  // and device: set it at the first launch on each device, not every launch.
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<DMAX, BQ, BK, RA, KB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::SMEM);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev].store(true, std::memory_order_release);
  }
  const dim3 grid(bh, (L + BQ - 1) / BQ);
  flash_fwd_kernel<DMAX, BQ, BK, RA, KB><<<grid, C::NT, C::SMEM, stream>>>(
      q, k, v, o, lse, L, d, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (bh, L, d) float32, contiguous, 16-byte aligned; lse: (bh, L)
// float32. d % 8 == 0 and d <= 128. `tile` is the query tile height: 32 or
// 128 for d <= 64, 64 for d > 64. Returns the CUDA error of the launch.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                              void* lse, int bh, int L, int d, float scale,
                              int tile, void* stream) {
  if (d < 8 || d % 8 || d > 128 ||
      !(d <= 64 ? tile == 32 || tile == 128 : tile == 64))
    return (int)cudaErrorInvalidValue;
  auto f = &launch<128, 64, 64, 4, 4>;
  if (tile == 32)
    f = d <= 32 ? &launch<32, 32, 32, 4, 4> : &launch<64, 32, 32, 4, 4>;
  else if (tile == 128)
    f = d <= 32 ? &launch<32, 128, 64, 8, 8> : &launch<64, 128, 64, 8, 8>;
  return f((const float*)q, (const float*)k, (const float*)v, (float*)o,
           (float*)lse, bh, L, d, scale, (cudaStream_t)stream);
}

// Message of a CUDA error code returned by the entries above.
extern "C" const char* dmc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
