// Device code shared by the selective-scan kernels (selective_scan_fwd.cu,
// selective_scan_bwd.cu, selective_scan_split.cu), float32. With
// a_t = exp(dt_t A), u_t = dt_t x_t and the adjoint gamma_t = dL/dh_t,
//   h_t     = a_t h_{t-1} + u_t B_t,      y_t = sum_n C_t h_t
//   gamma_t = C_t ybar_t + a_{t+1} gamma_{t+1}       (phi = a_{t+1} gamma_{t+1})
//   dx_t  = (sum_n gamma B_t) dt_t
//   ddt_t = sum_n gamma h_{t-1} a_t A + (sum_n gamma B_t) x_t
//   dB_t  = sum_d gamma u_t,  dC_t = sum_d h_t ybar_t,
//   dA    = sum_t gamma h_{t-1} a_t dt_t                (per batch row)
// over x, dt, y, g = ybar (batch, L, D); A (D, N); B, C (batch, L, N); bound
// (batch, n_blocks, N, D), the state entering each time block of T steps.
//
// Every kernel gives one thread one (batch row, channel) with its N states
// (padded to NMAX = 16 or 32; the states past N have A = B = C = 0 and stay
// 0) in registers, and one block 128 channels of one row, so x, dt, y and
// the gradients move coalesced along D and the recurrences need no
// cross-thread traffic. What differs between the kernels is the range of
// time steps a block walks and where its first state or adjoint comes from.
// expf, not __expf: the bars against the plain versions are 2e-5 and 1e-4.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace dmc_scan {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxT = 32;

inline int tiles_for(int D) { return (D + kThreads - 1) / kThreads; }

template <int NMAX>
__device__ __forceinline__ void load_a(float (&a_coef)[NMAX],
                                       const float* __restrict__ A, int d,
                                       int N, bool active) {
#pragma unroll
  for (int n = 0; n < NMAX; ++n)
    a_coef[n] = (active && n < N) ? A[(size_t)d * N + n] : 0.f;
}

// h over the steps [t_begin, t_end) with no output; returns the sum of dt
// over them (exp(A * sum) is the product of the range's decays).
template <int NMAX>
__device__ __forceinline__ float scan_advance(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float (&a_coef)[NMAX],
    float (&h)[NMAX], size_t row, int d, bool active, int D, int N,
    int t_begin, int t_end) {
  float sum = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    const size_t off = (row + t) * D + d;
    const float dtv = active ? dt[off] : 0.f;
    const float u = active ? dtv * x[off] : 0.f;
    const float* Bt = Bm + (row + t) * N;
    sum += dtv;
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      const float bn = n < N ? Bt[n] : 0.f;
      h[n] = expf(dtv * a_coef[n]) * h[n] + u * bn;
    }
  }
  return sum;
}

// The forward over the time blocks [k_begin, k_end) from the state h: y,
// and (bound != null) the state entering each block, except the first when
// `skip_first_bound` (the caller read h from that very row). B_t and C_t,
// shared by every channel of the row, are staged in the block's shared
// memory Bs, Cs one time block at a time. Every thread of the block must
// call it (it synchronises), active or not.
template <int NMAX>
__device__ __forceinline__ void scan_fwd_blocks(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    float* __restrict__ y, float* bound, const float (&a_coef)[NMAX],
    float (&h)[NMAX], float (*Bs)[NMAX], float (*Cs)[NMAX], int b, int d,
    bool active, int L, int D, int N, int T, int k_begin, int k_end,
    bool skip_first_bound) {
  const int n_blocks = (L + T - 1) / T;
  const size_t row = (size_t)b * L;
  for (int k = k_begin; k < k_end; ++k) {
    const int t0 = k * T;
    const int len = min(T, L - t0);
    __syncthreads();  // every thread is done with the previous block's B, C
    for (int i = threadIdx.x; i < len * NMAX; i += kThreads) {
      const int s = i / NMAX;
      const int n = i - s * NMAX;
      const size_t off = (row + t0 + s) * N + n;
      Bs[s][n] = n < N ? Bm[off] : 0.f;
      Cs[s][n] = n < N ? Cm[off] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    if (bound != nullptr && !(skip_first_bound && k == k_begin)) {
      float* bk = bound + ((size_t)b * n_blocks + k) * N * D + d;
#pragma unroll
      for (int n = 0; n < NMAX; ++n)
        if (n < N) bk[(size_t)n * D] = h[n];
    }
    for (int s = 0; s < len; ++s) {
      const size_t off = (row + t0 + s) * D + d;
      const float dtv = dt[off];
      const float u = dtv * x[off];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        const float a = expf(dtv * a_coef[n]);
        h[n] = a * h[n] + u * Bs[s][n];
        acc = fmaf(Cs[s][n], h[n], acc);
      }
      y[off] = acc;
    }
  }
}

// Sum over the warp of each of the 32 values v[i]: lane l returns the sum
// of v[l]. v is clobbered.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32], int lane) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    const bool upper = lane & s;
#pragma unroll
    for (int i = 0; i < s; ++i) {
      const float send = upper ? v[i] : v[i + s];
      const float keep = upper ? v[i + s] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, s);
    }
  }
  return v[0];
}

// Steps of a sub-block of the reverse sweep, and the dB then dC values of
// one step.
template <int NMAX>
struct BwdShape {
  static constexpr int SUB = 64 / NMAX;  // states held: (SUB + 1) * NMAX
  static constexpr int W = 2 * NMAX;
};

// The reverse sweep over the steps [t_begin, t_end), t_begin a multiple of
// T, from the adjoint carry phi (a_{t+1} gamma_{t+1} of step t_end - 1) and
// the state entering each time block, which the thread reads at
// bound_col[k * stride_k + n * stride_n] (device or shared memory). Writes
// dx, ddt and the block's dB/dC sums over its 128 channels into `partial`
// (batch, n_tiles, L, W); adds to da; leaves phi as the carry into step
// t_begin - 1.
// * A thread cannot hold a time block's states (T x N = 512 floats). It
//   walks sub-blocks of SUB steps (4 at N <= 16) in reverse, recomputes each
//   one's states from the saved state of its time block into registers
//   (SUB + 1 states), then walks them backwards. The recompute runs forward,
//   never h_{t-1} = (h_t - b_t) / a_t, which is unstable where a_t
//   underflows.
// * dB_t and dC_t sum over D: the 2N values of each step are summed over a
//   warp with a transposing butterfly (31 shuffles, lane l ends with value
//   l), over the block's warps in shared memory `red`, and each block writes
//   its 128 channels' sums; `scan_bwd_sum_kernel` sums the tiles. No
//   atomics: the result is deterministic.
// Every thread of the block must call it (it synchronises).
template <int NMAX>
__device__ __forceinline__ void scan_bwd_range(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ g, const float* bound_col, size_t stride_k,
    size_t stride_n, float* __restrict__ dx, float* __restrict__ ddt,
    float* __restrict__ partial, const float (&a_coef)[NMAX],
    float (&phi)[NMAX], float (&da)[NMAX],
    float (*red)[BwdShape<NMAX>::SUB][BwdShape<NMAX>::W], int b, int tile,
    int n_tiles, int d, bool active, int L, int D, int N, int T, int t_begin,
    int t_end) {
  constexpr int SUB = BwdShape<NMAX>::SUB;
  constexpr int W = BwdShape<NMAX>::W;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = (size_t)b * L;

  for (int j = (t_end + SUB - 1) / SUB - 1; j >= t_begin / SUB; --j) {
    const int t0 = j * SUB;
    const int len = min(SUB, t_end - t0);
    const int k = t0 / T;
    // hist[s] is the state before step t0 + s, hist[s + 1] the one after
    float hist[SUB + 1][NMAX];
    const float* bk = bound_col + (size_t)k * stride_k;
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      hist[0][n] = (active && n < N) ? bk[(size_t)n * stride_n] : 0.f;
    // from the time block's start to t0
    scan_advance<NMAX>(x, dt, Bm, a_coef, hist[0], row, d, active, D, N, k * T,
                       t0);
#pragma unroll
    for (int s = 0; s < SUB; ++s) {
      if (s < len) {
        const size_t off = (row + t0 + s) * D + d;
        const float dtv = active ? dt[off] : 0.f;
        const float u = active ? dtv * x[off] : 0.f;
        const float* Bt = Bm + (row + t0 + s) * N;
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          const float bn = n < N ? Bt[n] : 0.f;
          hist[s + 1][n] = expf(dtv * a_coef[n]) * hist[s][n] + u * bn;
        }
      }
    }

#pragma unroll
    for (int s = SUB - 1; s >= 0; --s) {
      if (s < len) {  // the same for every thread of the block
        const size_t off = (row + t0 + s) * D + d;
        const float dtv = active ? dt[off] : 0.f;
        const float xv = active ? x[off] : 0.f;
        const float gv = active ? g[off] : 0.f;
        const float u = dtv * xv;
        const float* Bt = Bm + (row + t0 + s) * N;
        const float* Ct = Cm + (row + t0 + s) * N;
        float v[W / 32][32];
        float g_b = 0.f, ddt_acc = 0.f;
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          const float bn = n < N ? Bt[n] : 0.f;
          const float cn = n < N ? Ct[n] : 0.f;
          const float a = expf(dtv * a_coef[n]);
          const float gam = cn * gv + phi[n];
          const float dadec = gam * hist[s][n] * a;
          ddt_acc = fmaf(dadec, a_coef[n], ddt_acc);
          g_b = fmaf(gam, bn, g_b);
          da[n] = fmaf(dadec, dtv, da[n]);
          v[n >> 5][n & 31] = gam * u;
          v[(NMAX + n) >> 5][(NMAX + n) & 31] = hist[s + 1][n] * gv;
          phi[n] = a * gam;
        }
        if (active) {
          dx[off] = g_b * dtv;
          ddt[off] = fmaf(g_b, xv, ddt_acc);
        }
#pragma unroll
        for (int r = 0; r < W / 32; ++r)
          red[warp][s][r * 32 + lane] = warp_transpose_sum(v[r], lane);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < len * W; i += kThreads) {
      const int s = i / W;
      const int c = i - s * W;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w][s][c];
      partial[(((size_t)b * n_tiles + tile) * L + t0 + s) * W + c] = sum;
    }
    __syncthreads();  // red is rewritten by the next sub-block
  }
}

// dB, dC (batch, L, N) from the per-tile sums: one thread per element.
// static: each source that includes this header links its own copy.
static __global__ void __launch_bounds__(256)
scan_bwd_sum_kernel(const float* __restrict__ partial, float* __restrict__ dB,
                    float* __restrict__ dC, int batch, int L, int N, int tiles,
                    int W) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)batch * L * N) return;
  const int n = (int)(i % N);
  const size_t bt = i / N;
  const size_t b = bt / L;
  const size_t t = bt - b * L;
  float sb = 0.f, sc = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    const float* p = partial + ((b * tiles + tile) * L + t) * W;
    sb += p[n];
    sc += p[W / 2 + n];
  }
  dB[i] = sb;
  dC[i] = sc;
}

inline int launch_bwd_sum(const float* partial, float* dB, float* dC, int batch,
                          int L, int D, int N, int W, cudaStream_t stream) {
  const size_t total = (size_t)batch * L * N;
  scan_bwd_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      partial, dB, dC, batch, L, N, tiles_for(D), W);
  return (int)cudaGetLastError();
}

}  // namespace dmc_scan
