// Selective-scan backward from the forward's block states, float32. With
// a_t = exp(dt_t A), u_t = dt_t x_t and the adjoint gamma_t = dL/dh_t,
//   gamma_t = C_t ybar_t + a_{t+1} gamma_{t+1}       (phi = a_{t+1} gamma_{t+1})
//   dx_t  = (sum_n gamma B_t) dt_t
//   ddt_t = sum_n gamma h_{t-1} a_t A + (sum_n gamma B_t) x_t
//   dB_t  = sum_d gamma u_t,  dC_t = sum_d h_t ybar_t,
//   dA    = sum_t gamma h_{t-1} a_t dt_t                (per batch row)
// over x, dt, g = ybar (batch, L, D); A (D, N); B, C (batch, L, N); bound
// (batch, n_blocks, N, D), the state entering each time block of T steps.
//
// Replaces diffusion_models_collection_tpu/ops/selective_scan_pallas.py:
// _scan_bwd_kernel_from_ckpt with _bwd_block_body (K8).
//
// What bounds it on an H100: the exponentials (N per channel and step, for
// each recomputed state and again in the reverse walk) and the sums over
// the D channels of dB and dC. Design, one thread per (batch row, channel),
// 128 channels of one row per block:
// * The TPU kernel holds a whole time block's states; a thread cannot (T x N
//   = 512 floats). It walks sub-blocks of SUB steps (4 at N <= 16) in
//   reverse, recomputes each one's states from the saved state of its time
//   block into registers (SUB + 1 states), then walks them backwards. The
//   recompute runs forward, never h_{t-1} = (h_t - b_t) / a_t, which is
//   unstable where a_t = exp(dt A) underflows.
// * dx, ddt and dA need only per-thread sums over N.
// * dB_t and dC_t sum over D: the 2N values of each step are summed over a
//   warp with a transposing butterfly (31 shuffles, lane l ends with value
//   l), over the block's warps in shared memory, and each block writes its
//   128 channels' sums to `partial` (batch, tiles, L, 2 NMAX); a second
//   kernel sums the tiles. No atomics: the result is deterministic.
// * dA is written per row (batch, D, N) and summed over the batch by the
//   caller, as the JAX wrapper does.
// States past N (N padded to 16 or 32) have A = B = C = 0 and contribute 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

template <int NMAX>
__global__ void __launch_bounds__(kThreads)
scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ g,
                const float* __restrict__ bound, float* __restrict__ dx,
                float* __restrict__ ddt, float* __restrict__ da_rows,
                float* __restrict__ partial, int L, int D, int N, int T) {
  constexpr int SUB = 64 / NMAX;  // states held: (SUB + 1) * NMAX registers
  constexpr int W = 2 * NMAX;     // dB then dC values of one step
  __shared__ float red[kWarps][SUB][W];
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int d = tile * kThreads + threadIdx.x;
  const bool active = d < D;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_blocks = (L + T - 1) / T;
  const int n_sub = (L + SUB - 1) / SUB;
  const size_t row = (size_t)b * L;

  float a_coef[NMAX], phi[NMAX], da[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    a_coef[n] = (active && n < N) ? A[(size_t)d * N + n] : 0.f;
    phi[n] = 0.f;
    da[n] = 0.f;
  }

  for (int j = n_sub - 1; j >= 0; --j) {
    const int t0 = j * SUB;
    const int len = min(SUB, L - t0);
    const int k = t0 / T;
    // hist[s] is the state before step t0 + s, hist[s + 1] the one after
    float hist[SUB + 1][NMAX];
    const float* bk = bound + ((size_t)b * n_blocks + k) * N * D + d;
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      hist[0][n] = (active && n < N) ? bk[(size_t)n * D] : 0.f;
    for (int t = k * T; t < t0; ++t) {  // from the block's start to t0
      const size_t off = (row + t) * D + d;
      const float dtv = active ? dt[off] : 0.f;
      const float u = active ? dtv * x[off] : 0.f;
      const float* Bt = Bm + (row + t) * N;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        const float bn = n < N ? Bt[n] : 0.f;
        hist[0][n] = expf(dtv * a_coef[n]) * hist[0][n] + u * bn;
      }
    }
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
      partial[(((size_t)b * gridDim.x + tile) * L + t0 + s) * W + c] = sum;
    }
    __syncthreads();  // red is rewritten by the next sub-block
  }

  if (active) {
    float* out = da_rows + ((size_t)b * D + d) * N;
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (n < N) out[n] = da[n];
  }
}

// dB, dC (batch, L, N) from the per-tile sums: one thread per element.
__global__ void __launch_bounds__(256)
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

int tiles_for(int D) { return (D + kThreads - 1) / kThreads; }
int width_for(int N) { return N <= 16 ? 32 : 64; }

template <int NMAX>
int launch(const float* x, const float* dt, const float* A, const float* B,
           const float* C, const float* g, const float* bound, float* dx,
           float* ddt, float* da_rows, float* dB, float* dC, float* partial,
           int batch, int L, int D, int N, int T, cudaStream_t stream) {
  const dim3 grid(tiles_for(D), batch);
  scan_bwd_kernel<NMAX><<<grid, kThreads, 0, stream>>>(
      x, dt, A, B, C, g, bound, dx, ddt, da_rows, partial, L, D, N, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)batch * L * N;
  scan_bwd_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      partial, dB, dC, batch, L, N, tiles_for(D), 2 * NMAX);
  return (int)cudaGetLastError();
}

}  // namespace

// The tile count and the per-step width of `partial` for D and N.
extern "C" int selective_scan_bwd_tiles(int D) { return tiles_for(D); }
extern "C" int selective_scan_bwd_width(int N) { return width_for(N); }

// x, dt, g, dx, ddt: (batch, L, D); A: (D, N); B, C, dB, dC: (batch, L, N);
// bound: (batch, ceil(L / T), N, D); da_rows: (batch, D, N); partial:
// (batch, selective_scan_bwd_tiles(D), L, selective_scan_bwd_width(N))
// scratch. All float32, contiguous. 1 <= N <= 32, 1 <= T <= 32. Returns the
// CUDA error of the launches.
extern "C" int selective_scan_bwd(const void* x, const void* dt, const void* A,
                                  const void* B, const void* C, const void* g,
                                  const void* bound, void* dx, void* ddt,
                                  void* da_rows, void* dB, void* dC,
                                  void* partial, int batch, int L, int D, int N,
                                  int T, void* stream) {
  if (N < 1 || N > 32 || T < 1 || T > 32) return (int)cudaErrorInvalidValue;
  auto f = N <= 16 ? &launch<16> : &launch<32>;
  return f((const float*)x, (const float*)dt, (const float*)A, (const float*)B,
           (const float*)C, (const float*)g, (const float*)bound, (float*)dx,
           (float*)ddt, (float*)da_rows, (float*)dB, (float*)dC,
           (float*)partial, batch, L, D, N, T, (cudaStream_t)stream);
}
