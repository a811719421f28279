// Selective-scan forward (the Mamba recurrence) on float32:
//   a_t = exp(dt_t * A),  h_t = a_t * h_{t-1} + (dt_t * x_t) B_t,
//   y_t = sum_n C_t[n] h_t[n]          (the caller adds the D skip)
// over x, dt, y (batch, L, D); A (D, N); B, C (batch, L, N); and, when asked
// for, bound (batch, n_blocks, N, D): the state entering each time block.
//
// Replaces diffusion_models_collection_tpu/ops/selective_scan_pallas.py:
// _scan_kernel_blocked (K5, states off), _scan_kernel_blocked_ckpt (K6,
// states on) and _scan_kernel (K4, any L: here the ragged last block).
//
// What bounds it on an H100: the N exponentials per (row, channel, step),
// which go to the special-function units, and the serial dependence of
// h_t on h_{t-1}. Device memory sees x, dt and y once (12 bytes per element)
// and B, C once per row. Design: one thread per (batch row, channel) with
// its N states in registers, a block covering 128 channels of one row, so
// x, dt and y move coalesced along D and the recurrence needs no
// cross-thread traffic; the N independent state chains give each thread
// the instruction-level parallelism the serial time axis does not. B_t and
// C_t, shared by every channel of the row, are staged in shared memory one
// time block (T = 32 or 16 steps, the JAX kernels' blocks) at a time; the
// states past N (N is padded up to 16 or 32) have A = B = C = 0 and stay 0.
// The walk over the time blocks is `scan_fwd_blocks` of
// selective_scan_common.cuh, which the time-split forward shares.

#include "selective_scan_common.cuh"

namespace {

using namespace dmc_scan;

template <int NMAX>
__global__ void __launch_bounds__(kThreads)
scan_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ bound, int L, int D, int N, int T) {
  __shared__ float Bs[kMaxT][NMAX];
  __shared__ float Cs[kMaxT][NMAX];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool active = d < D;

  float a_coef[NMAX], h[NMAX];
  load_a<NMAX>(a_coef, A, d, N, active);
#pragma unroll
  for (int n = 0; n < NMAX; ++n) h[n] = 0.f;
  scan_fwd_blocks<NMAX>(x, dt, Bm, Cm, y, bound, a_coef, h, Bs, Cs, b, d,
                        active, L, D, N, T, 0, (L + T - 1) / T, false);
}

template <int NMAX>
int launch(const float* x, const float* dt, const float* A, const float* B,
           const float* C, float* y, float* bound, int batch, int L, int D,
           int N, int T, cudaStream_t stream) {
  const dim3 grid(tiles_for(D), batch);
  scan_fwd_kernel<NMAX><<<grid, kThreads, 0, stream>>>(x, dt, A, B, C, y,
                                                       bound, L, D, N, T);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dt, y: (batch, L, D); A: (D, N); B, C: (batch, L, N); bound: null, or
// (batch, ceil(L / T), N, D). All float32, contiguous. 1 <= N <= 32,
// T (the time block) <= 32. Returns the CUDA error of the launch.
extern "C" int selective_scan_fwd(const void* x, const void* dt, const void* A,
                                  const void* B, const void* C, void* y,
                                  void* bound, int batch, int L, int D, int N,
                                  int T, void* stream) {
  if (N < 1 || N > 32 || T < 1 || T > kMaxT) return (int)cudaErrorInvalidValue;
  auto f = N <= 16 ? &launch<16> : &launch<32>;
  return f((const float*)x, (const float*)dt, (const float*)A, (const float*)B,
           (const float*)C, (float*)y, (float*)bound, batch, L, D, N, T,
           (cudaStream_t)stream);
}
