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
// which go to the special-function units (0.120 ms a call at batch 160,
// L 256, D 768, N 16, where the bytes need 0.114 ms), the instruction rate
// around them and the serial dependence of h_t on h_{t-1}. Design
// (`scan_fwd_walk` of selective_scan_common.cuh, where the argument is in
// full): four lanes share a channel, N / 4 states each, and a block of 256
// threads covers 64 channels of one row, so the grid has four times the
// threads of a thread-a-channel layout at a quarter of the registers; a
// decay is one multiply and one ex2.approx; x, dt, B_t and C_t of a time
// block (T = 32 or 16 steps, the JAX kernels' blocks) arrive in shared
// memory by cp.async while the block before is walked; y is summed over the
// four lanes by a transposing butterfly every four steps and stored straight
// to device memory. The states past N (N is padded up to 16 or 32) have A =
// B = C = 0 and stay 0. A time-split form without saved states (the passes
// of selective_scan_split.cu with a scratch row a chunk) was tried for few
// rows at L 1024: three launches and the exponentials twice lost to this
// walk from two rows up and tied at one, so there is none.
// Measured on an H100 80GB HBM3 at 700 W (tools/profile_torch_kernels.py,
// launches in a row, ms; a thread a channel with expf before): batch 160,
// L 256, D 768, N 16 0.217-0.219 (0.353); with states at batch 128 0.184-
// 0.186 (0.289); 16 rows, L 1024 0.130-0.131 (0.696); batch 32, L 100
// 0.038-0.049 (0.053).

#include "selective_scan_common.cuh"

namespace {

using namespace dmc_scan;

template <int NMAX>
__global__ void __launch_bounds__(kBwdThreads, NMAX <= 16 ? kFwdBlocks : 3)
scan_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ bound, int L, int D, int N, int T,
                FwdCopy copy) {
  constexpr int SPL = NMAX / kBwdLanes;
  __shared__ FwdShared<NMAX> sm;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kBwdChannels;
  const int d = d0 + (threadIdx.x >> 2);
  const int q = threadIdx.x & (kBwdLanes - 1);
  const bool active = d < D;

  float a2[SPL], h[SPL];
  load_a_lane<SPL>(a2, A, d, q, N, active);
#pragma unroll
  for (int i = 0; i < SPL; ++i) h[i] = 0.f;
  scan_fwd_walk<NMAX, true>(x, dt, Bm, Cm, y, bound, a2, h, sm, b, d0, active,
                            L, D, N, T, 0, (L + T - 1) / T, false, copy);
}

template <int NMAX>
int launch(const float* x, const float* dt, const float* A, const float* B,
           const float* C, float* y, float* bound, int batch, int L, int D,
           int N, int T, cudaStream_t stream) {
  const dim3 grid(bwd_tiles_for(D), batch);
  scan_fwd_kernel<NMAX><<<grid, kBwdThreads, 0, stream>>>(
      x, dt, A, B, C, y, bound, L, D, N, T, fwd_copy_for(x, dt, B, C, D, N));
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
