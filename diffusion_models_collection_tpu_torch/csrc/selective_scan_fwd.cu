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
// The stated form (`selective_scan_fwd_state`, E4: the JAX package's
// `selective_scan_with_state`, whose TPU path is XLA's, for the
// sequence-parallel DiM's distributed scan): the walk starts from h_in
// (batch, D, N) instead of zeros and writes the state after the last step to
// h_out (batch, D, N); block 0's saved state is h_in. With y null it writes
// no y and reads no C (the distributed scan's first pass wants h_out alone).
// The same walk, two loads and two stores a lane more.
// Any N: past 32 states the entries walk them in chunks of 32, one launch a
// chunk, each adding its share to y (`for_state_chunks`,
// selective_scan_common.cuh).
// Measured on an H100 80GB HBM3 at 700 W (tools/profile_torch_kernels.py,
// launches in a row, ms; a thread a channel with expf before): batch 160,
// L 256, D 768, N 16 0.217-0.219 (0.353); with states at batch 128 0.184-
// 0.186 (0.289); 16 rows, L 1024 0.130-0.131 (0.696); batch 32, L 100
// 0.038-0.049 (0.053).

#include "selective_scan_common.cuh"

namespace {

using namespace dmc_scan;

// OUT: y is written (added to with `acc`). h_in, h_out: null (a zero first
// state, no last one), or (batch, D, NS). The N states from A, B, C, bound,
// h_in, h_out on are a chunk of NS.
template <int NMAX, bool OUT>
__global__ void __launch_bounds__(kBwdThreads, NMAX <= 16 ? kFwdBlocks : 3)
scan_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ bound, const float* __restrict__ h_in,
                float* __restrict__ h_out, int L, int D, int N, int NS, int T,
                bool acc, FwdCopy copy) {
  constexpr int SPL = NMAX / kBwdLanes;
  __shared__ FwdShared<NMAX> sm;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kBwdChannels;
  const int d = d0 + (threadIdx.x >> 2);
  const int q = threadIdx.x & (kBwdLanes - 1);
  const bool active = d < D;
  const size_t state = ((size_t)b * D + d) * NS;  // (b, d, 0) of h_in, h_out

  float a2[SPL], h[SPL];
  load_a_lane<SPL>(a2, A, d, q, N, NS, active);
  if (h_in != nullptr) {
    load_lane_states<SPL>(h, h_in + (active ? state : 0), 1, q, N, active);
  } else {
#pragma unroll
    for (int i = 0; i < SPL; ++i) h[i] = 0.f;
  }
  scan_fwd_walk<NMAX, OUT, false>(x, dt, Bm, Cm, y, bound, a2, h, sm, b, d0,
                                  active, L, D, N, NS, T, 0, (L + T - 1) / T,
                                  false, acc, copy);
  if (h_out != nullptr && active)
    store_lane_states<SPL>(h_out + state, 1, h, q, N);
}

// One chunk: states n0 .. n0 + N - 1 of NS.
template <int NMAX>
int launch(const float* x, const float* dt, const float* A, const float* B,
           const float* C, float* y, float* bound, const float* h_in,
           float* h_out, int batch, int L, int D, int n0, int N, int NS,
           int T, cudaStream_t stream) {
  const dim3 grid(bwd_tiles_for(D), batch);
  A += n0;
  B += n0;
  if (C != nullptr) C += n0;
  if (bound != nullptr) bound += (size_t)n0 * D;
  if (h_in != nullptr) h_in += n0;
  if (h_out != nullptr) h_out += n0;
  const FwdCopy copy = fwd_copy_for(x, dt, B, C, D, N, NS);
  if (y != nullptr)
    scan_fwd_kernel<NMAX, true><<<grid, kBwdThreads, 0, stream>>>(
        x, dt, A, B, C, y, bound, h_in, h_out, L, D, N, NS, T, n0 > 0, copy);
  else
    scan_fwd_kernel<NMAX, false><<<grid, kBwdThreads, 0, stream>>>(
        x, dt, A, B, C, y, bound, h_in, h_out, L, D, N, NS, T, n0 > 0, copy);
  return (int)cudaGetLastError();
}

// Every chunk of the N states in turn.
int launch_chunks(const float* x, const float* dt, const float* A,
                  const float* B, const float* C, float* y, float* bound,
                  const float* h_in, float* h_out, int batch, int L, int D,
                  int N, int T, cudaStream_t stream) {
  return for_state_chunks(N, [&](int n0, int nc) {
    auto f = nc <= 16 ? &launch<16> : &launch<32>;
    return f(x, dt, A, B, C, y, bound, h_in, h_out, batch, L, D, n0, nc, N,
             T, stream);
  });
}

}  // namespace

// x, dt, y: (batch, L, D); A: (D, N); B, C: (batch, L, N); bound: null, or
// (batch, ceil(L / T), N, D). All float32, contiguous. N >= 1 (in chunks of
// 32 past 32), T (the time block) <= 32. Returns the CUDA error of the
// launches.
extern "C" int selective_scan_fwd(const void* x, const void* dt, const void* A,
                                  const void* B, const void* C, void* y,
                                  void* bound, int batch, int L, int D, int N,
                                  int T, void* stream) {
  if (N < 1 || T < 1 || T > kMaxT || y == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_chunks((const float*)x, (const float*)dt, (const float*)A,
                       (const float*)B, (const float*)C, (float*)y,
                       (float*)bound, nullptr, nullptr, batch, L, D, N, T,
                       (cudaStream_t)stream);
}

// The stated form (E4): as `selective_scan_fwd` from the state h_in
// (batch, D, N), writing the last state to h_out (batch, D, N); y may be
// null (no output: C is not read), bound may be null. float32, contiguous.
extern "C" int selective_scan_fwd_state(const void* x, const void* dt,
                                        const void* A, const void* B,
                                        const void* C, void* y, void* bound,
                                        const void* h_in, void* h_out,
                                        int batch, int L, int D, int N, int T,
                                        void* stream) {
  if (N < 1 || T < 1 || T > kMaxT || h_in == nullptr || h_out == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_chunks((const float*)x, (const float*)dt, (const float*)A,
                       (const float*)B, (const float*)C, (float*)y,
                       (float*)bound, (const float*)h_in, (float*)h_out, batch,
                       L, D, N, T, (cudaStream_t)stream);
}
