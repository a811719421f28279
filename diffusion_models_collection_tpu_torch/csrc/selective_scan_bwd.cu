// Selective-scan backward, float32: from the forward's block states, or with
// no saved state at all. The math and the reverse sweep (`scan_bwd_range`)
// are in selective_scan_common.cuh.
//
// Replaces diffusion_models_collection_tpu/ops/selective_scan_pallas.py:
// * _scan_bwd_kernel_from_ckpt with _bwd_block_body (K8): `selective_scan_bwd`,
//   the sweep over the whole sequence from `bound`, the states the forward
//   saved.
// * _scan_bwd_kernel (K7): `selective_scan_bwd_nostate`, for a forward that
//   saved nothing (gradient checkpointing keeps no residuals). One kernel:
//   phase 1 walks the sequence forward and keeps the state entering each
//   time block, phase 2 is K8's sweep from those. The TPU kernel kept the
//   block states in VMEM scratch; here a block's 64 channels need
//   n_blocks * N * 64 * 4 bytes (32 KB at L 256, T 32, N 16), which go to
//   dynamic shared memory while two blocks of them and of the sweep's own
//   48 KB still fit one SM (`kSharedBoundMax`), else to a scratch buffer in
//   device memory that the caller allocates. Either way a lane reads back
//   only what it wrote itself, so nothing synchronises.
//
// What bounds both on an H100: instruction rate and the exponential unit
// (N exponentials per channel and step for each recomputed state and again
// in the reverse walk; K7 adds one more forward walk of them), and the sums
// over the D channels of dB and dC; the bytes are a tenth of it. The sweep
// therefore splits each channel's states over four lanes, so that a lane
// keeps a 16-step history in registers and recomputes 2.5 exponentials per
// state and step at 16 warps an SM, stages the time block's operands in
// shared memory, and reduces dB/dC once per 16 steps: the whole argument is
// in selective_scan_common.cuh. Both kernels use its layout: 256 threads, 64
// channels, lane q of a channel with states q * NMAX / 4 onwards.
// dA is written per row (batch, D, N) and summed over the batch by the
// caller, as the JAX wrapper does.
// The stated form (`selective_scan_bwd_state`, E4: the backward of the JAX
// package's `selective_scan_with_state`, `_analytic_bwd(..., h0=h_in,
// phi0=g_hout)`, XLA's on the TPU): K8's sweep from the stated forward's
// bound (whose block 0 is h_in), its adjoint carry starting from the
// cotangent of h_out instead of zeros, and the carry it ends with, a_0
// gamma_0 = dL/dh_in, written out. A stated scan always saves its block
// states, under gradient checkpointing too (the recompute keeps them only
// inside its window), so there is no stated K7.
// Any N: past 32 states every entry runs its kernels once per chunk of 32,
// in turn, each adding its share to dx and ddt and writing its own columns
// of dA, dB, dC and dh_in (`for_state_chunks`, selective_scan_common.cuh);
// K7 rebuilds a chunk's block states in the same shared memory or scratch
// for each chunk.

#include <atomic>

#include "selective_scan_common.cuh"

namespace {

using namespace dmc_scan;

constexpr int kMaxDevices = 64;
// Block states in dynamic shared memory while two blocks an SM fit: half of
// what an SM offers (232,448 bytes), less the sweep's static 48 KB and the
// 1 KB the system keeps per block.
constexpr size_t kSharedBoundMax = 232448 / 2 - 49152 - 1024;

template <int NMAX, bool HAS_G>
__global__ void __launch_bounds__(kBwdThreads, 2)
scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ g,
                const float* __restrict__ bound, float* __restrict__ dx,
                float* __restrict__ ddt, float* __restrict__ da_rows,
                float* __restrict__ partial, const float* __restrict__ g_hout,
                float* __restrict__ dh_in, int L, int D, int N, int NS, int T,
                bool acc) {
  constexpr int SPL = BwdShape<NMAX>::SPL;
  __shared__ BwdShared<NMAX> sm;
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int d0 = tile * kBwdChannels;
  const int d = d0 + (threadIdx.x >> 2);
  const int q = threadIdx.x & (kBwdLanes - 1);
  const bool active = d < D;
  const int n_blocks = (L + T - 1) / T;
  const size_t state = ((size_t)b * D + d) * NS;  // (b, d, 0) of a state

  float a_coef[SPL], phi[SPL], da[SPL];
  load_a_lane<SPL>(a_coef, A, d, q, N, NS, active);
  // the adjoint entering the last step: the cotangent of h_out, or none
  if (g_hout != nullptr)
    load_lane_states<SPL>(phi, g_hout + (active ? state : 0), 1, q, N,
                          active);
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    if (g_hout == nullptr) phi[i] = 0.f;
    da[i] = 0.f;
  }
  scan_bwd_range<NMAX, HAS_G>(
      x, dt, Bm, Cm, g, bound + (size_t)b * n_blocks * NS * D + d,
      (size_t)NS * D, (size_t)D, dx, ddt, partial, a_coef, phi, da, sm, b,
      tile, gridDim.x, d0, active, L, D, N, NS, T, 0, L, acc);
  if (active) {
    store_lane_states<SPL>(da_rows + state, 1, da, q, N);
    if (dh_in != nullptr) store_lane_states<SPL>(dh_in + state, 1, phi, q, N);
  }
}

// K7. `scratch` is (batch, n_blocks, NS, D) in device memory, or null: the
// block states of the chunk's N states then live in dynamic shared memory,
// (n_blocks, N, 64).
template <int NMAX>
__global__ void __launch_bounds__(kBwdThreads, 2)
scan_bwd_nostate_kernel(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm,
                        const float* __restrict__ g, float* scratch,
                        float* __restrict__ dx, float* __restrict__ ddt,
                        float* __restrict__ da_rows,
                        float* __restrict__ partial, int L, int D, int N,
                        int NS, int T, bool acc) {
  constexpr int SPL = BwdShape<NMAX>::SPL;
  extern __shared__ float bound_smem[];
  __shared__ BwdShared<NMAX> sm;
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int d0 = tile * kBwdChannels;
  const int ch = threadIdx.x >> 2;
  const int d = d0 + ch;
  const int q = threadIdx.x & (kBwdLanes - 1);
  const bool active = d < D;
  const int n_blocks = (L + T - 1) / T;
  const size_t row = (size_t)b * L;

  float* col;
  size_t stride_k, stride_n;
  if (scratch != nullptr) {
    col = scratch + (size_t)b * n_blocks * NS * D + d;
    stride_k = (size_t)NS * D;
    stride_n = (size_t)D;
  } else {
    col = bound_smem + ch;
    stride_k = (size_t)N * kBwdChannels;
    stride_n = (size_t)kBwdChannels;
  }

  float a_coef[SPL], phi[SPL], da[SPL];
  load_a_lane<SPL>(a_coef, A, d, q, N, NS, active);
  // phase 1: the state entering each time block; phi holds h meanwhile
#pragma unroll
  for (int i = 0; i < SPL; ++i) phi[i] = 0.f;
  for (int k = 0; k < n_blocks; ++k) {
    if (active)
      store_lane_states<SPL>(col + (size_t)k * stride_k, stride_n, phi, q, N);
    if (k + 1 < n_blocks) {
      __syncthreads();  // the previous time block's staged steps are read
      stage_time_block<NMAX>(sm, x, dt, nullptr, Bm, nullptr, row, k * T, T,
                             d0, D, N, NS);
      __syncthreads();
      advance_staged<NMAX>(sm, a_coef, phi, q, ch, 0, T);
    }
  }
  // phase 2: the reverse sweep from them
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    phi[i] = 0.f;
    da[i] = 0.f;
  }
  scan_bwd_range<NMAX>(x, dt, Bm, Cm, g, col, stride_k, stride_n, dx, ddt,
                       partial, a_coef, phi, da, sm, b, tile, gridDim.x, d0,
                       active, L, D, N, NS, T, 0, L, acc);
  if (active)
    store_lane_states<SPL>(da_rows + ((size_t)b * D + d) * NS, 1, da, q, N);
}

// dB then dC of a step in `partial`: 2 NMAX of the (first) chunk
int width_for(int N) { return N <= 16 ? 32 : 64; }

// K7's block states of the largest chunk of N states in shared memory
size_t shared_bound_bytes(int L, int N, int T) {
  const int chunk = N < kStateChunk ? N : kStateChunk;
  return (size_t)((L + T - 1) / T) * chunk * kBwdChannels * sizeof(float);
}

// g null: the state-only form's backward (no cotangent of y). One chunk:
// states n0 .. n0 + N - 1 of NS.
template <int NMAX>
int launch(const float* x, const float* dt, const float* A, const float* B,
           const float* C, const float* g, const float* bound, float* dx,
           float* ddt, float* da_rows, float* dB, float* dC, float* partial,
           const float* g_hout, float* dh_in, int batch, int L, int D, int n0,
           int N, int NS, int T, cudaStream_t stream) {
  const dim3 grid(bwd_tiles_for(D), batch);
  auto kernel = g != nullptr ? &scan_bwd_kernel<NMAX, true>
                             : &scan_bwd_kernel<NMAX, false>;
  kernel<<<grid, kBwdThreads, 0, stream>>>(
      x, dt, A + n0, B + n0, C + n0, g, bound + (size_t)n0 * D, dx, ddt,
      da_rows + n0, partial, g_hout == nullptr ? nullptr : g_hout + n0,
      dh_in == nullptr ? nullptr : dh_in + n0, L, D, N, NS, T, n0 > 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_bwd_sum(partial, dB + n0, dC + n0, batch, L, D, N, NS,
                        2 * NMAX, stream);
}

int launch_chunks(const float* x, const float* dt, const float* A,
                  const float* B, const float* C, const float* g,
                  const float* bound, float* dx, float* ddt, float* da_rows,
                  float* dB, float* dC, float* partial, const float* g_hout,
                  float* dh_in, int batch, int L, int D, int N, int T,
                  cudaStream_t stream) {
  return for_state_chunks(N, [&](int n0, int nc) {
    auto f = nc <= 16 ? &launch<16> : &launch<32>;
    return f(x, dt, A, B, C, g, bound, dx, ddt, da_rows, dB, dC, partial,
             g_hout, dh_in, batch, L, D, n0, nc, N, T, stream);
  });
}

template <int NMAX>
int launch_nostate(const float* x, const float* dt, const float* A,
                   const float* B, const float* C, const float* g,
                   float* scratch, float* dx, float* ddt, float* da_rows,
                   float* dB, float* dC, float* partial, int batch, int L,
                   int D, int n0, int N, int NS, int T, cudaStream_t stream) {
  const size_t smem = scratch != nullptr ? 0 : shared_bound_bytes(L, N, T);
  if (smem > kSharedBoundMax) return (int)cudaErrorInvalidValue;
  // The opt-in to more than 48 KiB of dynamic shared memory holds per kernel
  // and device: set it at the first launch on each device, not every launch.
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(scan_bwd_nostate_kernel<NMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSharedBoundMax);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev].store(true, std::memory_order_release);
  }
  const dim3 grid(bwd_tiles_for(D), batch);
  scan_bwd_nostate_kernel<NMAX><<<grid, kBwdThreads, smem, stream>>>(
      x, dt, A + n0, B + n0, C + n0, g,
      scratch == nullptr ? nullptr : scratch + (size_t)n0 * D, dx, ddt,
      da_rows + n0, partial, L, D, N, NS, T, n0 > 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_bwd_sum(partial, dB + n0, dC + n0, batch, L, D, N, NS,
                        2 * NMAX, stream);
}

}  // namespace

// The tile count and the per-step width of `partial` for D and N.
extern "C" int selective_scan_bwd_tiles(int D) {
  return dmc_scan::bwd_tiles_for(D);
}
extern "C" int selective_scan_bwd_width(int N) { return width_for(N); }

// 1 when `selective_scan_bwd_nostate` needs its `scratch` in device memory
// for these sizes, 0 when the block states (of a chunk of at most 32 states)
// fit shared memory.
extern "C" int selective_scan_bwd_nostate_needs_scratch(int L, int N, int T) {
  return shared_bound_bytes(L, N, T) > kSharedBoundMax ? 1 : 0;
}

// x, dt, g, dx, ddt: (batch, L, D); A: (D, N); B, C, dB, dC: (batch, L, N);
// bound: (batch, ceil(L / T), N, D); da_rows: (batch, D, N); partial:
// (batch, selective_scan_bwd_tiles(D), L, selective_scan_bwd_width(N))
// scratch. All float32, contiguous. N >= 1 (in chunks of 32 past 32),
// 1 <= T <= 32. Returns the CUDA error of the launches.
extern "C" int selective_scan_bwd(const void* x, const void* dt, const void* A,
                                  const void* B, const void* C, const void* g,
                                  const void* bound, void* dx, void* ddt,
                                  void* da_rows, void* dB, void* dC,
                                  void* partial, int batch, int L, int D, int N,
                                  int T, void* stream) {
  if (N < 1 || T < 1 || T > 32 || g == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_chunks((const float*)x, (const float*)dt, (const float*)A,
                       (const float*)B, (const float*)C, (const float*)g,
                       (const float*)bound, (float*)dx, (float*)ddt,
                       (float*)da_rows, (float*)dB, (float*)dC,
                       (float*)partial, nullptr, nullptr, batch, L, D, N, T,
                       (cudaStream_t)stream);
}

// The stated form (E4): as `selective_scan_bwd` from the stated forward's
// `bound`, the adjoint starting from g_hout (batch, D, N), the cotangent of
// h_out, and dh_in (batch, D, N), the gradient of h_in, written too. g is
// null for the state-only forward's backward: no cotangent of y, dC is 0.
extern "C" int selective_scan_bwd_state(
    const void* x, const void* dt, const void* A, const void* B, const void* C,
    const void* g, const void* bound, const void* g_hout, void* dx, void* ddt,
    void* da_rows, void* dB, void* dC, void* partial, void* dh_in, int batch,
    int L, int D, int N, int T, void* stream) {
  if (N < 1 || T < 1 || T > 32 || g_hout == nullptr || dh_in == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_chunks((const float*)x, (const float*)dt, (const float*)A,
                       (const float*)B, (const float*)C, (const float*)g,
                       (const float*)bound, (float*)dx, (float*)ddt,
                       (float*)da_rows, (float*)dB, (float*)dC,
                       (float*)partial, (const float*)g_hout, (float*)dh_in,
                       batch, L, D, N, T, (cudaStream_t)stream);
}

// As `selective_scan_bwd` with no `bound`: `scratch` is null, or (batch,
// ceil(L / T), N, D) where `selective_scan_bwd_nostate_needs_scratch` says
// so.
extern "C" int selective_scan_bwd_nostate(
    const void* x, const void* dt, const void* A, const void* B, const void* C,
    const void* g, void* scratch, void* dx, void* ddt, void* da_rows, void* dB,
    void* dC, void* partial, int batch, int L, int D, int N, int T,
    void* stream) {
  if (N < 1 || T < 1 || T > 32) return (int)cudaErrorInvalidValue;
  return for_state_chunks(N, [&](int n0, int nc) {
    auto f = nc <= 16 ? &launch_nostate<16> : &launch_nostate<32>;
    return f((const float*)x, (const float*)dt, (const float*)A,
             (const float*)B, (const float*)C, (const float*)g,
             (float*)scratch, (float*)dx, (float*)ddt, (float*)da_rows,
             (float*)dB, (float*)dC, (float*)partial, batch, L, D, n0, nc, N,
             T, (cudaStream_t)stream);
  });
}
