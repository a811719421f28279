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

#include <atomic>

#include "selective_scan_common.cuh"

namespace {

using namespace dmc_scan;

constexpr int kMaxDevices = 64;
// Block states in dynamic shared memory while two blocks an SM fit: half of
// what an SM offers (232,448 bytes), less the sweep's static 48 KB and the
// 1 KB the system keeps per block.
constexpr size_t kSharedBoundMax = 232448 / 2 - 49152 - 1024;

template <int NMAX>
__global__ void __launch_bounds__(kBwdThreads, 2)
scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ g,
                const float* __restrict__ bound, float* __restrict__ dx,
                float* __restrict__ ddt, float* __restrict__ da_rows,
                float* __restrict__ partial, int L, int D, int N, int T) {
  constexpr int SPL = BwdShape<NMAX>::SPL;
  __shared__ BwdShared<NMAX> sm;
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int d0 = tile * kBwdChannels;
  const int d = d0 + (threadIdx.x >> 2);
  const int q = threadIdx.x & (kBwdLanes - 1);
  const bool active = d < D;
  const int n_blocks = (L + T - 1) / T;

  float a_coef[SPL], phi[SPL], da[SPL];
  load_a_lane<SPL>(a_coef, A, d, q, N, active);
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    phi[i] = 0.f;
    da[i] = 0.f;
  }
  scan_bwd_range<NMAX>(x, dt, Bm, Cm, g,
                       bound + (size_t)b * n_blocks * N * D + d, (size_t)N * D,
                       (size_t)D, dx, ddt, partial, a_coef, phi, da, sm, b,
                       tile, gridDim.x, d0, active, L, D, N, T, 0, L);
  if (active)
    store_lane_states<SPL>(da_rows + ((size_t)b * D + d) * N, 1, da, q, N);
}

// K7. `scratch` is (batch, n_blocks, N, D) in device memory, or null: the
// block states then live in dynamic shared memory, (n_blocks, N, 64).
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
                        int T) {
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
    col = scratch + (size_t)b * n_blocks * N * D + d;
    stride_k = (size_t)N * D;
    stride_n = (size_t)D;
  } else {
    col = bound_smem + ch;
    stride_k = (size_t)N * kBwdChannels;
    stride_n = (size_t)kBwdChannels;
  }

  float a_coef[SPL], phi[SPL], da[SPL];
  load_a_lane<SPL>(a_coef, A, d, q, N, active);
  // phase 1: the state entering each time block; phi holds h meanwhile
#pragma unroll
  for (int i = 0; i < SPL; ++i) phi[i] = 0.f;
  for (int k = 0; k < n_blocks; ++k) {
    if (active)
      store_lane_states<SPL>(col + (size_t)k * stride_k, stride_n, phi, q, N);
    if (k + 1 < n_blocks) {
      __syncthreads();  // the previous time block's staged steps are read
      stage_time_block<NMAX>(sm, x, dt, nullptr, Bm, nullptr, row, k * T, T,
                             d0, D, N);
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
                       active, L, D, N, T, 0, L);
  if (active)
    store_lane_states<SPL>(da_rows + ((size_t)b * D + d) * N, 1, da, q, N);
}

int width_for(int N) { return N <= 16 ? 32 : 64; }

size_t shared_bound_bytes(int L, int N, int T) {
  return (size_t)((L + T - 1) / T) * N * kBwdChannels * sizeof(float);
}

template <int NMAX>
int launch(const float* x, const float* dt, const float* A, const float* B,
           const float* C, const float* g, const float* bound, float* dx,
           float* ddt, float* da_rows, float* dB, float* dC, float* partial,
           int batch, int L, int D, int N, int T, cudaStream_t stream) {
  const dim3 grid(bwd_tiles_for(D), batch);
  scan_bwd_kernel<NMAX><<<grid, kBwdThreads, 0, stream>>>(
      x, dt, A, B, C, g, bound, dx, ddt, da_rows, partial, L, D, N, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_bwd_sum(partial, dB, dC, batch, L, D, N, 2 * NMAX, stream);
}

template <int NMAX>
int launch_nostate(const float* x, const float* dt, const float* A,
                   const float* B, const float* C, const float* g,
                   float* scratch, float* dx, float* ddt, float* da_rows,
                   float* dB, float* dC, float* partial, int batch, int L,
                   int D, int N, int T, cudaStream_t stream) {
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
      x, dt, A, B, C, g, scratch, dx, ddt, da_rows, partial, L, D, N, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_bwd_sum(partial, dB, dC, batch, L, D, N, 2 * NMAX, stream);
}

}  // namespace

// The tile count and the per-step width of `partial` for D and N.
extern "C" int selective_scan_bwd_tiles(int D) {
  return dmc_scan::bwd_tiles_for(D);
}
extern "C" int selective_scan_bwd_width(int N) { return width_for(N); }

// 1 when `selective_scan_bwd_nostate` needs its `scratch` in device memory
// for these sizes, 0 when the block states fit shared memory.
extern "C" int selective_scan_bwd_nostate_needs_scratch(int L, int N, int T) {
  return shared_bound_bytes(L, N, T) > kSharedBoundMax ? 1 : 0;
}

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

// As `selective_scan_bwd` with no `bound`: `scratch` is null, or (batch,
// ceil(L / T), N, D) where `selective_scan_bwd_nostate_needs_scratch` says
// so.
extern "C" int selective_scan_bwd_nostate(
    const void* x, const void* dt, const void* A, const void* B, const void* C,
    const void* g, void* scratch, void* dx, void* ddt, void* da_rows, void* dB,
    void* dC, void* partial, int batch, int L, int D, int N, int T,
    void* stream) {
  if (N < 1 || N > 32 || T < 1 || T > 32) return (int)cudaErrorInvalidValue;
  auto f = N <= 16 ? &launch_nostate<16> : &launch_nostate<32>;
  return f((const float*)x, (const float*)dt, (const float*)A, (const float*)B,
           (const float*)C, (const float*)g, (float*)scratch, (float*)dx,
           (float*)ddt, (float*)da_rows, (float*)dB, (float*)dC,
           (float*)partial, batch, L, D, N, T, (cudaStream_t)stream);
}
