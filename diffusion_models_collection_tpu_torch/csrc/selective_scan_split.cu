// Selective scan with the time axis split across thread blocks, float32:
// the forward with saved block states and the backward from them, for long
// sequences at small batch. The math, `scan_fwd_walk` and `scan_bwd_range`
// are in selective_scan_common.cuh.
//
// Replaces diffusion_models_collection_tpu/ops/selective_scan_pallas.py:
// _scan_fwd_ckpt_kernel_grid (K9) and _scan_bwd_from_ckpt_kernel_grid (K10),
// the forms with one time block per program. On the TPU the grid runs in
// order on one core, so the state (or the adjoint) is carried from program
// to program in scratch. Thread blocks run in no order, so here the carry is
// a pass of its own. A chunk is `CB` whole time blocks of T steps (the last
// chunk may be shorter); both recurrences are affine in what enters a chunk,
//   h_out = P h_in + S,   phi_out = P phi_in + R,   P = exp(A * sum_chunk dt),
// so each is three passes:
//   (a) per (row, channel tile, chunk): S (or R) from a zero h_in (phi_in)
//       and the chunk's sum of dt;
//   (b) per (row, channel): walk the chunks in order (in reverse) and replace
//       each S (R) by the state (adjoint) entering that chunk;
//   (c) per (row, channel tile, chunk): the whole chunk from what enters it,
//       with K6's forward walk or K8's reverse sweep.
// P is never divided by, so its underflow over a long chunk is harmless.
// The forward's S go straight into `bound`: the state entering a chunk is
// the `bound` row of its first time block. Passes (a) and (c) of the forward
// are both `scan_fwd_walk` (64 channels a block, four lanes a channel), (a)
// with no output. dB and dC are summed over D as in
// K8 (per-tile partials, no atomics); dA is written per (row, chunk) and
// summed by the caller.
//
// What bounds it on an H100: the exponentials, as in K6 and K8, here
// evaluated once more in pass (a) (the forward twice in all; the backward's
// pass (a) adds one to the sweep's 2.5 per state and step), for n_chunks
// times the blocks in flight that K6 and K8 have.

#include "selective_scan_common.cuh"

namespace {

using namespace dmc_scan;

// (a) of the forward: the chunk's end state from zero into the `bound` row of
// the chunk's first time block, and its sum of dt into sdt (batch, chunks, D).
template <int NMAX>
__global__ void __launch_bounds__(kBwdThreads, NMAX <= 16 ? kFwdBlocks : 3)
split_fwd_local_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Bm, float* __restrict__ bound,
                       float* __restrict__ sdt, int L, int D, int N, int T,
                       int CB, FwdCopy copy) {
  constexpr int SPL = NMAX / kBwdLanes;
  __shared__ FwdShared<NMAX> sm;
  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int d0 = blockIdx.x * kBwdChannels;
  const int d = d0 + (threadIdx.x >> 2);
  const int q = threadIdx.x & (kBwdLanes - 1);
  const bool active = d < D;
  const int n_blocks = (L + T - 1) / T;

  float a2[SPL], h[SPL];
  load_a_lane<SPL>(a2, A, d, q, N, active);
#pragma unroll
  for (int i = 0; i < SPL; ++i) h[i] = 0.f;
  const float sum = scan_fwd_walk<NMAX, false>(
      x, dt, Bm, nullptr, nullptr, nullptr, a2, h, sm, b, d0, active, L, D, N,
      T, c * CB, min(n_blocks, c * CB + CB), false, copy);
  if (!active) return;
  store_lane_states<SPL>(bound + ((size_t)b * n_blocks + c * CB) * N * D + d,
                         (size_t)D, h, q, N);
  if (q == 0) sdt[((size_t)b * gridDim.z + c) * D + d] = sum;
}

// (a) of the backward: the chunk's outgoing adjoint carry from a zero
// incoming one into phi (batch, chunks, N, D), and its sum of dt.
template <int NMAX>
__global__ void __launch_bounds__(kThreads)
split_bwd_local_kernel(const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Cm,
                       const float* __restrict__ g, float* __restrict__ phi_buf,
                       float* __restrict__ sdt, int L, int D, int N, int T,
                       int CB) {
  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool active = d < D;
  const int t_begin = c * CB * T;
  const int t_end = min(L, t_begin + CB * T);
  const size_t row = (size_t)b * L;

  float a_coef[NMAX], phi[NMAX];
  load_a<NMAX>(a_coef, A, d, N, active);
#pragma unroll
  for (int n = 0; n < NMAX; ++n) phi[n] = 0.f;
  float sum = 0.f;
  for (int t = t_end - 1; t >= t_begin; --t) {
    const size_t off = (row + t) * D + d;
    const float dtv = active ? dt[off] : 0.f;
    const float gv = active ? g[off] : 0.f;
    const float* Ct = Cm + (row + t) * N;
    sum += dtv;
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      const float cn = n < N ? Ct[n] : 0.f;
      phi[n] = expf(dtv * a_coef[n]) * (cn * gv + phi[n]);
    }
  }
  if (!active) return;
  float* pk = phi_buf + ((size_t)b * gridDim.z + c) * N * D + d;
#pragma unroll
  for (int n = 0; n < NMAX; ++n)
    if (n < N) pk[(size_t)n * D] = phi[n];
  sdt[((size_t)b * gridDim.z + c) * D + d] = sum;
}

// (b): one thread per (row, channel) walks the chunks, first to last or
// (`reverse`) last to first, and replaces each chunk's local result in `buf`
// (N values, D apart, at b * batch_stride + c * chunk_stride + d) by what
// enters that chunk.
template <int NMAX>
__global__ void __launch_bounds__(kThreads)
split_carry_kernel(float* __restrict__ buf, size_t batch_stride,
                   size_t chunk_stride, const float* __restrict__ sdt,
                   const float* __restrict__ A, int n_chunks, int D, int N,
                   int reverse) {
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  float a_coef[NMAX], carry[NMAX];
  load_a<NMAX>(a_coef, A, d, N, true);
#pragma unroll
  for (int n = 0; n < NMAX; ++n) carry[n] = 0.f;
  for (int i = 0; i < n_chunks; ++i) {
    const int c = reverse ? n_chunks - 1 - i : i;
    float* p = buf + (size_t)b * batch_stride + (size_t)c * chunk_stride + d;
    const float s = sdt[((size_t)b * n_chunks + c) * D + d];
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) {
        const float local = p[(size_t)n * D];
        p[(size_t)n * D] = carry[n];
        carry[n] = expf(s * a_coef[n]) * carry[n] + local;
      }
    }
  }
}

// (c) of the forward: the chunk from the state entering it (its first
// `bound` row): y, and the `bound` rows of its other time blocks.
template <int NMAX>
__global__ void __launch_bounds__(kBwdThreads, NMAX <= 16 ? kFwdBlocks : 3)
split_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y,
                 float* bound, int L, int D, int N, int T, int CB,
                 FwdCopy copy) {
  constexpr int SPL = NMAX / kBwdLanes;
  __shared__ FwdShared<NMAX> sm;
  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int d0 = blockIdx.x * kBwdChannels;
  const int d = d0 + (threadIdx.x >> 2);
  const int q = threadIdx.x & (kBwdLanes - 1);
  const bool active = d < D;
  const int n_blocks = (L + T - 1) / T;

  float a2[SPL], h[SPL];
  load_a_lane<SPL>(a2, A, d, q, N, active);
  load_lane_states<SPL>(h,
                        bound + ((size_t)b * n_blocks + c * CB) * N * D + d,
                        (size_t)D, q, N, active);
  scan_fwd_walk<NMAX, true>(x, dt, Bm, Cm, y, bound, a2, h, sm, b, d0, active,
                            L, D, N, T, c * CB, min(n_blocks, c * CB + CB),
                            true, copy);
}

// (c) of the backward: K8's sweep over the chunk from the adjoint entering
// it, in the sweep's layout (256 threads, 64 channels, four lanes a
// channel); dA per (row, chunk) into da_rows (batch, chunks, D, N).
template <int NMAX>
__global__ void __launch_bounds__(kBwdThreads, 2)
split_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ g,
                 const float* __restrict__ bound,
                 const float* __restrict__ phi_buf, float* __restrict__ dx,
                 float* __restrict__ ddt, float* __restrict__ da_rows,
                 float* __restrict__ partial, int L, int D, int N, int T,
                 int CB) {
  constexpr int SPL = BwdShape<NMAX>::SPL;
  __shared__ BwdShared<NMAX> sm;
  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int tile = blockIdx.x;
  const int d0 = tile * kBwdChannels;
  const int d = d0 + (threadIdx.x >> 2);
  const int q = threadIdx.x & (kBwdLanes - 1);
  const bool active = d < D;
  const int n_blocks = (L + T - 1) / T;
  const int t_begin = c * CB * T;
  const int t_end = min(L, t_begin + CB * T);

  float a_coef[SPL], phi[SPL], da[SPL];
  load_a_lane<SPL>(a_coef, A, d, q, N, active);
  load_lane_states<SPL>(phi,
                        phi_buf + ((size_t)b * gridDim.z + c) * N * D + d,
                        (size_t)D, q, N, active);
#pragma unroll
  for (int i = 0; i < SPL; ++i) da[i] = 0.f;
  scan_bwd_range<NMAX>(x, dt, Bm, Cm, g,
                       bound + (size_t)b * n_blocks * N * D + d, (size_t)N * D,
                       (size_t)D, dx, ddt, partial, a_coef, phi, da, sm, b,
                       tile, gridDim.x, d0, active, L, D, N, T, t_begin, t_end);
  if (active)
    store_lane_states<SPL>(
        da_rows + (((size_t)b * gridDim.z + c) * D + d) * N, 1, da, q, N);
}

template <int NMAX>
int launch_fwd(const float* x, const float* dt, const float* A, const float* B,
               const float* C, float* y, float* bound, float* sdt, int batch,
               int L, int D, int N, int T, int CB, cudaStream_t stream) {
  const int n_blocks = (L + T - 1) / T;
  const int n_chunks = (n_blocks + CB - 1) / CB;
  const FwdCopy copy = fwd_copy_for(x, dt, B, C, D, N);
  const dim3 grid(bwd_tiles_for(D), batch, n_chunks);
  split_fwd_local_kernel<NMAX><<<grid, kBwdThreads, 0, stream>>>(
      x, dt, A, B, bound, sdt, L, D, N, T, CB, copy);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_carry_kernel<NMAX><<<dim3(tiles_for(D), batch), kThreads, 0, stream>>>(
      bound, (size_t)n_blocks * N * D, (size_t)CB * N * D, sdt, A, n_chunks, D,
      N, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_fwd_kernel<NMAX><<<grid, kBwdThreads, 0, stream>>>(
      x, dt, A, B, C, y, bound, L, D, N, T, CB, copy);
  return (int)cudaGetLastError();
}

template <int NMAX>
int launch_bwd(const float* x, const float* dt, const float* A, const float* B,
               const float* C, const float* g, const float* bound, float* dx,
               float* ddt, float* da_rows, float* dB, float* dC, float* partial,
               float* phi_buf, float* sdt, int batch, int L, int D, int N,
               int T, int CB, cudaStream_t stream) {
  const int n_blocks = (L + T - 1) / T;
  const int n_chunks = (n_blocks + CB - 1) / CB;
  const dim3 grid(tiles_for(D), batch, n_chunks);
  split_bwd_local_kernel<NMAX><<<grid, kThreads, 0, stream>>>(
      dt, A, C, g, phi_buf, sdt, L, D, N, T, CB);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_carry_kernel<NMAX><<<dim3(tiles_for(D), batch), kThreads, 0, stream>>>(
      phi_buf, (size_t)n_chunks * N * D, (size_t)N * D, sdt, A, n_chunks, D, N,
      1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 sweep_grid(bwd_tiles_for(D), batch, n_chunks);
  split_bwd_kernel<NMAX><<<sweep_grid, kBwdThreads, 0, stream>>>(
      x, dt, A, B, C, g, bound, phi_buf, dx, ddt, da_rows, partial, L, D, N, T,
      CB);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_bwd_sum(partial, dB, dC, batch, L, D, N, 2 * NMAX, stream);
}

bool valid(int L, int N, int T, int CB) {
  if (N < 1 || N > 32 || T < 1 || T > kMaxT || CB < 1) return false;
  const int n_blocks = (L + T - 1) / T;
  return (n_blocks + CB - 1) / CB <= 65535;  // the grid's z extent
}

}  // namespace

// x, dt, y: (batch, L, D); A: (D, N); B, C: (batch, L, N); bound: (batch,
// ceil(L / T), N, D), written; sdt: (batch, chunks, D) scratch, chunks =
// ceil(ceil(L / T) / CB). All float32, contiguous. 1 <= N <= 32, T <= 32,
// CB >= 1 time blocks a chunk. Returns the CUDA error of the launches.
extern "C" int selective_scan_fwd_split(const void* x, const void* dt,
                                        const void* A, const void* B,
                                        const void* C, void* y, void* bound,
                                        void* sdt, int batch, int L, int D,
                                        int N, int T, int CB, void* stream) {
  if (!valid(L, N, T, CB)) return (int)cudaErrorInvalidValue;
  auto f = N <= 16 ? &launch_fwd<16> : &launch_fwd<32>;
  return f((const float*)x, (const float*)dt, (const float*)A, (const float*)B,
           (const float*)C, (float*)y, (float*)bound, (float*)sdt, batch, L, D,
           N, T, CB, (cudaStream_t)stream);
}

// As `selective_scan_bwd` of selective_scan_bwd.cu, with da_rows (batch,
// chunks, D, N) and two more scratch buffers: phi_buf (batch, chunks, N, D)
// and sdt (batch, chunks, D).
extern "C" int selective_scan_bwd_split(
    const void* x, const void* dt, const void* A, const void* B, const void* C,
    const void* g, const void* bound, void* dx, void* ddt, void* da_rows,
    void* dB, void* dC, void* partial, void* phi_buf, void* sdt, int batch,
    int L, int D, int N, int T, int CB, void* stream) {
  if (!valid(L, N, T, CB)) return (int)cudaErrorInvalidValue;
  auto f = N <= 16 ? &launch_bwd<16> : &launch_bwd<32>;
  return f((const float*)x, (const float*)dt, (const float*)A, (const float*)B,
           (const float*)C, (const float*)g, (const float*)bound, (float*)dx,
           (float*)ddt, (float*)da_rows, (float*)dB, (float*)dC,
           (float*)partial, (float*)phi_buf, (float*)sdt, batch, L, D, N, T, CB,
           (cudaStream_t)stream);
}
