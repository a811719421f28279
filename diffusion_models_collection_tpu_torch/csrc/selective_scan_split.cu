// Selective scan with the time axis split across thread blocks, float32:
// the forward with saved block states (K9) and the backward from them (K10),
// for long sequences at small batch. The math, `scan_fwd_walk` and
// `scan_bwd_range` are in selective_scan_common.cuh.
//
// Replaces diffusion_models_collection_tpu/ops/selective_scan_pallas.py:
// _scan_fwd_ckpt_kernel_grid (K9) and _scan_bwd_from_ckpt_kernel_grid (K10),
// the forms with one time block per program. On the TPU the grid runs in
// order on one core, so the state (or the adjoint) is carried from program
// to program in scratch. Thread blocks run in no order, so here the carry is
// computed apart. A chunk is `CB` whole time blocks of T steps (the last
// chunk may be shorter); both recurrences are affine in what enters a chunk,
//   h_out = P h_in + S,   phi_out = P phi_in + R,   P = exp(A * sum_chunk dt).
// P is never divided by, so its underflow over a long chunk is harmless.
//
// The forward (K9), two launches of `scan_fwd_walk` (64 channels a block,
// four lanes a channel):
//   (a) per (row, channel tile, chunk) for every chunk but the last: S from
//       a zero state and the chunk's sum of dt, into scratch. The state
//       entering chunk 0 is zero, so its block walks it whole, y and `bound`
//       rows included, and its S is the state that leaves it;
//   (c) per (row, channel tile, chunk) for every chunk but the first: the
//       state entering the chunk, rebuilt from the S and sums of the chunks
//       before it (h = P_j h + S_j, in order; a few loads and exponentials a
//       chunk), then the chunk with y and `bound`.
// What bounds it on an H100: the walk's exponentials and its chain of
// dependent steps. At the 64x64 DiM's shape (batch 16, L 1024, D 768) the
// whole-sequence walk (K6) has 192 blocks for the card's 528 slots (four a
// SM) and each walks 1024 steps; k chunks make each launch (k - 1) x 192
// blocks that walk 1024 / k steps, for 2 - 2 / k walks in all (chunk 0 once,
// the last chunk once, the others twice). `selective_scan.fwd_chunk_blocks`
// takes the most chunks for which each launch is one wave (three here:
// 384 blocks of 352 steps, then 384 of 352, 4/3 walks).
//
// The backward (K10), three passes:
//   (a) per (row, channel, chunk): R from a zero phi_in and the chunk's sum
//       of dt, one thread a channel;
//   (b) per (row, channel): walk the chunks last to first and replace each
//       R by the adjoint entering that chunk (`split_carry_kernel`);
//   (c) per (row, channel tile, chunk): K8's reverse sweep over the chunk
//       from what enters it.
// dB and dC are summed over D as in K8 (per-tile partials, no atomics); dA is
// written per (row, chunk) and summed by the caller. Its pass (a) adds an
// exponential a state and step to the sweep's 2.5.
// Any N: past 32 states the forward runs all its passes once per chunk of
// 32 states, in turn (`for_state_chunks`, selective_scan_common.cuh); each
// chunk of states owns its columns of bound and ends and adds its share to
// y. The backward runs passes (a) and (b) per chunk of 32 (each writes its
// columns of phi and the same sums of dt), then pass (c) once per 64 states
// in the wide sweep (`split_bwd_wide_kernel`, `scan_bwd_range_wide`), which
// adds its share to dx and ddt and owns its columns of dA, dB, dC.

#include "selective_scan_common.cuh"

namespace {

using namespace dmc_scan;

// (a) of the forward, over chunks 0 .. n_chunks - 2 (chunk 0 alone when
// there is one chunk): chunk 0 walked whole from the zero state, y and its
// `bound` rows written; a later chunk from a zero state with no output. Each
// such chunk's end state goes into ends (batch, n_chunks - 1, N, D), its sum
// of dt into sdt (batch, n_chunks - 1, D), except with one chunk.
template <int NMAX>
__global__ void __launch_bounds__(kBwdThreads, NMAX <= 16 ? kFwdBlocks : 3)
split_fwd_local_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm, float* __restrict__ y,
                       float* bound, float* __restrict__ ends,
                       float* __restrict__ sdt, int L, int D, int N, int NS,
                       int T, int CB, int n_chunks, bool acc, FwdCopy copy) {
  constexpr int SPL = NMAX / kBwdLanes;
  __shared__ FwdShared<NMAX> sm;
  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int d0 = blockIdx.x * kBwdChannels;
  const int d = d0 + (threadIdx.x >> 2);
  const int q = threadIdx.x & (kBwdLanes - 1);
  const bool active = d < D;
  const int n_blocks = (L + T - 1) / T;
  const int k_end = min(n_blocks, c * CB + CB);

  float a2[SPL], h[SPL];
  load_a_lane<SPL>(a2, A, d, q, N, NS, active);
#pragma unroll
  for (int i = 0; i < SPL; ++i) h[i] = 0.f;
  float sum;
  if (c == 0)  // the same for the whole block
    sum = scan_fwd_walk<NMAX, true, true>(x, dt, Bm, Cm, y, bound, a2, h, sm,
                                          b, d0, active, L, D, N, NS, T, 0,
                                          k_end, false, acc, copy);
  else
    sum = scan_fwd_walk<NMAX, false>(x, dt, Bm, nullptr, nullptr, nullptr, a2,
                                     h, sm, b, d0, active, L, D, N, NS, T,
                                     c * CB, k_end, false, false, copy);
  if (!active || c == n_chunks - 1) return;
  const size_t r = (size_t)b * (n_chunks - 1) + c;
  store_lane_states<SPL>(ends + r * NS * D + d, (size_t)D, h, q, N);
  if (q == 0) sdt[r * D + d] = sum;
}

// (a) of the backward: the chunk's outgoing adjoint carry from a zero
// incoming one into phi (batch, chunks, N, D), and its sum of dt.
template <int NMAX>
__global__ void __launch_bounds__(kThreads)
split_bwd_local_kernel(const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Cm,
                       const float* __restrict__ g, float* __restrict__ phi_buf,
                       float* __restrict__ sdt, int L, int D, int N, int NS,
                       int T, int CB) {
  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool active = d < D;
  const int t_begin = c * CB * T;
  const int t_end = min(L, t_begin + CB * T);
  const size_t row = (size_t)b * L;

  float a_coef[NMAX], phi[NMAX];
  load_a<NMAX>(a_coef, A, d, N, NS, active);
#pragma unroll
  for (int n = 0; n < NMAX; ++n) phi[n] = 0.f;
  float sum = 0.f;
  for (int t = t_end - 1; t >= t_begin; --t) {
    const size_t off = (row + t) * D + d;
    const float dtv = active ? dt[off] : 0.f;
    const float gv = active ? g[off] : 0.f;
    const float* Ct = Cm + (row + t) * NS;
    sum += dtv;
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      const float cn = n < N ? Ct[n] : 0.f;
      phi[n] = expf(dtv * a_coef[n]) * (cn * gv + phi[n]);
    }
  }
  if (!active) return;
  float* pk = phi_buf + ((size_t)b * gridDim.z + c) * NS * D + d;
#pragma unroll
  for (int n = 0; n < NMAX; ++n)
    if (n < N) pk[(size_t)n * D] = phi[n];
  sdt[((size_t)b * gridDim.z + c) * D + d] = sum;
}

// (b) of the backward: one thread per (row, channel) walks the chunks last
// to first and replaces each chunk's outgoing carry in phi (batch, chunks, N,
// D) by the one entering it from the chunk after.
template <int NMAX>
__global__ void __launch_bounds__(kThreads)
split_carry_kernel(float* __restrict__ phi_buf, const float* __restrict__ sdt,
                   const float* __restrict__ A, int n_chunks, int D, int N,
                   int NS) {
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  float a_coef[NMAX], carry[NMAX];
  load_a<NMAX>(a_coef, A, d, N, NS, true);
#pragma unroll
  for (int n = 0; n < NMAX; ++n) carry[n] = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const size_t r = (size_t)b * n_chunks + c;
    float* p = phi_buf + r * NS * D + d;
    const float s = sdt[r * D + d];
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

// (c) of the forward, over chunks 1 .. n_chunks - 1: the state entering
// the chunk from the end states and dt sums of the chunks before it, then
// the chunk with y and all of its `bound` rows.
template <int NMAX>
__global__ void __launch_bounds__(kBwdThreads, NMAX <= 16 ? kFwdBlocks : 3)
split_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y,
                 float* bound, const float* __restrict__ ends,
                 const float* __restrict__ sdt, int L, int D, int N, int NS,
                 int T, int CB, int n_chunks, bool acc, FwdCopy copy) {
  constexpr int SPL = NMAX / kBwdLanes;
  __shared__ FwdShared<NMAX> sm;
  const int b = blockIdx.y;
  const int c = blockIdx.z + 1;
  const int d0 = blockIdx.x * kBwdChannels;
  const int d = d0 + (threadIdx.x >> 2);
  const int q = threadIdx.x & (kBwdLanes - 1);
  const bool active = d < D;
  const int n_blocks = (L + T - 1) / T;

  float a2[SPL], h[SPL];
  load_a_lane<SPL>(a2, A, d, q, N, NS, active);
#pragma unroll
  for (int i = 0; i < SPL; ++i) h[i] = 0.f;
  for (int j = 0; j < c; ++j) {  // h = exp(A sum_j) h + S_j
    const size_t r = (size_t)b * (n_chunks - 1) + j;
    const float s = active ? sdt[r * D + d] : 0.f;
    float e[SPL];
    load_lane_states<SPL>(e, ends + r * NS * D + d, (size_t)D, q, N, active);
#pragma unroll
    for (int i = 0; i < SPL; ++i) h[i] = fmaf(fast_exp2(s * a2[i]), h[i], e[i]);
  }
  scan_fwd_walk<NMAX, true>(x, dt, Bm, Cm, y, bound, a2, h, sm, b, d0, active,
                            L, D, N, NS, T, c * CB, min(n_blocks, c * CB + CB),
                            false, acc, copy);
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
  load_a_lane<SPL>(a_coef, A, d, q, N, N, active);
  load_lane_states<SPL>(phi,
                        phi_buf + ((size_t)b * gridDim.z + c) * N * D + d,
                        (size_t)D, q, N, active);
#pragma unroll
  for (int i = 0; i < SPL; ++i) da[i] = 0.f;
  scan_bwd_range<NMAX>(x, dt, Bm, Cm, g,
                       bound + (size_t)b * n_blocks * N * D + d,
                       (size_t)N * D, (size_t)D, dx, ddt, partial, a_coef,
                       phi, da, sm, b, tile, gridDim.x, d0, active, L, D, N,
                       N, T, t_begin, t_end, false);
  if (active)
    store_lane_states<SPL>(
        da_rows + (((size_t)b * gridDim.z + c) * D + d) * N, 1, da, q, N);
}

// (c) of the backward past 32 states: `split_bwd_kernel` over up to
// kWideMax states through the wide sweep.
__global__ void __launch_bounds__(kBwdThreads, 2)
split_bwd_wide_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ g,
                      const float* __restrict__ bound,
                      const float* __restrict__ phi_buf,
                      float* __restrict__ dx, float* __restrict__ ddt,
                      float* __restrict__ da_rows,
                      float* __restrict__ partial, int L, int D, int N,
                      int NS, int T, int CB, bool acc) {
  constexpr int SPL = WideShape::SPL;
  extern __shared__ float4 wide_smem[];
  BwdWideShared& sm = *reinterpret_cast<BwdWideShared*>(wide_smem);
  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int tile = blockIdx.x;
  const int d0 = tile * kBwdChannels;
  const int d = d0 + (threadIdx.x >> 2);
  const int q = threadIdx.x & (kBwdLanes - 1);
  const bool active = d < D;
  const int n_blocks = (L + T - 1) / T;
  const int chunks = (N + kWideChunk - 1) / kWideChunk;
  const int t_begin = c * CB * T;
  const int t_end = min(L, t_begin + CB * T);
  const float* phi_in = phi_buf + ((size_t)b * gridDim.z + c) * NS * D + d;

  for (int j = 0; j < chunks; ++j) {
    float phi[SPL], da[SPL];
    load_lane_states<SPL>(phi, phi_in + (size_t)j * kWideChunk * D,
                          (size_t)D, q, N - j * kWideChunk, active);
#pragma unroll
    for (int i = 0; i < SPL; ++i) da[i] = 0.f;
    store_carry(sm.phi, phi, j);
    store_carry(sm.da, da, j);
  }
  scan_bwd_range_wide<true>(x, dt, A, Bm, Cm, g,
                            bound + (size_t)b * n_blocks * NS * D + d,
                            (size_t)NS * D, (size_t)D, dx, ddt, partial, sm,
                            b, tile, gridDim.x, d0, active, L, D, N, NS, T,
                            t_begin, t_end, acc);
  if (!active) return;
  float* da_out = da_rows + (((size_t)b * gridDim.z + c) * D + d) * NS;
  for (int j = 0; j < chunks; ++j) {
    float da[SPL];
    load_carry(da, sm.da, j);
    store_lane_states<SPL>(da_out + j * kWideChunk, 1, da, q,
                           N - j * kWideChunk);
  }
}

// One chunk of states: n0 .. n0 + N - 1 of NS.
template <int NMAX>
int launch_fwd(const float* x, const float* dt, const float* A, const float* B,
               const float* C, float* y, float* bound, float* ends, float* sdt,
               int batch, int L, int D, int n0, int N, int NS, int T, int CB,
               cudaStream_t stream) {
  const int n_blocks = (L + T - 1) / T;
  const int n_chunks = (n_blocks + CB - 1) / CB;
  A += n0;
  B += n0;
  C += n0;
  bound += (size_t)n0 * D;
  if (ends != nullptr) ends += (size_t)n0 * D;
  const FwdCopy copy = fwd_copy_for(x, dt, B, C, D, N, NS);
  const int tiles = bwd_tiles_for(D);
  split_fwd_local_kernel<NMAX>
      <<<dim3(tiles, batch, n_chunks > 1 ? n_chunks - 1 : 1), kBwdThreads, 0,
         stream>>>(x, dt, A, B, C, y, bound, ends, sdt, L, D, N, NS, T, CB,
                   n_chunks, n0 > 0, copy);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return (int)err;
  split_fwd_kernel<NMAX><<<dim3(tiles, batch, n_chunks - 1), kBwdThreads, 0,
                           stream>>>(x, dt, A, B, C, y, bound, ends, sdt, L, D,
                                     N, NS, T, CB, n_chunks, n0 > 0, copy);
  return (int)cudaGetLastError();
}

// N <= NMAX states.
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
      dt, A, C, g, phi_buf, sdt, L, D, N, N, T, CB);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_carry_kernel<NMAX><<<dim3(tiles_for(D), batch), kThreads, 0, stream>>>(
      phi_buf, sdt, A, n_chunks, D, N, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 sweep_grid(bwd_tiles_for(D), batch, n_chunks);
  split_bwd_kernel<NMAX><<<sweep_grid, kBwdThreads, 0, stream>>>(
      x, dt, A, B, C, g, bound, phi_buf, dx, ddt, da_rows, partial, L, D, N,
      T, CB);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_bwd_sum(partial, dB, dC, batch, L, D, N, N, 2 * NMAX, stream);
}

// Past 32 states, for states n0 .. n0 + N - 1 of NS (N <= kWideMax): passes
// (a) and (b) per chunk of at most 32 of them, then one launch of pass (c)
// in the wide sweep and the sum over the tiles.
int launch_bwd_wide(const float* x, const float* dt, const float* A,
                    const float* B, const float* C, const float* g,
                    const float* bound, float* dx, float* ddt, float* da_rows,
                    float* dB, float* dC, float* partial, float* phi_buf,
                    float* sdt, int batch, int L, int D, int n0, int N,
                    int NS, int T, int CB, cudaStream_t stream) {
  const int n_blocks = (L + T - 1) / T;
  const int n_chunks = (n_blocks + CB - 1) / CB;
  const dim3 grid(tiles_for(D), batch, n_chunks);
  int err = for_state_chunks(N, [&](int m0, int nc) {
    const int s0 = n0 + m0;
    auto local = nc <= 16 ? &split_bwd_local_kernel<16>
                          : &split_bwd_local_kernel<32>;
    auto carry = nc <= 16 ? &split_carry_kernel<16> : &split_carry_kernel<32>;
    local<<<grid, kThreads, 0, stream>>>(dt, A + s0, C + s0, g,
                                         phi_buf + (size_t)s0 * D, sdt, L, D,
                                         nc, NS, T, CB);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    carry<<<dim3(tiles_for(D), batch), kThreads, 0, stream>>>(
        phi_buf + (size_t)s0 * D, sdt, A + s0, n_chunks, D, nc, NS);
    return (int)cudaGetLastError();
  });
  if (err != 0) return err;
  static std::atomic<bool> opted_in[kMaxDevices];
  err = opt_in_wide((const void*)split_bwd_wide_kernel, opted_in);
  if (err != 0) return err;
  split_bwd_wide_kernel<<<dim3(bwd_tiles_for(D), batch, n_chunks),
                          kBwdThreads, sizeof(BwdWideShared), stream>>>(
      x, dt, A + n0, B + n0, C + n0, g, bound + (size_t)n0 * D,
      phi_buf + (size_t)n0 * D, dx, ddt, da_rows + n0, partial, L, D, N, NS,
      T, CB, n0 > 0);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_bwd_sum(partial, dB + n0, dC + n0, batch, L, D, N, NS,
                        2 * kWideMax, stream);
}

bool valid(int L, int N, int T, int CB) {
  if (N < 1 || T < 1 || T > kMaxT || CB < 1) return false;
  const int n_blocks = (L + T - 1) / T;
  return (n_blocks + CB - 1) / CB <= 65535;  // the grid's z extent
}

}  // namespace

// x, dt, y: (batch, L, D); A: (D, N); B, C: (batch, L, N); bound: (batch,
// ceil(L / T), N, D), written; with chunks = ceil(ceil(L / T) / CB) > 1 the
// scratch ends (batch, chunks - 1, N, D) and sdt (batch, chunks - 1, D),
// else unused. All float32, contiguous. N >= 1 (in chunks of 32 past 32),
// T <= 32, CB >= 1 time blocks a chunk. Returns the CUDA error of the
// launches.
extern "C" int selective_scan_fwd_split(const void* x, const void* dt,
                                        const void* A, const void* B,
                                        const void* C, void* y, void* bound,
                                        void* ends, void* sdt, int batch,
                                        int L, int D, int N, int T, int CB,
                                        void* stream) {
  if (!valid(L, N, T, CB)) return (int)cudaErrorInvalidValue;
  return for_state_chunks(N, [&](int n0, int nc) {
    auto f = nc <= 16 ? &launch_fwd<16> : &launch_fwd<32>;
    return f((const float*)x, (const float*)dt, (const float*)A,
             (const float*)B, (const float*)C, (float*)y, (float*)bound,
             (float*)ends, (float*)sdt, batch, L, D, n0, nc, N, T, CB,
             (cudaStream_t)stream);
  });
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
  if (N > kStateChunk)
    return for_wide_chunks(N, [&](int n0, int nc) {
      return launch_bwd_wide(
          (const float*)x, (const float*)dt, (const float*)A,
          (const float*)B, (const float*)C, (const float*)g,
          (const float*)bound, (float*)dx, (float*)ddt, (float*)da_rows,
          (float*)dB, (float*)dC, (float*)partial, (float*)phi_buf,
          (float*)sdt, batch, L, D, n0, nc, N, T, CB, (cudaStream_t)stream);
    });
  auto f = N <= 16 ? &launch_bwd<16> : &launch_bwd<32>;
  return f((const float*)x, (const float*)dt, (const float*)A,
           (const float*)B, (const float*)C, (const float*)g,
           (const float*)bound, (float*)dx, (float*)ddt, (float*)da_rows,
           (float*)dB, (float*)dC, (float*)partial, (float*)phi_buf,
           (float*)sdt, batch, L, D, N, T, CB, (cudaStream_t)stream);
}
