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
// Every kernel that walks the time axis gives one channel to four neighbouring
// lanes, each with NMAX / 4 of its N states (padded to NMAX = 16 or 32; the
// states past N have A = B = C = 0 and stay 0) in registers, and one block
// of 256 threads 64 channels of one row: see "forward" and "backward" below
// for what bounds each and why. The local and carry passes of the
// time-split backward give one thread a whole channel (128 channels a
// block). What differs between the kernels of a kind is the range of time
// steps a block walks and where its first state or adjoint comes from (the
// time-split forward rebuilds it from the chunks before, in `fast_exp2`).
// The decays are a = 2^(dt * A log2(e)) on the exponential unit
// (`fast_exp2`); every kernel holds its bar against the plain versions (2e-5
// forward, 1e-4 backward) with it. The backward's carry pass keeps expf: it
// runs once a chunk.
//
// More than 32 states (the JAX package runs any N; its TPU kernels stop at
// 32 and hand larger states to XLA): the states of one channel are
// independent recurrences, so each entry walks them in chunks of at most
// kStateChunk, one launch of the same kernel a chunk, in turn on the stream
// (`for_state_chunks`). A chunk reads A, B, C and the states at its own
// columns (its pointers start at state n0, rows NS = N apart) and owns its
// columns of bound, dA, dB, dC, h_out and dh_in; it adds its share of the
// sums over n (y in the forward, dx and ddt in the backward) to what the
// chunks before it wrote (`acc`). Each chunk rereads x, dt (and g), so the
// bytes grow with the chunks while the exponentials, which bound the walk,
// grow with N as they must. At N <= 32 there is one chunk, NS = N and no
// `acc`: the kernels run as they did.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace dmc_scan {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxT = 32;
// Thread blocks of the forward walk an SM is asked to hold at N <= 16 (three
// at N > 16), and groups of four steps unrolled together. On an H100 at batch
// 160, L 256, D 768, N 16, three or four blocks with one, two or four groups
// unrolled read within a few percent of each other, so the smallest code (64
// registers) stays.
constexpr int kFwdBlocks = 4;
constexpr int kFwdUnroll = 1;
// the most states one walk holds (four lanes of eight)
constexpr int kStateChunk = 32;

inline int tiles_for(int D) { return (D + kThreads - 1) / kThreads; }

// Calls f(n0, nc) for the chunks of at most kStateChunk of N states, in
// order, and returns the first error.
template <typename F>
int for_state_chunks(int N, F f) {
  for (int n0 = 0; n0 < N; n0 += kStateChunk) {
    const int err = f(n0, N - n0 < kStateChunk ? N - n0 : kStateChunk);
    if (err != 0) return err;
  }
  return 0;
}

// A chunk's A row: N states of a row NS long.
template <int NMAX>
__device__ __forceinline__ void load_a(float (&a_coef)[NMAX],
                                       const float* __restrict__ A, int d,
                                       int N, int NS, bool active) {
#pragma unroll
  for (int n = 0; n < NMAX; ++n)
    a_coef[n] = (active && n < N) ? A[(size_t)d * NS + n] : 0.f;
}

// ------------------------------------------- the lanes' layout; the backward
// The reverse sweep (`scan_bwd_range`) and the kernels around it give one
// channel to four neighbouring lanes, each with NMAX / 4 of its states, and
// one block of 256 threads 64 channels of one row.
//
// What bounds the sweep on an H100: instruction rate and the exponential
// unit, at whatever occupancy the registers leave; the bytes are a tenth of
// it. A thread that owns all N states of a channel can keep only a few
// steps of them in registers, so it has to rebuild the states of every short
// sub-block from the start of its time block (about 5.5 exponentials per
// state and step at 253 registers, 8 warps an SM). With a quarter of the
// states a lane keeps the history of a 16-step stretch (17 x 4 floats) in
// registers: a time block of 32 steps is two stretches, and only the first
// 16 steps are walked twice, 2.5 exponentials per state and step at under
// 128 registers (16 warps an SM). The rest of the design serves that:
// * x, dt, g of the time block's 64 channels and its B, C rows are staged
//   in shared memory once per time block, by coalesced loads; the lanes read
//   them from there (four lanes one address, a broadcast). dx and ddt go
//   back into the staged x and dt (a step's inputs are read before its
//   outputs are written, and earlier steps are still untouched) and leave
//   coalesced when the time block is done.
// * dx and ddt sum over n: two shuffles across the four lanes.
// * dB_t and dC_t sum over D: a lane's 2 NMAX / 4 values are summed over the
//   warp's eight channels by a transposing butterfly (7 shuffles at NMAX
//   16), over the block's warps in shared memory once per stretch (two
//   barriers for 16 steps, where the sub-blocks paid two for 4), and each
//   block writes its 64 channels' sums; `scan_bwd_sum_kernel` sums the
//   tiles. No atomics: the result is deterministic.
// Read by chip_smoke.py on an H100 80GB HBM3 at 700 W, batch 128, L 256, D
// 768, N 16: 0.97 ms a call from saved states, 1.35 ms with the rebuild
// first, against a bound of 0.17 ms (bytes); 128 registers, no spills from
// saved states, 40 bytes of them with the rebuild in the same kernel.

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdLanes = 4;                             // lanes of a channel
constexpr int kBwdChannels = kBwdThreads / kBwdLanes;    // channels of a block

inline int bwd_tiles_for(int D) { return (D + kBwdChannels - 1) / kBwdChannels; }

template <int NMAX>
struct BwdShape {
  static constexpr int SPL = NMAX / kBwdLanes;  // states of a lane
  static constexpr int S = 64 / SPL;            // steps of a stretch
  static constexpr int W = 2 * NMAX;            // dB then dC values of a step
  static constexpr int R = 2 * SPL / 8;         // sums a lane is left with
};

// Shared memory of the sweep: the staged time block and the warps' dB/dC
// sums of one stretch.
template <int NMAX>
struct __align__(16) BwdShared {
  float x[kMaxT][kBwdChannels];   // x, then dx
  float dt[kMaxT][kBwdChannels];  // dt, then ddt
  float g[kMaxT][kBwdChannels];
  float B[kMaxT][NMAX];
  float C[kMaxT][NMAX];
  float red[kBwdWarps][BwdShape<NMAX>::S][BwdShape<NMAX>::W];
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x on the exponential unit alone (ex2.approx: relative error about
// 2e-7, results below 2^-126 flush to 0). The sweep evaluates 2.5 decays per
// state and step; expf spends about eight more instructions on each to scale
// the argument and to keep denormals. The decays are a = 2^(dt * A log2(e)).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The A row of the lane's states, times log2(e): n = q * SPL + i, zero past
// N; A's rows are NS long.
template <int SPL>
__device__ __forceinline__ void load_a_lane(float (&a2)[SPL],
                                            const float* __restrict__ A, int d,
                                            int q, int N, int NS,
                                            bool active) {
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int n = q * SPL + i;
    a2[i] = (active && n < N) ? A[(size_t)d * NS + n] * kLog2e : 0.f;
  }
}

// The lane's states out of a column of states stride_n apart: p[n *
// stride_n] for n = q * SPL + i, zero past N.
template <int SPL>
__device__ __forceinline__ void load_lane_states(float (&h)[SPL], const float* p,
                                                 size_t stride_n, int q, int N,
                                                 bool active) {
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int n = q * SPL + i;
    h[i] = (active && n < N) ? p[(size_t)n * stride_n] : 0.f;
  }
}

template <int SPL>
__device__ __forceinline__ void store_lane_states(float* p, size_t stride_n,
                                                  const float (&h)[SPL], int q,
                                                  int N) {
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int n = q * SPL + i;
    if (n < N) p[(size_t)n * stride_n] = h[i];
  }
}

// The lane's SPL entries of a staged B or C row (NMAX floats, 16-byte
// aligned), by 16-byte loads.
template <int SPL>
__device__ __forceinline__ void load_lane_row(float (&out)[SPL], const float* r,
                                              int q) {
#pragma unroll
  for (int j = 0; j < SPL / 4; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(r + q * SPL + 4 * j);
    out[4 * j] = v.x;
    out[4 * j + 1] = v.y;
    out[4 * j + 2] = v.z;
    out[4 * j + 3] = v.w;
  }
}

// ----------------------------------------------------------------- forward
// The forward walk (`scan_fwd_walk`) uses the sweep's layout: four lanes a
// channel, 64 channels and 256 threads a block, so a (row, 64 channels) tile
// is a block and the grid has four times the threads of a thread-a-channel
// layout at a quarter of the registers (up to four blocks an SM).
//
// What bounds it on an H100: the exponential unit and the instruction rate.
// One call at batch 160, L 256, D 768, N 16 evaluates 503 M decays; the
// special-function units do 16 a clock and SM where the FMA pipes do 128, so
// they alone need 0.120 ms where the bytes (x, dt in, y out, once) need
// 0.114 ms. What the design does about it:
// * a decay is one multiply and one ex2.approx (`fast_exp2` on A log2(e));
// * x, dt and the B, C rows of a time block arrive in shared memory by
//   cp.async (16 bytes where D, N and the pointers allow it, else 4), the
//   next time block requested before this one is walked, so no step waits
//   on device memory; the lanes read them from there (four lanes one
//   address, a broadcast);
// * y_t is a sum over n, so over the four lanes. Each lane keeps its partial
//   sums of four steps and the lanes exchange them in a transposing
//   butterfly, three shuffles for four steps, which leaves lane q with y of
//   step 4 j + q; it stores that straight to device memory (a warp writes
//   four rows of eight channels, whole 32-byte sectors). Nothing in the walk
//   of a time block synchronises, so the steps overlap: one barrier a time
//   block, where the next one's copies are waited for;
// * the `bound` rows are written from registers as each time block begins.
// Measured on an H100 80GB HBM3 at 700 W (tools/profile_torch_kernels.py,
// launches in a row): 0.215-0.226 ms at batch 160, L 256, D 768, N 16, where a
// thread a channel with expf, x, dt and y in device memory took 0.350; 0.13-
// 0.14 ms at 16 rows, L 1024 (0.696). A first form that wrote y_t into the
// staged x after two shuffles and a __syncwarp every step was slower at
// both: the barrier kept the steps from overlapping.

template <int NMAX>
struct __align__(16) FwdStage {
  float x[kMaxT][kBwdChannels];
  float dt[kMaxT][kBwdChannels];
  float B[kMaxT][NMAX];
  float C[kMaxT][NMAX];
};

// Two stages: one walked, one in flight. 40 KB at NMAX 16, 48 KB at 32.
template <int NMAX>
struct __align__(16) FwdShared {
  FwdStage<NMAX> stage[2];
};

// How the operands may be copied: 16 bytes at a time along D (x, dt) and
// along the B, C rows, or 4.
struct FwdCopy {
  bool vec_d;  // D % 4 == 0 and x, dt 16-byte aligned
  bool vec_n;  // N == NMAX == NS and B, C 16-byte aligned: a time block's
               // rows are one contiguous run that fills the staged rows
};

inline FwdCopy fwd_copy_for(const void* x, const void* dt, const void* B,
                            const void* C, int D, int N, int NS) {
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  FwdCopy copy;
  copy.vec_d = D % 4 == 0 && !misaligned(x) && !misaligned(dt);
  copy.vec_n = N == NS && (N == 16 || N == 32) && !misaligned(B) &&
               !misaligned(C);
  return copy;
}

// `bytes` (16 or 4) from device to shared memory, asynchronously; zeros when
// not `valid` (src must still be an address inside the allocation).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Request the steps [t0, t0 + len) of the block's 64 channels from d0 on
// into `st`: x, dt, the B rows and (OUT) the C rows (N states of rows NS
// long). Channels past D arrive as zeros; the columns past N of B and C are
// never written (the walk zeroes them once).
template <int NMAX, bool OUT>
__device__ __forceinline__ void request_time_block(
    FwdStage<NMAX>& st, const float* __restrict__ x,
    const float* __restrict__ dt, const float* __restrict__ Bm,
    const float* __restrict__ Cm, size_t row, int t0, int len, int d0, int D,
    int N, int NS, FwdCopy copy) {
  const int tid = threadIdx.x;
  if (copy.vec_d) {
    constexpr int V = kBwdChannels / 4;
    for (int i = tid; i < len * V; i += kBwdThreads) {
      const int s = i / V;
      const int c = (i - s * V) * 4;
      const bool ok = d0 + c < D;
      const size_t off = ok ? (row + t0 + s) * D + d0 + c : 0;
      cp_async16(&st.x[s][c], x + off, ok);
      cp_async16(&st.dt[s][c], dt + off, ok);
    }
  } else {
    for (int i = tid; i < len * kBwdChannels; i += kBwdThreads) {
      const int s = i / kBwdChannels;
      const int c = i - s * kBwdChannels;
      const bool ok = d0 + c < D;
      const size_t off = ok ? (row + t0 + s) * D + d0 + c : 0;
      cp_async4(&st.x[s][c], x + off, ok);
      cp_async4(&st.dt[s][c], dt + off, ok);
    }
  }
  if (copy.vec_n) {  // N == NMAX == NS
    const size_t base = (row + t0) * N;
    for (int i = tid; i < len * (NMAX / 4); i += kBwdThreads) {
      cp_async16(&st.B[0][0] + 4 * i, Bm + base + 4 * i, true);
      if (OUT) cp_async16(&st.C[0][0] + 4 * i, Cm + base + 4 * i, true);
    }
  } else {
    for (int i = tid; i < len * N; i += kBwdThreads) {
      const int s = i / N;
      const int n = i - s * N;
      const size_t off = (row + t0 + s) * NS + n;
      cp_async4(&st.B[s][n], Bm + off, true);
      if (OUT) cp_async4(&st.C[s][n], Cm + off, true);
    }
  }
  cp_async_commit();
}

// The forward over the time blocks [k_begin, k_end) of the block's 64
// channels from d0 on. The thread is lane q = threadIdx.x & 3 of channel
// d0 + (threadIdx.x >> 2) and holds, for its states n = q * SPL + i, the A
// row times log2(e) (`load_a_lane`) and the state h, which it advances.
// OUT: y is written (else neither C nor y is touched: the local pass of a
// time-split scan). bound != null: the state entering each time block is
// written, except the first when `skip_first_bound` (the caller read h from
// that very row). SUM (by default where there is no output): returns the
// sum of dt over the steps walked (exp(A * sum) is the product of their
// decays), else 0. The walk's N states are a chunk of NS (B, C rows and
// bound's state axis NS long); `acc`: y is added to, not written (a later
// chunk of states).
// Every thread of the block must call it (it synchronises), active or not.
template <int NMAX, bool OUT, bool SUM = !OUT>
__device__ __forceinline__ float scan_fwd_walk(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    float* __restrict__ y, float* bound, const float (&a2)[NMAX / kBwdLanes],
    float (&h)[NMAX / kBwdLanes], FwdShared<NMAX>& sm, int b, int d0,
    bool active, int L, int D, int N, int NS, int T, int k_begin, int k_end,
    bool skip_first_bound, bool acc, FwdCopy copy) {
  constexpr int SPL = NMAX / kBwdLanes;
  const int tid = threadIdx.x;
  const int q = tid & (kBwdLanes - 1);
  const int ch = tid >> 2;
  const int n_blocks = (L + T - 1) / T;
  const size_t row = (size_t)b * L;
  float dt_sum = 0.f;
  if (k_begin >= k_end) return dt_sum;

  // the columns past N of both stages' B and C: no copy writes them
  const int pad = NMAX - N;
  for (int i = tid; i < 2 * kMaxT * pad; i += kBwdThreads) {
    const int st = i / (kMaxT * pad);
    const int r = i - st * (kMaxT * pad);
    const int s = r / pad;
    const int n = N + (r - s * pad);
    sm.stage[st].B[s][n] = 0.f;
    sm.stage[st].C[s][n] = 0.f;
  }
  request_time_block<NMAX, OUT>(sm.stage[0], x, dt, Bm, Cm, row, k_begin * T,
                                min(T, L - k_begin * T), d0, D, N, NS, copy);

  for (int k = k_begin; k < k_end; ++k) {
    const int p = (k - k_begin) & 1;
    const FwdStage<NMAX>& st = sm.stage[p];
    const int t0 = k * T;
    const int len = min(T, L - t0);
    cp_async_wait_all();
    __syncthreads();  // time block k is in; every thread has walked k - 1
    if (k + 1 < k_end)
      request_time_block<NMAX, OUT>(sm.stage[p ^ 1], x, dt, Bm, Cm, row,
                                    t0 + T, min(T, L - t0 - T), d0, D, N,
                                    NS, copy);
    if (active && bound != nullptr && !(skip_first_bound && k == k_begin))
      store_lane_states<SPL>(
          bound + ((size_t)b * n_blocks + k) * NS * D + d0 + ch, (size_t)D, h,
          q, N);
    // channels past D were staged as zeros: their lanes walk a = 1, u = 0.
    // Four steps at a time; `ragged` (a std::integral_constant) says whether
    // the four may reach past len.
    auto four_steps = [&](int j, auto ragged) {
      float part[4];  // the lane's share of y at the steps j .. j + 3
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        part[r] = 0.f;
        // the same for every thread of the block
        if (!decltype(ragged)::value || j + r < len) {
          const int s = j + r;
          const float dtv = st.dt[s][ch];
          const float u = dtv * st.x[s][ch];
          float bn[SPL];
          load_lane_row<SPL>(bn, st.B[s], q);
          if (SUM) dt_sum += dtv;
#pragma unroll
          for (int i = 0; i < SPL; ++i)
            h[i] = fmaf(fast_exp2(dtv * a2[i]), h[i], u * bn[i]);
          if (OUT) {
            float cn[SPL];
            load_lane_row<SPL>(cn, st.C[s], q);
            float even = 0.f, odd = 0.f;
#pragma unroll
            for (int i = 0; i < SPL; i += 2) {
              even = fmaf(cn[i], h[i], even);
              odd = fmaf(cn[i + 1], h[i + 1], odd);
            }
            part[r] = even + odd;
          }
        }
      }
      if (OUT) {
        // over the channel's four lanes, transposing: lane q is left with
        // the sum of part[q]
        const bool hi = q & 2;
        const float w0 = (hi ? part[2] : part[0]) +
                         __shfl_xor_sync(0xffffffffu, hi ? part[0] : part[2], 2);
        const float w1 = (hi ? part[3] : part[1]) +
                         __shfl_xor_sync(0xffffffffu, hi ? part[1] : part[3], 2);
        const bool odd_lane = q & 1;
        const float yv = (odd_lane ? w1 : w0) +
                         __shfl_xor_sync(0xffffffffu, odd_lane ? w0 : w1, 1);
        if (active && (!decltype(ragged)::value || j + q < len)) {
          float* out = y + (row + t0 + j + q) * D + d0 + ch;
          *out = acc ? *out + yv : yv;
        }
      }
    };
    const int whole = len & ~3;
#pragma unroll kFwdUnroll
    for (int j = 0; j < whole; j += 4) four_steps(j, std::false_type{});
    if (whole < len) four_steps(whole, std::true_type{});
  }
  return dt_sum;
}

// Stage the steps [t0, t0 + len) of the block's 64 channels from d0 on: x
// and dt, the B rows and (g != null) g and the C rows (N states of rows NS
// long). Every thread of the block calls it, between two barriers.
template <int NMAX>
__device__ __forceinline__ void stage_time_block(
    BwdShared<NMAX>& sm, const float* __restrict__ x,
    const float* __restrict__ dt, const float* __restrict__ g,
    const float* __restrict__ Bm, const float* __restrict__ Cm, size_t row,
    int t0, int len, int d0, int D, int N, int NS) {
  const int tid = threadIdx.x;
  for (int i = tid; i < len * kBwdChannels; i += kBwdThreads) {
    const int s = i / kBwdChannels;
    const int c = i - s * kBwdChannels;
    const bool ok = d0 + c < D;
    const size_t off = (row + t0 + s) * D + d0 + c;
    sm.x[s][c] = ok ? x[off] : 0.f;
    sm.dt[s][c] = ok ? dt[off] : 0.f;
    if (g != nullptr) sm.g[s][c] = ok ? g[off] : 0.f;
  }
  for (int i = tid; i < len * NMAX; i += kBwdThreads) {
    const int s = i / NMAX;
    const int n = i - s * NMAX;
    const size_t off = (row + t0 + s) * NS + n;
    sm.B[s][n] = n < N ? Bm[off] : 0.f;
    if (g != nullptr) sm.C[s][n] = n < N ? Cm[off] : 0.f;
  }
}

// The lane's states over the staged steps [s_begin, s_end), with no output.
template <int NMAX>
__device__ __forceinline__ void advance_staged(
    const BwdShared<NMAX>& sm, const float (&a2)[BwdShape<NMAX>::SPL],
    float (&h)[BwdShape<NMAX>::SPL], int q, int ch, int s_begin, int s_end) {
  constexpr int SPL = BwdShape<NMAX>::SPL;
  for (int s = s_begin; s < s_end; ++s) {
    const float dtv = sm.dt[s][ch];
    const float u = dtv * sm.x[s][ch];
    float bn[SPL];
    load_lane_row<SPL>(bn, sm.B[s], q);
#pragma unroll
    for (int i = 0; i < SPL; ++i)
      h[i] = fast_exp2(dtv * a2[i]) * h[i] + u * bn[i];
  }
}

// Sum over the warp's eight channels (lane bits 2, 3, 4) of each of the V
// values v[i] of the lanes with the same low two bits: the lane is left
// with the sums of the values (lane & 16 ? V/2 : 0) + (lane & 8 ? V/4 : 0) +
// (lane & 4 ? V/8 : 0) + r in v[r], r < V / 8. v is clobbered.
template <int V>
__device__ __forceinline__ void channel_transpose_sum(float (&v)[V], int lane) {
#pragma unroll
  for (int st = 0; st < 3; ++st) {
    const int half = V >> (st + 1);
    const int bit = 16 >> st;
    const bool upper = lane & bit;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
    }
  }
}

// The reverse sweep over the steps [t_begin, t_end), t_begin a multiple of
// T, for the block's 64 channels from d0 on. The thread is lane q =
// threadIdx.x & 3 of channel d = d0 + (threadIdx.x >> 2) and holds, for its
// states n = q * SPL + i: the A row times log2(e) (`load_a_lane`), the
// adjoint carry phi (a_{t+1}
// gamma_{t+1} of step t_end - 1 on entry, the carry into step t_begin - 1 on
// return) and the dA sums da, which it adds to. The state entering time
// block k is read at bound_col[k * stride_k + n * stride_n] (device or
// shared memory). Writes dx, ddt and the block's dB/dC sums over its
// channels into `partial` (batch, n_tiles, L, W); with `acc` (a later chunk
// of the NS states) dx and ddt are added to, not written.
// The states inside a stretch are recomputed forward from the saved state
// of the time block, never as h_{t-1} = (h_t - b_t) / a_t, which is unstable
// where a_t underflows.
// Without HAS_G (the backward of a scan whose y nobody reads, the stated
// forward's state-only form) there is no cotangent of y: g is not read, C
// is not staged, the adjoint takes no C_t g_t term and the dC sums are 0.
// Every thread of the block must call it (it synchronises), active or not.
template <int NMAX, bool HAS_G = true>
__device__ __forceinline__ void scan_bwd_range(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ g, const float* bound_col, size_t stride_k,
    size_t stride_n, float* __restrict__ dx, float* __restrict__ ddt,
    float* __restrict__ partial,
    const float (&a2)[BwdShape<NMAX>::SPL],
    float (&phi)[BwdShape<NMAX>::SPL], float (&da)[BwdShape<NMAX>::SPL],
    BwdShared<NMAX>& sm, int b, int tile, int n_tiles, int d0, bool active,
    int L, int D, int N, int NS, int T, int t_begin, int t_end, bool acc) {
  constexpr int SPL = BwdShape<NMAX>::SPL;
  constexpr int S = BwdShape<NMAX>::S;
  constexpr int W = BwdShape<NMAX>::W;
  constexpr int R = BwdShape<NMAX>::R;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q = tid & (kBwdLanes - 1);
  const int ch = tid >> 2;
  const size_t row = (size_t)b * L;
  // where the lane's R sums of a step go in a row of `red` and `partial`:
  // value j of the lane's 2 SPL is dB of state q SPL + j, or dC of state
  // q SPL + j - SPL
  const int j0 = ((lane & 16) ? SPL : 0) + ((lane & 8) ? SPL / 2 : 0) +
                 ((lane & 4) ? SPL / 4 : 0);
  const int col0 = j0 < SPL ? q * SPL + j0 : NMAX + q * SPL + j0 - SPL;

  for (int k = (t_end - 1) / T; k >= t_begin / T; --k) {
    const int tb0 = k * T;
    const int tlen = min(T, t_end - tb0);
    __syncthreads();  // the previous time block's dx, ddt have left
    stage_time_block<NMAX>(sm, x, dt, HAS_G ? g : nullptr, Bm, Cm, row, tb0,
                           tlen, d0, D, N, NS);
    __syncthreads();

    for (int s0 = ((tlen - 1) / S) * S; s0 >= 0; s0 -= S) {
      const int slen = min(S, tlen - s0);
      // hist[s] is the state before step s0 + s, hist[s + 1] the one after
      float hist[S + 1][SPL];
      load_lane_states<SPL>(hist[0], bound_col + (size_t)k * stride_k, stride_n,
                            q, N, active);
      // from the time block's start to s0
      advance_staged<NMAX>(sm, a2, hist[0], q, ch, 0, s0);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (s < slen) {  // the same for every thread of the block
          const float dtv = sm.dt[s0 + s][ch];
          const float u = dtv * sm.x[s0 + s][ch];
          float bn[SPL];
          load_lane_row<SPL>(bn, sm.B[s0 + s], q);
#pragma unroll
          for (int i = 0; i < SPL; ++i)
            hist[s + 1][i] = fast_exp2(dtv * a2[i]) * hist[s][i] + u * bn[i];
        }
      }

#pragma unroll
      for (int s = S - 1; s >= 0; --s) {
        if (s < slen) {
          const float dtv = sm.dt[s0 + s][ch];
          const float xv = sm.x[s0 + s][ch];
          const float gv = HAS_G ? sm.g[s0 + s][ch] : 0.f;
          const float u = dtv * xv;
          float v[2 * SPL], bn[SPL], cn[SPL];
          load_lane_row<SPL>(bn, sm.B[s0 + s], q);
          if (HAS_G) {
            load_lane_row<SPL>(cn, sm.C[s0 + s], q);
          } else {
#pragma unroll
            for (int i = 0; i < SPL; ++i) cn[i] = 0.f;
          }
          float g_b = 0.f, ddt_acc = 0.f;
#pragma unroll
          for (int i = 0; i < SPL; ++i) {
            const float a = fast_exp2(dtv * a2[i]);
            const float gam = cn[i] * gv + phi[i];
            const float dadec = gam * hist[s][i] * a;
            ddt_acc = fmaf(dadec, a2[i], ddt_acc);
            g_b = fmaf(gam, bn[i], g_b);
            da[i] = fmaf(dadec, dtv, da[i]);
            v[i] = gam * u;
            v[SPL + i] = hist[s + 1][i] * gv;
            phi[i] = a * gam;
          }
          // over the channel's four lanes
          g_b += __shfl_xor_sync(0xffffffffu, g_b, 1);
          ddt_acc += __shfl_xor_sync(0xffffffffu, ddt_acc, 1);
          g_b += __shfl_xor_sync(0xffffffffu, g_b, 2);
          ddt_acc += __shfl_xor_sync(0xffffffffu, ddt_acc, 2);
          __syncwarp();  // the four lanes have read x, dt of this step
          if (q == 0) {
            sm.x[s0 + s][ch] = g_b * dtv;
            sm.dt[s0 + s][ch] = fmaf(g_b, xv, ddt_acc * kLn2);
          }
          channel_transpose_sum<2 * SPL>(v, lane);
#pragma unroll
          for (int r = 0; r < R; ++r) sm.red[warp][s][col0 + r] = v[r];
        }
      }
      __syncthreads();
      for (int i = tid; i < slen * W; i += kBwdThreads) {
        const int s = i / W;
        const int c = i - s * W;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kBwdWarps; ++w) sum += sm.red[w][s][c];
        partial[(((size_t)b * n_tiles + tile) * L + tb0 + s0 + s) * W + c] = sum;
      }
      __syncthreads();  // red is rewritten by the next stretch
    }

    for (int i = tid; i < tlen * kBwdChannels; i += kBwdThreads) {
      const int s = i / kBwdChannels;
      const int c = i - s * kBwdChannels;
      if (d0 + c < D) {
        const size_t off = (row + tb0 + s) * D + d0 + c;
        dx[off] = acc ? dx[off] + sm.x[s][c] : sm.x[s][c];
        ddt[off] = acc ? ddt[off] + sm.dt[s][c] : sm.dt[s][c];
      }
    }
  }
}

// A chunk's N columns of dB, dC (batch, L, NS) from the per-tile sums: one
// thread per element.
// static: each source that includes this header links its own copy.
static __global__ void __launch_bounds__(256)
scan_bwd_sum_kernel(const float* __restrict__ partial, float* __restrict__ dB,
                    float* __restrict__ dC, int batch, int L, int N, int NS,
                    int tiles, int W) {
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
  dB[bt * NS + n] = sb;
  dC[bt * NS + n] = sc;
}

inline int launch_bwd_sum(const float* partial, float* dB, float* dC, int batch,
                          int L, int D, int N, int NS, int W,
                          cudaStream_t stream) {
  const size_t total = (size_t)batch * L * N;
  scan_bwd_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      partial, dB, dC, batch, L, N, NS, bwd_tiles_for(D), W);
  return (int)cudaGetLastError();
}

}  // namespace dmc_scan
