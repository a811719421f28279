// GroupNorm + SiLU on (B, HW, C) float32 or bfloat16 activations (NHWC
// images flattened over H and W), with per-channel float32 affine scale and
// bias: the forward, which also writes each (image, group)'s mean and
// 1 / sigma, and the backward from them.
//
// The forward replaces
// diffusion_models_collection_tpu/ops/fused_norm.py:_gn_silu_kernel. The
// backward has no TPU counterpart (the JAX package recomputes the plain
// forward under autodiff); with xh = (x - mean) / sigma, z = xh * scale +
// bias, s = sigmoid(z):
//   dz = g s (1 + z (1 - s)),  dbias = sum dz,  dscale = sum dz xh,
//   dxh = dz scale,
//   dx = (dxh - mean_g(dxh) - xh mean_g(dxh xh)) / sigma,
// the means over the group, the sums over the image (written per image,
// (B, C), and summed over B by the caller in a fixed order: no atomics).
//
// What bounds both on an H100: device-memory bandwidth. A handful of flops
// an element, so the least is one read of x (and g) and one write of y (dx).
// Design: one block per (image, group), the group on chip. A group is HW
// rows of C / G contiguous floats, C floats apart; every row is a whole
// number of 16-byte vectors (C / G % 4 == 0), so a thread owns one vector
// column and walks down the rows: 16-byte loads and stores, no division per
// element, scale and bias of its four channels in registers.
// * Forward: x is read once into shared memory (up to 226 KB: the largest
//   group of the CIFAR-10 UNet, 32 x 32 x 48 floats, is 192 KB); the mean,
//   then the centred sum of squares (two passes, not E[x^2] - mean^2, which
//   cancels when |mean| >> sigma), then y come from there.
// * Backward: x and g are read once; dxh and xh stay in shared memory where
//   both fit, else dxh alone and x is read a second time (mostly from L2)
//   for dx. The thread's column is fixed, so its four dbias and dscale sums
//   are registers; the rows' shares are summed through shared memory in row
//   order once dx has left.
// * The block is sized to the group (`threads_for`): one warp up to 1024
//   floats, where the two sums are shuffles and no block-wide barrier runs,
//   to 1024 threads beyond 16384 floats.
// * Backward, a group whose float32 copy does not fit one SM's shared
//   memory (every GroupNorm of the 64 x 64 SR UNet: 64 x 64 x 16 floats and
//   more): the cluster form. One (image, group)'s rows are split over a
//   thread block cluster of k blocks on neighbouring SMs (`cluster_for`: the
//   least k, 2 to 16, at which a block's share of the rows fits with dxh;
//   at that k the share keeps xh too where both fit); each block walks its
//   rows as the form above does, and the blocks exchange the two means'
//   partial sums, then each channel's dbias and dscale column sums,
//   through distributed shared memory, summed in cluster-rank order: x and
//   g are read once and dx written once, deterministic, no atomics. A
//   shape that should take it and whose cluster cannot be scheduled raises
//   (no fallback).
// * A group whose rows are no whole vectors, a view that is not 16-byte
//   aligned, or (forward; backward past 16 blocks' shared memory) a group
//   that does not fit, takes the generic kernels: scalar accesses, the
//   group read three times (the backward once more per channel). They are
//   right, not fast.
// The SiLU's exponential is __expf and its division __fdividef: both within
// 2 ulp here, against a bar of 2e-5.
// bfloat16 (the models' mixed precision, as the JAX package's
// `group_norm_silu(x.astype(f32)).astype(bf16)` and its autodiff): the
// element type T of x, y, the gradient g and dx is a template parameter of
// the same kernels. A bf16 value widens to float32 exactly on load, every
// sum and product stays float32, and only y (dx) is rounded, to nearest even,
// at the store; mean, 1 / sigma, scale, bias and the dscale, dbias rows stay
// float32. A 16-byte vector then holds eight channels (the forward keeps the
// group in shared memory as bf16, half the bytes); groups whose rows are no
// whole number of vectors (C / G % 8 != 0) take the generic kernels.
// Measured on an H100 80GB HBM3 at 700 W (tools/profile_torch_kernels.py,
// launches in a row, batch 160 forward / 128 backward, ms): 32 x 32 x 384
// forward 0.213 (bytes alone 0.150; three reads from device memory 0.722),
// backward 0.308 (bytes 0.180; autograd through the plain forward 3.3);
// 32 x 32 x 128 0.084 / 0.118. The groups of 4 x 4 and 8 x 8 images take
// less time on the card than their launch takes on the host. The cluster
// form at batch 256, 64 x 64 x 128 (--only gn_generic): 0.86-0.90 ms a
// launch against a bound of 0.481 (bytes), where the scalar generic kernel
// took 9.7.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int kGenericThreads = 256;
constexpr int kMaxDevices = 64;
// Dynamic shared memory a block may ask for, less the kernels' static few
// hundred bytes.
constexpr size_t kSharedMax = 232448 - 1024;
// The largest cluster the backward's cluster form takes (8 is the portable
// limit; 16 needs the non-portable opt-in).
constexpr int kClusterMax = 16;

// A 16-byte vector of the I/O type T: V elements, widened to float32 on load
// and rounded (bf16: to nearest even) on store; `widen` and `round` do the
// same for one element.
template <typename T>
struct Io;

template <>
struct Io<float> {
  using Vec = float4;
  static constexpr int V = 4;
  static constexpr int LOG_V = 2;
  static __device__ __forceinline__ void unpack(const Vec& v, float (&f)[V]) {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  static __device__ __forceinline__ Vec pack(const float (&f)[V]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  using Vec = uint4;
  static constexpr int V = 8;
  static constexpr int LOG_V = 3;
  static __device__ __forceinline__ void unpack(const Vec& v, float (&f)[V]) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i is the low half of word i
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ Vec pack(const float (&f)[V]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 round(float v) {
    return __float2bfloat16_rn(v);
  }
};

// The V floats of vector column `cv` of a group's float32 channels `p`, 16
// bytes at a time.
template <int V>
__device__ __forceinline__ void load_channels(float (&f)[V],
                                              const float* __restrict__ p,
                                              int cv) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(p)[cv * (V / 4) + q];
    f[4 * q] = v.x;
    f[4 * q + 1] = v.y;
    f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
  }
}

// Sum of the V floats pairwise: (f0 + f1) + (f2 + f3), ...
template <int V>
__device__ __forceinline__ float vsum(const float (&f)[V]) {
  if constexpr (V == 4) {
    return (f[0] + f[1]) + (f[2] + f[3]);
  } else {
    return ((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]));
  }
}

// Sums of `a` and of `b` over the block of THREADS threads (0: of blockDim.x,
// not known when compiled); every thread gets both. `red` holds at least 66
// floats. One warp: shuffles alone.
template <int THREADS>
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if (THREADS == 32) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = THREADS ? THREADS / 32 : blockDim.x >> 5;
  __syncthreads();  // every thread has read the previous call's results
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < nwarps ? red[lane] : 0.f;
    b = lane < nwarps ? red[32 + lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    if (lane == 0) {
      red[64] = a;
      red[65] = b;
    }
  }
  __syncthreads();
  a = red[64];
  b = red[65];
}

__device__ __forceinline__ float silu(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}

// dz / g for the pre-activation z: s (1 + z (1 - s)), s = sigmoid(z).
__device__ __forceinline__ float silu_grad(float z) {
  const float s = __fdividef(1.f, 1.f + __expf(-z));
  return s * fmaf(z, 1.f - s, 1.f);
}

// Where a thread of the vector kernels works: vector column `cv` of the
// group's `vr` = gs / V vectors of V channels, rows r0, r0 + rows, ...;
// threads past rows * vr idle.
struct Column {
  int vr, rows, cv, r0;
  bool active;
};

template <int THREADS, int LOG_V>
__device__ __forceinline__ Column column_of(int gs) {
  Column col;
  col.vr = gs >> LOG_V;
  col.rows = THREADS / col.vr;
  col.r0 = threadIdx.x / col.vr;
  col.cv = threadIdx.x - col.r0 * col.vr;
  col.active = col.r0 < col.rows;
  return col;
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
gn_silu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ y,
                   float* __restrict__ mean_out, float* __restrict__ rstd_out,
                   int hw, int c, int groups, float eps) {
  using Vec = typename Io<T>::Vec;
  constexpr int V = Io<T>::V, LOG_V = Io<T>::LOG_V;
  extern __shared__ float4 smem_fwd[];
  Vec* group = reinterpret_cast<Vec*>(smem_fwd);  // (hw, vr) vectors of x
  __shared__ float red[66];
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x - b * groups;
  const int gs = c / groups;
  const float n = (float)hw * (float)gs;
  const Column col = column_of<THREADS, LOG_V>(gs);
  const int rs = c >> LOG_V;  // vectors from one row to the next
  const size_t base = ((size_t)b * hw * c + (size_t)g * gs) >> LOG_V;
  const Vec* xg = reinterpret_cast<const Vec*>(x) + base + col.cv;
  Vec* yg = reinterpret_cast<Vec*>(y) + base + col.cv;
  Vec* mine = group + col.cv;

  float s = 0.f, unused = 0.f;
  if (col.active) {
#pragma unroll 4
    for (int r = col.r0; r < hw; r += col.rows) {
      const Vec v = xg[(size_t)r * rs];
      mine[r * col.vr] = v;
      float f[V];
      Io<T>::unpack(v, f);
      s += vsum<V>(f);
    }
  }
  block_sum2<THREADS>(s, unused, red);
  const float mean = s / n;

  float ss = 0.f;
  if (col.active) {
#pragma unroll 4
    for (int r = col.r0; r < hw; r += col.rows) {
      float f[V];
      Io<T>::unpack(mine[r * col.vr], f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = f[j] - mean;
        ss = fmaf(d, d, ss);
      }
    }
  }
  unused = 0.f;
  block_sum2<THREADS>(ss, unused, red);
  const float inv = 1.f / sqrtf(ss / n + eps);
  if (threadIdx.x == 0) {
    mean_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = inv;
  }

  if (col.active) {
    float sc[V], bi[V];
    load_channels<V>(sc, scale + (size_t)g * gs, col.cv);
    load_channels<V>(bi, bias + (size_t)g * gs, col.cv);
#pragma unroll
    for (int j = 0; j < V; ++j) sc[j] *= inv;
#pragma unroll 4
    for (int r = col.r0; r < hw; r += col.rows) {
      float f[V];
      Io<T>::unpack(mine[r * col.vr], f);
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = silu(fmaf(f[j] - mean, sc[j], bi[j]));
      yg[(size_t)r * rs] = Io<T>::pack(f);
    }
  }
}

// XS: xh is kept in shared memory beside dxh; else x is read again for dx.
// dxh and xh are float32 in shared memory whatever T is: V / 4 float4 a
// vector.
template <typename T, int THREADS, bool XS>
__global__ void __launch_bounds__(THREADS)
gn_silu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gout,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   const float* __restrict__ mean_in,
                   const float* __restrict__ rstd_in, T* __restrict__ dx,
                   float* __restrict__ dscale_rows,
                   float* __restrict__ dbias_rows, int hw, int c, int groups) {
  using Vec = typename Io<T>::Vec;
  constexpr int V = Io<T>::V, LOG_V = Io<T>::LOG_V;
  constexpr int Q = V / 4;  // float4 of one vector's float32 values
  // (hw, vr) vectors of dxh, then (XS) as many of xh; afterwards the
  // threads' channel sums, 2 V floats each
  extern __shared__ float4 group[];
  __shared__ float red[66];
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x - b * groups;
  const int gs = c / groups;
  const float n = (float)hw * (float)gs;
  const Column col = column_of<THREADS, LOG_V>(gs);
  const int rs = c >> LOG_V;
  const size_t base = ((size_t)b * hw * c + (size_t)g * gs) >> LOG_V;
  const Vec* xg = reinterpret_cast<const Vec*>(x) + base + col.cv;
  const Vec* gg = reinterpret_cast<const Vec*>(gout) + base + col.cv;
  Vec* dxg = reinterpret_cast<Vec*>(dx) + base + col.cv;
  float4* dxh_s = group + col.cv * Q;
  float4* xh_s = group + ((size_t)hw * col.vr + col.cv) * Q;
  const float mean = mean_in[blockIdx.x];
  const float inv = rstd_in[blockIdx.x];

  float db[V], dg[V];
#pragma unroll
  for (int j = 0; j < V; ++j) db[j] = dg[j] = 0.f;
  float s1 = 0.f, s2 = 0.f;
  if (col.active) {
    float sc[V], bi[V];
    load_channels<V>(sc, scale + (size_t)g * gs, col.cv);
    load_channels<V>(bi, bias + (size_t)g * gs, col.cv);
#pragma unroll 2
    for (int r = col.r0; r < hw; r += col.rows) {
      float xh[V], dxh[V], gv[V];
      Io<T>::unpack(xg[(size_t)r * rs], xh);
      Io<T>::unpack(gg[(size_t)r * rs], gv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        xh[j] = (xh[j] - mean) * inv;
        const float dz = gv[j] * silu_grad(fmaf(xh[j], sc[j], bi[j]));
        db[j] += dz;
        dg[j] = fmaf(dz, xh[j], dg[j]);
        dxh[j] = dz * sc[j];
        s1 += dxh[j];
        s2 = fmaf(dxh[j], xh[j], s2);
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        dxh_s[r * col.vr * Q + q] = make_float4(
            dxh[4 * q], dxh[4 * q + 1], dxh[4 * q + 2], dxh[4 * q + 3]);
        if (XS)
          xh_s[r * col.vr * Q + q] = make_float4(
              xh[4 * q], xh[4 * q + 1], xh[4 * q + 2], xh[4 * q + 3]);
      }
    }
  }
  block_sum2<THREADS>(s1, s2, red);
  const float m1 = s1 / n, m2 = s2 / n;

  if (col.active) {
#pragma unroll 4
    for (int r = col.r0; r < hw; r += col.rows) {
      float dxh[V], xh[V];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 d4 = dxh_s[r * col.vr * Q + q];
        dxh[4 * q] = d4.x;
        dxh[4 * q + 1] = d4.y;
        dxh[4 * q + 2] = d4.z;
        dxh[4 * q + 3] = d4.w;
        if (XS) {
          const float4 x4 = xh_s[r * col.vr * Q + q];
          xh[4 * q] = x4.x;
          xh[4 * q + 1] = x4.y;
          xh[4 * q + 2] = x4.z;
          xh[4 * q + 3] = x4.w;
        }
      }
      if (!XS) {
        Io<T>::unpack(xg[(size_t)r * rs], xh);
#pragma unroll
        for (int j = 0; j < V; ++j) xh[j] = (xh[j] - mean) * inv;
      }
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = (dxh[j] - m1 - xh[j] * m2) * inv;
      dxg[(size_t)r * rs] = Io<T>::pack(o);
    }
  }

  // dbias, dscale of the group's channels for this image: the threads of a
  // column, one per row residue, summed in row order
  if (THREADS == 32) __syncwarp(); else __syncthreads();
  if (col.active) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      group[2 * Q * threadIdx.x + q] =
          make_float4(db[4 * q], db[4 * q + 1], db[4 * q + 2], db[4 * q + 3]);
      group[2 * Q * threadIdx.x + Q + q] =
          make_float4(dg[4 * q], dg[4 * q + 1], dg[4 * q + 2], dg[4 * q + 3]);
    }
  }
  if (THREADS == 32) __syncwarp(); else __syncthreads();
  const float* sums = reinterpret_cast<const float*>(group);
  for (int t = threadIdx.x; t < 2 * gs; t += THREADS) {
    const int which = t / gs;  // 0: dbias, 1: dscale
    const int ch = t - which * gs;
    const float* p =
        sums + (ch >> LOG_V) * 2 * V + which * V + (ch & (V - 1));
    float acc = 0.f;
    for (int r = 0; r < col.rows; ++r) acc += p[(size_t)r * col.vr * 2 * V];
    (which ? dscale_rows : dbias_rows)[(size_t)b * c + (size_t)g * gs + ch] =
        acc;
  }
}

// The backward's cluster form: the (image, group) of cluster blockIdx.x / k,
// its rows [rank * share, (rank + 1) * share) in the block of cluster rank
// `rank`, which walks them as gn_silu_bwd_kernel walks a whole group (XS: xh
// kept beside dxh). The two means' sums and then the channel sums of the k
// blocks are read through distributed shared memory in rank order, so every
// block holds the same means and the result is the same from run to run.
template <typename T, int THREADS, bool XS>
__global__ void __launch_bounds__(THREADS)
gn_silu_bwd_cluster_kernel(const T* __restrict__ x, const T* __restrict__ gout,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           const float* __restrict__ mean_in,
                           const float* __restrict__ rstd_in,
                           T* __restrict__ dx, float* __restrict__ dscale_rows,
                           float* __restrict__ dbias_rows, int hw, int c,
                           int groups, int k, int share) {
  using Vec = typename Io<T>::Vec;
  constexpr int V = Io<T>::V, LOG_V = Io<T>::LOG_V;
  constexpr int Q = V / 4;
  // (share, vr) vectors of dxh, then (XS) as many of xh; afterwards the
  // threads' channel sums, 2 V floats each, summed down to the first row
  extern __shared__ float4 group[];
  __shared__ float red[66];
  __shared__ float part[2];   // this block's sums of dxh and dxh xh
  __shared__ float total[2];  // the cluster's
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bg = blockIdx.x / k;  // b * groups + g
  const int b = bg / groups;
  const int g = bg - b * groups;
  const int gs = c / groups;
  const float n = (float)hw * (float)gs;
  const Column col = column_of<THREADS, LOG_V>(gs);
  const int rs = c >> LOG_V;
  const int row0 = rank * share;
  const int rows = min(hw, row0 + share) - row0;  // this block's
  const size_t base =
      (((size_t)b * hw + row0) * c + (size_t)g * gs) >> LOG_V;
  const Vec* xg = reinterpret_cast<const Vec*>(x) + base + col.cv;
  const Vec* gg = reinterpret_cast<const Vec*>(gout) + base + col.cv;
  Vec* dxg = reinterpret_cast<Vec*>(dx) + base + col.cv;
  float4* dxh_s = group + col.cv * Q;
  float4* xh_s = group + ((size_t)share * col.vr + col.cv) * Q;
  const float mean = mean_in[bg];
  const float inv = rstd_in[bg];

  float db[V], dg[V];
#pragma unroll
  for (int j = 0; j < V; ++j) db[j] = dg[j] = 0.f;
  float s1 = 0.f, s2 = 0.f;
  if (col.active) {
    float sc[V], bi[V];
    load_channels<V>(sc, scale + (size_t)g * gs, col.cv);
    load_channels<V>(bi, bias + (size_t)g * gs, col.cv);
#pragma unroll 2
    for (int r = col.r0; r < rows; r += col.rows) {
      float xh[V], dxh[V], gv[V];
      Io<T>::unpack(xg[(size_t)r * rs], xh);
      Io<T>::unpack(gg[(size_t)r * rs], gv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        xh[j] = (xh[j] - mean) * inv;
        const float dz = gv[j] * silu_grad(fmaf(xh[j], sc[j], bi[j]));
        db[j] += dz;
        dg[j] = fmaf(dz, xh[j], dg[j]);
        dxh[j] = dz * sc[j];
        s1 += dxh[j];
        s2 = fmaf(dxh[j], xh[j], s2);
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        dxh_s[r * col.vr * Q + q] = make_float4(
            dxh[4 * q], dxh[4 * q + 1], dxh[4 * q + 2], dxh[4 * q + 3]);
        if (XS)
          xh_s[r * col.vr * Q + q] = make_float4(
              xh[4 * q], xh[4 * q + 1], xh[4 * q + 2], xh[4 * q + 3]);
      }
    }
  }
  block_sum2<THREADS>(s1, s2, red);
  if (threadIdx.x == 0) {
    part[0] = s1;
    part[1] = s2;
  }
  cluster.sync();  // every block's part is written
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < k; ++r) {
      const float* p = cluster.map_shared_rank(part, r);
      t1 += p[0];
      t2 += p[1];
    }
    total[0] = t1;
    total[1] = t2;
  }
  __syncthreads();
  const float m1 = total[0] / n, m2 = total[1] / n;

  if (col.active) {
#pragma unroll 4
    for (int r = col.r0; r < rows; r += col.rows) {
      float dxh[V], xh[V];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 d4 = dxh_s[r * col.vr * Q + q];
        dxh[4 * q] = d4.x;
        dxh[4 * q + 1] = d4.y;
        dxh[4 * q + 2] = d4.z;
        dxh[4 * q + 3] = d4.w;
        if (XS) {
          const float4 x4 = xh_s[r * col.vr * Q + q];
          xh[4 * q] = x4.x;
          xh[4 * q + 1] = x4.y;
          xh[4 * q + 2] = x4.z;
          xh[4 * q + 3] = x4.w;
        }
      }
      if (!XS) {
        Io<T>::unpack(xg[(size_t)r * rs], xh);
#pragma unroll
        for (int j = 0; j < V; ++j) xh[j] = (xh[j] - mean) * inv;
      }
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = (dxh[j] - m1 - xh[j] * m2) * inv;
      dxg[(size_t)r * rs] = Io<T>::pack(o);
    }
  }

  // dbias, dscale of the group's channels for this image: each block's
  // column sums (a tree over the rows of its threads, row r + h into row r),
  // then the k blocks' in rank order
  __syncthreads();  // dxh and xh are read
  if (col.active) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      group[2 * Q * threadIdx.x + q] =
          make_float4(db[4 * q], db[4 * q + 1], db[4 * q + 2], db[4 * q + 3]);
      group[2 * Q * threadIdx.x + Q + q] =
          make_float4(dg[4 * q], dg[4 * q + 1], dg[4 * q + 2], dg[4 * q + 3]);
    }
  }
  __syncthreads();
  float* sums = reinterpret_cast<float*>(group);
  const int row_floats = 2 * gs;  // a row of threads' sums: vr x 2 V floats
  int h = 1;
  while (2 * h < col.rows) h *= 2;
  for (; h > 0; h >>= 1) {
    if (h < col.rows) {
      for (int i = threadIdx.x; i < h * row_floats; i += THREADS) {
        if (i / row_floats + h < col.rows) sums[i] += sums[i + h * row_floats];
      }
    }
    __syncthreads();
  }
  cluster.sync();  // every block's first row holds its channel sums
  for (int t = threadIdx.x * k + rank; t < 2 * gs; t += THREADS * k) {
    const int which = t / gs;  // 0: dbias, 1: dscale
    const int ch = t - which * gs;
    const int off = (ch >> LOG_V) * 2 * V + which * V + (ch & (V - 1));
    float acc = 0.f;
    for (int r = 0; r < k; ++r) acc += cluster.map_shared_rank(sums, r)[off];
    (which ? dscale_rows : dbias_rows)[(size_t)b * c + (size_t)g * gs + ch] =
        acc;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// The generic forward: any C / G, any size; the group read three times.
template <typename T>
__global__ void __launch_bounds__(kGenericThreads)
gn_silu_fwd_generic_kernel(const T* __restrict__ x,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           T* __restrict__ y, float* __restrict__ mean_out,
                           float* __restrict__ rstd_out, int hw, int c,
                           int groups, float eps) {
  __shared__ float red[66];
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x - b * groups;
  const int gs = c / groups;
  const size_t n = (size_t)hw * gs;
  const size_t base = (size_t)b * hw * c + (size_t)g * gs;
  const T* xg = x + base;
  T* yg = y + base;

  float s = 0.f, unused = 0.f;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t r = i / gs;
    s += Io<T>::widen(xg[r * c + (i - r * gs)]);
  }
  block_sum2<0>(s, unused, red);
  const float mean = s / (float)n;

  float ss = 0.f;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t r = i / gs;
    const float d = Io<T>::widen(xg[r * c + (i - r * gs)]) - mean;
    ss = fmaf(d, d, ss);
  }
  unused = 0.f;
  block_sum2<0>(ss, unused, red);
  const float inv = 1.f / sqrtf(ss / (float)n + eps);
  if (threadIdx.x == 0) {
    mean_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = inv;
  }

  for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t r = i / gs;
    const int col = (int)(i - r * gs);
    const int ch = g * gs + col;
    const size_t off = r * c + col;
    yg[off] = Io<T>::round(
        silu(fmaf(Io<T>::widen(xg[off]) - mean, inv * scale[ch], bias[ch])));
  }
}

// The generic backward: the group's two means, then dx, then each channel's
// dbias and dscale by a block sum of its own.
template <typename T>
__global__ void __launch_bounds__(kGenericThreads)
gn_silu_bwd_generic_kernel(const T* __restrict__ x,
                           const T* __restrict__ gout,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           const float* __restrict__ mean_in,
                           const float* __restrict__ rstd_in,
                           T* __restrict__ dx,
                           float* __restrict__ dscale_rows,
                           float* __restrict__ dbias_rows, int hw, int c,
                           int groups) {
  __shared__ float red[66];
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x - b * groups;
  const int gs = c / groups;
  const size_t n = (size_t)hw * gs;
  const size_t base = (size_t)b * hw * c + (size_t)g * gs;
  const T* xg = x + base;
  const T* gg = gout + base;
  T* dxg = dx + base;
  const float mean = mean_in[blockIdx.x];
  const float inv = rstd_in[blockIdx.x];

  float s1 = 0.f, s2 = 0.f;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t r = i / gs;
    const int col = (int)(i - r * gs);
    const int ch = g * gs + col;
    const size_t off = r * c + col;
    const float xh = (Io<T>::widen(xg[off]) - mean) * inv;
    const float dxh = Io<T>::widen(gg[off]) *
                      silu_grad(fmaf(xh, scale[ch], bias[ch])) * scale[ch];
    s1 += dxh;
    s2 = fmaf(dxh, xh, s2);
  }
  block_sum2<0>(s1, s2, red);
  const float m1 = s1 / (float)n, m2 = s2 / (float)n;

  for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t r = i / gs;
    const int col = (int)(i - r * gs);
    const int ch = g * gs + col;
    const size_t off = r * c + col;
    const float xh = (Io<T>::widen(xg[off]) - mean) * inv;
    const float dxh = Io<T>::widen(gg[off]) *
                      silu_grad(fmaf(xh, scale[ch], bias[ch])) * scale[ch];
    dxg[off] = Io<T>::round((dxh - m1 - xh * m2) * inv);
  }

  for (int col = 0; col < gs; ++col) {
    const int ch = g * gs + col;
    float db = 0.f, dg = 0.f;
    for (int r = threadIdx.x; r < hw; r += blockDim.x) {
      const size_t off = (size_t)r * c + col;
      const float xh = (Io<T>::widen(xg[off]) - mean) * inv;
      const float dz = Io<T>::widen(gg[off]) *
                       silu_grad(fmaf(xh, scale[ch], bias[ch]));
      db += dz;
      dg = fmaf(dz, xh, dg);
    }
    block_sum2<0>(db, dg, red);
    if (threadIdx.x == 0) {
      dbias_rows[(size_t)b * c + ch] = db;
      dscale_rows[(size_t)b * c + ch] = dg;
    }
  }
}

// The block size for a group of `nv` vectors in rows of `vr`: about eight
// vectors a thread, one warp to 1024 threads, never fewer threads than a row
// has vectors.
int threads_for(size_t nv, int vr) {
  int t = nv <= 256 ? 32 : nv <= 1024 ? 128 : nv <= 2048 ? 256
          : nv <= 4096 ? 512 : 1024;
  while (t < vr) t = t == 32 ? 128 : 2 * t;
  return t;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Channels in a 16-byte vector and bytes an element of the I/O type.
int vec_of(bool bf16) { return bf16 ? 8 : 4; }
size_t elem_of(bool bf16) { return bf16 ? 2 : 4; }

// The vector kernels' shared memory: the forward's group of x in the I/O
// type; the backward's `copies` of the group in float32, and no less than
// the channel sums need (2 V floats a thread).
size_t shared_bytes(int hw, int gs, int copies, int threads, bool backward,
                    bool bf16) {
  if (!backward) return (size_t)hw * gs * elem_of(bf16);
  const size_t data = (size_t)hw * gs * sizeof(float) * copies;
  const size_t sums = (size_t)threads * 2 * vec_of(bf16) * sizeof(float);
  return data > sums ? data : sums;
}

// 0: the generic kernels; 1: the group once in shared memory (the forward's
// x; the backward's dxh); 2: twice (the backward's dxh and xh).
int form_for(int hw, int c, int groups, bool backward, bool bf16) {
  const int gs = c / groups;
  const int v = vec_of(bf16);
  if (gs % v != 0 || gs / v > 1024) return 0;
  if (!backward)
    return shared_bytes(hw, gs, 1, 0, false, bf16) <= kSharedMax ? 1 : 0;
  const size_t one = (size_t)hw * gs * sizeof(float);
  if (2 * one <= kSharedMax) return 2;
  return one <= kSharedMax ? 1 : 0;
}

// The backward's cluster form for a group that form_for leaves to the
// generic kernels although its rows are whole vectors: the least k of 2, 4,
// 8, 16 at which a share of ceil(hw / k) rows fits kSharedMax with dxh; at
// that k, form 4 where dxh and xh both fit, else form 3 (dxh alone); form 0
// where even 16 do not. (At the
// SR UNet's shapes on an H100, preferring dxh and xh in clusters twice as
// large read 1.2-1.4 times slower, and shares of half the shared memory the
// same.)
struct Cluster {
  int form, k, share;
};

Cluster cluster_for(int hw, int c, int groups, bool bf16) {
  const int gs = c / groups;
  const int v = vec_of(bf16);
  if (gs % v != 0 || gs / v > 1024 || form_for(hw, c, groups, true, bf16))
    return {0, 0, 0};
  for (int k = 2; k <= kClusterMax; k *= 2) {
    const int share = (hw + k - 1) / k;
    const size_t one = (size_t)share * gs * sizeof(float);
    if (2 * one <= kSharedMax) return {4, k, share};
    if (one <= kSharedMax) return {3, k, share};
  }
  return {0, 0, 0};
}

// The opt-in to more than 48 KiB of dynamic shared memory holds per kernel
// and device: set it at the first launch on each device.
int opt_in(const void* kernel, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSharedMax);
    if (err != cudaSuccess) return (int)err;
    done[dev].store(true, std::memory_order_release);
  }
  return 0;
}

template <typename T, int THREADS>
int launch_fwd(const T* x, const float* scale, const float* bias, T* y,
               float* mean, float* rstd, int batch, int hw, int c, int groups,
               float eps, size_t smem, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const int err = opt_in((const void*)gn_silu_fwd_kernel<T, THREADS>, done);
  if (err != 0) return err;
  gn_silu_fwd_kernel<T, THREADS><<<batch * groups, THREADS, smem, stream>>>(
      x, scale, bias, y, mean, rstd, hw, c, groups, eps);
  return (int)cudaGetLastError();
}

template <typename T, int THREADS, bool XS>
int launch_bwd(const T* x, const T* g, const float* scale, const float* bias,
               const float* mean, const float* rstd, T* dx, float* dscale_rows,
               float* dbias_rows, int batch, int hw, int c, int groups,
               size_t smem, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const int err =
      opt_in((const void*)gn_silu_bwd_kernel<T, THREADS, XS>, done);
  if (err != 0) return err;
  gn_silu_bwd_kernel<T, THREADS, XS>
      <<<batch * groups, THREADS, smem, stream>>>(
          x, g, scale, bias, mean, rstd, dx, dscale_rows, dbias_rows, hw, c,
          groups);
  return (int)cudaGetLastError();
}

// The cluster form's launch (cudaLaunchKernelEx, clusters of k blocks along
// x). Once per device: the shared-memory opt-in and, past the portable 8
// blocks, the non-portable cluster size; and once per device, cluster size
// and largest `smem` so far, whether such a cluster can be scheduled at all
// (cudaOccupancyMaxActiveClusters): where it cannot, the call fails with
// cudaErrorInvalidConfiguration and launches nothing.
template <typename T, int THREADS, bool XS>
int launch_bwd_cluster(const T* x, const T* g, const float* scale,
                       const float* bias, const float* mean,
                       const float* rstd, T* dx, float* dscale_rows,
                       float* dbias_rows, int batch, int hw, int c,
                       int groups, int k, int share, size_t smem,
                       cudaStream_t stream) {
  auto kernel = gn_silu_bwd_cluster_kernel<T, THREADS, XS>;
  static std::atomic<bool> done[kMaxDevices];
  static std::atomic<size_t> fits[kMaxDevices][4];  // k = 2, 4, 8, 16
  int err = opt_in((const void*)kernel, done);
  if (err != 0) return err;
  if ((size_t)k * batch * groups >= ((size_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k * batch * groups);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int slot = 0;
  while ((2 << slot) < k) ++slot;
  if (fits[dev][slot].load(std::memory_order_acquire) < smem) {
    if (k > 8) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return (int)e;
    }
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    fits[dev][slot].store(smem, std::memory_order_release);
  }
  e = cudaLaunchKernelEx(&cfg, kernel, x, g, scale, bias, mean, rstd, dx,
                         dscale_rows, dbias_rows, hw, c, groups, k, share);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int forward(const void* x, const void* scale, const void* bias, void* y,
            void* mean, void* rstd, int batch, int hw, int c, int groups,
            float eps, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int gs = c / groups;
  const bool vec = form_for(hw, c, groups, false, kBf16) != 0 &&
                   aligned16(x) && aligned16(y) && aligned16(scale) &&
                   aligned16(bias);
  if (!vec) {
    gn_silu_fwd_generic_kernel<T><<<batch * groups, kGenericThreads, 0,
                                    stream>>>(
        (const T*)x, (const float*)scale, (const float*)bias, (T*)y,
        (float*)mean, (float*)rstd, hw, c, groups, eps);
    return (int)cudaGetLastError();
  }
  const int v = Io<T>::V;
  const int threads = threads_for((size_t)hw * gs / v, gs / v);
  const size_t smem = shared_bytes(hw, gs, 1, threads, false, kBf16);
  auto f = threads == 32    ? &launch_fwd<T, 32>
           : threads == 128 ? &launch_fwd<T, 128>
           : threads == 256 ? &launch_fwd<T, 256>
           : threads == 512 ? &launch_fwd<T, 512>
                            : &launch_fwd<T, 1024>;
  return f((const T*)x, (const float*)scale, (const float*)bias, (T*)y,
           (float*)mean, (float*)rstd, batch, hw, c, groups, eps, smem,
           stream);
}

template <typename T>
int backward(const void* x, const void* g, const void* scale, const void* bias,
             const void* mean, const void* rstd, void* dx, void* dscale_rows,
             void* dbias_rows, int batch, int hw, int c, int groups,
             cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int gs = c / groups;
  const int v = Io<T>::V;
  const bool aligned = aligned16(x) && aligned16(g) && aligned16(dx) &&
                       aligned16(scale) && aligned16(bias);
  int form = aligned ? form_for(hw, c, groups, true, kBf16) : 0;
  const Cluster cl = cluster_for(hw, c, groups, kBf16);
  if (aligned && cl.form != 0) {
    const int threads = threads_for((size_t)cl.share * gs / v, gs / v);
    const size_t smem =
        shared_bytes(cl.share, gs, cl.form - 2, threads, true, kBf16);
    using Launch = int (*)(const T*, const T*, const float*, const float*,
                           const float*, const float*, T*, float*, float*,
                           int, int, int, int, int, int, size_t,
                           cudaStream_t);
    Launch f;
    if (cl.form == 4) {
      f = threads == 32    ? &launch_bwd_cluster<T, 32, true>
          : threads == 128 ? &launch_bwd_cluster<T, 128, true>
          : threads == 256 ? &launch_bwd_cluster<T, 256, true>
          : threads == 512 ? &launch_bwd_cluster<T, 512, true>
                           : &launch_bwd_cluster<T, 1024, true>;
    } else {
      f = threads == 32    ? &launch_bwd_cluster<T, 32, false>
          : threads == 128 ? &launch_bwd_cluster<T, 128, false>
          : threads == 256 ? &launch_bwd_cluster<T, 256, false>
          : threads == 512 ? &launch_bwd_cluster<T, 512, false>
                           : &launch_bwd_cluster<T, 1024, false>;
    }
    return f((const T*)x, (const T*)g, (const float*)scale,
             (const float*)bias, (const float*)mean, (const float*)rstd,
             (T*)dx, (float*)dscale_rows, (float*)dbias_rows, batch, hw, c,
             groups, cl.k, cl.share, smem, stream);
  }
  if (form == 0) {
    gn_silu_bwd_generic_kernel<T><<<batch * groups, kGenericThreads, 0,
                                    stream>>>(
        (const T*)x, (const T*)g, (const float*)scale, (const float*)bias,
        (const float*)mean, (const float*)rstd, (T*)dx, (float*)dscale_rows,
        (float*)dbias_rows, hw, c, groups);
    return (int)cudaGetLastError();
  }
  const int threads = threads_for((size_t)hw * gs / v, gs / v);
  const size_t smem = shared_bytes(hw, gs, form, threads, true, kBf16);
  if (smem > kSharedMax) return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const T*, const T*, const float*, const float*,
                         const float*, const float*, T*, float*, float*, int,
                         int, int, int, size_t, cudaStream_t);
  Launch f;
  if (form == 2) {
    f = threads == 32    ? &launch_bwd<T, 32, true>
        : threads == 128 ? &launch_bwd<T, 128, true>
        : threads == 256 ? &launch_bwd<T, 256, true>
        : threads == 512 ? &launch_bwd<T, 512, true>
                         : &launch_bwd<T, 1024, true>;
  } else {
    f = threads == 32    ? &launch_bwd<T, 32, false>
        : threads == 128 ? &launch_bwd<T, 128, false>
        : threads == 256 ? &launch_bwd<T, 256, false>
        : threads == 512 ? &launch_bwd<T, 512, false>
                         : &launch_bwd<T, 1024, false>;
  }
  return f((const T*)x, (const T*)g, (const float*)scale, (const float*)bias,
           (const float*)mean, (const float*)rstd, (T*)dx,
           (float*)dscale_rows, (float*)dbias_rows, batch, hw, c, groups,
           smem, stream);
}

}  // namespace

// The form the kernels take for this shape and I/O type (`form_for`; the
// backward's cluster forms 3 and 4, `cluster_for`) times 10000, plus the
// block size (the table's choice for the vector kernels), plus the cluster
// size times 100000.
extern "C" int gn_silu_form(int hw, int c, int groups, int backward,
                            int bf16) {
  if (groups < 1 || c % groups != 0) return 0;
  const int gs = c / groups;
  const int v = vec_of(bf16 != 0);
  if (backward) {
    const Cluster cl = cluster_for(hw, c, groups, bf16 != 0);
    if (cl.form != 0)
      return cl.k * 100000 + cl.form * 10000 +
             threads_for((size_t)cl.share * gs / v, gs / v);
  }
  const int form = form_for(hw, c, groups, backward != 0, bf16 != 0);
  if (form == 0) return kGenericThreads;
  return form * 10000 + threads_for((size_t)hw * gs / v, gs / v);
}

// x, y: (batch, hw, c), contiguous, float32 or (`bf16` != 0) bfloat16;
// scale, bias: (c,) float32; mean, rstd: (batch, groups) float32, written.
// Returns the CUDA error of the launch (0 on success).
extern "C" int gn_silu_fwd(const void* x, const void* scale, const void* bias,
                           void* y, void* mean, void* rstd, int batch, int hw,
                           int c, int groups, float eps, int bf16,
                           void* stream) {
  if (groups < 1 || c % groups != 0) return (int)cudaErrorInvalidValue;
  auto f = bf16 ? &forward<__nv_bfloat16> : &forward<float>;
  return f(x, scale, bias, y, mean, rstd, batch, hw, c, groups, eps,
           (cudaStream_t)stream);
}

// x, g (the gradient of y), dx: (batch, hw, c), contiguous, float32 or
// (`bf16` != 0) bfloat16; scale, bias: (c,); mean, rstd: (batch, groups) from
// the forward; dscale_rows, dbias_rows: (batch, c), written: each image's
// sums, for the caller to add over the batch. Those four float32.
extern "C" int gn_silu_bwd(const void* x, const void* g, const void* scale,
                           const void* bias, const void* mean, const void* rstd,
                           void* dx, void* dscale_rows, void* dbias_rows,
                           int batch, int hw, int c, int groups, int bf16,
                           void* stream) {
  if (groups < 1 || c % groups != 0) return (int)cudaErrorInvalidValue;
  auto f = bf16 ? &backward<__nv_bfloat16> : &backward<float>;
  return f(x, g, scale, bias, mean, rstd, dx, dscale_rows, dbias_rows, batch,
           hw, c, groups, (cudaStream_t)stream);
}
