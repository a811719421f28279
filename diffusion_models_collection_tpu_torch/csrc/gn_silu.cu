// GroupNorm + SiLU on (B, HW, C) float32 activations (NHWC images flattened
// over H and W), with per-channel affine scale and bias: the forward, which
// also writes each (image, group)'s mean and 1 / sigma, and the backward from
// them.
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
// * A group that does not fit shared memory, or whose rows are no whole
//   vectors, takes the generic kernels: scalar accesses, the group read
//   three times (the backward once more per channel). They are right, not
//   fast.
// The SiLU's exponential is __expf and its division __fdividef: both within
// 2 ulp here, against a bar of 2e-5.
// Measured on an H100 80GB HBM3 at 700 W (tools/profile_torch_kernels.py,
// launches in a row, batch 160 forward / 128 backward, ms): 32 x 32 x 384
// forward 0.213 (bytes alone 0.150; three reads from device memory 0.722),
// backward 0.308 (bytes 0.180; autograd through the plain forward 3.3);
// 32 x 32 x 128 0.084 / 0.118. The groups of 4 x 4 and 8 x 8 images take
// less time on the card than their launch takes on the host.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kGenericThreads = 256;
constexpr int kMaxDevices = 64;
// Dynamic shared memory a block may ask for, less the kernels' static few
// hundred bytes.
constexpr size_t kSharedMax = 232448 - 1024;

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
// group's `vr` = gs / 4, rows r0, r0 + rows, ...; threads past rows * vr idle.
struct Column {
  int vr, rows, cv, r0;
  bool active;
};

template <int THREADS>
__device__ __forceinline__ Column column_of(int gs) {
  Column col;
  col.vr = gs >> 2;
  col.rows = THREADS / col.vr;
  col.r0 = threadIdx.x / col.vr;
  col.cv = threadIdx.x - col.r0 * col.vr;
  col.active = col.r0 < col.rows;
  return col;
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
gn_silu_fwd_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, float* __restrict__ y,
                   float* __restrict__ mean_out, float* __restrict__ rstd_out,
                   int hw, int c, int groups, float eps) {
  extern __shared__ float4 group[];  // (hw, vr) vectors
  __shared__ float red[66];
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x - b * groups;
  const int gs = c / groups;
  const float n = (float)hw * (float)gs;
  const Column col = column_of<THREADS>(gs);
  const int rs = c >> 2;  // vectors from one row to the next
  const size_t base = ((size_t)b * hw * c + (size_t)g * gs) >> 2;
  const float4* xg = reinterpret_cast<const float4*>(x) + base + col.cv;
  float4* yg = reinterpret_cast<float4*>(y) + base + col.cv;
  float4* mine = group + col.cv;

  float s = 0.f, unused = 0.f;
  if (col.active) {
#pragma unroll 4
    for (int r = col.r0; r < hw; r += col.rows) {
      const float4 v = xg[(size_t)r * rs];
      mine[r * col.vr] = v;
      s += (v.x + v.y) + (v.z + v.w);
    }
  }
  block_sum2<THREADS>(s, unused, red);
  const float mean = s / n;

  float ss = 0.f;
  if (col.active) {
#pragma unroll 4
    for (int r = col.r0; r < hw; r += col.rows) {
      const float4 v = mine[r * col.vr];
      const float dx = v.x - mean, dy = v.y - mean, dz = v.z - mean,
                  dw = v.w - mean;
      ss = fmaf(dx, dx, ss);
      ss = fmaf(dy, dy, ss);
      ss = fmaf(dz, dz, ss);
      ss = fmaf(dw, dw, ss);
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
    float4 sc = reinterpret_cast<const float4*>(scale + (size_t)g * gs)[col.cv];
    const float4 bi =
        reinterpret_cast<const float4*>(bias + (size_t)g * gs)[col.cv];
    sc.x *= inv;
    sc.y *= inv;
    sc.z *= inv;
    sc.w *= inv;
#pragma unroll 4
    for (int r = col.r0; r < hw; r += col.rows) {
      const float4 v = mine[r * col.vr];
      float4 o;
      o.x = silu(fmaf(v.x - mean, sc.x, bi.x));
      o.y = silu(fmaf(v.y - mean, sc.y, bi.y));
      o.z = silu(fmaf(v.z - mean, sc.z, bi.z));
      o.w = silu(fmaf(v.w - mean, sc.w, bi.w));
      yg[(size_t)r * rs] = o;
    }
  }
}

// XS: xh is kept in shared memory beside dxh; else x is read again for dx.
template <int THREADS, bool XS>
__global__ void __launch_bounds__(THREADS)
gn_silu_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gout,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   const float* __restrict__ mean_in,
                   const float* __restrict__ rstd_in, float* __restrict__ dx,
                   float* __restrict__ dscale_rows,
                   float* __restrict__ dbias_rows, int hw, int c, int groups) {
  // (hw, vr) vectors of dxh, then (XS) as many of xh; afterwards the
  // threads' channel sums, eight floats each
  extern __shared__ float4 group[];
  __shared__ float red[66];
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x - b * groups;
  const int gs = c / groups;
  const float n = (float)hw * (float)gs;
  const Column col = column_of<THREADS>(gs);
  const int rs = c >> 2;
  const size_t base = ((size_t)b * hw * c + (size_t)g * gs) >> 2;
  const float4* xg = reinterpret_cast<const float4*>(x) + base + col.cv;
  const float4* gg = reinterpret_cast<const float4*>(gout) + base + col.cv;
  float4* dxg = reinterpret_cast<float4*>(dx) + base + col.cv;
  float4* dxh_s = group + col.cv;
  float4* xh_s = group + (size_t)hw * col.vr + col.cv;
  const float mean = mean_in[blockIdx.x];
  const float inv = rstd_in[blockIdx.x];

  float4 db = make_float4(0.f, 0.f, 0.f, 0.f), dg = db;
  float s1 = 0.f, s2 = 0.f;
  if (col.active) {
    const float4 sc =
        reinterpret_cast<const float4*>(scale + (size_t)g * gs)[col.cv];
    const float4 bi =
        reinterpret_cast<const float4*>(bias + (size_t)g * gs)[col.cv];
#pragma unroll 2
    for (int r = col.r0; r < hw; r += col.rows) {
      const float4 xv = xg[(size_t)r * rs];
      const float4 gv = gg[(size_t)r * rs];
      float4 xh, dxh;
#define DMC_GN_BWD_LANE(f)                                  \
  {                                                         \
    xh.f = (xv.f - mean) * inv;                             \
    const float dz = gv.f * silu_grad(fmaf(xh.f, sc.f, bi.f)); \
    db.f += dz;                                             \
    dg.f = fmaf(dz, xh.f, dg.f);                            \
    dxh.f = dz * sc.f;                                      \
    s1 += dxh.f;                                            \
    s2 = fmaf(dxh.f, xh.f, s2);                             \
  }
      DMC_GN_BWD_LANE(x)
      DMC_GN_BWD_LANE(y)
      DMC_GN_BWD_LANE(z)
      DMC_GN_BWD_LANE(w)
#undef DMC_GN_BWD_LANE
      dxh_s[r * col.vr] = dxh;
      if (XS) xh_s[r * col.vr] = xh;
    }
  }
  block_sum2<THREADS>(s1, s2, red);
  const float m1 = s1 / n, m2 = s2 / n;

  if (col.active) {
#pragma unroll 4
    for (int r = col.r0; r < hw; r += col.rows) {
      const float4 dxh = dxh_s[r * col.vr];
      float4 xh;
      if (XS) {
        xh = xh_s[r * col.vr];
      } else {
        const float4 xv = xg[(size_t)r * rs];
        xh.x = (xv.x - mean) * inv;
        xh.y = (xv.y - mean) * inv;
        xh.z = (xv.z - mean) * inv;
        xh.w = (xv.w - mean) * inv;
      }
      float4 o;
      o.x = (dxh.x - m1 - xh.x * m2) * inv;
      o.y = (dxh.y - m1 - xh.y * m2) * inv;
      o.z = (dxh.z - m1 - xh.z * m2) * inv;
      o.w = (dxh.w - m1 - xh.w * m2) * inv;
      dxg[(size_t)r * rs] = o;
    }
  }

  // dbias, dscale of the group's channels for this image: the threads of a
  // column, one per row residue, summed in row order
  if (THREADS == 32) __syncwarp(); else __syncthreads();
  if (col.active) {
    group[2 * threadIdx.x] = db;
    group[2 * threadIdx.x + 1] = dg;
  }
  if (THREADS == 32) __syncwarp(); else __syncthreads();
  const float* sums = reinterpret_cast<const float*>(group);
  for (int t = threadIdx.x; t < 2 * gs; t += THREADS) {
    const int which = t / gs;  // 0: dbias, 1: dscale
    const int ch = t - which * gs;
    const float* p = sums + (ch >> 2) * 8 + which * 4 + (ch & 3);
    float acc = 0.f;
    for (int r = 0; r < col.rows; ++r) acc += p[(size_t)r * col.vr * 8];
    (which ? dscale_rows : dbias_rows)[(size_t)b * c + (size_t)g * gs + ch] =
        acc;
  }
}

// The generic forward: any C / G, any size; the group read three times.
__global__ void __launch_bounds__(kGenericThreads)
gn_silu_fwd_generic_kernel(const float* __restrict__ x,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           float* __restrict__ y, float* __restrict__ mean_out,
                           float* __restrict__ rstd_out, int hw, int c,
                           int groups, float eps) {
  __shared__ float red[66];
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x - b * groups;
  const int gs = c / groups;
  const size_t n = (size_t)hw * gs;
  const size_t base = (size_t)b * hw * c + (size_t)g * gs;
  const float* xg = x + base;
  float* yg = y + base;

  float s = 0.f, unused = 0.f;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t r = i / gs;
    s += xg[r * c + (i - r * gs)];
  }
  block_sum2<0>(s, unused, red);
  const float mean = s / (float)n;

  float ss = 0.f;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t r = i / gs;
    const float d = xg[r * c + (i - r * gs)] - mean;
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
    yg[off] = silu(fmaf(xg[off] - mean, inv * scale[ch], bias[ch]));
  }
}

// The generic backward: the group's two means, then dx, then each channel's
// dbias and dscale by a block sum of its own.
__global__ void __launch_bounds__(kGenericThreads)
gn_silu_bwd_generic_kernel(const float* __restrict__ x,
                           const float* __restrict__ gout,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           const float* __restrict__ mean_in,
                           const float* __restrict__ rstd_in,
                           float* __restrict__ dx,
                           float* __restrict__ dscale_rows,
                           float* __restrict__ dbias_rows, int hw, int c,
                           int groups) {
  __shared__ float red[66];
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x - b * groups;
  const int gs = c / groups;
  const size_t n = (size_t)hw * gs;
  const size_t base = (size_t)b * hw * c + (size_t)g * gs;
  const float* xg = x + base;
  const float* gg = gout + base;
  float* dxg = dx + base;
  const float mean = mean_in[blockIdx.x];
  const float inv = rstd_in[blockIdx.x];

  float s1 = 0.f, s2 = 0.f;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t r = i / gs;
    const int col = (int)(i - r * gs);
    const int ch = g * gs + col;
    const size_t off = r * c + col;
    const float xh = (xg[off] - mean) * inv;
    const float dxh =
        gg[off] * silu_grad(fmaf(xh, scale[ch], bias[ch])) * scale[ch];
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
    const float xh = (xg[off] - mean) * inv;
    const float dxh =
        gg[off] * silu_grad(fmaf(xh, scale[ch], bias[ch])) * scale[ch];
    dxg[off] = (dxh - m1 - xh * m2) * inv;
  }

  for (int col = 0; col < gs; ++col) {
    const int ch = g * gs + col;
    float db = 0.f, dg = 0.f;
    for (int r = threadIdx.x; r < hw; r += blockDim.x) {
      const size_t off = (size_t)r * c + col;
      const float xh = (xg[off] - mean) * inv;
      const float dz = gg[off] * silu_grad(fmaf(xh, scale[ch], bias[ch]));
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

// The vector kernels' shared memory: `copies` of the group, and no less than
// the channel sums of the backward need (32 bytes a thread).
size_t shared_bytes(int hw, int gs, int copies, int threads, bool backward) {
  const size_t data = (size_t)hw * gs * sizeof(float) * copies;
  const size_t sums = backward ? (size_t)threads * 32 : 0;
  return data > sums ? data : sums;
}

// 0: the generic kernels; 1: the group once in shared memory (the forward;
// the backward's dxh); 2: twice (the backward's dxh and xh).
int form_for(int hw, int c, int groups, bool backward) {
  const int gs = c / groups;
  if (gs % 4 != 0 || gs / 4 > 1024) return 0;
  const size_t one = (size_t)hw * gs * sizeof(float);
  if (backward && 2 * one <= kSharedMax) return 2;
  return one <= kSharedMax ? 1 : 0;
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

template <int THREADS>
int launch_fwd(const float* x, const float* scale, const float* bias, float* y,
               float* mean, float* rstd, int batch, int hw, int c, int groups,
               float eps, size_t smem, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const int err = opt_in((const void*)gn_silu_fwd_kernel<THREADS>, done);
  if (err != 0) return err;
  gn_silu_fwd_kernel<THREADS><<<batch * groups, THREADS, smem, stream>>>(
      x, scale, bias, y, mean, rstd, hw, c, groups, eps);
  return (int)cudaGetLastError();
}

template <int THREADS, bool XS>
int launch_bwd(const float* x, const float* g, const float* scale,
               const float* bias, const float* mean, const float* rstd,
               float* dx, float* dscale_rows, float* dbias_rows, int batch,
               int hw, int c, int groups, size_t smem, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const int err = opt_in((const void*)gn_silu_bwd_kernel<THREADS, XS>, done);
  if (err != 0) return err;
  gn_silu_bwd_kernel<THREADS, XS><<<batch * groups, THREADS, smem, stream>>>(
      x, g, scale, bias, mean, rstd, dx, dscale_rows, dbias_rows, hw, c,
      groups);
  return (int)cudaGetLastError();
}

}  // namespace

// The form the kernels take for this shape (`form_for`) times 10000, plus
// the block size of the vector kernels (the table's choice).
extern "C" int gn_silu_form(int hw, int c, int groups, int backward) {
  if (groups < 1 || c % groups != 0) return 0;
  const int form = form_for(hw, c, groups, backward != 0);
  if (form == 0) return kGenericThreads;
  const int gs = c / groups;
  return form * 10000 + threads_for((size_t)hw * gs / 4, gs / 4);
}

// x, y: (batch, hw, c) float32, contiguous; scale, bias: (c,) float32; mean,
// rstd: (batch, groups), written. Returns the CUDA error of the launch (0 on
// success).
extern "C" int gn_silu_fwd(const void* x, const void* scale, const void* bias,
                           void* y, void* mean, void* rstd, int batch, int hw,
                           int c, int groups, float eps, void* stream) {
  if (groups < 1 || c % groups != 0) return (int)cudaErrorInvalidValue;
  const int gs = c / groups;
  const bool vec = form_for(hw, c, groups, false) != 0 && aligned16(x) &&
                   aligned16(y) && aligned16(scale) && aligned16(bias);
  if (!vec) {
    gn_silu_fwd_generic_kernel<<<batch * groups, kGenericThreads, 0,
                                 (cudaStream_t)stream>>>(
        (const float*)x, (const float*)scale, (const float*)bias, (float*)y,
        (float*)mean, (float*)rstd, hw, c, groups, eps);
    return (int)cudaGetLastError();
  }
  const int threads = threads_for((size_t)hw * gs / 4, gs / 4);
  const size_t smem = shared_bytes(hw, gs, 1, threads, false);
  auto f = threads == 32    ? &launch_fwd<32>
           : threads == 128 ? &launch_fwd<128>
           : threads == 256 ? &launch_fwd<256>
           : threads == 512 ? &launch_fwd<512>
                            : &launch_fwd<1024>;
  return f((const float*)x, (const float*)scale, (const float*)bias, (float*)y,
           (float*)mean, (float*)rstd, batch, hw, c, groups, eps, smem,
           (cudaStream_t)stream);
}

// x, g (the gradient of y), dx: (batch, hw, c); scale, bias: (c,); mean, rstd:
// (batch, groups) from the forward; dscale_rows, dbias_rows: (batch, c),
// written: each image's sums, for the caller to add over the batch. All
// float32, contiguous.
extern "C" int gn_silu_bwd(const void* x, const void* g, const void* scale,
                           const void* bias, const void* mean, const void* rstd,
                           void* dx, void* dscale_rows, void* dbias_rows,
                           int batch, int hw, int c, int groups, void* stream) {
  if (groups < 1 || c % groups != 0) return (int)cudaErrorInvalidValue;
  const int gs = c / groups;
  int form = form_for(hw, c, groups, true);
  if (!(aligned16(x) && aligned16(g) && aligned16(dx) && aligned16(scale) &&
        aligned16(bias)))
    form = 0;
  if (form == 0) {
    gn_silu_bwd_generic_kernel<<<batch * groups, kGenericThreads, 0,
                                 (cudaStream_t)stream>>>(
        (const float*)x, (const float*)g, (const float*)scale,
        (const float*)bias, (const float*)mean, (const float*)rstd, (float*)dx,
        (float*)dscale_rows, (float*)dbias_rows, hw, c, groups);
    return (int)cudaGetLastError();
  }
  const int threads = threads_for((size_t)hw * gs / 4, gs / 4);
  const size_t smem = shared_bytes(hw, gs, form, threads, true);
  if (smem > kSharedMax) return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const float*, const float*, const float*, const float*,
                         const float*, const float*, float*, float*, float*,
                         int, int, int, int, size_t, cudaStream_t);
  Launch f;
  if (form == 2) {
    f = threads == 32    ? &launch_bwd<32, true>
        : threads == 128 ? &launch_bwd<128, true>
        : threads == 256 ? &launch_bwd<256, true>
        : threads == 512 ? &launch_bwd<512, true>
                         : &launch_bwd<1024, true>;
  } else {
    f = threads == 32    ? &launch_bwd<32, false>
        : threads == 128 ? &launch_bwd<128, false>
        : threads == 256 ? &launch_bwd<256, false>
        : threads == 512 ? &launch_bwd<512, false>
                         : &launch_bwd<1024, false>;
  }
  return f((const float*)x, (const float*)g, (const float*)scale,
           (const float*)bias, (const float*)mean, (const float*)rstd,
           (float*)dx, (float*)dscale_rows, (float*)dbias_rows, batch, hw, c,
           groups, smem, (cudaStream_t)stream);
}
