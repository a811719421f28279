// GroupNorm + SiLU forward on (B, HW, C) float32 activations (NHWC images
// flattened over H and W), with per-channel affine scale and bias.
//
// Replaces diffusion_models_collection_tpu/ops/fused_norm.py:_gn_silu_kernel.
//
// What bounds it on an H100: device-memory bandwidth. The op does a handful
// of flops per element, so the least it can cost is one read and one write
// of x. Design: one block per (image, group). The group's HW * (C / G)
// elements are read three times (sum, centred sum of squares, normalise and
// write); the group is at most a few hundred KB, so the second and third
// reads mostly hit L2 and device memory sees about one read and one write.
// Statistics are float32, two passes (mean first, then the centred sum of
// squares) instead of the TPU kernel's E[x^2] - mean^2, which cancels badly
// when |mean| >> std. Any C divisible by the group count and any HW >= 1
// are taken; there is no alignment requirement.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// Sum of `v` over the block; every thread gets the result. `red` holds
// at least 33 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // every thread has read the previous call's red[32]
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

__global__ void __launch_bounds__(kThreads)
gn_silu_fwd_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, float* __restrict__ y, int hw,
                   int c, int groups, float eps) {
  __shared__ float red[33];
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x - b * groups;
  const int gs = c / groups;
  const int n = hw * gs;
  const size_t base = (size_t)b * hw * c + (size_t)g * gs;
  const float* xg = x + base;
  float* yg = y + base;

  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / gs;
    s += xg[(size_t)r * c + (i - r * gs)];
  }
  const float mean = block_sum(s, red) / (float)n;

  float ss = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / gs;
    const float d = xg[(size_t)r * c + (i - r * gs)] - mean;
    ss = fmaf(d, d, ss);
  }
  const float var = block_sum(ss, red) / (float)n;
  const float inv = 1.f / sqrtf(var + eps);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / gs;
    const int col = i - r * gs;
    const int ch = g * gs + col;
    const size_t off = (size_t)r * c + col;
    const float v = (xg[off] - mean) * inv * scale[ch] + bias[ch];
    yg[off] = v / (1.f + expf(-v));
  }
}

}  // namespace

// x, y: (batch, hw, c) float32, contiguous; scale, bias: (c,) float32.
// Returns the CUDA error of the launch (0 on success).
extern "C" int gn_silu_fwd(const void* x, const void* scale, const void* bias,
                           void* y, int batch, int hw, int c, int groups,
                           float eps, void* stream) {
  gn_silu_fwd_kernel<<<batch * groups, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)scale, (const float*)bias, (float*)y, hw, c,
      groups, eps);
  return (int)cudaGetLastError();
}
