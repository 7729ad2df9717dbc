// What the row-norm kernels share (rms_norm.cu, K3/K4; layer_norm.cu,
// K5/K6): one block of kThreads threads a row, fp32 conversions of the
// element types, a block-wide sum, and the backward's deterministic weight
// gradient. The backward's row blocks each leave one fp32 partial row of
// each weight gradient; column_sum_kernel adds those partials up column by
// column in a fixed order, so the result is the same on every run and no
// atomics are needed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The sum of v over the block, returned to every thread. `red` holds one
// float per warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  __syncthreads();  // `red` may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < kThreads / 32 ? red[lane] : 0.0f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
  return t;
}

// out_a[i] = sum over p < n_partial of a[p * D + i], in fp32 and in order
// of p; the same for b into out_b where b is not null.
__global__ void __launch_bounds__(kThreads)
column_sum_kernel(const float* __restrict__ a, float* __restrict__ out_a,
                  const float* __restrict__ b, float* __restrict__ out_b, int n_partial, int D) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= D) return;
  float sa = 0.0f, sb = 0.0f;
  for (int p = 0; p < n_partial; ++p) {
    sa += a[(size_t)p * D + i];
    if (b != nullptr) sb += b[(size_t)p * D + i];
  }
  out_a[i] = sa;
  if (b != nullptr) out_b[i] = sb;
}

// Launches a backward kernel `kernel` on `blocks` row blocks with `smem`
// bytes of dynamic shared memory (opting in past the default 48 KB), then
// column_sum_kernel over its partial rows. Returns the first CUDA error
// (0 if none).
template <typename Kernel, typename... Args>
int launch_with_column_sum(Kernel kernel, int blocks, size_t smem, cudaStream_t s,
                           const float* a, float* out_a, const float* b, float* out_b, int D,
                           Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, kThreads, smem, s>>>(args...);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  column_sum_kernel<<<(D + kThreads - 1) / kThreads, kThreads, 0, s>>>(a, out_a, b, out_b,
                                                                      blocks, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
