// RMSNorm forward: out = cast(x * rsqrt(mean(x^2) + eps) * w), statistics
// and products in fp32; with `gemma` the scale is (1 + w), also in fp32.
//
// Replaces the TPU kernel unsloth_tpu/ops/rms_norm.py:_fwd_kernel
// (launched by _rms_norm_fwd_pallas). Same formula as that kernel and as
// rms_norm_ref: var = mean(x_f32^2), xhat = x_f32 * rsqrt(var + eps),
// out = cast(xhat * w_f32) or cast(xhat * (1 + w_f32)).
//
// What bounds it on an H100: device-memory bytes. It reads each row once
// for the sum of squares and once more (mostly from L1/L2) for the output,
// and writes it once; at D = 4096 there are 2 FLOPs per byte.
// Design: one block of 256 threads per row, a strided loop over D, a
// warp-shuffle reduction and then one across the eight warps in shared
// memory. Rows are independent, so the grid is simply the row count.

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

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rms_norm_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out,
                int D, float eps, int gemma) {
  __shared__ float partial[kThreads / 32];
  const size_t row = blockIdx.x;
  const TX* xr = x + row * D;
  TX* outr = out + row * D;

  float ss = 0.0f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? partial[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) partial[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(partial[0] / static_cast<float>(D) + eps);

  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float xhat = to_f32(xr[i]) * inv;
    const float scale = gemma ? 1.0f + to_f32(w[i]) : to_f32(w[i]);
    outr[i] = from_f32<TX>(xhat * scale);
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* out, int rows, int D, float eps, int gemma,
            cudaStream_t s) {
  rms_norm_kernel<TX, TW><<<rows, kThreads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out), D, eps,
      gemma);
}

}  // namespace

// RMSNorm over the last axis of x [rows, D] on `stream`. dtype codes:
// 0 = float32, 1 = bfloat16, for x (and out) and for w separately.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an unknown dtype code); allocates nothing.
extern "C" int unsloth_rms_norm(const void* x, const void* w, void* out, int rows, int D,
                                float eps, int gemma, int x_dtype, int w_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && w_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, D, eps, gemma, s);
  } else if (x_dtype == 1 && w_dtype == 0) {
    launch<__nv_bfloat16, float>(x, w, out, rows, D, eps, gemma, s);
  } else if (x_dtype == 0 && w_dtype == 0) {
    launch<float, float>(x, w, out, rows, D, eps, gemma, s);
  } else if (x_dtype == 0 && w_dtype == 1) {
    launch<float, __nv_bfloat16>(x, w, out, rows, D, eps, gemma, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
