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

#include "norm_common.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// Backward. Replaces unsloth_tpu/ops/rms_norm.py:_bwd_kernel (launched by
// _rms_norm_bwd_pallas). With s = w (or 1 + w for Gemma), all in fp32:
//   inv = rsqrt(mean(x^2) + eps), xhat = x * inv, wg = g * s,
//   dx  = inv * (wg - xhat * mean(wg * xhat))          (cast to x's dtype)
//   dW  = sum over rows of g * xhat                      (fp32)
// dW is a reduction across every row. The TPU kernel carried it across
// its sequential grid; here blocks run in parallel, so each block sums its
// own rows into one fp32 partial row (kept in shared memory, each thread
// owning the columns it walks) and column_sum_kernel (norm_common.cuh)
// adds the partials up column by column. No atomics, so dW is the same on
// every run.
// Bounded by device-memory bytes: x and g are read once from device
// memory (the three passes over a row hit L1/L2) and dx written once.
// ---------------------------------------------------------------------------

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w, const TX* __restrict__ g,
                    TX* __restrict__ dx, float* __restrict__ dw_partial, int rows, int D,
                    int rows_per_block, float eps, int gemma) {
  extern __shared__ float dw_acc[];  // [D]
  __shared__ float red[kThreads / 32];
  for (int i = threadIdx.x; i < D; i += kThreads) dw_acc[i] = 0.0f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    const TX* xr = x + (size_t)r * D;
    const TX* gr = g + (size_t)r * D;
    float ss = 0.0f;
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float v = to_f32(xr[i]);
      ss += v * v;
    }
    const float inv = rsqrtf(block_sum(ss, red) / static_cast<float>(D) + eps);
    float dot = 0.0f;
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float s = gemma ? 1.0f + to_f32(w[i]) : to_f32(w[i]);
      dot += to_f32(gr[i]) * s * (to_f32(xr[i]) * inv);
    }
    const float mean_term = block_sum(dot, red) / static_cast<float>(D);
    TX* dxr = dx + (size_t)r * D;
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float s = gemma ? 1.0f + to_f32(w[i]) : to_f32(w[i]);
      const float gv = to_f32(gr[i]);
      const float xhat = to_f32(xr[i]) * inv;
      dxr[i] = from_f32<TX>(inv * (gv * s - xhat * mean_term));
      dw_acc[i] += gv * xhat;
    }
  }
  float* out = dw_partial + (size_t)blockIdx.x * D;
  for (int i = threadIdx.x; i < D; i += kThreads) out[i] = dw_acc[i];
}

template <typename TX, typename TW>
int launch_bwd(const void* x, const void* w, const void* g, void* dx, void* dw_partial, void* dw,
               int rows, int D, int n_partial, float eps, int gemma, cudaStream_t s) {
  const int rows_per_block = (rows + n_partial - 1) / n_partial;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  return launch_with_column_sum(
      rms_norm_bwd_kernel<TX, TW>, blocks, smem, s, static_cast<const float*>(dw_partial),
      static_cast<float*>(dw), static_cast<const float*>(nullptr), static_cast<float*>(nullptr),
      D, static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<const TX*>(g),
      static_cast<TX*>(dx), static_cast<float*>(dw_partial), rows, D, rows_per_block, eps,
      gemma);
}

}  // namespace

// RMSNorm backward on `stream`: dx [rows, D] in x's dtype and dw [D] fp32
// from x, g [rows, D] and w [D]. dw_partial is fp32 scratch of at least
// n_partial * D floats (the wrapper allocates it); n_partial bounds the
// number of row blocks. dtype codes as for unsloth_rms_norm; g has x's
// dtype. Returns the first CUDA error of the two launches (0 if none).
extern "C" int unsloth_rms_norm_bwd(const void* x, const void* w, const void* g, void* dx,
                                    void* dw_partial, void* dw, int rows, int D, int n_partial,
                                    float eps, int gemma, int x_dtype, int w_dtype,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, w, g, dx, dw_partial, dw, rows, D,
                                                    n_partial, eps, gemma, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_bwd<__nv_bfloat16, float>(x, w, g, dx, dw_partial, dw, rows, D, n_partial,
                                            eps, gemma, s);
  if (x_dtype == 0 && w_dtype == 0)
    return launch_bwd<float, float>(x, w, g, dx, dw_partial, dw, rows, D, n_partial, eps,
                                    gemma, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_bwd<float, __nv_bfloat16>(x, w, g, dx, dw_partial, dw, rows, D, n_partial,
                                            eps, gemma, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
