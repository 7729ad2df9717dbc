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
//
// The backward (K4) below instantiates norm_common.cuh's.

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
// Backward (K4). Replaces unsloth_tpu/ops/rms_norm.py:_bwd_kernel (launched
// by _rms_norm_bwd_pallas); the design, what bounds it and the two forms
// are at the top of norm_common.cuh. C: the 16-byte chunks a lane of the
// row form holds (2 or 4), 0 for the strided form; kDw: dW beside dx
// (the strided form reads it from the arguments).
// ---------------------------------------------------------------------------

template <typename TX, typename TW, int C, bool kDw>
__global__ void __launch_bounds__(kThreads, 2) rms_norm_bwd_kernel(const NormBwdArgs p) {
  if constexpr (C == 0)
    norm_bwd_strided<false, TX, TW>(p);
  else
    norm_bwd_vec<false, TX, TW, C, kDw>(p);
}

// The instantiation of the form (chunks, dW or not) for x and w of TX
// and TW; null where the lane budget leaves it out.
template <typename TX, typename TW>
NormBwdKernel bwd_kernel(int chunks, bool dw) {
  if (chunks == 0) return rms_norm_bwd_kernel<TX, TW, 0, false>;
  if (chunks == 2)
    return dw ? rms_norm_bwd_kernel<TX, TW, 2, true>
              : rms_norm_bwd_kernel<TX, TW, 2, false>;
  if constexpr (norm_lane_fits<TX>(4, 1))
    if (chunks == 4)
      return dw ? rms_norm_bwd_kernel<TX, TW, 4, true> : rms_norm_bwd_kernel<TX, TW, 4, false>;
  return nullptr;
}

// bwd_kernel by dtype codes (0 float32, 1 bfloat16; null for others).
NormBwdKernel pick_bwd(int x_dtype, int w_dtype, int chunks, bool dw) {
  if (x_dtype == 1 && w_dtype == 1)
    return bwd_kernel<__nv_bfloat16, __nv_bfloat16>(chunks, dw);
  if (x_dtype == 1 && w_dtype == 0) return bwd_kernel<__nv_bfloat16, float>(chunks, dw);
  if (x_dtype == 0 && w_dtype == 0) return bwd_kernel<float, float>(chunks, dw);
  if (x_dtype == 0 && w_dtype == 1) return bwd_kernel<float, __nv_bfloat16>(chunks, dw);
  return nullptr;
}

}  // namespace

// RMSNorm backward on `stream`: dx [rows, D] in x's dtype from x, g
// [rows, D] (g in x's dtype) and w [D]; with dw ([D] in w's dtype) also
// dW, summed in fp32 through `partials` (fp32 scratch of (blocks +
// ceil(blocks / group_blocks)) * round4(D) floats) and `arrivals`
// (ceil(blocks / group_blocks) + 1 int32 counters, zero before the first
// launch; the kernel leaves them zero), rounded once. chunks,
// warps_per_row, blocks and group_blocks are ops/rms_norm.py:
// norm_bwd_form's. dtype codes as for unsloth_rms_norm. Returns the
// launch's CUDA error (cudaErrorInvalidValue for arguments the kernels do
// not take).
extern "C" int unsloth_rms_norm_bwd(const void* x, const void* w, const void* g, void* dx,
                                    void* dw, void* partials, void* arrivals, int rows, int D,
                                    int chunks, int warps_per_row, int blocks, int group_blocks,
                                    float eps, int gemma, int x_dtype, int w_dtype,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const NormBwdArgs a{x, w, g, dx, dw, nullptr, static_cast<float*>(partials),
                      static_cast<int*>(arrivals), rows, D, warps_per_row, group_blocks, eps,
                      gemma};
  const bool ok = x_dtype == 1 ? norm_bwd_args_ok<__nv_bfloat16>(a, chunks, blocks, 1)
                               : norm_bwd_args_ok<float>(a, chunks, blocks, 1);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return launch_norm_bwd(pick_bwd(x_dtype, w_dtype, chunks, dw != nullptr), blocks,
                         norm_bwd_smem(dw != nullptr, chunks, D, warps_per_row, 1), s, a);
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

// The blocks of the backward form (chunks, warps_per_row, dW or not) an SM
// holds at width D (ops/rms_norm.py sizes the grid by it), or a negative
// CUDA error. dtype codes as for unsloth_rms_norm.
extern "C" int unsloth_rms_norm_bwd_blocks_per_sm(int chunks, int warps_per_row, int dw,
                                                  int D, int x_dtype, int w_dtype) {
  return norm_bwd_blocks_per_sm(pick_bwd(x_dtype, w_dtype, chunks, dw != 0),
                                norm_bwd_smem(dw != 0, chunks, D, warps_per_row, 1));
}
