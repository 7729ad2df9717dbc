// LayerNorm forward: out = cast(xhat * w + b), xhat = (x - mean) * rsqrt(var
// + eps), statistics and products in fp32, one rounding to x's dtype at the
// end; b may be absent (zeros).
//
// Replaces the TPU kernel unsloth_tpu/ops/rms_norm.py:_ln_fwd_kernel
// (launched by _ln_fwd_pallas). Same two-pass formula as that kernel and as
// layer_norm_ref: mean = mean(x_f32), var = mean((x_f32 - mean)^2).
//
// What bounds it on an H100: device-memory bytes. It reads each row once
// from device memory (the second and third passes over a row hit L1/L2)
// and writes it once; a handful of FLOPs per element.
// Design: as the RMSNorm kernel beside it (rms_norm.cu), one block of 256
// threads per row, a strided loop over D, a warp-shuffle reduction and then
// one across the eight warps in shared memory, three passes over the row
// (sum, centred sum of squares, output). Rows are independent, so the grid
// is simply the row count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "norm_common.cuh"

namespace {

// (mean, rsqrt(var + eps)) of one row, by the two-pass formula.
template <typename TX>
__device__ __forceinline__ float2 row_stats(const TX* __restrict__ xr, int D, float eps,
                                            float* red) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < D; i += kThreads) s += to_f32(xr[i]);
  const float mean = block_sum(s, red) / static_cast<float>(D);
  float v = 0.0f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float d = to_f32(xr[i]) - mean;
    v += d * d;
  }
  const float var = block_sum(v, red) / static_cast<float>(D);
  return make_float2(mean, rsqrtf(var + eps));
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const TX* __restrict__ x, const TW* __restrict__ w, const TW* __restrict__ b,
                  TX* __restrict__ out, int D, float eps) {
  __shared__ float red[kThreads / 32];
  const size_t row = blockIdx.x;
  const TX* xr = x + row * D;
  TX* outr = out + row * D;
  const float2 st = row_stats(xr, D, eps, red);
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float xhat = (to_f32(xr[i]) - st.x) * st.y;
    const float bias = b != nullptr ? to_f32(b[i]) : 0.0f;
    outr[i] = from_f32<TX>(xhat * to_f32(w[i]) + bias);
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, const void* b, void* out, int rows, int D, float eps,
           cudaStream_t s) {
  layer_norm_kernel<TX, TW><<<rows, kThreads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<const TW*>(b),
      static_cast<TX*>(out), D, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward. Replaces unsloth_tpu/ops/rms_norm.py:_ln_bwd_kernel (launched by
// _ln_bwd_pallas). All in fp32, with the statistics recomputed as above:
//   xhat = (x - mean) * inv, dxhat = g * w,
//   dx   = inv * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))  (x's dtype)
//   dW   = sum over rows of g * xhat,  dB = sum over rows of g      (fp32)
// dW and dB are reductions across every row. The TPU kernel carried them
// across its sequential grid; here blocks run in parallel, so each block
// sums its own rows into one fp32 partial row of each (kept in shared
// memory, each thread owning the columns it walks) and column_sum_kernel
// (norm_common.cuh) adds the partials up column by column. No atomics, so
// dW and dB are the same on every run. Both are computed whether or not the weights are
// trained, as the TPU kernel computes them.
// Bounded by device-memory bytes: x and g are read once from device memory
// (the later passes over a row hit L1/L2) and dx written once.
// ---------------------------------------------------------------------------

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                      const TX* __restrict__ g, TX* __restrict__ dx,
                      float* __restrict__ dw_partial, float* __restrict__ db_partial, int rows,
                      int D, int rows_per_block, float eps) {
  extern __shared__ float acc[];  // [2 * D]: dW's columns, then dB's
  float* dw_acc = acc;
  float* db_acc = acc + D;
  __shared__ float red[kThreads / 32];
  for (int i = threadIdx.x; i < D; i += kThreads) {
    dw_acc[i] = 0.0f;
    db_acc[i] = 0.0f;
  }
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    const TX* xr = x + (size_t)r * D;
    const TX* gr = g + (size_t)r * D;
    const float2 st = row_stats(xr, D, eps, red);
    float s1 = 0.0f, s2 = 0.0f;
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float dxhat = to_f32(gr[i]) * to_f32(w[i]);
      s1 += dxhat;
      s2 += dxhat * ((to_f32(xr[i]) - st.x) * st.y);
    }
    const float m1 = block_sum(s1, red) / static_cast<float>(D);
    const float m2 = block_sum(s2, red) / static_cast<float>(D);
    TX* dxr = dx + (size_t)r * D;
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float gv = to_f32(gr[i]);
      const float xhat = (to_f32(xr[i]) - st.x) * st.y;
      dxr[i] = from_f32<TX>(st.y * (gv * to_f32(w[i]) - m1 - xhat * m2));
      dw_acc[i] += gv * xhat;
      db_acc[i] += gv;
    }
  }
  float* dw_out = dw_partial + (size_t)blockIdx.x * D;
  float* db_out = db_partial + (size_t)blockIdx.x * D;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    dw_out[i] = dw_acc[i];
    db_out[i] = db_acc[i];
  }
}

template <typename TX, typename TW>
int launch_bwd(const void* x, const void* w, const void* g, void* dx, void* dw_partial,
               void* db_partial, void* dw, void* db, int rows, int D, int n_partial, float eps,
               cudaStream_t s) {
  const int rows_per_block = (rows + n_partial - 1) / n_partial;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = 2 * static_cast<size_t>(D) * sizeof(float);
  return launch_with_column_sum(
      layer_norm_bwd_kernel<TX, TW>, blocks, smem, s, static_cast<const float*>(dw_partial),
      static_cast<float*>(dw), static_cast<const float*>(db_partial), static_cast<float*>(db),
      D, static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<const TX*>(g),
      static_cast<TX*>(dx), static_cast<float*>(dw_partial), static_cast<float*>(db_partial),
      rows, D, rows_per_block, eps);
}

}  // namespace

// LayerNorm over the last axis of x [rows, D] on `stream`, with weight w [D]
// and bias b [D] (null for none; b has w's dtype). dtype codes: 0 = float32,
// 1 = bfloat16, for x (and out) and for w separately. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an unknown
// dtype code); allocates nothing.
extern "C" int unsloth_layer_norm(const void* x, const void* w, const void* b, void* out,
                                  int rows, int D, float eps, int x_dtype, int w_dtype,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, b, out, rows, D, eps, s);
  if (x_dtype == 1 && w_dtype == 0) return launch<__nv_bfloat16, float>(x, w, b, out, rows, D, eps, s);
  if (x_dtype == 0 && w_dtype == 0) return launch<float, float>(x, w, b, out, rows, D, eps, s);
  if (x_dtype == 0 && w_dtype == 1) return launch<float, __nv_bfloat16>(x, w, b, out, rows, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// LayerNorm backward on `stream`: dx [rows, D] in x's dtype, and dw, db [D]
// fp32, from x, g [rows, D] (g in x's dtype) and w [D]. dw_partial and
// db_partial are fp32 scratch of at least n_partial * D floats each (the
// wrapper allocates them); n_partial bounds the number of row blocks.
// dtype codes as for unsloth_layer_norm. Returns the first CUDA error of
// the two launches (0 if none).
extern "C" int unsloth_layer_norm_bwd(const void* x, const void* w, const void* g, void* dx,
                                      void* dw_partial, void* db_partial, void* dw, void* db,
                                      int rows, int D, int n_partial, float eps, int x_dtype,
                                      int w_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, w, g, dx, dw_partial, db_partial, dw, db,
                                                    rows, D, n_partial, eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_bwd<__nv_bfloat16, float>(x, w, g, dx, dw_partial, db_partial, dw, db, rows, D,
                                            n_partial, eps, s);
  if (x_dtype == 0 && w_dtype == 0)
    return launch_bwd<float, float>(x, w, g, dx, dw_partial, db_partial, dw, db, rows, D,
                                    n_partial, eps, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_bwd<float, __nv_bfloat16>(x, w, g, dx, dw_partial, db_partial, dw, db, rows, D,
                                            n_partial, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
