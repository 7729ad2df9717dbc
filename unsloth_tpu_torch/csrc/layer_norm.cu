// LayerNorm forward: out = cast(xhat * w + b), xhat = (x - mean) * rsqrt(var
// + eps), statistics and products in fp32, one rounding to x's dtype at the
// end; b may be absent (zeros).
//
// Replaces the TPU kernel unsloth_tpu/ops/rms_norm.py:_ln_fwd_kernel
// (launched by _ln_fwd_pallas). Same two-pass formula as that kernel and as
// layer_norm_ref: mean = mean(x_f32), var = mean((x_f32 - mean)^2).
//
// What bounds it on an H100: device-memory bytes, each row read once and
// written once; a handful of FLOPs per element. Two forms:
//   * layer_norm_warp_kernel, for D a multiple of the 16-byte chunk (8 bf16
//     or 4 fp32 elements) with at most 16 chunks a lane (bf16 D <= 4,096,
//     fp32 D <= 2,048) and 16-byte aligned tensors: one warp a row, eight
//     rows a 256-thread block (two rows a block below eight rows an SM:
//     [448, 1280] then spreads over 132 SMs, not 56). Each lane loads its
//     chunks (lane, lane + 32, ...) once, 16 bytes at a time, and keeps
//     them in registers (instantiated for 4, 8, 12 and 16 chunks a lane:
//     the fewest registers that hold them); both sums are the lane's
//     elements in order, then a warp shuffle tree, so no shared memory and
//     no block barrier; w and b are read in the same chunks, the output
//     written in 16-byte chunks. At Whisper's D = 1,280 a 256-thread block
//     a row had five elements a thread, loaded two bytes at a time, and
//     four block barriers.
//   * layer_norm_kernel, every other row: as the RMSNorm kernel beside it
//     (rms_norm.cu), one block of 256 threads per row, a strided loop over
//     D, a warp-shuffle reduction and then one across the eight warps in
//     shared memory, three passes over the row (sum, centred sum of
//     squares, output; the later passes hit L1/L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int kRowsPerBlock = kThreads / 32;  // the warp form: one warp a row

// The sum of v over the warp, returned to every lane (a shuffle tree).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// E elements of T from `p` (8, 16 or 32 bytes, as aligned) as fp32.
template <typename T, int E>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&f)[E]) {
  constexpr int kBytes = E * static_cast<int>(sizeof(T));
  static_assert(kBytes == 8 || kBytes == 16 || kBytes == 32, "vector width");
  uint32_t raw[kBytes / 4];
  if constexpr (kBytes == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    raw[0] = v.x;
    raw[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      raw[4 * i] = v.x;
      raw[4 * i + 1] = v.y;
      raw[4 * i + 2] = v.z;
      raw[4 * i + 3] = v.w;
    }
  }
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) f[i] = __uint_as_float(raw[i]);
  }
}

// The 16 bytes of a chunk of T as fp32 (E = 16 / sizeof(T) values).
template <typename T, int E>
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[E]) {
  const uint32_t raw[4] = {v.x, v.y, v.z, v.w};
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(raw[i]);
  }
}

// E fp32 values rounded once to T, as one 16-byte chunk.
template <typename T, int E>
__device__ __forceinline__ uint4 pack(const float (&f)[E]) {
  uint32_t raw[4];
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      raw[i] = *reinterpret_cast<const uint32_t*>(&t);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) raw[i] = __float_as_uint(f[i]);
  }
  return make_uint4(raw[0], raw[1], raw[2], raw[3]);
}

// One warp a row (rows blockIdx.x * warps + warp); lane l holds the row's
// 16-byte chunks l, l + 32, ... (at most kMaxChunks) in registers. The sums
// run over a lane's elements in chunk order, then the shuffle tree.
template <typename TX, typename TW, int kMaxChunks>
__global__ void __launch_bounds__(kThreads)
layer_norm_warp_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                       const TW* __restrict__ b, TX* __restrict__ out, int rows, int D,
                       float eps) {
  constexpr int E = 16 / static_cast<int>(sizeof(TX));  // elements of a chunk
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;  // a whole warp
  const int chunks = D / E;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
  uint4 v[kMaxChunks];
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i)
    if (lane + 32 * i < chunks) v[i] = xr[lane + 32 * i];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    if (lane + 32 * i >= chunks) continue;
    float f[E];
    unpack<TX, E>(v[i], f);
#pragma unroll
    for (int e = 0; e < E; ++e) s += f[e];
  }
  const float mean = warp_sum(s) / static_cast<float>(D);
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    if (lane + 32 * i >= chunks) continue;
    float f[E];
    unpack<TX, E>(v[i], f);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float d = f[e] - mean;
      q += d * d;
    }
  }
  const float inv = rsqrtf(warp_sum(q) / static_cast<float>(D) + eps);
  uint4* outr = reinterpret_cast<uint4*>(out + (size_t)row * D);
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int ch = lane + 32 * i;
    if (ch >= chunks) continue;
    float f[E], wf[E], bf[E];
    unpack<TX, E>(v[i], f);
    load_f32<TW, E>(w + ch * E, wf);
    if (b != nullptr) {
      load_f32<TW, E>(b + ch * E, bf);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) bf[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = (f[e] - mean) * inv * wf[e] + bf[e];
    outr[ch] = pack<TX, E>(f);
  }
}

// The forward on `rows` rows: the warp form where it takes D and the
// pointers, else layer_norm_kernel.
template <typename TX, typename TW>
int launch_fwd(const void* x, const void* w, const void* b, void* out, int rows, int D, float eps,
               cudaStream_t s) {
  constexpr int E = 16 / static_cast<int>(sizeof(TX));
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(out);
  const int per_lane = (D / E + 31) / 32;
  if (ptrs % 16 != 0 || D % E != 0 || per_lane > 16)
    return launch<TX, TW>(x, w, b, out, rows, D, eps, s);
  // eight rows a block, or two where eight leave SMs without a block
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms < 1)
      sms = 132;
  }
  const int per_block = rows < kRowsPerBlock * sms ? 2 : kRowsPerBlock;
  const int blocks = (rows + per_block - 1) / per_block;
  const int threads = 32 * per_block;
  const auto* xp = static_cast<const TX*>(x);
  const auto* wp = static_cast<const TW*>(w);
  const auto* bp = static_cast<const TW*>(b);
  auto* op = static_cast<TX*>(out);
  // the fewest registers that hold a lane's chunks (occupancy)
  if (per_lane <= 4)
    layer_norm_warp_kernel<TX, TW, 4><<<blocks, threads, 0, s>>>(xp, wp, bp, op, rows, D, eps);
  else if (per_lane <= 8)
    layer_norm_warp_kernel<TX, TW, 8><<<blocks, threads, 0, s>>>(xp, wp, bp, op, rows, D, eps);
  else if (per_lane <= 12)
    layer_norm_warp_kernel<TX, TW, 12><<<blocks, threads, 0, s>>>(xp, wp, bp, op, rows, D, eps);
  else
    layer_norm_warp_kernel<TX, TW, 16><<<blocks, threads, 0, s>>>(xp, wp, bp, op, rows, D, eps);
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
// and bias b [D] (null for none; b has w's dtype); the warp form or the
// block form as launch_fwd picks. dtype codes: 0 = float32,
// 1 = bfloat16, for x (and out) and for w separately. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an unknown
// dtype code); allocates nothing.
extern "C" int unsloth_layer_norm(const void* x, const void* w, const void* b, void* out,
                                  int rows, int D, float eps, int x_dtype, int w_dtype,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, w, b, out, rows, D, eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_fwd<__nv_bfloat16, float>(x, w, b, out, rows, D, eps, s);
  if (x_dtype == 0 && w_dtype == 0) return launch_fwd<float, float>(x, w, b, out, rows, D, eps, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_fwd<float, __nv_bfloat16>(x, w, b, out, rows, D, eps, s);
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
