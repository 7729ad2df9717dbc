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
//
// The backward (K6) below instantiates norm_common.cuh's.

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
// Backward (K6). Replaces unsloth_tpu/ops/rms_norm.py:_ln_bwd_kernel
// (launched by _ln_bwd_pallas); the design, what bounds it and the two
// forms are at the top of norm_common.cuh. C: the 16-byte chunks a lane
// of the row form holds (2 or 4), 0 for the strided form; kDw: dW and
// dB beside dx (the strided form reads it from the arguments).
// ---------------------------------------------------------------------------

template <typename TX, typename TW, int C, bool kDw>
__global__ void __launch_bounds__(kThreads, 2) layer_norm_bwd_kernel(const NormBwdArgs p) {
  if constexpr (C == 0)
    norm_bwd_strided<true, TX, TW>(p);
  else
    norm_bwd_vec<true, TX, TW, C, kDw>(p);
}

// The instantiation of the form (chunks, dW or not) for x and w of TX
// and TW; null where the lane budget leaves it out.
template <typename TX, typename TW>
NormBwdKernel bwd_kernel(int chunks, bool dw) {
  if (chunks == 0) return layer_norm_bwd_kernel<TX, TW, 0, false>;
  if (chunks == 2)
    return dw ? layer_norm_bwd_kernel<TX, TW, 2, true>
              : layer_norm_bwd_kernel<TX, TW, 2, false>;
  if constexpr (norm_lane_fits<TX>(4, 2))
    if (chunks == 4)
      return dw ? layer_norm_bwd_kernel<TX, TW, 4, true> : layer_norm_bwd_kernel<TX, TW, 4, false>;
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

// LayerNorm backward on `stream`: dx [rows, D] in x's dtype from x, g
// [rows, D] (g in x's dtype) and w [D]; with dw and db (fp32 [D], both or
// neither) also dW and dB, summed through `partials` (fp32 scratch of
// (blocks + ceil(blocks / group_blocks)) * 2 * round4(D) floats) and
// `arrivals` (ceil(blocks / group_blocks) + 1 int32 counters, zero before
// the first launch; the kernel leaves them zero). chunks, warps_per_row,
// blocks and group_blocks are ops/rms_norm.py:norm_bwd_form's. dtype codes
// as for unsloth_layer_norm. Returns the launch's CUDA error
// (cudaErrorInvalidValue for arguments the kernels do not take).
extern "C" int unsloth_layer_norm_bwd(const void* x, const void* w, const void* g, void* dx,
                                      void* dw, void* db, void* partials, void* arrivals,
                                      int rows, int D, int chunks, int warps_per_row, int blocks,
                                      int group_blocks, float eps, int x_dtype, int w_dtype,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const NormBwdArgs a{x, w, g, dx, dw, static_cast<float*>(db), static_cast<float*>(partials),
                      static_cast<int*>(arrivals), rows, D, warps_per_row, group_blocks, eps, 0};
  const bool ok = x_dtype == 1 ? norm_bwd_args_ok<__nv_bfloat16>(a, chunks, blocks, 2)
                               : norm_bwd_args_ok<float>(a, chunks, blocks, 2);
  if (!ok || (dw == nullptr) != (db == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_norm_bwd(pick_bwd(x_dtype, w_dtype, chunks, dw != nullptr), blocks,
                         norm_bwd_smem(dw != nullptr, chunks, D, warps_per_row, 2), s, a);
}

// The blocks of the backward form (chunks, warps_per_row, dW or not) an SM
// holds at width D (ops/rms_norm.py sizes the grid by it), or a negative
// CUDA error. dtype codes as for unsloth_layer_norm.
extern "C" int unsloth_layer_norm_bwd_blocks_per_sm(int chunks, int warps_per_row, int dw,
                                                    int D, int x_dtype, int w_dtype) {
  return norm_bwd_blocks_per_sm(pick_bwd(x_dtype, w_dtype, chunks, dw != 0),
                                norm_bwd_smem(dw != 0, chunks, D, warps_per_row, 2));
}
