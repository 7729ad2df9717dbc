// Cross-entropy over full logits: per-row loss and logsumexp (K7) and
// dlogits (K8), for bf16 or fp32 logits [N, V].
//
// Replaces the TPU kernels of unsloth_tpu/ops/cross_entropy.py:
//   ce_fwd_kernel <- _ce_fwd_kernel (online (max, sum-exp) over vocab
//                                    chunks; loss = lse - target, 0 for
//                                    label -100)
//   ce_bwd_kernel <- _ce_bwd_kernel (dlogits = (softmax - onehot) * g,
//                                    through the softcap and the scale,
//                                    from the saved lse)
// Each logit is transformed as in the JAX kernels: x * logit_scale, then
// softcap * tanh(x / softcap); the caller passes scale 1 and softcap 0
// where the model has none (multiplying by 1.0f is exact).
//
// Written in CUDA C++ (the repository's rule) rather than Triton: both
// kernels are one row reduction plus one elementwise pass, which need
// nothing beyond a block reduction.
//
// What bounds it on an H100: device memory. The forward reads N x V
// logits once (1.05 GB at 4,094 x 128,256 bf16); the backward reads them
// again and writes dlogits of the same size. Design: the TPU's sequential
// vocab grid axis becomes a loop inside the block, and one 256-thread
// block owns one row: each thread keeps an online (max, sum-exp) in fp32
// over 16-byte loads (8 bf16 or 4 fp32 values a load, the ragged end of
// the vocabulary masked), then the block merges the threads' pairs with
// warp shuffles and shared memory. No state crosses blocks, so there are
// no atomics and the result is the same on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIgnore = -100;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void from_float(float x, bf16* out) { *out = __float2bfloat16(x); }
__device__ __forceinline__ void from_float(float x, float* out) { *out = x; }

// Values per 16-byte load.
template <typename T> struct Vec;
template <> struct Vec<bf16> { static constexpr int n = 8; };
template <> struct Vec<float> { static constexpr int n = 4; };

__device__ __forceinline__ float transform(float x, float scale, float softcap) {
  x *= scale;
  if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
  return x;
}

// (m, s) <- the pair whose sum-exp is s * exp(m) plus s2 * exp(m2).
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
              float* __restrict__ loss, float* __restrict__ lse, int V, float scale,
              float softcap) {
  constexpr int kVec = Vec<T>::n;
  __shared__ float m_sh[kThreads / 32], s_sh[kThreads / 32];
  const int row = blockIdx.x;
  const T* x = logits + (size_t)row * V;
  float m = -INFINITY, s = 0.0f;
  // rows start 16-byte aligned when V % kVec == 0 (the wrapper's
  // allocation is), then whole vectors; the rest one value at a time
  const int v_vec = V % kVec == 0 ? V : 0;
  for (int c = threadIdx.x * kVec; c < v_vec; c += kThreads * kVec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + c);
    const T* e = reinterpret_cast<const T*>(&raw);
    float z[kVec];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      z[i] = transform(to_float(e[i]), scale, softcap);
      mx = fmaxf(mx, z[i]);
    }
    float se = 0.0f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) se += expf(z[i] - mx);
    merge(m, s, mx, se);
  }
  for (int c = v_vec + threadIdx.x; c < V; c += kThreads)
    merge(m, s, transform(to_float(x[c]), scale, softcap), 1.0f);

  // block reduction of the (m, s) pairs
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    m_sh[warp] = m;
    s_sh[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) merge(m, s, m_sh[w], s_sh[w]);
    const float row_lse = m + logf(s);
    const int label = labels[row];
    // the JAX kernel picks the target with a where/sum over the columns:
    // a label outside [0, V) picks nothing (0)
    const float target =
        label >= 0 && label < V ? transform(to_float(x[label]), scale, softcap) : 0.0f;
    lse[row] = row_lse;
    loss[row] = label != kIgnore ? row_lse - target : 0.0f;
  }
}

template <typename T>
__device__ __forceinline__ float dlogit(float x, int col, int label, float row_lse, float g,
                                        float scale, float softcap) {
  const float z = x * scale;
  float zc = z, th = 0.0f;
  if (softcap > 0.0f) {
    th = tanhf(z / softcap);
    zc = softcap * th;
  }
  float d = (expf(zc - row_lse) - (col == label ? 1.0f : 0.0f)) * g;
  if (softcap > 0.0f) d *= 1.0f - th * th;
  return d * scale;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
              const float* __restrict__ lse, const float* __restrict__ g,
              T* __restrict__ dlogits, int V, float scale, float softcap) {
  constexpr int kVec = Vec<T>::n;
  const int row = blockIdx.x;
  const T* x = logits + (size_t)row * V;
  T* dx = dlogits + (size_t)row * V;
  const int label = labels[row];
  const bool valid = label != kIgnore;
  const float row_lse = lse[row], gr = g[row];
  const int v_vec = V % kVec == 0 ? V : 0;
  for (int c = threadIdx.x * kVec; c < v_vec; c += kThreads * kVec) {
    uint4 raw = *reinterpret_cast<const uint4*>(x + c);
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float d = valid ? dlogit<T>(to_float(e[i]), c + i, label, row_lse, gr, scale, softcap)
                            : 0.0f;
      from_float(d, &e[i]);
    }
    *reinterpret_cast<uint4*>(dx + c) = raw;
  }
  for (int c = v_vec + threadIdx.x; c < V; c += kThreads) {
    const float d = valid ? dlogit<T>(to_float(x[c]), c, label, row_lse, gr, scale, softcap) : 0.0f;
    from_float(d, &dx[c]);
  }
}

}  // namespace

// Forward on `stream`: loss and lse [N] fp32 from logits [N, V] (bf16 if
// `is_bf16`, else fp32; contiguous, 16-byte aligned) and labels [N] int32.
// Returns the CUDA error code (0 if none).
extern "C" int unsloth_ce_fwd(const void* logits, const void* labels, void* loss, void* lse,
                              int N, int V, float scale, float softcap, int is_bf16,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lb = static_cast<const int*>(labels);
  if (is_bf16)
    ce_fwd_kernel<bf16><<<N, kThreads, 0, s>>>(static_cast<const bf16*>(logits), lb,
                                               static_cast<float*>(loss),
                                               static_cast<float*>(lse), V, scale, softcap);
  else
    ce_fwd_kernel<float><<<N, kThreads, 0, s>>>(static_cast<const float*>(logits), lb,
                                                static_cast<float*>(loss),
                                                static_cast<float*>(lse), V, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

// Backward on `stream`: dlogits [N, V] in the logits' dtype from logits,
// labels, the forward's lse and the upstream gradient g [N] fp32.
extern "C" int unsloth_ce_bwd(const void* logits, const void* labels, const void* lse,
                              const void* g, void* dlogits, int N, int V, float scale,
                              float softcap, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lb = static_cast<const int*>(labels);
  const auto* ls = static_cast<const float*>(lse);
  const auto* gp = static_cast<const float*>(g);
  if (is_bf16)
    ce_bwd_kernel<bf16><<<N, kThreads, 0, s>>>(static_cast<const bf16*>(logits), lb, ls, gp,
                                               static_cast<bf16*>(dlogits), V, scale, softcap);
  else
    ce_bwd_kernel<float><<<N, kThreads, 0, s>>>(static_cast<const float*>(logits), lb, ls, gp,
                                                static_cast<float*>(dlogits), V, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}
