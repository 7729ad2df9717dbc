// What the row-norm kernels share (rms_norm.cu, K3/K4; layer_norm.cu,
// K5/K6): fp32 conversions of the element types, a block-wide sum, the
// 16-byte chunk helpers of the warp forms, and the backward of both norms
// (norm_bwd_vec, norm_bwd_strided), which rms_norm.cu and layer_norm.cu
// instantiate as K4's and K6's kernels.
//
// The backward. Replaces unsloth_tpu/ops/rms_norm.py:_bwd_kernel (K4) and
// _ln_bwd_kernel (K6). Per row, all in fp32:
//   K4: inv = rsqrt(mean(x^2) + eps), xhat = x * inv, s = w (Gemma: 1 + w),
//       dx = inv * (g s - xhat * mean(g s xhat)),     dW = sum_rows(g xhat)
//   K6: mean, inv = rsqrt(mean((x - mean)^2) + eps), xhat = (x - mean) inv,
//       dx = inv * (g w - mean(g w) - xhat * mean(g w xhat)),
//       dW = sum_rows(g xhat), dB = sum_rows(g)
// What bounds it on an H100: device-memory bytes. x and g are read once
// and dx written once, 6 bytes an element in bf16 against 8 (K4) or 14
// (K6) fp32 operations, so the design reads each row once at full width
// and adds no pass around it:
//   * The row form (norm_bwd_vec): a row is read once, in 16-byte chunks,
//     neighbouring lanes on neighbouring chunks, and its x and g stay in
//     registers for every later pass; w is read in the same chunks (from
//     L1 after the first rows). A row belongs to a group of W warps (W = 1,
//     2, 4 or 8, 8 / W rows a 256-thread block at a time; lane l of the
//     group holds chunks l, l + 32 W, ...): a row's sums are each warp's
//     shuffle tree, then, where W > 1, the W warp sums added in warp order
//     through shared memory behind a named barrier of the group's 32 W
//     threads, never the whole block. ops/rms_norm.py:norm_bwd_form picks
//     W and the chunks a lane holds (the template C) from the register
//     budget with the dW (and dB) columns whether or not they are asked
//     for (so dx is the same bits in both forms), and the grid: about one
//     wave at the kernel's occupancy, blocks walking rows in a grid-stride
//     loop.
//   * dx only (dw null; every LoRA path, where the weights are frozen): one
//     launch, no scratch.
//   * dx with dW (and dB): each lane keeps its columns' sums in fp32
//     registers over every row its group visits; the groups of a block add
//     theirs in group order into one fp32 partial row a block; the last
//     block of each group of Q blocks to arrive (a self-resetting arrival
//     counter) sums its group's partial rows in block order, and the last
//     group to finish sums the group rows in group order into dW (and dB),
//     in the same launch. No atomics on dW or dB: the same bits on every
//     run.
//   * The strided form (norm_bwd_strided), for widths that are not a whole
//     number of chunks, tensors that are not 16-byte aligned or rows wider
//     than the row form holds: the same grid and epilogue, a row a block,
//     elements t, t + 256, ... re-read in each pass, dW (and dB) summed in
//     shared memory (each thread owning its columns).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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


// ---------------------------------------------------------------------------
// The backward (K4, K6): see the top of this file.
// ---------------------------------------------------------------------------

constexpr int kWarps = kThreads / 32;
// 32-bit registers a lane of the row form may give its data: C chunks of
// x and of g (four each) and `sums` fp32 columns (dW; and dB) for each of
// their elements; __launch_bounds__(kThreads, 2) leaves 128 a thread
// (ops/rms_norm.py: NORM_LANE_REGS, norm_lane_registers)
constexpr int kNormLaneRegs = 64;

template <typename TX>
constexpr bool norm_lane_fits(int chunks, int sums) {
  return 8 * chunks + sums * (16 / static_cast<int>(sizeof(TX))) * chunks <= kNormLaneRegs;
}

struct NormBwdArgs {
  const void* x;
  const void* w;
  const void* g;
  void* dx;
  void* dw;         // dW (K4: w's dtype, K6: fp32); null in the dx-only form
  float* db;        // K6's dB (fp32) beside dW, else null
  float* partials;  // fp32 scratch, (blocks + groups) rows of nacc * Dp
  int* arrivals;    // groups + 1 counters, zero between launches
  int rows;
  int D;
  int warps_per_row;  // W of the row form (the strided form: kWarps)
  int group_blocks;   // Q: the blocks of a group of partial rows
  float eps;
  int gemma;        // K4: the scale is 1 + w
};

__device__ __forceinline__ int round4(int d) { return (d + 3) & ~3; }

// The 32 * W threads of row group `id` - 1 wait for each other (bar.sync
// with a thread count: the rest of the block goes on).
__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// v[n] summed over the W warps of row group `grp`, returned to each of
// their lanes: each warp's shuffle tree, then (W > 1) the W warp sums in
// warp order through red[n][warp] behind the group's barrier. Each of a
// row's sums takes its own `red`, so a group's next row never overwrites a
// value a slower warp of it has not read (the barrier between two uses of
// one slot is passed only after every warp has read the first).
template <int N>
__device__ __forceinline__ void group_sum(float (&v)[N], float (&red)[2][kWarps], int W,
                                          int grp) {
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = warp_sum(v[n]);
  if (W == 1) return;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) red[n][warp] = v[n];
  }
  group_barrier(1 + grp, 32 * W);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float t = red[n][grp * W];
    for (int j = 1; j < W; ++j) t += red[n][grp * W + j];
    v[n] = t;
  }
}

__device__ __forceinline__ float4 add4(float4 a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
  return a;
}

// store(j, the sum over m < count of src[m * n4 + j] in order of m) for
// the float4 columns j < n4: the block's threads stride over j two columns
// at a time and load 8 rows of both before adding them, 16 loads in
// flight a thread (the partial rows are in L2).
template <typename Store>
__device__ __forceinline__ void sum_rows_in_order(const float4* __restrict__ src, int count,
                                                  int n4, Store store) {
  constexpr int kB = 8;
  for (int j0 = threadIdx.x; j0 < n4; j0 += 2 * kThreads) {
    const int j1 = j0 + kThreads;
    const bool two = j1 < n4;
    float4 s0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), s1 = s0;
    for (int m0 = 0; m0 < count; m0 += kB) {
      float4 v0[kB], v1[kB];
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        if (m0 + u >= count) continue;
        v0[u] = __ldcg(src + (size_t)(m0 + u) * n4 + j0);
        if (two) v1[u] = __ldcg(src + (size_t)(m0 + u) * n4 + j1);
      }
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        if (m0 + u >= count) continue;
        s0 = m0 + u == 0 ? v0[u] : add4(s0, v0[u]);
        if (two) s1 = m0 + u == 0 ? v1[u] : add4(s1, v1[u]);
      }
    }
    store(j0, s0);
    if (two) store(j1, s1);
  }
}

// After the block stored its partial row (nacc rows of Dp floats: dW's,
// then dB's): the last of each group of Q blocks to arrive sums the
// group's partial rows in block order into the group's row (after the
// blocks' rows); the last group to finish sums the group rows in group
// order into dW (TOut) and dB (fp32). Both counters reset themselves.
template <typename TOut>
__device__ __forceinline__ void finish_partials(const NormBwdArgs& p, int nacc) {
  __shared__ int ticket;
  const int P = gridDim.x, Q = p.group_blocks;
  const int n_groups = (P + Q - 1) / Q;
  const int grp = blockIdx.x / Q;
  const int members = min(Q, P - grp * Q);
  const int D = p.D, Dp = round4(D);
  const int n4 = nacc * Dp / 4;
  float4* rows4 = reinterpret_cast<float4*>(p.partials);
  float4* group_row = rows4 + ((size_t)P + grp) * n4;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(p.arrivals + grp, 1);
  __syncthreads();
  if (ticket != members - 1) return;
  __threadfence();
  sum_rows_in_order(rows4 + (size_t)grp * Q * n4, members, n4,
                    [&](int j, const float4& v) { __stcg(group_row + j, v); });
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    p.arrivals[grp] = 0;
    ticket = atomicAdd(p.arrivals + n_groups, 1);
  }
  __syncthreads();
  if (ticket != n_groups - 1) return;
  __threadfence();
  TOut* dw = static_cast<TOut*>(p.dw);
  float* db = p.db;
  sum_rows_in_order(rows4 + (size_t)P * n4, n_groups, n4, [&](int j, const float4& s) {
    const float v[4] = {s.x, s.y, s.z, s.w};
    const int a = 4 * j / Dp, col = 4 * j % Dp;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (col + k >= D) break;
      if (a == 0)
        dw[col + k] = from_f32<TOut>(v[k]);
      else
        db[col + k] = v[k];
    }
  });
  if (threadIdx.x == 0) p.arrivals[n_groups] = 0;
}

// The row form: rows r = (blockIdx.x + k gridDim.x) * G + group, G = 8 / W
// rows a block at a time; lane l of a group holds the row's 16-byte chunks
// l, l + 32 W, ... (at most C) of x and of g in registers. kLn: K6, else
// K4. kDw: dW (and dB) too.
template <bool kLn, typename TX, typename TW, int C, bool kDw>
__device__ __forceinline__ void norm_bwd_vec(const NormBwdArgs& p) {
  constexpr int E = 16 / static_cast<int>(sizeof(TX));  // elements of a chunk
  constexpr int NACC = kLn ? 2 : 1;
  __shared__ float red[3][2][kWarps];
  const int W = p.warps_per_row, G = kWarps / W;
  const int warp = threadIdx.x / 32;
  const int grp = warp / W;
  const int glane = (warp % W) * 32 + threadIdx.x % 32;
  const int stride = 32 * W;
  const int chunks = p.D / E;
  const float d = static_cast<float>(p.D);
  const TW* w = static_cast<const TW*>(p.w);
  float acc[kDw ? NACC : 1][kDw ? C : 1][E];
  if constexpr (kDw) {
#pragma unroll
    for (int a = 0; a < NACC; ++a)
#pragma unroll
      for (int i = 0; i < C; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[a][i][e] = 0.0f;
  }
  for (int r = blockIdx.x * G + grp; r < p.rows; r += gridDim.x * G) {
    const size_t off = (size_t)r * p.D;
    const uint4* xr = reinterpret_cast<const uint4*>(static_cast<const TX*>(p.x) + off);
    const uint4* gr = reinterpret_cast<const uint4*>(static_cast<const TX*>(p.g) + off);
    uint4* dxr = reinterpret_cast<uint4*>(static_cast<TX*>(p.dx) + off);
    uint4 xv[C], gv[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int ch = glane + i * stride;
      xv[i] = make_uint4(0, 0, 0, 0);
      gv[i] = xv[i];
      if (ch < chunks) {
        xv[i] = __ldcs(xr + ch);
        gv[i] = __ldcs(gr + ch);
      }
    }
    float mean = 0.0f, inv, m1 = 0.0f, m2;
    if constexpr (kLn) {
      float s[1] = {0.0f};
#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (glane + i * stride >= chunks) continue;
        float f[E];
        unpack<TX, E>(xv[i], f);
#pragma unroll
        for (int e = 0; e < E; ++e) s[0] += f[e];
      }
      group_sum(s, red[0], W, grp);
      mean = s[0] / d;
    }
    {
      float q[1] = {0.0f};
#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (glane + i * stride >= chunks) continue;
        float f[E];
        unpack<TX, E>(xv[i], f);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float c = f[e] - mean;
          q[0] += c * c;
        }
      }
      group_sum(q, red[1], W, grp);
      inv = rsqrtf(q[0] / d + p.eps);
    }
    {
      // K4: mean(g s xhat); K6: mean(g w) and mean(g w xhat)
      float m[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int ch = glane + i * stride;
        if (ch >= chunks) continue;
        float xf[E], gf[E], wf[E];
        unpack<TX, E>(xv[i], xf);
        unpack<TX, E>(gv[i], gf);
        load_f32<TW, E>(w + ch * E, wf);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float s = !kLn && p.gemma ? 1.0f + wf[e] : wf[e];
          const float gs = gf[e] * s;
          m[0] += gs;
          m[1] += gs * ((xf[e] - mean) * inv);
        }
      }
      if constexpr (kLn) {
        group_sum(m, red[2], W, grp);
        m1 = m[0] / d;
        m2 = m[1] / d;
      } else {
        float dot[1] = {m[1]};
        group_sum(dot, red[2], W, grp);
        m2 = dot[0] / d;
      }
    }
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int ch = glane + i * stride;
      if (ch >= chunks) continue;
      float xf[E], gf[E], wf[E], out[E];
      unpack<TX, E>(xv[i], xf);
      unpack<TX, E>(gv[i], gf);
      load_f32<TW, E>(w + ch * E, wf);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float s = !kLn && p.gemma ? 1.0f + wf[e] : wf[e];
        const float xhat = (xf[e] - mean) * inv;
        out[e] = inv * (gf[e] * s - m1 - xhat * m2);
        if constexpr (kDw) {
          acc[0][i][e] += gf[e] * xhat;
          if constexpr (kLn) acc[NACC - 1][i][e] += gf[e];
        }
      }
      __stcs(dxr + ch, pack<TX, E>(out));
    }
  }
  if constexpr (kDw) {
    // the block's groups in group order into one partial row: group j adds
    // its sums to groups 0..j-1's in shared memory; the last one stores
    extern __shared__ float4 smem4[];
    float* sacc = reinterpret_cast<float*>(smem4);  // [NACC][D]
    float* prow = p.partials + (size_t)blockIdx.x * NACC * round4(p.D);
    for (int j = 0; j < G; ++j) {
      if (grp == j) {
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const int ch = glane + i * stride;
          if (ch >= chunks) continue;
#pragma unroll
          for (int a = 0; a < NACC; ++a) {
            float v[E];
#pragma unroll
            for (int e = 0; e < E; ++e)
              v[e] = j == 0 ? acc[a][i][e] : sacc[a * p.D + ch * E + e] + acc[a][i][e];
            float* dst = j == G - 1 ? prow + a * round4(p.D) : sacc + a * p.D;
#pragma unroll
            for (int e = 0; e < E; e += 4) {
              const float4 v4 = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
              if (j == G - 1)
                __stcg(reinterpret_cast<float4*>(dst + ch * E + e), v4);
              else
                *reinterpret_cast<float4*>(dst + ch * E + e) = v4;
            }
          }
        }
      }
      if (j < G - 1) __syncthreads();
    }
    finish_partials<typename std::conditional<kLn, float, TW>::type>(p, NACC);
  }
}

// The strided form: one row a block at a time (rows blockIdx.x + k
// gridDim.x), thread t on elements t, t + 256, ..., each pass reading the
// row again (from L1/L2 after the first); the sums as the row form's with
// W = 8; dW (and dB) where p.dw is set, in shared memory [nacc][D], each
// thread owning the columns it walks.
template <bool kLn, typename TX, typename TW>
__device__ __forceinline__ void norm_bwd_strided(const NormBwdArgs& p) {
  __shared__ float red[3][2][kWarps];
  extern __shared__ float4 smem4[];
  float* sacc = reinterpret_cast<float*>(smem4);
  const int nacc = p.dw == nullptr ? 0 : kLn ? 2 : 1;
  const int D = p.D;
  const float d = static_cast<float>(D);
  const TW* w = static_cast<const TW*>(p.w);
  for (int i = threadIdx.x; i < nacc * D; i += kThreads) sacc[i] = 0.0f;
  for (int r = blockIdx.x; r < p.rows; r += gridDim.x) {
    const TX* xr = static_cast<const TX*>(p.x) + (size_t)r * D;
    const TX* gr = static_cast<const TX*>(p.g) + (size_t)r * D;
    TX* dxr = static_cast<TX*>(p.dx) + (size_t)r * D;
    float mean = 0.0f, m1 = 0.0f;
    if constexpr (kLn) {
      float s[1] = {0.0f};
      for (int i = threadIdx.x; i < D; i += kThreads) s[0] += to_f32(xr[i]);
      group_sum(s, red[0], kWarps, 0);
      mean = s[0] / d;
    }
    float q[1] = {0.0f};
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float c = to_f32(xr[i]) - mean;
      q[0] += c * c;
    }
    group_sum(q, red[1], kWarps, 0);
    const float inv = rsqrtf(q[0] / d + p.eps);
    float m[2] = {0.0f, 0.0f};
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float s = !kLn && p.gemma ? 1.0f + to_f32(w[i]) : to_f32(w[i]);
      const float gs = to_f32(gr[i]) * s;
      m[0] += gs;
      m[1] += gs * ((to_f32(xr[i]) - mean) * inv);
    }
    float m2;
    if constexpr (kLn) {
      group_sum(m, red[2], kWarps, 0);
      m1 = m[0] / d;
      m2 = m[1] / d;
    } else {
      float dot[1] = {m[1]};
      group_sum(dot, red[2], kWarps, 0);
      m2 = dot[0] / d;
    }
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float s = !kLn && p.gemma ? 1.0f + to_f32(w[i]) : to_f32(w[i]);
      const float gv = to_f32(gr[i]);
      const float xhat = (to_f32(xr[i]) - mean) * inv;
      dxr[i] = from_f32<TX>(inv * (gv * s - m1 - xhat * m2));
      if (nacc) {
        sacc[i] += gv * xhat;
        if (kLn) sacc[D + i] += gv;
      }
    }
  }
  if (nacc == 0) return;
  float* prow = p.partials + (size_t)blockIdx.x * nacc * round4(D);
  for (int a = 0; a < nacc; ++a)
    for (int i = threadIdx.x; i < D; i += kThreads)
      __stcg(prow + a * round4(D) + i, sacc[a * D + i]);
  finish_partials<typename std::conditional<kLn, float, TW>::type>(p, nacc);
}

// Dynamic shared memory of a backward launch with `sums` rows of dW (and
// dB): the strided form's sums, or the row form's group-order combine
// where a block holds more than one row group; none in the dx-only form.
inline size_t norm_bwd_smem(bool dw, int chunks, int D, int warps_per_row, int sums) {
  if (!dw || (chunks != 0 && warps_per_row == kWarps)) return 0;
  return static_cast<size_t>(sums) * D * sizeof(float);
}

using NormBwdKernel = void (*)(NormBwdArgs);

// Launches `kernel` with `smem` bytes of dynamic shared memory (opting in
// past the default 48 KB); the launch's CUDA error (0 if none).
inline int launch_norm_bwd(NormBwdKernel kernel, int blocks, size_t smem, cudaStream_t s,
                           const NormBwdArgs& a) {
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The 256-thread blocks of `kernel` an SM holds with `smem` bytes of
// dynamic shared memory, or a negative CUDA error.
inline int norm_bwd_blocks_per_sm(NormBwdKernel kernel, size_t smem) {
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, reinterpret_cast<const void*>(kernel), kThreads, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// Whether a backward's arguments are what its kernels take (the wrapper
// ops/rms_norm.py:norm_bwd_form picks them): the row form (chunks 2 or 4
// within the lane budget with `sums` columns, W 1, 2, 4 or 8 with C * 32 W
// chunks covering the row, 16-byte aligned tensors) or the strided form
// (chunks 0, W 8); with dW, the scratch and a group size.
template <typename TX>
bool norm_bwd_args_ok(const NormBwdArgs& a, int chunks, int blocks, int sums) {
  constexpr int E = 16 / static_cast<int>(sizeof(TX));
  if (a.rows < 1 || a.D < 1 || blocks < 1) return false;
  if (a.dw != nullptr && (a.partials == nullptr || a.arrivals == nullptr || a.group_blocks < 1))
    return false;
  if (chunks == 0) return a.warps_per_row == kWarps;
  const int W = a.warps_per_row;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.g) |
                         reinterpret_cast<uintptr_t>(a.dx) | reinterpret_cast<uintptr_t>(a.w);
  return (chunks == 2 || chunks == 4) && norm_lane_fits<TX>(chunks, sums) &&
         (W == 1 || W == 2 || W == 4 || W == 8) && a.D % E == 0 &&
         chunks * 32 * W >= a.D / E && ptrs % 16 == 0;
}

}  // namespace
