// Device code shared by the two flash attention sources of this package:
// packed_attention.cu (segment-block-sparse, packed rows; TPU kernels of
// unsloth_tpu/ops/packed_attention.py) and flash_attention.cu (the whole
// causal range, unpacked or padded rows; the bundled Pallas flash kernels
// that unsloth_tpu/ops/attention.py:_tpu_flash calls).
//
// Each source instantiates the three kernels below with a *range policy*,
// which alone decides which (query tile, kv tile) pairs a block visits:
//   kv_begin(b, iq) .. kv_end(b, iq)  kv tiles of query tile iq;
//   q_end(b, j)                       last query tile of kv tile j
//                                     (the first is j: causality);
//   skip(b, iq, j)                    a visited pair that provably holds
//                                     no valid (query, key) pair.
// Within a visited pair the mask is the same for both: token i attends to
// token j iff seg[i] == seg[j] and j <= i. So a policy may only narrow the
// visited pairs to those that can hold a valid one; the results at every
// position it covers are those of the full mask.
//
// Rounding points are the caller's, as kernel arguments: q is multiplied
// by `scale_q` in fp32 and rounded to bf16 when `prescale_q` is set (the
// packed kernels' JAX wrapper), the fp32 scores by `s_scale` (the bundled
// kernel's `s *= sm_scale`), dS by `ds_scale` before it is rounded to bf16,
// and dq by `dq_scale` when stored. A factor of 1.0f is exact, so each
// policy passes 1.0f where its TPU kernel has no such step. P and dS are
// rounded to bf16 before their products, as in both TPU kernels; the row
// statistics stay fp32.
//
// Layouts (the model's, no transposes): q, out, dout, dq [B, T, Hq, D];
// k, v, dk, dv [B, T, Hkv, D]; segment ids [B, T] int32; lse, di
// [B, Hq, T] fp32. D is 128. T need not be a multiple of 64: rows past T
// load as zeros with segment ids that match nothing (a query past T gets
// one sentinel, a key past T another), and are never stored.
//
// Design, kept simple: one block of four warps per (64-query tile, head)
// for the forward and dq, per (64-key tile, kv head) for dk/dv; tiles are
// staged in shared memory and multiplied with nvcuda::wmma 16x16x16 bf16
// MMAs in fp32. Each warp owns 16 query rows for QK^T and the softmax, so
// the row statistics need only warp shuffles. The forward keeps its
// running output in shared memory (fp32) so a row can be rescaled; dq, dk
// and dv accumulate in registers. The TPU's sequential grid axis becomes a
// loop inside the block; dq and dk/dv are separate kernels and dk/dv loops
// over the query heads of its kv head itself, so there are no atomics and
// the result is the same on every run. wgmma, TMA and pipelining are later
// work.

#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kD = 128;          // head dim
constexpr int kBlk = 64;         // tokens per tile
constexpr int kThreads = 128;    // four warps, 16 query rows each
constexpr int kLd = kD + 8;      // bf16 [64][kD] tile row stride
constexpr int kLds = kBlk + 4;   // fp32 [64][64] score tile row stride
constexpr int kLdp = kBlk + 8;   // bf16 [64][64] probability tile row stride
constexpr int kLdo = kD + 4;     // fp32 [64][kD] output tile row stride
constexpr float kNegInf = -1e30f;
constexpr float kEmptyLse = 1e30f;
constexpr int kQueryPastEnd = INT_MIN;    // segment id of a query row >= T
constexpr int kKeyPastEnd = INT_MIN + 1;  // segment id of a key row >= T

constexpr int kTileBf16 = kBlk * kLd * 2;   // bytes
constexpr int kTileS = kBlk * kLds * 4;
constexpr int kTileP = kBlk * kLdp * 2;
constexpr int kTileO = kBlk * kLdo * 4;
constexpr int kRowVecs = 4 * kBlk * 4;      // four [64] fp32/int32 arrays

constexpr int kFwdSmem = 3 * kTileBf16 + kTileS + kTileP + kTileO + kRowVecs;
constexpr int kDqSmem = 4 * kTileBf16 + 2 * kTileS + kTileP + kRowVecs;
constexpr int kDkvSmem = 4 * kTileBf16 + 2 * kTileS + 2 * kTileP + kRowVecs;

// Per-call scalars of the three kernels.
struct AttnArgs {
  int T, Hq, Hkv;
  bool prescale_q;
  float scale_q, s_scale, ds_scale, dq_scale;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 64 rows (tokens t0..t0+63 of head h) of a [B, T, H, kD] tensor into a
// shared [64][kLd] tile, zeros past T; with `do_scale` each value is
// multiplied in fp32 and rounded back to bf16.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int b, int T,
                                          int H, int h, int t0, bool do_scale, float scale) {
  constexpr int kChunks = kD / 8;
  for (int c = threadIdx.x; c < kBlk * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T) {
      v = *reinterpret_cast<const uint4*>(src + (((size_t)b * T + t0 + r) * H + h) * kD + col);
      if (do_scale) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(p[e]);
          p[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + col) = v;
  }
}

// Segment ids of tokens t0..t0+63 of row b into dst, `past_end` past T.
__device__ __forceinline__ void load_seg(int* dst, const int* __restrict__ seg, int b, int T,
                                         int t0, int past_end) {
  for (int i = threadIdx.x; i < kBlk; i += kThreads)
    dst[i] = t0 + i < T ? seg[(size_t)b * T + t0 + i] : past_end;
}

// S[r][c] = sum_d A[r][d] * B[c][d] for the warp's 16 rows r, all 64 c.
__device__ __forceinline__ void rows_times_tile_t(float* S, const bf16* A, const bf16* B,
                                                  int warp) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBlk / 16];
#pragma unroll
  for (int nf = 0; nf < kBlk / 16; ++nf) wmma::fill_fragment(acc[nf], 0.0f);
#pragma unroll
  for (int kk = 0; kk < kD; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + warp * 16 * kLd + kk, kLd);
#pragma unroll
    for (int nf = 0; nf < kBlk / 16; ++nf) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
      wmma::load_matrix_sync(bt, B + nf * 16 * kLd + kk, kLd);
      wmma::mma_sync(acc[nf], a, bt, acc[nf]);
    }
  }
#pragma unroll
  for (int nf = 0; nf < kBlk / 16; ++nf)
    wmma::store_matrix_sync(S + warp * 16 * kLds + nf * 16, acc[nf], kLds, wmma::mem_row_major);
}

// Writes a fp32 [64][kLdo] staging tile as bf16 rows (times `scale`) of a
// [B, T, H, kD] tensor, rows before T only.
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst, const float* stage, int b,
                                           int T, int H, int h, int t0, float scale) {
  constexpr int kChunks = kD / 8;
  for (int c = threadIdx.x; c < kBlk * kChunks; c += kThreads) {
    const int r = c / kChunks;
    if (t0 + r >= T) continue;
    const int col = (c % kChunks) * 8;
    const float* s = stage + r * kLdo + col;
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) o2[e] = __floats2bfloat162_rn(s[2 * e] * scale, s[2 * e + 1] * scale);
    *reinterpret_cast<uint4*>(dst + (((size_t)b * T + t0 + r) * H + h) * kD + col) = o;
  }
}

// Stages the warps' 16-row accumulators through shared memory and stores
// them as tile t0 of head h.
__device__ __forceinline__ void store_acc(
    bf16* __restrict__ dst, float* stage,
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[kD / 16], int warp, int b, int T,
    int H, int h, int t0, float scale) {
#pragma unroll
  for (int nf = 0; nf < kD / 16; ++nf)
    wmma::store_matrix_sync(stage + warp * 16 * kLdo + nf * 16, acc[nf], kLdo, wmma::mem_row_major);
  __syncthreads();
  store_tile(dst, stage, b, T, H, h, t0, scale);
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(T/64), Hq, B)
// ---------------------------------------------------------------------------
template <class Range>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ seg, Range range,
                bf16* __restrict__ out, float* __restrict__ lse, AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBlk * kLd;
  bf16* Vs = Ks + kBlk * kLd;
  float* Ss = reinterpret_cast<float*>(Vs + kBlk * kLd);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + kBlk * kLds);
  float* Os = reinterpret_cast<float*>(Ps + kBlk * kLdp);
  float* m_s = Os + kBlk * kLdo;
  float* l_s = m_s + kBlk;
  int* qseg = reinterpret_cast<int*>(l_s + kBlk);
  int* kseg = qseg + kBlk;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int T = a.T;
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile(Qs, q, b, T, a.Hq, h, iq * kBlk, a.prescale_q, a.scale_q);
  load_seg(qseg, seg, b, T, iq * kBlk, kQueryPastEnd);
  for (int i = threadIdx.x; i < kBlk; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < kBlk * kLdo; i += kThreads) Os[i] = 0.0f;

  const int hi = range.kv_end(b, iq);
  for (int j = range.kv_begin(b, iq); j <= hi; ++j) {
    if (range.skip(b, iq, j)) continue;  // uniform over the block
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, k, b, T, a.Hkv, hk, j * kBlk, false, 1.0f);
    load_tile(Vs, v, b, T, a.Hkv, hk, j * kBlk, false, 1.0f);
    load_seg(kseg, seg, b, T, j * kBlk, kKeyPastEnd);
    __syncthreads();

    rows_times_tile_t(Ss, Qs, Ks, warp);
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const int qpos = iq * kBlk + r;
      const int qs = qseg[r];
      const float s0 = Ss[r * kLds + lane] * a.s_scale;
      const float s1 = Ss[r * kLds + lane + 32] * a.s_scale;
      const bool v0 = kseg[lane] == qs && j * kBlk + lane <= qpos;
      const bool v1 = kseg[lane + 32] == qs && j * kBlk + lane + 32 <= qpos;
      const float mx = warp_max(fmaxf(v0 ? s0 : kNegInf, v1 ? s1 : kNegInf));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      const float p0 = v0 ? expf(s0 - m_new) : 0.0f;
      const float p1 = v1 ? expf(s1 - m_new) : 0.0f;
      const float sum = warp_sum(p0 + p1);
      Ps[r * kLdp + lane] = __float2bfloat16(p0);
      Ps[r * kLdp + lane + 32] = __float2bfloat16(p1);
      for (int d = lane; d < kD; d += 32) Os[r * kLdo + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
      }
    }
    __syncwarp();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[kD / 16];
#pragma unroll
    for (int nf = 0; nf < kD / 16; ++nf)
      wmma::load_matrix_sync(o[nf], Os + warp * 16 * kLdo + nf * 16, kLdo, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBlk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, Ps + warp * 16 * kLdp + kk, kLdp);
#pragma unroll
      for (int nf = 0; nf < kD / 16; ++nf) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, Vs + kk * kLd + nf * 16, kLd);
        wmma::mma_sync(o[nf], pa, bv, o[nf]);
      }
    }
#pragma unroll
    for (int nf = 0; nf < kD / 16; ++nf)
      wmma::store_matrix_sync(Os + warp * 16 * kLdo + nf * 16, o[nf], kLdo, wmma::mem_row_major);
  }
  __syncthreads();

  constexpr int kChunks = kD / 8;
  for (int c = threadIdx.x; c < kBlk * kChunks; c += kThreads) {
    const int r = c / kChunks;
    if (iq * kBlk + r >= T) continue;
    const int col = (c % kChunks) * 8;
    const float l = l_s[r];
    const float* s = Os + r * kLdo + col;
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o2[e] = __floats2bfloat162_rn(l > 0.0f ? s[2 * e] / l : 0.0f,
                                    l > 0.0f ? s[2 * e + 1] / l : 0.0f);
    *reinterpret_cast<uint4*>(out + (((size_t)b * T + iq * kBlk + r) * a.Hq + h) * kD + col) = o;
  }
  for (int r = threadIdx.x; r < kBlk; r += kThreads) {
    if (iq * kBlk + r >= T) continue;
    const float l = l_s[r];
    lse[((size_t)b * a.Hq + h) * T + iq * kBlk + r] = l > 0.0f ? m_s[r] + logf(l) : kEmptyLse;
  }
}

// ---------------------------------------------------------------------------
// dq (and di = sum(dout * out)): grid (ceil(T/64), Hq, B)
// ---------------------------------------------------------------------------
template <class Range>
__global__ void __launch_bounds__(kThreads)
attn_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const int* __restrict__ seg, Range range,
               const bf16* __restrict__ out, const bf16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ di, bf16* __restrict__ dq,
               AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kBlk * kLd;
  bf16* Ks = dOs + kBlk * kLd;
  bf16* Vs = Ks + kBlk * kLd;
  float* Ss = reinterpret_cast<float*>(Vs + kBlk * kLd);
  float* dPs = Ss + kBlk * kLds;
  bf16* dSs = reinterpret_cast<bf16*>(dPs + kBlk * kLds);
  float* lse_s = reinterpret_cast<float*>(dSs + kBlk * kLdp);
  float* di_s = lse_s + kBlk;
  int* qseg = reinterpret_cast<int*>(di_s + kBlk);
  int* kseg = qseg + kBlk;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int T = a.T;
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = ((size_t)b * a.Hq + h) * T + iq * kBlk;  // into lse / di

  load_tile(Qs, q, b, T, a.Hq, h, iq * kBlk, a.prescale_q, a.scale_q);
  load_tile(dOs, dout, b, T, a.Hq, h, iq * kBlk, false, 1.0f);
  load_seg(qseg, seg, b, T, iq * kBlk, kQueryPastEnd);
  for (int i = threadIdx.x; i < kBlk; i += kThreads)
    lse_s[i] = iq * kBlk + i < T ? lse[row0 + i] : 0.0f;
  // di = sum_d dout * out in fp32, one warp per row
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    float acc = 0.0f;
    if (iq * kBlk + r < T) {
      const size_t off = (((size_t)b * T + iq * kBlk + r) * a.Hq + h) * kD;
      for (int d = lane; d < kD; d += 32)
        acc += __bfloat162float(dout[off + d]) * __bfloat162float(out[off + d]);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      di_s[r] = acc;
      if (iq * kBlk + r < T) di[row0 + r] = acc;
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kD / 16];
#pragma unroll
  for (int nf = 0; nf < kD / 16; ++nf) wmma::fill_fragment(acc[nf], 0.0f);

  const int hi = range.kv_end(b, iq);
  for (int j = range.kv_begin(b, iq); j <= hi; ++j) {
    if (range.skip(b, iq, j)) continue;  // uniform over the block
    __syncthreads();
    load_tile(Ks, k, b, T, a.Hkv, hk, j * kBlk, false, 1.0f);
    load_tile(Vs, v, b, T, a.Hkv, hk, j * kBlk, false, 1.0f);
    load_seg(kseg, seg, b, T, j * kBlk, kKeyPastEnd);
    __syncthreads();

    rows_times_tile_t(Ss, Qs, Ks, warp);
    rows_times_tile_t(dPs, dOs, Vs, warp);
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const int qpos = iq * kBlk + r;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const bool valid = kseg[c] == qseg[r] && j * kBlk + c <= qpos;
        const float p = valid ? expf(Ss[r * kLds + c] * a.s_scale - lse_s[r]) : 0.0f;
        dSs[r * kLdp + c] = __float2bfloat16(p * (dPs[r * kLds + c] - di_s[r]) * a.ds_scale);
      }
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kBlk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> sa;
      wmma::load_matrix_sync(sa, dSs + warp * 16 * kLdp + kk, kLdp);
#pragma unroll
      for (int nf = 0; nf < kD / 16; ++nf) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bk;
        wmma::load_matrix_sync(bk, Ks + kk * kLd + nf * 16, kLd);
        wmma::mma_sync(acc[nf], sa, bk, acc[nf]);
      }
    }
  }
  __syncthreads();
  store_acc(dq, reinterpret_cast<float*>(smem), acc, warp, b, T, a.Hq, h, iq * kBlk, a.dq_scale);
}

// ---------------------------------------------------------------------------
// dk, dv: grid (ceil(T/64), Hkv, B); loops over the Hq/Hkv query heads of
// the kv head and the query tiles j .. q_end(j).
// ---------------------------------------------------------------------------
template <class Range>
__global__ void __launch_bounds__(kThreads)
attn_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ seg, Range range,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv,
                AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBlk * kLd;
  bf16* Qs = Vs + kBlk * kLd;
  bf16* dOs = Qs + kBlk * kLd;
  float* Ss = reinterpret_cast<float*>(dOs + kBlk * kLd);
  float* dPs = Ss + kBlk * kLds;
  bf16* Ps = reinterpret_cast<bf16*>(dPs + kBlk * kLds);
  bf16* dSs = Ps + kBlk * kLdp;
  float* lse_s = reinterpret_cast<float*>(dSs + kBlk * kLdp);
  float* di_s = lse_s + kBlk;
  int* qseg = reinterpret_cast<int*>(di_s + kBlk);
  int* kseg = qseg + kBlk;

  const int j = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int T = a.T;
  const int group = a.Hq / a.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile(Ks, k, b, T, a.Hkv, hk, j * kBlk, false, 1.0f);
  load_tile(Vs, v, b, T, a.Hkv, hk, j * kBlk, false, 1.0f);
  load_seg(kseg, seg, b, T, j * kBlk, kKeyPastEnd);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[kD / 16], dv_acc[kD / 16];
#pragma unroll
  for (int nf = 0; nf < kD / 16; ++nf) {
    wmma::fill_fragment(dk_acc[nf], 0.0f);
    wmma::fill_fragment(dv_acc[nf], 0.0f);
  }

  const int last = range.q_end(b, j);
  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    for (int iq = j; iq <= last; ++iq) {
      if (range.skip(b, iq, j)) continue;  // uniform over the block
      __syncthreads();  // the previous tile's readers are done
      load_tile(Qs, q, b, T, a.Hq, h, iq * kBlk, a.prescale_q, a.scale_q);
      load_tile(dOs, dout, b, T, a.Hq, h, iq * kBlk, false, 1.0f);
      load_seg(qseg, seg, b, T, iq * kBlk, kQueryPastEnd);
      const size_t row0 = ((size_t)b * a.Hq + h) * T + iq * kBlk;
      for (int i = threadIdx.x; i < kBlk; i += kThreads) {
        const bool in = iq * kBlk + i < T;
        lse_s[i] = in ? lse[row0 + i] : 0.0f;
        di_s[i] = in ? di[row0 + i] : 0.0f;
      }
      __syncthreads();

      rows_times_tile_t(Ss, Qs, Ks, warp);    // S[q][c]
      rows_times_tile_t(dPs, dOs, Vs, warp);  // dP[q][c]
      __syncwarp();
      for (int rr = 0; rr < 16; ++rr) {
        const int r = warp * 16 + rr;
        const int qpos = iq * kBlk + r;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = lane + 32 * half;
          const bool valid = kseg[c] == qseg[r] && j * kBlk + c <= qpos;
          const float p = valid ? expf(Ss[r * kLds + c] * a.s_scale - lse_s[r]) : 0.0f;
          Ps[r * kLdp + c] = __float2bfloat16(p);
          dSs[r * kLdp + c] = __float2bfloat16(p * (dPs[r * kLds + c] - di_s[r]) * a.ds_scale);
        }
      }
      __syncthreads();  // every query row of P and dS is written

      // warp w owns key rows 16w..16w+15: dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < kBlk; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> pa, sa;
        wmma::load_matrix_sync(pa, Ps + kk * kLdp + warp * 16, kLdp);
        wmma::load_matrix_sync(sa, dSs + kk * kLdp + warp * 16, kLdp);
#pragma unroll
        for (int nf = 0; nf < kD / 16; ++nf) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bo, bq;
          wmma::load_matrix_sync(bo, dOs + kk * kLd + nf * 16, kLd);
          wmma::mma_sync(dv_acc[nf], pa, bo, dv_acc[nf]);
          wmma::load_matrix_sync(bq, Qs + kk * kLd + nf * 16, kLd);
          wmma::mma_sync(dk_acc[nf], sa, bq, dk_acc[nf]);
        }
      }
    }
  }
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem);
  store_acc(dk, stage, dk_acc, warp, b, T, a.Hkv, hk, j * kBlk, 1.0f);
  __syncthreads();
  store_acc(dv, stage, dv_acc, warp, b, T, a.Hkv, hk, j * kBlk, 1.0f);
}

inline int set_smem(const void* fn, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace
