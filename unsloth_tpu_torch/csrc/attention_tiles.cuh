// Device code shared by the two flash attention sources of this package:
// packed_attention.cu (segment-block-sparse, packed rows; TPU kernels of
// unsloth_tpu/ops/packed_attention.py) and flash_attention.cu (the whole
// causal range, unpacked or padded rows; the bundled Pallas flash kernels
// that unsloth_tpu/ops/attention.py:_tpu_flash calls).
//
// Each source instantiates the three kernels below with a head dim D and a
// *range policy*, which alone decides which (query tile, kv tile) pairs a
// block visits:
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
// [B, Hq, T] fp32. D is 64, 128 or 256 (Tiles<D>). T need not be a
// multiple of 64: rows past T load as zeros with segment ids that match
// nothing (a query past T gets one sentinel, a key past T another), and are
// never stored.
//
// Design, kept simple: one block per (64-query tile, head) for the forward
// and dq, per (64-key tile, kv head) for dk/dv; tiles are staged in shared
// memory and multiplied with nvcuda::wmma 16x16x16 bf16 MMAs in fp32. The
// block has four row groups of 16 rows times D / kSlice column groups of
// warps (kSlice = min(D, 128)): every warp accumulates a 16 x kSlice slice
// of a D-wide output, so the dk/dv kernel's accumulators stay at the
// D = 128 count at D = 256 (8 warps) and halve at D = 64 (4 warps). The
// score tiles are split the same way; the softmax and the masks run one
// warp per row, 2 columns a lane, so the row statistics need only warp
// shuffles. With one column group a warp reads only the score rows it
// wrote, and a warp barrier suffices between the products and the softmax
// (sync_rows). The forward keeps its running output in shared memory
// (fp32) so a row can be rescaled; dq, dk and dv accumulate in registers.
// The TPU's sequential grid axis becomes a loop inside the block; dq and
// dk/dv are separate kernels and dk/dv loops over the query heads of its
// kv head itself, so there are no atomics and the result is the same on
// every run. At D = 256 a block takes 176-191 KB of shared memory (opted
// in per instantiation), so one block runs per SM. wgmma, TMA and
// pipelining are later work.

#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;
using Frag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kBlk = 64;         // tokens per tile
constexpr int kLds = kBlk + 4;   // fp32 [64][64] score tile row stride
constexpr int kLdp = kBlk + 8;   // bf16 [64][64] probability tile row stride
constexpr float kNegInf = -1e30f;
constexpr float kEmptyLse = 1e30f;
constexpr int kQueryPastEnd = INT_MIN;    // segment id of a query row >= T
constexpr int kKeyPastEnd = INT_MIN + 1;  // segment id of a key row >= T

template <int D>
struct Tiles {
  static_assert(D == 64 || D == 128 || D == 256, "head dim 64, 128 or 256");
  static constexpr int kSlice = D < 128 ? D : 128;      // output columns a warp accumulates
  static constexpr int kColGroups = D / kSlice;
  static constexpr int kWarps = 4 * kColGroups;         // 4 row groups x column groups
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kScoreCols = kBlk / kColGroups;  // score columns a warp computes
  static constexpr int kRows = kBlk / kWarps;           // softmax rows a warp handles
  static constexpr int kLd = D + 8;                     // bf16 [64][D] tile row stride
  static constexpr int kLdo = D + 4;                    // fp32 [64][D] tile row stride
  static constexpr int kTileBf16 = kBlk * kLd * 2;      // bytes
  static constexpr int kTileS = kBlk * kLds * 4;
  static constexpr int kTileP = kBlk * kLdp * 2;
  static constexpr int kTileO = kBlk * kLdo * 4;
  static constexpr int kRowVecs = 4 * kBlk * 4;         // four [64] fp32/int32 arrays
  static constexpr int kFwdSmem = 3 * kTileBf16 + kTileS + kTileP + kTileO + kRowVecs;
  static constexpr int kDqSmem = 4 * kTileBf16 + 2 * kTileS + kTileP + kRowVecs;
  static constexpr int kDkvSmem = 4 * kTileBf16 + 2 * kTileS + 2 * kTileP + kRowVecs;
  static_assert(kDqSmem >= kTileO && kDkvSmem >= kTileO, "the store stage fits");
};

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

// The barrier between a score product and the per-row softmax that reads
// it (and between that and the products that read P or dS): with one
// column group warp w writes and reads rows 16w..16w+15 only.
template <int D>
__device__ __forceinline__ void sync_rows() {
  if constexpr (Tiles<D>::kColGroups == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// 64 rows (tokens t0..t0+63 of head h) of a [B, T, H, D] tensor into a
// shared [64][kLd] tile, zeros past T; with `do_scale` each value is
// multiplied in fp32 and rounded back to bf16.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int b, int T,
                                          int H, int h, int t0, bool do_scale, float scale) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kBlk * kChunks; c += Tiles<D>::kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T) {
      v = *reinterpret_cast<const uint4*>(src + (((size_t)b * T + t0 + r) * H + h) * D + col);
      if (do_scale) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(p[e]);
          p[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * Tiles<D>::kLd + col) = v;
  }
}

// Segment ids of tokens t0..t0+63 of row b into dst, `past_end` past T.
template <int D>
__device__ __forceinline__ void load_seg(int* dst, const int* __restrict__ seg, int b, int T,
                                         int t0, int past_end) {
  for (int i = threadIdx.x; i < kBlk; i += Tiles<D>::kThreads)
    dst[i] = t0 + i < T ? seg[(size_t)b * T + t0 + i] : past_end;
}

// S[r][c] = sum_d A[r][d] * B[c][d] over a 64 x 64 tile: warp (wr, wc)
// computes rows 16 wr .. 16 wr + 15, columns wc * kScoreCols onward.
template <int D>
__device__ __forceinline__ void tile_times_tile_t(float* S, const bf16* A, const bf16* B,
                                                  int warp) {
  using C = Tiles<D>;
  constexpr int kFr = C::kScoreCols / 16;
  const int wr = warp % 4, c0 = (warp / 4) * C::kScoreCols;
  Frag acc[kFr];
#pragma unroll
  for (int nf = 0; nf < kFr; ++nf) wmma::fill_fragment(acc[nf], 0.0f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + wr * 16 * C::kLd + kk, C::kLd);
#pragma unroll
    for (int nf = 0; nf < kFr; ++nf) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
      wmma::load_matrix_sync(bt, B + (c0 + nf * 16) * C::kLd + kk, C::kLd);
      wmma::mma_sync(acc[nf], a, bt, acc[nf]);
    }
  }
#pragma unroll
  for (int nf = 0; nf < kFr; ++nf)
    wmma::store_matrix_sync(S + wr * 16 * kLds + c0 + nf * 16, acc[nf], kLds,
                            wmma::mem_row_major);
}

// The warps' 16 x kSlice accumulator slices through a shared fp32
// [64][kLdo] stage into bf16 rows (times `scale`) of tile t0 of head h of
// a [B, T, H, D] tensor, rows before T only.
template <int D>
__device__ __forceinline__ void store_acc(bf16* __restrict__ dst, float* stage,
                                          Frag (&acc)[Tiles<D>::kSlice / 16], int warp, int b,
                                          int T, int H, int h, int t0, float scale) {
  using C = Tiles<D>;
  const int wr = warp % 4, c0 = (warp / 4) * C::kSlice;
#pragma unroll
  for (int nf = 0; nf < C::kSlice / 16; ++nf)
    wmma::store_matrix_sync(stage + wr * 16 * C::kLdo + c0 + nf * 16, acc[nf], C::kLdo,
                            wmma::mem_row_major);
  __syncthreads();
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kBlk * kChunks; c += C::kThreads) {
    const int r = c / kChunks;
    if (t0 + r >= T) continue;
    const int col = (c % kChunks) * 8;
    const float* s = stage + r * C::kLdo + col;
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) o2[e] = __floats2bfloat162_rn(s[2 * e] * scale, s[2 * e + 1] * scale);
    *reinterpret_cast<uint4*>(dst + (((size_t)b * T + t0 + r) * H + h) * D + col) = o;
  }
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(T/64), Hq, B)
// ---------------------------------------------------------------------------
template <int D, class Range>
__global__ void __launch_bounds__(Tiles<D>::kThreads)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ seg, Range range,
                bf16* __restrict__ out, float* __restrict__ lse, AttnArgs a) {
  using C = Tiles<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBlk * C::kLd;
  bf16* Vs = Ks + kBlk * C::kLd;
  float* Ss = reinterpret_cast<float*>(Vs + kBlk * C::kLd);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + kBlk * kLds);
  float* Os = reinterpret_cast<float*>(Ps + kBlk * kLdp);
  float* m_s = Os + kBlk * C::kLdo;
  float* l_s = m_s + kBlk;
  int* qseg = reinterpret_cast<int*>(l_s + kBlk);
  int* kseg = qseg + kBlk;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int T = a.T;
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % 4, c0 = (warp / 4) * C::kSlice;

  load_tile<D>(Qs, q, b, T, a.Hq, h, iq * kBlk, a.prescale_q, a.scale_q);
  load_seg<D>(qseg, seg, b, T, iq * kBlk, kQueryPastEnd);
  for (int i = threadIdx.x; i < kBlk; i += C::kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < kBlk * C::kLdo; i += C::kThreads) Os[i] = 0.0f;

  const int hi = range.kv_end(b, iq);
  for (int j = range.kv_begin(b, iq); j <= hi; ++j) {
    if (range.skip(b, iq, j)) continue;  // uniform over the block
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Ks, k, b, T, a.Hkv, hk, j * kBlk, false, 1.0f);
    load_tile<D>(Vs, v, b, T, a.Hkv, hk, j * kBlk, false, 1.0f);
    load_seg<D>(kseg, seg, b, T, j * kBlk, kKeyPastEnd);
    __syncthreads();

    tile_times_tile_t<D>(Ss, Qs, Ks, warp);
    sync_rows<D>();
    for (int rr = 0; rr < C::kRows; ++rr) {
      const int r = warp * C::kRows + rr;
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
      for (int d = lane; d < D; d += 32) Os[r * C::kLdo + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
      }
    }
    sync_rows<D>();  // P and the rescaled rows are in place

    Frag o[C::kSlice / 16];
#pragma unroll
    for (int nf = 0; nf < C::kSlice / 16; ++nf)
      wmma::load_matrix_sync(o[nf], Os + wr * 16 * C::kLdo + c0 + nf * 16, C::kLdo,
                             wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBlk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, Ps + wr * 16 * kLdp + kk, kLdp);
#pragma unroll
      for (int nf = 0; nf < C::kSlice / 16; ++nf) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, Vs + kk * C::kLd + c0 + nf * 16, C::kLd);
        wmma::mma_sync(o[nf], pa, bv, o[nf]);
      }
    }
#pragma unroll
    for (int nf = 0; nf < C::kSlice / 16; ++nf)
      wmma::store_matrix_sync(Os + wr * 16 * C::kLdo + c0 + nf * 16, o[nf], C::kLdo,
                              wmma::mem_row_major);
  }
  __syncthreads();

  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kBlk * kChunks; c += C::kThreads) {
    const int r = c / kChunks;
    if (iq * kBlk + r >= T) continue;
    const int col = (c % kChunks) * 8;
    const float l = l_s[r];
    const float* s = Os + r * C::kLdo + col;
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o2[e] = __floats2bfloat162_rn(l > 0.0f ? s[2 * e] / l : 0.0f,
                                    l > 0.0f ? s[2 * e + 1] / l : 0.0f);
    *reinterpret_cast<uint4*>(out + (((size_t)b * T + iq * kBlk + r) * a.Hq + h) * D + col) = o;
  }
  for (int r = threadIdx.x; r < kBlk; r += C::kThreads) {
    if (iq * kBlk + r >= T) continue;
    const float l = l_s[r];
    lse[((size_t)b * a.Hq + h) * T + iq * kBlk + r] = l > 0.0f ? m_s[r] + logf(l) : kEmptyLse;
  }
}

// ---------------------------------------------------------------------------
// dq (and di = sum(dout * out)): grid (ceil(T/64), Hq, B)
// ---------------------------------------------------------------------------
template <int D, class Range>
__global__ void __launch_bounds__(Tiles<D>::kThreads)
attn_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const int* __restrict__ seg, Range range,
               const bf16* __restrict__ out, const bf16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ di, bf16* __restrict__ dq,
               AttnArgs a) {
  using C = Tiles<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kBlk * C::kLd;
  bf16* Ks = dOs + kBlk * C::kLd;
  bf16* Vs = Ks + kBlk * C::kLd;
  float* Ss = reinterpret_cast<float*>(Vs + kBlk * C::kLd);
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
  const int wr = warp % 4, c0 = (warp / 4) * C::kSlice;
  const size_t row0 = ((size_t)b * a.Hq + h) * T + iq * kBlk;  // into lse / di

  load_tile<D>(Qs, q, b, T, a.Hq, h, iq * kBlk, a.prescale_q, a.scale_q);
  load_tile<D>(dOs, dout, b, T, a.Hq, h, iq * kBlk, false, 1.0f);
  load_seg<D>(qseg, seg, b, T, iq * kBlk, kQueryPastEnd);
  for (int i = threadIdx.x; i < kBlk; i += C::kThreads)
    lse_s[i] = iq * kBlk + i < T ? lse[row0 + i] : 0.0f;
  // di = sum_d dout * out in fp32, one warp per row
  for (int rr = 0; rr < C::kRows; ++rr) {
    const int r = warp * C::kRows + rr;
    float acc = 0.0f;
    if (iq * kBlk + r < T) {
      const size_t off = (((size_t)b * T + iq * kBlk + r) * a.Hq + h) * D;
      for (int d = lane; d < D; d += 32)
        acc += __bfloat162float(dout[off + d]) * __bfloat162float(out[off + d]);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      di_s[r] = acc;
      if (iq * kBlk + r < T) di[row0 + r] = acc;
    }
  }

  Frag acc[C::kSlice / 16];
#pragma unroll
  for (int nf = 0; nf < C::kSlice / 16; ++nf) wmma::fill_fragment(acc[nf], 0.0f);

  const int hi = range.kv_end(b, iq);
  for (int j = range.kv_begin(b, iq); j <= hi; ++j) {
    if (range.skip(b, iq, j)) continue;  // uniform over the block
    __syncthreads();
    load_tile<D>(Ks, k, b, T, a.Hkv, hk, j * kBlk, false, 1.0f);
    load_tile<D>(Vs, v, b, T, a.Hkv, hk, j * kBlk, false, 1.0f);
    load_seg<D>(kseg, seg, b, T, j * kBlk, kKeyPastEnd);
    __syncthreads();

    tile_times_tile_t<D>(Ss, Qs, Ks, warp);
    tile_times_tile_t<D>(dPs, dOs, Vs, warp);
    sync_rows<D>();
    for (int rr = 0; rr < C::kRows; ++rr) {
      const int r = warp * C::kRows + rr;
      const int qpos = iq * kBlk + r;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const bool valid = kseg[c] == qseg[r] && j * kBlk + c <= qpos;
        const float p = valid ? expf(Ss[r * kLds + c] * a.s_scale - lse_s[r]) : 0.0f;
        dSs[r * kLdp + c] = __float2bfloat16(p * (dPs[r * kLds + c] - di_s[r]) * a.ds_scale);
      }
    }
    sync_rows<D>();
#pragma unroll
    for (int kk = 0; kk < kBlk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> sa;
      wmma::load_matrix_sync(sa, dSs + wr * 16 * kLdp + kk, kLdp);
#pragma unroll
      for (int nf = 0; nf < C::kSlice / 16; ++nf) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bk;
        wmma::load_matrix_sync(bk, Ks + kk * C::kLd + c0 + nf * 16, C::kLd);
        wmma::mma_sync(acc[nf], sa, bk, acc[nf]);
      }
    }
  }
  __syncthreads();
  store_acc<D>(dq, reinterpret_cast<float*>(smem), acc, warp, b, T, a.Hq, h, iq * kBlk,
               a.dq_scale);
}

// ---------------------------------------------------------------------------
// dk, dv: grid (ceil(T/64), Hkv, B); loops over the Hq/Hkv query heads of
// the kv head and the query tiles j .. q_end(j).
// ---------------------------------------------------------------------------
template <int D, class Range>
__global__ void __launch_bounds__(Tiles<D>::kThreads)
attn_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ seg, Range range,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv,
                AttnArgs a) {
  using C = Tiles<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBlk * C::kLd;
  bf16* Qs = Vs + kBlk * C::kLd;
  bf16* dOs = Qs + kBlk * C::kLd;
  float* Ss = reinterpret_cast<float*>(dOs + kBlk * C::kLd);
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
  const int wr = warp % 4, c0 = (warp / 4) * C::kSlice;

  load_tile<D>(Ks, k, b, T, a.Hkv, hk, j * kBlk, false, 1.0f);
  load_tile<D>(Vs, v, b, T, a.Hkv, hk, j * kBlk, false, 1.0f);
  load_seg<D>(kseg, seg, b, T, j * kBlk, kKeyPastEnd);

  Frag dk_acc[C::kSlice / 16], dv_acc[C::kSlice / 16];
#pragma unroll
  for (int nf = 0; nf < C::kSlice / 16; ++nf) {
    wmma::fill_fragment(dk_acc[nf], 0.0f);
    wmma::fill_fragment(dv_acc[nf], 0.0f);
  }

  const int last = range.q_end(b, j);
  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    for (int iq = j; iq <= last; ++iq) {
      if (range.skip(b, iq, j)) continue;  // uniform over the block
      __syncthreads();  // the previous tile's readers are done
      load_tile<D>(Qs, q, b, T, a.Hq, h, iq * kBlk, a.prescale_q, a.scale_q);
      load_tile<D>(dOs, dout, b, T, a.Hq, h, iq * kBlk, false, 1.0f);
      load_seg<D>(qseg, seg, b, T, iq * kBlk, kQueryPastEnd);
      const size_t row0 = ((size_t)b * a.Hq + h) * T + iq * kBlk;
      for (int i = threadIdx.x; i < kBlk; i += C::kThreads) {
        const bool in = iq * kBlk + i < T;
        lse_s[i] = in ? lse[row0 + i] : 0.0f;
        di_s[i] = in ? di[row0 + i] : 0.0f;
      }
      __syncthreads();

      tile_times_tile_t<D>(Ss, Qs, Ks, warp);    // S[q][c]
      tile_times_tile_t<D>(dPs, dOs, Vs, warp);  // dP[q][c]
      sync_rows<D>();
      for (int rr = 0; rr < C::kRows; ++rr) {
        const int r = warp * C::kRows + rr;
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

      // warp (wr, wc) owns key rows 16 wr.. and columns c0..: dV += P^T dO,
      // dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < kBlk; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> pa, sa;
        wmma::load_matrix_sync(pa, Ps + kk * kLdp + wr * 16, kLdp);
        wmma::load_matrix_sync(sa, dSs + kk * kLdp + wr * 16, kLdp);
#pragma unroll
        for (int nf = 0; nf < C::kSlice / 16; ++nf) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bo, bq;
          wmma::load_matrix_sync(bo, dOs + kk * C::kLd + c0 + nf * 16, C::kLd);
          wmma::mma_sync(dv_acc[nf], pa, bo, dv_acc[nf]);
          wmma::load_matrix_sync(bq, Qs + kk * C::kLd + c0 + nf * 16, C::kLd);
          wmma::mma_sync(dk_acc[nf], sa, bq, dk_acc[nf]);
        }
      }
    }
  }
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem);
  store_acc<D>(dk, stage, dk_acc, warp, b, T, a.Hkv, hk, j * kBlk, 1.0f);
  __syncthreads();
  store_acc<D>(dv, stage, dv_acc, warp, b, T, a.Hkv, hk, j * kBlk, 1.0f);
}

inline int set_smem(const void* fn, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace
