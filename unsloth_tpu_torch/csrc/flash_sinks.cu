// Flash attention with attention sinks: causal self-attention with segment
// ids, GQA and a learned per-head sink logit in the softmax normalizer,
// bf16, head dim 64 (gpt-oss), K17.
//
// Replaces the bundled Pallas TPU flash kernels that
// unsloth_tpu/ops/attention.py:_tpu_flash_sinks drives
// (jax.experimental.pallas.ops.tpu.flash_attention):
//   sinks_fwd_kernel  <- _flash_attention_impl with its residuals (l, m),
//                        and the wrapper's sink rescale folded into the
//                        epilogue: m' = max(m, s), l' = l e^{m-m'} + e^{s-m'},
//                        out = o (l e^{m-m'}) / l', lse' = m' + log l'
//   sinks_dq_kernel   <- _flash_attention_bwd_dq on (l', m'); also
//                        di = sum(dout * out), which the JAX wrapper forms
//   sinks_dkv_kernel  <- _flash_attention_bwd_dkv on (l', m')
// The sink is an extra softmax logit with no value, so with lse' the
// bundled backward's p' = exp(score - lse') is the sink-softmax probability
// and dS = p' (dP - di) the exact gradient; dsinks_h = -sum_{b,t}
// e^{s_h - lse'} di, a plain reduction in the wrapper (as in JAX).
// Semantics, as the bundled kernels take them: the score is q . k in fp32
// times sm_scale; token i attends to token j iff j <= i and their segment
// ids are equal; dq = scale dS K, dk = scale dS^T Q, dv = P^T dO, dk and dv
// summed over each kv head's query heads (in a loop: deterministic).
//
// Rounding points: P and dS are rounded to bf16 before their products, as
// in the bundled backward; row statistics and the sink stay fp32; the
// forward's rescale by the sink is applied to the fp32 running output
// before its one rounding to bf16 (JAX rounds o, then rescales and rounds
// again).
//
// What bounds it on an H100: tensor-core work over the valid (query, key)
// pairs: 4 D flops per pair forward, 6 D for dq, 8 D for dk/dv. A query
// tile visits the kv tiles up to its own (causality), and a tile pair whose
// segment-id ranges do not overlap is skipped (exact: no valid pair in it),
// so on packed rows the work follows sum(len_i^2), not T^2.
//
// Design: the form of splash_attention.cu (K18), kept in its own source so
// that K16 and K18 compile as before, specialised to head dim 64, which
// neither K16 (128) nor K18 (128, 256) is built for: 64-token tiles in
// shared memory, one block of four warps per (64-query tile, query head)
// for the forward and dq and per (64-key tile, kv head) for dk/dv, each
// warp owning 16 rows of every 64-wide tile, nvcuda::wmma 16x16x16 bf16
// MMAs with fp32 accumulators, the softmax one warp per row with 2 columns
// a lane, the forward's running output in shared memory (fp32) so a row can
// be rescaled. wgmma, TMA and pipelining are later work.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;
using Frag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kD = 64;                    // head dim
constexpr int kBlk = 64;                  // tokens per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kBlk / kWarps;      // softmax rows a warp handles
constexpr int kLd = kD + 8;               // bf16 [64][64] tile row stride
constexpr int kLds = kBlk + 4;            // fp32 [64][64] tile row stride
constexpr int kFr = kD / 16;              // fragments across a 64-wide tile
constexpr float kNegInf = -1e30f;
constexpr int kQueryPastEnd = INT_MIN;    // segment id of a query row >= T
constexpr int kKeyPastEnd = INT_MIN + 1;  // segment id of a key row >= T

constexpr int kTileBf16 = kBlk * kLd * 2;  // bytes
constexpr int kTileF32 = kBlk * kLds * 4;
constexpr int kRowVecs = 4 * kBlk * 4;
constexpr int kFwdSmem = 4 * kTileBf16 + 2 * kTileF32 + kRowVecs;
constexpr int kDqSmem = 5 * kTileBf16 + 2 * kTileF32 + kRowVecs;
constexpr int kDkvSmem = 6 * kTileBf16 + 2 * kTileF32 + kRowVecs;

// Per-call scalars of the three kernels.
struct SinksArgs {
  int T, Hq, Hkv, nq;   // nq = ceil(T / 64)
  float scale;          // sm_scale: multiplies the fp32 score
  const int* seg_min;   // [B, nq] per-tile min segment id
  const int* seg_max;   // [B, nq] per-tile max segment id
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

// A (query tile, kv tile) pair whose segment-id ranges do not overlap.
__device__ __forceinline__ bool disjoint(const SinksArgs& a, int b, int iq, int j) {
  const size_t row = (size_t)b * a.nq;
  return a.seg_max[row + j] < a.seg_min[row + iq] || a.seg_min[row + j] > a.seg_max[row + iq];
}

// 64 rows (tokens t0..t0+63 of head h) of a [B, T, H, 64] tensor into a
// shared [64][kLd] tile, zeros past T.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int b, int T,
                                          int H, int h, int t0) {
  constexpr int kChunks = kD / 8;
  for (int c = threadIdx.x; c < kBlk * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T) v = *reinterpret_cast<const uint4*>(src + (((size_t)b * T + t0 + r) * H + h) * kD + col);
    *reinterpret_cast<uint4*>(dst + r * kLd + col) = v;
  }
}

__device__ __forceinline__ void load_seg(int* dst, const int* __restrict__ seg, int b, int T,
                                         int t0, int past_end) {
  for (int i = threadIdx.x; i < kBlk; i += kThreads)
    dst[i] = t0 + i < T ? seg[(size_t)b * T + t0 + i] : past_end;
}

// S[r][c] = sum_d A[r][d] B[c][d] over a 64 x 64 tile; warp w computes
// rows 16 w .. 16 w + 15.
__device__ __forceinline__ void tile_times_tile_t(float* S, const bf16* A, const bf16* B,
                                                  int warp) {
  Frag acc[kFr];
#pragma unroll
  for (int nf = 0; nf < kFr; ++nf) wmma::fill_fragment(acc[nf], 0.0f);
#pragma unroll
  for (int kk = 0; kk < kD; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, A + warp * 16 * kLd + kk, kLd);
#pragma unroll
    for (int nf = 0; nf < kFr; ++nf) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, B + nf * 16 * kLd + kk, kLd);
      wmma::mma_sync(acc[nf], fa, fb, acc[nf]);
    }
  }
#pragma unroll
  for (int nf = 0; nf < kFr; ++nf)
    wmma::store_matrix_sync(S + warp * 16 * kLds + nf * 16, acc[nf], kLds, wmma::mem_row_major);
}

// acc[r][:] += sum_k P[k][r] * X[k][:] (P^T X, col-major A) when
// `transpose`, else sum_k P[r][k] * X[k][:], for warp w's 16 rows.
template <bool kTranspose>
__device__ __forceinline__ void tile_times_tile(Frag (&acc)[kFr], const bf16* P, const bf16* X,
                                                int warp) {
  using Layout = typename std::conditional<kTranspose, wmma::col_major, wmma::row_major>::type;
#pragma unroll
  for (int kk = 0; kk < kBlk; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, Layout> pa;
    if (kTranspose)
      wmma::load_matrix_sync(pa, P + kk * kLd + warp * 16, kLd);
    else
      wmma::load_matrix_sync(pa, P + warp * 16 * kLd + kk, kLd);
#pragma unroll
    for (int nf = 0; nf < kFr; ++nf) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bx;
      wmma::load_matrix_sync(bx, X + kk * kLd + nf * 16, kLd);
      wmma::mma_sync(acc[nf], pa, bx, acc[nf]);
    }
  }
}

// The warps' accumulators through a shared fp32 [64][kLds] stage into bf16
// rows (times `scale`) of tile t0 of head h of a [B, T, H, 64] tensor.
__device__ __forceinline__ void store_acc(bf16* __restrict__ dst, float* stage,
                                          Frag (&acc)[kFr], int warp, int b, int T, int H, int h,
                                          int t0, float scale) {
#pragma unroll
  for (int nf = 0; nf < kFr; ++nf)
    wmma::store_matrix_sync(stage + warp * 16 * kLds + nf * 16, acc[nf], kLds,
                            wmma::mem_row_major);
  __syncthreads();
  constexpr int kChunks = kD / 8;
  for (int c = threadIdx.x; c < kBlk * kChunks; c += kThreads) {
    const int r = c / kChunks;
    if (t0 + r >= T) continue;
    const int col = (c % kChunks) * 8;
    const float* s = stage + r * kLds + col;
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) o2[e] = __floats2bfloat162_rn(s[2 * e] * scale, s[2 * e + 1] * scale);
    *reinterpret_cast<uint4*>(dst + (((size_t)b * T + t0 + r) * H + h) * kD + col) = o;
  }
}

// ---------------------------------------------------------------------------
// forward: grid (nq, Hq, B)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sinks_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg,
                 const float* __restrict__ sinks, bf16* __restrict__ out,
                 float* __restrict__ lse, SinksArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBlk * kLd;
  bf16* Vs = Ks + kBlk * kLd;
  bf16* Ps = Vs + kBlk * kLd;
  float* Ss = reinterpret_cast<float*>(Ps + kBlk * kLd);
  float* Os = Ss + kBlk * kLds;
  float* m_s = Os + kBlk * kLds;
  float* l_s = m_s + kBlk;
  int* qseg = reinterpret_cast<int*>(l_s + kBlk);
  int* kseg = qseg + kBlk;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int T = a.T;
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile(Qs, q, b, T, a.Hq, h, iq * kBlk);
  load_seg(qseg, seg, b, T, iq * kBlk, kQueryPastEnd);
  for (int i = threadIdx.x; i < kBlk; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < kBlk * kLds; i += kThreads) Os[i] = 0.0f;

  for (int j = 0; j <= iq; ++j) {
    if (disjoint(a, b, iq, j)) continue;  // uniform over the block
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, k, b, T, a.Hkv, hk, j * kBlk);
    load_tile(Vs, v, b, T, a.Hkv, hk, j * kBlk);
    load_seg(kseg, seg, b, T, j * kBlk, kKeyPastEnd);
    __syncthreads();

    tile_times_tile_t(Ss, Qs, Ks, warp);
    __syncthreads();
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = warp * kRows + rr;
      const int qpos = iq * kBlk + r;
      float s[2];
      bool ok[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = lane + 32 * hf;
        s[hf] = Ss[r * kLds + c] * a.scale;
        ok[hf] = kseg[c] == qseg[r] && j * kBlk + c <= qpos;
      }
      const float mx = warp_max(fmaxf(ok[0] ? s[0] : kNegInf, ok[1] ? s[1] : kNegInf));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      const float p0 = ok[0] ? expf(s[0] - m_new) : 0.0f;
      const float p1 = ok[1] ? expf(s[1] - m_new) : 0.0f;
      const float sum = warp_sum(p0 + p1);
      Ps[r * kLd + lane] = __float2bfloat16(p0);
      Ps[r * kLd + lane + 32] = __float2bfloat16(p1);
      for (int d = lane; d < kD; d += 32) Os[r * kLds + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
      }
    }
    __syncthreads();  // P and the rescaled rows are in place

    Frag o[kFr];
#pragma unroll
    for (int nf = 0; nf < kFr; ++nf)
      wmma::load_matrix_sync(o[nf], Os + warp * 16 * kLds + nf * 16, kLds, wmma::mem_row_major);
    tile_times_tile<false>(o, Ps, Vs, warp);
#pragma unroll
    for (int nf = 0; nf < kFr; ++nf)
      wmma::store_matrix_sync(Os + warp * 16 * kLds + nf * 16, o[nf], kLds, wmma::mem_row_major);
  }
  __syncthreads();

  // the sink joins the normalizer: m' = max(m, s), l' = l e^{m-m'} + e^{s-m'}
  const float sink = sinks[h];
  for (int r = threadIdx.x; r < kBlk; r += kThreads) {
    const float m2 = fmaxf(m_s[r], sink);
    const float l2 = l_s[r] * expf(m_s[r] - m2) + expf(sink - m2);
    // Os / l2 * e^{m-m'} = o (l e^{m-m'}) / l'
    m_s[r] = expf(m_s[r] - m2) / l2;
    if (iq * kBlk + r < T) lse[((size_t)b * a.Hq + h) * T + iq * kBlk + r] = m2 + logf(l2);
  }
  __syncthreads();
  constexpr int kChunks = kD / 8;
  for (int c = threadIdx.x; c < kBlk * kChunks; c += kThreads) {
    const int r = c / kChunks;
    if (iq * kBlk + r >= T) continue;
    const int col = (c % kChunks) * 8;
    const float f = m_s[r];
    const float* s = Os + r * kLds + col;
    uint4 ov;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
    for (int e = 0; e < 4; ++e) o2[e] = __floats2bfloat162_rn(s[2 * e] * f, s[2 * e + 1] * f);
    *reinterpret_cast<uint4*>(out + (((size_t)b * T + iq * kBlk + r) * a.Hq + h) * kD + col) = ov;
  }
}

// ---------------------------------------------------------------------------
// dq (and di = sum(dout * out)): grid (nq, Hq, B)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sinks_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ seg,
                const bf16* __restrict__ out, const bf16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ di, bf16* __restrict__ dq,
                SinksArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kBlk * kLd;
  bf16* Ks = dOs + kBlk * kLd;
  bf16* Vs = Ks + kBlk * kLd;
  bf16* dSs = Vs + kBlk * kLd;
  float* Ss = reinterpret_cast<float*>(dSs + kBlk * kLd);
  float* dPs = Ss + kBlk * kLds;
  float* lse_s = dPs + kBlk * kLds;
  float* di_s = lse_s + kBlk;
  int* qseg = reinterpret_cast<int*>(di_s + kBlk);
  int* kseg = qseg + kBlk;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int T = a.T;
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = ((size_t)b * a.Hq + h) * T + iq * kBlk;  // into lse / di

  load_tile(Qs, q, b, T, a.Hq, h, iq * kBlk);
  load_tile(dOs, dout, b, T, a.Hq, h, iq * kBlk);
  load_seg(qseg, seg, b, T, iq * kBlk, kQueryPastEnd);
  for (int i = threadIdx.x; i < kBlk; i += kThreads)
    lse_s[i] = iq * kBlk + i < T ? lse[row0 + i] : 0.0f;
  for (int rr = 0; rr < kRows; ++rr) {
    const int r = warp * kRows + rr;
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

  Frag acc[kFr];
#pragma unroll
  for (int nf = 0; nf < kFr; ++nf) wmma::fill_fragment(acc[nf], 0.0f);

  for (int j = 0; j <= iq; ++j) {
    if (disjoint(a, b, iq, j)) continue;  // uniform over the block
    __syncthreads();
    load_tile(Ks, k, b, T, a.Hkv, hk, j * kBlk);
    load_tile(Vs, v, b, T, a.Hkv, hk, j * kBlk);
    load_seg(kseg, seg, b, T, j * kBlk, kKeyPastEnd);
    __syncthreads();

    tile_times_tile_t(Ss, Qs, Ks, warp);
    tile_times_tile_t(dPs, dOs, Vs, warp);
    __syncthreads();
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = warp * kRows + rr;
      const int qpos = iq * kBlk + r;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = lane + 32 * hf;
        const bool ok = kseg[c] == qseg[r] && j * kBlk + c <= qpos;
        const float p = ok ? expf(Ss[r * kLds + c] * a.scale - lse_s[r]) : 0.0f;
        dSs[r * kLd + c] = __float2bfloat16(p * (dPs[r * kLds + c] - di_s[r]));
      }
    }
    __syncthreads();
    tile_times_tile<false>(acc, dSs, Ks, warp);
  }
  __syncthreads();
  store_acc(dq, reinterpret_cast<float*>(smem), acc, warp, b, T, a.Hq, h, iq * kBlk, a.scale);
}

// ---------------------------------------------------------------------------
// dk, dv: grid (nq, Hkv, B); loops over the Hq/Hkv query heads of the kv
// head and the query tiles from its own to the last.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sinks_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg,
                 const bf16* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 SinksArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBlk * kLd;
  bf16* Qs = Vs + kBlk * kLd;
  bf16* dOs = Qs + kBlk * kLd;
  bf16* Ps = dOs + kBlk * kLd;
  bf16* dSs = Ps + kBlk * kLd;
  float* Ss = reinterpret_cast<float*>(dSs + kBlk * kLd);
  float* dPs = Ss + kBlk * kLds;
  float* lse_s = dPs + kBlk * kLds;
  float* di_s = lse_s + kBlk;
  int* qseg = reinterpret_cast<int*>(di_s + kBlk);
  int* kseg = qseg + kBlk;

  const int j = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int T = a.T;
  const int group = a.Hq / a.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile(Ks, k, b, T, a.Hkv, hk, j * kBlk);
  load_tile(Vs, v, b, T, a.Hkv, hk, j * kBlk);
  load_seg(kseg, seg, b, T, j * kBlk, kKeyPastEnd);

  Frag dk_acc[kFr], dv_acc[kFr];
#pragma unroll
  for (int nf = 0; nf < kFr; ++nf) {
    wmma::fill_fragment(dk_acc[nf], 0.0f);
    wmma::fill_fragment(dv_acc[nf], 0.0f);
  }

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    for (int iq = j; iq < a.nq; ++iq) {
      if (disjoint(a, b, iq, j)) continue;  // uniform over the block
      __syncthreads();  // the previous tile's readers are done
      load_tile(Qs, q, b, T, a.Hq, h, iq * kBlk);
      load_tile(dOs, dout, b, T, a.Hq, h, iq * kBlk);
      load_seg(qseg, seg, b, T, iq * kBlk, kQueryPastEnd);
      const size_t row0 = ((size_t)b * a.Hq + h) * T + iq * kBlk;
      for (int i = threadIdx.x; i < kBlk; i += kThreads) {
        const bool in = iq * kBlk + i < T;
        lse_s[i] = in ? lse[row0 + i] : 0.0f;
        di_s[i] = in ? di[row0 + i] : 0.0f;
      }
      __syncthreads();

      tile_times_tile_t(Ss, Qs, Ks, warp);    // S[q][c]
      tile_times_tile_t(dPs, dOs, Vs, warp);  // dP[q][c]
      __syncthreads();
      for (int rr = 0; rr < kRows; ++rr) {
        const int r = warp * kRows + rr;
        const int qpos = iq * kBlk + r;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int c = lane + 32 * hf;
          const bool ok = kseg[c] == qseg[r] && j * kBlk + c <= qpos;
          const float p = ok ? expf(Ss[r * kLds + c] * a.scale - lse_s[r]) : 0.0f;
          Ps[r * kLd + c] = __float2bfloat16(p);
          dSs[r * kLd + c] = __float2bfloat16(p * (dPs[r * kLds + c] - di_s[r]));
        }
      }
      __syncthreads();  // every query row of P and dS is written
      // warp w owns key rows 16 w..: dV += P^T dO, dK += dS^T Q
      tile_times_tile<true>(dv_acc, Ps, dOs, warp);
      tile_times_tile<true>(dk_acc, dSs, Qs, warp);
    }
  }
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem);
  store_acc(dk, stage, dk_acc, warp, b, T, a.Hkv, hk, j * kBlk, a.scale);
  __syncthreads();
  store_acc(dv, stage, dv_acc, warp, b, T, a.Hkv, hk, j * kBlk, 1.0f);
}

inline int set_smem(const void* fn, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

SinksArgs sinks_args(int T, int Hq, int Hkv, float scale, const void* seg_min,
                     const void* seg_max) {
  return SinksArgs{T, Hq, Hkv, (T + kBlk - 1) / kBlk, scale, static_cast<const int*>(seg_min),
                   static_cast<const int*>(seg_max)};
}

}  // namespace

// Forward on `stream`: out [B, T, Hq, 64] bf16 and lse' [B, Hq, T] fp32 (the
// logsumexp with the sink) from q [B, T, Hq, 64], k, v [B, T, Hkv, 64]
// bf16, segment ids [B, T] int32 with their per-64-token-tile min / max
// [B, ceil(T/64)] int32, and sinks [Hq] fp32. Hq % Hkv == 0, pointers
// 16-byte aligned (the wrapper checks). Returns the CUDA error code.
extern "C" int unsloth_flash_sinks_fwd(const void* q, const void* k, const void* v,
                                       const void* seg, const void* seg_min,
                                       const void* seg_max, const void* sinks, void* out,
                                       void* lse, int B, int T, int Hq, int Hkv, float scale,
                                       void* stream) {
  const SinksArgs a = sinks_args(T, Hq, Hkv, scale, seg_min, seg_max);
  int e = set_smem(reinterpret_cast<const void*>(sinks_fwd_kernel), kFwdSmem);
  if (e) return e;
  sinks_fwd_kernel<<<dim3(a.nq, Hq, B), kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<const float*>(sinks), static_cast<bf16*>(out),
      static_cast<float*>(lse), a);
  return static_cast<int>(cudaGetLastError());
}

// dq on `stream`: dq [B, T, Hq, 64] bf16 and di [B, Hq, T] fp32 from the
// forward's inputs, its out and lse', and dout.
extern "C" int unsloth_flash_sinks_dq(const void* q, const void* k, const void* v,
                                      const void* seg, const void* seg_min, const void* seg_max,
                                      const void* out, const void* dout, const void* lse,
                                      void* di, void* dq, int B, int T, int Hq, int Hkv,
                                      float scale, void* stream) {
  const SinksArgs a = sinks_args(T, Hq, Hkv, scale, seg_min, seg_max);
  int e = set_smem(reinterpret_cast<const void*>(sinks_dq_kernel), kDqSmem);
  if (e) return e;
  sinks_dq_kernel<<<dim3(a.nq, Hq, B), kThreads, kDqSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<float*>(di),
      static_cast<bf16*>(dq), a);
  return static_cast<int>(cudaGetLastError());
}

// dk, dv on `stream`: [B, T, Hkv, 64] bf16 from the forward's inputs, lse',
// dout and the di that the dq kernel wrote.
extern "C" int unsloth_flash_sinks_dkv(const void* q, const void* k, const void* v,
                                       const void* seg, const void* seg_min,
                                       const void* seg_max, const void* dout, const void* lse,
                                       const void* di, void* dk, void* dv, int B, int T, int Hq,
                                       int Hkv, float scale, void* stream) {
  const SinksArgs a = sinks_args(T, Hq, Hkv, scale, seg_min, seg_max);
  int e = set_smem(reinterpret_cast<const void*>(sinks_dkv_kernel), kDkvSmem);
  if (e) return e;
  sinks_dkv_kernel<<<dim3(a.nq, Hkv, B), kThreads, kDkvSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), a);
  return static_cast<int>(cudaGetLastError());
}
