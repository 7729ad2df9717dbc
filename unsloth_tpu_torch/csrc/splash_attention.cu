// Splash attention: causal self-attention with a sliding window, a logit
// softcap, segment ids and GQA, bf16, head dim 64, 128 or 256 (K18).
//
// Replaces the bundled Pallas TPU splash kernels that
// unsloth_tpu/ops/attention.py:_tpu_splash builds in _splash_kernel
// (jax.experimental.pallas.ops.tpu.splash_attention, a CausalMask or a
// LocalMask(window_size=(window - 1, 0)) per kv head):
//   splash_fwd_kernel<D>  <- the forward kernel (out and an fp32
//                            lse = m + log l)
//   splash_dq_kernel<D>   <- the dq kernel (dq; also di = sum(dout * out),
//                            which the JAX wrapper forms outside)
//   splash_dkv_kernel<D>  <- the dk/dv kernel
// Semantics, as _tpu_splash feeds the kernel: q is multiplied by `scale`
// and rounded to bf16 first; s = q_scaled . k in fp32; with a softcap c,
// s' = c * tanh(s / c); token i attends to token j iff j <= i,
// i - j < window (when a window is given) and seg[i] == seg[j]. Every
// output is defined (a token always sees itself). In the backward
// dS' = P * (dP - di), and with a softcap dS = dS' * (1 - tanh^2(s / c));
// dq = scale * (dS @ K), dk = dS^T @ q_scaled, dv = P^T @ dO. The window
// (<= 0: none) and the softcap (<= 0: none) are runtime arguments.
// GQA: JAX runs the kernel per kv head with its query heads stacked; here
// a block reads kv head h / (Hq / Hkv), and the dk/dv block sums its query
// heads in a loop, so the sum is deterministic.
//
// Rounding points: the bundled forward multiplies fp32 P by fp32 V; here P
// is rounded to bf16 before P @ V, as in its backward, which rounds P and
// dS to bf16 before their products. Row statistics stay fp32.
//
// What bounds it on an H100: tensor-core work over the visited tile pairs
// (4 D flops per valid (query, key) pair forward, 10 D backward). A query
// tile visits the kv tiles from the first one its window reaches up to its
// own (causality); a visited pair is skipped when the segment-id ranges of
// its two tiles do not overlap. Both skips are exact: no (query, key) pair
// in a skipped tile pair is valid.
//
// Design, kept simple, in the form of attention_tiles.cuh (which the
// packed and flash kernels share and this file leaves as it is): 64-token
// tiles staged in shared memory, nvcuda::wmma 16x16x16 bf16 MMAs in fp32,
// one block per (64-query tile, head) for the forward and dq and per
// (64-key tile, kv head) for dk/dv. The block has four row groups of 16
// rows times D / kSlice column groups of warps, kSlice = min(D, 128), so
// every warp accumulates a 16 x kSlice slice of a D-wide output: at
// D = 128 and 256, 16 x 128 (8 fragments; dk and dv 16), which keeps the
// dk/dv kernel's accumulators at the Dh-128 kernel's count at D = 256; at
// D = 64 (gpt-oss's sliding layers), four warps that each own all 64
// columns of their 16 rows (4 fragments; dk and dv 8). The score tiles
// are split the same way; the softmax and the masks run one warp per row
// with 2 columns a lane. The forward keeps its running output in shared
// memory (fp32) so a row can be rescaled. At D = 256 a block uses 176-191
// KB of shared memory (dynamic, opted in), so one block runs per SM; at
// D = 64, 71-89 KB. wgmma, TMA and pipelining are later work.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;
using Frag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kBlk = 64;                  // tokens per tile
constexpr int kLds = kBlk + 4;            // fp32 [64][64] score tile row stride
constexpr int kLdp = kBlk + 8;            // bf16 [64][64] probability tile row stride
constexpr float kNegInf = -1e30f;
constexpr float kEmptyLse = 1e30f;
constexpr int kQueryPastEnd = INT_MIN;    // segment id of a query row >= T
constexpr int kKeyPastEnd = INT_MIN + 1;  // segment id of a key row >= T

template <int D>
struct Cfg {
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
  static constexpr int kRowVecs = 4 * kBlk * 4;
  static constexpr int kFwdSmem = 3 * kTileBf16 + kTileS + kTileP + kTileO + kRowVecs;
  static constexpr int kDqSmem = 4 * kTileBf16 + 2 * kTileS + kTileP + kRowVecs;
  static constexpr int kDkvSmem = 4 * kTileBf16 + 2 * kTileS + 2 * kTileP + kRowVecs;
  static_assert(kDqSmem >= kTileO && kDkvSmem >= kTileO, "the store stage fits");
};

// Per-call scalars of the three kernels.
struct SplashArgs {
  int T, Hq, Hkv, nq;   // nq = ceil(T / 64)
  float scale;          // q is multiplied by it (bf16 result); dq by it
  int window;           // <= 0: no window
  float softcap;        // <= 0: no softcap
  float inv_softcap;
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

// First kv tile that query tile iq can see: its window's reach.
__device__ __forceinline__ int kv_first(const SplashArgs& a, int iq) {
  if (a.window <= 0) return 0;
  const long long lo = (long long)iq * kBlk - a.window + 1;
  return lo <= 0 ? 0 : (int)(lo / kBlk);
}

// Last query tile that sees kv tile j: the reach of the window of its last
// key, or the end.
__device__ __forceinline__ int q_last(const SplashArgs& a, int j) {
  if (a.window <= 0) return a.nq - 1;
  const long long hi = ((long long)j * kBlk + kBlk - 1 + a.window - 1) / kBlk;
  return hi < a.nq - 1 ? (int)hi : a.nq - 1;
}

// A (query tile, kv tile) pair whose segment-id ranges do not overlap.
__device__ __forceinline__ bool disjoint(const SplashArgs& a, int b, int iq, int j) {
  const size_t row = (size_t)b * a.nq;
  return a.seg_max[row + j] < a.seg_min[row + iq] || a.seg_min[row + j] > a.seg_max[row + iq];
}

__device__ __forceinline__ bool attends(const SplashArgs& a, int qs, int ks, int qpos, int kpos) {
  return ks == qs && kpos <= qpos && (a.window <= 0 || qpos - kpos < a.window);
}

// 64 rows (tokens t0..t0+63 of head h) of a [B, T, H, D] tensor into a
// shared [64][kLd] tile, zeros past T; with `do_scale` each value is
// multiplied in fp32 and rounded back to bf16.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int b, int T,
                                          int H, int h, int t0, bool do_scale, float scale) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kBlk * kChunks; c += Cfg<D>::kThreads) {
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
    *reinterpret_cast<uint4*>(dst + r * Cfg<D>::kLd + col) = v;
  }
}

// Segment ids of tokens t0..t0+63 of row b into dst, `past_end` past T.
template <int D>
__device__ __forceinline__ void load_seg(int* dst, const int* __restrict__ seg, int b, int T,
                                         int t0, int past_end) {
  for (int i = threadIdx.x; i < kBlk; i += Cfg<D>::kThreads)
    dst[i] = t0 + i < T ? seg[(size_t)b * T + t0 + i] : past_end;
}

// S[r][c] = sum_d A[r][d] * B[c][d] over a 64 x 64 tile: warp (wr, wc)
// computes rows 16 wr .. 16 wr + 15, columns wc * kScoreCols onward.
template <int D>
__device__ __forceinline__ void tile_times_tile_t(float* S, const bf16* A, const bf16* B,
                                                  int warp) {
  using C = Cfg<D>;
  constexpr int kFr = C::kScoreCols / 16;
  const int wr = warp % 4, c0 = (warp / 4) * C::kScoreCols;
  Frag acc[kFr];
#pragma unroll
  for (int nf = 0; nf < kFr; ++nf) wmma::fill_fragment(acc[nf], 0.0f);
#pragma unroll 4
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, A + wr * 16 * C::kLd + kk, C::kLd);
#pragma unroll
    for (int nf = 0; nf < kFr; ++nf) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, B + (c0 + nf * 16) * C::kLd + kk, C::kLd);
      wmma::mma_sync(acc[nf], fa, fb, acc[nf]);
    }
  }
#pragma unroll
  for (int nf = 0; nf < kFr; ++nf)
    wmma::store_matrix_sync(S + wr * 16 * kLds + c0 + nf * 16, acc[nf], kLds,
                            wmma::mem_row_major);
}

// The warps' 16 x kSlice accumulator slices through a shared fp32 [64][kLdo]
// stage into bf16 rows (times `scale`) of tile t0 of head h of a
// [B, T, H, D] tensor, rows before T only.
template <int D>
__device__ __forceinline__ void store_acc(bf16* __restrict__ dst, float* stage,
                                          Frag (&acc)[Cfg<D>::kSlice / 16], int warp, int b,
                                          int T, int H, int h, int t0, float scale) {
  using C = Cfg<D>;
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
    for (int e = 0; e < 4; ++e)
      o2[e] = __floats2bfloat162_rn(s[2 * e] * scale, s[2 * e + 1] * scale);
    *reinterpret_cast<uint4*>(dst + (((size_t)b * T + t0 + r) * H + h) * D + col) = o;
  }
}

// ---------------------------------------------------------------------------
// forward: grid (nq, Hq, B)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
splash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ seg,
                  bf16* __restrict__ out, float* __restrict__ lse, SplashArgs a) {
  using C = Cfg<D>;
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

  load_tile<D>(Qs, q, b, T, a.Hq, h, iq * kBlk, true, a.scale);
  load_seg<D>(qseg, seg, b, T, iq * kBlk, kQueryPastEnd);
  for (int i = threadIdx.x; i < kBlk; i += C::kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < kBlk * C::kLdo; i += C::kThreads) Os[i] = 0.0f;

  for (int j = kv_first(a, iq); j <= iq; ++j) {
    if (disjoint(a, b, iq, j)) continue;  // uniform over the block
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Ks, k, b, T, a.Hkv, hk, j * kBlk, false, 1.0f);
    load_tile<D>(Vs, v, b, T, a.Hkv, hk, j * kBlk, false, 1.0f);
    load_seg<D>(kseg, seg, b, T, j * kBlk, kKeyPastEnd);
    __syncthreads();

    tile_times_tile_t<D>(Ss, Qs, Ks, warp);
    __syncthreads();
    for (int rr = 0; rr < C::kRows; ++rr) {
      const int r = warp * C::kRows + rr;
      const int qpos = iq * kBlk + r;
      float s[2];
      bool ok[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        float x = Ss[r * kLds + c];
        if (a.softcap > 0.0f) x = a.softcap * tanhf(x * a.inv_softcap);
        s[half] = x;
        ok[half] = attends(a, qseg[r], kseg[c], qpos, j * kBlk + c);
      }
      const float mx = warp_max(fmaxf(ok[0] ? s[0] : kNegInf, ok[1] ? s[1] : kNegInf));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      const float p0 = ok[0] ? expf(s[0] - m_new) : 0.0f;
      const float p1 = ok[1] ? expf(s[1] - m_new) : 0.0f;
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
    __syncthreads();  // P and the rescaled rows are in place

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
    uint4 ov;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o2[e] = __floats2bfloat162_rn(l > 0.0f ? s[2 * e] / l : 0.0f,
                                    l > 0.0f ? s[2 * e + 1] / l : 0.0f);
    *reinterpret_cast<uint4*>(out + (((size_t)b * T + iq * kBlk + r) * a.Hq + h) * D + col) = ov;
  }
  for (int r = threadIdx.x; r < kBlk; r += C::kThreads) {
    if (iq * kBlk + r >= T) continue;
    const float l = l_s[r];
    lse[((size_t)b * a.Hq + h) * T + iq * kBlk + r] = l > 0.0f ? m_s[r] + logf(l) : kEmptyLse;
  }
}

// P and dS of one (query row r, key column c) pair from the raw score x,
// dP, the row's lse and di: dS = P (dP - di), times 1 - tanh^2 when capped.
__device__ __forceinline__ void prob_and_ds(const SplashArgs& a, bool ok, float x, float dp,
                                            float row_lse, float row_di, float* p, float* ds) {
  float t = 0.0f;
  if (a.softcap > 0.0f) {
    t = tanhf(x * a.inv_softcap);
    x = a.softcap * t;
  }
  const float pv = ok ? expf(x - row_lse) : 0.0f;
  float d = pv * (dp - row_di);
  if (a.softcap > 0.0f) d *= 1.0f - t * t;
  *p = pv;
  *ds = d;
}

// ---------------------------------------------------------------------------
// dq (and di = sum(dout * out)): grid (nq, Hq, B)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
splash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg,
                 const bf16* __restrict__ out, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ di, bf16* __restrict__ dq,
                 SplashArgs a) {
  using C = Cfg<D>;
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

  load_tile<D>(Qs, q, b, T, a.Hq, h, iq * kBlk, true, a.scale);
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

  for (int j = kv_first(a, iq); j <= iq; ++j) {
    if (disjoint(a, b, iq, j)) continue;  // uniform over the block
    __syncthreads();
    load_tile<D>(Ks, k, b, T, a.Hkv, hk, j * kBlk, false, 1.0f);
    load_tile<D>(Vs, v, b, T, a.Hkv, hk, j * kBlk, false, 1.0f);
    load_seg<D>(kseg, seg, b, T, j * kBlk, kKeyPastEnd);
    __syncthreads();

    tile_times_tile_t<D>(Ss, Qs, Ks, warp);
    tile_times_tile_t<D>(dPs, dOs, Vs, warp);
    __syncthreads();
    for (int rr = 0; rr < C::kRows; ++rr) {
      const int r = warp * C::kRows + rr;
      const int qpos = iq * kBlk + r;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const bool ok = attends(a, qseg[r], kseg[c], qpos, j * kBlk + c);
        float p, ds;
        prob_and_ds(a, ok, Ss[r * kLds + c], dPs[r * kLds + c], lse_s[r], di_s[r], &p, &ds);
        dSs[r * kLdp + c] = __float2bfloat16(ds);
      }
    }
    __syncthreads();
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
  store_acc<D>(dq, reinterpret_cast<float*>(smem), acc, warp, b, T, a.Hq, h, iq * kBlk, a.scale);
}

// ---------------------------------------------------------------------------
// dk, dv: grid (nq, Hkv, B); loops over the Hq/Hkv query heads of the kv
// head and the query tiles j .. q_last(j).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
splash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ seg,
                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv,
                  SplashArgs a) {
  using C = Cfg<D>;
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

  const int last = q_last(a, j);
  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    for (int iq = j; iq <= last; ++iq) {
      if (disjoint(a, b, iq, j)) continue;  // uniform over the block
      __syncthreads();  // the previous tile's readers are done
      load_tile<D>(Qs, q, b, T, a.Hq, h, iq * kBlk, true, a.scale);
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
      __syncthreads();
      for (int rr = 0; rr < C::kRows; ++rr) {
        const int r = warp * C::kRows + rr;
        const int qpos = iq * kBlk + r;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = lane + 32 * half;
          const bool ok = attends(a, qseg[r], kseg[c], qpos, j * kBlk + c);
          float p, ds;
          prob_and_ds(a, ok, Ss[r * kLds + c], dPs[r * kLds + c], lse_s[r], di_s[r], &p, &ds);
          Ps[r * kLdp + c] = __float2bfloat16(p);
          dSs[r * kLdp + c] = __float2bfloat16(ds);
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

SplashArgs splash_args(int T, int Hq, int Hkv, float scale, int window, float softcap,
                       const void* seg_min, const void* seg_max) {
  return SplashArgs{T, Hq, Hkv, (T + kBlk - 1) / kBlk, scale, window, softcap,
                    softcap > 0.0f ? 1.0f / softcap : 0.0f,
                    static_cast<const int*>(seg_min), static_cast<const int*>(seg_max)};
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* seg, void* out,
               void* lse, int B, SplashArgs a, cudaStream_t stream) {
  int e = set_smem(reinterpret_cast<const void*>(splash_fwd_kernel<D>), Cfg<D>::kFwdSmem);
  if (e) return e;
  splash_fwd_kernel<D><<<dim3(a.nq, a.Hq, B), Cfg<D>::kThreads, Cfg<D>::kFwdSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<bf16*>(out), static_cast<float*>(lse), a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* seg, const void* out,
              const void* dout, const void* lse, void* di, void* dq, int B, SplashArgs a,
              cudaStream_t stream) {
  int e = set_smem(reinterpret_cast<const void*>(splash_dq_kernel<D>), Cfg<D>::kDqSmem);
  if (e) return e;
  splash_dq_kernel<D><<<dim3(a.nq, a.Hq, B), Cfg<D>::kThreads, Cfg<D>::kDqSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<float*>(di),
      static_cast<bf16*>(dq), a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* seg, const void* dout,
               const void* lse, const void* di, void* dk, void* dv, int B, SplashArgs a,
               cudaStream_t stream) {
  int e = set_smem(reinterpret_cast<const void*>(splash_dkv_kernel<D>), Cfg<D>::kDkvSmem);
  if (e) return e;
  splash_dkv_kernel<D><<<dim3(a.nq, a.Hkv, B), Cfg<D>::kThreads, Cfg<D>::kDkvSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward on `stream`: out [B, T, Hq, D] bf16 and lse [B, Hq, T] fp32 from
// q [B, T, Hq, D], k, v [B, T, Hkv, D] bf16, segment ids [B, T] int32 and
// their per-64-token-tile min / max [B, ceil(T/64)] int32. D is 64, 128 or 256,
// Hq % Hkv == 0, pointers 16-byte aligned (the wrapper checks); window <= 0
// and softcap <= 0 mean none. Returns the CUDA error code (0 if none).
extern "C" int unsloth_splash_attn_fwd(const void* q, const void* k, const void* v,
                                       const void* seg, const void* seg_min,
                                       const void* seg_max, void* out, void* lse, int B, int T,
                                       int Hq, int Hkv, int D, float scale, int window,
                                       float softcap, void* stream) {
  const SplashArgs a = splash_args(T, Hq, Hkv, scale, window, softcap, seg_min, seg_max);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_fwd<64>(q, k, v, seg, out, lse, B, a, s);
  if (D == 128) return launch_fwd<128>(q, k, v, seg, out, lse, B, a, s);
  if (D == 256) return launch_fwd<256>(q, k, v, seg, out, lse, B, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dq on `stream`: dq [B, T, Hq, D] bf16 and di [B, Hq, T] fp32 (for the
// dk/dv kernel) from the forward's inputs, its out and lse, and dout.
extern "C" int unsloth_splash_attn_dq(const void* q, const void* k, const void* v,
                                      const void* seg, const void* seg_min, const void* seg_max,
                                      const void* out, const void* dout, const void* lse,
                                      void* di, void* dq, int B, int T, int Hq, int Hkv, int D,
                                      float scale, int window, float softcap, void* stream) {
  const SplashArgs a = splash_args(T, Hq, Hkv, scale, window, softcap, seg_min, seg_max);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_dq<64>(q, k, v, seg, out, dout, lse, di, dq, B, a, s);
  if (D == 128) return launch_dq<128>(q, k, v, seg, out, dout, lse, di, dq, B, a, s);
  if (D == 256) return launch_dq<256>(q, k, v, seg, out, dout, lse, di, dq, B, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dk, dv on `stream`: [B, T, Hkv, D] bf16 from the forward's inputs, lse,
// dout and the di that the dq kernel wrote.
extern "C" int unsloth_splash_attn_dkv(const void* q, const void* k, const void* v,
                                       const void* seg, const void* seg_min,
                                       const void* seg_max, const void* dout, const void* lse,
                                       const void* di, void* dk, void* dv, int B, int T, int Hq,
                                       int Hkv, int D, float scale, int window, float softcap,
                                       void* stream) {
  const SplashArgs a = splash_args(T, Hq, Hkv, scale, window, softcap, seg_min, seg_max);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_dkv<64>(q, k, v, seg, dout, lse, di, dk, dv, B, a, s);
  if (D == 128) return launch_dkv<128>(q, k, v, seg, dout, lse, di, dk, dv, B, a, s);
  if (D == 256) return launch_dkv<256>(q, k, v, seg, dout, lse, di, dk, dv, B, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
