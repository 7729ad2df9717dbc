// The flash attention kernels' own Hopper parts (flash_fwd.cu, flash_dq.cu,
// flash_dkv.cu, which hold K16, with kSplash K18, and with the forward's
// kSinks K17's forward, whose backward is K16's): their per-call
// values, the 4-D TMA load of a [B, T, H, D] tensor, the tile-pair classes
// and the walks' bounds, the kv ring's producer, the softcap and q's
// rounding, the accumulator-to-A-fragment packing and the host-side
// [B, T, H, D] map. The generic blocks (mbarriers, wgmma, swizzled
// descriptors, tensor maps) are hopper_common.cuh's; everything here lives
// in namespace hflash, which sees hopper's names.
//
// kSplash (a template parameter of every kernel and of the helpers that
// differ) adds K18's rules to K16's: q multiplied by `scale` and rounded to
// bf16 in shared memory after its TMA load, the logit softcap
// s' = c tanh(s / c) in the consumers' registers, the sliding window
// (i - j < window) and GRPO's prefix layout (P, G, L) as tile rules and
// element masks. Every such branch is `if constexpr`, so K16's
// instantiations (kSplash false) are the code they were before K18 joined.
// kSinks (the forward's third template parameter) adds K17's epilogue alone:
// the per-head sink logit joins the softmax normaliser; K17's dq and dk/dv
// are K16's kernels fed the sink-inclusive lse.
//
// Registers 8 kk .. 8 kk + 7 of a wgmma accumulator (hopper_common.cuh has
// its layout), packed to bf16 pairs, are the A fragment of a k16 step kk of
// a product with A from registers (score tile times V, dS times K, ...).

#pragma once

#include <climits>

#include "hopper_common.cuh"

namespace hopper {

template <>
struct Wgmma<16> {
  // d (+)= A * B^T, A [64 x 16] and B [16 x 16] K-major in shared memory
  // (K18's dk/dv at D = 256: one warpgroup's 16 queries of a stage)
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(a), "l"(b), "r"(acc));
  }
};

}  // namespace hopper

namespace hflash {

using namespace hopper;

using bf16 = __nv_bfloat16;

constexpr int kQueryPastEnd = INT_MIN;    // segment id of a query row >= T
constexpr int kKeyPastEnd = INT_MIN + 1;  // segment id of a key row >= T
constexpr float kEmptyLse = 1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Classes of a visited (query tile, kv tile) pair, and the index of each in
// the optional tile-pair counters.
constexpr int kSkip = 0;    // the tiles' segment-id ranges are disjoint
constexpr int kFull = 1;    // every (query, key) pair is valid: no mask
constexpr int kMasked = 2;  // the per-element test runs

// Per-call values of the three kernels (fields a kernel does not use are
// null).
struct Params {
  const int* seg;      // [B, T] segment ids
  const int* seg_min;  // [B, n64] per-64-token-tile min / max segment id
  const int* seg_max;
  const bf16* out;     // forward output (dq: di)
  const bf16* dout;
  const float* lse;    // [B, Hq, T]
  const float* di;     // [B, Hq, T] (dk/dv)
  bf16* o;             // forward kernel: out, lse
  float* lse_out;
  float* di_out;       // dq kernel: di, dq
  bf16* dq;
  bf16* dk;            // dk/dv kernel: dk, dv, or fp32 partials per slice
  bf16* dv;
  float* part;
  int* counts;         // [3] tile-pair classes visited, or null
  int B, T, Hq, Hkv, n64, nsplit;
  // K16: sm_scale, sm_scale * log2(e). K18: the factor q is rounded by
  // (and dq multiplied by), and the scores' factor to log2 units: log2(e),
  // or 1 with a softcap (softcap_log2 returns log2 units)
  float scale, scale_log2;
  int causal;
  // K18 only: the window (0: none), the prefix layout (G = 0: none), the
  // softcap c (0: none) as 2 log2(e) / c and c log2(e)
  int window, P, G, L;
  float cap, cap_k, cap_l;
  // K17's forward only: the sink logits, fp32 [Hq] (appended last, so that
  // the fields the other kernels read keep their offsets)
  const float* sinks;
};

// One [rows][64] box of a 4-D [B, T, H, D] tensor map at (column c0, head h,
// token t0, row b) into shared memory; rows past T arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int h, int t0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(h), "r"(t0),
      "r"(b)
      : "memory");
}

// 2^x by the special-function unit (ex2.approx: ~2 ulp; 2^-inf = +0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 1 / x by the special-function unit (rcp.approx: ~1 ulp; 1 / inf = +0).
__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// K18's softcapped score c tanh(s / c) in log2 units (times log2(e)), and
// through r the softcap's derivative 1 - tanh^2 = 4 r (1 - r): tanh(x) =
// 1 - 2 r with r = 1 / (1 + e^(2x)), by ex2 and rcp, whose error is
// absolute (~1e-7 of c), not relative as tanh.approx's 2^-11 would be.
__device__ __forceinline__ float softcap_log2(const Params& p, float s, float& r) {
  r = fast_rcp(1.0f + fast_exp2(s * p.cap_k));
  return fmaf(-2.0f * p.cap_l, r, p.cap_l);
}

// `bytes` of bf16 at `base` multiplied by `scale` in fp32 and rounded back
// (K18's q_scaled = bf16(q * scale)), 16 bytes a thread from thread `t` of
// `n`; the caller fences (fence_proxy_async) and syncs before wgmma reads
// them.
__device__ __forceinline__ void scale_bf16(unsigned char* base, int bytes, int t, int n,
                                           float scale) {
  for (int u = t * 16; u < bytes; u += n * 16) {
    uint4 v = *reinterpret_cast<uint4*>(base + u);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      h[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(base + u) = v;
  }
}

// The accumulator's columns 16 kk .. 16 kk + 15 as the A fragment of step kk.
template <int N>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&d)[N], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// What a_frag's rounding leaves of columns 16 kk .. 16 kk + 15, d - bf16(d),
// as a second A fragment: the two products together carry d to ~16 bits.
template <int N>
__device__ __forceinline__ void a_frag_lo(uint32_t (&a)[4], const float (&d)[N], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float x0 = d[8 * kk + 2 * r], x1 = d[8 * kk + 2 * r + 1];
    a[r] = pack_bf16(x0 - __bfloat162float(__float2bfloat16_rn(x0)),
                     x1 - __bfloat162float(__float2bfloat16_rn(x1)));
  }
}


// --- tile-pair classes ---------------------------------------------------------

// Min and max segment id of tokens t0 .. t0 + len - 1 (t0 < T) of row b,
// from the per-64-token entries that span them (the min of mins and the
// max of maxes: the exact range).
__device__ __forceinline__ int2 seg_span(const Params& p, int b, int t0, int len) {
  const int first = t0 / 64, last = min((t0 + len - 1) / 64, p.n64 - 1);
  const int* mn = p.seg_min + (size_t)b * p.n64;
  const int* mx = p.seg_max + (size_t)b * p.n64;
  int lo = mn[first], hi = mx[first];
  for (int e = first + 1; e <= last; ++e) {
    lo = min(lo, mn[e]);
    hi = max(hi, mx[e]);
  }
  return make_int2(lo, hi);
}

// First slot of the completion region of slot t >= P (K18's prefix layout).
__device__ __forceinline__ int region_start(const Params& p, int t) {
  return p.P + (t - p.P) / p.L * p.L;
}

// The class of the pair (queries q0 .. q0 + bq - 1, keys k0 .. k0 + bk - 1)
// of row b: skip when the segment-id ranges are disjoint (no valid pair);
// full when both tiles lie wholly before T, hold one segment id, the same,
// and, causal, the keys end at or before the first query; else masked.
// K18 (causal) adds: skip when the nearest pair is outside the window
// (q0 - (k0 + bk - 1) >= window) or, under the prefix layout, when the kv
// tile lies wholly past the prompt and before the region of the query
// tile's first query past the prompt; full only if, besides, the farthest
// pair is inside the window and the kv tile lies wholly in the prompt or
// both tiles in one region. Every skip is exact; a full pair holds only
// valid pairs.
template <bool kSplash>
__device__ __forceinline__ int pair_class(const Params& p, int b, int q0, int bq, int k0,
                                          int bk) {
  const int2 qs = seg_span(p, b, q0, bq), ks = seg_span(p, b, k0, bk);
  if (ks.y < qs.x || ks.x > qs.y) return kSkip;
  if constexpr (kSplash) {
    if (p.window > 0 && q0 - (k0 + bk - 1) >= p.window) return kSkip;
    if (p.G > 0 && k0 >= p.P && k0 + bk - 1 < region_start(p, max(q0, p.P))) return kSkip;
  }
  if (q0 + bq <= p.T && k0 + bk <= p.T && qs.x == qs.y && ks.x == ks.y && qs.x == ks.x &&
      (!p.causal || k0 + bk - 1 <= q0)) {
    if constexpr (kSplash) {
      if (p.window > 0 && q0 + bq - 1 - k0 >= p.window) return kMasked;
      if (p.G > 0 && k0 + bk > p.P &&
          (k0 < p.P || region_start(p, k0) != region_start(p, q0 + bq - 1)))
        return kMasked;
    }
    return kFull;
  }
  return kMasked;
}

// First kv tile (bk keys) of the forward's and dq's walk for query tile
// q0: 0, or with K18's window the first one it reaches.
template <bool kSplash>
__device__ __forceinline__ int kv_first(const Params& p, int q0, int bk) {
  if constexpr (kSplash) {
    if (p.window > 0) return max(0, q0 - p.window + 1) / bk;
  }
  return 0;
}

// One past the last query tile (bq queries) of the dk/dv walk for kv tile
// k0 (bk keys): nq, or with K18's window the tile of the last query its
// last key reaches, and under the prefix layout, for a kv tile wholly past
// the prompt, the tile of the end of its last key's region (a prompt kv
// tile is seen by every query after it).
template <bool kSplash>
__device__ __forceinline__ int q_end(const Params& p, int k0, int bk, int bq, int nq) {
  if constexpr (kSplash) {
    const int kl = min(k0 + bk - 1, p.T - 1);
    int end = INT_MAX;
    if (p.window > 0) end = kl + p.window - 1;
    if (p.G > 0 && k0 >= p.P) end = min(end, region_start(p, kl) + p.L - 1);
    return min(nq, end / bq + 1);
  }
  return nq;
}

// The kv ring's producer of the forward and dq kernels, run by their
// loading warp: walks kv tiles kv_first .. last (kBk keys each, kSub 64-column
// sub-tiles of 128 bytes a row) against query tile q0 (kBq rows) of row b
// and kv head hk, and classes each pair (pair_class). A skipped pair is
// never loaded. For every other pair it takes the next stage s of the
// kStages-deep ring once its consumers have emptied it, writes the keys'
// segment ids (sentinels past T) and (kv tile, class) beside it, and loads
// K and V into it by TMA, completing full[s]. The walk ends with the
// sentinel (-1, 0) in the next stage; the classes are added to p.counts,
// when given, once a block.
template <int kBq, int kBk, int kStages, int kSub, bool kSplash>
__device__ __forceinline__ void produce_kv_ring(const Params& p, int b, int q0, int hk, int last,
                                                int lane, const CUtensorMap* tk,
                                                const CUtensorMap* tv, unsigned char* Ks,
                                                unsigned char* Vs, int* kseg, int2* info,
                                                uint64_t* full, uint64_t* empty) {
  constexpr int kKSub = kBk * 128, kKBytes = kSub * kKSub;
  int n_skip = 0, n_full = 0, n_masked = 0, it = 0;
  for (int j = kv_first<kSplash>(p, q0, kBk); j <= last; ++j) {
    const int cls = pair_class<kSplash>(p, b, q0, kBq, j * kBk, kBk);
    n_skip += cls == kSkip;
    n_full += cls == kFull;
    n_masked += cls == kMasked;
    if (cls == kSkip) continue;
    const int s = it % kStages, use = it / kStages;
    if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
    for (int i = lane; i < kBk; i += 32) {
      const int t = j * kBk + i;
      kseg[s * kBk + i] = t < p.T ? p.seg[(size_t)b * p.T + t] : kKeyPastEnd;
    }
    if (lane == 0) info[s] = make_int2(j, cls);
    __syncwarp();
    if (lane == 0) {
      mbar_expect_tx(&full[s], 2 * kKBytes);
      for (int c = 0; c < kSub; ++c) {
        tma_load(Ks + s * kKBytes + c * kKSub, tk, &full[s], c * 64, hk, j * kBk, b);
        tma_load(Vs + s * kKBytes + c * kKSub, tv, &full[s], c * 64, hk, j * kBk, b);
      }
    }
    ++it;
  }
  const int s = it % kStages, use = it / kStages;
  if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
  if (lane == 0) {
    info[s] = make_int2(-1, 0);  // the end of the walk
    mbar_arrive(&full[s]);
    if (p.counts != nullptr) {
      atomicAdd(p.counts + kSkip, n_skip);
      atomicAdd(p.counts + kFull, n_full);
      atomicAdd(p.counts + kMasked, n_masked);
    }
  }
}

// The 4-D map (D, H, T, B) of a [B, T, H, D] bf16 tensor with a box of 64
// columns x 1 head x `rows` tokens x 1, 128-byte swizzle, zeros past T.
// Returns a CUDA error code.
inline int bthd_map(CUtensorMap* map, const void* ptr, int B, int T, int H, int D, int rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)T * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

inline Params make_params(const void* seg, const void* seg_min, const void* seg_max, int B,
                          int T, int Hq, int Hkv, float scale, bool causal, void* counts) {
  Params p{};
  p.seg = static_cast<const int*>(seg);
  p.seg_min = static_cast<const int*>(seg_min);
  p.seg_max = static_cast<const int*>(seg_max);
  p.counts = static_cast<int*>(counts);
  p.B = B;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.n64 = (T + 63) / 64;
  p.nsplit = 1;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal ? 1 : 0;
  return p;
}

// K18's values: K16's, with q rounded by `scale`, the window (<= 0: none),
// the prefix layout (G = 0: none) and the softcap (<= 0: none).
inline Params make_splash_params(const void* seg, const void* seg_min, const void* seg_max,
                                 int B, int T, int Hq, int Hkv, float scale, bool causal,
                                 void* counts, int window, float softcap, int P, int G, int L) {
  Params p = make_params(seg, seg_min, seg_max, B, T, Hq, Hkv, scale, causal, counts);
  p.window = window > 0 ? window : 0;
  p.G = G > 0 ? G : 0;
  p.P = P;
  p.L = L;
  p.cap = softcap > 0.0f ? softcap : 0.0f;
  p.cap_k = softcap > 0.0f ? 2.0f * kLog2e / softcap : 0.0f;
  p.cap_l = softcap > 0.0f ? softcap * kLog2e : 0.0f;
  p.scale_log2 = softcap > 0.0f ? 1.0f : kLog2e;
  return p;
}

// The forward's forms: K16's, K18's (kSplash) and K17's (kSinks).
enum class FwdForm { kFlash, kSplash, kSinks };

// The launchers of flash_fwd.cu, flash_dq.cu and flash_dkv.cu, called by
// flash_attention.cu's entry points (K16), splash_attention.cu's (K18,
// `splash`) and flash_sinks.cu's (K17: the forward's kSinks form, K16's dq
// and dk/dv); each returns a CUDA error code.
int flash_fwd(int D, FwdForm form, const void* q, const void* k, const void* v, Params p,
              cudaStream_t s);
int flash_dq(int D, bool splash, const void* q, const void* k, const void* v, const void* dout,
             Params p, cudaStream_t s);
int flash_dkv(int D, bool splash, const void* q, const void* k, const void* v,
              const void* dout, Params p, cudaStream_t s);

}  // namespace hflash
