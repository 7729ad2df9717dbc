// The flash attention kernels' own Hopper parts (K16: flash_fwd.cu,
// flash_dq.cu, flash_dkv.cu): their per-call values, the 4-D TMA load of a
// [B, T, H, D] tensor, the tile-pair classes, the kv ring's producer, the
// accumulator-to-A-fragment packing and the host-side [B, T, H, D] map. The
// generic blocks (mbarriers, wgmma, swizzled descriptors, tensor maps) are
// hopper_common.cuh's; everything here lives in namespace hflash, which
// sees hopper's names.
//
// Registers 8 kk .. 8 kk + 7 of a wgmma accumulator (hopper_common.cuh has
// its layout), packed to bf16 pairs, are the A fragment of a k16 step kk of
// a product with A from registers (score tile times V, dS times K, ...).

#pragma once

#include <climits>

#include "hopper_common.cuh"

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
  float scale, scale_log2;  // sm_scale, sm_scale * log2(e)
  int causal;
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

// The accumulator's columns 16 kk .. 16 kk + 15 as the A fragment of step kk.
template <int N>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&d)[N], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
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

// The class of the pair (queries q0 .. q0 + bq - 1, keys k0 .. k0 + bk - 1)
// of row b: skip when the segment-id ranges are disjoint (no valid pair);
// full when both tiles lie wholly before T, hold one segment id, the same,
// and, causal, the keys end at or before the first query; else masked.
__device__ __forceinline__ int pair_class(const Params& p, int b, int q0, int bq, int k0,
                                          int bk) {
  const int2 qs = seg_span(p, b, q0, bq), ks = seg_span(p, b, k0, bk);
  if (ks.y < qs.x || ks.x > qs.y) return kSkip;
  if (q0 + bq <= p.T && k0 + bk <= p.T && qs.x == qs.y && ks.x == ks.y && qs.x == ks.x &&
      (!p.causal || k0 + bk - 1 <= q0))
    return kFull;
  return kMasked;
}

// The kv ring's producer of the forward and dq kernels, run by their
// loading warp: walks kv tiles 0 .. last (kBk keys each, kSub 64-column
// sub-tiles of 128 bytes a row) against query tile q0 (kBq rows) of row b
// and kv head hk, and classes each pair (pair_class). A skipped pair is
// never loaded. For every other pair it takes the next stage s of the
// kStages-deep ring once its consumers have emptied it, writes the keys'
// segment ids (sentinels past T) and (kv tile, class) beside it, and loads
// K and V into it by TMA, completing full[s]. The walk ends with the
// sentinel (-1, 0) in the next stage; the classes are added to p.counts,
// when given, once a block.
template <int kBq, int kBk, int kStages, int kSub>
__device__ __forceinline__ void produce_kv_ring(const Params& p, int b, int q0, int hk, int last,
                                                int lane, const CUtensorMap* tk,
                                                const CUtensorMap* tv, unsigned char* Ks,
                                                unsigned char* Vs, int* kseg, int2* info,
                                                uint64_t* full, uint64_t* empty) {
  constexpr int kKSub = kBk * 128, kKBytes = kSub * kKSub;
  int n_skip = 0, n_full = 0, n_masked = 0, it = 0;
  for (int j = 0; j <= last; ++j) {
    const int cls = pair_class(p, b, q0, kBq, j * kBk, kBk);
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

// The launchers of flash_fwd.cu, flash_dq.cu and flash_dkv.cu, called by
// flash_attention.cu's entry points; each returns a CUDA error code.
int flash_fwd(int D, const void* q, const void* k, const void* v, Params p, cudaStream_t s);
int flash_dq(int D, const void* q, const void* k, const void* v, const void* dout, Params p,
             cudaStream_t s);
int flash_dkv(int D, const void* q, const void* k, const void* v, const void* dout, Params p,
              cudaStream_t s);

}  // namespace hflash
