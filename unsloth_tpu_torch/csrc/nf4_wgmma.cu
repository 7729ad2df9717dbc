// NF4 matmul forward (K1) for Hopper at more than 16 rows:
// y[M, N] = x[M, K] @ dequant(W)[N, K]^T, bf16 x and y, NF4 W.
//
// Replaces the TPU kernel unsloth_tpu/ops/qlora_matmul.py:_fwd_kernel
// (launched by _fwd_pallas, public entry nf4_matmul) wherever the rows are
// not a decode batch; nf4_matmul.cu keeps nf4_matmul_kernel<16> for M <= 16
// and holds the C entry point that picks between the two. Same arithmetic
// as that kernel: each weight is NF4_CODE[nibble] * absmax in fp32,
// rounded once to bf16; products summed in fp32; each output rounded once
// to bf16. Same split-half bytes (unsloth_tpu/ops/nf4.py): byte [n, j]
// holds W[n, j] in its high nibble and W[n, j + K/2] in its low nibble.
//
// What bounds it on an H100: tensor-core work, 2 M N K operations (gate/up
// at M = 8,192: 0.97 ms against 0.10 ms of bytes), provided the NF4 decode
// keeps up with the products and the x tiles with both.
//
// Design. The product is computed transposed, y^T = W x^T, in the form of
// Hopper's mixed-input products: W is wgmma's A operand, decoded straight
// from the packed bytes into registers, and x is the B operand, read from
// shared memory. The decoded W never touches shared memory, and each
// decoded weight feeds BX (256) rows of x, so the decode costs one weight
// per 512 operations.
//   - Persistent grid, one 384-thread block per SM, in clusters of two. A
//     tile is BX rows of x by 128 rows of W (128 output columns); a
//     cluster takes a unit of two tiles side by side, the same BX rows of
//     x against W tiles 2 p and 2 p + 1 (one per CTA; past N, where the W
//     tiles are odd in number, the second is computed and not stored).
//     Units are numbered with the W pairs fastest and dealt to the
//     clusters in turn, so the clusters in flight share an x tile in L2
//     and walk W in the same order. The next unit's loads are in flight
//     during a unit's epilogue.
//   - Producer warp (warpgroup 2, one thread a CTA): a ring of kStages
//     stages by TMA. A stage is 32 packed bytes of each of the tile's 128
//     W rows ([128][32] u8, 32-byte swizzle) and the two x boxes the bytes
//     pair with: columns 32 st.. (high nibbles) and K/2 + 32 st.. (low
//     nibbles), [BX][32] bf16 each, 64-byte swizzle. Each CTA loads half
//     of each x box and multicasts it to both CTAs of the cluster, which
//     halves the x tiles' share of the L2 traffic (x is 16 of a stage's 18
//     bytes a row); a consumer warp hands a stage back to both CTAs'
//     producers, since either writes it next. Rows past M or N arrive as
//     zeros.
//   - Two consumer warpgroups, each 64 W rows. A thread decodes its
//     fragment of the stage (two rows, 16 bytes of each) through the
//     16-entry fp32 codebook in shared memory, scales by its rows' absmax
//     (loaded one stage ahead) and packs bf16 pairs in wgmma's A-fragment
//     order; then four wgmma.m64nBXk16 products per stage (two k steps a
//     side), fp32 accumulators in registers (BX / 2 a thread). The A
//     fragments are double-buffered: the next stage is decoded while the
//     current products run (wgmma.wait_group 1 frees the buffer and hands
//     the previous stage back to the producer).
//   - Epilogue: the accumulators (y^T) are rounded once to bf16 and stored
//     transposed into a [BX][64] staging tile by stmatrix.trans (128-byte
//     swizzle), then by one TMA store, which clips rows past M and columns
//     past N; where N is not a multiple of 8 (no TMA map), by masked
//     element stores.
// The 32-byte stage keeps the traps of the split-half layout out of the
// walk: K/2 is a multiple of 32, so no stage crosses K/2 (at gpt-oss's K =
// 2,880, K/2 = 1,440 = 45 stages): a stage's high-nibble x columns never
// reach the low side's real columns, no zero-filled byte past K/2 is ever
// decoded (NF4 code 0 is -1.0, not 0), and each side of a stage lies in one
// absmax block (a 64-block holds two 32-column stages on either side).
// Rows past N decode with absmax 0 and are never stored.
//
// The FP8 forward (K12) runs the same kernel, nf4_wgmma_kernel<BX, true>,
// with the e4m3 weight format as its policy (fp8_matmul.cu's entry point
// picks it by shape, unsloth_fp8_wgmma_launch). Replaces
// unsloth_tpu/ops/fp8_matmul.py:_fwd_kernel (launched by _fwd_pallas) above
// 16 rows: W [N, K] float8_e4m3fn, fp32 scales [ceil(N/B), ceil(K/B)].
// A stage is 32 bytes of each W row (32 weights, one a byte) against one x
// box [BX][32], not two nibble sides, so a stage is 20 KB and the ring
// holds 8. A thread decodes its fragment by the hardware cvt (e4m3x2 ->
// f16x2, exact), multiplies by the block's scale in fp32 and rounds once
// to bf16: the TPU kernel's arithmetic. With B a multiple of 32 a warp's
// 16 rows share a scale row and a stage lies in one scale column, so the
// scale is one value a stage; rows past N read the last scale row and
// decode TMA's zero bytes to 0. K % 16 == 0 (the maps' strides); the
// kernel's parameters are K1's, with B in the flags word (bit 0: TMA
// store, the rest B), so K1's form keeps its code.
//
// The NF4 backward (K2), nf4_dx_wgmma_kernel<BX> below, is this kernel's
// sibling: dx^T = W^T g^T, the NF4 bytes decoded into the A fragments, g
// the K-major B operand; the FP8 backward (K13) is K2's kernel in its e4m3
// form, nf4_dx_wgmma_kernel<BX, true>. See their own note. The grouped
// expert forward (K14) and backward (K15) are K1's and K2's kernels under a
// grouped schedule, nf4_gmm_wgmma_kernel<BX> and nf4_gmm_dx_wgmma_kernel<BX>.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper_common.cuh"

namespace nf4w {
namespace {

using namespace hopper;

__constant__ float kCode[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

constexpr int kThreads = 384;  // two consumer warpgroups, then the producer's
constexpr int kBw = 128;       // W rows (output columns) of a tile
constexpr int kStep = 32;      // packed bytes of a W row a stage
constexpr int kStages = 4;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Slots of the optional counters.
constexpr int kCntTiles = 0;   // output tiles stored
constexpr int kCntStages = 1;  // their stages

// kFp8: K12's e4m3 form (one x box a stage, eight stages), else K1's.
template <int BX, bool kFp8 = false>
struct Cfg {
  static constexpr int kStages = kFp8 ? 8 : ::nf4w::kStages;
  static constexpr int kXBytes = BX * kStep * 2;  // one side's x box, [BX][32] bf16
  static constexpr int kXHalf = kXBytes / 2;      // the rows one CTA loads
  static constexpr int kWBytes = kBw * kStep;     // the packed bytes, [128][32] u8
  static constexpr int kStageBytes = (kFp8 ? 1 : 2) * kXBytes + kWBytes;
  static constexpr int kOutBytes = BX * 128;      // a warpgroup's [BX][64] bf16 result
  static constexpr int kOffOut = kStages * kStageBytes;
  static constexpr int kOffBar = kOffOut + 2 * kOutBytes;
  static constexpr int kSmem = kOffBar + 2 * kStages * 8 + 1024;  // + alignment
  static_assert(kStageBytes % 1024 == 0, "stages stay 1,024-byte aligned");
};

// A 64-byte-swizzled K-major operand (rows of 64 bytes, 8-row groups 512
// bytes apart) from `saddr`.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// tma_load_2d's box written at the same offset of both CTAs of the
// cluster, completing the mbarrier at `bar`'s offset in each.
__device__ __forceinline__ void tma_load_2d_both(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "h"(static_cast<uint16_t>(3))
      : "memory");
}

template <int N>
__device__ __forceinline__ void fence_u32(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int BX>
struct Rs;

// d += A * B^T: A [64 x 16] bf16 in registers (a0..a3 of wgmma's A
// fragment), B [BX x 16] K-major in shared memory.
template <>
struct Rs<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(acc));
  }
};

template <>
struct Rs<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(acc));
  }
};

// Two bf16 values of a W row from one 16-bit pair of packed bytes (columns
// 2c and 2c + 1 of a k step, the lower column in the low half): the high
// nibbles (the first half of the row) or the low ones (the second half),
// code * absmax in fp32, rounded once.
__device__ __forceinline__ uint32_t decode_hi(uint32_t u, float a, const float* code) {
  return pack_bf16(code[(u >> 4) & 15] * a, code[u >> 12] * a);
}
__device__ __forceinline__ uint32_t decode_lo(uint32_t u, float a, const float* code) {
  return pack_bf16(code[u & 15] * a, code[(u >> 8) & 15] * a);
}

// A thread's A fragments of one stage: a[4 k + ...] the high-nibble side's
// k step k (k = 0, 1), a[8 + 4 k + ...] the low side's, each {row r,
// columns 2c..; row r + 8, columns 2c..; row r, columns 2c + 8..; row r +
// 8, columns 2c + 8..} of wgmma's A layout. `w` is the stage's [128][32]
// packed bytes (32-byte swizzle: the 16-byte half h of row r sits at half
// h ^ ((r >> 2) & 1)); s = {absmax high side rows r, r + 8; low side rows
// r, r + 8}.
__device__ __forceinline__ void decode_stage(const unsigned char* w, int r, int c,
                                             const float (&s)[4], const float* code,
                                             uint32_t (&a)[16]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows r, r + 8
      const int row = r + 8 * h;
      const unsigned char* p = w + row * kStep + ((16 * k) ^ (((row >> 2) & 1) << 4)) + 2 * c;
      const uint32_t u0 = *reinterpret_cast<const uint16_t*>(p);
      const uint32_t u1 = *reinterpret_cast<const uint16_t*>(p + 8);
      a[4 * k + h] = decode_hi(u0, s[h], code);
      a[4 * k + 2 + h] = decode_hi(u1, s[h], code);
      a[8 + 4 * k + h] = decode_lo(u0, s[2 + h], code);
      a[8 + 4 * k + 2 + h] = decode_lo(u1, s[2 + h], code);
    }
  }
}

// Two weights of a W row from one 16-bit pair of e4m3 bytes (the lower
// column in the low byte) as fp32: the hardware cvt to f16 (exact),
// widened.
__device__ __forceinline__ float2 e4m3x2_float2(uint32_t u) {
  const __half2_raw h =
      __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(u & 0xFFFFu), __NV_E4M3);
  return __half22float2(__half2(h));
}

// The pair as two bf16 weights: fp32 times the block's scale, rounded once.
__device__ __forceinline__ uint32_t decode_e4m3(uint32_t u, float s) {
  const float2 f = e4m3x2_float2(u);
  return pack_bf16(f.x * s, f.y * s);
}

// K12's A fragments of one stage: a[4 k + ...] k step k (k = 0, 1) in
// decode_stage's order, from the stage's [128][32] e4m3 bytes (the same
// 32-byte swizzle), every weight scaled by `s`.
__device__ __forceinline__ void decode_stage_e4m3(const unsigned char* w, int r, int c, float s,
                                                  uint32_t (&a)[16]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows r, r + 8
      const int row = r + 8 * h;
      const unsigned char* p = w + row * kStep + ((16 * k) ^ (((row >> 2) & 1) << 4)) + 2 * c;
      a[4 * k + h] = decode_e4m3(*reinterpret_cast<const uint16_t*>(p), s);
      a[4 * k + 2 + h] = decode_e4m3(*reinterpret_cast<const uint16_t*>(p + 8), s);
    }
  }
}

// Hand stage `s` back to both CTAs' producers, once per consumer warp.
__device__ __forceinline__ void release(uint64_t* empty, int s, int lane, int rank) {
  __syncwarp();
  if (lane == 0) {
    mbar_arrive(&empty[s]);
    mbar_arrive_cluster(&empty[s], rank ^ 1);
  }
}

// The absmax of a thread's rows (pa, pb; null past N) for stage st: the
// high side's block st / 2, the low side's (K/2 + 32 st) / 64.
__device__ __forceinline__ void load_scales(float (&s)[4], const float* pa, const float* pb,
                                            int st, int half) {
  const int bh = st >> 1, bl = (half + st * kStep) >> 6;
  s[0] = pa != nullptr ? __ldg(pa + bh) : 0.0f;
  s[1] = pb != nullptr ? __ldg(pb + bh) : 0.0f;
  s[2] = pa != nullptr ? __ldg(pa + bl) : 0.0f;
  s[3] = pb != nullptr ? __ldg(pb + bl) : 0.0f;
}

template <int BX, bool kFp8 = false>
__global__ void __launch_bounds__(kThreads, 1)
    nf4_wgmma_kernel(const __grid_constant__ CUtensorMap tx,  // x [M, K], box 32 x BX / 2
                     const __grid_constant__ CUtensorMap tw,  // packed [N, K/2] u8, box 32 x 128
                                                              // (K12: e4m3 [N, K])
                     const __grid_constant__ CUtensorMap ty,  // y [M, N], box 64 x BX (tma_store)
                     const float* __restrict__ absmax, bf16* __restrict__ y,
                     int* __restrict__ counts, int M, int N, int K, int flags) {
  using C = Cfg<BX, kFp8>;
  constexpr int kWOff = (kFp8 ? 1 : 2) * C::kXBytes;  // the W bytes in a stage
  // K1: `flags` is the TMA-store switch. K12: bit 0 is, the rest is the
  // scale block B, and `absmax` is the fp32 scales [ceil(N/B), ceil(K/B)].
  const int tma_store = kFp8 ? flags & 1 : flags;
  const int block = kFp8 ? flags >> 1 : 64;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float code[16];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  uint64_t* empty = full + C::kStages;
  const int half = K / 2;
  const int nst = kFp8 ? (K + kStep - 1) / kStep : half / kStep;
  const int pairs_n = ((N + kBw - 1) / kBw + 1) / 2;  // W tile pairs
  const int units = ((M + BX - 1) / BX) * pairs_n;
  const int rank = static_cast<int>(cluster_rank());
  const int cluster = blockIdx.x / 2, clusters = gridDim.x / 2;
  if (threadIdx.x < 16) code[threadIdx.x] = kCode[threadIdx.x];
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 16);  // one arrival per consumer warp of both CTAs
    }
    fence_barrier_init();
  }
  cluster_sync();  // both CTAs' barriers and codebooks are initialised

  // warpgroup 2 produces; the index is made warp-uniform (a shuffle from
  // lane 0) so that the compiler sees each branch taken by whole warpgroups
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 2) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int u = cluster; u < units; u += clusters) {
      // this CTA's half of the x rows and its W tile, both moved inside the
      // tensors where they lie past them (their rows of y are not stored)
      const int xr = min((u / pairs_n) * BX + rank * (BX / 2), M - 1);
      const int n0 = min((2 * (u % pairs_n) + rank) * kBw, N - 1);
      for (int st = 0; st < nst; ++st, ++it) {
        const int s = it % C::kStages;
        if (it >= C::kStages) mbar_wait(&empty[s], ((it / C::kStages) - 1) & 1);
        unsigned char* slot = smem + s * C::kStageBytes;
        mbar_expect_tx(&full[s], C::kStageBytes);
        tma_load_2d_both(slot + rank * C::kXHalf, &tx, &full[s], st * kStep, xr);
        if constexpr (!kFp8)
          tma_load_2d_both(slot + C::kXBytes + rank * C::kXHalf, &tx, &full[s],
                           half + st * kStep, xr);
        tma_load_2d(slot + kWOff, &tw, &full[s], st * kStep, n0);
      }
    }
    // stay until both CTAs' consumers have handed back every stage, so no
    // arrival or multicast from the other CTA finds this one gone
    for (int i = 0; i < C::kStages; ++i, ++it)
      if (it >= C::kStages) mbar_wait(&empty[it % C::kStages], ((it / C::kStages) - 1) & 1);
    return;
  }

  regs_inc<kConsumerRegs>();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r = 64 * wg + 16 * warp + lane / 4;  // this thread's W rows: r, r + 8
  const int c = lane % 4;
  unsigned char* staged = smem + C::kOffOut + wg * C::kOutBytes;
  const int blocks = K / 64;  // absmax blocks of a W row
  const int scale_rows = (N + block - 1) / block, scale_cols = (K + block - 1) / block;  // K12
  int it = 0, n_tiles = 0, n_stages = 0;
  for (int u = cluster; u < units; u += clusters) {
    // shuffled from lane 0, so that the compiler sees the branch on n0
    // taken by whole warps
    const int m0 = __shfl_sync(0xffffffffu, (u / pairs_n) * BX, 0);
    const int n0 = __shfl_sync(0xffffffffu, (2 * (u % pairs_n) + rank) * kBw, 0);
    const float* pa;
    const float* pb;
    if constexpr (kFp8) {
      // K12: the scale row of this warp's 16 W rows (B % 32 == 0); past N
      // the last one, whose bytes arrive as zeros
      pa = absmax + (size_t)min((n0 + 64 * wg + 16 * warp) / block, scale_rows - 1) * scale_cols;
      pb = nullptr;
    } else {
      pa = n0 + r < N ? absmax + (size_t)(n0 + r) * blocks : nullptr;
      pb = n0 + r + 8 < N ? absmax + (size_t)(n0 + r + 8) * blocks : nullptr;
    }
    float acc[BX / 2];
    uint32_t fa[16], fb[16];  // the A fragments of two stages
    float sc[4];
    if constexpr (kFp8)
      sc[0] = __ldg(pa);
    else
      load_scales(sc, pa, pb, 0, half);
    mbar_wait(&full[it % C::kStages], (it / C::kStages) & 1);
    if constexpr (kFp8)
      decode_stage_e4m3(smem + (it % C::kStages) * C::kStageBytes + kWOff, r, c, sc[0], fa);
    else
      decode_stage(smem + (it % C::kStages) * C::kStageBytes + 2 * C::kXBytes, r, c, sc, code, fa);
    // One stage: its four products (K12: two) from `cur`, then, while they
    // run, the next stage decoded into `nxt` once the products that read
    // `nxt` are done.
    auto step = [&](int st, uint32_t(&cur)[16], uint32_t(&nxt)[16]) {
      const int s = (it + st) % C::kStages;
      const bool more = st + 1 < nst;
      if constexpr (kFp8) {
        if (more) sc[0] = __ldg(pa + (st + 1) * kStep / block);
      } else {
        if (more) load_scales(sc, pa, pb, st + 1, half);
      }
      const uint32_t xs = smem_u32(smem + s * C::kStageBytes);
      fence_u32(cur);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 2; ++k)
        Rs<BX>::mma(acc, cur[4 * k], cur[4 * k + 1], cur[4 * k + 2], cur[4 * k + 3],
                    sw64_desc(xs + 32 * k), st > 0 || k > 0);
      if constexpr (!kFp8) {
#pragma unroll
        for (int k = 0; k < 2; ++k)
          Rs<BX>::mma(acc, cur[8 + 4 * k], cur[8 + 4 * k + 1], cur[8 + 4 * k + 2],
                      cur[8 + 4 * k + 3], sw64_desc(xs + C::kXBytes + 32 * k), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (st > 0) release(empty, (it + st - 1) % C::kStages, lane, rank);
      if (more) {
        const int sn = (it + st + 1) % C::kStages;
        mbar_wait(&full[sn], ((it + st + 1) / C::kStages) & 1);
        if constexpr (kFp8)
          decode_stage_e4m3(smem + sn * C::kStageBytes + kWOff, r, c, sc[0], nxt);
        else
          decode_stage(smem + sn * C::kStageBytes + 2 * C::kXBytes, r, c, sc, code, nxt);
      }
    };
    for (int st = 0; st < nst; st += 2) {
      step(st, fa, fb);
      if (st + 1 < nst) step(st + 1, fb, fa);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(empty, (it + nst - 1) % C::kStages, lane, rank);
    it += nst;
    if (n0 >= N) continue;  // the odd W tile's partner: computed, not stored
    ++n_tiles;
    n_stages += nst;

    // epilogue: once the previous tile's TMA store has read the staging
    // tile, y^T rounded to bf16 and stored transposed into it: matrix q of
    // stmatrix j2 holds accumulator columns (x rows) 8 (2 j2 + q / 2).. and
    // rows (W rows) 16 warp + 8 (q % 2)..; lane L gives the address of x
    // row 8 (2 j2 + L / 16) + L % 8, whose W rows 16 warp + 8 ((L / 8) % 2)
    // .. form the 16-byte chunk 2 warp + (L / 8) % 2 of its 128-byte row
    // (swizzled by the row's index mod 8).
    if (t == 0) bulk_wait_read<0>();
    named_bar_sync(1 + wg, 128);
    {
      const int q = lane / 8;
      const int chunk = 2 * warp + (q % 2);
#pragma unroll
      for (int j2 = 0; j2 < BX / 16; ++j2) {
        const int row = 8 * (2 * j2 + q / 2) + lane % 8;
        const uint32_t addr =
            smem_u32(staged + row * 128 + ((chunk ^ (row % 8)) * 16));
        const int j0 = 2 * j2, j1 = 2 * j2 + 1;
        asm volatile(
            "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
            "r"(pack_bf16(acc[4 * j0], acc[4 * j0 + 1])),
            "r"(pack_bf16(acc[4 * j0 + 2], acc[4 * j0 + 3])),
            "r"(pack_bf16(acc[4 * j1], acc[4 * j1 + 1])),
            "r"(pack_bf16(acc[4 * j1 + 2], acc[4 * j1 + 3]))
            : "memory");
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    const int nw = n0 + 64 * wg;  // this warpgroup's first output column
    if (tma_store) {
      if (t == 0 && nw < N) {
        tma_store_2d(&ty, staged, nw, m0);
        bulk_commit();
      }
    } else {
      for (int q = t; q < BX * 64; q += 128) {
        const int row = q / 64, col = q % 64;
        if (m0 + row < M && nw + col < N)
          y[(size_t)(m0 + row) * N + nw + col] = *reinterpret_cast<const bf16*>(
              staged + row * 128 + ((((col / 8) ^ (row % 8)) * 16) + (col % 8) * 2));
      }
    }
  }
  if (t == 0) {
    bulk_wait<0>();
    if (counts != nullptr && wg == 0) {
      atomicAdd(counts + kCntTiles, n_tiles);
      atomicAdd(counts + kCntStages, n_stages);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: dx[M, K] = g[M, N] @ dequant(W)[N, K], computed transposed,
// dx^T = W^T g^T.
//
// Replaces unsloth_tpu/ops/qlora_matmul.py:_bwd_kernel (launched by
// _bwd_pallas from _nf4_vjp_bwd): the gradient of y = x @ W^T with respect
// to x; W is frozen. Same arithmetic as K1: code * absmax in fp32, rounded
// once to bf16; fp32 sums; each output rounded once to bf16.
//
// What bounds it on an H100: tensor-core work, 2 M N K operations (gate/up
// at M = 8,192: 0.97 ms), as K1.
//
// Design: K1's machinery with the roles of W's two axes swapped.
//   - A = W^T, decoded from the packed bytes into registers. A tile's 64
//     output rows a warpgroup are 64 packed byte columns j0..j0 + 63: the
//     high-nibble warpgroup's are dx columns j0.., the low one's K/2 +
//     j0..; the reduction runs over W's rows n. So one byte stream feeds
//     both warpgroups, each decoding its own nibble. A thread's two A rows
//     are taken as neighbouring bytes (A row 16 w + l / 4 holds byte 16 w +
//     2 (l / 4), row 16 w + l / 4 + 8 the next byte), so that one 16-bit
//     load gives both; the epilogue stores them as one bf16 pair.
//   - B = g, K-major, from the ring: a [BX][64] bf16 box of g's rows (128-
//     byte swizzle), the two halves multicast across the cluster as K1's x
//     boxes. Each decoded weight serves BX (256) rows of g.
//   - A stage is 64 W rows: g [BX][64], the packed bytes [64][64] u8 by
//     TMA (64-byte swizzle: the 16-byte chunk h of row n sits at h ^ ((n
//     >> 1) & 3)), and the absmax the stage needs, read from the transposed
//     absmax [K/64, N] (one 256-byte row a block, any K) by TMA: the high
//     side's block j0 / 64 and the low side's (K/2 + j0) / 64 and (K/2 + j0
//     + 32) / 64. The absmax varies along the reduction, per (n, block), so
//     each thread scales each weight it decodes.
//   - Persistent, clusters of two: a unit is BX rows of g against the byte
//     tiles 2 p and 2 p + 1 (one per CTA), numbered with the tile pairs
//     fastest; 4 stages; A double-buffered; the epilogue writes bf16 pairs
//     into a [BX][64] 128-byte-swizzled staging tile and stores it by TMA
//     through one of two maps, dx[:, :K/2] (high side) and dx[:, K/2:]
//     (low side), each K/2 wide with dx's row stride.
// The traps of the split-half layout where K/2 % 64 == 32 (gpt-oss's K =
// 2,880): the last byte tile crosses K/2, its bytes past K/2 arrive as
// zeros, which decode to NF4 code 0 = -1.0 x absmax. Its columns past K/2
// decode with absmax 0 (a zero row in shared memory), and the high side's
// map ends at K/2, so none of them reaches the low side's real columns
// K/2..K/2 + 31. The low side's tile straddles two absmax blocks there
// (columns 0-31 and 32-63): warps 0-1 read the first, warps 2-3 the
// second. N must be a multiple of 64 (the wrapper checks), so no stage has
// rows past N.
//
// K13: dx = g @ dequant(W) for W e4m3 [N, K] with fp32 scales [ceil(N/B),
// ceil(K/B)], the FP8 backward, is this kernel in its e4m3 form,
// nf4_dx_wgmma_kernel<BX, true>. Replaces unsloth_tpu/ops/fp8_matmul.py:
// _bwd_kernel (launched by _bwd_pallas) above 16 rows wherever
// fp8_matmul.cu's fp8_dx_wgmma_form holds. Same arithmetic: fp32(e4m3) x
// scale[n / B][k / B] rounded once to bf16, fp32 sums, one rounding.
//   - A tile is 128 columns of dx: warpgroup 0 takes k0..k0 + 63,
//     warpgroup 1 k0 + 64.., one byte a weight, so K2's two nibble sides of
//     one byte stream become two halves of a 128-byte stream. A stage is 64
//     W rows: g [BX][64] bf16 and W [64][128] u8 (128-byte swizzle), 40 KB
//     at BX = 256; four stages and the two staging tiles take 230,464 of
//     the 232,448 bytes a block may have, which leaves no room to stage the
//     scales, and they need none:
//   - a thread's A fragment of a k step covers 16 W rows and its warp's 16
//     columns, which lie in one block where B % 32 == 0, so each (k step,
//     warp) reads one fp32 scale, in place, a stage ahead (past the grid
//     the last row or column: there the bytes are TMA's zeros, or the
//     columns are not stored);
//   - the cvt (e4m3x2 -> f16x2, exact) gives two columns of one W row, the
//     A register wants one column of two rows (K2's remap of A rows onto
//     neighbouring bytes), so the pairs are re-paired in fp32 after the
//     scale and rounded once;
//   - no N % 64 rule: an e4m3 zero byte decodes to +0 (NF4's to -1.0), so
//     the W rows past N and g's columns past N, both TMA's zeros, add
//     nothing; one store map, dx [M, K], clips the columns past K.
// ---------------------------------------------------------------------------

constexpr int kDxCols = 64;    // packed byte columns of a tile (64 output columns a side)
constexpr int kDxRows = 64;    // W rows (the reduction) a stage
constexpr int kDxStages = 4;
constexpr int kDx8Cols = 128;  // K13: e4m3 bytes of a W row a stage (the tile's 128 columns)

// kFp8: K13's e4m3 form (no absmax rows, no zero row), else K2's.
template <int BX, bool kFp8 = false>
struct DxCfg {
  static constexpr int kGBytes = BX * kDxRows * 2;     // g box, [BX][64] bf16
  static constexpr int kGHalf = kGBytes / 2;           // the rows one CTA loads
  // packed bytes [64][64] u8 (K13: e4m3 [64][128])
  static constexpr int kWBytes = kDxRows * (kFp8 ? kDx8Cols : kDxCols);
  static constexpr int kStageBytes = kGBytes + kWBytes;
  static constexpr int kScaleBytes = kFp8 ? 0 : 3 * kDxRows * 4;  // absmax: high, low a, low b
  static constexpr int kOutBytes = BX * 128;           // a warpgroup's [BX][64] bf16 result
  static constexpr int kOffOut = kDxStages * kStageBytes;
  static constexpr int kOffScale = kOffOut + 2 * kOutBytes;
  static constexpr int kOffZero = kOffScale + kDxStages * kScaleBytes;
  static constexpr int kOffBar = kOffZero + (kFp8 ? 0 : kDxRows * 4);
  static constexpr int kSmem = kOffBar + 2 * kDxStages * 8 + 1024;  // + alignment
  static_assert(kStageBytes % 1024 == 0, "stages stay 1,024-byte aligned");
  static_assert(kSmem + 64 <= 232448, "the opt-in shared memory of an H100 block");
};

// K13's scale grid. The e4m3 form reads its scales in place, by plain
// loads, and has no absmax map, so the grid rides in that map's parameter
// slot: the kernel's parameters, and with them K2's name and code, stay
// K2's.
struct Fp8Grid {
  const float* scales;  // fp32 [rows, cols], one a block x block tile of W
  int block, rows, cols;
};
static_assert(sizeof(Fp8Grid) <= sizeof(CUtensorMap), "fits the map's slot");

// A thread's A fragments of one K2 stage: a[4 k + 2 h + i] is k step k (W
// rows 16 k..), {rows r (i = 0), r + 8 (i = 1)} x {W rows 2c, 2c + 1 (h =
// 0); 2c + 8, 2c + 9 (h = 1)} of wgmma's A layout, A rows r and r + 8 being
// the bytes at `off` and `off` + 1 of a row (`off` holds the swizzled chunk
// of this warp's 16 bytes). `w` is the stage's [64][64] packed bytes, `s`
// the absmax of its 64 rows for this thread's columns, `sh` the nibble (4:
// high, 0: low).
__device__ __forceinline__ void decode_dx_stage(const unsigned char* w, const float* s, int off,
                                                int sh, const float* code, uint32_t (&a)[16]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = 16 * k + 8 * h;  // + 2c, which `off` and `s` carry
      const uint32_t va = *reinterpret_cast<const uint16_t*>(w + n * kDxCols + off);
      const uint32_t vb = *reinterpret_cast<const uint16_t*>(w + (n + 1) * kDxCols + off);
      const float2 sv = *reinterpret_cast<const float2*>(s + n);
      a[4 * k + 2 * h] = pack_bf16(code[(va >> sh) & 15] * sv.x, code[(vb >> sh) & 15] * sv.y);
      a[4 * k + 2 * h + 1] =
          pack_bf16(code[(va >> (sh + 8)) & 15] * sv.x, code[(vb >> (sh + 8)) & 15] * sv.y);
    }
  }
}

// K13's A fragments of one stage in decode_dx_stage's order, from the
// stage's [64][128] e4m3 bytes (128-byte swizzle: the 16-byte chunk h of
// row n sits at h ^ (n % 8)). A rows r and r + 8 are the bytes at `off0`
// and `off0` + 1 of W row 16 k + 8 h + 2c, and at `off1` of the next row
// (the two rows' swizzles differ). One 16-bit load gives two columns of
// one W row, wgmma's register wants one column of two rows, so the pairs
// are re-paired in fp32: each weight fp32(e4m3) x the scale of its k step
// (`s`: a k step's 16 W rows and this warp's 16 columns lie in one block),
// rounded once to bf16.
__device__ __forceinline__ void decode_dx_stage_e4m3(const unsigned char* w, int off0, int off1,
                                                     const float (&s)[4], uint32_t (&a)[16]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = 16 * k + 8 * h;  // + 2c, which the offsets carry
      const float2 fa = e4m3x2_float2(*reinterpret_cast<const uint16_t*>(w + n * kDx8Cols + off0));
      const float2 fb =
          e4m3x2_float2(*reinterpret_cast<const uint16_t*>(w + (n + 1) * kDx8Cols + off1));
      a[4 * k + 2 * h] = pack_bf16(fa.x * s[k], fb.x * s[k]);
      a[4 * k + 2 * h + 1] = pack_bf16(fa.y * s[k], fb.y * s[k]);
    }
  }
}

template <int BX, bool kFp8 = false>
__global__ void __launch_bounds__(kThreads, 1)
    nf4_dx_wgmma_kernel(const __grid_constant__ CUtensorMap tg,   // g [M, N], box 64 x BX / 2
                        const __grid_constant__ CUtensorMap tw,   // packed [N, K/2] u8, box 64 x 64
                                                                  // (K13: e4m3 [N, K], box 128 x 64)
                        const __grid_constant__ CUtensorMap ts,   // absmax^T [K/64, N] f32, box 64 x 1
                                                                  // (K13: an Fp8Grid)
                        const __grid_constant__ CUtensorMap thi,  // dx[:, :K/2], box 64 x BX
                                                                  // (K13: dx [M, K])
                        const __grid_constant__ CUtensorMap tlo,  // dx[:, K/2:], box 64 x BX
                                                                  // (K13: unused)
                        int* __restrict__ counts, int M, int N, int K) {
  using C = DxCfg<BX, kFp8>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float code[16];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  uint64_t* empty = full + kDxStages;
  const int half = K / 2;
  // K13: rows past N arrive as zeros (an e4m3 zero byte is +0, not NF4's
  // -1.0), so N needs no multiple of 64; a tile is 128 columns of dx
  const int nst = kFp8 ? (N + kDxRows - 1) / kDxRows : N / kDxRows;
  const int tiles_j = kFp8 ? (K + kDx8Cols - 1) / kDx8Cols : (half + kDxCols - 1) / kDxCols;
  const int pairs_j = (tiles_j + 1) / 2;  // byte tile pairs
  const int units = ((M + BX - 1) / BX) * pairs_j;
  const int blocks = K / 64;
  const int rank = static_cast<int>(cluster_rank());
  const int cluster = blockIdx.x / 2, clusters = gridDim.x / 2;
  if constexpr (!kFp8) {
    if (threadIdx.x < 16) code[threadIdx.x] = kCode[threadIdx.x];
    if (threadIdx.x < kDxRows) reinterpret_cast<float*>(smem + C::kOffZero)[threadIdx.x] = 0.0f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 16);  // one arrival per consumer warp of both CTAs
    }
    fence_barrier_init();
  }
  cluster_sync();

  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 2) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int u = cluster; u < units; u += clusters) {
      // this CTA's half of the g rows and its byte tile, moved inside the
      // tensors where they lie past them (the odd tile's partner: not stored)
      const int gr = min((u / pairs_j) * BX + rank * (BX / 2), M - 1);
      const int jc = min(2 * (u % pairs_j) + rank, tiles_j - 1);
      if constexpr (kFp8) {
        // K13: g's columns and W's rows st * 64.., W's columns 128 jc..
        for (int st = 0; st < nst; ++st, ++it) {
          const int s = it % kDxStages;
          if (it >= kDxStages) mbar_wait(&empty[s], ((it / kDxStages) - 1) & 1);
          unsigned char* slot = smem + s * C::kStageBytes;
          mbar_expect_tx(&full[s], C::kStageBytes);
          tma_load_2d_both(slot + rank * C::kGHalf, &tg, &full[s], st * kDxRows, gr);
          tma_load_2d(slot + C::kGBytes, &tw, &full[s], jc * kDx8Cols, st * kDxRows);
        }
      } else {
        const int j0 = jc * kDxCols;
        const int bh = jc, bla = min((half + j0) / 64, blocks - 1),
                  blb = min((half + j0 + 32) / 64, blocks - 1);
        for (int st = 0; st < nst; ++st, ++it) {
          const int s = it % kDxStages;
          if (it >= kDxStages) mbar_wait(&empty[s], ((it / kDxStages) - 1) & 1);
          unsigned char* slot = smem + s * C::kStageBytes;
          unsigned char* sl = smem + C::kOffScale + s * C::kScaleBytes;
          mbar_expect_tx(&full[s], C::kStageBytes + C::kScaleBytes);
          tma_load_2d_both(slot + rank * C::kGHalf, &tg, &full[s], st * kDxRows, gr);
          tma_load_2d(slot + C::kGBytes, &tw, &full[s], j0, st * kDxRows);
          tma_load_2d(sl, &ts, &full[s], st * kDxRows, bh);
          tma_load_2d(sl + kDxRows * 4, &ts, &full[s], st * kDxRows, bla);
          tma_load_2d(sl + 2 * kDxRows * 4, &ts, &full[s], st * kDxRows, blb);
        }
      }
    }
    for (int i = 0; i < kDxStages; ++i, ++it)
      if (it >= kDxStages) mbar_wait(&empty[it % kDxStages], ((it / kDxStages) - 1) & 1);
    return;
  }

  regs_inc<kConsumerRegs>();
  // 0: high side, 1: low (K13: the tile's columns 0-63, 64-127)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int q = lane / 4, c = lane % 4;
  const int sh = wg == 0 ? 4 : 0;
  // this thread's byte pair 16 warp + 2q.. in row 2c of a k step's 16 rows
  // (and 2c + 1, 2c + 8, 2c + 9): chunk warp ^ c by the 64-byte swizzle
  const int off = 2 * c * kDxCols + ((warp ^ c) << 4) + 2 * q;
  unsigned char* staged = smem + C::kOffOut + wg * C::kOutBytes;
  const float* zero = reinterpret_cast<const float*>(smem + C::kOffZero);
  int it = 0, n_tiles = 0, n_stages = 0;
  for (int u = cluster; u < units; u += clusters) {
    const int m0 = __shfl_sync(0xffffffffu, (u / pairs_j) * BX, 0);
    const int j0 = __shfl_sync(0xffffffffu,
                               (2 * (u % pairs_j) + rank) * (kFp8 ? kDx8Cols : kDxCols), 0);
    // the absmax row of this warp's 16 columns: the high side's block, the
    // low side's first or (from column 32, where K/2 % 64 == 32 it is the
    // next) second; columns past K/2 take the zero row
    const int srow = j0 + 16 * warp >= half ? -1 : wg == 0 ? 0 : (warp < 2 ? 1 : 2);
    auto scales = [&](int s) {
      return srow < 0 ? zero
                      : reinterpret_cast<const float*>(smem + C::kOffScale + s * C::kScaleBytes) +
                            srow * kDxRows + 2 * c;
    };
    float acc[BX / 2];
    uint32_t fa[16], fb[16];  // the A fragments of two stages
    // K13: this thread's byte pair 64 wg + 16 warp + 2q.. of W rows 2c and
    // 2c + 1 of each 8 (chunk 4 wg + warp, swizzled by the row), and the
    // scales of a stage's four k steps, read a stage ahead from the scale
    // column of this warp's 16 columns (past K the last; past N the last
    // row, whose bytes arrive as zeros)
    const int off0 = 2 * c * kDx8Cols + (((4 * wg + warp) ^ (2 * c)) << 4) + 2 * q;
    const int off1 = 2 * c * kDx8Cols + (((4 * wg + warp) ^ (2 * c + 1)) << 4) + 2 * q;
    const Fp8Grid& grid = *reinterpret_cast<const Fp8Grid*>(&ts);
    float sc[4];
    auto load_sc = [&](int st) {
      const float* col = grid.scales + min((j0 + 64 * wg + 16 * warp) / grid.block, grid.cols - 1);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        sc[k] = __ldg(col + (size_t)min((st * kDxRows + 16 * k) / grid.block, grid.rows - 1) *
                                grid.cols);
    };
    if constexpr (kFp8) load_sc(0);
    mbar_wait(&full[it % kDxStages], (it / kDxStages) & 1);
    if constexpr (kFp8)
      decode_dx_stage_e4m3(smem + (it % kDxStages) * C::kStageBytes + C::kGBytes, off0, off1, sc,
                           fa);
    else
      decode_dx_stage(smem + (it % kDxStages) * C::kStageBytes + C::kGBytes,
                      scales(it % kDxStages), off, sh, code, fa);
    // One stage: its four products from `cur`, then, while they run, the
    // next stage decoded into `nxt` once the products that read `nxt` are
    // done.
    auto step = [&](int st, uint32_t(&cur)[16], uint32_t(&nxt)[16]) {
      const int s = (it + st) % kDxStages;
      const bool more = st + 1 < nst;
      if constexpr (kFp8) {
        if (more) load_sc(st + 1);
      }
      const uint32_t gs = smem_u32(smem + s * C::kStageBytes);
      fence_u32(cur);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        Rs<BX>::mma(acc, cur[4 * k], cur[4 * k + 1], cur[4 * k + 2], cur[4 * k + 3],
                    sw128_desc(gs + 32 * k, 16, 1024), st > 0 || k > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (st > 0) release(empty, (it + st - 1) % kDxStages, lane, rank);
      if (more) {
        const int sn = (it + st + 1) % kDxStages;
        mbar_wait(&full[sn], ((it + st + 1) / kDxStages) & 1);
        if constexpr (kFp8)
          decode_dx_stage_e4m3(smem + sn * C::kStageBytes + C::kGBytes, off0, off1, sc, nxt);
        else
          decode_dx_stage(smem + sn * C::kStageBytes + C::kGBytes, scales(sn), off, sh, code,
                          nxt);
      }
    };
    for (int st = 0; st < nst; st += 2) {
      step(st, fa, fb);
      if (st + 1 < nst) step(st + 1, fb, fa);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(empty, (it + nst - 1) % kDxStages, lane, rank);
    it += nst;
    if (j0 >= (kFp8 ? K : half)) continue;  // the odd byte tile's partner: computed, not stored
    ++n_tiles;
    n_stages += nst;

    // epilogue: once the previous tile's TMA store has read the staging
    // tile, dx^T rounded to bf16 and written transposed into it: the
    // accumulators of g row 8 jj + 2c + e for A rows r and r + 8 are dx
    // columns 16 warp + 2q and + 1 of this side, one bf16 pair at 16-byte
    // chunk 2 warp + q / 4 (swizzled by the row's index mod 8), word q % 4
    if (t == 0) bulk_wait_read<0>();
    named_bar_sync(1 + wg, 128);
#pragma unroll
    for (int jj = 0; jj < BX / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 8 * jj + 2 * c + e;
        *reinterpret_cast<uint32_t*>(staged + row * 128 +
                                     (((2 * warp + (q >> 2)) ^ (row % 8)) << 4) + 4 * (q & 3)) =
            pack_bf16(acc[4 * jj + e], acc[4 * jj + 2 + e]);
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    if (t == 0) {
      if constexpr (kFp8) {
        // K13: dx columns j0 + 64 wg..; the map clips them at K
        if (j0 + 64 * wg < K) tma_store_2d(&thi, staged, j0 + 64 * wg, m0);
      } else {
        if (wg == 0)
          tma_store_2d(&thi, staged, j0, m0);
        else
          tma_store_2d(&tlo, staged, j0, m0);
      }
      bulk_commit();
    }
  }
  if (t == 0) {
    bulk_wait<0>();
    if (counts != nullptr && wg == 0) {
      atomicAdd(counts + kCntTiles, n_tiles);
      atomicAdd(counts + kCntStages, n_stages);
    }
  }
}

// ---------------------------------------------------------------------------
// K14: the grouped NF4 expert forward,
//   y[r, :] = x[r, :] @ dequant(W_g)^T + bias[g]   for the rows r of group g.
//
// Replaces unsloth_tpu/ops/nf4_gmm.py:_fwd_kernel (launched by
// _nf4_gmm_fwd_impl) above 16 rows; nf4_gmm.cu keeps nf4_gmm_kernel<16> for
// decode rows and holds the C entry point. Same arithmetic: each weight
// NF4_CODE[nibble] x absmax in fp32, rounded once to bf16; fp32 sums; the
// fp32 bias added to the fp32 sum; one rounding.
//
// Layout: rows of x sorted by expert; group g owns rows [off_g, off_g +
// size_g), off the running sum of the int32 group sizes, which stay on the
// device. W is NF4Stacked: packed [E, N, K/2] u8 in split-half order,
// absmax fp32 [E, N, K / B] for B 32 or 64, K/2 a multiple of 32 and of B;
// bias fp32 [E, N] or none.
//
// What bounds it on an H100: tensor-core work, 2 m N K operations (the
// gpt-oss path's 16,384 routed rows at N = K = 2,880: 0.275 ms).
//
// Design: K1's kernel (y^T = W_g x^T; the bytes decoded into wgmma's A
// fragments; x the B operand from a 4-stage TMA ring; clusters of two
// multicasting the x boxes; persistent) under K19's grouped schedule:
//   - Row tiles are laid from each group's first row: group g has
//     ceil(size_g / BX) tiles of BX rows, full but its last, whose rows past
//     the group's end are computed and never stored (the x box reads the
//     next group's rows there, or TMA's zeros past m). At the path's 16,384
//     rows over 32 groups (~512 each) that is ~80 tiles of 256 rows, 1.25x
//     the rows, where a global grid of 256-row tiles visited once per group
//     they touch (megablox's visits, the old kernel's) takes ~95 (1.48x).
//     BX is 256 above 128 rows, else 128 (K1's rule): at the path's rows
//     128-row tiles multiply 1.13x the rows, not 1.25x, but took 0.74-0.75
//     ms against 256's 0.57-0.58 (each decoded weight then feeds half the
//     rows; H100, PERF.md).
//   - A unit is (row tile, W tile pair): the cluster's two CTAs multiply
//     the same BX rows of x by W_g's tiles 2 p and 2 p + 1 of 128 rows (past
//     N, where the tiles are odd in number, the second is computed and not
//     stored). At N = 2,880: 23 tiles, 12 pairs, ~960 units for the 66
//     clusters of an H100. Units are numbered group by group and, inside a
//     group, with its row tiles fastest, so the clusters in flight share
//     W_g's tiles in L2. Each block builds the running sums of the group
//     sizes and each group's first unit in shared memory once (after K1's
//     barriers; E <= 1,024) and maps a unit to its group by binary search
//     (K19's tables, gmm.cu).
//   - The stage is K1's: 32 packed bytes of each of the tile's 128 W rows
//     (row g N + n of the [E N, K/2] bytes) and the two x boxes they pair
//     with. Each side of a stage lies in one absmax block, the high side's
//     32 st / B and the low side's (K/2 + 32 st) / B. W rows past N decode
//     with absmax 0 (their bytes are the next expert's) and are not stored.
//   - Epilogue: the bias of a thread's two W rows added to the fp32
//     accumulators, one rounding, stmatrix.trans into the staging tile; a
//     full tile stores by TMA, a group's last tile by masked 16-byte stores
//     of its own rows, so no CTA writes another group's rows. The rows past
//     the groups (where the sizes sum to less than m) are stored as zeros,
//     so the wrapper allocates y with torch.empty.
// ---------------------------------------------------------------------------

constexpr int kMaxGmmExperts = 1024;
constexpr int kCntMasked = 2;  // K14: tiles stored by masked stores

// K1's shared memory with the group tables after the barriers: offs[g] the
// first row of group g (offs[E] the end of the groups), ustart[g] its first
// unit (ustart[E] all units), E + 1 ints each.
template <int BX>
struct GmmCfg {
  static constexpr int kOffTab = Cfg<BX>::kOffBar + 2 * kStages * 8;
  static constexpr int smem(int E) { return kOffTab + 8 * (E + 1) + 1024; }  // + alignment
};
static_assert(GmmCfg<256>::smem(kMaxGmmExperts) + 64 <= 232448,
              "the tables fit beside K1's ring and staging tiles");

struct GmmUnit {
  int g;     // group
  int row0;  // first row of the row tile
  int hi;    // the end of the group's rows in it
  int p;     // W tile pair
};

// Unit u: its group is the last g with ustart[g] <= u (an empty group
// starts where the next one does), its row tile and W pair follow from u -
// ustart[g], row tiles fastest.
template <int BX>
__device__ __forceinline__ GmmUnit gmm_unit(int u, const int* offs, const int* ustart, int E) {
  int a = 0, b = E - 1;
  while (a < b) {
    const int mid = (a + b + 1) >> 1;
    if (ustart[mid] <= u)
      a = mid;
    else
      b = mid - 1;
  }
  const int nt = (offs[a + 1] - offs[a] + BX - 1) / BX;
  const int local = u - ustart[a];
  GmmUnit w;
  w.g = a;
  w.row0 = offs[a] + (local % nt) * BX;
  w.hi = min(offs[a + 1], w.row0 + BX);
  w.p = local / nt;
  return w;
}

// The unit with every field lane 0's, so that the compiler sees the
// branches on them taken by whole warps.
__device__ __forceinline__ GmmUnit warp_uniform(GmmUnit w) {
  w.g = __shfl_sync(0xffffffffu, w.g, 0);
  w.row0 = __shfl_sync(0xffffffffu, w.row0, 0);
  w.hi = __shfl_sync(0xffffffffu, w.hi, 0);
  w.p = __shfl_sync(0xffffffffu, w.p, 0);
  return w;
}

// The absmax of a thread's rows (pa, pb; null past N) for stage st at
// blocks of 2^shift: the high side's block 32 st >> shift, the low side's
// (K/2 + 32 st) >> shift.
__device__ __forceinline__ void load_group_scales(float (&s)[4], const float* pa, const float* pb,
                                                  int st, int half, int shift) {
  const int bh = (st * kStep) >> shift, bl = (half + st * kStep) >> shift;
  s[0] = pa != nullptr ? __ldg(pa + bh) : 0.0f;
  s[1] = pb != nullptr ? __ldg(pb + bh) : 0.0f;
  s[2] = pa != nullptr ? __ldg(pa + bl) : 0.0f;
  s[3] = pb != nullptr ? __ldg(pb + bl) : 0.0f;
}

// A float from global memory, issued here (volatile) rather than at its use.
__device__ __forceinline__ float ldg_now(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

template <int BX>
__global__ void __launch_bounds__(kThreads, 1)
    nf4_gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,  // x [M, K], box 32 x BX / 2
                         const __grid_constant__ CUtensorMap tw,  // packed [E N, K/2] u8, box 32 x 128
                         const __grid_constant__ CUtensorMap ty,  // y [M, N], box 64 x BX
                         const float* __restrict__ absmax, const float* __restrict__ bias,
                         const int* __restrict__ group_sizes, bf16* __restrict__ y,
                         int* __restrict__ counts, int M, int E, int N, int K, int shift) {
  using C = Cfg<BX>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float code[16];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  uint64_t* empty = full + kStages;
  int* offs = reinterpret_cast<int*>(smem + GmmCfg<BX>::kOffTab);
  int* ustart = offs + E + 1;
  const int half = K / 2;
  const int nst = half / kStep;
  const int pairs_n = ((N + kBw - 1) / kBw + 1) / 2;  // W tile pairs
  const int rank = static_cast<int>(cluster_rank());
  const int cluster = blockIdx.x / 2, clusters = gridDim.x / 2;
  if (threadIdx.x < 16) code[threadIdx.x] = kCode[threadIdx.x];
  for (int g = threadIdx.x; g < E; g += kThreads) offs[g + 1] = group_sizes[g];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 16);  // one arrival per consumer warp of both CTAs
    }
    fence_barrier_init();
    // the tables; sizes clamped to [0, M]
    int off = 0, u = 0;
    for (int g = 0; g < E; ++g) {
      const int end = min(off + max(offs[g + 1], 0), M);
      offs[g] = off;
      ustart[g] = u;
      u += (end - off + BX - 1) / BX * pairs_n;
      off = end;
    }
    offs[E] = off;
    ustart[E] = u;
  }
  cluster_sync();  // both CTAs' barriers, codebooks and tables are made
  const int units = __shfl_sync(0xffffffffu, ustart[E], 0);

  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 2) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int u = cluster; u < units; u += clusters) {
      const GmmUnit w = gmm_unit<BX>(u, offs, ustart, E);
      // this CTA's half of the x rows and W_g's tile, moved inside the
      // tensors where they lie past them (their rows of y are not stored)
      const int xr = min(w.row0 + rank * (BX / 2), M - 1);
      const int wr = w.g * N + min((2 * w.p + rank) * kBw, N - 1);
      for (int st = 0; st < nst; ++st, ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
        unsigned char* slot = smem + s * C::kStageBytes;
        mbar_expect_tx(&full[s], C::kStageBytes);
        tma_load_2d_both(slot + rank * C::kXHalf, &tx, &full[s], st * kStep, xr);
        tma_load_2d_both(slot + C::kXBytes + rank * C::kXHalf, &tx, &full[s], half + st * kStep,
                         xr);
        tma_load_2d(slot + 2 * C::kXBytes, &tw, &full[s], st * kStep, wr);
      }
    }
    // stay until both CTAs' consumers have handed back every stage
    for (int i = 0; i < kStages; ++i, ++it)
      if (it >= kStages) mbar_wait(&empty[it % kStages], ((it / kStages) - 1) & 1);
    return;
  }

  regs_inc<kConsumerRegs>();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r = 64 * wg + 16 * warp + lane / 4;  // this thread's W rows: r, r + 8
  const int c = lane % 4;
  unsigned char* staged = smem + C::kOffOut + wg * C::kOutBytes;
  const int blocks = K >> shift;  // absmax blocks of a W row
  // the rows past the groups: zeros, 16 bytes a consumer thread
  {
    const int end = offs[E], chunks = N / 8;
    const long total = (long)(M - end) * chunks;
    for (long i = blockIdx.x * 256L + threadIdx.x; i < total; i += gridDim.x * 256L)
      *reinterpret_cast<uint4*>(y + (size_t)(end + i / chunks) * N + 8 * (i % chunks)) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  int it = 0, n_tiles = 0, n_stages = 0, n_masked = 0;
  for (int u = cluster; u < units; u += clusters) {
    const GmmUnit w = warp_uniform(gmm_unit<BX>(u, offs, ustart, E));
    const int n0 = (2 * w.p + rank) * kBw;
    const size_t row_g = (size_t)w.g * N;  // W_g's first row in [E N, K/2]
    const float* pa = n0 + r < N ? absmax + (row_g + n0 + r) * blocks : nullptr;
    const float* pb = n0 + r + 8 < N ? absmax + (row_g + n0 + r + 8) * blocks : nullptr;
    // the bias of this thread's two W rows, read now for the epilogue
    const float b0 = bias != nullptr && n0 + r < N ? ldg_now(bias + row_g + n0 + r) : 0.0f;
    const float b1 = bias != nullptr && n0 + r + 8 < N ? ldg_now(bias + row_g + n0 + r + 8) : 0.0f;
    float acc[BX / 2];
    uint32_t fa[16], fb[16];  // the A fragments of two stages
    float sc[4];
    load_group_scales(sc, pa, pb, 0, half, shift);
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
    decode_stage(smem + (it % kStages) * C::kStageBytes + 2 * C::kXBytes, r, c, sc, code, fa);
    // One stage: its four products from `cur`, then, while they run, the
    // next stage decoded into `nxt` once the products that read `nxt` are
    // done.
    auto step = [&](int st, uint32_t(&cur)[16], uint32_t(&nxt)[16]) {
      const int s = (it + st) % kStages;
      const bool more = st + 1 < nst;
      if (more) load_group_scales(sc, pa, pb, st + 1, half, shift);
      const uint32_t xs = smem_u32(smem + s * C::kStageBytes);
      fence_u32(cur);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 2; ++k)
        Rs<BX>::mma(acc, cur[4 * k], cur[4 * k + 1], cur[4 * k + 2], cur[4 * k + 3],
                    sw64_desc(xs + 32 * k), st > 0 || k > 0);
#pragma unroll
      for (int k = 0; k < 2; ++k)
        Rs<BX>::mma(acc, cur[8 + 4 * k], cur[8 + 4 * k + 1], cur[8 + 4 * k + 2],
                    cur[8 + 4 * k + 3], sw64_desc(xs + C::kXBytes + 32 * k), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (st > 0) release(empty, (it + st - 1) % kStages, lane, rank);
      if (more) {
        const int sn = (it + st + 1) % kStages;
        mbar_wait(&full[sn], ((it + st + 1) / kStages) & 1);
        decode_stage(smem + sn * C::kStageBytes + 2 * C::kXBytes, r, c, sc, code, nxt);
      }
    };
    for (int st = 0; st < nst; st += 2) {
      step(st, fa, fb);
      if (st + 1 < nst) step(st + 1, fb, fa);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(empty, (it + nst - 1) % kStages, lane, rank);
    it += nst;
    if (n0 >= N) continue;  // the odd W tile's partner: computed, not stored
    const bool whole = w.hi - w.row0 == BX;  // no row past the group's end
    ++n_tiles;
    n_stages += nst;
    n_masked += !whole;

    // epilogue: the bias added in fp32 (accumulator 4 j + e holds W row r,
    // e < 2, or r + 8), then K1's: rounded once and stored transposed into
    // the staging tile by stmatrix.trans
#pragma unroll
    for (int j = 0; j < BX / 8; ++j) {
      acc[4 * j] += b0;
      acc[4 * j + 1] += b0;
      acc[4 * j + 2] += b1;
      acc[4 * j + 3] += b1;
    }
    if (t == 0) bulk_wait_read<0>();
    named_bar_sync(1 + wg, 128);
    {
      const int q = lane / 8;
      const int chunk = 2 * warp + (q % 2);
#pragma unroll
      for (int j2 = 0; j2 < BX / 16; ++j2) {
        const int row = 8 * (2 * j2 + q / 2) + lane % 8;
        const uint32_t addr = smem_u32(staged + row * 128 + ((chunk ^ (row % 8)) * 16));
        const int j0 = 2 * j2, j1 = 2 * j2 + 1;
        asm volatile(
            "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
            "r"(pack_bf16(acc[4 * j0], acc[4 * j0 + 1])),
            "r"(pack_bf16(acc[4 * j0 + 2], acc[4 * j0 + 3])),
            "r"(pack_bf16(acc[4 * j1], acc[4 * j1 + 1])),
            "r"(pack_bf16(acc[4 * j1 + 2], acc[4 * j1 + 3]))
            : "memory");
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    const int nw = n0 + 64 * wg;  // this warpgroup's first output column
    if (whole) {
      if (t == 0 && nw < N) {
        tma_store_2d(&ty, staged, nw, w.row0);
        bulk_commit();
      }
    } else {
      // the group's own rows only, 16 bytes (8 columns; N % 8 == 0) a store
      for (int i = t; i < (w.hi - w.row0) * 8; i += 128) {
        const int row = i / 8, ch = i % 8;
        if (nw + 8 * ch < N)
          *reinterpret_cast<uint4*>(y + (size_t)(w.row0 + row) * N + nw + 8 * ch) =
              *reinterpret_cast<const uint4*>(staged + row * 128 + ((ch ^ (row % 8)) * 16));
      }
    }
  }
  if (t == 0) {
    bulk_wait<0>();
    if (counts != nullptr && wg == 0) {
      atomicAdd(counts + kCntTiles, n_tiles);
      atomicAdd(counts + kCntStages, n_stages);
      atomicAdd(counts + kCntMasked, n_masked);
    }
  }
}

// ---------------------------------------------------------------------------
// K15: the grouped NF4 expert backward,
//   dx[r, :] = g[r, :] @ dequant(W_g)   for the rows r of group g.
//
// Replaces unsloth_tpu/ops/nf4_gmm.py:_bwd_kernel (launched by
// _nf4_gmm_bwd_impl) at every row count: the gradient of K14 with respect
// to x (W and the bias are frozen). Same arithmetic: each weight
// NF4_CODE[nibble] x absmax in fp32, rounded once to bf16; fp32 sums; one
// rounding.
//
// What bounds it on an H100: tensor-core work, 2 m N K operations (the
// gpt-oss path's 16,384 routed rows at N = K = 2,880: 0.275 ms).
//
// Design: K2's kernel (dx^T = W_g^T g^T; one packed byte stream decoded
// into both warpgroups' A fragments, the high nibbles dx[:, j0..], the low
// ones dx[:, K/2 + j0..]; g the K-major B operand, [BX][64] boxes
// multicast across a cluster of two; a 4-stage ring of 64 W rows; the
// epilogue through the two maps dx[:, :K/2] and dx[:, K/2:]) under K14's
// grouped schedule:
//   - Row tiles laid from each group's first row (ceil(size_g / BX) tiles,
//     the last ending at the group's end); a unit is (row tile, pair p of
//     64-byte tiles), units numbered group by group with the row tiles
//     fastest, found by K14's tables and binary search (gmm_unit). Empty
//     groups have no unit. BX is 256 above 128 rows, else 128 (K2's rule).
//   - Stage st of group g reads W rows g N + 64 st.. of the [E N, K/2]
//     bytes. Where N % 64 != 0 the last stage's rows past N are the next
//     expert's bytes (or TMA's zeros past E N): they add nothing, since
//     the transposed absmax's columns past N and g's columns past N both
//     arrive as TMA's zeros.
//   - The absmax is transposed per call to [E K/B, N] (row g K/B + b is
//     block b of W_g's rows), B 32 or 64. A stage carries four of its rows
//     by TMA, each side's block of the tile's columns 0-31 (warps 0-1) and
//     32-63 (warps 2-3): at B = 32 every 64-byte tile spans two blocks a
//     side (K2's straddle of the low side, on both); at B = 64 (K/2 a
//     multiple of 64) each side's two rows are one block. Where K/2 % 64
//     == 32 (B = 32: gpt-oss's K = 2,880) the last tile crosses K/2: its
//     bytes past K/2 are TMA's zeros, which would decode to -1.0 x absmax;
//     its columns past K/2 decode with a zero row in shared memory (never
//     with the low side's first block, which the high side's block of
//     columns 32-63 names there), and the high side's map ends at K/2.
//   - Epilogue: a full tile stores by TMA, a group's short last tile by
//     masked 16-byte stores of its own rows (K14's), so no CTA writes
//     another group's rows; rows past the groups are stored as zeros, so
//     the wrapper allocates dx with torch.empty.
// ---------------------------------------------------------------------------

// K2's ring and staging tiles, then four absmax rows a stage (high a, high
// b, low a, low b), the zero row, the barriers and K14's group tables.
template <int BX>
struct GmmDxCfg {
  using D = DxCfg<BX>;
  static constexpr int kScaleBytes = 4 * kDxRows * 4;
  static constexpr int kOffScale = D::kOffScale;
  static constexpr int kOffZero = kOffScale + kDxStages * kScaleBytes;
  static constexpr int kOffBar = kOffZero + kDxRows * 4;
  static constexpr int kOffTab = kOffBar + 2 * kDxStages * 8;
  static constexpr int smem(int E) { return kOffTab + 8 * (E + 1) + 1024; }  // + alignment
};
static_assert(GmmDxCfg<256>::smem(kMaxGmmExperts) + 64 <= 232448,
              "the tables fit beside K2's ring and staging tiles");

template <int BX>
__global__ void __launch_bounds__(kThreads, 1)
    nf4_gmm_dx_wgmma_kernel(const __grid_constant__ CUtensorMap tg,   // g [M, N], box 64 x BX / 2
                            const __grid_constant__ CUtensorMap tw,   // packed [E N, K/2] u8, box 64 x 64
                            const __grid_constant__ CUtensorMap ts,   // absmax^T [E K/B, N] f32, box 64 x 1
                            const __grid_constant__ CUtensorMap thi,  // dx[:, :K/2], box 64 x BX
                            const __grid_constant__ CUtensorMap tlo,  // dx[:, K/2:], box 64 x BX
                            const int* __restrict__ group_sizes, bf16* __restrict__ dx,
                            int* __restrict__ counts, int M, int E, int N, int K, int shift) {
  using D = DxCfg<BX>;
  using C = GmmDxCfg<BX>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float code[16];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  uint64_t* empty = full + kDxStages;
  int* offs = reinterpret_cast<int*>(smem + C::kOffTab);
  int* ustart = offs + E + 1;
  const int half = K / 2;
  const int nst = (N + kDxRows - 1) / kDxRows;
  const int tiles_j = (half + kDxCols - 1) / kDxCols;
  const int pairs_j = (tiles_j + 1) / 2;  // byte tile pairs
  const int blocks = K >> shift;          // absmax blocks of a W row
  const int rank = static_cast<int>(cluster_rank());
  const int cluster = blockIdx.x / 2, clusters = gridDim.x / 2;
  if (threadIdx.x < 16) code[threadIdx.x] = kCode[threadIdx.x];
  if (threadIdx.x < kDxRows) reinterpret_cast<float*>(smem + C::kOffZero)[threadIdx.x] = 0.0f;
  for (int g = threadIdx.x; g < E; g += kThreads) offs[g + 1] = group_sizes[g];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 16);  // one arrival per consumer warp of both CTAs
    }
    fence_barrier_init();
    // the tables; sizes clamped to [0, M]
    int off = 0, u = 0;
    for (int g = 0; g < E; ++g) {
      const int end = min(off + max(offs[g + 1], 0), M);
      offs[g] = off;
      ustart[g] = u;
      u += (end - off + BX - 1) / BX * pairs_j;
      off = end;
    }
    offs[E] = off;
    ustart[E] = u;
  }
  cluster_sync();  // both CTAs' barriers, codebooks, zero rows and tables are made
  const int units = __shfl_sync(0xffffffffu, ustart[E], 0);

  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 2) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int u = cluster; u < units; u += clusters) {
      const GmmUnit w = gmm_unit<BX>(u, offs, ustart, E);
      // this CTA's half of the g rows and its byte tile, moved inside the
      // tensors where they lie past them (their rows and columns of dx are
      // not stored)
      const int gr = min(w.row0 + rank * (BX / 2), M - 1);
      const int j0 = min(2 * w.p + rank, tiles_j - 1) * kDxCols;
      // W_g's absmax rows of the tile's columns 0-31 and 32-63, each side
      const int b0 = w.g * blocks;
      const int ha = b0 + min(j0 >> shift, blocks - 1);
      const int hb = b0 + min((j0 + 32) >> shift, blocks - 1);
      const int la = b0 + min((half + j0) >> shift, blocks - 1);
      const int lb = b0 + min((half + j0 + 32) >> shift, blocks - 1);
      for (int st = 0; st < nst; ++st, ++it) {
        const int s = it % kDxStages;
        if (it >= kDxStages) mbar_wait(&empty[s], ((it / kDxStages) - 1) & 1);
        unsigned char* slot = smem + s * D::kStageBytes;
        unsigned char* sl = smem + C::kOffScale + s * C::kScaleBytes;
        mbar_expect_tx(&full[s], D::kStageBytes + C::kScaleBytes);
        tma_load_2d_both(slot + rank * D::kGHalf, &tg, &full[s], st * kDxRows, gr);
        tma_load_2d(slot + D::kGBytes, &tw, &full[s], j0, w.g * N + st * kDxRows);
        tma_load_2d(sl, &ts, &full[s], st * kDxRows, ha);
        tma_load_2d(sl + kDxRows * 4, &ts, &full[s], st * kDxRows, hb);
        tma_load_2d(sl + 2 * kDxRows * 4, &ts, &full[s], st * kDxRows, la);
        tma_load_2d(sl + 3 * kDxRows * 4, &ts, &full[s], st * kDxRows, lb);
      }
    }
    // stay until both CTAs' consumers have handed back every stage
    for (int i = 0; i < kDxStages; ++i, ++it)
      if (it >= kDxStages) mbar_wait(&empty[it % kDxStages], ((it / kDxStages) - 1) & 1);
    return;
  }

  regs_inc<kConsumerRegs>();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // 0: high side, 1: low
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int q = lane / 4, c = lane % 4;
  const int sh = wg == 0 ? 4 : 0;
  // K2's byte pair 16 warp + 2q.. of row 2c of a k step's 16 rows
  const int off = 2 * c * kDxCols + ((warp ^ c) << 4) + 2 * q;
  unsigned char* staged = smem + D::kOffOut + wg * D::kOutBytes;
  const float* zero = reinterpret_cast<const float*>(smem + C::kOffZero);
  // the rows past the groups: zeros, 16 bytes a consumer thread
  {
    const int end = offs[E], chunks = K / 8;
    const long total = (long)(M - end) * chunks;
    for (long i = blockIdx.x * 256L + threadIdx.x; i < total; i += gridDim.x * 256L)
      *reinterpret_cast<uint4*>(dx + (size_t)(end + i / chunks) * K + 8 * (i % chunks)) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  int it = 0, n_tiles = 0, n_stages = 0, n_masked = 0;
  for (int u = cluster; u < units; u += clusters) {
    const GmmUnit w = warp_uniform(gmm_unit<BX>(u, offs, ustart, E));
    const int j0 = (2 * w.p + rank) * kDxCols;
    // the absmax row of this warp's 16 columns: its side's block of the
    // tile's columns 0-31 (warps 0-1) or 32-63 (warps 2-3); columns past
    // K/2 take the zero row
    const int srow = j0 + 16 * warp >= half ? -1 : 2 * wg + (warp >> 1);
    auto scales = [&](int s) {
      return srow < 0 ? zero
                      : reinterpret_cast<const float*>(smem + C::kOffScale + s * C::kScaleBytes) +
                            srow * kDxRows + 2 * c;
    };
    float acc[BX / 2];
    uint32_t fa[16], fb[16];  // the A fragments of two stages
    mbar_wait(&full[it % kDxStages], (it / kDxStages) & 1);
    decode_dx_stage(smem + (it % kDxStages) * D::kStageBytes + D::kGBytes,
                    scales(it % kDxStages), off, sh, code, fa);
    // One stage: its four products from `cur`, then, while they run, the
    // next stage decoded into `nxt` once the products that read `nxt` are
    // done.
    auto step = [&](int st, uint32_t(&cur)[16], uint32_t(&nxt)[16]) {
      const int s = (it + st) % kDxStages;
      const bool more = st + 1 < nst;
      const uint32_t gs = smem_u32(smem + s * D::kStageBytes);
      fence_u32(cur);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        Rs<BX>::mma(acc, cur[4 * k], cur[4 * k + 1], cur[4 * k + 2], cur[4 * k + 3],
                    sw128_desc(gs + 32 * k, 16, 1024), st > 0 || k > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (st > 0) release(empty, (it + st - 1) % kDxStages, lane, rank);
      if (more) {
        const int sn = (it + st + 1) % kDxStages;
        mbar_wait(&full[sn], ((it + st + 1) / kDxStages) & 1);
        decode_dx_stage(smem + sn * D::kStageBytes + D::kGBytes, scales(sn), off, sh, code, nxt);
      }
    };
    for (int st = 0; st < nst; st += 2) {
      step(st, fa, fb);
      if (st + 1 < nst) step(st + 1, fb, fa);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(empty, (it + nst - 1) % kDxStages, lane, rank);
    it += nst;
    if (j0 >= half) continue;  // the odd byte tile's partner: computed, not stored
    const bool whole = w.hi - w.row0 == BX;  // no row past the group's end
    ++n_tiles;
    n_stages += nst;
    n_masked += !whole;

    // epilogue (K2's): once the previous tile's TMA store has read the
    // staging tile, dx^T rounded to bf16 and written transposed into it,
    // g row 8 jj + 2c + e of A rows r, r + 8 as dx columns 16 warp + 2q
    // and + 1 of this side
    if (t == 0) bulk_wait_read<0>();
    named_bar_sync(1 + wg, 128);
#pragma unroll
    for (int jj = 0; jj < BX / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 8 * jj + 2 * c + e;
        *reinterpret_cast<uint32_t*>(staged + row * 128 +
                                     (((2 * warp + (q >> 2)) ^ (row % 8)) << 4) + 4 * (q & 3)) =
            pack_bf16(acc[4 * jj + e], acc[4 * jj + 2 + e]);
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    if (whole) {
      if (t == 0) {
        if (wg == 0)
          tma_store_2d(&thi, staged, j0, w.row0);
        else
          tma_store_2d(&tlo, staged, j0, w.row0);
        bulk_commit();
      }
    } else {
      // the group's own rows only, 16 bytes (8 columns; K/2 % 32 == 0) a
      // store, none past K/2 on either side
      bf16* side = dx + (wg == 0 ? 0 : half) + j0;
      for (int i = t; i < (w.hi - w.row0) * 8; i += 128) {
        const int row = i / 8, ch = i % 8;
        if (j0 + 8 * ch < half)
          *reinterpret_cast<uint4*>(side + (size_t)(w.row0 + row) * K + 8 * ch) =
              *reinterpret_cast<const uint4*>(staged + row * 128 + ((ch ^ (row % 8)) * 16));
      }
    }
  }
  if (t == 0) {
    bulk_wait<0>();
    if (counts != nullptr && wg == 0) {
      atomicAdd(counts + kCntTiles, n_tiles);
      atomicAdd(counts + kCntStages, n_stages);
      atomicAdd(counts + kCntMasked, n_masked);
    }
  }
}

// The map of a row-major 2-D tensor of `elem` bytes an element (bf16, u8 or
// f32), dims and box innermost first, with `swizzle`, zeros past the edges;
// rows `stride` bytes apart (0: packed, d0 * elem).
int tile_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int elem, uint64_t d0,
             uint64_t d1, uint32_t b0, uint32_t b1, CUtensorMapSwizzle swizzle,
             uint64_t stride = 0) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {d0, d1};
  const cuuint64_t strides[1] = {stride != 0 ? stride : d0 * elem};
  const cuuint32_t box[2] = {b0, b1};
  const cuuint32_t one[2] = {1, 1};
  const CUresult r = enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, one,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
    return 132;
  return n;
}

// A persistent launch in clusters of two: as many clusters as are resident
// at once, at most one a unit.
template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, int smem, long units, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int resident = sm_count() / 2;
  cfg.gridDim = dim3(2 * resident);
  int fits = 0;
  if (cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg) == cudaSuccess && fits > 0)
    resident = fits;
  const long clusters = units < resident ? units : resident;
  cfg.gridDim = dim3(2 * (unsigned)clusters);
  const int e = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
  if (e != 0) return e;
  return static_cast<int>(cudaGetLastError());
}

// K1 (kFp8 false: `w` the packed NF4 bytes [N, K/2], `scales` the absmax
// [N * K/64]) or K12 (`w` e4m3 [N, K], `scales` [ceil(N/B), ceil(K/B)]).
template <int BX, bool kFp8>
int launch(const void* x, const void* w, const void* scales, void* y, void* counts, int M,
           int N, int K, int block, cudaStream_t stream) {
  using C = Cfg<BX, kFp8>;
  CUtensorMap tx, tw, ty;
  const bool tma_store = N % 8 == 0;  // y's rows 16-byte multiples
  int e = tile_map(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, M, kStep, BX / 2,
                   CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == 0)
    e = tile_map(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, kFp8 ? K : K / 2, N, kStep, kBw,
                 CU_TENSOR_MAP_SWIZZLE_32B);
  if (e == 0 && tma_store)
    e = tile_map(&ty, y, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, M, 64, BX,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != 0) return e;
  if (!tma_store) ty = tx;  // unused
  auto kernel = nf4_wgmma_kernel<BX, kFp8>;
  static bool configured = false;
  if (!configured) {
    e = static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem));
    if (e != 0) return e;
    configured = true;
  }
  const long units = (long)((M + BX - 1) / BX) * (((N + kBw - 1) / kBw + 1) / 2);
  const int flags = (tma_store ? 1 : 0) | (kFp8 ? block << 1 : 0);
  return launch_clusters(kernel, C::kSmem, units, stream, tx, tw, ty,
                         static_cast<const float*>(scales), static_cast<bf16*>(y),
                         static_cast<int*>(counts), M, N, K, flags);
}

// K2 (kFp8 false: `w` the packed NF4 bytes [N, K/2], `scales` the absmax
// transposed, [K/64, N]) or K13 (`w` e4m3 [N, K], `scales` [ceil(N/B),
// ceil(K/B)] read in place).
template <int BX, bool kFp8>
int launch_dx(const void* g, const void* w, const void* scales, void* dx, void* counts, int M,
              int N, int K, int block, cudaStream_t stream) {
  using C = DxCfg<BX, kFp8>;
  const int half = K / 2;
  CUtensorMap tg, tw, ts, thi, tlo;
  int e = tile_map(&tg, g, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, M, kDxRows, BX / 2,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (kFp8) {
    if (e == 0)
      e = tile_map(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, kDx8Cols, kDxRows,
                   CU_TENSOR_MAP_SWIZZLE_128B);
    if (e == 0)
      e = tile_map(&thi, dx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, M, 64, BX,
                   CU_TENSOR_MAP_SWIZZLE_128B);
    const Fp8Grid grid = {static_cast<const float*>(scales), block, (N + block - 1) / block,
                          (K + block - 1) / block};
    memset(&ts, 0, sizeof ts);
    memcpy(&ts, &grid, sizeof grid);
    tlo = thi;  // unused
  } else {
    if (e == 0)
      e = tile_map(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, half, N, kDxCols, kDxRows,
                   CU_TENSOR_MAP_SWIZZLE_64B);
    if (e == 0)
      e = tile_map(&ts, scales, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, N, K / 64, kDxRows, 1,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e == 0)
      e = tile_map(&thi, dx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, half, M, 64, BX,
                   CU_TENSOR_MAP_SWIZZLE_128B, (uint64_t)K * 2);
    if (e == 0)
      e = tile_map(&tlo, static_cast<bf16*>(dx) + half, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                   half, M, 64, BX, CU_TENSOR_MAP_SWIZZLE_128B, (uint64_t)K * 2);
  }
  if (e != 0) return e;
  auto kernel = nf4_dx_wgmma_kernel<BX, kFp8>;
  static bool configured = false;
  if (!configured) {
    e = static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem));
    if (e != 0) return e;
    configured = true;
  }
  const int tiles = kFp8 ? (K + kDx8Cols - 1) / kDx8Cols : (half + kDxCols - 1) / kDxCols;
  const long units = (long)((M + BX - 1) / BX) * ((tiles + 1) / 2);
  return launch_clusters(kernel, C::kSmem, units, stream, tg, tw, ts, thi, tlo,
                         static_cast<int*>(counts), M, N, K);
}

template <int BX>
int launch_gmm(const void* x, const void* packed, const void* absmax, const void* bias,
               const void* group_sizes, void* y, void* counts, int M, int E, int N, int K,
               int bs, cudaStream_t stream) {
  if (E < 1 || E > kMaxGmmExperts || (bs != 32 && bs != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tw, ty;
  int e = tile_map(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, M, kStep, BX / 2,
                   CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == 0)
    e = tile_map(&tw, packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K / 2, (uint64_t)E * N, kStep,
                 kBw, CU_TENSOR_MAP_SWIZZLE_32B);
  if (e == 0)
    e = tile_map(&ty, y, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, M, 64, BX,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != 0) return e;
  auto kernel = nf4_gmm_wgmma_kernel<BX>;
  static bool configured = false;
  if (!configured) {
    e = static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              GmmCfg<BX>::smem(kMaxGmmExperts)));
    if (e != 0) return e;
    configured = true;
  }
  // the group sizes stay on the device: as many clusters as the units could
  // need at most (each group adds at most one partial row tile)
  const long units = ((long)(M + BX - 1) / BX + E) * (((N + kBw - 1) / kBw + 1) / 2);
  return launch_clusters(kernel, GmmCfg<BX>::smem(E), units, stream, tx, tw, ty,
                         static_cast<const float*>(absmax), static_cast<const float*>(bias),
                         static_cast<const int*>(group_sizes), static_cast<bf16*>(y),
                         static_cast<int*>(counts), M, E, N, K, bs == 32 ? 5 : 6);
}

template <int BX>
int launch_gmm_dx(const void* g, const void* packed, const void* absmax_t,
                  const void* group_sizes, void* dx, void* counts, int M, int E, int N, int K,
                  int bs, cudaStream_t stream) {
  if (E < 1 || E > kMaxGmmExperts || (bs != 32 && bs != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int half = K / 2;
  CUtensorMap tg, tw, ts, thi, tlo;
  int e = tile_map(&tg, g, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, M, kDxRows, BX / 2,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == 0)
    e = tile_map(&tw, packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, half, (uint64_t)E * N, kDxCols,
                 kDxRows, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == 0)
    e = tile_map(&ts, absmax_t, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, N, (uint64_t)E * (K / bs),
                 kDxRows, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == 0)
    e = tile_map(&thi, dx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, half, M, 64, BX,
                 CU_TENSOR_MAP_SWIZZLE_128B, (uint64_t)K * 2);
  if (e == 0)
    e = tile_map(&tlo, static_cast<bf16*>(dx) + half, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, half,
                 M, 64, BX, CU_TENSOR_MAP_SWIZZLE_128B, (uint64_t)K * 2);
  if (e != 0) return e;
  auto kernel = nf4_gmm_dx_wgmma_kernel<BX>;
  static bool configured = false;
  if (!configured) {
    e = static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              GmmDxCfg<BX>::smem(kMaxGmmExperts)));
    if (e != 0) return e;
    configured = true;
  }
  // as many clusters as the units could need at most (each group adds at
  // most one partial row tile)
  const long units =
      ((long)(M + BX - 1) / BX + E) * ((((half + kDxCols - 1) / kDxCols) + 1) / 2);
  return launch_clusters(kernel, GmmDxCfg<BX>::smem(E), units, stream, tg, tw, ts, thi, tlo,
                         static_cast<const int*>(group_sizes), static_cast<bf16*>(dx),
                         static_cast<int*>(counts), M, E, N, K, bs == 32 ? 5 : 6);
}

}  // namespace
}  // namespace nf4w

// y = x @ dequant(W)^T on `stream` for M > 16 rows (nf4_matmul.cu's entry
// point calls it). Shapes as unsloth_nf4_matmul_bf16: x [M, K] bf16, packed
// [N, K/2] u8, absmax [N * K/64] f32, y [M, N] bf16; K/2 a multiple of 32,
// x, packed and y 16-byte aligned. `counts`, when not null, is an int32 [2]
// to which the kernel adds the output tiles it stored and the stages it
// consumed. Rows of x at or below 128 take 128-row tiles (wgmma n128), the
// rest 256-row tiles. Returns the launch's CUDA error code.
int unsloth_nf4_wgmma_launch(const void* x, const void* packed, const void* absmax, void* y,
                             void* counts, int M, int N, int K, cudaStream_t stream) {
  if (M <= 128)
    return nf4w::launch<128, false>(x, packed, absmax, y, counts, M, N, K, 64, stream);
  return nf4w::launch<256, false>(x, packed, absmax, y, counts, M, N, K, 64, stream);
}

// y = x @ dequant(W)^T for the FP8 forward (fp8_matmul.cu's entry point
// calls it where its shape rule holds: M > 16, B % 32 == 0, K % 16 == 0,
// x and w 16-byte aligned). x [M, K] bf16, w e4m3 [N, K], scales fp32
// [ceil(N/B), ceil(K/B)], y [M, N] bf16; `counts` as above.
int unsloth_fp8_wgmma_launch(const void* x, const void* w, const void* scales, void* y,
                             void* counts, int M, int N, int K, int block, cudaStream_t stream) {
  if (M <= 128)
    return nf4w::launch<128, true>(x, w, scales, y, counts, M, N, K, block, stream);
  return nf4w::launch<256, true>(x, w, scales, y, counts, M, N, K, block, stream);
}

// dx = g @ dequant(W) on `stream` (nf4_matmul.cu's entry point calls it).
// g [M, N] bf16, packed [N, K/2] u8, absmax_t the absmax transposed, fp32
// [K/64, N], dx [M, K] bf16; N a multiple of 64, K/2 of 32, every pointer
// 16-byte aligned. `counts`, when not null, is an int32 [2] to which the
// kernel adds the output tiles (a CTA's pair of 64-column sides) it stored
// and the stages it consumed. 128-row tiles of g up to 128 rows, else 256.
int unsloth_nf4_dx_wgmma_launch(const void* g, const void* packed, const void* absmax_t,
                                void* dx, void* counts, int M, int N, int K,
                                cudaStream_t stream) {
  if (M <= 128)
    return nf4w::launch_dx<128, false>(g, packed, absmax_t, dx, counts, M, N, K, 64, stream);
  return nf4w::launch_dx<256, false>(g, packed, absmax_t, dx, counts, M, N, K, 64, stream);
}

// dx = g @ dequant(W) for the FP8 backward (fp8_matmul.cu's entry point
// calls it where its shape rule holds: M > 16, B % 32 == 0, K % 16 == 0,
// N % 8 == 0, g, w and dx 16-byte aligned). g [M, N] bf16, w e4m3 [N, K],
// scales fp32 [ceil(N/B), ceil(K/B)], dx [M, K] bf16. `counts`, when not
// null, is an int32 [2] to which the kernel adds the output tiles (128
// columns of dx) it stored and the stages it consumed. 128-row tiles of g
// up to 128 rows, else 256.
int unsloth_fp8_dx_wgmma_launch(const void* g, const void* w, const void* scales, void* dx,
                                void* counts, int M, int N, int K, int block,
                                cudaStream_t stream) {
  if (M <= 128)
    return nf4w::launch_dx<128, true>(g, w, scales, dx, counts, M, N, K, block, stream);
  return nf4w::launch_dx<256, true>(g, w, scales, dx, counts, M, N, K, block, stream);
}

// y = x @ dequant(W_g)^T + bias[g] per group on `stream` for m > 16 rows
// (nf4_gmm.cu's entry point calls it). Shapes as unsloth_nf4_gmm_bf16: x [M,
// K] bf16 rows sorted by expert, packed [E, N, K/2] u8, absmax [E, N K / bs]
// f32, bias [E, N] f32 or null, group_sizes [E] int32 on the device, y [M,
// N] bf16 (every row written: rows past the groups are zeros); K/2 a
// multiple of 32 and of bs (32 or 64), N of 8, E <= 1,024, x, packed and y
// 16-byte aligned. `counts`, when not null, is an int32 [3] to which the
// kernel adds the output tiles it stored, their stages, and the tiles of
// those it stored by masked stores (a group's last). Rows of x at or below
// 128 take 128-row tiles, the rest 256-row tiles (K1's rule). Returns the
// launch's CUDA error code.
int unsloth_nf4_gmm_wgmma_launch(const void* x, const void* packed, const void* absmax,
                                 const void* bias, const void* group_sizes, void* y,
                                 void* counts, int M, int E, int N, int K, int bs,
                                 cudaStream_t stream) {
  if (M <= 128)
    return nf4w::launch_gmm<128>(x, packed, absmax, bias, group_sizes, y, counts, M, E, N, K, bs,
                                 stream);
  return nf4w::launch_gmm<256>(x, packed, absmax, bias, group_sizes, y, counts, M, E, N, K, bs,
                               stream);
}

// dx = g @ dequant(W_g) per group on `stream`, at every row count
// (nf4_gmm.cu's entry point calls it). g [M, N] bf16 rows sorted by expert,
// packed [E, N, K/2] u8, absmax_t the absmax transposed, fp32 [E K/bs, N]
// (row g K/bs + b: block b of W_g's rows), group_sizes [E] int32 on the
// device, dx [M, K] bf16 (every row written: rows past the groups are
// zeros); K/2 a multiple of 32 and of bs (32 or 64), N of 8, E <= 1,024,
// every pointer 16-byte aligned. `counts`, when not null, is an int32 [3]
// to which the kernel adds the output tiles it stored (a CTA's pair of
// 64-column sides), their stages, and the tiles of those it stored by
// masked stores (a group's last). 128-row tiles of g up to 128 rows, else
// 256. Returns the launch's CUDA error code.
int unsloth_nf4_gmm_dx_wgmma_launch(const void* g, const void* packed, const void* absmax_t,
                                    const void* group_sizes, void* dx, void* counts, int M, int E,
                                    int N, int K, int bs, cudaStream_t stream) {
  if (M <= 128)
    return nf4w::launch_gmm_dx<128>(g, packed, absmax_t, group_sizes, dx, counts, M, E, N, K, bs,
                                    stream);
  return nf4w::launch_gmm_dx<256>(g, packed, absmax_t, group_sizes, dx, counts, M, E, N, K, bs,
                                  stream);
}
