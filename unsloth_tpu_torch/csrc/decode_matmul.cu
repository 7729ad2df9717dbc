// Decode-row dequant-inside-matmul forward, at M <= 16 rows of x:
//   y[M, N] = x[M, K] @ dequant(W)[N, K]^T
// for an NF4 W (K1's decode form) and for a block-scaled e4m3 W (K12's);
// and its grouped form over experts (below: K14's and K19's forwards at
// m <= 16 routed rows).
//
// Replaces, at M <= 16, the TPU kernels unsloth_tpu/ops/qlora_matmul.py:
// _fwd_kernel (K1, launched by _fwd_pallas) and unsloth_tpu/ops/
// fp8_matmul.py:_fwd_kernel (K12, launched by _fwd_pallas), and, at m <=
// 16, unsloth_tpu/ops/nf4_gmm.py:_fwd_kernel (K14, pallas_call in
// _nf4_gmm_fwd_impl) and megablox `gmm` as unsloth_tpu/ops/moe.py:
// tiled_gmm calls it with its bias epilogue (K19). Above 16 rows K1, K12
// and K14 run nf4_wgmma.cu's persistent Hopper kernels, K19 gmm.cu's.
//
// Rounding points (the TPU kernels' and the plain versions'):
//   * NF4: each weight is bf16(NF4_CODE[nibble] * absmax), the product in
//     fp32, rounded once. Layout (unsloth_tpu/ops/nf4.py, "split-half"):
//     byte [n, j] of packed [N, K/2] holds element j in its high nibble and
//     element K/2 + j in its low nibble; one absmax per 64 elements of the
//     row-major weight. The absmax is read as stored: fp32, or int8 codes
//     with one fp32 scale per `double_block` codes and one fp32 offset,
//     decoded here as __fadd_rn(__fmul_rn(float(code), scale), offset)
//     (mul, then add: nvcc would contract a*b+c into an FMA, which is not
//     ops/nf4.py:_decode_absmax's bits). Both forms give the same bits.
//   * e4m3: each weight is bf16(float(e4m3) * scale[n / B][k / B]): the
//     hardware cvt (e4m3x2 -> f16x2, exact), one fp32 multiply, one round.
//   * Products on the tensor cores in fp32; each output rounded once.
//
// What bounds it on an H100: the weight's bytes, read once a call:
// 0.5 B/param plus 1/64 B of int8 absmax (NF4), 1 B/param plus 4/B^2 B of
// scales (e4m3). At 3.35 TB/s a 14,336 x 4,096 NF4 weight takes 9.1 us;
// x (<= 16 rows) and y are small beside it. The design's answer:
//   * Split K. A unit is (a group of 16 * WR W rows, a slice of the packed
//     row, in 64-byte steps); WR in {8, 4, 2} and the number of slices S
//     are picked by shape (ops/qlora_matmul.py:decode_schedule, whose
//     choice the wrapper passes in) so that every decode shape, down to
//     gpt-oss's k/v (N = 512), fills the 132 SMs with one wave of at most
//     two 256-thread blocks an SM. A block's 8 warps split the group's
//     rows into WR warp rows of 16 and the slice's steps among the other
//     8 / WR, interleaved.
//   * Bytes in flight. Each lane reads 16 bytes of two W rows a step (rows
//     g and g + 8 of its warp's 16: the m16n8k16 A fragment's rows), by
//     ld.global.nc.L1::no_allocate, four steps ahead of the decode in a
//     ring of registers: 32 KB a block, 64 KB an SM, in flight. Four lanes
//     read a row's 64 contiguous bytes.
//   * Products from registers. y^T = W x^T by mma.sync m16n8k16 bf16 ->
//     fp32: the decoded weights go straight into the A fragments; x^T is
//     the B operand (8 columns = 8 rows of x; a second n-tile at M > 8).
//     The contraction order inside a 16-wide k chunk is free as long as A
//     and B agree: lane (g, t) holds bytes 16t + 4s .. 16t + 4s + 3 of its
//     rows as the k columns 2t, 2t+1, 2t+8, 2t+9 of mma s (s = 0..3), so
//     its B fragment is 4 consecutive x values, read from the x slice the
//     block stages in shared memory once (rows padded by 16 bytes: no
//     bank conflicts).
//   * The scales ride in the same ring: for NF4 the lanes of a row group
//     read the absmax of the step's high-side block and low-side block(s)
//     as stored (an int8 code and its group's scale, or fp32), decode it
//     and pass it on by shuffle; for e4m3 each lane reads its chunk's
//     scale. Each 16-byte chunk takes one (K/2 % 32 == 0: a chunk never
//     straddles an absmax block, even at gpt-oss's K = 2,880 where a block
//     straddles K/2; e4m3 with B % 16 == 0). Other e4m3 blocks take a
//     scale per element. Nothing is staged but x, by bulk copies: the loop
//     starts as soon as the first step and x have arrived.
//   * A deterministic reduction in the same launch: the warps of a slice
//     add their partials in shared memory in a fixed order; at S > 1 each
//     block writes its fp32 partial tile to a scratch the wrapper
//     allocates, and the last block of a row group to arrive (a counter
//     per group that it sets back to 0) sums the S partials in slice order
//     and rounds once. Two runs give the same bits; no atomics touch y and
//     no memset runs per call.
//   * Masks: rows past N and bytes past the row read nothing; x columns
//     past the slice or K are staged as zeros; e4m3 rows that are not
//     16-byte aligned (K % 16 != 0) read byte by byte.
// Counters (null, or int32 [2]): the units stored and the 16-byte chunks
// of W consumed, held to decode_schedule by the checks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using hopper::pack_bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStep = 64;             // bytes of a W row a step
constexpr int kRing = 4;              // steps of loads in flight a lane
constexpr int kMaxSmem = 100 * 1024;  // dynamic shared memory a block, at most

__constant__ float kNF4Code[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

struct Params {
  const __nv_bfloat16* x;   // [M, K]
  const uint8_t* w;         // NF4: packed [N, K/2]; e4m3: [N, K]
  const float* absmax;      // NF4, fp32 [N K / 64], or null
  const int8_t* codes;      // NF4, double-quantized: int8 [N K / 64]
  const float* code_scale;  // one fp32 scale a `double_block` codes
  const float* code_offset; // one fp32
  int double_block;
  unsigned long long group_magic;  // ceil(2^40 / double_block): code -> group
  const float* scales;      // e4m3: fp32 [ceil(N/B), ceil(K/B)]
  int block, scale_cols;
  unsigned long long block_magic;  // ceil(2^40 / B): byte -> scale column
  __nv_bfloat16* y;         // [M, N]
  float* partials;          // [units][WR][32][NT * 4] fp32, at S > 1
  int* arrivals;            // [groups], 0 between calls, at S > 1
  int* counts;              // null or int32 [2]
  int M, N, K;
  int L;                    // bytes of a W row: K/2 or K
  int steps;                // ceil(L / 64)
  int row_warps;            // WR
  int slices;               // S
  int slice_steps;          // steps a slice (the last may have fewer)
  bool w_vec;               // 16-byte W loads (always for NF4)
  bool x_vec;               // 16-byte x loads
  bool chunk_scale;         // e4m3: B % 16 == 0
};

__host__ __device__ constexpr int x_cols(bool fp8, int slice_steps) {
  return (fp8 ? 1 : 2) * kStep * slice_steps;
}

// Dynamic shared memory of a block: the x slice [8 NT][x_cols + 8] bf16,
// reused by the warps' partials once the loop is done.
__host__ __device__ inline int smem_bytes(bool fp8, int nt, int slice_steps, int row_warps) {
  const int xs = 8 * nt * (x_cols(fp8, slice_steps) + 8) * 2;
  const int red = (kWarps - row_warps) * 32 * nt * 4 * 4;
  return xs > red ? xs : red;
}

__device__ __forceinline__ uint4 ld_stream(const uint8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) global ->
// shared by the copy engine, completing `bar`'s transactions.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(hopper::smem_u32(dst)), "l"(src), "r"(bytes), "r"(hopper::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The B fragments of mmas s and s + 1 (s even): x values 4 s .. 4 s + 7 of
// the lane's 16, one 16-byte load (rows 16 bytes apart mod 128: no bank
// conflicts).
__device__ __forceinline__ uint4 xfrag(const __nv_bfloat16* xrow, int s) {
  return *reinterpret_cast<const uint4*>(xrow + 4 * s);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int s) {
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}

// The NF4 code of byte e's nibble (byte offsets of code[], x 4, in `ofs`).
__device__ __forceinline__ float nf4_code(const float* code, uint32_t ofs, int e) {
  return *reinterpret_cast<const float*>(reinterpret_cast<const char*>(code) +
                                         __byte_perm(ofs, 0u, 0x4440u + e));
}

// Bytes 0 and 1 (sel 0) or 2 and 3 (sel 1) of `w`, NF4 nibbles of one side
// (hi: the element j side), times `a`, as one bf16 pair.
__device__ __forceinline__ uint32_t nf4_pair(const float* code, uint32_t ofs, int sel, float a) {
  return pack_bf16(__fmul_rn(nf4_code(code, ofs, 2 * sel), a),
                   __fmul_rn(nf4_code(code, ofs, 2 * sel + 1), a));
}

__device__ __forceinline__ float2 e4m3x2(uint32_t pair) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair & 0xFFFFu), __NV_E4M3);
  return __half22float2(__half2(h));
}

// Bytes 0, 1 (sel 0) or 2, 3 (sel 1) of `w`, e4m3, times the scales.
__device__ __forceinline__ uint32_t e4m3_pair(uint32_t w, int sel, float s0, float s1) {
  const float2 f = e4m3x2(w >> (16 * sel));
  return pack_bf16(__fmul_rn(f.x, s0), __fmul_rn(f.y, s1));
}

// 16 bytes of a W row at byte `kb` of its `L` bytes: one 16-byte load, or
// byte by byte where the rows are not 16-byte aligned (e4m3 only: NF4 rows
// always are); bytes past L are 0.
template <bool kAny>
__device__ __forceinline__ uint4 load_chunk(const uint8_t* row, int kb, int L, bool vec) {
  if (!kAny || vec) return ld_stream(row + kb);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (kb + e < L) v[e / 4] |= (uint32_t)__ldg(row + kb + e) << (8 * (e % 4));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// The weight policies: NF4; e4m3 with 16-byte rows and pointers and B %
// 16 == 0 (every decode shape of the paths); e4m3 at any K, alignment and
// B (byte loads, a scale per element; two steps in flight).
enum Policy { kNF4 = 0, kE4m3 = 1, kE4m3Any = 2 };

template <int kPolicy, int NT>
__global__ void __launch_bounds__(kThreads, 2)
decode_matmul_kernel(const Params p) {
  constexpr bool kFp8 = kPolicy != kNF4;
  constexpr bool kAny = kPolicy == kE4m3Any;
  // (NF4 at M > 8 holds one step fewer: its second n-tile's registers)
  constexpr int kDepth = kAny ? 2 : (!kFp8 && NT == 2 ? kRing - 1 : kRing);
  const bool w_vec = !kAny || p.w_vec;
  const bool x_vec = !kAny || p.x_vec;
  const bool chunk_scale = !kAny || p.chunk_scale;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float code[16];
  __shared__ int last;
  __shared__ __align__(8) uint64_t x_bar;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int WR = p.row_warps, KP = kWarps / WR;
  const int rw = warp % WR, kp = warp / WR;
  const int unit = blockIdx.x;
  const int group = unit / p.slices, slice = unit % p.slices;
  const int sps = p.slice_steps;
  const int s0 = slice * sps;
  const int s1 = min(s0 + sps, p.steps);
  const int n0 = group * 16 * WR;
  const int r0 = n0 + 16 * rw + g, r1 = r0 + 8;
  const bool v0 = r0 < p.N, v1 = r1 < p.N;
  // this warp's steps: s0 + kp, s0 + kp + KP, ...
  const int nst = s1 - s0 > kp ? (s1 - s0 - kp + KP - 1) / KP : 0;
  const uint8_t* row0 = p.w + (size_t)r0 * p.L;
  const uint8_t* row1 = p.w + (size_t)r1 * p.L;

  // The x slice first, rows below M only (the n-tile columns of the rows
  // past M are never stored): NF4 columns [64 s0, 64 s1) of each side (the
  // high side at 0, the low side at 64 sps), e4m3 columns [64 s0, 64 s1);
  // zeros past the slice and past the side or K. With 16-byte rows, one
  // bulk copy a row and side by warp 0's lanes, completing x_bar.
  const int xc = x_cols(kFp8, sps);
  const int xld = xc + 8;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  const int side_cols = kStep * sps;
  const int used = kStep * (s1 - s0);
  const int sides = kFp8 ? 1 : 2;
  const int x_valid = min(used, p.L - kStep * s0);  // columns a side
  if (x_vec) {
    if (warp == 0) {
      if (lane == 0) {
        hopper::mbar_init(&x_bar, 1);
        hopper::fence_barrier_init();
        hopper::mbar_expect_tx(&x_bar, (uint32_t)(p.M * sides * x_valid * 2));
      }
      __syncwarp();
      for (int c = lane; c < p.M * sides; c += 32) {
        const int m = c / sides, side = c - m * sides;
        bulk_load(xs + m * xld + side * side_cols,
                  p.x + (size_t)m * p.K + side * (p.K / 2) + kStep * s0, x_valid * 2, &x_bar);
      }
    }
    const int tail = side_cols - x_valid;
    if (tail)  // the last slice: zeros past the row
      for (int c = tid; c < p.M * sides * tail; c += kThreads) {
        const int ms = c / tail, j = x_valid + c - ms * tail;
        xs[(ms / sides) * xld + (ms % sides) * side_cols + j] = __float2bfloat16(0.0f);
      }
  } else {
    for (int m = 0; m < p.M; ++m)
      for (int c = tid; c < xc; c += kThreads) {
        const int src = kStep * s0 + c;
        xs[m * xld + c] = c < used && src < p.K ? p.x[(size_t)m * p.K + src]
                                               : __float2bfloat16(0.0f);
      }
  }
  if (!kFp8 && tid < 16) code[tid] = kNF4Code[tid];

  // Each step's loads, kDepth steps ahead of the decode: 16 bytes of each
  // of the lane's two W rows, and (aux) what scales them.
  //  * NF4: lane t of a row group reads the absmax of both its rows for
  //    the group: t = 0 the high side's block of the step, t = 1 the low
  //    side's, t = 2 and 3 the low side's next block (where K/2 % 64 ==
  //    32, chunks 2 and 3 of a step lie there); as stored (fp32, or the
  //    int8 code and its group's scale), decoded at the step and passed to
  //    the group's lanes by shuffle. 0 past the row or N.
  //  * e4m3 (B % 16 == 0): the scale of each row at the lane's chunk (a
//    scale per element at other B, read at the step).
  const int per_row = p.K / 64;
  const bool straddle = !kFp8 && (p.L % 64) != 0;
  const int boff = t == 0 ? 0 : p.L / 64 + (t >= 2 && straddle ? 1 : 0);
  const bool fetches_absmax = t < 2 || (t == 2 && straddle);
  const float* srow0 = kFp8 ? p.scales + (size_t)(min(r0, p.N - 1) / p.block) * p.scale_cols
                            : nullptr;
  const float* srow1 = kFp8 ? p.scales + (size_t)(min(r1, p.N - 1) / p.block) * p.scale_cols
                            : nullptr;
  uint4 ring[kDepth][2];
  uint32_t aux[kDepth][4];  // NF4: absmax (bits) or codes of r0, r1, then
                            // the codes' group scales; e4m3: scales of r0, r1
  auto fetch = [&](int d, int i) {  // this warp's step i into ring slot d
    const int st = s0 + kp + i * KP;
    const int kb = kStep * st + 16 * t;
    const bool in = i < nst && kb < p.L;
    ring[d][0] = in && v0 ? load_chunk<kAny>(row0, kb, p.L, w_vec) : make_uint4(0u, 0u, 0u, 0u);
    ring[d][1] = in && v1 ? load_chunk<kAny>(row1, kb, p.L, w_vec) : make_uint4(0u, 0u, 0u, 0u);
    aux[d][0] = aux[d][1] = aux[d][2] = aux[d][3] = 0u;
    if (!kFp8) {
      if (fetches_absmax && i < nst && boff + st < per_row) {
        const unsigned i0 = r0 * per_row + boff + st, i1 = i0 + 8 * per_row;
        if (p.absmax) {
          if (v0) aux[d][0] = __float_as_uint(__ldg(p.absmax + i0));
          if (v1) aux[d][1] = __float_as_uint(__ldg(p.absmax + i1));
        } else {
          if (v0) {
            aux[d][0] = (uint32_t)(int)__ldg(p.codes + i0);
            aux[d][2] = __float_as_uint(__ldg(p.code_scale + ((i0 * p.group_magic) >> 40)));
          }
          if (v1) {
            aux[d][1] = (uint32_t)(int)__ldg(p.codes + i1);
            aux[d][3] = __float_as_uint(__ldg(p.code_scale + ((i1 * p.group_magic) >> 40)));
          }
        }
      }
    } else if (chunk_scale && in) {
      const int col = min((int)(((unsigned long long)kb * p.block_magic) >> 40), p.scale_cols - 1);
      if (v0) aux[d][0] = __float_as_uint(__ldg(srow0 + col));
      if (v1) aux[d][1] = __float_as_uint(__ldg(srow1 + col));
    }
  };
#pragma unroll
  for (int d = 0; d < kDepth; ++d) fetch(d, d);
  const float offset = !kFp8 && !p.absmax ? __ldg(p.code_offset) : 0.0f;
  __syncthreads();  // x_bar's init, the zeros and the code table
  if (x_vec) hopper::mbar_wait(&x_bar, 0);

  // the absmax of a row from what a lane fetched
  auto absmax_of = [&](uint32_t v, uint32_t scale) {
    return p.absmax ? __uint_as_float(v)
                    : __fadd_rn(__fmul_rn((float)(int)v, __uint_as_float(scale)), offset);
  };
  const int quad = lane & ~3;
  const int lo_src = quad | (straddle && t >= 2 ? 2 : 1);

  float acc[2][NT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][n][e] = 0.0f;

  for (int i0 = 0; i0 < nst; i0 += kDepth) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int i = i0 + d;
      if (i >= nst) break;
      const uint4 w0 = ring[d][0], w1 = ring[d][1];
      const uint32_t x0 = aux[d][0], x1 = aux[d][1], x2 = aux[d][2], x3 = aux[d][3];
      fetch(d, i + kDepth);
      const int ls = kp + i * KP;  // the step within the slice
      const int xo = kStep * ls + 16 * t;
      if (!kFp8) {
        const float m0 = absmax_of(x0, x2), m1 = absmax_of(x1, x3);
        const float ah0 = __shfl_sync(0xffffffffu, m0, quad);
        const float ah1 = __shfl_sync(0xffffffffu, m1, quad);
        const float al0 = __shfl_sync(0xffffffffu, m0, lo_src);
        const float al1 = __shfl_sync(0xffffffffu, m1, lo_src);
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const __nv_bfloat16* xrow = xs + g * xld + side * side_cols + xo;
          const float a0s = side ? al0 : ah0, a1s = side ? al1 : ah1;
          uint4 bq[NT];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const uint32_t q0 = word(w0, s), q1 = word(w1, s);
            // byte offsets into code[] of the four nibbles of this side
            const uint32_t o0 = side ? (q0 << 2) & 0x3C3C3C3Cu : (q0 >> 2) & 0x3C3C3C3Cu;
            const uint32_t o1 = side ? (q1 << 2) & 0x3C3C3C3Cu : (q1 >> 2) & 0x3C3C3C3Cu;
            const uint32_t a0 = nf4_pair(code, o0, 0, a0s);
            const uint32_t a1 = nf4_pair(code, o1, 0, a1s);
            const uint32_t a2 = nf4_pair(code, o0, 1, a0s);
            const uint32_t a3 = nf4_pair(code, o1, 1, a1s);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              if (s % 2 == 0) bq[n] = xfrag(xrow + 8 * n * xld, s);
              mma_bf16(acc[side][n], a0, a1, a2, a3, s % 2 ? bq[n].z : bq[n].x,
                       s % 2 ? bq[n].w : bq[n].y);
            }
          }
        }
      } else {
        const __nv_bfloat16* xrow = xs + g * xld + xo;
        uint4 bq[NT];
        if (chunk_scale) {
          const float f0 = __uint_as_float(x0), f1 = __uint_as_float(x1);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const uint32_t q0 = word(w0, s), q1 = word(w1, s);
            const uint32_t a0 = e4m3_pair(q0, 0, f0, f0), a1 = e4m3_pair(q1, 0, f1, f1);
            const uint32_t a2 = e4m3_pair(q0, 1, f0, f0), a3 = e4m3_pair(q1, 1, f1, f1);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              if (s % 2 == 0) bq[n] = xfrag(xrow + 8 * n * xld, s);
              mma_bf16(acc[s & 1][n], a0, a1, a2, a3, s % 2 ? bq[n].z : bq[n].x,
                       s % 2 ? bq[n].w : bq[n].y);
            }
          }
        } else {
          // a scale per element: B % 16 != 0, a chunk may cross a block
          const int kb = kStep * (s0 + ls) + 16 * t;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const uint32_t q0 = word(w0, s), q1 = word(w1, s);
            uint32_t a[4];
#pragma unroll
            for (int sel = 0; sel < 2; ++sel) {
              float c0[2], c1[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = min((kb + 4 * s + 2 * sel + e) / p.block, p.scale_cols - 1);
                c0[e] = v0 ? __ldg(srow0 + col) : 0.0f;
                c1[e] = v1 ? __ldg(srow1 + col) : 0.0f;
              }
              a[2 * sel] = e4m3_pair(q0, sel, c0[0], c0[1]);
              a[2 * sel + 1] = e4m3_pair(q1, sel, c1[0], c1[1]);
            }
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              if (s % 2 == 0) bq[n] = xfrag(xrow + 8 * n * xld, s);
              mma_bf16(acc[s & 1][n], a[0], a[1], a[2], a[3], s % 2 ? bq[n].z : bq[n].x,
                       s % 2 ? bq[n].w : bq[n].y);
            }
          }
        }
      }
    }
  }

  // The warp's partial: its two chains, then the slice's warps in order.
  float c[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = __fadd_rn(acc[0][n][e], acc[1][n][e]);
  __syncthreads();  // the x slice is no longer read
  float4* red = reinterpret_cast<float4*>(smem);
  if (kp > 0) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
      red[(((kp - 1) * WR + rw) * 32 + lane) * NT + n] = make_float4(c[n][0], c[n][1], c[n][2], c[n][3]);
  }
  __syncthreads();
  if (kp == 0) {
    for (int q = 1; q < KP; ++q) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float4 v = red[(((q - 1) * WR + rw) * 32 + lane) * NT + n];
        c[n][0] = __fadd_rn(c[n][0], v.x);
        c[n][1] = __fadd_rn(c[n][1], v.y);
        c[n][2] = __fadd_rn(c[n][2], v.z);
        c[n][3] = __fadd_rn(c[n][3], v.w);
      }
    }
  }

  if (p.counts != nullptr) {
    // 16-byte chunks this lane read: its valid rows times its steps' chunks
    int chunks = 0;
    for (int i = 0; i < nst; ++i)
      if (kStep * (s0 + kp + i * KP) + 16 * t < p.L) chunks += (int)v0 + (int)v1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) chunks += __shfl_xor_sync(0xffffffffu, chunks, o);
    if (lane == 0 && chunks) atomicAdd(p.counts + 1, chunks);
    if (tid == 0) atomicAdd(p.counts, 1);
  }

  // Rounds the sums of this lane's outputs and stores them: (x row 8n +
  // 2t + {0, 1}, W rows r0 and r1).
  auto store = [&](float (&v)[NT][4]) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int m = 8 * n + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int mm = m + (e & 1);
        const int r = e < 2 ? r0 : r1;
        if (mm < p.M && r < p.N) p.y[(size_t)mm * p.N + r] = __float2bfloat16_rn(v[n][e]);
      }
    }
  };
  if (p.slices == 1) {
    if (kp == 0) store(c);
    return;
  }
  if (kp == 0) {
    float4* mine = reinterpret_cast<float4*>(p.partials) +
                   (((size_t)unit * WR + rw) * 32 + lane) * NT;
#pragma unroll
    for (int n = 0; n < NT; ++n) __stcg(mine + n, make_float4(c[n][0], c[n][1], c[n][2], c[n][3]));
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(p.arrivals + group, 1) == p.slices - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (kp == 0) {
    // the slices' partials in slice order, one rounding
    const float4* base = reinterpret_cast<const float4*>(p.partials) +
                         (((size_t)group * p.slices * WR + rw) * 32 + lane) * NT;
    const size_t per_unit = (size_t)WR * 32 * NT;
    float sum[NT][4];
    for (int q0 = 0; q0 < p.slices; q0 += 8) {
      float4 v[8][NT];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int n = 0; n < NT; ++n)
          if (q0 + u < p.slices) v[u][n] = __ldcg(base + (q0 + u) * per_unit + n);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (q0 + u >= p.slices) break;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (q0 + u == 0) {
            sum[n][0] = v[u][n].x; sum[n][1] = v[u][n].y;
            sum[n][2] = v[u][n].z; sum[n][3] = v[u][n].w;
          } else {
            sum[n][0] = __fadd_rn(sum[n][0], v[u][n].x);
            sum[n][1] = __fadd_rn(sum[n][1], v[u][n].y);
            sum[n][2] = __fadd_rn(sum[n][2], v[u][n].z);
            sum[n][3] = __fadd_rn(sum[n][3], v[u][n].w);
          }
        }
      }
    }
    store(sum);
  }
  if (tid == 0) p.arrivals[group] = 0;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

template <int kPolicy, int NT>
int launch_one(const Params& p, int units, cudaStream_t stream) {
  const int smem = smem_bytes(kPolicy != kNF4, NT, p.slice_steps, p.row_warps);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(decode_matmul_kernel<kPolicy, NT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  decode_matmul_kernel<kPolicy, NT><<<units, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Checks the schedule the wrapper passes (ops/qlora_matmul.py:
// decode_schedule) and launches one block a unit.
template <int kPolicy>
int launch(Params& p, cudaStream_t stream) {
  p.steps = (p.L + kStep - 1) / kStep;
  const int WR = p.row_warps;
  if (p.M < 1 || p.M > 16 || p.N < 1 || p.K < 1 || (WR != 2 && WR != 4 && WR != 8) ||
      p.slice_steps < 1 || p.slices < 1 || (p.slices - 1) * p.slice_steps >= p.steps ||
      p.slices * p.slice_steps < p.steps ||
      (p.slices > 1 && (p.partials == nullptr || p.arrivals == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (p.N + 16 * WR - 1) / (16 * WR);
  const long long units = groups * p.slices;
  if (units > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  return p.M <= 8 ? launch_one<kPolicy, 1>(p, (int)units, stream)
                  : launch_one<kPolicy, 2>(p, (int)units, stream);
}

// ---------------------------------------------------------------------------
// The grouped form: K14's and K19's forwards at m <= 16 routed rows
//
//   y[r, :] = x[r, :] @ W_g^T (+ bias[g])   for the rows r of group g
//
// Rows of x are sorted by expert; group g owns rows [off_g, off_g +
// size_g), off the running sum of the int32 sizes (clamped to m), which
// stay on the device. The loop above, with two more weight policies:
//   * NF4Stacked: packed [E, N, K/2] in split-half order, fp32 absmax [E,
//     N K / B] at B = 32 or 64. Each 16-byte chunk of a side takes one
//     absmax (K/2 % 32 == 0: a chunk never straddles a block, even where
//     a block straddles K/2). Lane t of a row quad reads, for both its
//     rows, the absmax of element (t >> 1) K/2 + 64 st + 32 (t & 1) of the
//     step (a 32-element half of a side lies in one block at either B) and
//     hands it on by shuffle. The bias (fp32, or bf16 read exactly) is
//     added to the fp32 sum, which is rounded once (K14's store).
//   * Dense bf16 [E, N, K]: no decode. A lane's 16 bytes of a row are 8
//     weights, the A fragments of two mmas as they are; a step (64 bytes)
//     is 32 columns of x, and the B fragments of lane t are x columns 8 t
//     .. 8 t + 7 of it (x rows 64 bytes apart mod 128). The sum is rounded
//     to bf16, the bf16 bias added and the sum rounded again (K19's
//     epilogue). Four steps in flight, as NF4's (eight spill; six were no
//     faster on an H100).
// The schedule: units (slot, row group of 16 WR W rows, K slice), slot
// outermost, for min(m, E) slots; slot s takes the s-th expert that owns
// rows, which every warp finds from the sizes by ballots over 32 experts
// at a time; the blocks of a slot that no expert fills exit at once. WR
// and the slices are ops/qlora_matmul.py:grouped_decode_schedule's, laid
// from (m, E, N, K) alone (no call reads the sizes on the host): one
// slice wherever the slots' row groups fill the SMs, the row groups whose
// waves stream the fewest rows each; K split as above where they do not
// (m = 1). Only
// the slot's rows of x are staged. The blocks of slot 0's first slice also
// store zeros in the rows past the groups (their row group's columns), so
// y needs no memset: one launch a call. At S > 1 the last block of each
// (slot, row group) sums the slices' fp32 partials in slice order, as
// above. Counters (null, or int32 [3]): the units stored, the 16-byte
// chunks of W consumed, the slots that found no expert.
// ---------------------------------------------------------------------------

enum GroupedPolicy { kNF4Stacked = 0, kDense = 1 };

struct GroupedParams {
  const __nv_bfloat16* x;  // [M, K], rows sorted by expert
  const uint8_t* w;        // NF4: packed [E, N, K/2]; dense: bf16 [E, N, K]
  const float* absmax;     // NF4: fp32 [E, N K / B]
  int block_shift;         // NF4: log2 B
  const void* bias;        // [E, N] or null: fp32 or bf16 (NF4), bf16 (dense)
  bool bias_f32;
  const int* group_sizes;  // [E] int32
  int E;
  __nv_bfloat16* y;        // [M, N]
  float* partials;         // [units][WR][32][NT * 4] fp32, at S > 1
  int* arrivals;           // [slots * groups], 0 between calls, at S > 1
  int* counts;             // null or int32 [3]
  int M, N, K;
  int L;                   // bytes of a W row: K/2 or 2K
  int steps;               // ceil(L / 64)
  int row_warps, slices, slice_steps;
  int slots, groups;       // min(M, E); ceil(N / (16 WR))
};

// x columns of a side a step covers
__host__ __device__ constexpr int grouped_step_cols(int policy) {
  return policy == kNF4Stacked ? kStep : kStep / 2;
}

// The x slice's row stride in elements: rows 16 bytes apart mod 128 for
// NF4 (its lanes read 32 bytes apart), 64 for dense (16 apart).
__host__ __device__ inline int grouped_x_ld(int policy, int slice_steps) {
  const int xc = (policy == kNF4Stacked ? 2 : 1) * grouped_step_cols(policy) * slice_steps;
  return policy == kNF4Stacked ? xc + 8 : xc + (xc % 64 == 0 ? 32 : 0);
}

__host__ __device__ inline int grouped_smem_bytes(int policy, int nt, int slice_steps,
                                                  int row_warps) {
  const int xs = 8 * nt * grouped_x_ld(policy, slice_steps) * 2;
  const int red = (kWarps - row_warps) * 32 * nt * 4 * 4;
  return xs > red ? xs : red;
}

// The expert of a slot and its rows [lo, hi), expert -1 where fewer
// experts own rows; `total`, the rows in groups, where the walk ran to the
// end (`to_end`). Warp-uniform: each warp walks the sizes itself.
struct SlotRows {
  int expert, lo, hi, total;
};

__device__ __forceinline__ SlotRows find_slot(const int* __restrict__ sizes, int E, int M,
                                              int slot, bool to_end) {
  const int lane = threadIdx.x & 31;
  SlotRows r{-1, 0, 0, 0};
  int off = 0, seen = 0;
  for (int base = 0; base < E; base += 32) {
    const int e = base + lane;
    const int s = e < E ? min(max(__ldg(sizes + e), 0), M) : 0;
    int inc = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    const int lo = min(off + inc - s, M), hi = min(off + inc, M);
    const unsigned live = __ballot_sync(0xffffffffu, hi > lo);
    if (r.expert < 0 && slot - seen < __popc(live)) {
      unsigned b = live;
      for (int i = seen; i < slot; ++i) b &= b - 1;  // the live experts before the slot's
      const int src = __ffs(b) - 1;
      r.expert = base + src;
      r.lo = __shfl_sync(0xffffffffu, lo, src);
      r.hi = __shfl_sync(0xffffffffu, hi, src);
    }
    seen += __popc(live);
    off = min(off + __shfl_sync(0xffffffffu, inc, 31), M);
    if (r.expert >= 0 && !to_end) break;
  }
  r.total = off;
  return r;
}

template <int kPolicy, int NT>
__global__ void __launch_bounds__(kThreads, 2)
grouped_decode_kernel(const GroupedParams p) {
  constexpr bool kNF4 = kPolicy == kNF4Stacked;
  // (NF4 at m > 8 holds one step fewer: its second n-tile's registers)
  constexpr int kDepth = kNF4 && NT == 2 ? kRing - 1 : kRing;
  constexpr int kCols = grouped_step_cols(kPolicy);
  constexpr int kSides = kNF4 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float code[16];
  __shared__ int last;
  __shared__ __align__(8) uint64_t x_bar;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int WR = p.row_warps, KP = kWarps / WR;
  const int rw = warp % WR, kp = warp / WR;
  const int slot = blockIdx.x / (p.groups * p.slices);
  const int gid = blockIdx.x / p.slices;  // (slot, row group): slot * groups + group
  const int group = gid - slot * p.groups, slice = blockIdx.x % p.slices;
  const int n0 = group * 16 * WR;
  const bool zeroes = slot == 0 && slice == 0;  // stores the rows past the groups
  const SlotRows sr = find_slot(p.group_sizes, p.E, p.M, slot, zeroes);
  if (zeroes && sr.total < p.M) {
    const int cols = min(16 * WR, p.N - n0);
    for (int c = tid; c < (p.M - sr.total) * cols; c += kThreads)
      p.y[(size_t)(sr.total + c / cols) * p.N + n0 + c % cols] = __float2bfloat16(0.0f);
  }
  if (sr.expert < 0) {
    if (p.counts != nullptr && tid == 0 && group == 0 && slice == 0) atomicAdd(p.counts + 2, 1);
    return;
  }
  const int rows = sr.hi - sr.lo;  // x rows of the slot
  const int sps = p.slice_steps;
  const int s0 = slice * sps;
  const int s1 = min(s0 + sps, p.steps);
  const size_t wrow = (size_t)sr.expert * p.N;  // the expert's first W row
  const int r0 = n0 + 16 * rw + g, r1 = r0 + 8;
  const bool v0 = r0 < p.N, v1 = r1 < p.N;
  // this warp's steps: s0 + kp, s0 + kp + KP, ...
  const int nst = s1 - s0 > kp ? (s1 - s0 - kp + KP - 1) / KP : 0;
  const uint8_t* row0 = p.w + (wrow + r0) * p.L;
  const uint8_t* row1 = p.w + (wrow + r1) * p.L;

  // x: the slot's rows, the slice's columns of each side (NF4: the high
  // side at 0, the low side at kCols * sps), zeros past the row; one bulk
  // copy a row and side by warp 0's lanes, completing x_bar
  const int side_cols = kCols * sps;
  const int xld = grouped_x_ld(kPolicy, sps);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  const int x_valid = min(kCols * (s1 - s0), (kNF4 ? p.K / 2 : p.K) - kCols * s0);
  if (warp == 0) {
    if (lane == 0) {
      hopper::mbar_init(&x_bar, 1);
      hopper::fence_barrier_init();
      hopper::mbar_expect_tx(&x_bar, (uint32_t)(rows * kSides * x_valid * 2));
    }
    __syncwarp();
    for (int c = lane; c < rows * kSides; c += 32) {
      const int m = c / kSides, side = c - m * kSides;
      bulk_load(xs + m * xld + side * side_cols,
                p.x + (size_t)(sr.lo + m) * p.K + side * (p.K / 2) + kCols * s0, x_valid * 2,
                &x_bar);
    }
  }
  const int tail = side_cols - x_valid;
  if (tail)  // the last slice: zeros past the row
    for (int c = tid; c < rows * kSides * tail; c += kThreads) {
      const int ms = c / tail, j = x_valid + c - ms * tail;
      xs[(ms / kSides) * xld + (ms % kSides) * side_cols + j] = __float2bfloat16(0.0f);
    }
  if (kNF4 && tid < 16) code[tid] = kNF4Code[tid];

  // Each step's loads, kDepth steps ahead: 16 bytes of each of the lane's
  // two W rows, and for NF4 the absmax of both rows at element (t >> 1)
  // K/2 + 64 st + 32 (t & 1) (0 past the row).
  const int per_row = kNF4 ? p.K >> p.block_shift : 0;
  const float* am0 = kNF4 ? p.absmax + (wrow + r0) * per_row : nullptr;
  const float* am1 = kNF4 ? am0 + 8 * per_row : nullptr;
  uint4 ring[kDepth][2];
  float aux[kNF4 ? kDepth : 1][2];
  auto fetch = [&](int d, int i) {
    const int st = s0 + kp + i * KP;
    const int kb = kStep * st + 16 * t;
    const bool in = i < nst && kb < p.L;
    ring[d][0] = in && v0 ? ld_stream(row0 + kb) : make_uint4(0u, 0u, 0u, 0u);
    ring[d][1] = in && v1 ? ld_stream(row1 + kb) : make_uint4(0u, 0u, 0u, 0u);
    if constexpr (kNF4) {
      const int c = kStep * st + 32 * (t & 1);
      aux[d][0] = aux[d][1] = 0.0f;
      if (i < nst && c < p.L) {
        const int blk = ((t >> 1) * p.L + c) >> p.block_shift;
        if (v0) aux[d][0] = __ldg(am0 + blk);
        if (v1) aux[d][1] = __ldg(am1 + blk);
      }
    }
  };
#pragma unroll
  for (int d = 0; d < kDepth; ++d) fetch(d, d);
  __syncthreads();  // x_bar's init, the zeros and the code table
  hopper::mbar_wait(&x_bar, 0);

  const int quad = lane & ~3;
  const int hi_src = quad | (t >> 1), lo_src = quad | 2 | (t >> 1);
  float acc[2][NT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][n][e] = 0.0f;

  for (int i0 = 0; i0 < nst; i0 += kDepth) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int i = i0 + d;
      if (i >= nst) break;
      const uint4 w0 = ring[d][0], w1 = ring[d][1];
      float m0 = 0.0f, m1 = 0.0f;
      if constexpr (kNF4) {
        m0 = aux[d][0];
        m1 = aux[d][1];
      }
      fetch(d, i + kDepth);
      const int ls = kp + i * KP;  // the step within the slice
      if constexpr (kNF4) {
        const int xo = kStep * ls + 16 * t;
        const float ah0 = __shfl_sync(0xffffffffu, m0, hi_src);
        const float ah1 = __shfl_sync(0xffffffffu, m1, hi_src);
        const float al0 = __shfl_sync(0xffffffffu, m0, lo_src);
        const float al1 = __shfl_sync(0xffffffffu, m1, lo_src);
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const __nv_bfloat16* xrow = xs + g * xld + side * side_cols + xo;
          const float a0s = side ? al0 : ah0, a1s = side ? al1 : ah1;
          uint4 bq[NT];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const uint32_t q0 = word(w0, s), q1 = word(w1, s);
            const uint32_t o0 = side ? (q0 << 2) & 0x3C3C3C3Cu : (q0 >> 2) & 0x3C3C3C3Cu;
            const uint32_t o1 = side ? (q1 << 2) & 0x3C3C3C3Cu : (q1 >> 2) & 0x3C3C3C3Cu;
            const uint32_t a0 = nf4_pair(code, o0, 0, a0s);
            const uint32_t a1 = nf4_pair(code, o1, 0, a1s);
            const uint32_t a2 = nf4_pair(code, o0, 1, a0s);
            const uint32_t a3 = nf4_pair(code, o1, 1, a1s);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              if (s % 2 == 0) bq[n] = xfrag(xrow + 8 * n * xld, s);
              mma_bf16(acc[side][n], a0, a1, a2, a3, s % 2 ? bq[n].z : bq[n].x,
                       s % 2 ? bq[n].w : bq[n].y);
            }
          }
        }
      } else {
        // bytes 16 t .. 16 t + 15 of each row: weights 8 t .. 8 t + 7 of the
        // step, k columns {2t, 2t+1, 2t+8, 2t+9} of two mmas
        const __nv_bfloat16* xrow = xs + g * xld + (kStep / 2) * ls + 8 * t;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint4 b = *reinterpret_cast<const uint4*>(xrow + 8 * n * xld);
          mma_bf16(acc[0][n], w0.x, w1.x, w0.y, w1.y, b.x, b.y);
          mma_bf16(acc[1][n], w0.z, w1.z, w0.w, w1.w, b.z, b.w);
        }
      }
    }
  }

  // The warp's partial: its two chains, then the slice's warps in order.
  float c[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = __fadd_rn(acc[0][n][e], acc[1][n][e]);
  __syncthreads();  // the x slice is no longer read
  float4* red = reinterpret_cast<float4*>(smem);
  if (kp > 0) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
      red[(((kp - 1) * WR + rw) * 32 + lane) * NT + n] = make_float4(c[n][0], c[n][1], c[n][2], c[n][3]);
  }
  __syncthreads();
  if (kp == 0) {
    for (int q = 1; q < KP; ++q) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float4 v = red[(((q - 1) * WR + rw) * 32 + lane) * NT + n];
        c[n][0] = __fadd_rn(c[n][0], v.x);
        c[n][1] = __fadd_rn(c[n][1], v.y);
        c[n][2] = __fadd_rn(c[n][2], v.z);
        c[n][3] = __fadd_rn(c[n][3], v.w);
      }
    }
  }

  if (p.counts != nullptr) {
    // 16-byte chunks this lane read: its valid rows times its steps' chunks
    int chunks = 0;
    for (int i = 0; i < nst; ++i)
      if (kStep * (s0 + kp + i * KP) + 16 * t < p.L) chunks += (int)v0 + (int)v1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) chunks += __shfl_xor_sync(0xffffffffu, chunks, o);
    if (lane == 0 && chunks) atomicAdd(p.counts + 1, chunks);
    if (tid == 0) atomicAdd(p.counts, 1);
  }

  // Adds the bias, rounds and stores this lane's outputs: (the slot's x
  // row 8n + 2t + {0, 1}, W rows r0 and r1).
  const float* bias_f = static_cast<const float*>(p.bias);
  const __nv_bfloat16* bias_h = static_cast<const __nv_bfloat16*>(p.bias);
  auto store = [&](float (&v)[NT][4]) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int mm = 8 * n + 2 * t + (e & 1);
        const int r = e < 2 ? r0 : r1;
        if (mm < rows && r < p.N) {
          __nv_bfloat16 out;
          if constexpr (kNF4) {
            float o = v[n][e];
            if (p.bias != nullptr)
              o = __fadd_rn(o, p.bias_f32 ? bias_f[wrow + r] : __bfloat162float(bias_h[wrow + r]));
            out = __float2bfloat16_rn(o);
          } else {
            out = __float2bfloat16_rn(v[n][e]);
            if (p.bias != nullptr)
              out = __float2bfloat16_rn(
                  __fadd_rn(__bfloat162float(out), __bfloat162float(bias_h[wrow + r])));
          }
          p.y[(size_t)(sr.lo + mm) * p.N + r] = out;
        }
      }
    }
  };
  if (p.slices == 1) {
    if (kp == 0) store(c);
    return;
  }
  if (kp == 0) {
    float4* mine = reinterpret_cast<float4*>(p.partials) +
                   (((size_t)blockIdx.x * WR + rw) * 32 + lane) * NT;
#pragma unroll
    for (int n = 0; n < NT; ++n) __stcg(mine + n, make_float4(c[n][0], c[n][1], c[n][2], c[n][3]));
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(p.arrivals + gid, 1) == p.slices - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (kp == 0) {
    // the slices' partials in slice order, one rounding
    const float4* base = reinterpret_cast<const float4*>(p.partials) +
                         (((size_t)gid * p.slices * WR + rw) * 32 + lane) * NT;
    const size_t per_unit = (size_t)WR * 32 * NT;
    float sum[NT][4];
    for (int q0 = 0; q0 < p.slices; q0 += 8) {
      float4 v[8][NT];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int n = 0; n < NT; ++n)
          if (q0 + u < p.slices) v[u][n] = __ldcg(base + (q0 + u) * per_unit + n);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (q0 + u >= p.slices) break;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (q0 + u == 0) {
            sum[n][0] = v[u][n].x; sum[n][1] = v[u][n].y;
            sum[n][2] = v[u][n].z; sum[n][3] = v[u][n].w;
          } else {
            sum[n][0] = __fadd_rn(sum[n][0], v[u][n].x);
            sum[n][1] = __fadd_rn(sum[n][1], v[u][n].y);
            sum[n][2] = __fadd_rn(sum[n][2], v[u][n].z);
            sum[n][3] = __fadd_rn(sum[n][3], v[u][n].w);
          }
        }
      }
    }
    store(sum);
  }
  if (tid == 0) p.arrivals[gid] = 0;
}

template <int kPolicy, int NT>
int launch_grouped_one(const GroupedParams& p, int units, cudaStream_t stream) {
  const int smem = grouped_smem_bytes(kPolicy, NT, p.slice_steps, p.row_warps);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(grouped_decode_kernel<kPolicy, NT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  grouped_decode_kernel<kPolicy, NT><<<units, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Checks the schedule the wrapper passes (ops/qlora_matmul.py:
// grouped_decode_schedule) and launches one block a unit.
template <int kPolicy>
int launch_grouped(GroupedParams& p, cudaStream_t stream) {
  p.steps = (p.L + kStep - 1) / kStep;
  const int WR = p.row_warps;
  if (p.M < 1 || p.M > 16 || p.N < 1 || p.K < 1 || p.E < 1 ||
      (WR != 2 && WR != 4 && WR != 8) || p.slice_steps < 1 || p.slices < 1 ||
      (p.slices - 1) * p.slice_steps >= p.steps || p.slices * p.slice_steps < p.steps ||
      (p.slices > 1 && (p.partials == nullptr || p.arrivals == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  p.slots = p.M < p.E ? p.M : p.E;
  p.groups = (p.N + 16 * WR - 1) / (16 * WR);
  const long long units = (long long)p.slots * p.groups * p.slices;
  if (units > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  return p.M <= 8 ? launch_grouped_one<kPolicy, 1>(p, (int)units, stream)
                  : launch_grouped_one<kPolicy, 2>(p, (int)units, stream);
}

}  // namespace

// y = x @ dequant(W)^T at M <= 16 for an NF4 W on `stream`. x [M, K] bf16
// row-major, packed [N, K/2] u8, y [M, N] bf16; K/2 % 32 == 0 and x and
// packed 16-byte aligned (the wrapper checks). The absmax as stored: fp32
// `absmax` [N K / 64], or (absmax null) int8 `codes` with fp32
// `code_scale` [ceil(N K / 64 / double_block)] and the fp32 `code_offset`.
// The schedule (row_warps, slices, slice_steps) is decode_schedule's; at
// slices > 1 `partials` (fp32, units * 16 row_warps * 8 NT floats, NT =
// 1 at M <= 8 else 2) and `arrivals` (int32 [groups], all 0, left 0) are
// required. `counts` (null, or an int32 [2]): units stored, 16-byte
// chunks of W read. Returns cudaGetLastError() after the launch;
// allocates nothing.
extern "C" int unsloth_decode_matmul_nf4(const void* x, const void* packed, const void* absmax,
                                         const void* codes, const void* code_scale,
                                         const void* code_offset, int double_block, void* y,
                                         void* partials, void* arrivals, int M, int N, int K,
                                         int row_warps, int slices, int slice_steps,
                                         void* counts, void* stream) {
  Params p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const uint8_t*>(packed);
  p.absmax = static_cast<const float*>(absmax);
  p.codes = static_cast<const int8_t*>(codes);
  p.code_scale = static_cast<const float*>(code_scale);
  p.code_offset = static_cast<const float*>(code_offset);
  p.double_block = double_block;
  // (idx * magic) >> 40 == idx / double_block while idx * double_block <
  // 2^40 (checked below)
  p.group_magic = double_block > 0 ? ((1ull << 40) + double_block - 1) / double_block : 0;
  p.y = static_cast<__nv_bfloat16*>(y);
  p.partials = static_cast<float*>(partials);
  p.arrivals = static_cast<int*>(arrivals);
  p.counts = static_cast<int*>(counts);
  p.M = M;
  p.N = N;
  p.K = K;
  p.L = K / 2;
  p.row_warps = row_warps;
  p.slices = slices;
  p.slice_steps = slice_steps;
  p.w_vec = true;
  p.x_vec = true;
  if (K % 64 || !aligned16(x) || !aligned16(packed) ||
      (absmax == nullptr && (codes == nullptr || code_scale == nullptr ||
                             code_offset == nullptr || double_block < 1 ||
                             (long long)N * (K / 64) * double_block >= (1ll << 40))))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<kNF4>(p, static_cast<cudaStream_t>(stream));
}

// y = x @ dequant(W)^T at M <= 16 for a block-scaled e4m3 W on `stream`.
// x [M, K] bf16, w e4m3 [N, K], scales fp32 [ceil(N/B), ceil(K/B)], y [M,
// N] bf16; any N, K >= 1 and B >= 1, no alignment needed (16-byte loads
// where K and the pointers allow). Schedule, partials, arrivals and counts
// as unsloth_decode_matmul_nf4's.
extern "C" int unsloth_decode_matmul_fp8(const void* x, const void* w, const void* scales,
                                         int block, void* y, void* partials, void* arrivals,
                                         int M, int N, int K, int row_warps, int slices,
                                         int slice_steps, void* counts, void* stream) {
  Params p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const uint8_t*>(w);
  p.scales = static_cast<const float*>(scales);
  p.block = block;
  p.scale_cols = (K + block - 1) / block;
  // (k * magic) >> 40 == k / B while k * B < 2^40 (checked below)
  p.block_magic = block > 0 ? ((1ull << 40) + block - 1) / block : 0;
  p.y = static_cast<__nv_bfloat16*>(y);
  p.partials = static_cast<float*>(partials);
  p.arrivals = static_cast<int*>(arrivals);
  p.counts = static_cast<int*>(counts);
  p.M = M;
  p.N = N;
  p.K = K;
  p.L = K;
  p.row_warps = row_warps;
  p.slices = slices;
  p.slice_steps = slice_steps;
  p.w_vec = K % 16 == 0 && aligned16(w);
  p.x_vec = K % 8 == 0 && aligned16(x);
  p.chunk_scale = block % 16 == 0;
  if (block < 1 || (long long)K * block >= (1ll << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.w_vec && p.x_vec && p.chunk_scale ? launch<kE4m3>(p, s) : launch<kE4m3Any>(p, s);
}

// K14 at m <= 16 routed rows (nf4_gmm.cu's entry point sends them here):
// y = x @ dequant(W_g)^T + bias[g] per group on `stream`. x [m, K] bf16
// rows sorted by expert, packed [E, N, K/2] u8, absmax fp32 [E, N K /
// block] (block 32 or 64, K/2 a multiple of it and of 32), bias [E, N]
// fp32 (`bias_f32`) or bf16, or null, group_sizes [E] int32 on the device,
// y [m, N] bf16, every row written (zeros past the groups); x and packed
// 16-byte aligned. The schedule and scratch are grouped_decode_schedule's
// and the decode kernel's; `counts` (null, or an int32 [3]): units
// stored, 16-byte chunks of W read, slots that found no expert.
int unsloth_decode_gmm_nf4(const void* x, const void* packed, const void* absmax, int block,
                           const void* bias, bool bias_f32, const void* group_sizes, void* y,
                           void* partials, void* arrivals, int M, int E, int N, int K,
                           int row_warps, int slices, int slice_steps, void* counts,
                           cudaStream_t stream) {
  GroupedParams p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const uint8_t*>(packed);
  p.absmax = static_cast<const float*>(absmax);
  p.block_shift = block == 32 ? 5 : 6;
  p.bias = bias;
  p.bias_f32 = bias_f32;
  p.group_sizes = static_cast<const int*>(group_sizes);
  p.E = E;
  p.y = static_cast<__nv_bfloat16*>(y);
  p.partials = static_cast<float*>(partials);
  p.arrivals = static_cast<int*>(arrivals);
  p.counts = static_cast<int*>(counts);
  p.M = M;
  p.N = N;
  p.K = K;
  p.L = K / 2;
  p.row_warps = row_warps;
  p.slices = slices;
  p.slice_steps = slice_steps;
  if ((block != 32 && block != 64) || (K / 2) % 32 || (K / 2) % block || absmax == nullptr ||
      !aligned16(x) || !aligned16(packed))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_grouped<kNF4Stacked>(p, stream);
}

// K19's forward at m <= 16 routed rows (gmm.cu's entry point sends them
// here): y = x @ W_g^T (+ bias[g]) per group on `stream`. x [m, K] bf16
// rows sorted by expert, w [E, N, K] bf16, bias [E, N] bf16 or null,
// group_sizes, y, schedule, scratch and counts as the NF4 form's; K a
// multiple of 8, x and w 16-byte aligned.
int unsloth_decode_gmm_bf16(const void* x, const void* w, const void* bias,
                            const void* group_sizes, void* y, void* partials, void* arrivals,
                            int M, int E, int N, int K, int row_warps, int slices,
                            int slice_steps, void* counts, cudaStream_t stream) {
  GroupedParams p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const uint8_t*>(w);
  p.bias = bias;
  p.group_sizes = static_cast<const int*>(group_sizes);
  p.E = E;
  p.y = static_cast<__nv_bfloat16*>(y);
  p.partials = static_cast<float*>(partials);
  p.arrivals = static_cast<int*>(arrivals);
  p.counts = static_cast<int*>(counts);
  p.M = M;
  p.N = N;
  p.K = K;
  p.L = 2 * K;
  p.row_warps = row_warps;
  p.slices = slices;
  p.slice_steps = slice_steps;
  if (K % 8 || !aligned16(x) || !aligned16(w)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_grouped<kDense>(p, stream);
}
