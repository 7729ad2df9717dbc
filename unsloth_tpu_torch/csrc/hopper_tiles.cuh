// Hopper building blocks of the flash attention kernels (K16: flash_fwd.cu,
// flash_dq.cu, flash_dkv.cu): TMA tile loads into 128-byte-swizzled shared
// memory, mbarriers, warpgroup products (wgmma) as inline PTX for sm_90a,
// the tile-pair classes, and the host-side tensor maps. Everything lives in
// namespace hflash.
//
// Shared-memory tiles. A [rows][D] bf16 tile is stored as D / 64 sub-tiles
// of [rows][64], each row 128 bytes, written by TMA with the 128-byte
// swizzle (16-byte chunk c of row r lands at chunk c ^ (r % 8)); every
// sub-tile starts on a 1,024-byte boundary, so the swizzle atoms (8 rows x
// 128 bytes) line up with the address bits the hardware swizzles on. Such
// a tile is read by wgmma in two ways:
//   K-major (kmajor_desc): rows are wgmma's M or N, the 64 columns its K.
//     Stride between 8-row groups (SBO) 1,024 bytes; a k16 step inside a
//     sub-tile adds 32 bytes to the start address, the next sub-tile
//     starts a new run of four steps.
//   MN-major (mnmajor_desc, the transpose bit): rows are wgmma's K, the
//     columns its N. SBO 1,024 bytes between 8-row groups of K, LBO the
//     sub-tile's size between 64-column groups of N; a k16 step adds 16
//     rows (2,048 bytes).
// Accumulators follow wgmma's m64nN fp32 layout: thread t of a warpgroup
// (warp w = t / 32, lane l) holds rows 16 w + l / 4 + 8 i (i = 0, 1) and
// columns 8 j + 2 (l % 4) + c (c = 0, 1) in register 4 j + 2 i + c, so a
// row lives in the four threads of a quad. Registers 8 kk .. 8 kk + 7,
// packed to bf16 pairs, are the A fragment of a k16 step kk of a product
// with A from registers (score tile times V, dS times K, ...).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

namespace hflash {

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

// --- shared memory, barriers, TMA ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and add `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. (No watchdog trap
// in this loop: a trap in the kernel leaves ptxas short of registers for
// the wgmma pipeline, which it then serializes.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

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

// Registers a thread of this warpgroup may hold from here on: the producer
// warpgroup gives up registers, the consumer warpgroups take them
// (setmaxnreg; the warpgroup executes it together).
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --- wgmma -------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Step k (16 columns) of the K-major operand at `tile` ([rows][D] as D/64
// sub-tiles of `sub_bytes`), starting at byte `row_off` of each sub-tile.
__device__ __forceinline__ uint64_t kmajor_desc(const void* tile, int sub_bytes, int row_off,
                                                int k) {
  return sw128_desc(smem_u32(tile) + (k / 4) * sub_bytes + row_off + (k % 4) * 32, 16, 1024);
}

// Step k (16 rows) of the MN-major operand at `tile` (sub-tiles of
// `sub_bytes`).
__device__ __forceinline__ uint64_t mnmajor_desc(const void* tile, int sub_bytes, int k) {
  return sw128_desc(smem_u32(tile) + k * 2048, sub_bytes, 1024);
}

// 2^x by the special-function unit (ex2.approx: ~2 ulp; 2^-inf = +0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator's columns 16 kk .. 16 kk + 15 as the A fragment of step kk.
template <int N>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&d)[N], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // d (+)= A * B^T, A [64 x 16] and B [32 x 16] K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  // d (+)= A * B^T, A [64 x 16] and B [64 x 16] K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
  // d += A * B, A [64 x 16] in registers (the accumulator layout packed to
  // bf16 pairs), B [16 x 64] MN-major in shared memory (transposed)
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<128> {
  // d (+)= A * B^T, A [64 x 16] and B [128 x 16] K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
  }
  // d += A * B, A [64 x 16] in registers (the accumulator layout packed to
  // bf16 pairs), B [16 x 128] MN-major in shared memory (transposed)
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<256> {
  // d += A * B, A [64 x 16] in registers (the accumulator layout packed to
  // bf16 pairs), B [16 x 256] MN-major in shared memory (transposed)
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};


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

// The dynamic shared memory rounded up to 1,024 bytes (the launch asks for
// 1,024 more).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((1024u - (a & 1023u)) & 1023u);
}

// --- host ------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through cudart (cudaGetDriverEntryPoint),
// so the library links against cudart alone.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault) ==
            cudaSuccess &&
        sym != nullptr)
      fn = reinterpret_cast<EncodeTiledFn>(sym);
  }
  return fn;
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
