// The parts shared by K19's persistent Hopper kernels: gmm.cu (forward and
// dx, gmm_wgmma_kernel) and tgmm.cu (the expert weight gradient,
// tgmm_kernel). Everything lives in namespace gmm.
//
// Both kernels are one block per SM (384 threads; gmm.cu's in clusters of
// two): warpgroups 0 and 1 consume, warpgroup 2 produces. One thread of
// the producer walks the block's work units and keeps a kStages-deep ring
// of TMA loads in flight (full[s] completes when stage s has landed,
// empty[s] when the consumer warps, of both CTAs of a cluster in gmm.cu,
// are done with it). Each consumer warpgroup owns 64 rows of
// a 128 x 192 output tile: it issues m64n192k16 wgmma from shared memory
// with fp32 accumulators in registers (96 a thread), then, in its
// epilogue, rounds them to bf16 into its own 64 x 192 staging area (three
// 128-byte-swizzled [64][64] sub-tiles, the layout TMA stores read) and
// stores the half by TMA, or by masked 16-byte stores where only some of
// its rows are the unit's. The producer loads the next unit's stages while
// the consumers round and store.
//
// Stage layout: A (two [..][64] sub-tiles, 16 KB), then B (three, 24 KB);
// forward / dx A is [128 rows][64] and B is W's 192 x 64; tgmm A is gy's
// [64 rows][128 columns] and B lhs's [64 rows][192 columns].

#pragma once

#include "hopper_common.cuh"

namespace gmm {

using namespace hopper;
using hopper::bf16;

constexpr int kThreads = 384;             // two consumer warpgroups, then the producer's
constexpr int kStages = 4;                // ring depth
constexpr int kSubBytes = 64 * 128;       // one [64][64] bf16 sub-tile
constexpr int kABytes = 2 * kSubBytes;
constexpr int kBBytes = 3 * kSubBytes;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kHalfOutBytes = 3 * kSubBytes;  // a warpgroup's 64 x 192 bf16 result
constexpr int kOffOut = kStages * kStageBytes;
constexpr int kOffBar = kOffOut + 2 * kHalfOutBytes;
constexpr int kOffTab = kOffBar + 2 * kStages * 8;  // the per-expert tables
constexpr int kMaxExperts = 1024;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// The dynamic shared memory of a launch whose tables hold `ints` ints (the
// launch asks for 1,024 bytes more to align the base).
constexpr int smem_bytes(int ints) { return kOffTab + 4 * ints + 1024; }

// Arrive on empty[s] once per consumer warp (tgmm.cu: one CTA's ring).
__device__ __forceinline__ void release(uint64_t* empty, int s, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[s]);
}

// The bf16 bias pairs of the columns a thread's accumulator holds (column
// col0 + 8 j + 2 (lane % 4) and the next, for j < 24; zeros past ncols),
// as the epilogue adds them. The loads are volatile so that they issue
// here, before the main loop hides their latency, and not at their use in
// the epilogue. `bias_row` is 4-byte aligned (the wrapper's is 16).
__device__ __forceinline__ void load_bias(uint32_t (&pairs)[24], const bf16* bias_row, int col0,
                                          int ncols, int lane) {
#pragma unroll
  for (int j = 0; j < 24; ++j) {
    const int col = col0 + 8 * j + 2 * (lane % 4);
    uint32_t v = 0;
    if (col < ncols) asm volatile("ld.global.nc.b32 %0, [%1];\n" : "=r"(v) : "l"(bias_row + col));
    pairs[j] = v;
  }
}

// Rounds a warpgroup's 64 x 192 accumulator (thread t of the warpgroup) to
// bf16 into `stage`, at row r column c of sub-tile c / 64 with the 128-byte
// swizzle. With `bias`, the bias pairs of load_bias are then added to the
// rounded values and the sums rounded again. Called only where the
// products that wrote `acc` have been waited for: ptxas serializes the
// products (C7514) where it finds a path that reads an accumulator with
// products pending.
__device__ __forceinline__ void stage_half(unsigned char* stage, const float (&acc)[96], bool bias,
                                           const uint32_t (&pairs)[24], int t) {
  const int warp = t / 32, lane = t % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + lane / 4 + 8 * i;
    unsigned char* row = stage + r * 128 + (lane % 4) * 4;
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      if (bias) {
        const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(&pairs[j]);
        v = __floats2bfloat162_rn(__low2float(v) + __low2float(bb),
                                  __high2float(v) + __high2float(bb));
      }
      *reinterpret_cast<__nv_bfloat162*>(row + (j / 8) * kSubBytes +
                                         (((j % 8) ^ (r % 8)) * 16)) = v;
    }
  }
}

// Zeros in a warpgroup's staging area.
__device__ __forceinline__ void stage_zero(unsigned char* stage, int t) {
  for (int q = t; q < kHalfOutBytes / 16; q += 128)
    reinterpret_cast<uint4*>(stage)[q] = make_uint4(0, 0, 0, 0);
}

// The start of a warpgroup's epilogue: once the previous unit's TMA stores
// (thread 0's bulk groups) have read the staging area, its 128 threads may
// write it.
__device__ __forceinline__ void staging_free(int wg, int t) {
  if (t == 0) bulk_wait_read<0>();
  named_bar_sync(1 + wg, 128);
}

// The staged half is written: order the writes before the TMA stores'
// reads (async proxy) and the other threads' reads.
__device__ __forceinline__ void staging_done(int wg) {
  fence_proxy_async();
  named_bar_sync(1 + wg, 128);
}

// Copies the staged half (global rows row0 .. row0 + 63) to `out` (rows of
// `ld` elements) where the row lies in [lo, hi) and the column below
// ncols, 16 bytes a thread at a time (thread t of the warpgroup).
__device__ __forceinline__ void store_rows(const unsigned char* stage, bf16* out, int ld,
                                           int row0, int lo, int hi, int col0, int ncols, int t) {
  for (int q = t; q < 64 * 24; q += 128) {
    const int r = q / 24, jc = q % 24;
    const int row = row0 + r, col = col0 + 8 * jc;
    if (row < lo || row >= hi || col >= ncols) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(stage + (jc / 8) * kSubBytes + r * 128 +
                                                    (((jc % 8) ^ (r % 8)) * 16));
    *reinterpret_cast<uint4*>(out + (size_t)row * ld + col) = v;
  }
}

// The SMs of the current device (the persistent grid's size).
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
    return 132;
  return n;
}

}  // namespace gmm
