// K19 tgmm: the expert weight gradient of the grouped dense bf16 matmul.
//
//   dW[g, n, k] = sum over the rows r of group g of g[r, n] * lhs[r, k]
//
// Replaces megablox `tgmm` (jax.experimental.pallas.ops.tpu.megablox.
// gmm:573, pallas_call :763), the weight gradient that megablox's VJP runs
// (`_gmm_bwd`, ops.py:90) when unsloth_tpu/ops/moe.py:249's experts are
// trained (full fine-tuning). It is written straight into W's [E, N, K]
// layout, which fuses the swapaxes(1, 2) that megablox applies to its
// [E, K, N] result under transpose_rhs (ops.py:105).
//
// g [m, N] and lhs [m, K] bf16 with rows sorted by expert; group g owns
// rows [off_g, off_g + size_g) of the int32 group sizes on the device;
// rows past the groups count for none. bf16 products summed in fp32 over
// the group's rows, one rounding to bf16. An expert with no rows gets
// zeros, as megablox visits empty groups (visit_empty_groups=True,
// gmm.py:633-640). No atomics: each output element is summed by one thread,
// in row order, so a rerun gives the same bits. N and K multiples of 8.
//
// What bounds it on an H100: tensor-core throughput, 2 m N K operations
// (at m = 16,384, N = K = 2,880: 0.275 ms; its 720 MB of lhs, g and dW take
// 0.215 ms). Design (gmm_tiles.cuh has the block's structure): persistent,
// one block per SM walking work units b, b + grid, ... A unit is (expert,
// 128 x 192 tile of [N, K]), numbered expert by expert and, inside one,
// row tile by row tile of N with the column tiles of K fastest: the blocks
// in flight work on one or two experts, whose rows stay in L2. A unit
// reduces over its expert's rows in chunks of 64 from the group's first
// row (TMA takes any row): the producer loads g[r:r+64, n0:n0+128] (two
// [64][64] boxes) and lhs[r:r+64, k0:k0+192] (three). Consumer warpgroup
// w owns the tile's N rows n0 + 64 w ..: A = g^T, its [64 rows][64 columns
// of N] sub-tile read MN-major (wgmma's transpose bit for A), B = lhs read
// MN-major too. The last chunk of a group carries the next group's first
// rows: each warpgroup zeros its A sub-tile's rows past the group in shared
// memory, fences the generic-proxy writes against the async proxy
// (fence.proxy.async) and syncs its 128 threads before its products read
// them. A warpgroup whose N rows lie past N skips its products and its
// store. The epilogue rounds the half tile to bf16 and stores it by TMA
// through a 3-D map (K, N, E) of dW, which clips at N and K; an empty
// expert's units store zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gmm_tiles.cuh"

namespace gmm {
namespace {

constexpr int kTn = 128;    // N rows of a tile: two consumer warpgroups of 64
constexpr int kTk = 192;    // K columns of a tile (m64n192 products)
constexpr int kChunk = 64;  // rows of a reduction chunk: one stage

// Slots of the optional work-unit counters.
constexpr int kCntUnits = 0;    // units of an expert with rows
constexpr int kCntZero = 1;     // units of an empty expert (zeros)
constexpr int kCntChunks = 2;   // chunks reduced, over the units
constexpr int kCntZeroed = 3;   // of those, chunks whose rows past the group were zeroed

__global__ void __launch_bounds__(kThreads, 1)
    tgmm_kernel(const __grid_constant__ CUtensorMap tg,   // g [m, N], box 64 x 64
                const __grid_constant__ CUtensorMap tl,   // lhs [m, K], box 64 x 64
                const __grid_constant__ CUtensorMap tdw,  // dW (K, N, E), box 64 x 64 x 1
                const int* __restrict__ group_sizes, int* __restrict__ counts, int m, int E,
                int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* empty = full + kStages;
  int* offs = reinterpret_cast<int*>(smem + kOffTab);  // [E + 1]: group g's rows offs[g] ..
  int* order = offs + E + 1;                           // [E]: experts, largest group first
  const int nkt = (K + kTk - 1) / kTk;
  const int per = (N + kTn - 1) / kTn * nkt;  // units of an expert
  const int total = E * per;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  for (int g = threadIdx.x; g < E; g += kThreads) offs[g + 1] = group_sizes[g];
  __syncthreads();
  if (threadIdx.x == 0) {
    int off = 0;
    for (int g = 0; g < E; ++g) {
      const int end = min(off + max(offs[g + 1], 0), m);
      offs[g] = off;
      off = end;
    }
    offs[E] = off;
  }
  __syncthreads();
  // the walk's expert order: by rows, most first, ties by index (each
  // thread ranks its experts against all E)
  for (int g = threadIdx.x; g < E; g += kThreads) {
    const int rows = offs[g + 1] - offs[g];
    int rank = 0;
    for (int j = 0; j < E; ++j) {
      const int rj = offs[j + 1] - offs[j];
      rank += rj > rows || (rj == rows && j < g);
    }
    order[rank] = g;
  }
  __syncthreads();

  // warpgroup 2 produces (the index made warp-uniform, as in gmm.cu)
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 2) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int u = blockIdx.x; u < total; u += gridDim.x) {
      const int g = order[u / per], local = u % per;
      const int n0 = local / nkt * kTn, k0 = local % nkt * kTk;
      const int lo = offs[g], hi = offs[g + 1];
      for (int r = lo; r < hi; r += kChunk, ++it) {
        const int s = it % kStages, use = it / kStages;
        if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
        unsigned char* st = smem + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load_2d(st, &tg, &full[s], n0, r);
        tma_load_2d(st + kSubBytes, &tg, &full[s], n0 + 64, r);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          tma_load_2d(st + kABytes + c * kSubBytes, &tl, &full[s], k0 + 64 * c, r);
      }
    }
    return;
  }

  regs_inc<kConsumerRegs>();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  const int t = threadIdx.x % 128, lane = t % 32;
  unsigned char* staged = smem + kOffOut + wg * kHalfOutBytes;
  int n_units = 0, n_zero = 0, n_chunks = 0, n_zeroed = 0;
  int it = 0;
  for (int u = blockIdx.x; u < total; u += gridDim.x) {
    const int g = __shfl_sync(0xffffffffu, order[u / per], 0), local = u % per;
    const int n0 = local / nkt * kTn, k0 = local % nkt * kTk;
    // lane 0's rows (a shuffle: branches on them taken by whole warps, see
    // gmm.cu's warp_uniform)
    const int lo = __shfl_sync(0xffffffffu, offs[g], 0);
    const int hi = __shfl_sync(0xffffffffu, offs[g + 1], 0);
    const int nrow = n0 + 64 * wg;
    const bool live = nrow < N;  // this half holds rows of N
    const bool rows = hi > lo;
    n_units += rows;
    n_zero += !rows;
    float acc[96];
    if (live && rows) {
      for (int r = lo, c = 0; r < hi; r += kChunk, ++c, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        n_chunks += 1;
        unsigned char* a = smem + s * kStageBytes + wg * kSubBytes;
        if (hi - r < kChunk) {
          // the chunk runs past the group: zero this warpgroup's g rows
          // hi - r .. 63 before the products read them
          const int valid = hi - r;
          for (int q = t; q < (kChunk - valid) * 8; q += 128)
            reinterpret_cast<uint4*>(a + valid * 128)[q] = make_uint4(0, 0, 0, 0);
          fence_proxy_async();
          named_bar_sync(1 + wg, 128);
          n_zeroed += 1;
        }
        const uint32_t a0 = smem_u32(a);
        const uint32_t b0 = smem_u32(smem + s * kStageBytes + kABytes);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          Wgmma<kTk>::ss<1, 1>(acc, sw128_desc(a0 + 2048 * k, kSubBytes, 1024),
                               sw128_desc(b0 + 2048 * k, kSubBytes, 1024), c > 0 || k > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the products of the previous chunk are done
        if (c > 0) release(empty, (it - 1) % kStages, lane);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty, (it - 1) % kStages, lane);
      // epilogue: this warpgroup's 64 x 192 half of the tile
      staging_free(wg, t);
      const uint32_t no_bias[24] = {};
      stage_half(staged, acc, false, no_bias, t);
    } else if (rows) {
      // this half lies past N: hand the stages back
      for (int r = lo; r < hi; r += kChunk, ++it) {
        mbar_wait(&full[it % kStages], (it / kStages) & 1);
        release(empty, it % kStages, lane);
      }
      continue;
    } else if (live) {
      staging_free(wg, t);
      stage_zero(staged, t);
    } else {
      continue;
    }
    staging_done(wg);
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (k0 + 64 * c < K) tma_store_3d(&tdw, staged + c * kSubBytes, k0 + 64 * c, nrow, g);
      bulk_commit();
    }
  }
  if (t == 0) {
    bulk_wait<0>();
    if (counts != nullptr && wg == 0) {
      atomicAdd(counts + kCntUnits, n_units);
      atomicAdd(counts + kCntZero, n_zero);
      atomicAdd(counts + kCntChunks, n_chunks);
      atomicAdd(counts + kCntZeroed, n_zeroed);
    }
  }
}

}  // namespace
}  // namespace gmm

// dW = g^T @ lhs per group on `stream`: lhs [m, K] and g [m, N] bf16 rows
// sorted by expert, group_sizes [E] int32 on the device summing to at most
// m (rows past the groups are read by no unit), dW [E, N, K] bf16, every
// element written (an empty expert's are zeros). N and K multiples of 8,
// pointers 16-byte aligned, E <= 1,024 (the wrapper checks). `unit_counts`,
// when not null, is an int32 [4] to which the kernel adds its units of an
// expert with rows, its units of an empty expert, the 64-row chunks it
// reduced and those of them whose rows past the group it zeroed (warpgroup
// 0's count). Returns cudaGetLastError() after the launch; allocates
// nothing.
extern "C" int unsloth_gmm_tgmm_bf16(const void* lhs, const void* g, const void* group_sizes,
                                     void* dw, int m, int E, int N, int K, void* unit_counts,
                                     void* stream) {
  using namespace gmm;
  if (E < 1 || E > kMaxExperts) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tg, tl, tdw;
  const uint64_t dims_g[2] = {(uint64_t)N, (uint64_t)m};
  const uint64_t dims_l[2] = {(uint64_t)K, (uint64_t)m};
  const uint64_t dims_w[3] = {(uint64_t)K, (uint64_t)N, (uint64_t)E};
  const uint32_t box[3] = {64, 64, 1};
  int e = bf16_map(&tg, g, 2, dims_g, box);
  if (e == 0) e = bf16_map(&tl, lhs, 2, dims_l, box);
  if (e == 0) e = bf16_map(&tdw, dw, 3, dims_w, box);
  if (e != 0) return e;
  static bool configured = false;
  if (!configured) {
    e = static_cast<int>(cudaFuncSetAttribute(
        tgmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(2 * kMaxExperts + 1)));
    if (e != 0) return e;
    configured = true;
  }
  const long units = (long)E * ((N + kTn - 1) / kTn) * ((K + kTk - 1) / kTk);
  const int grid = (int)(units < sm_count() ? units : sm_count());
  tgmm_kernel<<<grid, kThreads, smem_bytes(2 * E + 1), static_cast<cudaStream_t>(stream)>>>(
      tg, tl, tdw, static_cast<const int*>(group_sizes), static_cast<int*>(unit_counts), m, E, N,
      K);
  return static_cast<int>(cudaGetLastError());
}
