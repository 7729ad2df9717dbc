// Grouped dense bf16 matmul over experts (the MoE expert products when the
// experts are dense bf16 stacks), K19 forward and dx.
//
//   forward  out[r, :] = lhs[r, :] @ W_g^T (+ bias[g])   for the rows r of group g
//   dx       dx[r, :]  = g[r, :] @ W_g
//
// Replaces the TPU kernel megablox `gmm` (jax.experimental.pallas.ops.tpu.
// megablox.gmm:314, pallas_call :526; imported by unsloth_tpu/ops/moe.py:177
// and called through tiled_gmm at :249 with transpose_rhs=True), and the
// transpose_rhs-flipped `gmm` that megablox's VJP runs for the gradient of
// its lhs (megablox/ops.py:80). The weight gradient, megablox `tgmm`, is
// tgmm.cu.
//
// Arithmetic: bf16 products summed in fp32, one rounding to bf16; the
// forward's optional per-expert bf16 bias is then added to the rounded
// product and the sum rounded again, as the JAX package adds its gathered
// bf16 bias rows to gmm's output cast to the input dtype (moe.py:258-276).
// No atomics: each output element is summed by one thread in one order, so
// a rerun gives the same bits.
//
// Layout: rows of lhs (and of g, dx, out) are sorted by expert; group g
// owns rows [off_g, off_g + size_g), off the running sum of the int32 group
// sizes, which stay on the device. W is [E, N, K] row-major (out-major, as
// the JAX package keeps expert stacks). Both directions run one kernel body
// over a reduction dim RED and an output dim OUT: forward RED = K, OUT = N,
// B(i, j) = W_g[j, i]; dx RED = N, OUT = K, B(i, j) = W_g[i, j]. N and K
// must be multiples of 8 (TMA strides and 16-byte stores); ragged edges of
// both are masked in the kernel (TMA reads zeros past them and clips its
// stores at them) where the TPU launcher pads them in memory to a multiple
// of 128 (gpt-oss: N = K = 2,880 = 22.5 x 128 = 15 x 192).
//
// What bounds it on an H100: at training row counts (m = 16,384 sorted
// rows, N = K = 2,880) tensor-core throughput, 2 m N K operations (the
// bytes, 720 MB, take 0.215 ms against the operations' 0.275); at decode
// (8 rows over at most 8 experts) the bytes of the visited experts'
// weights.
//
// Training rows (m > 64): gmm_wgmma_kernel<DX>, persistent and
// warp-specialised (gmm_tiles.cuh has the block's structure), in clusters
// of two CTAs. The grid is as many clusters as are resident at once (66 on
// an H100). A unit is (visit, 192-column tile of the output): a 128-row
// tile that straddles two experts is visited once per expert, each visit
// storing only its own rows [lo, hi); the rows past the last group form
// one more group whose units store zeros (so the wrapper allocates the
// output with torch.empty). The block builds the running sums of the group
// sizes and the first unit of each group in shared memory once and maps a
// unit to its group by binary search. Units are numbered group by group
// and, inside a group, column tile by column tile with the group's visits
// fastest, so the blocks in flight share W_g's 192-row slabs in L2 and
// each visit's rows (737 KB at K = 2,880) stay in L2 across its 15 column
// tiles. A cluster takes the units in pairs (2 q, 2 q + 1), q = cluster,
// cluster + clusters, ..., one a CTA: two visits of one (expert, column
// tile) share W_g's box, so each CTA loads half of it and multicasts it
// to both (TMA .multicast::cluster), which halves W_g's share of the L2
// traffic that bounds the loads (a stage moves 40 KB for 3.1 MFLOP). The
// producer loads A (lhs, or g for dx) as a [128][64] box of a 2-D map and
// W_g from a 3-D map (K, N, E): for the forward one K-major [192][64] box,
// for dx three [64 rows of N][64 columns of K] boxes (B MN-major: wgmma's
// transpose bit). A consumer warpgroup whose 64 rows hold none of the
// visit's rows skips the products. The epilogue rounds, adds the bias and
// rounds again in registers, stages the bf16 half tile in shared memory
// and stores it by TMA where the visit owns all 64 rows, else by masked
// 16-byte stores.
//
// Small row counts (m <= 64): the wmma kernel below (16 x 64 tiles of
// four warps, cp.async 4 stages deep, one block per (column tile, visit);
// the visit found by expert_visits.cuh), for dx and for the forward at
// 17-64 rows. The forward at decode rows (m <= 16) runs decode_matmul.cu's
// grouped_decode_kernel<Dense, NT> instead (split K, each expert that owns
// rows read once, one launch a call).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "expert_visits.cuh"
#include "gmm_tiles.cuh"

using namespace nvcuda;

namespace {

using bf16 = __nv_bfloat16;

// 16 bytes global -> shared, asynchronously; zeros where `ok` is false
// (the source size 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool DX>
struct GmmTile {
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = (BM / WM) * kWarpsN * 32;
  static constexpr int kLda = BK + 8;               // bf16, padded rows
  static constexpr int kLdb = DX ? BN + 8 : BK + 8;
  static constexpr int kAElems = BM * kLda;
  static constexpr int kBElems = DX ? BK * kLdb : BN * kLdb;
  static constexpr int kStage = kAElems + kBElems;
  static constexpr int kSmemBytes = STAGES * kStage * 2;
  static_assert(kSmemBytes >= (kThreads / 32) * 256 * 4, "epilogue scratch");
};

// ---------------------------------------------------------------------------
// K19 forward (DX = false) and dx (DX = true) at decode rows: grid (ceil(OUT /
// BN), ceil(m / BM) + E), dynamic shared memory GmmTile::kSmemBytes.
// ---------------------------------------------------------------------------
template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool DX>
__global__ void __launch_bounds__(GmmTile<BM, BN, BK, WM, WN, STAGES, DX>::kThreads, 2)
gmm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w, const bf16* __restrict__ bias,
           const int* __restrict__ group_sizes, bf16* __restrict__ out, int E, int RED, int OUT) {
  using T = GmmTile<BM, BN, BK, WM, WN, STAGES, DX>;
  using BLayout = typename std::conditional<DX, wmma::row_major, wmma::col_major>::type;
  constexpr int kFM = WM / 16;
  constexpr int kFN = WN / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const Visit vis = find_visit<BM>(group_sizes, E, blockIdx.y);
  if (vis.expert < 0) return;  // uniform over the block
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / T::kWarpsN;
  const int wn = warp % T::kWarpsN;
  const int m0 = vis.lo / BM * BM;
  const int j0 = blockIdx.x * BN;
  const bf16* wg = w + (size_t)vis.expert * RED * OUT;

  auto load_stage = [&](int stage, int r0) {
    bf16* as = smem + stage * T::kStage;
    bf16* bs = as + T::kAElems;
    // lhs rows of this visit only; the other rows of the tile are zeros
    for (int c = tid; c < BM * (BK / 8); c += T::kThreads) {
      const int r = c / (BK / 8);
      const int col = (c % (BK / 8)) * 8;
      const int m = m0 + r;
      const bool ok = m >= vis.lo && m < vis.hi && r0 + col < RED;
      cp_async16(as + r * T::kLda + col, ok ? a + (size_t)m * RED + r0 + col : a, ok);
    }
    if (DX) {
      // B(i, j) = W_g[i, j]: BK weight rows, BN output columns each
      for (int c = tid; c < BK * (BN / 8); c += T::kThreads) {
        const int r = c / (BN / 8);
        const int col = (c % (BN / 8)) * 8;
        const bool ok = r0 + r < RED && j0 + col < OUT;
        cp_async16(bs + r * T::kLdb + col, ok ? wg + (size_t)(r0 + r) * OUT + j0 + col : wg, ok);
      }
    } else {
      // B(i, j) = W_g[j, i]: BN weight rows, BK reduction columns each
      for (int c = tid; c < BN * (BK / 8); c += T::kThreads) {
        const int r = c / (BK / 8);
        const int col = (c % (BK / 8)) * 8;
        const bool ok = j0 + r < OUT && r0 + col < RED;
        cp_async16(bs + r * T::kLdb + col, ok ? wg + (size_t)(j0 + r) * RED + r0 + col : wg, ok);
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (RED + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int pre = kt + STAGES - 1;
    if (pre < nk) load_stage(pre % STAGES, pre * BK);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // the stage of step kt has landed
    __syncthreads();
    const bf16* as = smem + (kt % STAGES) * T::kStage;
    const bf16* bs = as + T::kAElems;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[kFN];
#pragma unroll
      for (int i = 0; i < kFM; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * WM + i * 16) * T::kLda + kk, T::kLda);
#pragma unroll
      for (int j = 0; j < kFN; ++j) {
        if (DX)
          wmma::load_matrix_sync(fb[j], bs + kk * T::kLdb + wn * WN + j * 16, T::kLdb);
        else
          wmma::load_matrix_sync(fb[j], bs + (wn * WN + j * 16) * T::kLdb + kk, T::kLdb);
      }
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // before step kt + 1 overwrites this stage
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: one 16 x 16 fragment at a time through the warp's scratch;
  // a lane rounds and stores 8 columns of one row (16 bytes)
  float* scratch = reinterpret_cast<float*>(smem_raw) + warp * 256;
  const bf16* bp = bias ? bias + (size_t)vis.expert * OUT : nullptr;
  const int fr = lane / 2;
  const int fc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < kFM; ++i) {
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * WM + i * 16 + fr;
      const int col = j0 + wn * WN + j * 16 + fc;
      if (m >= vis.lo && m < vis.hi && col < OUT) {
        uint4 o;
        bf16* ov = reinterpret_cast<bf16*>(&o);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          bf16 v = __float2bfloat16(scratch[fr * 16 + fc + e]);
          if (bp) v = __float2bfloat16(__bfloat162float(v) + __bfloat162float(bp[col + e]));
          ov[e] = v;
        }
        *reinterpret_cast<uint4*>(out + (size_t)m * OUT + col) = o;
      }
      __syncwarp();
    }
  }
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool DX>
int launch(const void* a, const void* w, const void* bias, const void* group_sizes, void* out,
           int m, int E, int RED, int OUT, cudaStream_t stream) {
  using T = GmmTile<BM, BN, BK, WM, WN, STAGES, DX>;
  auto kernel = gmm_kernel<BM, BN, BK, WM, WN, STAGES, DX>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((OUT + BN - 1) / BN, (m + BM - 1) / BM + E);
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<const int*>(group_sizes), static_cast<bf16*>(out), E, RED, OUT);
  return static_cast<int>(cudaGetLastError());
}

// rows at or below which the decode tiles (16 rows) run
constexpr int kSmallM = 64;

}  // namespace


namespace gmm {
namespace {

constexpr int kBm = 128;  // rows of a tile: two consumer warpgroups of 64
constexpr int kBn = 192;  // output columns of a tile (m64n192 products)
constexpr int kBk = 64;   // reduction depth of a stage: one 128-byte row

// Slots of the optional work-unit counters.
constexpr int kCntUnits = 0;   // units of an expert (the main loop runs)
constexpr int kCntZero = 1;    // units of the rows past the groups (zeros)
constexpr int kCntTma = 2;     // 64-row halves stored by TMA
constexpr int kCntMasked = 3;  // halves stored by masked 16-byte stores

struct Unit {
  int g;     // group; E for the rows past the groups
  int row0;  // first row of the 128-row tile
  int lo, hi;  // the visit's rows
  int col0;  // first output column
};

// Unit u: its group is the last g with ustart[g] <= u (empty groups start
// where the next one does), its visit and column tile follow from u -
// ustart[g], visits fastest.
__device__ __forceinline__ Unit unit_of(int u, const int* offs, const int* ustart, int E) {
  int a = 0, b = E;
  while (a < b) {
    const int mid = (a + b + 1) >> 1;
    if (ustart[mid] <= u)
      a = mid;
    else
      b = mid - 1;
  }
  const int first = offs[a] / kBm;
  const int nv = (offs[a + 1] - 1) / kBm - first + 1;
  const int local = u - ustart[a];
  Unit w;
  w.g = a;
  w.row0 = (first + local % nv) * kBm;
  w.lo = max(offs[a], w.row0);
  w.hi = min(offs[a + 1], w.row0 + kBm);
  w.col0 = (local / nv) * kBn;
  return w;
}

// The unit with every field lane 0's (a shuffle), so that the compiler
// sees the branches on them taken by whole warps: a branch it cannot prove
// uniform around the products makes ptxas serialize them (C7518).
__device__ __forceinline__ Unit warp_uniform(Unit w) {
  w.g = __shfl_sync(0xffffffffu, w.g, 0);
  w.row0 = __shfl_sync(0xffffffffu, w.row0, 0);
  w.lo = __shfl_sync(0xffffffffu, w.lo, 0);
  w.hi = __shfl_sync(0xffffffffu, w.hi, 0);
  w.col0 = __shfl_sync(0xffffffffu, w.col0, 0);
  return w;
}

// Tables in shared memory (E + 2 ints each): offs[g] the first row of group
// g (group E: the rows past the groups, offs[E + 1] = m), ustart[g] its
// first unit (ustart[E + 1]: all units). Sizes are clamped to [0, m].
__device__ __forceinline__ void build_tables(const int* __restrict__ group_sizes, int* offs,
                                             int* ustart, int m, int E, int ncol) {
  for (int g = threadIdx.x; g < E; g += kThreads) offs[g + 1] = group_sizes[g];
  __syncthreads();
  if (threadIdx.x == 0) {
    int off = 0, u = 0;
    for (int g = 0; g <= E; ++g) {
      const int end = g < E ? min(off + max(offs[g + 1], 0), m) : m;
      offs[g] = off;
      ustart[g] = u;
      if (end > off) u += ((end - 1) / kBm - off / kBm + 1) * ncol;
      off = end;
    }
    offs[E + 1] = m;
    ustart[E + 1] = u;
  }
  __syncthreads();
}

// The B box of a stage, for the forward one K-major [192][64] box of W_g
// at (stage kt, column tile col0), for dx three MN-major [64][64] boxes;
// with `half` (a cluster's two CTAs sharing W_g's slab) only CTA `rank`'s
// half of it: the forward's rows 96 rank .., dx's rows 32 rank .. of each
// box, multicast to both CTAs.
template <bool DX>
__device__ __forceinline__ void load_b(unsigned char* b, const CUtensorMap* tb,
                                       const CUtensorMap* tb_half, uint64_t* bar, int kt,
                                       int col0, int g, bool half, int rank) {
  if (DX) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (half)
        tma_load_3d_multicast(b + c * kSubBytes + rank * 4096, tb_half, bar, col0 + 64 * c,
                              kt * kBk + 32 * rank, g, 3);
      else
        tma_load_3d(b + c * kSubBytes, tb, bar, col0 + 64 * c, kt * kBk, g);
    }
  } else if (half) {
    tma_load_3d_multicast(b + rank * 96 * 128, tb_half, bar, kt * kBk, col0 + 96 * rank, g, 3);
  } else {
    tma_load_3d(b, tb, bar, kt * kBk, col0, g);
  }
}

// Clusters of two CTAs walk the units of the experts in pairs: pair q is
// units 2 q (CTA rank 0) and 2 q + 1 (rank 1), q = cluster, cluster +
// clusters, ... Both CTAs run the same stages in step. Where the two units
// share (expert, column tile) each CTA loads half of W_g's box and
// multicasts it to both, so the pair reads W_g from L2 once; else each
// loads its own. An odd last unit leaves rank 1 a copy of rank 0's unit
// that it loads and drops. Each consumer warp hands a stage back to both
// CTAs' producers (empty counts 16 arrivals), since either may write it
// next. The units of the rows past the groups follow, unpaired and with
// no loads.
template <bool DX>
__global__ void __launch_bounds__(kThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,       // A [m, RED], box 64 x 128
                     const __grid_constant__ CUtensorMap tb,       // W (K, N, E), the whole B box
                     const __grid_constant__ CUtensorMap tb_half,  // W, a CTA's half of it
                     const __grid_constant__ CUtensorMap tout,     // out [m, OUT], box 64 x 64
                     const bf16* __restrict__ bias, const int* __restrict__ group_sizes,
                     bf16* __restrict__ out, int* __restrict__ counts, int m, int E, int RED,
                     int OUT) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* empty = full + kStages;
  int* offs = reinterpret_cast<int*>(smem + kOffTab);
  int* ustart = offs + E + 2;
  const int ncol = (OUT + kBn - 1) / kBn;
  const int nk = (RED + kBk - 1) / kBk;
  const int rank = static_cast<int>(cluster_rank());
  const int cluster = blockIdx.x / 2, clusters = gridDim.x / 2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 16);  // one arrival per consumer warp of both CTAs
    }
    fence_barrier_init();
  }
  build_tables(group_sizes, offs, ustart, m, E, ncol);
  cluster_sync();  // both CTAs' barriers are initialised
  const int paired = __shfl_sync(0xffffffffu, ustart[E], 0);     // units of the experts
  const int total = __shfl_sync(0xffffffffu, ustart[E + 1], 0);  // and of the rows past them

  // warpgroup 2 produces; the index is made warp-uniform (a shuffle from
  // lane 0) so that the compiler sees each branch taken by whole warpgroups
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 2) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int q = cluster; 2 * q < paired; q += clusters) {
      const Unit u0 = unit_of(2 * q, offs, ustart, E);
      const Unit u1 = 2 * q + 1 < paired ? unit_of(2 * q + 1, offs, ustart, E) : u0;
      const bool half = 2 * q + 1 < paired && u0.g == u1.g && u0.col0 == u1.col0;
      const Unit w = rank == 0 ? u0 : u1;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages, use = it / kStages;
        if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
        unsigned char* st = smem + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load_2d(st, &ta, &full[s], kt * kBk, w.row0);
        load_b<DX>(st + kABytes, &tb, &tb_half, &full[s], kt, w.col0, w.g, half, rank);
      }
    }
    // stay until both CTAs' consumers have handed back every stage, so no
    // arrival from the other CTA finds this one gone
    for (int i = 0; i < kStages; ++i, ++it)
      if (it >= kStages) mbar_wait(&empty[it % kStages], (it / kStages - 1) & 1);
    return;
  }

  regs_inc<kConsumerRegs>();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  const int t = threadIdx.x % 128, lane = t % 32;
  unsigned char* staged = smem + kOffOut + wg * kHalfOutBytes;
  int n_units = 0, n_zero = 0, n_tma = 0, n_masked = 0;
  int it = 0;
  // hand stage s back to both CTAs' producers, once per consumer warp
  auto release_both = [&](int s) {
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&empty[s]);
      mbar_arrive_cluster(&empty[s], rank ^ 1);
    }
  };
  // this CTA's pair steps, then its units of the rows past the groups
  const int pairs = (paired + 1) / 2;
  const int steps = pairs > cluster ? (pairs - cluster + clusters - 1) / clusters : 0;
  for (int i = 0;; ++i) {
    int u;
    bool own = true;
    if (i < steps) {
      const int q = cluster + i * clusters;
      u = 2 * q + rank;
      if (u >= paired) {
        u = 2 * q;  // rank 1's copy of the odd last unit: loaded, dropped
        own = false;
      }
    } else {
      u = paired + blockIdx.x + (i - steps) * gridDim.x;
      if (u >= total) break;
    }
    const Unit w = warp_uniform(unit_of(u, offs, ustart, E));
    const bool real = w.g < E;
    const int r0 = w.row0 + 64 * wg;
    // this half holds rows of the visit that this CTA stores
    const bool live = own && r0 < w.hi && r0 + 64 > w.lo;
    n_units += real && own;
    n_zero += !real;
    const bool with_bias = real && bias != nullptr;
    uint32_t bias_pairs[24];
    if (with_bias && live) load_bias(bias_pairs, bias + (size_t)w.g * OUT, w.col0, OUT, lane);
    float acc[96];
    if (real && live) {
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        const uint32_t a0 = smem_u32(smem + s * kStageBytes) + wg * kSubBytes;
        const uint32_t b0 = smem_u32(smem + s * kStageBytes + kABytes);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint64_t da = sw128_desc(a0 + 32 * k, 16, 1024);
          const uint64_t db = DX ? sw128_desc(b0 + 2048 * k, kSubBytes, 1024)
                                 : sw128_desc(b0 + 32 * k, 16, 1024);
          Wgmma<kBn>::ss<0, DX ? 1 : 0>(acc, da, db, kt > 0 || k > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the products of the previous stage are done
        if (kt > 0) release_both((it - 1) % kStages);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release_both((it - 1) % kStages);
      // epilogue: this warpgroup's half
      staging_free(wg, t);
      stage_half(staged, acc, with_bias, bias_pairs, t);
    } else if (real) {
      // no row of the visit to store in this half: hand the stages back
      for (int kt = 0; kt < nk; ++kt, ++it) {
        mbar_wait(&full[it % kStages], (it / kStages) & 1);
        release_both(it % kStages);
      }
      continue;
    } else if (live) {
      staging_free(wg, t);
      stage_zero(staged, t);
    } else {
      continue;
    }
    staging_done(wg);
    if (w.lo <= r0 && r0 + 64 <= w.hi) {
      if (t == 0) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          if (w.col0 + 64 * c < OUT) tma_store_2d(&tout, staged + c * kSubBytes, w.col0 + 64 * c, r0);
        bulk_commit();
      }
      ++n_tma;
    } else {
      store_rows(staged, out, OUT, r0, w.lo, w.hi, w.col0, OUT, t);
      ++n_masked;
    }
  }
  if (t == 0) {
    bulk_wait<0>();
    if (counts != nullptr) {
      if (wg == 0) {
        atomicAdd(counts + kCntUnits, n_units);
        atomicAdd(counts + kCntZero, n_zero);
      }
      atomicAdd(counts + kCntTma, n_tma);
      atomicAdd(counts + kCntMasked, n_masked);
    }
  }
}

template <bool DX>
int launch_wgmma(const void* a, const void* w, const void* bias, const void* group_sizes,
                 void* out, void* counts, int m, int E, int RED, int OUT, cudaStream_t stream) {
  if (E < 1 || E > kMaxExperts) return static_cast<int>(cudaErrorInvalidValue);
  const int N = DX ? RED : OUT, K = DX ? OUT : RED;
  CUtensorMap ta, tb, tb_half, tout;
  const uint64_t dims_a[2] = {(uint64_t)RED, (uint64_t)m};
  const uint32_t box_a[2] = {64, kBm};
  const uint64_t dims_w[3] = {(uint64_t)K, (uint64_t)N, (uint64_t)E};
  const uint32_t box_w[3] = {64, DX ? 64u : (uint32_t)kBn, 1};
  const uint32_t box_half[3] = {64, DX ? 32u : (uint32_t)kBn / 2, 1};
  const uint64_t dims_o[2] = {(uint64_t)OUT, (uint64_t)m};
  const uint32_t box_o[2] = {64, 64};
  int e = bf16_map(&ta, a, 2, dims_a, box_a);
  if (e == 0) e = bf16_map(&tb, w, 3, dims_w, box_w);
  if (e == 0) e = bf16_map(&tb_half, w, 3, dims_w, box_half);
  if (e == 0) e = bf16_map(&tout, out, 2, dims_o, box_o);
  if (e != 0) return e;
  auto kernel = gmm_wgmma_kernel<DX>;
  static bool configured = false;
  if (!configured) {
    e = static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              smem_bytes(2 * (kMaxExperts + 2))));
    if (e != 0) return e;
    configured = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(2 * (E + 2));
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // as many clusters as are resident at once, at most one a pair of units
  const long units = ((long)(m + kBm - 1) / kBm + E + 1) * ((OUT + kBn - 1) / kBn);
  int resident = sm_count() / 2;
  cfg.gridDim = dim3(2 * resident);
  int fits = 0;
  if (cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg) == cudaSuccess && fits > 0)
    resident = fits;
  const long clusters = (units + 1) / 2 < resident ? (units + 1) / 2 : resident;
  cfg.gridDim = dim3(2 * (unsigned)clusters);
  e = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, ta, tb, tb_half, tout,
                                          static_cast<const bf16*>(bias),
                                          static_cast<const int*>(group_sizes),
                                          static_cast<bf16*>(out), static_cast<int*>(counts), m,
                                          E, RED, OUT));
  if (e != 0) return e;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gmm

int unsloth_decode_gmm_bf16(const void* x, const void* w, const void* bias,
                            const void* group_sizes, void* y, void* partials, void* arrivals,
                            int M, int E, int N, int K, int row_warps, int slices,
                            int slice_steps, void* counts, cudaStream_t stream);

// out = lhs @ W_g^T (+ bias[g]) per group on `stream`. Shapes: lhs [m, K]
// bf16 rows sorted by expert, w [E, N, K] bf16, bias [E, N] bf16 or null,
// group_sizes [E] int32 on the device summing to at most m, out [m, N]
// bf16: for m > 64 and m <= 16 every row is written (rows past the groups
// are zeros), for 17-64 rows past the groups are left as they are. N and K
// multiples of 8, pointers 16-byte aligned, E <= 1,024 (the wrapper
// checks). At m <= 16 decode_matmul.cu's grouped decode kernel under the
// schedule (row_warps, slices, slice_steps) and scratch (partials,
// arrivals) the wrapper passes (ops/qlora_matmul.py:
// grouped_decode_schedule), its `unit_counts` (null, or an int32 [3]) the
// units, 16-byte chunks of W and empty slots; for m > 64, `unit_counts`,
// when not null, is an int32 [4] to which the kernel adds its work units
// of an expert, its units of the rows past the groups, and the 64-row
// halves it stored by TMA and by masked stores. Returns
// cudaGetLastError() after the launch; allocates nothing.
extern "C" int unsloth_gmm_bf16(const void* lhs, const void* w, const void* bias,
                                const void* group_sizes, void* out, int m, int E, int N, int K,
                                int row_warps, int slices, int slice_steps, void* partials,
                                void* arrivals, void* unit_counts, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 16)
    return unsloth_decode_gmm_bf16(lhs, w, bias, group_sizes, out, partials, arrivals, m, E, N, K,
                                   row_warps, slices, slice_steps, unit_counts, s);
  if (m <= kSmallM)
    return launch<16, 64, 64, 16, 16, 4, false>(lhs, w, bias, group_sizes, out, m, E, K, N, s);
  return gmm::launch_wgmma<false>(lhs, w, bias, group_sizes, out, unit_counts, m, E, K, N, s);
}

// dx = g @ W_g per group on `stream`: g [m, N] bf16 rows sorted by expert,
// w and group_sizes as above, dx [m, K] bf16. Same conditions and counters.
extern "C" int unsloth_gmm_dx_bf16(const void* g, const void* w, const void* group_sizes,
                                   void* dx, int m, int E, int N, int K, void* unit_counts,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= kSmallM)
    return launch<16, 64, 64, 16, 16, 4, true>(g, w, nullptr, group_sizes, dx, m, E, N, K, s);
  return gmm::launch_wgmma<true>(g, w, nullptr, group_sizes, dx, unit_counts, m, E, N, K, s);
}
