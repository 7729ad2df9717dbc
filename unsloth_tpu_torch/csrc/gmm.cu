// Grouped dense bf16 matmul over experts (the MoE expert products when the
// experts are dense bf16 stacks), K19 and its dx.
//
//   gmm_kernel<..., DX = false>  out[r, :] = lhs[r, :] @ W_g^T (+ bias[g])
//                                for the rows r of group g
//   gmm_kernel<..., DX = true>   dx[r, :]  = g[r, :] @ W_g
//
// Replaces the TPU kernel megablox `gmm` (jax.experimental.pallas.ops.tpu.
// megablox, imported by unsloth_tpu/ops/moe.py:177 and called through
// tiled_gmm at :249 with transpose_rhs=True), and the transpose_rhs-flipped
// `gmm` that megablox's VJP runs for the gradient of its lhs. The weight
// gradient (megablox `tgmm`) is not ported: under QLoRA the experts are
// frozen.
//
// Arithmetic: bf16 products summed in fp32, one rounding to bf16; the
// forward's optional per-expert bf16 bias is then added to the rounded
// product and the sum rounded again, as the JAX package adds its gathered
// bf16 bias rows to gmm's output cast to the input dtype (moe.py:258-276).
//
// Layout: rows of lhs (and of g, dx, out) are sorted by expert; group g
// owns rows [off_g, off_g + size_g), off the running sum of the int32 group
// sizes, which stay on the device. W is [E, N, K] row-major (out-major, as
// the JAX package keeps expert stacks). Both directions run one kernel body
// over a reduction dim RED and an output dim OUT: forward RED = K, OUT = N,
// B(i, j) = W_g[j, i]; dx RED = N, OUT = K, B(i, j) = W_g[i, j]. N and K
// must be multiples of 8 (rows load and store 16 bytes at a time); ragged
// edges of both are masked in the kernel where the TPU launcher pads them
// in memory to a multiple of 128 (gpt-oss: N = K = 2,880 = 22.5 x 128).
//
// Schedule (expert_visits.cuh, shared with nf4_gmm.cu): the grid's second
// axis runs over tile visits, at most ceil(m / BM) + E of them. A BM-row
// tile that straddles two experts is visited once per expert, each visit
// loading and storing only its own rows; empty experts have no visit;
// blocks past the last visit exit at once. Each block finds its visit with
// one walk over the E group sizes, so the launch needs nothing from the
// host.
//
// What bounds it on an H100: at training row counts (m = 16,384 sorted
// rows, N = K = 2,880) tensor-core throughput, 2 m N K operations; at
// decode (8 rows over at most 8 experts) the bytes of the visited experts'
// weights. Design: 128 x 128 output tiles of eight warps (32 x 64 each),
// two blocks an SM (at most 128 registers a thread), for training rows;
// 16 x 64 tiles of four warps for decode rows; tiles of lhs and W stream
// into shared memory through cp.async, 16 bytes a thread, 3-4 stages deep,
// so the next tiles load while nvcuda::wmma 16x16x16 bf16 MMAs with fp32
// accumulators work on the current one; the epilogue rounds one 16 x 16
// fragment at a time through a per-warp scratch. Of the tile shapes tried
// on an H100 (64 or 32 deep, 64 x 32 or 32 x 64 warp tiles, one or two
// blocks an SM), these were the fastest at the training shape. wgmma, TMA
// and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "expert_visits.cuh"

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
// K19 forward (DX = false) and dx (DX = true): grid (ceil(OUT / BN),
// ceil(m / BM) + E), dynamic shared memory GmmTile::kSmemBytes.
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

// out = lhs @ W_g^T (+ bias[g]) per group on `stream`. Shapes: lhs [m, K]
// bf16 rows sorted by expert, w [E, N, K] bf16, bias [E, N] bf16 or null,
// group_sizes [E] int32 on the device summing to at most m, out [m, N]
// bf16 (rows past the groups are left as they are). N and K multiples of
// 8, pointers 16-byte aligned (the wrapper checks). Returns
// cudaGetLastError() after the launch; allocates nothing.
extern "C" int unsloth_gmm_bf16(const void* lhs, const void* w, const void* bias,
                                const void* group_sizes, void* out, int m, int E, int N, int K,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= kSmallM)
    return launch<16, 64, 64, 16, 16, 4, false>(lhs, w, bias, group_sizes, out, m, E, K, N, s);
  return launch<128, 128, 64, 32, 64, 3, false>(lhs, w, bias, group_sizes, out, m, E, K, N, s);
}

// dx = g @ W_g per group on `stream`: g [m, N] bf16 rows sorted by expert,
// w and group_sizes as above, dx [m, K] bf16. Same conditions.
extern "C" int unsloth_gmm_dx_bf16(const void* g, const void* w, const void* group_sizes,
                                   void* dx, int m, int E, int N, int K, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= kSmallM)
    return launch<16, 64, 64, 16, 16, 4, true>(g, w, nullptr, group_sizes, dx, m, E, N, K, s);
  return launch<128, 128, 64, 32, 64, 3, true>(g, w, nullptr, group_sizes, dx, m, E, N, K, s);
}
