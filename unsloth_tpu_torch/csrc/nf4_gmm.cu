// Grouped NF4 dequant-inside-matmul over experts (the MoE QLoRA base), K14
// and K15: the decode-row kernel and the C entry points.
//
//   nf4_gmm_kernel<16>   out[r, :] = x[r, :] @ dequant(W_g)^T + bias[g]
//                        for the rows r of group g (K14 at decode rows)
//
// K14 above 16 rows is nf4_wgmma.cu's nf4_gmm_wgmma_kernel<BX>, K1's Hopper
// kernel under a grouped persistent schedule, and K15 (dx = g @ dequant(W_g)
// per group) at every row count its nf4_gmm_dx_wgmma_kernel<BX>, K2's
// Hopper kernel under the same schedule (see their notes); this file holds
// the C entry points that pick them.
//
// Replaces the TPU kernel unsloth_tpu/ops/nf4_gmm.py:_fwd_kernel (launched
// by _nf4_gmm_fwd_impl) at decode rows. Same arithmetic as it and as the
// dense NF4 kernels (nf4_matmul.cu): each weight is NF4_CODE[nibble] *
// absmax (fp32) rounded to bf16, products summed in fp32, the bias (fp32)
// added to the fp32 sum, one rounding to bf16 at the store.
//
// Layout: rows of x (and of g, dx, out) are sorted by expert; group g owns
// rows [off_g, off_g + size_g), off the running sum of the int32 group
// sizes, which stay on the device (no host sync per MoE layer). The weight
// is NF4Stacked [E, N, K]: packed uint8 [E, N, K/2] in split-half order
// (byte [e, n, j] holds element j in its high nibble and element j + K/2 in
// its low one), absmax fp32 [E, N * K / bs] for a block size bs of 32 or
// 64; each 16-byte chunk of packed bytes looks up its own absmax, so K/2
// need only be a multiple of 32, and the last step of a row is masked past
// K/2 (gpt-oss: K = 2,880, K/2 = 1,440 = 22.5 steps of 64). N is masked at
// its ragged edge where the TPU launcher pads it in memory.
//
// Schedule (megablox's group metadata, made inside the block; shared with
// gmm.cu in expert_visits.cuh): the grid's second axis runs over tile
// visits, at most ceil(m / BM) + E of them. A BM-row tile that straddles
// two experts is visited once per expert, each visit loading and storing
// only its expert's rows; empty experts have no visit; blocks past the
// last visit exit at once. Each block finds its visit with one walk over
// the E group sizes (thread 0), so the launch needs no metadata from the
// host.
//
// What bounds it on an H100: at decode (8 rows over at most 8 experts) the
// bytes of the visited experts' weights, 0.5 B/param plus 4 B per block of
// absmax. Design: the structure of nf4_matmul.cu's kernels, one block per
// (64-column tile, visit), the 16-entry codebook in shared memory, decoded
// bf16 tiles in shared memory, nvcuda::wmma 16x16x16 bf16 MMAs with fp32
// accumulators; a visit decodes its expert's weight tile once for all of
// its rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "expert_visits.cuh"

using namespace nvcuda;

namespace {

__constant__ float kGmmCode[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

constexpr int kBN = 64;          // output columns (weight rows) per block
constexpr int kStep = 64;        // packed bytes per row per step
constexpr int kLds = kStep + 8;  // shared-memory row stride in bf16, padded
constexpr int kThreads = 128;    // four warps

// Decode 16 packed bytes of weight row `n` at byte column `c` into the 16
// high-nibble weights (columns c..) and the 16 low-nibble ones (columns
// K/2 + c..), each scaled by its own block's absmax; zeros where `ok` is
// false.
__device__ __forceinline__ void decode16(const uint8_t* __restrict__ packed_row,
                                         const float* __restrict__ absmax_row, const float* code,
                                         int c, int half, int bs, bool ok, uint4 (&hi_out)[2],
                                         uint4 (&lo_out)[2]) {
  hi_out[0] = hi_out[1] = lo_out[0] = lo_out[1] = make_uint4(0u, 0u, 0u, 0u);
  if (!ok) return;
  const uint4 v = *reinterpret_cast<const uint4*>(packed_row + c);
  const float a_hi = absmax_row[c / bs];
  const float a_lo = absmax_row[(half + c) / bs];
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
  __nv_bfloat162* hi2 = reinterpret_cast<__nv_bfloat162*>(hi_out);
  __nv_bfloat162* lo2 = reinterpret_cast<__nv_bfloat162*>(lo_out);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint8_t b0 = b[2 * e], b1 = b[2 * e + 1];
    hi2[e] = __floats2bfloat162_rn(code[b0 >> 4] * a_hi, code[b1 >> 4] * a_hi);
    lo2[e] = __floats2bfloat162_rn(code[b0 & 15] * a_lo, code[b1 & 15] * a_lo);
  }
}

// ---------------------------------------------------------------------------
// K14 forward: grid (ceil(N / 64), ceil(m / BM) + E)
// ---------------------------------------------------------------------------
template <int BM>
__global__ void __launch_bounds__(kThreads)
nf4_gmm_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
               const float* __restrict__ absmax, const float* __restrict__ bias,
               const int* __restrict__ group_sizes, __nv_bfloat16* __restrict__ y, int E, int N,
               int K, int bs) {
  constexpr int kWarpsM = BM == 64 ? 2 : 1;
  constexpr int kWarpsN = 4 / kWarpsM;
  constexpr int kWM = BM / kWarpsM;
  constexpr int kWN = kBN / kWarpsN;
  constexpr int kFM = kWM / 16;
  constexpr int kFN = kWN / 16;
  constexpr int kLdc = kBN + 4;
  constexpr int kBytesAB = (2 * BM + 2 * kBN) * kLds * 2;
  constexpr int kBytesC = BM * kLdc * 4;
  constexpr int kBytes = kBytesAB > kBytesC ? kBytesAB : kBytesC;
  __shared__ __align__(128) unsigned char smem[kBytes];
  __shared__ float code[16];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = xs + 2 * BM * kLds;
  float* cs = reinterpret_cast<float*>(smem);

  const Visit vis = find_visit<BM>(group_sizes, E, blockIdx.y);
  if (vis.expert < 0) return;  // uniform over the block
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int m0 = vis.lo / BM * BM;
  const int n0 = blockIdx.x * kBN;
  const int half = K / 2;
  const size_t blocks_per_row = K / bs;
  const uint8_t* wp = packed + (size_t)vis.expert * N * half;
  const float* ap = absmax + (size_t)vis.expert * N * blocks_per_row;
  if (tid < 16) code[tid] = kGmmCode[tid];

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int jj = 0; jj < kFN; ++jj) wmma::fill_fragment(acc[i][jj], 0.0f);
  __syncthreads();

  for (int j = 0; j < half; j += kStep) {
    // x: both column sides, 8 bf16 a chunk; rows outside the visit are 0
    constexpr int kXChunks = 2 * BM * (kStep / 8);
    for (int c = tid; c < kXChunks; c += kThreads) {
      const int side = c / (BM * (kStep / 8));
      const int r = (c / (kStep / 8)) % BM;
      const int col = (c % (kStep / 8)) * 8;
      const int m = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m >= vis.lo && m < vis.hi && j + col < half)
        v = *reinterpret_cast<const uint4*>(x + (size_t)m * K + side * half + j + col);
      *reinterpret_cast<uint4*>(xs + (side * BM + r) * kLds + col) = v;
    }
    constexpr int kPChunks = kBN * (kStep / 16);
    for (int c = tid; c < kPChunks; c += kThreads) {
      const int r = c / (kStep / 16);
      const int col = (c % (kStep / 16)) * 16;
      const int n = n0 + r;
      uint4 hi_out[2], lo_out[2];
      decode16(wp + (size_t)n * half, ap + (size_t)n * blocks_per_row, code, j + col, half, bs,
               n < N && j + col < half, hi_out, lo_out);
      uint4* whi = reinterpret_cast<uint4*>(ws + r * kLds + col);
      uint4* wlo = reinterpret_cast<uint4*>(ws + (kBN + r) * kLds + col);
      whi[0] = hi_out[0];
      whi[1] = hi_out[1];
      wlo[0] = lo_out[0];
      wlo[1] = lo_out[1];
    }
    __syncthreads();

#pragma unroll
    for (int side = 0; side < 2; ++side) {
#pragma unroll
      for (int kk = 0; kk < kStep; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[kFM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bw[kFN];
#pragma unroll
        for (int i = 0; i < kFM; ++i)
          wmma::load_matrix_sync(a[i], xs + (side * BM + wm * kWM + i * 16) * kLds + kk, kLds);
#pragma unroll
        for (int jj = 0; jj < kFN; ++jj)
          wmma::load_matrix_sync(bw[jj], ws + (side * kBN + wn * kWN + jj * 16) * kLds + kk, kLds);
#pragma unroll
        for (int i = 0; i < kFM; ++i)
#pragma unroll
          for (int jj = 0; jj < kFN; ++jj) wmma::mma_sync(acc[i][jj], a[i], bw[jj], acc[i][jj]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int jj = 0; jj < kFN; ++jj)
      wmma::store_matrix_sync(cs + (wm * kWM + i * 16) * kLdc + wn * kWN + jj * 16,
                              acc[i][jj], kLdc, wmma::mem_row_major);
  __syncthreads();
  // the per-expert bias in the store epilogue, fp32
  const float* bp = bias ? bias + (size_t)vis.expert * N : nullptr;
  for (int c = tid; c < BM * kBN; c += kThreads) {
    const int r = c / kBN;
    const int col = c % kBN;
    const int m = m0 + r;
    const int n = n0 + col;
    if (m >= vis.lo && m < vis.hi && n < N)
      y[(size_t)m * N + n] = __float2bfloat16(cs[r * kLdc + col] + (bp ? bp[n] : 0.0f));
  }
}

}  // namespace

int unsloth_nf4_gmm_wgmma_launch(const void* x, const void* packed, const void* absmax,
                                 const void* bias, const void* group_sizes, void* y,
                                 void* counts, int M, int E, int N, int K, int bs,
                                 cudaStream_t stream);
int unsloth_nf4_gmm_dx_wgmma_launch(const void* g, const void* packed, const void* absmax_t,
                                    const void* group_sizes, void* dx, void* counts, int M, int E,
                                    int N, int K, int bs, cudaStream_t stream);

// out = x @ dequant(W_g)^T + bias[g] per group on `stream`. Shapes: x [m, K]
// bf16 rows sorted by expert, packed [E, N, K/2] u8, absmax [E, N * K / bs]
// f32, bias [E, N] f32 or null, group_sizes [E] int32 on the device summing
// to at most m, out [m, N] bf16. K/2 a multiple of 32 and of bs (32 or 64),
// N a multiple of 8, pointers 16-byte aligned, E <= 1,024 (the wrapper
// checks). Above 16 rows nf4_wgmma.cu's Hopper kernel, which writes every
// row (zeros past the groups); `counts` (null, or an int32 [3]) is its.
// At 16 rows or fewer
// nf4_gmm_kernel<16>, which leaves the rows past the groups as they are.
// Returns the launch's CUDA error code; allocates nothing.
extern "C" int unsloth_nf4_gmm_bf16(const void* x, const void* packed, const void* absmax,
                                    const void* bias, const void* group_sizes, void* out, int m,
                                    int E, int N, int K, int bs, void* counts, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m > 16)
    return unsloth_nf4_gmm_wgmma_launch(x, packed, absmax, bias, group_sizes, out, counts, m, E,
                                        N, K, bs, s);
  const dim3 grid((N + kBN - 1) / kBN, (m + 15) / 16 + E);
  nf4_gmm_kernel<16><<<grid, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(absmax), static_cast<const float*>(bias),
      static_cast<const int*>(group_sizes), static_cast<__nv_bfloat16*>(out), E, N, K, bs);
  return static_cast<int>(cudaGetLastError());
}

// dx = g @ dequant(W_g) per group on `stream` at every row count:
// nf4_wgmma.cu's Hopper kernel (K15). Shapes: g [m, N] bf16 rows sorted by
// expert, packed / group_sizes as above, absmax_t the absmax transposed,
// fp32 [E K / bs, N], dx [m, K] bf16 (every row written: zeros past the
// groups). Same conditions as the forward; `counts` (null, or an int32
// [3]) as the forward's Hopper kernel's.
extern "C" int unsloth_nf4_gmm_dx_bf16(const void* g, const void* packed, const void* absmax_t,
                                       const void* group_sizes, void* dx, int m, int E, int N,
                                       int K, int bs, void* counts, void* stream) {
  return unsloth_nf4_gmm_dx_wgmma_launch(g, packed, absmax_t, group_sizes, dx, counts, m, E, N, K,
                                         bs, static_cast<cudaStream_t>(stream));
}
