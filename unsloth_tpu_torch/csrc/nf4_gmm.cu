// Grouped NF4 dequant-inside-matmul over experts (the MoE QLoRA base), K14
// and K15.
//
//   nf4_gmm_kernel<BM>   out[r, :] = x[r, :] @ dequant(W_g)^T + bias[g]
//                        for the rows r of group g (K14)
//   nf4_gmm_dx_kernel    dx[r, :] = g[r, :] @ dequant(W_g)              (K15)
//
// Replaces the TPU kernels unsloth_tpu/ops/nf4_gmm.py:_fwd_kernel (launched
// by _nf4_gmm_fwd_impl) and _bwd_kernel (launched by _nf4_gmm_bwd_impl).
// Same arithmetic as those and as the dense NF4 kernels (nf4_matmul.cu):
// each weight is NF4_CODE[nibble] * absmax (fp32) rounded to bf16, products
// summed in fp32, the bias (fp32) added to the fp32 sum, one rounding to
// bf16 at the store.
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
// What bounds it on an H100: at training row counts (m = 16,384 sorted
// rows, N = K = 2,880) tensor-core throughput, 2 m N K operations; each
// decoded weight tile is reused across a BM-row tile of x. At decode (8
// rows over at most 8 experts) the bytes of the visited experts' weights,
// 0.5 B/param plus 4 B per block of absmax. Design: the structure of
// nf4_matmul.cu's kernels, one block per (64-column tile, visit), the
// 16-entry codebook in shared memory, decoded bf16 tiles in shared memory,
// nvcuda::wmma 16x16x16 bf16 MMAs with fp32 accumulators; a visit decodes
// its expert's weight tile once for all of its rows. wgmma, TMA and
// pipelining are later work.

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

// ---------------------------------------------------------------------------
// K15 dx: grid (ceil(K/2 / 64), ceil(m / 64) + E). A block owns the 64-byte
// column stretch j0 of its expert's packed weight and one visit; it reduces
// over the N weight rows 64 at a time (masked past N) and writes the two
// 64-column dx tiles that stretch decodes to, dx[:, j0..] (high nibbles) and
// dx[:, K/2 + j0..] (low nibbles), as nf4_matmul_dx_kernel does.
// ---------------------------------------------------------------------------
constexpr int kDxBM = 64;
constexpr int kDxBK = 64;           // W rows (reduction) per step
constexpr int kDxLdg = kDxBK + 8;
constexpr int kDxLdw = kStep + 8;
constexpr int kDxLdc = 2 * kStep + 4;

__global__ void __launch_bounds__(kThreads)
nf4_gmm_dx_kernel(const __nv_bfloat16* __restrict__ g, const uint8_t* __restrict__ packed,
                  const float* __restrict__ absmax, const int* __restrict__ group_sizes,
                  __nv_bfloat16* __restrict__ dx, int E, int N, int K, int bs) {
  constexpr int BM = kDxBM;
  constexpr int kBytesAB = (BM * kDxLdg + 2 * kDxBK * kDxLdw) * 2;
  constexpr int kBytesC = BM * kDxLdc * 4;
  constexpr int kBytes = kBytesAB > kBytesC ? kBytesAB : kBytesC;
  __shared__ __align__(128) unsigned char smem[kBytes];
  __shared__ float code[16];
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = gs + BM * kDxLdg;
  float* cs = reinterpret_cast<float*>(smem);

  const Visit vis = find_visit<BM>(group_sizes, E, blockIdx.y);
  if (vis.expert < 0) return;  // uniform over the block
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;    // rows 32 wm .. +32 of the tile
  const int side = warp % 2;  // which 64-column output tile
  const int m0 = vis.lo / BM * BM;
  const int j0 = blockIdx.x * kStep;
  const int half = K / 2;
  const size_t blocks_per_row = K / bs;
  const uint8_t* wp = packed + (size_t)vis.expert * N * half;
  const float* ap = absmax + (size_t)vis.expert * N * blocks_per_row;
  if (tid < 16) code[tid] = kGmmCode[tid];

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) wmma::fill_fragment(acc[i][jj], 0.0f);
  __syncthreads();

  for (int n0 = 0; n0 < N; n0 += kDxBK) {
    constexpr int kGChunks = BM * (kDxBK / 8);
    for (int c = tid; c < kGChunks; c += kThreads) {
      const int r = c / (kDxBK / 8);
      const int col = (c % (kDxBK / 8)) * 8;
      const int m = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m >= vis.lo && m < vis.hi && n0 + col < N)
        v = *reinterpret_cast<const uint4*>(g + (size_t)m * N + n0 + col);
      *reinterpret_cast<uint4*>(gs + r * kDxLdg + col) = v;
    }
    constexpr int kPChunks = kDxBK * (kStep / 16);
    for (int c = tid; c < kPChunks; c += kThreads) {
      const int r = c / (kStep / 16);
      const int col = (c % (kStep / 16)) * 16;
      const int n = n0 + r;
      uint4 hi_out[2], lo_out[2];
      decode16(wp + (size_t)n * half, ap + (size_t)n * blocks_per_row, code, j0 + col, half, bs,
               n < N && j0 + col < half, hi_out, lo_out);
      uint4* whi = reinterpret_cast<uint4*>(ws + r * kDxLdw + col);
      uint4* wlo = reinterpret_cast<uint4*>(ws + (kDxBK + r) * kDxLdw + col);
      whi[0] = hi_out[0];
      whi[1] = hi_out[1];
      wlo[0] = lo_out[0];
      wlo[1] = lo_out[1];
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kDxBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bw[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], gs + (wm * 32 + i * 16) * kDxLdg + kk, kDxLdg);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        wmma::load_matrix_sync(bw[jj], ws + (side * kDxBK + kk) * kDxLdw + jj * 16, kDxLdw);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) wmma::mma_sync(acc[i][jj], a[i], bw[jj], acc[i][jj]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * kDxLdc + side * kStep + jj * 16,
                              acc[i][jj], kDxLdc, wmma::mem_row_major);
  __syncthreads();
  for (int c = tid; c < BM * (2 * kStep / 8); c += kThreads) {
    const int r = c / (2 * kStep / 8);
    const int col = (c % (2 * kStep / 8)) * 8;
    const int m = m0 + r;
    if (m < vis.lo || m >= vis.hi || j0 + col % kStep >= half) continue;
    const int out_col = col < kStep ? j0 + col : half + j0 + (col - kStep);
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
    const float* src = cs + r * kDxLdc + col;
#pragma unroll
    for (int e = 0; e < 4; ++e) o2[e] = __floats2bfloat162_rn(src[2 * e], src[2 * e + 1]);
    *reinterpret_cast<uint4*>(dx + (size_t)m * K + out_col) = o;
  }
}

}  // namespace

// out = x @ dequant(W_g)^T + bias[g] per group on `stream`. Shapes: x [m, K]
// bf16 rows sorted by expert, packed [E, N, K/2] u8, absmax [E, N * K / bs]
// f32, bias [E, N] f32 or null, group_sizes [E] int32 on the device summing
// to m, out [m, N] bf16. K/2 a multiple of 32 and of bs (32 or 64), N a
// multiple of 8, pointers 16-byte aligned (the wrapper checks). Returns
// cudaGetLastError() after the launch; allocates nothing.
extern "C" int unsloth_nf4_gmm_bf16(const void* x, const void* packed, const void* absmax,
                                    const void* bias, const void* group_sizes, void* out, int m,
                                    int E, int N, int K, int bs, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* pp = static_cast<const uint8_t*>(packed);
  const auto* ap = static_cast<const float*>(absmax);
  const auto* bp = static_cast<const float*>(bias);
  const auto* gp = static_cast<const int*>(group_sizes);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (m <= 16) {
    const dim3 grid((N + kBN - 1) / kBN, (m + 15) / 16 + E);
    nf4_gmm_kernel<16><<<grid, kThreads, 0, s>>>(xp, pp, ap, bp, gp, op, E, N, K, bs);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (m + 63) / 64 + E);
    nf4_gmm_kernel<64><<<grid, kThreads, 0, s>>>(xp, pp, ap, bp, gp, op, E, N, K, bs);
  }
  return static_cast<int>(cudaGetLastError());
}

// dx = g @ dequant(W_g) per group on `stream`. Shapes: g [m, N] bf16 rows
// sorted by expert, packed / absmax / group_sizes as above, dx [m, K] bf16.
// Same conditions as the forward.
extern "C" int unsloth_nf4_gmm_dx_bf16(const void* g, const void* packed, const void* absmax,
                                       const void* group_sizes, void* dx, int m, int E, int N,
                                       int K, int bs, void* stream) {
  const dim3 grid((K / 2 + kStep - 1) / kStep, (m + kDxBM - 1) / kDxBM + E);
  nf4_gmm_dx_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(absmax), static_cast<const int*>(group_sizes),
      static_cast<__nv_bfloat16*>(dx), E, N, K, bs);
  return static_cast<int>(cudaGetLastError());
}
