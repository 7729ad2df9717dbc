// NF4 dequant-inside-matmul forward: y[M, N] = x[M, K] @ dequant(W)[N, K]^T.
//
// Replaces the TPU kernel unsloth_tpu/ops/qlora_matmul.py:_fwd_kernel
// (launched by _fwd_pallas, public entry nf4_matmul). Same arithmetic:
// each weight is NF4_CODE[nibble] * absmax (fp32), rounded to bf16 before
// the product, products summed in fp32, the sum rounded once to bf16.
//
// Layout (unsloth_tpu/ops/nf4.py, "split-half"): byte [n, j] of the packed
// uint8 [N, K/2] weight holds element [n, j] in its high nibble and element
// [n, j + K/2] in its low nibble. absmax is fp32 [N * K/64], one scale per
// 64 consecutive elements of a row; the wrapper decodes double-quantized
// codes to fp32 before the launch, as the TPU launcher does. K/2 need only
// be a multiple of 32 (gpt-oss's K = 2,880: K/2 = 1,440 = 22.5 blocks of
// 64, so a block straddles the split-half boundary). The TPU kernel takes
// only K/2 % 64 == 0 (qlora_matmul.py:_shapes_ok) and dequantizes in XLA
// otherwise; these kernels run at every such shape.
//
// Two kernels, picked by the row count in unsloth_nf4_matmul_bf16:
//   * M > 16 (prefill and training rows): nf4_wgmma.cu's persistent Hopper
//     kernel (TMA ring, the NF4 decode into wgmma's A fragments, wgmma
//     products, TMA store), bounded by tensor-core throughput.
//   * M <= 16 (decode): nf4_matmul_kernel<16> below, bounded by the bytes
//     of weight read, 0.5 B/param plus 1/16 of that again in fp32 absmax;
//     every byte is read once per call. One block computes a 16 x 64 tile
//     of y. It walks the packed bytes 64 at a time; each byte load yields
//     two decoded weights, one for column j (high nibble) and one for
//     column j + K/2 (low nibble), so one step pairs one byte tile with two
//     x column tiles; each 16-byte chunk looks up its own absmax, from the
//     element index of its first column, and the last 64-byte step of a
//     row is masked past K/2. The 16-entry codebook sits in shared memory;
//     decoded bf16 W and x tiles go to shared memory and the products run
//     on the tensor cores through nvcuda::wmma 16x16x16 bf16 with fp32
//     accumulators. TMA, pipelining and a split-K shape for decode are
//     later work.
//
// The backward dx = g @ dequant(W) (K2) is nf4_wgmma.cu's
// nf4_dx_wgmma_kernel at every row count; its C entry point is below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

__constant__ float kNF4Code[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

constexpr int kBN = 64;          // output columns (weight rows) per block
constexpr int kStep = 64;        // packed bytes per row per step = one absmax block
constexpr int kLds = kStep + 8;  // shared-memory row stride in bf16, padded
constexpr int kThreads = 128;    // four warps
constexpr int kQuantBlock = 64;

template <int BM>
__global__ void __launch_bounds__(kThreads)
nf4_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint8_t* __restrict__ packed,
                  const float* __restrict__ absmax,
                  __nv_bfloat16* __restrict__ y, int M, int N, int K) {
  constexpr int kWarpsM = BM == 64 ? 2 : 1;
  constexpr int kWarpsN = 4 / kWarpsM;
  constexpr int kWM = BM / kWarpsM;  // rows of y per warp
  constexpr int kWN = kBN / kWarpsN; // columns of y per warp
  constexpr int kFM = kWM / 16;
  constexpr int kFN = kWN / 16;
  constexpr int kLdc = kBN + 4;
  // x tiles [2][BM][kLds] and W tiles [2][kBN][kLds] (index 0: the high
  // nibble side, columns j..; index 1: the low side, columns K/2 + j..);
  // the fp32 output tile [BM][kLdc] reuses the same bytes after the loop.
  constexpr int kBytesAB = (2 * BM + 2 * kBN) * kLds * 2;
  constexpr int kBytesC = BM * kLdc * 4;
  constexpr int kBytes = kBytesAB > kBytesC ? kBytesAB : kBytesC;
  __shared__ __align__(128) unsigned char smem[kBytes];
  __shared__ float code[16];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = xs + 2 * BM * kLds;
  float* cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const int half = K / 2;
  const int blocks_per_row = K / kQuantBlock;
  if (tid < 16) code[tid] = kNF4Code[tid];

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int jj = 0; jj < kFN; ++jj) wmma::fill_fragment(acc[i][jj], 0.0f);
  __syncthreads();

  for (int j = 0; j < half; j += kStep) {
    // x: both column tiles, 16-byte chunks of 8 bf16; rows past M are 0.
    constexpr int kXChunks = 2 * BM * (kStep / 8);
    for (int c = tid; c < kXChunks; c += kThreads) {
      const int side = c / (BM * (kStep / 8));
      const int r = (c / (kStep / 8)) % BM;
      const int col = (c % (kStep / 8)) * 8;
      const int m = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && j + col < half)
        v = *reinterpret_cast<const uint4*>(x + (size_t)m * K + side * half + j + col);
      *reinterpret_cast<uint4*>(xs + (side * BM + r) * kLds + col) = v;
    }
    // W: one 16-byte load of packed bytes gives 16 weights of each side.
    constexpr int kPChunks = kBN * (kStep / 16);
    for (int c = tid; c < kPChunks; c += kThreads) {
      const int r = c / (kStep / 16);
      const int col = (c % (kStep / 16)) * 16;
      const int n = n0 + r;
      uint4 hi_out[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
      uint4 lo_out[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
      if (n < N && j + col < half) {
        const uint4 v = *reinterpret_cast<const uint4*>(packed + (size_t)n * half + j + col);
        const float a_hi = absmax[(size_t)n * blocks_per_row + (j + col) / kQuantBlock];
        const float a_lo = absmax[(size_t)n * blocks_per_row + (half + j + col) / kQuantBlock];
        const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
        __nv_bfloat162* hi2 = reinterpret_cast<__nv_bfloat162*>(hi_out);
        __nv_bfloat162* lo2 = reinterpret_cast<__nv_bfloat162*>(lo_out);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint8_t b0 = b[2 * e], b1 = b[2 * e + 1];
          // fp32 product, then one round to bf16: the rounding point of
          // dequantize_nf4(w, dtype=bf16).
          hi2[e] = __floats2bfloat162_rn(code[b0 >> 4] * a_hi, code[b1 >> 4] * a_hi);
          lo2[e] = __floats2bfloat162_rn(code[b0 & 15] * a_lo, code[b1 & 15] * a_lo);
        }
      }
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
  for (int c = tid; c < BM * kBN; c += kThreads) {
    const int r = c / kBN;
    const int col = c % kBN;
    const int m = m0 + r;
    const int n = n0 + col;
    if (m < M && n < N) y[(size_t)m * N + n] = __float2bfloat16(cs[r * kLdc + col]);
  }
}

}  // namespace

int unsloth_nf4_dx_wgmma_launch(const void* g, const void* packed, const void* absmax_t,
                                void* dx, void* counts, int M, int N, int K, cudaStream_t stream);

// dx = g @ dequant(W) on `stream`: nf4_wgmma.cu's Hopper kernel at every
// row count. Shapes: g [M, N] bf16 row-major, packed [N, K/2] u8, absmax_t
// the absmax transposed, fp32 [K/64, N], dx [M, K] bf16. N must be a
// multiple of 64, K/2 a multiple of 32 and every pointer 16-byte aligned
// (the wrapper checks). `counts` (null, or an int32 [2]): the kernel adds
// the output tiles it stored and the stages it consumed. Returns
// cudaGetLastError() after the launch; allocates nothing.
extern "C" int unsloth_nf4_matmul_dx_bf16(const void* g, const void* packed,
                                          const void* absmax_t, void* dx, int M, int N, int K,
                                          void* counts, void* stream) {
  return unsloth_nf4_dx_wgmma_launch(g, packed, absmax_t, dx, counts, M, N, K,
                                     static_cast<cudaStream_t>(stream));
}

int unsloth_nf4_wgmma_launch(const void* x, const void* packed, const void* absmax, void* y,
                             void* counts, int M, int N, int K, cudaStream_t stream);

// y = x @ dequant(W)^T on `stream`. Shapes: x [M, K] bf16 row-major,
// packed [N, K/2] u8, absmax [N * K/64] f32, y [M, N] bf16. K/2 must be a
// multiple of 32 and every pointer 16-byte aligned (the wrapper checks).
// M <= 16 runs nf4_matmul_kernel<16>, more rows nf4_wgmma.cu's kernel;
// `counts` (null, or an int32 [2]) is that kernel's: it adds the output
// tiles it stored and the stages it consumed. Returns cudaGetLastError()
// after the launch; allocates nothing.
extern "C" int unsloth_nf4_matmul_bf16(const void* x, const void* packed, const void* absmax,
                                       void* y, int M, int N, int K, void* counts, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 16) return unsloth_nf4_wgmma_launch(x, packed, absmax, y, counts, M, N, K, s);
  const dim3 grid((N + kBN - 1) / kBN, (M + 15) / 16);
  nf4_matmul_kernel<16><<<grid, dim3(kThreads), 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(absmax), static_cast<__nv_bfloat16*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* unsloth_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
