// FP8 block-scaled dequant-inside-matmul: the forward (K12)
//   y[M, N]  = x[M, K] @ dequant(W)[N, K]^T
// and its gradient with respect to x (K13)
//   dx[M, K] = g[M, N] @ dequant(W)[N, K].
//
// Replaces the TPU kernels unsloth_tpu/ops/fp8_matmul.py:_fwd_kernel
// (launched by _fwd_pallas) and _bwd_kernel (launched by _bwd_pallas).
// Same arithmetic: each weight is fp32(e4m3) * scale[n / B][k / B], rounded
// once to bf16 before the product; products are summed in fp32 on the
// tensor cores; the sum is rounded once to bf16. The activations are never
// quantized: running the product in FP8 on the tensor cores would compute
// another function.
//
// Layout (unsloth_tpu/ops/fp8.py, the DeepSeek/vLLM block format): W is
// float8_e4m3fn [N, K] row-major, the scales fp32 [ceil(N/B), ceil(K/B)]
// row-major, any block B >= 1. N and K may be ragged (the last block and
// the last tile are masked) and M is any row count. The TPU kernel took
// only N, K % 128 == 0 and B == 128 (fp8_matmul.py:use_fused_fp8); these
// kernels take every tensor quantize_fp8_block makes.
//
// What bounds them on an H100:
//   * decode (M <= 16 rows): the weight's bytes, 1 B/param plus 4 / B^2 of
//     that in scales, each read once a call; K12 at these rows is
//     decode_matmul.cu's split-K kernel (its own entry point), K13 the
//     <16, true> tiles below;
//   * training (M in the thousands): tensor-core throughput; each decoded
//     weight tile serves a 64-row tile of x or g.
// Design, after csrc/nf4_matmul.cu (K1): one block of four warps computes a
// BM x 64 tile of the output and walks the contraction 64 at a time. Each
// step decodes one 64 x 64 tile of W into bf16 in shared memory: a 16-byte
// load of 16 e4m3 values, the hardware cvt (e4m3x2 -> f16x2, exact), one
// fp32 multiply by the block's scale, one round to bf16. The x (or g) tile
// goes to shared memory beside it, and nvcuda::wmma 16x16x16 bf16 products
// with fp32 accumulators run on the tensor cores. K12 walks W along its
// rows (one n-range, k stepping); K13 walks W down its columns (one
// k-range, n stepping), so the same scale grid is read with the two
// indices' roles swapped.
//
// Above 16 rows both run nf4_wgmma.cu's persistent Hopper kernels wherever
// those can map the shape. K12: K1's kernel in its e4m3 form
// (nf4_wgmma_kernel<BX, true>: TMA ring, the e4m3 bytes decoded into
// wgmma's A fragments, y^T = W x^T) where B % 32 == 0 (a 32-byte stage in
// one scale column), K % 16 == 0 (the TMA strides) and x, w and y are
// 16-byte aligned (fp8_wgmma_form below). K13: K2's kernel in its e4m3
// form (nf4_dx_wgmma_kernel<BX, true>: dx^T = W^T g^T, 64 W rows a stage,
// one scale a k step and warp) where, besides, N % 8 == 0 (g's TMA row
// stride) and g, w and dx are 16-byte aligned (fp8_dx_wgmma_form). Both
// rules are mirrored by ops/fp8_matmul.py. fp8_matmul_kernel<64, DX> takes
// the other shapes, <16, true> K13's decode rows.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int kBN = 64;          // output columns per block
constexpr int kStep = 64;        // contraction elements per step
constexpr int kLds = kStep + 8;  // shared-memory row stride in bf16, padded
constexpr int kThreads = 128;    // four warps

struct Fp8Weight {
  const uint8_t* w;      // e4m3 [N, K]
  const float* scales;   // fp32 [ceil(N/B), ceil(K/B)]
  int N, K, block, scale_cols;
  bool vec;              // K % 16 == 0 and w 16-byte aligned
};

__device__ __forceinline__ float2 e4m3x2_to_float2(uint32_t pair) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair & 0xFFFFu), __NV_E4M3);
  return __half22float2(__half2(h));
}

// W[r0 .. r0+63][c0 .. c0+63] decoded into ws [64][kLds] bf16: each value
// fp32(e4m3) * its block's scale, rounded once to bf16; zero past N or K.
__device__ __forceinline__ void load_w_tile(const Fp8Weight& op, int r0, int c0,
                                            __nv_bfloat16* ws, int tid) {
  constexpr int kChunks = 64 * (kStep / 16);  // 16 values a chunk
  for (int c = tid; c < kChunks; c += kThreads) {
    const int r = c / (kStep / 16);
    const int col = (c % (kStep / 16)) * 16;
    const int n = r0 + r;
    const int k = c0 + col;
    uint4 out[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
    if (n < op.N && k < op.K) {
      const uint8_t* src = op.w + (size_t)n * op.K + k;
      uint32_t words[4] = {0u, 0u, 0u, 0u};
      if (op.vec) {
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        words[0] = v.x; words[1] = v.y; words[2] = v.z; words[3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (k + e < op.K) words[e / 4] |= (uint32_t)src[e] << (8 * (e % 4));
      }
      const float* srow = op.scales + (size_t)(n / op.block) * op.scale_cols;
      int kb = k / op.block;
      float s = srow[kb];
      // the next block boundary along k; a chunk of 16 crosses it only when
      // B is not a multiple of 16 (or is smaller than 16)
      int next = (kb + 1) * op.block;
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float2 f = e4m3x2_to_float2(words[e / 2] >> (16 * (e % 2)));
        float s0 = s;
        if (k + 2 * e >= next && k + 2 * e < op.K) {
          ++kb; next += op.block; s = srow[kb]; s0 = s;
        }
        if (k + 2 * e + 1 >= next && k + 2 * e + 1 < op.K) {
          ++kb; next += op.block; s = srow[kb];
        }
        // fp32 product, then one round to bf16: the rounding point of
        // dequantize_fp8(w, dtype=bf16)
        o2[e] = __floats2bfloat162_rn(f.x * s0, f.y * s);
      }
    }
    uint4* dst = reinterpret_cast<uint4*>(ws + r * kLds + col);
    dst[0] = out[0];
    dst[1] = out[1];
  }
}

// a[m0 .. m0+BM-1][c0 .. c0+63] (bf16, rows of L) into as [BM][kLds]; zero
// past M or L.
template <int BM>
__device__ __forceinline__ void load_a_tile(const __nv_bfloat16* a, int M, int L, int m0,
                                            int c0, bool vec, __nv_bfloat16* as, int tid) {
  constexpr int kChunks = BM * (kStep / 8);  // 8 bf16 a chunk
  for (int c = tid; c < kChunks; c += kThreads) {
    const int r = c / (kStep / 8);
    const int col = (c % (kStep / 8)) * 8;
    const int m = m0 + r;
    const int k = c0 + col;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m < M && k < L) {
      const __nv_bfloat16* src = a + (size_t)m * L + k;
      if (vec) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
        uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (k + e < L) words[e / 2] |= (uint32_t)s16[e] << (16 * (e % 2));
        v = make_uint4(words[0], words[1], words[2], words[3]);
      }
    }
    *reinterpret_cast<uint4*>(as + r * kLds + col) = v;
  }
}

// One BM x 64 tile of the output. DX = false: y [M, N] = x [M, K] @ W^T,
// contraction over K, the block's 64 columns are W rows. DX = true: dx
// [M, K] = g [M, N] @ W, contraction over N, the block's 64 columns are W
// columns.
template <int BM, bool DX>
__global__ void __launch_bounds__(kThreads)
fp8_matmul_kernel(const __nv_bfloat16* __restrict__ a, Fp8Weight op,
                  __nv_bfloat16* __restrict__ out, int M, bool a_vec, bool out_vec) {
  constexpr int kWarpsM = BM == 64 ? 2 : 1;
  constexpr int kWarpsN = 4 / kWarpsM;
  constexpr int kWM = BM / kWarpsM;   // rows of the tile per warp
  constexpr int kWN = kBN / kWarpsN;  // columns of the tile per warp
  constexpr int kFM = kWM / 16;
  constexpr int kFN = kWN / 16;
  constexpr int kLdc = kBN + 4;
  constexpr int kBytesAB = (BM + 64) * kLds * 2;
  constexpr int kBytesC = BM * kLdc * 4;
  constexpr int kBytes = kBytesAB > kBytesC ? kBytesAB : kBytesC;
  using BLayout = typename std::conditional<DX, wmma::row_major, wmma::col_major>::type;
  __shared__ __align__(128) unsigned char smem[kBytes];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = as + BM * kLds;
  float* cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int m0 = blockIdx.y * BM;
  const int o0 = blockIdx.x * kBN;
  const int L = DX ? op.N : op.K;         // contraction length
  const int out_cols = DX ? op.K : op.N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int jj = 0; jj < kFN; ++jj) wmma::fill_fragment(acc[i][jj], 0.0f);

  for (int c0 = 0; c0 < L; c0 += kStep) {
    load_a_tile<BM>(a, M, L, m0, c0, a_vec, as, tid);
    if (DX)
      load_w_tile(op, c0, o0, ws, tid);
    else
      load_w_tile(op, o0, c0, ws, tid);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kStep; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> fb[kFN];
#pragma unroll
      for (int i = 0; i < kFM; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * kWM + i * 16) * kLds + kk, kLds);
#pragma unroll
      for (int jj = 0; jj < kFN; ++jj) {
        const int col = wn * kWN + jj * 16;
        // K12: B[k][n] = ws[n][k] (col-major); K13: B[n][k] = ws[n][k]
        const __nv_bfloat16* p = DX ? ws + kk * kLds + col : ws + col * kLds + kk;
        wmma::load_matrix_sync(fb[jj], p, kLds);
      }
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int jj = 0; jj < kFN; ++jj) wmma::mma_sync(acc[i][jj], fa[i], fb[jj], acc[i][jj]);
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
  // 8 consecutive columns per thread: one 16-byte store where the row
  // length allows it, else element by element.
  for (int c = tid; c < BM * (kBN / 8); c += kThreads) {
    const int r = c / (kBN / 8);
    const int col = (c % (kBN / 8)) * 8;
    const int m = m0 + r;
    const int o = o0 + col;
    if (m >= M || o >= out_cols) continue;
    const float* src = cs + r * kLdc + col;
    __nv_bfloat16* dst = out + (size_t)m * out_cols + o;
    if (out_vec) {
      uint4 v;
      __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) v2[e] = __floats2bfloat162_rn(src[2 * e], src[2 * e + 1]);
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      for (int e = 0; e < 8 && o + e < out_cols; ++e) dst[e] = __float2bfloat16(src[e]);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// The shapes K12's Hopper form takes.
bool fp8_wgmma_form(const void* x, const void* w, const void* y, int M, int K, int block) {
  return M > 16 && block % 32 == 0 && K % 16 == 0 && aligned16(x) && aligned16(w) &&
         aligned16(y);
}

// The shapes K13's Hopper form takes: K12's, and g's rows (N) a multiple of
// 16 bytes.
bool fp8_dx_wgmma_form(const void* g, const void* w, const void* dx, int M, int N, int K,
                       int block) {
  return fp8_wgmma_form(g, w, dx, M, K, block) && N % 8 == 0;
}

template <bool DX>
int launch(const void* a, const void* w, const void* scales, void* out, int M, int N, int K,
           int block, void* stream) {
  Fp8Weight op;
  op.w = static_cast<const uint8_t*>(w);
  op.scales = static_cast<const float*>(scales);
  op.N = N;
  op.K = K;
  op.block = block;
  op.scale_cols = (K + block - 1) / block;
  op.vec = K % 16 == 0 && aligned16(w);
  const int L = DX ? N : K;
  const int out_cols = DX ? K : N;
  const bool a_vec = L % 8 == 0 && aligned16(a);
  const bool out_vec = out_cols % 8 == 0 && aligned16(out);
  const auto* ap = static_cast<const __nv_bfloat16*>(a);
  auto* op_out = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block_dim(kThreads);
  if (M <= 16) {
    // K12's decode rows are decode_matmul.cu's (unsloth_decode_matmul_fp8)
    if constexpr (!DX) return static_cast<int>(cudaErrorInvalidValue);
    else {
      const dim3 grid((out_cols + kBN - 1) / kBN, (M + 15) / 16);
      fp8_matmul_kernel<16, DX><<<grid, block_dim, 0, s>>>(ap, op, op_out, M, a_vec, out_vec);
    }
  } else {
    const dim3 grid((out_cols + kBN - 1) / kBN, (M + 63) / 64);
    fp8_matmul_kernel<64, DX><<<grid, block_dim, 0, s>>>(ap, op, op_out, M, a_vec, out_vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int unsloth_fp8_wgmma_launch(const void* x, const void* w, const void* scales, void* y,
                             void* counts, int M, int N, int K, int block, cudaStream_t stream);
int unsloth_fp8_dx_wgmma_launch(const void* g, const void* w, const void* scales, void* dx,
                                void* counts, int M, int N, int K, int block,
                                cudaStream_t stream);

// y = x @ dequant(W)^T on `stream` at M > 16 (decode rows take
// unsloth_decode_matmul_fp8; M <= 16 here is refused). x [M, K] bf16
// row-major, w e4m3 [N, K] row-major, scales fp32 [ceil(N/B), ceil(K/B)],
// y [M, N] bf16. Any N, K >= 1 and B >= 1; pointers need no alignment (16-byte loads and stores
// are used where the row lengths and pointers allow them). Where
// fp8_wgmma_form holds, nf4_wgmma.cu's Hopper kernel; `counts` (null, or
// an int32 [2]) is that kernel's: it adds the output tiles it stored and
// the stages it consumed. Returns cudaGetLastError() after the launch;
// allocates nothing.
extern "C" int unsloth_fp8_matmul_bf16(const void* x, const void* w, const void* scales,
                                       void* y, int M, int N, int K, int block, void* counts,
                                       void* stream) {
  if (fp8_wgmma_form(x, w, y, M, K, block))
    return unsloth_fp8_wgmma_launch(x, w, scales, y, counts, M, N, K, block,
                                    static_cast<cudaStream_t>(stream));
  return launch<false>(x, w, scales, y, M, N, K, block, stream);
}

// dx = g @ dequant(W) on `stream`. g [M, N] bf16, w and scales as above,
// dx [M, K] bf16. Where fp8_dx_wgmma_form holds, nf4_wgmma.cu's Hopper
// kernel; `counts` (null, or an int32 [2]) is that kernel's: it adds the
// output tiles (128 columns of dx) it stored and the stages it consumed.
extern "C" int unsloth_fp8_matmul_dx_bf16(const void* g, const void* w, const void* scales,
                                          void* dx, int M, int N, int K, int block,
                                          void* counts, void* stream) {
  if (fp8_dx_wgmma_form(g, w, dx, M, N, K, block))
    return unsloth_fp8_dx_wgmma_launch(g, w, scales, dx, counts, M, N, K, block,
                                       static_cast<cudaStream_t>(stream));
  return launch<true>(g, w, scales, dx, M, N, K, block, stream);
}
