// The C entry points of the NF4 dequant-inside-matmul above 16 rows of x:
// the forward (K1) y[M, N] = x[M, K] @ dequant(W)[N, K]^T and its gradient
// with respect to x (K2) dx[M, K] = g[M, N] @ dequant(W)[N, K].
//
// Replaces the TPU kernels unsloth_tpu/ops/qlora_matmul.py:_fwd_kernel
// (launched by _fwd_pallas, public entry nf4_matmul) and _bwd_kernel
// (launched by _bwd_pallas). Same arithmetic: each weight is
// NF4_CODE[nibble] * absmax (fp32), rounded to bf16 before the product,
// products summed in fp32, the sum rounded once to bf16.
//
// Layout (unsloth_tpu/ops/nf4.py, "split-half"): byte [n, j] of the packed
// uint8 [N, K/2] weight holds element [n, j] in its high nibble and element
// [n, j + K/2] in its low nibble; one absmax per 64 consecutive elements of
// a row. K/2 need only be a multiple of 32 (gpt-oss's K = 2,880: a block
// straddles the split-half boundary); the TPU kernel took only K/2 % 64 ==
// 0 (qlora_matmul.py:_shapes_ok).
//
// Both run nf4_wgmma.cu's persistent Hopper kernels (TMA ring, the NF4
// decode into wgmma's A fragments, wgmma products), bounded by tensor-core
// throughput, with the absmax the wrapper decodes to fp32. At 16 rows or
// fewer the forward is decode_matmul.cu's split-K kernel, bounded by the
// weight's bytes, which reads the absmax as stored; the wrapper calls its
// own entry point.

#include <cuda_runtime.h>

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

// y = x @ dequant(W)^T on `stream` at M > 16 (decode rows take
// unsloth_decode_matmul_nf4; M <= 16 here is refused). Shapes: x [M, K]
// bf16 row-major, packed [N, K/2] u8, absmax [N * K/64] f32, y [M, N]
// bf16. K/2 must be a multiple of 32 and every pointer 16-byte aligned
// (the wrapper checks). `counts` (null, or an int32 [2]): the kernel adds
// the output tiles it stored and the stages it consumed. Returns
// cudaGetLastError() after the launch; allocates nothing.
extern "C" int unsloth_nf4_matmul_bf16(const void* x, const void* packed, const void* absmax,
                                       void* y, int M, int N, int K, void* counts, void* stream) {
  if (M <= 16) return static_cast<int>(cudaErrorInvalidValue);
  return unsloth_nf4_wgmma_launch(x, packed, absmax, y, counts, M, N, K,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" const char* unsloth_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
