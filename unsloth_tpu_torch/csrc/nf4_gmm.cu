// Grouped NF4 dequant-inside-matmul over experts (the MoE QLoRA base), K14
// and K15: the C entry points.
//
// K14 (out[r, :] = x[r, :] @ dequant(W_g)^T + bias[g] for the rows r of
// group g) above 16 rows is nf4_wgmma.cu's nf4_gmm_wgmma_kernel<BX>, K1's
// Hopper kernel under a grouped persistent schedule; at 16 rows or fewer
// decode_matmul.cu's grouped_decode_kernel<NF4Stacked, NT>, the split-K
// decode kernel under a grouped schedule (one launch a call, each expert
// that owns rows read once). K15 (dx = g @ dequant(W_g) per group) at
// every row count is nf4_wgmma.cu's nf4_gmm_dx_wgmma_kernel<BX>, K2's
// Hopper kernel under the same grouped schedule. See their notes.
//
// Replaces the TPU kernels unsloth_tpu/ops/nf4_gmm.py:_fwd_kernel
// (launched by _nf4_gmm_fwd_impl) and _bwd_kernel (_nf4_gmm_bwd_impl).
// Layout: rows of x (and of g, dx, out) are sorted by expert; group g owns
// rows [off_g, off_g + size_g), off the running sum of the int32 group
// sizes, which stay on the device (no host sync per MoE layer). The weight
// is NF4Stacked [E, N, K]: packed uint8 [E, N, K/2] in split-half order
// (byte [e, n, j] holds element j in its high nibble and element j + K/2 in
// its low one), absmax fp32 [E, N * K / bs] for a block size bs of 32 or
// 64.

#include <cuda_runtime.h>

int unsloth_nf4_gmm_wgmma_launch(const void* x, const void* packed, const void* absmax,
                                 const void* bias, const void* group_sizes, void* y,
                                 void* counts, int M, int E, int N, int K, int bs,
                                 cudaStream_t stream);
int unsloth_nf4_gmm_dx_wgmma_launch(const void* g, const void* packed, const void* absmax_t,
                                    const void* group_sizes, void* dx, void* counts, int M, int E,
                                    int N, int K, int bs, cudaStream_t stream);

int unsloth_decode_gmm_nf4(const void* x, const void* packed, const void* absmax, int block,
                           const void* bias, bool bias_f32, const void* group_sizes, void* y,
                           void* partials, void* arrivals, int M, int E, int N, int K,
                           int row_warps, int slices, int slice_steps, void* counts,
                           cudaStream_t stream);

// out = x @ dequant(W_g)^T + bias[g] per group on `stream`. Shapes: x [m, K]
// bf16 rows sorted by expert, packed [E, N, K/2] u8, absmax [E, N * K / bs]
// f32, bias [E, N] or null, fp32 (`bias_f32`) or, at 16 rows or fewer,
// bf16, group_sizes [E] int32 on the device summing to at most m, out
// [m, N] bf16, every row written (zeros past the groups). K/2 a multiple
// of 32 and of bs (32 or 64), N a multiple of 8, pointers 16-byte aligned,
// E <= 1,024 (the wrapper checks). Above 16 rows nf4_wgmma.cu's Hopper
// kernel, whose `counts` (null, or an int32 [3]) are tiles, stages and
// masked tiles; at 16 rows or fewer decode_matmul.cu's grouped decode
// kernel under the schedule (row_warps, slices, slice_steps) and scratch
// (partials, arrivals) the wrapper passes (ops/qlora_matmul.py:
// grouped_decode_schedule), whose `counts` are units, 16-byte chunks and
// empty slots. Returns the launch's CUDA error code; allocates nothing.
extern "C" int unsloth_nf4_gmm_bf16(const void* x, const void* packed, const void* absmax,
                                    const void* bias, int bias_f32, const void* group_sizes,
                                    void* out, int m, int E, int N, int K, int bs,
                                    int row_warps, int slices, int slice_steps, void* partials,
                                    void* arrivals, void* counts, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 16)
    return unsloth_decode_gmm_nf4(x, packed, absmax, bs, bias, bias_f32 != 0, group_sizes, out,
                                  partials, arrivals, m, E, N, K, row_warps, slices, slice_steps,
                                  counts, s);
  if (bias != nullptr && !bias_f32) return static_cast<int>(cudaErrorInvalidValue);
  return unsloth_nf4_gmm_wgmma_launch(x, packed, absmax, bias, group_sizes, out, counts, m, E, N,
                                      K, bs, s);
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
