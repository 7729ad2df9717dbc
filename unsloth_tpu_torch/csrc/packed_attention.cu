// Segment-block-sparse causal flash attention for packed rows, GQA, bf16:
// the backward (K10, K11).
//
// Replaces the TPU kernels of unsloth_tpu/ops/packed_attention.py:
//   attn_dq_kernel<128, PackedRange>   <- _dq_kernel   (dq; also
//                                                       di = sum(dout * out))
//   attn_dkv_kernel<128, PackedRange>  <- _dkv_kernel  (dk, dv summed over
//                                                       the query heads that
//                                                       share a kv head)
// The kernel bodies live in attention_tiles.cuh; this file supplies the
// packed range. The forward (K9, TPU _fwd_kernel) runs on K16's Hopper
// forward (flash_fwd.cu, entry point unsloth_flash_attn_fwd), which the
// port's wrapper launches on q * bf16(scale) at scale 1: its out and its
// lse [B, Hq, T] = m + ln l, in the layout and the natural log these
// kernels read. Same semantics as the TPU kernels: token i of a row
// attends to token j iff both carry the same segment id and j <= i. Query
// block iq (64 tokens) visits kv blocks [kv_lo, min(kv_lo + n_kv - 1,
// iq)], kv block j visits query blocks [j, min(j + n_kv - 1, q_hi)], where
// kv_lo / q_hi come from segment_block_metadata and n_kv is the packer's
// segment-length bound in blocks. That skip assumes contiguous segments;
// outputs at pad positions are then unspecified. q is pre-scaled in bf16
// inside the kernels (q * bf16(scale), the rounding point of the JAX
// wrapper) and dq gets the factor `scale` back. T is a multiple of 64; D
// is 128, as in the JAX package, which takes this kernel at dh % 128 == 0
// only.
//
// What bounds it on an H100: tensor-core work over the visited tiles,
// O(sum of segment lengths squared) rather than O(T^2); see the header
// for the tile design.

#include "attention_tiles.cuh"

namespace {

struct PackedRange {
  const int* kv_lo;  // [B, T/64]
  const int* q_hi;   // [B, T/64]
  int nq, n_kv;
  static constexpr bool kCausal = true;
  __device__ int kv_begin(int b, int iq) const { return kv_lo[(size_t)b * nq + iq]; }
  __device__ int kv_end(int b, int iq) const { return min(kv_begin(b, iq) + n_kv - 1, iq); }
  __device__ int q_begin(int, int j) const { return j; }
  __device__ int q_end(int b, int j) const {
    return min(j + n_kv - 1, q_hi[(size_t)b * nq + j]);
  }
  __device__ bool skip(int, int, int) const { return false; }
};

constexpr int kD = 128;
using C = Tiles<kD>;

AttnArgs packed_args(int T, int Hq, int Hkv, float scale_q, float scale) {
  return AttnArgs{T, Hq, Hkv, true, scale_q, 1.0f, 1.0f, scale};
}

}  // namespace

// Backward on `stream`: the dq kernel (which also writes di [B, Hq, T]
// fp32 scratch), then the dk/dv kernel. dq [B, T, Hq, 128], dk, dv
// [B, T, Hkv, 128] bf16. Returns the first CUDA error code (0 if none).
extern "C" int unsloth_packed_attn_bwd(const void* q, const void* k, const void* v,
                                       const void* seg, const void* kv_lo, const void* q_hi,
                                       const void* out, const void* dout, const void* lse,
                                       void* di, void* dq, void* dk, void* dv, int B, int T,
                                       int Hq, int Hkv, int n_kv, float scale_q, float scale,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e = set_smem(reinterpret_cast<const void*>(attn_dq_kernel<kD, PackedRange>), C::kDqSmem);
  if (e) return e;
  e = set_smem(reinterpret_cast<const void*>(attn_dkv_kernel<kD, PackedRange>), C::kDkvSmem);
  if (e) return e;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* sp = static_cast<const int*>(seg);
  const PackedRange range{static_cast<const int*>(kv_lo), static_cast<const int*>(q_hi),
                          T / kBlk, n_kv};
  const AttnArgs a = packed_args(T, Hq, Hkv, scale_q, scale);
  attn_dq_kernel<kD, PackedRange><<<dim3(T / kBlk, Hq, B), C::kThreads, C::kDqSmem, s>>>(
      qp, kp, vp, sp, range, static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(di), static_cast<bf16*>(dq), a);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  attn_dkv_kernel<kD, PackedRange><<<dim3(T / kBlk, Hkv, B), C::kThreads, C::kDkvSmem, s>>>(
      qp, kp, vp, sp, range, static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dk), static_cast<bf16*>(dv), a);
  return static_cast<int>(cudaGetLastError());
}
