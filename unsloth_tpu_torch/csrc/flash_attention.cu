// Flash attention for unpacked or padded rows, GQA, bf16 (K16), causal and
// not.
//
// Replaces the bundled Pallas TPU kernels that
// unsloth_tpu/ops/attention.py:_tpu_flash calls
// (jax.experimental.pallas.ops.tpu.flash_attention), with causal=True and
// with causal=False (bidirectional attention: the text-diffusion models):
//   attn_fwd_kernel<D, Range>  <- _flash_attention_kernel (out and an fp32
//                                 lse = m + log l)
//   attn_dq_kernel<D, Range>   <- _flash_attention_bwd_dq (dq; also
//                                 di = sum(dout * out), which the JAX
//                                 wrapper forms outside the kernels)
//   attn_dkv_kernel<D, Range>  <- _flash_attention_bwd_dkv (dk, dv)
// with Range = CausalRange or FullRange. Semantics: token i of a row
// attends to token j iff seg[i] == seg[j] and, causal, j <= i, over the
// *whole* range; no segment ids is the same with one segment. Unlike the
// packed kernels (packed_attention.cu), nothing assumes contiguous
// segments, and every output is defined: a pad query (segment 0 on a
// padded row) attends the pad keys (at or before it, when causal).
// GQA: JAX expands k/v to Hq heads; here a block reads kv head
// h / (Hq / Hkv), and the dk/dv block sums its query heads in a loop, so
// the sum is deterministic.
//
// Rounding points are the bundled kernel's: scores in fp32 from bf16 q, k,
// times sm_scale in fp32; P rounded to bf16 before P @ V and P^T @ dO;
// dS = P * (dP - di) * sm_scale rounded to bf16 before dS @ K and
// dS^T @ Q. T is any length (the ragged last tile is masked); D is 64
// (Llama-3.2-1B, Qwen2.5-0.5B), 128 (Llama-3.1-8B) or 256 (Gemma-1), as
// JAX runs _tpu_flash at any head dim that is a multiple of 64.
//
// What bounds it on an H100: tensor-core work over the visited tile pairs
// (4 D flops per valid (query, key) pair forward, 10 D backward). The
// causal range visits iq + 1 kv tiles per query tile, the full range all
// of them (twice the pairs, and twice the bound). A visited pair is
// skipped when the segment-id ranges of its two tiles do not overlap
// (SegRange::skip; exact, as no (query, key) pair in it can be valid),
// which drops the pad queries' work against the real keys of a padded row.
// Causality is a compile-time property of the policy (kCausal), so the
// causal kernels are the code they were before the full range existed.
// The tile design is in attention_tiles.cuh: at D = 256 a block of 8
// warps holds 176-191 KB of shared memory (one block an SM), at D = 64 a
// block of 4 warps 71-89 KB.

#include "attention_tiles.cuh"

namespace {

// The whole range of a row, causal or not, less the tile pairs whose
// segment-id ranges do not overlap.
template <bool Causal>
struct SegRange {
  static constexpr bool kCausal = Causal;
  const int* seg_min;  // [B, ceil(T/64)] per-tile min segment id
  const int* seg_max;  // [B, ceil(T/64)] per-tile max segment id
  int nq;
  __device__ int kv_begin(int, int) const { return 0; }
  __device__ int kv_end(int, int iq) const { return Causal ? iq : nq - 1; }
  __device__ int q_begin(int, int j) const { return Causal ? j : 0; }
  __device__ int q_end(int, int) const { return nq - 1; }
  __device__ bool skip(int b, int iq, int j) const {
    const size_t row = (size_t)b * nq;
    return seg_max[row + j] < seg_min[row + iq] || seg_min[row + j] > seg_max[row + iq];
  }
};
using CausalRange = SegRange<true>;
using FullRange = SegRange<false>;

AttnArgs flash_args(int T, int Hq, int Hkv, float scale) {
  return AttnArgs{T, Hq, Hkv, false, 1.0f, scale, scale, 1.0f};
}

template <class Range>
Range seg_range(const void* seg_min, const void* seg_max, int T) {
  return Range{static_cast<const int*>(seg_min), static_cast<const int*>(seg_max),
               (T + kBlk - 1) / kBlk};
}

template <int D, class Range>
int launch_fwd(const void* q, const void* k, const void* v, const void* seg,
               const void* seg_min, const void* seg_max, void* out, void* lse, int B, int T,
               int Hq, int Hkv, float scale, cudaStream_t stream) {
  using C = Tiles<D>;
  int e = set_smem(reinterpret_cast<const void*>(attn_fwd_kernel<D, Range>), C::kFwdSmem);
  if (e) return e;
  const Range range = seg_range<Range>(seg_min, seg_max, T);
  attn_fwd_kernel<D, Range><<<dim3(range.nq, Hq, B), C::kThreads, C::kFwdSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), range, static_cast<bf16*>(out), static_cast<float*>(lse),
      flash_args(T, Hq, Hkv, scale));
  return static_cast<int>(cudaGetLastError());
}

template <int D, class Range>
int launch_dq(const void* q, const void* k, const void* v, const void* seg, const void* seg_min,
              const void* seg_max, const void* out, const void* dout, const void* lse, void* di,
              void* dq, int B, int T, int Hq, int Hkv, float scale, cudaStream_t stream) {
  using C = Tiles<D>;
  int e = set_smem(reinterpret_cast<const void*>(attn_dq_kernel<D, Range>), C::kDqSmem);
  if (e) return e;
  const Range range = seg_range<Range>(seg_min, seg_max, T);
  attn_dq_kernel<D, Range><<<dim3(range.nq, Hq, B), C::kThreads, C::kDqSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), range, static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<float*>(di),
      static_cast<bf16*>(dq), flash_args(T, Hq, Hkv, scale));
  return static_cast<int>(cudaGetLastError());
}

template <int D, class Range>
int launch_dkv(const void* q, const void* k, const void* v, const void* seg,
               const void* seg_min, const void* seg_max, const void* dout, const void* lse,
               const void* di, void* dk, void* dv, int B, int T, int Hq, int Hkv, float scale,
               cudaStream_t stream) {
  using C = Tiles<D>;
  int e = set_smem(reinterpret_cast<const void*>(attn_dkv_kernel<D, Range>), C::kDkvSmem);
  if (e) return e;
  const Range range = seg_range<Range>(seg_min, seg_max, T);
  attn_dkv_kernel<D, Range><<<dim3(range.nq, Hkv, B), C::kThreads, C::kDkvSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), range, static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), flash_args(T, Hq, Hkv, scale));
  return static_cast<int>(cudaGetLastError());
}

// The kernels of head dim D (64, 128 or 256; another is an invalid value)
// and range policy Range.
template <class Range>
int fwd_for(int D, const void* q, const void* k, const void* v, const void* seg,
            const void* seg_min, const void* seg_max, void* out, void* lse, int B, int T, int Hq,
            int Hkv, float scale, cudaStream_t s) {
  if (D == 64)
    return launch_fwd<64, Range>(q, k, v, seg, seg_min, seg_max, out, lse, B, T,
                                 Hq, Hkv, scale, s);
  if (D == 128)
    return launch_fwd<128, Range>(q, k, v, seg, seg_min, seg_max, out, lse, B, T,
                                  Hq, Hkv, scale, s);
  if (D == 256)
    return launch_fwd<256, Range>(q, k, v, seg, seg_min, seg_max, out, lse, B, T,
                                  Hq, Hkv, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class Range>
int dq_for(int D, const void* q, const void* k, const void* v, const void* seg,
           const void* seg_min, const void* seg_max, const void* out, const void* dout,
           const void* lse, void* di, void* dq, int B, int T, int Hq, int Hkv, float scale,
           cudaStream_t s) {
  if (D == 64)
    return launch_dq<64, Range>(q, k, v, seg, seg_min, seg_max, out, dout,
                                lse, di, dq, B, T, Hq, Hkv, scale, s);
  if (D == 128)
    return launch_dq<128, Range>(q, k, v, seg, seg_min, seg_max, out, dout,
                                 lse, di, dq, B, T, Hq, Hkv, scale, s);
  if (D == 256)
    return launch_dq<256, Range>(q, k, v, seg, seg_min, seg_max, out, dout,
                                 lse, di, dq, B, T, Hq, Hkv, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class Range>
int dkv_for(int D, const void* q, const void* k, const void* v, const void* seg,
            const void* seg_min, const void* seg_max, const void* dout, const void* lse,
            const void* di, void* dk, void* dv, int B, int T, int Hq, int Hkv, float scale,
            cudaStream_t s) {
  if (D == 64)
    return launch_dkv<64, Range>(q, k, v, seg, seg_min, seg_max, dout, lse,
                                 di, dk, dv, B, T, Hq, Hkv, scale, s);
  if (D == 128)
    return launch_dkv<128, Range>(q, k, v, seg, seg_min, seg_max, dout, lse,
                                  di, dk, dv, B, T, Hq, Hkv, scale, s);
  if (D == 256)
    return launch_dkv<256, Range>(q, k, v, seg, seg_min, seg_max, dout, lse,
                                  di, dk, dv, B, T, Hq, Hkv, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Forward on `stream`: out [B, T, Hq, D] bf16 and lse [B, Hq, T] fp32
// from q [B, T, Hq, D], k, v [B, T, Hkv, D] bf16, segment ids [B, T]
// int32 and their per-64-token-tile min / max [B, ceil(T/64)] int32.
// D is 64, 128 or 256, Hq % Hkv == 0, pointers 16-byte aligned (the
// wrapper checks); `causal` chooses the mask. Returns the CUDA error code
// (0 if none).
extern "C" int unsloth_flash_attn_fwd(const void* q, const void* k, const void* v,
                                      const void* seg, const void* seg_min, const void* seg_max,
                                      void* out, void* lse, int B, int T, int Hq, int Hkv, int D,
                                      float scale, bool causal, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return causal ? fwd_for<CausalRange>(D, q, k, v, seg, seg_min, seg_max, out, lse, B, T, Hq,
                                       Hkv, scale, s)
                : fwd_for<FullRange>(D, q, k, v, seg, seg_min, seg_max, out, lse, B, T, Hq, Hkv,
                                     scale, s);
}

// dq on `stream`: dq [B, T, Hq, D] bf16 and di [B, Hq, T] fp32 (for the
// dk/dv kernel) from the forward's inputs, its out and lse, and dout.
extern "C" int unsloth_flash_attn_dq(const void* q, const void* k, const void* v,
                                     const void* seg, const void* seg_min, const void* seg_max,
                                     const void* out, const void* dout, const void* lse,
                                     void* di, void* dq, int B, int T, int Hq, int Hkv, int D,
                                     float scale, bool causal, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return causal ? dq_for<CausalRange>(D, q, k, v, seg, seg_min, seg_max, out, dout, lse, di, dq,
                                      B, T, Hq, Hkv, scale, s)
                : dq_for<FullRange>(D, q, k, v, seg, seg_min, seg_max, out, dout, lse, di, dq, B,
                                    T, Hq, Hkv, scale, s);
}

// dk, dv on `stream`: [B, T, Hkv, D] bf16 from the forward's inputs, lse,
// dout and the di that the dq kernel wrote.
extern "C" int unsloth_flash_attn_dkv(const void* q, const void* k, const void* v,
                                      const void* seg, const void* seg_min, const void* seg_max,
                                      const void* dout, const void* lse, const void* di,
                                      void* dk, void* dv, int B, int T, int Hq, int Hkv, int D,
                                      float scale, bool causal, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return causal ? dkv_for<CausalRange>(D, q, k, v, seg, seg_min, seg_max, dout, lse, di, dk, dv,
                                       B, T, Hq, Hkv, scale, s)
                : dkv_for<FullRange>(D, q, k, v, seg, seg_min, seg_max, dout, lse, di, dk, dv, B,
                                     T, Hq, Hkv, scale, s);
}
