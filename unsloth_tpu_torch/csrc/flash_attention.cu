// Flash attention for unpacked or padded rows, GQA, bf16 (K16), causal and
// not: the C entry points of the kernels.
//
// Replaces the bundled Pallas TPU kernels that
// unsloth_tpu/ops/attention.py:_tpu_flash calls
// (jax.experimental.pallas.ops.tpu.flash_attention), with causal=True and
// with causal=False (bidirectional attention: the text-diffusion models):
//   _flash_attention_kernel   -> flash_fwd.cu (out and an fp32 lse = m + log l)
//   _flash_attention_bwd_dq   -> flash_dq.cu (dq; also di = sum(dout * out),
//                                which the JAX wrapper forms outside the
//                                kernels)
//   _flash_attention_bwd_dkv  -> flash_dkv.cu (dk, dv)
// The three are Hopper kernels (wgmma products, TMA-fed tile rings, the
// softmax in registers; hopper_tiles.cuh).
//
// Semantics: token i of a row attends to token j iff seg[i] == seg[j] and,
// causal, j <= i, over the *whole* range; no segment ids is the same with
// one segment. Nothing assumes contiguous segments, and every output is
// defined: a pad query (segment 0 on a padded row) attends the pad keys (at
// or before it, when causal). Rows past T load as zeros, match no segment
// id (sentinels) and are never stored. GQA: JAX expands k/v to Hq heads;
// here a block reads kv head h / (Hq / Hkv), and the dk/dv sums over the
// query heads have a fixed order, so every result has the same bits on
// every run.
//
// Rounding points are the bundled kernel's: scores in fp32 from bf16 q, k,
// times sm_scale in fp32 (the Hopper kernels fold it into exp2 as
// sm_scale * log2(e)); P rounded to bf16 before P @ V and P^T @ dO;
// dS = P * (dP - di) * sm_scale rounded to bf16 before dS @ K and
// dS^T @ Q. T is any length; D is 64 (Llama-3.2-1B, Qwen2.5-0.5B), 128
// (Llama-3.1-8B) or 256 (Gemma-1), as JAX runs _tpu_flash at any head dim
// that is a multiple of 64.
//
// What bounds it on an H100: tensor-core work over the visited tile pairs
// (4 D flops per valid (query, key) pair forward, 10 D backward). A visited
// pair is skipped when the segment-id ranges of its two tiles do not
// overlap (exact: no (query, key) pair in it can be valid), which drops the
// pad queries' work against the real keys of a padded row; the ranges come
// per 64-token tile (tile_segment_ranges), and a kernel's larger tile takes
// the min and max of the entries it spans.

#include "hopper_tiles.cuh"

using hflash::bf16;

// Forward on `stream`: out [B, T, Hq, D] bf16 and lse [B, Hq, T] fp32
// from q [B, T, Hq, D], k, v [B, T, Hkv, D] bf16, segment ids [B, T]
// int32 and their per-64-token-tile min / max [B, ceil(T/64)] int32.
// D is 64, 128 or 256, Hq % Hkv == 0, pointers 16-byte aligned (the
// wrapper checks); `causal` chooses the mask. `tile_counts`, when not
// null, is an int32 [3] to which the kernel adds the tile pairs it
// classed skip, full and masked (hopper_tiles.cuh). Returns the CUDA error
// code (0 if none).
extern "C" int unsloth_flash_attn_fwd(const void* q, const void* k, const void* v,
                                      const void* seg, const void* seg_min, const void* seg_max,
                                      void* out, void* lse, int B, int T, int Hq, int Hkv, int D,
                                      float scale, bool causal, void* tile_counts, void* stream) {
  hflash::Params p =
      hflash::make_params(seg, seg_min, seg_max, B, T, Hq, Hkv, scale, causal, tile_counts);
  p.o = static_cast<bf16*>(out);
  p.lse_out = static_cast<float*>(lse);
  return hflash::flash_fwd(D, hflash::FwdForm::kFlash, q, k, v, p,
                           static_cast<cudaStream_t>(stream));
}

// dq on `stream`: dq [B, T, Hq, D] bf16 and di [B, Hq, T] fp32 (for the
// dk/dv kernel) from the forward's inputs, its out and lse, and dout.
// `tile_counts` as for the forward.
extern "C" int unsloth_flash_attn_dq(const void* q, const void* k, const void* v,
                                     const void* seg, const void* seg_min, const void* seg_max,
                                     const void* out, const void* dout, const void* lse,
                                     void* di, void* dq, int B, int T, int Hq, int Hkv, int D,
                                     float scale, bool causal, void* tile_counts,
                                     void* stream) {
  hflash::Params p =
      hflash::make_params(seg, seg_min, seg_max, B, T, Hq, Hkv, scale, causal, tile_counts);
  p.out = static_cast<const bf16*>(out);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.di_out = static_cast<float*>(di);
  p.dq = static_cast<bf16*>(dq);
  return hflash::flash_dq(D, false, q, k, v, dout, p, static_cast<cudaStream_t>(stream));
}

// dk, dv on `stream`: [B, T, Hkv, D] bf16 from the forward's inputs, lse,
// dout and the di that the dq kernel wrote. The Hq / Hkv query heads of a
// kv head go to `nsplit` blocks (a divisor of Hq / Hkv); with nsplit > 1
// `scratch` is an fp32 [nsplit, 2, B, T, Hkv, D] for their partial sums.
// `tile_counts` as for the forward.
extern "C" int unsloth_flash_attn_dkv(const void* q, const void* k, const void* v,
                                      const void* seg, const void* seg_min, const void* seg_max,
                                      const void* dout, const void* lse, const void* di,
                                      void* dk, void* dv, void* scratch, int nsplit, int B,
                                      int T, int Hq, int Hkv, int D, float scale, bool causal,
                                      void* tile_counts, void* stream) {
  hflash::Params p =
      hflash::make_params(seg, seg_min, seg_max, B, T, Hq, Hkv, scale, causal, tile_counts);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.part = static_cast<float*>(scratch);
  p.nsplit = nsplit;
  return hflash::flash_dkv(D, false, q, k, v, dout, p, static_cast<cudaStream_t>(stream));
}
