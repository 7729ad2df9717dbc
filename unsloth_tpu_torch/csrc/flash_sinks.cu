// Flash attention with attention sinks: causal self-attention with segment
// ids, GQA and a learned per-head sink logit in the softmax normalizer,
// bf16, head dim 64 (gpt-oss), 128 or 256 (K17): the C entry points of the
// kernels.
//
// Replaces the bundled Pallas TPU flash kernels that
// unsloth_tpu/ops/attention.py:_tpu_flash_sinks drives
// (jax.experimental.pallas.ops.tpu.flash_attention):
//   _flash_attention_impl with its residuals (l, m), and the wrapper's
//     sink rescale m' = max(m, s), l' = l e^{m-m'} + e^{s-m'},
//     out = o (l e^{m-m'}) / l', lse' = m' + log l'
//                                  -> flash_fwd.cu (the kSinks form: K16's
//                                     forward with the rescale folded into
//                                     its epilogue)
//   _flash_attention_bwd_dq on (l', m'); also di = sum(dout * out), which
//     the JAX wrapper forms  -> flash_dq.cu (K16's causal dq kernel as it is)
//   _flash_attention_bwd_dkv on (l', m')
//                            -> flash_dkv.cu (K16's causal dk/dv kernel as
//                               it is, with its split of the query heads)
// The sink is an extra softmax logit with no value, so with lse' the
// bundled backward's p' = exp(score - lse') is the sink-softmax probability
// and dS = p' (dP - di) the exact gradient: K16's backward fed lse' is
// K17's. dsinks_h = -sum_{b,t} e^{s_h - lse'} di is a plain reduction in
// the wrapper (as in JAX), over the di that the dq kernel writes.
//
// Semantics, as the bundled kernels take them: the score is q . k in fp32
// times sm_scale; token i attends to token j iff j <= i and their segment
// ids are equal; dq = scale dS K, dk = scale dS^T Q, dv = P^T dO, dk and dv
// summed over each kv head's query heads in a fixed order (deterministic).
// Every query row sees itself, so no row's l is 0 below T; the forward
// still defines one (out = 0, lse' = s).
//
// Rounding points: P and dS are rounded to bf16 before their products, as
// in the bundled kernels; row statistics and the sink stay fp32; the
// forward's rescale by the sink is applied to the fp32 running output
// before its one rounding to bf16 (JAX rounds o, then rescales and rounds
// again).
//
// What bounds it on an H100: tensor-core work over the valid (query, key)
// pairs: 4 D flops per pair forward, 6 D for dq, 8 D for dk/dv. The
// kernels skip a tile pair whose segment-id ranges do not overlap (exact),
// so on packed rows the work follows sum(len_i^2), not T^2
// (hopper_tiles.cuh has the design).

#include "hopper_tiles.cuh"

using hflash::bf16;

// Forward on `stream`: out [B, T, Hq, D] bf16 and lse' [B, Hq, T] fp32
// from q [B, T, Hq, D], k, v [B, T, Hkv, D] bf16, segment ids [B, T]
// int32, their per-64-token-tile min / max [B, ceil(T/64)] int32 and the
// sinks [Hq] fp32. D is 64, 128 or 256, Hq % Hkv == 0, pointers 16-byte
// aligned (the wrapper checks). Returns the CUDA error code (0 if none).
extern "C" int unsloth_flash_sinks_fwd(const void* q, const void* k, const void* v,
                                       const void* seg, const void* seg_min,
                                       const void* seg_max, const void* sinks, void* out,
                                       void* lse, int B, int T, int Hq, int Hkv, int D,
                                       float scale, void* stream) {
  hflash::Params p =
      hflash::make_params(seg, seg_min, seg_max, B, T, Hq, Hkv, scale, true, nullptr);
  p.o = static_cast<bf16*>(out);
  p.lse_out = static_cast<float*>(lse);
  p.sinks = static_cast<const float*>(sinks);
  return hflash::flash_fwd(D, hflash::FwdForm::kSinks, q, k, v, p,
                           static_cast<cudaStream_t>(stream));
}

// dq on `stream`: dq [B, T, Hq, D] bf16 and di [B, Hq, T] fp32 (for the
// dk/dv kernel and dsinks) from the forward's inputs, its out and lse', and
// dout.
extern "C" int unsloth_flash_sinks_dq(const void* q, const void* k, const void* v,
                                      const void* seg, const void* seg_min, const void* seg_max,
                                      const void* out, const void* dout, const void* lse,
                                      void* di, void* dq, int B, int T, int Hq, int Hkv, int D,
                                      float scale, void* stream) {
  hflash::Params p =
      hflash::make_params(seg, seg_min, seg_max, B, T, Hq, Hkv, scale, true, nullptr);
  p.out = static_cast<const bf16*>(out);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.di_out = static_cast<float*>(di);
  p.dq = static_cast<bf16*>(dq);
  return hflash::flash_dq(D, false, q, k, v, dout, p, static_cast<cudaStream_t>(stream));
}

// dk, dv on `stream`: [B, T, Hkv, D] bf16 from the forward's inputs, lse',
// dout and the di that the dq kernel wrote. The Hq / Hkv query heads of a
// kv head go to `nsplit` blocks (a divisor of Hq / Hkv); with nsplit > 1
// `scratch` is an fp32 [nsplit, 2, B, T, Hkv, D] for their partial sums.
extern "C" int unsloth_flash_sinks_dkv(const void* q, const void* k, const void* v,
                                       const void* seg, const void* seg_min,
                                       const void* seg_max, const void* dout, const void* lse,
                                       const void* di, void* dk, void* dv, void* scratch,
                                       int nsplit, int B, int T, int Hq, int Hkv, int D,
                                       float scale, void* stream) {
  hflash::Params p =
      hflash::make_params(seg, seg_min, seg_max, B, T, Hq, Hkv, scale, true, nullptr);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.part = static_cast<float*>(scratch);
  p.nsplit = nsplit;
  return hflash::flash_dkv(D, false, q, k, v, dout, p, static_cast<cudaStream_t>(stream));
}
