// Splash attention: self-attention with a sliding window, a logit softcap,
// segment ids, GQA and GRPO's shared-prefix layout, causal, or without
// causality (softcap and segment ids only), bf16, head dim 64, 128 or 256
// (K18): the C entry points of the kernels.
//
// Replaces the bundled Pallas TPU splash kernels that
// unsloth_tpu/ops/attention.py:_tpu_splash builds in _splash_kernel
// (jax.experimental.pallas.ops.tpu.splash_attention, a CausalMask, a
// LocalMask(window_size=(window - 1, 0)), under prefix_attention a
// NumpyMask(prefix_mask_array(P, G, L)), or, for causal=False without a
// window, a FullMask, per kv head):
//   the forward kernel (out and an fp32 lse = m + log l) -> flash_fwd.cu
//   the dq kernel (dq; also di = sum(dout * out), which the JAX wrapper
//     forms outside)                                      -> flash_dq.cu
//   the dk/dv kernel                                      -> flash_dkv.cu
// K18 runs on K16's Hopper kernels (wgmma products, TMA-fed tile rings, the
// softmax in registers; hopper_tiles.cuh), instantiated with kSplash, which
// adds the softcap, q's rounding, the window and the prefix layout.
//
// Semantics, as _tpu_splash feeds the kernel: q is multiplied by `scale`
// and rounded to bf16 first (the kernels do it in shared memory after the
// TMA load); s = q_scaled . k in fp32; with a softcap c,
// s' = c * tanh(s / c); token i attends to token j iff j <= i,
// i - j < window (when a window is given) and seg[i] == seg[j]; with
// `causal` off (no window, no layout: the wrapper refuses both) iff
// seg[i] == seg[j]. Every output is defined (a token always sees itself).
// In the backward dS' = P * (dP - di), and with a softcap
// dS = dS' * (1 - tanh^2(s / c)); dq = scale * (dS @ K), dk = dS^T @
// q_scaled, dv = P^T @ dO. The window (<= 0: none) and the softcap (<= 0:
// none) are runtime arguments, and so is the prefix layout (G = 0: none):
// the row is [P prompt slots | G completion regions of L slots],
// T = P + G L, and token i attends to token j iff j <= i,
// seg[i] == seg[j], and j < P or i and j lie in the same region (each
// completion sees the shared prompt and itself, never another
// completion). The layout replaces the window (the wrapper refuses both at
// once). GQA: JAX runs the kernel per kv head with its query heads
// stacked; here a block reads kv head h / (Hq / Hkv), and the dk/dv block
// sums its query heads in a loop, so the sum is deterministic.
//
// Rounding points: the bundled forward multiplies fp32 P by fp32 V; here
// P V is two bf16 products, P rounded to bf16 and its remainder
// P - bf16(P), which carry P to ~16 bits (with P rounded once, gpt-oss's
// router-bias gradient, a sum that cancels, moved past its check). The
// backward rounds P and dS to bf16 before their products, as the bundled
// one does. Row statistics stay fp32.
//
// What bounds it on an H100: tensor-core work over the visited tile pairs
// (4 D flops per valid (query, key) pair forward, 6 D as the kernel takes
// P V twice; 10 D backward), and with
// a softcap the special-function unit (ex2 and rcp for tanh, ex2 for P:
// about three a score). The forward's and dq's walk of a query tile starts
// at the first kv tile its window reaches and ends at its own (or at the
// last without causality); the dk/dv walk of a kv tile ends at the last
// query tile its window or its region reaches. A visited pair is classed
// (hopper_tiles.cuh: pair_class<true>): skipped when the segment-id ranges
// of its tiles do not overlap, or the prefix layout masks it whole (the kv
// tile past the prompt and before the region of the query tile's first
// query past it); full (no element mask) when it holds only valid pairs;
// else masked. Every skip is exact; a tile that straddles the prompt's or
// a region's edge is masked, so any P, G, L is exact. Given a counter, each
// kernel adds the pairs it classed skip, full and masked, so that a caller
// can read back what the rules left.

#include "hopper_tiles.cuh"

using hflash::bf16;

// Forward on `stream`: out [B, T, Hq, D] bf16 and lse [B, Hq, T] fp32 from
// q [B, T, Hq, D], k, v [B, T, Hkv, D] bf16, segment ids [B, T] int32 and
// their per-64-token-tile min / max [B, ceil(T/64)] int32. D is 64, 128 or
// 256, Hq % Hkv == 0, pointers 16-byte aligned (the wrapper checks);
// window <= 0 and softcap <= 0 mean none; the prefix layout (P, G, L) has
// T = P + G L, L > 0 and no window, and G = 0 means none; with causal
// false there is no window and no layout. `tile_counts`, when not null, is
// an int32 [3] to which the kernel adds the tile pairs it classed skip,
// full and masked. Returns the CUDA error code (0 if none).
extern "C" int unsloth_splash_attn_fwd(const void* q, const void* k, const void* v,
                                       const void* seg, const void* seg_min,
                                       const void* seg_max, void* out, void* lse, int P, int G,
                                       int L, int B, int T, int Hq, int Hkv, int D, float scale,
                                       int window, float softcap, bool causal, void* tile_counts,
                                       void* stream) {
  hflash::Params p = hflash::make_splash_params(seg, seg_min, seg_max, B, T, Hq, Hkv, scale,
                                                causal, tile_counts, window, softcap, P, G, L);
  p.o = static_cast<bf16*>(out);
  p.lse_out = static_cast<float*>(lse);
  return hflash::flash_fwd(D, hflash::FwdForm::kSplash, q, k, v, p,
                           static_cast<cudaStream_t>(stream));
}

// dq on `stream`: dq [B, T, Hq, D] bf16 and di [B, Hq, T] fp32 (for the
// dk/dv kernel) from the forward's inputs, its out and lse, and dout.
// `tile_counts` as for the forward.
extern "C" int unsloth_splash_attn_dq(const void* q, const void* k, const void* v,
                                      const void* seg, const void* seg_min, const void* seg_max,
                                      const void* out, const void* dout, const void* lse,
                                      void* di, void* dq, int P, int G, int L, int B, int T,
                                      int Hq, int Hkv, int D, float scale, int window,
                                      float softcap, bool causal, void* tile_counts,
                                      void* stream) {
  hflash::Params p = hflash::make_splash_params(seg, seg_min, seg_max, B, T, Hq, Hkv, scale,
                                                causal, tile_counts, window, softcap, P, G, L);
  p.out = static_cast<const bf16*>(out);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.di_out = static_cast<float*>(di);
  p.dq = static_cast<bf16*>(dq);
  return hflash::flash_dq(D, true, q, k, v, dout, p, static_cast<cudaStream_t>(stream));
}

// dk, dv on `stream`: [B, T, Hkv, D] bf16 from the forward's inputs, lse,
// dout and the di that the dq kernel wrote; one block takes every query
// head of its kv head. `tile_counts` as for the forward.
extern "C" int unsloth_splash_attn_dkv(const void* q, const void* k, const void* v,
                                       const void* seg, const void* seg_min,
                                       const void* seg_max, const void* dout, const void* lse,
                                       const void* di, void* dk, void* dv, int P, int G, int L,
                                       int B, int T, int Hq, int Hkv, int D, float scale,
                                       int window, float softcap, bool causal, void* tile_counts,
                                       void* stream) {
  hflash::Params p = hflash::make_splash_params(seg, seg_min, seg_max, B, T, Hq, Hkv, scale,
                                                causal, tile_counts, window, softcap, P, G, L);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  return hflash::flash_dkv(D, true, q, k, v, dout, p, static_cast<cudaStream_t>(stream));
}
