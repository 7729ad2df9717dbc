// Flash attention forward for Hopper (K16 forward; with kSplash, K18's
// splash forward; with kSinks, K17's forward), causal or not, GQA, bf16,
// head dim 64, 128 or 256.
//
// Replaces the forward kernel of the bundled Pallas flash attention that
// unsloth_tpu/ops/attention.py:_tpu_flash calls (_flash_attention_kernel:
// out and an fp32 lse = m + log l), with causal=True and causal=False,
// (kSplash) the bundled splash forward kernel that _tpu_splash runs, and
// (kSinks) _tpu_flash_sinks' _flash_attention_impl with the wrapper's sink
// rescale folded into the epilogue. Semantics (flash_attention.cu,
// splash_attention.cu and flash_sinks.cu have the whole contracts): token i
// of a row attends to token j iff seg[i] == seg[j] and,
// causal, j <= i (K18: and i - j < window, or the prefix layout's rule);
// every output is defined; rows past T load as zeros and are never stored.
//
// What bounds it on an H100: tensor-core work, 4 D flops per valid (query,
// key) pair, over the visited tile pairs. Design (hopper_tiles.cuh has the
// building blocks):
//   - one block per (128 query rows, query head, row b): two consumer
//     warpgroups of 64 rows (224 registers a thread by setmaxnreg) and a
//     producer warpgroup (56) whose first warp loads;
//   - the producer loads the Q tile once by TMA, then walks the kv tiles
//     (128 keys at D = 64/128, 64 at D = 256) through a two-stage ring in
//     shared memory (TMA with the 128-byte swizzle; full and empty
//     mbarriers hand each stage over), and writes each stage's key segment
//     ids (sentinels past T) and its tile-pair class beside it; a skipped
//     pair is never loaded (produce_kv_ring, shared with dq);
//   - S = Q K^T by wgmma from shared memory into registers; the online
//     softmax runs there (a row's values sit in the four threads of a
//     quad: two shuffles give its max; the row sum stays per thread until
//     the end), with exp2 and the scale folded in as scale * log2(e);
//   - P is rounded to bf16 in registers and is the A operand of
//     O += P V (wgmma with V the MN-major B operand); O stays in registers
//     and is rescaled there; K18 adds a second product with P's rounding
//     remainder, P - bf16(P), as the A operand (a_frag_lo);
//   - the per-element mask runs only on a masked pair (pair_class): a
//     padded row's pairs are almost all full;
//   - causal: the query tiles with the most kv tiles are launched first;
//   - K17 (kSinks): the epilogue folds the head's sink logit s into the
//     normaliser in log2 units, s2 = s log2(e), m' = max(m, s2),
//     l' = l 2^(m - m') + 2^(s2 - m'), out = o 2^(m - m') / l' (rounded to
//     bf16 once), lse' = (m' + log2 l') ln 2; a row with l = 0 gets out = 0
//     and lse' = s;
//   - K18 (kSplash): each consumer warpgroup multiplies its 64 rows of Q by
//     `scale` in shared memory and rounds them to bf16 before its first
//     product; the softcap maps S to c tanh(S / c) in registers (in log2
//     units, softcap_log2) before the mask and the softmax; the window
//     starts the walk at the first kv tile it reaches, and the window's and
//     the prefix layout's element tests join the segment test on masked
//     pairs (pair_class<true> classes the pairs).
// Shared memory: Q 32 KB + 2 stages x (K + V) 128 KB at D = 128, 80 KB at
// D = 64, 192 KB at D = 256 (64-key stages).

#include "hopper_tiles.cuh"

namespace hflash {
namespace {

template <int D>
struct FwdCfg {
  static constexpr int kBq = 128;                  // query rows: two warpgroups of 64
  static constexpr int kBk = D == 256 ? 64 : 128;  // keys a stage
  static constexpr int kStages = 2;
  static constexpr int kSub = D / 64;
  static constexpr int kQSub = kBq * 128;          // bytes of a [rows][64] sub-tile
  static constexpr int kKSub = kBk * 128;
  static constexpr int kQBytes = kSub * kQSub;
  static constexpr int kKBytes = kSub * kKSub;
  // Q | K stages | V stages | key segment ids | stage info | barriers
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kStages * kKBytes;
  static constexpr int kOffSeg = kOffV + kStages * kKBytes;
  static constexpr int kOffInfo = kOffSeg + kStages * kBk * 4;
  static constexpr int kOffBar = kOffInfo + kStages * 8;
  static constexpr int kSmem = kOffBar + (1 + 2 * kStages) * 8 + 1024;
  static constexpr int kThreads = 384;  // 2 consumer warpgroups + the producer's
};

template <int D, bool kSplash, bool kSinks>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = FwdCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + C::kOffK;
  unsigned char* Vs = smem + C::kOffV;
  int* kseg = reinterpret_cast<int*>(smem + C::kOffSeg);
  int2* info = reinterpret_cast<int2*>(smem + C::kOffInfo);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + C::kStages;

  const int h = blockIdx.x % p.Hq, b = blockIdx.x / p.Hq;
  const int iq = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = iq * C::kBq;
  const int hk = h / (p.Hq / p.Hkv);
  const int nk = (p.T + C::kBk - 1) / C::kBk;
  const int last = p.causal ? min(nk - 1, (q0 + C::kBq - 1) / C::kBk) : nk - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // warpgroup 2 produces; the index is made warp-uniform (a shuffle from
  // lane 0) so that the compiler sees each branch taken by whole warpgroups
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 2) {
    regs_dec<56>();
    if (warp != 8) return;
    if (lane == 0) {
      mbar_expect_tx(qbar, C::kQBytes);
      for (int c = 0; c < C::kSub; ++c) tma_load(Qs + c * C::kQSub, &tq, qbar, c * 64, h, q0, b);
    }
    produce_kv_ring<C::kBq, C::kBk, C::kStages, C::kSub, kSplash>(
        p, b, q0, hk, last, lane, &tk, &tv, Ks, Vs, kseg, info, full, empty);
    return;
  }

  regs_inc<224>();
  // the consumer warpgroups: warpgroup wg owns query rows q0 + 64 wg ..
  const int wg = warp / 4;
  const int r0 = q0 + wg * 64 + 16 * (warp % 4) + lane / 4;
  const int qpos[2] = {r0, r0 + 8};
  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qseg[i] = qpos[i] < p.T ? p.seg[(size_t)b * p.T + qpos[i]] : kQueryPastEnd;
  // K18: a key kpos is out of row i's reach when kpos < klo (the window) or
  // kpfx <= kpos < kgap (past the prompt, before the row's region)
  int klo[2], kgap[2], kpfx = INT_MAX;
  if constexpr (kSplash) {
    if (p.G > 0) kpfx = p.P;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      klo[i] = p.window > 0 ? qpos[i] - p.window + 1 : INT_MIN;
      kgap[i] = p.G > 0 && qpos[i] >= p.P ? region_start(p, qpos[i]) : 0;
    }
  }
  float o[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  mbar_wait(qbar, 0);
  if constexpr (kSplash) {
    // q_scaled = bf16(q * scale): this warpgroup's 64 rows of each sub-tile
    for (int c = 0; c < C::kSub; ++c)
      scale_bf16(Qs + c * C::kQSub + wg * 8192, 8192, threadIdx.x % 128, 128, p.scale);
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
  }
  for (int it = 0;; ++it) {
    const int s = it % C::kStages;
    mbar_wait(&full[s], (it / C::kStages) & 1);
    const int2 inf = info[s];
    if (inf.x < 0) break;
    const int k0 = inf.x * C::kBk;
    const unsigned char* Kst = Ks + s * C::kKBytes;
    const unsigned char* Vst = Vs + s * C::kKBytes;

    float sc[C::kBk / 2];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      Wgmma<C::kBk>::ss(sc, kmajor_desc(Qs, C::kQSub, wg * 8192, k),
                        kmajor_desc(Kst, C::kKSub, 0, k), k > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    if constexpr (kSplash) {
      if (p.cap > 0.0f) {
#pragma unroll
        for (int x = 0; x < C::kBk / 2; ++x) {
          float r;
          sc[x] = softcap_log2(p, sc[x], r);
        }
      }
    }
    if (inf.y == kMasked) {
      const int* ks = kseg + s * C::kBk;
#pragma unroll
      for (int jj = 0; jj < C::kBk / 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * jj + 2 * (lane % 4) + c;
          const int sid = ks[col];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            bool out = sid != qseg[i] || (p.causal && k0 + col > qpos[i]);
            if constexpr (kSplash)
              out = out || k0 + col < klo[i] || (k0 + col >= kpfx && k0 + col < kgap[i]);
            if (out) sc[4 * jj + 2 * i + c] = -INFINITY;
          }
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < C::kBk / 8; ++jj)
        mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * i], sc[4 * jj + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx * p.scale_log2);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = fast_exp2(m[i] - m_use);
      m[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < C::kBk / 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e = fast_exp2(fmaf(sc[4 * jj + 2 * i + c], p.scale_log2, -m_use));
          sc[4 * jj + 2 * i + c] = e;
          sum += e;
        }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        o[4 * jj + 2 * i] *= alpha;
        o[4 * jj + 2 * i + 1] *= alpha;
      }
    }

    uint32_t pa[C::kBk / 16][4];
#pragma unroll
    for (int kk = 0; kk < C::kBk / 16; ++kk) a_frag(pa[kk], sc, kk);
    // K18: P's rounding remainder is a second A operand, so that P V is
    // taken with P to ~16 bits (the bundled splash forward's fp32 P)
    uint32_t pl[kSplash ? C::kBk / 16 : 1][4];
    if constexpr (kSplash) {
#pragma unroll
      for (int kk = 0; kk < C::kBk / 16; ++kk) a_frag_lo(pl[kk], sc, kk);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kBk / 16; ++kk)
      Wgmma<D>::rs(o, pa[kk], mnmajor_desc(Vst, C::kKSub, kk), 1);
    if constexpr (kSplash) {
#pragma unroll
      for (int kk = 0; kk < C::kBk / 16; ++kk)
        Wgmma<D>::rs(o, pl[kk], mnmajor_desc(Vst, C::kKSub, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (qpos[i] >= p.T) continue;
    float inv;
    [[maybe_unused]] float lse_sink;
    if constexpr (kSinks) {
      const float s2 = p.sinks[h] * kLog2e;
      const float ms = fmaxf(m[i], s2);
      const float a = exp2f(m[i] - ms);
      const float ls = fmaf(l[i], a, exp2f(s2 - ms));
      inv = a / ls;
      lse_sink = (ms + log2f(ls)) * kLn2;
    } else {
      inv = l[i] > 0.0f ? 1.0f / l[i] : 0.0f;
    }
    bf16* dst = p.o + ((size_t)(b * p.T + qpos[i]) * p.Hq + h) * D + 2 * (lane % 4);
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<uint32_t*>(dst + 8 * jj) =
          pack_bf16(o[4 * jj + 2 * i] * inv, o[4 * jj + 2 * i + 1] * inv);
    if (lane % 4 == 0) {
      if constexpr (kSinks)
        p.lse_out[((size_t)b * p.Hq + h) * p.T + qpos[i]] = lse_sink;
      else
        p.lse_out[((size_t)b * p.Hq + h) * p.T + qpos[i]] =
            l[i] > 0.0f ? (m[i] + log2f(l[i])) * kLn2 : kEmptyLse;
    }
  }
}

template <int D, bool kSplash, bool kSinks>
int launch(const void* q, const void* k, const void* v, const Params& p, cudaStream_t s) {
  using C = FwdCfg<D>;
  CUtensorMap tq, tk, tv;
  int e = bthd_map(&tq, q, p.B, p.T, p.Hq, D, C::kBq);
  if (e == 0) e = bthd_map(&tk, k, p.B, p.T, p.Hkv, D, C::kBk);
  if (e == 0) e = bthd_map(&tv, v, p.B, p.T, p.Hkv, D, C::kBk);
  if (e != 0) return e;
  e = static_cast<int>(cudaFuncSetAttribute(
      flash_fwd_kernel<D, kSplash, kSinks>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem));
  if (e != 0) return e;
  const dim3 grid(p.Hq * p.B, (p.T + C::kBq - 1) / C::kBq);
  flash_fwd_kernel<D, kSplash, kSinks><<<grid, C::kThreads, C::kSmem, s>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_form(FwdForm form, const void* q, const void* k, const void* v, const Params& p,
                cudaStream_t s) {
  if (form == FwdForm::kSplash) return launch<D, true, false>(q, k, v, p, s);
  if (form == FwdForm::kSinks) return launch<D, false, true>(q, k, v, p, s);
  return launch<D, false, false>(q, k, v, p, s);
}

}  // namespace

int flash_fwd(int D, FwdForm form, const void* q, const void* k, const void* v, Params p,
              cudaStream_t s) {
  if (D == 64) return launch_form<64>(form, q, k, v, p, s);
  if (D == 128) return launch_form<128>(form, q, k, v, p, s);
  if (D == 256) return launch_form<256>(form, q, k, v, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hflash
