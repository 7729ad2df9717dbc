// Flash attention dk/dv for Hopper (K16 dk/dv; with kSplash, K18's splash
// dk/dv), causal or not, GQA, bf16, head dim 64, 128 or 256.
//
// Replaces the bundled Pallas kernel _flash_attention_bwd_dkv that
// unsloth_tpu/ops/attention.py:_tpu_flash reaches through its VJP (and,
// kSplash, the bundled splash dk/dv kernel behind _tpu_splash). Rounding
// points are the bundled kernel's: P = exp(s sm_scale - lse) in fp32 and
// rounded to bf16 before P^T dO; dS = P (dP - di) sm_scale rounded to bf16
// before dS^T Q; dk and dv summed in fp32 over the query heads of each kv
// head, then rounded once. K18: the producer warpgroup's three idle warps
// multiply each Q stage by `scale` and round it to bf16 in shared memory
// once it has landed, and signal it on a second mbarrier (`scaled`), so
// dK = dS^T q_scaled; the softcap's t is recomputed with P and
// dS = P (dP - di) (1 - t^2); the walk of a kv tile ends at the last query
// tile its window or its region reaches (q_end); one block takes all the
// query heads of its kv head (nsplit 1: the splash entry points take no
// scratch). At D = 256, where K16's two warpgroups split D and each forms
// the whole S^T and dP^T (1.5 times the products), K18's warpgroup wg
// forms them (m64n16) and P^T, dS^T with the softcap for the stage's
// queries 16 wg .. 16 wg + 15 only, hands its bf16 fragments to the other
// through shared memory (a named barrier), and adds both halves' products
// into its 128 columns of dK and dV, in the same order in both. K18's
// rings are deeper (four stages, eight at D = 64) to keep the loads and
// the rounding ahead of the consumers. At D = 128 K18's consumers take a
// stage's 64 queries in two halves of 32 (S^T, dP^T, the softcap, then
// their dV, dK products), which halves the score registers that the
// softcap's temporaries would otherwise push past 224.
//
// What bounds it on an H100: tensor-core work, 8 D flops per valid pair.
// Design: one block per (128 key rows, kv head, slice of the kv head's
// query heads, row b), two consumer warpgroups of 64 key rows and a
// producer warpgroup (one warp loads). K and V are loaded once by TMA and
// stay; Q and dO of each (query head, 64-query tile) come through a
// two-stage TMA ring, with the queries' segment ids, lse * log2(e) and di
// beside each stage. The key rows are wgmma's M: S^T = K Q^T and
// dP^T = V dO^T from shared memory into registers; P^T and dS^T are formed
// in registers and, packed to bf16, are the A operands of dV += P^T dO and
// dK += dS^T Q (dO and Q the MN-major B operands). At D = 256, 64 key rows
// of dK and dV would take 256 fp32 registers a thread, so the two
// warpgroups share one block's 64 key rows and split D: each forms the
// whole S^T and dP^T (over 32-query tiles) and keeps 128 columns of dK and
// dV, at 1.5 times the products. Under GQA the query heads of a kv head are split over
// `nsplit` blocks so the grid fills the card (Qwen2.5-0.5B's 14/2 heads at
// T = 2,048: 448 blocks rather than 64); each slice writes fp32 partials
// to a scratch and dkv_sum_kernel adds them in slice order. Every sum has
// a fixed order: the same bits on every run.

#include "hopper_tiles.cuh"

namespace hflash {
namespace {

template <int D, bool kSplash>
struct DkvCfg {
  static constexpr bool kSplitD = D == 256;     // the warpgroups split D
  static constexpr bool kSplitQ = kSplash && kSplitD;  // ... and K18's the stage's queries
  static constexpr int kBk = kSplitD ? 64 : 128;  // key rows of a block
  static constexpr int kBq = kSplitD ? 32 : 64;   // queries a stage
  static constexpr int kDw = kSplitD ? D / 2 : D;  // dK, dV columns a warpgroup
  // K18's stages carry the rounding hop: deeper rings hide the loads
  static constexpr int kStages = kSplash ? (D == 64 ? 8 : 4) : 2;
  static constexpr int kHalves = kSplash && D == 128 ? 2 : 1;  // parts of a stage's queries
  static constexpr int kNq = kBq / kHalves;                     // queries a part
  static constexpr int kSub = D / 64;
  static constexpr int kKSub = kBk * 128;
  static constexpr int kQSub = kBq * 128;
  static constexpr int kKBytes = kSub * kKSub;
  static constexpr int kQBytes = kSub * kQSub;
  // K | V | Q stages | dO stages | query segment ids, lse * log2(e), di |
  // stage info | barriers
  static constexpr int kOffV = kKBytes;
  static constexpr int kOffQ = kOffV + kKBytes;
  static constexpr int kOffDo = kOffQ + kStages * kQBytes;
  static constexpr int kOffSeg = kOffDo + kStages * kQBytes;
  static constexpr int kOffLse = kOffSeg + kStages * kBq * 4;
  static constexpr int kOffDi = kOffLse + kStages * kBq * 4;
  static constexpr int kOffInfo = kOffDi + kStages * kBq * 4;
  // kSplitQ: the P^T, dS^T fragments handed over, [2 uses][2 warpgroups]
  // [128 threads][8 words]
  static constexpr int kOffX = kOffInfo + kStages * 16;
  static constexpr int kOffBar = kOffX + (kSplitQ ? 2 * 2 * 128 * 8 * 4 : 0);
  // K18 adds a `scaled` barrier a stage
  static constexpr int kSmem = kOffBar + (1 + (kSplash ? 3 : 2) * kStages) * 8 + 1024;
  static constexpr int kThreads = 384;  // 2 consumer warpgroups + the producer's
};

// K18: the producer warpgroup's warps 9-11 (thread t of 96) multiply each
// Q stage by `scale` in fp32 and round it to bf16 once its TMA load has
// landed (full), then arrive on scaled[s] (three arrivals a phase); they
// stop at the walk's end.
template <class C>
__device__ __forceinline__ void scale_q_ring(unsigned char* Qs, const int4* info, uint64_t* full,
                                             uint64_t* scaled, float scale, int t, int lane) {
  for (int it = 0;; ++it) {
    const int s = it % C::kStages;
    mbar_wait(&full[s], (it / C::kStages) & 1);
    const bool end = info[s].x < 0;
    if (!end) {
      scale_bf16(Qs + s * C::kQBytes, C::kQBytes, t, 96, scale);
      fence_proxy_async();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&scaled[s]);
    if (end) return;
  }
}

// P^T and dS^T of N queries of a stage in registers (S^T in sc, dP^T in
// dp on entry), packed to bf16 as the A fragments of dV += P^T dO and
// dK += dS^T Q; the element test runs on a masked pair only.
template <int N, bool kSplash>
__device__ __forceinline__ void stage_probs(const Params& p, float (&sc)[N / 2],
                                            float (&dp)[N / 2], uint32_t (&pa)[N / 16][4],
                                            uint32_t (&da)[N / 16][4], bool masked,
                                            const int* qs, const float* ls, const float* ds,
                                            int qbase, const int (&kpos)[2],
                                            const int (&kseg)[2], const int (&qhi)[2],
                                            int lane) {
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 8 * jj + 2 * (lane % 4) + c;
      const float lse2 = ls[col], dic = ds[col];
      const int sid = masked ? qs[col] : 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int x = 4 * jj + 2 * i + c;
        bool valid = !masked || (sid == kseg[i] && (!p.causal || kpos[i] <= qbase + col));
        if constexpr (kSplash) {
          valid = valid && (!masked || qbase + col <= qhi[i]);
          // P from the capped score, dS = P (dP - di) (1 - t^2)
          float s2 = sc[x] * p.scale_log2, dt = 1.0f;
          if (p.cap > 0.0f) {
            float r;
            s2 = softcap_log2(p, sc[x], r);
            dt = 4.0f * r * (1.0f - r);
          }
          const float e = valid ? fast_exp2(s2 - lse2) : 0.0f;
          sc[x] = e;
          dp[x] = e * (dp[x] - dic) * dt;
        } else {
          const float e = valid ? fast_exp2(fmaf(sc[x], p.scale_log2, -lse2)) : 0.0f;
          sc[x] = e;
          dp[x] = e * (dp[x] - dic) * p.scale;
        }
      }
    }
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a_frag(pa[kk], sc, kk);
    a_frag(da[kk], dp, kk);
  }
}

template <int D, bool kSplash>
__global__ void __launch_bounds__(384, 1)
    flash_dkv_kernel(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo, const Params p) {
  using C = DkvCfg<D, kSplash>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + C::kOffV;
  unsigned char* Qs = smem + C::kOffQ;
  unsigned char* dOs = smem + C::kOffDo;
  int* qseg_s = reinterpret_cast<int*>(smem + C::kOffSeg);
  float* lse_s = reinterpret_cast<float*>(smem + C::kOffLse);
  float* di_s = reinterpret_cast<float*>(smem + C::kOffDi);
  int4* info = reinterpret_cast<int4*>(smem + C::kOffInfo);
  uint64_t* kbar = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  uint64_t* full = kbar + 1;
  uint64_t* empty = full + C::kStages;
  uint64_t* scaled = empty + C::kStages;  // K18 only

  const int hk = blockIdx.x % p.Hkv;
  const int sl = (blockIdx.x / p.Hkv) % p.nsplit;
  const int b = blockIdx.x / (p.Hkv * p.nsplit);
  const int group = p.Hq / p.Hkv, per = group / p.nsplit;
  const int h_first = hk * group + sl * per;
  const int k0 = blockIdx.y * C::kBk;
  const int first = p.causal ? k0 / C::kBq : 0;
  const int nq = q_end<kSplash>(p, k0, C::kBk, C::kBq, (p.T + C::kBq - 1) / C::kBq);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kbar, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
      if constexpr (kSplash) mbar_init(&scaled[s], 3);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // warpgroup 2 produces; the index is made warp-uniform (a shuffle from
  // lane 0) so that the compiler sees each branch taken by whole warpgroups
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 2) {
    regs_dec<56>();
    if (warp != 8) {
      if constexpr (kSplash) scale_q_ring<C>(Qs, info, full, scaled, p.scale, threadIdx.x - 288, lane);
      return;
    }
    if (lane == 0) {
      mbar_expect_tx(kbar, 2 * C::kKBytes);
      for (int c = 0; c < C::kSub; ++c) {
        tma_load(Ks + c * C::kKSub, &tk, kbar, c * 64, hk, k0, b);
        tma_load(Vs + c * C::kKSub, &tv, kbar, c * 64, hk, k0, b);
      }
    }
    int n_skip = 0, n_full = 0, n_masked = 0, it = 0;
    for (int gi = 0; gi < per; ++gi) {
      const int h = h_first + gi;
      for (int iq = first; iq < nq; ++iq) {
        const int cls = pair_class<kSplash>(p, b, iq * C::kBq, C::kBq, k0, C::kBk);
        n_skip += cls == kSkip;
        n_full += cls == kFull;
        n_masked += cls == kMasked;
        if (cls == kSkip) continue;
        const int s = it % C::kStages, use = it / C::kStages;
        if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
        const size_t row = ((size_t)b * p.Hq + h) * p.T;
        for (int i = lane; i < C::kBq; i += 32) {
          const int t = iq * C::kBq + i;
          const bool in = t < p.T;
          qseg_s[s * C::kBq + i] = in ? p.seg[(size_t)b * p.T + t] : kQueryPastEnd;
          lse_s[s * C::kBq + i] = in ? p.lse[row + t] * kLog2e : 0.0f;
          di_s[s * C::kBq + i] = in ? p.di[row + t] : 0.0f;
        }
        if (lane == 0) info[s] = make_int4(iq, h, cls, 0);
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * C::kQBytes);
          for (int c = 0; c < C::kSub; ++c) {
            tma_load(Qs + s * C::kQBytes + c * C::kQSub, &tq, &full[s], c * 64, h,
                     iq * C::kBq, b);
            tma_load(dOs + s * C::kQBytes + c * C::kQSub, &tdo, &full[s], c * 64, h,
                     iq * C::kBq, b);
          }
        }
        ++it;
      }
    }
    const int s = it % C::kStages, use = it / C::kStages;
    if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
    if (lane == 0) {
      info[s] = make_int4(-1, 0, 0, 0);
      mbar_arrive(&full[s]);
      if (p.counts != nullptr) {
        atomicAdd(p.counts + kSkip, n_skip);
        atomicAdd(p.counts + kFull, n_full);
        atomicAdd(p.counts + kMasked, n_masked);
      }
    }
    return;
  }

  regs_inc<224>();
  // the consumer warpgroups: warpgroup wg owns key rows k0 + 64 wg .. (at
  // D = 256 both own rows k0 .., wg the columns kDw wg ..)
  const int wg = warp / 4;
  const int wrow = C::kSplitD ? 0 : wg, col0 = C::kSplitD ? wg * C::kDw : 0;
  const int r0 = k0 + wrow * 64 + 16 * (warp % 4) + lane / 4;
  const int kpos[2] = {r0, r0 + 8};
  int kseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    kseg[i] = kpos[i] < p.T ? p.seg[(size_t)b * p.T + kpos[i]] : kKeyPastEnd;
  // K18: the last query key row i reaches (its window, or the end of its
  // region past the prompt)
  int qhi[2];
  if constexpr (kSplash) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qhi[i] = INT_MAX;
      if (p.window > 0) qhi[i] = kpos[i] + p.window - 1;
      if (p.G > 0 && kpos[i] >= p.P) qhi[i] = region_start(p, kpos[i]) + p.L - 1;
    }
  }
  float dk[C::kDw / 2], dv[C::kDw / 2];
#pragma unroll
  for (int x = 0; x < C::kDw / 2; ++x) {
    dk[x] = 0.0f;
    dv[x] = 0.0f;
  }

  mbar_wait(kbar, 0);
  if constexpr (C::kSplitQ) {
    // K18 at D = 256: warpgroup wg's 16 queries of each stage, handed over
    uint32_t* xbuf = reinterpret_cast<uint32_t*>(smem + C::kOffX) + (threadIdx.x % 128) * 8;
    for (int it = 0;; ++it) {
      const int s = it % C::kStages;
      mbar_wait(&full[s], (it / C::kStages) & 1);
      mbar_wait(&scaled[s], (it / C::kStages) & 1);
      const int4 inf = info[s];
      if (inf.x < 0) break;
      const unsigned char* Qst = Qs + s * C::kQBytes;
      const unsigned char* dOst = dOs + s * C::kQBytes;

      float sc[8], dp[8];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        Wgmma<16>::ss(sc, kmajor_desc(Ks, C::kKSub, 0, k),
                      kmajor_desc(Qst, C::kQSub, wg * 2048, k), k > 0);
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        Wgmma<16>::ss(dp, kmajor_desc(Vs, C::kKSub, 0, k),
                      kmajor_desc(dOst, C::kQSub, wg * 2048, k), k > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      uint32_t own[1][4], ownd[1][4];
      stage_probs<16, kSplash>(p, sc, dp, own, ownd, inf.z == kMasked,
                               qseg_s + s * C::kBq + 16 * wg, lse_s + s * C::kBq + 16 * wg,
                               di_s + s * C::kBq + 16 * wg, inf.x * C::kBq + 16 * wg, kpos,
                               kseg, qhi, lane);
      // hand over: this warpgroup's fragments to its slot of this use's
      // buffer, the other's from its slot (two buffers by use parity, so a
      // slot is rewritten only after both passed the next barrier)
      uint32_t* mine = xbuf + ((it & 1) * 2 + wg) * 1024;
      const uint32_t* theirs = xbuf + ((it & 1) * 2 + 1 - wg) * 1024;
      *reinterpret_cast<uint4*>(mine) = make_uint4(own[0][0], own[0][1], own[0][2], own[0][3]);
      *reinterpret_cast<uint4*>(mine + 4) =
          make_uint4(ownd[0][0], ownd[0][1], ownd[0][2], ownd[0][3]);
      named_bar_sync(1, 256);
      const uint4 op = *reinterpret_cast<const uint4*>(theirs);
      const uint4 od = *reinterpret_cast<const uint4*>(theirs + 4);
      const uint32_t other[4] = {op.x, op.y, op.z, op.w}, otherd[4] = {od.x, od.y, od.z, od.w};
      // k16 step 0 is warpgroup 0's queries, step 1 warpgroup 1's
      uint32_t pa[2][4], da[2][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[0][r] = wg == 0 ? own[0][r] : other[r];
        pa[1][r] = wg == 0 ? other[r] : own[0][r];
        da[0][r] = wg == 0 ? ownd[0][r] : otherd[r];
        da[1][r] = wg == 0 ? otherd[r] : ownd[0][r];
      }
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        Wgmma<C::kDw>::rs(dv, pa[kk], mnmajor_desc(dOst + (col0 / 64) * C::kQSub, C::kQSub, kk),
                          1);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        Wgmma<C::kDw>::rs(dk, da[kk], mnmajor_desc(Qst + (col0 / 64) * C::kQSub, C::kQSub, kk),
                          1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  } else {
    for (int it = 0;; ++it) {
      const int s = it % C::kStages;
      mbar_wait(&full[s], (it / C::kStages) & 1);
      if constexpr (kSplash) mbar_wait(&scaled[s], (it / C::kStages) & 1);
      const int4 inf = info[s];
      if (inf.x < 0) break;
      const int qbase = inf.x * C::kBq;
      const unsigned char* Qst = Qs + s * C::kQBytes;
      const unsigned char* dOst = dOs + s * C::kQBytes;

#pragma unroll
      for (int part = 0; part < C::kHalves; ++part) {
        constexpr int kNq = C::kNq;
        const int q_off = part * kNq;  // this part's first query of the stage
        float sc[kNq / 2], dp[kNq / 2];
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          Wgmma<kNq>::ss(sc, kmajor_desc(Ks, C::kKSub, wrow * 8192, k),
                         kmajor_desc(Qst, C::kQSub, q_off * 128, k), k > 0);
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          Wgmma<kNq>::ss(dp, kmajor_desc(Vs, C::kKSub, wrow * 8192, k),
                         kmajor_desc(dOst, C::kQSub, q_off * 128, k), k > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);

        uint32_t pa[kNq / 16][4], da[kNq / 16][4];
        stage_probs<kNq, kSplash>(p, sc, dp, pa, da, inf.z == kMasked,
                                  qseg_s + s * C::kBq + q_off, lse_s + s * C::kBq + q_off,
                                  di_s + s * C::kBq + q_off, qbase + q_off, kpos, kseg, qhi,
                                  lane);
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kNq / 16; ++kk)
          Wgmma<C::kDw>::rs(dv, pa[kk],
                            mnmajor_desc(dOst + (col0 / 64) * C::kQSub, C::kQSub,
                                         kk + q_off / 16),
                            1);
#pragma unroll
        for (int kk = 0; kk < kNq / 16; ++kk)
          Wgmma<C::kDw>::rs(dk, da[kk],
                            mnmajor_desc(Qst + (col0 / 64) * C::kQSub, C::kQSub,
                                         kk + q_off / 16),
                            1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dv);
        fence_regs(dk);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  const size_t n = (size_t)p.B * p.T * p.Hkv * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kpos[i] >= p.T) continue;
    const size_t off = ((size_t)(b * p.T + kpos[i]) * p.Hkv + hk) * D + col0 + 2 * (lane % 4);
    if (p.nsplit == 1) {
#pragma unroll
      for (int jj = 0; jj < C::kDw / 8; ++jj) {
        *reinterpret_cast<uint32_t*>(p.dk + off + 8 * jj) =
            pack_bf16(dk[4 * jj + 2 * i], dk[4 * jj + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(p.dv + off + 8 * jj) =
            pack_bf16(dv[4 * jj + 2 * i], dv[4 * jj + 2 * i + 1]);
      }
    } else {
      float* pk = p.part + (size_t)(2 * sl) * n + off;
      float* pv = pk + n;
#pragma unroll
      for (int jj = 0; jj < C::kDw / 8; ++jj) {
        *reinterpret_cast<float2*>(pk + 8 * jj) =
            make_float2(dk[4 * jj + 2 * i], dk[4 * jj + 2 * i + 1]);
        *reinterpret_cast<float2*>(pv + 8 * jj) =
            make_float2(dv[4 * jj + 2 * i], dv[4 * jj + 2 * i + 1]);
      }
    }
  }
}

// dk, dv = the slices' fp32 partials ([nsplit][2][n]) added in slice order,
// rounded to bf16; four elements a thread.
__global__ void dkv_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                               bf16* __restrict__ dv, size_t n, int nsplit) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    float4 acc = *reinterpret_cast<const float4*>(part + (size_t)t * n + i);
    for (int s = 1; s < nsplit; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(part + (size_t)(2 * s + t) * n + i);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    uint2 o;
    o.x = pack_bf16(acc.x, acc.y);
    o.y = pack_bf16(acc.z, acc.w);
    *reinterpret_cast<uint2*>((t == 0 ? dk : dv) + i) = o;
  }
}

template <int D, bool kSplash>
int launch(const void* q, const void* k, const void* v, const void* dout, const Params& p,
           cudaStream_t s) {
  using C = DkvCfg<D, kSplash>;
  CUtensorMap tk, tv, tq, tdo;
  int e = bthd_map(&tk, k, p.B, p.T, p.Hkv, D, C::kBk);
  if (e == 0) e = bthd_map(&tv, v, p.B, p.T, p.Hkv, D, C::kBk);
  if (e == 0) e = bthd_map(&tq, q, p.B, p.T, p.Hq, D, C::kBq);
  if (e == 0) e = bthd_map(&tdo, dout, p.B, p.T, p.Hq, D, C::kBq);
  if (e != 0) return e;
  if (p.nsplit < 1 || (p.Hq / p.Hkv) % p.nsplit != 0 || (p.nsplit > 1 && p.part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  e = static_cast<int>(cudaFuncSetAttribute(
      flash_dkv_kernel<D, kSplash>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem));
  if (e != 0) return e;
  const dim3 grid(p.Hkv * p.nsplit * p.B, (p.T + C::kBk - 1) / C::kBk);
  flash_dkv_kernel<D, kSplash><<<grid, C::kThreads, C::kSmem, s>>>(tk, tv, tq, tdo, p);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0 || p.nsplit == 1) return e;
  const size_t n = (size_t)p.B * p.T * p.Hkv * D;
  const unsigned blocks = static_cast<unsigned>((n / 4 + 255) / 256);
  dkv_sum_kernel<<<blocks, 256, 0, s>>>(p.part, p.dk, p.dv, n, p.nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int flash_dkv(int D, bool splash, const void* q, const void* k, const void* v,
              const void* dout, Params p, cudaStream_t s) {
  if (D == 64)
    return splash ? launch<64, true>(q, k, v, dout, p, s) : launch<64, false>(q, k, v, dout, p, s);
  if (D == 128)
    return splash ? launch<128, true>(q, k, v, dout, p, s)
                  : launch<128, false>(q, k, v, dout, p, s);
  if (D == 256)
    return splash ? launch<256, true>(q, k, v, dout, p, s)
                  : launch<256, false>(q, k, v, dout, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hflash
