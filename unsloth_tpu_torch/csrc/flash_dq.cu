// Flash attention dq for Hopper (K16 dq; with kSplash, K18's splash dq),
// causal or not, GQA, bf16, head dim 64, 128 or 256.
//
// Replaces the bundled Pallas kernel _flash_attention_bwd_dq that
// unsloth_tpu/ops/attention.py:_tpu_flash reaches through its VJP (and,
// kSplash, the bundled splash dq kernel behind _tpu_splash); also forms
// di = sum(dout * out), which the JAX wrapper computes outside the
// kernels, for the dk/dv kernel. Rounding points are the bundled kernel's:
// scores in fp32 times sm_scale (here folded into exp2 as
// sm_scale * log2(e)), P = exp(s - lse) in fp32, dS = P (dP - di) sm_scale
// rounded to bf16 before dS K. K18: the scores come from q_scaled =
// bf16(q * scale) (rounded in shared memory, as the forward does), the
// softcap's t = tanh(s / c) is recomputed with P, dS = P (dP - di)
// (1 - t^2) rounded to bf16, and the epilogue multiplies dQ by `scale`;
// the window and the prefix layout are the forward's tile rules and element
// tests.
//
// What bounds it on an H100: tensor-core work, 6 D flops per valid pair.
// Design: one block per (128 query rows, query head, row b), two consumer
// warpgroups of 64 rows and a producer warpgroup (one warp loads). Q and dO
// are loaded once by TMA; K and V come through a two-stage TMA ring of
// 64-key tiles (32 at D = 256, where Q and dO take 128 KB; full and empty
// mbarriers), with the keys' segment ids and the tile-pair class
// beside each stage (produce_kv_ring, as the forward's). S = Q K^T and dP = dO V^T are wgmma products from
// shared memory into registers; P and dS are formed in registers and dS,
// packed to bf16, is the A operand of dQ += dS K (K the MN-major B
// operand); dQ stays in registers until the epilogue. Each query row's dq
// is one block's fixed-order sum: the same bits on every run.

#include "hopper_tiles.cuh"

namespace hflash {
namespace {

template <int D>
struct DqCfg {
  static constexpr int kBq = 128;  // query rows: two warpgroups of 64
  static constexpr int kBk = D == 256 ? 32 : 64;  // keys a stage
  static constexpr int kStages = 2;
  static constexpr int kSub = D / 64;
  static constexpr int kQSub = kBq * 128;
  static constexpr int kKSub = kBk * 128;
  static constexpr int kQBytes = kSub * kQSub;
  static constexpr int kKBytes = kSub * kKSub;
  // Q | dO | K stages | V stages | key segment ids | stage info | barriers
  static constexpr int kOffDo = kQBytes;
  static constexpr int kOffK = kOffDo + kQBytes;
  static constexpr int kOffV = kOffK + kStages * kKBytes;
  static constexpr int kOffSeg = kOffV + kStages * kKBytes;
  static constexpr int kOffInfo = kOffSeg + kStages * kBk * 4;
  static constexpr int kOffBar = kOffInfo + kStages * 8;
  static constexpr int kSmem = kOffBar + (1 + 2 * kStages) * 8 + 1024;
  static constexpr int kThreads = 384;  // 2 consumer warpgroups + the producer's
};

template <int D, bool kSplash>
__global__ void __launch_bounds__(384, 1)
    flash_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = DqCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* dOs = smem + C::kOffDo;
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
      mbar_init(&empty[s], 8);
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
      mbar_expect_tx(qbar, 2 * C::kQBytes);
      for (int c = 0; c < C::kSub; ++c) {
        tma_load(Qs + c * C::kQSub, &tq, qbar, c * 64, h, q0, b);
        tma_load(dOs + c * C::kQSub, &tdo, qbar, c * 64, h, q0, b);
      }
    }
    produce_kv_ring<C::kBq, C::kBk, C::kStages, C::kSub, kSplash>(
        p, b, q0, hk, last, lane, &tk, &tv, Ks, Vs, kseg, info, full, empty);
    return;
  }

  regs_inc<224>();
  const int wg = warp / 4;
  const int r0 = q0 + wg * 64 + 16 * (warp % 4) + lane / 4;
  const int qpos[2] = {r0, r0 + 8};
  int qseg[2];
  float lse2[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = qpos[i] < p.T;
    const size_t row = ((size_t)b * p.Hq + h) * p.T + qpos[i];
    qseg[i] = in ? p.seg[(size_t)b * p.T + qpos[i]] : kQueryPastEnd;
    lse2[i] = in ? p.lse[row] * kLog2e : 0.0f;
    // di = sum_d dout * out in fp32: the four threads of a quad split D
    float acc = 0.0f;
    if (in) {
      const size_t off = ((size_t)(b * p.T + qpos[i]) * p.Hq + h) * D;
      for (int c = (lane % 4) * 8; c < D; c += 32) {
        const uint4 ov = *reinterpret_cast<const uint4*>(p.out + off + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(p.dout + off + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fo = __bfloat1622float2(o2[e]), fd = __bfloat1622float2(d2[e]);
          acc = fmaf(fd.x, fo.x, acc);
          acc = fmaf(fd.y, fo.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    di[i] = acc;
    if (in && lane % 4 == 0) p.di_out[row] = acc;
  }
  // K18: the forward's reach of each row (flash_fwd.cu)
  int klo[2], kgap[2], kpfx = INT_MAX;
  if constexpr (kSplash) {
    if (p.G > 0) kpfx = p.P;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      klo[i] = p.window > 0 ? qpos[i] - p.window + 1 : INT_MIN;
      kgap[i] = p.G > 0 && qpos[i] >= p.P ? region_start(p, qpos[i]) : 0;
    }
  }
  float dq[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dq[x] = 0.0f;

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

    float sc[C::kBk / 2], dp[C::kBk / 2];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      Wgmma<C::kBk>::ss(sc, kmajor_desc(Qs, C::kQSub, wg * 8192, k),
                        kmajor_desc(Kst, C::kKSub, 0, k), k > 0);
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      Wgmma<C::kBk>::ss(dp, kmajor_desc(dOs, C::kQSub, wg * 8192, k),
                        kmajor_desc(Vst, C::kKSub, 0, k), k > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const bool masked = inf.y == kMasked;
    const int* ks = kseg + s * C::kBk;
#pragma unroll
    for (int jj = 0; jj < C::kBk / 8; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * jj + 2 * (lane % 4) + c;
        const int sid = masked ? ks[col] : 0;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * jj + 2 * i + c;
          bool valid = !masked || (sid == qseg[i] && (!p.causal || k0 + col <= qpos[i]));
          if constexpr (kSplash) {
            valid = valid && (!masked || (k0 + col >= klo[i] &&
                                          (k0 + col < kpfx || k0 + col >= kgap[i])));
            // P from the capped score, dS = P (dP - di) (1 - t^2)
            float s2 = sc[x] * p.scale_log2, dt = 1.0f;
            if (p.cap > 0.0f) {
              float r;
              s2 = softcap_log2(p, sc[x], r);
              dt = 4.0f * r * (1.0f - r);
            }
            const float e = valid ? fast_exp2(s2 - lse2[i]) : 0.0f;
            sc[x] = e * (dp[x] - di[i]) * dt;
          } else {
            const float e = valid ? fast_exp2(fmaf(sc[x], p.scale_log2, -lse2[i])) : 0.0f;
            sc[x] = e * (dp[x] - di[i]) * p.scale;
          }
        }
      }

    uint32_t da[C::kBk / 16][4];
#pragma unroll
    for (int kk = 0; kk < C::kBk / 16; ++kk) a_frag(da[kk], sc, kk);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kBk / 16; ++kk)
      Wgmma<D>::rs(dq, da[kk], mnmajor_desc(Kst, C::kKSub, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= p.T) continue;
    bf16* dst = p.dq + ((size_t)(b * p.T + qpos[i]) * p.Hq + h) * D + 2 * (lane % 4);
    // K18's dq = scale (dS K); K16's dS carries sm_scale already
    const float f = kSplash ? p.scale : 1.0f;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<uint32_t*>(dst + 8 * jj) =
          pack_bf16(dq[4 * jj + 2 * i] * f, dq[4 * jj + 2 * i + 1] * f);
  }
}

template <int D, bool kSplash>
int launch(const void* q, const void* k, const void* v, const void* dout, const Params& p,
           cudaStream_t s) {
  using C = DqCfg<D>;
  CUtensorMap tq, tdo, tk, tv;
  int e = bthd_map(&tq, q, p.B, p.T, p.Hq, D, C::kBq);
  if (e == 0) e = bthd_map(&tdo, dout, p.B, p.T, p.Hq, D, C::kBq);
  if (e == 0) e = bthd_map(&tk, k, p.B, p.T, p.Hkv, D, C::kBk);
  if (e == 0) e = bthd_map(&tv, v, p.B, p.T, p.Hkv, D, C::kBk);
  if (e != 0) return e;
  e = static_cast<int>(cudaFuncSetAttribute(
      flash_dq_kernel<D, kSplash>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem));
  if (e != 0) return e;
  const dim3 grid(p.Hq * p.B, (p.T + C::kBq - 1) / C::kBq);
  flash_dq_kernel<D, kSplash><<<grid, C::kThreads, C::kSmem, s>>>(tq, tdo, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int flash_dq(int D, bool splash, const void* q, const void* k, const void* v, const void* dout,
             Params p, cudaStream_t s) {
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
