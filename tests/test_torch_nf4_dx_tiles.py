"""The CPU twin of K2's Hopper walk against the JAX package.

K2 (``csrc/nf4_wgmma.cu``, ``nf4_dx_wgmma_kernel``) computes dx = g @
dequant(W) transposed: 64 packed byte columns a tile, their high nibbles
dx[:, j0..] and their low nibbles dx[:, K/2 + j0..], the reduction over
W's rows in stages of 64. ``nf4_matmul_dx_tiles_ref`` rebuilds dx from that
walk (tiles of the persistent schedule, zero bytes past K/2, the absmax of
each stage's rows, the low tile's two absmax blocks where K/2 % 64 == 32,
the high side's store clipped at K/2, rows past M zero-filled) and is held
to JAX's ``jax.vjp`` of ``nf4_matmul`` (``_bwd_pallas`` in interpret mode,
as the JAX tests run it) at K = 4,096 and to JAX's ``dequantize_nf4`` and a
matmul at gpt-oss's K = 2,880 (K/2 = 1,440: 22.5 byte tiles, the last one
crossing K/2), with M tails (300 and 200 rows against 256-row tiles).
Tolerance: the twin and JAX round the same bf16 weights and sum them in
fp32 in other orders, then round once to bf16, so each output is within
one bf16 ulp of JAX's (plus 2^-20 of the largest, for sums that cancel).
A walk without the clip at K/2, or with one absmax a 64-column tile on the
low side, disagrees far past that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from unsloth_tpu.ops import nf4 as jnf4
from unsloth_tpu.ops.qlora_matmul import nf4_matmul as jax_nf4_matmul
from unsloth_tpu_torch.interop import to_tensor
from unsloth_tpu_torch.ops import nf4 as tnf4
from unsloth_tpu_torch.ops.qlora_matmul import (DX_STAGE_ROWS, DX_TILE_BYTES,
                                                H100_SMS, nf4_dx_tile_schedule,
                                                nf4_matmul_dx_ref,
                                                nf4_matmul_dx_tiles_ref,
                                                tile_rows_x)


def _carried(n, k, m, seed):
    """W [n, k] quantized by the port (fp32 absmax: the bytes JAX makes,
    tests/test_torch_nf4.py), the same NF4 tensor in JAX, and g [m, n] in
    bf16 on both sides."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((n, k)) * 0.05
                          ).astype(np.float32))
    tq = tnf4.quantize_nf4(w, double_quant=False)
    jq = jnf4.NF4Tensor(jnp.asarray(tq.packed.numpy()),
                        jnp.asarray(tq.absmax.numpy()), None, None, (n, k),
                        tq.block_size, jnp.bfloat16)
    gj = jnp.asarray(rng.standard_normal((m, n)).astype(np.float32)
                     ).astype(jnp.bfloat16)
    return jq, tq, gj, to_tensor(np.asarray(gj), "cpu")


def _within_one_ulp(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16
    return bool(np.all(np.abs(got - want)
                       <= ulp + 2.0 ** -20 * np.abs(want).max()))


@jax.jit
def _jax_dequant_dx(jq, gj):
    """g @ dequantize_nf4(W): JAX's bf16 weights, fp32 sums, one bf16
    rounding."""
    w = jnf4.dequantize_nf4(jq, dtype=jnp.bfloat16)
    return jnp.matmul(gj.astype(jnp.float32), w.astype(jnp.float32)
                      ).astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def gpt_oss_q():
    """gpt-oss's q/k/v input width, K = 2,880 (K/2 = 1,440 = 22.5 byte
    tiles and 22.5 absmax blocks), N = 512 (its k/v: 8 stages) and 200
    rows of g (one 256-row tile, 56 rows short)."""
    return _carried(512, 2880, 200, seed=1)


def test_dx_walk_matches_jax_vjp_at_k4096():
    """K = 4,096 (32 byte tiles), N = 512, M = 300 (a 256-row tile and a
    tail): the twin against jax.vjp of JAX's nf4_matmul (its backward
    kernel in interpret mode) and against dequantize_nf4 + a matmul."""
    jq, tq, gj, gt = _carried(512, 4096, 300, seed=0)
    xj = jnp.zeros((300, 4096), jnp.bfloat16)
    _, vjp = jax.vjp(lambda x: jax_nf4_matmul(x, jq), xj)
    want = vjp(gj)[0]
    dx, visits = nf4_matmul_dx_tiles_ref(gt, tq)
    assert dx.shape == (300, 4096) and dx.dtype == torch.bfloat16
    assert visits.tolist() == [[1] * 32] * 2
    assert _within_one_ulp(dx, want)
    assert _within_one_ulp(dx, _jax_dequant_dx(jq, gj))


def test_dx_walk_matches_jax_dequant_at_gpt_oss_width(gpt_oss_q):
    jq, tq, gj, gt = gpt_oss_q
    dx, visits = nf4_matmul_dx_tiles_ref(gt, tq)
    assert bool((visits == 1).all()) and visits.shape == (1, 23)
    assert _within_one_ulp(dx, _jax_dequant_dx(jq, gj))


@pytest.mark.parametrize("n,k,m", [(2880, 2880, 70), (256, 1024, 129),
                                   (64, 64, 5)])
def test_dx_walk_matches_the_plain_version(n, k, m):
    """The twin against the port's plain version (dequantize, one matmul)
    where N is gpt-oss's o width (45 stages), at 129 rows (one 256-row
    tile, 127 rows short) and at K = 64 (one 32-byte tile: its columns
    32-63 past K/2)."""
    _, tq, gj, gt = _carried(n, k, m, seed=n + k)
    dx, visits = nf4_matmul_dx_tiles_ref(gt, tq)
    assert bool((visits == 1).all())
    assert _within_one_ulp(dx, jnp.asarray(
        nf4_matmul_dx_ref(gt, tq).float().numpy()))


def test_dx_walk_needs_its_clip_and_split_absmax(gpt_oss_q):
    """At K/2 % 64 == 32 the last byte tile crosses K/2: without the clip
    its zero bytes decode to -absmax and the high side's columns past K/2
    land on dx's real low-side columns 1,440..1,471; with one absmax a
    64-column tile on the low side, its columns 32-63 (the next block)
    read the block before theirs. Either walk disagrees far past one ulp,
    and only in those columns."""
    jq, tq, gj, gt = gpt_oss_q
    assert (2880 // 2) % DX_TILE_BYTES == 32
    want = _jax_dequant_dx(jq, gj)
    ref = np.asarray(want.astype(jnp.float32))
    for kw in (dict(clip=False), dict(split_low=False)):
        bad, _ = nf4_matmul_dx_tiles_ref(gt, tq, **kw)
        assert not _within_one_ulp(bad, want), kw
        d = np.abs(bad.float().numpy() - ref)
        assert d.max() > 0.1 * np.abs(ref).max(), kw
        wrong = np.nonzero(d.max(axis=0) > 2.0 ** -6 * np.abs(ref).max())[0]
        if kw == dict(clip=False):
            assert set(wrong) <= set(range(1440, 1472))
        else:   # the low tiles' columns 32-63: K/2 + 64 t + 32..
            assert all((c - 1440) % 64 >= 32 for c in wrong) and \
                min(wrong) >= 1440
    # at K = 4,096 (K/2 % 64 == 0) neither trap exists
    _, tq4, _, gt4 = _carried(256, 4096, 40, seed=5)
    good, _ = nf4_matmul_dx_tiles_ref(gt4, tq4)
    for kw in (dict(clip=False), dict(split_low=False)):
        assert torch.equal(nf4_matmul_dx_tiles_ref(gt4, tq4, **kw)[0], good)


@pytest.mark.parametrize("m,k,sms", [(8192, 4096, 132), (8192, 14336, 132),
                                     (300, 2880, 132), (17, 512, 132),
                                     (128, 4096, 132), (4096, 2880, 132),
                                     (129, 1024, 7), (4096, 2880, 1),
                                     (5, 64, 132)])
def test_dx_schedule_stores_each_tile_once(m, k, sms):
    """Every output tile of dx [m, k] (a g tile against a byte tile: its
    two 64-column sides) is stored by exactly one block of the persistent
    grid: clusters of two, at most one a unit and as many as the SMs hold;
    the two blocks of a cluster take the same g rows against neighbouring
    byte tiles, unit by unit, the units dealt to the clusters in turn
    (byte tile pairs fastest); the partner of an odd last tile stores
    nothing."""
    bx = tile_rows_x(m)
    tiles_j = -(-(k // 2) // DX_TILE_BYTES)
    sched = nf4_dx_tile_schedule(m, k, sms)
    tiles = [t for block in sched for t in block]
    want = {(i * bx, j * DX_TILE_BYTES) for i in range(-(-m // bx))
            for j in range(tiles_j)}
    assert len(tiles) == len(set(tiles)) == len(want) and set(tiles) == want
    pairs = -(-tiles_j // 2)
    units = -(-m // bx) * pairs
    clusters = min(units, max(1, sms // 2))
    assert len(sched) == 2 * clusters
    for c in range(clusters):
        lead, peer = sched[2 * c], sched[2 * c + 1]
        assert all((j0 // DX_TILE_BYTES) % 2 == 0 for _, j0 in lead)
        assert peer == [(m0, j0 + DX_TILE_BYTES) for m0, j0 in lead
                        if j0 // DX_TILE_BYTES + 1 < tiles_j]
        assert [(m0 // bx) * pairs + j0 // (2 * DX_TILE_BYTES)
                for m0, j0 in lead] == list(range(c, units, clusters))


def test_dx_tiles_follow_the_kernel():
    """The twin's constants are the kernel's: 64 packed bytes a tile (64
    output columns a side), 64 W rows a stage, 128-row g tiles up to 128
    rows and 256 above (K1's rule), an H100's 132 SMs."""
    assert (DX_TILE_BYTES, DX_STAGE_ROWS, H100_SMS) == (64, 64, 132)
    assert [tile_rows_x(m) for m in (1, 128, 129)] == [128, 128, 256]
    with pytest.raises(ValueError, match="multiple of 64"):
        nf4_matmul_dx_tiles_ref(torch.zeros((4, 96), dtype=torch.bfloat16),
                                tnf4.quantize_nf4(torch.randn(96, 128)))


def test_dx_faults_rejected_on_the_plain_version(gpt_oss_q):
    """Phase 3's injected K2 faults (``chip_smoke.nf4_dx_faults``: the
    low side's upper columns read with the block before theirs, and at
    K/2 % 64 == 32 the high side stored past K/2) miss its check, max|d|
    <= 1e-2 max|ref|, by far."""
    _, tq, _, gt = gpt_oss_q
    ref = nf4_matmul_dx_ref(gt, tq)
    tol = 1e-2 * ref.float().abs().max()
    faults = chip_smoke.nf4_dx_faults(gt, tq, ref)
    assert len(faults) == 2
    for name, bad in faults.items():
        assert (bad.float() - ref.float()).abs().max() > 5 * tol, name


def test_build_report_finds_the_k2_and_k12_kernels():
    """Phase 2 holds K2's Hopper kernel and K12's form of K1's kernel to 0
    spill and no serialized wgmma as it holds K1's; K1's own rows keep
    their name whether or not the kernel carries the format value."""
    entry = "_ZN4nf4w54_GLOBAL__N__5c1f0b2a_12_nf4_wgmma_cu_0e3f5a1c{}"
    names = {"19nf4_dx_wgmma_kernelILi256EEEv14CUtensorMap_stS2_S2_S2_S2_"
             "Piiii": "nf4_dx_wgmma_kernel<256, K2>",
             "16nf4_wgmma_kernelILi128ELb1EEEv14CUtensorMap_stS2_S2_PKfP13"
             "__nv_bfloat16Piiiii": "nf4_wgmma_kernel<128, K12>",
             "16nf4_wgmma_kernelILi256ELb0EEEv14CUtensorMap_stS2_S2_PKfP13"
             "__nv_bfloat16Piiiii": "nf4_wgmma_kernel<256, K1>"}
    lines = []
    for mangled in names:
        lines += [f"ptxas info    : Compiling entry function "
                  f"'{entry.format(mangled)}' for 'sm_90a'",
                  "    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                  "spill loads",
                  "ptxas info    : Used 168 registers, used 1 barriers"]
    lines.append("ptxas info    : (C7514) Potential Performance Loss: "
                 f"wgmma.mma_async instructions are serialized in the "
                 f"function '{entry.format(next(iter(names)))}'")
    rows, serialized = chip_smoke.attention_build_report("\n".join(lines))
    assert rows == [(n, 168, 0) for n in names.values()]
    assert len(serialized) == 1 and "C7514" in serialized[0]


def test_build_report_finds_the_k13_and_k14_kernels():
    """Phase 2 holds K13's form of K2's kernel (``nf4_dx_wgmma_kernel<BX,
    true>``) and K14's grouped form of K1's (``nf4_gmm_wgmma_kernel<BX>``)
    to 0 spill and no serialized wgmma as it holds K2's; K2's rows keep
    their name whether or not the kernel carries the format value."""
    entry = "_ZN4nf4w54_GLOBAL__N__5c1f0b2a_12_nf4_wgmma_cu_0e3f5a1c{}"
    names = {"19nf4_dx_wgmma_kernelILi256ELb1EEEv14CUtensorMap_stS2_S2_S2_"
             "S2_Piiii": "nf4_dx_wgmma_kernel<256, K13>",
             "19nf4_dx_wgmma_kernelILi128ELb0EEEv14CUtensorMap_stS2_S2_S2_"
             "S2_Piiii": "nf4_dx_wgmma_kernel<128, K2>",
             "20nf4_gmm_wgmma_kernelILi128EEEv14CUtensorMap_stS2_S2_PKfS4_"
             "PKiP13__nv_bfloat16Piiiiii": "nf4_gmm_wgmma_kernel<128, K14>"}
    lines = []
    for mangled in names:
        lines += [f"ptxas info    : Compiling entry function "
                  f"'{entry.format(mangled)}' for 'sm_90a'",
                  "    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                  "spill loads",
                  "ptxas info    : Used 168 registers, used 1 barriers"]
    k14 = entry.format(list(names)[2])
    lines.append("ptxas info    : (C7518) Potential Performance Loss: "
                 f"wgmma.mma_async instructions are serialized in the "
                 f"function '{k14}'")
    rows, serialized = chip_smoke.attention_build_report("\n".join(lines))
    assert rows == [(n, 168, 0) for n in names.values()]
    assert len(serialized) == 1 and "C7518" in serialized[0]

