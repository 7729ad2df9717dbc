"""The CPU twin of K15's Hopper walk against the JAX package.

K15 (the grouped NF4 expert backward, dx = g @ dequant(W_g) for the rows
of group g) runs ``csrc/nf4_wgmma.cu``'s ``nf4_gmm_dx_wgmma_kernel<BX>`` at
every row count: K2's kernel (dx^T = W_g^T g^T, 64 packed byte columns a
tile, their high nibbles dx[:, j0..] and their low nibbles dx[:, K/2 +
j0..], the reduction over W_g's rows in stages of 64) under K14's grouped
schedule (row tiles laid from each group's first row, units of (row tile,
pair of byte tiles) numbered group by group). ``nf4_gmm_dx_tiles_ref``
rebuilds dx from that walk (each side's absmax block of the tile's columns
0-31 and 32-63, nothing stored past K/2, each tile storing its group's rows
only, zeros outside every group) and is held to JAX's
``_nf4_gmm_bwd_impl(..., interpret=True)`` (its Pallas kernel in interpret
mode, as the JAX tests run it) at gpt-oss's K = 2,880 / B = 32 (K/2 = 1,440
= 22.5 byte tiles, the last crossing K/2) with an empty expert and a group
spanning several tiles, and at B = 64 with N = 136 (N % 64 != 0: the last
stage 8 rows), at both row tiles, and to ``nf4_gmm_ref(transpose=True)``
where the sizes sum to fewer rows than g has.

Tolerances: the twin and JAX round the same bf16 weights (code x absmax in
fp32, one rounding), sum them in fp32 in other orders and round once to
bf16: within one bf16 ulp of JAX's, plus 2^-20 of the largest for sums
that cancel. ``nf4_gmm_ref`` keeps the weights in fp32: row by row within
``chip_smoke.ATTN_ROW_TOL`` (``attn_row_err``, the limit phase 3 holds the
kernel to against it). A walk whose tiles store past their group's end, or
that reads a tile's columns 32-63 with the block of its column 0 at B =
32, disagrees far past that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import ATTN_ROW_TOL, attn_row_err
from unsloth_tpu.ops import nf4 as jnf4
from unsloth_tpu.ops import nf4_gmm as jgmm
from unsloth_tpu_torch.interop import params_from_numpy
from unsloth_tpu_torch.ops.nf4_gmm import (nf4_gmm_dx_tile_counts,
                                           nf4_gmm_dx_tile_schedule,
                                           nf4_gmm_dx_tiles_ref, nf4_gmm_ref)
from unsloth_tpu_torch.ops.qlora_matmul import (DX_STAGE_ROWS, DX_TILE_BYTES,
                                                tile_rows_x)


def _case(e, n, k, bs, sizes, seed, rows=None):
    """W [e, n, k] quantized by JAX (the port's NF4Stacked carries the same
    bytes: tests/test_torch_moe.py), g [rows, n] in bf16 on both sides, the
    group sizes."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((e, n, k)) * 0.1).astype(np.float32)
    jq = jnf4.quantize_nf4_stacked(jnp.asarray(w), block_size=bs,
                                   dtype=jnp.bfloat16)
    tq = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), "cpu")
    m = sum(sizes) if rows is None else rows
    gj = jnp.asarray(rng.standard_normal((m, n)).astype(np.float32)
                     ).astype(jnp.bfloat16)
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32))).to(
        torch.bfloat16)
    return jq, tq, gj, gt, np.asarray(sizes, np.int32)


def _jax_dx(jq, gj, sizes):
    return np.asarray(jgmm._nf4_gmm_bwd_impl(
        gj, jq, jnp.asarray(sizes), interpret=True).astype(jnp.float32))


def _within_one_ulp(got, want):
    got = got.float().numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16
    return bool(np.all(np.abs(got - want)
                       <= ulp + 2.0 ** -20 * np.abs(want).max()))


@pytest.fixture(scope="module")
def gpt_oss():
    """gpt-oss's expert width K = 2,880 at block 32, N = 320 (five stages),
    five experts: 150 rows, none, 400 (two 256-row tiles), 37 and 90; and
    JAX's dx."""
    jq, tq, gj, gt, sizes = _case(5, 320, 2880, 32, [150, 0, 400, 37, 90],
                                  seed=0)
    return tq, gt, sizes, _jax_dx(jq, gj, sizes)


def test_walk_matches_jax_kernel_at_gpt_oss_width(gpt_oss):
    tq, gt, sizes, want = gpt_oss
    dx, stores = nf4_gmm_dx_tiles_ref(gt, tq, torch.from_numpy(sizes))
    assert dx.shape == (677, 2880) and dx.dtype == torch.bfloat16
    assert stores.shape == (677, 23) and bool((stores == 1).all())
    assert _within_one_ulp(dx, want)


@pytest.mark.parametrize("sizes", [[70, 300, 0, 33], [20, 60, 0, 33]])
def test_walk_matches_jax_kernel_at_block_64(sizes):
    """Block 64 (K/2 = 256: four byte tiles, each side's two absmax rows
    one block), N = 136 (the last stage 8 rows: the kernel's rows past N are
    the next expert's bytes, with absmax and g zero there), at both row
    tiles the kernel builds: 403 rows (256-row tiles) and 113 (128-row
    tiles)."""
    jq, tq, gj, gt, sizes = _case(4, 136, 512, 64, sizes, seed=1)
    dx, stores = nf4_gmm_dx_tiles_ref(gt, tq, torch.from_numpy(sizes))
    assert bool((stores == 1).all())
    assert _within_one_ulp(dx, _jax_dx(jq, gj, sizes))


def test_rows_outside_every_group_are_zero():
    """Sizes summing to fewer rows than g has: the rows past the groups are
    zero (the kernel stores zeros there) and stored by no tile; every row
    matches the plain version row by row."""
    _, tq, _, gt, sizes = _case(3, 192, 256, 32, [40, 0, 100], seed=2,
                                rows=200)
    dx, stores = nf4_gmm_dx_tiles_ref(gt, tq, torch.from_numpy(sizes))
    assert bool((dx[140:] == 0).all()) and bool((stores[140:] == 0).all())
    assert bool((stores[:140] == 1).all())
    ref = nf4_gmm_ref(gt, tq, torch.from_numpy(sizes), transpose=True)
    assert torch.equal(ref[140:], dx[140:])
    assert attn_row_err(dx[:140], ref[:140]) <= ATTN_ROW_TOL


def test_walk_matches_plain_version_at_gpt_oss_width(gpt_oss):
    tq, gt, sizes, _ = gpt_oss
    dx, _ = nf4_gmm_dx_tiles_ref(gt, tq, torch.from_numpy(sizes))
    ref = nf4_gmm_ref(gt, tq, torch.from_numpy(sizes), transpose=True)
    assert attn_row_err(dx, ref) <= ATTN_ROW_TOL


@pytest.mark.parametrize("fault", ["past_end", "first_block"])
def test_faults_disagree(gpt_oss, fault):
    """A walk whose tiles also store their rows past the group's end (over
    the next group's rows, after those were stored) misses JAX in those
    rows only; one that reads a tile's columns 32-63 with the absmax block
    of its column 0 misses it in those columns. Both far past one ulp and
    past the row-wise limit against the plain version."""
    tq, gt, sizes, want = gpt_oss
    bad, stores = nf4_gmm_dx_tiles_ref(gt, tq, torch.from_numpy(sizes),
                                       **{fault: True})
    assert not _within_one_ulp(bad, want)
    d = np.abs(bad.float().numpy() - want)
    assert d.max() > 0.1 * np.abs(want).max()
    ref = nf4_gmm_ref(gt, tq, torch.from_numpy(sizes), transpose=True)
    assert attn_row_err(bad, ref) > ATTN_ROW_TOL
    big = d > 2.0 ** -6 * np.abs(want).max()
    if fault == "past_end":
        # the first group's 256-row tile runs 106 rows into the third
        # group's; the third's second tile (144 rows) runs into the
        # fourth's, and the fourth's (37 rows) into the fifth's up to m
        wrong = set(np.nonzero(big.any(axis=1))[0])
        assert wrong and wrong <= set(range(150, 256)) | set(range(550, 677))
        assert int(stores.max()) >= 2
    else:
        cols = np.nonzero(big.any(axis=0))[0]
        assert len(cols) and bool(((cols % 1440) % 64 >= 32).all())


@pytest.mark.parametrize("sizes,n,k,sms", [
    ([512] * 32, 2880, 2880, 132),        # the path's routing, evenly
    ([8192, 2730, 2731, 2731] + [0] * 28, 2880, 2880, 132),  # skewed
    ([0, 5, 0, 3], 2880, 2880, 132),      # 8 decode rows: 128-row tiles
    ([40, 0, 70, 9], 136, 512, 132),      # 119 rows, N % 64 != 0
    ([150, 0, 400, 37, 90], 320, 2880, 7),
    ([129] * 3, 128, 320, 1),
    ([0, 0, 0], 256, 256, 132)])          # no rows: no unit
def test_schedule_stores_each_row_once(sizes, n, k, sms):
    """Each row of each group is stored once for each byte tile by one
    block of the persistent grid, from its own group's tile only: tiles
    laid from the group's first row, the last ending at its end; a
    cluster's two blocks take the same rows against neighbouring byte
    tiles; the counters' twin counts those tiles, their stages and the
    short ones."""
    m = max(sum(sizes), 1)
    bx = tile_rows_x(m)
    sched = nf4_gmm_dx_tile_schedule(sizes, m, k, sms)
    tiles_j = -(-(k // 2) // DX_TILE_BYTES)
    stored = np.zeros((m, tiles_j), np.int64)
    ends = np.cumsum(sizes)
    for block in sched:
        for g, row0, hi, j0 in block:
            lo, end = ends[g] - sizes[g], ends[g]
            assert lo <= row0 < hi <= end and hi - row0 <= bx
            assert (row0 - lo) % bx == 0 and (hi == end or hi - row0 == bx)
            assert j0 < k // 2
            stored[row0:hi, j0 // DX_TILE_BYTES] += 1
    assert bool((stored[:sum(sizes)] == 1).all())
    for c in range(len(sched) // 2):
        lead, peer = sched[2 * c], sched[2 * c + 1]
        assert all((j0 // DX_TILE_BYTES) % 2 == 0 for *_, j0 in lead)
        assert peer == [(g, r0, hi, j0 + DX_TILE_BYTES)
                        for g, r0, hi, j0 in lead
                        if j0 // DX_TILE_BYTES + 1 < tiles_j]
    tiles = [t for block in sched for t in block]
    assert nf4_gmm_dx_tile_counts(sizes, m, n, k) == [
        len(tiles), len(tiles) * -(-n // DX_STAGE_ROWS),
        sum(hi - r0 < bx for _, r0, hi, _ in tiles)]


def test_build_report_finds_the_k15_kernel():
    """Phase 2 holds K15's grouped form of K2's kernel
    (``nf4_gmm_dx_wgmma_kernel<BX>``) to 0 spill and no serialized wgmma
    as it holds K14's, and tells it from K2's and K14's names."""
    entry = "_ZN4nf4w54_GLOBAL__N__5c1f0b2a_12_nf4_wgmma_cu_0e3f5a1c{}"
    names = {"23nf4_gmm_dx_wgmma_kernelILi256EEEv14CUtensorMap_stS2_S2_S2_"
             "S2_PKiP13__nv_bfloat16Piiiiii": "nf4_gmm_dx_wgmma_kernel<256, "
                                              "K15>",
             "23nf4_gmm_dx_wgmma_kernelILi128EEEv14CUtensorMap_stS2_S2_S2_"
             "S2_PKiP13__nv_bfloat16Piiiiii": "nf4_gmm_dx_wgmma_kernel<128, "
                                              "K15>",
             "20nf4_gmm_wgmma_kernelILi256EEEv14CUtensorMap_stS2_S2_PKfS4_"
             "PKiP13__nv_bfloat16Piiiiii": "nf4_gmm_wgmma_kernel<256, K14>"}
    lines = []
    for mangled in names:
        lines += [f"ptxas info    : Compiling entry function "
                  f"'{entry.format(mangled)}' for 'sm_90a'",
                  "    0 bytes stack frame, 8 bytes spill stores, 8 bytes "
                  "spill loads",
                  "ptxas info    : Used 168 registers, used 1 barriers"]
    k15 = entry.format(next(iter(names)))
    lines.append("ptxas info    : (C7510) Potential Performance Loss: "
                 f"wgmma.mma_async instructions are serialized in the "
                 f"function '{k15}'")
    rows, serialized = chip_smoke.attention_build_report("\n".join(lines))
    assert rows == [(n, 168, 8) for n in names.values()]
    assert len(serialized) == 1 and "C7510" in serialized[0]
