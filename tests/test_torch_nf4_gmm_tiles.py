"""The CPU twin of K14's Hopper walk against the JAX package.

K14 (the grouped NF4 expert forward, y = x @ dequant(W_g)^T + bias[g] for
the rows of group g) above 16 rows runs ``csrc/nf4_wgmma.cu``'s
``nf4_gmm_wgmma_kernel<BX>``: K1's kernel under a grouped persistent
schedule, row tiles laid from each group's first row, units of (row tile,
pair of W_g's 128-row tiles) numbered group by group. ``nf4_gmm_tiles_ref``
rebuilds y from that walk (32-byte stages, each side's absmax block at B =
32 and 64, the fp32 bias added before the one rounding, each tile storing
its group's rows only, zeros outside every group) and is held to JAX's
``_nf4_gmm_fwd_impl(..., interpret=True)`` (its Pallas kernel in interpret
mode, as the JAX tests run it), with and without bias, at gpt-oss's K =
2,880 / B = 32 (K/2 = 1,440 = 45 stages) with an empty expert and a group
spanning several tiles, and at B = 64. Tolerance: the twin and JAX round
the same bf16 weights (code x absmax in fp32, one rounding), sum them in
fp32 in other orders, add the same fp32 bias and round once to bf16: within
one bf16 ulp of JAX's, plus 2^-20 of the largest for sums that cancel. A
walk whose tiles store past their group's end, or that reads the low side
with the high side's absmax, disagrees far past that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsloth_tpu.ops import nf4 as jnf4
from unsloth_tpu.ops import nf4_gmm as jgmm
from unsloth_tpu_torch.interop import params_from_numpy
from unsloth_tpu_torch.ops.nf4_gmm import (MAX_EXPERTS, nf4_gmm_ref,
                                           nf4_gmm_tile_counts,
                                           nf4_gmm_tile_schedule,
                                           nf4_gmm_tiles_ref)
from unsloth_tpu_torch.ops.qlora_matmul import (H100_SMS, STAGE_BYTES,
                                                TILE_W, tile_rows_x)


def _case(e, n, k, bs, sizes, seed, rows=None):
    """W [e, n, k] quantized by JAX (the port's NF4Stacked carries the same
    bytes: tests/test_torch_moe.py), x [rows, k] in bf16 on both sides,
    bias [e, n] fp32, the group sizes."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((e, n, k)) * 0.1).astype(np.float32)
    jq = jnf4.quantize_nf4_stacked(jnp.asarray(w), block_size=bs,
                                   dtype=jnp.bfloat16)
    tq = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), "cpu")
    m = sum(sizes) if rows is None else rows
    xj = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32)
                     ).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    bias = rng.standard_normal((e, n)).astype(np.float32)
    return jq, tq, xj, xt, bias, np.asarray(sizes, np.int32)


def _within_one_ulp(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16
    return bool(np.all(np.abs(got - want)
                       <= ulp + 2.0 ** -20 * np.abs(want).max()))


@pytest.fixture(scope="module")
def gpt_oss():
    """gpt-oss's expert width K = 2,880 at block 32, N = 320 (three W
    tiles: the second pair's partner past N, the third tile 64 rows short),
    five experts: 150 rows, none, 400 (two 256-row tiles), 37 and 90."""
    return _case(5, 320, 2880, 32, [150, 0, 400, 37, 90], seed=0)


@pytest.mark.parametrize("with_bias", [False, True])
def test_walk_matches_jax_kernel_at_gpt_oss_width(gpt_oss, with_bias):
    jq, tq, xj, xt, bias, sizes = gpt_oss
    want = jgmm._nf4_gmm_fwd_impl(
        xj, jq, jnp.asarray(sizes),
        bias=jnp.asarray(bias) if with_bias else None, interpret=True)
    y, stores = nf4_gmm_tiles_ref(
        xt, tq, torch.from_numpy(sizes),
        torch.from_numpy(bias) if with_bias else None)
    assert y.shape == (677, 320) and y.dtype == torch.bfloat16
    assert bool((stores == 1).all())
    assert _within_one_ulp(y, want)


@pytest.mark.parametrize("sizes", [[70, 300, 0, 33], [20, 60, 0, 33]])
def test_walk_matches_jax_kernel_at_block_64(sizes):
    """Block 64 (K/2 = 256: two 32-byte stages a block on either side),
    N = 136 (the second W tile 8 rows), at both row tiles the kernel
    builds: 403 rows (256-row tiles) and 113 (128-row tiles)."""
    jq, tq, xj, xt, bias, sizes = _case(4, 136, 512, 64, sizes, seed=1)
    want = jgmm._nf4_gmm_fwd_impl(xj, jq, jnp.asarray(sizes),
                                  bias=jnp.asarray(bias), interpret=True)
    y, stores = nf4_gmm_tiles_ref(xt, tq, torch.from_numpy(sizes),
                                  torch.from_numpy(bias))
    assert bool((stores == 1).all())
    assert _within_one_ulp(y, want)


def test_rows_outside_every_group_are_zero():
    """Sizes summing to fewer rows than x has: the rows past the groups
    are zero (the kernel stores zeros there) and stored by no tile; the
    rest matches the plain version to one ulp of its own rounding."""
    _, tq, _, xt, bias, sizes = _case(3, 128, 256, 32, [40, 0, 100], seed=2,
                                      rows=200)
    y, stores = nf4_gmm_tiles_ref(xt, tq, torch.from_numpy(sizes),
                                  torch.from_numpy(bias))
    assert bool((y[140:] == 0).all()) and bool((stores[140:] == 0).all())
    assert bool((stores[:140] == 1).all())
    ref = nf4_gmm_ref(xt, tq, torch.from_numpy(sizes), torch.from_numpy(bias))
    assert torch.equal(ref[140:], y[140:])


@pytest.mark.parametrize("fault", ["past_end", "low_with_high"])
def test_faults_disagree(gpt_oss, fault):
    """A walk whose tiles also store their rows past the group's end (over
    the next group's rows, after those were stored) misses JAX in those
    rows only; one that reads the low side with the high side's absmax
    block misses it everywhere. Both far past one ulp."""
    jq, tq, xj, xt, bias, sizes = gpt_oss
    want = np.asarray(jgmm._nf4_gmm_fwd_impl(
        xj, jq, jnp.asarray(sizes), bias=jnp.asarray(bias),
        interpret=True).astype(jnp.float32))
    bad, stores = nf4_gmm_tiles_ref(xt, tq, torch.from_numpy(sizes),
                                    torch.from_numpy(bias),
                                    **{fault: True})
    assert not _within_one_ulp(bad, want)
    d = np.abs(bad.float().numpy() - want)
    assert d.max() > 0.1 * np.abs(want).max()
    if fault == "past_end":
        # the first group's 256-row tile runs 106 rows into the third
        # group's; the third's second tile (144 rows) runs into the
        # fourth's, and the fourth's (37 rows) into the fifth's up to m
        wrong = set(np.nonzero(d.max(axis=1) > 2.0 ** -6 * np.abs(want).max()
                               )[0])
        assert wrong and wrong <= set(range(150, 256)) | set(range(550, 677))
        assert int(stores.max()) >= 2


@pytest.mark.parametrize("sizes,n,sms", [
    ([512] * 32, 2880, 132),              # the path's routing, evenly
    ([8192, 2730, 2731, 2731] + [0] * 28, 2880, 132),  # skewed
    ([0, 17, 0, 0], 320, 132),            # 17 rows: one 128-row tile
    ([40, 0, 70, 9], 320, 132),           # 119 rows: 128-row tiles
    ([150, 0, 400, 37, 90], 320, 7),
    ([129] * 3, 128, 1),
    ([0, 0, 0], 256, 132)])               # no rows: no unit
def test_schedule_stores_each_row_once(sizes, n, sms):
    """Each row of each group is stored once for each W tile by one block
    of the persistent grid, from its own group's tile only: tiles laid from
    the group's first row, the last ending at its end; a cluster's two
    blocks take the same rows against neighbouring W tiles; the counters'
    twin counts those tiles, their stages and the short ones."""
    m = max(sum(sizes), 1)
    bx = tile_rows_x(m)
    sched = nf4_gmm_tile_schedule(sizes, m, n, sms)
    tiles_n = -(-n // TILE_W)
    stored = np.zeros((m, tiles_n), np.int64)
    ends = np.cumsum(sizes)
    for block in sched:
        for g, row0, hi, n0 in block:
            lo, end = ends[g] - sizes[g], ends[g]
            assert lo <= row0 < hi <= end and hi - row0 <= bx
            assert (row0 - lo) % bx == 0 and (hi == end or hi - row0 == bx)
            stored[row0:hi, n0 // TILE_W] += 1
    assert bool((stored[:sum(sizes)] == 1).all())
    for c in range(len(sched) // 2):
        lead, peer = sched[2 * c], sched[2 * c + 1]
        assert all((n0 // TILE_W) % 2 == 0 for *_, n0 in lead)
        assert peer == [(g, r0, hi, n0 + TILE_W) for g, r0, hi, n0 in lead
                        if n0 // TILE_W + 1 < tiles_n]
    tiles = [t for block in sched for t in block]
    assert nf4_gmm_tile_counts(sizes, m, n, 2880) == [
        len(tiles), len(tiles) * 1440 // STAGE_BYTES,
        sum(hi - r0 < bx for _, r0, hi, _ in tiles)]


def test_path_routing_takes_fewer_rows_than_visits():
    """At the path's shape (16,384 rows over 32 groups of about 512), the
    row tiles laid from each group's first row multiply fewer rows than a
    global grid of tiles visited once per group it touches."""
    rng = np.random.default_rng(3)
    sizes = np.bincount(np.stack([rng.permutation(32)[:4]
                                  for _ in range(4096)]).ravel(),
                        minlength=32)
    m = int(sizes.sum())
    ends = np.cumsum(sizes)
    for bx in (128, 256):
        laid = sum(-(-int(s) // bx) for s in sizes) * bx
        visits = sum((int(e) - 1) // bx - (int(e) - int(s)) // bx + 1
                     for s, e in zip(sizes, ends) if s) * bx
        assert laid < visits and laid < 1.3 * m
    assert MAX_EXPERTS == 1024 and H100_SMS == 132
