"""K16's tile-pair classes and the check that must see their faults, on the
CPU.

``chip_smoke.flash_tile_classes`` is the Python twin of ``pair_class`` in
unsloth_tpu_torch/csrc/hopper_tiles.cuh: the flash attention kernels skip
a (query tile, kv tile) pair whose segment-id ranges are disjoint, run a
"full" pair without the per-element mask and test every element of a
"masked" one. Here the twin is held against the dense mask
(``ops.flash_attention._mask``) at each kernel's tiles
(``KERNEL_TILES``): a skipped pair holds no valid (query, key) pair, a full
pair holds only valid pairs before T, and every valid pair lies in a
visited pair that is not skipped. Then ``chip_smoke.attn_row_err`` must
reject the plain versions under a class rule that calls a pair full when
it is not (``chip_smoke.tile_fault_errs``).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from unsloth_tpu_torch.ops import flash_attention as tfa

#: (query tile, kv tile) of the forward (head dims 64/128 and 256), dq and
#: dk/dv kernels
TILES = sorted({tiles for by_d in tfa.KERNEL_TILES.values()
                for tiles in by_d.values()})


def _layout(kind, t, seed=0):
    """[2, t] int32 segment ids of one kind of row pair."""
    rng = np.random.default_rng(seed)
    seg = np.ones((2, t), dtype=np.int32)
    if kind == "contiguous":        # packed documents, then a pad tail
        cuts = np.sort(rng.choice(np.arange(1, t), size=4, replace=False))
        for r in range(2):
            for i, c in enumerate(cuts):
                seg[r, c:] = i + 2
        seg[1, cuts[-1]:] = 0
    elif kind == "interleaved":     # one id recurs after another
        seg[0, ::3] = 2
        seg[1] = (np.arange(t) // 50) % 3
    elif kind == "padded":          # pad_batch: 1 real, 0 pad
        seg[0, int(t * 0.7):] = 0
    return torch.from_numpy(seg)


def _check_classes(seg, causal, bq, bk):
    b, t = seg.shape
    mask = tfa._mask(seg, b, t, "cpu", causal=causal).numpy()
    classes = chip_smoke.flash_tile_classes(seg, causal, bq, bk)
    covered = np.zeros_like(mask)
    for (row, iq, j), cls in classes.items():
        qs = slice(iq * bq, min(t, (iq + 1) * bq))
        ks = slice(j * bk, min(t, (j + 1) * bk))
        block = mask[row, qs, ks]
        if cls == "skip":
            assert not block.any(), (row, iq, j)
        else:
            covered[row, qs, ks] = True
        if cls == "full":
            assert (iq + 1) * bq <= t and (j + 1) * bk <= t, (row, iq, j)
            assert block.all(), (row, iq, j)
    missed = np.argwhere(mask & ~covered)
    assert not len(missed), missed[:5]
    return classes


@pytest.mark.parametrize("bq,bk", TILES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind,t", [("contiguous", 512), ("interleaved", 384),
                                    ("padded", 640), ("padded", 200),
                                    ("contiguous", 333), ("one", 384)])
def test_tile_classes_hold_the_mask(kind, t, causal, bq, bk):
    """Contiguous, interleaved (non-contiguous), padded and ragged-T
    layouts, causal and not, at each kernel's tiles."""
    classes = _check_classes(_layout(kind, t), causal, bq, bk)
    n = [list(classes.values()).count(c) for c in chip_smoke.TILE_CLASSES]
    assert chip_smoke.flash_tile_counts(_layout(kind, t), causal, bq, bk) \
        == n
    if kind == "one" and t % max(bq, bk) == 0:
        # one segment, no ragged tile: only the diagonal needs the mask
        assert n[0] == 0 and (n[2] == 0) == (not causal)


def test_tile_classes_padded_row_is_mostly_full():
    """The notebook batch's row of 1,500 real tokens and a pad tail: at the
    forward's tiles almost every visited pair needs no mask."""
    seg = torch.ones((1, 2048), dtype=torch.int32)
    seg[0, 1500:] = 0
    skip, full, masked = chip_smoke.flash_tile_counts(seg, False, 128, 128)
    # tile 11 (tokens 1,408-1,535) holds both ids: its 31 pairs are masked
    assert (skip, full, masked) == (88, 137, 31)
    assert full > 2 * masked


@settings(max_examples=60, deadline=None)
@given(t=st.integers(1, 400), causal=st.booleans(),
       tiles=st.sampled_from(TILES), n_ids=st.integers(1, 4),
       run=st.integers(1, 90), seed=st.integers(0, 2 ** 31 - 1))
def test_tile_classes_property(t, causal, tiles, n_ids, run, seed):
    """Random layouts: runs of random ids (an id may come back later, so
    segments need not be contiguous) over a random T."""
    rng = np.random.default_rng(seed)
    seg = np.repeat(rng.integers(0, n_ids, size=(2, -(-t // run))), run,
                    axis=1)[:, :t].astype(np.int32)
    _check_classes(torch.from_numpy(seg), causal, *tiles)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_check_rejects_tile_faults(causal):
    """The plain versions under a diagonal pair called full (causal) and a
    mixed-segment pair called full fail the row-wise check in each of out,
    dq, dk and dv; the reference rounded to bf16 passes it."""
    rng = np.random.default_rng(7)
    b, t, hq, hkv, d = 2, 512, 4, 2, 64
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(
        (b, t, h, d)).astype(np.float32)) for h in (hq, hkv, hkv, hq))
    seg = torch.ones((b, t), dtype=torch.int32)
    seg[0, 300:] = 0
    scale = d ** -0.5
    out, lse = tfa.flash_attention_fwd_ref(q, k, v, seg, scale, causal)
    want = (out,) + tfa.flash_attention_bwd_ref(q, k, v, seg, out, lse, dout,
                                                scale, causal)
    for x in want:
        assert chip_smoke.attn_row_err(x.to(torch.bfloat16), x) <= \
            chip_smoke.ATTN_ROW_TOL
    res = chip_smoke.tile_fault_errs(q, k, v, seg, dout, scale, want, causal)
    expect = {"mixed-segment tile as full"} | (
        {"diagonal tile as full"} if causal else set())
    assert set(res) == expect
    for fault, errs in res.items():
        assert set(errs) == {"out", "dq", "dk", "dv"}
        for name, (err, _) in errs.items():
            assert err > chip_smoke.ATTN_ROW_TOL, (fault, name, err)
