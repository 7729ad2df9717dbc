"""K18's tile-pair classes and the check that must see their faults, on the
CPU.

K18 runs on K16's Hopper kernels, whose ``pair_class<true>``
(unsloth_tpu_torch/csrc/hopper_tiles.cuh) adds the sliding window and
GRPO's prefix layout to the segment rule, and whose walks start at the
first kv tile a window reaches (forward, dq) or end at the last query tile
a kv tile's window or region reaches (dk/dv). ``chip_smoke.
flash_tile_classes`` with a ``window`` or a ``prefix_layout`` is their
Python twin. Here it is held against the dense mask (``ops.
splash_attention._splash_mask``) at each kernel's tiles (``KERNEL_TILES``):
a skipped pair holds no valid (query, key) pair, a full pair holds only
valid pairs before T, and every valid pair lies in a visited pair that is
not skipped. Then ``chip_smoke.attn_row_err`` must reject the plain
versions under a class rule that calls a pair past the window, or a pair
across two completion regions, full (``chip_smoke.
splash_tile_fault_errs``).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from unsloth_tpu_torch.ops import flash_attention as tfa
from unsloth_tpu_torch.ops import splash_attention as tsa

#: (kernel, query tile, kv tile) of the forward, dq and dk/dv kernels at
#: each head dim
KERNELS = sorted({(w, *tiles) for w, by_d in tfa.KERNEL_TILES.items()
                  for tiles in by_d.values()})


def _segments(kind, t, seed=0):
    """[2, t] int32 segment ids of one kind of row pair."""
    rng = np.random.default_rng(seed)
    seg = np.ones((2, t), dtype=np.int32)
    if kind == "contiguous":        # packed documents, then a pad tail
        cuts = np.sort(rng.choice(np.arange(1, t), size=4, replace=False))
        for r in range(2):
            for i, c in enumerate(cuts):
                seg[r, c:] = i + 2
        seg[1, cuts[-1]:] = 0
    elif kind == "padded":          # pad_batch: 1 real, 0 pad
        seg[0, int(t * 0.7):] = 0
    return torch.from_numpy(seg)


def _check(seg, causal, kernel, bq, bk, window=None, layout=None):
    """The three properties of the classes against the dense mask."""
    b, t = seg.shape
    mask = tsa._splash_mask(seg, b, t, "cpu", window, layout,
                            causal).numpy()
    classes = chip_smoke.flash_tile_classes(seg, causal, bq, bk, window,
                                            layout, kernel)
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


@pytest.mark.parametrize("kernel,bq,bk", KERNELS)
@pytest.mark.parametrize("window", [None, 1, 50, 64, 128, 300, 5000])
@pytest.mark.parametrize("kind,t", [("one", 512), ("padded", 333),
                                    ("contiguous", 640)])
def test_window_classes_hold_the_mask(kind, t, window, kernel, bq, bk):
    """Windows of none, one token, less than, equal to and more than a tile,
    and past T, over one segment, a padded row pair and packed documents
    with a pad tail, ragged T among them, at each kernel's tiles."""
    _check(_segments(kind, t), True, kernel, bq, bk, window=window)


@pytest.mark.parametrize("kernel,bq,bk", KERNELS)
@pytest.mark.parametrize("layout,prompt_len,lens", [
    ((256, 6, 896), 173, (768, 412, 57, 768, 230, 600)),  # phase 12's row
    ((128, 3, 128), 90, (128, 40, 101)),                  # tile-aligned
    ((100, 3, 70), 57, (70, 13, 66)),                     # edges in tiles
    ((5, 5, 5), 5, (5, 2, 5, 1, 3)),                      # regions < a tile
    ((0, 4, 96), 0, (96, 50, 1, 96)),                     # no prompt
])
@pytest.mark.parametrize("segments", [False, True])
def test_layout_classes_hold_the_mask(layout, prompt_len, lens, segments,
                                      kernel, bq, bk):
    """GRPO's prefix layouts whose edges fall on and off tile edges, with
    one segment and with the row's segment ids as GRPOTrainer builds them
    (a right-aligned prompt, completions shorter than their regions)."""
    P, G, L = layout
    seg = (chip_smoke.prefix_segments(layout, prompt_len, lens) if segments
           else torch.ones((1, P + G * L), dtype=torch.int32))
    _check(seg, True, kernel, bq, bk, layout=layout)


@pytest.mark.parametrize("kernel,bq,bk", KERNELS)
@pytest.mark.parametrize("kind,t", [("padded", 333), ("contiguous", 640)])
def test_noncausal_classes_hold_the_mask(kind, t, kernel, bq, bk):
    """Without causality (K18's FullMask form: no window, no layout)."""
    _check(_segments(kind, t), False, kernel, bq, bk)


def test_walks_skip_nothing_they_need():
    """The windowed walks visit the same pairs in every kernel (each pair's
    nearest (query, key) inside the window), so a window skips nothing
    inside a walk; at phase 12's layout the forward classes 735 of its 990
    causal pairs skip, and dk/dv, whose walk ends at each kv tile's
    region, none."""
    seg = torch.ones((1, 8192), dtype=torch.int32)
    for w, (bq, bk) in ((w, tfa.KERNEL_TILES[w][256]) for w in
                        ("fwd", "dq", "dkv")):
        counts = chip_smoke.flash_tile_counts(seg, True, bq, bk, 4096,
                                              kernel=w)
        assert counts[0] == 0
        causal = chip_smoke.flash_tile_counts(seg, True, bq, bk, kernel=w)
        assert sum(counts) < sum(causal)
    one = torch.ones((1, 5632), dtype=torch.int32)
    layout = (256, 6, 896)
    assert chip_smoke.flash_tile_counts(one, True, 128, 128,
                                        prefix_layout=layout) == [735, 211, 44]
    assert chip_smoke.flash_tile_counts(one, True, 64, 128,
                                        prefix_layout=layout,
                                        kernel="dkv") == [0, 422, 88]
    assert chip_smoke.visited_tile_pairs(5632, layout, bq=128, bk=128) == 255
    assert chip_smoke.visited_tile_pairs(5632, bq=128, bk=128) == 990


@settings(max_examples=60, deadline=None)
@given(t=st.integers(1, 400), kernel=st.sampled_from(KERNELS),
       window=st.one_of(st.none(), st.integers(1, 500)),
       n_ids=st.integers(1, 4), run=st.integers(1, 90),
       seed=st.integers(0, 2 ** 31 - 1))
def test_window_classes_property(t, kernel, window, n_ids, run, seed):
    """Random windows over random layouts: runs of random ids (an id may
    come back later) over a random T."""
    rng = np.random.default_rng(seed)
    seg = np.repeat(rng.integers(0, n_ids, size=(2, -(-t // run))), run,
                    axis=1)[:, :t].astype(np.int32)
    _check(torch.from_numpy(seg), True, *kernel, window=window)


@settings(max_examples=60, deadline=None)
@given(P=st.integers(0, 150), G=st.integers(1, 5), L=st.integers(1, 130),
       kernel=st.sampled_from(KERNELS), seed=st.integers(0, 2 ** 31 - 1))
def test_layout_classes_property(P, G, L, kernel, seed):
    """Random prefix layouts, each with a random prompt length and random
    completion lengths (segment ids as GRPOTrainer builds them)."""
    rng = np.random.default_rng(seed)
    seg = chip_smoke.prefix_segments(
        (P, G, L), int(rng.integers(0, P + 1)),
        [int(x) for x in rng.integers(0, L + 1, size=G)])
    _check(seg, True, *kernel, layout=(P, G, L))


def _inputs(t, hq=4, hkv=2, d=64, seed=7):
    rng = np.random.default_rng(seed)
    q, k = (torch.from_numpy(4 * rng.standard_normal((2, t, h, d))
                             .astype(np.float32)) for h in (hq, hkv))
    v, dout = (torch.from_numpy(rng.standard_normal((2, t, h, d))
                                .astype(np.float32)) for h in (hkv, hq))
    return q, k, v, dout


def _want(q, k, v, seg, dout, **opts):
    out, lse = tsa.splash_attention_fwd_ref(q, k, v, seg, **opts)
    return (out,) + tsa.splash_attention_bwd_ref(q, k, v, seg, out, lse,
                                                 dout, **opts)


@pytest.mark.parametrize("softcap", [None, 50.0])
def test_check_rejects_a_pair_past_the_window_as_full(softcap):
    """The plain versions with one (query tile, kv tile) pair that holds
    pairs inside and past the window called full fail the row-wise check
    in each of out, dq, dk and dv; the reference rounded to bf16 passes."""
    t, window = 512, 200
    q, k, v, dout = _inputs(t)
    seg = _segments("padded", t)
    opts = dict(window=window, softcap=softcap, scale=0.125)
    want = _want(q, k, v, seg, dout, **opts)
    for x in want:
        assert chip_smoke.attn_row_err(x.to(torch.bfloat16), x) <= \
            chip_smoke.ATTN_ROW_TOL
    res = chip_smoke.splash_tile_fault_errs(q, k, v, seg, dout, 0.125, want,
                                            window=window, softcap=softcap)
    assert set(res) == {"pair past the window as full"}
    for name, (err, _) in res["pair past the window as full"].items():
        assert err > chip_smoke.ATTN_ROW_TOL, (name, err)


@pytest.mark.parametrize("layout,prompt_len,lens", [
    ((128, 3, 128), 90, (128, 40, 101)),
    ((100, 3, 70), 57, (70, 13, 66)),
])
def test_check_rejects_a_pair_across_regions_as_full(layout, prompt_len,
                                                     lens):
    """The plain versions with one pair whose queries and keys lie in two
    completion regions called full (a completion sees an earlier one) fail
    the row-wise check in each of out, dq, dk and dv."""
    P, G, L = layout
    t = P + G * L
    q, k, v, dout = (x[:1] for x in _inputs(t))
    seg = chip_smoke.prefix_segments(layout, prompt_len, lens)
    opts = dict(window=None, softcap=None, scale=0.125, prefix_layout=layout)
    want = _want(q, k, v, seg, dout, **opts)
    res = chip_smoke.splash_tile_fault_errs(q, k, v, seg, dout, 0.125, want,
                                            prefix_layout=layout)
    assert set(res) == {"pair across regions as full"}
    for name, (err, _) in res["pair across regions as full"].items():
        assert err > chip_smoke.ATTN_ROW_TOL, (name, err)


def test_masked_plain_version_is_the_plain_version():
    """``chip_smoke._plain_under_mask`` in K18's form, under the right mask,
    gives the plain versions' results (so that its faults differ only in the mask): within
    1e-4 relative plus 1e-5 of the tensor's largest value, the fp32 sums
    of a softmax against exp(s - lse) in another order."""
    t = 200
    q, k, v, dout = _inputs(t)
    seg = _segments("contiguous", t)
    opts = dict(window=64, softcap=30.0, scale=0.125)
    want = _want(q, k, v, seg, dout, **opts)
    mask = tsa._splash_mask(seg, 2, t, "cpu", 64, None)
    got = chip_smoke._plain_under_mask(q, k, v, dout, 0.125, mask, 30.0,
                                       splash=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * b.abs().max().item())


def test_build_report_finds_spills_and_serialized_wgmma():
    """``chip_smoke.attention_build_report``, which phase 2 holds every
    build to: each Hopper attention instantiation with its registers and
    spill, named by kernel, head dim and K16, K17 (the forward's sinks
    form) or K18; ptxas's C75xx lines that name one of them; other kernels
    ignored."""
    fn = ("_ZN6hflash45_GLOBAL__N__1b2810b0_12_flash_dkv_cu_5d9fc7b116"
          "flash_dkv_kernelILi256ELb1EEEv14CUtensorMap_stS2_S2_S2_NS_6ParamsE")
    dq = ("_ZN6hflash44_GLOBAL__N__cad7f7ec_11_flash_dq_cu_b298537015"
          "flash_dq_kernelILi64ELb0EEEv14CUtensorMap_stS2_S2_S2_NS_6ParamsE")
    fwd = ("_ZN6hflash45_GLOBAL__N__0c2f7a1e_12_flash_fwd_cu_1e43b0aa16"
           "flash_fwd_kernelILi{}ELb0ELb{}EEEv14CUtensorMap_stS2_S2_NS_6ParamsE")
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fn}",
        "    96 bytes stack frame, 92 bytes spill stores, 96 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers",
        "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async "
        f"instructions are serialized in the function '{fn}'",
        f"ptxas info    : Compiling entry function '{dq}' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{fwd.format(128, 1)}' "
        "for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{fwd.format(256, 0)}' "
        "for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z10nf4_kernel' for "
        "'sm_90a'",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 255 registers"])
    rows, serialized = chip_smoke.attention_build_report(log)
    assert rows == [("flash_dkv_kernel<256, K18>", 168, 92),
                    ("flash_dq_kernel<64, K16>", 168, 0),
                    ("flash_fwd_kernel<128, K17>", 168, 0),
                    ("flash_fwd_kernel<256, K16>", 168, 0)]
    assert len(serialized) == 1 and "C7515" in serialized[0]
