"""K19's work-unit schedule and the checks that must see its faults, on the
CPU.

``chip_smoke.gmm_work_units`` is the Python twin of the persistent forward
/ dx kernel's walk in unsloth_tpu_torch/csrc/gmm.cu (``build_tables``,
``unit_of``): a unit is (visit, 192-column tile of the output), a visit
being the rows [lo, hi) of one group inside one 128-row tile, and the rows
past the last group form one more group whose units store zeros.
``chip_smoke.tgmm_work_units`` is the twin of csrc/tgmm.cu's walk: a unit
per (expert, 128 x 192 tile of [N, K]), reducing the expert's rows in
64-row chunks from its first row, the rows of a chunk past the group
zeroed. Here the twins are held, at the kernels' tiles
(``ops.gmm.KERNEL_TILES``), to what the kernels must do: every row and
column of the output is stored by exactly one unit of its own group, every
element of dW exactly once (empty experts too), and every chunk's kept
rows lie inside its group and cover it once. Then ``chip_smoke.mm_ulps``
and ``chip_smoke.attn_row_err`` must reject, on the plain versions, each
planted fault of ``chip_smoke.tgmm_faults`` (at the kernel's chunk) and
``chip_smoke.gmm_straddle_faults``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from unsloth_tpu_torch.ops import gmm as tgmm

T = tgmm.KERNEL_TILES

#: (group sizes, m, output columns): zeros among the groups, one expert,
#: m not a multiple of the 128-row tile, columns not a multiple of 192,
#: rows past the groups, a group inside one tile
CASES = [
    ([300, 0, 212, 0, 0, 100], 612, 400),
    ([0, 0, 0, 777], 777, 192),
    ([1, 1, 1, 1, 1000], 1004, 2880),
    ([128, 128, 256, 0, 64], 700, 136),
    ([50, 20, 3], 73, 64),
    ([0, 0], 150, 200),
]


def _row_groups(sizes, m):
    """Group of each row: its group, len(sizes) past the groups."""
    own = np.full(m, len(sizes))
    start = 0
    for gi, s in enumerate(sizes):
        own[start:min(start + s, m)] = gi
        start = min(start + s, m)
    return own


def _check_gmm_units(sizes, m, n_out):
    units = chip_smoke.gmm_work_units(sizes, m, n_out)
    own = _row_groups(sizes, m)
    count = np.zeros((m, n_out), dtype=np.int64)
    for g, rows, cols in chip_smoke.gmm_stored(units, n_out):
        assert (own[rows.start:rows.stop] == g).all(), (g, rows)
        count[rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (count == 1).all()
    for u in units:
        assert u["row0"] % T["rows"] == 0 and u["col0"] % T["cols"] == 0
        assert u["row0"] <= u["lo"] < u["hi"] <= u["row0"] + T["rows"]
        assert u["col0"] < n_out
    # the counters' twin agrees with the unit list
    c = chip_smoke.gmm_unit_counts(sizes, m, n_out)
    assert c[0] + c[1] == len(units)
    assert c[1] == sum(u["g"] == len(sizes) for u in units)
    assert c[2] + c[3] == len(chip_smoke.gmm_stored(units, n_out))
    return units


def _check_tgmm_units(sizes, n, k):
    m = sum(sizes)
    units = chip_smoke.tgmm_work_units(sizes, n, k, m)
    e = len(sizes)
    assert len(units) == e * -(-n // T["tgmm_n"]) * -(-k // T["tgmm_k"])
    written = np.zeros((e, n, k), dtype=np.int64)
    start = 0
    bounds = []
    for s in sizes:
        bounds.append((start, start + s))
        start += s
    for u in units:
        for h in (0, 64):
            r0 = u["n0"] + h
            if r0 < n:
                written[u["g"], r0:min(r0 + 64, n),
                        u["k0"]:min(u["k0"] + T["tgmm_k"], k)] += 1
        lo, hi = bounds[u["g"]]
        rows = np.zeros(m, dtype=np.int64)
        for i, (r, kept) in enumerate(u["chunks"]):
            assert lo <= r and r + kept <= hi
            assert 0 < kept <= T["tgmm_chunk"]
            assert kept == T["tgmm_chunk"] or i == len(u["chunks"]) - 1
            rows[r:r + kept] += 1
        assert (rows[lo:hi] == 1).all() and rows.sum() == hi - lo
    assert (written == 1).all()
    c = chip_smoke.tgmm_unit_counts(sizes, n, k, m)
    assert c[0] + c[1] == len(units)
    assert c[1] == sum(not u["chunks"] for u in units)
    assert c[2] == sum(len(u["chunks"]) for u in units)
    return units


@pytest.mark.parametrize("sizes,m,n_out", CASES)
def test_gmm_units_store_every_row_once(sizes, m, n_out):
    units = _check_gmm_units(sizes, m, n_out)
    # units come group by group, column tile by column tile, visits fastest
    keys = [(u["g"], u["col0"], u["row0"]) for u in units]
    assert keys == sorted(keys)


def test_gmm_units_at_the_path_shape():
    """The gpt-oss path's 16,384 rows over 32 experts at N = 2,880: 15
    column tiles, no column wasted; the straddling tiles' visits store by
    masked stores, the rest by TMA."""
    rng = np.random.default_rng(0)
    sizes = np.bincount(rng.integers(0, 32, 16384), minlength=32).tolist()
    units = _check_gmm_units(sizes, 16384, 2880)
    assert {u["col0"] for u in units} == set(range(0, 2880, 192))
    c = chip_smoke.gmm_unit_counts(sizes, 16384, 2880)
    assert c[1] == 0 and c[0] == len(units)
    straddles = sum(1 for u in units if u["hi"] - u["lo"] < T["rows"])
    assert straddles > 0 and c[3] > 0


@settings(max_examples=40, deadline=None)
@given(sizes=st.lists(st.one_of(st.just(0), st.integers(1, 300)),
                      min_size=1, max_size=9),
       tail=st.integers(0, 200), n_out=st.integers(1, 60).map(lambda x: 8 * x))
def test_gmm_units_property(sizes, tail, n_out):
    m = sum(sizes) + tail
    if m == 0:
        return
    _check_gmm_units(sizes, m, n_out)


@pytest.mark.parametrize("sizes,n,k", [
    ([300, 0, 212, 0, 0, 100], 200, 136),
    ([0, 0, 0, 777], 128, 192),
    ([1, 1, 1, 1, 1000], 2880 // 8, 400),
    ([128, 64, 0, 65], 64, 72),
    ([0, 0], 136, 200),
])
def test_tgmm_units_write_every_element_once(sizes, n, k):
    _check_tgmm_units(sizes, n, k)


@settings(max_examples=40, deadline=None)
@given(sizes=st.lists(st.one_of(st.just(0), st.integers(1, 300)),
                      min_size=1, max_size=6),
       n=st.integers(1, 40).map(lambda x: 8 * x),
       k=st.integers(1, 50).map(lambda x: 8 * x))
def test_tgmm_units_property(sizes, n, k):
    _check_tgmm_units(sizes, n, k)


def test_tgmm_chunk_is_the_kernels():
    assert chip_smoke.TGMM_CHUNK == T["tgmm_chunk"]


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(torch.bfloat16)


@pytest.mark.parametrize("sizes,n,k", [
    ((0, 45, 0, 70, 1, 33), 200, 136),   # phase 3's ragged case
    ((100, 0, 130, 64), 72, 48),         # a whole chunk, partial chunks
])
def test_tgmm_check_rejects_faults(sizes, n, k):
    """Each fault of chip_smoke.tgmm_faults at the kernel's chunk, on the
    plain version, is above MM_ULPS; the plain version against itself in
    another summation order (fp64) is within it."""
    rng = np.random.default_rng(3)
    sizes_t = torch.tensor(sizes, dtype=torch.int32)
    m = sum(sizes)
    lhs, gy = _bf16(rng, m, k), _bf16(rng, m, n)
    ref = tgmm.tgmm_ref(lhs, gy, sizes_t)
    faults = chip_smoke.tgmm_faults(lhs, gy, sizes_t)
    assert set(faults) == {"next group's row counted",
                           "empty expert unwritten",
                           "last partial chunk dropped",
                           "written [E, K, N]"}
    for fault, wrong in faults.items():
        assert not chip_smoke.mm_ulps(wrong, ref) <= chip_smoke.MM_ULPS, \
            fault
    start, other = 0, torch.zeros_like(ref)
    for gi, s in enumerate(sizes):
        other[gi] = (gy[start:start + s].double().t()
                     @ lhs[start:start + s].double()).to(ref.dtype)
        start += s
    assert chip_smoke.mm_ulps(other, ref) <= chip_smoke.MM_ULPS


@pytest.mark.parametrize("transpose", [False, True])
def test_gmm_check_rejects_straddle_fault(transpose):
    """A straddling tile's rows stored by the next expert's visit (through
    its weights, and bias in the forward) is rejected row by row
    (chip_smoke.attn_row_err) on the plain version, while the plain
    version in fp64 passes; with no tile straddling there is no such
    fault."""
    rng = np.random.default_rng(5)
    e, n, k = 4, 72, 48
    sizes = torch.tensor([200, 0, 100, 90], dtype=torch.int32)
    m = int(sizes.sum())
    x = _bf16(rng, m, n if transpose else k)
    w = (_bf16(rng, e, n, k).float() * 0.05).to(torch.bfloat16)
    bias = None if transpose else _bf16(rng, e, n)
    ref = tgmm.gmm_ref(x, w, sizes, bias, transpose=transpose)
    faults = chip_smoke.gmm_straddle_faults(x, w, sizes, bias, transpose)
    assert len(faults) == 1
    for fault, wrong in faults.items():
        assert not chip_smoke.attn_row_err(wrong, ref) \
            <= chip_smoke.ATTN_ROW_TOL, fault
    other = torch.zeros_like(ref)
    start = 0
    for gi, s in enumerate(sizes.tolist()):
        wg = w[gi].double()
        y = (x[start:start + s].double() @ (wg if transpose else wg.t())
             ).to(ref.dtype)
        other[start:start + s] = y if bias is None else y + bias[gi]
        start += s
    assert chip_smoke.attn_row_err(other, ref) <= chip_smoke.ATTN_ROW_TOL
    aligned = torch.tensor([128, 0, 256, 0], dtype=torch.int32)
    xa = _bf16(rng, 384, n if transpose else k)
    assert chip_smoke.gmm_straddle_faults(xa, w, aligned, bias,
                                          transpose) == {}
