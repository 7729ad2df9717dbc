"""The CPU twins of the grouped decode kernel's walks against the JAX package.

At 16 routed rows or fewer, K14 (the grouped NF4 expert forward, y = x @
dequant(W_g)^T + bias[g] for the rows of group g) and K19's forward (the
same over dense bf16 experts) run ``csrc/decode_matmul.cu``'s grouped
decode kernel: units of (slot, row group, K slice) for min(m, E) slots,
slot s on the s-th expert that owns rows, laid from the shapes alone
(``grouped_decode_schedule``); each slice's fp32 partial summed in slice
order, one rounding (K14: the fp32 bias added first; K19: the bf16 bias
added to the rounded product, a second rounding). ``nf4_gmm_decode_tiles_ref``
and ``gmm_decode_tiles_ref`` rebuild y from that walk and are held to JAX's
``_nf4_gmm_fwd_impl(..., interpret=True)`` and to megablox ``gmm`` in
interpret mode as ``unsloth_tpu/ops/moe.py:tiled_gmm`` calls it, with and
without the bias: gpt-oss's K = 2,880 at block 32 (an absmax block
straddles K/2), N = 200 (a row-group tail), E = 8, m = 1, 4, 8 and 16,
routings with every row on its own expert, several rows on one expert,
empty experts, and rows past the groups (zeros in the twin; JAX leaves
them unwritten, so they are compared only against zero). Tolerance
(``chip_smoke.decode_twin_within``): one bf16 ulp of each output plus
2^-20 of the largest (the same bf16 weights summed in fp32 in other
orders, one rounding); K19 with its bias one ulp of the product more, for
its second rounding, and at most one output in a thousand past two ulps
of its own. A walk that reads the next live expert's weights, drops a K
slice, or (K19) adds the bias before the rounding disagrees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import decode_twin_within
from unsloth_tpu.ops import nf4 as jnf4
from unsloth_tpu.ops import nf4_gmm as jgmm
from unsloth_tpu_torch import kernels
from unsloth_tpu_torch.interop import params_from_numpy
from unsloth_tpu_torch.ops import gmm as tgmm
from unsloth_tpu_torch.ops import nf4_gmm as tng
from unsloth_tpu_torch.ops.qlora_matmul import (DECODE_MAX_SMEM, DECODE_STEP,
                                                H100_SMS, _smem_bytes,
                                                grouped_decode_schedule)
from tests.test_torch_gmm import jax_tiled_gmm

E, N, K, BLOCK = 8, 200, 2880, 32
ROWS = 16   # x rows made; a case takes the first m

#: (m, routing) -> group sizes over E = 8 experts
ROUTINGS = {
    (1, "own"): [0, 0, 1, 0, 0, 0, 0, 0],
    (4, "own"): [1, 0, 1, 1, 0, 0, 1, 0],
    (4, "shared"): [0, 3, 0, 0, 0, 0, 1, 0],
    (8, "own"): [1, 1, 1, 1, 1, 1, 1, 1],
    (8, "past"): [0, 3, 0, 0, 2, 0, 0, 0],
    (16, "shared"): [2, 0, 9, 0, 0, 1, 0, 4],
    (16, "past"): [0, 0, 6, 0, 5, 0, 0, 0],
}


@pytest.fixture(scope="module")
def case():
    """W [E, N, K] quantized by JAX (the port's NF4Stacked carries the same
    bytes), the same W in bf16 on both sides, x [ROWS, K] and a bias [E,
    N] in bf16 on both sides (fp32 for K14: exact), and a cache of JAX's
    results by (kernel, m, routing, bias)."""
    rng = np.random.default_rng(23)
    w = (rng.standard_normal((E, N, K)) * 0.1).astype(np.float32)
    jq = jnf4.quantize_nf4_stacked(jnp.asarray(w), block_size=BLOCK,
                                   dtype=jnp.bfloat16)
    tq = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), "cpu")
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    xj = jnp.asarray(rng.standard_normal((ROWS, K)).astype(np.float32)
                     ).astype(jnp.bfloat16)
    bj = jnp.asarray(rng.standard_normal((E, N)).astype(np.float32)
                     ).astype(jnp.bfloat16)

    def to_t(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
            torch.bfloat16)

    cache = {}

    def jax_y(kernel, m, routing, with_bias):
        key = (kernel, m, routing, with_bias)
        if key not in cache:
            sizes = jnp.asarray(ROUTINGS[m, routing], jnp.int32)
            if kernel == "nf4":
                cache[key] = jgmm._nf4_gmm_fwd_impl(
                    xj[:m], jq, sizes,
                    bias=bj.astype(jnp.float32) if with_bias else None,
                    interpret=True)
            else:
                cache[key] = jax_tiled_gmm(xj[:m], wj, sizes,
                                           bj if with_bias else None)
        return np.asarray(cache[key].astype(jnp.float32))

    return dict(tq=tq, w=to_t(wj), x=to_t(xj), bias=to_t(bj), jax_y=jax_y)


def _twin(kernel, case, m, routing, with_bias, **fault):
    sizes = torch.tensor(ROUTINGS[m, routing], dtype=torch.int32)
    if kernel == "nf4":
        b = case["bias"].float() if with_bias else None
        return tng.nf4_gmm_decode_tiles_ref(case["x"][:m], case["tq"], sizes,
                                            b, **fault)
    b = case["bias"] if with_bias else None
    return tgmm.gmm_decode_tiles_ref(case["x"][:m], case["w"], sizes, b,
                                     **fault)


def _within(kernel, case, got, want, m, routing, with_bias):
    """The groups' rows of ``got`` within ``decode_twin_within`` of JAX's:
    one bf16 ulp plus 2^-20 of the largest; for K19 with its bias, one
    ulp of the product more (the twin's product without the bias gives
    its scale), and at most one output in a thousand past two ulps."""
    rows = sum(ROUTINGS[m, routing])
    product = None
    if kernel == "bf16" and with_bias:
        product = _twin(kernel, case, m, routing, False)[0][:rows]
    return decode_twin_within(got[:rows], want[:rows], product)


def _check(kernel, case, m, routing, with_bias):
    y, visits = _twin(kernel, case, m, routing, with_bias)
    sizes = ROUTINGS[m, routing]
    end, live = sum(sizes), sum(1 for s in sizes if s)
    plan = grouped_decode_schedule(m, E, N, K, kernel)
    assert y.shape == (m, N) and y.dtype == torch.bfloat16
    assert visits.shape == (plan.slots, plan.groups, plan.slices)
    assert bool((visits[:live] == 1).all()) and not bool(visits[live:].any())
    assert bool((y[end:] == 0).all())
    want = case["jax_y"](kernel, m, routing, with_bias)
    assert _within(kernel, case, y, want, m, routing, with_bias)


@pytest.mark.parametrize("kernel", ["nf4", "bf16"])
@pytest.mark.parametrize("m,routing", list(ROUTINGS))
def test_walk_matches_jax_with_bias(case, kernel, m, routing):
    _check(kernel, case, m, routing, True)


@pytest.mark.parametrize("kernel", ["nf4", "bf16"])
@pytest.mark.parametrize("m,routing", [(4, "shared"), (16, "past")])
def test_walk_matches_jax_without_bias(case, kernel, m, routing):
    _check(kernel, case, m, routing, False)


@pytest.mark.parametrize("kernel,fault", [
    ("nf4", "next_expert"), ("nf4", "drop_slice"),
    ("bf16", "next_expert"), ("bf16", "drop_slice"), ("bf16", "bias_first")])
def test_walk_with_a_fault_disagrees(case, kernel, fault):
    """At 16 rows over four experts (two of them sharing 13 rows), each
    fault misses JAX far past the tolerance, in the groups' rows."""
    m, routing = 16, "shared"
    plan = grouped_decode_schedule(m, E, N, K, kernel)
    assert plan.slices > 1
    kw = {"drop_slice": plan.slices // 2} if fault == "drop_slice" \
        else {fault: True}
    bad, _ = _twin(kernel, case, m, routing, True, **kw)
    want = case["jax_y"](kernel, m, routing, True)
    assert not _within(kernel, case, bad, want, m, routing, True)


#: (E, N, K) of the paths' experts: gpt-oss-20b's gate/up and down,
#: qwen3-moe-30b's, Mixtral's, and the test shape above
SHAPES = [(32, 2880, 2880), (128, 768, 2048), (128, 2048, 768),
          (8, 14336, 4096), (8, 4096, 14336), (E, N, K)]


@pytest.mark.parametrize("policy", ["nf4", "bf16"])
@pytest.mark.parametrize("m", [1, 4, 8, 16])
def test_schedule_visits_each_unit_once(policy, m):
    """Every (slot, row group, 64-byte step) in exactly one unit, every W
    row in one group, no slice empty; min(m, E) slots; at least one block
    an SM. Where some row group (128, 64 or 32 rows) gives that many units
    without splitting K: one slice (fewer steps a slice only where the x
    slice would not fit the shared memory), and the row group whose waves
    of two blocks an SM stream the fewest rows each, on a tie the one that
    fits one wave, else the shorter;
    else K split as the plain decode kernel splits it, at most two blocks
    an SM unless the x slice forces more slices. The x slice within the
    shared memory; the counters' expectation for each number of live
    experts."""
    for e, n, k in SHAPES:
        plan = grouped_decode_schedule(m, e, n, k, policy)
        row_bytes = k // 2 if policy == "nf4" else 2 * k
        assert plan.slots == min(m, e) and plan.row_bytes == row_bytes
        assert plan.steps == -(-row_bytes // DECODE_STEP)
        assert (plan.groups - 1) * plan.rows < n <= plan.groups * plan.rows
        seen = np.zeros((plan.groups, plan.steps), dtype=np.int64)
        for row0, st0, st1 in plan.units:
            assert st0 < st1 <= plan.steps
            seen[row0 // plan.rows, st0:st1] += 1
        assert (seen == 1).all()
        units = plan.slots * plan.groups * plan.slices
        assert units >= H100_SMS, (e, n, k, plan)
        # one slice fewer would not fit x in the shared memory
        capped = plan.slices > 1 and _smem_bytes(
            policy, plan.n_tiles, -(-plan.steps // (plan.slices - 1)),
            plan.row_warps) > DECODE_MAX_SMEM
        fits = {rw: plan.slots * -(-n // (16 * rw)) for rw in (8, 4, 2)
                if plan.slots * -(-n // (16 * rw)) >= H100_SMS}
        if fits:
            assert plan.slices == 1 or capped, (e, n, k, plan)
            waves = {rw: -(-u // (2 * H100_SMS)) for rw, u in fits.items()}
            cost = {rw: waves[rw] * rw for rw in fits}
            best = [rw for rw in cost if cost[rw] == min(cost.values())]
            one = [rw for rw in best if waves[rw] == 1]
            assert plan.row_warps == (one[0] if one else min(best))
        else:
            assert units <= 2 * H100_SMS or capped, (e, n, k, plan)
        assert _smem_bytes(policy, plan.n_tiles, plan.slice_steps,
                           plan.row_warps) <= DECODE_MAX_SMEM
        chunks = n * -(-row_bytes // 16)
        for live in range(plan.slots + 1):
            assert plan.grouped_counts(n, live) == [
                live * plan.groups * plan.slices, live * chunks,
                plan.slots - live]
        assert plan.scratch == (units * plan.rows * 8 * plan.n_tiles,
                                plan.slots * plan.groups)
    with pytest.raises(ValueError):
        grouped_decode_schedule(m, 8, 256, 256, "fp8")


@pytest.mark.parametrize("kernel", ["nf4", "bf16"])
def test_decode_rows_reach_the_grouped_launch(monkeypatch, kernel):
    """Off the CPU (meta tensors, standing in for CUDA, whose group sizes
    cannot be read on the host), 16 rows or fewer call the C entry point
    once with the grouped schedule of the shapes and count one launch of
    the decode form, also under the kernel's own name; 17 rows reach it
    with no decode schedule. The output is left to the kernel (torch.empty:
    it writes the rows past the groups)."""
    calls = []

    class FakeLibrary:
        def unsloth_nf4_gmm_bf16(self, *args):
            calls.append((args[7:11], args[12:15], args[15] is not None))
            return 0

        def unsloth_gmm_bf16(self, *args):
            calls.append((args[5:9], args[9:12], args[12] is not None))
            return 0

    monkeypatch.setattr(kernels, "library", lambda: FakeLibrary())
    meta = dict(device="meta", dtype=torch.bfloat16)
    sizes = torch.empty((E,), device="meta", dtype=torch.int32)
    bias = torch.empty((E, N), **meta)
    if kernel == "nf4":
        monkeypatch.setattr(tng, "_check_cuda", lambda *a: None)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda dev: type("S", (), {"cuda_stream": 0}))
        w = tng.NF4Stacked(torch.empty((E, N, K // 2), device="meta",
                                       dtype=torch.uint8),
                           torch.empty((E * N * K // BLOCK,), device="meta"),
                           (E, N, K), BLOCK)
        fwd, dec, whole = tng.nf4_gmm_fwd, tng.nf4_gmm_decode, tng.nf4_gmm
    else:
        monkeypatch.setattr(tgmm, "_check_cuda", lambda *a: None)
        monkeypatch.setattr(tgmm, "_stream", lambda t: 0)
        w = torch.empty((E, N, K), **meta)
        fwd, dec, whole = tgmm.gmm_fwd, tgmm.gmm_decode, tgmm.gmm
    for m in (1, 16, 17):
        before = (whole.launches, dec.launches)
        y = fwd(torch.empty((m, K), **meta), w, sizes, bias)
        assert y.shape == (m, N)
        decode = m <= 16
        assert (whole.launches, dec.launches) == (before[0] + 1,
                                                  before[1] + decode)
        plan = grouped_decode_schedule(m, E, N, K, kernel)
        want = tuple(plan[:3]) if decode else (0, 0, 0)
        assert calls[-1][:2] == ((m, E, N, K), want)
        assert calls[-1][2] == (decode and plan.slices > 1)
    with pytest.raises(ValueError, match="at most 16"):
        dec(torch.empty((17, K), **meta), w, sizes, bias)
