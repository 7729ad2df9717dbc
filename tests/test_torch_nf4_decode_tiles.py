"""The CPU twins of the decode kernel's walks against the JAX package.

At 16 rows of x or fewer, K1 (the NF4 matmul forward) and K12 (the FP8
one) run ``csrc/decode_matmul.cu``: split K over row groups and slices of
64-byte steps (``decode_schedule``), the absmax read as stored and decoded
in the kernel, each slice's fp32 partial summed in slice order, one
rounding. ``nf4_decode_tiles_ref`` and ``fp8_decode_tiles_ref`` rebuild y
from that walk and are held to JAX's ``nf4_matmul`` and ``fp8_matmul``
(their Pallas kernels in interpret mode, as the JAX tests run them) and to
JAX's ``dequantize_nf4`` / ``dequantize_fp8`` and a matmul: NF4 at K =
4,096 and gpt-oss's K = 2,880 (K/2 % 64 == 32: an absmax block straddles
K/2), N = 1,000 (a row-group tail), M = 1, 4, 7 and 16, the absmax
double-quantized and plain fp32; FP8 at block 128 and at the ragged block
32 shape of phase 3. Tolerance: the twin and JAX round the same bf16
weights and sum them in fp32 in other orders, then round once to bf16:
within one bf16 ulp of JAX's, plus 2^-20 of the largest for sums that
cancel. A walk whose low side reads the high side's absmax, or that drops
a K slice, disagrees far past that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsloth_tpu.ops import fp8 as jfp8
from unsloth_tpu.ops import fp8_matmul as jfm
from unsloth_tpu.ops import nf4 as jnf4
from unsloth_tpu.ops.qlora_matmul import nf4_matmul as jax_nf4_matmul
from unsloth_tpu_torch.interop import to_tensor
from unsloth_tpu_torch.ops import fp8 as tfp8
from unsloth_tpu_torch.ops import nf4 as tnf4
from unsloth_tpu_torch.ops.fp8_matmul import fp8_decode_tiles_ref
from unsloth_tpu_torch.ops.qlora_matmul import (DECODE_MAX_SMEM, DECODE_STEP,
                                                H100_SMS, decode_absmax_ref,
                                                decode_schedule,
                                                decode_smem_bytes,
                                                nf4_decode_tiles_ref)

ROWS = 16   # x rows made for every case; a case takes the first m


def _within_one_ulp(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16
    return bool(np.all(np.abs(got - want)
                       <= ulp + 2.0 ** -20 * np.abs(want).max()))


def _nf4(n, k, seed):
    """W [n, k] quantized by the port with double quantization (as the
    loader stores it), the same weights with that absmax decoded to plain
    fp32 (the bnb-4bit form), JAX's NF4 tensor of those bytes and that
    fp32 absmax, and x [ROWS, k] in bf16 on both sides. JAX gets the
    port's decoded absmax because its jitted decode contracts code * scale
    + offset into one FMA, which moves the last bit of a few scales (and
    so a bf16 weight, and outputs that cancel near zero, past one ulp);
    the port's decode is held to the kernel's bit for bit below."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((n, k)) * 0.05
                          ).astype(np.float32))
    tq = tnf4.quantize_nf4(w, double_quant=True)
    tf = tnf4.NF4Tensor(tq.packed, tnf4._decode_absmax(tq), None, None,
                        tq.shape, tq.block_size, tq.dtype)
    jq = jnf4.NF4Tensor(jnp.asarray(tq.packed.numpy()),
                        jnp.asarray(tf.absmax.numpy()), None, None, (n, k),
                        tq.block_size, jnp.bfloat16)
    xj = jnp.asarray(rng.standard_normal((ROWS, k)).astype(np.float32)
                     ).astype(jnp.bfloat16)
    return jq, tq, tf, xj, to_tensor(np.asarray(xj), "cpu")


@jax.jit
def _jax_nf4_dequant_matmul(jq, xj):
    w = jnf4.dequantize_nf4(jq, dtype=jnp.bfloat16)
    return jnp.matmul(xj.astype(jnp.float32), w.astype(jnp.float32).T
                      ).astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def nf4_cases():
    """K -> (JAX's tensor, the port's double-quantized and fp32-absmax
    tensors, x): K = 4,096 and 2,880 at N = 1,000."""
    return {k: _nf4(1000, k, seed=k) for k in (4096, 2880)}


@pytest.mark.parametrize("k", [4096, 2880])
@pytest.mark.parametrize("dq", [True, False], ids=["double-quant", "fp32"])
@pytest.mark.parametrize("m", [1, 4, 7, 16])
def test_nf4_walk_matches_jax_dequant(nf4_cases, k, dq, m):
    jq, tq, tf, xj, xt = nf4_cases[k]
    y, visits = nf4_decode_tiles_ref(xt[:m], tq if dq else tf)
    plan = decode_schedule(m, 1000, k, "nf4")
    assert y.shape == (m, 1000) and y.dtype == torch.bfloat16
    assert visits.shape == (plan.groups, plan.slices)
    assert bool((visits == 1).all())
    assert _within_one_ulp(y, _jax_nf4_dequant_matmul(jq, xj[:m]))


@pytest.fixture(scope="module")
def nf4_kernel_case():
    """N = 1,024, K = 4,096: the JAX kernel's tiles divide both."""
    return _nf4(1024, 4096, seed=5)


@pytest.mark.parametrize("m", [1, 16])
def test_nf4_walk_matches_jax_kernel(nf4_kernel_case, m):
    jq, tq, _, xj, xt = nf4_kernel_case
    y, _ = nf4_decode_tiles_ref(xt[:m], tq)
    assert _within_one_ulp(y, jax.jit(jax_nf4_matmul)(xj[:m], jq))


@pytest.mark.parametrize("k", [4096, 2880])
def test_absmax_decode_is_the_wrappers(nf4_cases, k):
    """The kernel's decode of the stored absmax (the code times its group's
    scale, then plus the offset, two fp32 roundings) is ``_decode_absmax``
    bit for bit, so that the two absmax forms give the same bits; the
    fp32 form reads as it is."""
    _, tq, tf, _, _ = nf4_cases[k]
    assert torch.equal(decode_absmax_ref(tq), tnf4._decode_absmax(tq))
    assert torch.equal(decode_absmax_ref(tf), tf.absmax)


@pytest.mark.parametrize("k", [4096, 2880])
@pytest.mark.parametrize("fault", ["low_reads_high", "drop_slice"])
def test_nf4_walk_with_a_fault_disagrees(nf4_cases, k, fault):
    jq, tq, _, xj, xt = nf4_cases[k]
    plan = decode_schedule(4, 1000, k, "nf4")
    kw = ({"low_reads_high": True} if fault == "low_reads_high"
          else {"drop_slice": plan.slices // 2})
    y, _ = nf4_decode_tiles_ref(xt[:4], tq, **kw)
    assert not _within_one_ulp(y, _jax_nf4_dequant_matmul(jq, xj[:4]))


# the decode shapes of the paths: (N, K) of every projection of
# Llama-3.1-8B, Gemma-2-9B and gpt-oss-20b's attention
DECODE_SHAPES = {
    "llama": [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)],
    "gemma2": [(4096, 3584), (2048, 3584), (3584, 4096), (14336, 3584),
               (3584, 14336)],
    "gpt-oss": [(4096, 2880), (512, 2880), (2880, 4096)]}


@pytest.mark.parametrize("model", sorted(DECODE_SHAPES))
@pytest.mark.parametrize("policy", ["nf4", "fp8"])
@pytest.mark.parametrize("m", [1, 16])
def test_decode_schedule_visits_each_unit_once(model, policy, m):
    """Every (row group, 64-byte step) in exactly one unit, every W row in
    one group, no slice empty, at least one block an SM and at most two
    (one wave), the x slice within the shared memory, and the counters'
    expectation: the units, and each row's 16-byte chunks once."""
    for n, k in DECODE_SHAPES[model]:
        plan = decode_schedule(m, n, k, policy)
        row_bytes = k // 2 if policy == "nf4" else k
        assert plan.row_bytes == row_bytes
        assert plan.steps == -(-row_bytes // DECODE_STEP)
        assert (plan.groups - 1) * plan.rows < n <= plan.groups * plan.rows
        seen = np.zeros((plan.groups, plan.steps), dtype=np.int64)
        for row0, st0, st1 in plan.units:
            assert st0 < st1 <= plan.steps
            seen[row0 // plan.rows, st0:st1] += 1
        assert (seen == 1).all()
        units = plan.groups * plan.slices
        assert H100_SMS <= units <= 2 * H100_SMS, (n, k, plan)
        assert decode_smem_bytes(policy == "fp8", plan.n_tiles,
                                 plan.slice_steps, plan.row_warps) \
            <= DECODE_MAX_SMEM
        assert plan.counts(n) == [units, n * -(-row_bytes // 16)]


def test_decode_schedule_n_tiles_follow_the_rows():
    assert decode_schedule(8, 4096, 4096).n_tiles == 1
    assert decode_schedule(9, 4096, 4096).n_tiles == 2
    with pytest.raises(ValueError):
        decode_schedule(1, 4096, 4096, "int8")


def _fp8(n, k, block, seed):
    """W [n, k] with per-block magnitudes two orders apart, quantized by
    both packages (byte for byte the same), and x [ROWS, k]."""
    rng = np.random.default_rng(seed)
    nb, kb = -(-n // block), -(-k // block)
    f = np.exp2(rng.uniform(-2, 2, (nb, kb)))
    f = np.repeat(np.repeat(f, block, 0), block, 1)[:n, :k]
    w = (rng.standard_normal((n, k)) * 0.02 * f).astype(np.float32)
    jq = jfp8.quantize_fp8_block(jnp.asarray(w), block=block,
                                 dtype=jnp.bfloat16)
    tq = tfp8.quantize_fp8_block(torch.from_numpy(w), block=block,
                                 dtype=torch.bfloat16)
    xj = jnp.asarray(rng.standard_normal((ROWS, k)).astype(np.float32)
                     ).astype(jnp.bfloat16)
    return jq, tq, xj, to_tensor(np.asarray(xj), "cpu")


@jax.jit
def _jax_fp8_dequant_matmul(jq, xj):
    w = jfp8.dequantize_fp8(jq, jnp.bfloat16)
    return jnp.matmul(xj.astype(jnp.float32), w.astype(jnp.float32).T
                      ).astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def fp8_cases():
    """Block 128 at N = 640, K = 1,024 (JAX's kernel shape), and phase 3's
    ragged case: block 32 at N = 1,000, K = 1,404 (K % 16 == 12: the
    kernel's byte loads, a last scale column cut short)."""
    return {"block 128": _fp8(640, 1024, 128, seed=3),
            "ragged block 32": _fp8(1000, 1404, 32, seed=4)}


@pytest.mark.parametrize("case", ["block 128", "ragged block 32"])
@pytest.mark.parametrize("m", [1, 4])
def test_fp8_walk_matches_jax(fp8_cases, case, m):
    jq, tq, xj, xt = fp8_cases[case]
    y, visits = fp8_decode_tiles_ref(xt[:m], tq)
    n, k = tq.shape
    plan = decode_schedule(m, n, k, "fp8")
    assert visits.shape == (plan.groups, plan.slices)
    assert bool((visits == 1).all())
    assert _within_one_ulp(y, _jax_fp8_dequant_matmul(jq, xj[:m]))
    if case == "block 128":
        assert _within_one_ulp(y, jfm.fp8_matmul(xj[:m], jq))


@pytest.mark.parametrize("fault", ["scale_shift", "drop_slice"])
def test_fp8_walk_with_a_fault_disagrees(fp8_cases, fault):
    jq, tq, xj, xt = fp8_cases["ragged block 32"]
    plan = decode_schedule(4, *tq.shape, "fp8")
    kw = ({"scale_shift": 1} if fault == "scale_shift"
          else {"drop_slice": plan.slices // 2})
    y, _ = fp8_decode_tiles_ref(xt[:4], tq, **kw)
    assert not _within_one_ulp(y, _jax_fp8_dequant_matmul(jq, xj[:4]))
