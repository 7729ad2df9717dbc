"""The CPU twin of K12's Hopper walk against the JAX package.

K12 above 16 rows runs K1's persistent kernel in its e4m3 form
(``csrc/nf4_wgmma.cu``, ``nf4_wgmma_kernel<BX, true>``) wherever
``fp8_wgmma_form`` holds. ``fp8_matmul_tiles_ref`` rebuilds y from that
walk (K1's schedule, 32-byte stages of the tile's 128 W rows, one scale
row a warp's 16 rows and one scale column a stage, zero bytes past N and
K) and is held to JAX's ``fp8_matmul`` (its Pallas kernel in interpret
mode, as the JAX tests run it) at block 128, and to JAX's
``dequantize_fp8`` and a matmul at block 32 on a ragged shape (N = 1,000
and K = 1,392: a last scale row and column cut short, a last stage half
past K). Tolerance: the twin and JAX round the same bf16 weights (fp32
e4m3 times the block's scale, one rounding) and sum them in fp32 in other
orders, then round once to bf16: within one bf16 ulp of JAX's, plus 2^-20
of the largest for sums that cancel. A walk that reads the neighbouring
scale column disagrees far past that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsloth_tpu.ops import fp8 as jfp8
from unsloth_tpu.ops import fp8_matmul as jfm
from unsloth_tpu_torch.interop import to_tensor
from unsloth_tpu_torch.ops import fp8 as tfp8
from unsloth_tpu_torch.ops.fp8_matmul import (H100_SMS, STAGE_BYTES, TILE_W,
                                              fp8_matmul_tiles_ref,
                                              fp8_tile_schedule,
                                              fp8_wgmma_form)
from unsloth_tpu_torch.ops.qlora_matmul import nf4_tile_schedule


def _carried(n, k, m, block, seed):
    """W [n, k] with per-block magnitudes two orders apart (so that the
    blocks' scales differ, as a checkpoint's do), quantized at ``block`` by
    both packages (byte for byte the same: tests/test_torch_fp8.py), and x
    [m, k] in bf16 on both sides."""
    rng = np.random.default_rng(seed)
    nb, kb = -(-n // block), -(-k // block)
    f = np.exp2(rng.uniform(-2, 2, (nb, kb)))
    f = np.repeat(np.repeat(f, block, 0), block, 1)[:n, :k]
    w = (rng.standard_normal((n, k)) * 0.02 * f).astype(np.float32)
    jq = jfp8.quantize_fp8_block(jnp.asarray(w), block=block,
                                 dtype=jnp.bfloat16)
    tq = tfp8.quantize_fp8_block(torch.from_numpy(w), block=block,
                                 dtype=torch.bfloat16)
    np.testing.assert_array_equal(tq.values.view(torch.uint8).numpy(),
                                  np.asarray(jq.values).view(np.uint8))
    xj = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32)
                     ).astype(jnp.bfloat16)
    return jq, tq, xj, to_tensor(np.asarray(xj), "cpu")


def _within_one_ulp(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16
    return bool(np.all(np.abs(got - want)
                       <= ulp + 2.0 ** -20 * np.abs(want).max()))


def _jax_dequant_matmul(jq, xj):
    """x @ dequantize_fp8(W)^T: JAX's bf16 weights, fp32 sums, one bf16
    rounding."""
    w = jfp8.dequantize_fp8(jq, jnp.bfloat16)
    return jnp.matmul(xj.astype(jnp.float32), w.astype(jnp.float32).T
                      ).astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def ragged32():
    """Block 32, N = 1,000 (the last 128-row tile 104 rows short, the last
    scale row 8 rows), K = 1,392 (43.5 stages and scale columns), 333 rows
    (a 256-row tile and a tail)."""
    return _carried(1000, 1392, 333, 32, seed=1)


def test_walk_matches_jax_kernel_at_block_128():
    """N = 512 (four W tiles), K = 384 (three scale columns, 12 stages), M
    = 300: the twin against JAX's fp8_matmul (its Pallas kernel in
    interpret mode) and against dequantize_fp8 + a matmul."""
    jq, tq, xj, xt = _carried(512, 384, 300, 128, seed=0)
    y, visits = fp8_matmul_tiles_ref(xt, tq)
    assert y.shape == (300, 512) and y.dtype == torch.bfloat16
    assert visits.tolist() == [[1] * 4] * 2
    assert _within_one_ulp(y, jfm.fp8_matmul(xj, jq))
    assert _within_one_ulp(y, _jax_dequant_matmul(jq, xj))


def test_walk_matches_jax_dequant_at_ragged_block_32(ragged32):
    jq, tq, xj, xt = ragged32
    y, visits = fp8_matmul_tiles_ref(xt, tq)
    assert bool((visits == 1).all()) and visits.shape == (2, 8)
    assert _within_one_ulp(y, _jax_dequant_matmul(jq, xj))


@pytest.mark.parametrize("case", ["block 128", "ragged block 32"])
def test_walk_with_a_neighbours_scale_disagrees(case, ragged32):
    """Each stage read with the scale column one further along (the next
    block's; the last reads its own) misses JAX far past one ulp."""
    jq, tq, xj, xt = ragged32 if case != "block 128" else _carried(
        512, 384, 300, 128, seed=0)
    want = _jax_dequant_matmul(jq, xj)
    bad, _ = fp8_matmul_tiles_ref(xt, tq, scale_shift=1)
    assert not _within_one_ulp(bad, want)
    ref = np.asarray(want.astype(jnp.float32))
    assert np.abs(bad.float().numpy() - ref).max() > 0.1 * np.abs(ref).max()


@pytest.mark.parametrize("m,k,block,ptrs,hopper", [
    (4096, 4096, 128, (0, 16, 4096), True),      # the path's shapes
    (17, 384, 32, (), True),                     # the fewest rows it takes
    (16, 4096, 128, (), False),                  # decode rows: <16, false>
    (1, 14336, 128, (), False),
    (333, 1392, 32, (), True),                   # K % 32 == 16
    (333, 1404, 32, (), False),                  # K % 16 != 0: <64, false>
    (300, 512, 48, (), False),                   # B % 32 != 0
    (300, 512, 24, (), False),
    (300, 512, 256, (), True),
    (300, 512, 128, (16, 8, 32), False)])        # a pointer 8 bytes off
def test_fp8_wgmma_form_rule(m, k, block, ptrs, hopper):
    """The Hopper form takes more than 16 rows, B a multiple of the 32-byte
    stage, K a multiple of 16 (the TMA maps' strides) and 16-byte aligned
    pointers; fp8_matmul.cu's fp8_wgmma_form mirrors it."""
    assert fp8_wgmma_form(m, k, block, *ptrs) is hopper


def test_walk_refuses_blocks_the_form_does_not_take():
    q = tfp8.quantize_fp8_block(torch.randn(64, 96), block=48)
    with pytest.raises(ValueError, match="multiple of the 32-byte"):
        fp8_matmul_tiles_ref(torch.zeros((20, 96), dtype=torch.bfloat16), q)


@pytest.mark.parametrize("m,n", [(4096, 14336), (333, 1000), (17, 96)])
def test_schedule_is_k1s(m, n):
    """K12's Hopper form runs K1's kernel, so its schedule is K1's, tile
    for tile; the twin's stage and tile are K1's."""
    assert fp8_tile_schedule(m, n) == nf4_tile_schedule(m, n, H100_SMS)
    assert (STAGE_BYTES, TILE_W) == (32, 128)
