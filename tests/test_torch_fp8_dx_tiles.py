"""The CPU twin of K13's Hopper walk against the JAX package.

K13 (the FP8 backward, dx = g @ dequant(W)) above 16 rows runs K2's
persistent kernel in its e4m3 form (``csrc/nf4_wgmma.cu``,
``nf4_dx_wgmma_kernel<BX, true>``) wherever ``fp8_dx_wgmma_form`` holds: dx
computed transposed, 128-column tiles, the reduction over W's rows in
stages of 64. ``fp8_matmul_dx_tiles_ref`` rebuilds dx from that walk (K2's
schedule with 128-column tiles, zero bytes past N and K, one scale a 16 x
16 piece of W: a k step's rows and a warp's columns, the grid's last row or
column past its edge) and is held to ``jax.vjp`` of JAX's ``fp8_matmul``
(``_bwd_pallas`` in interpret mode, as the JAX tests run it) at block 128,
and to JAX's ``dequantize_fp8`` and a matmul at block 32 on a ragged shape
(N = 1,000: a last stage 40 rows past N and a last scale row of 8; K =
1,392: a last tile 112 columns past K, a last scale column of 16).
Tolerance: the twin and JAX round the same bf16 weights (fp32 e4m3 times
the block's scale, one rounding) and sum them in fp32 in other orders, then
round once to bf16: within one bf16 ulp of JAX's, plus 2^-20 of the largest
for sums that cancel. A walk that reads the neighbouring scale row or
column disagrees far past that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsloth_tpu.ops import fp8 as jfp8
from unsloth_tpu.ops import fp8_matmul as jfm
from unsloth_tpu_torch.interop import to_tensor
from unsloth_tpu_torch.ops import fp8 as tfp8
from unsloth_tpu_torch.ops.fp8_matmul import (FP8_DX_SCALE_TILE, FP8_DX_TILE,
                                              H100_SMS, fp8_dx_tile_schedule,
                                              fp8_dx_wgmma_form,
                                              fp8_matmul_dx_ref,
                                              fp8_matmul_dx_tiles_ref)
from unsloth_tpu_torch.ops.qlora_matmul import (DX_STAGE_ROWS,
                                                nf4_dx_tile_schedule,
                                                tile_rows_x)


def _carried(n, k, m, block, seed):
    """W [n, k] with per-block magnitudes two orders apart (so that the
    blocks' scales differ, as a checkpoint's do), quantized at ``block`` by
    both packages (byte for byte the same: tests/test_torch_fp8.py), and g
    [m, n] in bf16 on both sides."""
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
    """g @ dequantize_fp8(W): JAX's bf16 weights, fp32 sums, one bf16
    rounding."""
    w = jfp8.dequantize_fp8(jq, jnp.bfloat16)
    return jnp.matmul(gj.astype(jnp.float32), w.astype(jnp.float32)
                      ).astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def ragged32():
    """Block 32, N = 1,000 (16 stages, the last 40 rows past N; the last
    scale row 8 rows), K = 1,392 (11 column tiles, the last 112 columns
    past K; the last scale column 16 columns), 333 rows (a 256-row tile and
    a tail)."""
    return _carried(1000, 1392, 333, 32, seed=1)


def test_dx_walk_matches_jax_vjp_at_block_128():
    """N = 512 (8 stages, four scale rows), K = 384 (three column tiles,
    three scale columns), M = 300: the twin against jax.vjp of JAX's
    fp8_matmul (its backward kernel in interpret mode) and against
    dequantize_fp8 + a matmul."""
    jq, tq, gj, gt = _carried(512, 384, 300, 128, seed=0)
    xj = jnp.zeros((300, 384), jnp.bfloat16)
    _, vjp = jax.vjp(lambda x: jfm.fp8_matmul(x, jq), xj)
    want = vjp(gj)[0]
    dx, visits = fp8_matmul_dx_tiles_ref(gt, tq)
    assert dx.shape == (300, 384) and dx.dtype == torch.bfloat16
    assert visits.tolist() == [[1] * 3] * 2
    assert _within_one_ulp(dx, want)
    assert _within_one_ulp(dx, _jax_dequant_dx(jq, gj))


def test_dx_walk_matches_jax_dequant_at_ragged_block_32(ragged32):
    jq, tq, gj, gt = ragged32
    dx, visits = fp8_matmul_dx_tiles_ref(gt, tq)
    assert bool((visits == 1).all()) and visits.shape == (2, 11)
    assert _within_one_ulp(dx, _jax_dequant_dx(jq, gj))


@pytest.mark.parametrize("n,k,m,block", [(2880, 2880, 70, 32),
                                         (96, 4096, 129, 128),
                                         (200, 48, 17, 64)])
def test_dx_walk_matches_the_plain_version(n, k, m, block):
    """The twin against the port's plain version (dequantize, one matmul)
    at gpt-oss's widths (45 stages, 23 column tiles), at 129 rows (a
    256-row tile 127 rows short) with N = 96 (a stage half past N), and at
    17 rows with K = 48 (one tile, 80 columns past K)."""
    _, tq, _, gt = _carried(n, k, m, block, seed=n + k)
    dx, visits = fp8_matmul_dx_tiles_ref(gt, tq)
    assert bool((visits == 1).all())
    assert _within_one_ulp(dx, jnp.asarray(
        fp8_matmul_dx_ref(gt, tq).float().numpy()))


@pytest.mark.parametrize("case", ["block 128", "ragged block 32"])
@pytest.mark.parametrize("shift", [(1, 0), (0, 1)])
def test_dx_walk_with_a_neighbours_scale_disagrees(case, shift, ragged32):
    """Each 16 x 16 piece of W read with the scale one block further down
    its rows (the next scale row: the reduction's neighbour) or along its
    columns (the next scale column) misses JAX far past one ulp."""
    jq, tq, gj, gt = ragged32 if case != "block 128" else _carried(
        512, 384, 300, 128, seed=0)
    want = _jax_dequant_dx(jq, gj)
    bad, _ = fp8_matmul_dx_tiles_ref(gt, tq, scale_shift=shift)
    assert not _within_one_ulp(bad, want)
    ref = np.asarray(want.astype(jnp.float32))
    assert np.abs(bad.float().numpy() - ref).max() > 0.1 * np.abs(ref).max()


@pytest.mark.parametrize("m,n,k,block,ptrs,hopper", [
    (4096, 14336, 4096, 128, (0, 16, 4096), True),  # the path's gate/up
    (4096, 4096, 14336, 128, (), True),             # its down
    (4096, 1024, 4096, 128, (), True),              # its k/v
    (17, 200, 384, 32, (), True),                   # the fewest rows it takes
    (16, 4096, 4096, 128, (), False),               # decode rows: <16, true>
    (333, 1000, 1392, 32, (), True),                # K % 32 == 16
    (333, 1000, 1404, 32, (), False),               # K % 16 != 0
    (300, 130, 256, 64, (), False),                 # N % 8 != 0: g's stride
    (300, 512, 512, 48, (), False),                 # B % 32 != 0
    (300, 512, 512, 128, (16, 8, 32), False)])      # a pointer 8 bytes off
def test_fp8_dx_wgmma_form_rule(m, n, k, block, ptrs, hopper):
    """K13's Hopper form takes K12's shapes (more than 16 rows, B a
    multiple of 32, K a multiple of 16, 16-byte aligned pointers) with N a
    multiple of 8 (g's TMA row stride); fp8_matmul.cu's fp8_dx_wgmma_form
    mirrors it. Every FP8 projection of the path takes it."""
    assert fp8_dx_wgmma_form(m, n, k, block, *ptrs) is hopper


def test_dx_walk_refuses_blocks_the_form_does_not_take():
    q = tfp8.quantize_fp8_block(torch.randn(96, 64), block=48)
    with pytest.raises(ValueError, match="multiple of the 32"):
        fp8_matmul_dx_tiles_ref(torch.zeros((20, 96), dtype=torch.bfloat16),
                                q)


@pytest.mark.parametrize("m,k,sms", [(4096, 4096, 132), (4096, 14336, 132),
                                     (333, 1392, 132), (17, 384, 132),
                                     (128, 1024, 132), (129, 2880, 7),
                                     (4096, 2880, 1), (5, 48, 132)])
def test_dx_schedule_stores_each_tile_once(m, k, sms):
    """Every 128-column tile of dx [m, k] against every g tile is stored by
    exactly one block of the persistent grid; the schedule is K2's with
    128-column tiles for 64-byte ones: clusters of two taking the same g
    rows against neighbouring column tiles, unit by unit, the partner of
    an odd last tile storing nothing."""
    bx = tile_rows_x(m)
    tiles_k = -(-k // FP8_DX_TILE)
    sched = fp8_dx_tile_schedule(m, k, sms)
    tiles = [t for block in sched for t in block]
    want = {(i * bx, j * FP8_DX_TILE) for i in range(-(-m // bx))
            for j in range(tiles_k)}
    assert len(tiles) == len(set(tiles)) == len(want) and set(tiles) == want
    # K2's schedule over 64-byte tiles of a K/2 as wide as K13's tiles
    k2 = nf4_dx_tile_schedule(m, 2 * tiles_k * 64, sms)
    assert sched == [[(m0, j0 * 2) for m0, j0 in block] for block in k2]


def test_dx_tiles_follow_the_kernel():
    """The twin's constants are the kernel's: 128 dx columns a tile, 64 W
    rows a stage (K2's), one scale a 16 x 16 piece, 128-row g tiles up to
    128 rows and 256 above, an H100's 132 SMs."""
    assert (FP8_DX_TILE, DX_STAGE_ROWS, FP8_DX_SCALE_TILE, H100_SMS) == \
        (128, 64, 16, 132)
    assert [tile_rows_x(m) for m in (17, 128, 129)] == [128, 128, 256]
