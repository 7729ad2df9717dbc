"""The CPU twins of K1's and K5's Hopper walks against the JAX package.

K1 (``csrc/nf4_wgmma.cu``): ``nf4_matmul_tiles_ref`` rebuilds y from the
kernel's walk (tiles of the persistent schedule, 32-byte stages, the two
nibble sides' x columns, an absmax lookup per 16-byte chunk, rows past M
and N zero-filled) and is held to JAX's ``nf4_matmul`` (the Pallas kernel
in interpret mode, as the JAX tests run it) and to JAX's
``dequantize_nf4`` at K = 4,096 and gpt-oss's K = 2,880 (K/2 % 64 == 32),
with N tails (2,880 = 22.5 tiles of 128; 512) and M tails (300 and 200
rows against 256-row tiles).
Tolerance: the twin and JAX round the same bf16 weights and sum them in
fp32 in other orders, then round once to bf16, so each output is within
one bf16 ulp of JAX's (plus 2^-20 of the largest, for sums that cancel).
A walk whose 64-byte stage crosses K/2 agrees only with its past-K/2 mask:
the zero bytes there decode to -absmax and the high side reads x's real
low-side columns.

K5 (``csrc/layer_norm.cu``): ``layer_norm_rows_ref`` sums each row as the
kernel's form does (one warp a row: a lane's 16-byte chunks, then the
shuffle tree; else one 256-thread block) and is held to JAX's
``layer_norm`` within ``chip_smoke.ln_errs``' forward limits, at D = 1,280
(the warp form) and D = 1,282 (no whole chunks: the block form).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from unsloth_tpu.ops import nf4 as jnf4
from unsloth_tpu.ops.qlora_matmul import nf4_matmul as jax_nf4_matmul
from unsloth_tpu.ops.rms_norm import layer_norm as jax_layer_norm
from unsloth_tpu_torch.interop import to_tensor
from unsloth_tpu_torch.ops import nf4 as tnf4
from unsloth_tpu_torch.ops.qlora_matmul import (H100_SMS, STAGE_BYTES,
                                                TILE_W, nf4_matmul_tiles_ref,
                                                nf4_tile_schedule,
                                                tile_rows_x)
from unsloth_tpu_torch.ops.rms_norm import (layer_norm_rows_ref,
                                            layer_norm_warp_form)


def _carried(n, k, m, seed):
    """W [n, k] quantized by the port (fp32 absmax: the bytes JAX makes,
    tests/test_torch_nf4.py), the same NF4 tensor in JAX, and x [m, k] in
    bf16 on both sides."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((n, k)) * 0.05
                          ).astype(np.float32))
    tq = tnf4.quantize_nf4(w, double_quant=False)
    jq = jnf4.NF4Tensor(jnp.asarray(tq.packed.numpy()),
                        jnp.asarray(tq.absmax.numpy()), None, None, (n, k),
                        tq.block_size, jnp.bfloat16)
    xj = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32)
                     ).astype(jnp.bfloat16)
    return jq, tq, xj, to_tensor(np.asarray(xj), "cpu")


def _within_one_ulp(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16
    return bool(np.all(np.abs(got - want)
                       <= ulp + 2.0 ** -20 * np.abs(want).max()))


@jax.jit
def _jax_dequant_matmul(jq, xj):
    """x @ dequantize_nf4(W)^T: JAX's bf16 weights, fp32 sums, one bf16
    rounding."""
    w = jnf4.dequantize_nf4(jq, dtype=jnp.bfloat16)
    return jnp.matmul(xj.astype(jnp.float32), w.astype(jnp.float32).T
                      ).astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def gpt_oss_qkv():
    """gpt-oss's q/k/v input width, K = 2,880 (K/2 = 1,440 = 22.5 absmax
    blocks), at its o projection's N = 2,880 (a tail of 64 rows past 22
    W tiles) and 200 rows of x (one 256-row tile, 56 rows short)."""
    return _carried(2880, 2880, 200, seed=1)


def test_walk_matches_jax_kernel_at_k4096():
    """K = 4,096, N = 512 (four W tiles), M = 300 (a 256-row tile and a
    tail): the twin against JAX's nf4_matmul in interpret mode and
    against dequantize_nf4 + a matmul."""
    jq, tq, xj, xt = _carried(512, 4096, 300, seed=0)
    y, visits = nf4_matmul_tiles_ref(xt, tq)
    assert y.shape == (300, 512) and y.dtype == torch.bfloat16
    assert visits.tolist() == [[1] * 4] * 2
    assert _within_one_ulp(y, jax.jit(jax_nf4_matmul)(xj, jq))
    assert _within_one_ulp(y, _jax_dequant_matmul(jq, xj))


def test_walk_matches_jax_dequant_at_gpt_oss_width(gpt_oss_qkv):
    jq, tq, xj, xt = gpt_oss_qkv
    y, visits = nf4_matmul_tiles_ref(xt, tq)
    assert bool((visits == 1).all()) and visits.shape == (1, 23)
    assert _within_one_ulp(y, _jax_dequant_matmul(jq, xj))


def test_walk_needs_its_past_half_mask(gpt_oss_qkv):
    """With 64-byte stages at K/2 = 1,440 the last stage crosses K/2: with
    its mask the walk still agrees; without it the zero-filled bytes
    decode to -absmax against x's real low-side columns (and the low
    side's absmax runs into the next row), and the walk disagrees far past
    one ulp. The kernel's 32-byte stage divides K/2, so no stage of its
    walk crosses K/2 at all."""
    jq, tq, xj, xt = gpt_oss_qkv
    assert (2880 // 2) % STAGE_BYTES == 0 and (2880 // 2) % 64 == 32
    want = _jax_dequant_matmul(jq, xj)
    masked, _ = nf4_matmul_tiles_ref(xt, tq, stage_bytes=64, mask=True)
    assert _within_one_ulp(masked, want)
    bare, _ = nf4_matmul_tiles_ref(xt, tq, stage_bytes=64, mask=False)
    assert not _within_one_ulp(bare, want)
    ref = np.asarray(want.astype(jnp.float32))
    assert np.abs(bare.float().numpy() - ref).max() > 0.1 * np.abs(ref).max()


@pytest.mark.parametrize("m,n,sms", [(8192, 14336, 132), (300, 2880, 132),
                                     (17, 512, 132), (128, 4096, 132),
                                     (1500, 4096, 132), (129, 1024, 7),
                                     (4096, 2880, 1), (200, 384, 132)])
def test_schedule_visits_each_tile_once(m, n, sms):
    """Every output tile of y [m, n] is stored by exactly one block of the
    persistent grid: clusters of two, at most one a unit and as many as
    the SMs hold; the two blocks of a cluster take the same x rows against
    neighbouring W tiles, unit by unit, the units dealt to the clusters in
    turn (W pairs fastest)."""
    bx = tile_rows_x(m)
    sched = nf4_tile_schedule(m, n, sms)
    tiles = [t for block in sched for t in block]
    want = {(i * bx, j * TILE_W) for i in range(-(-m // bx))
            for j in range(-(-n // TILE_W))}
    assert len(tiles) == len(set(tiles)) == len(want) and set(tiles) == want
    tiles_n = -(-n // TILE_W)
    pairs = -(-tiles_n // 2)
    units = -(-m // bx) * pairs
    clusters = min(units, max(1, sms // 2))
    assert len(sched) == 2 * clusters
    for c in range(clusters):
        lead, peer = sched[2 * c], sched[2 * c + 1]
        assert all((n0 // TILE_W) % 2 == 0 for _, n0 in lead)
        assert peer == [(m0, n0 + TILE_W) for m0, n0 in lead
                        if n0 + TILE_W < tiles_n * TILE_W]
        units_of = [(m0 // bx) * pairs + n0 // (2 * TILE_W) for m0, n0 in lead]
        assert units_of == list(range(c, units, clusters))


def test_tile_rows_follow_the_kernel():
    """128-row tiles of x up to 128 rows (wgmma n128), 256 above; the
    twin's defaults are the kernel's constants."""
    assert [tile_rows_x(m) for m in (17, 128, 129, 8192)] == [128, 128,
                                                              256, 256]
    assert (STAGE_BYTES, TILE_W, H100_SMS) == (32, 128, 132)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [1280, 1282])
def test_layer_norm_rows_twin_matches_jax(dtype, d):
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((24, d)) * rng.uniform(0.5, 3.0, (24, 1))
         + rng.standard_normal((24, 1))).astype(np.float32)
    w = (1.0 + 0.2 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    xj, wj, bj = (jnp.asarray(a).astype(getattr(jnp, dtype))
                  for a in (x, w, b))
    xt, wt, bt = (to_tensor(np.asarray(a), "cpu") for a in (xj, wj, bj))
    assert layer_norm_warp_form(d, xt.dtype) == (d == 1280)
    got = layer_norm_rows_ref(xt, wt, bt, 1e-5)
    want = to_tensor(np.asarray(jax_layer_norm(xj, wj, bj, 1e-5)), "cpu")
    assert got.dtype == xt.dtype
    assert chip_smoke.ln_out_err(xt.dtype, got, want) <= 1.0


@pytest.mark.parametrize("d,dtype,warp", [
    (1280, torch.bfloat16, True), (1280, torch.float32, True),
    (4096, torch.bfloat16, True), (4096, torch.float32, False),
    (2048, torch.float32, True), (4104, torch.bfloat16, False),
    (1284, torch.bfloat16, False), (1284, torch.float32, True),
    (7000, torch.bfloat16, False)])
def test_layer_norm_warp_form_rule(d, dtype, warp):
    """The warp form takes D a multiple of the 16-byte chunk with at most
    16 chunks a lane: bf16 up to 4,096, fp32 up to 2,048."""
    assert layer_norm_warp_form(d, dtype) is warp


def test_build_report_finds_the_nf4_kernel():
    """Phase 2 holds K1's Hopper kernel, the decode kernel and its grouped
    form to 0 spill and no serialized wgmma as it holds the attention
    kernels (43 rows: the attention kernels' 21, two tile heights each of
    K1, K12, K2, K13, K14 and K15, the decode kernel's three weight
    policies at one and two n-tiles, and its grouped form's two, K14's and
    K19's decode rows, at one and two)."""
    fn = ("_ZN4nf4w54_GLOBAL__N__5c1f0b2a_12_nf4_wgmma_cu_0e3f5a1c16"
          "nf4_wgmma_kernelILi256EEEv14CUtensorMap_stS2_S2_PKfP13"
          "__nv_bfloat16Piiiii")
    dec = ("_ZN49_GLOBAL__N__03a29351_16_decode_matmul_cu_1152633920"
           "decode_matmul_kernelILi2ELi1EEEvNS_6ParamsE")
    grouped = ("_ZN49_GLOBAL__N__03a29351_16_decode_matmul_cu_1152633921"
               "grouped_decode_kernelILi1ELi2EEEvNS_13GroupedParamsE")
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : (C7517) Potential Performance Loss: wgmma.mma_async "
        f"instructions are serialized in the function '{fn}'",
        f"ptxas info    : Compiling entry function '{dec}' for 'sm_90a'",
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 16 bytes smem",
        f"ptxas info    : Compiling entry function '{grouped}' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 126 registers, used 1 barriers, 80 bytes smem"])
    rows, serialized = chip_smoke.attention_build_report(log)
    assert rows == [("nf4_wgmma_kernel<256, K1>", 168, 0),
                    ("decode_matmul_kernel<K12 any shape, NT 1>", 128, 8),
                    ("grouped_decode_kernel<K19, NT 2>", 126, 0)]
    assert len(serialized) == 1 and "C7517" in serialized[0]
    assert chip_smoke.HOPPER_BUILD_ROWS == 43


def test_build_report_finds_the_norm_backwards():
    """Phase 2 holds K4's and K6's backward instantiations to 0 spill (36
    rows: for each (x, w) dtype pair the row form at 2 and 4 chunks a lane,
    dx alone and with dW, and the strided form; K6 with bf16 x has no
    4-chunk row form), named by their dtypes and form."""
    tag = "_ZN44_GLOBAL__N__85108ee7_11_rms_norm_cu_f565634d19"
    names = [tag + "rms_norm_bwd_kernelIf13__nv_bfloat16Li4ELb1EEEvNS_11"
             "NormBwdArgsE",
             tag + "rms_norm_bwd_kernelI13__nv_bfloat16S1_Li2ELb0EEEvNS_11"
             "NormBwdArgsE",
             "_ZN46_GLOBAL__N__bd966dab_13_layer_norm_cu_4cb206c321layer_norm"
             "_bwd_kernelIffLi0ELb0EEEvNS_11NormBwdArgsE",
             "_ZN46_GLOBAL__N__bd966dab_13_layer_norm_cu_4cb206c321layer_norm"
             "_bwd_kernelI13__nv_bfloat16fLi2ELb1EEEvNS_11NormBwdArgsE"]
    lines = []
    for i, fn in enumerate(names):
        lines += [f"ptxas info    : Compiling entry function '{fn}' for "
                  "'sm_90a'",
                  f"    0 bytes stack frame, {8 * (i == 3)} bytes spill "
                  "stores, 0 bytes spill loads",
                  f"ptxas info    : Used {90 + i} registers, used 16 "
                  "barriers, 208 bytes smem"]
    assert chip_smoke.norm_build_report("\n".join(lines)) == [
        ("rms_norm_bwd_kernel<f32, bf16, C 4, dW>", 90, 0),
        ("rms_norm_bwd_kernel<bf16, bf16, C 2, dx>", 91, 0),
        ("layer_norm_bwd_kernel<f32, f32, strided>", 92, 0),
        ("layer_norm_bwd_kernel<bf16, f32, C 2, dW>", 93, 8)]
    assert chip_smoke.NORM_BUILD_ROWS == 36
