"""The port's CUDA kernels against their plain PyTorch versions on the card.

These need an NVIDIA GPU and nvcc; without one they skip. On the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from chip_smoke import (ATTN_ROW_TOL, MM_ULPS, attn_row_err,
                        decode_twin_within, fp8_weight, flash_tile_counts,
                        kernel_tile_classes, launched_kernels, mm_ulps)
from unsloth_tpu_torch.ops.fp8 import fp8_matmul_ref, quantize_fp8_block
from unsloth_tpu_torch.ops.fp8_matmul import (fp8_matmul_dx, fp8_matmul_dx_ref,
                                              fp8_matmul_fwd)
from unsloth_tpu_torch.ops.lora import base_matmul
from unsloth_tpu_torch.ops.nf4 import dequantize_nf4, quantize_nf4
from unsloth_tpu_torch.ops.qlora_matmul import nf4_matmul
from unsloth_tpu_torch.ops.rms_norm import rms_norm, rms_norm_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


@pytest.mark.parametrize("m,n,k", [(1, 256, 512), (7, 200, 384),
                                   (70, 1024, 4096), (300, 4096, 4096),
                                   (64, 4096, 4096), (256, 4096, 4096),
                                   (1500, 4096, 4096), (300, 2880, 2880),
                                   (1500, 512, 2880), (70, 196, 384)])
def test_nf4_matmul_kernel_matches_plain(dev, m, n, k):
    g = torch.Generator(device=dev).manual_seed(0)
    q = quantize_nf4(torch.randn((n, k), generator=g, device=dev) * 0.05)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    before = nf4_matmul.launches
    y = nf4_matmul(x, q)
    ref = torch.matmul(x, dequantize_nf4(q, torch.bfloat16).t())
    torch.cuda.synchronize()
    assert nf4_matmul.launches == before + 1
    assert y.shape == (m, n) and y.dtype == torch.bfloat16
    # same bf16 weights, fp32 sums in another order, one bf16 rounding
    assert (y.float() - ref.float()).abs().max() <= \
        1e-2 * ref.float().abs().max()


@pytest.mark.parametrize("m,n,k", [(1, 1024, 4096), (16, 1024, 4096),
                                   (17, 1024, 4096), (128, 2880, 2880),
                                   (129, 512, 4096), (1500, 4096, 4096)])
def test_nf4_matmul_dispatch_by_rows(dev, m, n, k):
    """At 16 rows or fewer the forward runs the decode kernel
    (csrc/decode_matmul.cu), whose counters (units stored, 16-byte chunks
    read) equal ``decode_schedule``'s and which counts under
    ``nf4_matmul_decode`` too; above, the Hopper kernel, which stores each
    output tile of its schedule once and consumes K/64 stages a tile.
    Every form counts as one launch of nf4_matmul."""
    from unsloth_tpu_torch.ops.qlora_matmul import (DECODE_ROWS, STAGE_BYTES,
                                                    _nf4_matmul_fwd,
                                                    decode_schedule,
                                                    nf4_matmul_decode,
                                                    nf4_tile_schedule)

    g = torch.Generator(device=dev).manual_seed(3)
    q = quantize_nf4(torch.randn((n, k), generator=g, device=dev) * 0.05)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    before = (nf4_matmul.launches, nf4_matmul_decode.launches)
    y = _nf4_matmul_fwd(x, q, tile_counts=counts)
    torch.cuda.synchronize()
    decode = m <= DECODE_ROWS
    assert (nf4_matmul.launches, nf4_matmul_decode.launches) == \
        (before[0] + 1, before[1] + decode)
    if decode:
        want = decode_schedule(m, n, k, "nf4").counts(n)
    else:
        tiles = sum(map(len, nf4_tile_schedule(m, n)))
        want = [tiles, tiles * (k // 2 // STAGE_BYTES)]
    assert counts.tolist() == want
    ref = torch.matmul(x, dequantize_nf4(q, torch.bfloat16).t())
    assert (y.float() - ref.float()).abs().max() <= \
        1e-2 * ref.float().abs().max()


def _within_one_ulp(got, want):
    """The tiles tests' tolerance: one bf16 ulp of each output plus 2^-20
    of the largest (both round the same bf16 weights and sum in fp32 in
    other orders, then round once)."""
    got, want = got.float().cpu(), want.float().cpu()
    ulp = torch.from_numpy(np.spacing(want.abs().numpy())) * 2.0 ** 16
    return bool(((got - want).abs()
                 <= ulp + 2.0 ** -20 * want.abs().max()).all())


@pytest.mark.parametrize("m,n,k", [(1, 1000, 4096), (4, 4096, 4096),
                                   (7, 512, 2880), (16, 1024, 2880),
                                   (9, 200, 384), (16, 14336, 4096)])
def test_nf4_decode_kernel_matches_its_twin(dev, m, n, k):
    """The decode kernel against ``nf4_decode_tiles_ref`` (its walk in plain
    PyTorch on the CPU) within one ulp, the double-quantized absmax and
    the same tensor with it decoded to plain fp32 giving the same bits, two
    runs the same bits, and one kernel launched a call (no absmax decode
    pass, no memset)."""
    import dataclasses

    from unsloth_tpu_torch.ops.nf4 import _decode_absmax
    from unsloth_tpu_torch.ops.qlora_matmul import (nf4_decode_tiles_ref,
                                                    nf4_matmul_decode)

    g = torch.Generator(device=dev).manual_seed(31)
    q = quantize_nf4(torch.randn((n, k), generator=g, device=dev) * 0.05)
    q32 = dataclasses.replace(q, absmax=_decode_absmax(q).contiguous(),
                              absmax_scale=None, absmax_offset=None)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    y = nf4_matmul_decode(x, q)
    again = nf4_matmul_decode(x, q)
    kernels = launched_kernels(lambda: nf4_matmul_decode(x, q))
    from_f32 = nf4_matmul_decode(x, q32)
    twin, _ = nf4_decode_tiles_ref(x.cpu(), q.to("cpu"))
    torch.cuda.synchronize()
    assert len(kernels) == 1 and "decode_matmul_kernel" in kernels[0]
    assert torch.equal(y, again) and torch.equal(y, from_f32)
    assert _within_one_ulp(y, twin)


@pytest.mark.parametrize("m,n,k,block", [
    (1, 4096, 4096, 128),    # q/o, the FP8 path's block
    (16, 1024, 4096, 128),   # k/v, two n-tiles
    (4, 1000, 1404, 32),     # ragged: byte loads, a last column cut short
    (9, 130, 250, 24),       # B % 16 != 0: a scale per element
    (1, 200, 300, 7)])
def test_fp8_decode_kernel_matches_its_twin(dev, fp32_reductions, m, n, k,
                                            block):
    """K12's decode form against ``fp8_decode_tiles_ref`` within one ulp,
    its counters equal ``decode_schedule(m, n, k, "fp8")``'s, two runs the
    same bits, one launch counted under ``fp8_matmul_decode``."""
    import dataclasses

    from unsloth_tpu_torch.ops.fp8_matmul import (fp8_decode_tiles_ref,
                                                  fp8_matmul_decode)
    from unsloth_tpu_torch.ops.qlora_matmul import decode_schedule

    g = torch.Generator(device=dev).manual_seed(32)
    q = quantize_fp8_block(fp8_weight(n, k, g, dev, block), block)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    before = (fp8_matmul_fwd.launches, fp8_matmul_decode.launches)
    y = fp8_matmul_decode(x, q, tile_counts=counts)
    again = fp8_matmul_decode(x, q)
    twin, _ = fp8_decode_tiles_ref(x.cpu(), dataclasses.replace(
        q, values=q.values.cpu(), scales=q.scales.cpu()))
    torch.cuda.synchronize()
    assert (fp8_matmul_fwd.launches, fp8_matmul_decode.launches) == \
        (before[0] + 2, before[1] + 2)
    assert counts.tolist() == decode_schedule(m, n, k, "fp8").counts(n)
    assert torch.equal(y, again)
    assert _within_one_ulp(y, twin)


def test_nf4_matmul_kernel_refuses_f32(dev):
    q = quantize_nf4(torch.randn((128, 256), device=dev))
    with pytest.raises(NotImplementedError, match="bfloat16"):
        nf4_matmul(torch.randn((2, 256), device=dev), q)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gemma", [False, True])
def test_rms_norm_kernel_matches_plain(dev, dtype, gemma):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((3, 5, 4096), generator=g, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(4096, generator=g, device=dev)).to(dtype)
    before = rms_norm.launches
    y = rms_norm(x, w, 1e-5, gemma)
    ref = rms_norm_ref(x, w, 1e-5, gemma)
    torch.cuda.synchronize()
    assert rms_norm.launches == before + 1
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-6
    assert ((y.float() - ref.float()).abs()
            <= tol * ref.float().abs() + 1e-6).all()


# ---------------------------------------------------------------------------
# the training slice's kernels
# ---------------------------------------------------------------------------

from unsloth_tpu_torch.ops import packed_attention as tpa  # noqa: E402
from unsloth_tpu_torch.ops.qlora_matmul import (  # noqa: E402
    nf4_matmul_dx, nf4_matmul_dx_ref)
from unsloth_tpu_torch.ops.rms_norm import (  # noqa: E402
    rms_norm_bwd, rms_norm_bwd_ref)


@pytest.mark.parametrize("m,n,k", [(5, 256, 512), (300, 1024, 4096),
                                   (130, 4096, 1024)])
def test_nf4_matmul_dx_kernel_matches_plain(dev, m, n, k):
    """dx = g @ W: same bf16 weights, fp32 sums in another order, one bf16
    rounding: within 1e-2 of max|ref|."""
    g = torch.Generator(device=dev).manual_seed(2)
    q = quantize_nf4(torch.randn((n, k), generator=g, device=dev) * 0.05)
    gr = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
    before = nf4_matmul_dx.launches
    dx = nf4_matmul_dx(gr, q)
    ref = nf4_matmul_dx_ref(gr, q)
    torch.cuda.synchronize()
    assert nf4_matmul_dx.launches == before + 1
    assert dx.shape == (m, k) and dx.dtype == torch.bfloat16
    assert (dx.float() - ref.float()).abs().max() <= \
        1e-2 * ref.float().abs().max()


@pytest.mark.parametrize("m,n,k", [(5, 256, 512), (128, 512, 4096),
                                   (129, 1024, 4096), (300, 2880, 2880),
                                   (1500, 512, 2880), (260, 4096, 2880),
                                   (70, 320, 1024), (2, 64, 64)])
def test_nf4_dx_tiles_match_the_schedule(dev, m, n, k):
    """K2's Hopper kernel at every row count: each output tile of its
    persistent schedule (``nf4_dx_tile_schedule``) stored once, N / 64
    stages a tile, dx within 1e-2 of max|ref| of the plain version, at M
    tails, at gpt-oss's K = 2,880 (K/2 % 64 == 32: the last byte tile
    crosses K/2, the low side straddles two absmax blocks) and at K = 64
    (one byte tile of 32 bytes)."""
    from unsloth_tpu_torch.ops.qlora_matmul import (DX_STAGE_ROWS,
                                                    nf4_dx_tile_schedule)

    g = torch.Generator(device=dev).manual_seed(21)
    q = quantize_nf4(torch.randn((n, k), generator=g, device=dev) * 0.05)
    gr = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    before = nf4_matmul_dx.launches
    dx = nf4_matmul_dx(gr, q, tile_counts=counts)
    ref = nf4_matmul_dx_ref(gr, q)
    torch.cuda.synchronize()
    assert nf4_matmul_dx.launches == before + 1
    tiles = sum(map(len, nf4_dx_tile_schedule(m, k)))
    assert counts.tolist() == [tiles, tiles * (n // DX_STAGE_ROWS)]
    assert torch.isfinite(dx).all()
    assert (dx.float() - ref.float()).abs().max() <= \
        1e-2 * ref.float().abs().max()


def test_nf4_matmul_backward_launches_dx_kernel(dev):
    q = quantize_nf4(torch.randn((256, 512), device=dev) * 0.05)
    x = torch.randn((4, 512), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    before = nf4_matmul_dx.launches
    nf4_matmul(x, q).float().sum().backward()
    assert nf4_matmul_dx.launches == before + 1
    ref = nf4_matmul_dx_ref(torch.ones((4, 256), device=dev,
                                       dtype=torch.bfloat16), q)
    assert (x.grad.float() - ref.float()).abs().max() <= \
        1e-2 * ref.float().abs().max()


@pytest.mark.parametrize("need_dw", [True, False])
@pytest.mark.parametrize("d", [896, 1280, 3584, 4096])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gemma", [False, True])
def test_rms_norm_bwd_kernel_matches_plain(dev, dtype, gemma, d, need_dw):
    """K4 in both forms (dx alone, as the LoRA paths ask; dx with dW) at
    the main paths' widths (Qwen2.5-0.5B's 896, 1,280, Gemma-2's 3,584,
    Llama's 4,096): dx within 2 output ulps (the fp32 result differs in
    its last bits, then rounds); dW, an fp32 sum over 700 rows in another
    order, within 1e-3 of max|dW| (bf16: one bf16 ulp, 2^-7, of max|dW|);
    the same bits from a second call; one launch a call, and in the
    dx-only form no dW and one device operation (torch.profiler)."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((7, 100, d), generator=g, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(dtype)
    gy = torch.randn((7, 100, d), generator=g, device=dev).to(dtype)
    before = rms_norm_bwd.launches
    dx, dw = rms_norm_bwd(x, w, gy, 1e-5, gemma, need_dw=need_dw)
    dx2, dw2 = rms_norm_bwd(x, w, gy, 1e-5, gemma, need_dw=need_dw)
    rdx, rdw = rms_norm_bwd_ref(x, w, gy, 1e-5, gemma)
    torch.cuda.synchronize()
    assert rms_norm_bwd.launches == before + 2
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    assert ((dx.float() - rdx.float()).abs()
            <= 2 * ulp * rdx.float().abs() + 1e-5).all()
    assert torch.equal(dx, dx2)
    if need_dw:
        assert dw.dtype == w.dtype and torch.equal(dw, dw2)
        tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-3
        assert (dw.float() - rdw.float()).abs().max() <= \
            tol * rdw.float().abs().max()
    else:
        assert dw is None and dw2 is None
        ops = launched_kernels(
            lambda: rms_norm_bwd(x, w, gy, 1e-5, gemma, need_dw=False),
            tries=6)
        assert len(ops) == 1, ops


def _segments(t, lo, hi, seed):
    rng = torch.Generator().manual_seed(seed)
    seg = torch.zeros((1, t), dtype=torch.int32)
    pos, sid = 0, 1
    while pos < t - 100:
        n = int(torch.randint(lo, hi + 1, (1,), generator=rng))
        n = min(n, t - 100 - pos)
        seg[0, pos:pos + n] = sid
        pos += n
        sid += 1
    return seg   # the last 100 tokens are a pad tail (id 0)


@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 128), (4, 4, 256)])
def test_packed_attention_kernels_match_plain(dev, hq, hkv, d):
    """Forward (out, lse: K16's Hopper forward on q * bf16(scale)) and
    backward (dq, dk, dv: K18's dq and dk/dv at bf16(scale), fed that
    forward's out and lse) against the plain per-segment fp32 versions on
    the same bf16 inputs and the same saved (out, lse), at real positions:
    out/dq/dk/dv row by row (``chip_smoke.attn_row_err``: each element
    within 2^-6 of its value plus 2^-4 of its (token, head) row's rms;
    bf16 P and dS, bf16 outputs), lse within 1e-3. The forward counts as
    K9's launch, not K16's, the backward as K10/K11's, not splash's; the
    tile-pair classes of each kernel are the rule's
    (``chip_smoke.flash_tile_counts`` at that kernel's tiles)."""
    t, max_len = 1024, 300
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v, dout = (torch.randn((1, t, h, d), generator=g, device=dev)
                     .to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
    seg = _segments(t, 40, max_len, seed=5).to(dev)
    scale = d ** -0.5
    lo, hi = tfa.tile_segment_ranges(seg)
    fns = (tpa.packed_attention_fwd, tpa.packed_attention_bwd,
           tfa.flash_attention_fwd, tsa.splash_attention_dq,
           tsa.splash_attention_dkv)
    before = [f.launches for f in fns]
    classes = {w: torch.zeros(3, dtype=torch.int32, device=dev)
               for w in ("fwd", "dq", "dkv")}
    out, lse = tpa.packed_attention_fwd(q, k, v, seg, scale=scale,
                                        tile_classes=classes["fwd"])
    dq, dk, dv = tpa.packed_attention_bwd(
        q, k, v, seg, lo, hi, out, lse, dout, scale=scale,
        tile_classes=(classes["dq"], classes["dkv"]))
    rout, rlse = tpa.packed_attention_fwd_ref(q, k, v, seg, scale)
    rdq, rdk, rdv = tpa.packed_attention_bwd_ref(q, k, v, seg, out, lse,
                                                 dout, scale)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fns, before)] == [1, 1, 0, 0, 0]
    for w, c in classes.items():
        assert [x // hq for x in c.tolist()] == flash_tile_counts(
            seg.cpu(), True, *tfa.KERNEL_TILES[w][d], kernel=w), w
    real = (seg[0] != 0)
    assert ((lse - rlse)[..., real]).abs().max() <= 1e-3
    for got, ref in ((out, rout), (dq, rdq), (dk, rdk), (dv, rdv)):
        got, ref = got[:, real].float(), ref[:, real].float()
        assert torch.isfinite(got).all()
        assert attn_row_err(got, ref) <= ATTN_ROW_TOL


def test_attention_dispatch_on_cuda(dev):
    """With a declared bound the packed kernels run; without one the flash
    kernels over the whole causal range (K16) run."""
    from unsloth_tpu_torch.ops.attention import attention, packed_segment_bound

    q = torch.randn((1, 256, 4, 128), device=dev, dtype=torch.bfloat16)
    k = torch.randn((1, 256, 2, 128), device=dev, dtype=torch.bfloat16)
    seg = _segments(356, 20, 60, seed=6)[:, :256].to(dev)
    before = (tpa.packed_attention_fwd.launches, tfa.flash_attention_fwd.launches)
    with packed_segment_bound(60):
        out = attention(q, k, k, segment_ids=seg)
    assert tpa.packed_attention_fwd.launches == before[0] + 1
    assert out.shape == q.shape
    out2 = attention(q, k, k, segment_ids=seg)
    assert tfa.flash_attention_fwd.launches == before[1] + 1
    real = seg[0] != 0   # the packed kernels leave pad outputs unspecified
    assert attn_row_err(out2[:, real], out[:, real]) <= ATTN_ROW_TOL


# ---------------------------------------------------------------------------
# SFT without packing: full-logits CE (K7/K8), unpacked flash (K16)
# ---------------------------------------------------------------------------

from unsloth_tpu_torch.ops import cross_entropy as tce  # noqa: E402
from unsloth_tpu_torch.ops import flash_attention as tfa  # noqa: E402


@pytest.mark.parametrize("n,v,dtype", [(300, 2500, torch.bfloat16),
                                       (257, 4099, torch.float32),
                                       (64, 128256, torch.bfloat16)])
@pytest.mark.parametrize("softcap,scale", [(None, None), (30.0, 0.5)])
def test_cross_entropy_kernels_match_plain(dev, n, v, dtype, softcap, scale):
    """K7 (loss, lse) and K8 (dlogits) against the plain twins on the same
    inputs, a ragged V (not a multiple of 8, which the vectorized loop
    masks) among them, 30% ignored rows. loss/lse within 1e-4 relative (fp32
    sums in another order); dlogits within 2 ulps of its dtype plus 1e-6
    of the largest value (fp32 math in another order, one rounding)."""
    g = torch.Generator(device=dev).manual_seed(7)
    logits = (torch.randn((n, v), generator=g, device=dev) * 4).to(dtype)
    labels = torch.randint(0, v, (n,), generator=g, device=dev)
    labels[torch.rand(n, generator=g, device=dev) < 0.3] = -100
    gr = torch.rand(n, generator=g, device=dev)
    before = (tce.cross_entropy_fwd.launches, tce.cross_entropy_bwd.launches)
    loss, lse = tce.cross_entropy_fwd(logits, labels, softcap, scale)
    dx = tce.cross_entropy_bwd(logits, labels, lse, gr, softcap, scale)
    rloss, rlse = tce.cross_entropy_ref(logits, labels, softcap, scale)
    rdx = tce.cross_entropy_bwd_ref(logits, labels, lse, gr, softcap, scale)
    torch.cuda.synchronize()
    assert (tce.cross_entropy_fwd.launches,
            tce.cross_entropy_bwd.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(loss, rloss, rtol=1e-4, atol=1e-4)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    assert dx.dtype == dtype
    assert ((dx.float() - rdx.float()).abs() <= 2 * ulp * rdx.float().abs()
            + 1e-6 * rdx.float().abs().max()).all()


@pytest.mark.parametrize("seg_kind", ["padded", "interleaved"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,d,hq,hkv", [
    (256, 128, 8, 2), (200, 128, 8, 2),
    (320, 128, 8, 2),     # T past the last 128-token tile
    (200, 64, 14, 2),     # Qwen2.5-0.5B's heads: 7 query heads a kv head
    (2048, 64, 14, 2),    # ... at T = 2,048: dk/dv splits each group
    (256, 64, 32, 8),     # Llama-3.2-1B's
    (200, 256, 4, 4),     # Gemma-1's head dim, no GQA
    (256, 256, 8, 2),
])
def test_flash_attention_kernels_match_plain(dev, t, d, hq, hkv, causal,
                                             seg_kind):
    """K16 forward (out, lse) and backward (dq, dk, dv) against the plain
    fp32 twins on the same bf16 inputs at head dims 64, 128 and 256, causal
    and not: one full row and one padded row (pad queries included), or
    interleaved segment ids (an id that recurs after another), ragged Ts
    among them: every position row by row (``chip_smoke.attn_row_err``:
    each element within 2^-6 of its value plus 2^-4 of its (token, head)
    row's rms; the kernels round P and dS to bf16), lse within 1e-3; the
    backward pair gets the kernel forward's (out, lse), and run again it
    gives the same bits. The tile pairs each kernel classed (its counters)
    are the rule's at its tiles (``chip_smoke.flash_tile_counts``)."""
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v, dout = (torch.randn((2, t, h, d), generator=g, device=dev)
                     .to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
    seg = torch.ones((2, t), dtype=torch.int32, device=dev)
    if seg_kind == "padded":
        seg[1, t - 70:] = 0
    else:
        seg[0, ::3] = 2
        seg[1, t // 3:2 * t // 3] = 3
    lo, hi = tfa.tile_segment_ranges(seg)
    scale = d ** -0.5
    sfx = "" if causal else "_full"
    fns = [getattr(tfa, f"flash_attention_{w}{sfx}")
           for w in ("fwd", "dq", "dkv")]
    before = [f.launches for f in fns]
    out, lse = fns[0](q, k, v, seg, lo, hi, scale=scale)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, seg, lo, hi, out, lse, dout,
                                         scale=scale, causal=causal)
    rout, rlse = tfa.flash_attention_fwd_ref(q, k, v, seg, scale, causal)
    rdq, rdk, rdv = tfa.flash_attention_bwd_ref(q, k, v, seg, out, lse, dout,
                                                scale, causal)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [x + 1 for x in before]
    assert (lse - rlse).abs().max() <= 1e-3
    for got, ref in ((out, rout), (dq, rdq), (dk, rdk), (dv, rdv)):
        assert torch.isfinite(got).all()
        assert attn_row_err(got, ref) <= ATTN_ROW_TOL
    again = tfa.flash_attention_bwd(q, k, v, seg, lo, hi, out, lse, dout,
                                    scale=scale, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
    got = kernel_tile_classes(q, k, v, seg, dout, scale, causal)
    assert got == {w: flash_tile_counts(seg, causal, *tfa.KERNEL_TILES[w][d])
                   for w in got}


def test_flash_attention_refuses_other_head_dims(dev):
    q = torch.zeros((1, 64, 2, 96), device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head_dim 64 or 128 or 256"):
        tfa.flash_attention(q, q, q)


# ---------------------------------------------------------------------------
# Gemma-2 training: splash attention (K18), and K1/K3/K7 at Gemma-2 shapes
# ---------------------------------------------------------------------------

from unsloth_tpu_torch.ops import splash_attention as tsa  # noqa: E402


def _splash_segments(t, dev):
    """Row 0 padded (1 real, 0 pad from token 230), row 1 packed: segments
    of 37, 150 and the rest."""
    seg = torch.ones((2, t), dtype=torch.int32)
    seg[0, 230:] = 0
    seg[1, 37:187] = 2
    seg[1, 187:] = 3
    return seg.to(dev)


@pytest.mark.parametrize("d,hq,hkv,window,softcap,scale", [
    (256, 4, 2, None, None, 256 ** -0.5),
    (256, 4, 2, 64, 50.0, 256 ** -0.5),
    (256, 8, 4, None, 50.0, 256 ** -0.5),
    (256, 4, 2, 1000, 50.0, 256 ** -0.5),   # a window past T
    (128, 8, 2, 100, None, 128 ** -0.5),
    (128, 4, 2, 64, 50.0, 144 ** -0.5),
    (128, 4, 2, 128, 30.0, 144 ** -0.5),    # a window of one kv tile
    (64, 16, 2, 128, None, 0.125),     # gpt-oss's sliding layers' form
    (64, 8, 1, 64, 50.0, 0.125),
    (64, 14, 2, None, 30.0, 0.125),
    (64, 8, 2, 2, 50.0, 0.125),        # a window of two tokens
])
def test_splash_attention_kernels_match_plain(dev, d, hq, hkv, window,
                                              softcap, scale):
    """K18 forward (out, lse), dq and dk/dv against the plain fp32 versions
    on the same bf16 inputs at head dims 64, 128 and 256, a padded and a
    packed row at a ragged T = 300, with and without a window (64, 100 and
    128 tokens: it bites; two tokens, and past T) and the softcap:
    every position row by row (``chip_smoke.attn_row_err``; the kernels
    round P and dS to bf16), lse within 1e-3; the backward pair gets the
    kernel forward's (out, lse), and the three run again give the same
    bits. The tile pairs each kernel classed (its counters) are the rule's
    at its tiles (``chip_smoke.flash_tile_counts`` with the window)."""
    t = 300
    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v, dout = (torch.randn((2, t, h, d), generator=g, device=dev)
                     .to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
    seg = _splash_segments(t, dev)
    lo, hi = tfa.tile_segment_ranges(seg)
    opts = dict(window=window, softcap=softcap, scale=scale)
    before = (tsa.splash_attention_fwd.launches,
              tsa.splash_attention_dq.launches,
              tsa.splash_attention_dkv.launches)
    out, lse = tsa.splash_attention_fwd(q, k, v, seg, lo, hi, **opts)
    dq, di = tsa.splash_attention_dq(q, k, v, seg, lo, hi, out, lse, dout,
                                     **opts)
    dk, dv = tsa.splash_attention_dkv(q, k, v, seg, lo, hi, lse, di, dout,
                                      **opts)
    rout, rlse = tsa.splash_attention_fwd_ref(q, k, v, seg, **opts)
    rdq, rdk, rdv = tsa.splash_attention_bwd_ref(q, k, v, seg, out, lse,
                                                 dout, **opts)
    torch.cuda.synchronize()
    assert (tsa.splash_attention_fwd.launches,
            tsa.splash_attention_dq.launches,
            tsa.splash_attention_dkv.launches) == tuple(x + 1 for x in before)
    assert (lse - rlse).abs().max() <= 1e-3
    for got, ref in ((out, rout), (dq, rdq), (dk, rdk), (dv, rdv)):
        assert torch.isfinite(got).all()
        assert attn_row_err(got, ref) <= ATTN_ROW_TOL
    out2, lse2 = tsa.splash_attention_fwd(q, k, v, seg, lo, hi, **opts)
    dq2, di2 = tsa.splash_attention_dq(q, k, v, seg, lo, hi, out, lse, dout,
                                       **opts)
    dk2, dv2 = tsa.splash_attention_dkv(q, k, v, seg, lo, hi, lse, di, dout,
                                        **opts)
    assert all(torch.equal(a, b) for a, b in zip(
        (out, lse, dq, di, dk, dv), (out2, lse2, dq2, di2, dk2, dv2)))
    got = kernel_tile_classes(q, k, v, seg, dout, scale, True,
                              splash=dict(opts, prefix_layout=None))
    assert got == {w: flash_tile_counts(seg, True, *tfa.KERNEL_TILES[w][d],
                                        window=window, kernel=w)
                   for w in got}


def test_attention_dispatch_reaches_splash_on_cuda(dev):
    """A window or a softcap sends causal attention to K18, under a declared
    segment bound too; its gradients come from the dq and dk/dv kernels."""
    from unsloth_tpu_torch.ops.attention import attention, packed_segment_bound

    q = torch.randn((2, 128, 4, 256), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn((2, 128, 2, 256), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    seg = _splash_segments(128, dev)
    before = (tsa.splash_attention_fwd.launches,
              tsa.splash_attention_dq.launches,
              tsa.splash_attention_dkv.launches)
    with packed_segment_bound(128):
        out = attention(q, k, k, segment_ids=seg, window=32, softcap=50.0,
                        scale=0.0625)
    out.float().sum().backward()
    assert (tsa.splash_attention_fwd.launches,
            tsa.splash_attention_dq.launches,
            tsa.splash_attention_dkv.launches) == tuple(x + 1 for x in before)
    assert q.grad.shape == q.shape and torch.isfinite(k.grad).all()


def test_splash_attention_refuses_other_head_dims(dev):
    q = torch.zeros((1, 64, 2, 96), device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head_dim"):
        tsa.splash_attention(q, q, q, window=16)


def test_gemma2_shapes_nf4_rms_norm_ce(dev):
    """K1 at Gemma-2-9B's q projection (N 4096, K 3584), K3 with gemma=True
    at hidden 3584, K7 over the 256,000-token vocabulary with softcap 30,
    each against its plain version with the tolerances above."""
    g = torch.Generator(device=dev).manual_seed(10)
    q = quantize_nf4(torch.randn((4096, 3584), generator=g, device=dev) * 0.02)
    x = torch.randn((64, 3584), generator=g, device=dev).to(torch.bfloat16)
    y = nf4_matmul(x, q)
    ref = torch.matmul(x, dequantize_nf4(q, torch.bfloat16).t())
    assert (y.float() - ref.float()).abs().max() <= \
        1e-2 * ref.float().abs().max()
    w = (0.1 * torch.randn(3584, generator=g, device=dev)).to(torch.bfloat16)
    y = rms_norm(x, w, 1e-6, True)
    ref = rms_norm_ref(x, w, 1e-6, True)
    assert ((y.float() - ref.float()).abs()
            <= 2.0 ** -7 * ref.float().abs() + 1e-6).all()
    logits = (torch.randn((64, 256000), generator=g, device=dev) * 4
              ).to(torch.bfloat16)
    labels = torch.randint(0, 256000, (64,), generator=g, device=dev)
    loss, lse = tce.cross_entropy_fwd(logits, labels, 30.0)
    rloss, rlse = tce.cross_entropy_ref(logits, labels, 30.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(loss, rloss, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the MoE slice's kernels: K1/K2 at gpt-oss's widths, K14/K15, K17
# ---------------------------------------------------------------------------

from unsloth_tpu_torch.ops import flash_sinks as tfs  # noqa: E402
from unsloth_tpu_torch.ops import nf4_gmm as tng  # noqa: E402
from unsloth_tpu_torch.ops.nf4 import quantize_nf4_stacked  # noqa: E402


@pytest.mark.parametrize("m,n,k", [(5, 4096, 2880), (300, 512, 2880),
                                   (70, 2880, 4096), (260, 320, 2880)])
def test_nf4_kernels_at_gpt_oss_widths(dev, m, n, k):
    """K1 and K2 where in/2 is a multiple of 32 but not of 64 (gpt-oss's
    q/k/v: in = 2,880, so a 64-block straddles the split-half boundary),
    and at its o projection: within 1e-2 of max|ref| as above."""
    g = torch.Generator(device=dev).manual_seed(11)
    q = quantize_nf4(torch.randn((n, k), generator=g, device=dev) * 0.05)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    y = nf4_matmul(x, q)
    ref = torch.matmul(x, dequantize_nf4(q, torch.bfloat16).t())
    gr = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
    dx = nf4_matmul_dx(gr, q)
    rdx = nf4_matmul_dx_ref(gr, q)
    torch.cuda.synchronize()
    for got, want in ((y, ref), (dx, rdx)):
        assert torch.isfinite(got).all()
        assert (got.float() - want.float()).abs().max() <= \
            1e-2 * want.float().abs().max()


def _group_sizes(kind, e, m, g, dev):
    """Group sizes [E] int32 summing to m: "random" (a real top-k routing's
    spread), "skewed" (one expert half the rows, several none)."""
    if kind == "skewed":
        sizes = torch.zeros(e, dtype=torch.int64)
        sizes[3] = m // 2
        rest = m - m // 2
        live = [0, 5, e - 1]
        for i, ex in enumerate(live):
            sizes[ex] = rest // len(live) + (1 if i < rest % len(live) else 0)
        return sizes.to(torch.int32).to(dev)
    ids = torch.randint(0, e, (m,), generator=g, device=dev)
    return torch.bincount(ids, minlength=e).to(torch.int32)


@pytest.mark.parametrize("e,n,k,bs,m,kind", [
    (8, 2880, 2880, 32, 700, "random"),     # gpt-oss widths, block 32
    (8, 768, 2048, 64, 513, "random"),      # qwen3-moe's, block 64
    (16, 320, 192, 32, 900, "skewed"),
    (32, 2880, 2880, 32, 8, "random"),      # decode rows
])
def test_nf4_gmm_kernels_match_plain(dev, e, n, k, bs, m, kind):
    """K14 (with and without the bias epilogue) and K15 against
    nf4_gmm_ref on the same bf16 inputs: within 1e-2 of max|ref| (the
    kernels round each weight to bf16, the plain version keeps fp32, both
    sum in fp32), every row; the backward of nf4_gmm launches K15."""
    g = torch.Generator(device=dev).manual_seed(12)
    q = quantize_nf4_stacked(
        torch.randn((e, n, k), generator=g, device=dev) * 0.05, bs)
    sizes = _group_sizes(kind, e, m, g, dev)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    bias = torch.randn((e, n), generator=g, device=dev).to(torch.bfloat16)
    gy = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
    before = (tng.nf4_gmm.launches, tng.nf4_gmm_dx.launches)
    outs = [tng.nf4_gmm(x, q, sizes), tng.nf4_gmm(x, q, sizes, bias=bias),
            tng.nf4_gmm_dx(gy, q, sizes)]
    refs = [tng.nf4_gmm_ref(x, q, sizes), tng.nf4_gmm_ref(x, q, sizes, bias),
            tng.nf4_gmm_ref(gy, q, sizes, transpose=True)]
    torch.cuda.synchronize()
    assert (tng.nf4_gmm.launches, tng.nf4_gmm_dx.launches) == \
        (before[0] + 2, before[1] + 1)
    for got, ref in zip(outs, refs):
        assert torch.isfinite(got).all() and got.dtype == torch.bfloat16
        assert (got.float() - ref.float()).abs().max() <= \
            1e-2 * ref.float().abs().max()
    xr = x.clone().requires_grad_(True)
    tng.nf4_gmm(xr, q, sizes, bias=bias).backward(gy)
    assert tng.nf4_gmm_dx.launches == before[1] + 2
    assert (xr.grad.float() - refs[2].float()).abs().max() <= \
        1e-2 * refs[2].float().abs().max()


@pytest.mark.parametrize("e,n,k,bs,sizes,extra", [
    (4, 320, 2880, 32, [0, 17, 0, 0], 0),           # 17 rows: one tile
    (4, 320, 2880, 32, [40, 0, 70, 9], 5),          # 124 rows: 128-row tiles
    (5, 320, 2880, 32, [150, 0, 400, 37, 90], 40),  # a group over tiles,
                                                    # an empty group, rows
                                                    # past N and past groups
    (4, 768, 2048, 64, [300, 0, 513, 200], 0),      # qwen3-moe's widths, B 64
    (3, 136, 512, 64, [129, 0, 260], 7)])           # N % 128 == 8
def test_nf4_gmm_hopper_tiles_match_the_schedule(dev, e, n, k, bs, sizes,
                                                 extra):
    """K14 above 16 rows on K1's Hopper kernel under the grouped schedule,
    at both row tiles (128 up to 128 rows, else 256): y with the bias
    within ATTN_ROW_TOL of nf4_gmm_ref row by row (each group's rows from
    its own tiles: a tile that stored past its group's end would leave the
    next group's rows wrong), the rows past the groups zero over memory
    the wrapper leaves uninitialised, and the tile counters equal to the
    schedule's twin (tiles, stages, tiles stored by masked stores)."""
    g = torch.Generator(device=dev).manual_seed(24)
    q = quantize_nf4_stacked(
        torch.randn((e, n, k), generator=g, device=dev) * 0.05, bs)
    m = sum(sizes) + extra
    sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    bias = torch.randn((e, n), generator=g, device=dev)
    counts = torch.zeros(3, dtype=torch.int32, device=dev)
    # NaN in the block the caching allocator hands y next
    torch.full((m, n), float("nan"), dtype=torch.bfloat16, device=dev)
    y = tng.nf4_gmm_fwd(x, q, sz, bias, tile_counts=counts)
    ref = tng.nf4_gmm_ref(x, q, sz, bias)
    torch.cuda.synchronize()
    assert counts.tolist() == tng.nf4_gmm_tile_counts(sizes, m, n, k)
    assert torch.isfinite(y).all()
    assert attn_row_err(y, ref) <= ATTN_ROW_TOL
    assert bool((y[sum(sizes):] == 0).all())


@pytest.mark.parametrize("e,n,k,bs,sizes,extra", [
    (4, 320, 2880, 32, [0, 5, 0, 3], 0),            # 8 decode rows
    (4, 320, 2880, 32, [40, 0, 70, 9], 5),          # 124 rows: 128-row tiles
    (5, 320, 2880, 32, [150, 0, 400, 37, 90], 40),  # a group over tiles,
                                                    # an empty group, rows
                                                    # past the groups
    (4, 768, 2048, 64, [300, 0, 513, 200], 0),      # qwen3-moe's widths, B 64
    (3, 136, 512, 64, [129, 0, 260], 7)])           # N % 64 == 8
def test_nf4_gmm_dx_hopper_tiles_match_the_twin(dev, e, n, k, bs, sizes,
                                                extra):
    """K15 at every row count on K2's Hopper kernel under the grouped
    schedule, at both row tiles (128 up to 128 rows, else 256): dx within
    one bf16 ulp (plus 2^-20 of the largest) of its walk's twin
    nf4_gmm_dx_tiles_ref on the same inputs (the same bf16 weights, fp32
    sums in another order, one rounding), within ATTN_ROW_TOL of
    nf4_gmm_ref row by row, the rows past the groups zero over memory the
    wrapper leaves uninitialised, and the tile counters equal to
    nf4_gmm_dx_tile_counts (tiles, stages, tiles stored by masked
    stores)."""
    g = torch.Generator(device=dev).manual_seed(25)
    q = quantize_nf4_stacked(
        torch.randn((e, n, k), generator=g, device=dev) * 0.05, bs)
    m = sum(sizes) + extra
    sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
    gy = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
    counts = torch.zeros(3, dtype=torch.int32, device=dev)
    # NaN in the block the caching allocator hands dx next
    torch.full((m, k), float("nan"), dtype=torch.bfloat16, device=dev)
    before = tng.nf4_gmm_dx.launches
    dx = tng.nf4_gmm_dx(gy, q, sz, tile_counts=counts)
    ref = tng.nf4_gmm_ref(gy, q, sz, transpose=True)
    torch.cuda.synchronize()
    assert tng.nf4_gmm_dx.launches == before + 1
    assert counts.tolist() == tng.nf4_gmm_dx_tile_counts(sizes, m, n, k)
    assert torch.isfinite(dx).all()
    twin, _ = tng.nf4_gmm_dx_tiles_ref(gy.cpu(), q.to("cpu"), sizes)
    got, want = dx.cpu().float(), twin.float()
    ulp = torch.from_numpy(np.spacing(want.abs().numpy())) * 2.0 ** 16
    assert bool(((got - want).abs()
                 <= ulp + 2.0 ** -20 * want.abs().max()).all())
    assert attn_row_err(dx, ref) <= ATTN_ROW_TOL
    assert bool((dx[sum(sizes):] == 0).all())


@pytest.mark.parametrize("kernel", ["nf4", "bf16"])
@pytest.mark.parametrize("e,n,k,bs,sizes,extra", [
    (8, 200, 2880, 32, [0, 0, 1, 0, 0, 0, 0, 0], 0),        # one row: S > 1
    (8, 200, 2880, 32, [0, 3, 0, 0, 0, 0, 1, 0], 0),        # 4 rows, 2 experts
    (32, 2880, 2880, 32, [0] * 5 + [1, 2] + [0] * 20 + [1, 1, 1, 1, 1],
     0),                                                    # gpt-oss, 8 rows
    (32, 2880, 2880, 32, [3, 0, 0, 5] + [0] * 12 + [4] + [0] * 14 + [4],
     0),                                                    # skewed, 16 rows
    (8, 136, 512, 64, [2, 0, 9, 0, 0, 1, 0, 1], 3)])        # B 64, rows past
def test_grouped_decode_kernels_match_their_twins(dev, fp32_reductions,
                                                   kernel, e, n, k, bs,
                                                   sizes, extra):
    """K14's and K19's forwards at 16 rows or fewer (csrc/decode_matmul.cu's
    grouped form): within ``chip_smoke.decode_twin_within`` of their
    walk's twin on the CPU (one bf16 ulp plus 2^-20 of the largest; K19 an
    ulp of its product more, for its second rounding), within
    ATTN_ROW_TOL of the plain version row by row, the rows past the groups
    zero over NaN-filled memory, the counters equal to the schedule's
    (units, 16-byte chunks, empty slots), a second run the same bits, one
    kernel a call (``chip_smoke.launched_kernels``), one launch counted
    under the decode form's name and the kernel's."""
    from unsloth_tpu_torch.ops import gmm as tgmm_
    from unsloth_tpu_torch.ops.qlora_matmul import grouped_decode_schedule

    g = torch.Generator(device=dev).manual_seed(33)
    m = sum(sizes) + extra
    sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    bias = torch.randn((e, n), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((e, n, k), generator=g, device=dev) * 0.05
         ).to(torch.bfloat16)
    if kernel == "nf4":
        q = quantize_nf4_stacked(w, bs)
        fwd, dec, whole = tng.nf4_gmm_fwd, tng.nf4_gmm_decode, tng.nf4_gmm

        def call(counts=None):
            return fwd(x, q, sz, bias, tile_counts=counts)

        ref = tng.nf4_gmm_ref(x, q, sz, bias)
        twin, _ = tng.nf4_gmm_decode_tiles_ref(x.cpu(), q.to("cpu"), sizes,
                                               bias.cpu())
        product = None
    else:
        fwd, dec, whole = tgmm_.gmm_fwd, tgmm_.gmm_decode, tgmm_.gmm

        def call(counts=None):
            return fwd(x, w, sz, bias, unit_counts=counts)

        ref = tgmm_.gmm_ref(x, w, sz, bias)
        twin, _ = tgmm_.gmm_decode_tiles_ref(x.cpu(), w.cpu(), sizes,
                                             bias.cpu())
        product, _ = tgmm_.gmm_decode_tiles_ref(x.cpu(), w.cpu(), sizes)
    counts = torch.zeros(3, dtype=torch.int32, device=dev)
    # NaN in the block the caching allocator hands y next
    torch.full((m, n), float("nan"), dtype=torch.bfloat16, device=dev)
    before = (whole.launches, dec.launches)
    y = call(counts)
    again = call()
    assert (whole.launches, dec.launches) == (before[0] + 2, before[1] + 2)
    launched = launched_kernels(call)
    assert len(launched) == 1 and "grouped_decode_kernel" in launched[0]
    plan = grouped_decode_schedule(m, e, n, k, kernel)
    live = sum(1 for s_ in sizes if s_)
    assert counts.tolist() == plan.grouped_counts(n, live)
    assert torch.equal(y, again)
    assert torch.isfinite(y).all()
    assert bool((y[sum(sizes):] == 0).all())
    assert attn_row_err(y[:sum(sizes)], ref[:sum(sizes)]) <= ATTN_ROW_TOL
    assert decode_twin_within(y, twin, product)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("t,hq,hkv", [(300, 8, 1), (256, 64, 8)])
def test_flash_sinks_kernels_match_plain(dev, t, hq, hkv, d):
    """K17 forward (out, lse'), dq and dk/dv at head dim 64 (gpt-oss), 128
    and 256 with GQA (8 query heads a kv head) against the plain fp32
    versions on the same bf16 inputs, a padded and a packed row: every
    position row by row (``chip_smoke.attn_row_err``), lse' within 1e-3,
    dsinks within 1e-2 of its largest value (a sum over tokens of the
    kernels' di)."""
    g = torch.Generator(device=dev).manual_seed(13)
    q, k, v, dout = (torch.randn((2, t, h, d), generator=g, device=dev)
                     .to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
    sinks = torch.randn((hq,), generator=g, device=dev) * 2
    seg = _splash_segments(t, dev)
    lo, hi = tfa.tile_segment_ranges(seg)
    scale = 0.125
    before = (tfs.flash_sinks_fwd.launches, tfs.flash_sinks_dq.launches,
              tfs.flash_sinks_dkv.launches)
    out, lse = tfs.flash_sinks_fwd(q, k, v, seg, lo, hi, sinks, scale=scale)
    dq, di = tfs.flash_sinks_dq(q, k, v, seg, lo, hi, out, lse, dout,
                                scale=scale)
    dk, dv = tfs.flash_sinks_dkv(q, k, v, seg, lo, hi, lse, di, dout,
                                 scale=scale)
    dsk = tfs.sinks_grad(sinks, lse, di)
    rout, rlse = tfs.flash_sinks_fwd_ref(q, k, v, seg, sinks, scale)
    rdq, rdk, rdv, rdsk = tfs.flash_sinks_bwd_ref(q, k, v, seg, out, lse,
                                                  dout, sinks, scale)
    torch.cuda.synchronize()
    assert (tfs.flash_sinks_fwd.launches, tfs.flash_sinks_dq.launches,
            tfs.flash_sinks_dkv.launches) == tuple(x + 1 for x in before)
    assert (lse - rlse).abs().max() <= 1e-3
    for got, ref in ((out, rout), (dq, rdq), (dk, rdk), (dv, rdv)):
        assert torch.isfinite(got).all()
        assert attn_row_err(got, ref) <= ATTN_ROW_TOL
    assert (dsk - rdsk).abs().max() <= 1e-2 * rdsk.abs().max()


def test_attention_dispatch_with_sinks_on_cuda(dev):
    """Plain causal rows with sinks launch K17 (its gradient through dq and
    dk/dv); a narrow window takes the banded form, no kernel; a window that
    is not narrow (T = 384) takes K18 at head dim 64, then the chunked lse
    and the sink rescale, against the reference; plain causal rows at head
    dims 128 and 256 launch K17 and match the reference row by row; head
    dim 192, which no kernel is built for, raises naming K17."""
    from unsloth_tpu_torch.ops.attention import attention

    q = torch.randn((1, 512, 8, 64), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn((1, 512, 2, 64), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    sinks = torch.zeros(8, device=dev)
    before = (tfs.flash_sinks_fwd.launches, tfs.flash_sinks_dq.launches,
              tfs.flash_sinks_dkv.launches)
    attention(q, k, k, sinks=sinks).float().sum().backward()
    assert (tfs.flash_sinks_fwd.launches, tfs.flash_sinks_dq.launches,
            tfs.flash_sinks_dkv.launches) == tuple(x + 1 for x in before)
    banded = attention(q, k, k, sinks=sinks, window=128)
    assert tfs.flash_sinks_fwd.launches == before[0] + 1
    assert torch.isfinite(banded).all()
    from unsloth_tpu_torch.ops.attention import attention_ref
    q3, k3 = q[:, :384].detach(), k[:, :384].detach()
    sinks3 = torch.randn(8, device=dev)
    n_splash = tsa.splash_attention_fwd.launches
    got = attention(q3, k3, k3, sinks=sinks3, window=128)
    assert tsa.splash_attention_fwd.launches == n_splash + 1
    want = attention_ref(q3, k3, k3, window=128, sinks=sinks3)
    assert attn_row_err(got, want) <= ATTN_ROW_TOL
    g = torch.Generator(device=dev).manual_seed(17)
    for d in (128, 256):
        qd, kd, vd = (torch.randn((1, 200, h, d), generator=g, device=dev)
                      .to(torch.bfloat16) for h in (4, 2, 2))
        sd = torch.randn(4, generator=g, device=dev)
        n_sinks = tfs.flash_sinks_fwd.launches
        got = attention(qd, kd, vd, sinks=sd)
        assert tfs.flash_sinks_fwd.launches == n_sinks + 1
        assert attn_row_err(got, attention_ref(qd, kd, vd, sinks=sd)) <= \
            ATTN_ROW_TOL
    q192 = torch.zeros((1, 64, 2, 192), device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="K17"):
        attention(q192, q192, q192, sinks=torch.zeros(2, device=dev))


from unsloth_tpu_torch.ops import gmm as tgmm  # noqa: E402


@pytest.mark.parametrize("e,n,k,m,kind", [
    (32, 2880, 2880, 2048, "random"),   # gpt-oss widths: 22.5 x 128
    (8, 768, 2048, 513, "random"),      # qwen3-moe's; m not a tile multiple
    (16, 320, 200, 900, "skewed"),      # empty experts, K % 64 != 0
    (4, 136, 72, 300, "one"),           # every row routed to one expert
    (32, 2880, 2880, 8, "random"),      # decode rows
    (32, 2880, 2880, 16384, "random"),  # the gpt-oss path's rows
    (32, 2880, 2880, 16384, "skewed"),
])
def test_gmm_kernels_match_plain(dev, e, n, k, m, kind):
    """K19 forward (with and without the bias epilogue) and dx against
    gmm_ref on the same bf16 inputs: every row on its own scale
    (``chip_smoke.attn_row_err``; both round the same fp32 sums once, in
    another order) and max|d| within 1e-2 of max|ref|; the backward of gmm
    launches the dx kernel; f32 and a strided W raise."""
    g = torch.Generator(device=dev).manual_seed(19)
    w = (torch.randn((e, n, k), generator=g, device=dev) * 0.05
         ).to(torch.bfloat16)
    if kind == "one":
        sizes = torch.zeros(e, dtype=torch.int32, device=dev)
        sizes[e - 1] = m
    else:
        sizes = _group_sizes(kind, e, m, g, dev)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    bias = torch.randn((e, n), generator=g, device=dev).to(torch.bfloat16)
    gy = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
    before = (tgmm.gmm.launches, tgmm.gmm_dx.launches)
    outs = [tgmm.gmm(x, w, sizes), tgmm.gmm(x, w, sizes, bias),
            tgmm.gmm_dx(gy, w, sizes)]
    refs = [tgmm.gmm_ref(x, w, sizes), tgmm.gmm_ref(x, w, sizes, bias),
            tgmm.gmm_ref(gy, w, sizes, transpose=True)]
    torch.cuda.synchronize()
    assert (tgmm.gmm.launches, tgmm.gmm_dx.launches) == \
        (before[0] + 2, before[1] + 1)
    for got, ref in zip(outs, refs):
        assert torch.isfinite(got).all() and got.dtype == torch.bfloat16
        assert attn_row_err(got, ref) <= ATTN_ROW_TOL
        assert (got.float() - ref.float()).abs().max() <= \
            1e-2 * ref.float().abs().max()
    xr = x.clone().requires_grad_(True)
    tgmm.gmm(xr, w, sizes, bias).backward(gy)
    assert tgmm.gmm_dx.launches == before[1] + 2
    assert attn_row_err(xr.grad, refs[2]) <= ATTN_ROW_TOL
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tgmm.gmm(x.float(), w, sizes)
    with pytest.raises(ValueError, match="contiguous"):
        tgmm.gmm(x, w.transpose(1, 2).contiguous().transpose(1, 2), sizes)


@pytest.mark.parametrize("e,n,k,m,kind", [
    (32, 2880, 2880, 2048, "random"),   # gpt-oss widths
    (8, 768, 2048, 513, "random"),      # qwen3-moe's; m not a chunk multiple
    (16, 200, 136, 900, "skewed"),      # N, K % 64 != 0; empty experts
    (4, 136, 72, 300, "one"),           # every row routed to one expert
    (32, 2880, 2880, 16384, "random"),  # the gpt-oss path's rows
    (32, 2880, 2880, 16384, "skewed"),
])
def test_tgmm_kernel_matches_plain(dev, fp32_reductions, e, n, k, m, kind):
    """K19's tgmm against tgmm_ref on the same bf16 inputs: every element
    within MM_ULPS (chip_smoke.mm_ulps: the same products, fp32 sums in
    another order, one rounding); empty experts written as zeros over
    memory filled with NaN first; the check rejects each fault of
    chip_smoke.tgmm_faults; the backward of gmm with trainable W and bias
    launches tgmm (and dx) once and gives db = group_sum."""
    from chip_smoke import tgmm_faults

    g = torch.Generator(device=dev).manual_seed(23)
    if kind == "one":
        sizes = torch.zeros(e, dtype=torch.int32, device=dev)
        sizes[e - 1] = m
    else:
        sizes = _group_sizes(kind, e, m, g, dev)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    gy = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
    nan = torch.full((e, n, k), float("nan"), dtype=torch.bfloat16,
                     device=dev)
    del nan
    before = tgmm.tgmm.launches
    got = tgmm.tgmm(x, gy, sizes)
    ref = tgmm.tgmm_ref(x, gy, sizes)
    torch.cuda.synchronize()
    assert tgmm.tgmm.launches == before + 1
    assert got.shape == (e, n, k) and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    assert mm_ulps(got, ref) <= MM_ULPS
    for i in (sizes == 0).nonzero().flatten().tolist():
        assert (got[i] == 0).all()
    for fault, wrong in tgmm_faults(x, gy, sizes).items():
        assert not mm_ulps(wrong, ref) <= MM_ULPS, fault
    w = (torch.randn((e, n, k), generator=g, device=dev) * 0.05
         ).to(torch.bfloat16).requires_grad_(True)
    bias = torch.randn((e, n), generator=g, device=dev).to(
        torch.bfloat16).requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    before = (tgmm.gmm_dx.launches, tgmm.tgmm.launches)
    tgmm.gmm(xr, w, sizes, bias).backward(gy)
    torch.cuda.synchronize()
    assert (tgmm.gmm_dx.launches, tgmm.tgmm.launches) == \
        (before[0] + 1, before[1] + 1)
    assert mm_ulps(w.grad, ref) <= MM_ULPS
    assert mm_ulps(bias.grad, tgmm.group_sum(gy, sizes, torch.bfloat16)) \
        <= MM_ULPS
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tgmm.tgmm(x.float(), gy, sizes)


@pytest.mark.parametrize("e,n,k,m,kind", [
    (32, 2880, 2880, 16384, "random"),  # the gpt-oss path's rows
    (32, 2880, 2880, 16384, "skewed"),
    (16, 320, 200, 900, "skewed"),      # empty experts, ragged N and K
    (4, 136, 72, 300, "one"),           # one expert, rows past 256
    (8, 768, 2048, 513, "short"),       # rows past the groups
])
def test_gmm_work_units_match_the_schedule(dev, e, n, k, m, kind):
    """K19's forward, dx and tgmm kernels report, through their
    ``unit_counts``, the work units of the schedule's twin
    (chip_smoke.gmm_unit_counts, tgmm_unit_counts); a rerun gives the same
    bits; rows past the groups come back zero from memory the kernel got
    uninitialised (filled with NaN first); the row-wise check rejects a
    straddling tile's rows stored by the next expert's visit."""
    from chip_smoke import (gmm_straddle_faults, gmm_unit_counts,
                            tgmm_unit_counts)

    g = torch.Generator(device=dev).manual_seed(29)
    if kind == "one":
        sizes = torch.zeros(e, dtype=torch.int32, device=dev)
        sizes[e - 1] = m
    elif kind == "short":
        sizes = _group_sizes("random", e, m - 100, g, dev)
    else:
        sizes = _group_sizes(kind, e, m, g, dev)
    sz = sizes.tolist()
    w = (torch.randn((e, n, k), generator=g, device=dev) * 0.05
         ).to(torch.bfloat16)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    gy = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
    bias = torch.randn((e, n), generator=g, device=dev).to(torch.bfloat16)
    counts = [torch.zeros(4, dtype=torch.int32, device=dev) for _ in range(3)]
    torch.full((m, max(n, k)), float("nan"), dtype=torch.bfloat16,
               device=dev)
    y = tgmm.gmm_fwd(x, w, sizes, bias, unit_counts=counts[0])
    dx = tgmm.gmm_dx(gy, w, sizes, unit_counts=counts[1])
    dw = tgmm.tgmm(x, gy, sizes, unit_counts=counts[2])
    torch.cuda.synchronize()
    assert counts[0].tolist() == gmm_unit_counts(sz, m, n)
    assert counts[1].tolist() == gmm_unit_counts(sz, m, k)
    assert counts[2].tolist() == tgmm_unit_counts(sz, n, k, m)
    assert torch.equal(y, tgmm.gmm_fwd(x, w, sizes, bias))
    assert torch.equal(dx, tgmm.gmm_dx(gy, w, sizes))
    assert torch.equal(dw, tgmm.tgmm(x, gy, sizes))
    ref = tgmm.gmm_ref(x, w, sizes, bias)
    rdx = tgmm.gmm_ref(gy, w, sizes, transpose=True)
    assert attn_row_err(y, ref) <= ATTN_ROW_TOL
    assert attn_row_err(dx, rdx) <= ATTN_ROW_TOL
    end = sum(sz)
    assert (y[end:] == 0).all() and (dx[end:] == 0).all()
    faults = {**gmm_straddle_faults(x, w, sizes, bias),
              **{f"dx: {f_}": (wrong, rdx) for f_, wrong in
                 gmm_straddle_faults(gy, w, sizes, transpose=True).items()}}
    assert faults or kind == "one"
    for fault, wrong in faults.items():
        wrong, want = wrong if isinstance(wrong, tuple) else (wrong, ref)
        assert not attn_row_err(wrong, want) <= ATTN_ROW_TOL, fault


# ---------------------------------------------------------------------------
# GRPO: K18's shared-prefix form
# ---------------------------------------------------------------------------

from chip_smoke import (prefix_fault_errs, prefix_segments,  # noqa: E402
                        visited_tile_pairs)


@pytest.mark.parametrize("layout,prompt_len,completion_lens,d,hq,hkv", [
    ((128, 3, 128), 90, (128, 40, 101), 128, 8, 2),    # tile-aligned edges
    ((100, 3, 70), 57, (70, 13, 66), 128, 8, 2),       # edges inside tiles
    ((37, 4, 20), 37, (20, 3, 11, 20), 64, 4, 1),      # regions < one tile
    ((256, 2, 128), 200, (128, 77), 256, 4, 2),
])
def test_splash_prefix_kernels_match_plain(dev, layout, prompt_len,
                                           completion_lens, d, hq, hkv):
    """K18's prefix form (forward, dq, dk/dv) against the plain versions
    with the same layout on bf16 inputs, a left-padded prompt and
    completions shorter than their regions: every position row by row
    (``chip_smoke.attn_row_err``), lse within 1e-3; layouts whose P and L
    are and are not multiples of the 64-token tile, and regions shorter
    than a tile. The check rejects the region rule dropped and the prefix
    dropped; a window beside the layout raises. The tile pairs each kernel
    classed, read back from its counters, are the rule's at its tiles
    (``chip_smoke.flash_tile_counts`` with the layout), with one segment
    and with the row's segment ids (and causal's without the layout); the
    three run again give the same bits."""
    P, G, L = layout
    t = P + G * L
    g = torch.Generator(device=dev).manual_seed(18)
    q, k, v, dout = (torch.randn((1, t, h, d), generator=g, device=dev)
                     .to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
    seg = prefix_segments(layout, prompt_len, completion_lens, dev)
    lo, hi = tfa.tile_segment_ranges(seg)
    opts = dict(window=None, softcap=None, scale=d ** -0.5,
                prefix_layout=layout)
    before = (tsa.splash_attention_fwd.launches,
              tsa.splash_attention_dq.launches,
              tsa.splash_attention_dkv.launches)
    out, lse = tsa.splash_attention_fwd(q, k, v, seg, lo, hi, **opts)
    dq, di = tsa.splash_attention_dq(q, k, v, seg, lo, hi, out, lse, dout,
                                     **opts)
    dk, dv = tsa.splash_attention_dkv(q, k, v, seg, lo, hi, lse, di, dout,
                                      **opts)
    rout, rlse = tsa.splash_attention_fwd_ref(q, k, v, seg, **opts)
    rdq, rdk, rdv = tsa.splash_attention_bwd_ref(q, k, v, seg, out, lse,
                                                 dout, **opts)
    torch.cuda.synchronize()
    assert (tsa.splash_attention_fwd.launches,
            tsa.splash_attention_dq.launches,
            tsa.splash_attention_dkv.launches) == tuple(x + 1 for x in before)
    assert (lse - rlse).abs().max() <= 1e-3
    want = (rout, rdq, rdk, rdv)
    for got, ref in zip((out, dq, dk, dv), want):
        assert torch.isfinite(got).all()
        assert attn_row_err(got, ref) <= ATTN_ROW_TOL
    res = prefix_fault_errs(q, k, v, seg, dout, d ** -0.5, layout, want)
    for fault, errs in res.items():
        for name, (err, _) in errs.items():
            assert err > ATTN_ROW_TOL, (fault, name, err)
    with pytest.raises(ValueError, match="window"):
        tsa.splash_attention_fwd(q, k, v, seg, lo, hi, window=64,
                                 softcap=None, scale=0.1,
                                 prefix_layout=layout)
    one = torch.ones_like(seg)
    for s_, lay in ((one, layout), (seg, layout), (one, None)):
        got = kernel_tile_classes(q, k, v, s_, dout, d ** -0.5, True,
                                  splash=dict(window=None, softcap=None,
                                              prefix_layout=lay))
        assert got == {w: flash_tile_counts(s_, True, *tfa.KERNEL_TILES[w][d],
                                            prefix_layout=lay, kernel=w)
                       for w in got}
    bq, bk = tfa.KERNEL_TILES["fwd"][d]
    assert visited_tile_pairs(t, layout, seg, bq, bk) <= \
        visited_tile_pairs(t, layout, None, bq, bk) <= \
        visited_tile_pairs(t, None, None, bq, bk)
    out2, lse2 = tsa.splash_attention_fwd(q, k, v, seg, lo, hi, **opts)
    dq2, di2 = tsa.splash_attention_dq(q, k, v, seg, lo, hi, out, lse, dout,
                                       **opts)
    dk2, dv2 = tsa.splash_attention_dkv(q, k, v, seg, lo, hi, lse, di, dout,
                                        **opts)
    assert all(torch.equal(a, b) for a, b in zip(
        (out, lse, dq, di, dk, dv), (out2, lse2, dq2, di2, dk2, dv2)))
    with pytest.raises(ValueError, match="tile_counts"):
        tsa.splash_attention_fwd(q, k, v, seg, lo, hi, **opts,
                                 tile_counts=torch.zeros(1, device=dev))


def test_attention_prefix_route_on_cuda(dev):
    """Under prefix_attention a row of T = P + G * L launches K18's prefix
    form (forward, then dq and dk/dv), not K16; a softcap or sinks with
    the layout raise."""
    from unsloth_tpu_torch.ops.attention import attention, prefix_attention

    layout = (64, 2, 96)
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((1, 256, 8, 128), generator=g, device=dev).to(
        torch.bfloat16).requires_grad_(True)
    k = torch.randn((1, 256, 2, 128), generator=g, device=dev).to(
        torch.bfloat16).requires_grad_(True)
    seg = prefix_segments(layout, 50, (96, 30), dev)
    before = (tsa.splash_attention_fwd.launches,
              tsa.splash_attention_dq.launches,
              tsa.splash_attention_dkv.launches,
              tfa.flash_attention_fwd.launches)
    with prefix_attention(layout):
        out = attention(q, k, k, segment_ids=seg)
    out.float().sum().backward()
    assert (tsa.splash_attention_fwd.launches,
            tsa.splash_attention_dq.launches,
            tsa.splash_attention_dkv.launches,
            tfa.flash_attention_fwd.launches) == \
        (before[0] + 1, before[1] + 1, before[2] + 1, before[3])
    with pytest.raises(NotImplementedError, match="masked reference"):
        attention(q, k, k, segment_ids=seg, softcap=30.0,
                  prefix_layout=layout)
    with pytest.raises(NotImplementedError, match="masked reference"):
        attention(q, k, k, segment_ids=seg, prefix_layout=layout,
                  sinks=torch.zeros(8, device=dev))


# ---------------------------------------------------------------------------
# the speech slice's kernels: LayerNorm forward (K5) and backward (K6)
# ---------------------------------------------------------------------------

from chip_smoke import ln_errs  # noqa: E402
from unsloth_tpu_torch.ops.rms_norm import (  # noqa: E402
    layer_norm, layer_norm_bwd, layer_norm_bwd_ref, layer_norm_fwd,
    layer_norm_ref)


@pytest.mark.parametrize("rows,d", [(3000, 1280), (448, 1280), (70, 384),
                                    (5, 7000), (37, 4096), (37, 2048),
                                    (9, 1288), (100, 896), (64, 3584)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("need_dw", [True, False])
def test_layer_norm_kernels_match_plain(dev, rows, d, dtype, bias, need_dw):
    """K5 and K6 against layer_norm_ref / layer_norm_bwd_ref at Whisper's
    widths, a narrow one, one whose dW/dB sums need more than 48 KB of
    shared memory (the strided form) and the other main paths' 896 and
    3,584, with and without a bias, K6 in both forms (dx alone, as the
    Whisper LoRA path asks; dx with dW and dB); the tolerances of
    chip_smoke.ln_errs (each part <= 1 of its limit); the same bits from a
    second backward; one launch a call, and in the dx-only form no dW or
    dB and one device operation (torch.profiler)."""
    g = torch.Generator(device=dev).manual_seed(12)
    x = (torch.randn((rows, d), generator=g, device=dev) * 2 + 0.5).to(dtype)
    w = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(dtype)
    b = (0.1 * torch.randn(d, generator=g, device=dev)).to(dtype) \
        if bias else None
    gy = torch.randn((rows, d), generator=g, device=dev).to(dtype)
    before = (layer_norm_fwd.launches, layer_norm_bwd.launches)
    out = layer_norm_fwd(x, w, b, 1e-5)
    dx, dw, db = layer_norm_bwd(x, w, gy, 1e-5, need_dw=need_dw)
    again = layer_norm_bwd(x, w, gy, 1e-5, need_dw=need_dw)
    torch.cuda.synchronize()
    assert (layer_norm_fwd.launches, layer_norm_bwd.launches) == \
        (before[0] + 1, before[1] + 2)
    assert out.dtype == dx.dtype == dtype
    want = (layer_norm_ref(x, w, b, 1e-5),) + layer_norm_bwd_ref(x, w, gy,
                                                                 1e-5)
    assert torch.equal(dx, again[0])
    if need_dw:
        assert dw.dtype == db.dtype == torch.float32
        assert torch.equal(dw, again[1]) and torch.equal(db, again[2])
    else:
        assert dw is db is again[1] is again[2] is None
        ops = launched_kernels(lambda: layer_norm_bwd(
            x, w, gy, 1e-5, need_dw=False), tries=6)
        assert len(ops) == 1, ops
    errs = ln_errs(dtype, (out, dx, dw, db), want)
    assert max(errs.values()) <= 1.0, errs


@pytest.mark.parametrize("xdt,wdt", [(torch.bfloat16, torch.float32),
                                     (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("d", [1280, 1282])
def test_layer_norm_fwd_mixed_dtypes(dev, xdt, wdt, d):
    """K5 with w and b in the other dtype than x, in the warp form (D =
    1,280) and the block form (1,282: no whole 16-byte chunks), and on a
    view of x that is not 16-byte aligned (the block form): within
    ln_errs' forward limit of layer_norm_ref."""
    from chip_smoke import ln_out_err

    g = torch.Generator(device=dev).manual_seed(14)
    x = (torch.randn((3001, d), generator=g, device=dev) * 2 + 0.5).to(xdt)
    w = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(wdt)
    b = (0.1 * torch.randn(d, generator=g, device=dev)).to(wdt)
    for xs in (x[:3000], x.reshape(-1)[1:1 + 3000 * d].reshape(3000, d)):
        out = layer_norm_fwd(xs, w, b, 1e-5)
        torch.cuda.synchronize()
        assert ln_out_err(xdt, out, layer_norm_ref(xs, w, b, 1e-5)) <= 1.0


def test_layer_norm_autograd_launches_kernels(dev):
    """layer_norm's backward on the card is K6: dx, dW and dB (in the
    parameters' dtype) equal the wrapper's, and no dB without a bias."""
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn((4, 50, 1280), generator=g, device=dev).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(1280, generator=g, device=dev)).to(
        torch.bfloat16)
    b = torch.zeros(1280, device=dev, dtype=torch.bfloat16)
    gy = torch.randn(x.shape, generator=g, device=dev).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    before = (layer_norm_fwd.launches, layer_norm_bwd.launches)
    layer_norm(*leaves, 1e-5).backward(gy)
    assert (layer_norm_fwd.launches, layer_norm_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    dx, dw, db = layer_norm_bwd(x, w, gy, 1e-5)
    assert torch.equal(leaves[0].grad, dx)
    assert torch.equal(leaves[1].grad, dw.to(torch.bfloat16))
    assert torch.equal(leaves[2].grad, db.to(torch.bfloat16))
    xl = x.clone().requires_grad_(True)
    layer_norm(xl, w, None, 1e-5).backward(gy)
    assert torch.equal(xl.grad, dx)


def test_layer_norm_refuses_other_dtypes(dev):
    x = torch.randn((4, 64), device=dev, dtype=torch.float16)
    w = torch.ones(64, device=dev, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="float32/bfloat16"):
        layer_norm(x, w, None)
    xb = x.to(torch.bfloat16)
    wb = w.to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="b like w"):
        layer_norm(xb, wb, torch.zeros(64, device=dev))


@pytest.fixture
def fp32_reductions():
    """cuBLAS's bf16 products (the FP8 kernels' plain versions) with fp32
    reductions only, as chip_smoke.main sets them: the plain versions then
    compute what they state, one bf16 rounding of an fp32 sum; with bf16
    split-K reductions allowed they drift from it by several ulps."""
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    yield
    matmul.allow_bf16_reduced_precision_reduction = old


@pytest.mark.parametrize("m,n,k,block", [
    (1, 256, 512, 128),      # one decode row
    (4, 14336, 4096, 128),   # gate/up at decode rows
    (1, 200, 300, 32),       # ragged, block 32, one row
    (333, 1000, 1404, 32),   # ragged: every load and store masked
    (9, 130, 250, 24),       # a block that is not a multiple of 16
    (300, 1024, 4096, 128)])
def test_fp8_matmul_kernels_match_plain(dev, fp32_reductions, m, n, k, block):
    """K12 and K13 against fp8_matmul_ref / fp8_matmul_dx_ref on the card:
    every element within MM_ULPS bf16 ulps (chip_smoke.mm_ulps: the same
    bf16 weights, fp32 sums in another order, one rounding), and the check
    rejects a wrong scale."""
    import dataclasses

    g = torch.Generator(device=dev).manual_seed(14)
    q = quantize_fp8_block(fp8_weight(n, k, g, dev, block), block)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    gy = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
    before = (fp8_matmul_fwd.launches, fp8_matmul_dx.launches)
    y, dx = fp8_matmul_fwd(x, q), fp8_matmul_dx(gy, q)
    ref, rdx = fp8_matmul_ref(x, q), fp8_matmul_dx_ref(gy, q)
    torch.cuda.synchronize()
    assert (fp8_matmul_fwd.launches, fp8_matmul_dx.launches) == \
        (before[0] + 1, before[1] + 1)
    assert y.shape == (m, n) and dx.shape == (m, k)
    assert y.dtype == dx.dtype == torch.bfloat16
    assert mm_ulps(y, ref) <= MM_ULPS and mm_ulps(dx, rdx) <= MM_ULPS
    wrong = dataclasses.replace(q, scales=torch.ones_like(q.scales))
    assert mm_ulps(fp8_matmul_ref(x, wrong), ref) > MM_ULPS


@pytest.mark.parametrize("m,n,k,block", [
    (300, 1024, 4096, 128),  # the path's block: one scale a stage
    (17, 200, 384, 32),      # 17 rows: the Hopper form's fewest
    (40, 96, 400, 32),       # K % 32 == 16: a last stage half past K
    (129, 130, 256, 64),     # N % 8 != 0: masked element stores
    (1500, 512, 2880, 128),  # gpt-oss width, K = 2,880 = 90 stages
    (333, 1000, 1408, 32),   # ragged N, K a multiple of 16 but not of 128
    (333, 1000, 1404, 32),   # K % 16 != 0: fp8_matmul_kernel<64, false>
    (300, 256, 512, 48)])    # B % 32 != 0: fp8_matmul_kernel<64, false>
def test_fp8_wgmma_tiles_match_the_schedule(dev, fp32_reductions, m, n, k,
                                            block):
    """K12 on K1's Hopper kernel where ``fp8_wgmma_form`` holds: each output
    tile of K1's schedule (``fp8_tile_schedule``) stored once, ceil(K/32)
    stages a tile, y within MM_ULPS of the plain version; elsewhere the
    wmma tiles, whose counters stay 0."""
    from unsloth_tpu_torch.ops.fp8_matmul import (STAGE_BYTES,
                                                  fp8_tile_schedule,
                                                  fp8_wgmma_form)

    g = torch.Generator(device=dev).manual_seed(22)
    q = quantize_fp8_block(fp8_weight(n, k, g, dev, block), block)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    y = fp8_matmul_fwd(x, q, tile_counts=counts)
    ref = fp8_matmul_ref(x, q)
    torch.cuda.synchronize()
    hopper = fp8_wgmma_form(m, k, block, x.data_ptr(),
                            q.values.data_ptr(), y.data_ptr())
    assert hopper == (block % 32 == 0 and k % 16 == 0)
    tiles = sum(map(len, fp8_tile_schedule(m, n)))
    want = [tiles, tiles * -(-k // STAGE_BYTES)] if hopper else [0, 0]
    assert counts.tolist() == want
    assert mm_ulps(y, ref) <= MM_ULPS


@pytest.mark.parametrize("m,n,k,block", [
    (300, 1024, 4096, 128),  # the path's block: four scales a stage
    (17, 200, 384, 32),      # 17 rows: the Hopper form's fewest
    (40, 96, 400, 32),       # K % 32 == 16 (a last tile 112 columns past
                             # K); N = 96: a last stage half past N
    (129, 130, 256, 64),     # N % 8 != 0: fp8_matmul_kernel<64, true>
    (1500, 512, 2880, 128),  # gpt-oss width: 23 column tiles
    (333, 1000, 1408, 32),   # ragged N, K a multiple of 16 but not of 128
    (333, 1000, 1404, 32),   # K % 16 != 0: fp8_matmul_kernel<64, true>
    (300, 256, 512, 48)])    # B % 32 != 0: fp8_matmul_kernel<64, true>
def test_fp8_dx_wgmma_tiles_match_the_schedule(dev, fp32_reductions, m, n,
                                               k, block):
    """K13 on K2's Hopper kernel in its e4m3 form where
    ``fp8_dx_wgmma_form`` holds: each 128-column tile of its schedule
    (``fp8_dx_tile_schedule``) stored once, ceil(N/64) stages a tile, dx
    within MM_ULPS of the plain version; elsewhere the wmma tiles, whose
    counters stay 0."""
    from unsloth_tpu_torch.ops.fp8_matmul import (DX_STAGE_ROWS,
                                                  fp8_dx_tile_schedule,
                                                  fp8_dx_wgmma_form)

    g = torch.Generator(device=dev).manual_seed(23)
    q = quantize_fp8_block(fp8_weight(n, k, g, dev, block), block)
    gy = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    dx = fp8_matmul_dx(gy, q, tile_counts=counts)
    ref = fp8_matmul_dx_ref(gy, q)
    torch.cuda.synchronize()
    hopper = fp8_dx_wgmma_form(m, n, k, block, gy.data_ptr(),
                               q.values.data_ptr(), dx.data_ptr())
    assert hopper == (block % 32 == 0 and k % 16 == 0 and n % 8 == 0)
    tiles = sum(map(len, fp8_dx_tile_schedule(m, k)))
    want = [tiles, tiles * -(-n // DX_STAGE_ROWS)] if hopper else [0, 0]
    assert counts.tolist() == want
    assert mm_ulps(dx, ref) <= MM_ULPS


def test_fp8_base_matmul_launches_kernels(dev, fp32_reductions):
    """base_matmul over an FP8 base on the card runs K12, its backward K13
    (read from the launch counters), at training and at decode rows."""
    g = torch.Generator(device=dev).manual_seed(15)
    q = quantize_fp8_block(fp8_weight(512, 384, g, dev), 128)
    for rows in (1, 200):
        x = torch.randn((2, rows, 384), generator=g, device=dev).to(
            torch.bfloat16).requires_grad_(True)
        gy = torch.randn((2, rows, 512), generator=g, device=dev).to(
            torch.bfloat16)
        before = (fp8_matmul_fwd.launches, fp8_matmul_dx.launches)
        y = base_matmul(x, q)
        y.backward(gy)
        torch.cuda.synchronize()
        assert (fp8_matmul_fwd.launches, fp8_matmul_dx.launches) == \
            (before[0] + 1, before[1] + 1)
        assert mm_ulps(y, fp8_matmul_ref(x.detach(), q)) <= MM_ULPS
        assert mm_ulps(x.grad, fp8_matmul_dx_ref(gy, q)) <= MM_ULPS


def test_fp8_matmul_refuses_f32(dev):
    q = quantize_fp8_block(torch.randn((128, 256), device=dev))
    with pytest.raises(NotImplementedError, match="bfloat16"):
        fp8_matmul_fwd(torch.randn((2, 256), device=dev), q)


# ---------------------------------------------------------------------------
# text diffusion: the non-causal forms of K16 and K18
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,d,hq,hkv,softcap", [
    (256, 128, 8, 8, None),     # LLaDA-8B's heads: no GQA
    (200, 128, 8, 2, None),     # a ragged T, Llama's 4 query heads a kv head
    (200, 64, 14, 2, None),
    (256, 256, 4, 4, None),
    (300, 256, 4, 2, 50.0),     # K18: Gemma-2's head dim and softcap
    (300, 128, 8, 2, 50.0),
    (300, 64, 8, 2, 30.0),
])
def test_noncausal_attention_kernels_match_plain(dev, t, d, hq, hkv, softcap):
    """K16 (no softcap) and K18 (softcap) without causality: forward (out,
    lse), dq and dk/dv against the plain fp32 versions with causal=False
    on the same bf16 inputs, a padded and a packed row, every position row
    by row (``chip_smoke.attn_row_err``), lse within 1e-3, one launch of
    each non-causal wrapper and none of the causal ones; the causal
    kernels' out on the same inputs fails the same check. K18's tile
    pairs by class (its counters) are the rule's at its tiles."""
    g = torch.Generator(device=dev).manual_seed(12)
    q, k, v, dout = (torch.randn((2, t, h, d), generator=g, device=dev)
                     .to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
    seg = _splash_segments(t, dev)
    lo, hi = tfa.tile_segment_ranges(seg)
    scale = d ** -0.5
    if softcap is None:
        fns = (tfa.flash_attention_fwd_full, tfa.flash_attention_dq_full,
               tfa.flash_attention_dkv_full)
        causal_fns = (tfa.flash_attention_fwd, tfa.flash_attention_dq,
                      tfa.flash_attention_dkv)
        opts, ref_opts = dict(scale=scale), dict(scale=scale)
        fwd_ref = lambda c: tfa.flash_attention_fwd_ref(  # noqa: E731
            q, k, v, seg, scale, c)
        bwd_ref = lambda o, l_: tfa.flash_attention_bwd_ref(  # noqa: E731
            q, k, v, seg, o, l_, dout, scale, False)
        causal_out = lambda: tfa.flash_attention_fwd(  # noqa: E731
            q, k, v, seg, lo, hi, scale=scale)[0]
    else:
        fns = (tsa.splash_attention_fwd_full, tsa.splash_attention_dq_full,
               tsa.splash_attention_dkv_full)
        causal_fns = (tsa.splash_attention_fwd, tsa.splash_attention_dq,
                      tsa.splash_attention_dkv)
        opts = dict(softcap=softcap, scale=scale)
        ref_opts = dict(window=None, softcap=softcap, scale=scale)
        fwd_ref = lambda c: tsa.splash_attention_fwd_ref(  # noqa: E731
            q, k, v, seg, causal=c, **ref_opts)
        bwd_ref = lambda o, l_: tsa.splash_attention_bwd_ref(  # noqa: E731
            q, k, v, seg, o, l_, dout, causal=False, **ref_opts)
        causal_out = lambda: tsa.splash_attention_fwd(  # noqa: E731
            q, k, v, seg, lo, hi, window=None, **opts)[0]
    before = [f.launches for f in fns + causal_fns]
    out, lse = fns[0](q, k, v, seg, lo, hi, **opts)
    dq, di = fns[1](q, k, v, seg, lo, hi, out, lse, dout, **opts)
    dk, dv = fns[2](q, k, v, seg, lo, hi, lse, di, dout, **opts)
    rout, rlse = fwd_ref(False)
    rdq, rdk, rdv = bwd_ref(out, lse)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns + causal_fns, before)] == \
        [1, 1, 1, 0, 0, 0]
    assert (lse - rlse).abs().max() <= 1e-3
    for got, ref in ((out, rout), (dq, rdq), (dk, rdk), (dv, rdv)):
        assert torch.isfinite(got).all()
        assert attn_row_err(got, ref) <= ATTN_ROW_TOL
    assert attn_row_err(causal_out(), rout) > ATTN_ROW_TOL
    if softcap is not None:
        got = kernel_tile_classes(q, k, v, seg, dout, scale, False,
                                  splash=dict(window=None, softcap=softcap,
                                              prefix_layout=None))
        assert got == {w: flash_tile_counts(seg, False,
                                            *tfa.KERNEL_TILES[w][d], kernel=w)
                       for w in got}


@pytest.mark.parametrize("softcap", [None, 50.0])
def test_attention_dispatch_noncausal_on_cuda(dev, softcap):
    """causal=False self-attention reaches the non-causal K16 (no softcap)
    or K18 (softcap) wrappers, forward and backward; a window without
    causality raises."""
    from unsloth_tpu_torch.ops.attention import attention

    q = torch.randn((2, 128, 4, 128), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn((2, 128, 2, 128), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    mod, names = ((tfa, ("flash_attention_fwd_full", "flash_attention_dq_full",
                         "flash_attention_dkv_full")) if softcap is None else
                  (tsa, ("splash_attention_fwd_full",
                         "splash_attention_dq_full",
                         "splash_attention_dkv_full")))
    before = [getattr(mod, n).launches for n in names]
    out = attention(q, k, k, causal=False, segment_ids=_splash_segments(
        128, dev), softcap=softcap)
    out.float().sum().backward()
    assert [getattr(mod, n).launches - b for n, b in zip(names, before)] == \
        [1, 1, 1]
    assert torch.isfinite(q.grad).all() and torch.isfinite(k.grad).all()
    with pytest.raises(NotImplementedError, match="attention_ref"):
        attention(q, k, k, causal=False, window=32)
