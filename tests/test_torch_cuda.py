"""The port's CUDA kernels against their plain PyTorch versions on the card.

These need an NVIDIA GPU and nvcc; without one they skip. On the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import pytest
import torch

from chip_smoke import ATTN_ROW_TOL, attn_row_err
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
                                   (70, 1024, 4096), (300, 4096, 4096)])
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gemma", [False, True])
def test_rms_norm_bwd_kernel_matches_plain(dev, dtype, gemma):
    """dx within 2 output ulps (the fp32 result differs in its last bits,
    then rounds); dW, an fp32 sum over 700 rows in another order, within
    1e-3 of max|dW| (bf16: one bf16 ulp, 2^-7, of max|dW|)."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((7, 100, 4096), generator=g, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(4096, generator=g, device=dev)).to(dtype)
    gy = torch.randn((7, 100, 4096), generator=g, device=dev).to(dtype)
    before = rms_norm_bwd.launches
    dx, dw = rms_norm_bwd(x, w, gy, 1e-5, gemma)
    rdx, rdw = rms_norm_bwd_ref(x, w, gy, 1e-5, gemma)
    torch.cuda.synchronize()
    assert rms_norm_bwd.launches == before + 1
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    assert ((dx.float() - rdx.float()).abs()
            <= 2 * ulp * rdx.float().abs() + 1e-5).all()
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-3
    assert (dw.float() - rdw.float()).abs().max() <= \
        tol * rdw.float().abs().max()


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


def test_packed_attention_kernels_match_plain(dev):
    """Forward (out, lse) and backward (dq, dk, dv) of the kernels against
    the plain per-segment fp32 versions on the same bf16 inputs and the
    same saved (out, lse), at real positions: out/dq/dk/dv row by row
    (``chip_smoke.attn_row_err``: each element within 2^-6 of its value
    plus 2^-4 of its (token, head) row's rms; bf16 P and dS, bf16
    outputs), lse within 1e-3."""
    t, hq, hkv, d, max_len = 1024, 8, 2, 128, 300
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v, dout = (torch.randn((1, t, h, d), generator=g, device=dev)
                     .to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
    seg = _segments(t, 40, max_len, seed=5).to(dev)
    scale = d ** -0.5
    n_kv = tpa.bound_blocks(max_len, tpa.BLOCK)
    kv_lo, q_hi = tpa.segment_block_metadata(seg, tpa.BLOCK)
    before = (tpa.packed_attention_fwd.launches,
              tpa.packed_attention_bwd.launches)
    out, lse = tpa.packed_attention_fwd(q, k, v, seg, kv_lo, scale=scale,
                                        n_kv=n_kv)
    dq, dk, dv = tpa.packed_attention_bwd(q, k, v, seg, kv_lo, q_hi, out,
                                          lse, dout, scale=scale, n_kv=n_kv)
    rout, rlse = tpa.packed_attention_fwd_ref(q, k, v, seg, scale)
    rdq, rdk, rdv = tpa.packed_attention_bwd_ref(q, k, v, seg, out, lse,
                                                 dout, scale)
    torch.cuda.synchronize()
    assert (tpa.packed_attention_fwd.launches,
            tpa.packed_attention_bwd.launches) == (before[0] + 1,
                                                    before[1] + 1)
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


@pytest.mark.parametrize("t,d,hq,hkv", [
    (256, 128, 8, 2), (200, 128, 8, 2),
    (200, 64, 14, 2),     # Qwen2.5-0.5B's heads: 7 query heads a kv head
    (256, 64, 32, 8),     # Llama-3.2-1B's
    (200, 256, 4, 4),     # Gemma-1's head dim, no GQA
    (256, 256, 8, 2),
])
def test_flash_attention_kernels_match_plain(dev, t, d, hq, hkv):
    """K16 forward (out, lse) and backward (dq, dk, dv) against the plain
    fp32 twins on the same bf16 inputs at head dims 64, 128 and 256, one
    full row and one padded row (pad queries included), a ragged T among
    them: every position row by row (``chip_smoke.attn_row_err``: each
    element within 2^-6 of its value plus 2^-4 of its (token, head) row's
    rms; the kernels round P and dS to bf16), lse within 1e-3; the
    backward pair gets the kernel forward's (out, lse)."""
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v, dout = (torch.randn((2, t, h, d), generator=g, device=dev)
                     .to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
    seg = torch.ones((2, t), dtype=torch.int32, device=dev)
    seg[1, t - 70:] = 0
    lo, hi = tfa.tile_segment_ranges(seg)
    scale = d ** -0.5
    before = (tfa.flash_attention_fwd.launches, tfa.flash_attention_dq.launches,
              tfa.flash_attention_dkv.launches)
    out, lse = tfa.flash_attention_fwd(q, k, v, seg, lo, hi, scale=scale)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, seg, lo, hi, out, lse, dout,
                                         scale=scale)
    rout, rlse = tfa.flash_attention_fwd_ref(q, k, v, seg, scale)
    rdq, rdk, rdv = tfa.flash_attention_bwd_ref(q, k, v, seg, out, lse, dout,
                                                scale)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_fwd.launches, tfa.flash_attention_dq.launches,
            tfa.flash_attention_dkv.launches) == tuple(x + 1 for x in before)
    assert (lse - rlse).abs().max() <= 1e-3
    for got, ref in ((out, rout), (dq, rdq), (dk, rdk), (dv, rdv)):
        assert torch.isfinite(got).all()
        assert attn_row_err(got, ref) <= ATTN_ROW_TOL


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
    (128, 8, 2, 100, None, 128 ** -0.5),
    (128, 4, 2, 64, 50.0, 144 ** -0.5),
    (64, 16, 2, 128, None, 0.125),     # gpt-oss's sliding layers' form
    (64, 8, 1, 64, 50.0, 0.125),
    (64, 14, 2, None, 30.0, 0.125),
])
def test_splash_attention_kernels_match_plain(dev, d, hq, hkv, window,
                                              softcap, scale):
    """K18 forward (out, lse), dq and dk/dv against the plain fp32 versions
    on the same bf16 inputs at head dims 64, 128 and 256, a padded and a
    packed row at a ragged T = 300, with and without a window (64, 100 and
    128 tokens: it bites) and the softcap:
    every position row by row (``chip_smoke.attn_row_err``; the kernels
    round P and dS to bf16), lse within 1e-3; the backward pair gets the
    kernel forward's (out, lse)."""
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


@pytest.mark.parametrize("t,hq,hkv", [(300, 8, 1), (256, 64, 8)])
def test_flash_sinks_kernels_match_plain(dev, t, hq, hkv):
    """K17 forward (out, lse'), dq and dk/dv at head dim 64 with GQA (8
    query heads a kv head) against the plain fp32 versions on the same
    bf16 inputs, a padded and a packed row: every position row by row
    (``chip_smoke.attn_row_err``), lse' within 1e-3, dsinks within 1e-2 of
    its largest value (a sum over tokens of the kernels' di)."""
    g = torch.Generator(device=dev).manual_seed(13)
    q, k, v, dout = (torch.randn((2, t, h, 64), generator=g, device=dev)
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
    and the sink rescale, against the reference; head dim 128 with sinks
    raises naming K17."""
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
    q128 = torch.zeros((1, 64, 2, 128), device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="K17"):
        attention(q128, q128, q128, sinks=torch.zeros(2, device=dev))


from unsloth_tpu_torch.ops import gmm as tgmm  # noqa: E402


@pytest.mark.parametrize("e,n,k,m,kind", [
    (32, 2880, 2880, 2048, "random"),   # gpt-oss widths: 22.5 x 128
    (8, 768, 2048, 513, "random"),      # qwen3-moe's; m not a tile multiple
    (16, 320, 200, 900, "skewed"),      # empty experts, K % 64 != 0
    (4, 136, 72, 300, "one"),           # every row routed to one expert
    (32, 2880, 2880, 8, "random"),      # decode rows
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
