"""The training slice's ops in the PyTorch port against the JAX package on
the same numpy inputs, on the CPU: the plain twins of the NF4 backward
(K2), the RMSNorm backward (K4) and packed attention (K9-K11) against the
JAX Pallas kernels in interpret mode, the autograd of each against
``jax.grad``, the chunked fused CE, packing, and the CUDA routes: those
with kernels reach their wrappers, the others raise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsloth_tpu.data import packing as jpack
from unsloth_tpu.ops import fused_ce_linear as jce
from unsloth_tpu.ops.attention import attention_ref as jattention_ref
from unsloth_tpu.ops import nf4 as jnf4
from unsloth_tpu.ops import packed_attention as jpa
from unsloth_tpu.ops import qlora_matmul as jqm
from unsloth_tpu.ops.rms_norm import _rms_norm_bwd_pallas
from unsloth_tpu.ops.rms_norm import rms_norm as jrms_norm
from unsloth_tpu_torch.data import packing as tpack
from unsloth_tpu_torch.interop import params_from_numpy
from unsloth_tpu_torch.ops import attention as tatt
from unsloth_tpu_torch.ops import cross_entropy as tce_full
from unsloth_tpu_torch.ops import flash_attention as tfa
from unsloth_tpu_torch.ops import fused_ce_linear as tce
from unsloth_tpu_torch.ops import packed_attention as tpa
from unsloth_tpu_torch.ops.cross_entropy import fast_cross_entropy_loss
from unsloth_tpu_torch.ops.qlora_matmul import nf4_matmul, nf4_matmul_dx
from unsloth_tpu_torch.ops.rms_norm import rms_norm, rms_norm_bwd


def _rng(seed=0):
    return np.random.default_rng(seed)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def carried_nf4():
    """W [256, 512] quantized by JAX (double quant) and the same bytes in
    the port."""
    w = (_rng(0).standard_normal((256, 512)) * 0.05).astype(np.float32)
    jq = jnf4.quantize_nf4(jnp.asarray(w), dtype=jnp.float32)
    tq = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), "cpu")
    return jq, tq


# ---------------------------------------------------------------------------
# (a) NF4 backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nf4_dx_plain_matches_pallas_bwd(carried_nf4, dtype):
    """Same weights rounded to `dtype` at the same point, fp32 sums in
    another order: f32 within 1e-5 of max|dx|; bf16 within one output ulp
    (2^-8 relative) plus the summation noise, 1e-2 of max|dx|."""
    jq, tq = carried_nf4
    g = _rng(1).standard_normal((48, 256)).astype(np.float32)
    jg = jnp.asarray(g, getattr(jnp, dtype))
    want = _np(jqm._bwd_pallas(jg, jq, bm=16, bn=128, bk=128,
                               interpret=True))
    got = nf4_matmul_dx(_t(g).to(getattr(torch, dtype)), tq)
    assert got.dtype == getattr(torch, dtype) and got.shape == (48, 512)
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


def test_nf4_matmul_autograd_matches_jax_grad(carried_nf4):
    """d/dx sum(sin(nf4_matmul(x, W))) in f32: the port's autograd.Function
    (backward = nf4_matmul_dx) against jax.grad through the custom VJP
    (Pallas kernels in interpret mode). Tolerance 1e-5 abs: both are f32
    dots of the same dequantized weights."""
    jq, tq = carried_nf4
    x = _rng(2).standard_normal((3, 5, 512)).astype(np.float32)
    jgrad = jax.grad(lambda a: jnp.sum(jnp.sin(jqm.nf4_matmul(a, jq))))(
        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y = nf4_matmul(xt, tq)
    torch.sin(y).sum().backward()
    assert y.shape == (3, 5, 256)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# (b) RMSNorm backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gemma", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_bwd_plain_matches_pallas(gemma, dtype):
    """dx and dW of the plain twin against _rms_norm_bwd_pallas (interpret
    mode). f32: 1e-5 relative to the largest value (fp32 sums in another
    order). bf16 inputs: dx rounds to bf16 in both (2^-8 relative), dW is
    summed in fp32 and cast to bf16: 1e-2 of the largest value."""
    rng = _rng(3)
    x = rng.standard_normal((200, 256)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    g = rng.standard_normal((200, 256)).astype(np.float32)
    jd = getattr(jnp, dtype)
    jdx, jdw = _rms_norm_bwd_pallas(jnp.asarray(x, jd), jnp.asarray(w, jd),
                                    jnp.asarray(g, jd), 1e-5, gemma)
    td = getattr(torch, dtype)
    tdx, tdw = rms_norm_bwd(_t(x).to(td), _t(w).to(td), _t(g).to(td), 1e-5,
                            gemma)
    assert tdx.dtype == td and tdw.dtype == td
    tol = 1e-5 if dtype == "float32" else 1e-2
    for got, want in ((tdx, _np(jdx)), (tdw, _np(jdw))):
        assert np.abs(got.float().numpy() - want).max() <= \
            tol * np.abs(want).max()


@pytest.mark.parametrize("gemma", [False, True])
def test_rms_norm_autograd_matches_jax_grad(gemma):
    """Grads of sum(sin(rms_norm(x, w))) in x and w, f32, 1e-5."""
    rng = _rng(4)
    x = rng.standard_normal((2, 7, 128)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    jgx, jgw = jax.grad(
        lambda a, b: jnp.sum(jnp.sin(jrms_norm(a, b, 1e-5, gemma))),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    torch.sin(rms_norm(xt, wt, 1e-5, gemma)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# (c) packed attention
# ---------------------------------------------------------------------------

def _packed_segments(b, t, lo, hi, seed):
    """Contiguous segments of lengths in [lo, hi] with a pad tail (id 0) on
    the even rows, as pack_sequences lays them out."""
    rng = np.random.RandomState(seed)
    seg = np.zeros((b, t), np.int32)
    for bi in range(b):
        pos, sid = 0, 1
        limit = t - (t // 8 if bi % 2 == 0 else 0)
        while pos < limit - 4:
            n = min(rng.randint(lo, hi + 1), limit - pos)
            seg[bi, pos:pos + n] = sid
            pos += n
            sid += 1
    return seg


@pytest.mark.parametrize("block", [64, 128])
def test_segment_block_metadata_matches_jax(block):
    seg = _packed_segments(3, 512, 20, 150, seed=block)
    jlo, jhi = jpa.segment_block_metadata(jnp.asarray(seg), block)
    tlo, thi = tpa.segment_block_metadata(_t(seg), block)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))


@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2)])
def test_packed_attention_matches_pallas(hq, hkv):
    """Forward and q/k/v grads of the plain twin (through the port's
    autograd.Function) against packed_flash_attention(block=128,
    interpret=True), f32, at positions with segment id != 0 (pad outputs
    are unspecified). Tolerances: out 2e-5 abs (fp32 softmax, another sum
    order); grads 1e-4 of the largest value."""
    b, t, d, max_len = 1, 256, 128, 90
    rng = _rng(5)
    q = (rng.standard_normal((b, t, hq, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, t, hkv, d)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((b, t, hkv, d)) * 0.5).astype(np.float32)
    seg = _packed_segments(b, t, 30, max_len, seed=hq)
    real = (seg != 0)[..., None, None].astype(np.float32)

    def jfn(q_, k_, v_):
        return jpa.packed_flash_attention(q_, k_, v_, jnp.asarray(seg),
                                          max_segment_len=max_len, block=128,
                                          interpret=True)

    jout = np.asarray(jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    jgrads = jax.grad(lambda *a: jnp.sum((jfn(*a) * real) ** 2),
                      argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v))
    qt, kt, vt = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = tpa.packed_flash_attention(qt, kt, vt, _t(seg),
                                     max_segment_len=max_len)
    torch.sum((out * _t(real)) ** 2).backward()
    mask = np.broadcast_to(real.astype(bool), jout.shape)
    assert np.abs(out.detach().numpy() - jout)[mask].max() < 2e-5
    for name, got, want in zip("qkv", (qt.grad, kt.grad, vt.grad), jgrads):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < 1e-4, (name, err)


def test_packed_attention_plain_matches_attention_ref():
    """The plain twin's output and lse against attention_ref (and a direct
    logsumexp) at real positions, bf16 inputs: the twin pre-scales q in
    bf16 as the kernel does, attention_ref scales in fp32, so 1e-2."""
    b, t, hq, hkv, d = 2, 128, 4, 2, 128
    rng = _rng(6)
    q, k, v = (_t((rng.standard_normal((b, t, h, d)) * 0.5)
                  .astype(np.float32)).to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    seg = _t(_packed_segments(b, t, 10, 60, seed=1))
    out, lse = tpa.packed_attention_fwd_ref(q, k, v, seg, d ** -0.5)
    ref = tatt.attention_ref(q, k, v, causal=True, segment_ids=seg)
    real = (seg != 0)[..., None, None].expand_as(out)
    assert ((out.float() - ref.float()).abs()[real]).max() < 1e-2
    assert lse.shape == (b, hq, t) and torch.isfinite(lse).all()


def test_packed_attention_rejects_oversized_segment():
    seg = np.zeros((1, 128), np.int32)
    seg[0, :100] = 1
    x = torch.zeros((1, 128, 2, 128))
    with pytest.raises(ValueError, match="exceeds max_segment_len"):
        tpa.packed_flash_attention(x, x, x, _t(seg), max_segment_len=64)


def test_attention_ref_matches_jax():
    """attention_ref with causal + segment ids + GQA + window, f32, 1e-5."""
    b, t, hq, hkv, d = 2, 64, 4, 2, 32
    rng = _rng(7)
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    seg = _packed_segments(b, t, 5, 20, seed=2)
    for window in (None, 8):
        want = jattention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, segment_ids=jnp.asarray(seg),
                              window=window)
        got = tatt.attention(_t(q), _t(k), _t(v), causal=True,
                             segment_ids=_t(seg), window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("route,kw,kernel", [
    ("window", dict(window=8, causal=False), "K18"),
    ("softcap", dict(softcap=30.0, causal=False), "K18"),
    ("sinks", dict(sinks=torch.zeros(4, device="meta")), "K17"),
])
def test_unported_device_routes_raise(route, kw, kernel):
    """Off the CPU every route without a kernel raises and names the TPU
    kernel it waits for (a meta tensor stands in for a CUDA one): sinks
    at a head dim K17 is not built for (it takes gpt-oss's 64, these
    tensors have 128), and a window or softcap without causality (K18's
    non-causal form; the causal one is ported)."""
    q = torch.empty((1, 128, 4, 128), device="meta")
    k = torch.empty((1, 128, 2, 128), device="meta")
    seg = torch.empty((1, 128), dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError, match=kernel):
        tatt.attention(q, k, k, segment_ids=seg, **kw)


def _recorder(calls, name, result):
    def launch(*args, **kw):
        calls.append(name)
        return result(*args)
    return launch


@pytest.mark.parametrize("with_segments", [True, False])
def test_unpacked_device_route_reaches_k16(monkeypatch, with_segments):
    """Off the CPU, causal attention without a declared segment bound (a
    padded row, or no segment ids) goes to the K16 kernel wrappers: the
    forward, then dq and dk/dv in the backward, at a ragged T (a meta
    tensor stands in for a CUDA one; the launchers are recorded)."""
    b, t, hq, hkv, d = 2, 100, 4, 2, 128
    calls = []
    meta = dict(device="meta")
    monkeypatch.setattr(tfa, "flash_attention_fwd", _recorder(
        calls, "fwd", lambda q, *_: (torch.empty_like(q),
                                     torch.empty((b, hq, t), **meta))))
    monkeypatch.setattr(tfa, "flash_attention_dq", _recorder(
        calls, "dq", lambda q, *_: (torch.empty_like(q),
                                    torch.empty((b, hq, t), **meta))))
    monkeypatch.setattr(tfa, "flash_attention_dkv", _recorder(
        calls, "dkv", lambda q, k, v, *_: (torch.empty_like(k),
                                           torch.empty_like(v))))
    q = torch.empty((b, t, hq, d), requires_grad=True, **meta)
    k = torch.empty((b, t, hkv, d), requires_grad=True, **meta)
    seg = torch.ones((b, t), dtype=torch.int32, **meta) if with_segments \
        else None
    out = tatt.attention(q, k, k, segment_ids=seg)
    assert calls == ["fwd"] and out.shape == q.shape
    out.sum().backward()
    assert calls == ["fwd", "dq", "dkv"]
    assert q.grad.shape == q.shape and k.grad.shape == k.shape


@pytest.mark.parametrize("window,softcap,bound", [
    (8, None, None), (None, 30.0, None), (4096, 50.0, None),
    (8, 50.0, 64)])
def test_window_softcap_device_route_reaches_k18(monkeypatch, window,
                                                 softcap, bound):
    """Off the CPU, causal attention with a sliding window or a softcap goes
    to the K18 kernel wrappers (the forward, then dq and dk/dv in the
    backward) with its window, softcap and scale, at head dim 256 and a
    ragged T, packed rows under a declared segment bound included (a meta
    tensor stands in for a CUDA one; the launchers are recorded)."""
    from unsloth_tpu_torch.ops import splash_attention as tsa

    b, t, hq, hkv, d = 2, 100, 4, 2, 256
    calls = []
    meta = dict(device="meta")

    def record(name, result):
        def launch(*args, **kw):
            calls.append((name, kw["window"], kw["softcap"], kw["scale"]))
            return result(*args)
        return launch

    monkeypatch.setattr(tsa, "splash_attention_fwd", record(
        "fwd", lambda q, *_: (torch.empty_like(q),
                              torch.empty((b, hq, t), **meta))))
    monkeypatch.setattr(tsa, "splash_attention_dq", record(
        "dq", lambda q, *_: (torch.empty_like(q),
                             torch.empty((b, hq, t), **meta))))
    monkeypatch.setattr(tsa, "splash_attention_dkv", record(
        "dkv", lambda q, k, v, *_: (torch.empty_like(k),
                                    torch.empty_like(v))))
    q = torch.empty((b, t, hq, d), requires_grad=True, **meta)
    k = torch.empty((b, t, hkv, d), requires_grad=True, **meta)
    seg = torch.ones((b, t), dtype=torch.int32, **meta)
    with tatt.packed_segment_bound(bound):
        out = tatt.attention(q, k, k, segment_ids=seg, window=window,
                             softcap=softcap, scale=0.0625)
    assert calls == [("fwd", window, softcap, 0.0625)]
    out.sum().backward()
    assert [c[0] for c in calls] == ["fwd", "dq", "dkv"]
    assert len(set(c[1:] for c in calls)) == 1
    assert q.grad.shape == q.shape and k.grad.shape == k.shape


def test_full_logits_ce_off_cpu_reaches_k7_k8(monkeypatch):
    """Off the CPU the full-logits CE goes to the K7 wrapper forward and
    the K8 wrapper backward (a meta tensor stands in for a CUDA one)."""
    calls = []
    monkeypatch.setattr(tce_full, "cross_entropy_fwd", _recorder(
        calls, "K7", lambda x, *_: (torch.empty(x.shape[:1], device="meta"),
                                    torch.empty(x.shape[:1], device="meta"))))
    monkeypatch.setattr(tce_full, "cross_entropy_bwd", _recorder(
        calls, "K8", lambda x, *_: torch.empty_like(x)))
    logits = torch.empty((4, 32), device="meta", requires_grad=True)
    labels = torch.empty((4,), dtype=torch.int64, device="meta")
    loss = fast_cross_entropy_loss(logits, labels)
    assert calls == ["K7"]
    loss.backward()
    assert calls == ["K7", "K8"] and logits.grad.shape == logits.shape


def test_segment_bound_context_nests():
    assert tatt.current_segment_bound() is None
    with tatt.packed_segment_bound(512):
        with tatt.packed_segment_bound(None):
            assert tatt.current_segment_bound() is None
        assert tatt.current_segment_bound() == 512
    assert tatt.current_segment_bound() is None


# ---------------------------------------------------------------------------
# (d) chunked fused CE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("softcap,logit_scale,n_items", [
    (None, None, None), (30.0, 0.5, 500.0)])
def test_fused_ce_matches_jax(softcap, logit_scale, n_items):
    """Loss and grads in hidden and a trainable head, 300 rows in chunks of
    128 (a ragged last chunk), some labels ignored; f32, 1e-5."""
    rng = _rng(8)
    h = rng.standard_normal((300, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 500)) * 0.1).astype(np.float32)
    labels = rng.integers(0, 500, 300).astype(np.int32)
    labels[rng.random(300) < 0.2] = -100
    ni = None if n_items is None else jnp.float32(n_items)

    def jloss(h_, w_):
        return jce.fused_ce_loss_mean(h_, w_, jnp.asarray(labels),
                                      n_items=ni, softcap=softcap,
                                      logit_scale=logit_scale,
                                      chunk_size=128)

    jl, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    ht, wt = _t(h).requires_grad_(True), _t(w).requires_grad_(True)
    tl = tce.fused_ce_loss_mean(
        ht, wt, _t(labels), n_items=None if n_items is None
        else torch.tensor(n_items), softcap=softcap, logit_scale=logit_scale,
        chunk_size=128)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jgh), atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), atol=1e-5)


def test_fused_ce_frozen_head_skips_weight_grad():
    rng = _rng(9)
    h = _t(rng.standard_normal((40, 16)).astype(np.float32)).requires_grad_()
    w = _t(rng.standard_normal((16, 50)).astype(np.float32))
    labels = _t(rng.integers(0, 50, 40).astype(np.int32))
    loss_sum, n_valid = tce.fused_linear_cross_entropy(
        h, w, None, labels, chunk_size=16, w_trainable=False)
    loss_sum.backward()
    assert int(n_valid) == 40 and h.grad is not None and w.grad is None


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def test_packing_matches_jax():
    rng = np.random.RandomState(0)
    docs = [{"input_ids": rng.randint(1, 200, rng.randint(5, 90)).tolist()}
            for _ in range(40)]
    jrows = jpack.batch_packed_rows(jpack.pack_sequences(docs, 128), 3, 128)
    trows = tpack.batch_packed_rows(tpack.pack_sequences(docs, 128), 3, 128)
    assert len(jrows) == len(trows)
    for jb, tb in zip(jrows, trows):
        for key, arr in jb.as_dict().items():
            np.testing.assert_array_equal(tb.as_dict()[key], arr)
        assert tpack.max_segment_length(tb.segment_ids) == \
            jpack.max_segment_length(jb.segment_ids)
    with pytest.raises(ValueError, match="max_segment_len"):
        tpack.validate_segment_bound(trows, 10)
