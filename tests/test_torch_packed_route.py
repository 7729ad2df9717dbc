"""The compositions K9-K11 run on the card, against the JAX package.

On a CUDA tensor ``packed_attention_fwd`` (K9) forms q * bf16(scale) in
bf16 (the JAX wrapper's product, ``_prescale``) and launches K16's Hopper
forward on it at scale 1 with the per-tile segment-id ranges: causal
attention within each segment, lse = m + ln l over [B, Hq, T].
``packed_attention_bwd`` (K10/K11) launches K18's dq and dk/dv on the
unscaled q with that forward's out and lse, no window, softcap or prefix
layout, at bf16(scale): the kernels round q * bf16(scale) to bf16 as K9's
forward was fed, dS = P (dP - di) stays unscaled, dq = bf16(scale) (dS k).
These tests run those compositions in plain PyTorch (``_prescale`` then
``flash_attention_fwd_ref(..., scale=1.0)``; ``splash_attention_bwd_ref``
with ``scale=bf16(scale)`` on JAX's forward out and lse, with which JAX's
backward runs) on a packed bf16 row of segments up to 90
tokens and a pad tail, GQA 4/2, and hold them on the real tokens to JAX's
``packed_flash_attention`` (``_packed_attn_fwd`` / ``_packed_attn_bwd``,
its Pallas kernels in interpret mode at JAX's 64-token blocks) and to the
port's plain twins ``packed_attention_fwd_ref`` / ``_bwd_ref``. Off the
CPU, ``attention()`` under a segment bound reaches K9 and K18's pair at
head dims 128 and 256 (a meta tensor stands in for the card's).

Tolerances: lse within 1e-4 of both (the same bf16 q * scale and k, fp32
scores and logsumexp in other orders); out, dq, dk and dv row by row
within ``chip_smoke.ATTN_ROW_TOL`` of JAX's (``attn_row_err``: JAX rounds
P, and in the backward dS, to bf16 before their products, the plain
compositions keep fp32) and within 2^-8 (out) or 2^-7 (dq, dk, dv; dq's
factor is bf16(scale) against the twin's fp32 scale) of the largest value
of the twin's (fp32 both, one bf16 rounding each).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATTN_ROW_TOL, attn_row_err
from tests.test_torch_head_dims import _meta, fake_kernels  # noqa: F401
from unsloth_tpu.ops import packed_attention as jpa
from unsloth_tpu_torch.ops import flash_attention as tfa
from unsloth_tpu_torch.ops import packed_attention as tpa
from unsloth_tpu_torch.ops import splash_attention as tsa

tatt = importlib.import_module("unsloth_tpu_torch.ops.attention")


def _row(t, lo, hi, pad, seed):
    """Segment ids [1, t]: segments of lo..hi tokens, then a pad tail of
    ``pad`` tokens (id 0)."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((1, t), np.int32)
    pos, sid = 0, 1
    while pos < t - pad:
        n = min(int(rng.integers(lo, hi + 1)), t - pad - pos)
        seg[0, pos:pos + n] = sid
        pos, sid = pos + n, sid + 1
    return seg


def test_card_composition_matches_jax_packed_forward():
    t, hq, hkv, d, max_len = 320, 4, 2, 128, 90
    rng = np.random.default_rng(7)
    seg = _row(t, 20, max_len, pad=50, seed=8)
    qj, kj, vj = (jnp.asarray(rng.standard_normal((1, t, h, d)).astype(
        np.float32)).astype(jnp.bfloat16) for h in (hq, hkv, hkv))
    scale = d ** -0.5
    n_kv = min(jpa._bound_blocks(max_len, 64), t // 64)
    jout, res = jpa._packed_attn_fwd(qj, kj, vj, jnp.asarray(seg), scale,
                                     64, n_kv, True)
    jout = np.asarray(jout.astype(jnp.float32))
    jlse = np.asarray(res[-1][..., 0])                      # [B, Hq, T]

    q, k, v = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (qj, kj, vj))
    segt = torch.from_numpy(seg)
    qs = tpa._prescale(q, scale)
    assert qs.dtype == torch.bfloat16
    out, lse = tfa.flash_attention_fwd_ref(qs, k, v, segt, 1.0, causal=True)
    rout, rlse = tpa.packed_attention_fwd_ref(q, k, v, segt, scale)

    real = seg[0] != 0
    assert 0 < real.sum() < t
    assert np.abs(lse.numpy() - jlse)[..., real].max() <= 1e-4
    assert (lse - rlse)[..., real].abs().max().item() <= 1e-4
    got = out[:, real].float()
    assert bool(torch.isfinite(got).all())
    assert attn_row_err(got, torch.from_numpy(jout[:, real])) <= ATTN_ROW_TOL
    want = rout[:, real].float()
    assert (got - want).abs().max().item() <= 2.0 ** -8 * want.abs().max()


def _inputs(d, seed):
    """A packed bf16 row (T 320, segments of 20-90 tokens, a 50-token pad
    tail), q, k, v and dout with GQA 4/2 at head dim ``d``, as JAX arrays
    and as CPU tensors."""
    t, hq, hkv = 320, 4, 2
    rng = np.random.default_rng(seed)
    seg = _row(t, 20, 90, pad=50, seed=seed + 1)
    js = [jnp.asarray(rng.standard_normal((1, t, h, d)).astype(
        np.float32)).astype(jnp.bfloat16) for h in (hq, hkv, hkv, hq)]
    ts = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in js]
    return seg, js, ts


@pytest.mark.parametrize("d", [128, 256])
def test_card_backward_composition_matches_jax_packed_backward(d):
    seg, (qj, kj, vj, gj), (q, k, v, dout) = _inputs(d, seed=11)
    scale = d ** -0.5
    n_kv = min(jpa._bound_blocks(90, 64), seg.shape[1] // 64)
    jout, res = jpa._packed_attn_fwd(qj, kj, vj, jnp.asarray(seg), scale,
                                     64, n_kv, True)
    jgrads = [np.asarray(x.astype(jnp.float32)) for x in
              jpa._packed_attn_bwd(scale, 64, n_kv, True, res, gj)[:3]]
    # the backward on both sides reads JAX's forward (out, lse), as the
    # card's reads K9's: di = sum(dout * out) cancels in dP - di, so a
    # forward's own rounding of out would dominate dq's comparison
    out = torch.from_numpy(np.array(jout.astype(jnp.float32))).to(
        torch.bfloat16)
    lse = torch.from_numpy(np.array(res[-1][..., 0]))      # [B, Hq, T]

    segt = torch.from_numpy(seg)
    scale_q = tpa._rounded_scale(scale, q.dtype)
    assert scale_q == float(torch.tensor(scale, dtype=torch.bfloat16))
    if d == 256:
        assert scale_q == scale
    got = tsa.splash_attention_bwd_ref(q, k, v, segt, out, lse, dout,
                                       window=None, softcap=None,
                                       scale=scale_q)
    twin = tpa.packed_attention_bwd_ref(q, k, v, segt, out, lse, dout, scale)

    real = seg[0] != 0
    for name, g_, j_, w_ in zip(("dq", "dk", "dv"), got, jgrads, twin):
        g_, w_ = g_[:, real].float(), w_[:, real].float()
        assert bool(torch.isfinite(g_).all()), name
        assert attn_row_err(g_, torch.from_numpy(j_[:, real])) \
            <= ATTN_ROW_TOL, name
        assert (g_ - w_).abs().max().item() <= \
            2.0 ** -7 * w_.abs().max().item(), name


@pytest.mark.parametrize("d,entry", [
    (64, "unsloth_flash_attn"), (128, "unsloth_splash_attn"),
    (256, "unsloth_splash_attn")])
def test_packed_dispatch_off_cpu_reaches_k9_and_k18(fake_kernels,
                                                    monkeypatch, d, entry):
    """attention() on a packed row under a segment bound, off the CPU: at
    head dims 128 and 256 (JAX's ``Dh % 128 == 0``) the forward launches
    K9 (K16's forward entry) and the backward K18's dq and dk/dv entries,
    counted as K9's and K10/K11's launches and never as splash's or
    K16's; at 64 the flash kernels over the whole range. No plain version
    runs."""
    def no_plain(*a, **kw):
        raise AssertionError("a plain version ran on a tensor off the CPU")

    monkeypatch.setattr(tpa, "_check_attn_inputs", tfa._check_kernel_inputs)
    monkeypatch.setattr(tpa, "check_segment_bound", lambda *a: None)
    for name in ("packed_attention_fwd_ref", "packed_attention_bwd_ref"):
        monkeypatch.setattr(tpa, name, no_plain)
    fns = (tpa.packed_attention_fwd, tpa.packed_attention_bwd,
           tfa.flash_attention_fwd, tfa.flash_attention_dq,
           tfa.flash_attention_dkv, tsa.splash_attention_dq,
           tsa.splash_attention_dkv)
    before = [f.launches for f in fns]
    q, k, v = _meta(1, 128, 8, d), _meta(1, 128, 2, d), _meta(1, 128, 2, d)
    seg = torch.empty((1, 128), device="meta", dtype=torch.int32)
    with tatt.packed_segment_bound(96):
        out = tatt.attention(q, k, v, segment_ids=seg)
    out.backward(torch.empty_like(out))
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert fake_kernels.calls == [("unsloth_flash_attn_fwd", d),
                                  (entry + "_dq", d), (entry + "_dkv", d)]
    packed = d % 128 == 0
    assert [f.launches - n for f, n in zip(fns, before)] == (
        [1, 1, 0, 0, 0, 0, 0] if packed else [0, 0, 1, 1, 1, 0, 0])
