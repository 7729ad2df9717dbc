"""The composition K9's forward runs on the card, against the JAX package.

On a CUDA tensor ``packed_attention_fwd`` (K9) forms q * bf16(scale) in
bf16 (the JAX wrapper's product, ``_prescale``) and launches K16's Hopper
forward on it at scale 1 with the per-tile segment-id ranges: causal
attention within each segment, lse = m + ln l over [B, Hq, T]. This test
runs that composition in plain PyTorch, ``_prescale`` then
``flash_attention_fwd_ref(..., scale=1.0)`` with the segment ids, on a
packed bf16 row of segments up to 90 tokens and a pad tail, GQA 4/2, and
holds its out and lse on the real tokens to JAX's
``packed_flash_attention`` forward (``_packed_attn_fwd``, its Pallas
kernel in interpret mode at JAX's 64-token blocks) and to the port's
plain K9 twin ``packed_attention_fwd_ref``, which K10/K11 and phase 3 read.

Tolerances: lse within 1e-4 of both (the same bf16 q * scale and k, fp32
scores and logsumexp in other orders); out row by row within
``chip_smoke.ATTN_ROW_TOL`` of JAX's (``attn_row_err``: JAX rounds P to
bf16 before P V, the plain composition keeps fp32) and within 2^-8 of the
largest value of the twin's (both fp32, one bf16 rounding each).
"""

import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import ATTN_ROW_TOL, attn_row_err
from unsloth_tpu.ops import packed_attention as jpa
from unsloth_tpu_torch.ops import flash_attention as tfa
from unsloth_tpu_torch.ops import packed_attention as tpa


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
