"""Splash attention: causal self-attention with a sliding window, a logit
softcap, segment ids and GQA, in PyTorch with hand-written CUDA kernels
(K18).

Counterpart of unsloth_tpu/ops/attention.py:_tpu_splash, which runs the
bundled ``jax.experimental.pallas.ops.tpu.splash_attention`` kernels
(built in ``_splash_kernel``) with a ``CausalMask``, or a
``LocalMask(window_size=(window - 1, 0))`` when a window is given, per kv
head. What they compute, as ``_tpu_splash`` feeds them:

* q is multiplied by ``scale`` in its own dtype first (``q * scale``);
* s = q_scaled . k in fp32; with a softcap c, s' = c * tanh(s / c);
* token i attends to token j iff j <= i, i - j < window (when given) and
  their segment ids are equal (no segment ids: one segment); every output
  is defined, pad positions included;
* the backward: dS' = P * (dP - di), dS = dS' * (1 - tanh^2(s / c)) when
  capped; dq = scale * (dS @ k), dk = dS^T @ q_scaled, dv = P^T @ dout,
  dk and dv summed over each kv head's query heads.

On CUDA tensors :func:`splash_attention` runs ``csrc/splash_attention.cu``:
:func:`splash_attention_fwd` (out and an fp32 logsumexp),
:func:`splash_attention_dq` (dq, and di = sum(dout * out)) and
:func:`splash_attention_dkv` (dk, dv), each with its own launch count. On
CPU tensors it runs the plain versions :func:`splash_attention_fwd_ref`
and :func:`splash_attention_bwd_ref` in fp32. The device of q is the only
thing that chooses.

Layout: the model's, q [B, T, Hq, D], k, v [B, T, Hkv, D], segment ids
[B, T] int, lse [B, Hq, T]. CUDA: bf16, D = 64, 128 or 256, any T;
anything else raises. Not ported: the shared-prefix (GRPO) mask and the non-causal
``FullMask`` forms of the same kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels
from .flash_attention import (_check_kernel_inputs, _mask, _stream,
                              tile_segment_ranges)

#: head dims the CUDA kernels are built for
KERNEL_HEAD_DIMS = (64, 128, 256)


def _scaled_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale in q's dtype (the JAX wrapper's rounding), then fp32."""
    return (q * scale).to(q.dtype).to(torch.float32)


def _kv_heads(q: torch.Tensor, k: torch.Tensor):
    """(kv head, slice of its query heads) for each kv head."""
    g = q.shape[2] // k.shape[2]
    return [(h, slice(h * g, (h + 1) * g)) for h in range(k.shape[2])]


def _capped(s: torch.Tensor, softcap: Optional[float]):
    """(s', tanh(s / c) or None)."""
    if softcap is None:
        return s, None
    t = torch.tanh(s / softcap)
    return softcap * t, t


# ---------------------------------------------------------------------------
# plain versions (CPU path; the card's kernels are held against them)
# ---------------------------------------------------------------------------

def splash_attention_fwd_ref(q, k, v, segment_ids: Optional[torch.Tensor], *,
                             window: Optional[int], softcap: Optional[float],
                             scale: float
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward in fp32, one kv head (and its query heads) at a time:
    (out [B, T, Hq, D] in q.dtype, lse [B, Hq, T] fp32)."""
    b, t, hq, d = q.shape
    mask = _mask(segment_ids, b, t, q.device, window)[:, None]
    qs = _scaled_q(q, scale)
    out = torch.empty((b, t, hq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    for h, grp in _kv_heads(q, k):
        s = torch.einsum("btgd,bsd->bgts", qs[:, :, grp],
                         k[:, :, h].to(torch.float32))
        s = _capped(s, softcap)[0].masked_fill(~mask, float("-inf"))
        lse[:, grp] = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[:, grp, :, None])
        out[:, :, grp] = torch.einsum("bgts,bsd->btgd", p,
                                      v[:, :, h].to(torch.float32))
    return out.to(q.dtype), lse


def splash_attention_bwd_ref(q, k, v, segment_ids: Optional[torch.Tensor],
                             out, lse, dout, *, window: Optional[int],
                             softcap: Optional[float], scale: float):
    """Plain backward from the saved (out, lse), with the bundled kernels'
    formulas in fp32 (module docstring), one kv head at a time. Returns
    (dq, dk, dv) in the input dtypes."""
    b, t, hq, d = q.shape
    mask = _mask(segment_ids, b, t, q.device, window)[:, None]
    qs = _scaled_q(q, scale)
    dof = dout.to(torch.float32)
    di = (dof * out.to(torch.float32)).sum(-1).transpose(1, 2)  # [B, H, T]
    dq = torch.empty((b, t, hq, d), dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    for h, grp in _kv_heads(q, k):
        kh, vh = k[:, :, h].to(torch.float32), v[:, :, h].to(torch.float32)
        s, tanh = _capped(torch.einsum("btgd,bsd->bgts", qs[:, :, grp], kh),
                          softcap)
        p = torch.where(mask, torch.exp(s - lse[:, grp, :, None]),
                        torch.zeros((), device=q.device))
        dp = torch.einsum("btgd,bsd->bgts", dof[:, :, grp], vh)
        ds = p * (dp - di[:, grp, :, None])
        if tanh is not None:
            ds = ds * (1 - tanh * tanh)
        dq[:, :, grp] = torch.einsum("bgts,bsd->btgd", ds, kh) * scale
        dk[:, :, h] = torch.einsum("bgts,btgd->bsd", ds, qs[:, :, grp])
        dv[:, :, h] = torch.einsum("bgts,btgd->bsd", p, dof[:, :, grp])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _options(window: Optional[int], softcap: Optional[float]):
    """The kernels' runtime window and softcap: 0 for none."""
    return (0 if window is None else int(window),
            0.0 if softcap is None else float(softcap))


def splash_attention_fwd(q, k, v, segment_ids, seg_min, seg_max, *,
                         window: Optional[int], softcap: Optional[float],
                         scale: float):
    """Kernel forward: (out [B, T, Hq, D] bf16, lse [B, Hq, T] fp32)."""
    _check_kernel_inputs("splash_attention_fwd", q, k, v, segment_ids,
                         KERNEL_HEAD_DIMS)
    b, t, hq, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    seg = segment_ids.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    rc = kernels.library().unsloth_splash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        seg_min.data_ptr(), seg_max.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, t, hq, k.shape[2], d, float(scale),
        *_options(window, softcap), _stream(q))
    kernels.check(rc, "splash_attention_fwd")
    splash_attention_fwd.launches += 1
    return out, lse


#: number of kernel launches since the last reset (CPU calls do not count)
splash_attention_fwd.launches = 0


def splash_attention_dq(q, k, v, segment_ids, seg_min, seg_max, out, lse,
                        dout, *, window: Optional[int],
                        softcap: Optional[float], scale: float):
    """Kernel dq: (dq [B, T, Hq, D] bf16, di [B, Hq, T] fp32)."""
    _check_kernel_inputs("splash_attention_dq", q, k, v, segment_ids,
                         KERNEL_HEAD_DIMS)
    b, t, hq, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out, dout = out.contiguous(), dout.to(q.dtype).contiguous()
    seg = segment_ids.to(torch.int32).contiguous()
    lse = lse.contiguous()
    di = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    rc = kernels.library().unsloth_splash_attn_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        seg_min.data_ptr(), seg_max.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(), b, t,
        hq, k.shape[2], d, float(scale), *_options(window, softcap),
        _stream(q))
    kernels.check(rc, "splash_attention_dq")
    splash_attention_dq.launches += 1
    return dq, di


#: number of kernel launches since the last reset (CPU calls do not count)
splash_attention_dq.launches = 0


def splash_attention_dkv(q, k, v, segment_ids, seg_min, seg_max, lse, di,
                         dout, *, window: Optional[int],
                         softcap: Optional[float], scale: float):
    """Kernel dk/dv: (dk, dv) [B, T, Hkv, D] bf16, from the dq kernel's
    di."""
    _check_kernel_inputs("splash_attention_dkv", q, k, v, segment_ids,
                         KERNEL_HEAD_DIMS)
    b, t, hq, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dout = dout.to(q.dtype).contiguous()
    seg = segment_ids.to(torch.int32).contiguous()
    lse, di = lse.contiguous(), di.contiguous()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = kernels.library().unsloth_splash_attn_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        seg_min.data_ptr(), seg_max.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t,
        hq, k.shape[2], d, float(scale), *_options(window, softcap),
        _stream(q))
    kernels.check(rc, "splash_attention_dkv")
    splash_attention_dkv.launches += 1
    return dk, dv


#: number of kernel launches since the last reset (CPU calls do not count)
splash_attention_dkv.launches = 0


class _SplashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, window, softcap, scale):
        opts = dict(window=window, softcap=softcap, scale=scale)
        if q.device.type == "cpu":
            out, lse = splash_attention_fwd_ref(q, k, v, segment_ids, **opts)
            ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        else:
            if segment_ids is None:
                segment_ids = torch.zeros(q.shape[:2], dtype=torch.int32,
                                          device=q.device)
            seg_min, seg_max = tile_segment_ranges(segment_ids)
            out, lse = splash_attention_fwd(q, k, v, segment_ids, seg_min,
                                            seg_max, **opts)
            ctx.save_for_backward(q, k, v, segment_ids, out, lse, seg_min,
                                  seg_max)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, out, lse, *ranges = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = splash_attention_bwd_ref(q, k, v, segment_ids, out,
                                                  lse, dout, **ctx.opts)
        else:
            dq, di = splash_attention_dq(q, k, v, segment_ids, *ranges, out,
                                         lse, dout, **ctx.opts)
            dk, dv = splash_attention_dkv(q, k, v, segment_ids, *ranges, lse,
                                          di, dout, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def splash_attention(q, k, v, segment_ids: Optional[torch.Tensor] = None, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None):
    """Causal attention with an optional sliding window (i - j < window),
    logit softcap and segment ids; differentiable in q, k, v. q [B, T, Hq,
    D]; k, v [B, T, Hkv, D] with Hq % Hkv == 0."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"splash_attention: Hq={q.shape[2]} is not a "
                         f"multiple of Hkv={k.shape[2]}")
    if window is not None and window <= 0:
        raise ValueError(f"splash_attention: window={window} must be > 0")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"splash_attention: softcap={softcap} must be > 0")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _SplashAttention.apply(q, k, v, segment_ids, window, softcap,
                                  float(scale))
