"""Causal flash attention with gpt-oss attention sinks, in PyTorch with
hand-written CUDA kernels (K17).

Counterpart of unsloth_tpu/ops/attention.py:_tpu_flash_sinks, which drives
the bundled ``jax.experimental.pallas.ops.tpu.flash_attention`` kernels and
folds the sink into their softmax normalizer. The sink s_h is a learned
per-head logit that joins the softmax denominator and carries no value
(HF ``GptOssAttention``):

* forward: with the kernel's row max m and sum l, m' = max(m, s),
  l' = l e^{m-m'} + e^{s-m'}, out = o (l e^{m-m'}) / l', lse' = m' + log l';
* backward: the flash backward on lse' (its p' = exp(score - lse') is the
  sink-softmax probability) with di = sum(dout * out), and
  dsinks_h = -sum_{b,t} e^{s_h - lse'} di, a plain reduction.

Scores are q . k in fp32 times ``scale``; token i attends to token j iff
j <= i and their segment ids are equal (no segment ids: one segment).

On CUDA tensors :func:`flash_sinks` runs K16's Hopper kernels through
the entry points of ``csrc/flash_sinks.cu``: :func:`flash_sinks_fwd` (out
and lse'; K16's forward in its sinks form, the rescale folded into its
epilogue), :func:`flash_sinks_dq` (dq and di; K16's causal dq kernel fed
lse') and :func:`flash_sinks_dkv` (dk, dv; K16's causal dk/dv kernel fed
lse', each kv head's query heads split over
:func:`~.flash_attention.dkv_splits` blocks as K16's are), each with its
own launch count and under the profiler range ``unsloth.flash_sinks``, so
that a profile tells K17's device time from K16's, whose kernels it
shares. On CPU tensors it runs the plain versions
:func:`flash_sinks_fwd_ref` and :func:`flash_sinks_bwd_ref` in fp32
(``attention_ref`` with sinks, as the JAX package computes it off the
TPU). The device of q is the only thing that chooses.

Layout: q [B, T, Hq, D], k, v [B, T, Hkv, D], segment ids [B, T] int,
sinks [Hq], lse' [B, Hq, T]. CUDA: bf16 q/k/v, D = 64 (gpt-oss), 128 or
256 (JAX runs the bundled kernel at any head dim that is a multiple of
64), any T; anything else raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from .. import kernels
from .flash_attention import (KERNEL_HEAD_DIMS, _check_kernel_inputs, _mask,
                              _stream, dkv_split_scratch,
                              tile_segment_ranges)
from .splash_attention import _kv_heads

#: profiler range of every K17 launch
PROFILE_RANGE = "unsloth.flash_sinks"


# ---------------------------------------------------------------------------
# plain versions (CPU path; the card's kernels are held against them)
# ---------------------------------------------------------------------------

def flash_sinks_fwd_ref(q, k, v, segment_ids: Optional[torch.Tensor],
                        sinks: torch.Tensor, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward in fp32, one kv head (and its query heads) at a time:
    softmax over [scores, sink] with the sink column dropped. Returns (out
    [B, T, Hq, D] in q.dtype, lse' [B, Hq, T] fp32)."""
    b, t, hq, d = q.shape
    mask = _mask(segment_ids, b, t, q.device)[:, None]
    qf = q.to(torch.float32)
    sk = sinks.to(torch.float32)
    out = torch.empty((b, t, hq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    for h, grp in _kv_heads(q, k):
        s = torch.einsum("btgd,bsd->bgts", qf[:, :, grp],
                         k[:, :, h].to(torch.float32)) * scale
        s = s.masked_fill(~mask, float("-inf"))
        sink = sk[grp][None, :, None, None].expand(b, -1, t, 1)
        lse[:, grp] = torch.logsumexp(torch.cat([s, sink], dim=-1), dim=-1)
        p = torch.exp(s - lse[:, grp, :, None])
        out[:, :, grp] = torch.einsum("bgts,bsd->btgd", p,
                                      v[:, :, h].to(torch.float32))
    return out.to(q.dtype), lse


def sinks_grad(sinks: torch.Tensor, lse: torch.Tensor, di: torch.Tensor
               ) -> torch.Tensor:
    """dsinks_h = -sum_{b,t} e^{s_h - lse'} di, in sinks' dtype."""
    p_sink = torch.exp(sinks.to(torch.float32)[None, :, None] - lse)
    return (-(p_sink * di).sum(dim=(0, 2))).to(sinks.dtype)


def flash_sinks_bwd_ref(q, k, v, segment_ids: Optional[torch.Tensor], out,
                        lse, dout, sinks, scale: float):
    """Plain backward from the saved (out, lse') in fp32, one kv head at a
    time: di = sum(dout * out), p = exp(s - lse'), ds = p (dp - di);
    dq = scale ds k, dk = scale ds^T q, dv = p^T dout, dk and dv summed
    over each kv head's query heads; dsinks by :func:`sinks_grad`. Returns
    (dq, dk, dv, dsinks) in the input dtypes."""
    b, t, hq, d = q.shape
    mask = _mask(segment_ids, b, t, q.device)[:, None]
    qf, dof = q.to(torch.float32), dout.to(torch.float32)
    di = (dof * out.to(torch.float32)).sum(-1).transpose(1, 2)  # [B, H, T]
    dq = torch.empty((b, t, hq, d), dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    for h, grp in _kv_heads(q, k):
        kh, vh = k[:, :, h].to(torch.float32), v[:, :, h].to(torch.float32)
        s = torch.einsum("btgd,bsd->bgts", qf[:, :, grp], kh) * scale
        p = torch.where(mask, torch.exp(s - lse[:, grp, :, None]),
                        torch.zeros((), device=q.device))
        dp = torch.einsum("btgd,bsd->bgts", dof[:, :, grp], vh)
        ds = p * (dp - di[:, grp, :, None])
        dq[:, :, grp] = torch.einsum("bgts,bsd->btgd", ds, kh) * scale
        dk[:, :, h] = torch.einsum("bgts,btgd->bsd", ds, qf[:, :, grp]) * scale
        dv[:, :, h] = torch.einsum("bgts,btgd->bsd", p, dof[:, :, grp])
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            sinks_grad(sinks, lse, di))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def epilogue_ref(o: torch.Tensor, l: torch.Tensor, m: torch.Tensor,
                 sinks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the forward kernel's sinks epilogue, in fp32: from a
    row's unnormalised output o [..., H, D], sum l [..., H] and max m
    [..., H] in log2 units (2^(score log2(e) - m) summed; m = -inf and
    l = 0 where no key is valid), as K16's forward leaves them, and the
    sinks [H]: (out, lse') with s2 = s log2(e), m' = max(m, s2),
    l' = l 2^(m - m') + 2^(s2 - m'), out = o 2^(m - m') / l',
    lse' = (m' + log2 l') ln 2. A row with l = 0 gets out = 0 and
    lse' = s."""
    s2 = sinks.to(torch.float32) * 1.4426950408889634
    ms = torch.maximum(m, s2)
    a = torch.exp2(m - ms)
    ls = l * a + torch.exp2(s2 - ms)
    return o * (a / ls)[..., None], (ms + torch.log2(ls)) * 0.6931471805599453


def _check(name, q, k, v, segment_ids, sinks=None):
    _check_kernel_inputs(name, q, k, v, segment_ids, KERNEL_HEAD_DIMS)
    if sinks is not None and (sinks.shape != (q.shape[2],)
                              or sinks.device != q.device):
        raise ValueError(f"{name}: sinks {tuple(sinks.shape)} on "
                         f"{sinks.device} for {q.shape[2]} heads on "
                         f"{q.device}")


def flash_sinks_fwd(q, k, v, segment_ids, seg_min, seg_max, sinks, *,
                    scale: float):
    """Kernel forward: (out [B, T, Hq, D] bf16, lse' [B, Hq, T] fp32)."""
    _check("flash_sinks_fwd", q, k, v, segment_ids, sinks)
    b, t, hq, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    seg = segment_ids.to(torch.int32).contiguous()
    sk = sinks.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    with record_function(PROFILE_RANGE):
        rc = kernels.library().unsloth_flash_sinks_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            seg_min.data_ptr(), seg_max.data_ptr(), sk.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, t, hq, k.shape[2], d,
            float(scale), _stream(q))
    kernels.check(rc, "flash_sinks_fwd")
    flash_sinks_fwd.launches += 1
    return out, lse


#: number of kernel launches since the last reset (CPU calls do not count)
flash_sinks_fwd.launches = 0


def flash_sinks_dq(q, k, v, segment_ids, seg_min, seg_max, out, lse, dout,
                   *, scale: float):
    """Kernel dq: (dq [B, T, Hq, D] bf16, di [B, Hq, T] fp32)."""
    _check("flash_sinks_dq", q, k, v, segment_ids)
    b, t, hq, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out, dout = out.contiguous(), dout.to(q.dtype).contiguous()
    seg = segment_ids.to(torch.int32).contiguous()
    lse = lse.contiguous()
    di = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    with record_function(PROFILE_RANGE):
        rc = kernels.library().unsloth_flash_sinks_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            seg_min.data_ptr(), seg_max.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
            b, t, hq, k.shape[2], d, float(scale), _stream(q))
    kernels.check(rc, "flash_sinks_dq")
    flash_sinks_dq.launches += 1
    return dq, di


#: number of kernel launches since the last reset (CPU calls do not count)
flash_sinks_dq.launches = 0


def flash_sinks_dkv(q, k, v, segment_ids, seg_min, seg_max, lse, di, dout,
                    *, scale: float):
    """Kernel dk/dv: (dk, dv) [B, T, Hkv, D] bf16, from the dq kernel's
    di."""
    _check("flash_sinks_dkv", q, k, v, segment_ids)
    b, t, hq, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dout = dout.to(q.dtype).contiguous()
    seg = segment_ids.to(torch.int32).contiguous()
    lse, di = lse.contiguous(), di.contiguous()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    splits, scratch = dkv_split_scratch(q, k)
    with record_function(PROFILE_RANGE):
        rc = kernels.library().unsloth_flash_sinks_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            seg_min.data_ptr(), seg_max.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if scratch is None else scratch.data_ptr(), splits, b, t,
            hq, k.shape[2], d, float(scale), _stream(q))
    kernels.check(rc, "flash_sinks_dkv")
    flash_sinks_dkv.launches += 1
    return dk, dv


#: number of kernel launches since the last reset (CPU calls do not count)
flash_sinks_dkv.launches = 0


class _FlashSinks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sinks, segment_ids, scale):
        if q.device.type == "cpu":
            out, lse = flash_sinks_fwd_ref(q, k, v, segment_ids, sinks, scale)
            ctx.save_for_backward(q, k, v, sinks, segment_ids, out, lse)
        else:
            if segment_ids is None:
                segment_ids = torch.zeros(q.shape[:2], dtype=torch.int32,
                                          device=q.device)
            seg_min, seg_max = tile_segment_ranges(segment_ids)
            out, lse = flash_sinks_fwd(q, k, v, segment_ids, seg_min,
                                       seg_max, sinks, scale=scale)
            ctx.save_for_backward(q, k, v, sinks, segment_ids, out, lse,
                                  seg_min, seg_max)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, sinks, segment_ids, out, lse, *ranges = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv, dsk = flash_sinks_bwd_ref(q, k, v, segment_ids, out,
                                                  lse, dout, sinks, ctx.scale)
        else:
            dq, di = flash_sinks_dq(q, k, v, segment_ids, *ranges, out, lse,
                                    dout, scale=ctx.scale)
            dk, dv = flash_sinks_dkv(q, k, v, segment_ids, *ranges, lse, di,
                                     dout, scale=ctx.scale)
            dsk = sinks_grad(sinks, lse, di)
        return dq, dk, dv, dsk, None, None


def flash_sinks(q, k, v, sinks: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None, *,
                scale: Optional[float] = None):
    """Causal attention with per-head sinks [Hq] and optional segment ids;
    differentiable in q, k, v and sinks. q [B, T, Hq, D]; k, v [B, T, Hkv,
    D] with Hq % Hkv == 0."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_sinks: Hq={q.shape[2]} is not a multiple "
                         f"of Hkv={k.shape[2]}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashSinks.apply(q, k, v, sinks, segment_ids, float(scale))
