"""Segment-block-sparse flash attention for packed rows, in PyTorch with
hand-written CUDA kernels.

Counterpart of unsloth_tpu/ops/packed_attention.py. A packed SFT row
holds many short documents; tokens attend only within their segment, so
the work is O(sum of segment lengths squared) instead of O(T^2). The TPU
kernels bound each 64-token query block's kv range by its first token's
segment start and the packer's declared longest segment
(``max_segment_len``); the card's kernels visit the causal tile pairs and
skip every pair whose tiles' segment-id ranges are disjoint.

On CUDA tensors :func:`packed_flash_attention` runs the forward (K9, TPU
``_fwd_kernel``: the output and an fp32 logsumexp) on K16's Hopper
forward (``csrc/flash_fwd.cu``, through ``ops/flash_attention.py``) with q
pre-scaled in bf16, as the JAX wrapper pre-scales it, and the backward
(K10, TPU ``_dq_kernel``, then K11, TPU ``_dkv_kernel``) on K18's Hopper
dq and dk/dv (``csrc/flash_dq.cu``, ``csrc/flash_dkv.cu`` in their splash
form, through ``ops/splash_attention.py``), which read that forward's out
and lse. On CPU tensors it runs the plain versions
:func:`packed_attention_fwd_ref` and :func:`packed_attention_bwd_ref`:
causal attention within each segment, in fp32. The device of q is the
only thing that chooses.

Contract (as in the JAX package): every *real* segment fits in
``max_segment_len`` tokens; a longer one raises. The padding tail (segment
id 0) may be longer; outputs at pad positions are then finite but
unspecified, and nothing downstream reads them. Layout: the model's, q
[B, T, Hq, D], k, v [B, T, Hkv, D], segment ids [B, T] int with equal ids
contiguous. CUDA: bf16, D = 128 or 256, T % 64 == 0.
"""

from __future__ import annotations

import weakref
from typing import Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..data.packing import max_segment_length
from .flash_attention import _check_kernel_inputs as _check_attn_inputs
from .flash_attention import _fwd as _flash_fwd
from .flash_attention import tile_segment_ranges
from .splash_attention import _dkv as _splash_dkv
from .splash_attention import _dq as _splash_dq

#: lse of a row with no valid key (cannot happen for a real token, which
#: always sees itself; keeps exp(s - lse) at 0 instead of inf if it does)
EMPTY_LSE = 1e30
#: tokens per tile of the segment-id ranges (``tile_segment_ranges``); the
#: packed route takes rows of T % BLOCK == 0
BLOCK = 64
#: head dims the CUDA kernels are built for (JAX's packed kernel takes any
#: multiple of 128)
KERNEL_HEAD_DIMS = (128, 256)
#: the profiler range of the backward's launches (K18's kernels)
PROFILE_RANGE = "unsloth.packed_attention_bwd"


def segment_block_metadata(segment_ids: torch.Tensor, block: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block sparsity bounds from packed segment ids [B, T].

    Returns (kv_lo [B, T/block], q_hi [B, T/block]) int32:
    kv_lo[b, i] = block of the segment start of token i*block;
    q_hi[b, j] = block of the segment end of token (j+1)*block - 1."""
    b, t = segment_ids.shape
    dev = segment_ids.device
    idx = torch.arange(t, dtype=torch.int64, device=dev)[None].expand(b, t)
    seg = segment_ids
    differs = seg[:, 1:] != seg[:, :-1]
    ones = torch.ones((b, 1), dtype=torch.bool, device=dev)
    change = torch.cat([ones, differs], dim=1)
    start = torch.cummax(torch.where(change, idx, 0), dim=1).values
    change_next = torch.cat([differs, ones], dim=1)
    end = torch.cummin(torch.where(change_next, idx, t).flip(1),
                       dim=1).values.flip(1)
    kv_lo = (start[:, ::block] // block).to(torch.int32)
    q_hi = (end[:, block - 1::block] // block).to(torch.int32)
    return kv_lo, q_hi


def check_segment_bound(segment_ids: torch.Tensor,
                        max_segment_len: int) -> None:
    """Raise if a real segment is longer than ``max_segment_len`` (the
    kernel would silently truncate its attention span). Reads the ids on
    the host once per tensor: the layers of one forward share one."""
    ref, version, bound = _checked
    if (ref is not None and ref() is segment_ids
            and version == segment_ids._version
            and bound == int(max_segment_len)):
        return
    got = max_segment_length(segment_ids.detach().cpu().numpy())
    if got > int(max_segment_len):
        raise ValueError(
            f"segment of {got} tokens exceeds max_segment_len="
            f"{int(max_segment_len)}; attention would be silently "
            "truncated for it")
    _checked[:] = [weakref.ref(segment_ids), segment_ids._version,
                   int(max_segment_len)]


#: (weakref to the last segment-id tensor checked, its version, the bound)
_checked: list = [None, None, None]


# ---------------------------------------------------------------------------
# plain versions (CPU path; the card's kernels are held against them)
# ---------------------------------------------------------------------------

def _segments(segment_ids_row: np.ndarray):
    """(start, stop) of each contiguous run of equal ids in one row."""
    change = np.flatnonzero(np.diff(segment_ids_row)) + 1
    bounds = np.concatenate(([0], change, [segment_ids_row.shape[0]]))
    return list(zip(bounds[:-1].tolist(), bounds[1:].tolist()))


def _prescale(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale in q.dtype, the scale itself rounded to q.dtype first (the
    JAX wrapper's ``q * jnp.asarray(scale, q.dtype)``)."""
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def packed_attention_fwd_ref(q, k, v, segment_ids, scale: float):
    """Plain forward: causal attention within each contiguous segment, fp32
    scores and softmax on the pre-scaled q. Returns (out [B, T, Hq, D] in
    q.dtype, lse [B, Hq, T] fp32)."""
    b, t, hq, d = q.shape
    g = hq // k.shape[2]
    qs = _prescale(q, scale).to(torch.float32)
    kf = k.to(torch.float32).repeat_interleave(g, dim=2)
    vf = v.to(torch.float32).repeat_interleave(g, dim=2)
    out = torch.zeros((b, t, hq, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, hq, t), EMPTY_LSE, dtype=torch.float32,
                     device=q.device)
    seg_np = segment_ids.detach().cpu().numpy()
    for bi in range(b):
        for lo, hi in _segments(seg_np[bi]):
            s = torch.einsum("thd,shd->hts", qs[bi, lo:hi], kf[bi, lo:hi])
            causal = torch.ones((hi - lo, hi - lo), dtype=torch.bool,
                                device=q.device).tril()
            s = s.masked_fill(~causal, float("-inf"))
            row_lse = torch.logsumexp(s, dim=-1)              # [H, L]
            p = torch.exp(s - row_lse[..., None])
            out[bi, lo:hi] = torch.einsum("hts,shd->thd", p, vf[bi, lo:hi])
            lse[bi, :, lo:hi] = row_lse
    return out.to(q.dtype), lse


def packed_attention_bwd_ref(q, k, v, segment_ids, out, lse, dout,
                             scale: float):
    """Plain backward of :func:`packed_attention_fwd_ref` from the saved
    (out, lse), with the TPU kernels' formulas in fp32: di = sum(dout*out),
    p = exp(s - lse), ds = p * (dp - di); dq = scale * ds @ k,
    dk = ds^T @ (q * scale), dv = p^T @ dout, summed over each kv head's
    query heads. Returns (dq, dk, dv) in the input dtypes."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qs = _prescale(q, scale).to(torch.float32)
    kf = k.to(torch.float32).repeat_interleave(g, dim=2)
    vf = v.to(torch.float32).repeat_interleave(g, dim=2)
    dof = dout.to(torch.float32)
    di = (dof * out.to(torch.float32)).sum(-1)                 # [B, T, Hq]
    dq = torch.zeros((b, t, hq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    seg_np = segment_ids.detach().cpu().numpy()
    for bi in range(b):
        for lo, hi in _segments(seg_np[bi]):
            s = torch.einsum("thd,shd->hts", qs[bi, lo:hi], kf[bi, lo:hi])
            causal = torch.ones((hi - lo, hi - lo), dtype=torch.bool,
                                device=q.device).tril()
            p = torch.where(causal, torch.exp(s - lse[bi, :, lo:hi, None]),
                            torch.zeros((), device=q.device))
            dp = torch.einsum("thd,shd->hts", dof[bi, lo:hi], vf[bi, lo:hi])
            ds = p * (dp - di[bi, lo:hi].t()[..., None])
            dq[bi, lo:hi] = torch.einsum("hts,shd->thd", ds, kf[bi, lo:hi])
            dk[bi, lo:hi] = torch.einsum("hts,thd->shd", ds, qs[bi, lo:hi])
            dv[bi, lo:hi] = torch.einsum("hts,thd->shd", p, dof[bi, lo:hi])
    dk = dk.reshape(b, t, hkv, g, d).sum(3)
    dv = dv.reshape(b, t, hkv, g, d).sum(3)
    return (dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _check_kernel_inputs(name, q, k, v, segment_ids):
    _check_attn_inputs(name, q, k, v, segment_ids, KERNEL_HEAD_DIMS)
    if q.shape[1] % BLOCK:
        raise ValueError(f"{name}: needs T % {BLOCK} == 0; got q "
                         f"{tuple(q.shape)}")


def _rounded_scale(scale: float, dtype: torch.dtype) -> float:
    """``scale`` rounded to ``dtype`` (the factor :func:`_prescale` takes)."""
    return float(torch.tensor(scale, dtype=dtype))


def packed_attention_fwd(q, k, v, segment_ids, *, scale: float,
                         tile_classes=None):
    """Kernel forward: (out [B, T, Hq, D] bf16, lse [B, Hq, T] fp32 = m +
    ln l). K16's Hopper forward on q * bf16(scale) in bf16 (the JAX
    wrapper's product, :func:`_prescale`) at scale 1, over the per-tile
    segment-id ranges of ``tile_segment_ranges``: causal within segments,
    every tile pair whose ranges are disjoint skipped, P rounded to bf16
    before P V, as the TPU kernel. Pad queries attend the pad keys before
    them (their outputs stay unspecified). ``tile_classes`` (an int32 [3]
    on q's card, or None) receives the pairs it classed skip, full and
    masked."""
    seg_min, seg_max = tile_segment_ranges(segment_ids)
    return _packed_fwd(q, k, v, segment_ids, seg_min, seg_max, scale,
                       tile_classes)


def _packed_fwd(q, k, v, segment_ids, seg_min, seg_max, scale,
                tile_classes=None):
    _check_kernel_inputs("packed_attention_fwd", q, k, v, segment_ids)
    res = _flash_fwd("packed_attention_fwd", _prescale(q, scale), k, v,
                     segment_ids, seg_min, seg_max, 1.0, True, tile_classes)
    packed_attention_fwd.launches += 1
    return res


packed_attention_fwd.launches = 0


def packed_attention_bwd(q, k, v, segment_ids, seg_min, seg_max, out, lse,
                         dout, *, scale: float, tile_classes=None):
    """Kernel backward: (dq [B, T, Hq, D], dk, dv [B, T, Hkv, D]) in bf16,
    from the forward's inputs (q unscaled), its out and lse, and the
    per-tile segment-id ranges (``tile_segment_ranges``). K18's Hopper dq
    (``flash_dq_kernel<D, true>``, which also forms di = sum(dout * out))
    then K18's dk/dv (``flash_dkv_kernel<D, true>``), causal, with no
    window, softcap or prefix layout, at ``scale`` rounded to bf16: the
    kernels round q * bf16(scale) to bf16 in shared memory, the q that
    the forward scored (:func:`_prescale`), so P = exp(s - lse) reads the
    forward's lse. Rounding points are the TPU kernels': P and dS = P (dP
    - di) rounded to bf16 unscaled before their products, dk = dS^T
    q_scaled, dv = P^T dout, summed in fp32 over each kv head's query
    heads, dq = scale (dS k) rounded once. One divergence by design: the
    TPU multiplies dq's fp32 sum by the fp32 ``scale``, K18 by bf16(scale)
    (relative 1.07e-4 at D = 128, far below a bf16 ulp; equal at D = 256,
    where the scale is 1/16). ``tile_classes`` (None, or a pair of int32
    [3] on q's card: dq's, then dk/dv's) receives the tile pairs each
    kernel classed skip, full and masked, for each query head. Counted as
    one backward launch, and launched under the profiler range
    :data:`PROFILE_RANGE`, by which a profile tells K10/K11 from K18."""
    _check_kernel_inputs("packed_attention_bwd", q, k, v, segment_ids)
    scale_q = _rounded_scale(scale, q.dtype)
    dq_classes, dkv_classes = tile_classes or (None, None)
    with record_function(PROFILE_RANGE):
        dq, di = _splash_dq("packed_attention_bwd", q, k, v, segment_ids,
                            seg_min, seg_max, out, lse, dout, None, None,
                            scale_q, None, dq_classes, True)
        dk, dv = _splash_dkv("packed_attention_bwd", q, k, v, segment_ids,
                             seg_min, seg_max, lse, di, dout, None, None,
                             scale_q, None, dkv_classes, True)
    packed_attention_bwd.launches += 1
    return dq, dk, dv


packed_attention_bwd.launches = 0


class _PackedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, scale):
        if q.device.type == "cpu":
            out, lse = packed_attention_fwd_ref(q, k, v, segment_ids, scale)
            ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        else:
            seg_min, seg_max = tile_segment_ranges(segment_ids)
            out, lse = _packed_fwd(q, k, v, segment_ids, seg_min, seg_max,
                                   scale)
            ctx.save_for_backward(q, k, v, segment_ids, out, lse, seg_min,
                                  seg_max)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, out, lse, *ranges = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = packed_attention_bwd_ref(q, k, v, segment_ids, out,
                                                  lse, dout, ctx.scale)
        else:
            dq, dk, dv = packed_attention_bwd(q, k, v, segment_ids, *ranges,
                                              out, lse, dout,
                                              scale=ctx.scale)
        return dq, dk, dv, None, None


def packed_flash_attention(q, k, v, segment_ids: torch.Tensor, *,
                           max_segment_len: int,
                           scale: Optional[float] = None):
    """Causal packed attention, O(sum len_i^2) instead of O(T^2);
    differentiable in q, k, v.

    q [B, T, Hq, D]; k, v [B, T, Hkv, D]; segment_ids [B, T] int with equal
    ids contiguous (pad tail = id 0). max_segment_len: the packer's
    per-document cap; a real segment above it raises ValueError.
    CUDA: bf16, D = 128 or 256, T % 64 == 0; anything else raises."""
    b, t, hq, d = q.shape
    if hq % k.shape[2]:
        raise ValueError(f"packed_flash_attention: Hq={hq} is not a "
                         f"multiple of Hkv={k.shape[2]}")
    check_segment_bound(segment_ids, max_segment_len)
    if scale is None:
        scale = d ** -0.5
    return _PackedAttention.apply(q, k, v, segment_ids, float(scale))
