"""Segment-block-sparse flash attention for packed rows, in PyTorch with
hand-written CUDA kernels.

Counterpart of unsloth_tpu/ops/packed_attention.py. A packed SFT row
holds many short documents; tokens attend only within their segment, so
each 64-token query block visits only the kv blocks from its first token's
segment start up to the diagonal, and the kv range is also capped by the
packer's declared longest segment (``max_segment_len``). The work is
O(sum of segment lengths squared) instead of O(T^2).

On CUDA tensors :func:`packed_flash_attention` runs the forward (TPU
``_fwd_kernel``: the output and an fp32 logsumexp) on K16's Hopper
forward (``csrc/flash_fwd.cu``, through ``ops/flash_attention.py``) with q
pre-scaled in bf16, as the JAX wrapper pre-scales it, and the backward
pair of ``csrc/packed_attention.cu``, dq (TPU ``_dq_kernel``) then dk/dv
(TPU ``_dkv_kernel``), which read that forward's out and lse. On CPU
tensors it runs the plain versions :func:`packed_attention_fwd_ref` and
:func:`packed_attention_bwd_ref`: causal attention within each segment, in
fp32. The device of q is the only thing that chooses.

Contract (as in the JAX package): every *real* segment fits in
``max_segment_len`` tokens. The padding tail (segment id 0) may be longer;
outputs at pad positions are then finite but unspecified (the backward
kernels visit a bounded subset of the pad tokens, the forward and the
plain versions all of them), and nothing downstream reads them. Layout:
the model's, q [B, T, Hq, D], k, v [B, T, Hkv, D], segment ids [B, T] int
with equal ids contiguous.
"""

from __future__ import annotations

import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..data.packing import max_segment_length
from .flash_attention import _fwd as _flash_fwd
from .flash_attention import tile_segment_ranges

#: lse of a row with no valid key (cannot happen for a real token, which
#: always sees itself; keeps exp(s - lse) at 0 instead of inf if it does)
EMPTY_LSE = 1e30
#: tokens per kernel tile (query and kv blocks); the card's choice, not the
#: TPU's 512
BLOCK = 64
#: head dim the CUDA kernels are built for
KERNEL_HEAD_DIM = 128


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


def bound_blocks(max_segment_len: int, block: int) -> int:
    """kv blocks a query block can need: the segment of its first token
    starts at most max_segment_len - 1 tokens earlier, plus the diagonal."""
    return min(-(-max_segment_len // block) + 1, 1 << 30)


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
    if q.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device {q.device}")
    b, t, hq, d = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(
            f"{name} CUDA kernel takes bfloat16 q/k/v, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}")
    if d != KERNEL_HEAD_DIM or k.shape[3] != d or v.shape != k.shape:
        raise NotImplementedError(
            f"{name} CUDA kernel is built for head_dim {KERNEL_HEAD_DIM}; "
            f"got q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if t % BLOCK or k.shape[:2] != (b, t) or hq % k.shape[2]:
        raise ValueError(f"{name}: needs T % {BLOCK} == 0, k/v over the "
                         f"same [B, T] and Hq % Hkv == 0; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if segment_ids.shape != (b, t) or segment_ids.device != q.device:
        raise ValueError(f"{name}: segment_ids {tuple(segment_ids.shape)} "
                         f"on {segment_ids.device}, q on {q.device}")


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
    _check_kernel_inputs("packed_attention_fwd", q, k, v, segment_ids)
    seg_min, seg_max = tile_segment_ranges(segment_ids)
    res = _flash_fwd("packed_attention_fwd", _prescale(q, scale), k, v,
                     segment_ids, seg_min, seg_max, 1.0, True, tile_classes)
    packed_attention_fwd.launches += 1
    return res


packed_attention_fwd.launches = 0


def packed_attention_bwd(q, k, v, segment_ids, kv_lo, q_hi, out, lse, dout,
                         *, scale: float, n_kv: int):
    """Kernel backward: (dq [B, T, Hq, D], dk, dv [B, T, Hkv, D]) in bf16.
    One launch of the dq kernel (which also forms di = sum(dout * out))
    and one of the dk/dv kernel; counted as one backward launch."""
    _check_kernel_inputs("packed_attention_bwd", q, k, v, segment_ids)
    b, t, hq, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out, dout = out.contiguous(), dout.to(q.dtype).contiguous()
    lse = lse.contiguous()
    seg = segment_ids.to(torch.int32).contiguous()
    kv_lo = kv_lo.to(torch.int32).contiguous()
    q_hi = q_hi.to(torch.int32).contiguous()
    di = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    scale_q = float(torch.tensor(scale, dtype=q.dtype))
    rc = kernels.library().unsloth_packed_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        kv_lo.data_ptr(), q_hi.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, t, hq, k.shape[2], int(n_kv), scale_q,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(rc, "packed_attention_bwd")
    packed_attention_bwd.launches += 1
    return dq, dk, dv


packed_attention_bwd.launches = 0


class _PackedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, scale, max_segment_len):
        if q.device.type == "cpu":
            out, lse = packed_attention_fwd_ref(q, k, v, segment_ids, scale)
            ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        else:
            n_kv = min(bound_blocks(max_segment_len, BLOCK),
                       q.shape[1] // BLOCK)
            kv_lo, q_hi = segment_block_metadata(segment_ids, BLOCK)
            out, lse = packed_attention_fwd(q, k, v, segment_ids,
                                            scale=scale)
            ctx.n_kv = n_kv
            ctx.save_for_backward(q, k, v, segment_ids, out, lse, kv_lo,
                                  q_hi)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, out, lse, *meta = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = packed_attention_bwd_ref(q, k, v, segment_ids, out,
                                                  lse, dout, ctx.scale)
        else:
            kv_lo, q_hi = meta
            dq, dk, dv = packed_attention_bwd(
                q, k, v, segment_ids, kv_lo, q_hi, out, lse, dout,
                scale=ctx.scale, n_kv=ctx.n_kv)
        return dq, dk, dv, None, None, None


def packed_flash_attention(q, k, v, segment_ids: torch.Tensor, *,
                           max_segment_len: int,
                           scale: Optional[float] = None):
    """Causal packed attention, O(sum len_i^2) instead of O(T^2);
    differentiable in q, k, v.

    q [B, T, Hq, D]; k, v [B, T, Hkv, D]; segment_ids [B, T] int with equal
    ids contiguous (pad tail = id 0). max_segment_len: the packer's
    per-document cap; a real segment above it raises ValueError.
    CUDA: bf16, D = 128, T % 64 == 0; anything else raises."""
    b, t, hq, d = q.shape
    if hq % k.shape[2]:
        raise ValueError(f"packed_flash_attention: Hq={hq} is not a "
                         f"multiple of Hkv={k.shape[2]}")
    check_segment_bound(segment_ids, max_segment_len)
    if scale is None:
        scale = d ** -0.5
    return _PackedAttention.apply(q, k, v, segment_ids, float(scale),
                                  int(max_segment_len))
