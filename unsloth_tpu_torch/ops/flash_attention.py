"""Causal flash attention for unpacked or padded rows, in PyTorch with
hand-written CUDA kernels (K16).

Counterpart of the bundled ``jax.experimental.pallas.ops.tpu.
flash_attention`` that unsloth_tpu/ops/attention.py:_tpu_flash calls: its
forward kernel and its ``_flash_attention_bwd_dq`` and
``_flash_attention_bwd_dkv`` kernels. Token i of a row attends to token j
iff j <= i and their segment ids are equal, over the *whole* causal range
(no segment ids: one segment). Every output is defined: on a padded row
(segment 1 = real, 0 = pad) a pad query attends the pad keys at or before
it. Scale: the scores are formed in fp32 and multiplied by ``sm_scale``
there, as in the bundled kernel.

On CUDA tensors :func:`flash_attention` runs ``csrc/flash_attention.cu``:
:func:`flash_attention_fwd` (out and an fp32 logsumexp),
:func:`flash_attention_dq` (dq, and di = sum(dout * out)) and
:func:`flash_attention_dkv` (dk, dv summed over the query heads of each
kv head), each with its own launch count. On CPU tensors it runs the plain
versions :func:`flash_attention_fwd_ref` and :func:`flash_attention_bwd_ref`
in fp32. The device of q is the only thing that chooses.

Layout: the model's, q [B, T, Hq, D], k, v [B, T, Hkv, D], segment ids
[B, T] int, lse [B, Hq, T]. CUDA: bf16, D = 64, 128 or 256 (JAX runs the
bundled kernel at any head dim that is a multiple of 64; the models the
port loads have 64, 128 or 256), any T; anything else raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels

#: tokens per kernel tile (query and kv)
BLOCK = 64
#: head dims the CUDA kernels are built for
KERNEL_HEAD_DIMS = (64, 128, 256)


def _mask(segment_ids: Optional[torch.Tensor], b: int, t: int, device,
          window: Optional[int] = None) -> torch.Tensor:
    """[B, T, T] bool: causal, within the window (i - j < window) and with
    equal segment ids, where given."""
    pos = torch.arange(t, device=device)
    diff = pos[:, None] - pos[None, :]
    mask = diff >= 0
    if window is not None:
        mask = mask & (diff < window)
    if segment_ids is None:
        return mask[None].expand(b, t, t)
    return mask[None] & (segment_ids[:, :, None] == segment_ids[:, None, :])


def _expand_kv(x: torch.Tensor, hq: int) -> torch.Tensor:
    return x.to(torch.float32).repeat_interleave(hq // x.shape[2], dim=2)


# ---------------------------------------------------------------------------
# plain versions (CPU path; the card's kernels are held against them)
# ---------------------------------------------------------------------------

def flash_attention_fwd_ref(q, k, v, segment_ids: Optional[torch.Tensor],
                            scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward in fp32: (out [B, T, Hq, D] in q.dtype, lse [B, Hq, T]
    fp32)."""
    b, t, hq, _ = q.shape
    s = torch.einsum("bthd,bshd->bhts", q.to(torch.float32),
                     _expand_kv(k, hq)) * scale
    mask = _mask(segment_ids, b, t, q.device)[:, None]
    s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                       # [B, H, T]
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhts,bshd->bthd", p, _expand_kv(v, hq))
    return out.to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, segment_ids: Optional[torch.Tensor],
                            out, lse, dout, scale: float):
    """Plain backward from the saved (out, lse), with the bundled kernels'
    formulas in fp32: di = sum(dout * out), p = exp(s - lse),
    ds = p * (dp - di) * scale; dq = ds @ k, dk = ds^T @ q, dv = p^T @ dout,
    dk and dv summed over each kv head's query heads. Returns (dq, dk, dv)
    in the input dtypes."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    qf, dof = q.to(torch.float32), dout.to(torch.float32)
    kf, vf = _expand_kv(k, hq), _expand_kv(v, hq)
    s = torch.einsum("bthd,bshd->bhts", qf, kf) * scale
    mask = _mask(segment_ids, b, t, q.device)[:, None]
    p = torch.where(mask, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=q.device))
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    di = (dof * out.to(torch.float32)).sum(-1).transpose(1, 2)  # [B, H, T]
    ds = p * (dp - di[..., None]) * scale
    dq = torch.einsum("bhts,bshd->bthd", ds, kf)
    dk = torch.einsum("bhts,bthd->bshd", ds, qf)
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    dk = dk.reshape(b, t, hkv, hq // hkv, d).sum(3)
    dv = dv.reshape(b, t, hkv, hq // hkv, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def tile_segment_ranges(segment_ids: torch.Tensor, block: int = BLOCK
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, max) segment id of each ``block``-token tile, [B, ceil(T /
    block)] int32 each; the ragged last tile counts only its tokens. A
    (query tile, kv tile) pair whose ranges do not overlap holds no valid
    pair, and the kernels skip it."""
    b, t = segment_ids.shape
    pad = -t % block
    seg = segment_ids.to(torch.int32)
    if pad:   # repeat the last id: the tile's range stays its tokens'
        seg = torch.cat([seg, seg[:, -1:].expand(b, pad)], dim=1)
    tiles = seg.reshape(b, -1, block)
    return (tiles.amin(-1).contiguous(), tiles.amax(-1).contiguous())


def _check_kernel_inputs(name, q, k, v, segment_ids,
                         head_dims=KERNEL_HEAD_DIMS):
    if q.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device {q.device}")
    b, t, hq, d = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(
            f"{name} CUDA kernel takes bfloat16 q/k/v, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}")
    if d not in head_dims or k.shape[3] != d or v.shape != k.shape:
        raise NotImplementedError(
            f"{name} CUDA kernel is built for head_dim "
            f"{' or '.join(map(str, head_dims))}; got q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[:2] != (b, t) or hq % k.shape[2]:
        raise ValueError(f"{name}: needs k/v over the same [B, T] as q and "
                         f"Hq % Hkv == 0; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if segment_ids.shape != (b, t) or segment_ids.device != q.device:
        raise ValueError(f"{name}: segment_ids {tuple(segment_ids.shape)} "
                         f"on {segment_ids.device}, q on {q.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd(q, k, v, segment_ids, seg_min, seg_max, *,
                        scale: float):
    """Kernel forward: (out [B, T, Hq, D] bf16, lse [B, Hq, T] fp32)."""
    _check_kernel_inputs("flash_attention_fwd", q, k, v, segment_ids)
    b, t, hq, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    seg = segment_ids.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    rc = kernels.library().unsloth_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        seg_min.data_ptr(), seg_max.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, t, hq, k.shape[2], d, float(scale), _stream(q))
    kernels.check(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


#: number of kernel launches since the last reset (CPU calls do not count)
flash_attention_fwd.launches = 0


def flash_attention_dq(q, k, v, segment_ids, seg_min, seg_max, out, lse,
                       dout, *, scale: float):
    """Kernel dq: (dq [B, T, Hq, D] bf16, di [B, Hq, T] fp32)."""
    _check_kernel_inputs("flash_attention_dq", q, k, v, segment_ids)
    b, t, hq, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out, dout = out.contiguous(), dout.to(q.dtype).contiguous()
    seg = segment_ids.to(torch.int32).contiguous()
    lse = lse.contiguous()
    di = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    rc = kernels.library().unsloth_flash_attn_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        seg_min.data_ptr(), seg_max.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(), b, t,
        hq, k.shape[2], d, float(scale), _stream(q))
    kernels.check(rc, "flash_attention_dq")
    flash_attention_dq.launches += 1
    return dq, di


#: number of kernel launches since the last reset (CPU calls do not count)
flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, segment_ids, seg_min, seg_max, lse, di,
                        dout, *, scale: float):
    """Kernel dk/dv: (dk, dv) [B, T, Hkv, D] bf16, from the dq kernel's
    di."""
    _check_kernel_inputs("flash_attention_dkv", q, k, v, segment_ids)
    b, t, hq, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dout = dout.to(q.dtype).contiguous()
    seg = segment_ids.to(torch.int32).contiguous()
    lse, di = lse.contiguous(), di.contiguous()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = kernels.library().unsloth_flash_attn_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        seg_min.data_ptr(), seg_max.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t,
        hq, k.shape[2], d, float(scale), _stream(q))
    kernels.check(rc, "flash_attention_dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


#: number of kernel launches since the last reset (CPU calls do not count)
flash_attention_dkv.launches = 0


def flash_attention_bwd(q, k, v, segment_ids, seg_min, seg_max, out, lse,
                        dout, *, scale: float):
    """Kernel backward: the dq kernel, then the dk/dv kernel."""
    dq, di = flash_attention_dq(q, k, v, segment_ids, seg_min, seg_max, out,
                                lse, dout, scale=scale)
    dk, dv = flash_attention_dkv(q, k, v, segment_ids, seg_min, seg_max,
                                 lse, di, dout, scale=scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, scale):
        if q.device.type == "cpu":
            out, lse = flash_attention_fwd_ref(q, k, v, segment_ids, scale)
            ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        else:
            if segment_ids is None:
                segment_ids = torch.zeros(q.shape[:2], dtype=torch.int32,
                                          device=q.device)
            seg_min, seg_max = tile_segment_ranges(segment_ids)
            out, lse = flash_attention_fwd(q, k, v, segment_ids, seg_min,
                                           seg_max, scale=scale)
            ctx.save_for_backward(q, k, v, segment_ids, out, lse, seg_min,
                                  seg_max)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, out, lse, *ranges = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, segment_ids, out,
                                                 lse, dout, ctx.scale)
        else:
            dq, dk, dv = flash_attention_bwd(q, k, v, segment_ids, *ranges,
                                             out, lse, dout, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, segment_ids: Optional[torch.Tensor] = None, *,
                    scale: Optional[float] = None):
    """Causal attention with optional segment ids (equality over the whole
    causal range); differentiable in q, k, v. q [B, T, Hq, D]; k, v
    [B, T, Hkv, D] with Hq % Hkv == 0."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: Hq={q.shape[2]} is not a "
                         f"multiple of Hkv={k.shape[2]}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, segment_ids, float(scale))
