"""Flash attention for unpacked or padded rows, causal or not, in PyTorch
with hand-written CUDA kernels (K16).

Counterpart of the bundled ``jax.experimental.pallas.ops.tpu.
flash_attention`` that unsloth_tpu/ops/attention.py:_tpu_flash calls: its
forward kernel and its ``_flash_attention_bwd_dq`` and
``_flash_attention_bwd_dkv`` kernels, with ``causal=True`` and with
``causal=False`` (the text-diffusion models' bidirectional attention).
Token i of a row attends to token j iff their segment ids are equal and,
causal, j <= i, over the *whole* range (no segment ids: one segment).
Every output is defined: on a padded row (segment 1 = real, 0 = pad) a pad
query attends the pad keys (at or before it, when causal). Scale: the
scores are formed in fp32 and multiplied by ``sm_scale`` there, as in the
bundled kernel.

On CUDA tensors :func:`flash_attention` runs the Hopper kernels of
``csrc/flash_fwd.cu``, ``csrc/flash_dq.cu`` and ``csrc/flash_dkv.cu``
(entry points in ``csrc/flash_attention.cu``; wgmma products, TMA-fed tile
rings, the softmax in registers): :func:`flash_attention_fwd` (out and an
fp32 logsumexp), :func:`flash_attention_dq` (dq, and di = sum(dout *
out)) and :func:`flash_attention_dkv` (dk, dv summed over the query heads
of each kv head), and without causality :func:`flash_attention_fwd_full`,
:func:`flash_attention_dq_full` and :func:`flash_attention_dkv_full`, each
with its own launch count, so that a path can show which form it ran.
Under GQA the dk/dv kernel splits each kv head's query heads over
:func:`dkv_splits` blocks, whose fp32 partials a second kernel adds in a
fixed order. Each kernel wrapper takes an optional
``tile_classes`` (int32 [3] on the card) to which the kernel adds the
(query tile, kv tile) pairs it visited, by class: skipped (disjoint
segment-id ranges), full (no mask needed) and masked; :data:`KERNEL_TILES`
gives the tiles. On CPU tensors it runs the plain versions
:func:`flash_attention_fwd_ref` and :func:`flash_attention_bwd_ref` in
fp32. The device of q is the only thing that chooses.

Layout: the model's, q [B, T, Hq, D], k, v [B, T, Hkv, D], segment ids
[B, T] int, lse [B, Hq, T]. CUDA: bf16, D = 64, 128 or 256 (JAX runs the
bundled kernel at any head dim that is a multiple of 64; the models the
port loads have 64, 128 or 256), any T; anything else raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels

#: tokens per tile of the segment-id ranges (tile_segment_ranges), which
#: K17 and K18 share
BLOCK = 64
#: head dims the CUDA kernels are built for
KERNEL_HEAD_DIMS = (64, 128, 256)
#: (query tile, kv tile) tokens of each Hopper kernel, by head dim
KERNEL_TILES = {"fwd": {64: (128, 128), 128: (128, 128), 256: (128, 64)},
                "dq": {64: (128, 64), 128: (128, 64), 256: (128, 32)},
                "dkv": {64: (64, 128), 128: (64, 128), 256: (32, 64)}}


def _mask(segment_ids: Optional[torch.Tensor], b: int, t: int, device,
          window: Optional[int] = None, causal: bool = True) -> torch.Tensor:
    """[B, T, T] bool: causal (where ``causal``), within the window
    (i - j < window) and with equal segment ids, where given."""
    pos = torch.arange(t, device=device)
    diff = pos[:, None] - pos[None, :]
    mask = diff >= 0 if causal else torch.ones((t, t), dtype=torch.bool,
                                                 device=device)
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
                            scale: float, causal: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward in fp32: (out [B, T, Hq, D] in q.dtype, lse [B, Hq, T]
    fp32)."""
    b, t, hq, _ = q.shape
    s = torch.einsum("bthd,bshd->bhts", q.to(torch.float32),
                     _expand_kv(k, hq)) * scale
    mask = _mask(segment_ids, b, t, q.device, causal=causal)[:, None]
    s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                       # [B, H, T]
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhts,bshd->bthd", p, _expand_kv(v, hq))
    return out.to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, segment_ids: Optional[torch.Tensor],
                            out, lse, dout, scale: float,
                            causal: bool = True):
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
    mask = _mask(segment_ids, b, t, q.device, causal=causal)[:, None]
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


def _classes(tile_classes: Optional[torch.Tensor], q: torch.Tensor):
    """The counters' pointer (None: no counting)."""
    if tile_classes is None:
        return None
    if (tile_classes.dtype != torch.int32 or tile_classes.device != q.device
            or tile_classes.shape != (3,)):
        raise ValueError("flash attention: tile_classes must be an int32 [3] "
                         f"on {q.device}; got {tile_classes.dtype} "
                         f"{tuple(tile_classes.shape)} on "
                         f"{tile_classes.device}")
    return tile_classes.data_ptr()


def _multiprocessors(device: torch.device) -> int:
    """The card's multiprocessor count; an H100's 132 for a device that is
    no card (the meta tensors that stand in for one in the dispatch
    tests)."""
    if device.type != "cuda":
        return 132
    return torch.cuda.get_device_properties(device).multi_processor_count


def dkv_splits(b: int, t: int, hq: int, hkv: int, d: int,
               sms: int) -> int:
    """Blocks that share the Hq / Hkv query heads of a kv head in the dk/dv
    kernel: the least divisor of the group that gives the grid two blocks
    for each of the card's ``sms`` multiprocessors, else the whole group
    (one head a block); 1 without GQA."""
    group = hq // hkv
    if group == 1:
        return 1
    blocks = -(-t // KERNEL_TILES["dkv"][d][1]) * hkv * b
    for n in range(1, group + 1):
        if group % n == 0 and blocks * n >= 2 * sms:
            return n
    return group


def dkv_split_scratch(q: torch.Tensor, k: torch.Tensor):
    """(:func:`dkv_splits` for q [B, T, Hq, D] and k [B, T, Hkv, D] on q's
    card, the dk/dv kernel's fp32 [splits, 2, B, T, Hkv, D] scratch for
    the slices' partial sums, or None with one slice)."""
    b, t, hq, d = q.shape
    splits = dkv_splits(b, t, hq, k.shape[2], d, _multiprocessors(q.device))
    scratch = None if splits == 1 else torch.empty(
        (splits, 2) + tuple(k.shape), dtype=torch.float32, device=q.device)
    return splits, scratch


def _fwd(name, q, k, v, segment_ids, seg_min, seg_max, scale, causal,
         tile_classes=None):
    _check_kernel_inputs(name, q, k, v, segment_ids)
    b, t, hq, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    seg = segment_ids.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    rc = kernels.library().unsloth_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        seg_min.data_ptr(), seg_max.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, t, hq, k.shape[2], d, float(scale), causal,
        _classes(tile_classes, q), _stream(q))
    kernels.check(rc, name)
    return out, lse


def _dq(name, q, k, v, segment_ids, seg_min, seg_max, out, lse, dout, scale,
        causal, tile_classes=None):
    _check_kernel_inputs(name, q, k, v, segment_ids)
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
        hq, k.shape[2], d, float(scale), causal, _classes(tile_classes, q),
        _stream(q))
    kernels.check(rc, name)
    return dq, di


def _dkv(name, q, k, v, segment_ids, seg_min, seg_max, lse, di, dout, scale,
         causal, tile_classes=None):
    _check_kernel_inputs(name, q, k, v, segment_ids)
    b, t, hq, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dout = dout.to(q.dtype).contiguous()
    seg = segment_ids.to(torch.int32).contiguous()
    lse, di = lse.contiguous(), di.contiguous()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    splits, scratch = dkv_split_scratch(q, k)
    rc = kernels.library().unsloth_flash_attn_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        seg_min.data_ptr(), seg_max.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if scratch is None else scratch.data_ptr(), splits, b, t, hq,
        k.shape[2], d, float(scale), causal, _classes(tile_classes, q),
        _stream(q))
    kernels.check(rc, name)
    return dk, dv


def flash_attention_fwd(q, k, v, segment_ids, seg_min, seg_max, *,
                        scale: float, tile_classes=None):
    """Kernel forward, causal: (out [B, T, Hq, D] bf16, lse [B, Hq, T]
    fp32)."""
    res = _fwd("flash_attention_fwd", q, k, v, segment_ids, seg_min,
               seg_max, scale, True, tile_classes)
    flash_attention_fwd.launches += 1
    return res


def flash_attention_dq(q, k, v, segment_ids, seg_min, seg_max, out, lse,
                       dout, *, scale: float, tile_classes=None):
    """Kernel dq, causal: (dq [B, T, Hq, D] bf16, di [B, Hq, T] fp32)."""
    res = _dq("flash_attention_dq", q, k, v, segment_ids, seg_min, seg_max,
              out, lse, dout, scale, True, tile_classes)
    flash_attention_dq.launches += 1
    return res


def flash_attention_dkv(q, k, v, segment_ids, seg_min, seg_max, lse, di,
                        dout, *, scale: float, tile_classes=None):
    """Kernel dk/dv, causal: (dk, dv) [B, T, Hkv, D] bf16, from the dq
    kernel's di."""
    res = _dkv("flash_attention_dkv", q, k, v, segment_ids, seg_min, seg_max,
               lse, di, dout, scale, True, tile_classes)
    flash_attention_dkv.launches += 1
    return res


def flash_attention_fwd_full(q, k, v, segment_ids, seg_min, seg_max, *,
                             scale: float, tile_classes=None):
    """Kernel forward without causality: as :func:`flash_attention_fwd`,
    every key of the query's segment attended."""
    res = _fwd("flash_attention_fwd_full", q, k, v, segment_ids, seg_min,
               seg_max, scale, False, tile_classes)
    flash_attention_fwd_full.launches += 1
    return res


def flash_attention_dq_full(q, k, v, segment_ids, seg_min, seg_max, out, lse,
                            dout, *, scale: float, tile_classes=None):
    """Kernel dq without causality (:func:`flash_attention_dq`'s form)."""
    res = _dq("flash_attention_dq_full", q, k, v, segment_ids, seg_min,
              seg_max, out, lse, dout, scale, False, tile_classes)
    flash_attention_dq_full.launches += 1
    return res


def flash_attention_dkv_full(q, k, v, segment_ids, seg_min, seg_max, lse, di,
                             dout, *, scale: float, tile_classes=None):
    """Kernel dk/dv without causality (:func:`flash_attention_dkv`'s
    form)."""
    res = _dkv("flash_attention_dkv_full", q, k, v, segment_ids, seg_min,
               seg_max, lse, di, dout, scale, False, tile_classes)
    flash_attention_dkv_full.launches += 1
    return res


# number of kernel launches since the last reset (CPU calls do not count)
for _fn in (flash_attention_fwd, flash_attention_dq, flash_attention_dkv,
            flash_attention_fwd_full, flash_attention_dq_full,
            flash_attention_dkv_full):
    _fn.launches = 0
del _fn


def flash_attention_bwd(q, k, v, segment_ids, seg_min, seg_max, out, lse,
                        dout, *, scale: float, causal: bool = True):
    """Kernel backward: the dq kernel, then the dk/dv kernel, of the form
    ``causal`` names."""
    dq_fn, dkv_fn = ((flash_attention_dq, flash_attention_dkv) if causal
                     else (flash_attention_dq_full, flash_attention_dkv_full))
    dq, di = dq_fn(q, k, v, segment_ids, seg_min, seg_max, out, lse, dout,
                   scale=scale)
    dk, dv = dkv_fn(q, k, v, segment_ids, seg_min, seg_max, lse, di, dout,
                    scale=scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, scale, causal):
        if q.device.type == "cpu":
            out, lse = flash_attention_fwd_ref(q, k, v, segment_ids, scale,
                                               causal)
            ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        else:
            if segment_ids is None:
                segment_ids = torch.zeros(q.shape[:2], dtype=torch.int32,
                                          device=q.device)
            seg_min, seg_max = tile_segment_ranges(segment_ids)
            fwd = flash_attention_fwd if causal else flash_attention_fwd_full
            out, lse = fwd(q, k, v, segment_ids, seg_min, seg_max,
                           scale=scale)
            ctx.save_for_backward(q, k, v, segment_ids, out, lse, seg_min,
                                  seg_max)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, out, lse, *ranges = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, segment_ids, out,
                                                 lse, dout, ctx.scale,
                                                 ctx.causal)
        else:
            dq, dk, dv = flash_attention_bwd(q, k, v, segment_ids, *ranges,
                                             out, lse, dout, scale=ctx.scale,
                                             causal=ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, segment_ids: Optional[torch.Tensor] = None, *,
                    scale: Optional[float] = None, causal: bool = True):
    """Attention with optional segment ids (equality over the whole range),
    causal or not; differentiable in q, k, v. q [B, T, Hq, D]; k, v
    [B, T, Hkv, D] with Hq % Hkv == 0."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: Hq={q.shape[2]} is not a "
                         f"multiple of Hkv={k.shape[2]}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, segment_ids, float(scale),
                                 bool(causal))
