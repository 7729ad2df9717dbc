"""Splash attention: self-attention with a sliding window, a logit
softcap, segment ids, GQA and GRPO's shared-prefix layout, causal or (with
a softcap and segment ids only) not, in PyTorch with hand-written CUDA
kernels (K18).

Counterpart of unsloth_tpu/ops/attention.py:_tpu_splash, which runs the
bundled ``jax.experimental.pallas.ops.tpu.splash_attention`` kernels
(built in ``_splash_kernel``) with a ``CausalMask``, a
``LocalMask(window_size=(window - 1, 0))`` when a window is given, a
``NumpyMask(prefix_mask_array(P, G, L))`` under ``prefix_attention``, or,
for ``causal=False`` without a window, a ``FullMask``, per kv head. What
they compute, as ``_tpu_splash`` feeds them:

* q is multiplied by ``scale`` in its own dtype first (``q * scale``);
* s = q_scaled . k in fp32; with a softcap c, s' = c * tanh(s / c);
* token i attends to token j iff j <= i, i - j < window (when given) and
  their segment ids are equal (no segment ids: one segment); without
  causality iff their segment ids are equal (no window: JAX's
  ``_splash_kernel`` builds a causal ``LocalMask`` for a window whatever
  ``causal`` says, its ``attention_ref`` masks i - j < window alone, and
  the wrappers refuse the case rather than choose); with a
  prefix layout (P, G, L) (the row is [P prompt slots | G completion
  regions of L slots], T = P + G L) the window is unset and j <= i, equal
  segment ids and (j < P or i and j in the same region) decide
  (:func:`prefix_mask_array`); every output is defined, pad positions
  included;
* the backward: dS' = P * (dP - di), dS = dS' * (1 - tanh^2(s / c)) when
  capped; dq = scale * (dS @ k), dk = dS^T @ q_scaled, dv = P^T @ dout,
  dk and dv summed over each kv head's query heads.

On CUDA tensors :func:`splash_attention` runs K16's Hopper kernels
(``csrc/flash_fwd.cu``, ``flash_dq.cu``, ``flash_dkv.cu``: wgmma products,
TMA-fed tile rings, the softmax in registers) instantiated with K18's
rules (the softcap, q's rounding, the window, the prefix layout), through
the entry points of ``csrc/splash_attention.cu``:
:func:`splash_attention_fwd` (out and an fp32 logsumexp),
:func:`splash_attention_dq` (dq, and di = sum(dout * out)) and
:func:`splash_attention_dkv` (dk, dv), and without causality
:func:`splash_attention_fwd_full`, :func:`splash_attention_dq_full` and
:func:`splash_attention_dkv_full`, each with its own launch count. On
CPU tensors it runs the plain versions :func:`splash_attention_fwd_ref`
and :func:`splash_attention_bwd_ref` in fp32. The device of q is the only
thing that chooses. Each kernel wrapper takes an optional ``tile_counts``
(an int32 [3] on the card), to which its kernel adds, for each query head,
the (query tile, kv tile) pairs it visited, by class: skipped (disjoint
segment-id ranges, or masked whole by the prefix layout), full (no mask
needed) and masked; the tiles are K16's ``KERNEL_TILES``.

Layout: the model's, q [B, T, Hq, D], k, v [B, T, Hkv, D], segment ids
[B, T] int, lse [B, Hq, T]. CUDA: bf16, D = 64, 128 or 256, any T;
anything else raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels
from .flash_attention import (_check_kernel_inputs, _mask, _stream,
                              tile_segment_ranges)

#: head dims the CUDA kernels are built for
KERNEL_HEAD_DIMS = (64, 128, 256)


def prefix_mask_array(P: int, G: int, L: int) -> np.ndarray:
    """Static [T, T] bool mask of the shared-prefix GRPO layout [P prompt
    slots | G completion regions of L slots], T = P + G * L (JAX
    ``prefix_mask_array``): query slot i attends key slot j iff j <= i and
    (j < P or i and j lie in the same region). Each completion sees the
    shared prompt and itself, the prompt is causal within itself, and
    completions never see each other."""
    T = P + G * L
    q = np.arange(T)[:, None]
    k = np.arange(T)[None, :]
    reg_q = np.where(q >= P, (q - P) // L, -1)
    reg_k = np.where(k >= P, (k - P) // L, -2)
    return (q >= k) & ((k < P) | (reg_q == reg_k))


def check_prefix_layout(layout, t: int) -> Tuple[int, int, int]:
    """(P, G, L) as ints; raises unless P >= 0, G >= 1, L >= 1 and
    P + G * L == t."""
    P, G, L = (int(x) for x in layout)
    if P < 0 or G < 1 or L < 1 or P + G * L != t:
        raise ValueError(f"prefix layout (P, G, L) = {(P, G, L)} does not "
                         f"fill T = {t} (needs P + G * L == T, G, L >= 1)")
    return P, G, L


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

def _splash_mask(segment_ids: Optional[torch.Tensor], b: int, t: int, device,
                 window: Optional[int], prefix_layout,
                 causal: bool = True) -> torch.Tensor:
    """[B, T, T] bool: causal (where ``causal``), within the window and with
    equal segment ids; with a prefix layout, :func:`prefix_mask_array` and
    equal segment ids."""
    if prefix_layout is None:
        return _mask(segment_ids, b, t, device, window, causal)
    pm = torch.from_numpy(prefix_mask_array(
        *check_prefix_layout(prefix_layout, t))).to(device)
    if segment_ids is None:
        return pm[None].expand(b, t, t)
    return pm[None] & (segment_ids[:, :, None] == segment_ids[:, None, :])


def splash_attention_fwd_ref(q, k, v, segment_ids: Optional[torch.Tensor], *,
                             window: Optional[int], softcap: Optional[float],
                             scale: float, prefix_layout=None,
                             causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward in fp32, one kv head (and its query heads) at a time:
    (out [B, T, Hq, D] in q.dtype, lse [B, Hq, T] fp32)."""
    b, t, hq, d = q.shape
    mask = _splash_mask(segment_ids, b, t, q.device, window,
                        prefix_layout, causal)[:, None]
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
                             softcap: Optional[float], scale: float,
                             prefix_layout=None, causal: bool = True):
    """Plain backward from the saved (out, lse), with the bundled kernels'
    formulas in fp32 (module docstring), one kv head at a time. Returns
    (dq, dk, dv) in the input dtypes."""
    b, t, hq, d = q.shape
    mask = _splash_mask(segment_ids, b, t, q.device, window,
                        prefix_layout, causal)[:, None]
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


def _counts(tile_counts: Optional[torch.Tensor], q: torch.Tensor):
    """The kernels' class counters' pointer (None: no count)."""
    if tile_counts is None:
        return None
    if (tile_counts.dtype != torch.int32 or tile_counts.device != q.device
            or tile_counts.shape != (3,)):
        raise ValueError("splash attention: tile_counts must be an int32 [3] "
                         f"on {q.device}; got {tile_counts.dtype} "
                         f"{tuple(tile_counts.shape)} on "
                         f"{tile_counts.device}")
    return tile_counts.data_ptr()


def _layout(prefix_layout, t: int, window: Optional[int],
            causal: bool = True):
    """The kernels' runtime (P, G, L): G = 0 for none. Refuses a layout
    with a window, and a window or a layout without causality (where JAX's
    two readings of a non-causal window disagree, module docstring)."""
    if not causal and (window is not None or prefix_layout is not None):
        raise NotImplementedError(
            f"splash attention without causality takes neither a window "
            f"(got {window}) nor a prefix layout (got {prefix_layout}): for "
            "a window JAX's _splash_kernel builds the causal LocalMask "
            "(unsloth_tpu/ops/attention.py:248-249) while its attention_ref "
            "masks only i - j < window (:177-178)")
    if prefix_layout is None:
        return 0, 0, 0
    if window is not None:
        raise ValueError("splash attention: a prefix layout replaces the "
                         f"window; got window={window} with the layout "
                         f"{tuple(prefix_layout)}")
    return check_prefix_layout(prefix_layout, t)


def _fwd(name, q, k, v, segment_ids, seg_min, seg_max, window, softcap,
         scale, prefix_layout, tile_counts, causal):
    _check_kernel_inputs(name, q, k, v, segment_ids, KERNEL_HEAD_DIMS)
    b, t, hq, d = q.shape
    layout = _layout(prefix_layout, t, window, causal)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    seg = segment_ids.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    rc = kernels.library().unsloth_splash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        seg_min.data_ptr(), seg_max.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *layout, b, t, hq, k.shape[2], d, float(scale),
        *_options(window, softcap), causal, _counts(tile_counts, q),
        _stream(q))
    kernels.check(rc, name)
    return out, lse


def _dq(name, q, k, v, segment_ids, seg_min, seg_max, out, lse, dout, window,
        softcap, scale, prefix_layout, tile_counts, causal):
    _check_kernel_inputs(name, q, k, v, segment_ids, KERNEL_HEAD_DIMS)
    b, t, hq, d = q.shape
    layout = _layout(prefix_layout, t, window, causal)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out, dout = out.contiguous(), dout.to(q.dtype).contiguous()
    seg = segment_ids.to(torch.int32).contiguous()
    lse = lse.contiguous()
    di = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    rc = kernels.library().unsloth_splash_attn_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        seg_min.data_ptr(), seg_max.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        *layout, b, t, hq, k.shape[2], d, float(scale),
        *_options(window, softcap), causal, _counts(tile_counts, q),
        _stream(q))
    kernels.check(rc, name)
    return dq, di


def _dkv(name, q, k, v, segment_ids, seg_min, seg_max, lse, di, dout, window,
         softcap, scale, prefix_layout, tile_counts, causal):
    _check_kernel_inputs(name, q, k, v, segment_ids, KERNEL_HEAD_DIMS)
    b, t, hq, d = q.shape
    layout = _layout(prefix_layout, t, window, causal)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dout = dout.to(q.dtype).contiguous()
    seg = segment_ids.to(torch.int32).contiguous()
    lse, di = lse.contiguous(), di.contiguous()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = kernels.library().unsloth_splash_attn_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        seg_min.data_ptr(), seg_max.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *layout, b, t, hq, k.shape[2], d, float(scale),
        *_options(window, softcap), causal, _counts(tile_counts, q),
        _stream(q))
    kernels.check(rc, name)
    return dk, dv


def splash_attention_fwd(q, k, v, segment_ids, seg_min, seg_max, *,
                         window: Optional[int], softcap: Optional[float],
                         scale: float, prefix_layout=None,
                         tile_counts: Optional[torch.Tensor] = None):
    """Kernel forward, causal: (out [B, T, Hq, D] bf16, lse [B, Hq, T]
    fp32)."""
    res = _fwd("splash_attention_fwd", q, k, v, segment_ids, seg_min,
               seg_max, window, softcap, scale, prefix_layout, tile_counts,
               True)
    splash_attention_fwd.launches += 1
    return res


def splash_attention_dq(q, k, v, segment_ids, seg_min, seg_max, out, lse,
                        dout, *, window: Optional[int],
                        softcap: Optional[float], scale: float,
                        prefix_layout=None,
                        tile_counts: Optional[torch.Tensor] = None):
    """Kernel dq, causal: (dq [B, T, Hq, D] bf16, di [B, Hq, T] fp32)."""
    res = _dq("splash_attention_dq", q, k, v, segment_ids, seg_min, seg_max,
              out, lse, dout, window, softcap, scale, prefix_layout,
              tile_counts, True)
    splash_attention_dq.launches += 1
    return res


def splash_attention_dkv(q, k, v, segment_ids, seg_min, seg_max, lse, di,
                         dout, *, window: Optional[int],
                         softcap: Optional[float], scale: float,
                         prefix_layout=None,
                         tile_counts: Optional[torch.Tensor] = None):
    """Kernel dk/dv, causal: (dk, dv) [B, T, Hkv, D] bf16, from the dq
    kernel's di."""
    res = _dkv("splash_attention_dkv", q, k, v, segment_ids, seg_min,
               seg_max, lse, di, dout, window, softcap, scale, prefix_layout,
               tile_counts, True)
    splash_attention_dkv.launches += 1
    return res


def splash_attention_fwd_full(q, k, v, segment_ids, seg_min, seg_max, *,
                              softcap: Optional[float], scale: float,
                              tile_counts: Optional[torch.Tensor] = None):
    """Kernel forward without causality (``FullMask``): as
    :func:`splash_attention_fwd`, with no window or layout."""
    res = _fwd("splash_attention_fwd_full", q, k, v, segment_ids, seg_min,
               seg_max, None, softcap, scale, None, tile_counts, False)
    splash_attention_fwd_full.launches += 1
    return res


def splash_attention_dq_full(q, k, v, segment_ids, seg_min, seg_max, out,
                             lse, dout, *, softcap: Optional[float],
                             scale: float,
                             tile_counts: Optional[torch.Tensor] = None):
    """Kernel dq without causality (:func:`splash_attention_dq`'s form)."""
    res = _dq("splash_attention_dq_full", q, k, v, segment_ids, seg_min,
              seg_max, out, lse, dout, None, softcap, scale, None,
              tile_counts, False)
    splash_attention_dq_full.launches += 1
    return res


def splash_attention_dkv_full(q, k, v, segment_ids, seg_min, seg_max, lse,
                              di, dout, *, softcap: Optional[float],
                              scale: float,
                              tile_counts: Optional[torch.Tensor] = None):
    """Kernel dk/dv without causality (:func:`splash_attention_dkv`'s
    form)."""
    res = _dkv("splash_attention_dkv_full", q, k, v, segment_ids, seg_min,
               seg_max, lse, di, dout, None, softcap, scale, None,
               tile_counts, False)
    splash_attention_dkv_full.launches += 1
    return res


# number of kernel launches since the last reset (CPU calls do not count)
for _fn in (splash_attention_fwd, splash_attention_dq, splash_attention_dkv,
            splash_attention_fwd_full, splash_attention_dq_full,
            splash_attention_dkv_full):
    _fn.launches = 0
del _fn


class _SplashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, window, softcap, scale,
                prefix_layout, causal):
        opts = dict(window=window, softcap=softcap, scale=scale,
                    prefix_layout=prefix_layout)
        if q.device.type == "cpu":
            out, lse = splash_attention_fwd_ref(q, k, v, segment_ids,
                                                causal=causal, **opts)
            ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        else:
            if segment_ids is None:
                segment_ids = torch.zeros(q.shape[:2], dtype=torch.int32,
                                          device=q.device)
            seg_min, seg_max = tile_segment_ranges(segment_ids)
            if causal:
                out, lse = splash_attention_fwd(q, k, v, segment_ids,
                                                seg_min, seg_max, **opts)
            else:
                out, lse = splash_attention_fwd_full(
                    q, k, v, segment_ids, seg_min, seg_max, softcap=softcap,
                    scale=scale)
            ctx.save_for_backward(q, k, v, segment_ids, out, lse, seg_min,
                                  seg_max)
        ctx.opts, ctx.causal = opts, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, out, lse, *ranges = ctx.saved_tensors
        opts = ctx.opts
        if q.device.type == "cpu":
            dq, dk, dv = splash_attention_bwd_ref(q, k, v, segment_ids, out,
                                                  lse, dout,
                                                  causal=ctx.causal, **opts)
        elif ctx.causal:
            dq, di = splash_attention_dq(q, k, v, segment_ids, *ranges, out,
                                         lse, dout, **opts)
            dk, dv = splash_attention_dkv(q, k, v, segment_ids, *ranges, lse,
                                          di, dout, **opts)
        else:
            full = dict(softcap=opts["softcap"], scale=opts["scale"])
            dq, di = splash_attention_dq_full(q, k, v, segment_ids, *ranges,
                                              out, lse, dout, **full)
            dk, dv = splash_attention_dkv_full(q, k, v, segment_ids, *ranges,
                                               lse, di, dout, **full)
        return dq, dk, dv, None, None, None, None, None, None


def splash_attention(q, k, v, segment_ids: Optional[torch.Tensor] = None, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None, prefix_layout=None,
                     causal: bool = True):
    """Attention with an optional sliding window (i - j < window), logit
    softcap and segment ids, or with a prefix layout (P, G, L) in place of
    the window, causal; without causality, with a softcap and segment ids
    only (a window or a layout raises NotImplementedError);
    differentiable in q, k, v. q [B, T, Hq, D]; k, v [B, T, Hkv, D] with
    Hq % Hkv == 0."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"splash_attention: Hq={q.shape[2]} is not a "
                         f"multiple of Hkv={k.shape[2]}")
    if window is not None and window <= 0:
        raise ValueError(f"splash_attention: window={window} must be > 0")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"splash_attention: softcap={softcap} must be > 0")
    layout = _layout(prefix_layout, q.shape[1], window, causal)
    if prefix_layout is not None:
        prefix_layout = layout
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _SplashAttention.apply(q, k, v, segment_ids, window, softcap,
                                  float(scale), prefix_layout, bool(causal))
