"""Attention for the training path (self-attention over [B, T] rows).

Counterpart of the training parts of unsloth_tpu/ops/attention.py, with
its layout: q [B, T, Hq, Dh]; k, v [B, T, Hkv, Dh]; segment_ids [B, T]
(tokens attend only within their segment; the pad tail is segment 0);
sinks [Hq] (gpt-oss: a per-head logit in the softmax denominator that
carries no value).

* :func:`attention_ref` — masked SDPA in fp32: causal, segment ids,
  sliding window, softcap, GQA, sinks. The parity oracle and the CPU path.
* :func:`banded_window_attention` — exact sliding-window attention over
  bands of 2 x roundup(window, 128) keys, plain PyTorch under
  ``torch.utils.checkpoint`` (sinks and softcap inline); on any device.
* :func:`attention` — the dispatcher. With sinks it takes JAX's order:
  plain causal rows launch K17 (``ops/flash_sinks.py``, head dim 64) on a
  CUDA tensor; a narrow window (4 bands fit in T) takes the banded form;
  otherwise, on CUDA, the window or softcap kernel (K18, head dim 64, 128
  or 256) plus a chunked logsumexp and the exact rescale
  out * sigmoid(lse - sink); on the CPU, :func:`attention_ref`. Without
  sinks a CPU tensor takes :func:`attention_ref`; a CUDA tensor, causal,
  with k/v over the same T (``Hq % Hkv == 0``), launches a kernel: with a
  sliding window or a logit softcap, the splash kernels
  (``ops/splash_attention.py``, K18), padded and packed rows alike, head
  dim 64, 128 or 256; otherwise, with a declared segment bound
  (:class:`packed_segment_bound`, set by the trainer when it packs),
  segment ids, ``T % 64 == 0`` and head dim 128, the packed flash kernels
  (``ops/packed_attention.py``, K9-K11); otherwise the flash kernels over
  the whole causal range (``ops/flash_attention.py``, K16: any T, head dim
  64, 128 or 256): unpacked or padded rows, no segment ids, and packed
  rows at head dim 64 or 256 (JAX's packed kernel takes ``Dh % 128 ==
  0``; the port's is built for 128 only, and K16 computes the same
  function over more tile pairs). Every other CUDA route raises
  ``NotImplementedError`` naming the TPU kernel it still needs: the
  non-causal forms of K16 and K18 (no causality, or cross attention); a
  head dim the kernels are not built for raises in the kernel wrapper.
  There is no fallback from the card to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from .flash_attention import flash_attention
from .flash_sinks import KERNEL_HEAD_DIM as SINKS_HEAD_DIM
from .flash_sinks import flash_sinks
from .packed_attention import BLOCK
from .packed_attention import KERNEL_HEAD_DIM as PACKED_HEAD_DIM
from .packed_attention import packed_flash_attention
from .splash_attention import KERNEL_HEAD_DIMS as SPLASH_HEAD_DIMS
from .splash_attention import splash_attention

_SEGMENT_BOUND: Optional[int] = None


class packed_segment_bound:
    """Context manager declaring the packer's max-segment-length cap for
    every :func:`attention` call inside it. A declared bound routes packed
    causal attention to the segment-block-sparse kernels. The bound must be
    >= the longest real segment the packer can emit; a longer segment
    raises."""

    def __init__(self, max_segment_len: Optional[int]):
        self.bound = None if max_segment_len is None \
            else int(max_segment_len)

    def __enter__(self):
        global _SEGMENT_BOUND
        self._prev = _SEGMENT_BOUND
        _SEGMENT_BOUND = self.bound
        return self

    def __exit__(self, *exc):
        global _SEGMENT_BOUND
        _SEGMENT_BOUND = self._prev
        return False


def current_segment_bound() -> Optional[int]:
    return _SEGMENT_BOUND


def _gqa_expand(k: torch.Tensor, hq: int) -> torch.Tensor:
    hkv = k.shape[2]
    if hq == hkv:
        return k
    return k.repeat_interleave(hq // hkv, dim=2)


def attention_ref(q, k, v, *, causal: bool = True,
                  segment_ids: Optional[torch.Tensor] = None,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None,
                  positions: Optional[torch.Tensor] = None,
                  sinks: Optional[torch.Tensor] = None):
    """Masked SDPA with fp32 scores and softmax; returns [B, T, Hq, Dh] in
    q.dtype. Fully masked rows give zeros (their softmax would be NaN);
    with ``sinks`` the softmax runs over [scores, sink] and the sink column
    is dropped before the value product (HF GptOssAttention)."""
    b, t, hq, dh = q.shape
    s = k.shape[1]
    if scale is None:
        scale = dh ** -0.5
    k = _gqa_expand(k, hq)
    v = _gqa_expand(v, hq)
    scores = torch.einsum("bthd,bshd->bhts", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    dev = q.device
    if positions is None:
        positions = torch.arange(t, device=dev)[None].expand(b, t)
    kv_positions = positions if s == t else \
        torch.arange(s, device=dev)[None].expand(b, s)
    qpos = positions[:, :, None]
    kpos = kv_positions[:, None, :]
    mask = torch.ones((b, t, s), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & ((qpos - kpos) < window)
    if segment_ids is not None:
        mask = mask & (segment_ids[:, :, None] == segment_ids[:, None, :])
    scores = scores.masked_fill(~mask[:, None], float("-inf"))
    if sinks is not None:
        sink_col = sinks.to(torch.float32)[None, :, None, None].expand(
            b, hq, t, 1)
        probs = torch.softmax(torch.cat([scores, sink_col], dim=-1),
                              dim=-1)[..., :-1]
    else:
        probs = torch.softmax(scores, dim=-1)
        probs = torch.where(mask.any(dim=-1, keepdim=True)[:, None], probs,
                            torch.zeros((), device=dev))
    out = torch.einsum("bhts,bshd->bthd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def banded_window_attention(q, k, v, *, window: int,
                            segment_ids: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None,
                            sinks: Optional[torch.Tensor] = None,
                            softcap: Optional[float] = None):
    """Exact causal sliding-window attention by block-banding, O(T * 2W)
    (JAX ``banded_window_attention``): query block i of size
    W' = roundup(window, 128) attends only kv blocks i - 1 and i, which
    hold every key its window reaches; scores are [T/W', W', 2W'] instead
    of [T, T]. Plain PyTorch in fp32 under ``torch.utils.checkpoint`` (the
    banded probabilities are recomputed in the backward, not saved);
    sinks and softcap inline; its forward (and recompute) under the
    profiler range "unsloth.banded_attention". Needs T % W' == 0 and
    self-attention."""
    b, t, hq, dh = q.shape
    if k.shape[1] != t:
        raise ValueError("banded_window_attention: self-attention only")
    if scale is None:
        scale = dh ** -0.5
    bw = -(-window // 128) * 128
    if t % bw:
        raise ValueError(f"banded_window_attention: T={t} is not a multiple "
                         f"of the band {bw}")
    nb = t // bw
    k = _gqa_expand(k, hq)
    v = _gqa_expand(v, hq)

    def run(q, k, v, seg, sinks):
        with record_function("unsloth.banded_attention"):
            return _banded(q, k, v, seg, sinks)

    def _banded(q, k, v, seg, sinks):
        dev = q.device
        qb = q.reshape(b, nb, bw, hq, dh).to(torch.float32) * scale
        kb = k.reshape(b, nb, bw, hq, dh).to(torch.float32)
        vb = v.reshape(b, nb, bw, hq, dh).to(torch.float32)

        def band(x):
            prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
            return torch.cat([prev, x], dim=2)           # [b, nb, 2W', ...]

        kband, vband = band(kb), band(vb)
        scores = torch.einsum("bnrhd,bnchd->bnhrc", qb, kband)
        if softcap is not None:
            scores = softcap * torch.tanh(scores / softcap)
        qpos = (torch.arange(nb, device=dev)[:, None] * bw
                + torch.arange(bw, device=dev)[None])      # [nb, W']
        kpos = qpos[:, :1] - bw + torch.arange(2 * bw, device=dev)[None]
        delta = qpos[:, :, None] - kpos[:, None, :]       # [nb, W', 2W']
        mask = (delta >= 0) & (delta < window) & (kpos[:, None, :] >= 0)
        mask = mask[None].expand(b, nb, bw, 2 * bw)
        if seg is not None:
            sq = seg.reshape(b, nb, bw)
            skv = band(seg.reshape(b, nb, bw, 1, 1))[..., 0, 0]
            mask = mask & (sq[:, :, :, None] == skv[:, :, None, :])
        scores = scores.masked_fill(~mask[:, :, None], float("-inf"))
        if sinks is not None:
            sink_col = sinks.to(torch.float32)[None, None, :, None, None] \
                .expand(b, nb, hq, bw, 1)
            probs = torch.softmax(torch.cat([scores, sink_col], dim=-1),
                                  dim=-1)[..., :-1]
        else:
            probs = torch.softmax(scores, dim=-1)
            probs = torch.where(mask.any(dim=-1, keepdim=True)[:, :, None],
                                probs, torch.zeros((), device=dev))
        out = torch.einsum("bnhrc,bnchd->bnrhd", probs, vband)
        return out.reshape(b, t, hq, dh)

    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (q, k, v, sinks)):
        out = checkpoint(run, q, k, v, segment_ids, sinks,
                         use_reentrant=False, preserve_rng_state=False)
    else:
        out = run(q, k, v, segment_ids, sinks)
    return out.to(q.dtype)


def _chunked_lse(q, k, *, causal: bool, segment_ids, window, softcap,
                 scale: float, q_chunk: int = 512) -> torch.Tensor:
    """Differentiable logsumexp of the masked attention scores, [B, Hq, T],
    in q-chunks under ``torch.utils.checkpoint`` so the full [T, S] score
    matrix never exists (JAX ``_chunked_lse``): with :func:`_apply_sinks`,
    the sinks on top of a kernel that has none."""
    b, t, hq, dh = q.shape
    s = k.shape[1]
    q_chunk = min(q_chunk, t)
    while t % q_chunk:
        q_chunk //= 2
    kf = _gqa_expand(k, hq).to(torch.float32)
    kpos = torch.arange(s, device=q.device)
    seg_kv = segment_ids if segment_ids is not None else \
        torch.zeros((b, s), dtype=torch.int32, device=q.device)

    def one(qc, c0):
        scores = torch.einsum("bchd,bshd->bhcs",
                              qc.to(torch.float32) * scale, kf)
        if softcap is not None:
            scores = softcap * torch.tanh(scores / softcap)
        qp = torch.arange(c0, c0 + qc.shape[1], device=q.device)
        sq = seg_kv[:, c0:c0 + qc.shape[1]] if segment_ids is not None \
            else torch.zeros((b, qc.shape[1]), dtype=seg_kv.dtype,
                             device=q.device)
        m = sq[:, :, None] == seg_kv[:, None, :]
        if causal:
            m = m & (qp[None, :, None] >= kpos[None, None, :])
        if window is not None:
            m = m & ((qp[None, :, None] - kpos[None, None, :]) < window)
        scores = scores.masked_fill(~m[:, None], float("-inf"))
        return torch.logsumexp(scores, dim=-1)           # [B, H, C]

    parts = []
    for c0 in range(0, t, q_chunk):
        qc = q[:, c0:c0 + q_chunk]
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
            parts.append(checkpoint(one, qc, c0, use_reentrant=False,
                                    preserve_rng_state=False))
        else:
            parts.append(one(qc, c0))
    return torch.cat(parts, dim=-1)


def _apply_sinks(out: torch.Tensor, lse: torch.Tensor,
                 sinks: torch.Tensor) -> torch.Tensor:
    """out [B, T, Hq, Dh] * sigmoid(lse - sink), lse [B, Hq, T]: the exact
    sink rescale of an output computed without it."""
    c = torch.sigmoid(lse - sinks.to(torch.float32)[None, :, None])
    return (out.to(torch.float32)
            * c.transpose(1, 2)[..., None]).to(out.dtype)


def attention(q, k, v, *, causal: bool = True,
              segment_ids: Optional[torch.Tensor] = None,
              window: Optional[int] = None,
              softcap: Optional[float] = None,
              scale: Optional[float] = None,
              positions: Optional[torch.Tensor] = None,
              sinks: Optional[torch.Tensor] = None):
    """Dispatching attention (training path, self-attention)."""
    b, t, hq, dh = q.shape
    if scale is None:
        scale = dh ** -0.5
    self_attn = k.shape[1] == t and hq % k.shape[2] == 0
    if sinks is not None:
        return _attention_sinks(q, k, v, sinks, causal=causal,
                                segment_ids=segment_ids, window=window,
                                softcap=softcap, scale=scale,
                                positions=positions, self_attn=self_attn)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, segment_ids=segment_ids,
                             window=window, softcap=softcap, scale=scale,
                             positions=positions)
    if window is not None or softcap is not None:
        if causal and self_attn:
            return splash_attention(q, k, v, segment_ids, window=window,
                                    softcap=softcap, scale=scale)
        raise NotImplementedError(
            f"attention on CUDA with a sliding window or softcap, non-causal "
            f"(causal={causal}) or cross attention (q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}), needs the non-causal form of TPU kernel K18 "
            "(splash FullMask, unsloth_tpu/ops/attention.py:_splash_kernel); "
            "the port covers causal self-attention")
    bound = current_segment_bound() if segment_ids is not None else None
    if (bound is not None and causal and t % BLOCK == 0
            and dh == PACKED_HEAD_DIM and self_attn):
        return packed_flash_attention(q, k, v, segment_ids,
                                      max_segment_len=bound, scale=scale)
    if causal and self_attn:
        return flash_attention(q, k, v, segment_ids, scale=scale)
    raise NotImplementedError(
        f"attention on CUDA, non-causal (causal={causal}) or cross attention "
        f"(q {tuple(q.shape)}, k {tuple(k.shape)}), needs the non-causal "
        "form of TPU kernel K16 (bundled flash with causal=False, "
        "unsloth_tpu/ops/attention.py:_tpu_flash); the port covers causal "
        "self-attention")


def _attention_sinks(q, k, v, sinks, *, causal, segment_ids, window,
                     softcap, scale, positions, self_attn):
    """The sinks routes, in JAX's order (unsloth_tpu/ops/attention.py
    ``attention``): plain causal rows -> K17 on CUDA; a narrow window ->
    banded; else, on CUDA, the window/softcap kernel plus the chunked lse
    and the rescale; else the reference."""
    t, dh = q.shape[1], q.shape[3]
    on_device = q.device.type != "cpu"
    plain = softcap is None and window is None
    band = None if window is None else -(-window // 128) * 128
    narrow = band is not None and t % band == 0 and band * 4 <= t
    if on_device and plain and causal and self_attn:
        if dh != SINKS_HEAD_DIM:
            raise NotImplementedError(
                f"attention with sinks on {q.device}: the K17 kernel "
                "(ops/flash_sinks.py; TPU unsloth_tpu/ops/attention.py:"
                f"_tpu_flash_sinks) is built for head dim {SINKS_HEAD_DIM}, "
                f"got {dh}")
        return flash_sinks(q, k, v, sinks, segment_ids, scale=scale)
    if narrow and causal and self_attn and dh % 64 == 0:
        return banded_window_attention(q, k, v, window=window,
                                       segment_ids=segment_ids, scale=scale,
                                       sinks=sinks, softcap=softcap)
    if on_device and self_attn:
        if dh not in SPLASH_HEAD_DIMS:
            raise NotImplementedError(
                f"attention with sinks and a window of {window} (not narrow "
                f"at T={t}) or softcap {softcap} on {q.device} needs TPU "
                "kernel K18 (splash, unsloth_tpu/ops/attention.py:"
                f"_splash_kernel) at head dim {dh}; the port's K18 is built "
                f"for {SPLASH_HEAD_DIMS}")
        out = attention(q, k, v, causal=causal, segment_ids=segment_ids,
                        window=window, softcap=softcap, scale=scale)
        lse = _chunked_lse(q, k, causal=causal, segment_ids=segment_ids,
                           window=window, softcap=softcap, scale=scale)
        return _apply_sinks(out, lse, sinks)
    if on_device:
        raise NotImplementedError(
            f"attention on {q.device} with sinks: cross attention (q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}) has no kernel")
    return attention_ref(q, k, v, causal=causal, segment_ids=segment_ids,
                         window=window, softcap=softcap, scale=scale,
                         positions=positions, sinks=sinks)
