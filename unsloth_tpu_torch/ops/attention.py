"""Attention for the training path (self-attention over [B, T] rows).

Counterpart of the training parts of unsloth_tpu/ops/attention.py, with
its layout: q [B, T, Hq, Dh]; k, v [B, T, Hkv, Dh]; segment_ids [B, T]
(tokens attend only within their segment; the pad tail is segment 0).

* :func:`attention_ref` — masked SDPA in fp32: causal, segment ids,
  sliding window, softcap, GQA. The parity oracle and the CPU path.
* :func:`attention` — the dispatcher. A CPU tensor takes
  :func:`attention_ref`. A CUDA tensor, causal, with k/v over the same T
  (``Hq % Hkv == 0``) and no sinks, launches a kernel: with a sliding
  window or a logit softcap, the splash kernels
  (``ops/splash_attention.py``, K18), padded and packed rows alike, head
  dim 128 or 256; otherwise, with a declared segment bound
  (:class:`packed_segment_bound`, set by the trainer when it packs),
  segment ids, ``T % 64 == 0`` and ``Dh % 128 == 0``, the packed flash
  kernels (``ops/packed_attention.py``, K9-K11); otherwise (unpacked or
  padded rows, no segment ids) the flash kernels over the whole causal
  range (``ops/flash_attention.py``, K16), which take any T and raise for
  a head dim other than 128. Every other CUDA route raises
  ``NotImplementedError`` naming the TPU kernel it still needs: K17
  (sinks), K18's non-causal form (a window or softcap without
  causality). There is no fallback from the card to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention
from .packed_attention import BLOCK, packed_flash_attention
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
                  positions: Optional[torch.Tensor] = None):
    """Masked SDPA with fp32 scores and softmax; returns [B, T, Hq, Dh] in
    q.dtype. Fully masked rows give zeros (their softmax would be NaN)."""
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
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(dim=-1, keepdim=True)[:, None], probs,
                        torch.zeros((), device=dev))
    out = torch.einsum("bhts,bshd->bthd", probs, v.to(torch.float32))
    return out.to(q.dtype)


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
    if q.device.type == "cpu":
        if sinks is not None:
            raise NotImplementedError(
                "attention: sinks are not ported yet (TPU kernel K17, "
                "ops/attention.py:_tpu_flash_sinks)")
        return attention_ref(q, k, v, causal=causal, segment_ids=segment_ids,
                             window=window, softcap=softcap, scale=scale,
                             positions=positions)
    if sinks is not None:
        raise NotImplementedError(
            "attention on CUDA with sinks needs the port of TPU kernel K17 "
            "(unsloth_tpu/ops/attention.py:_tpu_flash_sinks)")
    self_attn = k.shape[1] == t and hq % k.shape[2] == 0
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
    if (bound is not None and causal and t % BLOCK == 0 and dh % 128 == 0
            and self_attn):
        return packed_flash_attention(q, k, v, segment_ids,
                                      max_segment_len=bound, scale=scale)
    if causal and self_attn:
        return flash_attention(q, k, v, segment_ids, scale=scale)
    raise NotImplementedError(
        f"attention on CUDA: non-causal (causal={causal}) or cross attention "
        f"(q {tuple(q.shape)}, k {tuple(k.shape)}) has no kernel; the port "
        "of the bundled flash kernel (K16, unsloth_tpu/ops/attention.py:"
        "_tpu_flash) covers causal self-attention")
