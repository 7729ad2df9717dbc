"""Cross-entropy over full logits, in PyTorch.

Counterpart of unsloth_tpu/ops/cross_entropy.py: per-row CE in fp32 with
ignore_index -100, Gemma-2 softcapping ``t * tanh(x / t)`` and Cohere
logit scaling, and :func:`fast_cross_entropy_loss`, which divides by
``n_items`` (the global valid-token count under gradient accumulation).
On CPU tensors these are the plain versions. On a CUDA tensor the
full-logits path needs the port of TPU kernels K7/K8
(``_ce_fwd_kernel`` / ``_ce_bwd_kernel``) and raises; the training loss
takes the chunked ``ops/fused_ce_linear.py`` path there.
"""

from __future__ import annotations

from typing import Optional

import torch

IGNORE_INDEX = -100


def _transform_logits(x: torch.Tensor, softcap: Optional[float],
                      logit_scale: Optional[float]) -> torch.Tensor:
    if logit_scale is not None:
        x = x * logit_scale
    if softcap is not None:
        x = softcap * torch.tanh(x / softcap)
    return x


def cross_entropy_ref(logits: torch.Tensor, labels: torch.Tensor,
                      softcap: Optional[float] = None,
                      logit_scale: Optional[float] = None) -> torch.Tensor:
    """Per-row CE loss fp32 [N] from logits [N, V] and labels [N]; rows
    with label -100 contribute 0."""
    x = _transform_logits(logits.to(torch.float32), softcap, logit_scale)
    lse = torch.logsumexp(x, dim=-1)
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    target = torch.gather(x, -1, safe[:, None].long())[:, 0]
    return torch.where(valid, lse - target, torch.zeros_like(lse))


def fast_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                            n_items: Optional[torch.Tensor] = None,
                            softcap: Optional[float] = None,
                            logit_scale: Optional[float] = None
                            ) -> torch.Tensor:
    """Mean CE over valid tokens, or sum / ``n_items`` when given. logits
    [B, T, V] or [N, V]; labels [B, T] / [N], used as they are (the caller
    shifts)."""
    if logits.device.type != "cpu":
        raise NotImplementedError(
            "fast_cross_entropy_loss on CUDA needs the port of TPU kernels "
            "K7/K8 (unsloth_tpu/ops/cross_entropy.py:_ce_fwd_kernel, "
            "_ce_bwd_kernel); use the chunked ops.fused_ce_linear path")
    v = logits.shape[-1]
    labels1d = labels.reshape(-1)
    per_row = cross_entropy_ref(logits.reshape(-1, v), labels1d, softcap,
                                logit_scale)
    if n_items is None:
        n_items = torch.clamp((labels1d != IGNORE_INDEX).sum(), min=1)
    return per_row.sum() / n_items
