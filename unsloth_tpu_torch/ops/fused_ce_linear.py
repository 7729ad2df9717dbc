"""Fused lm_head + cross-entropy that never holds [N, V] logits.

Counterpart of unsloth_tpu/ops/fused_ce_linear.py (which has no Pallas
kernel): the token dimension is cut into chunks; each chunk's [C, V]
logits are computed in fp32, reduced at once to per-row (loss,
logsumexp), and dropped. The backward recomputes each chunk's logits to
form dhidden (and dW when the head is trainable). Peak memory is O(C·V)
instead of O(N·V). The per-chunk products are plain ``torch`` matrix
products with fp32 outputs, as the JAX package leaves them to XLA.
:func:`fused_linear_ce_per_row` gives the loss of each row, with a
per-row upstream gradient; :func:`fused_linear_cross_entropy` their sum
(SFT) and :func:`selective_log_softmax` their negation, the
log-probability of one token a row (GRPO).

Rounding points: logits = hidden @ w with fp32 accumulation and an fp32
result (JAX ``preferred_element_type=float32``); in the backward dz is
rounded to hidden's dtype before dz @ w^T (in f32 that is the JAX formula
exactly; in bf16 it is the precision of the TPU's default dot).
"""

from __future__ import annotations

from typing import Optional

import torch

from .cross_entropy import IGNORE_INDEX, _transform_logits

_DEFAULT_CHUNK = 1024


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 accumulation and an fp32 result. A half-precision
    pair on CUDA stays in its dtype for the tensor cores; elsewhere both
    operands are widened to fp32 (exact for bf16)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16) \
            and b.dtype == a.dtype:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


def _chunk_logits(h_c, w, bias, softcap, logit_scale):
    """(z0, z): the chunk's raw fp32 logits (+ bias) and the transformed
    ones that the softmax reads."""
    z0 = _mm_f32(h_c, w)
    if bias is not None:
        z0 = z0 + bias.to(torch.float32)
    return z0, _transform_logits(z0, softcap, logit_scale)


def _chunk_dz(h_c, w, bias, lb, lse, softcap, logit_scale, g):
    """Recompute the chunk's logits and form dz, the gradient of the rows'
    losses, weighted by their upstream gradients ``g`` ([C, 1]), with
    respect to the raw (pre-transform) logits, fp32."""
    z0, z = _chunk_logits(h_c, w, bias, softcap, logit_scale)
    th = torch.tanh((z0 * logit_scale if logit_scale is not None else z0)
                    / softcap) if softcap is not None else None
    del z0
    dz = torch.exp(z - lse[:, None])
    del z
    valid = lb != IGNORE_INDEX
    rows = torch.nonzero(valid).squeeze(1)
    dz[rows, lb[rows].long()] -= 1.0
    dz.mul_(valid[:, None].to(torch.float32))
    if th is not None:
        dz.mul_(1.0 - th * th)
    if logit_scale is not None:
        dz.mul_(logit_scale)
    return dz.mul_(g)


class _FusedLinearCEPerRow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, w, bias, labels, softcap, logit_scale,
                chunk_size, w_trainable):
        n = hidden.shape[0]
        loss = torch.empty((n,), dtype=torch.float32, device=hidden.device)
        lse = torch.empty((n,), dtype=torch.float32, device=hidden.device)
        for c0 in range(0, n, chunk_size):
            lb = labels[c0:c0 + chunk_size]
            _, z = _chunk_logits(hidden[c0:c0 + chunk_size], w, bias,
                                 softcap, logit_scale)
            lse_c = torch.logsumexp(z, dim=-1)
            valid = lb != IGNORE_INDEX
            safe = torch.where(valid, lb, torch.zeros_like(lb)).long()
            target = torch.gather(z, 1, safe[:, None])[:, 0]
            loss[c0:c0 + chunk_size] = torch.where(
                valid, lse_c - target, torch.zeros_like(lse_c))
            lse[c0:c0 + chunk_size] = lse_c
            del z
        ctx.save_for_backward(hidden, w, bias, labels, lse)
        ctx.cfg = (softcap, logit_scale, chunk_size, w_trainable)
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, w, bias, labels, lse = ctx.saved_tensors
        softcap, logit_scale, chunk_size, w_trainable = ctx.cfg
        g = g.to(torch.float32)
        want_w = w_trainable and ctx.needs_input_grad[1]
        want_b = w_trainable and bias is not None and ctx.needs_input_grad[2]
        dh = torch.empty_like(hidden)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device) \
            if want_w else None
        db = torch.zeros(bias.shape, dtype=torch.float32,
                         device=bias.device) if want_b else None
        for c0 in range(0, hidden.shape[0], chunk_size):
            h_c = hidden[c0:c0 + chunk_size]
            dz = _chunk_dz(h_c, w, bias, labels[c0:c0 + chunk_size],
                           lse[c0:c0 + chunk_size], softcap, logit_scale,
                           g[c0:c0 + chunk_size, None])
            dz_h = dz.to(hidden.dtype)
            dh[c0:c0 + chunk_size] = _mm_f32(dz_h, w.t()).to(hidden.dtype)
            if dw is not None:
                dw += _mm_f32(h_c.t(), dz_h)
            if db is not None:
                db += dz.sum(dim=0)
            del dz, dz_h
        return (dh if ctx.needs_input_grad[0] else None,
                dw.to(w.dtype) if dw is not None else None,
                db.to(bias.dtype) if db is not None else None,
                None, None, None, None, None)


def fused_linear_ce_per_row(hidden: torch.Tensor, w: torch.Tensor,
                            bias: Optional[torch.Tensor],
                            labels: torch.Tensor,
                            softcap: Optional[float] = None,
                            logit_scale: Optional[float] = None,
                            chunk_size: int = _DEFAULT_CHUNK,
                            w_trainable: bool = False) -> torch.Tensor:
    """Per-row CE loss [N] in fp32 without holding [N, V] logits; rows with
    label -100 give 0. hidden [N, D]; w [D, V]; labels [N]. The backward
    takes a per-row upstream gradient and recomputes each chunk's logits
    (dz rounded to hidden's dtype before dz @ w^T: exact in fp32)."""
    return _FusedLinearCEPerRow.apply(hidden, w, bias, labels, softcap,
                                      logit_scale, int(chunk_size),
                                      bool(w_trainable))


def selective_log_softmax(hidden: torch.Tensor, w: torch.Tensor,
                          token_ids: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          softcap: Optional[float] = None,
                          logit_scale: Optional[float] = None,
                          chunk_size: int = _DEFAULT_CHUNK,
                          w_trainable: bool = False) -> torch.Tensor:
    """log p(token_ids) of each row [N], fp32, in chunks, the logits never
    held whole; rows with token id -100 give 0."""
    return -fused_linear_ce_per_row(hidden, w, bias, token_ids, softcap,
                                    logit_scale, chunk_size, w_trainable)


def fused_linear_cross_entropy(hidden: torch.Tensor, w: torch.Tensor,
                               bias: Optional[torch.Tensor],
                               labels: torch.Tensor,
                               softcap: Optional[float] = None,
                               logit_scale: Optional[float] = None,
                               chunk_size: int = _DEFAULT_CHUNK,
                               w_trainable: bool = True):
    """(sum of per-token CE over valid tokens as an fp32 scalar, number of
    valid tokens). hidden [N, D]; w [D, V] (a transposed view of the
    [V, D] head is fine); labels [N], already shifted. ``w_trainable=False``
    (a frozen head, as under LoRA) skips the [D, V] weight gradient."""
    loss = fused_linear_ce_per_row(hidden, w, bias, labels, softcap,
                                   logit_scale, chunk_size, w_trainable)
    return loss.sum(), (labels != IGNORE_INDEX).sum()


def fused_ce_loss_mean(hidden: torch.Tensor, w: torch.Tensor,
                       labels: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       n_items: Optional[torch.Tensor] = None,
                       softcap: Optional[float] = None,
                       logit_scale: Optional[float] = None,
                       chunk_size: int = _DEFAULT_CHUNK,
                       w_trainable: bool = True) -> torch.Tensor:
    """Mean loss over valid tokens, or the loss sum over ``n_items``."""
    loss_sum, n_valid = fused_linear_cross_entropy(
        hidden, w, bias, labels, softcap, logit_scale, chunk_size,
        w_trainable)
    denom = n_items if n_items is not None else torch.clamp(n_valid, min=1)
    return loss_sum / denom
