"""Cross-entropy over full logits, in PyTorch with hand-written CUDA
kernels.

Counterpart of unsloth_tpu/ops/cross_entropy.py: per-row CE in fp32 with
ignore_index -100, Gemma-2 softcapping ``t * tanh(x / t)`` and Cohere
logit scaling, :func:`cross_entropy_per_row` (the JAX custom_vjp: the
forward saves the per-row logsumexp, the backward forms dlogits from it)
and :func:`fast_cross_entropy_loss`, which divides by ``n_items`` (the
global valid-token count under gradient accumulation).

On CUDA tensors the forward launches ``csrc/cross_entropy.cu``'s
``ce_fwd_kernel`` (TPU ``_ce_fwd_kernel``, K7) and the backward its
``ce_bwd_kernel`` (TPU ``_ce_bwd_kernel``, K8). On CPU tensors they run
the plain versions :func:`cross_entropy_ref` and
:func:`cross_entropy_bwd_ref`, the JAX package's own formulas. The device
of the logits is the only thing that chooses.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels

IGNORE_INDEX = -100


def _transform_logits(x: torch.Tensor, softcap: Optional[float],
                      logit_scale: Optional[float]) -> torch.Tensor:
    if logit_scale is not None:
        x = x * logit_scale
    if softcap is not None:
        x = softcap * torch.tanh(x / softcap)
    return x


# ---------------------------------------------------------------------------
# plain versions (CPU path; the card's kernels are held against them)
# ---------------------------------------------------------------------------

def cross_entropy_ref(logits: torch.Tensor, labels: torch.Tensor,
                      softcap: Optional[float] = None,
                      logit_scale: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, lse), each fp32 [N], from logits [N, V] and labels [N]; rows
    with label -100 give loss 0. (The JAX function of this name returns
    the loss alone.)"""
    x = _transform_logits(logits.to(torch.float32), softcap, logit_scale)
    lse = torch.logsumexp(x, dim=-1)
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    target = torch.gather(x, -1, safe[:, None].long())[:, 0]
    return torch.where(valid, lse - target, torch.zeros_like(lse)), lse


def cross_entropy_bwd_ref(logits: torch.Tensor, labels: torch.Tensor,
                          lse: torch.Tensor, g: torch.Tensor,
                          softcap: Optional[float] = None,
                          logit_scale: Optional[float] = None
                          ) -> torch.Tensor:
    """dlogits [N, V] in logits.dtype: (softmax - onehot) * g through the
    softcap and the scale, from the saved lse, in fp32 (JAX
    ``_cvjp_bwd``)."""
    z = logits.to(torch.float32)
    if logit_scale is not None:
        z = z * logit_scale
    th = None
    if softcap is not None:
        th = torch.tanh(z / softcap)
        z = softcap * th
    p = torch.exp(z - lse[:, None])
    valid = (labels != IGNORE_INDEX)[:, None]
    cols = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (cols[None] == labels[:, None]).to(torch.float32)
    d = torch.where(valid, p - onehot, torch.zeros((), device=logits.device))
    d = d * g.to(torch.float32)[:, None]
    if th is not None:
        d = d * (1.0 - th * th)
    if logit_scale is not None:
        d = d * logit_scale
    return d.to(logits.dtype)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _check_cuda(name: str, logits: torch.Tensor, labels: torch.Tensor):
    """(logits, int32 labels), contiguous and aligned for the kernels."""
    if logits.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device "
                                  f"{logits.device}")
    if logits.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"{name} CUDA kernel takes bfloat16 or "
                                  f"float32 logits, got {logits.dtype}")
    if logits.ndim != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"{name}: logits [N, V] and labels [N], got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    logits = logits.contiguous()
    if logits.data_ptr() % 16:
        logits = logits.clone()
    return logits, labels.to(torch.int32).contiguous()


def _scalars(softcap, logit_scale):
    """(scale, softcap) as the kernels take them: 1 and 0 for none."""
    return (1.0 if logit_scale is None else float(logit_scale),
            0.0 if softcap is None else float(softcap))


def cross_entropy_fwd(logits: torch.Tensor, labels: torch.Tensor,
                      softcap: Optional[float] = None,
                      logit_scale: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel forward (K7): (loss, lse), each fp32 [N]."""
    logits, labels = _check_cuda("cross_entropy_fwd", logits, labels)
    n, v = logits.shape
    loss = torch.empty((n,), dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(loss)
    if n:
        rc = kernels.library().unsloth_ce_fwd(
            logits.data_ptr(), labels.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), n, v, *_scalars(softcap, logit_scale),
            int(logits.dtype == torch.bfloat16),
            torch.cuda.current_stream(logits.device).cuda_stream)
        kernels.check(rc, "cross_entropy_fwd")
        cross_entropy_fwd.launches += 1
    return loss, lse


#: number of kernel launches since the last reset (CPU calls do not count)
cross_entropy_fwd.launches = 0


def cross_entropy_bwd(logits: torch.Tensor, labels: torch.Tensor,
                      lse: torch.Tensor, g: torch.Tensor,
                      softcap: Optional[float] = None,
                      logit_scale: Optional[float] = None) -> torch.Tensor:
    """Kernel backward (K8): dlogits [N, V] in logits.dtype."""
    logits, labels = _check_cuda("cross_entropy_bwd", logits, labels)
    n, v = logits.shape
    lse = lse.to(torch.float32).contiguous()
    g = g.to(torch.float32).expand(n).contiguous()
    dlogits = torch.empty_like(logits)
    if n:
        rc = kernels.library().unsloth_ce_bwd(
            logits.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dlogits.data_ptr(), n, v,
            *_scalars(softcap, logit_scale),
            int(logits.dtype == torch.bfloat16),
            torch.cuda.current_stream(logits.device).cuda_stream)
        kernels.check(rc, "cross_entropy_bwd")
        cross_entropy_bwd.launches += 1
    return dlogits


#: number of kernel launches since the last reset (CPU calls do not count)
cross_entropy_bwd.launches = 0


class _CrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, softcap, logit_scale):
        fwd = cross_entropy_ref if logits.device.type == "cpu" \
            else cross_entropy_fwd
        loss, lse = fwd(logits, labels, softcap, logit_scale)
        ctx.save_for_backward(logits, labels, lse)
        ctx.softcap, ctx.logit_scale = softcap, logit_scale
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        bwd = cross_entropy_bwd_ref if logits.device.type == "cpu" \
            else cross_entropy_bwd
        return (bwd(logits, labels, lse, g, ctx.softcap, ctx.logit_scale),
                None, None, None)


def cross_entropy_per_row(logits: torch.Tensor, labels: torch.Tensor,
                          softcap: Optional[float] = None,
                          logit_scale: Optional[float] = None
                          ) -> torch.Tensor:
    """Per-row CE loss fp32 [N] from logits [N, V]; differentiable in the
    logits."""
    return _CrossEntropy.apply(logits, labels, softcap, logit_scale)


def fast_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                            n_items: Optional[torch.Tensor] = None,
                            softcap: Optional[float] = None,
                            logit_scale: Optional[float] = None
                            ) -> torch.Tensor:
    """Mean CE over valid tokens, or sum / ``n_items`` when given. logits
    [B, T, V] or [N, V]; labels [B, T] / [N], used as they are (the caller
    shifts)."""
    v = logits.shape[-1]
    labels1d = labels.reshape(-1)
    per_row = cross_entropy_per_row(logits.reshape(-1, v), labels1d, softcap,
                                    logit_scale)
    if n_items is None:
        n_items = torch.clamp((labels1d != IGNORE_INDEX).sum(), min=1)
    return per_row.sum() / n_items
