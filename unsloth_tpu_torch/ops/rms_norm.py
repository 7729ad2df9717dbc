"""RMSNorm forward and backward, in PyTorch with hand-written CUDA kernels.

Counterpart of unsloth_tpu/ops/rms_norm.py:rms_norm: fp32 statistics
whatever the input dtype, and the Gemma variant's ``(1 + w)`` scale in
fp32. On a CUDA tensor :func:`rms_norm` launches ``csrc/rms_norm.cu``
(TPU ``_fwd_kernel``) and its backward :func:`rms_norm_bwd` the second
kernel of that file (TPU ``_bwd_kernel``); on a CPU tensor they run
:func:`rms_norm_ref` and :func:`rms_norm_bwd_ref`. The device of ``x`` is
the only thing that chooses.
"""

from __future__ import annotations

import torch

from .. import kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rms_norm_ref(x: torch.Tensor, w: torch.Tensor, eps: float,
                 gemma: bool = False) -> torch.Tensor:
    """Plain RMSNorm. x: [..., D], w: [D]; output in x.dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xhat = xf * torch.rsqrt(var + eps)
    wf = w.to(torch.float32)
    out = xhat * (1.0 + wf) if gemma else xhat * wf
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             gemma: bool = False) -> torch.Tensor:
    """RMSNorm over the last axis. x: [..., D] (bf16 or f32), w: [D].
    Differentiable in x and w (the backward is :func:`rms_norm_bwd`)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, eps, gemma)
    return _rms_norm_fwd(x, w, eps, gemma)


def _check_cuda(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise NotImplementedError(
            f"{name} CUDA kernel takes float32/bfloat16, got x {x.dtype}, "
            f"w {w.dtype}")
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"{name}: w shape {tuple(w.shape)} != ({d},)")
    if w.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, w on {w.device}")


def _rms_norm_fwd(x: torch.Tensor, w: torch.Tensor, eps: float,
                  gemma: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return rms_norm_ref(x, w, eps, gemma)
    _check_cuda("rms_norm", x, w)
    d = x.shape[-1]
    xc = x.contiguous()
    wc = w.contiguous()
    out = torch.empty_like(xc)
    rows = xc.numel() // d if d else 0
    if rows == 0:
        return out
    lib = kernels.library()
    rc = lib.unsloth_rms_norm(
        xc.data_ptr(), wc.data_ptr(), out.data_ptr(), rows, d, float(eps),
        int(bool(gemma)), _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "rms_norm")
    rms_norm.launches += 1
    return out


#: number of kernel launches since the last reset (CPU calls do not count)
rms_norm.launches = 0

#: most row blocks (fp32 partial rows of dW) the backward kernel uses
_BWD_PARTIALS = 512


def rms_norm_bwd_ref(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                     eps: float, gemma: bool = False):
    """Plain backward of :func:`rms_norm_ref`: (dx in x.dtype, dW in
    w.dtype), with the TPU kernel's formula in fp32:
    dx = inv * (wg - xhat * mean(wg * xhat)), dW = sum_rows(g * xhat)."""
    xf = x.to(torch.float32)
    gf = g.to(torch.float32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    wf = w.to(torch.float32)
    wg = gf * ((1.0 + wf) if gemma else wf)
    dx = inv * (wg - xhat * torch.mean(wg * xhat, dim=-1, keepdim=True))
    dw = (gf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def rms_norm_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                 eps: float = 1e-6, gemma: bool = False):
    """Gradients of RMSNorm: (dx [..., D] in x.dtype, dW [D] in w.dtype).
    g is the output's gradient, in x.dtype. dW is an fp32 sum over all
    rows, cast once."""
    if x.device.type == "cpu":
        return rms_norm_bwd_ref(x, w, g, eps, gemma)
    _check_cuda("rms_norm_bwd", x, w)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"rms_norm_bwd: g {tuple(g.shape)} {g.dtype} on "
                         f"{g.device} does not match x {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    d = x.shape[-1]
    xc, gc, wc = x.contiguous(), g.contiguous(), w.contiguous()
    dx = torch.empty_like(xc)
    dw = torch.zeros((d,), dtype=torch.float32, device=x.device)
    rows = xc.numel() // d if d else 0
    if rows == 0:
        return dx, dw.to(w.dtype)
    n_partial = min(rows, _BWD_PARTIALS)
    partial = torch.empty((n_partial, d), dtype=torch.float32,
                          device=x.device)
    rc = kernels.library().unsloth_rms_norm_bwd(
        xc.data_ptr(), wc.data_ptr(), gc.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), dw.data_ptr(), rows, d, n_partial, float(eps),
        int(bool(gemma)), _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "rms_norm_bwd")
    rms_norm_bwd.launches += 1
    return dx, dw.to(w.dtype)


#: number of kernel launches since the last reset (CPU calls do not count)
rms_norm_bwd.launches = 0


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with the TPU package's custom backward (JAX ``_vjp_bwd``):
    saves x and w, recomputes the statistics in the backward."""

    @staticmethod
    def forward(ctx, x, w, eps, gemma):
        ctx.save_for_backward(x, w)
        ctx.eps, ctx.gemma = eps, gemma
        return _rms_norm_fwd(x, w, eps, gemma)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, w, g.to(x.dtype), ctx.eps, ctx.gemma)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None, None, None)
