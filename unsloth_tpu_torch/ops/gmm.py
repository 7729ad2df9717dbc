"""Grouped dense matmul over experts (the MoE expert products when the
experts are dense bf16 stacks), forward and dx.

Counterpart of megablox ``gmm`` as unsloth_tpu/ops/moe.py:moe_mlp_grouped
calls it (``tiled_gmm``, with ``transpose_rhs=True``). Rows of the input
are sorted by expert; ``group_sizes`` [E] (int32, on the input's device)
says how many rows each expert owns. On a CUDA tensor :func:`gmm` launches
the hand-written kernel in ``csrc/gmm.cu`` (K19) for the forward, and the
same kernel with W untransposed for its dx (megablox's VJP with
``transpose_rhs`` flipped). On a CPU tensor both run the plain version
:func:`gmm_ref`. The device of the tensor is the only thing that chooses;
there is no fallback from a kernel to its plain version.

The optional per-expert bias is added as the JAX package adds it: the
product is rounded to the input dtype, then the bias (in that dtype) is
added and the sum rounded again. The kernel does both in its store
epilogue (no [m, N] bias gather), so :func:`gmm_ref` and the kernel differ
only by the order of the fp32 sums.

Divergences by design: the kernel masks ragged N and K (gpt-oss's 2,880)
where JAX pads them in memory to a multiple of 128; and there is no weight
gradient (megablox ``tgmm``): W and the bias are frozen under QLoRA, as the
JAX LoRA tree has no expert entries, so :func:`gmm` raises when either
requires a gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .nf4_gmm import _ALIGN, _aligned


def gmm_ref(lhs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
            bias: Optional[torch.Tensor] = None, *,
            transpose: bool = False) -> torch.Tensor:
    """Plain grouped product: rows of group g times W_g^T (or, with
    ``transpose``, times W_g: the dx of the forward) in fp32, one cast to
    lhs.dtype, then + bias[g] in lhs.dtype (forward only). Rows outside
    every group are zero."""
    ends = torch.cumsum(group_sizes.to(torch.int64), 0).tolist()
    n_out = w.shape[2] if transpose else w.shape[1]
    out = torch.zeros((lhs.shape[0], n_out), dtype=lhs.dtype,
                      device=lhs.device)
    start = 0
    for g, end in enumerate(ends):
        if end > start:
            wg = w[g].to(torch.float32)
            y = (lhs[start:end].to(torch.float32)
                 @ (wg if transpose else wg.t())).to(lhs.dtype)
            if bias is not None and not transpose:
                y = y + bias[g].to(lhs.dtype)
            out[start:end] = y
        start = end
    return out


def _check_cuda(name: str, t: torch.Tensor, w: torch.Tensor,
                group_sizes: torch.Tensor, inner: int) -> None:
    if t.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device {t.device}")
    if t.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise NotImplementedError(f"{name} CUDA kernel takes bfloat16 input "
                                  f"and weights, got {t.dtype} and {w.dtype}")
    if t.ndim != 2 or w.ndim != 3 or t.shape[1] != inner:
        raise ValueError(f"{name}: input {tuple(t.shape)}, W "
                         f"{tuple(w.shape)}")
    e, n, k = w.shape
    if n % 8 or k % 8:
        raise NotImplementedError(f"{name} CUDA kernel needs N and K "
                                  f"multiples of 8; got W {tuple(w.shape)}")
    if w.device != t.device or group_sizes.device != t.device:
        raise ValueError(f"{name}: input on {t.device}, W on {w.device}, "
                         f"group sizes on {group_sizes.device}")
    if not w.is_contiguous() or w.data_ptr() % _ALIGN:
        raise ValueError(f"{name}: W must be contiguous and 16-byte aligned")
    if group_sizes.shape != (e,):
        raise ValueError(f"{name}: group_sizes {tuple(group_sizes.shape)} "
                         f"for {e} experts")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def gmm_fwd(lhs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out [m, N] = lhs [m, K] @ W_g^T (+ bias[g]) per group, W [E, N, K];
    the plain version on a CPU tensor, K19 on a CUDA one."""
    if lhs.device.type == "cpu":
        return gmm_ref(lhs, w, group_sizes, bias)
    _check_cuda("gmm", lhs, w, group_sizes, w.shape[2])
    e, n, k = w.shape
    m = lhs.shape[0]
    if bias is not None and (tuple(bias.shape) != (e, n)
                             or bias.device != lhs.device):
        raise ValueError(f"gmm: bias {tuple(bias.shape)} on {bias.device} "
                         f"for W {tuple(w.shape)} on {lhs.device}")
    out = torch.zeros((m, n), dtype=lhs.dtype, device=lhs.device)
    if m == 0:
        return out
    x = _aligned(lhs)
    b = None if bias is None else bias.to(lhs.dtype).contiguous()
    gs = group_sizes.to(torch.int32).contiguous()
    rc = kernels.library().unsloth_gmm_bf16(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        gs.data_ptr(), out.data_ptr(), m, e, n, k, _stream(lhs))
    kernels.check(rc, "gmm")
    gmm.launches += 1
    return out


def gmm_dx(g: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor
           ) -> torch.Tensor:
    """dx [m, K] = g [m, N] @ W_g per group, the backward of :func:`gmm`
    with respect to its input; the plain version on a CPU tensor, K19's dx
    on a CUDA one."""
    if g.device.type == "cpu":
        return gmm_ref(g, w, group_sizes, transpose=True)
    _check_cuda("gmm_dx", g, w, group_sizes, w.shape[1])
    e, n, k = w.shape
    m = g.shape[0]
    dx = torch.zeros((m, k), dtype=g.dtype, device=g.device)
    if m == 0:
        return dx
    gg = _aligned(g)
    gs = group_sizes.to(torch.int32).contiguous()
    rc = kernels.library().unsloth_gmm_dx_bf16(
        gg.data_ptr(), w.data_ptr(), gs.data_ptr(), dx.data_ptr(), m, e, n,
        k, _stream(g))
    kernels.check(rc, "gmm_dx")
    gmm_dx.launches += 1
    return dx


#: number of kernel launches since the last reset (CPU calls do not count)
gmm_dx.launches = 0


class _Gmm(torch.autograd.Function):
    """Grouped y = x @ W_g^T + b_g with the gradient to x only (the lhs
    half of megablox's VJP); W and the group sizes are saved, no
    activation."""

    @staticmethod
    def forward(ctx, x, w, group_sizes, bias):
        ctx.save_for_backward(w, group_sizes)
        return gmm_fwd(x, w, group_sizes, bias)

    @staticmethod
    def backward(ctx, gy):
        w, group_sizes = ctx.saved_tensors
        return gmm_dx(gy, w, group_sizes), None, None, None


def gmm(lhs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped lhs[rows of group g] @ W_g^T (+ bias[g]) with W [E, N, K]
    dense and rows sorted by expert; differentiable in lhs (the backward
    is :func:`gmm_dx`).

    CUDA: bf16 lhs and W, W contiguous, N and K multiples of 8; anything
    else raises. W or the bias requiring a gradient raises: their gradient
    is megablox ``tgmm``, which full fine-tuning of the experts needs and
    the port does not have yet."""
    if torch.is_grad_enabled() and (
            w.requires_grad or (bias is not None and bias.requires_grad)):
        raise NotImplementedError(
            "gmm: the gradient of the expert weights or biases (megablox "
            "tgmm) is not ported; the experts are frozen under QLoRA")
    if lhs.requires_grad and torch.is_grad_enabled():
        return _Gmm.apply(lhs, w, group_sizes, bias)
    return gmm_fwd(lhs, w, group_sizes, bias)


#: number of kernel launches since the last reset (CPU calls do not count)
gmm.launches = 0
