"""Grouped NF4 dequant-inside-matmul over experts (the MoE QLoRA hot
path), forward and backward.

Counterpart of unsloth_tpu/ops/nf4_gmm.py. Rows of the input are sorted by
expert; ``group_sizes`` [E] (int32, on the input's device) says how many
rows each expert owns. On a CUDA tensor :func:`nf4_gmm` launches the
hand-written kernel in ``csrc/nf4_gmm.cu`` (TPU ``_fwd_kernel``, K14),
with the optional per-expert bias [E, N] added in its store epilogue; its
backward, dx = g @ W_g per group, is the second kernel of that file (TPU
``_bwd_kernel``, K15). W and the bias are frozen, so the gradient goes to
the input only. The packed uint8 expert weights stream from device memory
and are decoded in shared memory, so the dense [E, N, K] stack never
exists in device memory. On a CPU tensor both run the plain version
:func:`nf4_gmm_ref`. The device of the tensor is the only thing that
chooses; there is no fallback from a kernel to its plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .nf4 import NF4Stacked, dequantize_nf4_stacked

_ALIGN = 16  # bytes: the kernels read x and the packed bytes 16 at a time


def nf4_gmm_ref(lhs: torch.Tensor, q: NF4Stacked, group_sizes: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *,
                transpose: bool = False) -> torch.Tensor:
    """Plain grouped product (JAX ``nf4_gmm_ref``): W dequantized to fp32,
    rows of group g times W_g^T (or, with ``transpose``, times W_g: the
    dx of the forward) in fp32, plus bias[g] (forward only), one cast to
    lhs.dtype. Rows outside every group are zero."""
    w = dequantize_nf4_stacked(q, torch.float32)
    ends = torch.cumsum(group_sizes.to(torch.int64), 0)
    starts = ends - group_sizes.to(torch.int64)
    n_out = q.shape[2] if transpose else q.shape[1]
    x = lhs.to(torch.float32)
    out = torch.zeros((lhs.shape[0], n_out), dtype=torch.float32,
                      device=lhs.device)
    for g, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
        if e <= s:
            continue
        y = x[s:e] @ (w[g] if transpose else w[g].t())
        if bias is not None and not transpose:
            y = y + bias[g].to(torch.float32)
        out[s:e] = y
    return out.to(lhs.dtype)


def use_nf4_gmm(q) -> bool:
    """Quant blocks align to the split-half boundary (``in/2 % bs == 0``):
    the JAX package's condition for its fused kernel, and the port's for
    its kernels."""
    return (isinstance(q, NF4Stacked) and q.shape[2] % 2 == 0
            and (q.shape[2] // 2) % q.block_size == 0)


def _check_cuda(name: str, t: torch.Tensor, q: NF4Stacked,
                group_sizes: torch.Tensor, inner: int) -> None:
    if t.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device {t.device}")
    e, n, k = q.shape
    if t.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{name} CUDA kernel takes bfloat16, got {t.dtype}")
    if t.ndim != 2 or t.shape[1] != inner:
        raise ValueError(f"{name}: input {tuple(t.shape)}, W {q.shape}")
    if (q.block_size not in (32, 64) or not use_nf4_gmm(q) or (k // 2) % 32
            or n % 8):
        raise NotImplementedError(
            f"{name} CUDA kernel needs block_size 32 or 64, in/2 a multiple "
            f"of 32 and of the block, out a multiple of 8; got W {q.shape} "
            f"block_size {q.block_size}")
    if q.packed.device != t.device or group_sizes.device != t.device:
        raise ValueError(f"{name}: input on {t.device}, W on "
                         f"{q.packed.device}, group sizes on "
                         f"{group_sizes.device}")
    if group_sizes.shape != (e,):
        raise ValueError(f"{name}: group_sizes {tuple(group_sizes.shape)} "
                         f"for {e} experts")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % _ALIGN else t


def nf4_gmm_fwd(lhs: torch.Tensor, q: NF4Stacked, group_sizes: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out [m, N] = lhs [m, K] @ dequant(W_g)^T (+ bias[g]) per group; the
    plain version on a CPU tensor, K14 on a CUDA one."""
    if lhs.device.type == "cpu":
        return nf4_gmm_ref(lhs, q, group_sizes, bias)
    _check_cuda("nf4_gmm", lhs, q, group_sizes, q.shape[2])
    e, n, k = q.shape
    m = lhs.shape[0]
    out = torch.zeros((m, n), dtype=lhs.dtype, device=lhs.device)
    if m == 0:
        return out
    x = _aligned(lhs)
    packed = q.packed.contiguous()
    absmax = q.absmax.to(torch.float32).contiguous()
    b = None if bias is None else bias.to(torch.float32).contiguous()
    gs = group_sizes.to(torch.int32).contiguous()
    rc = kernels.library().unsloth_nf4_gmm_bf16(
        x.data_ptr(), packed.data_ptr(), absmax.data_ptr(),
        None if b is None else b.data_ptr(), gs.data_ptr(), out.data_ptr(),
        m, e, n, k, q.block_size,
        torch.cuda.current_stream(lhs.device).cuda_stream)
    kernels.check(rc, "nf4_gmm")
    nf4_gmm.launches += 1
    return out


def nf4_gmm_dx(g: torch.Tensor, q: NF4Stacked, group_sizes: torch.Tensor
               ) -> torch.Tensor:
    """dx [m, K] = g [m, N] @ dequant(W_g) per group, the backward of
    :func:`nf4_gmm` with respect to its input; the plain version on a CPU
    tensor, K15 on a CUDA one."""
    if g.device.type == "cpu":
        return nf4_gmm_ref(g, q, group_sizes, transpose=True)
    _check_cuda("nf4_gmm_dx", g, q, group_sizes, q.shape[1])
    e, n, k = q.shape
    m = g.shape[0]
    dx = torch.zeros((m, k), dtype=g.dtype, device=g.device)
    if m == 0:
        return dx
    gg = _aligned(g)
    packed = q.packed.contiguous()
    absmax = q.absmax.to(torch.float32).contiguous()
    gs = group_sizes.to(torch.int32).contiguous()
    rc = kernels.library().unsloth_nf4_gmm_dx_bf16(
        gg.data_ptr(), packed.data_ptr(), absmax.data_ptr(), gs.data_ptr(),
        dx.data_ptr(), m, e, n, k, q.block_size,
        torch.cuda.current_stream(g.device).cuda_stream)
    kernels.check(rc, "nf4_gmm_dx")
    nf4_gmm_dx.launches += 1
    return dx


#: number of kernel launches since the last reset (CPU calls do not count)
nf4_gmm_dx.launches = 0


class _NF4Gmm(torch.autograd.Function):
    """Grouped y = x @ W_g^T + b_g with the gradient to x only (JAX
    ``_vjp_bwd``: dW and dbias are zero, the base is frozen). The NF4
    weight and the group sizes are kept on ``ctx``; no activation is
    saved."""

    @staticmethod
    def forward(ctx, x, q, group_sizes, bias):
        ctx.q = q
        ctx.save_for_backward(group_sizes)
        return nf4_gmm_fwd(x, q, group_sizes, bias)

    @staticmethod
    def backward(ctx, gy):
        (group_sizes,) = ctx.saved_tensors
        return nf4_gmm_dx(gy, ctx.q, group_sizes), None, None, None


def nf4_gmm(lhs: torch.Tensor, q: NF4Stacked, group_sizes: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped lhs[rows of group g] @ dequant(W_g)^T (+ bias[g]) with W
    NF4Stacked [E, N, K] and rows sorted by expert; differentiable in lhs
    (the backward is :func:`nf4_gmm_dx`).

    CUDA: bf16 lhs, block size 32 or 64 with ``K/2`` a multiple of it and
    of 32, ``N`` a multiple of 8; anything else raises."""
    if lhs.requires_grad and torch.is_grad_enabled():
        return _NF4Gmm.apply(lhs, q, group_sizes, bias)
    return nf4_gmm_fwd(lhs, q, group_sizes, bias)


#: number of kernel launches since the last reset (CPU calls do not count)
nf4_gmm.launches = 0
