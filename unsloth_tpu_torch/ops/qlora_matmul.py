"""Fused NF4 dequant-inside-matmul (the QLoRA projection), forward and
backward.

Counterpart of unsloth_tpu/ops/qlora_matmul.py:nf4_matmul. On a CUDA
tensor the forward launches the hand-written kernel in
``csrc/nf4_matmul.cu`` (TPU ``_fwd_kernel``): the packed uint8 weight
streams from device memory and is decoded in shared memory right before
the tensor cores use it, so the dense weight never exists in device
memory. The backward, dx = g @ W, is a second kernel in the same file
(TPU ``_bwd_kernel``); W is frozen, so the gradient goes to x only. On a
CPU tensor both run their plain versions, :func:`nf4_matmul_ref` and
:func:`nf4_matmul_dx_ref`. The device of the tensor is the only thing that
chooses; there is no fallback from a kernel to its plain version.
"""

from __future__ import annotations

import torch

from .. import kernels
from .nf4 import NF4Tensor, _decode_absmax, dequantize_nf4, nf4_matmul_ref

_ALIGN = 16  # bytes: the kernel reads x and the packed bytes 16 at a time


def nf4_matmul(x: torch.Tensor, q: NF4Tensor) -> torch.Tensor:
    """y = x @ dequant(W)^T; x [..., in], W [out, in] NF4; y in x.dtype.
    Differentiable in x (the backward is :func:`nf4_matmul_dx`).

    CUDA: bf16 x only, ``in/2`` a multiple of 32 and ``block_size`` 64
    (each 16-column chunk looks up its own absmax, so a block may straddle
    the split-half boundary, as at gpt-oss's in = 2,880); anything else
    raises."""
    if isinstance(x, torch.Tensor) and x.requires_grad \
            and torch.is_grad_enabled():
        return _NF4Matmul.apply(x, q)
    return _nf4_matmul_fwd(x, q)


def _check_cuda(name: str, t: torch.Tensor, q: NF4Tensor, inner: int,
                inner_name: str) -> None:
    if t.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device {t.device}")
    out_f, in_f = q.shape
    if t.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{name} CUDA kernel takes bfloat16, got {t.dtype}")
    if t.shape[-1] != inner:
        raise ValueError(f"{name}: input has {t.shape[-1]} features, "
                         f"W expects {inner} ({inner_name})")
    if q.block_size != 64 or (in_f // 2) % 32:
        raise NotImplementedError(
            f"{name} CUDA kernel needs block_size 64 and in/2 % 32 == 0,"
            f" got block_size {q.block_size}, in {in_f}")
    if q.packed.device != t.device:
        raise ValueError(f"{name}: input on {t.device}, W on "
                         f"{q.packed.device}")


def _nf4_matmul_fwd(x: torch.Tensor, q: NF4Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return nf4_matmul_ref(x, q)
    _check_cuda("nf4_matmul", x, q, q.shape[1], "in")
    out_f, in_f = q.shape
    lead = x.shape[:-1]
    x2d = x.reshape(-1, in_f).contiguous()
    m = x2d.shape[0]
    y = torch.empty((m, out_f), dtype=x.dtype, device=x.device)
    if m == 0:
        return y.reshape(*lead, out_f)
    if x2d.data_ptr() % _ALIGN:   # a view at an odd offset: fresh copy
        x2d = x2d.clone()
    packed = q.packed.contiguous()
    if packed.data_ptr() % _ALIGN:
        raise ValueError(f"nf4_matmul: packed weight is not {_ALIGN}-byte "
                         "aligned")
    absmax = _decode_absmax(q).contiguous()
    lib = kernels.library()
    rc = lib.unsloth_nf4_matmul_bf16(
        x2d.data_ptr(), packed.data_ptr(), absmax.data_ptr(), y.data_ptr(),
        m, out_f, in_f, torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "nf4_matmul")
    nf4_matmul.launches += 1
    return y.reshape(*lead, out_f)


#: number of kernel launches since the last reset (CPU calls do not count)
nf4_matmul.launches = 0


def nf4_matmul_dx_ref(g: torch.Tensor, q: NF4Tensor) -> torch.Tensor:
    """Plain dx = g @ dequant(W): W dequantized to g.dtype, one matmul whose
    output is in g.dtype (the TPU kernel's rounding points)."""
    return torch.matmul(g, dequantize_nf4(q, dtype=g.dtype))


def nf4_matmul_dx(g: torch.Tensor, q: NF4Tensor) -> torch.Tensor:
    """dx = g @ dequant(W); g [..., out], W [out, in] NF4; dx [..., in] in
    g.dtype. The backward of :func:`nf4_matmul` with respect to x.

    CUDA: bf16 g only, ``out`` a multiple of 64 (the kernel's reduction
    step), ``in/2`` a multiple of 32 and ``block_size`` 64."""
    if g.device.type == "cpu":
        return nf4_matmul_dx_ref(g, q)
    _check_cuda("nf4_matmul_dx", g, q, q.shape[0], "out")
    out_f, in_f = q.shape
    if out_f % 64:
        raise NotImplementedError(
            f"nf4_matmul_dx CUDA kernel needs out % 64 == 0, got {out_f}")
    lead = g.shape[:-1]
    g2d = g.reshape(-1, out_f).contiguous()
    m = g2d.shape[0]
    dx = torch.empty((m, in_f), dtype=g.dtype, device=g.device)
    if m == 0:
        return dx.reshape(*lead, in_f)
    if g2d.data_ptr() % _ALIGN:
        g2d = g2d.clone()
    packed = q.packed.contiguous()
    if packed.data_ptr() % _ALIGN:
        raise ValueError(f"nf4_matmul_dx: packed weight is not {_ALIGN}-byte "
                         "aligned")
    absmax = _decode_absmax(q).contiguous()
    rc = kernels.library().unsloth_nf4_matmul_dx_bf16(
        g2d.data_ptr(), packed.data_ptr(), absmax.data_ptr(), dx.data_ptr(),
        m, out_f, in_f, torch.cuda.current_stream(g.device).cuda_stream)
    kernels.check(rc, "nf4_matmul_dx")
    nf4_matmul_dx.launches += 1
    return dx.reshape(*lead, in_f)


#: number of kernel launches since the last reset (CPU calls do not count)
nf4_matmul_dx.launches = 0


class _NF4Matmul(torch.autograd.Function):
    """y = x @ W^T with the gradient to x only (JAX ``_nf4_vjp_bwd``). The
    NF4 weight is frozen and kept on ``ctx``; no activation is saved."""

    @staticmethod
    def forward(ctx, x, q):
        ctx.q = q
        return _nf4_matmul_fwd(x, q)

    @staticmethod
    def backward(ctx, g):
        return nf4_matmul_dx(g, ctx.q), None
