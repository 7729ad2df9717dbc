"""Fused FP8 block-dequant-inside-matmul (a projection over an FP8 base),
forward and backward.

Counterpart of unsloth_tpu/ops/fp8_matmul.py:fp8_matmul. On a CUDA tensor
the forward launches the hand-written kernel K12 in ``csrc/fp8_matmul.cu``
(TPU ``_fwd_kernel``): the e4m3 weight streams from device memory at one
byte a parameter and is scaled and rounded to bf16 in shared memory right
before the tensor cores use it, so the dense weight never exists in device
memory. The backward, dx = g @ W, is K13 in the same file (TPU
``_bwd_kernel``); W is frozen, so the gradient goes to x only. On a CPU
tensor both run their plain versions, :func:`~.fp8.fp8_matmul_ref` and
:func:`fp8_matmul_dx_ref`. The device of the tensor is the only thing that
chooses: the JAX package's opt-in switch (``UNSLOTH_FUSED_FP8``) and its
``% 128`` shape gate have no counterpart, and there is no fallback from a
kernel to its plain version.
"""

from __future__ import annotations

import torch

from .. import kernels
from .fp8 import FP8_DTYPE, FP8Tensor, dequantize_fp8, fp8_matmul_ref

_MAX_ROW_TILES = 65535   # the kernels' grid.y: ceil(M / 64) row tiles


def fp8_matmul(x: torch.Tensor, q: FP8Tensor) -> torch.Tensor:
    """y = x @ dequant(W)^T; x [..., in], W [out, in] FP8; y in x.dtype.
    Differentiable in x (the backward is :func:`fp8_matmul_dx`).

    CUDA: bf16 x only (any row count, any out/in and block size);
    anything else raises."""
    if isinstance(x, torch.Tensor) and x.requires_grad \
            and torch.is_grad_enabled():
        return _FP8Matmul.apply(x, q)
    return fp8_matmul_fwd(x, q)


def _check_cuda(name: str, t: torch.Tensor, q: FP8Tensor, inner: int,
                inner_name: str) -> None:
    if t.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device {t.device}")
    if t.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{name} CUDA kernel takes bfloat16, got {t.dtype}")
    if t.shape[-1] != inner:
        raise ValueError(f"{name}: input has {t.shape[-1]} features, "
                         f"W expects {inner} ({inner_name})")
    out_f, in_f = q.shape
    grid = (-(-out_f // q.block), -(-in_f // q.block))
    if q.values.dtype != FP8_DTYPE or q.scales.dtype != torch.float32:
        raise TypeError(f"{name}: W must be float8_e4m3fn values with fp32 "
                        f"scales, got {q.values.dtype} and {q.scales.dtype}")
    if tuple(q.values.shape) != (out_f, in_f) or \
            tuple(q.scales.shape) != grid:
        raise ValueError(f"{name}: values {tuple(q.values.shape)} and scales "
                         f"{tuple(q.scales.shape)} do not fit shape "
                         f"{q.shape} at block {q.block} (scales {grid})")
    if q.values.device != t.device or q.scales.device != t.device:
        raise ValueError(f"{name}: input on {t.device}, W on "
                         f"{q.values.device}")


def _launch(fn, name: str, a: torch.Tensor, q: FP8Tensor, cols: int
            ) -> torch.Tensor:
    """Run ``fn`` (a C entry point) on a's rows; returns [..., cols]."""
    lead = a.shape[:-1]
    a2d = a.reshape(-1, a.shape[-1]).contiguous()
    m = a2d.shape[0]
    out = torch.empty((m, cols), dtype=a.dtype, device=a.device)
    if m == 0:
        return out.reshape(*lead, cols)
    if -(-m // 64) > _MAX_ROW_TILES:
        raise NotImplementedError(f"{name}: {m} rows exceed the kernel's "
                                  f"grid ({_MAX_ROW_TILES} tiles of 64)")
    out_f, in_f = q.shape
    values, scales = q.values.contiguous(), q.scales.contiguous()
    rc = fn(a2d.data_ptr(), values.data_ptr(), scales.data_ptr(),
            out.data_ptr(), m, out_f, in_f, q.block,
            torch.cuda.current_stream(a.device).cuda_stream)
    kernels.check(rc, name)
    return out.reshape(*lead, cols)


def fp8_matmul_fwd(x: torch.Tensor, q: FP8Tensor) -> torch.Tensor:
    """y = x @ dequant(W)^T without autograd: K12 on a CUDA tensor, the
    plain :func:`~.fp8.fp8_matmul_ref` on a CPU one."""
    if x.device.type == "cpu":
        return fp8_matmul_ref(x, q)
    _check_cuda("fp8_matmul", x, q, q.shape[1], "in")
    y = _launch(kernels.library().unsloth_fp8_matmul_bf16, "fp8_matmul", x,
                q, q.shape[0])
    fp8_matmul_fwd.launches += 1
    return y


#: number of kernel launches since the last reset (CPU calls do not count)
fp8_matmul_fwd.launches = 0


def fp8_matmul_dx_ref(g: torch.Tensor, q: FP8Tensor) -> torch.Tensor:
    """Plain dx = g @ dequant(W): W dequantized to g.dtype, one matmul whose
    output is in g.dtype (the TPU kernel's rounding points). The plain
    version of K13."""
    return torch.matmul(g, dequantize_fp8(q, g.dtype))


def fp8_matmul_dx(g: torch.Tensor, q: FP8Tensor) -> torch.Tensor:
    """dx = g @ dequant(W); g [..., out], W [out, in] FP8; dx [..., in] in
    g.dtype. The backward of :func:`fp8_matmul` with respect to x: K13 on a
    CUDA tensor (bf16 g only), the plain version on a CPU one."""
    if g.device.type == "cpu":
        return fp8_matmul_dx_ref(g, q)
    _check_cuda("fp8_matmul_dx", g, q, q.shape[0], "out")
    dx = _launch(kernels.library().unsloth_fp8_matmul_dx_bf16,
                 "fp8_matmul_dx", g, q, q.shape[1])
    fp8_matmul_dx.launches += 1
    return dx


#: number of kernel launches since the last reset (CPU calls do not count)
fp8_matmul_dx.launches = 0


class _FP8Matmul(torch.autograd.Function):
    """y = x @ W^T with the gradient to x only (JAX ``_vjp_bwd``, which
    gives the FP8 base zeros). The weight is frozen and kept on ``ctx``; no
    activation is saved."""

    @staticmethod
    def forward(ctx, x, q):
        ctx.q = q
        return fp8_matmul_fwd(x, q)

    @staticmethod
    def backward(ctx, g):
        return fp8_matmul_dx(g, ctx.q), None
