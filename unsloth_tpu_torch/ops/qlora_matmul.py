"""Fused NF4 dequant-inside-matmul forward (the QLoRA projection).

Counterpart of unsloth_tpu/ops/qlora_matmul.py:nf4_matmul. On a CUDA
tensor it launches the hand-written kernel in ``csrc/nf4_matmul.cu``: the
packed uint8 weight streams from device memory and is decoded in shared
memory right before the tensor cores use it, so the dense weight never
exists in device memory. On a CPU tensor it runs the plain version,
:func:`nf4_matmul_ref`. The device of ``x`` is the only thing that chooses;
there is no fallback from the kernel to the plain version.

The backward (dx = g @ W, TPU ``_bwd_kernel``) comes with the training
slice.
"""

from __future__ import annotations

import torch

from .. import kernels
from .nf4 import NF4Tensor, _decode_absmax, nf4_matmul_ref

_ALIGN = 16  # bytes: the kernel reads x and the packed bytes 16 at a time


def nf4_matmul(x: torch.Tensor, q: NF4Tensor) -> torch.Tensor:
    """y = x @ dequant(W)^T; x [..., in], W [out, in] NF4; y in x.dtype.

    CUDA: bf16 x only, ``in/2`` a multiple of 64 and ``block_size`` 64
    (one absmax block per kernel step); anything else raises."""
    if x.device.type == "cpu":
        return nf4_matmul_ref(x, q)
    if x.device.type != "cuda":
        raise NotImplementedError(
            f"nf4_matmul: no kernel for device {x.device}")
    out_f, in_f = q.shape
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"nf4_matmul CUDA kernel takes bfloat16 x, got {x.dtype}")
    if x.shape[-1] != in_f:
        raise ValueError(f"nf4_matmul: x has {x.shape[-1]} features, "
                         f"W expects {in_f}")
    if q.block_size != 64 or (in_f // 2) % 64:
        raise NotImplementedError(
            f"nf4_matmul CUDA kernel needs block_size 64 and in/2 % 64 == 0,"
            f" got block_size {q.block_size}, in {in_f}")
    if q.packed.device != x.device:
        raise ValueError(f"nf4_matmul: x on {x.device}, W on "
                         f"{q.packed.device}")
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
