"""RMSNorm forward, in PyTorch with a hand-written CUDA kernel.

Counterpart of unsloth_tpu/ops/rms_norm.py:rms_norm: fp32 statistics
whatever the input dtype, and the Gemma variant's ``(1 + w)`` scale in
fp32. On a CUDA tensor :func:`rms_norm` launches ``csrc/rms_norm.cu``; on
a CPU tensor it runs :func:`rms_norm_ref`. The device of ``x`` is the only
thing that chooses. The backward (TPU ``_bwd_kernel``) comes with the
training slice.
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
    """RMSNorm over the last axis. x: [..., D] (bf16 or f32), w: [D]."""
    if x.device.type == "cpu":
        return rms_norm_ref(x, w, eps, gemma)
    if x.device.type != "cuda":
        raise NotImplementedError(f"rms_norm: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise NotImplementedError(
            f"rms_norm CUDA kernel takes float32/bfloat16, got x {x.dtype}, "
            f"w {w.dtype}")
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rms_norm: w shape {tuple(w.shape)} != ({d},)")
    if w.device != x.device:
        raise ValueError(f"rms_norm: x on {x.device}, w on {w.device}")
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
