"""FP8 block quantization, in PyTorch.

Counterpart of unsloth_tpu/ops/fp8.py, with the same storage so that FP8
tensors compare byte for byte across the two packages: the values are
``float8_e4m3fn [out, in]`` and the scales fp32 ``[ceil(out/B),
ceil(in/B)]``, one per B x B block (default B = 128), the DeepSeek/vLLM
``weight`` + ``weight_scale_inv`` format, so an FP8 checkpoint pair loads
as it is stored. A weight decodes as ``fp32(value) * scale``, rounded once
to the dtype asked for.

The fused dequant-inside-matmul kernels (K12 forward, K13 dx) live in
``fp8_matmul.py``; :func:`fp8_matmul_ref` here is the forward's plain
version.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0


@dataclasses.dataclass
class FP8Tensor:
    """Block-scaled FP8 2-D weight [out_features, in_features]."""

    values: torch.Tensor      # float8_e4m3fn [out, in]
    scales: torch.Tensor      # fp32 [ceil(out/B), ceil(in/B)]
    shape: Tuple[int, int]
    block: int = 128
    dtype: torch.dtype = torch.bfloat16   # default dequant dtype

    @property
    def nbytes(self) -> int:
        return self.values.numel() + 4 * self.scales.numel()

    def to(self, device) -> "FP8Tensor":
        return dataclasses.replace(self, values=self.values.to(device),
                                   scales=self.scales.to(device))


def quantize_fp8_block(w: torch.Tensor, block: int = 128,
                       dtype: torch.dtype = torch.bfloat16) -> FP8Tensor:
    """Quantize a 2-D weight on its own device: pad to whole blocks, take
    each block's amax, scale = amax / 448 (1 where the block is all zero),
    divide, cut back to [out, in] and round to e4m3 (nearest even), as the
    JAX package does. ``|w / scale| <= 448`` up to one fp32 rounding, so
    no value reaches e4m3's NaN."""
    out_f, in_f = w.shape
    pb_o = -(-out_f // block)
    pb_i = -(-in_f // block)
    wp = F.pad(w.to(torch.float32),
               (0, pb_i * block - in_f, 0, pb_o * block - out_f))
    blocks = wp.reshape(pb_o, block, pb_i, block)
    amax = blocks.abs().amax(dim=(1, 3))                 # [pb_o, pb_i]
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / FP8_MAX)
    scaled = blocks / scale[:, None, :, None]
    vals = scaled.reshape(pb_o * block, pb_i * block)[
        :out_f, :in_f].to(FP8_DTYPE)
    return FP8Tensor(values=vals, scales=scale, shape=(out_f, in_f),
                     block=block, dtype=dtype)


def dequantize_fp8(q: FP8Tensor, dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
    """fp32(value) * its block's scale, rounded once to ``dtype`` (default
    ``q.dtype``)."""
    dtype = dtype or q.dtype
    out_f, in_f = q.shape
    b = q.block
    scale_up = q.scales.repeat_interleave(b, 0).repeat_interleave(b, 1)
    return (q.values.to(torch.float32)
            * scale_up[:out_f, :in_f]).to(dtype)


def fp8_matmul_ref(x: torch.Tensor, q: FP8Tensor) -> torch.Tensor:
    """Plain x @ W^T for an FP8 W: W dequantized to x.dtype, one matmul
    whose output is in x.dtype (the TPU kernel's rounding points). The
    plain version of K12."""
    return torch.matmul(x, dequantize_fp8(q, x.dtype).t())


def load_fp8_checkpoint_tensor(weight_fp8: torch.Tensor,
                               weight_scale_inv: torch.Tensor,
                               block: int = 128,
                               dtype: torch.dtype = torch.bfloat16
                               ) -> FP8Tensor:
    """Wrap a DeepSeek/vLLM-format FP8 checkpoint pair (weight [out, in]
    e4m3, weight_scale_inv [out/B, in/B] fp32) without touching its
    values."""
    return FP8Tensor(values=weight_fp8.to(FP8_DTYPE),
                     scales=weight_scale_inv.to(torch.float32),
                     shape=tuple(weight_fp8.shape), block=block, dtype=dtype)
