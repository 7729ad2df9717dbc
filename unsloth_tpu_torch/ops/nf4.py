"""NF4 (NormalFloat-4) blockwise quantization, in PyTorch.

Counterpart of unsloth_tpu/ops/nf4.py, with the same storage so that NF4
tensors compare byte for byte across the two packages:

  * ``packed``  uint8 [out, in/2] in **split-half order**: the high nibble
    of byte [o, j] is element [o, j], the low nibble is element
    [o, j + in/2] (not bitsandbytes' interleaved order);
  * ``absmax``  one scale per ``block_size`` elements of the row-major
    flattened weight: fp32, or with double quantization int8 codes plus an
    fp32 per-group scale and one fp32 offset (groups of
    ``double_block_size`` absmax entries). A value decodes as
    ``code * scale + offset``.

The fused dequant-inside-matmul kernel lives in ``qlora_matmul.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_NF4_CODE_NP = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
], dtype=np.float32)
NF4_CODE = torch.from_numpy(_NF4_CODE_NP.copy())

# Decision boundaries (fp32 midpoints) for nearest-value quantization.
_NF4_BOUNDARIES = torch.from_numpy(
    (_NF4_CODE_NP[1:] + _NF4_CODE_NP[:-1]) / np.float32(2.0))

DEFAULT_BLOCK = 64
DEFAULT_DOUBLE_BLOCK = 256


@dataclasses.dataclass
class NF4Tensor:
    """Quantized 2-D weight [out_features, in_features]."""

    packed: torch.Tensor                   # uint8 [out, in//2]
    absmax: torch.Tensor                   # fp32 [n_blocks] or int8 codes
    absmax_scale: Optional[torch.Tensor]   # fp32 [n_groups] if double-quant
    absmax_offset: Optional[torch.Tensor]  # fp32 scalar if double-quant
    shape: Tuple[int, int]
    block_size: int = DEFAULT_BLOCK
    dtype: torch.dtype = torch.bfloat16    # dequant target dtype
    double_block_size: int = DEFAULT_DOUBLE_BLOCK

    @property
    def is_double_quant(self) -> bool:
        return self.absmax_scale is not None

    @property
    def device(self) -> torch.device:
        return self.packed.device

    @property
    def nbytes(self) -> int:
        n = self.packed.numel() + self.absmax.numel() * self.absmax.element_size()
        if self.absmax_scale is not None:
            n += self.absmax_scale.numel() * 4 + 4
        return n

    def to(self, device) -> "NF4Tensor":
        def mv(t):
            return None if t is None else t.to(device)

        return dataclasses.replace(
            self, packed=mv(self.packed), absmax=mv(self.absmax),
            absmax_scale=mv(self.absmax_scale),
            absmax_offset=mv(self.absmax_offset))


def quantize_nf4(w: torch.Tensor, block_size: int = DEFAULT_BLOCK,
                 double_quant: bool = True,
                 double_block_size: int = DEFAULT_DOUBLE_BLOCK,
                 dtype: torch.dtype = torch.bfloat16) -> NF4Tensor:
    """Quantize a 2-D weight to NF4 on the weight's own device.

    Row-major flattening; a block never spans two rows, so in_features
    must be a multiple of ``block_size``."""
    out_f, in_f = w.shape
    if in_f % block_size or in_f % 2:
        raise ValueError(f"in_features {in_f} must be even and divisible by "
                         f"block_size {block_size}")
    blocks = w.reshape(-1, block_size).to(torch.float32)
    absmax = blocks.abs().amax(dim=-1)
    safe = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    norm = blocks / safe[:, None]
    # index = number of boundaries <= value, i.e. the nearest codebook entry
    idx = torch.bucketize(norm, _NF4_BOUNDARIES.to(w.device), right=True,
                          out_int32=True).to(torch.uint8).reshape(out_f, in_f)
    del norm
    half = in_f // 2
    packed = (idx[:, :half] << 4) | idx[:, half:]
    if not double_quant:
        return NF4Tensor(packed, absmax, None, None, (out_f, in_f),
                         block_size, dtype)

    # Double quantization: subtract the global mean, then symmetric int8
    # per group of double_block_size absmax entries.
    n_blocks = absmax.shape[0]
    pad = (-n_blocks) % double_block_size
    offset = absmax.mean()
    groups = F.pad(absmax - offset, (0, pad)).reshape(-1, double_block_size)
    gmax = groups.abs().amax(dim=-1)
    gsafe = torch.where(gmax == 0, torch.ones_like(gmax), gmax)
    codes = torch.round(groups / gsafe[:, None] * 127.0).to(torch.int8)
    return NF4Tensor(
        packed=packed,
        absmax=codes.reshape(-1)[:n_blocks].contiguous(),
        absmax_scale=(gsafe / 127.0).to(torch.float32),
        absmax_offset=offset.to(torch.float32),
        shape=(out_f, in_f),
        block_size=block_size,
        dtype=dtype,
        double_block_size=double_block_size,
    )


def _decode_absmax(q: NF4Tensor) -> torch.Tensor:
    """Per-block scales as fp32 [n_blocks]."""
    if not q.is_double_quant:
        return q.absmax.to(torch.float32)
    n_blocks = q.absmax.shape[0]
    scale = q.absmax_scale.repeat_interleave(q.double_block_size)[:n_blocks]
    return q.absmax.to(torch.float32) * scale + q.absmax_offset


def dequantize_nf4(q: NF4Tensor, dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
    """Full dequantization [out, in]: fp32 code * fp32 scale, one cast."""
    dtype = dtype or q.dtype
    out_f, in_f = q.shape
    code = NF4_CODE.to(q.packed.device)
    hi = (q.packed >> 4).long()
    lo = (q.packed & 0xF).long()
    vals = torch.cat([code[hi], code[lo]], dim=-1)           # [out, in]
    absmax = _decode_absmax(q).reshape(out_f, in_f // q.block_size)
    return (vals * absmax.repeat_interleave(q.block_size, dim=-1)).to(dtype)


@dataclasses.dataclass
class NF4Stacked:
    """Stacked per-expert NF4 weights [E, out, in] (the MoE QLoRA base):
    the split-half packing of :class:`NF4Tensor` with a leading expert
    axis and plain fp32 absmax (no double quantization), one scale per
    ``block_size`` elements of each expert's row-major weight."""

    packed: torch.Tensor            # uint8 [E, out, in//2]
    absmax: torch.Tensor            # fp32 [E, out * in // block_size]
    shape: Tuple[int, int, int]
    block_size: int = DEFAULT_BLOCK
    dtype: torch.dtype = torch.bfloat16

    @property
    def ndim(self) -> int:
        return 3

    @property
    def device(self) -> torch.device:
        return self.packed.device

    @property
    def nbytes(self) -> int:
        return self.packed.numel() + self.absmax.numel() * 4

    def to(self, device) -> "NF4Stacked":
        return dataclasses.replace(self, packed=self.packed.to(device),
                                   absmax=self.absmax.to(device))


def quantize_nf4_stacked(w: torch.Tensor, block_size: int = DEFAULT_BLOCK,
                         dtype: torch.dtype = torch.bfloat16) -> NF4Stacked:
    """[E, out, in] -> stacked NF4: the experts flattened into rows and
    quantized as one 2-D weight (row-major blocks make the layouts equal),
    as the JAX package does."""
    e, out_f, in_f = w.shape
    q = quantize_nf4(w.reshape(e * out_f, in_f), block_size=block_size,
                     double_quant=False, dtype=dtype)
    return NF4Stacked(q.packed.reshape(e, out_f, in_f // 2),
                      q.absmax.reshape(e, -1), (e, out_f, in_f), block_size,
                      dtype)


def dequantize_nf4_stacked(q: NF4Stacked, dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """Full dequantization [E, out, in]: fp32 code * fp32 scale, one cast."""
    dtype = dtype or q.dtype
    e, out_f, in_f = q.shape
    flat = NF4Tensor(q.packed.reshape(e * out_f, in_f // 2),
                     q.absmax.reshape(-1), None, None, (e * out_f, in_f),
                     q.block_size, dtype)
    return dequantize_nf4(flat, dtype).reshape(e, out_f, in_f)


def nf4_matmul_ref(x: torch.Tensor, q: NF4Tensor) -> torch.Tensor:
    """x @ W^T with W stored NF4 (W [out, in], x [..., in]): dequantize to
    x.dtype, then one matmul whose output is in x.dtype.

    This is the plain version of the fused kernel and what
    unsloth_tpu.ops.lora.base_matmul computes off the TPU; JAX's own
    ``nf4_matmul_ref`` returns the fp32 sum instead."""
    w = dequantize_nf4(q, dtype=x.dtype)
    return torch.matmul(x, w.t())
