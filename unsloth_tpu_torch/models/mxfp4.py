"""MXFP4 checkpoint interop (gpt-oss), in PyTorch.

Counterpart of unsloth_tpu/models/mxfp4.py. The published gpt-oss
checkpoints store the MoE expert weights MXFP4-quantized: 32-element
blocks of fp4 (e2m1) values sharing one e8m0 exponent scale. On disk (HF
serialization, the semantics of transformers' ``convert_moe_packed_tensors``):

  ``...gate_up_proj_blocks``  uint8 [E, 2F, D/32, 16]: element 2j in the
                              LOW nibble of byte j, 2j+1 in the HIGH nibble
                              (the opposite order to bitsandbytes' 4-bit)
  ``...gate_up_proj_scales``  uint8 [E, 2F, D/32]: exponent + 127

  value = FP4_VALUES[nibble] * 2^(scale - 127)

Each tensor is dequantized once, at load, on the device it is loaded to;
the result feeds the same path as a bf16 checkpoint's experts.
"""

from __future__ import annotations

import torch

# The 16 e2m1 values, sign bit high (public format constants).
FP4_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
              -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0)


def dequantize_mxfp4(blocks: torch.Tensor, scales: torch.Tensor
                     ) -> torch.Tensor:
    """[*P, G, B] uint8 blocks + [*P, G] uint8 scales -> [*P, G*B*2] fp32,
    on the blocks' device."""
    if blocks.dtype != torch.uint8 or scales.dtype != torch.uint8:
        raise ValueError(f"MXFP4 blocks and scales are uint8, got "
                         f"{blocks.dtype} and {scales.dtype}")
    if tuple(blocks.shape[:-1]) != tuple(scales.shape):
        raise ValueError(f"MXFP4 blocks {tuple(blocks.shape)} do not match "
                         f"scales {tuple(scales.shape)}")
    *prefix, g, b = blocks.shape
    table = torch.tensor(FP4_VALUES, dtype=torch.float32, device=blocks.device)
    vals = torch.stack([table[(blocks & 0x0F).long()],
                        table[(blocks >> 4).long()]], dim=-1)  # [*P, G, B, 2]
    vals = vals.reshape(*prefix, g, b * 2)
    vals *= torch.exp2(scales.to(torch.float32) - 127.0)[..., None]
    return vals.reshape(*prefix, g * b * 2)


def is_mxfp4_quantized(reader, base: str) -> bool:
    return base + "_blocks" in reader and base + "_scales" in reader


def load_mxfp4_tensor(reader, base: str, device="cpu") -> torch.Tensor:
    """Dequantize ``<base>_blocks`` / ``<base>_scales`` on ``device``. For
    the gpt-oss expert tensors the result has HF's bf16 layout: gate_up
    [E, D, 2F] (input-major, transposed from the dequant's row-major
    [E, 2F, D]), down [E, F, D] likewise from [E, D, F]."""
    vals = dequantize_mxfp4(reader.get(base + "_blocks").to(device),
                            reader.get(base + "_scales").to(device))
    # rows are the OUTPUT dim in the quantized layout; HF's bf16 layout for
    # these tensors is input-major, hence the transpose
    # (convert_moe_packed_tensors ends with .transpose(1, 2))
    return vals.transpose(1, 2)
