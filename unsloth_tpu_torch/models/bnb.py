"""bitsandbytes 4-bit checkpoints (``unsloth/*-bnb-4bit``), in PyTorch.

Counterpart of unsloth_tpu/models/bnb.py: the pre-quantized repos that
every Unsloth notebook loads are read straight from their safetensors,
with no bitsandbytes, and repacked into the port's split-half
:class:`~unsloth_tpu_torch.ops.nf4.NF4Tensor` layout, so that they go
through the NF4 kernels (K1/K2) as weights quantized on load do.

The on-disk form (``Linear4bit`` through ``quant_state.as_dict(packed=True)``):

  ``<p>.weight``                   uint8 [N/2, 1]; flat row-major nibbles,
                                   element 2j in the HIGH nibble of byte j,
                                   element 2j+1 in the LOW nibble
  ``<p>.weight.absmax``            uint8 codes (double-quant) or fp32
  ``<p>.weight.quant_map``         fp32 [16] NF4 codebook
  ``<p>.weight.nested_absmax``     fp32 per-group scales (double-quant)
  ``<p>.weight.nested_quant_map``  fp32 [256] dynamic-8-bit code table
  ``<p>.weight.quant_state.bitsandbytes__nf4``
                                   uint8 blob of JSON metadata: blocksize,
                                   dtype, shape, nested_blocksize,
                                   nested_offset, quant_type

The double dequantization, in fp32 and in this order (bitsandbytes' and
the JAX package's), so that dequantized weights are bit-equal to theirs:

    absmax[i] = nested_quant_map[code[i]] * nested_absmax[i // nested_blocksize]
                + nested_offset
    w[k] = quant_map[nibble_k] * absmax[k // blocksize]

The decoded fp32 absmax is kept as it is (no re-double-quantization, no
``absmax_scale``), as in the JAX package. Decoding and repacking run on the
load device, one tensor at a time. fp4 checkpoints and a ``quant_map``
other than the NF4 codebook raise.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import torch

from ..ops.nf4 import NF4_CODE, NF4Tensor

QUANT_STATE_SUFFIXES = (
    ".quant_state.bitsandbytes__nf4",
    ".quant_state.bitsandbytes__fp4",
)

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def is_bnb_quantized(reader, name: str) -> bool:
    """True if tensor ``name`` has bnb 4-bit companion tensors."""
    return any(name + s in reader for s in QUANT_STATE_SUFFIXES) or (
        name + ".absmax" in reader and name + ".quant_map" in reader)


def parse_quant_state(blob: torch.Tensor) -> Dict[str, Any]:
    """The quant_state companion is a uint8 tensor of JSON bytes."""
    return json.loads(bytes(blob.reshape(-1).to(torch.uint8).tolist()).decode())


def decode_absmax(absmax: torch.Tensor, nested_absmax: Optional[torch.Tensor],
                  nested_quant_map: Optional[torch.Tensor],
                  nested_blocksize: int, nested_offset: float) -> torch.Tensor:
    """Undo bnb's 8-bit double quantization of the block scales: fp32
    ``nested_quant_map[code] * nested_absmax[i // nested_blocksize]``, then
    ``+ nested_offset`` (two roundings, in that order). A plain fp32 absmax
    comes back as it is."""
    if absmax.dtype != torch.uint8:
        return absmax.to(torch.float32)
    codes = nested_quant_map.to(torch.float32)[absmax.long()]
    n = absmax.shape[0]
    scales = nested_absmax.to(torch.float32).repeat_interleave(
        nested_blocksize)[:n]
    return codes * scales + torch.tensor(nested_offset, dtype=torch.float32,
                                         device=codes.device)


def repack_interleaved_to_split_half(packed: torch.Tensor,
                                     shape) -> torch.Tensor:
    """bnb's interleaved nibbles -> the split-half [out, in/2] layout: the
    high nibble of byte [o, j] is element [o, j], the low nibble element
    [o, j + in/2]."""
    out_f, in_f = shape
    flat = packed.reshape(-1).to(torch.uint8)
    idx = torch.stack([flat >> 4, flat & 0xF], dim=-1).reshape(out_f, in_f)
    half = in_f // 2
    return (idx[:, :half] << 4) | idx[:, half:]


def bnb_to_nf4(weight: torch.Tensor, quant_state: Dict[str, Any],
               absmax: torch.Tensor,
               quant_map: Optional[torch.Tensor] = None,
               nested_absmax: Optional[torch.Tensor] = None,
               nested_quant_map: Optional[torch.Tensor] = None,
               dtype: Optional[torch.dtype] = None) -> NF4Tensor:
    """An NF4Tensor from the raw bnb-serialized tensors, on their device."""
    qt = quant_state.get("quant_type", "nf4")
    if qt != "nf4":
        raise NotImplementedError(
            f"bnb quant_type {qt!r} is not supported (nf4 only); fp4 "
            f"checkpoints should be re-quantized")
    if quant_map is not None and not torch.allclose(
            quant_map.to(torch.float32).cpu(), NF4_CODE, atol=1e-6):
        raise ValueError("checkpoint quant_map is not the NF4 codebook")
    shape = tuple(int(s) for s in quant_state["shape"])
    blocksize = int(quant_state.get("blocksize", 64))
    if shape[1] % blocksize != 0:
        raise ValueError(
            f"in_features {shape[1]} not divisible by blocksize "
            f"{blocksize}: blocks would span rows")
    absmax_f = decode_absmax(
        absmax, nested_absmax, nested_quant_map,
        int(quant_state.get("nested_blocksize", 256)),
        float(quant_state.get("nested_offset", 0.0)))
    if dtype is None:
        dtype = _DTYPES.get(str(quant_state.get("dtype", "bfloat16")),
                            torch.bfloat16)
    return NF4Tensor(
        packed=repack_interleaved_to_split_half(weight, shape),
        absmax=absmax_f, absmax_scale=None, absmax_offset=None, shape=shape,
        block_size=blocksize, dtype=dtype)


def load_bnb_tensor(reader, name: str, dtype: Optional[torch.dtype] = None,
                    device="cpu") -> NF4Tensor:
    """Read ``name`` and its bnb companion tensors from a checkpoint and
    decode them on ``device``."""
    state = None
    for s in QUANT_STATE_SUFFIXES:
        if name + s in reader:
            state = parse_quant_state(reader.get(name + s))
            break
    if state is None:
        raise ValueError(f"{name}: no bnb quant_state companion tensor")

    def opt(suffix):
        return (reader.get(name + suffix).to(device)
                if name + suffix in reader else None)

    return bnb_to_nf4(reader.get(name).to(device), state,
                      absmax=reader.get(name + ".absmax").to(device),
                      quant_map=opt(".quant_map"),
                      nested_absmax=opt(".nested_absmax"),
                      nested_quant_map=opt(".nested_quant_map"), dtype=dtype)
