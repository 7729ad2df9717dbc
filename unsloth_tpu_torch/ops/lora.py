"""LoRA linear ops over dense or NF4-quantized base weights, in PyTorch.

Counterpart of unsloth_tpu/ops/lora.py. Conventions (HF/peft): W [out, in];
lora_A [r, in]; lora_B [out, r]; scale = lora_alpha / r (rslora:
lora_alpha / sqrt(r)). An NF4 base goes through the fused kernel
(``qlora_matmul.nf4_matmul``) on every row count; a dense base is one
``torch.matmul``. The LoRA epilogue is two plain matmuls, as in JAX.
:func:`merge_lora` folds an adapter into its base weight for a merged
save. DoRA waits for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from .nf4 import NF4Tensor, dequantize_nf4
from .qlora_matmul import nf4_matmul


@dataclasses.dataclass
class LoRAWeights:
    a: torch.Tensor  # [r, in]
    b: torch.Tensor  # [out, r]
    scale: float

    def to(self, device) -> "LoRAWeights":
        return dataclasses.replace(self, a=self.a.to(device),
                                   b=self.b.to(device))


BaseWeight = Union[torch.Tensor, NF4Tensor]


def base_matmul(x: torch.Tensor, w: BaseWeight) -> torch.Tensor:
    """x @ W.T for a dense or NF4 base weight; output in x.dtype."""
    if isinstance(w, NF4Tensor):
        return nf4_matmul(x, w)
    return torch.matmul(x, w.to(x.dtype).t())


def lora_matmul(x: torch.Tensor, w: BaseWeight,
                lora: Optional[LoRAWeights] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ W.T (+ bias) (+ scale * (x @ A.T) @ B.T)."""
    if lora is not None and not isinstance(lora, LoRAWeights):
        raise NotImplementedError(
            f"lora_matmul: adapter type {type(lora).__name__} (DoRA) is not "
            "ported yet")
    y = base_matmul(x, w)
    if bias is not None:
        y = y + bias.to(y.dtype)
    if lora is not None:
        xa = torch.matmul(x, lora.a.to(x.dtype).t())
        y = y + lora.scale * torch.matmul(xa, lora.b.to(x.dtype).t())
    return y


def init_lora(generator: torch.Generator, in_features: int,
              out_features: int, r: int, alpha: float,
              dtype: torch.dtype = torch.float32, use_rslora: bool = False,
              device=None) -> LoRAWeights:
    """Kaiming-uniform A, zero B (peft init convention)."""
    device = device if device is not None else generator.device
    bound = (1.0 / in_features) ** 0.5 * (3.0 ** 0.5)
    a = torch.rand((r, in_features), generator=generator, device=device,
                   dtype=torch.float32) * (2 * bound) - bound
    b = torch.zeros((out_features, r), dtype=dtype, device=device)
    scale = alpha / (r ** 0.5) if use_rslora else alpha / r
    return LoRAWeights(a=a.to(dtype), b=b, scale=scale)


def merge_lora(w: BaseWeight, lora: LoRAWeights,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """W' = W + scale * B @ A, dequantizing an NF4 base first, all in fp32,
    then cast to ``dtype`` (JAX ``merge_lora``)."""
    if not isinstance(lora, LoRAWeights):
        raise NotImplementedError(
            f"merge_lora: adapter type {type(lora).__name__} (DoRA) is not "
            "ported yet")
    wd = dequantize_nf4(w, torch.float32) if isinstance(w, NF4Tensor) \
        else w.to(torch.float32)
    delta = torch.matmul(lora.b.to(torch.float32), lora.a.to(torch.float32))
    return (wd + lora.scale * delta.to(wd.device)).to(dtype)
