"""Tensor ops: NF4 and FP8 storage, the fused NF4 and FP8 matmul and RMSNorm
kernels, RoPE, activations and LoRA projections."""

from .fp8 import FP8Tensor, dequantize_fp8, quantize_fp8_block  # noqa: F401
from .fp8_matmul import fp8_matmul  # noqa: F401
