"""Tensor ops: NF4 and FP8 storage, the fused NF4 and FP8 matmul and RMSNorm
kernels, RoPE, activations and LoRA projections, attention and the
cross-entropy routes. The names are the JAX package's ``unsloth_tpu.ops``
exports (its ``attention`` and ``rms_norm`` are the functions, as there,
not the modules of the same names)."""

from .activations import (geglu_approx, geglu_exact, glu_for,  # noqa: F401
                          gpt_oss_glu, swiglu)
from .attention import (attention, attention_ref,  # noqa: F401
                        packed_segment_bound)
from .cross_entropy import (cross_entropy_per_row,  # noqa: F401
                            cross_entropy_ref, fast_cross_entropy_loss)
from .fp8 import FP8Tensor, dequantize_fp8, quantize_fp8_block  # noqa: F401
from .fp8_matmul import fp8_matmul  # noqa: F401
from .fused_ce_linear import (fused_ce_loss_mean,  # noqa: F401
                              fused_linear_cross_entropy)
from .lora import (LoRAWeights, base_matmul, init_lora,  # noqa: F401
                   lora_matmul, merge_lora)
from .nf4 import (NF4Tensor, dequantize_nf4, nf4_matmul_ref,  # noqa: F401
                  quantize_nf4)
from .packed_attention import (packed_flash_attention,  # noqa: F401
                               segment_block_metadata)
from .rms_norm import layer_norm_ref, rms_norm, rms_norm_ref  # noqa: F401
from .rope import (apply_rope, apply_rope_qk, rope_inv_freq,  # noqa: F401
                   rope_table)

__all__ = [
    "attention", "attention_ref", "packed_segment_bound",
    "packed_flash_attention", "segment_block_metadata",
    "cross_entropy_per_row", "cross_entropy_ref", "fast_cross_entropy_loss",
    "fused_ce_loss_mean", "fused_linear_cross_entropy",
    "LoRAWeights", "base_matmul", "init_lora", "lora_matmul", "merge_lora",
    "NF4Tensor", "dequantize_nf4", "nf4_matmul_ref", "quantize_nf4",
    "layer_norm_ref", "rms_norm", "rms_norm_ref",
    "apply_rope", "apply_rope_qk", "rope_inv_freq", "rope_table",
    "swiglu", "geglu_exact", "geglu_approx", "gpt_oss_glu", "glu_for",
    "FP8Tensor", "dequantize_fp8", "fp8_matmul", "quantize_fp8_block",
]
