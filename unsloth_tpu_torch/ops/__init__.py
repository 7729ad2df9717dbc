"""Tensor ops: NF4 storage, the fused NF4 matmul and RMSNorm kernels,
RoPE, activations and LoRA projections."""
