"""Rotary position embeddings (rotate-half), in PyTorch.

Counterpart of unsloth_tpu/ops/rope.py, with its layout: q, k are
[B, T, H, Dh], positions [B, T], cos/sin tables fp32 [B, T, rotary_dim/2].
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..models.config import RopeScaling


def rope_inv_freq(head_dim: int, theta: float,
                  scaling: Optional[RopeScaling] = None,
                  rotary_dim: Optional[int] = None) -> torch.Tensor:
    """Inverse frequencies fp32 [rotary_dim/2] with the rope_type's
    frequency correction (default/dynamic, linear, llama3, yarn, longrope)."""
    rotary_dim = rotary_dim or head_dim
    exponent = torch.arange(0, rotary_dim, 2, dtype=torch.float32) / rotary_dim
    inv_freq = 1.0 / (theta ** exponent)
    if scaling is None or scaling.rope_type in ("default", "dynamic"):
        return inv_freq

    if scaling.rope_type == "linear":
        return inv_freq / scaling.factor

    if scaling.rope_type == "llama3":
        orig = scaling.original_max_position_embeddings
        low_wavelen = orig / scaling.low_freq_factor
        high_wavelen = orig / scaling.high_freq_factor
        wavelen = 2.0 * math.pi / inv_freq
        scaled = inv_freq / scaling.factor
        smooth = (orig / wavelen - scaling.low_freq_factor) / (
            scaling.high_freq_factor - scaling.low_freq_factor)
        smooth = torch.clamp(smooth, 0.0, 1.0)
        mid = (1.0 - smooth) * scaled + smooth * inv_freq
        out = torch.where(wavelen > low_wavelen, scaled, inv_freq)
        return torch.where((wavelen <= low_wavelen) & (wavelen >= high_wavelen),
                           mid, out)

    if scaling.rope_type == "yarn":
        dim = rotary_dim
        orig = scaling.original_max_position_embeddings

        def find_dim(num_rot):
            return (dim * math.log(orig / (num_rot * 2 * math.pi))) / (
                2 * math.log(theta))

        low = max(math.floor(find_dim(scaling.beta_fast)), 0)
        high = min(math.ceil(find_dim(scaling.beta_slow)), dim - 1)
        rng = torch.arange(dim // 2, dtype=torch.float32)
        ramp = torch.clamp((rng - low) / max(high - low, 1e-3), 0.0, 1.0)
        return inv_freq / scaling.factor * ramp + inv_freq * (1.0 - ramp)

    if scaling.rope_type == "longrope":
        factors = scaling.long_factor or scaling.short_factor
        if factors is not None:
            return inv_freq / torch.tensor(factors, dtype=torch.float32)
        return inv_freq

    return inv_freq


def yarn_attention_factor(scaling: RopeScaling) -> float:
    if scaling.rope_type != "yarn":
        return 1.0
    if scaling.attention_factor is not None:
        return float(scaling.attention_factor)
    return float(0.1 * math.log(scaling.factor) + 1.0)


def rope_table(positions: torch.Tensor, inv_freq: torch.Tensor,
               attn_factor: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin fp32 [..., rotary_dim/2] for ``positions`` [...]."""
    freqs = positions.to(torch.float32)[..., None] * inv_freq.to(positions.device)
    return torch.cos(freqs) * attn_factor, torch.sin(freqs) * attn_factor


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE on x [B, T, H, Dh] with cos/sin [B, T, rot/2]; the
    head-dim tail past the rotary dims passes through unrotated."""
    rot = cos.shape[-1] * 2
    x1, x2 = x[..., :rot].to(torch.float32).chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
    if rot == x.shape[-1]:
        return out
    return torch.cat([out, x[..., rot:]], dim=-1)


def apply_rope_qk(q, k, cos, sin):
    """RoPE on q and k with one table."""
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)
