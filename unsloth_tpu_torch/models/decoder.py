"""Decoder building blocks used by KV-cache decoding, in PyTorch.

Counterpart of the parts of unsloth_tpu/models/decoder.py that
``inference/decode.py`` imports: ``_norm``, ``_proj``, ``mlp_block`` (the
dense gated MLP) and ``_rope_tables`` (1-D positions). The training
forward, the loss and the attention dispatch come with the training slice.

Parameter tree schema (the JAX package's, HF-shaped [out, in] weights):

  params = {
    "embed": [V, D],
    "layers": [{"input_norm": [D], "post_attn_norm": [D],
                "q": W|NF4, "k": ..., "v": ..., "o": ...,
                "gate": W|NF4, "up": W|NF4, "down": W|NF4, ...}, ...],
    "final_norm": [D],
    "lm_head": [V, D] (absent when tied to embed),
  }

Only the llama-family dense decoder is ported; :func:`check_supported`
raises ``NotImplementedError`` naming the first ``ModelConfig`` knob of any
other architecture.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.activations import ACT2GLU, glu_for
from ..ops.lora import lora_matmul
from ..ops.rms_norm import rms_norm
from ..ops.rope import rope_inv_freq, rope_table, yarn_attention_factor
from .config import ModelConfig

# ModelConfig knobs whose code paths are not ported yet: (field, test).
_UNPORTED = (
    ("altup", lambda c: c.altup is not None),
    ("hybrid_mamba", lambda c: c.hybrid_mamba or c.mamba is not None),
    ("mla", lambda c: c.mla is not None),
    ("lightning", lambda c: c.lightning is not None),
    ("gdn", lambda c: c.gdn is not None),
    ("zamba", lambda c: c.zamba is not None),
    ("num_experts (MoE)", lambda c: c.num_experts > 0),
    ("short_conv_l", lambda c: c.short_conv_l > 0),
    ("norm_type", lambda c: c.norm_type != "rmsnorm"),
    ("norm_bias", lambda c: c.norm_bias),
    ("mlp_gated", lambda c: not c.mlp_gated),
    ("hidden_act", lambda c: c.hidden_act not in ACT2GLU),
    ("gated_attention", lambda c: c.gated_attention),
    ("qk_norm", lambda c: c.qk_norm not in (False, True)),
    ("attn_sinks", lambda c: c.attn_sinks),
    ("rope_interleaved", lambda c: c.rope_interleaved),
    ("rope_layers", lambda c: c.rope_layers is not None),
    ("attn_temperature_tuning", lambda c: c.attn_temperature_tuning),
    ("mrope_section", lambda c: c.mrope_section is not None),
    ("parallel_residual", lambda c: c.parallel_residual),
    ("post_norm_only", lambda c: c.post_norm_only),
    ("attention_chunk_size", lambda c: c.attention_chunk_size is not None),
    ("causal", lambda c: not c.causal),
    ("layer_pattern", lambda c: any(
        k not in ("global", "sliding") for k in (c.layer_pattern or ()))),
)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError if ``cfg`` needs a path not ported yet."""
    for knob, test in _UNPORTED:
        if test(cfg):
            raise NotImplementedError(
                f"unsloth_tpu_torch: ModelConfig.{knob} "
                f"({cfg.model_type!r}) is not ported yet; only the "
                "llama-family dense decoder is")


def _norm(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(x, w, cfg.rms_norm_eps, cfg.gemma_norm)


def _proj(x: torch.Tensor, layer_p, lora_p, name: str) -> torch.Tensor:
    lora = lora_p.get(name) if lora_p else None
    return lora_matmul(x, layer_p[name], lora=lora,
                       bias=layer_p.get(f"{name}_bias"))


def mlp_block(x: torch.Tensor, layer_p, lora_p, cfg: ModelConfig,
              layer_idx: int) -> torch.Tensor:
    """Dense gated MLP: down(act(gate(x)) * up(x))."""
    glu = glu_for(cfg.hidden_act)
    e = _proj(x, layer_p, lora_p, "gate")
    g = _proj(x, layer_p, lora_p, "up")
    return _proj(glu(e, g), layer_p, lora_p, "down")


def _rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    """cos/sin fp32 [B, T, rot/2] for positions [B, T], plus the local
    (sliding-layer) tables when the config has a second rope theta."""
    rotary_dim = int(cfg.head_dim * cfg.partial_rotary_factor)
    inv = rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                        rotary_dim=rotary_dim)
    cos, sin = rope_table(positions, inv,
                          yarn_attention_factor(cfg.rope_scaling))
    cos_local: Optional[torch.Tensor] = None
    sin_local: Optional[torch.Tensor] = None
    if cfg.rope_local_theta is not None:
        inv_l = rope_inv_freq(cfg.head_dim, cfg.rope_local_theta, None,
                              rotary_dim=rotary_dim)
        cos_local, sin_local = rope_table(positions, inv_l)
    return cos, sin, cos_local, sin_local
