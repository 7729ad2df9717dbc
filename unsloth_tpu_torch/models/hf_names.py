"""HF checkpoint name mapping: safetensors tensor names <-> the param tree.

Counterpart of unsloth_tpu/models/hf_names.py for the llama-family dense
decoder (other families raise through ``decoder.check_supported``). All
weights keep the HF [out, in] orientation; nothing is transposed.
"""

from __future__ import annotations

from typing import Dict

from .config import ModelConfig
from .decoder import check_supported

# our layer-local name -> HF suffix (relative to model.layers.{i}.)
_LAYER_MAP = {
    "q": "self_attn.q_proj.weight",
    "k": "self_attn.k_proj.weight",
    "v": "self_attn.v_proj.weight",
    "o": "self_attn.o_proj.weight",
    "q_bias": "self_attn.q_proj.bias",
    "k_bias": "self_attn.k_proj.bias",
    "v_bias": "self_attn.v_proj.bias",
    "o_bias": "self_attn.o_proj.bias",
    "q_norm": "self_attn.q_norm.weight",
    "k_norm": "self_attn.k_norm.weight",
    "gate": "mlp.gate_proj.weight",
    "up": "mlp.up_proj.weight",
    "down": "mlp.down_proj.weight",
    "gate_bias": "mlp.gate_proj.bias",
    "up_bias": "mlp.up_proj.bias",
    "down_bias": "mlp.down_proj.bias",
    "input_norm": "input_layernorm.weight",
}

# post-norm architectures (gemma2/3) name the sandwich norms differently
_POST_NORM_MAP = {
    "post_attn_out_norm": "post_attention_layernorm.weight",
    "pre_ffw_norm": "pre_feedforward_layernorm.weight",
    "post_ffw_norm": "post_feedforward_layernorm.weight",
}
_PLAIN_NORM_MAP = {
    "post_attn_norm": "post_attention_layernorm.weight",
}

_TOP_MAP = {
    "embed": "model.embed_tokens.weight",
    "final_norm": "model.norm.weight",
    "lm_head": "lm_head.weight",
}


def layer_name_map(cfg: ModelConfig, layer_idx: int) -> Dict[str, str]:
    """our name -> HF name for one decoder layer."""
    check_supported(cfg)
    m = dict(_LAYER_MAP)
    m.update(_POST_NORM_MAP if cfg.use_post_norms else _PLAIN_NORM_MAP)
    prefix = f"model.layers.{layer_idx}."
    return {ours: prefix + hf for ours, hf in m.items()}


def top_level_map(cfg: ModelConfig) -> Dict[str, str]:
    check_supported(cfg)
    m = dict(_TOP_MAP)
    if cfg.tie_word_embeddings:
        m.pop("lm_head")
    return m
