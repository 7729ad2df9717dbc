"""HF checkpoint name mapping: safetensors tensor names <-> the param tree.

Counterpart of unsloth_tpu/models/hf_names.py for the llama-family
decoder, dense or with softmax-top-k MoE layers (gpt-oss, qwen3-moe,
mixtral); other families raise through ``decoder.check_supported``. All
weights keep the HF [out, in] orientation; nothing is transposed. Expert
weights are not in the per-layer map: ``hf_loader`` reads each layout
(:func:`expert_name`, :func:`mixtral_expert_name`, gpt-oss's stacked
tensors) and writes every family's experts under :func:`expert_name`, as
the JAX package does.
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

# MoE router (qwen3-moe / qwen2-moe style; mixtral's block_sparse_moe.gate
# is found by the loader)
_MOE_ROUTER = "mlp.gate.weight"
_MOE_ROUTER_BIAS = "mlp.gate.bias"

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
    out = {ours: prefix + hf for ours, hf in m.items()}
    if cfg.attn_sinks:
        out["sinks"] = prefix + "self_attn.sinks"
    if cfg.layer_is_moe(layer_idx):
        if cfg.model_type == "gpt_oss":
            out["router"] = prefix + "mlp.router.weight"
            out["router_bias"] = prefix + "mlp.router.bias"
        else:
            out["router"] = prefix + _MOE_ROUTER
            out["router_bias"] = prefix + _MOE_ROUTER_BIAS
        for name in ("gate", "up", "down", "gate_bias", "up_bias",
                     "down_bias"):
            out.pop(name, None)
    return out


def expert_name(layer_idx: int, expert_idx: int, proj: str) -> str:
    """HF name of one expert projection, qwen3-moe layout:
    mlp.experts.{e}.{gate,up,down}_proj.weight."""
    return (f"model.layers.{layer_idx}.mlp.experts.{expert_idx}."
            f"{proj}_proj.weight")


_MIXTRAL_PROJ = {"gate": "w1", "up": "w3", "down": "w2"}


def mixtral_expert_name(layer_idx: int, expert_idx: int, proj: str) -> str:
    """HF name of one expert projection, mixtral layout:
    block_sparse_moe.experts.{e}.{w1,w3,w2}.weight."""
    return (f"model.layers.{layer_idx}.block_sparse_moe.experts."
            f"{expert_idx}.{_MIXTRAL_PROJ[proj]}.weight")


def top_level_map(cfg: ModelConfig) -> Dict[str, str]:
    check_supported(cfg)
    m = dict(_TOP_MAP)
    if cfg.tie_word_embeddings:
        m.pop("lm_head")
    return m
