"""Parameter-tree construction: random init, LoRA injection, quantization.

Counterpart of unsloth_tpu/models/params.py for the llama-family
decoder, dense or with softmax-top-k MoE layers (stacked experts, NF4 as
:class:`~unsloth_tpu_torch.ops.nf4.NF4Stacked` once quantized). Random numbers come from a ``torch.Generator`` (they differ from
``jax.random``'s; tests hand both packages the same numpy arrays instead).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..ops.lora import LoRAWeights, init_lora
from ..ops.nf4 import quantize_nf4, quantize_nf4_stacked
from .config import ModelConfig
from .decoder import check_supported

DEFAULT_TARGET_MODULES = ("q", "k", "v", "o", "gate", "up", "down")

# HF peft naming <-> our short names
HF_MODULE_NAMES = {
    "q_proj": "q", "k_proj": "k", "v_proj": "v", "o_proj": "o",
    "gate_proj": "gate", "up_proj": "up", "down_proj": "down",
}

_QUANTIZABLE = frozenset(DEFAULT_TARGET_MODULES)


def normalize_target_modules(mods: Sequence[str]) -> tuple:
    return tuple(HF_MODULE_NAMES.get(m, m) for m in mods)


def _linear_dims(cfg: ModelConfig, name: str):
    d, f = cfg.hidden_size, cfg.intermediate_size
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "q": (hq * dh, d), "k": (hkv * dh, d), "v": (hkv * dh, d),
        "o": (d, hq * dh),
        "gate": (f, d), "up": (f, d), "down": (d, f),
    }[name]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, init_scale: float = 0.02,
                device=None) -> Dict[str, Any]:
    """Random-init a full parameter tree on ``device`` (default: the
    generator's device)."""
    check_supported(cfg)
    device = device if device is not None else generator.device

    def rand(shape, scale=init_scale):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    def norm_init(n=cfg.hidden_size):
        fill = torch.zeros if cfg.gemma_norm else torch.ones
        return fill((n,), dtype=dtype, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    d = cfg.hidden_size
    params: Dict[str, Any] = {
        "embed": rand((cfg.vocab_size, d)),
        "final_norm": norm_init(),
        "layers": [],
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = rand((cfg.vocab_size, d))
    for i in range(cfg.num_layers):
        layer: Dict[str, Any] = {"input_norm": norm_init(),
                                 "post_attn_norm": norm_init()}
        if cfg.use_post_norms:
            for name in ("post_attn_out_norm", "pre_ffw_norm",
                         "post_ffw_norm"):
                layer[name] = norm_init()
        for name in ("q", "k", "v", "o"):
            layer[name] = rand(_linear_dims(cfg, name))
            if cfg.attention_bias and name != "o":
                layer[f"{name}_bias"] = zeros(_linear_dims(cfg, name)[0])
        if cfg.o_proj_bias:
            layer["o_bias"] = zeros(d)
        if cfg.qk_norm:
            layer["q_norm"] = norm_init(cfg.head_dim)
            layer["k_norm"] = norm_init(cfg.head_dim)
        if cfg.attn_sinks:
            layer["sinks"] = rand((cfg.num_heads,), scale=1.0)
        if cfg.layer_is_moe(i):
            e = cfg.num_experts
            f = cfg.moe_intermediate_size or cfg.intermediate_size
            layer["router"] = rand((e, d))
            if cfg.router_bias:
                layer["router_bias"] = zeros(e)
            layer["experts"] = {"gate": rand((e, f, d)),
                                "up": rand((e, f, d)),
                                "down": rand((e, d, f))}
            if cfg.moe_mlp_bias:
                layer["experts"].update(
                    gate_bias=torch.zeros((e, f), dtype=dtype, device=device),
                    up_bias=torch.zeros((e, f), dtype=dtype, device=device),
                    down_bias=torch.zeros((e, d), dtype=dtype,
                                          device=device))
        else:
            for name in ("gate", "up", "down"):
                layer[name] = rand(_linear_dims(cfg, name))
                if cfg.mlp_bias:
                    layer[f"{name}_bias"] = zeros(_linear_dims(cfg, name)[0])
        params["layers"].append(layer)
    return params


def quantize_params(params: Dict[str, Any], cfg: ModelConfig,
                    block_size: int = 64, double_quant: bool = True,
                    dtype: torch.dtype = torch.bfloat16,
                    skip: Sequence[str] = ()) -> Dict[str, Any]:
    """Quantize the q/k/v/o/gate/up/down weights to NF4 (the QLoRA base),
    each on its own device, and stacked experts to NF4Stacked (fp32
    absmax, ``block_size``, or 32 where in/2 is not a multiple of it: the
    grouped kernels need blocks aligned to the split-half boundary, and
    gpt-oss's in = 2,880 has in/2 = 1,440 = 45 x 32). Weights already in
    NF4 stay as they are. Norms, biases, routers, sinks, embed and
    lm_head stay dense."""

    def expert_block(in_f: int) -> int:
        for b in (block_size, 32):
            if in_f % b == 0 and (in_f // 2) % b == 0:
                return b
        return 0

    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = []
    for layer in params["layers"]:
        new_layer = {}
        for name, w in layer.items():
            if (name in _QUANTIZABLE and name not in skip
                    and isinstance(w, torch.Tensor) and w.ndim == 2):
                w = quantize_nf4(w, block_size=block_size,
                                 double_quant=double_quant, dtype=dtype)
            elif name == "experts" and name not in skip:
                w = {en: quantize_nf4_stacked(ew, expert_block(ew.shape[-1]),
                                              dtype=dtype)
                     if isinstance(ew, torch.Tensor) and ew.ndim == 3
                     and expert_block(ew.shape[-1]) else ew
                     for en, ew in w.items()}
            new_layer[name] = w
        out["layers"].append(new_layer)
    return out


def init_lora_tree(cfg: ModelConfig, generator: torch.Generator, r: int = 16,
                   alpha: float = 16.0,
                   target_modules: Sequence[str] = DEFAULT_TARGET_MODULES,
                   dtype: torch.dtype = torch.float32,
                   use_rslora: bool = False,
                   device=None) -> Dict[str, Any]:
    """The LoRA tree matching the params schema: {"layers": [{name:
    LoRAWeights}]} with Kaiming-uniform A and zero B. MoE layers get no
    gate/up/down adapters (expert LoRA is not in the JAX package either)."""
    check_supported(cfg)
    targets = set(normalize_target_modules(target_modules))
    layers: List[Dict[str, Optional[LoRAWeights]]] = []
    for i in range(cfg.num_layers):
        layer = {}
        for name in DEFAULT_TARGET_MODULES:
            if name in ("gate", "up", "down") and cfg.layer_is_moe(i):
                continue
            if name in targets:
                out_f, in_f = _linear_dims(cfg, name)
                layer[name] = init_lora(generator, in_f, out_f, r, alpha,
                                        dtype, use_rslora, device=device)
        layers.append(layer)
    return {"layers": layers}


def count_params(tree: Any) -> int:
    """Elements of every tensor in a param or LoRA tree: NF4 and FP8
    weights count their codes and scales, LoRA weights A and B, as the
    JAX package's count_params sums its pytree's leaves."""
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return 0


def tree_to(tree: Any, device) -> Any:
    """Move every tensor of a param or LoRA tree to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    if tree is None:
        return None
    return tree.to(device)
