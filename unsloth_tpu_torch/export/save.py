"""Save and merge, in PyTorch.

Counterpart of unsloth_tpu/export/save.py: :func:`merged_params` (every
adapted projection merged in fp32 and cast to bf16, every other NF4 weight,
stacked NF4 experts included, dequantized), :func:`save_pretrained_merged`
(an HF-layout bf16 checkpoint, MoE experts written one tensor per expert
as the JAX package writes them; ``save_method="lora"`` writes the adapter
instead), and the peft adapter
format: :func:`save_lora` writes ``adapter_model.safetensors`` (fp32
lora_A / lora_B under peft's names) and ``adapter_config.json``,
:func:`load_lora_tree` / :func:`load_lora` read them back. Files go through
the package's own safetensors reader and writer, so the JAX package and
peft read what this writes and the other way round.

Not ported: pushes to the Hugging Face Hub (there is no network) and GGUF
export; they raise ``NotImplementedError``. A merged save over an FP8 base
raises it too, before any file is written: the JAX package's merge has no
FP8 branch (``merge_lora`` and the bf16 cast both fail on an
``FP8Tensor``); its adapter saves as usual.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import torch

from ..io_safetensors import SafetensorsFile, save_file
from ..models.hf_loader import save_params
from ..ops.fp8 import FP8Tensor
from ..ops.lora import LoRAWeights, merge_lora
from ..ops.nf4 import (NF4Stacked, NF4Tensor, dequantize_nf4,
                       dequantize_nf4_stacked)

_TOKENIZER_FILES = (
    "tokenizer.json", "tokenizer_config.json", "special_tokens_map.json",
    "tokenizer.model", "vocab.json", "merges.txt", "added_tokens.json",
    "generation_config.json", "chat_template.jinja",
)

_PEFT_MODULE_NAMES = {
    "q": "self_attn.q_proj", "k": "self_attn.k_proj",
    "v": "self_attn.v_proj", "o": "self_attn.o_proj",
    "gate": "mlp.gate_proj", "up": "mlp.up_proj", "down": "mlp.down_proj",
}


def _copy_assets(src: Optional[str], dst: str) -> None:
    """Carry the tokenizer and generation files of the source checkpoint."""
    if not src or not os.path.isdir(src):
        return
    for fname in _TOKENIZER_FILES:
        p = os.path.join(src, fname)
        if os.path.exists(p):
            shutil.copy(p, os.path.join(dst, fname))


def merged_params(model) -> Dict[str, Any]:
    """The param tree with each adapter merged into its projection (fp32,
    then bf16) and every other NF4 weight dequantized to bf16: stacked NF4
    experts too; dense expert stacks and their biases as they are."""
    lora_layers = (model.lora or {}).get("layers")
    out = {k: v for k, v in model.params.items() if k != "layers"}
    out["layers"] = []
    for i, layer in enumerate(model.params["layers"]):
        lora_p = lora_layers[i] if lora_layers else {}
        new_layer = {}
        for name, w in layer.items():
            lw = lora_p.get(name)
            if lw is not None:
                new_layer[name] = merge_lora(w, lw, dtype=torch.bfloat16)
            elif isinstance(w, NF4Tensor):
                new_layer[name] = dequantize_nf4(w, torch.bfloat16)
            elif name == "experts" and isinstance(w, dict):
                new_layer[name] = {
                    k: dequantize_nf4_stacked(v, torch.bfloat16)
                    if isinstance(v, NF4Stacked) else v
                    for k, v in w.items()}
            else:
                new_layer[name] = w
        out["layers"].append(new_layer)
    return out


def save_pretrained_merged(model, path: str, tokenizer=None,
                           save_method: str = "merged_16bit",
                           max_shard_bytes: int = 4 * 1024**3) -> str:
    """Merged bf16 HF checkpoint in ``path``: the tensors of
    :func:`merged_params`, each merged or dequantized when its turn to be
    written comes (the JAX package writes the same bf16 checkpoint for its
    "merged_4bit" methods)."""
    if save_method == "lora":
        return save_lora(model, path)
    if save_method not in ("merged_16bit", "merged_4bit",
                           "merged_4bit_forced"):
        raise ValueError(f"Unknown save_method: {save_method!r}")
    if any(isinstance(w, FP8Tensor) for layer in model.params["layers"]
           for w in layer.values()):
        raise NotImplementedError(
            "save_pretrained_merged: no merged save over an FP8 base; the "
            "JAX package cannot merge one either (merge_lora has no FP8 "
            "branch). Save the adapter with save_lora")
    os.makedirs(path, exist_ok=True)
    # merged projection by projection as each is written, not as a tree
    save_params(model.params, model.cfg, path, dtype=torch.bfloat16,
                max_shard_bytes=max_shard_bytes, hf_config=model.hf_config,
                lora=model.lora)
    _copy_assets(model.model_path, path)
    if tokenizer is not None and hasattr(tokenizer, "save_pretrained"):
        tokenizer.save_pretrained(path)
    return path


def save_lora(model, path: str) -> str:
    """Write a peft adapter: adapter_model.safetensors (fp32) and
    adapter_config.json."""
    os.makedirs(path, exist_ok=True)
    lora_layers = (model.lora or {}).get("layers", [])
    tensors = {}
    for i, layer in enumerate(lora_layers):
        for name, lw in layer.items():
            if not isinstance(lw, LoRAWeights):
                raise NotImplementedError(
                    f"save_lora: adapter type {type(lw).__name__} (DoRA) is "
                    "not ported yet")
            base = (f"base_model.model.model.layers.{i}."
                    f"{_PEFT_MODULE_NAMES[name]}")
            tensors[f"{base}.lora_A.weight"] = lw.a.detach().to(torch.float32)
            tensors[f"{base}.lora_B.weight"] = lw.b.detach().to(torch.float32)
    save_file(tensors, os.path.join(path, "adapter_model.safetensors"))

    lc = model.lora_config or {}
    target_modules = sorted({_PEFT_MODULE_NAMES[n].split(".")[-1]
                             for layer in lora_layers for n in layer})
    adapter_config = {
        "peft_type": "LORA",
        "base_model_name_or_path": model.cfg.name or model.model_path,
        "r": lc.get("r", 16),
        "lora_alpha": lc.get("lora_alpha", 16),
        "lora_dropout": lc.get("lora_dropout", 0.0),
        "bias": lc.get("bias", "none"),
        "use_rslora": lc.get("use_rslora", False),
        "use_dora": lc.get("use_dora", False),
        "target_modules": target_modules,
        "task_type": "CAUSAL_LM",
        "fan_in_fan_out": False,
        "inference_mode": False,
    }
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump(adapter_config, f, indent=2)
    return path


def load_lora_tree(path: str, num_layers: int, device="cuda"):
    """(LoRA tree on ``device``, adapter config) from a peft adapter
    directory, without touching a model."""
    with open(os.path.join(path, "adapter_config.json")) as f:
        lc = json.load(f)
    if lc.get("use_dora"):
        raise NotImplementedError("load_lora_tree: DoRA adapters are not "
                                  "ported yet")
    scale = (lc["lora_alpha"] / (lc["r"] ** 0.5) if lc.get("use_rslora")
             else lc["lora_alpha"] / lc["r"])
    inv = {v.split(".")[-1]: k for k, v in _PEFT_MODULE_NAMES.items()}
    layers = [dict() for _ in range(num_layers)]
    f = SafetensorsFile(os.path.join(path, "adapter_model.safetensors"))
    for name in f.keys():
        if not name.endswith(".lora_A.weight"):
            continue
        stem = name[: -len(".lora_A.weight")]
        parts = stem.split(".")
        layer_idx = int(parts[parts.index("layers") + 1])
        layers[layer_idx][inv[parts[-1]]] = LoRAWeights(
            a=f.get(name).to(device),
            b=f.get(stem + ".lora_B.weight").to(device), scale=scale)
    return {"layers": layers}, lc


def load_lora(model, path: str):
    """Load a peft adapter into the model's LoRA tree, on its device."""
    model.lora, model.lora_config = load_lora_tree(
        path, model.cfg.num_layers, device=model.device)
    return model


def _no_hub(*args, **kwargs):
    raise NotImplementedError(
        "pushes to the Hugging Face Hub and GGUF export are not ported; "
        "save locally with save_pretrained_merged or save_lora")


push_to_hub_merged = push_to_hub_lora = push_to_hub_gguf = _no_hub
