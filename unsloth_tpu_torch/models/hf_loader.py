"""HF safetensors checkpoint -> parameter tree, in PyTorch.

Counterpart of unsloth_tpu/models/hf_loader.py (``load_params``,
``save_params``) for the llama-family dense decoder: single-file or
index-sharded checkpoints, read
one tensor at a time with the package's own safetensors reader
(``io_safetensors``), moved to the target device, cast to ``dtype`` and,
with ``load_in_4bit``, NF4-quantized there as it arrives (so the dense
bf16 copy of a projection exists only while it is being quantized).
:func:`save_params` writes a tree back with HF names, one tensor at a time
(``io_safetensors.save_sharded``).

Not ported yet: pre-quantized bitsandbytes checkpoints, fused
qkv_proj/gate_up_proj checkpoints, expert weights and
``validate_checkpoint``; each raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, Optional

import torch

from ..io_safetensors import SafetensorsFile, save_sharded
from ..ops.lora import merge_lora
from ..ops.nf4 import NF4Tensor, dequantize_nf4, quantize_nf4
from . import hf_names
from .config import ModelConfig, load_hf_config

_QUANTIZABLE = ("q", "k", "v", "o", "gate", "up", "down")
_UNPORTED_SUFFIXES = (".quant_state.bitsandbytes__nf4", ".absmax",
                      "qkv_proj.weight", "gate_up_proj.weight",
                      ".experts.0.gate_proj.weight")


class CheckpointReader:
    """Random access to tensors across safetensors shards."""

    def __init__(self, path: str):
        self.path = path
        index_file = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(index_file):
            with open(index_file) as f:
                self._name_to_file: Dict[str, str] = dict(
                    json.load(f)["weight_map"])
        else:
            single = os.path.join(path, "model.safetensors")
            if not os.path.exists(single):
                raise FileNotFoundError(
                    f"No model.safetensors(.index.json) under {path}")
            self._name_to_file = {
                n: "model.safetensors" for n in SafetensorsFile(single).keys()}
        self._files: Dict[str, SafetensorsFile] = {}

    def names(self) -> Iterable[str]:
        return self._name_to_file.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._name_to_file

    def get(self, name: str) -> torch.Tensor:
        fname = self._name_to_file[name]
        if fname not in self._files:
            self._files[fname] = SafetensorsFile(os.path.join(self.path, fname))
        return self._files[fname].get(name)


def load_params(path: str, cfg: Optional[ModelConfig] = None, *,
                dtype: torch.dtype = torch.bfloat16,
                load_in_4bit: bool = False, quant_block_size: int = 64,
                double_quant: bool = True, device="cpu") -> Dict[str, Any]:
    """Load an HF causal-LM checkpoint directory into the param tree on
    ``device``. Each tensor is cast to ``dtype`` before quantization, as in
    the JAX loader, so both packages quantize the same values."""
    if cfg is None:
        cfg = ModelConfig.from_hf_config(load_hf_config(path))
    reader = CheckpointReader(path)
    for name in reader.names():
        if name.endswith(_UNPORTED_SUFFIXES):
            raise NotImplementedError(
                f"{path}: tensor {name!r} belongs to a checkpoint layout "
                "(bnb 4-bit, fused projections or experts) not ported yet")

    def load_one(hf_name: str, quantize: bool):
        arr = reader.get(hf_name).to(device).to(dtype)
        if quantize and arr.ndim == 2:
            return quantize_nf4(arr, block_size=quant_block_size,
                                double_quant=double_quant, dtype=dtype)
        return arr

    params: Dict[str, Any] = {"layers": []}
    for ours, hf in hf_names.top_level_map(cfg).items():
        if ours == "lm_head" and hf not in reader:
            continue  # some checkpoints tie without setting the flag
        params[ours] = load_one(hf, quantize=False)
    for i in range(cfg.num_layers):
        params["layers"].append({
            ours: load_one(hf, load_in_4bit and ours in _QUANTIZABLE)
            for ours, hf in hf_names.layer_name_map(cfg, i).items()
            if hf in reader})
    return params


def save_params(params: Dict[str, Any], cfg: ModelConfig, path: str, *,
                dtype: torch.dtype = torch.bfloat16,
                max_shard_bytes: int = 4 * 1024**3,
                hf_config: Optional[Dict[str, Any]] = None,
                lora: Optional[Dict[str, Any]] = None) -> None:
    """Write the param tree as an HF-layout safetensors checkpoint: HF
    names, shards of at most ``max_shard_bytes`` with an index when there
    are several, every weight in ``dtype`` (NF4 weights dequantized), plus
    ``config.json`` when ``hf_config`` is given. With ``lora`` (a LoRA
    tree), each adapted projection is written merged with its adapter
    (:func:`merge_lora`: fp32, then ``dtype``). Each tensor is made on its
    own device when its turn comes, so one dense weight at a time is
    alive, and copied to the host."""
    os.makedirs(path, exist_ok=True)
    lora_layers = (lora or {}).get("layers") or []
    tensors = {}   # HF name -> (weight, its adapter or None)
    for ours, hf in hf_names.top_level_map(cfg).items():
        if ours in params:
            tensors[hf] = (params[ours], None)
    for i, layer in enumerate(params["layers"]):
        adapters = lora_layers[i] if lora_layers else {}
        for ours, hf in hf_names.layer_name_map(cfg, i).items():
            if ours in layer:
                tensors[hf] = (layer[ours], adapters.get(ours))

    def produce(name: str) -> torch.Tensor:
        w, adapter = tensors[name]
        if adapter is not None:
            with torch.no_grad():
                return merge_lora(w, adapter, dtype=dtype)
        if isinstance(w, NF4Tensor):
            return dequantize_nf4(w, dtype)
        return w.detach().to(dtype)

    save_sharded(path, [(name, dtype, tuple(w.shape))
                        for name, (w, _) in tensors.items()], produce,
                 max_shard_bytes=max_shard_bytes, metadata={"format": "pt"})
    if hf_config is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(hf_config, f, indent=2)
