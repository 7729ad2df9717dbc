"""HF safetensors checkpoint -> parameter tree, in PyTorch.

Counterpart of unsloth_tpu/models/hf_loader.py (``load_params``,
``save_params``) for the llama-family decoder, dense or with MoE layers:
single-file or
index-sharded checkpoints, read
one tensor at a time with the package's own safetensors reader
(``io_safetensors``), moved to the target device, cast to ``dtype`` and,
with ``load_in_4bit``, NF4-quantized there as it arrives (so the dense
bf16 copy of a projection exists only while it is being quantized).
:func:`save_params` writes a tree back with HF names, one tensor at a time
(``io_safetensors.save_sharded``).

Experts load as dense stacks in ``dtype`` (gate/up [E, F, D], down
[E, D, F]), as the JAX loader loads them, also with ``load_in_4bit``:
``params.quantize_params`` stacks them as NF4 afterwards. Layouts read:
per-expert tensors (qwen3-moe ``mlp.experts.{e}.{gate,up,down}_proj``,
mixtral ``block_sparse_moe.experts.{e}.{w1,w3,w2}`` with its router
``block_sparse_moe.gate``) and gpt-oss's stacked tensors (gate and up
interleaved on the last dim, input-major, with biases), in bf16 or, as the
published gpt-oss checkpoints ship them, MXFP4 (``*_blocks`` /
``*_scales``, dequantized on the load device by :mod:`.mxfp4`).
:func:`save_params` writes expert stacks as the JAX package does: one
tensor per expert and projection under the qwen3-moe names
(``hf_names.expert_name``) for every MoE family, and no expert biases.

Pre-quantized bitsandbytes 4-bit checkpoints (``unsloth/*-bnb-4bit``):
every tensor with bnb companion tensors loads through :mod:`.bnb` as an
NF4 weight, before any cast and whatever ``load_in_4bit`` says, as in the
JAX loader; nothing is quantized again.

Not ported yet: fused qkv_proj/gate_up_proj checkpoints of dense models,
other expert layouts and ``validate_checkpoint``; the first two raise
``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, Optional

import torch

from ..io_safetensors import SafetensorsFile, save_sharded
from ..ops.lora import merge_lora
from ..ops.nf4 import NF4Stacked, NF4Tensor, dequantize_nf4, quantize_nf4
from . import hf_names
from .bnb import is_bnb_quantized, load_bnb_tensor
from .config import ModelConfig, load_hf_config
from .mxfp4 import is_mxfp4_quantized, load_mxfp4_tensor

_QUANTIZABLE = ("q", "k", "v", "o", "gate", "up", "down")
_UNPORTED_SUFFIXES = ("qkv_proj.weight", "gate_up_proj.weight")


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
    the JAX loader, so both packages quantize the same values; a bnb 4-bit
    tensor set becomes an NF4 weight as it is stored."""
    if cfg is None:
        cfg = ModelConfig.from_hf_config(load_hf_config(path))
    reader = CheckpointReader(path)
    for name in reader.names():
        if name.endswith(_UNPORTED_SUFFIXES):
            raise NotImplementedError(
                f"{path}: tensor {name!r} belongs to a checkpoint layout "
                "(fused projections) not ported yet")

    def load_one(hf_name: str, quantize: bool):
        if is_bnb_quantized(reader, hf_name):
            return load_bnb_tensor(reader, hf_name, dtype=dtype,
                                   device=device)
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
        layer = {ours: load_one(hf, load_in_4bit and ours in _QUANTIZABLE)
                 for ours, hf in hf_names.layer_name_map(cfg, i).items()
                 if hf in reader}
        if cfg.layer_is_moe(i):
            if "router" not in layer:   # mixtral: block_sparse_moe.gate
                alt = f"model.layers.{i}.block_sparse_moe.gate.weight"
                if alt in reader:
                    layer["router"] = load_one(alt, quantize=False)
            layer["experts"] = _load_experts(reader, cfg, i, dtype, device)
        params["layers"].append(layer)
    return params


def _load_experts(reader: CheckpointReader, cfg: ModelConfig, layer_idx: int,
                  dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """The experts of one layer as dense [E, ...] stacks on ``device``:
    gate/up [E, F, D], down [E, D, F], gpt-oss's biases gate_bias/up_bias
    [E, F] and down_bias [E, D]."""
    def get(name):
        return reader.get(name).to(device).to(dtype)

    def get_stack(name):
        """A gpt-oss stacked weight in HF's bf16 layout, from its bf16
        tensor or its MXFP4 blocks and scales (dequantized in fp32 on
        ``device``, then cast)."""
        if is_mxfp4_quantized(reader, name):
            return load_mxfp4_tensor(reader, name, device).to(dtype)
        return get(name)

    p = f"model.layers.{layer_idx}.mlp.experts."
    if cfg.model_type == "gpt_oss" and (
            p + "gate_up_proj" in reader
            or is_mxfp4_quantized(reader, p + "gate_up_proj")):
        # HF GptOssExperts: gate_up_proj [E, D, 2F] used as x @ W, gate and
        # up interleaved on the last dim; down_proj [E, F, D]; biases
        # [E, 2F] (interleaved) and [E, D]
        gup = get_stack(p + "gate_up_proj")
        out = {"gate": gup[:, :, 0::2].transpose(1, 2).contiguous(),
               "up": gup[:, :, 1::2].transpose(1, 2).contiguous(),
               "down": get_stack(p + "down_proj").transpose(1, 2)
               .contiguous()}
        del gup
        if p + "gate_up_proj_bias" in reader:
            gub = get(p + "gate_up_proj_bias")
            out["gate_bias"] = gub[:, 0::2].contiguous()
            out["up_bias"] = gub[:, 1::2].contiguous()
        if p + "down_proj_bias" in reader:
            out["down_bias"] = get(p + "down_proj_bias")
        return out
    namer = hf_names.expert_name
    if hf_names.mixtral_expert_name(layer_idx, 0, "gate") in reader:
        namer = hf_names.mixtral_expert_name
    if namer(layer_idx, 0, "gate") not in reader:
        raise NotImplementedError(
            f"{reader.path}: layer {layer_idx}'s experts are in a layout "
            "not ported yet (ported: per-expert qwen3-moe/mixtral tensors "
            "and gpt-oss's stacked bf16 or MXFP4 tensors)")
    return {proj: torch.stack([get(namer(layer_idx, e, proj))
                               for e in range(cfg.num_experts)])
            for proj in ("gate", "up", "down")}


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
    alive, and copied to the host.

    Expert stacks are written as the JAX package writes them
    (unsloth_tpu/models/hf_loader.py:478-483): one [out, in] tensor per
    expert and projection under :func:`hf_names.expert_name` (the
    qwen3-moe layout) for every MoE family, and no expert biases, so a
    gpt-oss checkpoint written here loads back, in either package, without
    its expert biases."""
    os.makedirs(path, exist_ok=True)
    lora_layers = (lora or {}).get("layers") or []
    tensors = {}   # HF name -> (weight or (expert stack, e), adapter or None)
    for ours, hf in hf_names.top_level_map(cfg).items():
        if ours in params:
            tensors[hf] = (params[ours], None)
    for i, layer in enumerate(params["layers"]):
        adapters = lora_layers[i] if lora_layers else {}
        for ours, hf in hf_names.layer_name_map(cfg, i).items():
            if ours in layer:
                tensors[hf] = (layer[ours], adapters.get(ours))
        if "experts" in layer:
            for proj in ("gate", "up", "down"):
                stacked = layer["experts"][proj]
                for e in range(cfg.num_experts):
                    tensors[hf_names.expert_name(i, e, proj)] = (
                        (stacked, e), None)

    def produce(name: str) -> torch.Tensor:
        w, adapter = tensors[name]
        if adapter is not None:
            with torch.no_grad():
                return merge_lora(w, adapter, dtype=dtype)
        if isinstance(w, tuple):
            stacked, e = w
            if isinstance(stacked, NF4Stacked):
                return dequantize_nf4(_expert_nf4(stacked, e), dtype)
            return stacked[e].detach().to(dtype)
        if isinstance(w, NF4Tensor):
            return dequantize_nf4(w, dtype)
        return w.detach().to(dtype)

    def shape(w) -> tuple:
        return (tuple(w[0].shape)[1:] if isinstance(w, tuple)
                else tuple(w.shape))

    save_sharded(path, [(name, dtype, shape(w))
                        for name, (w, _) in tensors.items()], produce,
                 max_shard_bytes=max_shard_bytes, metadata={"format": "pt"})
    if hf_config is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(hf_config, f, indent=2)


def _expert_nf4(q: NF4Stacked, e: int) -> NF4Tensor:
    """Expert ``e`` of a stacked NF4 weight as a 2-D NF4 weight: the stack
    quantizes each expert's rows in row-major blocks, so its slice
    dequantizes to the stack's dequantization at ``e``."""
    return NF4Tensor(q.packed[e], q.absmax[e].reshape(-1), None, None,
                     tuple(q.shape[1:]), q.block_size, q.dtype)
