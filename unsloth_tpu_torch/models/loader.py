"""FastLanguageModel — the user-facing facade, in PyTorch.

Counterpart of unsloth_tpu/models/loader.py: the same method names and the
load -> get_peft_model -> generate flow, returning (model, tokenizer). The
model is a handle over functional state (config + frozen param tree +
LoRA tree) on one explicit ``device``; ``load_in_4bit`` quantizes to NF4 on
that device as the checkpoint is read. A pre-quantized bitsandbytes 4-bit
directory (the ``unsloth/*-bnb-4bit`` repos the notebooks load) gives its
NF4 projections as they are stored, decoded on the device, without
quantizing anything (``models/bnb.py``).

``get_peft_model(use_gradient_checkpointing=...)`` sets ``gc_mode``, the
``remat`` that training passes to ``decoder.forward`` (JAX mapping:
"unsloth" -> "offload", True/"layer" -> True, False -> False).

``save_pretrained_merged``, ``save_lora`` and ``load_lora`` go through
``export/save.py``. Not ported yet: vision/audio checkpoints and DoRA
(both raise ``NotImplementedError``), GGUF files and export, Hub pushes,
8-bit loading, QAT, LoftQ, ``modules_to_save`` and the decode-time dequant
cache.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from . import hf_loader
from .config import ModelConfig, load_hf_config
from .params import DEFAULT_TARGET_MODULES, init_lora_tree

_DTYPES = {None: torch.bfloat16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float16": torch.float16}
_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                    "tokenizer.model")


@dataclasses.dataclass
class LanguageModel:
    """Functional model handle (what ``from_pretrained`` returns)."""

    cfg: ModelConfig
    params: Dict[str, Any]                 # frozen base weights
    lora: Optional[Dict[str, Any]] = None  # LoRA tree
    max_seq_length: int = 2048
    tokenizer: Any = None
    model_path: Optional[str] = None
    hf_config: Optional[Dict[str, Any]] = None
    lora_config: Optional[Dict[str, Any]] = None
    gc_mode: Any = True
    _mode: str = "training"

    @property
    def config(self) -> ModelConfig:
        return self.cfg

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def for_inference(self) -> "LanguageModel":
        """Switch to decode mode."""
        self._mode = "inference"
        return self

    def for_training(self) -> "LanguageModel":
        self._mode = "training"
        return self

    def get_peft_model(self, **kwargs) -> "LanguageModel":
        return FastLanguageModel.get_peft_model(self, **kwargs)

    def generate(self, *args, **kw):
        from ..inference.generate import generate

        return generate(self, *args, **kw)

    # -- persistence ----------------------------------------------------
    def save_pretrained_merged(self, path: str, tokenizer=None,
                               save_method: str = "merged_16bit", **kw):
        from ..export.save import save_pretrained_merged

        return save_pretrained_merged(self, path, tokenizer=tokenizer,
                                      save_method=save_method, **kw)

    def save_lora(self, path: str):
        from ..export.save import save_lora

        return save_lora(self, path)

    def load_lora(self, path: str):
        """Load a peft adapter into the LoRA tree."""
        from ..export.save import load_lora

        return load_lora(self, path)


class FastLanguageModel:
    """Reference-compatible entry point."""

    @staticmethod
    def from_pretrained(model_name: str, max_seq_length: int = 2048,
                        dtype: Optional[Any] = None, load_in_4bit: bool = True,
                        full_finetuning: bool = False, *,
                        device="cuda") -> Tuple[LanguageModel, Any]:
        """Load a model and tokenizer from a local HF checkpoint directory
        onto ``device``. The projections of a bnb-4bit directory arrive as
        NF4 weights without quantize_nf4, whatever ``load_in_4bit`` says,
        as in the JAX package."""
        path = _resolve_model_path(model_name)
        hf_config = load_hf_config(path)
        if "vision_config" in hf_config or hf_config.get("model_type") in (
                "whisper", "csm"):
            raise NotImplementedError(
                f"{hf_config.get('model_type')!r} checkpoints (vision/audio)"
                " are not ported yet")
        cfg = ModelConfig.from_hf_config(hf_config, name=model_name)
        if not isinstance(dtype, torch.dtype):
            dtype = _DTYPES[dtype]
        if full_finetuning:
            load_in_4bit = False
        params = hf_loader.load_params(path, cfg, dtype=dtype,
                                       load_in_4bit=load_in_4bit,
                                       device=device)
        tokenizer = load_tokenizer(path)
        model = LanguageModel(cfg=cfg, params=params,
                              max_seq_length=max_seq_length,
                              tokenizer=tokenizer, model_path=path,
                              hf_config=hf_config)
        return model, tokenizer

    @staticmethod
    def get_peft_model(model: LanguageModel, r: int = 16,
                       target_modules: Sequence[str] = DEFAULT_TARGET_MODULES,
                       lora_alpha: float = 16.0, lora_dropout: float = 0.0,
                       bias: str = "none",
                       use_gradient_checkpointing: Any = "unsloth",
                       random_state: int = 3407, use_rslora: bool = False,
                       use_dora: bool = False) -> LanguageModel:
        """Attach a LoRA tree (Kaiming-uniform A, zero B) on the model's
        device. Dropout and bias are recorded but, as on the fast path of
        the reference, not applied."""
        if use_dora:
            raise NotImplementedError("get_peft_model(use_dora=True) is not "
                                      "ported yet")
        model.gc_mode = {"unsloth": "offload", True: True, False: False,
                         "layer": True, "offload": "offload"}.get(
            use_gradient_checkpointing, True)
        gen = torch.Generator(device=model.device).manual_seed(random_state)
        model.lora = init_lora_tree(model.cfg, gen, r=r, alpha=lora_alpha,
                                    target_modules=target_modules,
                                    use_rslora=use_rslora)
        model.lora_config = {
            "r": r, "lora_alpha": lora_alpha,
            "target_modules": list(target_modules),
            "lora_dropout": lora_dropout, "bias": bias,
            "use_rslora": use_rslora, "modules_to_save": [],
            "init_lora_weights": True, "use_dora": False,
        }
        return model

    for_inference = staticmethod(lambda model: model.for_inference())
    for_training = staticmethod(lambda model: model.for_training())


FastModel = FastLanguageModel


def _resolve_model_path(model_name: str) -> str:
    if not os.path.isdir(model_name):
        raise FileNotFoundError(
            f"Model {model_name!r} is not a local checkpoint directory; there "
            "is no network access, so pass the path of a downloaded one.")
    return model_name


def load_tokenizer(path: str):
    """The checkpoint's tokenizer through ``transformers``; None when
    ``transformers`` is not installed or the directory holds no tokenizer
    file."""
    if not any(os.path.exists(os.path.join(path, f)) for f in _TOKENIZER_FILES):
        return None
    try:
        from transformers import AutoTokenizer
    except ImportError:
        return None
    return AutoTokenizer.from_pretrained(path, local_files_only=True)
