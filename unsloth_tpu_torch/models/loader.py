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

``get_peft_model(modules_to_save=["embed_tokens", "lm_head"])`` adds fp32
trainable copies of the embedding and the head to the LoRA tree, as JAX
does (a tied head's copy comes from the embedding, which unties it); the
decoder reads them in place of the frozen ones. Without
``get_peft_model``, ``from_pretrained(full_finetuning=True)`` loads dense
weights that the SFT trainer trains in full.

A name that is not a local directory resolves as in JAX: the mapper
(``models/mapper.py``) turns ``unsloth/...-bnb-4bit`` mirrors into the
float repo with ``load_in_4bit=True``, then the HF cache
(``$HF_HOME/hub/models--org--name/snapshots/<last>``) is searched; there is
no download.

``save_pretrained_merged``, ``save_lora`` and ``load_lora`` go through
``export/save.py``. A Whisper checkpoint loads into the functional
``(params, cfg)`` handle of ``models/whisper.py``. The keyword arguments
that JAX takes and ignores (``token``, ``trust_remote_code``,
``load_in_8bit``, ``fast_inference``, and others such as
``max_lora_rank`` or ``gpu_memory_utilization``) are taken and ignored.
Not ported yet, and raising ``NotImplementedError`` naming the option:
vision and CSM checkpoints, DoRA, LoftQ, QAT (``qat_scheme``), the
stacked-layers layout (``stack_layers``, a TPU compile-time layout),
meshes and sharding rules; nor GGUF files and export, Hub pushes and the
decode-time dequant cache.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from . import hf_loader
from .config import ModelConfig, load_hf_config
from .decoder import forward, logits_fn, loss_fn
from .mapper import get_model_name
from .params import DEFAULT_TARGET_MODULES, init_lora_tree

_DTYPES = {None: torch.bfloat16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float16": torch.float16}
_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                    "tokenizer.model")
#: modules_to_save names -> the param tree's keys (JAX's table)
_MODULES_TO_SAVE = {"embed_tokens": "embed", "embed": "embed",
                    "lm_head": "lm_head"}
#: why each refused option is not ported
_UNPORTED_OPTIONS = {
    "qat_scheme": "QAT, ROADMAP A13",
    "stack_layers": "the scan-over-layers layout cuts TPU compile time; "
                    "the port runs the layers one by one",
    "mesh": "parallelism, ROADMAP A13", "rules": "parallelism, ROADMAP A13",
    "use_dora": "DoRA, ROADMAP A13", "loftq_config": "LoftQ, ROADMAP A13"}


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

    # -- functional API (the JAX package's) ------------------------------
    def loss_fn(self, lora, batch, **kw):
        """``decoder.loss_fn`` on this model's params and config."""
        return loss_fn(self.params, lora, batch, self.cfg, **kw)

    def forward(self, input_ids, **kw):
        """``decoder.forward`` with this model's params and LoRA tree."""
        return forward(self.params, self.lora, input_ids, self.cfg, **kw)

    def logits(self, input_ids, **kw):
        """``decoder.logits_fn`` with this model's params and LoRA tree."""
        return logits_fn(self.params, self.lora, input_ids, self.cfg, **kw)

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
                        load_in_8bit: bool = False,
                        full_finetuning: bool = False, *,
                        token: Optional[str] = None,
                        trust_remote_code: bool = False,
                        fast_inference: bool = False,
                        stack_layers: bool = False,
                        qat_scheme: Optional[str] = None,
                        mesh: Optional[Any] = None,
                        rules: Optional[Any] = None, device="cuda",
                        **kwargs) -> Tuple[LanguageModel, Any]:
        """Load a model and tokenizer from a local HF checkpoint directory,
        or a hub name found in the HF cache, onto ``device``. The
        projections of a bnb-4bit directory arrive as NF4 weights without
        quantize_nf4, whatever ``load_in_4bit`` says, as in the JAX
        package. A Whisper directory gives ``((params, WhisperConfig),
        None)`` (``models/whisper.py``), its weights in ``dtype`` (default
        fp32), as the JAX package's route gives them.

        ``token``, ``trust_remote_code``, ``load_in_8bit`` and
        ``fast_inference`` are ignored, as in JAX, and so are other
        keywords (``max_lora_rank``, ``gpu_memory_utilization``, ...).
        ``qat_scheme`` without ``full_finetuning`` raises ValueError, as in
        JAX; with it, and ``stack_layers``, ``mesh`` or ``rules``, raise
        NotImplementedError."""
        del token, trust_remote_code, load_in_8bit, fast_inference, kwargs
        if qat_scheme is not None and not full_finetuning:
            raise ValueError(
                "Specifying `qat_scheme` in `from_pretrained(...)` is only "
                "compatible with `full_finetuning=True`. For QAT with LoRA, "
                "pass `qat_scheme` to `get_peft_model(...)`.")
        for option, value in (("qat_scheme", qat_scheme),
                              ("stack_layers", stack_layers or None),
                              ("mesh", mesh), ("rules", rules)):
            if value is not None:
                raise NotImplementedError(
                    f"from_pretrained({option}=...) is not ported yet "
                    f"({_UNPORTED_OPTIONS[option]})")
        if not os.path.isdir(model_name):
            model_name, load_in_4bit = get_model_name(model_name,
                                                      load_in_4bit)
        path = _resolve_model_path(model_name)
        hf_config = load_hf_config(path)
        if "vision_config" in hf_config or hf_config.get("model_type") == \
                "csm":
            raise NotImplementedError(
                f"{hf_config.get('model_type')!r} checkpoints (vision/audio)"
                " are not ported yet")
        if hf_config.get("model_type") == "whisper":
            # the JAX package's route: the functional (params, cfg) handle,
            # fp32 unless asked otherwise, and no tokenizer
            from .whisper import load_whisper

            if not isinstance(dtype, torch.dtype):
                dtype = torch.float32 if dtype is None else _DTYPES[dtype]
            return load_whisper(path, dtype=dtype, device=device), None
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
                       modules_to_save: Optional[Sequence[str]] = None,
                       qat_scheme: Optional[str] = None,
                       loftq_config: Optional[Any] = None,
                       use_dora: bool = False, **kwargs) -> LanguageModel:
        """Attach a LoRA tree (Kaiming-uniform A, zero B) on the model's
        device. Dropout and bias are recorded but, as on the fast path of
        the reference, not applied. ``modules_to_save`` ("embed_tokens" /
        "embed", "lm_head"; other names are skipped, as in JAX) adds fp32
        trainable copies of those weights to the tree: a tied model's
        "lm_head" copy comes from the embedding. Other keywords (the
        notebooks pass ``max_seq_length``) are ignored, as in JAX; DoRA,
        a ``loftq_config`` and ``qat_scheme`` raise NotImplementedError."""
        del kwargs
        for option, value in (("use_dora", use_dora or None),
                              ("loftq_config", loftq_config or None),
                              ("qat_scheme", qat_scheme)):
            if value is not None:
                raise NotImplementedError(
                    f"get_peft_model({option}=...) is not ported yet "
                    f"({_UNPORTED_OPTIONS[option]})")
        model.gc_mode = {"unsloth": "offload", True: True, False: False,
                         "layer": True, "offload": "offload"}.get(
            use_gradient_checkpointing, True)
        gen = torch.Generator(device=model.device).manual_seed(random_state)
        model.lora = init_lora_tree(model.cfg, gen, r=r, alpha=lora_alpha,
                                    target_modules=target_modules,
                                    use_rslora=use_rslora)
        for mod in (modules_to_save or []):
            ours = _MODULES_TO_SAVE.get(mod)
            if ours is None:
                continue
            src = model.params.get(ours)
            if src is None and ours == "lm_head":
                src = model.params["embed"]   # tied: untie into a copy
            if isinstance(src, torch.Tensor):
                model.lora[ours] = src.detach().to(torch.float32,
                                                   copy=True)
        model.lora_config = {
            "r": r, "lora_alpha": lora_alpha,
            "target_modules": list(target_modules),
            "lora_dropout": lora_dropout, "bias": bias,
            "use_rslora": use_rslora,
            "modules_to_save": list(modules_to_save or []),
            "init_lora_weights": True, "use_dora": False,
        }
        return model

    for_inference = staticmethod(lambda model: model.for_inference())
    for_training = staticmethod(lambda model: model.for_training())


FastModel = FastLanguageModel


def _resolve_model_path(model_name: str) -> str:
    """A local directory as it is; else the newest snapshot of the name in
    the HF cache (``$HF_HOME``, default ``~/.cache/huggingface``), as JAX
    looks for it. There is no download."""
    if os.path.isdir(model_name):
        return model_name
    cache = os.environ.get("HF_HOME",
                           os.path.expanduser("~/.cache/huggingface"))
    hub = os.path.join(cache, "hub",
                       "models--" + model_name.replace("/", "--"),
                       "snapshots")
    if os.path.isdir(hub):
        snaps = sorted(os.listdir(hub))
        if snaps:
            return os.path.join(hub, snaps[-1])
    raise FileNotFoundError(
        f"Model {model_name!r} is not a local directory and was not found "
        f"in the HF cache ({hub}). There is no network access; download "
        "the checkpoint first or pass a local path.")


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
