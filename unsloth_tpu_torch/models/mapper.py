"""Model-name catalog and resolution.

The port's own copy of unsloth_tpu/models/mapper.py (the package imports
nothing of the JAX one): the family registry (``MODEL_CATALOG``, merged
with ``catalog_data.CATALOG_DATA``), :func:`strip_quant_suffix`,
:func:`get_model_name` and :func:`search_models`, unchanged.

As in JAX, resolution inverts the reference's mapping: the port
quantizes to NF4 at load, so a name asking for a ``-bnb-4bit`` (or FP8 /
8-bit) mirror resolves to the float repo with ``load_in_4bit=True``, and
``unsloth/X`` to the catalog's ``org/X`` where the catalog has it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# family -> list of (org/base_name, sizes)
MODEL_CATALOG: Dict[str, List[str]] = {
    "llama": [
        "meta-llama/Llama-3.1-8B", "meta-llama/Llama-3.1-8B-Instruct",
        "meta-llama/Llama-3.1-70B", "meta-llama/Llama-3.1-70B-Instruct",
        "meta-llama/Llama-3.2-1B", "meta-llama/Llama-3.2-1B-Instruct",
        "meta-llama/Llama-3.2-3B", "meta-llama/Llama-3.2-3B-Instruct",
        "meta-llama/Llama-3.3-70B-Instruct",
        "meta-llama/Meta-Llama-3-8B", "meta-llama/Meta-Llama-3-8B-Instruct",
        "meta-llama/Llama-2-7b-hf", "meta-llama/Llama-2-13b-hf",
    ],
    "qwen": [
        "Qwen/Qwen2.5-0.5B", "Qwen/Qwen2.5-0.5B-Instruct",
        "Qwen/Qwen2.5-1.5B", "Qwen/Qwen2.5-1.5B-Instruct",
        "Qwen/Qwen2.5-3B", "Qwen/Qwen2.5-3B-Instruct",
        "Qwen/Qwen2.5-7B", "Qwen/Qwen2.5-7B-Instruct",
        "Qwen/Qwen2.5-14B", "Qwen/Qwen2.5-14B-Instruct",
        "Qwen/Qwen2.5-32B-Instruct", "Qwen/Qwen2.5-72B-Instruct",
        "Qwen/Qwen3-0.6B", "Qwen/Qwen3-1.7B", "Qwen/Qwen3-4B",
        "Qwen/Qwen3-8B", "Qwen/Qwen3-14B", "Qwen/Qwen3-32B",
        "Qwen/Qwen3-30B-A3B", "Qwen/Qwen3-235B-A22B",
    ],
    "gemma": [
        "google/gemma-2-2b", "google/gemma-2-2b-it",
        "google/gemma-2-9b", "google/gemma-2-9b-it",
        "google/gemma-2-27b-it",
        "google/gemma-3-1b-it", "google/gemma-3-4b-it",
        "google/gemma-3-12b-it", "google/gemma-3-27b-it",
    ],
    "mistral": [
        "mistralai/Mistral-7B-v0.3", "mistralai/Mistral-7B-Instruct-v0.3",
        "mistralai/Mistral-Nemo-Instruct-2407",
        "mistralai/Mixtral-8x7B-Instruct-v0.1",
        "mistralai/Ministral-8B-Instruct-2410",
    ],
    "phi": [
        "microsoft/Phi-3.5-mini-instruct", "microsoft/phi-4",
        "microsoft/Phi-4-mini-instruct",
    ],
    "gpt-oss": [
        "openai/gpt-oss-20b", "openai/gpt-oss-120b",
    ],
    "deepseek": [
        "deepseek-ai/DeepSeek-R1-Distill-Llama-8B",
        "deepseek-ai/DeepSeek-R1-Distill-Qwen-1.5B",
        "deepseek-ai/DeepSeek-R1-Distill-Qwen-7B",
        "deepseek-ai/DeepSeek-R1-Distill-Qwen-14B",
        "deepseek-ai/DeepSeek-R1-Distill-Qwen-32B",
        "deepseek-ai/DeepSeek-R1-Distill-Llama-70B",
    ],
    "llama-4": [
        "meta-llama/Llama-4-Scout-17B-16E",
        "meta-llama/Llama-4-Scout-17B-16E-Instruct",
        "meta-llama/Llama-4-Maverick-17B-128E-Instruct",
    ],
    "llama-guard": [
        "meta-llama/Llama-Guard-3-1B", "meta-llama/Llama-Guard-3-8B",
    ],
    "falcon": [
        "tiiuae/Falcon-H1-0.5B-Instruct", "tiiuae/Falcon-H1-1.5B-Instruct",
        "tiiuae/Falcon-H1-3B-Instruct", "tiiuae/Falcon-H1-7B-Instruct",
        "tiiuae/Falcon-H1-34B-Instruct", "tiiuae/falcon-7b-instruct",
    ],
    "qwen-vl": [
        "Qwen/Qwen2.5-VL-3B-Instruct", "Qwen/Qwen2.5-VL-7B-Instruct",
        "Qwen/Qwen2.5-VL-32B-Instruct", "Qwen/Qwen2.5-VL-72B-Instruct",
        "Qwen/Qwen2-VL-2B-Instruct", "Qwen/Qwen2-VL-7B-Instruct",
    ],
    "qwen-coder": [
        "Qwen/Qwen2.5-Coder-0.5B-Instruct",
        "Qwen/Qwen2.5-Coder-1.5B-Instruct",
        "Qwen/Qwen2.5-Coder-7B-Instruct",
        "Qwen/Qwen2.5-Coder-14B-Instruct",
        "Qwen/Qwen2.5-Coder-32B-Instruct",
    ],
    "qwen-math": [
        "Qwen/Qwen2.5-Math-1.5B-Instruct",
        "Qwen/Qwen2.5-Math-7B-Instruct",
    ],
    "qwen3-2507": [
        "Qwen/Qwen3-4B-Instruct-2507", "Qwen/Qwen3-4B-Thinking-2507",
        "Qwen/Qwen3-30B-A3B-Instruct-2507",
        "Qwen/Qwen3-30B-A3B-Thinking-2507",
        "Qwen/Qwen3-235B-A22B-Instruct-2507",
        "Qwen/QwQ-32B",
    ],
    "gemma-extra": [
        "google/gemma-3-270m-it", "google/gemma-3n-E2B-it",
        "google/gemma-3n-E4B-it", "google/codegemma-7b-it",
        "google/gemma-2b-it", "google/gemma-7b-it",
    ],
    "mistral-extra": [
        "mistralai/Mistral-Small-Instruct-2409",
        "mistralai/Mistral-Small-24B-Instruct-2501",
        "mistralai/Mistral-Large-Instruct-2407",
        "mistralai/Pixtral-12B-2409",
        "mistralai/Mathstral-7B-v0.1",
        "mistralai/Codestral-22B-v0.1",
        "mistralai/Mixtral-8x22B-Instruct-v0.1",
        "mistralai/Mistral-7B-Instruct-v0.2",
        "mistralai/Mistral-7B-Instruct-v0.1",
    ],
    "phi-extra": [
        "microsoft/Phi-3-mini-4k-instruct",
        "microsoft/Phi-3-medium-4k-instruct",
        "microsoft/Phi-3.5-MoE-instruct",
        "microsoft/Phi-4-mini-reasoning",
        "microsoft/Phi-4-reasoning",
    ],
    "granite": [
        "ibm-granite/granite-3.1-2b-instruct",
        "ibm-granite/granite-3.1-8b-instruct",
        "ibm-granite/granite-3.3-2b-instruct",
        "ibm-granite/granite-3.3-8b-instruct",
    ],
    "cohere": [
        "CohereForAI/c4ai-command-r-v01",
        "CohereForAI/c4ai-command-r7b-12-2024",
        "CohereForAI/aya-expanse-8b",
    ],
    "small-lm": [
        "TinyLlama/TinyLlama-1.1B-Chat-v1.0",
        "HuggingFaceTB/SmolLM2-135M-Instruct",
        "HuggingFaceTB/SmolLM2-360M-Instruct",
        "HuggingFaceTB/SmolLM2-1.7B-Instruct",
        "allenai/OLMo-2-1124-7B-Instruct",
        "01-ai/Yi-1.5-6B-Chat", "01-ai/Yi-1.5-9B-Chat",
        "HuggingFaceH4/zephyr-7b-beta",
        "LiquidAI/LFM2-1.2B",
    ],
    "vision": [
        "meta-llama/Llama-3.2-11B-Vision-Instruct",
        "meta-llama/Llama-3.2-90B-Vision-Instruct",
        "google/gemma-3-4b-it",  # multimodal gemma-3
        "unsloth/Llama-3.2-11B-Vision-Instruct",
    ],
    "audio": [
        "openai/whisper-large-v3", "openai/whisper-large-v3-turbo",
        "openai/whisper-medium", "openai/whisper-small",
        "canopylabs/orpheus-3b-0.1-ft",
        "canopylabs/orpheus-3b-0.1-pretrained",
        "sesame/csm-1b",
    ],
    "embedding": [
        "google/embeddinggemma-300m",
        "sentence-transformers/all-MiniLM-L6-v2",
        "sentence-transformers/all-mpnet-base-v2",
        "intfloat/e5-large-v2",
        "BAAI/bge-base-en-v1.5",
    ],
    "code": [
        "bigcode/starcoder2-3b", "bigcode/starcoder2-7b",
        "codellama/CodeLlama-7b-Instruct-hf",
        "codellama/CodeLlama-13b-Instruct-hf",
    ],
    "diffusion": [
        "google/diffusiongemma-26B-A4B-it",
    ],
}

# Merge the full harvested registry (reference mapper.py's "500+ models"
# list) under the curated families above.
from .catalog_data import CATALOG_DATA  # noqa: E402

for _fam, _models in CATALOG_DATA.items():
    _dst = MODEL_CATALOG.setdefault(_fam, [])
    for _m in _models:
        if _m not in _dst:
            _dst.append(_m)
del _fam, _models, _dst, _m

_QUANT_SUFFIXES = ("-unsloth-bnb-4bit", "-bnb-4bit", "-unsloth-dynamic-fp8",
                   "-FP8", "-bnb-8bit")


def strip_quant_suffix(name: str) -> Tuple[str, Optional[str]]:
    for suffix in _QUANT_SUFFIXES:
        if name.endswith(suffix):
            return name[: -len(suffix)], suffix
    return name, None


def get_model_name(model_name: str, load_in_4bit: bool = True
                   ) -> Tuple[str, bool]:
    """Resolve a user-supplied model name (reference:
    loader_utils.py:244 get_model_name). Returns (resolved_name,
    load_in_4bit). `unsloth/X-bnb-4bit` styles resolve to the float repo
    with on-the-fly NF4."""
    base, suffix = strip_quant_suffix(model_name)
    if suffix is not None:
        load_in_4bit = True
    # unsloth mirrors keep the base model's name under the unsloth org
    if base.startswith("unsloth/"):
        tail = base.split("/", 1)[1]
        for family in MODEL_CATALOG.values():
            for full in family:
                if full.split("/", 1)[1].lower() == tail.lower():
                    return full, load_in_4bit
        # unknown unsloth mirror: keep as-is (may exist locally)
        return base, load_in_4bit
    return base, load_in_4bit


def search_models(query: str = "", family: Optional[str] = None
                  ) -> List[str]:
    """Registry search (reference: unsloth/registry/ + `ModelInfo`)."""
    names = []
    for fam, models in MODEL_CATALOG.items():
        if family and fam != family:
            continue
        names.extend(models)
    if query:
        q = query.lower()
        names = [n for n in names if q in n.lower()]
    return sorted(names)
