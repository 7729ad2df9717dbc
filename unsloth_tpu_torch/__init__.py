"""unsloth_tpu_torch — the PyTorch/CUDA port of unsloth_tpu for NVIDIA Hopper.

The JAX package ``unsloth_tpu`` is the reference; this package mirrors its
layout (``ops/``, ``models/``, ``inference/``) so that each module's
counterpart is easy to find, and imports no JAX. Plain tensor code is
PyTorch; the kernels that the JAX package wrote in Pallas are CUDA C++
in ``csrc/``, built on first use (``kernels.py``).

Ported so far, for the llama-family dense decoder: the serving slice
(load -> NF4 quantize -> generate -> OpenAI-compatible HTTP server) and the
training slice (get_peft_model -> packed rows -> QLoRA SFT with offloaded
gradient checkpointing and a chunked fused CE), and SFT without packing
(padded rows through the flash kernels, the full-logits CE, evaluate,
response-only labels, merged and LoRA saves); GRPO and RLOO (fanned-out
rollouts, the reference pass on the frozen base, the chunked selective
log-softmax, and the shared-prefix layout through the splash kernels);
speech: Whisper (``models/whisper.py``, ``trainer/whisper.py``) over the
LayerNorm kernels, and the Orpheus TTS rows (``data/tts.py``); LoRA over a
block-FP8 base (``ops/fp8.py``: quantize the projections with
:func:`quantize_fp8_block`, as in JAX), trained and served through the FP8
dequant-inside-matmul kernels (``ops/fp8_matmul.py``); full fine-tuning
(``from_pretrained(full_finetuning=True)`` then ``SFTTrainer``: every
param trained, MoE experts through the expert weight-gradient kernel
``ops/gmm.py:tgmm``), with GaLore / Q-GaLore (``optimizers/galore.py``),
``modules_to_save`` with ``embedding_learning_rate``, and checkpoint saves
and resume (``trainer/checkpoint.py``); hub names resolved through the
model-name mapper (``models/mapper.py``) and the HF cache; text diffusion
(:class:`FastDiffusionModel`, ``models/diffusion.py``: LLaDA's masked
denoising loss and iterative unmasking over the bidirectional decoder;
``trainer/diffusion.py:DiffusionTrainer``), through the non-causal forms
of the attention kernels.

The root and ``trainer``, ``models``, ``inference`` and ``ops`` export the
JAX package's names whose modules are ported, with their meaning, so that
a notebook ports by swapping the import; a name whose module is not
ported raises AttributeError naming that module.
"""

__version__ = "0.1.0"

import torch  # noqa: E402

from .models.config import ModelConfig, RopeScaling  # noqa: E402,F401
from .models.loader import (FastLanguageModel, FastModel,  # noqa: E402,F401
                            LanguageModel)
from .models.diffusion import FastDiffusionModel  # noqa: E402,F401
from .inference.generate import SamplingParams, generate  # noqa: E402,F401
from .inference.server import InferenceServer  # noqa: E402,F401
from .trainer.sft import (SFTConfig, SFTTrainer,  # noqa: E402,F401
                          train_on_responses_only, unsloth_train)
from .trainer.grpo import (GRPOConfig, GRPOTrainer,  # noqa: E402,F401
                           PatchFastRL, RLOOConfig, RLOOTrainer)
from .ops import (FP8Tensor, dequantize_fp8,  # noqa: E402,F401
                  fp8_matmul, quantize_fp8_block)

# the JAX package's aliases: FastTextModel for text-only models, one facade
# name a family (every family loads through the same loader), the trainer's
# and vLLM's names
FastTextModel = FastLanguageModel
FastLlamaModel = FastLanguageModel
FastMistralModel = FastLanguageModel
FastQwen2Model = FastLanguageModel
FastQwen3Model = FastLanguageModel
FastQwen3MoeModel = FastLanguageModel
FastGraniteModel = FastLanguageModel
FastFalconH1Model = FastLanguageModel
UnslothTrainer = SFTTrainer
UnslothTrainingArguments = SFTConfig
vLLMSamplingParams = SamplingParams


def is_bfloat16_supported() -> bool:
    """True on a CUDA card with bf16 arithmetic (capability 8.0 or later;
    the JAX package's answer on a TPU is always true)."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability()[0] >= 8)


def is_vLLM_available() -> bool:
    """True, as in the JAX package: ``fast_inference=True`` is served by
    the port's own ``generate``, with no vLLM process."""
    return True


#: the JAX package's root names whose modules the port has not ported, by
#: that module
_UNPORTED = {
    name: module for module, names in {
        "unsloth_tpu.parallel.mesh": ("create_mesh", "ShardingRules"),
        "unsloth_tpu.parallel.pipeline": ("enable_pipeline",),
        "unsloth_tpu.models.vision": ("FastVisionModel",),
        "unsloth_tpu.models.sentence_transformer": (
            "FastSentenceTransformer",),
        "unsloth_tpu.data.chat_templates": (
            "get_chat_template", "apply_chat_template",
            "standardize_sharegpt", "standardize_data_formats",
            "remove_special_tokens", "to_sharegpt",
            "construct_chat_template", "CHAT_TEMPLATES"),
        "unsloth_tpu.data.tokenizer_utils": (
            "add_new_tokens", "mean_of_trained_tokens",
            "fix_untrained_tokens", "convert_to_fast_tokenizer"),
        "unsloth_tpu.data.raw_text": ("RawTextDataLoader",),
        "unsloth_tpu.data.synthetic": ("SyntheticDataKit",),
        "unsloth_tpu.trainer.dpo": (
            "PatchDPOTrainer", "PatchKTOTrainer", "DPOTrainer",
            "ORPOTrainer", "KTOTrainer", "CPOTrainer", "BCOTrainer",
            "BCOConfig"),
        "unsloth_tpu.trainer.reward": ("RewardTrainer", "RewardConfig"),
        "unsloth_tpu.trainer.online_dpo": ("OnlineDPOTrainer",
                                           "OnlineDPOConfig"),
        "unsloth_tpu.trainer.gkd": ("GKDTrainer", "GKDConfig"),
        "unsloth_tpu.trainer.ppo": ("PPOTrainer", "PPOConfig"),
        "unsloth_tpu.trainer.prm": ("PRMTrainer", "PRMConfig"),
        "unsloth_tpu.export.gguf_loader": ("load_gguf",),
    }.items() for name in names}


def __getattr__(name):
    if name in _UNPORTED:
        raise AttributeError(f"{__name__}.{name} is not ported: "
                             f"{_UNPORTED[name]} has no counterpart here")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ModelConfig", "RopeScaling", "FastLanguageModel", "FastModel",
    "FastTextModel", "FastDiffusionModel", "LanguageModel",
    "FastLlamaModel", "FastMistralModel", "FastQwen2Model",
    "FastQwen3Model", "FastQwen3MoeModel", "FastGraniteModel",
    "FastFalconH1Model", "SFTConfig", "SFTTrainer", "UnslothTrainer",
    "UnslothTrainingArguments", "train_on_responses_only", "unsloth_train",
    "GRPOConfig", "GRPOTrainer", "PatchFastRL", "RLOOConfig", "RLOOTrainer",
    "SamplingParams", "vLLMSamplingParams", "generate", "InferenceServer",
    "FP8Tensor", "dequantize_fp8", "fp8_matmul", "quantize_fp8_block",
    "is_bfloat16_supported", "is_vLLM_available", "__version__",
]
