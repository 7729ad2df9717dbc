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
"""

__version__ = "0.1.0"


from .models.loader import FastLanguageModel, LanguageModel  # noqa: E402,F401
from .models.diffusion import FastDiffusionModel  # noqa: E402,F401
from .inference.generate import SamplingParams, generate  # noqa: E402,F401
from .inference.server import InferenceServer  # noqa: E402,F401
from .trainer.sft import (SFTConfig, SFTTrainer,  # noqa: E402,F401
                          train_on_responses_only, unsloth_train)
from .trainer.grpo import (GRPOConfig, GRPOTrainer,  # noqa: E402,F401
                           PatchFastRL, RLOOConfig, RLOOTrainer)
from .ops import (FP8Tensor, dequantize_fp8,  # noqa: E402,F401
                  fp8_matmul, quantize_fp8_block)
