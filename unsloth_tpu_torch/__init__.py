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
response-only labels, merged and LoRA saves).
"""

__version__ = "0.1.0"


from .models.loader import FastLanguageModel, LanguageModel  # noqa: E402,F401
from .inference.generate import SamplingParams, generate  # noqa: E402,F401
from .inference.server import InferenceServer  # noqa: E402,F401
from .trainer.sft import (SFTConfig, SFTTrainer,  # noqa: E402,F401
                          train_on_responses_only, unsloth_train)
