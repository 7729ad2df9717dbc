"""The trainers: SFT (packed batches, accumulation, AdamW or GaLore, LoRA
or full fine-tuning, checkpoints and resume: ``trainer/checkpoint.py``),
GRPO/RLOO (fanned-out rollouts, the clipped surrogate, the shared-prefix
layout) and Whisper's seq2seq trainer (``trainer/whisper.py``)."""

from .checkpoint import (latest_checkpoint, restore_latest,  # noqa: F401
                         restore_train_state, save_train_state)

from .grpo import (GRPOConfig, GRPOTrainer, PatchFastRL,  # noqa: F401
                   RLOOConfig, RLOOTrainer)
