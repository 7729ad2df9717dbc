"""The trainers: SFT (packed batches, accumulation, AdamW), GRPO/RLOO
(fanned-out rollouts, the clipped surrogate, the shared-prefix layout)
and Whisper's seq2seq trainer (``trainer/whisper.py``)."""

from .grpo import (GRPOConfig, GRPOTrainer, PatchFastRL,  # noqa: F401
                   RLOOConfig, RLOOTrainer)
