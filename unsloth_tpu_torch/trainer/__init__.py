"""The trainers: SFT (packed batches, accumulation, AdamW) and GRPO/RLOO
(fanned-out rollouts, the clipped surrogate, the shared-prefix layout)."""

from .grpo import (GRPOConfig, GRPOTrainer, PatchFastRL,  # noqa: F401
                   RLOOConfig, RLOOTrainer)
