"""The trainers: SFT (packed batches, accumulation, AdamW or GaLore, LoRA
or full fine-tuning, checkpoints and resume: ``trainer/checkpoint.py``),
GRPO/RLOO (fanned-out rollouts, the clipped surrogate, the shared-prefix
layout) and Whisper's seq2seq trainer (``trainer/whisper.py``)."""

from .checkpoint import (latest_checkpoint, restore_latest,  # noqa: F401
                         restore_train_state, save_train_state)
from .grpo import (GRPOConfig, GRPOTrainer, PatchFastRL,  # noqa: F401
                   RLOOConfig, RLOOTrainer)
from .sft import (SFTConfig, SFTTrainer, TrainOutput,  # noqa: F401
                  build_optimizer, build_schedule, make_config,
                  train_on_responses_only, unsloth_train)

# the JAX package's names for the SFT trainer and its arguments
UnslothTrainer = SFTTrainer
UnslothTrainingArguments = SFTConfig

#: the JAX package's trainer names whose modules the port has not ported,
#: by that module
_UNPORTED = {
    name: f"unsloth_tpu.trainer.{module}" for module, names in {
        "dpo": ("DPOConfig", "DPOTrainer", "PatchDPOTrainer", "ORPOConfig",
                "ORPOTrainer", "KTOConfig", "KTOTrainer", "CPOConfig",
                "CPOTrainer", "BCOConfig", "BCOTrainer"),
        "reward": ("RewardConfig", "RewardTrainer"),
        "online_dpo": ("OnlineDPOConfig", "OnlineDPOTrainer"),
        "gkd": ("GKDConfig", "GKDTrainer"),
        "ppo": ("PPOConfig", "PPOTrainer"),
        "prm": ("PRMConfig", "PRMTrainer"),
    }.items() for name in names}


def __getattr__(name):
    if name in _UNPORTED:
        raise AttributeError(f"{__name__}.{name} is not ported: "
                             f"{_UNPORTED[name]} has no counterpart here")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "SFTConfig", "SFTTrainer", "TrainOutput", "build_optimizer",
    "build_schedule", "make_config", "train_on_responses_only",
    "unsloth_train", "UnslothTrainer", "UnslothTrainingArguments",
    "GRPOConfig", "GRPOTrainer", "PatchFastRL", "RLOOConfig", "RLOOTrainer",
    "latest_checkpoint", "restore_latest", "restore_train_state",
    "save_train_state",
]
