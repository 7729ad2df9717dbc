"""Model configuration, parameter trees, checkpoint loading and the
user-facing FastLanguageModel facade."""

from .config import ModelConfig, RopeScaling  # noqa: F401
from .decoder import forward, logits_fn, loss_fn  # noqa: F401
from .params import (count_params, init_lora_tree,  # noqa: F401
                     init_params, quantize_params)

__all__ = [
    "ModelConfig", "RopeScaling",
    "forward", "logits_fn", "loss_fn",
    "init_params", "init_lora_tree", "quantize_params", "count_params",
]
