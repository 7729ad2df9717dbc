"""Optimizers beyond the SFT trainer's clipped AdamW: GaLore and Q-GaLore
(``optimizers/galore.py``)."""

from .galore import galore, q_galore, state_memory_ratio  # noqa: F401
