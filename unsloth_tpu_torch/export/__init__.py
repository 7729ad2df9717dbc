"""Saving: merged 16-bit checkpoints and peft-format LoRA adapters."""
