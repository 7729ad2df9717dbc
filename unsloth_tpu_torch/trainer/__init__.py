"""The SFT trainer: packed batches, accumulation, AdamW."""
