"""KV-cache decoding, generation and the OpenAI-compatible server."""

from .decode import (KVCache, forward_with_cache, init_cache,  # noqa: F401
                     logits_from_hidden)
from .generate import SamplingParams, generate  # noqa: F401

__all__ = ["KVCache", "forward_with_cache", "init_cache",
           "logits_from_hidden", "SamplingParams", "generate"]
