"""KV-cache decoding, generation and the OpenAI-compatible server."""
