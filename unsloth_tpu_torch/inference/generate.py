"""Generation: left-padded prefill, then a Python decode loop, in PyTorch.

Counterpart of unsloth_tpu/inference/generate.py:generate. Prompts are
left-padded to a multiple of 64, prefilled in one ``forward_with_cache``
call and decoded one token per step with greedy, temperature, top-k or
top-p sampling from a seeded ``torch.Generator`` on the model's device.
Where JAX keeps the whole loop on the device (``lax.while_loop``), the
port's loop runs on the host and reads ``done.all()`` once per step to stop
early when every row has emitted an EOS id; that one sync per token is
accepted here (CUDA graphs are later work).

Not ported yet (each raises ``NotImplementedError``): speculative decoding,
``num_return_sequences`` > 1 (shared-prefix fan-out) and fp8 KV caches.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..models.config import ModelConfig
from .decode import forward_with_cache, init_cache, logits_from_hidden


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """vLLM-compatible sampling surface."""

    max_tokens: int = 128
    temperature: float = 0.0        # 0 => greedy
    top_p: float = 1.0
    top_k: int = 0                  # 0 => off
    seed: int = 0
    stop_token_ids: tuple = ()


def _sample(logits: torch.Tensor, generator: torch.Generator,
            p: SamplingParams) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int64)."""
    if p.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.to(torch.float32) / p.temperature
    if p.top_k > 0:
        kth = torch.topk(logits, p.top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if p.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # smallest set whose cumulative probability reaches top_p
        cutoff_idx = (cum < p.top_p).sum(dim=-1, keepdim=True)
        cutoff_idx = cutoff_idx.clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).squeeze(-1)


def _generate_ids(params: Dict[str, Any], lora, prompt_ids: torch.Tensor,
                  prompt_mask: torch.Tensor, cfg: ModelConfig,
                  max_new_tokens: int, eos_ids: torch.Tensor,
                  sampling: SamplingParams) -> torch.Tensor:
    """[B, T] left-padded prompts -> [B, max_new_tokens] new ids; rows that
    have emitted an EOS id are filled with 0 from then on."""
    dev = prompt_ids.device
    b, t_prompt = prompt_ids.shape
    cache = init_cache(cfg, b, t_prompt + max_new_tokens,
                       dtype=torch.bfloat16, device=dev)
    # left-padded prompts start at position 0 on their first real token
    first_real = torch.argmax(prompt_mask.to(torch.int32), dim=1)
    positions = (torch.arange(t_prompt, device=dev)[None]
                 - first_real[:, None]).clamp(min=0)
    kv_valid_extra = torch.ones((b, t_prompt + max_new_tokens),
                                dtype=torch.bool, device=dev)
    kv_valid_extra[:, :t_prompt] = prompt_mask.to(torch.bool)

    h, cache = forward_with_cache(params, lora, prompt_ids, cfg, cache,
                                  positions=positions,
                                  kv_valid_extra=kv_valid_extra)
    logits = logits_from_hidden(params, h[:, -1, :], cfg, lora)
    pos = positions[:, -1] + 1
    gen = torch.Generator(device=dev).manual_seed(sampling.seed)
    tok = _sample(logits, gen, sampling)
    out = torch.zeros((b, max_new_tokens), dtype=torch.int64, device=dev)
    out[:, 0] = tok
    done = torch.isin(tok, eos_ids)
    for i in range(1, max_new_tokens):
        if bool(done.all()):
            break
        h, cache = forward_with_cache(params, lora, tok[:, None], cfg, cache,
                                      positions=pos[:, None],
                                      kv_valid_extra=kv_valid_extra)
        logits = logits_from_hidden(params, h, cfg, lora)[:, 0]
        tok = torch.where(done, torch.zeros_like(tok),
                          _sample(logits, gen, sampling))
        out[:, i] = tok
        done = done | torch.isin(tok, eos_ids)
        pos = pos + 1
    return out


def generate(model, prompts: Union[str, Sequence[str], np.ndarray,
                                   Sequence[Sequence[int]]],
             sampling_params: Optional[SamplingParams] = None, *,
             max_new_tokens: Optional[int] = None,
             temperature: Optional[float] = None, tokenizer=None,
             skip_special_tokens: bool = True,
             return_token_ids: bool = False, num_return_sequences: int = 1,
             speculative: bool = False, lora: Any = "__model__",
             kv_cache_dtype: str = "bf16"):
    """Strings or token-id lists in, strings (or id lists) out.

    lora: an adapter tree to use instead of ``model.lora``, or None for the
    bare base model."""
    if speculative:
        raise NotImplementedError("speculative decoding is not ported yet")
    if num_return_sequences != 1:
        raise NotImplementedError(
            "num_return_sequences > 1 (shared-prefix fan-out) is not ported "
            "yet")
    if kv_cache_dtype != "bf16":
        raise NotImplementedError(f"kv_cache_dtype={kv_cache_dtype!r} is not "
                                  "ported yet; only 'bf16'")
    sampling = sampling_params or SamplingParams()
    if max_new_tokens is not None:
        sampling = dataclasses.replace(sampling, max_tokens=max_new_tokens)
    if temperature is not None:
        sampling = dataclasses.replace(sampling, temperature=temperature)

    tok = tokenizer or model.tokenizer
    if isinstance(prompts, str):
        prompts = [prompts]
    if len(prompts) and isinstance(prompts[0], str):
        if tok is None:
            raise ValueError("string prompts need a tokenizer")
        encoded = [list(tok(p)["input_ids"]) for p in prompts]
    else:
        encoded = [[int(i) for i in p] for p in prompts]

    b = len(encoded)
    t_prompt = -(-max(len(e) for e in encoded) // 64) * 64
    prompt_ids = np.zeros((b, t_prompt), np.int64)
    prompt_mask = np.zeros((b, t_prompt), np.int32)
    for i, e in enumerate(encoded):
        prompt_ids[i, t_prompt - len(e):] = e       # left padding
        prompt_mask[i, t_prompt - len(e):] = 1

    eos = []
    if tok is not None and getattr(tok, "eos_token_id", None) is not None:
        eos.append(int(tok.eos_token_id))
    if model.cfg.eos_token_id is not None:
        eos.append(int(model.cfg.eos_token_id))
    eos.extend(sampling.stop_token_ids)
    eos_set = set(eos)

    dev = model.device
    lora_tree = model.lora if isinstance(lora, str) and lora == "__model__" \
        else lora
    out = _generate_ids(
        model.params, lora_tree, torch.from_numpy(prompt_ids).to(dev),
        torch.from_numpy(prompt_mask).to(dev), model.cfg, sampling.max_tokens,
        torch.tensor(sorted(eos_set), dtype=torch.int64, device=dev),
        sampling).cpu().tolist()

    ids = [_trim_eos(row, eos_set) for row in out]
    if return_token_ids or tok is None:
        return ids
    return [tok.decode(r, skip_special_tokens=skip_special_tokens)
            for r in ids]


def _trim_eos(ids: List[int], eos: set) -> List[int]:
    result = []
    for t in ids:
        if t in eos:
            break
        result.append(t)
    return result
