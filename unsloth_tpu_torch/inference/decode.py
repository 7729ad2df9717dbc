"""KV-cache decoding: prefill and single-token steps, in PyTorch.

Counterpart of unsloth_tpu/inference/decode.py for the plain-attention
llama-family path, dense or MoE (the MLP through ``mlp_block``), with
gpt-oss's sinks. The cache holds one preallocated [B, S, Hkv, Dh] tensor
per layer for k and for v. Where JAX returns a new cache from
``dynamic_update_slice``, :func:`forward_with_cache` writes the new k/v
**in place** into slots [length, length + T) and returns a cache object
whose ``length`` has advanced and whose tensors are the same ones.

Attention over the cache is plain PyTorch in fp32 (the JAX package keeps
it plain jnp too); the projections and norms go through the kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models.config import ModelConfig
from ..models.decoder import (_norm, _proj, _rope_tables, check_supported,
                              mlp_block)
from ..ops.lora import base_matmul
from ..ops.rms_norm import rms_norm
from ..ops.rope import apply_rope_qk


@dataclasses.dataclass
class KVCache:
    k: List[torch.Tensor]   # per layer [B, S, Hkv, Dh]
    v: List[torch.Tensor]
    length: int             # slots already written


def init_cache(cfg: ModelConfig, batch: int, max_length: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> KVCache:
    shape = (batch, max_length, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        k=[torch.zeros(shape, dtype=dtype, device=device)
           for _ in range(cfg.num_layers)],
        v=[torch.zeros(shape, dtype=dtype, device=device)
           for _ in range(cfg.num_layers)],
        length=0)


def _attend_cached(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, *, q_slots: torch.Tensor,
                   kv_len_mask: torch.Tensor, window: Optional[int],
                   softcap: Optional[float],
                   scale: Optional[float],
                   sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, Tq, Hq, Dh]; caches [B, S, Hkv, Dh]; kv_len_mask [B, S] marks
    valid slots; q_slots [B, Tq] are the query tokens' cache slots
    (causality is slot order). fp32 scores and softmax. A query row that
    sees no valid slot (a left-pad token) gets zero output: its softmax
    over all -inf would be NaN and spread through later layers. sinks
    [Hq] (gpt-oss): a per-head logit that joins the softmax denominator
    and carries no value (such a row then gets zeros too)."""
    dh, hq, hkv = q.shape[-1], q.shape[2], k_cache.shape[2]
    s = k_cache.shape[1]
    if scale is None:
        scale = dh ** -0.5
    k = k_cache.to(torch.float32)
    v = v_cache.to(torch.float32)
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q.to(torch.float32), k) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    kv_pos = torch.arange(s, device=q.device)[None, None, :]     # [1,1,S]
    qp = q_slots[:, :, None]                                     # [B,Tq,1]
    mask = (kv_pos <= qp) & kv_len_mask[:, None, :]              # [B,Tq,S]
    if window is not None:
        mask &= (qp - kv_pos) < window
    scores = scores.masked_fill(~mask[:, None], float("-inf"))
    if sinks is not None:
        b, tq = q.shape[:2]
        sink_col = sinks.to(torch.float32)[None, :, None, None].expand(
            b, hq, tq, 1)
        probs = torch.softmax(torch.cat([scores, sink_col], dim=-1),
                              dim=-1)[..., :-1]
    else:
        probs = torch.softmax(scores, dim=-1)
        probs = torch.where(mask.any(dim=-1, keepdim=True)[:, None], probs,
                            torch.zeros((), device=q.device))
    out = torch.einsum("bhts,bshd->bthd", probs, v)
    return out.to(q.dtype)


def forward_with_cache(params: Dict[str, Any], lora: Optional[Dict[str, Any]],
                       input_ids: torch.Tensor, cfg: ModelConfig,
                       cache: KVCache, *, positions: torch.Tensor,
                       kv_valid_extra: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, KVCache]:
    """Run [B, T] tokens through the stack, writing their k/v in place into
    cache slots [cache.length, cache.length + T) and attending to every
    valid slot; prefill (T = prompt length) and decode (T = 1) alike.

    positions [B, T]: RoPE position of each token (left-padded prompts
    have shifted positions). kv_valid_extra [B, S]: False marks slots to
    exclude, such as those holding left-pad tokens. Returns the final-norm
    hidden states [B, T, D] and the advanced cache."""
    check_supported(cfg)
    if not cfg.causal:
        raise NotImplementedError(
            "KV-cache decoding is causal; a bidirectional (text-diffusion, "
            "cfg.causal=False) model generates with models/diffusion.py:"
            "diffusion_generate, which reruns the whole canvas each step")
    b, t = input_ids.shape
    dev = input_ids.device
    lora_layers = (lora or {}).get("layers")
    embed_w = (lora or {}).get("embed")
    if embed_w is None:
        embed_w = params["embed"]
    x = torch.nn.functional.embedding(input_ids, embed_w)
    if cfg.embed_scale is not None:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype, device=dev)

    cos, sin, cos_l, sin_l = _rope_tables(cfg, positions)
    s_max = cache.k[0].shape[1]
    if cache.length + t > s_max:
        raise ValueError(f"KV cache holds {s_max} slots; {cache.length} "
                         f"written + {t} new")
    slots = torch.arange(s_max, device=dev)
    kv_valid = (slots < cache.length + t)[None].expand(b, s_max)
    if kv_valid_extra is not None:
        kv_valid = kv_valid & kv_valid_extra
    q_slots = (cache.length + torch.arange(t, device=dev))[None].expand(b, t)
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rm = cfg.residual_multiplier
    lo, hi = cache.length, cache.length + t

    for i, layer_p in enumerate(params["layers"]):
        lora_p = lora_layers[i] if lora_layers else None
        h = _norm(x, layer_p["input_norm"], cfg)
        q = _proj(h, layer_p, lora_p, "q").reshape(b, t, hq, dh)
        k = _proj(h, layer_p, lora_p, "k").reshape(b, t, hkv, dh)
        v = _proj(h, layer_p, lora_p, "v").reshape(b, t, hkv, dh)
        if cfg.qk_norm is True:
            q = rms_norm(q, layer_p["q_norm"], cfg.rms_norm_eps, cfg.gemma_norm)
            k = rms_norm(k, layer_p["k_norm"], cfg.rms_norm_eps, cfg.gemma_norm)
        kind = cfg.layer_kind(i)
        if kind == "sliding" and cos_l is not None:
            q, k = apply_rope_qk(q, k, cos_l, sin_l)
        else:
            q, k = apply_rope_qk(q, k, cos, sin)
        cache.k[i][:, lo:hi] = k.to(cache.k[i].dtype)
        cache.v[i][:, lo:hi] = v.to(cache.v[i].dtype)
        attn = _attend_cached(
            q, cache.k[i], cache.v[i], q_slots=q_slots, kv_len_mask=kv_valid,
            window=cfg.sliding_window if kind == "sliding" else None,
            softcap=cfg.attn_softcap, scale=cfg.attn_logit_scale,
            sinks=layer_p.get("sinks"))
        attn = _proj(attn.reshape(b, t, hq * dh), layer_p, lora_p, "o")
        if cfg.use_post_norms and "post_attn_out_norm" in layer_p:
            attn = _norm(attn, layer_p["post_attn_out_norm"], cfg)
        x = x + (attn * rm if rm is not None else attn)

        if cfg.use_post_norms and "pre_ffw_norm" in layer_p:
            h2 = _norm(x, layer_p["pre_ffw_norm"], cfg)
        else:
            h2 = _norm(x, layer_p["post_attn_norm"], cfg)
        mlp = mlp_block(h2, layer_p, lora_p, cfg, i)
        if cfg.use_post_norms and "post_ffw_norm" in layer_p:
            mlp = _norm(mlp, layer_p["post_ffw_norm"], cfg)
        x = x + (mlp * rm if rm is not None else mlp)

    x = _norm(x, params["final_norm"], cfg)
    return x, KVCache(k=cache.k, v=cache.v, length=hi)


def logits_from_hidden(params: Dict[str, Any], h: torch.Tensor,
                       cfg: ModelConfig, lora=None) -> torch.Tensor:
    """h [..., D] -> logits [..., V] through the (dense) lm_head."""
    w = (lora or {}).get("lm_head")
    if w is None:
        w = params.get("lm_head")
    if w is None:
        w = (lora or {}).get("embed")
    if w is None:
        w = params["embed"]
    logits = base_matmul(h, w)
    if cfg.logit_scale is not None:
        logits = logits * cfg.logit_scale
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits
