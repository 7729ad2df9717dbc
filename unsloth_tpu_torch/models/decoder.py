"""The llama-family decoder in PyTorch, dense or with softmax-top-k MoE
layers (gpt-oss, qwen3-moe, mixtral): the training forward, the SFT loss
and the blocks that KV-cache decoding shares.

Counterpart of unsloth_tpu/models/decoder.py: ``_norm``, ``_proj``,
``mlp_block`` and ``_rope_tables`` (shared with ``inference/decode.py``),
``moe_block``, ``attention_block`` (with gpt-oss's sinks),
``decoder_layer``, ``forward`` (with per-layer
rematerialization, optionally offloading the layer boundaries to pinned
host memory), ``loss_fn`` / ``_loss_from_hidden`` (shifted labels, global
``n_items``, the full-logits CE through the K7/K8 kernels or the
chunked fused CE, chosen by :func:`fused_ce_gate`) and ``logits_fn``.

Parameter tree schema (the JAX package's, HF-shaped [out, in] weights):

  params = {
    "embed": [V, D],
    "layers": [{"input_norm": [D], "post_attn_norm": [D],
                "q": W|NF4, "k": ..., "v": ..., "o": ...,
                "gate": W|NF4, "up": W|NF4, "down": W|NF4, ...}, ...],
                (MoE layers: "router": [E, D], "router_bias": [E],
                 "experts": {"gate"/"up": [E, F, D], "down": [E, D, F]
                 (dense or NF4Stacked), "gate_bias"/"up_bias": [E, F],
                 "down_bias": [E, D]}; gpt-oss: "sinks": [Hq])
    "final_norm": [D],
    "lm_head": [V, D] (absent when tied to embed),
  }

Only the llama-family decoder is ported, dense or with MoE layers routed
by softmax-top-k without a shared expert; :func:`check_supported` raises
``NotImplementedError`` naming the first ``ModelConfig`` knob of any other
architecture.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.activations import ACT2GLU, glu_for
from ..ops.attention import attention
from ..ops.cross_entropy import fast_cross_entropy_loss
from ..ops.fused_ce_linear import fused_ce_loss_mean
from ..ops.lora import base_matmul, lora_matmul
from ..ops.moe import moe_mlp
from ..ops.nf4 import NF4Stacked, NF4Tensor, dequantize_nf4
from ..ops.rms_norm import rms_norm
from ..ops.rope import (apply_rope_qk, rope_inv_freq, rope_table,
                        yarn_attention_factor)
from .config import ModelConfig

# ModelConfig knobs whose code paths are not ported yet: (field, test).
_UNPORTED = (
    ("altup", lambda c: c.altup is not None),
    ("hybrid_mamba", lambda c: c.hybrid_mamba or c.mamba is not None),
    ("mla", lambda c: c.mla is not None),
    ("lightning", lambda c: c.lightning is not None),
    ("gdn", lambda c: c.gdn is not None),
    ("zamba", lambda c: c.zamba is not None),
    ("moe_routing", lambda c: c.num_experts > 0
     and c.moe_routing != "softmax_topk"),
    ("moe_shared_expert", lambda c: c.moe_shared_expert),
    ("moe_shared_gate", lambda c: c.moe_shared_gate),
    ("moe_act", lambda c: c.moe_act is not None and c.moe_act not in ACT2GLU),
    ("short_conv_l", lambda c: c.short_conv_l > 0),
    ("norm_type", lambda c: c.norm_type != "rmsnorm"),
    ("norm_bias", lambda c: c.norm_bias),
    ("mlp_gated", lambda c: not c.mlp_gated),
    ("hidden_act", lambda c: c.hidden_act not in ACT2GLU),
    ("gated_attention", lambda c: c.gated_attention),
    ("qk_norm", lambda c: c.qk_norm not in (False, True)),
    ("rope_interleaved", lambda c: c.rope_interleaved),
    ("rope_layers", lambda c: c.rope_layers is not None),
    ("attn_temperature_tuning", lambda c: c.attn_temperature_tuning),
    ("mrope_section", lambda c: c.mrope_section is not None),
    ("parallel_residual", lambda c: c.parallel_residual),
    ("post_norm_only", lambda c: c.post_norm_only),
    ("attention_chunk_size", lambda c: c.attention_chunk_size is not None),
    ("causal", lambda c: not c.causal),
    ("layer_pattern", lambda c: any(
        k not in ("global", "sliding") for k in (c.layer_pattern or ()))),
)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError if ``cfg`` needs a path not ported yet."""
    for knob, test in _UNPORTED:
        if test(cfg):
            raise NotImplementedError(
                f"unsloth_tpu_torch: ModelConfig.{knob} "
                f"({cfg.model_type!r}) is not ported yet; only the "
                "llama-family decoder is, dense or with softmax-top-k MoE "
                "layers")


def _norm(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(x, w, cfg.rms_norm_eps, cfg.gemma_norm)


def _proj(x: torch.Tensor, layer_p, lora_p, name: str) -> torch.Tensor:
    lora = lora_p.get(name) if lora_p else None
    return lora_matmul(x, layer_p[name], lora=lora,
                       bias=layer_p.get(f"{name}_bias"))


def mlp_block(x: torch.Tensor, layer_p, lora_p, cfg: ModelConfig,
              layer_idx: int) -> torch.Tensor:
    """Dense gated MLP, down(act(gate(x)) * up(x)), or the layer's MoE
    block."""
    if cfg.layer_is_moe(layer_idx) and "experts" in layer_p:
        return moe_block(x, layer_p, cfg)
    glu = glu_for(cfg.hidden_act)
    e = _proj(x, layer_p, lora_p, "gate")
    g = _proj(x, layer_p, lora_p, "up")
    return _proj(glu(e, g), layer_p, lora_p, "down")


def moe_block(x: torch.Tensor, layer_p, cfg: ModelConfig) -> torch.Tensor:
    """Token-choice top-k MoE on x [..., D]: router logits in fp32 (plus
    the router bias), then ``ops.moe.moe_mlp`` (the grouped route: the
    NF4 expert kernels K14/K15 on a CUDA tensor)."""
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    router_logits = xf.to(torch.float32) @ layer_p["router"].to(
        torch.float32).t()
    if layer_p.get("router_bias") is not None:
        router_logits = router_logits + layer_p["router_bias"].to(
            torch.float32)
    out = moe_mlp(xf, router_logits, layer_p["experts"],
                  cfg.num_experts_per_tok, cfg.moe_act or cfg.hidden_act,
                  cfg.norm_topk_prob, routing=cfg.moe_routing)
    return out.reshape(x.shape)


def _rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    """cos/sin fp32 [B, T, rot/2] for positions [B, T], plus the local
    (sliding-layer) tables when the config has a second rope theta."""
    rotary_dim = int(cfg.head_dim * cfg.partial_rotary_factor)
    inv = rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                        rotary_dim=rotary_dim)
    cos, sin = rope_table(positions, inv,
                          yarn_attention_factor(cfg.rope_scaling))
    cos_local: Optional[torch.Tensor] = None
    sin_local: Optional[torch.Tensor] = None
    if cfg.rope_local_theta is not None:
        inv_l = rope_inv_freq(cfg.head_dim, cfg.rope_local_theta, None,
                              rotary_dim=rotary_dim)
        cos_local, sin_local = rope_table(positions, inv_l)
    return cos, sin, cos_local, sin_local


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

def attention_block(x: torch.Tensor, layer_p, lora_p, cfg: ModelConfig,
                    layer_idx: int, cos, sin, cos_local, sin_local,
                    segment_ids: Optional[torch.Tensor],
                    positions: Optional[torch.Tensor]) -> torch.Tensor:
    """q/k/v projections, qk-norm, RoPE, attention (ops/attention.py
    dispatch) and the o projection."""
    b, t, _ = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _proj(x, layer_p, lora_p, "q").reshape(b, t, hq, dh)
    k = _proj(x, layer_p, lora_p, "k").reshape(b, t, hkv, dh)
    v = _proj(x, layer_p, lora_p, "v").reshape(b, t, hkv, dh)
    if cfg.qk_norm is True:
        q = rms_norm(q, layer_p["q_norm"], cfg.rms_norm_eps, cfg.gemma_norm)
        k = rms_norm(k, layer_p["k_norm"], cfg.rms_norm_eps, cfg.gemma_norm)
    kind = cfg.layer_kind(layer_idx)
    if cfg.layer_uses_rope(layer_idx):
        if kind == "sliding" and cos_local is not None:
            q, k = apply_rope_qk(q, k, cos_local, sin_local)
        else:
            q, k = apply_rope_qk(q, k, cos, sin)
    out = attention(q, k, v, causal=cfg.causal, segment_ids=segment_ids,
                    window=cfg.sliding_window if kind == "sliding" else None,
                    softcap=cfg.attn_softcap, scale=cfg.attn_logit_scale,
                    positions=positions, sinks=layer_p.get("sinks"))
    return _proj(out.reshape(b, t, hq * dh), layer_p, lora_p, "o")


def decoder_layer(x: torch.Tensor, layer_p, lora_p, cfg: ModelConfig,
                  layer_idx: int, cos, sin, cos_local, sin_local,
                  segment_ids: Optional[torch.Tensor],
                  positions: Optional[torch.Tensor]) -> torch.Tensor:
    """Pre-norm residual block: x + attn(norm(x)), then + mlp(norm(x))
    (with Gemma-2/3's extra post norms where the layer has them)."""
    h = _norm(x, layer_p["input_norm"], cfg)
    attn = attention_block(h, layer_p, lora_p, cfg, layer_idx, cos, sin,
                           cos_local, sin_local, segment_ids, positions)
    if cfg.use_post_norms and "post_attn_out_norm" in layer_p:
        attn = _norm(attn, layer_p["post_attn_out_norm"], cfg)
    rm = cfg.residual_multiplier
    x = x + (attn * rm if rm is not None else attn)
    if cfg.use_post_norms and "pre_ffw_norm" in layer_p:
        h = _norm(x, layer_p["pre_ffw_norm"], cfg)
    else:
        h = _norm(x, layer_p["post_attn_norm"], cfg)
    mlp = mlp_block(h, layer_p, lora_p, cfg, layer_idx)
    if cfg.use_post_norms and "post_ffw_norm" in layer_p:
        mlp = _norm(mlp, layer_p["post_ffw_norm"], cfg)
    return x + (mlp * rm if rm is not None else mlp)


_REMAT = (False, True, "layer", "offload")


def forward(params: Dict[str, Any], lora: Optional[Dict[str, Any]],
            input_ids: torch.Tensor, cfg: ModelConfig, *,
            positions: Optional[torch.Tensor] = None,
            segment_ids: Optional[torch.Tensor] = None,
            remat: Any = True) -> torch.Tensor:
    """Run the decoder stack on input_ids [B, T]; returns the final-norm
    hidden states [B, T, D].

    remat:
      False          no rematerialization;
      True, "layer"  per-layer ``torch.utils.checkpoint`` (non-reentrant):
                     only each layer's input survives the forward, the
                     rest is recomputed in the backward;
      "offload"      the same, with each layer's input saved to pinned
                     host memory (``save_on_cpu``) and brought back for
                     its recompute: the port's form of the JAX package's
                     offload policy and of the reference's "unsloth"
                     gradient checkpointing.
    Everything else the layers read (rope tables, segment ids, weights)
    is shared and stays where it is."""
    if remat not in _REMAT:
        raise ValueError(f"forward: remat={remat!r}; expected one of "
                         f"{_REMAT}")
    check_supported(cfg)
    b, t = input_ids.shape
    if positions is None:
        positions = torch.arange(t, device=input_ids.device)[None].expand(b, t)
    embed_w = (lora or {}).get("embed")
    if embed_w is None:
        embed_w = params["embed"]
    x = F.embedding(input_ids, embed_w)
    if cfg.embed_scale is not None:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype, device=x.device)
    cos, sin, cos_local, sin_local = _rope_tables(cfg, positions)
    lora_layers = (lora or {}).get("layers")
    for i, layer_p in enumerate(params["layers"]):
        layer = functools.partial(
            decoder_layer, layer_p=layer_p,
            lora_p=lora_layers[i] if lora_layers else None, cfg=cfg,
            layer_idx=i, cos=cos, sin=sin, cos_local=cos_local,
            sin_local=sin_local, segment_ids=segment_ids,
            positions=positions)
        if remat == "offload":
            with torch.autograd.graph.save_on_cpu(pin_memory=x.is_cuda):
                x = checkpoint(layer, x, use_reentrant=False,
                               preserve_rng_state=False)
        elif remat:
            x = checkpoint(layer, x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = layer(x)
    return _norm(x, params["final_norm"], cfg)


def _head_weight(params, lora):
    """(head weight [V, D] (dense or NF4), trainable?): a trainable head or
    embed in the LoRA tree shadows the frozen one; tied models use embed."""
    for tree, name, trainable in ((lora or {}, "lm_head", True),
                                  (params, "lm_head", False),
                                  (lora or {}, "embed", True),
                                  (params, "embed", False)):
        w = tree.get(name)
        if w is not None:
            return w, trainable
    raise KeyError("params has neither lm_head nor embed")


def logits_fn(params, lora, input_ids, cfg: ModelConfig,
              **kw) -> torch.Tensor:
    """Full logits [B, T, V] (inference / small-batch path)."""
    h = forward(params, lora, input_ids, cfg, **kw)
    w, _ = _head_weight(params, None)
    logits = base_matmul(h, w)
    if cfg.logit_scale is not None:
        logits = logits * cfg.logit_scale
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def loss_fn(params: Dict[str, Any], lora: Optional[Dict[str, Any]],
            batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            n_items: Optional[torch.Tensor] = None,
            lm_head_trainable: bool = False, fused_ce: Any = "auto",
            chunk_size: Optional[int] = None,
            remat: Any = True) -> torch.Tensor:
    """SFT loss. batch: input_ids [B, T], labels [B, T] (-100 = ignore),
    optional positions / segment_ids. Labels are shifted here (next-token
    prediction); the sum of token losses is divided by ``n_items`` when
    given (the global count under gradient accumulation), else by this
    batch's valid-token count."""
    h = forward(params, lora, batch["input_ids"], cfg,
                positions=batch.get("positions"),
                segment_ids=batch.get("segment_ids"), remat=remat)
    return _loss_from_hidden(params, lora, h, batch["labels"], cfg,
                             n_items=n_items,
                             lm_head_trainable=lm_head_trainable,
                             fused_ce=fused_ce, chunk_size=chunk_size)


#: share of device memory the full-logits CE may plan for: the JAX
#: package's 13.5 GB budget on its 16 GiB chip (27/32)
CE_MEMORY_SHARE = 27 / 32


def fused_ce_gate(n_rows: int, vocab: int, param_bytes: int, num_layers: int,
                  hidden: int, total_memory: int) -> bool:
    """The ``fused_ce="auto"`` gate on a card with ``total_memory`` bytes:
    True for the chunked fused CE, False for the full logits.

    The JAX gate's form (unsloth_tpu/models/decoder.py:_loss_from_hidden):
    full logits when their fp32 bytes are at most 1.5 GiB, else full only
    while the weights, one bf16 layer boundary per layer (per-layer
    checkpointing) and two fp32 logits buffers fit the budget, which is
    the same share of the card's memory that the JAX package allots on its
    chip."""
    logits_bytes = n_rows * vocab * 4
    if logits_bytes <= 1536 * 1024 * 1024:
        return False
    resid_bytes = num_layers * n_rows * hidden * 2
    return (param_bytes + resid_bytes + 2 * logits_bytes
            > CE_MEMORY_SHARE * total_memory)


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor in a param tree (NF4 weights, stacked NF4
    experts among them, by their packed codes and scales), as the JAX gate
    sums the tree's leaves."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, NF4Tensor):
        return sum(tree_bytes(t) for t in (tree.packed, tree.absmax,
                                           tree.absmax_scale,
                                           tree.absmax_offset))
    if isinstance(tree, NF4Stacked):
        return tree_bytes(tree.packed) + tree_bytes(tree.absmax)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _resolve_fused_ce(params, h2d: torch.Tensor, cfg: ModelConfig) -> bool:
    """``fused_ce="auto"``: on a CUDA tensor :func:`fused_ce_gate` with the
    card's memory; off CUDA the JAX package's gate as it runs off the TPU,
    where its budget has no limit: always the full logits."""
    if not h2d.is_cuda:
        return False
    return fused_ce_gate(
        h2d.shape[0], cfg.vocab_size, tree_bytes(params), cfg.num_layers,
        h2d.shape[1], torch.cuda.get_device_properties(h2d.device).total_memory)


def _loss_from_hidden(params, lora, h: torch.Tensor, labels: torch.Tensor,
                      cfg: ModelConfig, *,
                      n_items: Optional[torch.Tensor] = None,
                      lm_head_trainable: bool = False,
                      fused_ce: Any = "auto",
                      chunk_size: Optional[int] = None) -> torch.Tensor:
    """Shift + lm_head + CE from final hidden states [B, T, D]."""
    d = h.shape[-1]
    h2d = h[:, :-1].reshape(-1, d)
    lb = labels[:, 1:].reshape(-1)
    if fused_ce == "auto":
        fused_ce = _resolve_fused_ce(params, h2d, cfg)
    w, trainable = _head_weight(params, lora)
    lm_head_trainable = lm_head_trainable or trainable
    if chunk_size is None:
        # fewer, larger chunks, as long as one chunk's fp32 logits stay
        # near 2 GiB (the JAX package's choice)
        per_row = cfg.vocab_size * 4
        chunk_size = max(1024, min(h2d.shape[0],
                                   (2 << 30) // per_row // 1024 * 1024))
    if fused_ce:
        wd = dequantize_nf4(w, dtype=h.dtype) if isinstance(w, NF4Tensor) \
            else w.to(h.dtype)
        return fused_ce_loss_mean(
            h2d, wd.t(), lb, n_items=n_items, softcap=cfg.final_softcap,
            logit_scale=cfg.logit_scale, chunk_size=chunk_size,
            w_trainable=lm_head_trainable)
    logits = base_matmul(h2d, w)
    return fast_cross_entropy_loss(logits, lb, n_items=n_items,
                                   softcap=cfg.final_softcap,
                                   logit_scale=cfg.logit_scale)
