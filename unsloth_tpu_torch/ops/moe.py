"""MoE expert computation: token-choice routing and the expert MLPs.

Counterpart of unsloth_tpu/ops/moe.py. Experts are a dict of stacked
weights: gate/up [E, F, D] and down [E, D, F] (out-major, dense tensors or
:class:`~unsloth_tpu_torch.ops.nf4.NF4Stacked`), with optional per-expert
biases gate_bias/up_bias [E, F] and down_bias [E, D] (gpt-oss).

* :func:`_route` — HF routing semantics: softmax_topk (qwen3-moe, mixtral,
  gpt-oss), topk_softmax (granitemoe), llama4 and deepseek.
* :func:`moe_mlp_dense` and :func:`moe_mlp_expert_loop` — the parity
  oracles: a gather per top-k slot, and the HF-style loop over experts.
* :func:`moe_mlp_grouped` — tokens sorted by expert (one stable argsort),
  three grouped products with the bias in their epilogue, the GLU, and an
  inverse-permutation gather with the weighted sum over the k slots. NF4
  experts whose blocks align go through
  :func:`~unsloth_tpu_torch.ops.nf4_gmm.nf4_gmm` (K14, its backward K15,
  on a CUDA tensor); dense experts (the bf16 stacks that
  ``from_pretrained`` loads), and NF4 stacks whose blocks do not align
  (dequantized first, as in JAX), go through
  :func:`~unsloth_tpu_torch.ops.gmm.gmm` (K19, megablox ``gmm``, and its
  dx; under full fine-tuning, K19's tgmm for the weight gradient and a
  plain segment sum for the expert biases). Nothing is detached: the
  input, the router logits (so the router and its bias), the expert
  stacks and their biases all take gradients where they require them.
  Group sizes stay on the device: no host sync.
  The routing and permutation glue and the un-permute run under profiler
  ranges ("unsloth.moe_route_permute", "unsloth.moe_unpermute").
* :func:`moe_mlp` — chooses by ``impl``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.profiler import record_function

from .activations import glu_for
from .gmm import gmm
from .nf4 import NF4Stacked, dequantize_nf4_stacked
from .nf4_gmm import nf4_gmm, use_nf4_gmm


def _dense_experts(experts: Dict[str, torch.Tensor], dtype: torch.dtype):
    """NF4Stacked expert weights dequantized to ``dtype``; the rest as
    they are."""
    return {name: dequantize_nf4_stacked(w, dtype)
            if isinstance(w, NF4Stacked) else w
            for name, w in experts.items()}


def _route(router_logits: torch.Tensor, k: int, norm_topk_prob: bool,
           routing: str = "softmax_topk", routing_params=None):
    """(weights [N, k], selected experts [N, k]) under HF token-choice
    routing. "softmax_topk": softmax over all experts, then top-k,
    renormalized when ``norm_topk_prob``; "topk_softmax" (granitemoe):
    top-k of the raw logits, softmax over those k; "llama4": top-k of the
    raw logits, sigmoid of the selected values (the weight scales the
    expert input, in the callers); "deepseek" (DeepSeek-V3): sigmoid
    scores, selection on bias-corrected scores within the topk_group
    groups of highest top-2 sums, weights the raw scores at the chosen
    experts, normalized, times routed_scaling."""
    if routing == "llama4":
        top_vals, sel = torch.topk(router_logits, k, dim=-1)
        return torch.sigmoid(top_vals), sel
    if routing == "topk_softmax":
        top_vals, sel = torch.topk(router_logits.to(torch.float32), k,
                                   dim=-1)
        return torch.softmax(top_vals, dim=-1), sel
    if routing == "deepseek":
        p = routing_params or {}
        scores = torch.sigmoid(router_logits)
        corrected = scores + p["correction_bias"][None, :]
        n, e = scores.shape
        g = int(p.get("n_group", 1))
        per = e // g
        top2, _ = torch.topk(corrected.reshape(n, g, per), min(2, per),
                             dim=-1)
        group_scores = top2.sum(-1)                       # [n, g]
        _, gidx = torch.topk(group_scores, int(p.get("topk_group", 1)),
                             dim=-1)
        gmask = torch.zeros((n, g), dtype=corrected.dtype,
                            device=corrected.device).scatter_(1, gidx, 1.0)
        smask = gmask.repeat_interleave(per, dim=1)
        masked = torch.where(smask > 0, corrected,
                             torch.zeros((), dtype=corrected.dtype,
                                         device=corrected.device))
        _, sel = torch.topk(masked, k, dim=-1)
        weights = torch.gather(scores, 1, sel)
        if norm_topk_prob:
            weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
        return weights * float(p.get("routed_scaling", 1.0)), sel
    probs = torch.softmax(router_logits, dim=-1)
    weights, sel = torch.topk(probs, k, dim=-1)
    if norm_topk_prob:
        weights = weights / weights.sum(-1, keepdim=True)
    return weights, sel


def moe_mlp_dense(x: torch.Tensor, router_logits: torch.Tensor,
                  experts: Dict[str, torch.Tensor], num_experts_per_tok: int,
                  act: str, norm_topk_prob: bool = False,
                  routing: str = "softmax_topk", routing_params=None):
    """Reference per-slot gather (a parity oracle). x [N, D]; each slot's
    expert weights gathered per token; biases added inside each expert,
    before the routing weight."""
    k = num_experts_per_tok
    experts = _dense_experts(experts, x.dtype)
    weights, sel = _route(router_logits, k, norm_topk_prob, routing,
                          routing_params)
    glu = glu_for(act)
    scale_input = routing == "llama4"

    def bias(name, idx):
        b = experts.get(name)
        return b[idx].to(x.dtype) if b is not None else 0

    def one_slot(i):
        idx = sel[:, i]
        w_i = weights[:, i:i + 1].to(x.dtype)
        xi = x * w_i if scale_input else x
        e = torch.einsum("nd,nfd->nf", xi,
                         experts["gate"][idx].to(x.dtype)) \
            + bias("gate_bias", idx)
        g = torch.einsum("nd,nfd->nf", xi, experts["up"][idx].to(x.dtype)) \
            + bias("up_bias", idx)
        y = torch.einsum("nf,ndf->nd", glu(e, g),
                         experts["down"][idx].to(x.dtype)) \
            + bias("down_bias", idx)
        return y if scale_input else y * w_i

    return sum(one_slot(i) for i in range(k))


def moe_mlp_expert_loop(x: torch.Tensor, router_logits: torch.Tensor,
                        experts: Dict[str, torch.Tensor],
                        num_experts_per_tok: int, act: str,
                        norm_topk_prob: bool = False,
                        routing: str = "softmax_topk", routing_params=None):
    """HF-style loop over experts (a parity oracle): every expert runs a
    dense product over all tokens, masked by its routing weight."""
    dense = _dense_experts(experts, x.dtype)
    weights, sel = _route(router_logits, num_experts_per_tok,
                          norm_topk_prob, routing, routing_params)
    glu = glu_for(act)
    scale_input = routing == "llama4"

    def bias(name, e):
        b = dense.get(name)
        return b[e].to(x.dtype) if b is not None else 0

    out = torch.zeros_like(x)
    for e in range(dense["gate"].shape[0]):
        w_e = torch.where(sel == e, weights,
                          torch.zeros((), dtype=weights.dtype,
                                      device=x.device)).sum(-1)[:, None]
        w_e = w_e.to(x.dtype)
        xi = x * w_e if scale_input else x
        eh = xi @ dense["gate"][e].to(x.dtype).t() + bias("gate_bias", e)
        g = xi @ dense["up"][e].to(x.dtype).t() + bias("up_bias", e)
        y = glu(eh, g) @ dense["down"][e].to(x.dtype).t() \
            + bias("down_bias", e)
        if scale_input:
            out = out + torch.where(w_e != 0, y, torch.zeros((), dtype=y.dtype,
                                                             device=y.device))
        else:
            out = out + y * w_e
    return out


def moe_mlp_grouped(x: torch.Tensor, router_logits: torch.Tensor,
                    experts: Dict[str, torch.Tensor],
                    num_experts_per_tok: int, act: str,
                    norm_topk_prob: bool = False,
                    routing: str = "softmax_topk", routing_params=None):
    """Grouped-product implementation; same signature and semantics as
    :func:`moe_mlp_dense`."""
    n, d = x.shape
    k = num_experts_per_tok
    fused = {name: use_nf4_gmm(w) for name, w in experts.items()}
    experts = {name: w if fused[name] or not isinstance(w, NF4Stacked)
               else dequantize_nf4_stacked(w, x.dtype)
               for name, w in experts.items()}
    num_experts = experts["gate"].shape[0]
    scale_input = routing == "llama4"
    with record_function("unsloth.moe_route_permute"):
        weights, sel = _route(router_logits, k, norm_topk_prob, routing,
                              routing_params)                   # [N, k]
        flat_expert = sel.reshape(-1)                           # [N*k]
        order = torch.argsort(flat_expert, stable=True)         # [N*k]
        xs = x[order // k]                                      # [N*k, D]
        if scale_input:
            xs = xs * weights.reshape(-1)[order][:, None].to(x.dtype)
        # counts on the device (torch.bincount would sync for its length)
        group_sizes = torch.zeros(num_experts, dtype=torch.int32,
                                  device=x.device).index_add_(
            0, flat_expert, torch.ones_like(flat_expert, dtype=torch.int32))
    glu = glu_for(act)

    def gmm_(lhs, name):
        w = experts[name]
        b = experts.get(name + "_bias")
        if fused[name]:
            return nf4_gmm(lhs, w, group_sizes, bias=b).to(x.dtype)
        return gmm(lhs, w, group_sizes, b)

    e = gmm_(xs, "gate")
    g = gmm_(xs, "up")
    y = gmm_(glu(e, g), "down")

    # un-permute by gather: rows are a permutation of [N*k]
    with record_function("unsloth.moe_unpermute"):
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=order.device))
        y_flat = y[inv].reshape(n, k, d)
        if scale_input:
            return y_flat.sum(1).to(x.dtype)
        return (y_flat * weights[:, :, None].to(x.dtype)).sum(1).to(x.dtype)


_IMPLS = ("grouped", "dense", "eloop")


def moe_mlp(x: torch.Tensor, router_logits: torch.Tensor,
            experts: Dict[str, torch.Tensor], num_experts_per_tok: int,
            act: str, norm_topk_prob: bool = False, impl: str = "grouped",
            routing: str = "softmax_topk", routing_params=None):
    """The MoE MLP. impl: "grouped" (the hot path), "dense" or "eloop"
    (the parity oracles)."""
    if impl not in _IMPLS:
        raise ValueError(f"moe_mlp: impl={impl!r}; expected one of {_IMPLS}")
    fn = {"grouped": moe_mlp_grouped, "dense": moe_mlp_dense,
          "eloop": moe_mlp_expert_loop}[impl]
    return fn(x, router_logits, experts, num_experts_per_tok, act,
              norm_topk_prob, routing=routing, routing_params=routing_params)
