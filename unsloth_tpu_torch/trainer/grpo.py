"""GRPO trainer (Group Relative Policy Optimization), in PyTorch.

Counterpart of unsloth_tpu/trainer/grpo.py, with its surface and math:

* rollouts through the port's ``generate`` with
  ``num_return_sequences=num_generations``: each prompt is prefilled once
  and its cache fans out to G decode streams;
* the reference policy is the frozen base with the LoRA tree left out
  (``lora=None``), run under ``torch.no_grad`` when ``beta > 0``;
* log-probabilities from the final hidden states through the chunked
  :func:`selective_log_softmax` (the logits are never held whole), under
  ``forward(..., remat=True)``;
* the loss: the token-level clipped surrogate with group-normalized
  advantages and the k3 KL penalty (TRL GRPO semantics), with the loss
  types grpo / bnpo / dr_grpo and GSPO's importance-sampling levels
  token / sequence / sequence_token;
* three batch layouts, built with numpy on the host and moved to the
  model's device once a round: one right-padded row a sequence
  (:class:`GRPOBatch`), sequences packed into rows with segment ids
  (:class:`PackedGRPOBatch`), and the shared-prefix layout
  (:class:`GroupedGRPOBatch`, ``prefix_grouping=True``): one row a prompt
  group, [P prompt slots | G completion regions of L slots], attended
  under ``ops.attention.prefix_attention``, which on the card launches
  the prefix form of the splash kernels (K18), so the prompt's forward
  and backward run once for its G completions.

Divergences by design: the loop runs eagerly on the host (JAX jits the
step); the LoRA tensors are updated in place by :class:`ClippedAdamW`.
Meshes are not ported: the port's model carries none.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..inference.generate import SamplingParams, generate
from ..models.decoder import forward
from ..ops.attention import prefix_attention
from ..ops.fused_ce_linear import selective_log_softmax
from ..ops.nf4 import NF4Tensor, dequantize_nf4
from ..utils.logging import MetricsLogger
from .sft import SFTConfig, TrainOutput, build_optimizer, lora_leaves


@dataclasses.dataclass
class GRPOConfig(SFTConfig):
    """TRL-GRPOConfig-compatible surface (the JAX package's subset)."""

    num_generations: int = 4
    max_prompt_length: int = 256
    max_completion_length: int = 128
    beta: float = 0.04                 # KL coefficient (0 => no ref policy)
    epsilon: float = 0.2               # PPO clip
    epsilon_high: Optional[float] = None
    temperature: float = 0.9
    top_p: float = 1.0
    top_k: int = 0
    num_iterations: int = 1            # policy epochs per generation round
    scale_rewards: bool = True         # divide advantages by group std
    loss_type: str = "grpo"            # grpo | bnpo | dr_grpo
    # "token": vanilla GRPO; "sequence": one clipped sequence-level ratio
    # exp(mean_t(logp - old)); "sequence_token" (GSPO-token): the detached
    # sequence ratio as a per-token coefficient. Sequence levels force the
    # unpacked layout.
    importance_sampling_level: str = "token"
    mask_truncated_completions: bool = False
    # pack prompt+completion sequences into full rows via segment ids
    packing: Any = False
    # one row a prompt group: the shared prompt attended once
    prefix_grouping: bool = False


def _device_tensors(device, **arrays) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


@dataclasses.dataclass
class GRPOBatch:
    """One optimization round, one right-padded row a sequence."""

    input_ids: torch.Tensor        # [N, T] prompt+completion
    completion_mask: torch.Tensor  # [N, T] 1 on scored completion tokens
    logp_targets: torch.Tensor     # [N, T] next-token ids (-100 outside)
    advantages: torch.Tensor       # [N]


@dataclasses.dataclass
class PackedGRPOBatch:
    """Sequence-packed round: several prompt+completion sequences a row
    (segment ids, per-segment positions), the advantage and the loss
    weight broadcast to each token."""

    input_ids: torch.Tensor      # [R, T]
    segment_ids: torch.Tensor    # [R, T] (0 = padding)
    positions: torch.Tensor      # [R, T]
    logp_targets: torch.Tensor   # [R, T] (-100 outside completions)
    adv_tok: torch.Tensor        # [R, T] advantage per completion token
    w_tok: torch.Tensor          # [R, T] loss weight per completion token


@dataclasses.dataclass
class GroupedGRPOBatch:
    """Shared-prefix round: one row a prompt group, [P prompt slots
    (right-aligned) | G completion regions of L slots]; ``layout`` is the
    plain tuple (P, G, L)."""

    input_ids: torch.Tensor      # [n_g, T]
    segment_ids: torch.Tensor    # [n_g, T] (1 real, 0 padding)
    positions: torch.Tensor      # [n_g, T] rope positions
    logp_targets: torch.Tensor   # [n_g, T] next-token ids (-100 outside)
    first_targets: torch.Tensor  # [n_g, G] first completion tokens
    adv_tok: torch.Tensor        # [n_g, T]
    w_tok: torch.Tensor          # [n_g, T]
    first_adv: torch.Tensor      # [n_g, G]
    first_w: torch.Tensor        # [n_g, G]
    layout: Tuple[int, int, int] = (0, 0, 0)


def _lm_head_and_scale(params, cfg, dtype, temperature):
    """(head [D, V] in ``dtype``, logit scale or None): the frozen head (or
    the tied embedding), dequantized when NF4, and 1 / temperature times
    the config's logit scale."""
    w = params.get("lm_head")
    if w is None:
        w = params["embed"]
    if isinstance(w, NF4Tensor):
        wd = dequantize_nf4(w, dtype).t()
    else:
        wd = w.t().to(dtype)
    scale = (1.0 / temperature) if temperature != 1.0 else None
    if cfg.logit_scale is not None:
        scale = (scale or 1.0) * cfg.logit_scale
    return wd, scale


def grpo_per_token_logps(params, lora, input_ids, targets, cfg,
                         chunk_size=2048, temperature=1.0,
                         positions=None, segment_ids=None):
    """log p(targets) at each position [B, T] (targets -100 give 0), from
    the hidden states through the chunked selective log-softmax;
    positions / segment_ids give the packed layout."""
    h = forward(params, lora, input_ids, cfg, remat=True,
                positions=positions, segment_ids=segment_ids)
    b, t, d = h.shape
    wd, scale = _lm_head_and_scale(params, cfg, h.dtype, temperature)
    logps = selective_log_softmax(
        h.reshape(-1, d), wd, targets.reshape(-1),
        softcap=cfg.final_softcap, logit_scale=scale, chunk_size=chunk_size)
    return logps.reshape(b, t)


def grpo_grouped_logps(params, lora, batch: GroupedGRPOBatch, cfg,
                       chunk_size=2048, temperature=1.0):
    """(logps [n_g, T], first_logps [n_g, G]) of the shared-prefix layout:
    within a completion slot s predicts slot s + 1, and each completion's
    first token is predicted from the prompt's last hidden state
    h[:, P - 1] (one hidden state, G targets)."""
    P, G, L = batch.layout
    with prefix_attention((P, G, L)):
        h = forward(params, lora, batch.input_ids, cfg, remat=True,
                    positions=batch.positions,
                    segment_ids=batch.segment_ids)
    b, t, d = h.shape
    wd, scale = _lm_head_and_scale(params, cfg, h.dtype, temperature)
    logps = selective_log_softmax(
        h.reshape(-1, d), wd, batch.logp_targets.reshape(-1),
        softcap=cfg.final_softcap, logit_scale=scale,
        chunk_size=chunk_size).reshape(b, t)
    h_first = h[:, P - 1, :].repeat_interleave(G, dim=0)     # [b*G, d]
    first_logps = selective_log_softmax(
        h_first, wd, batch.first_targets.reshape(-1),
        softcap=cfg.final_softcap, logit_scale=scale,
        chunk_size=chunk_size).reshape(b, G)
    return logps, first_logps


def _grpo_token_term(lp, old, ref, adv, w, *, beta, eps_low, eps_high):
    """Weighted clipped-surrogate (+ k3 KL) sum, shared by the packed and
    grouped losses."""
    ratio = torch.exp(lp - old)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - eps_low, 1.0 + eps_high) * adv
    per_token = -torch.minimum(unclipped, clipped)
    if beta > 0.0 and ref is not None:
        delta = ref - lp
        per_token = per_token + beta * (torch.exp(delta) - delta - 1.0)
    return torch.sum(per_token * w)


def grpo_loss_grouped(policy, old, ref, batch: GroupedGRPOBatch, *,
                      beta: float, epsilon: float,
                      epsilon_high: Optional[float] = None):
    """Grouped-layout loss: the packed weighted sum over the in-row logps
    and over the first-token logps."""
    eps_high = epsilon_high if epsilon_high is not None else epsilon
    lp, flp = policy
    olp, oflp = old
    rlp, rflp = ref if ref is not None else (None, None)
    return (_grpo_token_term(lp, olp, rlp, batch.adv_tok, batch.w_tok,
                             beta=beta, eps_low=epsilon, eps_high=eps_high)
            + _grpo_token_term(flp, oflp, rflp, batch.first_adv,
                               batch.first_w, beta=beta, eps_low=epsilon,
                               eps_high=eps_high))


def grpo_loss_packed(policy_logps, old_logps, ref_logps,
                     batch: PackedGRPOBatch, *, beta: float, epsilon: float,
                     epsilon_high: Optional[float] = None):
    """Packed-layout loss: grpo_loss's math with the per-sequence
    normalization folded into ``batch.w_tok`` at build time (grpo:
    1/(len_i*N); bnpo: 1/total_tokens; dr_grpo: 1/(N*max_len))."""
    eps_high = epsilon_high if epsilon_high is not None else epsilon
    return _grpo_token_term(policy_logps, old_logps, ref_logps,
                            batch.adv_tok, batch.w_tok, beta=beta,
                            eps_low=epsilon, eps_high=eps_high)


def grpo_loss(policy_logps, old_logps, ref_logps, advantages,
              completion_mask, *, beta: float, epsilon: float,
              epsilon_high: Optional[float] = None,
              loss_type: str = "grpo",
              max_completion_length: int = 0,
              importance_sampling_level: str = "token"):
    """Token-level clipped surrogate + k3 KL (TRL GRPO semantics).
    policy / old / ref logps [N, T]; advantages [N]; mask [N, T].

    importance_sampling_level: "token" uses per-token ratios; "sequence"
    one length-normalized sequence ratio exp(mean_t(logp - old));
    "sequence_token" the detached sequence ratio times per-token policy
    terms exp(logp - sg(logp)), so token gradients flow through a
    sequence-level clip."""
    eps_low = epsilon
    eps_high = epsilon_high if epsilon_high is not None else epsilon
    log_ratio = policy_logps - old_logps
    if importance_sampling_level == "token":
        ratio = torch.exp(log_ratio)
    else:
        maskf = completion_mask.to(torch.float32)
        seq_log = torch.sum(log_ratio * maskf, -1) / torch.clamp(
            torch.sum(maskf, -1), min=1.0)                      # [N]
        if importance_sampling_level == "sequence":
            ratio = torch.exp(seq_log)[:, None]
        elif importance_sampling_level == "sequence_token":
            ratio = torch.exp(policy_logps - policy_logps.detach()
                              + seq_log.detach()[:, None])
        else:
            raise ValueError("unknown importance_sampling_level "
                             f"{importance_sampling_level!r}")
    adv = advantages[:, None]
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - eps_low, 1.0 + eps_high) * adv
    per_token = -torch.minimum(unclipped, clipped)
    if beta > 0.0 and ref_logps is not None:
        # k3 estimator: exp(ref - pi) - (ref - pi) - 1 >= 0
        delta = ref_logps - policy_logps
        per_token = per_token + beta * (torch.exp(delta) - delta - 1.0)
    mask = completion_mask.to(torch.float32)
    if loss_type == "grpo":
        seq_loss = torch.sum(per_token * mask, -1) / torch.clamp(
            torch.sum(mask, -1), min=1.0)
        return torch.mean(seq_loss)
    if loss_type == "bnpo":
        return torch.sum(per_token * mask) / torch.clamp(torch.sum(mask),
                                                         min=1.0)
    if loss_type == "dr_grpo":
        n = mask.shape[0] * max(max_completion_length, 1)
        return torch.sum(per_token * mask) / n
    raise ValueError(f"unknown loss_type {loss_type!r}")


def group_advantages(rewards: np.ndarray, num_generations: int,
                     scale_rewards: bool = True) -> np.ndarray:
    """rewards [N], N = prompts * G consecutive -> centered (optionally
    std-normalized) advantages."""
    r = rewards.reshape(-1, num_generations)
    adv = r - r.mean(axis=1, keepdims=True)
    if scale_rewards:
        adv = adv / (r.std(axis=1, keepdims=True) + 1e-4)
    return adv.reshape(-1).astype(np.float32)


def _completion(c, args, eos):
    """(completion with EOS appended when it stopped short, truncated?)."""
    c = list(c)
    truncated = len(c) >= args.max_completion_length and (
        eos is None or (len(c) > 0 and c[-1] != eos))
    if eos is not None and len(c) < args.max_completion_length:
        c = c + [eos]
    return c, truncated


def _token_weight(args, length, n_seq, total_comp):
    """The loss weight of each scored token of one sequence."""
    if args.loss_type == "grpo":
        return 1.0 / (length * n_seq)
    if args.loss_type == "bnpo":
        return 1.0 / total_comp
    return 1.0 / (n_seq * max(args.max_completion_length, 1))


class GRPOTrainer:
    """GRPOTrainer(model=..., reward_funcs=[...], args=GRPOConfig(...),
    train_dataset=..., processing_class=tokenizer)."""

    def __init__(self, model, reward_funcs: Sequence[Callable],
                 args: Optional[GRPOConfig] = None, train_dataset=None,
                 processing_class=None, **kwargs):
        self.model = model
        self.reward_funcs = (list(reward_funcs)
                             if isinstance(reward_funcs, (list, tuple))
                             else [reward_funcs])
        self.args = args or GRPOConfig()
        self.train_dataset = train_dataset
        self.tokenizer = processing_class or getattr(model, "tokenizer", None)
        self.state_log: List[Dict[str, Any]] = []
        self.metrics_logger = MetricsLogger(
            output_dir=self.args.output_dir, report_to=self.args.report_to,
            callbacks=kwargs.get("callbacks", ()))

    # -- data ------------------------------------------------------------

    def _prompt_text(self, ex) -> str:
        if "prompt" in ex:
            p = ex["prompt"]
            if isinstance(p, str):
                return p
            return self.tokenizer.apply_chat_template(
                p, tokenize=False, add_generation_prompt=True)
        raise ValueError("GRPO dataset examples need a 'prompt' field")

    def _eos(self):
        return self.tokenizer.eos_token_id if self.tokenizer else None

    # -- rollout ---------------------------------------------------------

    def _generate_batch(self, prompts: List[str]):
        """(prompt ids, completion ids), G completions a prompt, grouped
        consecutively: each prompt prefilled once, G decode streams."""
        args = self.args
        g = args.num_generations
        encoded = [self.tokenizer(p)["input_ids"][-args.max_prompt_length:]
                   for p in prompts]
        self._round = getattr(self, "_round", 0) + 1
        sp = SamplingParams(
            max_tokens=args.max_completion_length,
            temperature=args.temperature, top_p=args.top_p,
            top_k=args.top_k,
            seed=(args.seed * 1000003 + self._round) % (2**31))
        completions = generate(self.model, encoded, sp,
                               return_token_ids=True,
                               num_return_sequences=g)
        expanded = [p for p in encoded for _ in range(g)]
        return expanded, completions

    def _build_batch(self, prompt_ids, completion_ids, advantages):
        args = self.args
        t = args.max_prompt_length + args.max_completion_length
        n = len(prompt_ids)
        input_ids = np.zeros((n, t), np.int32)
        completion_mask = np.zeros((n, t), np.int32)
        targets = np.full((n, t), -100, np.int32)
        eos = self._eos()
        for i, (p, c) in enumerate(zip(prompt_ids, completion_ids)):
            c, truncated = _completion(c, args, eos)
            seq = (list(p) + c)[:t]
            input_ids[i, :len(seq)] = seq
            lo, hi = len(p), len(seq)
            # mask_truncated_completions: completions cut off by the length
            # limit contribute nothing to the loss
            if not (args.mask_truncated_completions and truncated):
                completion_mask[i, lo:hi] = 1
            targets[i, lo:hi] = seq[lo:hi]
        # the logp at slot j is that of the token at j + 1
        shifted = np.full_like(targets, -100)
        shifted[:, :-1] = targets[:, 1:]
        mask_shifted = np.zeros_like(completion_mask)
        mask_shifted[:, :-1] = completion_mask[:, 1:]
        return GRPOBatch(**_device_tensors(
            self.model.device, input_ids=input_ids,
            completion_mask=mask_shifted, logp_targets=shifted,
            advantages=np.asarray(advantages, np.float32)))

    def _build_packed_batch(self, prompt_ids, completion_ids, advantages):
        """First-fit pack prompt+completion sequences into [R, T] rows with
        segment ids; the per-token advantage and loss weight are
        precomputed, so grpo_loss_packed is a plain weighted sum."""
        args = self.args
        t = args.max_prompt_length + args.max_completion_length
        eos = self._eos()
        seqs = []
        for p, c in zip(prompt_ids, completion_ids):
            c, truncated = _completion(c, args, eos)
            seqs.append(((list(p) + c)[:t], len(p), truncated))
        n_seq = len(seqs)
        comp_lens = [max(len(s) - lp, 1) for s, lp, _ in seqs]
        total_comp = max(sum(
            0 if (args.mask_truncated_completions and tr) else cl
            for (_, _, tr), cl in zip(seqs, comp_lens)), 1)

        rows: List[List[int]] = []       # row -> its sequences
        space: List[int] = []
        for i, (seq, _, _) in enumerate(seqs):
            for r, free in enumerate(space):
                if len(seq) <= free:
                    rows[r].append(i)
                    space[r] -= len(seq)
                    break
            else:
                rows.append([i])
                space.append(t - len(seq))

        nr = -(-len(rows) // 4) * 4       # row count rounded up, as in JAX
        input_ids = np.zeros((nr, t), np.int32)
        segment_ids = np.zeros((nr, t), np.int32)
        positions = np.zeros((nr, t), np.int32)
        targets = np.full((nr, t), -100, np.int32)
        adv_tok = np.zeros((nr, t), np.float32)
        w_tok = np.zeros((nr, t), np.float32)
        for r, members in enumerate(rows):
            off = 0
            for si, i in enumerate(members, 1):
                seq, lp, truncated = seqs[i]
                ln = len(seq)
                input_ids[r, off:off + ln] = seq
                segment_ids[r, off:off + ln] = si
                positions[r, off:off + ln] = np.arange(ln)
                # the logp at slot j predicts token j + 1 (same segment)
                lo, hi = off + lp - 1, off + ln - 1
                targets[r, lo:hi] = seq[lp:]
                if not (args.mask_truncated_completions and truncated):
                    adv_tok[r, lo:hi] = advantages[i]
                    w_tok[r, lo:hi] = _token_weight(args, ln - lp, n_seq,
                                                    total_comp)
                off += ln
        return PackedGRPOBatch(**_device_tensors(
            self.model.device, input_ids=input_ids, segment_ids=segment_ids,
            positions=positions, logp_targets=targets, adv_tok=adv_tok,
            w_tok=w_tok))

    def _build_grouped_batch(self, prompt_ids, completion_ids, advantages):
        """The shared-prefix layout: one row a prompt group, [P prompt slots,
        right-aligned | G regions of L slots, one a completion]; the
        prompt's tokens exist once a group, so its forward and backward
        are not repeated for each generation."""
        args = self.args
        G = args.num_generations
        P = -(-args.max_prompt_length // 128) * 128
        L = -(-(args.max_completion_length + 1) // 128) * 128
        T = P + G * L
        eos = self._eos()
        n_groups = len(prompt_ids) // G
        n_seq = len(prompt_ids)

        input_ids = np.zeros((n_groups, T), np.int32)
        segment_ids = np.zeros((n_groups, T), np.int32)
        positions = np.zeros((n_groups, T), np.int32)
        targets = np.full((n_groups, T), -100, np.int32)
        first_targets = np.zeros((n_groups, G), np.int32)
        adv_tok = np.zeros((n_groups, T), np.float32)
        w_tok = np.zeros((n_groups, T), np.float32)
        first_adv = np.zeros((n_groups, G), np.float32)
        first_w = np.zeros((n_groups, G), np.float32)

        comp_rows = []
        total_comp = 0                   # bnpo's normalization
        for c in completion_ids:
            c, truncated = _completion(c, args, eos)
            c = c[:L]
            comp_rows.append((c, truncated))
            if c and not (args.mask_truncated_completions and truncated):
                total_comp += len(c)
        total_comp = max(total_comp, 1)

        for g in range(n_groups):
            p = list(prompt_ids[g * G])[-P:]
            lp = len(p)
            input_ids[g, P - lp:P] = p
            segment_ids[g, P - lp:P] = 1
            positions[g, P - lp:P] = np.arange(lp)
            for j in range(G):
                idx = g * G + j
                c, truncated = comp_rows[idx]
                lc = len(c)
                if lc == 0:
                    continue
                lo = P + j * L
                input_ids[g, lo:lo + lc] = c
                segment_ids[g, lo:lo + lc] = 1
                positions[g, lo:lo + lc] = lp + np.arange(lc)
                # slot s (holding c[i]) predicts c[i + 1]
                targets[g, lo:lo + lc - 1] = c[1:]
                first_targets[g, j] = c[0]
                if args.mask_truncated_completions and truncated:
                    continue
                w = _token_weight(args, lc, n_seq, total_comp)
                adv_tok[g, lo:lo + lc - 1] = advantages[idx]
                w_tok[g, lo:lo + lc - 1] = w
                first_adv[g, j] = advantages[idx]
                first_w[g, j] = w
        return GroupedGRPOBatch(**_device_tensors(
            self.model.device, input_ids=input_ids, segment_ids=segment_ids,
            positions=positions, logp_targets=targets,
            first_targets=first_targets, adv_tok=adv_tok, w_tok=w_tok,
            first_adv=first_adv, first_w=first_w), layout=(P, G, L))

    def _compute_rewards(self, prompts, completions_text, examples):
        g = self.args.num_generations
        expanded_prompts = [p for p in prompts for _ in range(g)]
        kwargs: Dict[str, List] = {}
        for key in examples[0].keys():
            if key == "prompt":
                continue
            kwargs[key] = [ex[key] for ex in examples for _ in range(g)]
        total = np.zeros(len(completions_text), np.float64)
        per_func = {}
        for fn in self.reward_funcs:
            out = fn(prompts=expanded_prompts, completions=completions_text,
                     **kwargs)
            arr = np.asarray([0.0 if r is None else float(r) for r in out])
            per_func[getattr(fn, "__name__", "reward")] = float(arr.mean())
            total += arr
        return total, per_func

    # -- training --------------------------------------------------------

    def _advantages(self, rewards: np.ndarray) -> np.ndarray:
        """Group-normalized advantages (RLOOTrainer: leave-one-out)."""
        return group_advantages(rewards, self.args.num_generations,
                                self.args.scale_rewards)

    def _logps(self, batch, lora):
        """The policy's log-probabilities on ``batch`` with ``lora`` (None:
        the frozen base): a pair for the grouped layout."""
        args, model = self.args, self.model
        if isinstance(batch, GroupedGRPOBatch):
            return grpo_grouped_logps(model.params, lora, batch, model.cfg,
                                      temperature=args.temperature)
        packed = isinstance(batch, PackedGRPOBatch)
        return grpo_per_token_logps(
            model.params, lora, batch.input_ids, batch.logp_targets,
            model.cfg, temperature=args.temperature,
            positions=batch.positions if packed else None,
            segment_ids=batch.segment_ids if packed else None)

    def _loss(self, batch, old_logps, ref_logps):
        """The round's loss with the model's LoRA tree; the old policy is
        the current one, detached, when ``old_logps`` is None."""
        args = self.args
        policy = self._logps(batch, self.model.lora)
        if isinstance(batch, GroupedGRPOBatch):
            old = old_logps if old_logps is not None else tuple(
                x.detach() for x in policy)
            return grpo_loss_grouped(policy, old, ref_logps, batch,
                                     beta=args.beta, epsilon=args.epsilon,
                                     epsilon_high=args.epsilon_high)
        old = old_logps if old_logps is not None else policy.detach()
        if isinstance(batch, PackedGRPOBatch):
            return grpo_loss_packed(policy, old, ref_logps, batch,
                                    beta=args.beta, epsilon=args.epsilon,
                                    epsilon_high=args.epsilon_high)
        return grpo_loss(
            policy, old, ref_logps, batch.advantages, batch.completion_mask,
            beta=args.beta, epsilon=args.epsilon,
            epsilon_high=args.epsilon_high, loss_type=args.loss_type,
            max_completion_length=args.max_completion_length,
            importance_sampling_level=args.importance_sampling_level)

    def train(self) -> TrainOutput:
        args = self.args
        model = self.model
        if model.lora is None:
            raise NotImplementedError(
                "GRPOTrainer: full fine-tuning (no LoRA tree) is not ported "
                "yet; call get_peft_model first")
        total_steps = args.max_steps if args.max_steps > 0 else len(
            self.train_dataset)
        params = lora_leaves(model.lora)
        for p in params:
            p.requires_grad_(True)
        tx, _ = build_optimizer(args, total_steps, params)

        bsz = args.per_device_train_batch_size
        ds = list(self.train_dataset)
        t0 = time.time()
        global_step = 0
        idx = 0
        try:
            while global_step < total_steps:
                examples = [ds[(idx + j) % len(ds)] for j in range(bsz)]
                idx += bsz
                prompts = [self._prompt_text(ex) for ex in examples]
                prompt_ids, completion_ids = self._generate_batch(prompts)
                completions_text = [
                    self.tokenizer.decode(c, skip_special_tokens=True)
                    for c in completion_ids]
                rewards, per_func = self._compute_rewards(
                    prompts, completions_text, examples)
                adv = self._advantages(rewards)
                # the sequence-level ratios need per-sequence token means;
                # the packed and grouped layouts fold the normalization into
                # per-token weights, so they stay token-level only
                seq_level = args.importance_sampling_level != "token"
                if args.prefix_grouping and not seq_level:
                    batch = self._build_grouped_batch(prompt_ids,
                                                      completion_ids, adv)
                elif (args.packing and args.packing != "auto"
                      and not seq_level):
                    batch = self._build_packed_batch(prompt_ids,
                                                     completion_ids, adv)
                else:
                    batch = self._build_batch(prompt_ids, completion_ids,
                                              adv)

                ref_logps = old_logps = None
                with torch.no_grad():
                    if args.beta > 0.0:
                        # the reference policy: the frozen base, no LoRA
                        ref_logps = self._logps(batch, None)
                    if args.num_iterations > 1:
                        old_logps = self._logps(batch, model.lora)

                for _ in range(args.num_iterations):
                    loss = self._loss(batch, old_logps, ref_logps)
                    loss.backward()
                    tx.step()
                    tx.zero_grad()
                    global_step += 1
                    if global_step % args.logging_steps == 0:
                        entry = {
                            "loss": float(loss.detach()),
                            "reward": float(rewards.mean()),
                            "reward_std": float(rewards.std()),
                            "completion_length": float(np.mean(
                                [len(c) for c in completion_ids])),
                            "step": global_step,
                            **{f"rewards/{k}": v
                               for k, v in per_func.items()},
                        }
                        self.state_log.append(entry)
                        self.metrics_logger.log(entry)
                    if global_step >= total_steps:
                        break
        finally:
            for p in params:
                p.requires_grad_(False)
        elapsed = time.time() - t0
        losses = [e["loss"] for e in self.state_log]
        return TrainOutput(global_step,
                           float(np.mean(losses)) if losses else float("nan"),
                           {"train_runtime": elapsed})


def PatchFastRL(algorithm: str = "GRPO", FastLanguageModel=None):
    """Reference API shim: the trainers are native, so nothing is patched;
    returns the trainer class for the algorithm."""
    return {"GRPO": GRPOTrainer}.get(algorithm, GRPOTrainer)


# ---------------------------------------------------------------------------
# RLOO: REINFORCE with a leave-one-out baseline (TRL RLOOTrainer)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RLOOConfig(GRPOConfig):
    """TRL-RLOOConfig-compatible surface: GRPO's knobs; the advantages use
    the leave-one-out group baseline and are not std-normalized by
    default."""

    scale_rewards: bool = False


def loo_advantages(rewards: np.ndarray, num_generations: int,
                   scale_rewards: bool = False) -> np.ndarray:
    """adv_i = r_i - mean(r_j, j != i) = G/(G-1) * (r_i - mean)."""
    g = num_generations
    r = rewards.reshape(-1, g)
    adv = (r - r.mean(axis=1, keepdims=True)) * (g / max(g - 1, 1))
    if scale_rewards:
        adv = adv / (r.std(axis=1, keepdims=True) + 1e-4)
    return adv.reshape(-1).astype(np.float32)


class RLOOTrainer(GRPOTrainer):
    """GRPO's machinery with the leave-one-out advantage estimator."""

    def __init__(self, model, reward_funcs, args=None, **kwargs):
        super().__init__(model, reward_funcs, args=args or RLOOConfig(),
                         **kwargs)

    def _advantages(self, rewards: np.ndarray) -> np.ndarray:
        return loo_advantages(rewards, self.args.num_generations,
                              self.args.scale_rewards)
