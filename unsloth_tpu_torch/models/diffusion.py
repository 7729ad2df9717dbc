"""FastDiffusionModel: text-diffusion (masked-diffusion) language models, in
PyTorch.

Counterpart of unsloth_tpu/models/diffusion.py: the same entry points and
schedule. The network is the llama-family decoder with bidirectional
attention (``cfg.causal=False``: every layer attends over the whole row,
through the non-causal forms of the attention kernels, K16 and K18, on
the card); training is LLaDA's masked-denoising objective (a per-sequence
mask ratio t ~ U(min_t, 1), cross entropy on the masked positions
weighted 1/t, LLaDA eq. 5); generation is confidence-ordered iterative
unmasking over a fixed canvas, the whole canvas rerun each step (no KV
cache).

The random draws come from an explicit ``torch.Generator`` on the ids'
device, where JAX takes a key: the two give different numbers from one
seed, so :func:`diffusion_loss` takes a drawn ``noise=(noised, masked,
t)`` in place of the generator, and a test feeds it JAX's draw.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.fused_ce_linear import selective_log_softmax
from ..ops.nf4 import NF4Tensor, dequantize_nf4
from .config import load_hf_config
from .decoder import forward, logits_fn
from .loader import FastLanguageModel, LanguageModel, _resolve_model_path

DIFFUSION_MODEL_TYPES = ("diffusion_gemma", "diffusion_gemma4", "llada",
                         "dream")


def is_diffusion_model_type(model_types) -> bool:
    """Whether a ``model_type`` (or any of a sequence of them) names a
    text-diffusion checkpoint."""
    if model_types is None:
        return False
    if isinstance(model_types, str):
        model_types = [model_types]
    return any(mt in DIFFUSION_MODEL_TYPES for mt in model_types)


class FastDiffusionModel:
    """Entry point for text-diffusion checkpoints (JAX's, with the port's
    ``device``)."""

    @staticmethod
    def from_pretrained(model_name: str, max_seq_length: int = 2048,
                        dtype: Optional[Any] = None,
                        load_in_4bit: bool = False,
                        full_finetuning: bool = False,
                        mask_token_id: Optional[int] = None,
                        device="cuda", **kwargs
                        ) -> Tuple[LanguageModel, Any]:
        """Load a diffusion checkpoint through
        ``FastLanguageModel.from_pretrained`` (bf16, not NF4, unless asked)
        and make it bidirectional. ``mask_token_id`` comes from the
        argument, else the config, else the tokenizer, else the last id of
        the vocabulary. An autoregressive ``model_type`` raises
        RuntimeError."""
        path = _resolve_model_path(model_name)
        hf = load_hf_config(path)
        if not is_diffusion_model_type(hf.get("model_type")):
            raise RuntimeError(
                f"FastDiffusionModel only supports diffusion model_types "
                f"{DIFFUSION_MODEL_TYPES}, got {hf.get('model_type')!r}. "
                f"Use FastLanguageModel for autoregressive models.")
        model, tok = FastLanguageModel.from_pretrained(
            path, max_seq_length=max_seq_length, dtype=dtype,
            load_in_4bit=load_in_4bit, full_finetuning=full_finetuning,
            device=device, **kwargs)
        mid = mask_token_id
        if mid is None:
            mid = hf.get("mask_token_id")
        if mid is None and tok is not None:
            mid = getattr(tok, "mask_token_id", None)
        if mid is None:
            mid = model.cfg.vocab_size - 1  # conventional fallback
        model.cfg = dataclasses.replace(model.cfg, causal=False,
                                        mask_token_id=int(mid))
        return model, tok

    get_peft_model = FastLanguageModel.get_peft_model
    for_inference = staticmethod(lambda m: m.for_inference())
    for_training = staticmethod(lambda m: m.for_training())


def diffusion_mask(generator: Optional[torch.Generator],
                   input_ids: torch.Tensor, mask_token_id: int, *,
                   prompt_mask: Optional[torch.Tensor] = None,
                   min_t: float = 1e-3):
    """LLaDA's forward process: per-sequence t ~ U(min_t, 1), each
    non-prompt token masked independently with probability t. The draws
    (t, then u) come from ``generator`` on the ids' device. Returns
    (noised ids, masked [B, T] bool, t [B] fp32)."""
    b, s = input_ids.shape
    dev = input_ids.device
    t = min_t + (1.0 - min_t) * torch.rand((b,), generator=generator,
                                           device=dev)
    u = torch.rand((b, s), generator=generator, device=dev)
    masked = u < t[:, None]
    if prompt_mask is not None:
        masked = masked & ~prompt_mask.bool()
    noised = torch.where(masked, torch.full_like(input_ids, mask_token_id),
                         input_ids)
    return noised, masked, t


def diffusion_loss(params: Dict[str, Any], lora: Optional[Dict[str, Any]],
                   batch: Dict[str, torch.Tensor], cfg,
                   generator: Optional[torch.Generator] = None, *,
                   noise: Optional[Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]] = None,
                   remat: Any = True,
                   lm_head_trainable: Optional[bool] = None) -> torch.Tensor:
    """Masked-denoising loss, E_t[(1/t) sum over masked positions of CE] /
    (B T) (LLaDA eq. 5). batch: input_ids [B, T], optional prompt_mask
    (never masked, never scored), segment_ids and positions. The mask is
    drawn by :func:`diffusion_mask` from ``generator``, or given as
    ``noise=(noised, masked, t)``. Pad positions are scored when masked,
    as in JAX. The head is the trainable copy where the LoRA tree holds
    one, else the frozen head, else the embedding; it takes a gradient
    under full fine-tuning (``lora is None``) or when trainable."""
    ids = batch["input_ids"]
    b, s = ids.shape
    if noise is None:
        noise = diffusion_mask(generator, ids, cfg.mask_token_id,
                               prompt_mask=batch.get("prompt_mask"))
    noised, masked, t = noise
    h = forward(params, lora, noised, cfg,
                segment_ids=batch.get("segment_ids"),
                positions=batch.get("positions"), remat=remat)
    if lm_head_trainable is None:
        # full fine-tuning (no lora tree) trains the head too
        lm_head_trainable = lora is None
    w = (lora or {}).get("lm_head")
    trainable = lm_head_trainable or w is not None
    if w is None:
        w = params.get("lm_head")
    if w is None:
        w2 = (lora or {}).get("embed")
        trainable = trainable or w2 is not None
        w = w2 if w2 is not None else params["embed"]
    wd = dequantize_nf4(w, h.dtype) if isinstance(w, NF4Tensor) \
        else w.to(h.dtype)
    targets = torch.where(masked, ids, torch.full_like(ids, -100))
    logps = selective_log_softmax(
        h.reshape(-1, h.shape[-1]), wd.t(), targets.reshape(-1),
        softcap=cfg.final_softcap, logit_scale=cfg.logit_scale,
        w_trainable=trainable).reshape(b, s)
    per_seq = -torch.where(masked, logps, torch.zeros_like(logps)).sum(-1) / t
    return per_seq.sum() / (b * s)


@torch.no_grad()
def diffusion_generate(model, prompt_ids: Sequence[int], *,
                       canvas_length: int = 128, steps: int = 16,
                       temperature: float = 0.0,
                       generator: Optional[torch.Generator] = None
                       ) -> List[int]:
    """Iterative unmasking (JAX's schedule): start from [prompt, MASK * rest];
    each of ``steps`` forward passes over the whole canvas predicts every
    slot (argmax, or a sample at ``temperature`` from ``generator``), and
    the still-masked slots whose confidence reaches the k-th largest
    commit, k bringing the unmasked count to n_masked * (step + 1) / steps
    (ties at the threshold commit too). Returns the canvas as ints."""
    cfg = model.cfg
    mid = cfg.mask_token_id
    dev = model.device
    prompt = [int(x) for x in prompt_ids]
    canvas = torch.full((1, canvas_length), mid, dtype=torch.long,
                        device=dev)
    canvas[0, :len(prompt)] = torch.tensor(prompt, dtype=torch.long)
    prompt_mask = torch.arange(canvas_length, device=dev) < len(prompt)
    n_masked0 = canvas_length - len(prompt)
    for step in range(steps):
        logits = logits_fn(model.params, model.lora, canvas, cfg,
                           remat=False)[0]
        if temperature > 0:
            probs_t = torch.softmax(logits.float() / temperature, dim=-1)
            choice = torch.multinomial(probs_t, 1, generator=generator)[:, 0]
        else:
            choice = torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float(), dim=-1)
        conf = probs.gather(-1, choice[:, None])[:, 0]
        still_masked = (canvas[0] == mid) & ~prompt_mask
        # linear schedule: by step k, keep (k+1)/steps of tokens unmasked
        target_unmasked = int(n_masked0 * (step + 1) / steps)
        already = int((~still_masked & ~prompt_mask).sum())
        k = max(target_unmasked - already, 0)
        if k == 0:
            continue
        conf = torch.where(still_masked, conf,
                           torch.full_like(conf, float("-inf")))
        thresh = torch.sort(conf).values[-k]
        commit = still_masked & (conf >= thresh)
        canvas = torch.where(commit[None], choice[None], canvas)
    return [int(x) for x in canvas[0].tolist()]
