"""Whisper ASR fine-tuning loop (seq2seq SFT), in PyTorch.

Counterpart of unsloth_tpu/trainer/whisper.py: :func:`prepare_whisper_batch`
(log-mel features and HF's teacher-forcing shift) and
:class:`WhisperTrainer`, which trains the LoRA tree of
``models.whisper.init_whisper_lora`` over a frozen base, or the whole
param tree (full fine-tuning) when ``lora`` is None, with the clipped
AdamW and the schedule of the SFT trainer (``trainer/sft.py``) at
optax.adamw's default betas and eps, as JAX builds its optimizer.
``gradient_accumulation_steps`` is ignored, as in JAX: one batch a step.

Divergences by design: the loop runs on the host, one step at a time with
one sync a step (JAX jits the step), and the trainable tensors are updated
in place (JAX returns a new tree).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.whisper import (log_mel_spectrogram, whisper_lora_leaves,
                              whisper_loss)
from .sft import ClippedAdamW, SFTConfig, TrainOutput, build_schedule

IGNORE = -100


def prepare_whisper_batch(examples, cfg, tokenizer=None, max_label_len=64):
    """Examples carry either precomputed {"features": [n_mels, frames]}
    or raw {"audio": {"array", "sampling_rate"}}, plus {"labels": [ids]}
    or {"text": str}. Returns numpy (features [B, n_mels, F] fp32,
    decoder_input_ids [B, T] int32, labels [B, T] int32) with HF's
    teacher-forcing shift (the decoder input starts at
    decoder_start_token_id; labels -100 past each row's end). Raw audio
    goes through :func:`log_mel_spectrogram` at its default 80 mel bins,
    as in JAX."""
    feats, label_rows = [], []
    for ex in examples:
        if "features" in ex:
            f = np.asarray(ex["features"], np.float32)
        else:
            audio = ex["audio"]
            arr = audio["array"] if isinstance(audio, dict) else audio
            f = log_mel_spectrogram(
                torch.as_tensor(np.asarray(arr, np.float32))).numpy()
        feats.append(f)
        if "labels" in ex:
            ids = list(ex["labels"])
        else:
            ids = tokenizer(ex["text"]).input_ids
        label_rows.append(ids[:max_label_len])
    frames = max(f.shape[-1] for f in feats)
    feats = np.stack([np.pad(f, ((0, 0), (0, frames - f.shape[-1])))
                      for f in feats])
    t = max(len(r) for r in label_rows)
    start = cfg.decoder_start_token_id
    dec_in = np.full((len(label_rows), t), cfg.pad_token_id, np.int32)
    labels = np.full((len(label_rows), t), IGNORE, np.int32)
    for i, row in enumerate(label_rows):
        dec_in[i, 0] = start
        dec_in[i, 1:len(row)] = row[:-1]
        labels[i, :len(row)] = row
    return feats, dec_in, labels


def _param_leaves(tree) -> List[torch.Tensor]:
    """Every tensor of a Whisper param tree, in tree order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _param_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


class WhisperTrainer:
    """Seq2seq trainer over the functional whisper model.

    Full FT by default; pass ``lora`` (from
    models.whisper.init_whisper_lora) to train adapters only: the base
    stays frozen (and can be bf16), as in the reference's Whisper LoRA
    notebook (get_peft_model on q_proj/v_proj)."""

    def __init__(self, model, tokenizer=None, train_dataset=None,
                 args: Optional[SFTConfig] = None, lora=None, **kwargs):
        self.model = model       # (params, cfg) from load_whisper
        self.tokenizer = tokenizer
        self.train_dataset = train_dataset
        self.args = args or SFTConfig()
        self.lora = lora
        self.state_log: List[Dict[str, Any]] = []
        #: wall seconds of each optimizer step, ending in a device sync
        self.step_times: List[float] = []

    def train(self) -> TrainOutput:
        args = self.args
        params, cfg = self.model
        ds = list(self.train_dataset)
        bsz = args.per_device_train_batch_size
        batches = [
            prepare_whisper_batch(ds[i:i + bsz], cfg, self.tokenizer,
                                  max_label_len=args.max_seq_length)
            for i in range(0, len(ds), bsz)
        ]
        total = args.max_steps if args.max_steps > 0 else \
            max(int(len(batches) * args.num_train_epochs), 1)
        trainable = (whisper_lora_leaves(self.lora) if self.lora is not None
                     else _param_leaves(params))
        for p in trainable:
            p.requires_grad_(True)
        # optax.adamw's own betas and eps, as the JAX trainer builds it
        tx = ClippedAdamW(trainable, build_schedule(args, total),
                          max_grad_norm=args.max_grad_norm, b1=0.9, b2=0.999,
                          eps=1e-8, weight_decay=args.weight_decay)
        device = params["decoder"]["embed"].device

        t0 = time.time()
        global_step = 0
        losses = []
        try:
            while global_step < total:
                for feats, dec_in, labels in batches:
                    if global_step >= total:
                        break
                    t_step = time.perf_counter()
                    loss = whisper_loss(
                        params, torch.from_numpy(feats).to(device),
                        torch.from_numpy(dec_in).to(device),
                        torch.from_numpy(labels).to(device), cfg,
                        lora=self.lora)
                    loss.backward()
                    tx.step()
                    tx.zero_grad()
                    global_step += 1
                    if global_step % args.logging_steps == 0:
                        entry = {"loss": float(loss.detach()),
                                 "step": global_step}
                        losses.append(entry["loss"])
                        self.state_log.append(entry)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    self.step_times.append(time.perf_counter() - t_step)
        finally:
            for p in trainable:
                p.requires_grad_(False)
        return TrainOutput(global_step,
                           float(np.mean(losses)) if losses else
                           float("nan"),
                           {"train_runtime": time.time() - t0})
