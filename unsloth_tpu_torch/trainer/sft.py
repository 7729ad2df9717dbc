"""SFT trainer, in PyTorch.

Counterpart of unsloth_tpu/trainer/sft.py: the same ``SFTConfig`` surface,
first-fit packing into fixed-length rows with segment ids (on by default
for text-only causal LMs, and then the longest document declares the
attention kernel's segment bound), gradient accumulation whose micro
losses are each divided by the *global* valid-token count of the whole
accumulation group, and the update ``optax.chain(clip_by_global_norm,
adamw(schedule))`` written out by hand (:class:`ClippedAdamW`). Without
packing, each example is one row padded to ``max_seq_length`` (segment 1
real, 0 pad). ``evaluate`` gives the token-weighted loss and perplexity
over padded batches; :func:`train_on_responses_only` masks the labels
outside the responses; :func:`unsloth_train` is ``trainer.train()``.

Divergences by design: the loop runs on the host, one micro-batch at a
time (JAX scans the micro-batches inside one jitted step), and the LoRA
tensors are updated in place (JAX returns a new tree). Not ported yet,
and raising when asked for: full fine-tuning, GaLore, a separate
embedding learning rate, and checkpoint saves and resume.
Meshes and pipelines are not ported either: the port's model carries
none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.packing import (PackedBatch, batch_packed_rows, pack_sequences,
                            pad_batch, validate_segment_bound)
from ..models.decoder import loss_fn as model_loss_fn
from ..ops.attention import packed_segment_bound
from ..ops.lora import LoRAWeights
from ..utils.logging import MetricsLogger


@dataclasses.dataclass
class SFTConfig:
    """TRL-SFTConfig-compatible argument surface; unknown keyword arguments
    of :func:`make_config` land in ``extra``."""

    output_dir: str = "outputs"
    per_device_train_batch_size: int = 2
    gradient_accumulation_steps: int = 1
    learning_rate: float = 2e-4
    embedding_learning_rate: Optional[float] = None
    lr_scheduler_type: str = "linear"
    warmup_steps: int = 5
    warmup_ratio: float = 0.0
    max_steps: int = -1
    num_train_epochs: float = 1.0
    logging_steps: int = 1
    save_steps: int = 0
    seed: int = 3407
    weight_decay: float = 0.01
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    optim: str = "adamw_torch"
    packing: Any = "auto"
    max_seq_length: int = 2048
    dataset_text_field: str = "text"
    bf16: bool = True
    report_to: Any = "none"
    dataset_num_proc: Optional[int] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def max_length(self):
        return self.max_seq_length


def make_config(**kwargs) -> SFTConfig:
    """SFTConfig from keyword arguments; TRL's ``max_length`` is accepted
    for ``max_seq_length``."""
    known = {f.name for f in dataclasses.fields(SFTConfig)}
    if "max_length" in kwargs and "max_seq_length" not in kwargs:
        kwargs["max_seq_length"] = kwargs.pop("max_length")
    cfg = SFTConfig(**{k: v for k, v in kwargs.items() if k in known})
    cfg.extra.update({k: v for k, v in kwargs.items() if k not in known})
    return cfg


# ---------------------------------------------------------------------------
# schedules (optax's formulas, evaluated in Python floats)
# ---------------------------------------------------------------------------

def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    def f(step):
        frac = 1.0 - min(max(step, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _cosine(init: float, steps: int) -> Callable[[int], float]:
    def f(step):
        return init * 0.5 * (1.0 + math.cos(math.pi * min(step, steps)
                                            / steps))
    return f


def build_schedule(args: SFTConfig, total_steps: int) -> Callable[[int], float]:
    """Learning rate at an update count: optional linear warmup from 0 to
    the peak, then linear (default), cosine or constant decay, joined as
    ``optax.join_schedules`` joins them."""
    warmup = args.warmup_steps
    if args.warmup_ratio > 0 and warmup == 0:
        warmup = int(total_steps * args.warmup_ratio)
    peak = args.learning_rate
    decay_steps = max(total_steps - warmup, 1)
    if args.lr_scheduler_type == "constant":
        decay = lambda step: peak  # noqa: E731
    elif args.lr_scheduler_type == "cosine":
        decay = _cosine(peak, decay_steps)
    else:
        decay = _linear(peak, 0.0, decay_steps)
    if warmup <= 0:
        return decay
    ramp = _linear(0.0, peak, warmup)
    return lambda step: ramp(step) if step < warmup else decay(step - warmup)


class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    eps, weight_decay=wd))`` over a list of tensors, updated in place.

    One update: g_norm = sqrt(sum of all g^2); if g_norm >= max_norm every
    g becomes g / g_norm * max_norm; mu = (1-b1) g + b1 mu and
    nu = (1-b2) g^2 + b2 nu; with the count t after the update, u =
    (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd * p; p -= lr * u
    with lr = schedule(count before the update), so with warmup the first
    step's learning rate is 0. The clip is decided on the device, without
    a host sync."""

    def __init__(self, params: List[torch.Tensor],
                 schedule: Callable[[int], float], *, max_grad_norm: float,
                 b1: float, b2: float, eps: float, weight_decay: float):
        self.params = params
        self.schedule = schedule
        self.max_grad_norm = float(max_grad_norm)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> None:
        """Apply one update from the params' ``.grad``."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < self.max_grad_norm
        lr = self.schedule(self.count)
        t = self.count + 1
        c1 = 1.0 - self.b1 ** t
        c2 = 1.0 - self.b2 ** t
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = torch.where(keep, g, (g / g_norm) * self.max_grad_norm)
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)
        self.count = t

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


def lora_leaves(lora: Dict[str, Any]) -> List[torch.Tensor]:
    """The trainable tensors of a LoRA tree (each adapter's a and b), in
    tree order."""
    out = []
    for layer in lora["layers"]:
        for name in sorted(layer):
            w = layer[name]
            if isinstance(w, LoRAWeights):
                out += [w.a, w.b]
    return out


def build_optimizer(args: SFTConfig, total_steps: int,
                    params: List[torch.Tensor]):
    """(ClippedAdamW over ``params``, schedule)."""
    if "galore" in args.optim:
        raise NotImplementedError(
            f"SFTConfig.optim={args.optim!r}: GaLore is not ported yet")
    schedule = build_schedule(args, total_steps)
    tx = ClippedAdamW(params, schedule, max_grad_norm=args.max_grad_norm,
                      b1=args.adam_beta1, b2=args.adam_beta2,
                      eps=args.adam_epsilon, weight_decay=args.weight_decay)
    return tx, schedule


@dataclasses.dataclass
class TrainOutput:
    global_step: int
    training_loss: float
    metrics: Dict[str, Any]


class SFTTrainer:
    """Owns the loop. Accepts pre-tokenized examples ({"input_ids": [...],
    "labels": [...]}), raw-text examples ({args.dataset_text_field: str})
    or "messages" conversations when the tokenizer has a chat template."""

    def __init__(self, model, tokenizer=None, train_dataset=None,
                 eval_dataset=None, args: Optional[SFTConfig] = None,
                 formatting_func: Optional[Callable] = None, **kwargs):
        self.model = model
        self.tokenizer = tokenizer or getattr(model, "tokenizer", None)
        self.args = args or SFTConfig()
        self.formatting_func = formatting_func
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self._batches: Optional[List[PackedBatch]] = None
        self._segment_bound: Optional[int] = None
        #: applied to each tokenized training example
        #: (:func:`train_on_responses_only` installs one)
        self._post_tokenize_fn: Optional[Callable] = None
        self.state_log: List[Dict[str, Any]] = []
        #: wall seconds of each optimizer step, ending in a device sync
        self.step_times: List[float] = []
        self.metrics_logger = MetricsLogger(
            output_dir=self.args.output_dir, report_to=self.args.report_to,
            callbacks=kwargs.get("callbacks", ()))

    # -- data ------------------------------------------------------------

    def _tokenize_example(self, ex) -> Dict[str, List[int]]:
        if "input_ids" in ex:
            out = {"input_ids": list(ex["input_ids"])}
            if "labels" in ex:
                out["labels"] = list(ex["labels"])
            return out
        if self.formatting_func is not None:
            text = self.formatting_func(ex)
            if isinstance(text, list):
                text = text[0]
        elif "messages" in ex and self.tokenizer is not None and getattr(
                self.tokenizer, "chat_template", None):
            text = self.tokenizer.apply_chat_template(ex["messages"],
                                                      tokenize=False)
        else:
            text = ex[self.args.dataset_text_field]
        return {"input_ids":
                self.tokenizer(text, add_special_tokens=True)["input_ids"]}

    def _pad_id(self) -> int:
        if self.tokenizer is None:
            return 0
        return (getattr(self.tokenizer, "pad_token_id", None)
                or getattr(self.tokenizer, "eos_token_id", 0) or 0)

    def prepare_batches(self) -> List[PackedBatch]:
        if self._batches is not None:
            return self._batches
        args = self.args
        examples = [self._tokenize_example(ex) for ex in self.train_dataset]
        if self._post_tokenize_fn is not None:
            examples = [self._post_tokenize_fn(ex) for ex in examples]
        pad_id = self._pad_id()
        bsz = args.per_device_train_batch_size
        packing = args.packing
        if packing == "auto":
            # text-only causal LM => pack (recurrent mixers, whose state
            # would cross documents, are rejected by the decoder anyway)
            packing = type(self.model).__name__ == "LanguageModel"
        if packing:
            rows = pack_sequences(examples, args.max_seq_length, pad_id)
            self._batches = batch_packed_rows(rows, bsz, args.max_seq_length,
                                              pad_id)
            # the longest real segment any packed row can hold: routes
            # attention to the segment-block-sparse kernels
            self._segment_bound = max(
                (min(len(e["input_ids"]), args.max_seq_length)
                 for e in examples), default=None)
            if self._segment_bound:
                validate_segment_bound(self._batches, self._segment_bound)
        else:
            self._batches = [pad_batch(examples[i:i + bsz],
                                       args.max_seq_length, pad_id)
                             for i in range(0, len(examples), bsz)]
            if self._batches and self._batches[-1].input_ids.shape[0] < bsz:
                last = self._batches[-1]
                fill = pad_batch([{"input_ids": []}] * (
                    bsz - last.input_ids.shape[0]), args.max_seq_length,
                    pad_id)
                self._batches[-1] = PackedBatch(*(
                    np.concatenate([a, b]) for a, b in zip(
                        last.as_dict().values(), fill.as_dict().values())))
        return self._batches

    # -- loop ------------------------------------------------------------

    def _check_supported(self, resume_from_checkpoint) -> None:
        args = self.args
        if self.model.lora is None:
            raise NotImplementedError(
                "SFTTrainer: full fine-tuning (no LoRA tree) is not ported "
                "yet; call get_peft_model first")
        if args.save_steps or resume_from_checkpoint:
            raise NotImplementedError(
                "SFTTrainer: checkpoint saves and resume are not ported yet "
                "(save_steps=0, resume_from_checkpoint=None)")
        if args.embedding_learning_rate and any(
                k in self.model.lora for k in ("embed", "lm_head")):
            raise NotImplementedError(
                "SFTTrainer: embedding_learning_rate is not ported yet")

    def train(self, resume_from_checkpoint=None) -> TrainOutput:
        self._check_supported(resume_from_checkpoint)
        args = self.args
        model = self.model
        batches = self.prepare_batches()
        accum = max(1, min(args.gradient_accumulation_steps, len(batches)))
        steps_per_epoch = max(len(batches) // accum, 1)
        total_steps = args.max_steps if args.max_steps > 0 else int(
            steps_per_epoch * args.num_train_epochs)
        total_steps = max(total_steps, 1)

        params = lora_leaves(model.lora)
        for p in params:
            p.requires_grad_(True)
        tx, schedule = build_optimizer(args, total_steps, params)
        seg_ctx = (packed_segment_bound(self._segment_bound)
                   if self._segment_bound else contextlib.nullcontext())
        device = model.device
        losses: List[float] = []
        tokens_seen = 0
        global_step = 0
        epoch = 0
        t0 = time.time()
        with seg_ctx:
            while global_step < total_steps:
                order = list(range(0, len(batches) - accum + 1, accum))
                np.random.RandomState(args.seed + epoch).shuffle(order)
                for start in order:
                    if global_step >= total_steps:
                        break
                    t_step = time.perf_counter()
                    group = batches[start:start + accum]
                    tokens_seen += int(sum((b.segment_ids != 0).sum()
                                           for b in group))
                    n_items = torch.tensor(float(max(sum(
                        int((b.labels[..., 1:] != -100).sum())
                        for b in group), 1)), device=device)
                    loss_sum = torch.zeros((), device=device)
                    for b in group:
                        micro = {k: torch.from_numpy(v).to(device)
                                 for k, v in b.as_dict().items()}
                        loss = model_loss_fn(model.params, model.lora, micro,
                                             model.cfg, n_items=n_items,
                                             remat=model.gc_mode)
                        loss.backward()
                        loss_sum += loss.detach()
                    tx.step()
                    tx.zero_grad()
                    global_step += 1
                    if global_step % args.logging_steps == 0:
                        entry = {
                            "loss": float(loss_sum),
                            "learning_rate": float(schedule(global_step)),
                            "step": global_step,
                            "epoch": round(global_step / steps_per_epoch, 3),
                        }
                        losses.append(entry["loss"])
                        self.state_log.append(entry)
                        self.metrics_logger.log(entry)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    self.step_times.append(time.perf_counter() - t_step)
                epoch += 1
        for p in params:
            p.requires_grad_(False)
        elapsed = time.time() - t0
        metrics = {"train_runtime": elapsed,
                   "train_tokens_per_second": tokens_seen / max(elapsed, 1e-9),
                   "total_steps": global_step}
        return TrainOutput(global_step,
                           float(np.mean(losses)) if losses else float("nan"),
                           metrics)

    def evaluate(self, eval_dataset=None) -> Dict[str, float]:
        """Loss and perplexity over ``eval_dataset`` (else the trainer's):
        padded batches of ``per_device_train_batch_size`` rows (a short
        last batch is filled with copies whose labels are ignored), no
        rematerialization, no gradients; each batch's mean loss weighted by
        its valid-token count. Returns ``eval_loss``, ``eval_perplexity``
        (exp of the loss, capped at exp(20)) and ``eval_tokens``."""
        ds = eval_dataset if eval_dataset is not None else self.eval_dataset
        if ds is None:
            raise ValueError("SFTTrainer.evaluate: no eval dataset")
        args = self.args
        model = self.model
        examples = [self._tokenize_example(ex) for ex in ds]
        pad_id = self._pad_id()
        bsz = args.per_device_train_batch_size
        losses: List[torch.Tensor] = []
        n_toks: List[int] = []
        with torch.no_grad():
            for i in range(0, len(examples), bsz):
                chunk = examples[i:i + bsz]
                n_real = len(chunk)
                chunk = chunk + [chunk[-1]] * (bsz - n_real)
                pb = pad_batch(chunk, args.max_seq_length, pad_id)
                labels = pb.labels.copy()
                labels[n_real:] = -100   # batch-fill rows don't count
                micro = {k: torch.from_numpy(v).to(model.device)
                         for k, v in dict(pb.as_dict(), labels=labels).items()}
                n_toks.append(int((labels[:n_real, 1:] != -100).sum()))
                losses.append(model_loss_fn(model.params, model.lora, micro,
                                            model.cfg, remat=False))
            total_loss = 0.0
            if losses:
                weights = torch.tensor([max(t, 1) for t in n_toks],
                                       dtype=torch.float32,
                                       device=model.device)
                total_loss = float(torch.sum(
                    torch.stack(losses).to(torch.float32) * weights))
        total_tokens = sum(n_toks)
        mean = total_loss / max(total_tokens, 1)
        metrics = {"eval_loss": mean,
                   "eval_perplexity": float(np.exp(min(mean, 20.0))),
                   "eval_tokens": total_tokens}
        self.metrics_logger.log(metrics)
        return metrics


def unsloth_train(trainer, *args, **kwargs):
    """``trainer.train()``: the training step already divides each
    micro-batch by the global token count of its accumulation group, so
    gradient accumulation needs no further fix."""
    return trainer.train(*args, **kwargs)


def train_on_responses_only(example_or_trainer=None, *,
                            instruction_part: str, response_part: str,
                            tokenizer=None):
    """Mask labels so that only the responses count in the loss.

    With ``tokenizer``: returns a function that maps a tokenized example
    ({"input_ids": ...}) to one whose "labels" are -100 except inside
    response spans, found by the token patterns of the two markers (a
    response runs from the end of ``response_part`` to the next
    ``instruction_part``). Otherwise the argument is a trainer: the masking
    is installed on its training examples and the trainer is returned."""
    def mask_example(ex, tok):
        ids = list(ex["input_ids"])
        instr = tok(instruction_part, add_special_tokens=False)["input_ids"]
        resp = tok(response_part, add_special_tokens=False)["input_ids"]
        labels = [-100] * len(ids)
        i = 0
        in_response = False
        while i < len(ids):
            if ids[i:i + len(resp)] == resp:
                in_response = True
                i += len(resp)
                continue
            if ids[i:i + len(instr)] == instr:
                in_response = False
                i += len(instr)
                continue
            if in_response:
                labels[i] = ids[i]
            i += 1
        return dict(ex, labels=labels)

    if tokenizer is not None:
        return lambda ex: mask_example(ex, tokenizer)
    trainer = example_or_trainer
    tok = trainer.tokenizer
    trainer._post_tokenize_fn = lambda ex: mask_example(ex, tok)
    trainer._batches = None
    return trainer
