"""Masked-diffusion LM trainer (text-diffusion fine-tuning), in PyTorch.

Counterpart of unsloth_tpu/trainer/diffusion.py: an ``SFTTrainer`` whose
step is the masked-denoising loss (``models/diffusion.diffusion_loss``)
and an update of the trainables (the LoRA tree, or every param under full
fine-tuning). Data preparation is inherited, with packing off (diffusion
canvases are fixed windows): each example one row padded to
``max_seq_length``. As in JAX, the batches go in order, epoch after epoch,
one batch per optimizer step (``gradient_accumulation_steps`` is not
read), a model without ``mask_token_id`` refused, each batch passes its ids, segment ids and positions (no prompt
mask), and one generator seeded from ``args.seed`` draws every step's
mask, in turn. ``step_times`` holds each step's wall seconds, ending in a
device sync, as ``SFTTrainer``'s does.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..models.diffusion import diffusion_loss
from .sft import SFTConfig, SFTTrainer, TrainOutput, build_optimizer


class DiffusionTrainer(SFTTrainer):
    """SFTTrainer with the masked-denoising loss; data prep (tokenize /
    pad, no packing) is inherited."""

    def __init__(self, model, tokenizer=None, train_dataset=None,
                 args: Optional[SFTConfig] = None, **kwargs):
        if args is None:
            args = SFTConfig()
        args.packing = False
        super().__init__(model, tokenizer=tokenizer,
                         train_dataset=train_dataset, args=args, **kwargs)
        if model.cfg.mask_token_id is None:
            raise ValueError("diffusion model needs mask_token_id "
                             "(FastDiffusionModel sets it)")

    def train(self, resume_from_checkpoint=None) -> TrainOutput:
        """Train for ``max_steps`` (else the epochs' batches);
        ``resume_from_checkpoint`` is taken and ignored, as in JAX."""
        del resume_from_checkpoint
        args = self.args
        model = self.model
        batches = self.prepare_batches()
        total_steps = args.max_steps if args.max_steps > 0 else \
            max(int(len(batches) * args.num_train_epochs), 1)
        trainables, _ = self._trainables()
        tx, schedule = build_optimizer(args, total_steps, trainables)
        for p in tx.params:
            p.requires_grad_(True)
        device = model.device
        gen = torch.Generator(device=device).manual_seed(args.seed)

        losses: List[float] = []
        t0 = time.time()
        global_step = 0
        try:
            while global_step < total_steps:
                for pb in batches:
                    if global_step >= total_steps:
                        break
                    t_step = time.perf_counter()
                    batch = {k: torch.from_numpy(getattr(pb, k)).to(device)
                             for k in ("input_ids", "segment_ids",
                                       "positions")}
                    loss = diffusion_loss(model.params, model.lora, batch,
                                          model.cfg, gen, remat=model.gc_mode)
                    loss.backward()
                    tx.step()
                    tx.zero_grad()
                    global_step += 1
                    if global_step % args.logging_steps == 0:
                        entry = {"loss": float(loss.detach()),
                                 "step": global_step,
                                 "learning_rate": float(
                                     schedule(global_step))}
                        losses.append(entry["loss"])
                        self.state_log.append(entry)
                        self.metrics_logger.log(entry)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    self.step_times.append(time.perf_counter() - t_step)
        finally:
            for p in tx.params:
                p.requires_grad_(False)
        return TrainOutput(
            global_step,
            float(np.mean(losses)) if losses else float("nan"),
            {"train_runtime": time.time() - t0})
