#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA
H100.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing a result:

  1. device    card name, capability (must be 9.0), CUDA and nvcc versions,
               the card's name and power limit from nvidia-smi;
  2. build     compile the package's CUDA kernels from csrc/, one nvcc per
               source in parallel (timed);
  3. kernels   each kernel against its plain PyTorch version on the card at
               the main paths' shapes, with the kernels' median times and
               the plain versions' time of the one call the check reads
               (:func:`once_ms`): the NF4 matmul
               (K1: at 1, 4, 7 and 16 rows the split-K decode kernel,
               also at gpt-oss's and Gemma-2's k/v shapes, its counters
               held to its schedule, its bits to a second run and to the
               fp32-absmax form, its faults rejected, one launch a call;
               above them the Hopper kernel, whose tile counters are held
               to its schedule, at 64, 256, 1,500, 4,096 and 8,192 rows;
               each with its two-call yardstick) and its backward (K2) at every
               Llama-3.1-8B projection shape, RMSNorm forward (K3) and
               backward (K4), packed flash
               attention forward (K9, K16's Hopper forward on q *
               bf16(scale)) and backward (K10/K11, K18's Hopper dq and
               dk/dv at bf16(scale)), their tile classes held to the
               rule, beside K16's pair, on an 8K row at Llama-3.1-8B's
               heads and at Gemma-7B's (through attention() as well), the
               full-logits CE forward (K7) and backward (K8) at 4,094 rows
               of the 128,256 vocabulary, and unpacked flash attention
               (K16: forward, dq, dk/dv) on a padded [2, 2048] batch, with
               the tile pairs each of its kernels classed skip, full and
               masked read back from its counters and held to the rule
               (:func:`flash_tile_classes`; also at the non-causal (a)
               below), and its backward run twice for the same bits at
               the non-causal (a) and at Qwen2.5-0.5B's heads; then
               the Gemma-2-9B path's: K1/K2 at its five projection shapes
               (M = 4,096), K3/K4 with gemma=True at [4096, 3584], K7/K8
               over 256,000 logits with softcap 30, and splash attention
               (K18: forward, dq, dk/dv) with softcap 50 at (a) the path's
               padded [2, 2048] batch, 16/8 heads, head dim 256, with and
               without the window of 4,096, (b) one 8K row where the window
               bites, (c) Gemma-2-27B's heads (32/16, head dim 128), (d)
               a packed 8K row and (e), without window or softcap, at
               K16's shape (K18 runs on K16's Hopper kernels, with the
               tile pairs each kernel classed held to the rule with the
               window at (a) sliding, (b) and (d), and the three kernels
               run twice for the same bits at (a) sliding); then the
               gpt-oss-20b path's: K1/K2 at its
               three attention projection shapes (M = 4,096; K = 2,880
               for q/k/v, whose K/2 is not a multiple of 64), the grouped
               NF4 expert kernels K14 (with the bias epilogue) and K15 at
               the path's 16,384 rows routed top-4 over 32 experts (N = K
               = 2,880, block 32), a skewed routing and the 8 rows of a
               decode step (their tile counters held to their schedules'
               twins, their walks' faults rejected), K15 also at block
               64, at N % 64 != 0 and with sizes summing below m, the
               grouped dense bf16 matmul K19 (forward
               with the bias epilogue, and dx) on the same three
               routings, K14's and K19's forwards at decode rows (the
               grouped decode kernel: top-4 routings of 1, 2 and 4
               tokens and 16 rows skewed over 4 experts; counters held
               to grouped_decode_schedule, the same bits twice, one
               kernel a call, one expert's rows through the next one's
               weights, the bias dropped and a K slice or the last step
               dropped rejected), and flash attention with sinks (K17:
               forward, dq, dk/dv, dsinks; 64/8 heads of 64) on the path's
               packed 4,096-token row and a padded [2, 2048] batch, and at head
               dims 128 (32/8 heads) and 256 (16/8) on a padded
               [1, 1024] row, each also through ``attention`` with
               sinks, against ``attention_ref``; then the
               small Llama-family paths' head-dim forms: K16 at head dim
               64 on the padded [2, 2048] batch with Llama-3.2-1B's 32/8
               and Qwen2.5-0.5B's 14/2 heads, at head dim 256 with
               Gemma-7B's 16/16, and K18 at head dim 64 on a packed
               384-token row with gpt-oss's 64/8 heads and window 128;
               then the GRPO path's: K18's shared-prefix form (forward, dq,
               dk/dv) at Llama-3.1-8B's 32/8 heads of 128 on one row of
               the layout (256, 6, 896) (T = 5,632; a left-padded prompt,
               short completions), with the tile pairs each kernel
               classed, read back from its counters, held to the rule
               with the layout (this row's segments and one segment) and
               printed beside causal's, and the three kernels run twice
               for the same bits; then the
               Whisper path's LayerNorm forward (K5) and backward (K6) at
               [3000, 1280] (2 x 1,500 encoder frames) in bf16 and fp32,
               at [448, 1280] (2 x 224 decoder tokens) in bf16 and with
               b=None (library call: F.layer_norm and its backward); then
               the FP8 path's dequant-inside-matmul K12 (forward) and K13
               (dx) at block 128 at Llama-3.1-8B's four projection shapes
               (M = 4,096), K12's decode kernel at 1, 4 and 16 rows at
               all four and at a ragged shape, and both at a ragged
               shape with block 32 (labelled
               yardstick: dequantize_fp8 + torch.matmul, two calls); the
               check must reject injected faults (K16: a dropped kv tile,
               an ignored pad mask, a late-half error, a diagonal or a
               mixed-segment tile called full; K18 also: the
               window ignored, the softcap's derivative dropped, a tile
               pair past the window called full; K14/K15:
               one expert's rows through the next expert's weights, the
               bias dropped; K19 the same and a straddling tile's rows
               stored by the next expert's visit, with its work-unit
               counters held to the schedule's twin at (a) and (b) and
               its (a) rerun for the same bits; K17: the sink ignored, dsinks
               dropped; K18's prefix form: the region rule dropped, the
               prefix dropped, a tile pair across two completion regions
               called full; K12/K13: a contraction block read with its
               neighbour's scale, the scales ignored, the last contraction
               block dropped, and for K13 the scale grid read
               untransposed); then the text-diffusion path's non-causal
               forms: K16 without causality (forward, dq, dk/dv) at (a)
               LLaDA-8B's 32/32 heads of 128 on the padded [2, 2048]
               batch, (b) Llama's 32/8, (c) a ragged T of 200, (d) the
               generate canvas (B = 1, T = 128, one segment), and K18
               without causality at (e) Gemma-2-9B's 16/8 heads of 256,
               softcap 50, no window (its tile classes held to the rule),
               each also rejecting the causal
               kernels' results on the same inputs (library call: SDPA
               with the segment mask for K16, compiled flex_attention
               for K18). For each
               kernel, its bound (the least time the card could take) and
               the time of the one PyTorch call that computes the same
               function, where there is one (K18: the compiled
               flex_attention with the softcap as its score_mod at the
               Gemma-2 path's shape, none at the other softcap shapes,
               SDPA with the mask at K16's; SDPA with the same mask and no
               softcap is timed beside each; K14/K15,
               labelled: dequantize + torch._grouped_mm; K17, labelled:
               compiled flex_attention with return_lse and the sink
               rescale; K19, labelled: torch._grouped_mm + a bias gather;
               K18 at head dim 64, labelled: SDPA with the causal, window
               and segment mask, which has no softcap to miss; K18's prefix
               form: SDPA with the layout's dense [T, T] mask);
  3b. CE routes  full logits (cuBLAS + K7/K8) against the chunked fused CE,
               forward + backward time and peak memory, at 4,094 and 8,191
               rows;
  4. parity    Llama-3.1-8B cut to 2 layers, random NF4 weights: prefill 64
               tokens + 4 decode steps on the card (kernels) and on the CPU
               (plain versions, same weights), logits compared;
  4b. train parity  the same 2-layer cut with nonzero LoRA: loss and every
               LoRA gradient of one packed 1,024-token row, and of one
               padded [2, 1024] batch (K16 and K7/K8 on the card), on the
               card and on the CPU, compared;
  4c. Gemma-2 train parity  the padded batch of 4b on Gemma-2-9B cut to 2
               layers (one sliding, one global), random NF4 weights,
               nonzero LoRA: K18 and K7/K8 with the softcaps on the card
               against the plain versions in fp32 on the CPU;
  4d. gpt-oss train parity  gpt-oss-20b cut to 2 layers (one sliding, one
               global) at full width with all 32 experts, NF4 attention
               and stacked-NF4 experts, nonzero LoRA on q/k/v/o: the loss
               and every LoRA gradient of one packed 2,048-token row, the
               card (K1/K2, K14/K15, K17, K7/K8) against the CPU (plain
               versions, fp32);
  4e. small-model train parity  the same against the CPU in fp32 for the
               head-dim forms in whole 2-layer models: Llama-3.2-1B's
               width from a 2-layer bnb-4bit checkpoint (K1/K2 on bnb's
               absmax, K16 at head dim 64) and Gemma-7B's (K16 at head dim
               256) on short padded batches, and gpt-oss-20b's on a packed
               384-token row (its sliding layer K18 at head dim 64, the
               chunked lse and the sink rescale; its global layer K17);
  4f. GRPO train parity  Llama-3.1-8B cut to 2 layers, random NF4 weights,
               LoRA r=32 with a random B: the grouped GRPO loss (the
               reference pass with LoRA off) and every LoRA gradient of one
               fixed rollout batch in the layout (128, 6, 128), the card
               (K18's prefix form) against the CPU in fp32;
  4g. Whisper train parity  Whisper-large-v3 at full width cut to 2 + 2
               layers, a random bf16 checkpoint loaded by load_whisper,
               LoRA r=32 on q/v with a random B: whisper_loss and every
               LoRA gradient of a [2, 128, 3000] log-mel batch, the card
               (K5/K6, K7/K8) against the CPU, both fp32, then the card in
               bf16; greedy ids over 16 tokens in fp32, equal; launches of
               K5/K6/K7/K8 exactly what the layer count predicts;
  4h. FP8 train parity  Llama-3.1-8B cut to 2 layers at full width, its
               seven projections quantized by quantize_fp8_block (block
               128), LoRA r=16 with a random B: the loss and every LoRA
               gradient of one padded [2, 1024] batch, the card (K12/K13,
               K3/K4, K16, K7/K8) against the CPU (plain versions, fp32),
               at 4b's limits; the logits of a 64-token prefill and 4
               decode steps the same way at phase 4's; K12/K13 launches
               exactly what 2 layers predict;
  4j. LLaDA-8B diffusion train parity  LLaDA-8B cut to 2 layers at full
               width, bidirectional, random bf16 weights, LoRA r=16 with a
               random B: diffusion_loss, the logits of the noised batch and
               every LoRA gradient of one padded batch with one mask drawn
               on the CPU, the card (non-causal K16 only, K3/K4) against
               the CPU in fp32 (loss 1e-2, logits 2e-2, worst leaf 5e-2);
               the card forced causal must fail those limits;
  4k. Gemma-2 diffusion train parity  the same at Gemma-2-9B's widths,
               every layer global, both softcaps (non-causal K18 only);
  5. main path (serving) a random-init bf16 Llama-3.1-8B checkpoint (full
               width, all 32 layers) is written as index-sharded
               safetensors, loaded with FastLanguageModel.from_pretrained(
               load_in_4bit=True), served by InferenceServer over HTTP (3
               requests) and run through model.generate on 4 prompts;
  6. main path (packed training) the same checkpoint, get_peft_model(r=16,
               all seven projections, use_gradient_checkpointing="unsloth"),
               SFTTrainer on synthetic documents packed into 8,192-token
               rows: batch 1, accumulation 2, 4 steps; losses finite and
               falling; step time, real tokens/s and peak memory; K10/K11
               once a layer for each row, and no flash or splash
               attention kernel;
  7. main path (SFT without packing, the Llama-3.1 Alpaca notebook's
               recipe) the same checkpoint at max_seq_length 2048, r=16 on
               seven projections, "unsloth" checkpointing, synthetic
               Alpaca-format texts with train_on_responses_only, padded
               rows, batch 2 x accumulation 4, 6 steps; then evaluate,
               save_lora -> a fresh adapter -> load_lora -> evaluate
               (equal losses), and
               save_pretrained_merged reloaded with load_in_4bit=False
               (logits against the LoRA model's);
  8. main path (Gemma-2 SFT, the notebook recipe) a random-init bf16
               Gemma-2-9B checkpoint (its published config: 42 layers,
               hidden 3584, 16/8 heads of 256, vocabulary 256,000, softcaps
               50/30, window 4,096 on the even layers, tied embedding) in
               place of the Llama one: from_pretrained(load_in_4bit=True),
               get_peft_model(r=16, seven projections, "unsloth"),
               SFTTrainer(packing=False) with train_on_responses_only,
               batch 2 x accumulation 4, 4 steps: losses finite and
               falling, step time, tokens/s, peak memory, K18 launched on
               every layer and K9-K11/K16 never; then evaluate and a
               greedy generate of 16 tokens for 2 prompts;
  9. main path (MoE QLoRA SFT on gpt-oss-20b) a random-init bf16
               gpt-oss-20b checkpoint (its published config: 24 layers,
               hidden 2,880, 64/8 heads of 64, 32 experts, 4 a token,
               vocabulary 201,088, sliding window 128 on the even layers,
               sinks, biases; HF's GptOss tensor names, gate and up
               interleaved) in place of the Gemma-2 one, after a check of
               the free disk: from_pretrained(load_in_4bit=True) (experts
               as bf16 stacks, as in the JAX loader); first the default
               MoE path on those bf16 experts: get_peft_model(r=16,
               "unsloth"), SFTTrainer on the packed 4,096-token rows,
               batch 1 x accumulation 2, 3 steps (losses finite and
               falling, step time, tokens/s, training peak, MFU, launches
               per step exactly K19 forward 288, dx 144, K14/K15 none) and
               a greedy generate of 8 tokens for 1 prompt, a prefill alone
               timed first (ms a decode step; K19's decode form exactly 72
               launches a decode step, none in a prefill); the trainer,
               its AdamW state and the adapter freed;
               then quantize_params (stacked NF4 at block 32),
               get_peft_model(r=16, "unsloth"),
               SFTTrainer with packing into 4,096-token rows, batch 1 x
               accumulation 2, 4 steps: losses finite and falling, step
               time, tokens/s, peak memory, MFU over active parameters,
               launches per step exactly K14 288, K15 144, K17 48/24/24 and
               K19/K9-K11/K16/K18 never; evaluate, the adapter round trip,
               and a greedy generate of 16 tokens for 2 prompts, timed as
               the bf16 one (K14's decode form exactly 72 launches a
               decode step);
 10. main path (the Llama 3.2 conversational notebook) a random-init
               Llama-3.2-1B checkpoint (its published config: 16 layers,
               hidden 2,048, 32/8 heads of 64, vocabulary 128,256, tied
               embedding, llama3 rope) written in the layout of the
               pre-quantized unsloth/*-bnb-4bit repos (interleaved NF4
               nibbles, double-quantized absmax):
               from_pretrained(load_in_4bit=True) (no quantize_nf4 call),
               get_peft_model(r=16, "unsloth"), SFTTrainer(packing=False)
               on synthetic llama-3.1 chat-format conversations with
               train_on_responses_only on the user/assistant headers,
               batch 2 x accumulation 4, 4 steps: losses finite and
               falling, launches per step exactly K16 forward 128, dq and
               dk/dv 64, K7/K8 4, K9-K11 none; evaluate, the adapter round
               trip, a greedy generate, the merged save reloaded;
 11. main path (Qwen2.5-0.5B LoRA SFT on Alpaca) a random-init bf16
               Qwen2.5-0.5B checkpoint (24 layers, hidden 896, 14/2 heads
               of 64, vocabulary 151,936, q/k/v biases, tied):
               from_pretrained(load_in_4bit=False), LoRA r=16, padded
               2,048-token Alpaca rows, batch 2 x accumulation 4, 4 steps:
               no K1/K2 launch (the bf16 base stays torch.matmul), K16
               launches exactly; evaluate and a greedy generate;
 12. main path (GRPO, the Llama 3.1 (8B) GRPO notebook's recipe; run right
               after phase 7, on its checkpoint) from_pretrained(
               max_seq_length=1024, load_in_4bit=True), get_peft_model(
               r=32, lora_alpha=32, seven projections, "unsloth"),
               GRPOTrainer(prefix_grouping=True): 6 generations of up to
               768 tokens from prompts of up to 256, batch 1, learning
               rate 5e-6, max_grad_norm 0.1, beta 0.04, a reward from the
               completion text, 2 steps: each round prefills its prompt
               once and decodes 6 streams; launches per step exactly K18
               prefix forward 96, dq 32, dk/dv 32 and K16 none; losses
               finite, the LoRA moved; rollout and step times, tokens/s,
               peak memory; then on the last rollouts the grouped loss and
               LoRA gradients against the unpacked ones (K16 on [6, 1024]
               rows), within fixed limits that the region rule dropped
               must fail;
 13. main path (Whisper-large-v3, bench_extra.py's main_whisper recipe) a
               random-init bf16 checkpoint of its published config (32 +
               32 layers, d 1,280, 20 heads, 128 mel bins, vocabulary
               51,866) loaded by from_pretrained(dtype=bf16):
               whisper_transcribe of a seeded 2-s waveform (32-id buffer:
               encoder ms, ms a decode step, the ids), then WhisperTrainer
               with fp32 LoRA r=32, alpha 64 on q/v, batch 2 of 3,000 mel
               frames and 224 labels, lr 1e-4, 4 steps on the repeated
               batch: losses finite and falling, step time, decoder
               tokens/s, peak memory, launches per step exactly K5 162,
               K6 160, K7/K8 1;
 14. main path (Orpheus-3B TTS QLoRA SFT, main_tts's recipe) a random-init
               bf16 checkpoint of the Llama-3.2-3B backbone with the
               156,940-token vocabulary (28 layers, hidden 3,072, 24/8
               heads of 128, tied): from_pretrained(load_in_4bit=True),
               get_peft_model(r=64, "unsloth"), SFTTrainer packing
               prepare_tts_dataset's rows (seeded SNAC codes, byte text)
               into 2,048-token rows, batch 1, 3 steps: losses finite, the
               LoRA moved, step time, real tokens/s, peak memory, the CE
               route fused_ce="auto" took, launches per step exactly K1
               392, K2 193, K3 113, K4 56, K9 56, K10/K11 28, K7/K8 1
               (full logits), and no flash or splash attention kernel;
 15. main path (LoRA SFT and generate over a block-FP8 base; run after
               phase 12, on its checkpoint) from_pretrained(
               max_seq_length=2048, load_in_4bit=False) in bf16, the seven
               projections of all 32 layers quantized by
               quantize_fp8_block (block 128), get_peft_model(r=16,
               "unsloth"), the notebook recipe of phase 7 for 3 steps:
               losses finite and falling, launches a step exactly phase
               7's K1/K2 counts as K12/K13 (1,792 and 884), K16 and K7/K8
               as in phase 7, K1/K2 and K9-K11 never; step time,
               tokens/s, peak memory, MFU; evaluate, the adapter round
               trip, save_pretrained_merged raising NotImplementedError
               (no merge over FP8 in either package), a greedy generate of
               16 tokens for 2 prompts (K12 at decode rows);
 18. main path (text diffusion, LLaDA-8B; run after phase 15, once the
               Llama checkpoint is removed) a random-init bf16 checkpoint of
               LLaDA-8B's published config under llama keys (32 layers,
               d 4,096, 32/32 heads of 128, FFN 12,288, vocabulary 126,464,
               mask id 126,336): FastDiffusionModel.from_pretrained(bf16),
               get_peft_model(r=16, seven projections, "unsloth"),
               DiffusionTrainer for 4 steps of 2 x 2,048-token rows of
               1,500 real tokens and more, lr 2e-4: losses finite, the
               LoRA B leaves moved, launches a step exactly non-causal K16
               forward 64, dq 32, dk/dv 32, K3 129, K4 64 and nothing
               else; step time, real tokens/s, peak memory, MFU; then
               diffusion_generate (32-token prompt, canvas 128, 16 steps,
               greedy): the prompt kept, no mask id left, the schedule's
               commits, 512 non-causal K16 forwards, ms a step.

Phases 4-4k run in a second process (``--parity-phases DIR``, with
PARITY_THREADS CPU threads), started after phase 3b and run beside
phases 5-8 and 10-18, and waited for before phase 9 writes the largest
checkpoint (phases 9 and 16, gpt-oss-20b, run last): their time is mostly
the fp32 references on the CPU, which would otherwise hold up the card.
Their lines are printed when that process has ended; any failure of it
fails the script. The step times of the main path's phases are read
beside it, so they are no measurement of the port's speed: the
``--profile-train`` runs are.

Then one JSON line with each kernel's launches on its main path (K5/K6:
Whisper's training, phase 13), its largest error against its plain
version, its time beside the plain version's, its bound and the library
call's time (the head-dim forms of K16 and K18 as entries of their own);
the nvidia-smi line;
and last the result line {"ok": true, "device": {...}}. It needs one CUDA
card and exits non-zero without it.

    python3 chip_smoke.py --profile-train
    python3 chip_smoke.py --profile-train-unpacked
    python3 chip_smoke.py --profile-train-gemma2
    python3 chip_smoke.py --profile-train-gpt-oss
    python3 chip_smoke.py --profile-train-gpt-oss-bf16
    python3 chip_smoke.py --profile-train-llama32
    python3 chip_smoke.py --profile-train-grpo
    python3 chip_smoke.py --profile-train-fp8
    python3 chip_smoke.py --profile-train-diffusion
    python3 chip_smoke.py --profile-train-whisper
    python3 chip_smoke.py --profile-serve

run phases 1, 2 and 6 (or 7 without evaluate and the saves, or 8, or 9's
NF4 part, or 9's bf16-expert part, or 10, each without evaluate, generate
and the saves, or 12 without its layout comparison, or 15's training
without evaluate, the saves and generate, or 18's training without its
checks and generate, or 13's transcription and LoRA training) only, then
one more
training step under torch.profiler (for GRPO: the reference pass, the
grouped loss, its backward and the update, on the last rollouts), and
print that step's device time by kernel and by kernel family, the device
spans of the port's profiler ranges (the MoE routing
glue, the banded attention), its device busy share and its MFU/HFU (no
result line). ``--profile-serve`` runs phases 1 and 2, then loads phase
5's model and profiles one batch-4 decode step after its 1,000-token
prompts (:func:`phase_profile_serve`). Every phase prints its time
("[time]"). After a --profile flag, ``--tree DIR`` profiles another
checkout's package
(a parent unpacked under build/ with git archive) with this script's
harness, its Hopper build rows reported but not held to this tree's.

    python3 chip_smoke.py --library-times

runs phases 1 and 2, then phase 3's K18 and gpt-oss parts with the
library yardsticks the default run leaves out for time (each compiled
flex_attention shape costs ~20-30 s): flex + the sink rescale at K17's
(b) and head dims 128 and 256, flex with the softcap and the window at
K18's (b)-(d), and K19 against torch._grouped_mm as the median of 5
medians of 20 runs (no result line).
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

LLAMA_31_8B_CONFIG = {
    # meta-llama/Llama-3.1-8B-Instruct config.json (published values)
    "architectures": ["LlamaForCausalLM"],
    "attention_bias": False,
    "attention_dropout": 0.0,
    "bos_token_id": 128000,
    "eos_token_id": [128001, 128008, 128009],
    "head_dim": 128,
    "hidden_act": "silu",
    "hidden_size": 4096,
    "initializer_range": 0.02,
    "intermediate_size": 14336,
    "max_position_embeddings": 131072,
    "mlp_bias": False,
    "model_type": "llama",
    "num_attention_heads": 32,
    "num_hidden_layers": 32,
    "num_key_value_heads": 8,
    "pretraining_tp": 1,
    "rms_norm_eps": 1e-05,
    "rope_scaling": {"factor": 8.0, "high_freq_factor": 4.0,
                     "low_freq_factor": 1.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "rope_theta": 500000.0,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
    "use_cache": True,
    "vocab_size": 128256,
}

GEMMA2_9B_CONFIG = {
    # google/gemma-2-9b config.json (published values; written in bf16)
    "architectures": ["Gemma2ForCausalLM"],
    "attention_bias": False,
    "attention_dropout": 0.0,
    "attn_logit_softcapping": 50.0,
    "bos_token_id": 2,
    "cache_implementation": "hybrid",
    "eos_token_id": 1,
    "final_logit_softcapping": 30.0,
    "head_dim": 256,
    "hidden_act": "gelu_pytorch_tanh",
    "hidden_activation": "gelu_pytorch_tanh",
    "hidden_size": 3584,
    "initializer_range": 0.02,
    "intermediate_size": 14336,
    "max_position_embeddings": 8192,
    "model_type": "gemma2",
    "num_attention_heads": 16,
    "num_hidden_layers": 42,
    "num_key_value_heads": 8,
    "pad_token_id": 0,
    "query_pre_attn_scalar": 256,
    "rms_norm_eps": 1e-06,
    "rope_theta": 10000.0,
    "sliding_window": 4096,
    "sliding_window_size": 4096,
    "torch_dtype": "bfloat16",
    "use_cache": True,
    "vocab_size": 256000,
}

GPT_OSS_20B_CONFIG = {
    # openai/gpt-oss-20b config.json (published values) without its
    # quantization_config: the bf16 layout unsloth/gpt-oss-20b-BF16 publishes
    "architectures": ["GptOssForCausalLM"],
    "attention_bias": True,
    "attention_dropout": 0.0,
    "eos_token_id": 200002,
    "experts_per_token": 4,
    "head_dim": 64,
    "hidden_act": "silu",
    "hidden_size": 2880,
    "initial_context_length": 4096,
    "initializer_range": 0.02,
    "intermediate_size": 2880,
    "layer_types": ["sliding_attention", "full_attention"] * 12,
    "max_position_embeddings": 131072,
    "model_type": "gpt_oss",
    "num_attention_heads": 64,
    "num_experts_per_tok": 4,
    "num_hidden_layers": 24,
    "num_key_value_heads": 8,
    "num_local_experts": 32,
    "output_router_logits": False,
    "pad_token_id": 199999,
    "rms_norm_eps": 1e-05,
    "rope_scaling": {"beta_fast": 32.0, "beta_slow": 1.0, "factor": 32.0,
                     "original_max_position_embeddings": 4096,
                     "rope_type": "yarn", "truncate": False},
    "rope_theta": 150000,
    "router_aux_loss_coef": 0.9,
    "sliding_window": 128,
    "swiglu_limit": 7.0,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
    "use_cache": True,
    "vocab_size": 201088,
}

LLAMA_32_1B_CONFIG = {
    # meta-llama/Llama-3.2-1B config.json (published values); phase 10
    # writes it in the layout of unsloth/Llama-3.2-1B-bnb-4bit
    "architectures": ["LlamaForCausalLM"],
    "attention_bias": False,
    "attention_dropout": 0.0,
    "bos_token_id": 128000,
    "eos_token_id": 128001,
    "head_dim": 64,
    "hidden_act": "silu",
    "hidden_size": 2048,
    "initializer_range": 0.02,
    "intermediate_size": 8192,
    "max_position_embeddings": 131072,
    "mlp_bias": False,
    "model_type": "llama",
    "num_attention_heads": 32,
    "num_hidden_layers": 16,
    "num_key_value_heads": 8,
    "pretraining_tp": 1,
    "rms_norm_eps": 1e-05,
    "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0,
                     "low_freq_factor": 1.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "rope_theta": 500000.0,
    "tie_word_embeddings": True,
    "torch_dtype": "bfloat16",
    "use_cache": True,
    "vocab_size": 128256,
}

QWEN25_05B_CONFIG = {
    # Qwen/Qwen2.5-0.5B config.json (published values): q/k/v biases (HF's
    # Qwen2Attention, no config key), tied embedding
    "architectures": ["Qwen2ForCausalLM"],
    "attention_dropout": 0.0,
    "bos_token_id": 151643,
    "eos_token_id": 151643,
    "hidden_act": "silu",
    "hidden_size": 896,
    "initializer_range": 0.02,
    "intermediate_size": 4864,
    "max_position_embeddings": 32768,
    "max_window_layers": 24,
    "model_type": "qwen2",
    "num_attention_heads": 14,
    "num_hidden_layers": 24,
    "num_key_value_heads": 2,
    "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0,
    "sliding_window": 32768,
    "tie_word_embeddings": True,
    "torch_dtype": "bfloat16",
    "use_cache": True,
    "use_mrope": False,
    "use_sliding_window": False,
    "vocab_size": 151936,
}

GEMMA_7B_CONFIG = {
    # google/gemma-7b config.json (published values); phase 4e cuts it to 2
    # layers: head dim 256 without a softcap reaches K16
    "architectures": ["GemmaForCausalLM"],
    "attention_bias": False,
    "attention_dropout": 0.0,
    "bos_token_id": 2,
    "eos_token_id": 1,
    "head_dim": 256,
    "hidden_act": "gelu",
    "hidden_activation": "gelu_pytorch_tanh",
    "hidden_size": 3072,
    "initializer_range": 0.02,
    "intermediate_size": 24576,
    "max_position_embeddings": 8192,
    "model_type": "gemma",
    "num_attention_heads": 16,
    "num_hidden_layers": 28,
    "num_key_value_heads": 16,
    "pad_token_id": 0,
    "rms_norm_eps": 1e-06,
    "rope_scaling": None,
    "rope_theta": 10000.0,
    "torch_dtype": "bfloat16",
    "use_cache": True,
    "vocab_size": 256000,
}

LLADA_8B_CONFIG = {
    # GSAI-ML/LLaDA-8B-Base config.json and the LLaDA paper's table
    # (published values: d_model 4096, n_layers 32, n_heads and n_kv_heads
    # 32, mlp_hidden_size 12288, vocab_size 126464, mask_token_id 126336,
    # rope_theta 500000, rms_norm_eps 1e-5, untied head) under HF llama
    # keys: neither package reads LLaDA's OLMo keys and tensor names
    "architectures": ["LLaDAModelLM"],
    "attention_bias": False,
    "head_dim": 128,
    "hidden_act": "silu",
    "hidden_size": 4096,
    "intermediate_size": 12288,
    "mask_token_id": 126336,
    "max_position_embeddings": 4096,
    "model_type": "llada",
    "num_attention_heads": 32,
    "num_hidden_layers": 32,
    "num_key_value_heads": 32,
    "rms_norm_eps": 1e-05,
    "rope_theta": 500000.0,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
    "vocab_size": 126464,
}

# (name, N = out features, K = in features) of every Llama-3.1-8B projection
PROJ_SHAPES = [("q/o", 4096, 4096), ("k/v", 1024, 4096),
               ("gate/up", 14336, 4096), ("down", 4096, 14336)]
# and of every Gemma-2-9B projection
GEMMA2_PROJ_SHAPES = [("q", 4096, 3584), ("k/v", 2048, 3584),
                      ("o", 3584, 4096), ("gate/up", 14336, 3584),
                      ("down", 3584, 14336)]
# and of every gpt-oss-20b attention projection (K/2 = 1,440 for q/k/v)
GPT_OSS_PROJ_SHAPES = [("q", 4096, 2880), ("k/v", 512, 2880),
                       ("o", 2880, 4096)]
PACKED_STEPS = 4           # optimizer steps of packed Llama training (phase 6)
UNPACKED_STEPS = 6         # and of the Llama notebook recipe (phase 7)
GEMMA2_STEPS = 4           # optimizer steps of the Gemma-2 recipe (phase 8)
GPT_OSS_STEPS = 4          # optimizer steps of gpt-oss-20b training (phase 9)
GPT_OSS_BF16_STEPS = 3     # and of its default path, bf16 experts (phase 9)
LLAMA32_STEPS = 4          # optimizer steps of the Llama-3.2 recipe (phase 10)
QWEN25_STEPS = 4           # and of Qwen2.5-0.5B LoRA SFT (phase 11)
DIFFUSION_STEPS = 4        # optimizer steps of LLaDA-8B training (phase 18)
DIFFUSION_PROMPT = 32      # phase 18's generate: prompt tokens,
DIFFUSION_CANVAS = 128     # canvas slots
DIFFUSION_GEN_STEPS = 16   # and denoising steps
DIFFUSION_PARITY = (200, 384)  # real tokens of the two rows of 4j and 4k
GPT_OSS_ROWS = 4096        # packed row of phase 9 (bench.py's first rung)
SINKS_ROWS = 384           # a gpt-oss row where the window of 128 is not
                           # narrow (4 bands do not fit): K18 at head dim 64
SINKS_DOCS = ((0, 260), (260, 360))   # its documents, then a pad tail
#: K17's head dims beyond gpt-oss's 64 in phase 3: (head dim, Hq, Hkv) on a
#: padded [1, 1024] row
SINKS_WIDE_HEADS = ((128, 32, 8), (256, 16, 8))
PARITY_ROWS = 1024         # row length of the card-vs-CPU parity phases 4b-4c
PARITY_DECODE_STEPS = 4    # decode steps of phase 4 (8 cost ~22 s more)
DECODE_ROWS = (1, 4, 7)
#: K1's decode kernel in phase 3: DECODE_ROWS and its edge, 16 rows, at
#: Llama's four shapes; 1 and 16 rows at gpt-oss's q, k/v and o (K =
#: 2,880: an absmax block straddles K/2; N = 512) and Gemma-2's k/v
K1_DECODE_CASES = (
    [(name, n, k, DECODE_ROWS + (16,)) for name, n, k in PROJ_SHAPES]
    + [("gpt-oss " + name, n, k, (1, 16)) for name, n, k in
       GPT_OSS_PROJ_SHAPES]
    + [("gemma2 k/v", 2048, 3584, (1, 16))])
#: K1's rows past the decode kernel below the prefill: the Hopper kernel's
#: 128- and 256-row tiles and a ragged 1,500 (a serving prefill)
NF4_CROSSOVER_ROWS = (64, 256, 1500)
PREFILL_ROWS = 4096
TRAIN_ROWS = 8192          # one packed 8K row: the training path's M
DOC_LENGTHS = (64, 1024)   # synthetic document lengths, inclusive
SUB_VOCAB = 512            # documents draw ids from this many token ids
UNPACKED_ROWS = 2048       # max_seq_length of the notebook recipe
CE_ROWS = (4094, 8191)     # CE rows: 2 x 2,048 and 1 x 8,192, shifted
SEED = 0
DEVICE = "cuda:0"
#: the NF4 matmuls' yardstick (K1, K2): no single PyTorch call dequantizes
#: and multiplies
NF4_LIBRARY = "dequantize_nf4 + torch.matmul (two calls)"

# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)
PEAK_BF16 = 989e12         # FLOP/s, tensor cores
PEAK_FP32 = 67e12          # FLOP/s, outside the tensor cores
PEAK_BYTES = 3.35e12       # bytes/s of device memory


class ByteTokenizer:
    """Stand-in tokenizer: one UTF-8 byte is one token id (0..255); ids of
    256 and up decode to ``<id>`` so that every generated token shows up
    in the text."""

    eos_token_id = None
    pad_token_id = 0
    chat_template = None

    def __call__(self, text, **kw):
        return {"input_ids": list(text.encode("utf-8"))}

    def encode(self, text, add_special_tokens=True):
        return list(text.encode("utf-8"))

    def decode(self, ids, **kw):
        out = bytearray()
        for i in ids:
            out += bytes([i]) if i < 256 else f"<{i}>".encode()
        return out.decode("utf-8", errors="replace")


def log(*parts):
    print(*parts, flush=True)


def _smi_name_power() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = 20, warmup: int = 3, flush=None) -> float:
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event-timed runs,
    after ``warmup`` runs; ``flush`` (a large buffer) is zeroed before each
    run so that weights come from device memory, not the 50 MB L2."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


#: set by ``--library-times``: phase 3's parts time the library
#: yardsticks the default run leaves out (:func:`phase_library_times`)
LIBRARY_TIMES = False


def _settled_ms(fn, flush=None, repeats=5, runs=20):
    """The median of ``repeats`` medians of ``runs`` runs (:func:`time_ms`):
    a time for ratios within a few percent of 1."""
    return statistics.median(time_ms(fn, runs=runs, flush=flush)
                             for _ in range(repeats))


def once_ms(fn):
    """(fn(), ms): one call of a plain version, timed by CUDA events, whose
    result the check then reads. Phase 3 times the plain versions by this
    one call only (no warm-up, no L2 flush): a plain version is the
    kernels' check, no yardstick of speed, and timing it again and again
    cost the script minutes."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16):
    """(ms, "bytes" | "operations"): the least time the card could take
    for ``flops`` operations at ``peak`` and ``nbytes`` of device memory
    traffic, and which of the two sets it."""
    t_ops, t_mem = flops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_mem),
            "operations" if t_ops > t_mem else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ulps_bf16_or_f32(err, ref, dtype):
    """|err| in units of the last place of ref in ``dtype``."""
    import torch

    _, e = torch.frexp(ref.to(torch.float32))
    mant = 8 if dtype == torch.bfloat16 else 24
    ulp = torch.ldexp(torch.ones_like(ref, dtype=torch.float32), e - mant)
    ulp = torch.where(ref == 0, torch.full_like(ulp, 2.0 ** -133), ulp)
    return (err.abs() / ulp).max().item()


#: the attention kernels' check: every element within 2^-6 of its reference
#: value plus ATTN_ROW_TOL of its row's scale (see attn_row_err). The
#: kernels measure 0.007-0.010 at the main paths' shapes on an H100
#: (PERF.md), the faults of attn_fault_errs 0.35 and up.
ATTN_ROW_TOL = 2.0 ** -4


def attn_row_err(got, ref) -> float:
    """Worst (|got - ref| - 2^-6 |ref|) / scale over every element, where
    a row is one token's head vector (the last dim) and its scale the rms
    of the reference row plus 1e-2 of the whole reference's rms (a floor
    for rows that are zero, as dq of a query that attends only itself).
    Each (token, head) is held on its own scale: a tolerance set by the
    largest value of an attention output lets through errors larger than
    the typical value of a query with a thousand keys. Passes at <=
    ATTN_ROW_TOL."""
    g, r = got.float(), ref.float()
    sq = r.square()
    scale = sq.mean(-1, keepdim=True).sqrt() + 1e-2 * sq.mean().sqrt()
    return (((g - r).abs() - 2.0 ** -6 * r.abs()) / scale).max().item()


def attn_fault_errs(q, k, v, seg, dout, scale, want, window=None,
                    softcap=None, causal=True):
    """The power of :func:`attn_row_err`: K16's results (or, with a
    ``window`` or ``softcap``, K18's) under faults a wrong kernel could
    make, held against ``want`` (the right out, dq, dk, dv). Faults: the
    plain versions with the 64-token kv tile at the middle of the last row
    (tokens 1,024-1,087 of 2,048) made a segment of its own, so the
    queries after it miss those keys; where a row has pad, the plain
    versions with the pad mask ignored (every query attends every key
    before it); ``want`` 10% off in the second half of the last row, as a
    wrong online-softmax rescale in the late tiles would leave it; with a
    window, the plain versions with the window ignored; with a softcap,
    the plain backward with the softcap's 1 - tanh^2 factor left out of dS
    (dq and dk only: the forward and dv do not use dS). Without
    causality (``causal=False``) every plain version takes the full mask,
    and one more fault is the causal mask in its place: the slip of a
    kernel that kept causality. Returns {fault: {tensor: (row-wise error,
    whether the old check, max|d| <= 2e-2 max|ref|, passes it)}}; every
    row-wise error must exceed ATTN_ROW_TOL."""
    import torch

    from unsloth_tpu_torch.ops import flash_attention as tfa
    from unsloth_tpu_torch.ops import splash_attention as tsa

    splash = window is not None or softcap is not None

    def plain(fseg, fwindow=window, fcausal=causal):
        if not splash:
            fout, flse = tfa.flash_attention_fwd_ref(q, k, v, fseg, scale,
                                                     fcausal)
            return (fout,) + tuple(tfa.flash_attention_bwd_ref(
                q, k, v, fseg, fout, flse, dout, scale, fcausal))
        opts = dict(window=fwindow, softcap=softcap, scale=scale,
                    causal=fcausal)
        fout, flse = tsa.splash_attention_fwd_ref(q, k, v, fseg, **opts)
        return (fout,) + tuple(tsa.splash_attention_bwd_ref(
            q, k, v, fseg, fout, flse, dout, **opts))

    mid = seg.shape[1] // 128 * 64
    dropped = seg.clone()
    dropped[-1, mid:mid + 64] = seg.max() + 1
    faults = {"kv tile dropped": plain(dropped)}
    if bool((seg == 0).any()):
        faults["pad mask ignored"] = plain(torch.ones_like(seg))
    late = []
    for ref in want:
        got = ref.clone()
        got[-1, seg.shape[1] // 2:] *= 0.9
        late.append(got)
    faults["late half 10% off"] = late
    if window is not None:
        faults["window ignored"] = plain(seg, fwindow=None)
    if not causal:
        faults["causal mask"] = plain(seg, fcausal=True)
    if softcap is not None:
        faults["softcap derivative dropped"] = (None,) + _grads_without_dtanh(
            q, k, v, seg, dout, window, softcap, scale, causal) + (None,)
    res = {}
    for fault, gots in faults.items():
        res[fault] = {}
        for name, got, ref in zip(("out", "dq", "dk", "dv"), gots, want):
            if got is None:
                continue
            old = ((got.float() - ref.float()).abs().max()
                   <= 2e-2 * ref.float().abs().max())
            res[fault][name] = (attn_row_err(got, ref), bool(old))
    return res


def prefix_segments(layout, prompt_len, completion_lens, device="cpu"):
    """Segment ids [1, T] of one row of the shared-prefix layout (P, G, L)
    as GRPOTrainer builds it: 1 on the prompt, right-aligned in its P
    slots, and on each completion from its region's start; 0 on the pad
    between."""
    import torch

    P, G, L = layout
    seg = torch.zeros((1, P + G * L), dtype=torch.int32)
    seg[0, P - prompt_len:P] = 1
    for r, n in enumerate(completion_lens):
        seg[0, P + r * L:P + r * L + n] = 1
    return seg.to(device)


def layout_skips(P, L, iq, j, bq=64, bk=64):
    """The prefix layout's skip in ``pair_class<true>`` (csrc/
    hopper_tiles.cuh): the layout (P, G, L) masks the whole pair of query
    tile iq (``bq`` tokens) and kv tile j (``bk`` tokens): the kv tile lies
    wholly past the prompt and before the region of the query tile's first
    query past the prompt."""
    q0, k0 = iq * bq, j * bk
    if k0 < P:
        return False
    q = max(q0, P)
    return k0 + bk - 1 < P + (q - P) // L * L


#: K16's (and K18's) tile-pair classes, in the order of its counters
TILE_CLASSES = ("skip", "full", "masked")


def _tile_walk(t, causal, bq, bk, kernel, window, prefix_layout):
    """The (query tile, kv tile) pairs a kernel visits, in its order: the
    forward and dq walk the kv tiles of each query tile (with a window from
    the first one it reaches), dk/dv the query tiles of each kv tile (with
    a window or a prefix layout up to the last one its keys reach)."""
    nq, nk = -(-t // bq), -(-t // bk)
    if kernel == "dkv":
        for j in range(nk):
            k0 = j * bk
            kl = min(k0 + bk - 1, t - 1)
            end = nq
            if window:
                end = min(end, (kl + window - 1) // bq + 1)
            if prefix_layout is not None and k0 >= prefix_layout[0]:
                P, _, L = prefix_layout
                end = min(end, (P + (kl - P) // L * L + L - 1) // bq + 1)
            for iq in range(k0 // bq if causal else 0, end):
                yield iq, j
        return
    for iq in range(nq):
        q0 = iq * bq
        first = max(0, q0 - window + 1) // bk if window else 0
        last = min(nk - 1, (q0 + bq - 1) // bk) if causal else nk - 1
        for j in range(first, last + 1):
            yield iq, j


def flash_tile_classes(segment_ids, causal, bq, bk, window=None,
                       prefix_layout=None, kernel="fwd"):
    """The rule of ``pair_class`` in csrc/hopper_tiles.cuh, the tile-pair
    classes of K16's Hopper kernels (and, given a ``window`` or a
    ``prefix_layout``, K18's, which run on them): {(row, query tile, kv
    tile): class} over the pairs the kernel named ``kernel`` ("fwd", "dq"
    or "dkv") visits with ``bq``-token query tiles and ``bk``-token kv
    tiles (every pair, or, causal, those whose kv tile starts at or before
    the query tile's last token; with a window, those whose nearest pair
    is inside it; dk/dv under a prefix layout ends a kv tile past the
    prompt at its last key's region). A pair is "skip" when its tiles'
    segment-id ranges (each the min of mins and the max of maxes of the
    64-token ranges it spans, as tile_segment_ranges gives them) are
    disjoint, or the layout masks it whole (:func:`layout_skips`); "full"
    when both tiles lie wholly before T, hold one segment id, the same,
    and, causal, the kv tile ends at or before the query tile's first
    token, and besides its farthest pair is inside the window and its kv
    tile lies wholly in the prompt or both tiles in one region; else
    "masked"."""
    seg = [[int(x) for x in row] for row in segment_ids.tolist()]
    t = len(seg[0])
    n64 = -(-t // 64)
    P, _, L = prefix_layout or (0, 0, 1)
    res = {}
    for b, row in enumerate(seg):
        lo = [min(row[e * 64:(e + 1) * 64]) for e in range(n64)]
        hi = [max(row[e * 64:(e + 1) * 64]) for e in range(n64)]

        def span(t0, n):
            first, last = t0 // 64, min((t0 + n - 1) // 64, n64 - 1)
            return (min(lo[first:last + 1]), max(hi[first:last + 1]))

        for iq, j in _tile_walk(t, causal, bq, bk, kernel, window,
                                prefix_layout):
            q0, k0 = iq * bq, j * bk
            (qlo, qhi), (klo, khi) = span(q0, bq), span(k0, bk)
            if (khi < qlo or klo > qhi
                    or (window and q0 - (k0 + bk - 1) >= window)
                    or (prefix_layout is not None
                        and layout_skips(P, L, iq, j, bq, bk))):
                cls = "skip"
            elif (q0 + bq <= t and k0 + bk <= t
                  and qlo == qhi == klo == khi
                  and (not causal or k0 + bk - 1 <= q0)
                  and not (window and q0 + bq - 1 - k0 >= window)
                  and not (prefix_layout is not None and k0 + bk > P and (
                      k0 < P or (k0 - P) // L != (q0 + bq - 1 - P) // L))):
                cls = "full"
            else:
                cls = "masked"
            res[(b, iq, j)] = cls
    return res


def flash_tile_counts(segment_ids, causal, bq, bk, window=None,
                      prefix_layout=None, kernel="fwd"):
    """[skip, full, masked]: the pairs of :func:`flash_tile_classes` by
    class, over every row."""
    classes = list(flash_tile_classes(segment_ids, causal, bq, bk, window,
                                      prefix_layout, kernel).values())
    return [classes.count(c) for c in TILE_CLASSES]


def visited_tile_pairs(t, prefix_layout=None, segment_ids=None, bq=64, bk=64,
                       kernel="fwd"):
    """The causal (query tile, kv tile) pairs of a T = ``t`` row that a
    K18 kernel with ``bq`` x ``bk`` tiles does not skip (full or masked in
    :func:`flash_tile_classes`), with a ``prefix_layout`` or without, over
    the segment ids of one row (None: one segment)."""
    import torch

    seg = (torch.ones((1, t), dtype=torch.int32) if segment_ids is None
           else segment_ids.reshape(1, -1).cpu())
    _, full, masked = flash_tile_counts(seg, True, bq, bk,
                                        prefix_layout=prefix_layout,
                                        kernel=kernel)
    return full + masked


def kernel_tile_classes(q, k, v, seg, dout, scale, causal, splash=None):
    """{"fwd", "dq", "dkv": [skip, full, masked] tile pairs that K16's
    kernel of that name classed, a query head}, read back from the
    kernels' counters (``tile_classes``) on these inputs; with ``splash``
    (a dict of window, softcap and prefix_layout), K18's kernels
    (``tile_counts``)."""
    import torch

    from unsloth_tpu_torch.ops import flash_attention as tfa
    from unsloth_tpu_torch.ops import splash_attention as tsa

    lo, hi = tfa.tile_segment_ranges(seg)
    sfx = "" if causal else "_full"
    n = {w: torch.zeros(3, dtype=torch.int32, device=q.device)
         for w in ("fwd", "dq", "dkv")}
    if splash is None:
        fwd, dq, dkv = (getattr(tfa, f"flash_attention_{w}{sfx}")
                        for w in ("fwd", "dq", "dkv"))
        opts = dict(scale=scale)
        key = "tile_classes"
    else:
        fwd, dq, dkv = (getattr(tsa, f"splash_attention_{w}{sfx}")
                        for w in ("fwd", "dq", "dkv"))
        opts = dict(splash, scale=scale)
        if not causal:
            opts.pop("window")
            opts.pop("prefix_layout")
        key = "tile_counts"
    out, lse = fwd(q, k, v, seg, lo, hi, **opts, **{key: n["fwd"]})
    _, di = dq(q, k, v, seg, lo, hi, out, lse, dout, **opts,
               **{key: n["dq"]})
    dkv(q, k, v, seg, lo, hi, lse, di, dout, **opts, **{key: n["dkv"]})
    heads = q.shape[2]
    counts = {w: c.tolist() for w, c in n.items()}
    if any(x % heads for c in counts.values() for x in c):
        name = "K16" if splash is None else "K18"
        raise RuntimeError(f"{name}'s tile-class counts {counts} are not a "
                           f"whole number a head ({heads} heads)")
    return {w: [x // heads for x in c] for w, c in counts.items()}


def _plain_under_mask(q, k, v, dout, scale, mask, softcap=None,
                      splash=False):
    """(out, dq, dk, dv) of the plain versions' formulas in fp32 under an
    explicit [B, T, T] mask (True: attended): a kernel's result under a
    wrong mask. K16's by default; with ``splash``, K18's (q rounded to its
    dtype after ``scale``, then the ``softcap``)."""
    import torch

    from unsloth_tpu_torch.ops.flash_attention import _expand_kv
    from unsloth_tpu_torch.ops.splash_attention import _capped, _scaled_q

    b, t, hq, d = q.shape
    hkv = k.shape[2]
    qf = _scaled_q(q, scale) if splash else q.float() * scale
    dof = dout.float()
    kf, vf = _expand_kv(k, hq), _expand_kv(v, hq)
    s, tanh = _capped(torch.einsum("bthd,bshd->bhts", qf, kf), softcap)
    s = s.masked_fill(~mask[:, None], float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhts,bshd->bthd", p, vf)
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    di = (dof * out.to(q.dtype).float()).sum(-1).transpose(1, 2)
    ds = p * (dp - di[..., None])
    if tanh is not None:
        ds = ds * (1 - tanh * tanh)
    dq = torch.einsum("bhts,bshd->bthd", ds, kf) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, qf).reshape(
        b, t, hkv, hq // hkv, d).sum(3)
    dv = torch.einsum("bhts,bthd->bshd", p, dof).reshape(
        b, t, hkv, hq // hkv, d).sum(3)
    return (out.to(q.dtype), dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def tile_fault_errs(q, k, v, seg, dout, scale, want, causal, tile=128):
    """The power of :func:`attn_row_err` over K16's tile classes: its
    plain versions under the faults of a class rule that calls a
    ``tile``-token pair full when it is not, so that no element of it is
    masked, held against ``want`` (the right out, dq, dk, dv). Faults:
    with causality, a diagonal pair of one segment (the query tile at the
    middle of the last row with itself: its queries see later keys); and,
    where a row holds a tile of more than one segment id, that kv tile
    with the next query tile (the previous one at the row's end), whose
    queries then see the other segment's keys. Returns {fault: {tensor:
    (row-wise error, whether the old check, max|d| <= 2e-2 max|ref|,
    passes it)}}; every row-wise error must exceed ATTN_ROW_TOL."""
    import torch

    from unsloth_tpu_torch.ops.flash_attention import _mask

    b, t = seg.shape
    mask = _mask(seg, b, t, seg.device, causal=causal)
    n = -(-t // tile)

    def widened(row, iq, j):
        m = mask.clone()
        m[row, iq * tile:(iq + 1) * tile, j * tile:(j + 1) * tile] = True
        return _plain_under_mask(q, k, v, dout, scale, m)

    faults = {}
    if causal:
        mid = n // 2
        faults["diagonal tile as full"] = widened(b - 1, mid, mid)
    for row in range(b):
        mixed = [j for j in range(n)
                 if len(set(seg[row, j * tile:(j + 1) * tile].tolist())) > 1]
        if mixed:
            j = mixed[0]
            iq = j + 1 if j + 1 < n else j - 1
            if iq >= 0:
                faults["mixed-segment tile as full"] = widened(row, iq, j)
                break
    res = {}
    for fault, gots in faults.items():
        res[fault] = {}
        for name, got, ref in zip(("out", "dq", "dk", "dv"), gots, want):
            old = ((got.float() - ref.float()).abs().max()
                   <= 2e-2 * ref.float().abs().max())
            res[fault][name] = (attn_row_err(got, ref), bool(old))
    return res


def splash_tile_fault_errs(q, k, v, seg, dout, scale, want, *, window=None,
                           softcap=None, prefix_layout=None, tile=128):
    """The power of :func:`attn_row_err` over K18's tile rules: its plain
    versions under the faults of a class rule that calls a ``tile``-token
    (query tile, earlier kv tile) pair full when it is not, so that no
    element of it is masked, held against ``want`` (the right out, dq, dk,
    dv), in the last row. Faults: with a ``window``, the first pair that
    holds pairs inside the window and past it ("pair past the window as
    full": its queries see keys past their window); with a
    ``prefix_layout``, the first pair whose queries and keys lie past the
    prompt in two regions ("pair across regions as full": a completion
    sees an earlier one). Returns {fault: {tensor: (row-wise error,
    whether the old check, max|d| <= 2e-2 max|ref|, passes it)}}; every
    row-wise error must exceed ATTN_ROW_TOL."""
    import torch

    from unsloth_tpu_torch.ops.splash_attention import _splash_mask

    b, t = seg.shape
    mask = _splash_mask(seg, b, t, seg.device, window, prefix_layout)
    n = -(-t // tile)
    pos = torch.arange(t, device=seg.device)

    def first_pair(bad):
        """The first (iq, j < iq) whose block holds a pair ``bad`` marks."""
        for iq in range(n):
            for j in range(iq):
                qs_, ks_ = (slice(x * tile, min(t, (x + 1) * tile))
                            for x in (iq, j))
                if bool(bad[qs_, ks_].any()):
                    return qs_, ks_
        return None

    faults = {}
    if window is not None:
        diff = pos[:, None] - pos[None, :]
        found = first_pair(diff >= window)
        if found is not None:
            faults["pair past the window as full"] = found
    if prefix_layout is not None:
        P, _, L = prefix_layout
        reg = torch.where(pos >= P, (pos - P) // L, -1)
        found = first_pair((reg[:, None] > reg[None, :]) & (reg[None, :] >= 0))
        if found is not None:
            faults["pair across regions as full"] = found
    res = {}
    for fault, (qs_, ks_) in faults.items():
        m = mask.clone()
        m[b - 1, qs_, ks_] = True
        gots = _plain_under_mask(q, k, v, dout, scale, m, softcap,
                                 splash=True)
        res[fault] = {}
        for name, got, ref in zip(("out", "dq", "dk", "dv"), gots, want):
            old = ((got.float() - ref.float()).abs().max()
                   <= 2e-2 * ref.float().abs().max())
            res[fault][name] = (attn_row_err(got, ref), bool(old))
    return res


def prefix_fault_errs(q, k, v, seg, dout, scale, layout, want):
    """The power of :func:`attn_row_err` over K18's prefix form: the plain
    versions under two faults a wrong layout mask would make, held
    against ``want`` (the right out, dq, dk, dv): the region rule dropped
    (plain causal over the row, so each completion sees the ones before
    it) and the prefix dropped (each completion sees itself only: every
    region made a segment of its own). Returns {fault: {tensor: (row-wise
    error, whether the old check, max|d| <= 2e-2 max|ref|, passes it)}};
    every row-wise error must exceed ATTN_ROW_TOL."""
    from unsloth_tpu_torch.ops import splash_attention as tsa

    P, G, L = layout
    opts = dict(window=None, softcap=None, scale=scale)

    def plain(fseg, flayout):
        fout, flse = tsa.splash_attention_fwd_ref(
            q, k, v, fseg, prefix_layout=flayout, **opts)
        return (fout,) + tuple(tsa.splash_attention_bwd_ref(
            q, k, v, fseg, fout, flse, dout, prefix_layout=flayout, **opts))

    own = seg.clone()
    for r in range(G):
        own[:, P + r * L:P + (r + 1) * L] += (r + 1) * (int(seg.max()) + 1)
    faults = {"region rule dropped": plain(seg, None),
              "prefix dropped": plain(own, None)}
    res = {}
    for fault, gots in faults.items():
        res[fault] = {}
        for name, got, ref in zip(("out", "dq", "dk", "dv"), gots, want):
            old = ((got.float() - ref.float()).abs().max()
                   <= 2e-2 * ref.float().abs().max())
            res[fault][name] = (attn_row_err(got, ref), bool(old))
    return res


def _grads_without_dtanh(q, k, v, seg, dout, window, softcap, scale,
                         causal=True):
    """(dq, dk) of capped attention as a kernel that leaves the softcap's
    1 - tanh^2 factor out of dS would give them: autograd through the
    capped scores with the cap's derivative taken as 1, one kv head (and
    its query heads) at a time, in fp32."""
    import torch

    from unsloth_tpu_torch.ops.flash_attention import _mask

    b, t, hq, _ = q.shape
    n_rep = hq // k.shape[2]
    mask = _mask(seg, b, t, q.device, window, causal)[:, None]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    for h in range(k.shape[2]):
        grp = slice(h * n_rep, (h + 1) * n_rep)
        qh = q[:, :, grp].float().requires_grad_(True)
        kh = k[:, :, h].float().requires_grad_(True)
        s = torch.einsum("btgd,bsd->bgts", qh * scale, kh)
        s = s + (softcap * torch.tanh(s / softcap) - s).detach()
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out = torch.einsum("bgts,bsd->btgd", p, v[:, :, h].float())
        dq[:, :, grp], dk[:, :, h] = torch.autograd.grad(
            out, (qh, kh), dout[:, :, grp].float())
    return dq.to(q.dtype), dk.to(k.dtype)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(f"[device] {name} capability {cap[0]}.{cap[1]} "
        f"count {torch.cuda.device_count()} torch {torch.__version__} "
        f"cuda {torch.version.cuda} python {sys.version.split()[0]}")
    if cap != (9, 0):
        raise RuntimeError(f"expected an sm_90 card (H100), got {cap}")
    from unsloth_tpu_torch import kernels

    r = subprocess.run([kernels.find_nvcc(), "--version"],
                       capture_output=True, text=True, check=True)
    log("[device] nvcc:", r.stdout.strip().splitlines()[-1])
    smi = _smi_name_power()
    log(f"[device] nvidia-smi: {smi}")
    return name, smi


def attention_build_report(build_log):
    """([(kernel, registers, spill-store bytes)] of each instantiation of
    the Hopper attention kernels (K16's ``flash_fwd_kernel<D, false,
    false>`` and ``flash_{dq,dkv}_kernel<D, false>``, K18's ``<D, true,
    false>`` and ``<D, true>``, K17's forward ``<D, false, true>``), of
    K1's and K12's Hopper kernel (``nf4_wgmma_kernel<BX, kFp8>``), of K2's
    and K13's (``nf4_dx_wgmma_kernel<BX, kFp8>``), of K14's
    (``nf4_gmm_wgmma_kernel<BX>``), of K15's
    (``nf4_gmm_dx_wgmma_kernel<BX>``), of K1's and K12's decode kernel
    (``decode_matmul_kernel<policy, NT>``) and of its grouped form, K14's
    and K19's at decode rows (``grouped_decode_kernel<policy, NT>``) in
    ptxas's ``-v`` output, [the C75xx lines, ptxas serializing their
    wgmma, that name one])."""
    import re

    rows, name, spill = [], None, 0
    lines = build_log.splitlines()
    for line in lines:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(flash_(?:fwd|dq|dkv)_kernel)ILi(\d+)ELb(\d)E"
                          r"(?:Lb(\d)E)?", m.group(1))
            kind = None if k is None else (
                "K17" if k.group(4) == "1" else
                "K18" if k.group(3) == "1" else "K16")
            name = f"{k.group(1)}<{k.group(2)}, {kind}>" if k else None
            n = re.search(r"nf4_wgmma_kernelILi(\d+)E(?:Lb(\d)E)?",
                          m.group(1))
            if n:
                name = (f"nf4_wgmma_kernel<{n.group(1)}, "
                        f"{'K12' if n.group(2) == '1' else 'K1'}>")
            n = re.search(r"nf4_dx_wgmma_kernelILi(\d+)E(?:Lb(\d)E)?",
                          m.group(1))
            if n:
                name = (f"nf4_dx_wgmma_kernel<{n.group(1)}, "
                        f"{'K13' if n.group(2) == '1' else 'K2'}>")
            n = re.search(r"nf4_gmm_wgmma_kernelILi(\d+)E", m.group(1))
            if n:
                name = f"nf4_gmm_wgmma_kernel<{n.group(1)}, K14>"
            n = re.search(r"nf4_gmm_dx_wgmma_kernelILi(\d+)E", m.group(1))
            if n:
                name = f"nf4_gmm_dx_wgmma_kernel<{n.group(1)}, K15>"
            n = re.search(r"decode_matmul_kernelILi(\d)ELi(\d)E", m.group(1))
            if n:
                name = (f"decode_matmul_kernel<"
                        f"{DECODE_POLICIES[int(n.group(1))]}, "
                        f"NT {n.group(2)}>")
            n = re.search(r"grouped_decode_kernelILi(\d)ELi(\d)E",
                          m.group(1))
            if n:
                name = (f"grouped_decode_kernel<"
                        f"{GROUPED_POLICIES[int(n.group(1))]}, "
                        f"NT {n.group(2)}>")
            spill = 0
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows.append((name, int(m.group(1)), spill))
            name = None
    serialized = [line.strip() for line in lines
                  if re.search(r"C75\d\d", line)
                  and re.search(r"flash_(fwd|dq|dkv)_kernel|"
                                r"nf4_(?:dx_|gmm_|gmm_dx_)?wgmma_kernel|"
                                r"(?:grouped_)?decode(?:_matmul)?_kernel",
                                line)]
    return rows, serialized


#: Hopper instantiations phase 2 holds to 0 spill and no serialized wgmma:
#: K16's and K18's nine, K17's three forwards, two tile heights each of
#: K1, K12 (K1's kernel in its e4m3 form), K2, K13 (K2's kernel in its e4m3
#: form), K14 (K1's under the grouped schedule) and K15 (K2's under it),
#: the decode kernel's three weight policies at one and two n-tiles, and
#: its grouped form's two (K14's NF4 experts, K19's bf16 ones) at one and
#: two
HOPPER_BUILD_ROWS = 21 + 2 + 2 + 2 + 2 + 2 + 2 + 6 + 4
#: K4's and K6's backward instantiations phase 2 holds to 0 spill
#: (csrc/norm_common.cuh): for each of the four (x, w) dtype pairs the row
#: form at 2 and 4 chunks a lane, dx alone and with dW (and dB), and the
#: strided form; K6 with bf16 x has no 4-chunk row form (its lane budget)
NORM_BUILD_ROWS = 4 * 5 + 2 * 5 + 2 * 3


def norm_build_report(build_log):
    """[(kernel, registers, spill-store bytes)] of each instantiation of
    K4's and K6's backward kernels (``rms_norm_bwd_kernel<TX, TW, C, kDw>``,
    ``layer_norm_bwd_kernel<...>``) in ptxas's ``-v`` output."""
    import re

    rows, name, spill = [], None, 0
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(rms|layer)_norm_bwd_kernelI(\w*?)Li(\d)ELb(\d)E",
                          m.group(1))
            name = None
            if k:
                tx = "bf16" if k.group(2).startswith("13__nv_bfloat16") \
                    else "f32"
                rest = k.group(2)[len("13__nv_bfloat16") if tx == "bf16"
                                  else 1:]
                tw = "bf16" if "bfloat16" in rest or rest.startswith("S") \
                    else "f32"
                form = ("strided" if k.group(3) == "0" else
                        f"C {k.group(3)}" + (", dW" if k.group(4) == "1"
                                             else ", dx"))
                name = f"{k.group(1)}_norm_bwd_kernel<{tx}, {tw}, {form}>"
            spill = 0
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


#: the decode kernel's weight policies (csrc/decode_matmul.cu, Policy)
DECODE_POLICIES = ("K1", "K12", "K12 any shape")
#: its grouped form's (csrc/decode_matmul.cu, GroupedPolicy)
GROUPED_POLICIES = ("K14", "K19")


def phase_build(hold=True):
    """Build the kernels and print ptxas's registers and spills; the 21
    Hopper attention kernels (K16's and K18's nine, K17's three forwards),
    the Hopper dequant-matmul kernels (K1, K12, K2, K13, K14 and K15, two
    tile heights each), the decode kernel (three policies, two n-tile
    counts) and its grouped form (K14's and K19's decode rows, two n-tile
    counts each) must report no spill and no serialized wgmma
    (:func:`attention_build_report`), and K4's and K6's backward
    instantiations no spill (:func:`norm_build_report`); with ``hold``
    False (another checkout's build, profiled by ``--tree``) they are only
    reported."""
    from unsloth_tpu_torch import kernels

    t0 = time.perf_counter()
    path = kernels.build()
    kernels.library()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {kernels.build_seconds} s)")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("[build]  ", line.strip())
    if not kernels.build_log.strip():
        raise RuntimeError(f"no build log beside {path.name}: the "
                           "Hopper kernels' registers and spills are "
                           "unknown")
    rows, serialized = attention_build_report(kernels.build_log)
    log("[build] Hopper attention and NF4 kernels (registers, spill "
        "bytes): " + ", ".join(f"{n} {r}/{b}" for n, r, b in rows))
    for line in serialized:
        log("[build] ", line)
    if hold and (len(rows) != HOPPER_BUILD_ROWS
                 or any(b for _, _, b in rows) or serialized):
        raise RuntimeError(f"the Hopper attention kernels, the Hopper "
                           f"K1 / K12 / K2 / K13 / K14 / K15 kernels or the "
                           f"decode kernel spill or serialize their wgmma "
                           f"(or are not all built): "
                           f"{rows}, "
                           f"{serialized}")
    norm_rows = norm_build_report(kernels.build_log)
    log("[build] K4 / K6 backward kernels (registers, spill bytes): "
        + ", ".join(f"{n} {r}/{b}" for n, r, b in norm_rows))
    if hold and (len(norm_rows) != NORM_BUILD_ROWS
                 or any(b for _, _, b in norm_rows)):
        raise RuntimeError(f"the K4 / K6 backward kernels spill (or are not "
                           f"all built): {norm_rows}")


def phase_kernels():
    """Each kernel against its plain version at the main paths' shapes: the
    Llama-3.1-8B ones and, for K1-K4, K7/K8 and K18, Gemma-2-9B's (K1 and
    K2 at its five projection shapes at M = 4,096, one [2, 2048]
    micro-batch; K3/K4 at [4096, 3584]).

    Tolerances: NF4 matmul in bf16, max|y - ref| <= 1e-2 * max|ref| (both
    round the same bf16 weights and sum in fp32, in another order, then
    round the output to bf16: one output ulp is <= 2^-8 of the value).
    RMSNorm: <= 1 ulp of the output dtype for bf16 (the fp32 result differs
    in the last fp32 bits, then rounds); <= 8 fp32 ulp for fp32 (another
    sum order and rsqrtf).

    Beside each kernel's time: its bound (:func:`bound`, from the bytes and
    operations these inputs need) and the time of the one PyTorch call that
    computes the same function (``library_ms``). No single call
    dequantizes and multiplies, so the NF4 matmuls take the two-call
    yardstick of K12/K13 instead: ``dequantize_nf4`` + ``torch.matmul``,
    labelled "(two calls)", at every K1 row. K1 runs at Llama's rows
    NF4_CROSSOVER_ROWS (64, 256 and a ragged 1,500: the Hopper kernel's
    128- and 256-row tiles and a partial one), the prefill's and the
    training path's; the Hopper kernel's counters (output tiles, stages)
    must equal its schedule's (:func:`unsloth_tpu_torch.ops.qlora_matmul.
    nf4_tile_schedule`). K1's and K12's decode rows are
    :func:`_decode_kernels`'."""
    import torch
    import torch.nn.functional as F

    from unsloth_tpu_torch.ops.nf4 import dequantize_nf4, quantize_nf4
    from unsloth_tpu_torch.ops.qlora_matmul import (STAGE_BYTES,
                                                    _nf4_matmul_fwd,
                                                    nf4_matmul,
                                                    nf4_tile_schedule)
    from unsloth_tpu_torch.ops.rms_norm import rms_norm, rms_norm_ref

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    t_part = time.perf_counter()
    rows = {"nf4_matmul": [], "rms_norm": []}
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    for name, n, k, row_counts in (
            [(name, n, k, NF4_CROSSOVER_ROWS + (PREFILL_ROWS, TRAIN_ROWS))
             for name, n, k in PROJ_SHAPES]
            + [("gemma2 " + name, n, k, (2 * UNPACKED_ROWS,))
               for name, n, k in GEMMA2_PROJ_SHAPES]
            + [("gpt-oss " + name, n, k, (GPT_OSS_ROWS,))
               for name, n, k in GPT_OSS_PROJ_SHAPES]):
        w = (torch.randn((n, k), generator=g, device=dev) * 0.02
             ).to(torch.bfloat16)
        q = quantize_nf4(w, dtype=torch.bfloat16)
        del w
        for m in row_counts:
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            counts.zero_()
            y = _nf4_matmul_fwd(x, q, tile_counts=counts)
            ref, plain_ms = once_ms(lambda: torch.matmul(
                x, dequantize_nf4(q, torch.bfloat16).t()))
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            ok = bool(torch.isfinite(y).all()) and err <= 1e-2 * scale
            got_c = counts.tolist()
            tiles = sum(map(len, nf4_tile_schedule(m, n)))
            want_c = [tiles, tiles * (k // 2 // STAGE_BYTES)]
            ms = time_ms(lambda: nf4_matmul(x, q), flush=flush)
            lib_ms = time_ms(lambda: torch.matmul(
                x, dequantize_nf4(q, torch.bfloat16).t()), runs=10,
                flush=flush)
            b_ms, b_by = bound(2 * m * n * k, nbytes(x) + q.nbytes + m * n * 2)
            rows["nf4_matmul"].append(dict(shape=f"{name} M={m} N={n} K={k}",
                                           err=err, tol=1e-2 * scale,
                                           ms=ms, plain_ms=plain_ms,
                                           bound_ms=b_ms, bound_by=b_by,
                                           library_ms=lib_ms,
                                           library=NF4_LIBRARY,
                                           tile_counts=got_c))
            log(f"[kernels] nf4_matmul {name:15s} M={m:<5d} N={n:<6d} "
                f"K={k:<6d}"
                f" max|d|={err:.3e} (tol {1e-2 * scale:.3e})"
                f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms"
                f" {NF4_LIBRARY} {lib_ms:.4f} ms bound {b_ms:.4f} ms"
                f" ({100 * b_ms / ms:.1f}%); tiles, stages {got_c}"
                f" (schedule {want_c})")
            if not ok:
                raise RuntimeError(f"nf4_matmul disagrees at {name} M={m}: "
                                   f"max|d| {err} > 1e-2 * {scale}")
            if got_c != want_c:
                raise RuntimeError(f"nf4_matmul at {name} M={m}: the kernel "
                                   f"counted {got_c} (tiles, stages), its "
                                   f"schedule {want_c}")
    for shape in ((TRAIN_ROWS, 4096), (4096, 4096), (4, 4096),
                  (2 * UNPACKED_ROWS, GEMMA2_9B_CONFIG["hidden_size"])):
        for dtype in (torch.bfloat16, torch.float32):
            for gemma in (False, True):
                x = torch.randn(shape, generator=g, device=dev).to(dtype)
                w = (1.0 + 0.1 * torch.randn((shape[-1],), generator=g,
                                             device=dev)).to(dtype)
                y = rms_norm(x, w, 1e-5, gemma)
                ref, plain_ms = once_ms(
                    lambda: rms_norm_ref(x, w, 1e-5, gemma))
                torch.cuda.synchronize()
                d = y.float() - ref.float()
                ulps = ulps_bf16_or_f32(d, ref, dtype)
                limit = 1 if dtype == torch.bfloat16 else 8
                ms = time_ms(lambda: rms_norm(x, w, 1e-5, gemma), flush=flush)
                # F.rms_norm computes the plain (not Gemma) form
                lib_ms = None if gemma else time_ms(
                    lambda: F.rms_norm(x, (shape[-1],), w, 1e-5), flush=flush)
                b_ms, b_by = bound(4 * x.numel(), 2 * nbytes(x) + nbytes(w),
                                   PEAK_FP32)
                rows["rms_norm"].append(dict(
                    shape=f"{list(shape)} {str(dtype)[6:]} gemma={gemma}",
                    err=d.abs().max().item(), ulps=ulps, ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms))
                log(f"[kernels] rms_norm {list(shape)} {str(dtype)[6:]:8s} "
                    f"gemma={gemma!s:5s} max|d|={d.abs().max().item():.3e} "
                    f"({ulps:.2f} ulp, limit {limit}) kernel {ms:.4f} ms "
                    f"plain {plain_ms:.4f} ms")
                if not (bool(torch.isfinite(y).all()) and ulps <= limit):
                    raise RuntimeError(f"rms_norm disagrees at {shape} {dtype}"
                                       f" gemma={gemma}: {ulps} ulp")
    log(f"[time] 3 K1, K3: {time.perf_counter() - t_part:.1f} s")
    for part, fn in (("K1/K12 decode rows", _decode_kernels),
                     ("K14/K19 decode rows", _gmm_decode_kernels),
                     ("K6 one launch", _layer_norm_launches),
                     ("K2, K4, K9-K11", _training_kernels),
                     ("K7/K8, K16", _unpacked_kernels),
                     ("K18", _splash_kernels),
                     ("K18 prefix", _grpo_kernels),
                     ("K14/K15, K17, K19", _gpt_oss_kernels),
                     ("head dims 64/256", _small_model_kernels),
                     ("K5/K6", _layer_norm_kernels),
                     ("K12/K13", _fp8_kernels),
                     ("K16/K18 non-causal", _diffusion_kernels)):
        t_part = time.perf_counter()
        for name, extra in fn(dev, g, flush).items():
            rows.setdefault(name, []).extend(extra)
        log(f"[time] 3 {part}: {time.perf_counter() - t_part:.1f} s")
    del flush
    torch.cuda.empty_cache()
    return rows


def phase_library_times():
    """``--library-times``: the library yardsticks that the default run
    leaves out for time (each flex_attention shape costs ~20-30 s of
    compile): compiled flex_attention + the sink rescale at K17's (b)
    padded [2, 2048] and (c) Dh 128 and 256 shapes, compiled
    flex_attention with the softcap ``score_mod`` and the window at K18's
    (b)-(d), and ``torch._grouped_mm`` against K19 at every routing with
    both timed as :func:`_settled_ms`. Runs phase 3's K18 and gpt-oss parts
    with LIBRARY_TIMES set (their checks too) and logs each row with a
    library time; returns those rows."""
    import torch

    global LIBRARY_TIMES
    LIBRARY_TIMES = True
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    for part, fn in (("K18", _splash_kernels),
                     ("K14/K15, K17, K19", _gpt_oss_kernels)):
        t_part = time.perf_counter()
        for name, extra in fn(dev, g, flush).items():
            rows.setdefault(name, []).extend(extra)
        log(f"[time] library times, {part}: "
            f"{time.perf_counter() - t_part:.1f} s")
    for name, extra in rows.items():
        for row in extra:
            if row.get("library_ms"):
                log(f"[library] {name} {row['shape']}: kernel "
                    f"{row['ms']:.4f} ms, "
                    f"{row.get('library') or 'compiled flex_attention'} "
                    f"{row['library_ms']:.4f} ms (kernel / library "
                    f"{row['ms'] / row['library_ms']:.3f})")
    return rows


def _packed_segments(rng, t):
    """Segment ids [1, t]: documents of DOC_LENGTHS tokens laid end to end
    while they fit, then a pad tail (id 0)."""
    import numpy as np

    seg = np.zeros((1, t), np.int32)
    pos, sid = 0, 1
    while True:
        n = int(rng.integers(DOC_LENGTHS[0], DOC_LENGTHS[1] + 1))
        if pos + n > t - 1:
            break
        seg[0, pos:pos + n] = sid
        pos, sid = pos + n, sid + 1
    return seg


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _autograd_ms(fn, inputs, grad_out, flush, runs=10):
    """Median ms of the autograd backward of ``fn(*inputs)`` alone: the
    graph is built once and its backward run again and again."""
    import torch

    leaves = [t.detach().requires_grad_(True) for t in inputs]
    y = fn(*leaves)
    ms = time_ms(lambda: torch.autograd.grad(y, leaves, grad_out,
                                             retain_graph=True),
                 runs=runs, flush=flush)
    del y, leaves
    return ms


def _sdpa_ms(q, k, v, segment_ids, dout, flush, window=None,
             prefix_layout=None, causal=True):
    """(forward ms, backward ms) of the one PyTorch call that computes the
    attention kernels' function: ``F.scaled_dot_product_attention`` with a
    boolean mask (causal unless ``causal`` is False, equal segment ids
    and, where given, within the window or the prefix layout's dense
    [T, T] mask; never ``is_causal``) and ``enable_gqa=True``, in its
    [B, H, T, D] layout. A yardstick only; the port never calls it."""
    import torch
    import torch.nn.functional as F

    from unsloth_tpu_torch.ops.splash_attention import _splash_mask

    mask = _splash_mask(segment_ids, q.shape[0], q.shape[1], q.device,
                        window, prefix_layout, causal)[:, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, attn_mask=mask,
                                              enable_gqa=True)

    fwd = time_ms(lambda: sdpa(qt, kt, vt), runs=5, warmup=1, flush=flush)
    bwd = _autograd_ms(sdpa, (qt, kt, vt), dout.transpose(1, 2), flush,
                       runs=5)
    del mask
    torch.cuda.empty_cache()
    return fwd, bwd


def _flex_ms(q, k, v, segment_ids, dout, flush, want, *, window, softcap,
             scale, causal=True):
    """(forward ms, backward ms, row-wise error of its out against
    ``want``) of the one PyTorch call that computes the splash kernels'
    function: ``torch.compile``d ``flex_attention`` in its [B, H, T, D]
    layout, with the softcap c * tanh(s / c) as its ``score_mod``, a block
    mask of causal (unless ``causal`` is False), within the window and
    equal segment ids, and ``enable_gqa=True``, on q * scale rounded to
    q's dtype (what the kernels and the JAX wrapper score; the timed call
    includes that product). The window, causality and segment ids reach
    the mask as tensors, so cases of one shape share a compiled kernel, and
    the inputs
    require a gradient throughout, so that one compiled graph serves the
    forward and the backward. A yardstick only; the port never calls it."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask

    flex_compiled = _compiled_flex()
    b, t = segment_ids.shape
    seg = segment_ids.to(torch.int32)
    win = torch.tensor(window or t, device=q.device)
    every = torch.tensor(not causal, device=q.device)

    def mask_mod(bi, h, qi, ki):
        return (((ki <= qi) | every) & (qi - ki < win)
                & (seg[bi, qi] == seg[bi, ki]))

    def score_mod(s, bi, h, qi, ki):
        return softcap * torch.tanh(s / softcap)

    mask = create_block_mask(mask_mod, b, None, t, t, device=q.device)

    def flex(a, b_, c):
        # q scaled and rounded in its dtype first, as the kernels take it
        return flex_compiled((a * scale).to(a.dtype), b_, c,
                     score_mod=score_mod if softcap else None,
                     block_mask=mask, scale=1.0, enable_gqa=True)

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    err = attn_row_err(flex(qt, kt, vt).detach().transpose(1, 2), want)
    fwd = time_ms(lambda: flex(qt, kt, vt), runs=5, warmup=1, flush=flush)
    bwd = _autograd_ms(flex, (qt, kt, vt), dout.transpose(1, 2), flush,
                       runs=5)
    del mask
    torch.cuda.empty_cache()
    return fwd, bwd, err


#: the compiled flex_attention of the yardsticks, made at first use
_FLEX = None


def _compiled_flex():
    """``torch.compile``d ``flex_attention``, compiled once for the
    yardsticks (:func:`_flex_ms`, :func:`_flex_sinks_ms`): forward and
    forward-for-backward of several shapes; a backward timed again and
    again on one graph (retain_graph) must not donate its buffers."""
    import torch
    from torch.nn.attention.flex_attention import flex_attention

    global _FLEX
    if _FLEX is None:
        torch._dynamo.config.recompile_limit = 64
        torch._functorch.config.donated_buffer = False
        _FLEX = torch.compile(flex_attention)
    return _FLEX


def nf4_dx_faults(gy, q, ref):
    """dx as a wrong K2 would compute it from g ``gy`` and NF4 ``q``
    (``ref`` the right one), in plain PyTorch: the low side's columns 32-63
    of each 64-column tile read with the absmax of the block before theirs
    (one absmax a tile: where K/2 % 64 == 32 the tile straddles two
    blocks), and, where K/2 % 64 == 32, the high side's last tile stored
    past K/2: its zero bytes there decode to NF4 code 0 (-absmax) and land
    on the low side's first 32 columns."""
    import torch

    from unsloth_tpu_torch.ops.nf4 import NF4_CODE, _decode_absmax

    n, k = q.shape
    half = k // 2
    am = _decode_absmax(q).float().reshape(n, k // 64)
    cols = torch.arange(k, device=gy.device)
    blk = cols // 64
    upper = (cols >= half) & ((cols - half) % 64 >= 32)
    blk = torch.where(upper, (blk - 1).clamp(min=0), blk)
    code = NF4_CODE.to(gy.device).float()
    nib = torch.cat([q.packed >> 4, q.packed & 15], dim=1).long()
    w = (code[nib] * am[:, blk]).to(gy.dtype)
    faults = {"low side's upper columns with the block before theirs":
              torch.matmul(gy, w)}
    if half % 64 == 32:
        garbage = torch.matmul(gy, (code[0] * am[:, half // 64]).to(
            gy.dtype)[:, None])
        bad = ref.clone()
        bad[:, half:half + 32] = garbage.to(ref.dtype)
        faults["high side stored past K/2"] = bad
    return faults


def rms_bwd_errs(dtype, got, want):
    """Phase 3's check of K4 against its plain version, each part's worst
    element in units of its limit (<= 1 passes), for (dx, dW) and their
    plain counterparts; dW None (the dx-only form): dx alone. dx: 2 ulps
    of its dtype (2^-7 |dx| in bf16, 2^-21 in fp32: the fp32 result
    differs in its last bits, then rounds) plus 1e-5 max|dx| (its terms
    cancel to near zero); dW: an fp32 sum over the rows in another order,
    rounded to w's dtype, within one bf16 ulp of max|dW| (2^-7) in bf16 and
    1e-3 of it in fp32."""
    import torch

    (dx, dw), (rdx, rdw) = got, want
    bf16 = dtype == torch.bfloat16
    r = rdx.float().abs()
    res = {"dx": ((dx.float() - rdx.float()).abs()
                  / ((2.0 ** -7 if bf16 else 2.0 ** -21) * r
                     + 1e-5 * r.max())).max().item()}
    if dw is not None:
        res["dW"] = ((dw.float() - rdw.float()).abs().max()
                     / ((2.0 ** -7 if bf16 else 1e-3)
                        * rdw.float().abs().max())).item()
    return res


def norm_bwd_faults(x, w, gy, eps, form, gemma=False, layer=False):
    """The backward of K4 (``layer`` False; ``gemma``: the scale 1 + w) or
    K6 as a wrong kernel would leave it, in plain PyTorch, for the
    check to reject: "dW without a block's partial row" (the rows that
    ``form``, :func:`unsloth_tpu_torch.ops.rms_norm.norm_bwd_form`'s, gives
    block blocks // 2 left out of dW, and of K6's dB) and "dx without its
    mean term" (the xhat * mean(g s xhat) term dropped: K4's dx = inv g s,
    K6's inv (g w - mean(g w))), each beside the right other parts."""
    import torch

    from unsloth_tpu_torch.ops.rms_norm import (layer_norm_bwd_ref,
                                                rms_norm_bwd_ref)

    keep = (form.block_of_rows(x.shape[0]) != form.blocks // 2).to(x.device)
    xf, gf, wf = x.float(), gy.float(), w.float()
    if layer:
        full = layer_norm_bwd_ref(x, w, gy, eps)
        part = layer_norm_bwd_ref(x[keep], w, gy[keep], eps)
        c = xf - xf.mean(-1, keepdim=True)
        inv = torch.rsqrt((c * c).mean(-1, keepdim=True) + eps)
        gs = gf * wf
        no_mean = (inv * (gs - gs.mean(-1, keepdim=True))).to(x.dtype)
        return {"dW without a block's partial row":
                (full[0], part[1], part[2]),
                "dx without its mean term": (no_mean, full[1], full[2])}
    full = rms_norm_bwd_ref(x, w, gy, eps, gemma)
    part = rms_norm_bwd_ref(x[keep], w, gy[keep], eps, gemma)
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    no_mean = (inv * gf * ((1.0 + wf) if gemma else wf)).to(x.dtype)
    return {"dW without a block's partial row": (full[0], part[1]),
            "dx without its mean term": (no_mean, full[1])}


#: K4 in phase 3: (rows, hidden, gemma, dtype) at every main path's width:
#: Llama-3.1-8B's packed 8K row (plain and Gemma's scale; fp32 too),
#: Gemma-2-9B's 2 x 2,048 rows, gpt-oss-20b's 4,096, Orpheus-3B's 2,048,
#: Llama-3.2-1B's and Qwen2.5-0.5B's 2 x 2,048
def k4_cases():
    return ([(TRAIN_ROWS, 4096, False, "bfloat16"),
             (TRAIN_ROWS, 4096, True, "bfloat16"),
             (2 * UNPACKED_ROWS, GEMMA2_9B_CONFIG["hidden_size"], True,
              "bfloat16"),
             (GPT_OSS_ROWS, GPT_OSS_20B_CONFIG["hidden_size"], False,
              "bfloat16"),
             (ORPHEUS_ROWS, ORPHEUS_3B_CONFIG["hidden_size"], False,
              "bfloat16"),
             (2 * UNPACKED_ROWS, LLAMA_32_1B_CONFIG["hidden_size"], False,
              "bfloat16"),
             (2 * UNPACKED_ROWS, QWEN25_05B_CONFIG["hidden_size"], False,
              "bfloat16"),
             (2 * UNPACKED_ROWS, 4096, False, "float32")])


def _norm_bwd_case(kind, x, w, gy, eps, plain, flush, gemma=False,
                   lib_call=None, count_ops=True):
    """Both forms of K4 (``kind`` "rms_norm_bwd") or K6 ("layer_norm_bwd")
    on one input against the plain version's ``plain`` (its (result, ms)):
    each form's errors (:func:`rms_bwd_errs`, :func:`ln_bwd_errs`), the
    same bits from a second call, dx the same bits
    in both forms, one device operation a dx-only call (torch.profiler),
    (unless ``count_ops`` is False: K6's count runs in
    :func:`_layer_norm_launches`), the faults of :func:`norm_bwd_faults`
    above their limits, the times,
    the library's backward (``lib_call(x, w)`` under autograd, with w a
    leaf in the dW form) and the bound (x and g read, dx written, w read,
    dW (and dB) written; 8 or 14 fp32 operations an element). Returns
    ({form: row}, log line); raises on a failed check."""
    import torch

    from unsloth_tpu_torch.ops.rms_norm import (layer_norm_bwd,
                                                norm_bwd_form_for,
                                                rms_norm_bwd)

    layer = kind == "layer_norm_bwd"
    dtype = x.dtype
    (ref, plain_ms) = plain

    def call(need):
        if layer:
            return layer_norm_bwd(x, w, gy, eps, need_dw=need)
        return rms_norm_bwd(x, w, gy, eps, gemma, need_dw=need)

    def errs(got):
        return (ln_bwd_errs if layer else rms_bwd_errs)(dtype, got, ref)

    out, lines = {}, []
    dx_of = {}
    for need in (False, True):
        got, again = call(need), call(need)
        torch.cuda.synchronize()
        e = errs(got)
        same = all(torch.equal(a, b) for a, b in zip(got, again)
                   if a is not None)
        dx_of[need] = got[0]
        ops = None
        if not need and count_ops:
            ops = launched_kernels(lambda: call(False), tries=6)
            if len(ops) != 1 or any(t is not None for t in got[1:]):
                raise RuntimeError(f"{kind} dx only at {list(x.shape)}: "
                                   f"launched {ops}, dW {got[1:]}")
        ms = time_ms(lambda: call(need), flush=flush)
        leaves = (x, w) if need else (x,)
        lib_ms = None if lib_call is None else _autograd_ms(
            (lambda a, b: lib_call(a, b)) if need
            else (lambda a: lib_call(a, w)), leaves, gy, flush)
        sums = (2 if layer else 1) if need else 0
        b_ms, b_by = bound((14 if layer else 8) * x.numel(),
                           3 * nbytes(x) + nbytes(w)
                           + sums * x.shape[-1] * (4 if layer else
                                                   w.element_size()),
                           PEAK_FP32)
        form = "dx + dW" if need else "dx only"
        out[need] = dict(err=max((a.float() - r_.float()).abs().max().item()
                                 for a, r_ in zip(got, ref)
                                 if a is not None),
                         errs=e, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, same_bits=same)
        lines.append(f"{form}: errors in units of their limits "
                     f"{ {k_: round(v_, 4) for k_, v_ in e.items()} }, same "
                     f"bits run twice {same}"
                     + (f", one call {len(ops)} device op(s)" if ops else "")
                     + f"; kernel {ms:.4f} ms"
                     + ("" if lib_ms is None else f" library {lib_ms:.4f} ms")
                     + f" bound {b_ms:.4f} ms ({b_by}, "
                     f"{100 * b_ms / ms:.1f}%)")
        if not (max(e.values()) <= 1.0 and same and all(
                bool(torch.isfinite(t).all()) for t in got if t is not None)):
            raise RuntimeError(f"{kind} disagrees at {list(x.shape)} "
                               f"({form}): {e}, same bits {same}")
    if not torch.equal(dx_of[False], dx_of[True]):
        raise RuntimeError(f"{kind} at {list(x.shape)}: dx differs between "
                           "the dx-only form and the dW form")
    faults = {f_: max(errs(fg).values()) for f_, fg in norm_bwd_faults(
        x, w, gy, eps, norm_bwd_form_for(x, w, True, layer), gemma,
        layer).items()}
    lines.append("faults " + ", ".join(f"{f_} {e_:.2f}"
                                       for f_, e_ in faults.items()))
    missed = [f_ for f_, e_ in faults.items() if not e_ > 1.0]
    if missed:
        raise RuntimeError(f"the {kind} check lets faults through at "
                           f"{list(x.shape)}: {missed}")
    return out, "; ".join(lines)


def _rms_norm_bwd_kernels(dev, g, flush):
    """K4 at :func:`k4_cases` in both forms (:func:`_norm_bwd_case`):
    the rows of phase 3's kernels line, dx only first. Library: the
    autograd backward of ``F.rms_norm`` (with Gemma's scale w + 1), with w
    a leaf in the dW form."""
    import torch
    import torch.nn.functional as F

    from unsloth_tpu_torch.ops.rms_norm import rms_norm_bwd_ref

    rows = []
    for n_rows, hidden, gemma, dt in k4_cases():
        dtype = getattr(torch, dt)
        shape = (n_rows, hidden)
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        w = (1.0 + 0.1 * torch.randn((hidden,), generator=g, device=dev)
             ).to(dtype)
        gy = torch.randn(shape, generator=g, device=dev).to(dtype)
        plain = once_ms(lambda: rms_norm_bwd_ref(x, w, gy, 1e-5, gemma))

        def lib_call(a, b, gemma=gemma, hidden=hidden):
            return F.rms_norm(a, (hidden,), b + 1.0 if gemma else b, 1e-5)

        forms, line = _norm_bwd_case("rms_norm_bwd", x, w, gy, 1e-5, plain,
                                     flush, gemma=gemma, lib_call=lib_call)
        for need, row in forms.items():
            rows.append(dict(
                row, shape=f"{list(shape)} {dt} gemma={gemma} "
                + ("dx + dW" if need else "dx only")))
        log(f"[kernels] rms_norm_bwd {list(shape)} {dt} gemma={gemma!s:5s} "
            + line)
        del x, gy, plain

    return rows


def _training_kernels(dev, g, flush):
    """K2 at every Llama-3.1-8B projection shape at M = 8192 and every
    Gemma-2-9B one at M = 4096; K4 at [8192, 4096] bf16, plain and Gemma,
    and at Gemma-2-9B's [4096, 3584]; packed attention forward and backward
    (:func:`_packed_case`) on one 8K row of Llama-3.1-8B attention (32/8
    heads, head dim 128) and of Gemma-7B's (16/16 heads of 256).

    Tolerances. K2: max|dx - ref| <= 1e-2 max|ref| (as K1: the same bf16
    weights, fp32 sums in another order, one bf16 rounding); its tile
    counters (output tiles, stages) equal to its schedule's
    (:func:`unsloth_tpu_torch.ops.qlora_matmul.nf4_dx_tile_schedule`), and
    the check must reject each of :func:`nf4_dx_faults`. K4: dx
    within 2 bf16 ulps plus 1e-5 of max|dx| (the fp32 result differs in
    its last bits before rounding; the floor covers values that cancel
    to near zero), dW within one bf16 ulp of max|dW| (an fp32 sum over
    8,192 rows in another order, then rounded to bf16). Attention, at positions
    with segment id != 0 (pad outputs are unspecified): out, dq, dk, dv
    row by row (:func:`attn_row_err`; the kernels round P and dS to bf16
    before their products, the plain version keeps fp32), lse within
    1e-3; the backward pair (K10/K11, K18's dq and dk/dv) is fed the
    kernel forward's (out, lse) on both sides; each kernel's tile-pair
    classes, read back from its counters, must be the rule's."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from unsloth_tpu_torch.ops.nf4 import quantize_nf4
    from unsloth_tpu_torch.ops.qlora_matmul import (DX_STAGE_ROWS,
                                                    nf4_dx_tile_schedule,
                                                    nf4_matmul_dx,
                                                    nf4_matmul_dx_ref)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    rows = {"nf4_matmul_dx": [], "rms_norm_bwd": [], "packed_attn_fwd": [],
            "packed_attn_bwd": []}
    for name, n, k, m in (
            [(name, n, k, TRAIN_ROWS) for name, n, k in PROJ_SHAPES]
            + [("gemma2 " + name, n, k, 2 * UNPACKED_ROWS)
               for name, n, k in GEMMA2_PROJ_SHAPES]
            + [("gpt-oss " + name, n, k, GPT_OSS_ROWS)
               for name, n, k in GPT_OSS_PROJ_SHAPES]):
        w = (torch.randn((n, k), generator=g, device=dev) * 0.02
             ).to(torch.bfloat16)
        q = quantize_nf4(w, dtype=torch.bfloat16)
        del w
        gy = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
        counts.zero_()
        dx = nf4_matmul_dx(gy, q, tile_counts=counts)
        ref, plain_ms = once_ms(lambda: nf4_matmul_dx_ref(gy, q))
        torch.cuda.synchronize()
        err = (dx.float() - ref.float()).abs().max().item()
        tol = 1e-2 * ref.float().abs().max().item()
        got_c = counts.tolist()
        tiles = sum(map(len, nf4_dx_tile_schedule(m, k)))
        want_c = [tiles, tiles * (n // DX_STAGE_ROWS)]
        faults = {f_: (fd.float() - ref.float()).abs().max().item()
                  for f_, fd in nf4_dx_faults(gy, q, ref).items()}
        ms = time_ms(lambda: nf4_matmul_dx(gy, q), flush=flush)
        lib_ms = None
        if name == "gate/up" and m == TRAIN_ROWS:
            lib_ms = time_ms(lambda: nf4_matmul_dx_ref(gy, q), runs=10,
                             flush=flush)
        b_ms, b_by = bound(2 * m * n * k, nbytes(gy) + q.nbytes + m * k * 2)
        rows["nf4_matmul_dx"].append(dict(
            shape=f"{name} M={m} N={n} K={k}", err=err, tol=tol, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, library=NF4_LIBRARY, tile_counts=got_c))
        log(f"[kernels] nf4_matmul_dx {name:15s} M={m} N={n:<6d} K={k:<6d} "
            f"max|d|={err:.3e} (tol {tol:.3e}) kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms" + ("" if lib_ms is None else
                                   f" {NF4_LIBRARY} {lib_ms:.4f} ms")
            + f" bound {b_ms:.4f} ms ({100 * b_ms / ms:.1f}%); tiles, stages "
            f"{got_c} (schedule {want_c}); faults "
            + ", ".join(f"{f_} {e_:.3e}" for f_, e_ in faults.items()))
        if not (bool(torch.isfinite(dx).all()) and err <= tol):
            raise RuntimeError(f"nf4_matmul_dx disagrees at {name}: {err}")
        if got_c != want_c:
            raise RuntimeError(f"nf4_matmul_dx at {name}: the kernel counted "
                               f"{got_c} (tiles, stages), its schedule "
                               f"{want_c}")
        missed = [f_ for f_, e_ in faults.items() if not e_ > tol]
        if missed:
            raise RuntimeError(f"the nf4_matmul_dx check lets faults through "
                               f"at {name}: {missed}")
        del q, gy, dx, ref

    m = TRAIN_ROWS
    rows["rms_norm_bwd"] = _rms_norm_bwd_kernels(dev, g, flush)

    seg = torch.from_numpy(_packed_segments(np.random.default_rng(SEED), m)
                           ).to(dev)
    for config, label, form in ((LLAMA_31_8B_CONFIG, "Llama-3.1-8B", None),
                                (GEMMA_7B_CONFIG, "Gemma-7B", "d256")):
        t_case = time.perf_counter()
        for name, row in _packed_case(dev, g, flush, label, seg, config,
                                      form).items():
            rows[name].append(row)
        log(f"[time] 3 K9-K11 {label}: {time.perf_counter() - t_case:.1f} s")
    return rows


def _packed_case(dev, g, flush, label, seg, config, form=None):
    """K9 (the packed forward: K16's Hopper forward on q * bf16(scale)) and
    K10/K11 (the packed backward: K18's Hopper dq and dk/dv at
    bf16(scale)) on one packed row ``seg`` at ``config``'s heads, against
    the plain versions at the real tokens: out, dq, dk, dv row by row
    (:func:`attn_row_err`), lse within 1e-3, the backward fed the kernel
    forward's (out, lse) on both sides. The tile pairs each kernel classed
    skip, full and masked, read back from its counters, must be the
    rule's (:func:`flash_tile_counts` at that kernel's tiles, times the
    query heads). Times: the forward (and its pre-scale pass alone), the
    backward pair (and K18's dq and dk/dv alone), K16's pair on the same
    inputs (its dq and dk/dv at scale 1 on the pre-scaled q, then dq *
    scale in one bf16 pass, which rounds dq twice: the route the backward
    did not take), the plain versions, SDPA with the segments' causal mask
    and the bound. With ``form`` (a head dim no model path of this script
    packs), one forward and backward of ``ops.attention.attention`` under
    the row's segment bound must launch K9 and K10/K11 once each and no
    other attention kernel (:func:`_packed_through_attention`). Returns a
    row each for "packed_attn_fwd" and "packed_attn_bwd"."""
    import numpy as np
    import torch

    from unsloth_tpu_torch.data.packing import max_segment_length
    from unsloth_tpu_torch.ops import flash_attention as tfa
    from unsloth_tpu_torch.ops import packed_attention as tpa
    from unsloth_tpu_torch.ops import splash_attention as tsa

    m = seg.shape[1]
    hq, hkv, d = (config["num_attention_heads"],
                  config["num_key_value_heads"], config["head_dim"])
    q, k, v, dout = (torch.randn((1, m, h, d), generator=g, device=dev)
                     .to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
    scale = d ** -0.5
    lo, hi = tfa.tile_segment_ranges(seg)
    real = seg[0] != 0
    classes = {w: torch.zeros(3, dtype=torch.int32, device=dev)
               for w in ("fwd", "dq", "dkv")}
    out, lse = tpa.packed_attention_fwd(q, k, v, seg, scale=scale,
                                        tile_classes=classes["fwd"])
    (rout, rlse), fwd_plain = once_ms(
        lambda: tpa.packed_attention_fwd_ref(q, k, v, seg, scale))
    dq, dk, dv = tpa.packed_attention_bwd(
        q, k, v, seg, lo, hi, out, lse, dout, scale=scale,
        tile_classes=(classes["dq"], classes["dkv"]))
    (rdq, rdk, rdv), bwd_plain = once_ms(lambda: tpa.packed_attention_bwd_ref(
        q, k, v, seg, out, lse, dout, scale))
    # K16's pair: dq and dk/dv at scale 1 on the pre-scaled q, then the pass
    qs = tpa._prescale(q, scale)

    def k16_pair():
        dq16, di16 = tfa.flash_attention_dq(qs, k, v, seg, lo, hi, out, lse,
                                            dout, scale=1.0)
        dk16, dv16 = tfa.flash_attention_dkv(qs, k, v, seg, lo, hi, lse,
                                             di16, dout, scale=1.0)
        return dq16 * scale, dk16, dv16

    k16_grads = k16_pair()
    torch.cuda.synchronize()
    n_docs = int(seg.max().item())
    shape = (f"{label} B=1 T={m} Hq={hq} Hkv={hkv} D={d} bf16, {n_docs} "
             f"segments of {DOC_LENGTHS[0]}-{DOC_LENGTHS[1]} + pad tail "
             f"{int((~real).sum())}")
    errs, k16_errs = {}, {}
    for name, got, ref in (("out", out, rout), ("dq", dq, rdq),
                           ("dk", dk, rdk), ("dv", dv, rdv)):
        got, ref = got[:, real].float(), ref[:, real].float()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"packed attention {label} {name} is not "
                               "finite")
        errs[name] = ((got - ref).abs().max().item(),
                      attn_row_err(got, ref))
    for name, got, ref in zip(("dq", "dk", "dv"), k16_grads,
                              (rdq, rdk, rdv)):
        k16_errs[name] = attn_row_err(got[:, real], ref[:, real])
    del rout, rdq, rdk, rdv, k16_grads
    lse_err = (lse - rlse)[..., real].abs().max().item()
    got_cls = {w: c_.tolist() for w, c_ in classes.items()}
    want_cls = {w: [hq * c_ for c_ in flash_tile_counts(
        seg.cpu(), True, *tfa.KERNEL_TILES[w][d], kernel=w)]
        for w in classes}
    path_launches = None
    if form is not None:
        path_launches = _packed_through_attention(
            q, k, v, seg, dout, scale, int(max_segment_length(
                seg.cpu().numpy())), (out, dq, dk, dv), label)
    fwd_ms = time_ms(lambda: tpa.packed_attention_fwd(q, k, v, seg,
                                                      scale=scale),
                     runs=10, flush=flush)
    pre_ms = time_ms(lambda: tpa._prescale(q, scale), runs=10, flush=flush)
    bwd_ms = time_ms(lambda: tpa.packed_attention_bwd(
        q, k, v, seg, lo, hi, out, lse, dout, scale=scale),
        runs=10, flush=flush)
    scale_q = tpa._rounded_scale(scale, q.dtype)
    _, di = tsa._dq("K10", q, k, v, seg, lo, hi, out, lse, dout, None, None,
                    scale_q, None, None, True)
    dq_ms = time_ms(lambda: tsa._dq(
        "K10", q, k, v, seg, lo, hi, out, lse, dout, None, None, scale_q,
        None, None, True), runs=10, flush=flush)
    dkv_ms = time_ms(lambda: tsa._dkv(
        "K11", q, k, v, seg, lo, hi, lse, di, dout, None, None, scale_q,
        None, None, True), runs=10, flush=flush)
    k16_ms = time_ms(k16_pair, runs=10, flush=flush)
    # the work the real tokens need: each segment's causal pairs
    seg_np = seg[0].cpu().numpy()
    lens = np.bincount(seg_np[seg_np != 0])
    pairs = int((lens * (lens + 1) // 2).sum())
    lib_fwd, lib_bwd = _sdpa_ms(q, k, v, seg, dout, flush)
    fb = bound(4 * d * hq * pairs, nbytes(q, k, v, out, lse))
    bb = bound(10 * d * hq * pairs,
               nbytes(q, k, v, out, dout, lse, q, k, v))
    common = {} if form is None else dict(form=form,
                                          path_launches=path_launches)
    res = {"packed_attn_fwd": dict(
        common, shape=shape, err=max(errs["out"][0], lse_err), ms=fwd_ms,
        plain_ms=fwd_plain, bound_ms=fb[0], bound_by=fb[1],
        library_ms=lib_fwd, tile_classes=got_cls["fwd"], prescale_ms=pre_ms),
        "packed_attn_bwd": dict(
        common, shape=shape, err=max(errs[n][0] for n in ("dq", "dk", "dv")),
        ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bb[0], bound_by=bb[1],
        library_ms=lib_bwd, k16_ms=k16_ms,
        tile_classes={w: got_cls[w] for w in ("dq", "dkv")})}
    card = _smi_name_power()
    log(f"[kernels] packed attention {shape}: " + ", ".join(
        f"{n} max|d|={e:.3e} row-wise {r:.3e}" for n, (e, r) in errs.items())
        + f" (row-wise tol {ATTN_ROW_TOL:.3e}); lse max|d|={lse_err:.3e} "
        "(tol 1e-3)")
    log(f"[kernels] packed attention {label}: tile pairs (skip, full, "
        "masked), kernels' counters / rule: " + "; ".join(
            f"{w} {got_cls[w]} / {want_cls[w]} (tiles "
            f"{tfa.KERNEL_TILES[w][d]})" for w in classes))
    log(f"[kernels] packed attention {label} on {card}: fwd (K16's Hopper "
        f"forward on q * bf16(scale)) kernel {fwd_ms:.4f} ms (of which the "
        f"pre-scale pass alone {pre_ms:.4f} ms) plain {fwd_plain:.4f} ms "
        f"SDPA {lib_fwd:.4f} ms bound {fb[0]:.4f} ms ({fb[1]}, "
        f"{100 * fb[0] / fwd_ms:.1f}%); bwd (K18's dq + dk/dv) kernel "
        f"{bwd_ms:.4f} ms (dq {dq_ms:.4f} ms, dk/dv {dkv_ms:.4f} ms) plain "
        f"{bwd_plain:.4f} ms SDPA {lib_bwd:.4f} ms bound {bb[0]:.4f} ms "
        f"({bb[1]}, {100 * bb[0] / bwd_ms:.1f}%); K16's pair with its dq "
        f"pass {k16_ms:.4f} ms (K16 / K18 {k16_ms / bwd_ms:.3f}; row-wise "
        + ", ".join(f"{n} {e:.3e}" for n, e in k16_errs.items())
        + f"); {pairs} causal pairs per head")
    bad = [n for n, (e, r) in errs.items() if not r <= ATTN_ROW_TOL]
    if bad or not lse_err <= 1e-3:
        raise RuntimeError(f"packed attention {label} disagrees in {bad}: "
                           f"{errs}, lse {lse_err}")
    if got_cls != want_cls:
        raise RuntimeError(f"packed attention {label} classed the tile "
                           f"pairs {got_cls} (skip, full, masked), the rule "
                           f"{want_cls}")
    return res


def _packed_through_attention(q, k, v, seg, dout, scale, bound, want, label):
    """{kernel: launches} of one forward and backward of
    ``ops.attention.attention`` on this packed row under
    ``packed_segment_bound(bound)``, the counters set to 0 just before:
    K9 and K10/K11 once each, no other attention kernel (the packed route
    takes this head dim, as JAX's at ``Dh % 128 == 0``), and the output
    and gradients at the real tokens row by row (:func:`attn_row_err`)
    those of the kernel wrappers' own run (``want``: out, dq, dk, dv)."""
    import torch

    from unsloth_tpu_torch.ops.attention import attention, packed_segment_bound

    names = ("packed_attn_fwd", "packed_attn_bwd") + PACKED_ABSENT
    fns = _kernel_fns()
    for n_ in names:
        fns[n_].launches = 0
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    with packed_segment_bound(bound):
        got = attention(*xs, segment_ids=seg, scale=scale)
    got.backward(dout)
    torch.cuda.synchronize()
    launches = {n_: fns[n_].launches for n_ in names}
    real = seg[0] != 0
    errs = {n_: attn_row_err(a[:, real], b[:, real]) for n_, a, b in zip(
        ("out", "dq", "dk", "dv"), (got.detach(), *(x.grad for x in xs)),
        want)}
    same = [bool(torch.equal(a, b)) for a, b in zip(
        (got.detach(), *(x.grad for x in xs)), want)]
    log(f"[kernels] packed attention {label} through attention() under "
        f"packed_segment_bound({bound}): launches {launches}; row-wise from "
        f"the wrappers' run {errs} (same bits {same})")
    wrong = {n_: c for n_, c in launches.items()
             if c != (1 if n_.startswith("packed") else 0)}
    if wrong or any(not e <= ATTN_ROW_TOL for e in errs.values()):
        raise RuntimeError(f"packed attention {label} through attention(): "
                           f"launches {wrong}, row-wise {errs}")
    return launches


def _unpacked_kernels(dev, g, flush):
    """The kernels of SFT without packing at the notebook recipe's shapes:
    K7/K8 on 4,094 rows (2 x 2,048, shifted) of the 128,256 vocabulary,
    bf16, about 30% of the rows ignored (-100), without and with a softcap,
    and of Gemma-2's 256,000 with its final softcap of 30;
    K16 forward, dq and dk/dv on a padded [2, 2048] batch of Llama-3.1-8B
    attention (32/8 heads, head dim 128): one row of 1,500 real tokens and
    a pad tail, one row full.

    Tolerances. K7: loss and lse within 1e-4 relative plus 1e-4 (fp32 sums
    of 128,256 exponentials in another order). K8: dlogits within 2 bf16
    ulps plus 1e-6 of max|ref| (the same fp32 formula, expf against
    torch.exp, one rounding to bf16). K16 at every position, pad queries
    included: out, dq, dk, dv row by row (:func:`attn_row_err`: each
    element within 2^-6 of its value plus 2^-4 of its (token, head) row's
    rms; the kernels round P and dS to bf16, the plain version keeps
    fp32), lse within 1e-3; the backward gets the kernel forward's (out,
    lse) on both sides. Then the check must reject the plain versions
    under a dropped kv tile and under an ignored pad mask
    (:func:`attn_fault_errs`)."""
    import torch
    import torch.nn.functional as F

    from unsloth_tpu_torch.ops import cross_entropy as tce

    rows = {name: [] for name in ("cross_entropy_fwd", "cross_entropy_bwd",
                                  "flash_attn_fwd", "flash_attn_dq",
                                  "flash_attn_dkv")}
    n, llama_v = CE_ROWS[0], LLAMA_31_8B_CONFIG["vocab_size"]
    for v, softcap in ((llama_v, None), (llama_v, 30.0),
                       (GEMMA2_9B_CONFIG["vocab_size"],
                        GEMMA2_9B_CONFIG["final_logit_softcapping"])):
        logits = (torch.randn((n, v), generator=g, device=dev) * 2
                  ).to(torch.bfloat16)
        labels = torch.randint(0, v, (n,), generator=g, device=dev)
        labels[torch.rand(n, generator=g, device=dev) < 0.3] = -100
        n_valid = int((labels != -100).sum())
        gr = torch.full((n,), 1.0 / n_valid, device=dev)  # d mean / d row
        loss, lse = tce.cross_entropy_fwd(logits, labels, softcap)
        dx = tce.cross_entropy_bwd(logits, labels, lse, gr, softcap)
        (rloss, rlse), fwd_plain = once_ms(
            lambda: tce.cross_entropy_ref(logits, labels, softcap))
        rdx, bwd_plain = once_ms(lambda: tce.cross_entropy_bwd_ref(
            logits, labels, lse, gr, softcap))
        torch.cuda.synchronize()
        fwd_err = max((loss - rloss).abs().max().item(),
                      (lse - rlse).abs().max().item())
        fwd_ok = bool(((loss - rloss).abs() <= 1e-4 * rloss.abs() + 1e-4).all()
                      and ((lse - rlse).abs() <= 1e-4 * rlse.abs() + 1e-4).all())
        d = (dx.float() - rdx.float()).abs()
        bwd_ok = bool((d <= 2.0 ** -7 * rdx.float().abs()
                       + 1e-6 * rdx.float().abs().max()).all())
        fwd_ms = time_ms(lambda: tce.cross_entropy_fwd(logits, labels, softcap),
                         flush=flush)
        bwd_ms = time_ms(lambda: tce.cross_entropy_bwd(logits, labels, lse, gr,
                                                       softcap), flush=flush)
        lib_fwd = lib_bwd = None
        if softcap is None:   # F.cross_entropy has no softcap
            lib_fwd = time_ms(lambda: F.cross_entropy(
                logits, labels, ignore_index=-100, reduction="none"),
                flush=flush)
            lib_bwd = _autograd_ms(lambda x: F.cross_entropy(
                x, labels, ignore_index=-100, reduction="none"), (logits,),
                gr, flush)
        ops = (8 if softcap else 4) * n * v
        fb = bound(ops, nbytes(logits, labels, loss, lse), PEAK_FP32)
        bb = bound(2 * ops, nbytes(logits, labels, lse, gr, dx), PEAK_FP32)
        shape = f"N={n} V={v} bf16 softcap={softcap}"
        rows["cross_entropy_fwd"].append(dict(
            shape=shape, err=fwd_err, ms=fwd_ms, plain_ms=fwd_plain,
            bound_ms=fb[0], bound_by=fb[1], library_ms=lib_fwd))
        rows["cross_entropy_bwd"].append(dict(
            shape=shape, err=d.max().item(), ms=bwd_ms, plain_ms=bwd_plain,
            bound_ms=bb[0], bound_by=bb[1], library_ms=lib_bwd))
        log(f"[kernels] cross_entropy {shape}, {n - n_valid} rows ignored: "
            f"K7 max|d|={fwd_err:.3e} (1e-4 rel + 1e-4: "
            f"{'ok' if fwd_ok else 'FAIL'}) kernel {fwd_ms:.4f} ms plain "
            f"{fwd_plain:.4f} ms F.cross_entropy {lib_fwd} ms bound "
            f"{fb[0]:.4f} ms ({fb[1]}); K8 max|d|={d.max().item():.3e} "
            f"(2 bf16 ulps + 1e-6 max: {'ok' if bwd_ok else 'FAIL'}) kernel "
            f"{bwd_ms:.4f} ms plain {bwd_plain:.4f} ms backward {lib_bwd} ms "
            f"bound {bb[0]:.4f} ms ({bb[1]})")
        if not (fwd_ok and bwd_ok and bool(torch.isfinite(dx).all())):
            raise RuntimeError(f"cross_entropy kernels disagree at {shape}")
        del logits, dx, rdx, d
        torch.cuda.empty_cache()

    c = LLAMA_31_8B_CONFIG
    seg = torch.ones((2, UNPACKED_ROWS), dtype=torch.int32, device=dev)
    seg[0, 1500:] = 0                      # pad_batch: 1 real, 0 pad
    res = _flash_case(dev, g, flush, "", seg, c["num_attention_heads"],
                      c["num_key_value_heads"], c["head_dim"], classes=True)
    for name, row in res.items():
        rows[name].append(row)
    return rows


def _k16_checks(label, q, k, v, seg, out, lse, dout, scale, causal, first,
                classes=False, same_bits=False):
    """K16's design checks at one shape: with ``classes``, the tile pairs
    each of its three kernels classed skip, full and masked, read back from
    their counters (:func:`kernel_tile_classes`), against the rule's
    count at that kernel's tiles (:func:`flash_tile_counts`), a query
    head; with ``same_bits``, dq and dk/dv run again on the same inputs
    give the bits of ``first`` (their dq, dk, dv). Raises on a difference;
    returns the extra keys of the kernels' rows by kernel name."""
    import torch

    from unsloth_tpu_torch.ops import flash_attention as tfa

    names = FULL_FLASH if not causal else ("flash_attn_fwd", "flash_attn_dq",
                                           "flash_attn_dkv")
    label = label.strip() or "(a)"
    extra = {n_: {} for n_ in names}
    if classes:
        got = kernel_tile_classes(q, k, v, seg, dout, scale, causal)
        rule = {w: flash_tile_counts(seg, causal,
                                     *tfa.KERNEL_TILES[w][q.shape[3]])
                for w in got}
        pairs = "; ".join(f"{w} {got[w]} / {rule[w]} (tiles "
                          f"{tfa.KERNEL_TILES[w][q.shape[3]]})" for w in got)
        log(f"[kernels] flash attention {label}: tile pairs a query "
            f"head (skip, full, masked), kernels' counters / rule: {pairs}")
        if got != rule:
            raise RuntimeError(f"K16's tile classes at {label} differ from "
                               f"the rule: {got} against {rule}")
        for n_, w in zip(names, ("fwd", "dq", "dkv")):
            extra[n_]["tile_classes"] = dict(zip(TILE_CLASSES, got[w]))
    if same_bits:
        lo, hi = tfa.tile_segment_ranges(seg)
        sfx = "" if causal else "_full"
        dq, di = getattr(tfa, "flash_attention_dq" + sfx)(
            q, k, v, seg, lo, hi, out, lse, dout, scale=scale)
        dk, dv = getattr(tfa, "flash_attention_dkv" + sfx)(
            q, k, v, seg, lo, hi, lse, di, dout, scale=scale)
        same = [bool(torch.equal(a, b)) for a, b in zip(first, (dq, dk, dv))]
        log(f"[kernels] flash attention {label}: dq, dk, dv run "
            f"twice, same bits {same}")
        if not all(same):
            raise RuntimeError(f"K16's backward at {label} gave other bits "
                               f"on a second run: {same}")
        extra[names[1]]["same_bits"] = extra[names[2]]["same_bits"] = True
    return extra


def _flash_case(dev, g, flush, label, seg, hq, hkv, hd, form=None,
                classes=False, same_bits=False):
    """K16 forward, dq and dk/dv at one shape against the plain versions, at
    every position, pad queries included: out, dq, dk, dv row by row
    (:func:`attn_row_err`), lse within 1e-3, the backward fed the kernel
    forward's (out, lse) on both sides; then the check must reject the
    plain versions under a dropped kv tile and under an ignored pad mask
    (:func:`attn_fault_errs`) and under a diagonal or a mixed-segment tile
    called full (:func:`tile_fault_errs`); with ``classes`` and
    ``same_bits``, :func:`_k16_checks`. Times: the kernels, the plain
    versions, and SDPA with the padding mask (the same function), and the
    kernels' ratio to it. Returns a row per kernel, tagged with ``form``
    (the head-dim form of the kernels line)."""
    import torch

    from unsloth_tpu_torch.ops import flash_attention as tfa

    b, t = seg.shape
    q, k, vv, dout = (torch.randn((b, t, h, hd), generator=g, device=dev)
                      .to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
    lo, hi = tfa.tile_segment_ranges(seg)
    scale = hd ** -0.5
    out, lse = tfa.flash_attention_fwd(q, k, vv, seg, lo, hi, scale=scale)
    dq, di = tfa.flash_attention_dq(q, k, vv, seg, lo, hi, out, lse, dout,
                                    scale=scale)
    dk, dv = tfa.flash_attention_dkv(q, k, vv, seg, lo, hi, lse, di, dout,
                                     scale=scale)
    (rout, rlse), fwd_plain = once_ms(
        lambda: tfa.flash_attention_fwd_ref(q, k, vv, seg, scale))
    (rdq, rdk, rdv), bwd_plain = once_ms(lambda: tfa.flash_attention_bwd_ref(
        q, k, vv, seg, out, lse, dout, scale))
    torch.cuda.synchronize()
    errs = {}
    for name, got, ref in (("out", out, rout), ("dq", dq, rdq),
                           ("dk", dk, rdk), ("dv", dv, rdv)):
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"flash attention {label} {name} is not "
                               "finite")
        errs[name] = ((got.float() - ref.float()).abs().max().item(),
                      attn_row_err(got, ref))
    lse_err = (lse - rlse).abs().max().item()
    faults = attn_fault_errs(q, k, vv, seg, dout, scale,
                             (rout, rdq, rdk, rdv))
    faults.update(tile_fault_errs(q, k, vv, seg, dout, scale,
                                  (rout, rdq, rdk, rdv), True))
    del rout, rdq, rdk, rdv
    extra = _k16_checks(label, q, k, vv, seg, out, lse, dout, scale, True,
                        (dq, dk, dv), classes, same_bits)
    fwd_ms = time_ms(lambda: tfa.flash_attention_fwd(
        q, k, vv, seg, lo, hi, scale=scale), runs=10, flush=flush)
    dq_ms = time_ms(lambda: tfa.flash_attention_dq(
        q, k, vv, seg, lo, hi, out, lse, dout, scale=scale), runs=10,
        flush=flush)
    dkv_ms = time_ms(lambda: tfa.flash_attention_dkv(
        q, k, vv, seg, lo, hi, lse, di, dout, scale=scale), runs=10,
        flush=flush)
    lib_fwd, lib_bwd = _sdpa_ms(q, k, vv, seg, dout, flush)
    # every output is defined, so the work is every valid pair: each
    # segment's causal pairs, the pad tail's among its own
    counts = [int((seg[i] == s_).sum()) for i in range(b)
              for s_ in torch.unique(seg[i]).tolist()]
    pairs = sum(x * (x + 1) // 2 for x in counts)
    fb = bound(4 * hd * hq * pairs, nbytes(q, k, vv, seg, out, lse))
    qb = bound(6 * hd * hq * pairs, nbytes(q, k, vv, seg, out, dout, lse, q,
                                           di))
    kb = bound(8 * hd * hq * pairs, nbytes(q, k, vv, seg, dout, lse, di, k,
                                           vv))
    lens = [int((seg[i] != 0).sum()) for i in range(b)]
    shape = (f"{label}B={b} T={t} Hq={hq} Hkv={hkv} D={hd} bf16, rows of "
             + " and ".join(f"{n} (+ {t - n} pad)" if n < t else f"{n}"
                            for n in lens) + " real tokens")
    common = dict(shape=shape, form=form)
    rows = {
        "flash_attn_fwd": dict(
            common, err=max(errs["out"][0], lse_err), ms=fwd_ms,
            plain_ms=fwd_plain, bound_ms=fb[0], bound_by=fb[1],
            library_ms=lib_fwd, **extra["flash_attn_fwd"]),
        "flash_attn_dq": dict(
            common, err=errs["dq"][0], ms=dq_ms, plain_ms=bwd_plain,
            bound_ms=qb[0], bound_by=qb[1], library_ms=lib_bwd,
            **extra["flash_attn_dq"]),
        "flash_attn_dkv": dict(
            common, err=max(errs["dk"][0], errs["dv"][0]), ms=dkv_ms,
            plain_ms=bwd_plain, bound_ms=kb[0], bound_by=kb[1],
            library_ms=lib_bwd, **extra["flash_attn_dkv"])}
    log(f"[kernels] flash attention (K16) {shape}, every position: " +
        ", ".join(f"{n_} max|d|={e:.3e} row-wise {r:.3e}"
                  for n_, (e, r) in errs.items())
        + f" (row-wise tol {ATTN_ROW_TOL:.3e}); lse max|d|={lse_err:.3e} "
        "(tol 1e-3)")
    for fault, res in faults.items():
        log(f"[kernels] flash attention check against a fault, {fault}: " +
            ", ".join(f"{n_} row-wise {r:.3e} (old max-scaled check "
                      f"{'passes' if old else 'fails'})"
                      for n_, (r, old) in res.items()))
    log(f"[kernels] flash attention {label}fwd kernel {fwd_ms:.4f} ms plain "
        f"{fwd_plain:.4f} ms SDPA {lib_fwd:.4f} ms bound {fb[0]:.4f} ms "
        f"({fb[1]}); dq kernel {dq_ms:.4f} ms bound {qb[0]:.4f} ms; dk/dv "
        f"kernel {dkv_ms:.4f} ms bound {kb[0]:.4f} ms; plain backward "
        f"{bwd_plain:.4f} ms, SDPA backward (dq, dk, dv) {lib_bwd:.4f} ms; "
        f"kernel / SDPA: forward {fwd_ms / lib_fwd:.2f}x, dq + dk/dv "
        f"{(dq_ms + dkv_ms) / lib_bwd:.2f}x; "
        f"{pairs} valid pairs per head, pad "
        f"{100 * int((seg == 0).sum()) / seg.numel():.1f}% of the batch")
    bad = [n_ for n_, (e, r) in errs.items() if not r <= ATTN_ROW_TOL]
    if bad or not lse_err <= 1e-3:
        raise RuntimeError(f"flash attention {label}disagrees in {bad}: "
                           f"{errs}, lse {lse_err}")
    missed = [(f, n_) for f, res in faults.items()
              for n_, (r, _) in res.items() if not r > ATTN_ROW_TOL]
    if missed:
        raise RuntimeError(f"the attention check lets faults through: "
                           f"{missed}")
    del q, k, vv, dout, out, lse, dq, dk, dv, di
    torch.cuda.empty_cache()
    return rows


def _splash_kernels(dev, g, flush):
    """Splash attention (K18: forward, dq, dk/dv) with Gemma-2-9B's softcap
    of 50 (:func:`_splash_case`) at (a) the Gemma-2 path's shape, [2,
    2048], 16/8 heads, head dim 256, scale 1/16, a row of 1,500 real tokens
    and a pad tail, with the sliding layers' window of 4,096 (which masks
    nothing at 2,048) and without (the global layers); (b) [1, 8192], one
    segment, window 4,096 (it bites); (c) Gemma-2-27B's heads, 32/16 at
    head dim 128, scale 144^-0.5, window 4,096, [1, 8192]; (d) a packed 8K
    row of segments of 64-1,024 tokens and a pad tail, window 4,096; (e)
    K16's shape in this phase (Llama-3.1-8B's 32/8 heads of 128, [2,
    2048], a row of 1,500 real tokens) with neither window nor softcap,
    K16's function, to time the two kernel families on one function. At (b)
    the check must also reject the faults of :func:`attn_fault_errs`, the
    window ignored and the softcap's derivative dropped among them, and a
    pair past the window called full (:func:`splash_tile_fault_errs`). At
    (a) sliding, (b) and (d) the kernels' tile-class counters must equal
    the rule's; at (a) sliding the kernels run again give the same bits. The
    library call: compiled flex_attention at (a), the shape of the kernels
    line (one compile serves both windows); SDPA with the mask at (e),
    which has no softcap; at (b)-(d) compiled flex_attention only under
    ``--library-times`` (LIBRARY_TIMES), whose compiles would cost the
    default run 60-80 s and time no path."""
    import numpy as np
    import torch

    c = GEMMA2_9B_CONFIG
    hq, hkv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                   c["head_dim"])
    scale = c["query_pre_attn_scalar"] ** -0.5
    cap = c["attn_logit_softcapping"]
    window = c["sliding_window"]
    padded = torch.ones((2, UNPACKED_ROWS), dtype=torch.int32, device=dev)
    padded[0, 1500:] = 0                      # pad_batch: 1 real, 0 pad
    one = torch.ones((1, TRAIN_ROWS), dtype=torch.int32, device=dev)
    packed = torch.from_numpy(_packed_segments(np.random.default_rng(SEED),
                                               TRAIN_ROWS)).to(dev)
    rows = {name: [] for name in ("splash_attn_fwd", "splash_attn_dq",
                                  "splash_attn_dkv")}
    llama = LLAMA_31_8B_CONFIG
    wide_lib = "flex" if LIBRARY_TIMES else None
    for label, seg, h_q, h_kv, dh, sc, win, sc_cap, faults, lib, checks in (
            ("(a) sliding", padded, hq, hkv, hd, scale, window, cap, False,
             "flex", True),
            ("(a) global", padded, hq, hkv, hd, scale, None, cap, False,
             "flex", False),
            ("(b)", one, hq, hkv, hd, scale, window, cap, True, wide_lib,
             True),
            ("(c) Gemma-2-27B heads", one, 32, 16, 128, 144 ** -0.5, window,
             cap, False, wide_lib, False),
            ("(d) packed", packed, hq, hkv, hd, scale, window, cap, False,
             wide_lib, True),
            ("(e) K16's shape", padded, llama["num_attention_heads"],
             llama["num_key_value_heads"], llama["head_dim"],
             llama["head_dim"] ** -0.5, None, None, False, "sdpa", False)):
        t_case = time.perf_counter()
        res = _splash_case(dev, g, flush, label, seg, h_q, h_kv, dh, sc, win,
                           sc_cap, faults, library=lib, classes=checks,
                           same_bits=label == "(a) sliding")
        log(f"[time] 3 K18 {label}: {time.perf_counter() - t_case:.1f} s")
        for name, row in res.items():
            rows[name].append(row)
    return rows


def _splash_case(dev, g, flush, label, seg, hq, hkv, d, scale, window,
                 softcap, faults, library="flex", form=None,
                 prefix_layout=None, classes=False, same_bits=False):
    """K18 forward, dq and dk/dv at one shape against the plain versions,
    every position row by row (:func:`attn_row_err`), lse within 1e-3, the
    backward fed the kernel forward's (out, lse) on both sides. q and k
    are N(0, 4^2), so the scores are of the order of the softcap and its
    tanh bites. With ``faults`` the check must also reject each fault of
    :func:`attn_fault_errs` and, with a window, a pair past the window
    called full (:func:`splash_tile_fault_errs`). Times: the kernels, the
    plain versions, SDPA with the same boolean mask and no softcap and,
    with ``library="flex"``, the library call that computes the same
    function (:func:`_flex_ms`, whose out must agree with the plain
    version's as the kernel's does). With ``library="sdpa"`` (no softcap)
    that SDPA call is the library call, which computes the same function;
    with None (a softcap, at a shape whose flex_attention compile phase 3
    does not spend) there is none. Only "flex" compiles flex_attention.
    With a ``prefix_layout`` the kernels take GRPO's shared-prefix form,
    the faults are :func:`prefix_fault_errs`' and a pair across two
    regions called full, and the tile pairs each kernel classed, read back
    from its counters (:func:`kernel_tile_classes`) with this row's
    segments, with one segment and causal without the layout, must be the
    rule's at its tiles (:func:`flash_tile_counts`). With ``classes`` (no
    layout) the same with this row's segments; with ``same_bits`` the
    three kernels run again must give the same bits. Returns a row per
    kernel, tagged with ``form`` (the kernels line's form of the kernel),
    with those counts where there are any."""
    import torch

    from unsloth_tpu_torch.ops import flash_attention as tfa
    from unsloth_tpu_torch.ops import splash_attention as tsa

    b, t = seg.shape
    q, k = ((torch.randn((b, t, h, d), generator=g, device=dev) * 4)
            .to(torch.bfloat16) for h in (hq, hkv))
    v, dout = (torch.randn((b, t, h, d), generator=g, device=dev)
               .to(torch.bfloat16) for h in (hkv, hq))
    lo, hi = tfa.tile_segment_ranges(seg)
    opts = dict(window=window, softcap=softcap, scale=scale,
                prefix_layout=prefix_layout)
    out, lse = tsa.splash_attention_fwd(q, k, v, seg, lo, hi, **opts)
    dq, di = tsa.splash_attention_dq(q, k, v, seg, lo, hi, out, lse, dout,
                                     **opts)
    dk, dv = tsa.splash_attention_dkv(q, k, v, seg, lo, hi, lse, di, dout,
                                      **opts)
    (rout, rlse), fwd_plain = once_ms(
        lambda: tsa.splash_attention_fwd_ref(q, k, v, seg, **opts))
    (rdq, rdk, rdv), bwd_plain = once_ms(lambda: tsa.splash_attention_bwd_ref(
        q, k, v, seg, out, lse, dout, **opts))
    torch.cuda.synchronize()
    errs = {}
    for name, got, ref in (("out", out, rout), ("dq", dq, rdq),
                           ("dk", dk, rdk), ("dv", dv, rdv)):
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"splash attention {label} {name} is not "
                               "finite")
        errs[name] = ((got.float() - ref.float()).abs().max().item(),
                      attn_row_err(got, ref))
    lse_err = (lse - rlse).abs().max().item()
    want = (rout, rdq, rdk, rdv)
    if not faults:
        fault_res = {}
    elif prefix_layout is not None:
        fault_res = prefix_fault_errs(q, k, v, seg, dout, scale,
                                      prefix_layout, want)
    else:
        fault_res = attn_fault_errs(q, k, v, seg, dout, scale, want,
                                    window=window, softcap=softcap)
    if faults and (window is not None or prefix_layout is not None):
        fault_res.update(splash_tile_fault_errs(
            q, k, v, seg, dout, scale, want, window=window, softcap=softcap,
            prefix_layout=prefix_layout))
    del rdq, rdk, rdv, want
    flex = library == "flex"
    flex_fwd = flex_bwd = flex_err = None
    if flex:
        flex_fwd, flex_bwd, flex_err = _flex_ms(
            q, k, v, seg, dout, flush, rout, window=window, softcap=softcap,
            scale=scale)
    elif library == "sdpa" and softcap is not None:
        raise ValueError("SDPA computes K18's function only without a "
                         "softcap")
    del rout
    fwd_ms = time_ms(lambda: tsa.splash_attention_fwd(
        q, k, v, seg, lo, hi, **opts), runs=10, flush=flush)
    dq_ms = time_ms(lambda: tsa.splash_attention_dq(
        q, k, v, seg, lo, hi, out, lse, dout, **opts), runs=10, flush=flush)
    dkv_ms = time_ms(lambda: tsa.splash_attention_dkv(
        q, k, v, seg, lo, hi, lse, di, dout, **opts), runs=10, flush=flush)
    sdpa_fwd, sdpa_bwd = _sdpa_ms(q, k, v, seg, dout, flush, window=window,
                                  prefix_layout=prefix_layout)
    # the valid (query, key) pairs of this data: the work the kernels need
    pairs = int(tsa._splash_mask(seg, b, t, dev, window,
                                 prefix_layout).sum())
    fb = bound(4 * d * hq * pairs, nbytes(q, k, v, seg, out, lse))
    qb = bound(6 * d * hq * pairs, nbytes(q, k, v, seg, out, dout, lse, q,
                                          di))
    kb = bound(8 * d * hq * pairs, nbytes(q, k, v, seg, dout, lse, di, k, v))
    n_seg = len(torch.unique(seg[seg != 0]))
    layout_text = ("" if prefix_layout is None else
                   f" prefix layout (P, G, L)={tuple(prefix_layout)}")
    shape = (f"{label}: B={b} T={t} Hq={hq} Hkv={hkv} D={d} bf16 scale="
             f"{scale:.5f} softcap={softcap} window={window}{layout_text}, "
             f"{n_seg} segment(s), {int((seg == 0).sum())} pad")
    common = dict(shape=shape, form=form)
    names = ("splash_attn_fwd", "splash_attn_dq", "splash_attn_dkv")
    extra = {n_: {} for n_ in names}
    if classes or prefix_layout is not None:
        # read back from the kernels: this row's segment ids, and for the
        # prefix form also one segment and causal over one segment
        one = torch.ones_like(seg)
        reads = [("tile_classes", seg, prefix_layout)]
        if prefix_layout is not None:
            reads += [("tile_classes_one_segment", one, prefix_layout),
                      ("causal_tile_classes", one, None)]
        for what, s_, lay in reads:
            got = kernel_tile_classes(
                q, k, v, s_, dout, scale, True, splash=dict(
                    window=window, softcap=softcap, prefix_layout=lay))
            rule = {w: flash_tile_counts(s_, True, *tfa.KERNEL_TILES[w][d],
                                         window=window, prefix_layout=lay,
                                         kernel=w) for w in got}
            log(f"[kernels] splash attention {label}: tile pairs a query "
                f"head (skip, full, masked), {what}, kernels' counters / "
                "rule: " + "; ".join(
                    f"{w} {got[w]} / {rule[w]} (tiles "
                    f"{tfa.KERNEL_TILES[w][d]})" for w in got))
            if got != rule:
                raise RuntimeError(f"K18's tile classes at {label} ({what}) "
                                   f"differ from the rule: {got} against "
                                   f"{rule}")
            for n_, w in zip(names, ("fwd", "dq", "dkv")):
                extra[n_][what] = dict(zip(TILE_CLASSES, got[w]))
    if same_bits:
        again = tsa.splash_attention_fwd(q, k, v, seg, lo, hi, **opts)
        again += tsa.splash_attention_dq(q, k, v, seg, lo, hi, out, lse,
                                         dout, **opts)
        again += tsa.splash_attention_dkv(q, k, v, seg, lo, hi, lse, di,
                                          dout, **opts)
        same = [bool(torch.equal(a, b_)) for a, b_ in zip(
            (out, lse, dq, di, dk, dv), again)]
        log(f"[kernels] splash attention {label}: forward, dq, dk/dv run "
            f"twice, same bits (out, lse, dq, di, dk, dv) {same}")
        if not all(same):
            raise RuntimeError(f"K18 at {label} gave other bits on a second "
                               f"run: {same}")
        del again
        for n_ in names:
            extra[n_]["same_bits"] = True
    lib = {"flex": {}, "sdpa": dict(
        library="SDPA with the dense boolean mask: causal, segments and "
        "the window or prefix layout (no softcap: the same function)"),
        None: dict(
        library="none timed at this shape (only compiled flex_attention "
        "computes the softcap; SDPA without it beside)")}[library]
    lib_fwd, lib_bwd = {"flex": (flex_fwd, flex_bwd),
                        "sdpa": (sdpa_fwd, sdpa_bwd)}.get(library,
                                                          (None, None))
    ratio = ({} if lib_fwd is None else dict(
        library_ratio=dict(forward=fwd_ms / lib_fwd,
                           backward=(dq_ms + dkv_ms) / lib_bwd)))
    res = {
        "splash_attn_fwd": dict(
            common, **extra["splash_attn_fwd"],
            err=max(errs["out"][0], lse_err), ms=fwd_ms,
            plain_ms=fwd_plain, bound_ms=fb[0], bound_by=fb[1],
            library_ms=lib_fwd,
            sdpa_no_softcap_ms=sdpa_fwd, **lib, **ratio),
        "splash_attn_dq": dict(
            common, **extra["splash_attn_dq"],
            err=errs["dq"][0], ms=dq_ms, plain_ms=bwd_plain,
            bound_ms=qb[0], bound_by=qb[1],
            library_ms=lib_bwd,
            sdpa_no_softcap_ms=sdpa_bwd, **lib, **ratio),
        "splash_attn_dkv": dict(
            common, **extra["splash_attn_dkv"],
            err=max(errs["dk"][0], errs["dv"][0]), ms=dkv_ms,
            plain_ms=bwd_plain, bound_ms=kb[0], bound_by=kb[1],
            library_ms=lib_bwd,
            sdpa_no_softcap_ms=sdpa_bwd, **lib, **ratio)}
    log(f"[kernels] splash attention (K18) {shape}, every position: " +
        ", ".join(f"{n_} max|d|={e:.3e} row-wise {r:.3e}"
                  for n_, (e, r) in errs.items())
        + f" (row-wise tol {ATTN_ROW_TOL:.3e}); lse max|d|={lse_err:.3e} "
        "(tol 1e-3)")
    for fault, fres in fault_res.items():
        log(f"[kernels] splash attention check against a fault, {fault}: " +
            ", ".join(f"{n_} row-wise {r:.3e} (old max-scaled check "
                      f"{'passes' if old else 'fails'})"
                      for n_, (r, old) in fres.items()))
    flex_text = (f"compiled flex_attention (the same function): fwd "
                 f"{flex_fwd:.4f} ms, backward (dq, dk, dv) {flex_bwd:.4f} "
                 f"ms, out row-wise {flex_err:.3e} from the plain version; "
                 if flex else "")
    ratio_text = ("no library call timed" if lib_fwd is None else
                  f"kernel / library ({library}): forward "
                  f"{fwd_ms / lib_fwd:.2f}x, dq + dk/dv "
                  f"{(dq_ms + dkv_ms) / lib_bwd:.2f}x")
    log(f"[kernels] splash attention {label} fwd kernel {fwd_ms:.4f} ms plain "
        f"{fwd_plain:.4f} ms bound {fb[0]:.4f} ms ({fb[1]}, "
        f"{100 * fb[0] / fwd_ms:.1f}%); dq kernel {dq_ms:.4f} ms bound "
        f"{qb[0]:.4f} ms ({100 * qb[0] / dq_ms:.1f}%); dk/dv kernel "
        f"{dkv_ms:.4f} ms bound {kb[0]:.4f} ms ({100 * kb[0] / dkv_ms:.1f}%); "
        f"plain backward {bwd_plain:.4f} ms; "
        f"{flex_text}SDPA with the same mask and "
        f"no softcap: fwd {sdpa_fwd:.4f} ms, backward {sdpa_bwd:.4f} ms; "
        f"{ratio_text}; {pairs} valid pairs per head")
    bad = [n_ for n_, (e, r) in errs.items() if not r <= ATTN_ROW_TOL]
    if bad or not lse_err <= 1e-3:
        raise RuntimeError(f"splash attention {label} disagrees in {bad}: "
                           f"{errs}, lse {lse_err}")
    if flex and not flex_err <= ATTN_ROW_TOL:
        raise RuntimeError(f"flex_attention, the library time of {label}, "
                           f"computes another function: {flex_err}")
    missed = [(f, n_) for f, fres in fault_res.items()
              for n_, (r, _) in fres.items() if not r > ATTN_ROW_TOL]
    if missed:
        raise RuntimeError(f"the splash attention check lets faults "
                           f"through: {missed}")
    del q, k, v, dout, out, lse, dq, dk, dv, di
    torch.cuda.empty_cache()
    return res


#: GRPO's shared-prefix layout on phase 12's path (the notebook's 256
#: prompt and 768 completion tokens: P = 256, L = roundup(769, 128))
GRPO_LAYOUT = (256, 6, 896)
#: phase 3's prompt and completion lengths in that layout
GRPO_PROMPT_LEN = 173
GRPO_COMPLETION_LENS = (768, 412, 57, 768, 230, 600)


def _grpo_kernels(dev, g, flush):
    """K18's prefix form (:func:`_splash_case` with the layout) at phase
    12's shape: Llama-3.1-8B's 32/8 heads of 128, scale 128^-0.5, one row
    of GRPO_LAYOUT (T = 5,632), a prompt of GRPO_PROMPT_LEN tokens
    right-aligned in its 256 slots and completions of GRPO_COMPLETION_LENS
    tokens, no softcap; the check must reject the region rule dropped, the
    prefix dropped and a pair across two regions called full; the
    kernels' tile-class counters must equal the rule's, and the kernels
    run again give the same bits. Library call: SDPA with the layout's
    dense [T, T] mask, which computes the same function (flex_attention's
    block mask would skip tiles as the kernels do, but its compile costs
    the script ~20 s and times no path)."""
    c = LLAMA_31_8B_CONFIG
    seg = prefix_segments(GRPO_LAYOUT, GRPO_PROMPT_LEN, GRPO_COMPLETION_LENS,
                          dev)
    res = _splash_case(dev, g, flush, "GRPO prefix layout", seg,
                       c["num_attention_heads"], c["num_key_value_heads"],
                       c["head_dim"], c["head_dim"] ** -0.5, None, None,
                       True, library="sdpa", form="prefix",
                       prefix_layout=GRPO_LAYOUT, same_bits=True)
    return {name: [row] for name, row in res.items()}


#: the non-causal forms' kernel names (the kernels line's entries)
FULL_FLASH = ("flash_attn_fwd_full", "flash_attn_dq_full",
              "flash_attn_dkv_full")
FULL_SPLASH = ("splash_attn_fwd_full", "splash_attn_dq_full",
               "splash_attn_dkv_full")


def _diffusion_kernels(dev, g, flush):
    """The non-causal forms of the text-diffusion path (:func:`_noncausal_case`):
    K16 without causality at (a) LLaDA-8B's 32/32 heads of 128 on the
    training batch's shape, [2, 2048] with a row of 1,500 real tokens and
    a pad tail and a full row, (b) Llama's 32/8 (GQA) on the same rows,
    (c) a ragged T of 200 (a row of 150 real tokens, a full row), (d) the
    generate canvas, B = 1, T = 128, one segment; and K18 without
    causality at (e) Gemma-2-9B's 16/8 heads of 256, softcap 50, no
    window, on the rows of (a). Library calls: SDPA with the segment mask
    (no ``is_causal``; the same function) for K16, compiled flex_attention
    with the softcap for K18 (its compiled graph is case (a) of the K18
    part's, the causality a tensor of its mask)."""
    import torch

    llada, llama, gemma = LLADA_8B_CONFIG, LLAMA_31_8B_CONFIG, \
        GEMMA2_9B_CONFIG
    padded = torch.ones((2, UNPACKED_ROWS), dtype=torch.int32, device=dev)
    padded[0, 1500:] = 0                      # pad_batch: 1 real, 0 pad
    ragged = torch.ones((2, 200), dtype=torch.int32, device=dev)
    ragged[0, 150:] = 0
    canvas = torch.ones((1, DIFFUSION_CANVAS), dtype=torch.int32, device=dev)
    rows = {}
    for label, seg, c, softcap, form in (
            ("(a) LLaDA-8B", padded, llada, None, None),
            ("(b) GQA 32/8", padded, llama, None, "gqa"),
            ("(c) ragged T=200", ragged, llada, None, "ragged"),
            ("(d) generate canvas", canvas, llada, None, "canvas"),
            ("(e) Gemma-2-9B", padded, gemma,
             gemma["attn_logit_softcapping"], None)):
        t_case = time.perf_counter()
        hq, hkv = c["num_attention_heads"], c["num_key_value_heads"]
        d = c["head_dim"]
        scale = (c.get("query_pre_attn_scalar") or d) ** -0.5
        first = label.startswith("(a)")
        res = _noncausal_case(dev, g, flush, label, seg, hq, hkv, d, scale,
                              softcap, form=form, classes=first,
                              same_bits=first)
        log(f"[time] 3 non-causal {label}: "
            f"{time.perf_counter() - t_case:.1f} s")
        for name, row in res.items():
            rows.setdefault(name, []).append(row)
    return rows


def _noncausal_case(dev, g, flush, label, seg, hq, hkv, d, scale, softcap,
                    form=None, classes=False, same_bits=False):
    """K16 (``softcap`` None) or K18 (a softcap, no window) without
    causality, forward, dq and dk/dv at one shape against the plain
    versions with ``causal=False``: every position row by row
    (:func:`attn_row_err`), lse within 1e-3, the backward fed the kernel
    forward's (out, lse) on both sides. q and k are N(0, 4^2) where a
    softcap bites, else N(0, 1). The check must reject the causal kernels'
    results on the same inputs (the slip this form guards against: their
    forward, then their dq and dk/dv from their own out and lse) and the
    faults of :func:`attn_fault_errs` with ``causal=False``; K18's
    tile-class counters must equal the rule's. Times: the
    kernels (median of 10), the plain versions (once), and the library
    call: SDPA with the segment mask for K16, compiled flex_attention with
    the softcap for K18 (its out held to the plain version as the
    kernel's). Bound: every (query, key) pair of a segment is valid, the
    pad tail's among its own. Returns a row per kernel, named by
    FULL_FLASH / FULL_SPLASH, tagged with ``form``."""
    import torch

    from unsloth_tpu_torch.ops import flash_attention as tfa
    from unsloth_tpu_torch.ops import splash_attention as tsa

    b, t = seg.shape
    std = 4.0 if softcap else 1.0
    q, k = ((torch.randn((b, t, h, d), generator=g, device=dev) * std)
            .to(torch.bfloat16) for h in (hq, hkv))
    v, dout = (torch.randn((b, t, h, d), generator=g, device=dev)
               .to(torch.bfloat16) for h in (hkv, hq))
    lo, hi = tfa.tile_segment_ranges(seg)
    if softcap is None:
        names, kind = FULL_FLASH, "flash attention (K16)"
        fns = (tfa.flash_attention_fwd_full, tfa.flash_attention_dq_full,
               tfa.flash_attention_dkv_full)
        causal_fns = (tfa.flash_attention_fwd, tfa.flash_attention_dq,
                      tfa.flash_attention_dkv)
        opts = copts = dict(scale=scale)

        def plain_fwd():
            return tfa.flash_attention_fwd_ref(q, k, v, seg, scale, False)

        def plain_bwd():
            return tfa.flash_attention_bwd_ref(q, k, v, seg, out, lse, dout,
                                               scale, False)
    else:
        names, kind = FULL_SPLASH, "splash attention (K18)"
        fns = (tsa.splash_attention_fwd_full, tsa.splash_attention_dq_full,
               tsa.splash_attention_dkv_full)
        causal_fns = (tsa.splash_attention_fwd, tsa.splash_attention_dq,
                      tsa.splash_attention_dkv)
        opts = dict(softcap=softcap, scale=scale)
        copts = dict(opts, window=None)

        def plain_fwd():
            return tsa.splash_attention_fwd_ref(q, k, v, seg, causal=False,
                                                **copts)

        def plain_bwd():
            return tsa.splash_attention_bwd_ref(q, k, v, seg, out, lse, dout,
                                                causal=False, **copts)
    out, lse = fns[0](q, k, v, seg, lo, hi, **opts)
    dq, di = fns[1](q, k, v, seg, lo, hi, out, lse, dout, **opts)
    dk, dv = fns[2](q, k, v, seg, lo, hi, lse, di, dout, **opts)
    (rout, rlse), fwd_plain = once_ms(plain_fwd)
    (rdq, rdk, rdv), bwd_plain = once_ms(plain_bwd)
    torch.cuda.synchronize()
    errs = {}
    for name, got, ref in (("out", out, rout), ("dq", dq, rdq),
                           ("dk", dk, rdk), ("dv", dv, rdv)):
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"non-causal {kind} {label} {name} is not "
                               "finite")
        errs[name] = ((got.float() - ref.float()).abs().max().item(),
                      attn_row_err(got, ref))
    lse_err = (lse - rlse).abs().max().item()
    want = (rout, rdq, rdk, rdv)
    faults = attn_fault_errs(q, k, v, seg, dout, scale, want,
                             softcap=softcap, causal=False)
    extra = {n_: {} for n_ in names}
    if softcap is None:
        faults.update(tile_fault_errs(q, k, v, seg, dout, scale, want,
                                      False))
        extra = _k16_checks(label, q, k, v, seg, out, lse, dout, scale,
                            False, (dq, dk, dv), classes, same_bits)
    else:
        got = kernel_tile_classes(q, k, v, seg, dout, scale, False,
                                  splash=dict(window=None, softcap=softcap,
                                              prefix_layout=None))
        rule = {w: flash_tile_counts(seg, False, *tfa.KERNEL_TILES[w][d],
                                     kernel=w) for w in got}
        log(f"[kernels] non-causal splash attention {label}: tile pairs a "
            "query head (skip, full, masked), kernels' counters / rule: " +
            "; ".join(f"{w} {got[w]} / {rule[w]} (tiles "
                      f"{tfa.KERNEL_TILES[w][d]})" for w in got))
        if got != rule:
            raise RuntimeError(f"K18's non-causal tile classes at {label} "
                               f"differ from the rule: {got} against {rule}")
        for n_, w in zip(names, ("fwd", "dq", "dkv")):
            extra[n_]["tile_classes"] = dict(zip(TILE_CLASSES, got[w]))
    cout, clse = causal_fns[0](q, k, v, seg, lo, hi, **copts)
    cdq, cdi = causal_fns[1](q, k, v, seg, lo, hi, cout, clse, dout, **copts)
    cdk, cdv = causal_fns[2](q, k, v, seg, lo, hi, clse, cdi, dout, **copts)
    faults["causal kernels"] = {
        name: (attn_row_err(got, ref), bool(
            (got.float() - ref.float()).abs().max()
            <= 2e-2 * ref.float().abs().max()))
        for name, got, ref in zip(("out", "dq", "dk", "dv"),
                                  (cout, cdq, cdk, cdv), want)}
    del cout, clse, cdq, cdi, cdk, cdv, rdq, rdk, rdv, want
    if softcap is None:
        lib_fwd, lib_bwd = _sdpa_ms(q, k, v, seg, dout, flush, causal=False)
        lib_err, lib_name = None, ("SDPA with the segment mask, no "
                                   "is_causal (the same function)")
    else:
        lib_fwd, lib_bwd, lib_err = _flex_ms(
            q, k, v, seg, dout, flush, rout, window=None, softcap=softcap,
            scale=scale, causal=False)
        lib_name = ("compiled flex_attention, softcap score_mod, segment "
                    "block mask (the same function)")
    del rout
    fwd_ms = time_ms(lambda: fns[0](q, k, v, seg, lo, hi, **opts), runs=10,
                     flush=flush)
    dq_ms = time_ms(lambda: fns[1](q, k, v, seg, lo, hi, out, lse, dout,
                                   **opts), runs=10, flush=flush)
    dkv_ms = time_ms(lambda: fns[2](q, k, v, seg, lo, hi, lse, di, dout,
                                    **opts), runs=10, flush=flush)
    # every pair of a segment is valid: the work these inputs need
    counts = [int((seg[i] == s_).sum()) for i in range(b)
              for s_ in torch.unique(seg[i]).tolist()]
    pairs = sum(x * x for x in counts)
    fb = bound(4 * d * hq * pairs, nbytes(q, k, v, seg, out, lse))
    qb = bound(6 * d * hq * pairs, nbytes(q, k, v, seg, out, dout, lse, q,
                                          di))
    kb = bound(8 * d * hq * pairs, nbytes(q, k, v, seg, dout, lse, di, k, v))
    lens = [int((seg[i] != 0).sum()) for i in range(b)]
    shape = (f"{label}: B={b} T={t} Hq={hq} Hkv={hkv} D={d} bf16 scale="
             f"{scale:.5f} softcap={softcap} causal=False, rows of "
             + " and ".join(f"{n} (+ {t - n} pad)" if n < t else f"{n}"
                            for n in lens) + " real tokens")
    common = dict(shape=shape, form=form, library=lib_name)
    res = {
        names[0]: dict(common, err=max(errs["out"][0], lse_err), ms=fwd_ms,
                       plain_ms=fwd_plain, bound_ms=fb[0], bound_by=fb[1],
                       library_ms=lib_fwd, **extra[names[0]]),
        names[1]: dict(common, err=errs["dq"][0], ms=dq_ms,
                       plain_ms=bwd_plain, bound_ms=qb[0], bound_by=qb[1],
                       library_ms=lib_bwd, **extra[names[1]]),
        names[2]: dict(common, err=max(errs["dk"][0], errs["dv"][0]),
                       ms=dkv_ms, plain_ms=bwd_plain, bound_ms=kb[0],
                       bound_by=kb[1], library_ms=lib_bwd,
                       **extra[names[2]])}
    log(f"[kernels] non-causal {kind} {shape}, every position: " +
        ", ".join(f"{n_} max|d|={e:.3e} row-wise {r:.3e}"
                  for n_, (e, r) in errs.items())
        + f" (row-wise tol {ATTN_ROW_TOL:.3e}); lse max|d|={lse_err:.3e} "
        "(tol 1e-3)")
    for fault, fres in faults.items():
        log(f"[kernels] non-causal check against a fault, {fault}: " +
            ", ".join(f"{n_} row-wise {r:.3e} (old max-scaled check "
                      f"{'passes' if old else 'fails'})"
                      for n_, (r, old) in fres.items()))
    lib_text = "" if lib_err is None else \
        f", its out row-wise {lib_err:.3e} from the plain version"
    log(f"[kernels] non-causal {label} fwd kernel {fwd_ms:.4f} ms plain "
        f"{fwd_plain:.4f} ms library {lib_fwd:.4f} ms bound {fb[0]:.4f} ms "
        f"({fb[1]}, {100 * fb[0] / fwd_ms:.1f}%); dq kernel {dq_ms:.4f} ms "
        f"bound {qb[0]:.4f} ms ({100 * qb[0] / dq_ms:.1f}%); dk/dv kernel "
        f"{dkv_ms:.4f} ms bound {kb[0]:.4f} ms ({100 * kb[0] / dkv_ms:.1f}%)"
        f"; plain backward {bwd_plain:.4f} ms, library backward (dq, dk, "
        f"dv) {lib_bwd:.4f} ms ({lib_name}{lib_text}); kernel / library: "
        f"forward {fwd_ms / lib_fwd:.2f}x, dq + dk/dv "
        f"{(dq_ms + dkv_ms) / lib_bwd:.2f}x; {pairs} valid pairs per head")
    bad = [n_ for n_, (e, r) in errs.items() if not r <= ATTN_ROW_TOL]
    if bad or not lse_err <= 1e-3:
        raise RuntimeError(f"non-causal {kind} {label} disagrees in {bad}: "
                           f"{errs}, lse {lse_err}")
    if lib_err is not None and not lib_err <= ATTN_ROW_TOL:
        raise RuntimeError(f"flex_attention, the library time of {label}, "
                           f"computes another function: {lib_err}")
    missed = [(f, n_) for f, fres in faults.items()
              for n_, (r, _) in fres.items() if not r > ATTN_ROW_TOL]
    if missed:
        raise RuntimeError(f"the non-causal attention check lets faults "
                           f"through: {missed}")
    del q, k, v, dout, out, lse, dq, dk, dv, di
    torch.cuda.empty_cache()
    return res


def _small_model_kernels(dev, g, flush):
    """The head-dim forms of the small Llama-family paths: K16 forward, dq
    and dk/dv (:func:`_flash_case`) on the recipe's padded [2, 2048] batch
    (a row of 1,500 real tokens and a pad tail, a full row) at head dim 64
    with Llama-3.2-1B's 32/8 heads and Qwen2.5-0.5B's 14/2, and at head
    dim 256 with Gemma-7B's 16/16; K18 (:func:`_splash_case`) at head dim
    64 on a packed row of SINKS_ROWS tokens with gpt-oss's sliding layers'
    64/8 heads, window 128 and no softcap (the row phase 4e's gpt-oss part
    takes), its library call SDPA with the causal, window and segment mask.
    Each must reject the faults of :func:`attn_fault_errs` (for K18 the
    window ignored among them)."""
    import torch

    seg = torch.ones((2, UNPACKED_ROWS), dtype=torch.int32, device=dev)
    seg[0, 1500:] = 0
    rows = {}
    for config, label, form in (
            (LLAMA_32_1B_CONFIG, "Llama-3.2-1B ", "d64"),
            (QWEN25_05B_CONFIG, "Qwen2.5-0.5B ", "d64"),
            (GEMMA_7B_CONFIG, "Gemma-7B ", "d256")):
        hq, hkv = config["num_attention_heads"], config["num_key_value_heads"]
        d = config.get("head_dim") or config["hidden_size"] // hq
        res = _flash_case(dev, g, flush, label, seg, hq, hkv, d, form=form,
                          same_bits=config is QWEN25_05B_CONFIG)
        for name, row in res.items():
            rows.setdefault(name, []).append(row)
    c = GPT_OSS_20B_CONFIG
    packed = torch.zeros((1, SINKS_ROWS), dtype=torch.int32, device=dev)
    for sid, (lo, hi) in enumerate(SINKS_DOCS, start=1):
        packed[0, lo:hi] = sid      # two documents and a pad tail
    res = _splash_case(dev, g, flush, "gpt-oss sliding, D=64", packed,
                       c["num_attention_heads"], c["num_key_value_heads"],
                       c["head_dim"], c["head_dim"] ** -0.5,
                       c["sliding_window"], None, True, library="sdpa",
                       form="d64")
    for name, row in res.items():
        rows.setdefault(name, []).append(row)
    return rows


def _gpt_oss_kernels(dev, g, flush):
    """The gpt-oss paths' own kernels at their shapes: K14 and K15
    (:func:`_gmm_case`, the NF4 experts) and K19 forward and dx
    (:func:`_dense_gmm_case`, the same experts as bf16 stacks) at (a) the
    path's 16,384 sorted rows (a real top-4 routing of 4,096 random tokens
    over 32 experts by a random router), N = K = 2,880, block 32, with
    bias; (b) a skewed routing of as many rows (one expert half of them,
    three more the rest, 28 none); (c) the 8 rows of a decode step (a
    top-4 routing of 2 tokens); K15 also at NF4_GMM_DX_SHAPES
    (:func:`_gmm_dx_shapes`: block 64, N % 64 != 0, sizes summing below
    m); K19's tgmm (:func:`_tgmm_case`, the expert
    weight gradient of the gate/up product, [E, F, D]) at (a) and (b) and
    at (d) TGMM_RAGGED; and K17 (:func:`_sinks_case`) on (a) the
    path's packed 4,096-token row and (b) a padded [2, 2048] batch, 64/8
    heads of 64, and (c) at SINKS_WIDE_HEADS on a padded [1, 1024] row,
    also through ``attention`` with sinks; K17's library yardstick at (a),
    and at (b) and (c) under ``--library-times`` (LIBRARY_TIMES)."""
    import numpy as np
    import torch

    from unsloth_tpu_torch.ops.moe import _route
    from unsloth_tpu_torch.ops.nf4 import quantize_nf4_stacked

    c = GPT_OSS_20B_CONFIG
    d, e, k = c["hidden_size"], c["num_local_experts"], c["num_experts_per_tok"]
    f = c["intermediate_size"]
    router = torch.randn((e, d), generator=g, device=dev) * 0.02
    w = (torch.randn((e, f, d), generator=g, device=dev) * 0.02
         ).to(torch.bfloat16)
    q = quantize_nf4_stacked(w, block_size=32)
    bias = (torch.randn((e, f), generator=g, device=dev) * 0.5
            ).to(torch.bfloat16)

    def routed_rows(n_tokens):
        x = torch.randn((n_tokens, d), generator=g, device=dev
                        ).to(torch.bfloat16)
        _, sel = _route(x.float() @ router.t(), k, True)
        flat = sel.reshape(-1)
        order = torch.argsort(flat, stable=True)
        sizes = torch.zeros(e, dtype=torch.int32, device=dev).index_add_(
            0, flat, torch.ones_like(flat, dtype=torch.int32))
        return x[order // k], sizes

    rows = {name: [] for name in ("nf4_gmm", "nf4_gmm_dx", "gmm", "gmm_dx",
                                  "tgmm", "flash_sinks_fwd", "flash_sinks_dq",
                                  "flash_sinks_dkv")}
    m = GPT_OSS_ROWS * k
    skew = torch.zeros(e, dtype=torch.int32)
    skew[3] = m // 2
    skew[[0, e // 2 + 1, e - 1]] = torch.tensor([m // 6, m // 6, m - m // 2
                                          - 2 * (m // 6)], dtype=torch.int32)
    x_path, sizes_path = routed_rows(GPT_OSS_ROWS)
    x_dec, sizes_dec = routed_rows(2)
    for label, x, sizes in (
            ("(a) path", x_path, sizes_path),
            ("(b) skewed", torch.randn((m, d), generator=g, device=dev
                                       ).to(torch.bfloat16), skew.to(dev)),
            ("(c) decode", x_dec, sizes_dec)):
        res = _gmm_case(dev, g, flush, label, x, q, sizes, bias)
        res.update(_dense_gmm_case(dev, g, flush, label, x, w, sizes, bias))
        if label != "(c) decode":
            res["tgmm"] = _tgmm_case(dev, g, flush, label, x, sizes, f)
        for name, row in res.items():
            rows[name].append(row)
    del q, w, x_path, x_dec
    torch.cuda.empty_cache()
    _gmm_dx_shapes(dev, g, flush)
    e_r, n_r, k_r, sizes_r = TGMM_RAGGED
    sizes_r = torch.tensor(sizes_r, dtype=torch.int32, device=dev)
    x_r = torch.randn((int(sizes_r.sum()), k_r), generator=g, device=dev
                      ).to(torch.bfloat16)
    rows["tgmm"].append(_tgmm_case(dev, g, flush, "(d) ragged", x_r, sizes_r,
                                   n_r))

    hq, hkv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                   c["head_dim"])
    packed = torch.from_numpy(_packed_segments(np.random.default_rng(SEED + 9),
                                               GPT_OSS_ROWS)).to(dev)
    padded = torch.ones((2, UNPACKED_ROWS), dtype=torch.int32, device=dev)
    padded[0, 1500:] = 0
    for label, seg, lib in (("(a) packed row", packed, True),
                            ("(b) padded", padded, LIBRARY_TIMES)):
        res = _sinks_case(dev, g, flush, label, seg, hq, hkv, hd, hd ** -0.5,
                          lib)
        for name, row in res.items():
            rows[name].append(row)
    # K17 at the head dims no model of the port runs with sinks
    wide = torch.ones((1, 1024), dtype=torch.int32, device=dev)
    wide[0, 800:] = 0
    for d_, hq_, hkv_ in SINKS_WIDE_HEADS:
        res = _sinks_case(dev, g, flush, f"(c) Dh {d_}", wide, hq_, hkv_, d_,
                          d_ ** -0.5, LIBRARY_TIMES, form=f"d{d_}")
        for name, row in res.items():
            rows[name].append(row)
    return rows


def _row_faults(want, faults):
    """{fault: row-wise error (:func:`attn_row_err`) of the faulty result
    against ``want``}; each must exceed ATTN_ROW_TOL."""
    return {name: attn_row_err(got, want) for name, got in faults.items()}


def nf4_gmm_faults(x, q, sizes, bias, ref):
    """K14 as its Hopper walk's two faults would compute it (the twin's,
    ``nf4_gmm_tiles_ref(past_end=..., low_with_high=...)``): the low side
    read with the high side's absmax block (run through the kernel, fed
    such an absmax), and the first tile that ends short of its row tile
    storing its rows past its group's end too (over the next group's rows:
    those rows through the previous group's weights and bias; none where
    no tile ends short)."""
    import dataclasses

    import torch

    from unsloth_tpu_torch.ops import nf4_gmm as tng
    from unsloth_tpu_torch.ops.nf4 import dequantize_nf4_stacked
    from unsloth_tpu_torch.ops.qlora_matmul import tile_rows_x

    e, n, k = q.shape
    m = x.shape[0]
    am = q.absmax.reshape(e, n, k // q.block_size).clone()
    hb = k // 2 // q.block_size
    am[..., hb:] = am[..., :hb]
    faults = {"low side with the high side's absmax": tng.nf4_gmm_fwd(
        x, dataclasses.replace(q, absmax=am.reshape(q.absmax.shape)), sizes,
        bias)}
    bx = tile_rows_x(m)
    short = [(g_, hi, min(row0 + bx, m))
             for block in tng.nf4_gmm_tile_schedule(sizes.tolist(), m, n)
             for g_, row0, hi, _ in block if min(row0 + bx, m) > hi]
    if short:
        g_, hi, stop = short[0]
        w = dequantize_nf4_stacked(q, torch.float32)[g_]
        bad = ref.clone()
        bad[hi:stop] = (x[hi:stop].float() @ w.t()
                        + bias[g_].float()).to(ref.dtype)
        faults["stored past the group's end"] = bad
    return faults


def nf4_gmm_dx_faults(gy, q, sizes, ref):
    """K15 as its Hopper walk's two faults would compute it (the twin's,
    ``nf4_gmm_dx_tiles_ref(past_end=..., first_block=...)``): at block 32,
    each tile's columns 32-63 read with the absmax block of its column 0 on
    both sides (run through the kernel, fed such an absmax), and the first
    tile that ends short of its row tile storing its rows past its group's
    end too (over the next group's rows: those rows through the previous
    group's weights; none where no tile ends short)."""
    import dataclasses

    import torch

    from unsloth_tpu_torch.ops import nf4_gmm as tng
    from unsloth_tpu_torch.ops.nf4 import dequantize_nf4_stacked
    from unsloth_tpu_torch.ops.qlora_matmul import tile_rows_x

    e, n, k = q.shape
    m = gy.shape[0]
    faults = {}
    if q.block_size == 32:
        hb = k // 2 // 32
        am = q.absmax.reshape(e, n, 2 * hb).clone()
        odd = torch.arange(1, hb, 2, device=am.device)
        am[..., odd] = am[..., odd - 1]
        am[..., hb + odd] = am[..., hb + odd - 1]
        faults["columns 32-63 with column 0's absmax block"] = tng.nf4_gmm_dx(
            gy, dataclasses.replace(q, absmax=am.reshape(q.absmax.shape)),
            sizes)
    bx = tile_rows_x(m)
    short = [(g_, hi, min(row0 + bx, m))
             for block in tng.nf4_gmm_dx_tile_schedule(sizes.tolist(), m, k)
             for g_, row0, hi, _ in block if min(row0 + bx, m) > hi]
    if short:
        g_, hi, stop = short[0]
        w = dequantize_nf4_stacked(q, torch.float32)[g_]
        bad = ref.clone()
        bad[hi:stop] = (gy[hi:stop].float() @ w).to(ref.dtype)
        faults["stored past the group's end"] = bad
    return faults


def _gmm_case(dev, g, flush, label, x, q, sizes, bias):
    """K14 (with the bias epilogue) and K15 at one routing against
    nf4_gmm_ref, row by row (:func:`attn_row_err`: each output row on its
    own rms; the kernels round each weight to bf16, the plain version keeps
    fp32, both sum in fp32), and max|d| beside it. The check must reject
    the rows of one expert multiplied by the next expert's weights (in both
    kernels), the bias dropped (K14) and the two faults of each kernel's
    walk (:func:`nf4_gmm_faults`, :func:`nf4_gmm_dx_faults`). Above 16
    rows K14's tile counters must equal its schedule's
    (``nf4_gmm_tile_counts``), at 16 or fewer its decode form's
    (``grouped_decode_schedule(...).grouped_counts``), and K15's at every
    row count its
    (``nf4_gmm_dx_tile_counts``); K15's per-call absmax transpose is timed
    on its own. Times: the kernels, the plain
    versions, and the library yardstick, which dequantizes the whole stack
    to bf16 and runs ``torch._grouped_mm`` (where the card's torch has
    it; labelled: it is dequantize + a grouped product, not one call).
    Bound: 2 m N K operations; bytes of the rows, of the experts this
    routing visits (packed and absmax) and of the output."""
    import torch

    from unsloth_tpu_torch.ops import nf4_gmm as tng
    from unsloth_tpu_torch.ops.nf4 import dequantize_nf4_stacked
    from unsloth_tpu_torch.ops.qlora_matmul import (DECODE_ROWS,
                                                    grouped_decode_schedule)

    e, n, k = q.shape
    m = x.shape[0]
    gy = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
    counts = torch.zeros(3, dtype=torch.int32, device=dev)
    dx_counts = torch.zeros(3, dtype=torch.int32, device=dev)
    y = tng.nf4_gmm_fwd(x, q, sizes, bias, tile_counts=counts)
    dx = tng.nf4_gmm_dx(gy, q, sizes, tile_counts=dx_counts)
    ref, ref_ms = once_ms(lambda: tng.nf4_gmm_ref(x, q, sizes, bias))
    rdx, rdx_ms = once_ms(
        lambda: tng.nf4_gmm_ref(gy, q, sizes, transpose=True))
    torch.cuda.synchronize()
    got_c, got_dx_c = counts.tolist(), dx_counts.tolist()
    want_c = tng.nf4_gmm_tile_counts(sizes.tolist(), m, n, k) \
        if m > DECODE_ROWS else grouped_decode_schedule(
            m, e, n, k, "nf4").grouped_counts(n, int((sizes > 0).sum()))
    want_dx_c = tng.nf4_gmm_dx_tile_counts(sizes.tolist(), m, n, k)
    log(f"[kernels] nf4_gmm {label}: tiles, stages, masked tiles (decode "
        f"rows: units, chunks, empty slots) {got_c} "
        f"(schedule {want_c}); nf4_gmm_dx {got_dx_c} (schedule "
        f"{want_dx_c})")
    if got_c != want_c or got_dx_c != want_dx_c:
        raise RuntimeError(f"nf4_gmm {label}: the kernels counted {got_c} "
                           f"and {got_dx_c} (tiles, stages, masked tiles), "
                           f"their schedules {want_c} and {want_dx_c}")
    errs = {}
    for name, got, want in (("nf4_gmm", y, ref), ("nf4_gmm_dx", dx, rdx)):
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"{name} {label} is not finite")
        errs[name] = ((got.float() - want.float()).abs().max().item(),
                      attn_row_err(got, want))
    # faults: one expert's rows through the next live expert's weights
    sz = sizes.tolist()
    live = [i for i, s_ in enumerate(sz) if s_]
    ends = torch.tensor(sz).cumsum(0).tolist()
    g0 = live[0]
    g1 = live[1] if len(live) > 1 else (g0 + 1) % e
    r0, r1 = ends[g0] - sz[g0], ends[g0]
    w1 = dequantize_nf4_stacked(q, torch.float32)[g1]
    wrong_y = ref.clone()
    wrong_y[r0:r1] = (x[r0:r1].float() @ w1.t() + bias[g0].float()
                      ).to(ref.dtype)
    wrong_dx = rdx.clone()
    wrong_dx[r0:r1] = (gy[r0:r1].float() @ w1).to(rdx.dtype)
    del w1
    faults = {"nf4_gmm": _row_faults(ref, {
        "next expert's weights": wrong_y,
        "bias dropped": tng.nf4_gmm_ref(x, q, sizes),
        **nf4_gmm_faults(x, q, sizes, bias, ref)}),
        "nf4_gmm_dx": _row_faults(rdx, {
            "next expert's weights": wrong_dx,
            **nf4_gmm_dx_faults(gy, q, sizes, rdx)})}
    lib = {"nf4_gmm": None, "nf4_gmm_dx": None}
    lib_err = {}
    if hasattr(torch, "_grouped_mm"):
        offs = sizes.cumsum(0).to(torch.int32)

        def lib_fwd():
            wd = dequantize_nf4_stacked(q, torch.bfloat16)
            return torch._grouped_mm(x, wd.transpose(1, 2), offs=offs) \
                + bias[torch.repeat_interleave(
                    torch.arange(e, device=dev), sizes.long(),
                    output_size=m)]

        def lib_dx():
            wd = dequantize_nf4_stacked(q, torch.bfloat16)
            return torch._grouped_mm(
                gy, wd.transpose(1, 2).contiguous().transpose(1, 2),
                offs=offs)

        for name, fn, want in (("nf4_gmm", lib_fwd, ref),
                               ("nf4_gmm_dx", lib_dx, rdx)):
            try:
                lib_err[name] = attn_row_err(fn(), want)
                lib[name] = time_ms(fn, runs=10, flush=flush)
            except Exception as exc:  # the yardstick only; logged
                lib_err[name] = f"torch._grouped_mm failed: {exc!r}"[:200]
    times = {
        "nf4_gmm": (time_ms(lambda: tng.nf4_gmm(x, q, sizes, bias),
                            flush=flush), ref_ms),
        "nf4_gmm_dx": (time_ms(lambda: tng.nf4_gmm_dx(gy, q, sizes),
                               flush=flush), rdx_ms)}
    # K15's wrapper transposes the absmax each call, inside its time above
    transpose_ms = time_ms(lambda: q.absmax.reshape(
        e, n, k // q.block_size).transpose(1, 2).contiguous(), runs=10,
        flush=flush)
    log(f"[kernels] nf4_gmm_dx {label}: the absmax transpose alone "
        f"{transpose_ms:.4f} ms")
    n_live = len(live)
    w_bytes = n_live * (n * k // 2 + n * k // q.block_size * 4)
    b_fwd = bound(2 * m * n * k, m * k * 2 + w_bytes + n_live * n * 2
                  + m * n * 2 + 4 * e)
    b_dx = bound(2 * m * n * k, m * n * 2 + w_bytes + m * k * 2 + 4 * e)
    shape = (f"{label}: m={m} E={e} N={n} K={k} block {q.block_size}, "
             f"{n_live} experts with rows (largest {max(sz)})")
    del y, dx, ref, rdx, wrong_y, wrong_dx, gy
    torch.cuda.empty_cache()
    res = _grouped_rows("grouped NF4", shape, errs, faults, times,
                        {"nf4_gmm": b_fwd, "nf4_gmm_dx": b_dx}, lib, lib_err,
                        "dequantize + torch._grouped_mm")
    res["nf4_gmm"]["tile_counts"] = got_c
    res["nf4_gmm_dx"]["tile_counts"] = got_dx_c
    res["nf4_gmm_dx"]["absmax_transpose_ms"] = transpose_ms
    return res


#: phase 3's further K15 shapes: (label, E, N, K, block, rows, the group
#: sizes' sum, or None for every row)
NF4_GMM_DX_SHAPES = (
    ("(d) block 64", 8, 768, 2048, 64, 2048, None),
    ("(e) N % 64 != 0", 8, 1000, 2880, 32, 2048, None),
    ("(f) sizes below m", 8, 2880, 2880, 32, 2048, 1900))


def _gmm_dx_shapes(dev, g, flush):
    """K15 at NF4_GMM_DX_SHAPES beyond the path's routings: a top-4 routing
    over E experts of rows/4 random tokens, cut to the sizes' sum where
    one is given (the rows past the groups must come out zero over memory
    the wrapper leaves uninitialised). Each against nf4_gmm_ref row by row
    within ATTN_ROW_TOL, its counters equal to ``nf4_gmm_dx_tile_counts``,
    and each fault of :func:`nf4_gmm_dx_faults` rejected; its time beside
    the plain version's."""
    import torch

    from unsloth_tpu_torch.ops import nf4_gmm as tng
    from unsloth_tpu_torch.ops.nf4 import quantize_nf4_stacked

    for label, e, n, k, bs, m, total in NF4_GMM_DX_SHAPES:
        q = quantize_nf4_stacked(
            torch.randn((e, n, k), generator=g, device=dev) * 0.02, bs)
        sel = torch.rand((m // 4, e), generator=g, device=dev).topk(
            4, dim=-1).indices.reshape(-1)
        sizes = torch.bincount(sel, minlength=e).to(torch.int32)
        if total is not None:
            for i in range(e - 1, -1, -1):
                cut = min(int(sizes.sum()) - total, int(sizes[i]))
                sizes[i] -= cut
        gy = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
        counts = torch.zeros(3, dtype=torch.int32, device=dev)
        torch.full((m, k), float("nan"), dtype=torch.bfloat16, device=dev)
        dx = tng.nf4_gmm_dx(gy, q, sizes, tile_counts=counts)
        ref, plain_ms = once_ms(
            lambda: tng.nf4_gmm_ref(gy, q, sizes, transpose=True))
        torch.cuda.synchronize()
        got_c = counts.tolist()
        want_c = tng.nf4_gmm_dx_tile_counts(sizes.tolist(), m, n, k)
        end = int(sizes.sum())
        err = attn_row_err(dx, ref)
        faults = _row_faults(ref, nf4_gmm_dx_faults(gy, q, sizes, ref))
        ms = time_ms(lambda: tng.nf4_gmm_dx(gy, q, sizes), flush=flush)
        log(f"[kernels] nf4_gmm_dx {label}: m={m} ({end} in groups) E={e} "
            f"N={n} K={k} block {bs}: row-wise {err:.3e} (tol "
            f"{ATTN_ROW_TOL:.3e}); tiles, stages, masked tiles {got_c} "
            f"(schedule {want_c}); faults "
            + ", ".join(f"{f_} {r:.3e}" for f_, r in faults.items())
            + f"; kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if not (bool(torch.isfinite(dx).all()) and err <= ATTN_ROW_TOL
                and bool((dx[end:] == 0).all())):
            raise RuntimeError(f"nf4_gmm_dx {label} disagrees: {err}")
        if got_c != want_c:
            raise RuntimeError(f"nf4_gmm_dx {label}: the kernel counted "
                               f"{got_c}, its schedule {want_c}")
        missed = [f_ for f_, r in faults.items() if not r > ATTN_ROW_TOL]
        if not faults or missed:
            raise RuntimeError(f"the nf4_gmm_dx check lets faults through "
                               f"at {label}: {missed or 'none made'}")
        del q, gy, dx, ref


def _grouped_rows(what, shape, errs, faults, times, bounds, lib, lib_err,
                  library):
    """Log and check one routing of a pair of grouped expert kernels,
    ``bounds`` {forward name: bound, dx name: bound}: each within
    ATTN_ROW_TOL row-wise of its plain version, each injected fault above
    it; returns their rows of the kernels line (the forward's library call
    adds a bias gather)."""
    res = {}
    for i, (name, (b_ms, b_by)) in enumerate(bounds.items()):
        ms, plain_ms = times[name]
        res[name] = dict(shape=shape, err=errs[name][0], row_err=errs[name][1],
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib[name],
                         library=library + ("" if i else " + bias gather"))
        log(f"[kernels] {name} {shape}: max|d|={errs[name][0]:.3e} row-wise "
            f"{errs[name][1]:.3e} (tol {ATTN_ROW_TOL:.3e}); faults "
            + ", ".join(f"{f_} {r:.3e}" for f_, r in faults[name].items())
            + f"; kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
            f"{b_ms:.4f} ms ({b_by}, {100 * b_ms / ms:.1f}% of it); "
            f"{library} {lib[name]} ms (row-wise {lib_err.get(name)})")
    bad = [n_ for n_, (_, r) in errs.items() if not r <= ATTN_ROW_TOL]
    if bad:
        raise RuntimeError(f"{what} kernels {shape} disagree: {errs}")
    missed = [(n_, f_) for n_, fs in faults.items() for f_, r in fs.items()
              if not r > ATTN_ROW_TOL]
    if missed:
        raise RuntimeError(f"the {what} check lets faults through: {missed}")
    return res


def _dense_gmm_case(dev, g, flush, label, x, w, sizes, bias):
    """K19 forward (with the bias epilogue) and dx at one routing against
    gmm_ref, row by row (:func:`attn_row_err`: each output row on its own
    rms; both round the same bf16 products' fp32 sums once, in another
    order, the forward then adds the bf16 bias and rounds again), and
    max|d| beside it. The check must reject the rows of one expert
    multiplied by the next expert's weights (forward and dx) and the bias
    dropped (forward), and a straddling tile's rows stored by the next
    expert's visit (:func:`gmm_straddle_faults`). Above 64 rows the
    kernels' work-unit counters must equal :func:`gmm_unit_counts`, at 16
    or fewer the forward's decode form's (``grouped_decode_schedule(...).
    grouped_counts``); at (a)
    a rerun must give the same bits. Times: the kernels, the plain
    versions, and the library call ``torch._grouped_mm`` (+ the bias
    gathered by row; where the card's torch has it), fed W in the
    column-major layout it takes, made once outside the timing, and the
    kernel's ratio to it; under ``--library-times`` both the kernels and
    the library call as :func:`_settled_ms`. Bound: 2 m N K operations;
    bytes of the rows, of the experts this routing visits and of the
    output."""
    import torch

    from unsloth_tpu_torch.ops import gmm as tgmm
    from unsloth_tpu_torch.ops.qlora_matmul import (DECODE_ROWS,
                                                    grouped_decode_schedule)

    e, n, k = w.shape
    m = x.shape[0]
    gy = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
    counted = m > tgmm.KERNEL_TILES["small_m"]
    decode = m <= DECODE_ROWS
    counts = {name: torch.zeros(3 if decode and name == "gmm" else 4,
                                dtype=torch.int32, device=dev)
              for name in ("gmm", "gmm_dx")}
    y = tgmm.gmm_fwd(x, w, sizes, bias, unit_counts=counts["gmm"])
    dx = tgmm.gmm_dx(gy, w, sizes, unit_counts=counts["gmm_dx"])
    ref, ref_ms = once_ms(lambda: tgmm.gmm_ref(x, w, sizes, bias))
    rdx, rdx_ms = once_ms(
        lambda: tgmm.gmm_ref(gy, w, sizes, transpose=True))
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in (("gmm", y, ref), ("gmm_dx", dx, rdx)):
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"{name} {label} is not finite")
        errs[name] = ((got.float() - want.float()).abs().max().item(),
                      attn_row_err(got, want))
    extra = {"gmm": {}, "gmm_dx": {}}
    if counted:
        # the kernels' work units against the schedule's twin
        sz = sizes.tolist()
        for name, n_out in (("gmm", n), ("gmm_dx", k)):
            got_c = counts[name].tolist()
            want_c = gmm_unit_counts(sz, m, n_out)
            log(f"[kernels] {name} {label}: work units (expert, past the "
                f"groups, TMA halves, masked halves) kernel {got_c} twin "
                f"{want_c}")
            if got_c != want_c:
                raise RuntimeError(f"K19 {name}'s work units at {label} "
                                   f"differ from the schedule: {got_c} "
                                   f"against {want_c}")
            extra[name]["unit_counts"] = got_c
    if decode:
        # the decode form's units, chunks and empty slots
        got_c = counts["gmm"].tolist()
        want_c = grouped_decode_schedule(m, e, n, k, "bf16").grouped_counts(
            n, int((sizes > 0).sum()))
        log(f"[kernels] gmm {label}: decode units, chunks, empty slots "
            f"kernel {got_c} schedule {want_c}")
        if got_c != want_c:
            raise RuntimeError(f"K19's decode form at {label} counted "
                               f"{got_c}, its schedule {want_c}")
        extra["gmm"]["unit_counts"] = got_c
    if label.startswith("(a)"):
        same = [bool(torch.equal(y, tgmm.gmm(x, w, sizes, bias))),
                bool(torch.equal(dx, tgmm.gmm_dx(gy, w, sizes)))]
        log(f"[kernels] gmm, gmm_dx {label}: run twice, same bits {same}")
        if not all(same):
            raise RuntimeError(f"K19 forward / dx at {label} gave other "
                               f"bits on a second run: {same}")
        extra["gmm"]["same_bits"] = extra["gmm_dx"]["same_bits"] = True
    # faults: one expert's rows through the next live expert's weights
    sz = sizes.tolist()
    live = [i for i, s_ in enumerate(sz) if s_]
    ends = torch.tensor(sz).cumsum(0).tolist()
    g0 = live[0]
    g1 = live[1] if len(live) > 1 else (g0 + 1) % e
    r0, r1 = ends[g0] - sz[g0], ends[g0]
    w1 = w[g1].float()
    wrong_y = ref.clone()
    wrong_y[r0:r1] = ((x[r0:r1].float() @ w1.t()).to(ref.dtype)
                      + bias[g0].to(ref.dtype))
    wrong_dx = rdx.clone()
    wrong_dx[r0:r1] = (gy[r0:r1].float() @ w1).to(rdx.dtype)
    del w1
    faults = {"gmm": _row_faults(ref, {
        "next expert's weights": wrong_y,
        "bias dropped": tgmm.gmm_ref(x, w, sizes),
        **gmm_straddle_faults(x, w, sizes, bias)}),
        "gmm_dx": _row_faults(rdx, {
            "next expert's weights": wrong_dx,
            **gmm_straddle_faults(gy, w, sizes, transpose=True)})}
    lib = {"gmm": None, "gmm_dx": None}
    lib_err = {}
    if hasattr(torch, "_grouped_mm"):
        offs = sizes.cumsum(0).to(torch.int32)
        w_cm = w.transpose(1, 2).contiguous()   # [E, K, N]

        def lib_fwd():
            return torch._grouped_mm(x, w.transpose(1, 2), offs=offs) \
                + bias[torch.repeat_interleave(
                    torch.arange(e, device=dev), sizes.long(),
                    output_size=m)]

        def lib_dx():
            return torch._grouped_mm(gy, w_cm.transpose(1, 2), offs=offs)

        for name, fn, want in (("gmm", lib_fwd, ref), ("gmm_dx", lib_dx, rdx)):
            try:
                lib_err[name] = attn_row_err(fn(), want)
                lib[name] = _settled_ms(fn, flush) if LIBRARY_TIMES \
                    else time_ms(fn, runs=10, flush=flush)
            except Exception as exc:  # the yardstick only; logged
                lib_err[name] = f"torch._grouped_mm failed: {exc!r}"[:200]
        del w_cm
    timed = _settled_ms if LIBRARY_TIMES else time_ms
    times = {
        "gmm": (timed(lambda: tgmm.gmm(x, w, sizes, bias), flush=flush),
                ref_ms),
        "gmm_dx": (timed(lambda: tgmm.gmm_dx(gy, w, sizes), flush=flush),
                   rdx_ms)}
    n_live = len(live)
    w_bytes = n_live * n * k * 2
    b_fwd = bound(2 * m * n * k, m * k * 2 + w_bytes + n_live * n * 2
                  + m * n * 2 + 4 * e)
    b_dx = bound(2 * m * n * k, m * n * 2 + w_bytes + m * k * 2 + 4 * e)
    shape = (f"{label}: m={m} E={e} N={n} K={k} bf16, {n_live} experts "
             f"with rows (largest {max(sz)})")
    del y, dx, ref, rdx, wrong_y, wrong_dx, gy
    torch.cuda.empty_cache()
    res = _grouped_rows("grouped dense", shape, errs, faults, times,
                        {"gmm": b_fwd, "gmm_dx": b_dx}, lib, lib_err,
                        "torch._grouped_mm")
    for name, row in res.items():
        row.update(extra[name])
        if row["library_ms"]:
            row["library_ratio"] = row["ms"] / row["library_ms"]
            log(f"[kernels] {name} {label}: kernel / torch._grouped_mm "
                f"{row['library_ratio']:.3f}")
    return res


def grouped_decode_faults(q, w, policy, plan):
    """The expert weights as a grouped decode walk that drops steps would
    read them (run through the kernel itself): where the schedule has
    several K slices, the middle slice's steps; at one slice, the last
    step of each row (gpt-oss's straddles K/2: 32 bytes of it are real).
    NF4 (``q``): those columns' absmax blocks zero on both sides; bf16
    (``w``): those columns zero. Returns (label, weights)."""
    import dataclasses

    if plan.slices > 1:
        st0 = plan.slices // 2 * plan.slice_steps
        st1 = min(st0 + plan.slice_steps, plan.steps)
        label = f"K slice {plan.slices // 2} of {plan.slices} dropped"
    else:
        st0, st1 = plan.steps - 1, plan.steps
        label = "the last step of each row dropped"
    if policy == "bf16":
        bad = w.clone()
        bad[..., 32 * st0:32 * st1] = 0
        return label, bad
    e, n, k = q.shape
    half, bs = k // 2, q.block_size
    am = q.absmax.reshape(e, n, k // bs).clone()
    for side in (0, half):
        am[..., (side + 64 * st0) // bs:
           -(-(side + min(64 * st1, half)) // bs)] = 0.0
    return label, dataclasses.replace(q, absmax=am.reshape(q.absmax.shape))


def _gmm_decode_kernels(dev, g, flush):
    """K14's and K19's forwards at decode rows, the grouped form of the
    decode kernel (csrc/decode_matmul.cu), on gpt-oss-20b's experts (E =
    32, N = K = 2,880, K14 at block 32, the bf16 bias), routed as
    :func:`_gpt_oss_kernels` routes them, top-4 from 1, 2 and 4 random
    tokens (m = 4, 8, 16), and 16 rows skewed 7/5/3/1 over 4 experts;
    inputs from a generator of its own (``g`` is left as it is, so the
    later parts keep their inputs); run before the parts that compile
    flex_attention (on the card, every trace taken after them in the same
    process came back without a device event). Each row by row within
    ATTN_ROW_TOL of its plain version (:func:`_grouped_rows`), its
    counters (units, 16-byte chunks, empty slots) equal to
    ``grouped_decode_schedule``'s, a second run the same bits, one kernel
    a call (:func:`launched_kernels`), and the faults
    rejected: one expert's rows through the next live expert's weights,
    the bias dropped, and steps dropped (:func:`grouped_decode_faults`,
    through the kernel). Times: the wrapper, the plain version, the
    library yardstick (K14: dequantize + ``torch._grouped_mm``; K19:
    ``torch._grouped_mm``; each + the bias gathered by row) and the bound
    (the bytes of the rows, of the experts with rows and their bias rows,
    of the output)."""
    import torch

    from unsloth_tpu_torch.ops import gmm as tgmm
    from unsloth_tpu_torch.ops import nf4_gmm as tng
    from unsloth_tpu_torch.ops.moe import _route
    from unsloth_tpu_torch.ops.nf4 import (dequantize_nf4_stacked,
                                           quantize_nf4_stacked)
    from unsloth_tpu_torch.ops.qlora_matmul import grouped_decode_schedule

    c = GPT_OSS_20B_CONFIG
    d, e, top = (c["hidden_size"], c["num_local_experts"],
                 c["num_experts_per_tok"])
    n = k = d
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    router = torch.randn((e, d), generator=g, device=dev) * 0.02
    w = (torch.randn((e, n, k), generator=g, device=dev) * 0.02
         ).to(torch.bfloat16)
    q = quantize_nf4_stacked(w, block_size=32)
    bias = (torch.randn((e, n), generator=g, device=dev) * 0.5
            ).to(torch.bfloat16)

    def routed(tokens):
        x = torch.randn((tokens, d), generator=g, device=dev
                        ).to(torch.bfloat16)
        _, sel = _route(x.float() @ router.t(), top, True)
        flat = sel.reshape(-1)
        order = torch.argsort(flat, stable=True)
        sizes = torch.zeros(e, dtype=torch.int32, device=dev).index_add_(
            0, flat, torch.ones_like(flat, dtype=torch.int32))
        return x[order // top], sizes

    skew = torch.zeros(e, dtype=torch.int32, device=dev)
    skew[[3, 9, 17, 30]] = torch.tensor([7, 5, 3, 1], dtype=torch.int32,
                                        device=dev)
    cases = [("m=4", *routed(1)), ("m=8", *routed(2)), ("m=16", *routed(4)),
             ("m=16 skewed", torch.randn((16, d), generator=g, device=dev
                                         ).to(torch.bfloat16), skew)]
    rows = {"nf4_gmm_decode": [], "gmm_decode": []}
    forms = {"nf4_gmm_decode": ("nf4", q, tng.nf4_gmm_ref,
                                "dequantize + torch._grouped_mm"),
             "gmm_decode": ("bf16", w, tgmm.gmm_ref, "torch._grouped_mm")}
    for label, x, sizes in cases:
        m = x.shape[0]
        sz = sizes.tolist()
        live = [i for i, s_ in enumerate(sz) if s_]
        ends = torch.tensor(sz).cumsum(0).tolist()
        g0, g1 = live[0], live[1] if len(live) > 1 else (live[0] + 1) % e
        r0, r1 = ends[g0] - sz[g0], ends[g0]
        offs = sizes.cumsum(0).to(torch.int32)
        bias_rows = bias[torch.repeat_interleave(
            torch.arange(e, device=dev), sizes.long(), output_size=m)]
        for name, (policy, wt, plain, library) in forms.items():
            plan = grouped_decode_schedule(m, e, n, k, policy)

            def fn(weights, counts=None):
                if policy == "nf4":
                    return tng.nf4_gmm_decode(x, weights, sizes, bias,
                                              tile_counts=counts)
                return tgmm.gmm_decode(x, weights, sizes, bias,
                                       unit_counts=counts)

            counts = torch.zeros(3, dtype=torch.int32, device=dev)
            y = fn(wt, counts)
            again = fn(wt)
            ref, plain_ms = once_ms(lambda: plain(x, wt, sizes, bias))
            torch.cuda.synchronize()
            got_c, want_c = counts.tolist(), plan.grouped_counts(n, len(live))
            same = bool(torch.equal(y, again))
            if not bool(torch.isfinite(y).all()):
                raise RuntimeError(f"{name} {label} is not finite")
            errs = {name: ((y.float() - ref.float()).abs().max().item(),
                           attn_row_err(y, ref))}
            if policy == "nf4":
                w1 = dequantize_nf4_stacked(q, torch.float32)[g1]
                wrong_rows = (x[r0:r1].float() @ w1.t()
                              + bias[g0].float()).to(ref.dtype)
            else:
                wrong_rows = ((x[r0:r1].float() @ w[g1].float().t()
                               ).to(ref.dtype) + bias[g0].to(ref.dtype))
            wrong = ref.clone()
            wrong[r0:r1] = wrong_rows
            drop_label, dropped = grouped_decode_faults(q, w, policy, plan)
            faults = {name: _row_faults(ref, {
                "next expert's weights": wrong,
                "bias dropped": plain(x, wt, sizes),
                drop_label: fn(dropped)})}
            del dropped
            launched = launched_kernels(lambda: fn(wt))
            lib, lib_err = {name: None}, {}
            if hasattr(torch, "_grouped_mm"):
                def lib_fn():
                    wd = w if policy == "bf16" else \
                        dequantize_nf4_stacked(q, torch.bfloat16)
                    return torch._grouped_mm(x, wd.transpose(1, 2),
                                             offs=offs) + bias_rows
                try:
                    lib_err[name] = attn_row_err(lib_fn(), ref)
                    lib[name] = time_ms(lib_fn, runs=10, flush=flush)
                except Exception as exc:  # the yardstick only; logged
                    lib_err[name] = f"torch._grouped_mm failed: {exc!r}"[:200]
            times = {name: (time_ms(lambda: fn(wt), flush=flush), plain_ms)}
            w_bytes = len(live) * (n * k // 2 + n * k // q.block_size * 4
                                   if policy == "nf4" else n * k * 2)
            b = bound(2 * m * n * k, m * k * 2 + w_bytes + len(live) * n * 2
                      + m * n * 2 + 4 * e)
            shape = (f"decode {label}: m={m} E={e} N={n} K={k} "
                     f"{'NF4 block ' + str(q.block_size) if policy == 'nf4' else 'bf16'}, "
                     f"{len(live)} experts with rows (largest {max(sz)})")
            log(f"[kernels] {name} {label}: units, chunks, empty slots "
                f"{got_c} (schedule {want_c}, row warps/slices/steps "
                f"{tuple(plan[:3])}); same bits run twice {same}; one call "
                f"launched {launched}")
            if got_c != want_c or not same or len(launched) != 1 \
                    or "grouped_decode_kernel" not in launched[0]:
                raise RuntimeError(f"{name} {label}: counted {got_c} "
                                   f"(schedule {want_c}), same bits {same}, "
                                   f"one call launched {launched}")
            res = _grouped_rows(f"{name} decode", shape, errs, faults, times,
                                {name: b}, lib, lib_err, library)
            res[name].update(tile_counts=got_c, same_bits=same,
                             schedule=tuple(plan[:3]))
            rows[name].append(res[name])
            del y, again, ref, wrong
    del w, q
    torch.cuda.empty_cache()
    return rows


#: tgmm's row chunk (csrc/tgmm.cu kChunk, ops.gmm.KERNEL_TILES
#: "tgmm_chunk"): the "last partial chunk dropped" fault drops each group's
#: rows past its last whole chunk
TGMM_CHUNK = 64
#: phase 3's small ragged tgmm case: (E, N, K, group sizes): N and K not
#: multiples of 64, empty experts, groups not multiples of the chunk
TGMM_RAGGED = (6, 200, 136, (0, 45, 0, 70, 1, 33))


def gmm_work_units(sizes, m, n_out, tiles=None):
    """The work units of K19's forward / dx kernel at more than
    KERNEL_TILES["small_m"] rows (csrc/gmm.cu: unit_of, build_tables), in
    the kernel's numbering: a list of dicts (g, row0, lo, hi, col0). Group
    g (of E = len(sizes)) owns rows [off_g, off_g + size_g), sizes clamped
    to [0, m]; group E is the rows past the groups, whose units store
    zeros. A group's units are its visits (the ``rows``-row tiles it
    touches, its rows [lo, hi) of each) times the ``cols``-column tiles of
    the output, column tile by column tile with the visits fastest. (The
    kernel's clusters of two CTAs take the experts' units in pairs, 2 q and
    2 q + 1; the second CTA of an odd last pair loads a copy of the first's
    unit and stores nothing.)"""
    from unsloth_tpu_torch.ops.gmm import KERNEL_TILES

    t = tiles or KERNEL_TILES
    bm, bn = t["rows"], t["cols"]
    ncol = -(-n_out // bn)
    sz = [int(s_) for s_ in sizes]
    ends, off = [], 0
    for s_ in sz:
        off = min(off + max(s_, 0), m)
        ends.append(off)
    ends.append(m)
    units, start = [], 0
    for g, end in enumerate(ends):
        if end > start:
            first, last = start // bm, (end - 1) // bm
            nv = last - first + 1
            for c in range(ncol):
                for v in range(nv):
                    row0 = (first + v) * bm
                    units.append(dict(g=g, row0=row0, lo=max(start, row0),
                                      hi=min(end, row0 + bm), col0=c * bn))
        start = end
    return units


def gmm_unit_counts(sizes, m, n_out, tiles=None):
    """[units of an expert, units of the rows past the groups, 64-row
    halves stored by TMA, halves stored by masked stores]: what K19's
    forward / dx kernel adds to its ``unit_counts`` (:func:`gmm_work_units`:
    a half of rows r0 .. r0 + 63 holding none of the unit's rows is skipped,
    one holding only them goes by TMA, any other by masked stores)."""
    counts = [0, 0, 0, 0]
    for u in gmm_work_units(sizes, m, n_out, tiles):
        counts[0 if u["g"] < len(sizes) else 1] += 1
        for r0 in (u["row0"], u["row0"] + 64):
            if r0 < u["hi"] and r0 + 64 > u["lo"]:
                counts[2 if u["lo"] <= r0 and r0 + 64 <= u["hi"] else 3] += 1
    return counts


def gmm_stored(units, n_out, tiles=None):
    """[(g, rows range, columns range)] that the units of
    :func:`gmm_work_units` store: each 64-row half's rows inside [lo, hi),
    its columns below n_out."""
    from unsloth_tpu_torch.ops.gmm import KERNEL_TILES

    bn = (tiles or KERNEL_TILES)["cols"]
    out = []
    for u in units:
        for r0 in (u["row0"], u["row0"] + 64):
            lo, hi = max(u["lo"], r0), min(u["hi"], r0 + 64)
            if lo < hi:
                out.append((u["g"], range(lo, hi),
                            range(u["col0"], min(u["col0"] + bn, n_out))))
    return out


def tgmm_work_units(sizes, n, k, m=None, tiles=None):
    """The work units of K19's tgmm kernel (csrc/tgmm.cu) in its
    numbering: dicts (g, n0, k0, chunks), a unit per (expert, ``tgmm_n`` x
    ``tgmm_k`` tile of [N, K]), expert by expert, the experts by rows, most
    first (ties by index), N tiles by N tiles with the K tiles fastest;
    chunks the (first row, rows kept) of each ``tgmm_chunk``-row chunk of
    the group, from its first row: the rows past the group's end are the
    ones the kernel zeros. Sizes clamped to [0, m]."""
    from unsloth_tpu_torch.ops.gmm import KERNEL_TILES

    t = tiles or KERNEL_TILES
    tn, tk, ch = t["tgmm_n"], t["tgmm_k"], t["tgmm_chunk"]
    sz = [int(s_) for s_ in sizes]
    m = sum(max(s_, 0) for s_ in sz) if m is None else m
    spans, off = [], 0
    for s_ in sz:
        end = min(off + max(s_, 0), m)
        spans.append((off, end))
        off = end
    order = sorted(range(len(sz)), key=lambda g: (spans[g][0] - spans[g][1],
                                                   g))
    units = []
    for g in order:
        lo, end = spans[g]
        chunks = [(r, min(ch, end - r)) for r in range(lo, end, ch)]
        for n0 in range(0, n, tn):
            for k0 in range(0, k, tk):
                units.append(dict(g=g, n0=n0, k0=k0, chunks=chunks))
    return units


def tgmm_unit_counts(sizes, n, k, m=None, tiles=None):
    """[units of an expert with rows, units of an empty expert, chunks
    reduced, chunks zeroed past the group's end]: what K19's tgmm kernel
    adds to its ``unit_counts`` (:func:`tgmm_work_units`)."""
    from unsloth_tpu_torch.ops.gmm import KERNEL_TILES

    ch = (tiles or KERNEL_TILES)["tgmm_chunk"]
    counts = [0, 0, 0, 0]
    for u in tgmm_work_units(sizes, n, k, m, tiles):
        counts[0 if u["chunks"] else 1] += 1
        counts[2] += len(u["chunks"])
        counts[3] += sum(kept < ch for _, kept in u["chunks"])
    return counts


def gmm_straddle_faults(x, w, sizes, bias=None, transpose=False):
    """{fault: output} of K19's forward (dx with ``transpose``) as a wrong
    schedule would write it, by the plain version: the first 128-row tile
    that straddles two experts with rows has the first expert's rows in it
    stored by the second expert's visit (through that expert's weights and
    bias). Empty where no tile straddles."""
    import torch

    from unsloth_tpu_torch.ops.gmm import KERNEL_TILES, gmm_ref

    bm = KERNEL_TILES["rows"]
    ref = gmm_ref(x, w, sizes, bias, transpose=transpose)
    sz = [int(s_) for s_ in sizes.tolist()]
    ends = torch.tensor(sz).cumsum(0).tolist()
    live = [i for i, s_ in enumerate(sz) if s_]
    for g0, g1 in zip(live, live[1:]):
        b = ends[g0]
        if b % bm:
            r0 = max(b // bm * bm, b - sz[g0])
            wg = w[g1].float()
            y = (x[r0:b].float() @ (wg if transpose else wg.t())).to(ref.dtype)
            if bias is not None and not transpose:
                y = y + bias[g1].to(ref.dtype)
            wrong = ref.clone()
            wrong[r0:b] = y
            return {"straddling rows stored by the next expert's visit":
                    wrong}
    return {}


def tgmm_faults(lhs, gy, sizes):
    """dW as a wrong K19 tgmm would write it, each by the plain version
    and each only where these sizes let it show: each group summing the
    next group's first row too (where a group is followed by rows); an
    empty expert left unwritten (its slab NaN, as in memory filled with NaN
    first; where an expert is empty); each group's rows past its last whole
    TGMM_CHUNK-row chunk dropped (where a group is not a whole number of
    chunks); the result written [E, K, N]."""
    import torch

    from unsloth_tpu_torch.ops.gmm import tgmm_ref

    ref = tgmm_ref(lhs, gy, sizes)
    sz = [int(s_) for s_ in sizes.tolist()]
    e, n, k = ref.shape
    ends = torch.tensor(sz).cumsum(0).tolist()
    faults = {}
    over = ref.clone()
    for gi, end in enumerate(ends):
        if sz[gi] and end < lhs.shape[0]:
            r0 = end - sz[gi]
            over[gi] = (gy[r0:end + 1].float().t()
                        @ lhs[r0:end + 1].float()).to(ref.dtype)
    if not torch.equal(over, ref):
        faults["next group's row counted"] = over
    if 0 in sz:
        unwritten = ref.clone()
        unwritten[sz.index(0)] = float("nan")
        faults["empty expert unwritten"] = unwritten
    if any(s_ % TGMM_CHUNK for s_ in sz):
        dropped = gy.clone()
        for gi, end in enumerate(ends):
            keep = end - sz[gi] + sz[gi] // TGMM_CHUNK * TGMM_CHUNK
            dropped[keep:end] = 0
        faults["last partial chunk dropped"] = tgmm_ref(lhs, dropped, sizes)
    faults["written [E, K, N]"] = ref.transpose(1, 2).reshape(e, n, k)
    return faults


def tgmm_library(lhs, gy, sizes):
    """(fn, label): the one PyTorch call that computes tgmm's function,
    ``torch._grouped_mm(gy^T, lhs, offs=cumsum(sizes))`` (ragged in the
    contraction, a 3-D [E, N, K] output), a yardstick only. The layouts it
    takes are tried in turn: as they come, then gy^T row-major and lhs
    column-major (copies made here, outside the timing; the label says
    so). Where it refuses them all, a per-expert torch.matmul loop,
    labelled as such."""
    import torch

    offs = sizes.cumsum(0).to(torch.int32)
    errors = []
    if hasattr(torch, "_grouped_mm"):
        gt_rm = gy.t().contiguous()
        lhs_cm = lhs.t().contiguous().t()
        for a, b, label in (
                (gy.t(), lhs, "torch._grouped_mm(gy.t(), lhs, offs)"),
                (gt_rm, lhs_cm, "torch._grouped_mm(gy.t() row-major, lhs "
                 "column-major, offs); the two copies outside the timing")):
            try:
                torch._grouped_mm(a, b, offs=offs)
                return (lambda a=a, b=b: torch._grouped_mm(a, b, offs=offs)
                        ), label
            except Exception as exc:  # the yardstick only; logged
                errors.append(repr(exc)[:160])
    ends = sizes.cumsum(0).tolist()

    def loop():
        out = torch.empty((len(ends), gy.shape[1], lhs.shape[1]),
                          dtype=lhs.dtype, device=lhs.device)
        start = 0
        for gi, end in enumerate(ends):
            torch.matmul(gy[start:end].t(), lhs[start:end], out=out[gi])
            start = end
        return out

    return loop, ("per-expert torch.matmul loop (torch._grouped_mm refused: "
                  + "; ".join(errors) + ")")


def _tgmm_case(dev, g, flush, label, x, sizes, n):
    """K19 tgmm at one routing against tgmm_ref (fp32 sums of the same bf16
    products per expert, one rounding): every element within MM_ULPS
    (:func:`mm_ulps`), the empty experts' slabs exactly zero with the
    output's memory filled with NaN first, each fault of
    :func:`tgmm_faults` rejected, the kernel's work-unit counters equal to
    :func:`tgmm_unit_counts` and, at (a), a rerun's bits the same. Times:
    the kernel, the plain version once, the library yardstick of
    :func:`tgmm_library` and the kernel's ratio to it. Bound: 2 m N K
    operations; bytes of lhs, gy and dW."""
    import torch

    from unsloth_tpu_torch.ops import gmm as tgmm

    m, k = x.shape
    e = sizes.shape[0]
    gy = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
    # the caching allocator hands tgmm's output the NaN block just freed
    nan = torch.full((e, n, k), float("nan"), dtype=torch.bfloat16,
                     device=dev)
    nan_ptr = nan.data_ptr()
    del nan
    counts = torch.zeros(4, dtype=torch.int32, device=dev)
    got = tgmm.tgmm(x, gy, sizes, unit_counts=counts)
    reused = got.data_ptr() == nan_ptr
    ref, plain_ms = once_ms(lambda: tgmm.tgmm_ref(x, gy, sizes))
    torch.cuda.synchronize()
    sz = [int(s_) for s_ in sizes.tolist()]
    got_c, want_c = counts.tolist(), tgmm_unit_counts(sz, n, k, m)
    log(f"[kernels] tgmm {label}: work units (expert with rows, empty "
        f"expert, chunks, chunks zeroed) kernel {got_c} twin {want_c}")
    if got_c != want_c:
        raise RuntimeError(f"K19 tgmm's work units at {label} differ from "
                           f"the schedule: {got_c} against {want_c}")
    same = None
    if label.startswith("(a)"):
        same = bool(torch.equal(got, tgmm.tgmm(x, gy, sizes)))
        log(f"[kernels] tgmm {label}: run twice, same bits {same}")
        if not same:
            raise RuntimeError(f"K19 tgmm at {label} gave other bits on a "
                               f"second run")
    empty = [i for i, s_ in enumerate(sz) if not s_]
    ulps = mm_ulps(got, ref)
    err = (got.float() - ref.float()).abs().max().item()
    zeros = all(bool((got[i] == 0).all()) for i in empty)
    faults = {f_: mm_ulps(fw, ref)
              for f_, fw in tgmm_faults(x, gy, sizes).items()}
    ms = time_ms(lambda: tgmm.tgmm(x, gy, sizes), flush=flush)
    lib_fn, library = tgmm_library(x, gy, sizes)
    lib_ulps = mm_ulps(lib_fn(), ref)
    lib_ms = time_ms(lib_fn, runs=10, flush=flush)
    b_ms, b_by = bound(2 * m * n * k, nbytes(x, gy) + e * n * k * 2)
    shape = (f"{label}: m={m} E={e} N={n} K={k} bf16, {e - len(empty)} "
             f"experts with rows (largest {max(sz)})")
    log(f"[kernels] tgmm {shape}: max|d|={err:.3e} ({ulps:.2f} ulp, limit "
        f"{MM_ULPS}); empty experts {empty[:4]}{'...' if len(empty) > 4 else ''}"
        f" zero {zeros} (output on the NaN block: {reused}); faults "
        + ", ".join(f"{f_} {u:.1f} ulp" for f_, u in faults.items())
        + f"; kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {b_ms:.4f} ms "
        f"({b_by}, {100 * b_ms / ms:.1f}% of it); {library} {lib_ms:.4f} ms "
        f"({lib_ulps:.2f} ulp; kernel / library {ms / lib_ms:.3f})")
    if not (bool(torch.isfinite(got).all()) and ulps <= MM_ULPS and zeros):
        raise RuntimeError(f"tgmm disagrees at {shape}: {ulps} ulp, empty "
                           f"experts zero: {zeros}")
    missed = [f_ for f_, u in faults.items() if u <= MM_ULPS]
    if missed:
        raise RuntimeError(f"the tgmm check lets faults through at {shape}: "
                           f"{missed}")
    del got, ref, gy
    torch.cuda.empty_cache()
    return dict(shape=shape, err=err, ulps=ulps, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                library=library, library_ratio=ms / lib_ms,
                unit_counts=got_c,
                **({} if same is None else {"same_bits": same}))


def _sinks_case(dev, g, flush, label, seg, hq, hkv, d, scale, lib,
                form=None):
    """K17 forward, dq, dk/dv and dsinks at one shape against the plain
    versions: out, dq, dk, dv at every position row by row
    (:func:`attn_row_err`), lse' within 1e-3, dsinks within 1e-2 of its
    largest value (a sum over 4,096 tokens of fp32 terms from the kernels'
    di); the backward fed the kernel forward's (out, lse') on both sides.
    Sinks are N(0, 2^2), so they weigh against a few keys and little
    against a thousand. The check must reject the sink ignored (the plain
    versions without it) and dsinks dropped. With ``lib``, the library
    yardstick: ``torch.compile``d ``flex_attention`` (block mask of causal
    and equal segment ids, GQA) with ``return_lse``, rescaled by
    sigmoid(lse - sink), forward and backward (labelled: flex plus the
    rescale). A head-dim ``form`` no model path runs with sinks is also
    driven through ``ops.attention.attention`` with sinks, forward and
    backward (:func:`_sinks_through_attention`)."""
    import torch

    from unsloth_tpu_torch.ops import flash_attention as tfa
    from unsloth_tpu_torch.ops import flash_sinks as tfs

    b, t = seg.shape
    q, k, v, dout = (torch.randn((b, t, h, d), generator=g, device=dev)
                     .to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
    sinks = torch.randn((hq,), generator=g, device=dev) * 2
    lo, hi = tfa.tile_segment_ranges(seg)
    out, lse = tfs.flash_sinks_fwd(q, k, v, seg, lo, hi, sinks, scale=scale)
    dq, di = tfs.flash_sinks_dq(q, k, v, seg, lo, hi, out, lse, dout,
                                scale=scale)
    dk, dv = tfs.flash_sinks_dkv(q, k, v, seg, lo, hi, lse, di, dout,
                                 scale=scale)
    dsk = tfs.sinks_grad(sinks, lse, di)
    (rout, rlse), fwd_plain = once_ms(
        lambda: tfs.flash_sinks_fwd_ref(q, k, v, seg, sinks, scale))
    (rdq, rdk, rdv, rdsk), bwd_plain = once_ms(
        lambda: tfs.flash_sinks_bwd_ref(q, k, v, seg, out, lse, dout, sinks,
                                        scale))
    torch.cuda.synchronize()
    errs = {}
    for name, got, ref in (("out", out, rout), ("dq", dq, rdq),
                           ("dk", dk, rdk), ("dv", dv, rdv)):
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"flash sinks {label} {name} is not finite")
        errs[name] = ((got.float() - ref.float()).abs().max().item(),
                      attn_row_err(got, ref))
    lse_err = (lse - rlse).abs().max().item()
    dsk_err = (dsk - rdsk).abs().max().item()
    dsk_tol = 1e-2 * rdsk.abs().max().item()
    # faults: the sink ignored (plain K16 math on the same inputs), dsinks
    # dropped
    nout, nlse = tfa.flash_attention_fwd_ref(q, k, v, seg, scale)
    ndq, ndk, ndv = tfa.flash_attention_bwd_ref(q, k, v, seg, nout, nlse,
                                                dout, scale)
    faults = {n_: attn_row_err(got, ref) for n_, got, ref in (
        ("out", nout, rout), ("dq", ndq, rdq), ("dk", ndk, rdk),
        ("dv", ndv, rdv))}
    dsk_dropped = rdsk.abs().max().item()
    del nout, nlse, ndq, ndk, ndv, rdq, rdk, rdv
    fwd_ms = time_ms(lambda: tfs.flash_sinks_fwd(
        q, k, v, seg, lo, hi, sinks, scale=scale), runs=10, flush=flush)
    dq_ms = time_ms(lambda: tfs.flash_sinks_dq(
        q, k, v, seg, lo, hi, out, lse, dout, scale=scale), runs=10,
        flush=flush)
    dkv_ms = time_ms(lambda: tfs.flash_sinks_dkv(
        q, k, v, seg, lo, hi, lse, di, dout, scale=scale), runs=10,
        flush=flush)
    # K16's kernels on the same inputs without the sink: the time K17's
    # sinks form adds to the kernels it runs on
    k16_ms = [time_ms(fn, runs=10, flush=flush) for fn in (
        lambda: tfa.flash_attention_fwd(q, k, v, seg, lo, hi, scale=scale),
        lambda: tfa.flash_attention_dq(q, k, v, seg, lo, hi, out, lse, dout,
                                       scale=scale),
        lambda: tfa.flash_attention_dkv(q, k, v, seg, lo, hi, lse, di, dout,
                                        scale=scale))]
    flex_fwd = flex_bwd = flex_err = None
    if lib:
        flex_fwd, flex_bwd, flex_err = _flex_sinks_ms(q, k, v, seg, sinks,
                                                      dout, flush, rout,
                                                      scale)
    path_launches = None
    if form is not None:
        path_launches = _sinks_through_attention(q, k, v, seg, sinks, dout,
                                                 scale, label)
    pairs = int(tfa._mask(seg, b, t, dev).sum())
    fb = bound(4 * d * hq * pairs, nbytes(q, k, v, seg, out, lse, sinks))
    qb = bound(6 * d * hq * pairs, nbytes(q, k, v, seg, out, dout, lse, q,
                                          di))
    kb = bound(8 * d * hq * pairs, nbytes(q, k, v, seg, dout, lse, di, k, v))
    n_seg = len(torch.unique(seg[seg != 0]))
    shape = (f"{label}: B={b} T={t} Hq={hq} Hkv={hkv} D={d} bf16, {n_seg} "
             f"segment(s), {int((seg == 0).sum())} pad")
    common = dict(shape=shape, library="compiled flex_attention(return_lse)"
                  " + sigmoid(lse - sink) rescale" if lib else None,
                  **({} if form is None else {
                      "form": form, "path_launches": path_launches}))
    res = {
        "flash_sinks_fwd": dict(common, err=max(errs["out"][0], lse_err),
                                ms=fwd_ms, plain_ms=fwd_plain,
                                k16_ms=k16_ms[0],
                                bound_ms=fb[0], bound_by=fb[1],
                                library_ms=flex_fwd),
        "flash_sinks_dq": dict(common, err=max(errs["dq"][0], dsk_err),
                               ms=dq_ms, plain_ms=bwd_plain,
                               k16_ms=k16_ms[1], bound_ms=qb[0],
                               bound_by=qb[1], library_ms=flex_bwd),
        "flash_sinks_dkv": dict(common, err=max(errs["dk"][0],
                                                errs["dv"][0]),
                                ms=dkv_ms, plain_ms=bwd_plain,
                                k16_ms=k16_ms[2], bound_ms=kb[0],
                                bound_by=kb[1], library_ms=flex_bwd)}
    log(f"[kernels] flash sinks (K17) {shape}, every position: " +
        ", ".join(f"{n_} max|d|={e_:.3e} row-wise {r:.3e}"
                  for n_, (e_, r) in errs.items())
        + f" (row-wise tol {ATTN_ROW_TOL:.3e}); lse' max|d|={lse_err:.3e} "
        f"(tol 1e-3); dsinks max|d|={dsk_err:.3e} (tol {dsk_tol:.3e})")
    log(f"[kernels] flash sinks check against faults: sink ignored " +
        ", ".join(f"{n_} row-wise {r:.3e}" for n_, r in faults.items())
        + f"; dsinks dropped max|d|={dsk_dropped:.3e}")
    log(f"[kernels] flash sinks {label} fwd kernel {fwd_ms:.4f} ms plain "
        f"{fwd_plain:.4f} ms bound {fb[0]:.4f} ms ({fb[1]}); dq kernel "
        f"{dq_ms:.4f} ms bound {qb[0]:.4f} ms; dk/dv kernel {dkv_ms:.4f} ms "
        f"bound {kb[0]:.4f} ms; plain backward {bwd_plain:.4f} ms; K16 on "
        f"the same inputs without the sink {k16_ms[0]:.4f} / "
        f"{k16_ms[1]:.4f} / {k16_ms[2]:.4f} ms; compiled "
        f"flex_attention(return_lse) + rescale: fwd {flex_fwd} ms, backward "
        f"{flex_bwd} ms, out row-wise {flex_err} from the plain version; "
        f"{pairs} valid pairs per head")
    bad = [n_ for n_, (_, r) in errs.items() if not r <= ATTN_ROW_TOL]
    if bad or not lse_err <= 1e-3 or not dsk_err <= dsk_tol:
        raise RuntimeError(f"flash sinks {label} disagrees in {bad}: {errs}, "
                           f"lse {lse_err}, dsinks {dsk_err}")
    missed = [n_ for n_, r in faults.items() if not r > ATTN_ROW_TOL]
    if missed or not dsk_dropped > dsk_tol:
        raise RuntimeError(f"the flash sinks check lets faults through: "
                           f"sink ignored in {missed}, dsinks dropped "
                           f"{dsk_dropped} vs {dsk_tol}")
    del q, k, v, dout, out, lse, dq, dk, dv, di, rout
    torch.cuda.empty_cache()
    return res


def _sinks_through_attention(q, k, v, seg, sinks, dout, scale, label):
    """{K17 kernel: launches} of one forward and backward of
    ``ops.attention.attention`` with sinks on these inputs, the counters
    set to 0 just before; each must be 1, the gradients finite, and the
    output must match ``attention_ref`` with sinks row by row
    (:func:`attn_row_err`)."""
    import torch

    from unsloth_tpu_torch.ops.attention import attention, attention_ref

    names = ("flash_sinks_fwd", "flash_sinks_dq", "flash_sinks_dkv")
    fns = _kernel_fns()
    for n_ in names:
        fns[n_].launches = 0
    xs = [x.detach().requires_grad_(True) for x in (q, k, v, sinks)]
    got = attention(*xs[:3], segment_ids=seg, scale=scale, sinks=xs[3])
    got.backward(dout)
    torch.cuda.synchronize()
    launches = {n_: fns[n_].launches for n_ in names}
    want = attention_ref(q, k, v, segment_ids=seg, scale=scale, sinks=sinks)
    err = attn_row_err(got.detach(), want)
    finite = all(bool(torch.isfinite(x.grad).all()) for x in xs)
    log(f"[kernels] flash sinks {label} through attention(sinks=...): "
        f"launches {launches}, out row-wise {err:.3e} from attention_ref "
        f"(tol {ATTN_ROW_TOL:.3e}), finite grads {finite}")
    if any(c != 1 for c in launches.values()) or not err <= ATTN_ROW_TOL \
            or not finite:
        raise RuntimeError(f"attention with sinks at {label}: launches "
                           f"{launches}, row-wise {err}, finite grads "
                           f"{finite}")
    return launches


def _flex_sinks_ms(q, k, v, segment_ids, sinks, dout, flush, want, scale):
    """(forward ms, backward ms, row-wise error of its out against
    ``want``) of the library yardstick of K17: ``torch.compile``d
    ``flex_attention`` with ``return_lse`` (block mask of causal and equal
    segment ids, GQA, ``scale``) times sigmoid(lse - sink), in its [B, H, T,
    D] layout; the backward through both. The inputs require a gradient
    throughout, so that one compiled graph serves the forward and the
    backward. A yardstick only, never called by the port; where flex
    refuses (an lse without a gradient), the failure is logged in place of
    the time."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask

    flex_compiled = _compiled_flex()
    b, t = segment_ids.shape
    seg = segment_ids.to(torch.int32)

    def mask_mod(bi, h, qi, ki):
        return (ki <= qi) & (seg[bi, qi] == seg[bi, ki])

    mask = create_block_mask(mask_mod, b, None, t, t, device=q.device)

    def flex(a, b_, c):
        out, lse = flex_compiled(a, b_, c, block_mask=mask, scale=scale,
                         enable_gqa=True, return_lse=True)
        rescale = torch.sigmoid(lse - sinks.float()[None, :, None])
        return (out.float() * rescale[..., None]).to(a.dtype)

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    try:
        err = attn_row_err(flex(qt, kt, vt).detach().transpose(1, 2), want)
        fwd = time_ms(lambda: flex(qt, kt, vt), runs=5, warmup=1,
                      flush=flush)
        bwd = _autograd_ms(flex, (qt, kt, vt), dout.transpose(1, 2), flush,
                           runs=5)
    except Exception as exc:  # the yardstick only; logged
        log(f"[kernels] flex_attention with return_lse failed: {exc!r}"[:300])
        return None, None, None
    del mask
    torch.cuda.empty_cache()
    return fwd, bwd, err


def phase_ce_routes():
    """The two CE routes of the training loss at the training shapes:
    full logits (a cuBLAS product into bf16 [N, V] logits, then K7/K8) and
    the chunked fused CE (fp32 chunk logits, recomputed in the backward),
    each forward + backward to the hidden states (a frozen lm_head, as
    under LoRA), at N = 4,094 (2 x 2,048) and 8,191 (1 x 8,192) rows.
    Median time of 5 runs and the peak memory above the inputs; the two
    losses agree within 1e-2 relative (the full route rounds the logits to
    bf16). These are the numbers the fused_ce="auto" gate can be re-derived
    from."""
    import torch

    from unsloth_tpu_torch.ops.cross_entropy import fast_cross_entropy_loss
    from unsloth_tpu_torch.ops.fused_ce_linear import fused_ce_loss_mean
    from unsloth_tpu_torch.ops.lora import base_matmul

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    d, v = LLAMA_31_8B_CONFIG["hidden_size"], LLAMA_31_8B_CONFIG["vocab_size"]
    w = (torch.randn((v, d), generator=g, device=dev) * 0.02
         ).to(torch.bfloat16)
    chunk = max(1024, (2 << 30) // (v * 4) // 1024 * 1024)  # decoder's
    out = {}
    for n in CE_ROWS:
        h = torch.randn((n, d), generator=g, device=dev).to(torch.bfloat16)
        h.requires_grad_(True)
        lb = torch.randint(0, v, (n,), generator=g, device=dev)

        def full():
            loss = fast_cross_entropy_loss(base_matmul(h, w), lb)
            return loss, torch.autograd.grad(loss, h)[0]

        def chunked():
            loss = fused_ce_loss_mean(h, w.t(), lb, chunk_size=min(chunk, n),
                                      w_trainable=False)
            return loss, torch.autograd.grad(loss, h)[0]

        res = {}
        for name, fn in (("full", full), ("chunked", chunked)):
            ms = time_ms(fn, runs=5, warmup=1)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss, _ = fn()
            torch.cuda.synchronize()
            res[name] = (ms, (torch.cuda.max_memory_allocated() - base) / 1e9,
                         float(loss.detach()))
            del loss
        rel = abs(res["full"][2] - res["chunked"][2]) / abs(res["chunked"][2])
        log(f"[ce routes] N={n} V={v}: full (cuBLAS + K7/K8) "
            f"{res['full'][0]:.2f} ms, peak +{res['full'][1]:.2f} GB; chunked "
            f"({chunk}-row chunks) {res['chunked'][0]:.2f} ms, peak "
            f"+{res['chunked'][1]:.2f} GB; losses {res['full'][2]:.6f} / "
            f"{res['chunked'][2]:.6f} (rel {rel:.2e}, tol 1e-2)")
        if not rel <= 1e-2:
            raise RuntimeError(f"CE routes disagree at N={n}: {res}")
        out[n] = res
        del h
    del w
    torch.cuda.empty_cache()
    return out


def _prefill_decode_logits(params, cfg, ids, mask, steps, feed=None):
    """Logits [steps + 1, B, V] (fp32, on the CPU) of a prefill of ``ids``
    [B, T] (left-padded, ``mask`` marks real tokens) and ``steps`` decode
    steps. Step s feeds ``feed[s]`` when given (teacher forcing, so that
    two devices see the same tokens), else the greedy token. Returns the
    logits and the fed tokens."""
    import torch

    from unsloth_tpu_torch.inference.decode import (forward_with_cache,
                                                    init_cache,
                                                    logits_from_hidden)

    dev = ids.device
    b, t = ids.shape
    cache = init_cache(cfg, b, t + steps, dtype=params["embed"].dtype,
                       device=dev)
    first = torch.argmax(mask.to(torch.int32), dim=1)
    positions = (torch.arange(t, device=dev)[None] - first[:, None]).clamp(min=0)
    valid = torch.ones((b, t + steps), dtype=torch.bool, device=dev)
    valid[:, :t] = mask.to(torch.bool)
    h, cache = forward_with_cache(params, None, ids, cfg, cache,
                                  positions=positions, kv_valid_extra=valid)
    logits = [logits_from_hidden(params, h[:, -1], cfg).float().cpu()]
    pos = positions[:, -1] + 1
    fed = []
    for s in range(steps):
        tok = (feed[s] if feed is not None else logits[-1].argmax(-1)).to(dev)
        fed.append(tok.cpu())
        h, cache = forward_with_cache(params, None, tok[:, None], cfg, cache,
                                      positions=pos[:, None],
                                      kv_valid_extra=valid)
        logits.append(logits_from_hidden(params, h, cfg)[:, 0].float().cpu())
        pos = pos + 1
    return torch.stack(logits), fed


def phase_slice_parity():
    """Llama-3.1-8B at full width cut to 2 layers, random NF4 weights from
    the seed: prefill 64 tokens (two rows, one left-padded to 64 from 50)
    plus PARITY_DECODE_STEPS decode steps on the card (kernels) and on the
    CPU (plain versions), same weights, same fed tokens.

    Tolerance: ||d||_2 <= 2e-2 ||ref||_2 and max|d| <= 0.1 max|ref| over
    all the steps' logits. Both run bf16 activations and round them at every
    op, but in other places (fp32 sums in other orders, the card's kernels
    against the CPU's matmuls) through 2 layers; a wrong kernel gives an
    error of the order of the logits themselves."""
    import numpy as np
    import torch

    from unsloth_tpu_torch.models.config import ModelConfig
    from unsloth_tpu_torch.models.params import (init_params, quantize_params,
                                                 tree_to)

    hf = dict(LLAMA_31_8B_CONFIG, num_hidden_layers=2)
    cfg = ModelConfig.from_hf_config(hf)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = quantize_params(init_params(cfg, gen, dtype=torch.bfloat16),
                             cfg, dtype=torch.bfloat16)
    cpu_params = tree_to(params, "cpu")
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
    mask = torch.ones((2, 64), dtype=torch.int32)
    ids[1, :14] = 0
    mask[1, :14] = 0
    t0 = time.perf_counter()
    card, fed = _prefill_decode_logits(params, cfg, ids.to(DEVICE),
                                       mask.to(DEVICE), PARITY_DECODE_STEPS)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref, _ = _prefill_decode_logits(cpu_params, cfg, ids, mask,
                                    PARITY_DECODE_STEPS, feed=fed)
    t_cpu = time.perf_counter() - t0
    d = card - ref
    rel = (d.norm() / ref.norm()).item()
    mx = d.abs().max().item()
    scale = ref.abs().max().item()
    agree = (card.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"[parity] 2-layer Llama-3.1-8B NF4, prefill 64 + "
        f"{PARITY_DECODE_STEPS} steps, B=2: "
        f"||d||/||ref|| = {rel:.3e} (tol 2e-2), max|d| = {mx:.3e} "
        f"(tol {0.1 * scale:.3e}), argmax agreement {agree:.3f}; "
        f"card {t_card:.1f} s, cpu {t_cpu:.1f} s")
    if not (torch.isfinite(card).all() and rel <= 2e-2 and mx <= 0.1 * scale):
        raise RuntimeError("card and CPU logits disagree beyond tolerance")
    del params, cpu_params
    torch.cuda.empty_cache()


def _synthetic_docs(rng, vocab, n_tokens):
    """Pre-tokenized documents of DOC_LENGTHS tokens, about ``n_tokens`` in
    all, drawn from a SUB_VOCAB-id sub-vocabulary (so the loss has
    something to learn)."""
    sub = rng.choice(vocab, SUB_VOCAB, replace=False)
    docs, total = [], 0
    while True:
        n = int(rng.integers(DOC_LENGTHS[0], DOC_LENGTHS[1] + 1))
        if total + n > n_tokens:
            return docs
        docs.append({"input_ids": sub[rng.integers(0, SUB_VOCAB, n)].tolist()})
        total += n


def _lora_leaves(lora):
    return [(f"layer{i}.{name}.{part}", getattr(lw, part))
            for i, layer in enumerate(lora["layers"])
            for name, lw in sorted(layer.items()) for part in ("a", "b")]


def phase_train_parity():
    """Llama-3.1-8B at full width cut to 2 layers, random NF4 weights and
    LoRA (r=16, all seven projections, B nonzero) from the seed: the
    packed-row loss and every LoRA gradient of one PARITY_ROWS-token row,
    on the card (the kernels) and on the CPU (the plain versions), from the
    same weights, both in bf16 and both through the chunked fused CE (the
    route the card takes; the CPU's full-logits CE would round the logits
    to bf16 where the chunked one keeps them in fp32).

    Tolerance: loss within 1e-2 relative and each gradient leaf within
    5e-2 relative L2. Both round bf16 activations at every op, but at
    other places and with fp32 sums in other orders through two layers and
    their backward; a wrong kernel gives errors of the order of the
    gradient itself."""
    import numpy as np
    import torch

    from unsloth_tpu_torch.data.packing import pack_sequences
    from unsloth_tpu_torch.models.config import ModelConfig
    from unsloth_tpu_torch.models.decoder import loss_fn
    from unsloth_tpu_torch.models.params import (init_lora_tree,
                                                 init_params, quantize_params,
                                                 tree_to)
    from unsloth_tpu_torch.ops.attention import packed_segment_bound

    hf = dict(LLAMA_31_8B_CONFIG, num_hidden_layers=2)
    cfg = ModelConfig.from_hf_config(hf)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    params = quantize_params(init_params(cfg, gen, dtype=torch.bfloat16),
                             cfg, dtype=torch.bfloat16)
    lora = init_lora_tree(cfg, gen, r=16, alpha=16.0)
    for layer in lora["layers"]:
        for lw in layer.values():
            lw.b = torch.randn(lw.b.shape, generator=gen, device=DEVICE) * 0.01
    rng = np.random.default_rng(SEED + 1)
    docs = _synthetic_docs(rng, cfg.vocab_size, 2 * PARITY_ROWS)
    row = pack_sequences(docs, PARITY_ROWS)[0].as_dict()
    bound = max(len(d["input_ids"]) for d in docs)
    results = {}
    for dev in (DEVICE, "cpu"):
        p = params if dev == DEVICE else tree_to(params, "cpu")
        lo = lora if dev == DEVICE else tree_to(lora, "cpu")
        leaves = _lora_leaves(lo)
        for _, t in leaves:
            t.requires_grad_(True)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in row.items()}
        t0 = time.perf_counter()
        with packed_segment_bound(bound):
            loss = loss_fn(p, lo, batch, cfg, fused_ce=True, remat=False)
        loss.backward()
        if dev == DEVICE:
            torch.cuda.synchronize()
        results[dev] = (float(loss.detach()), {n: t.grad.float().cpu()
                                              for n, t in leaves},
                        time.perf_counter() - t0)
        for _, t in leaves:
            t.grad = None
            t.requires_grad_(False)
    (l_card, g_card, t_card), (l_cpu, g_cpu, t_cpu) = results[DEVICE], \
        results["cpu"]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    rels = {n: _rel(g_card[n], g_cpu[n]) for n in g_cpu}
    worst = max(rels, key=rels.get)
    n_real = int((row["segment_ids"] != 0).sum())
    log(f"[train parity] 2-layer Llama-3.1-8B NF4 + LoRA r=16, one packed "
        f"row of {PARITY_ROWS} ({n_real} real tokens, bound {bound}): loss "
        f"card "
        f"{l_card:.6f} cpu {l_cpu:.6f} (rel {loss_rel:.2e}, tol 1e-2); "
        f"{len(rels)} LoRA grads, worst rel L2 {rels[worst]:.3e} ({worst}), "
        f"median {statistics.median(rels.values()):.3e} (tol 5e-2); card "
        f"{t_card:.1f} s, cpu {t_cpu:.1f} s")
    finite = np.isfinite(l_card) and all(
        bool(torch.isfinite(g).all()) for g in g_card.values())
    if not (finite and loss_rel <= 1e-2 and rels[worst] <= 5e-2):
        raise RuntimeError("card and CPU training loss/grads disagree")
    del params, lora
    torch.cuda.empty_cache()
    return dict(loss_rel=loss_rel, grad_rel_max=rels[worst])


def _tree_f32(tree):
    """A param tree with every dense float tensor in fp32 and every NF4
    weight dequantizing to fp32 (the same codes and scales)."""
    import dataclasses

    import torch

    from unsloth_tpu_torch.ops.nf4 import NF4Stacked, NF4Tensor

    if isinstance(tree, dict):
        return {k: _tree_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_f32(v) for v in tree]
    if isinstance(tree, (NF4Tensor, NF4Stacked)):
        return dataclasses.replace(tree, dtype=torch.float32)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(torch.float32)
    return tree


def phase_train_parity_padded(hf=LLAMA_31_8B_CONFIG, expect=None,
                              absent=(), label="Llama-3.1-8B", seed=SEED + 3,
                              lengths=(700, PARITY_ROWS), params=None):
    """SFT without packing on the 2-layer cut of ``hf``: the loss and every
    LoRA gradient of one padded batch of two rows of ``lengths`` real
    tokens (a row with a pad tail, a full row; the longer sets T),
    fused_ce="auto", on the card in bf16 (the attention kernels: K16 for
    Llama-3.1-8B, Llama-3.2-1B and Gemma-7B, K18 with the softcap, and the
    window on the sliding layer, for Gemma-2-9B; the full-logits CE
    through K7/K8) and on the CPU through the plain versions in fp32
    (attention_ref, the plain CE), from the same weights and NF4 codes:
    random ones from the seed, quantized, or ``params`` (a 2-layer tree on
    the card, as a loader gave it, or with FP8 projections). Tolerance as in phase 4b: loss within
    1e-2 relative, each gradient leaf within 5e-2 relative L2 (the card
    rounds to bf16 at every op; a wrong kernel gives errors of the order of
    the gradient). Every kernel of ``expect`` (default: the Llama path's)
    must launch, none of ``absent``. Returns the losses' and grads'
    distances and the card's launches."""
    import numpy as np
    import torch

    from unsloth_tpu_torch.data.packing import pad_batch
    from unsloth_tpu_torch.models.config import ModelConfig
    from unsloth_tpu_torch.models.decoder import loss_fn
    from unsloth_tpu_torch.models.params import (init_lora_tree,
                                                 init_params, quantize_params,
                                                 tree_to)
    from unsloth_tpu_torch.ops.fp8 import FP8Tensor

    cfg = ModelConfig.from_hf_config(dict(hf, num_hidden_layers=2))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    if params is None:
        params = quantize_params(init_params(cfg, gen, dtype=torch.bfloat16),
                                 cfg, dtype=torch.bfloat16)
    base = ("FP8" if isinstance(params["layers"][0]["q"], FP8Tensor)
            else "NF4")
    lora = init_lora_tree(cfg, gen, r=16, alpha=16.0)
    for layer in lora["layers"]:
        for lw in layer.values():
            lw.b = torch.randn(lw.b.shape, generator=gen, device=DEVICE) * 0.01
    rng = np.random.default_rng(seed)
    sub = rng.choice(cfg.vocab_size, SUB_VOCAB, replace=False)
    rows = [{"input_ids": sub[rng.integers(0, SUB_VOCAB, n)].tolist()}
            for n in lengths]
    batch_np = pad_batch(rows, max(lengths)).as_dict()
    kernels = _kernel_fns()
    results = {}
    for dev in (DEVICE, "cpu"):
        p = params if dev == DEVICE else _tree_f32(tree_to(params, "cpu"))
        lo = lora if dev == DEVICE else tree_to(lora, "cpu")
        leaves = _lora_leaves(lo)
        for _, t in leaves:
            t.requires_grad_(True)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        before = {n: fn.launches for n, fn in kernels.items()}
        t0 = time.perf_counter()
        loss = loss_fn(p, lo, batch, cfg, remat=False)
        loss.backward()
        if dev == DEVICE:
            torch.cuda.synchronize()
        results[dev] = (float(loss.detach()), {n: t.grad.float().cpu()
                                              for n, t in leaves},
                        time.perf_counter() - t0,
                        {n: fn.launches - before[n]
                         for n, fn in kernels.items()})
        for _, t in leaves:
            t.grad = None
            t.requires_grad_(False)
    (l_card, g_card, t_card, launches), (l_cpu, g_cpu, t_cpu, _) = \
        results[DEVICE], results["cpu"]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    rels = {n: _rel(g_card[n], g_cpu[n]) for n in g_cpu}
    worst = max(rels, key=rels.get)
    log(f"[train parity] 2-layer {label} {base} + LoRA r=16, padded "
        f"[2, {max(lengths)}] ({lengths[0]} and {lengths[1]} real tokens): "
        f"loss "
        f"card {l_card:.6f} cpu (fp32) {l_cpu:.6f} (rel {loss_rel:.2e}, tol "
        f"1e-2); {len(rels)} LoRA grads, worst rel L2 {rels[worst]:.3e} "
        f"({worst}), median {statistics.median(rels.values()):.3e} (tol "
        f"5e-2); card {t_card:.1f} s, cpu {t_cpu:.1f} s; card launches "
        f"{ {n: c for n, c in launches.items() if c} }")
    finite = np.isfinite(l_card) and all(
        bool(torch.isfinite(g).all()) for g in g_card.values())
    if not (finite and loss_rel <= 1e-2 and rels[worst] <= 5e-2):
        raise RuntimeError("card and CPU padded-batch loss/grads disagree")
    for name in expect or UNPACKED_KERNELS:
        if launches[name] <= 0:
            raise RuntimeError(f"{name} did not launch on the padded batch")
    for name in absent:
        if launches[name]:
            raise RuntimeError(f"{name} launched on the padded {label} "
                               "batch")
    del params, lora
    torch.cuda.empty_cache()
    return dict(loss_rel=loss_rel, grad_rel_max=rels[worst],
                launches=launches)


def checkpoint_entries(cfg):
    """(HF tensor name, shape) of every tensor of a checkpoint of ``cfg``: a
    llama-family dense decoder (Llama-3.1-8B, Gemma-2-9B: Gemma-2's
    sandwich norms, no lm_head where the embedding is tied) or gpt-oss
    (biased q/k/v/o, sinks, the router and its bias, and the experts as
    HF's GptOss stores them: gate_up_proj [E, D, 2F] with gate and up
    interleaved on the last dim and its bias [E, 2F], down_proj [E, F, D]
    and its bias [E, D])."""
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    dq, dkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    norms = ["input_layernorm", "post_attention_layernorm"]
    if cfg.use_post_norms:
        norms += ["pre_feedforward_layernorm", "post_feedforward_layernorm"]
    entries = [("model.embed_tokens.weight", (v, d))]
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        entries += [(p + n + ".weight", (d,)) for n in norms]
        entries += [(p + "self_attn.q_proj.weight", (dq, d)),
                    (p + "self_attn.k_proj.weight", (dkv, d)),
                    (p + "self_attn.v_proj.weight", (dkv, d)),
                    (p + "self_attn.o_proj.weight", (d, dq))]
        if cfg.model_type == "gpt_oss":
            e, fe = cfg.num_experts, cfg.moe_intermediate_size
            entries += [(p + "self_attn.q_proj.bias", (dq,)),
                        (p + "self_attn.k_proj.bias", (dkv,)),
                        (p + "self_attn.v_proj.bias", (dkv,)),
                        (p + "self_attn.o_proj.bias", (d,)),
                        (p + "self_attn.sinks", (cfg.num_heads,)),
                        (p + "mlp.router.weight", (e, d)),
                        (p + "mlp.router.bias", (e,)),
                        (p + "mlp.experts.gate_up_proj", (e, d, 2 * fe)),
                        (p + "mlp.experts.gate_up_proj_bias", (e, 2 * fe)),
                        (p + "mlp.experts.down_proj", (e, fe, d)),
                        (p + "mlp.experts.down_proj_bias", (e, d))]
        else:
            entries += [(p + "mlp.gate_proj.weight", (f, d)),
                        (p + "mlp.up_proj.weight", (f, d)),
                        (p + "mlp.down_proj.weight", (d, f))]
            if cfg.model_type == "qwen2":   # HF Qwen2Attention: q/k/v bias
                entries += [(p + "self_attn.q_proj.bias", (dq,)),
                            (p + "self_attn.k_proj.bias", (dkv,)),
                            (p + "self_attn.v_proj.bias", (dkv,))]
    entries += [("model.norm.weight", (d,))]
    if not cfg.tie_word_embeddings:
        entries += [("lm_head.weight", (v, d))]
    return entries


def checkpoint_tensor(config, name, device="cpu"):
    """Tensor ``name`` of :func:`write_checkpoint`'s checkpoint of
    ``config``, bf16 on ``device``, as written before any bnb-4bit
    quantization: N(0, 0.02) from a generator on DEVICE seeded by the seed
    and the tensor's index, norm weights ones (zeros for Gemma's
    (1 + w))."""
    import torch

    from unsloth_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig.from_hf_config(config)
    entries = checkpoint_entries(cfg)
    shape = dict(entries)[name]
    if name.endswith("norm.weight"):
        fill = torch.zeros if cfg.gemma_norm else torch.ones
        return fill(shape, dtype=torch.bfloat16, device=device)
    index = [n for n, _ in entries].index(name)
    g = torch.Generator(device=DEVICE).manual_seed(SEED * 1000 + index)
    w = torch.randn(shape, generator=g, device=DEVICE) * 0.02
    return w.to(torch.bfloat16).to(device)


#: bnb's 8-bit code table of the double-quantized absmax stands in as a
#: strictly increasing 256-entry table (tests/test_bnb_interop.py's): a
#: loader must decode with whatever table the checkpoint stores
BNB_NESTED_MAP = [math.tanh(-3.0 + 6.0 * i / 255) for i in range(256)]
BNB_BLOCK, BNB_NESTED_BLOCK = 64, 256
#: the companions bnb's Linear4bit stores beside each 4-bit weight
BNB_SUFFIXES = (".absmax", ".quant_map", ".nested_absmax",
                ".nested_quant_map", ".quant_state.bitsandbytes__nf4")


def _bnb_state_json(shape, offset):
    """bnb's quant_state JSON, the offset written in a fixed width so that
    the blob's length is known before the data."""
    return json.dumps({
        "quant_type": "nf4", "blocksize": BNB_BLOCK, "dtype": "bfloat16",
        "shape": list(shape), "nested_blocksize": BNB_NESTED_BLOCK,
        "nested_offset": "OFFSET", "nested_dtype": "float32",
    }).replace('"OFFSET"', f"{offset:.8e}")


def _bnb_entries(name, shape):
    """(name, dtype, shape) of the bnb-4bit tensor set of a weight."""
    import torch

    n_blocks = math.prod(shape) // BNB_BLOCK
    n_groups = -(-n_blocks // BNB_NESTED_BLOCK)
    return [(name, torch.uint8, (math.prod(shape) // 2, 1)),
            (name + ".absmax", torch.uint8, (n_blocks,)),
            (name + ".quant_map", torch.float32, (16,)),
            (name + ".nested_absmax", torch.float32, (n_groups,)),
            (name + ".nested_quant_map", torch.float32, (256,)),
            (name + ".quant_state.bitsandbytes__nf4", torch.uint8,
             (len(_bnb_state_json(shape, 1.0)),))]


def bnb4_tensors(w):
    """A bf16 weight [out, in] as bnb's Linear4bit stores it (``quant_state
    .as_dict(packed=True)``), made on w's device and returned on the host:
    NF4 codes of 64-element blocks (the port's quantize_nf4 without double
    quantization, its split-half bytes re-laid as bnb's interleaved
    nibbles: element 2j in the high nibble of byte j), and the fp32 block
    absmax double-quantized: the mean subtracted, groups of 256 scaled by
    their largest magnitude, each value the nearest entry of the 256-entry
    code table."""
    import torch

    from unsloth_tpu_torch.ops.nf4 import NF4_CODE, quantize_nf4

    out_f, in_f = w.shape
    q = quantize_nf4(w, block_size=BNB_BLOCK, double_quant=False)
    idx = torch.cat([q.packed >> 4, q.packed & 0xF], dim=1).reshape(-1, 2)
    weight = ((idx[:, 0] << 4) | idx[:, 1]).to(torch.uint8)[:, None]
    absmax = q.absmax.to(torch.float32)
    offset = absmax.mean()
    n = absmax.numel()
    groups = torch.nn.functional.pad(absmax - offset,
                                     (0, -n % BNB_NESTED_BLOCK))
    groups = groups.reshape(-1, BNB_NESTED_BLOCK)
    scale = groups.abs().amax(1)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    table = torch.tensor(BNB_NESTED_MAP, dtype=torch.float32, device=w.device)
    norm = (groups / scale[:, None]).reshape(-1)[:n]
    hi = torch.bucketize(norm, table).clamp(1, 255)
    nearer_below = (norm - table[hi - 1]).abs() <= (table[hi] - norm).abs()
    codes = torch.where(nearer_below, hi - 1, hi).to(torch.uint8)
    state = _bnb_state_json((out_f, in_f), float(offset))
    return {"": weight.cpu(), ".absmax": codes.cpu(),
            ".quant_map": NF4_CODE.clone(), ".nested_absmax": scale.cpu(),
            ".nested_quant_map": table.cpu(),
            ".quant_state.bitsandbytes__nf4": torch.tensor(
                list(state.encode()), dtype=torch.uint8)}


def write_checkpoint(path, config, bnb4=False):
    """Random-init bf16 checkpoint of the HF ``config`` (Llama-3.1-8B,
    Gemma-2-9B, gpt-oss-20b, Llama-3.2-1B, Qwen2.5-0.5B, Gemma-7B) at its
    published shapes (:func:`checkpoint_entries`, tensors as
    :func:`checkpoint_tensor` makes them): config.json plus index-sharded
    safetensors, one tensor at a time, after a check that the disk holds
    it. Every tensor but the norms is N(0, 0.02) (biases, sinks and router
    included); norm weights are ones, or zeros where the model applies
    them as (1 + w) (Gemma, as HF initializes them). With ``bnb4``, in the
    layout of the pre-quantized unsloth/*-bnb-4bit repos: each projection
    of a dense decoder as bnb's 4-bit tensor set (:func:`bnb4_tensors`),
    the rest bf16, and bnb's quantization_config in config.json."""
    import torch

    from unsloth_tpu_torch.io_safetensors import save_sharded
    from unsloth_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig.from_hf_config(config)
    dense = checkpoint_entries(cfg)
    entries = []
    for name, shape in dense:
        if bnb4 and len(shape) == 2 and name.endswith("_proj.weight"):
            entries += _bnb_entries(name, shape)
        else:
            entries.append((name, torch.bfloat16, shape))
    need = sum(math.prod(s_) * d_.itemsize for _, d_, s_ in entries)
    free = shutil.disk_usage(path if os.path.isdir(path)
                             else os.path.dirname(path) or ".").free
    log(f"[main] {config['model_type']} checkpoint: {need / 1e9:.2f} GB to "
        f"write, {free / 1e9:.2f} GB free on disk")
    if need > free:
        raise RuntimeError(f"the {config['model_type']} checkpoint needs "
                           f"{need / 1e9:.2f} GB; the disk has {free / 1e9:.2f}"
                           " GB free")
    companions = {}

    def produce(name):
        if name in companions:
            return companions.pop(name)
        w = checkpoint_tensor(config, name, DEVICE)
        if name + BNB_SUFFIXES[0] not in entry_names:
            return w.cpu()
        sets = bnb4_tensors(w)
        companions.update({name + s: t for s, t in sets.items() if s})
        return sets[""]

    entry_names = {n for n, _, _ in entries}
    save_sharded(path, entries, produce)
    if bnb4:
        config = dict(config, quantization_config={
            "_load_in_4bit": True, "bnb_4bit_compute_dtype": "bfloat16",
            "bnb_4bit_quant_type": "nf4", "bnb_4bit_use_double_quant": True,
            "load_in_4bit": True, "quant_method": "bitsandbytes"})
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(config, fh, indent=2)


def _write_model(path, config, bnb4=False):
    """:func:`write_checkpoint` into ``path``, logged; returns ``path``."""
    t0 = time.perf_counter()
    write_checkpoint(path, config, bnb4=bnb4)
    size = sum(os.path.getsize(os.path.join(path, n))
               for n in os.listdir(path))
    n_files = sum(n.endswith(".safetensors") for n in os.listdir(path))
    log(f"[main] wrote {config['model_type']} checkpoint: {n_files} "
        f"safetensors files, {size / 1e9:.2f} GB, in "
        f"{time.perf_counter() - t0:.1f} s")
    return path


def _http(method, url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def phase_main_path(tmp):
    """The user's serving path at full width and depth from the checkpoint
    in ``tmp``: load + quantize, serve three greedy requests over HTTP,
    then one batch-4 generate."""
    import numpy as np
    import torch

    from unsloth_tpu_torch import FastLanguageModel, InferenceServer
    from unsloth_tpu_torch.ops.qlora_matmul import (nf4_matmul,
                                                    nf4_matmul_decode)
    from unsloth_tpu_torch.ops.rms_norm import rms_norm

    nf4_matmul.launches = 0
    nf4_matmul_decode.launches = 0
    rms_norm.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, _ = FastLanguageModel.from_pretrained(
        tmp, load_in_4bit=True, dtype=torch.bfloat16, device=DEVICE)
    model = model.for_inference()
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    log(f"[main] from_pretrained(load_in_4bit=True) on {DEVICE}: "
        f"{t_load:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated")

    tok = ByteTokenizer()
    server = InferenceServer(model, tokenizer=tok,
                             model_name="llama-3.1-8b-random-nf4")
    httpd = server.serve("127.0.0.1", 0, background=True)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        for route in ("/health", "/v1/models"):
            status, _ = _http("GET", base + route)
            if status != 200:
                raise RuntimeError(f"GET {route}: HTTP {status}")
        long_msg = ("The quick brown fox jumps over the lazy dog. " * 35)[:1500]
        requests = [
            ("/v1/chat/completions", {"messages": [
                {"role": "user", "content": long_msg}],
                "max_tokens": 32, "temperature": 0.0}),
            ("/v1/chat/completions", {"messages": [
                {"role": "system", "content": "You are terse."},
                {"role": "user", "content": "Name three colours."}],
                "max_tokens": 32, "temperature": 0.0}),
            ("/v1/completions", {"prompt": "Once upon a time",
                                 "max_tokens": 32, "temperature": 0.0}),
        ]
        for route, body in requests:
            t0 = time.perf_counter()
            status, resp = _http("POST", base + route, body)
            dt = time.perf_counter() - t0
            if status != 200:
                raise RuntimeError(f"POST {route}: HTTP {status} {resp}")
            choice = resp["choices"][0]
            if route == "/v1/chat/completions":
                text = choice["message"]["content"]
                n_prompt = resp["usage"]["prompt_tokens"]
                n_out = resp["usage"]["completion_tokens"]
                if resp["object"] != "chat.completion" or \
                        choice["message"]["role"] != "assistant":
                    raise RuntimeError(f"bad chat response {resp}")
            else:
                text = choice["text"]
                n_prompt = len(tok(body["prompt"])["input_ids"])
                n_out = len(tok(text)["input_ids"])
                if resp["object"] != "text_completion":
                    raise RuntimeError(f"bad completion response {resp}")
            if n_out <= 0:
                raise RuntimeError(f"POST {route}: no completion tokens")
            log(f"[main] POST {route}: 200, prompt {n_prompt} tokens, "
                f"completion {n_out} tokens ({len(text)} chars), "
                f"{dt:.2f} s")
    finally:
        httpd.shutdown()
        httpd.server_close()

    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, model.cfg.vocab_size, (4, 1000)).tolist()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.generate(prompts, max_new_tokens=1, temperature=0.0,
                   return_token_ids=True)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.generate(prompts, max_new_tokens=64, temperature=0.0,
                         return_token_ids=True)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = {"nf4_matmul": nf4_matmul.launches,
                "nf4_matmul_decode": nf4_matmul_decode.launches,
                "rms_norm": rms_norm.launches}
    peak = torch.cuda.max_memory_allocated()
    n_new = sum(len(r) for r in out)
    decode_tps = (n_new - len(out)) / max(t_gen - t_prefill, 1e-9)
    log(f"[main] generate B=4, prompt 1000 tokens (bucketed to 1024), 64 "
        f"new: prefill {t_prefill:.3f} s (M = 4096 rows), total "
        f"{t_gen:.3f} s, {n_new} new tokens, decode {decode_tps:.1f} "
        f"tokens/s ({decode_tps / 4:.1f} per row), "
        f"{1e3 * (t_gen - t_prefill) / 63:.1f} ms a decode step")
    log(f"[main] peak memory allocated {peak / 1e9:.2f} GB; launches on "
        f"the main path: {launches}")
    if any(len(r) == 0 or not all(0 <= t < model.cfg.vocab_size for t in r)
           for r in out):
        raise RuntimeError("generate returned empty rows or bad ids")
    _check_launched(launches, SERVING_KERNELS, "serving")

    # the served model's logits are finite and of the expected shape
    ids = torch.tensor(prompts, device=DEVICE)[:, :64]
    logits, _ = _prefill_decode_logits(model.params, model.cfg, ids,
                                       torch.ones_like(ids), 1)
    if logits.shape != (2, 4, model.cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise RuntimeError(f"bad logits {tuple(logits.shape)}")
    return launches, dict(load_s=t_load, prefill_s=t_prefill,
                          decode_tps=decode_tps, peak_bytes=peak)


#: --profile-serve: the batch-4 decode step of phase 5's generate, after
#: its 1,000-token prompts, this many steps warm first and this many timed
SERVE_PROFILE_WARM, SERVE_PROFILE_TIMED = 3, 10


def phase_profile_serve(tmp, profile=True):
    """``--profile-serve``: phase 5's model from the checkpoint in ``tmp``
    (Llama-3.1-8B, load_in_4bit), its batch-4 prompts of 1,000 tokens
    prefilled through the KV cache, then decode steps as ``generate``
    takes them (the 4 new tokens through the cache, the logits, greedy):
    SERVE_PROFILE_WARM warm, SERVE_PROFILE_TIMED timed (ms a step, the
    host's clock around a sync), one under ``torch.profiler``: the device
    time by kernel and by family (K1's share among them), the busy share
    (:func:`_device_report`)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from unsloth_tpu_torch import FastLanguageModel
    from unsloth_tpu_torch.inference.decode import (forward_with_cache,
                                                    init_cache,
                                                    logits_from_hidden)

    model, _ = FastLanguageModel.from_pretrained(
        tmp, load_in_4bit=True, dtype=torch.bfloat16, device=DEVICE)
    model = model.for_inference()
    cfg, params = model.cfg, model.params
    rng = np.random.default_rng(SEED)
    b, t = 4, 1000
    n_steps = SERVE_PROFILE_WARM + SERVE_PROFILE_TIMED + 1
    ids = torch.tensor(rng.integers(0, cfg.vocab_size, (b, t)),
                       device=DEVICE)
    cache = init_cache(cfg, b, t + n_steps, dtype=torch.bfloat16,
                       device=DEVICE)
    valid = torch.ones((b, t + n_steps), dtype=torch.bool, device=DEVICE)
    pos = torch.arange(t, device=DEVICE)[None].expand(b, -1)

    def step(tok, cache, pos):
        h, cache = forward_with_cache(params, None, tok[:, None], cfg, cache,
                                      positions=pos[:, None],
                                      kv_valid_extra=valid)
        return (logits_from_hidden(params, h, cfg, None)[:, 0].argmax(-1),
                cache)

    with torch.no_grad():
        h, cache = forward_with_cache(params, None, ids, cfg, cache,
                                      positions=pos, kv_valid_extra=valid)
        tok = logits_from_hidden(params, h[:, -1, :], cfg, None).argmax(-1)
        pos = torch.full((b,), t, device=DEVICE)
        for _ in range(SERVE_PROFILE_WARM):
            tok, cache = step(tok, cache, pos)
            pos = pos + 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_PROFILE_TIMED):
            tok, cache = step(tok, cache, pos)
            pos = pos + 1
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / SERVE_PROFILE_TIMED
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tok, cache = step(tok, cache, pos)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
    log(f"[profile] serving decode step, batch {b} after {t}-token prompts: "
        f"{ms:.2f} ms a step over {SERVE_PROFILE_TIMED} (no profiler); the "
        f"profiled step {wall_us / 1e3:.2f} ms")
    _device_report(prof, wall_us, 25)


def phase_train_main(tmp, profile=False):
    """The user's training path at full width and depth from the checkpoint
    in ``tmp``: from_pretrained(load_in_4bit=True), get_peft_model(r=16,
    all seven projections, use_gradient_checkpointing="unsloth"), and
    SFTTrainer on synthetic documents packed into 8,192-token rows,
    batch 1, accumulation 2, PACKED_STEPS steps of the same data. Every loss must be
    finite and the last below the first, and every kernel of the path must
    have launched. With ``profile``, one more step runs under the
    profiler (:func:`_profile_train_step`)."""
    import numpy as np
    import torch

    from unsloth_tpu_torch import FastLanguageModel, SFTConfig, SFTTrainer

    kernels = _kernel_fns()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, _ = FastLanguageModel.from_pretrained(
        tmp, max_seq_length=TRAIN_ROWS, load_in_4bit=True,
        dtype=torch.bfloat16, device=DEVICE)
    model = FastLanguageModel.get_peft_model(
        model, r=16, lora_alpha=16,
        target_modules=["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                        "up_proj", "down_proj"],
        use_gradient_checkpointing="unsloth").for_training()
    torch.cuda.synchronize()
    log(f"[train] from_pretrained + get_peft_model(r=16, gc "
        f"{model.gc_mode!r}) in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    rng = np.random.default_rng(SEED + 2)
    docs = _synthetic_docs(rng, model.cfg.vocab_size, 2 * TRAIN_ROWS - 600)
    out_dir = os.path.join(tmp, "sft_out")
    trainer = SFTTrainer(model, train_dataset=docs, args=SFTConfig(
        output_dir=out_dir, max_seq_length=TRAIN_ROWS, packing=True,
        per_device_train_batch_size=1, gradient_accumulation_steps=2,
        max_steps=PACKED_STEPS, learning_rate=1e-3, warmup_steps=0,
        logging_steps=1,
        report_to="none"))
    batches = trainer.prepare_batches()
    real = [int((b.segment_ids != 0).sum()) for b in batches[:2]]
    log(f"[train] {len(docs)} documents of {DOC_LENGTHS[0]}-"
        f"{DOC_LENGTHS[1]} tokens from {SUB_VOCAB} ids packed into "
        f"{len(batches)} rows of {TRAIN_ROWS} (real tokens {real}), "
        f"segment bound {trainer._segment_bound}")
    result = trainer.train()
    peak = torch.cuda.max_memory_allocated()
    losses = [e["loss"] for e in trainer.state_log]
    times = trainer.step_times
    steady = statistics.median(times[1:])
    tokens = sum(real)
    launches = {name: fn.launches for name, fn in kernels.items()}
    log(f"[train] losses {[round(x, 4) for x in losses]}; step times (s) "
        f"{[round(x, 3) for x in times]}")
    log(f"[train] steady step (median of steps 2-{len(times)}) "
        f"{steady:.3f} s for {tokens} real tokens = {tokens / steady:.1f} "
        f"real tokens/s; first step {times[0]:.3f} s; peak memory allocated "
        f"{peak / 1e9:.2f} GB; launches on the training path: {launches}")
    if len(losses) != PACKED_STEPS or not all(np.isfinite(losses)):
        raise RuntimeError(f"training losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"training loss did not fall: {losses}")
    # K10/K11 once a layer for each of a step's two rows
    _check_launched(launches, PACKED_KERNELS, "packed training",
                    {"packed_attn_bwd": 2 * model.cfg.num_layers},
                    PACKED_STEPS)
    _check_absent(launches, PACKED_ABSENT, "packed training")
    for lname, t in _lora_leaves(model.lora):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"trained LoRA {lname} is not finite")
    if profile:
        _profile_train_step(trainer, batches[:2])
    del model, trainer
    torch.cuda.empty_cache()
    return launches, dict(losses=losses, step_s=steady, first_step_s=times[0],
                          real_tokens_per_s=tokens / steady, peak_bytes=peak,
                          runtime_s=result.metrics["train_runtime"])


INSTRUCTION, RESPONSE = "### Instruction:\n", "### Response:\n"


def _alpaca_texts(rng, n):
    """Synthetic Alpaca-format texts: the instruction marker, 32-512
    random printable bytes, a newline, the response marker, 64-1,536
    random printable bytes. With the byte tokenizer they make rows of
    128-2,079 tokens; every eighth text takes both maxima, so its row is
    cut at 2,048."""
    import numpy as np

    def printable(lo, hi, longest):
        size = hi if longest else int(rng.integers(lo, hi + 1))
        return bytes(rng.integers(32, 127, size).astype(np.uint8)).decode()

    return [{"text": INSTRUCTION + printable(32, 512, i % 8 == 0) + "\n"
             + RESPONSE + printable(64, 1536, i % 8 == 0)} for i in range(n)]


def _notebook_recipe(tmp, tag, train, steps, out_name,
                     markers=(INSTRUCTION, RESPONSE), load_in_4bit=True,
                     prepare=None):
    """The notebook recipe's training at full width and depth from the
    checkpoint in ``tmp`` (phases 7, 8, 10 and 11), with every kernel's
    launch count and the peak memory reset first: from_pretrained(
    max_seq_length 2048, ``load_in_4bit``), get_peft_model(r=16, seven
    projections, "unsloth" checkpointing; ``prepare``, where given, is
    called on the loaded model first and the peak memory is reset after
    it), SFTTrainer(packing=False) on the
    texts ``train`` with train_on_responses_only on the (instruction,
    response) ``markers``, batch 2 x accumulation 4, ``steps`` steps (one
    epoch: every step sees other rows), warmup 0. The losses must be
    finite and falling. Returns a dict: the model, trainer, batches, the
    epoch's group order and accumulation, launches, peak memory, losses,
    step times, real / trained / padded tokens/s over the steps after the
    first, and the train result."""
    import numpy as np
    import torch

    from unsloth_tpu_torch import (FastLanguageModel, SFTConfig, SFTTrainer,
                                   train_on_responses_only)

    kernels = _kernel_fns()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, _ = FastLanguageModel.from_pretrained(
        tmp, max_seq_length=UNPACKED_ROWS, load_in_4bit=load_in_4bit,
        dtype=torch.bfloat16, device=DEVICE)
    if prepare is not None:
        prepare(model)
        torch.cuda.synchronize()
        log(f"[{tag}] loaded and prepared in {time.perf_counter() - t0:.1f} "
            f"s, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
            f"resident {torch.cuda.memory_allocated() / 1e9:.2f} GB")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = FastLanguageModel.get_peft_model(
        model, r=16, lora_alpha=16,
        target_modules=["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                        "up_proj", "down_proj"],
        use_gradient_checkpointing="unsloth").for_training()
    torch.cuda.synchronize()
    log(f"[{tag}] from_pretrained(load_in_4bit={load_in_4bit}) + "
        f"get_peft_model(r=16) "
        f"in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    args = SFTConfig(
        output_dir=os.path.join(tmp, out_name),
        max_seq_length=UNPACKED_ROWS, packing=False,
        per_device_train_batch_size=2, gradient_accumulation_steps=4,
        max_steps=steps, learning_rate=1e-3, warmup_steps=0, logging_steps=1,
        report_to="none")
    trainer = SFTTrainer(model, tokenizer=ByteTokenizer(),
                         train_dataset=train, args=args)
    train_on_responses_only(trainer, instruction_part=markers[0],
                            response_part=markers[1])
    batches = trainer.prepare_batches()
    real = [int((b.segment_ids != 0).sum()) for b in batches]
    trained = [int((b.labels[:, 1:] != -100).sum()) for b in batches]
    padded = [int(b.segment_ids.size) for b in batches]
    lengths = [int(n) for b in batches for n in (b.segment_ids != 0).sum(1)]
    log(f"[{tag}] {len(train)} texts -> {len(batches)} padded batches of "
        f"[2, {UNPACKED_ROWS}]: rows of {min(lengths)}-{max(lengths)} tokens "
        f"({sum(n == UNPACKED_ROWS for n in lengths)} cut at "
        f"{UNPACKED_ROWS}); real {sum(real)} of {sum(padded)} row tokens "
        f"({100 * (1 - sum(real) / sum(padded)):.1f}% pad), trained "
        f"(response) tokens {sum(trained)}")
    result = trainer.train()
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [e["loss"] for e in trainer.state_log]
    times = trainer.step_times
    # the trainer's group order for epoch 0 (SFTTrainer.train)
    accum = args.gradient_accumulation_steps
    order = list(range(0, len(batches) - accum + 1, accum))
    np.random.RandomState(args.seed).shuffle(order)
    per_step = [[sum(c[i:i + accum]) for i in order]
                for c in (real, trained, padded)]
    steady_s = sum(times[1:])
    rates = [sum(c[1:]) / steady_s for c in per_step]
    log(f"[{tag}] losses {[round(x, 4) for x in losses]}; step times (s) "
        f"{[round(x, 3) for x in times]}")
    log(f"[{tag}] steady step (median of steps 2-{steps}) "
        f"{statistics.median(times[1:]):.3f} s; over steps 2-{steps}: "
        f"{rates[0]:.1f} real tokens/s, {rates[1]:.1f} trained tokens/s, "
        f"{rates[2]:.1f} padded tokens/s; first step {times[0]:.3f} s; peak "
        f"memory allocated {peak / 1e9:.2f} GB")
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise RuntimeError(f"{tag} training losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{tag} training loss did not fall: {losses}")
    return dict(model=model, trainer=trainer, batches=batches, order=order,
                accum=accum, launches=launches, peak=peak, losses=losses,
                times=times, rates=rates, result=result, tag=tag)


def _matmul_weights(c):
    """(N, lm_head's share): the weights a token passes through in matmuls,
    the projections (an MoE's active experts: top-k of gate/up/down) and
    the lm_head."""
    hd = c.head_dim or c.hidden_size // c.num_heads
    mlp = (c.num_experts_per_tok * 3 * c.hidden_size
           * (c.moe_intermediate_size or c.intermediate_size)
           if c.is_moe else 3 * c.hidden_size * c.intermediate_size)
    per_layer = (2 * c.num_heads * hd * c.hidden_size
                 + 2 * c.num_kv_heads * hd * c.hidden_size + mlp)
    n_head = c.vocab_size * c.hidden_size
    return c.num_layers * per_layer + n_head, n_head


def _recipe_metrics(run):
    """What phases 7, 8, 10 and 11 return of :func:`_notebook_recipe`'s
    run, with MFU: 4N FLOPs per real token (forward and dx through the
    matmul weights, :func:`_matmul_weights`; the base is frozen, so no
    dW) at 989 TFLOP/s, as the profile counts it."""
    n_matmul, _ = _matmul_weights(run["model"].cfg)
    mfu = 4 * n_matmul * run["rates"][0] / PEAK_BF16
    log(f"[{run['tag']}] MFU {100 * mfu:.2f}% (4N per real token, N = "
        f"{n_matmul / 1e9:.3f}e9 matmul weights, 989 TFLOP/s)")
    return dict(losses=run["losses"], step_s=statistics.median(
        run["times"][1:]), real_tokens_per_s=run["rates"][0],
        trained_tokens_per_s=run["rates"][1],
        padded_tokens_per_s=run["rates"][2], peak_bytes=run["peak"],
        mfu=mfu, runtime_s=run["result"].metrics["train_runtime"])


def phase_unpacked_sft(tmp, profile=False):
    """The notebook recipe at full width and depth from the checkpoint in
    ``tmp``: from_pretrained(max_seq_length=2048, load_in_4bit=True),
    get_peft_model(r=16, seven projections, "unsloth" checkpointing),
    SFTTrainer(packing=False) on 8 * UNPACKED_STEPS synthetic Alpaca texts
    with train_on_responses_only, batch 2 x accumulation 4, UNPACKED_STEPS
    steps (one epoch: every step sees other rows), warmup 0. Losses finite and falling; every
    kernel of the path launched. Then evaluate on 8 held-out texts,
    save_lora, a fresh adapter of another rank and scale in the trained
    one's place (its loss must differ), load_lora -> evaluate again (the
    two losses equal), and save_pretrained_merged (its peak device memory
    above the resident model at most 2 GB: it merges one projection at a
    time, where the whole merged tree is 16 GB) reloaded with
    load_in_4bit=False: its logits on a held-out row against the LoRA
    model's, within 5e-2 relative L2 (the merged weights are rounded to
    bf16 once, where the LoRA model adds the adapter in its own bf16
    products). With ``profile``, one more step
    runs under the profiler (:func:`_profile_train_step`) in place of
    evaluate and the saves."""
    import numpy as np
    import torch

    n_train = 8 * UNPACKED_STEPS
    texts = _alpaca_texts(np.random.default_rng(SEED + 4), n_train + 8)
    held_out = texts[n_train:]
    run = _notebook_recipe(tmp, "unpacked", texts[:n_train], UNPACKED_STEPS,
                           "sft_unpacked")
    model, trainer, launches = run["model"], run["trainer"], run["launches"]
    metrics = _recipe_metrics(run)
    _recipe_launches(run, "unpacked", UNPACKED_KERNELS,
                     ("packed_attn_fwd", "packed_attn_bwd", "splash_attn_fwd",
                      "splash_attn_dq", "splash_attn_dkv"))
    if profile:
        i = run["order"][0]
        _profile_train_step(trainer, run["batches"][i:i + run["accum"]])
        return launches, None

    ev = _adapter_round_trip(model, trainer, held_out, tmp, "unpacked")
    ids = torch.tensor([list(held_out[0]["text"].encode())[:256]],
                       device=DEVICE)
    del trainer, run
    rel = _merged_reload(model, ids, tmp, "unpacked")
    del model
    torch.cuda.empty_cache()
    return launches, dict(metrics, eval=ev, merged_rel=rel)


def _adapter_round_trip(model, trainer, held_out, tmp, tag):
    """evaluate on ``held_out``, save_lora, a fresh adapter of another
    rank, scale and seed (B = 0) in the trained one's place (its loss must
    differ: equal losses after load_lora can then only come from the
    files), load_lora -> evaluate again: the two losses equal. Returns the
    first evaluate's metrics."""
    import numpy as np

    from unsloth_tpu_torch import FastLanguageModel

    t0 = time.perf_counter()
    ev = trainer.evaluate(held_out)
    t_eval = time.perf_counter() - t0
    lora_dir = os.path.join(tmp, f"lora_{tag}")
    model.save_lora(lora_dir)
    FastLanguageModel.get_peft_model(
        model, r=8, lora_alpha=64, random_state=SEED + 6,
        use_gradient_checkpointing="unsloth")
    ev_fresh = trainer.evaluate(held_out)
    model.load_lora(lora_dir)
    ev2 = trainer.evaluate(held_out)
    log(f"[{tag}] evaluate on {len(held_out)} texts: {ev} in {t_eval:.1f} "
        f"s; with a fresh adapter: {ev_fresh}; after save_lora -> fresh "
        f"adapter -> load_lora: {ev2} ({sorted(os.listdir(lora_dir))})")
    if not (np.isfinite(ev["eval_loss"]) and ev["eval_tokens"] > 0):
        raise RuntimeError(f"bad eval metrics {ev}")
    if ev_fresh["eval_loss"] == ev["eval_loss"]:
        raise RuntimeError("the fresh adapter evaluates as the trained one")
    if ev2["eval_loss"] != ev["eval_loss"]:
        raise RuntimeError(f"eval loss changed across the adapter round "
                           f"trip: {ev['eval_loss']} -> {ev2['eval_loss']}")
    return ev


def _merged_reload(model, ids, tmp, tag):
    """save_pretrained_merged (its peak device memory above the resident
    model at most 2 GB: it merges one projection at a time) reloaded with
    load_in_4bit=False: its logits on ``ids`` against the LoRA model's,
    within 5e-2 relative L2 (the merged weights are rounded to bf16 once,
    where the LoRA model adds the adapter in its own bf16 products).
    Returns that distance."""
    import torch

    from unsloth_tpu_torch import FastLanguageModel
    from unsloth_tpu_torch.models.decoder import logits_fn

    with torch.no_grad():
        want = logits_fn(model.params, model.lora, ids, model.cfg,
                         remat=False).float()
    merged_dir = os.path.join(tmp, f"merged_16bit_{tag}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model.save_pretrained_merged(merged_dir)
    t_save = time.perf_counter() - t0
    save_peak = torch.cuda.max_memory_allocated() - resident
    size = sum(os.path.getsize(os.path.join(merged_dir, n))
               for n in os.listdir(merged_dir))
    t0 = time.perf_counter()
    merged, _ = FastLanguageModel.from_pretrained(
        merged_dir, load_in_4bit=False, dtype=torch.bfloat16, device=DEVICE)
    t_load = time.perf_counter() - t0
    with torch.no_grad():
        got = logits_fn(merged.params, None, ids, merged.cfg,
                        remat=False).float()
    rel = ((got - want).norm() / want.norm()).item()
    log(f"[{tag}] save_pretrained_merged: {size / 1e9:.2f} GB in "
        f"{t_save:.1f} s, peak device memory {save_peak / 1e9:.3f} GB above "
        f"the resident {resident / 1e9:.2f} GB (limit 2 GB: one dense "
        f"projection at a time); reloaded (load_in_4bit=False) in "
        f"{t_load:.1f} s; logits on a {ids.shape[1]}-token row against the "
        f"LoRA model's: rel L2 {rel:.3e} (tol 5e-2)")
    if not (bool(torch.isfinite(got).all()) and rel <= 5e-2):
        raise RuntimeError(f"merged model's logits disagree: rel {rel}")
    if save_peak > 2e9:
        raise RuntimeError(f"the merged save held {save_peak / 1e9:.2f} GB "
                           "more than the model at once")
    del merged
    shutil.rmtree(merged_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return rel


def _greedy_generate(model, prompts, n_new, tag):
    """A greedy generate of ``n_new`` tokens for ``prompts``: each row has
    1 to ``n_new`` ids (it may stop at the model's eos), all within the
    vocabulary."""
    import torch

    model.for_inference()
    t0 = time.perf_counter()
    model.generate(prompts, max_new_tokens=1, temperature=0.0,
                   return_token_ids=True)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.generate(prompts, max_new_tokens=n_new, temperature=0.0,
                         return_token_ids=True)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    steps = max(len(r) for r in out) - 1
    log(f"[{tag}] generate {len(prompts)} prompts of "
        f"{[len(p_) for p_ in prompts]} tokens, {n_new} new: "
        f"{[len(r) for r in out]} tokens in {t_gen:.2f} s (a prefill alone "
        f"{t_prefill:.3f} s; "
        f"{1e3 * (t_gen - t_prefill) / max(steps, 1):.1f} ms a decode step "
        f"over {steps})")
    if len(out) != len(prompts) or any(
            not 0 < len(r) <= n_new
            or not all(0 <= t_ < model.cfg.vocab_size for t_ in r)
            for r in out):
        raise RuntimeError(f"generate returned empty rows or bad ids: {out}")
    return t_gen


def phase_gemma2_sft(tmp, profile=False):
    """Gemma-2 QLoRA SFT, the notebook recipe, at full width and depth from
    the Gemma-2-9B checkpoint in ``tmp``: from_pretrained(max_seq_length
    2048, load_in_4bit=True), get_peft_model(r=16, seven projections,
    "unsloth" checkpointing), SFTTrainer(packing=False) on synthetic
    Alpaca texts with train_on_responses_only, batch 2 x accumulation 4,
    GEMMA2_STEPS steps (one epoch). Every layer's attention runs K18 (the
    softcap of 50 on all, the window of 4,096 on the sliding ones), the
    loss K7/K8 with the final softcap of 30 over 256,000 logits. Losses
    finite and falling; every kernel of the path launched, and none of the
    attention kernels without a softcap (K9-K11, K16). Then evaluate on 8
    held-out texts and a greedy generate of 16 new tokens for 2 prompts
    (the decode attention is plain PyTorch, as in the JAX package). With
    ``profile``, one more step runs under the profiler
    (:func:`_profile_train_step`) in place of evaluate and generate."""
    import numpy as np
    import torch

    texts = _alpaca_texts(np.random.default_rng(SEED + 7),
                          GEMMA2_STEPS * 8 + 8)
    held_out = texts[-8:]
    run = _notebook_recipe(tmp, "gemma2", texts[:-8], GEMMA2_STEPS,
                           "sft_gemma2")
    model, trainer, launches = run["model"], run["trainer"], run["launches"]
    metrics = _recipe_metrics(run)
    n_layers, accum, steps = (model.cfg.num_layers, run["accum"],
                              len(run["times"]))
    expect = {"splash_attn_fwd": 2 * n_layers * accum,   # forward + remat
              "splash_attn_dq": n_layers * accum,
              "splash_attn_dkv": n_layers * accum,
              "cross_entropy_fwd": accum, "cross_entropy_bwd": accum}
    log(f"[gemma2] launches on the path: {launches}; per step "
        f"{ {n: launches[n] / steps for n in expect} } (expected {expect})")
    _check_launched(launches, GEMMA2_KERNELS, "Gemma-2 training", expect,
                    steps)
    stray = {n: launches[n] for n in ("packed_attn_fwd", "packed_attn_bwd",
                                      "flash_attn_fwd", "flash_attn_dq",
                                      "flash_attn_dkv") if launches[n]}
    if stray:
        raise RuntimeError(f"kernels without a softcap ran on the Gemma-2 "
                           f"path: {stray}")
    if profile:
        i = run["order"][0]
        _profile_train_step(trainer, run["batches"][i:i + accum])
        return launches, None

    t0 = time.perf_counter()
    ev = trainer.evaluate(held_out)
    t_eval = time.perf_counter() - t0
    prompts = [list(text["text"].encode())[:64] for text in held_out[:2]]
    log(f"[gemma2] evaluate on {len(held_out)} texts: {ev} in {t_eval:.1f} s")
    if not (np.isfinite(ev["eval_loss"]) and ev["eval_tokens"] > 0):
        raise RuntimeError(f"bad eval metrics {ev}")
    _greedy_generate(model, prompts, 16, "gemma2")
    del trainer, model, run
    torch.cuda.empty_cache()
    return launches, dict(metrics, eval=ev)


#: the llama-3.1 chat format's turn headers (Llama 3.2 uses it), the
#: instruction and response markers of the conversational notebook's
#: train_on_responses_only
LLAMA31_USER = "<|start_header_id|>user<|end_header_id|>\n\n"
LLAMA31_ASSISTANT = "<|start_header_id|>assistant<|end_header_id|>\n\n"


def _chat_texts(rng, n):
    """Synthetic conversations rendered as strings in the llama-3.1 chat
    format (what the notebook's get_chat_template("llama-3.1") makes of a
    ShareGPT conversation): the begin-of-text and system header, then 1-3
    user/assistant turns of 16-400 and 32-700 random printable bytes, each
    turn closed by <|eot_id|>. With the byte tokenizer they make rows of
    about 200-3,400 tokens; every eighth text takes three turns at the
    maxima, so its row is cut at 2,048."""
    import numpy as np

    def printable(lo, hi, longest):
        size = hi if longest else int(rng.integers(lo, hi + 1))
        return bytes(rng.integers(32, 127, size).astype(np.uint8)).decode()

    texts = []
    for i in range(n):
        longest = i % 8 == 0
        text = ("<|begin_of_text|><|start_header_id|>system<|end_header_id|>"
                "\n\nCutting Knowledge Date: December 2023\nToday Date: 26 "
                "July 2024\n\n<|eot_id|>")
        for _ in range(3 if longest else int(rng.integers(1, 4))):
            text += (LLAMA31_USER + printable(16, 400, longest) + "<|eot_id|>"
                     + LLAMA31_ASSISTANT + printable(32, 700, longest)
                     + "<|eot_id|>")
        texts.append({"text": text})
    return texts


def _recipe_launches(run, tag, names, absent):
    """The exact launches a step of the recipe ``run`` needs of the
    unpacked attention kernels (K16: forward twice a layer and
    micro-batch, the offloaded remat running it again, dq and dk/dv once)
    and the full-logits CE (K7/K8 once a micro-batch); every kernel of
    ``names`` launched, none of ``absent``."""
    n_layers, accum = run["model"].cfg.num_layers, run["accum"]
    steps, launches = len(run["times"]), run["launches"]
    expect = {"flash_attn_fwd": 2 * n_layers * accum,
              "flash_attn_dq": n_layers * accum,
              "flash_attn_dkv": n_layers * accum,
              "cross_entropy_fwd": accum, "cross_entropy_bwd": accum}
    log(f"[{tag}] launches on the path: "
        f"{ {n: c for n, c in launches.items() if c} }; per step "
        f"{ {n: launches[n] / steps for n in expect} } (expected {expect})")
    _check_launched(launches, names, f"{tag} training", expect, steps)
    stray = {n: launches[n] for n in absent if launches[n]}
    if stray:
        raise RuntimeError(f"kernels off the {tag} path ran: {stray}")


def phase_llama32_sft(tmp, profile=False):
    """The Llama 3.2 (1B) conversational notebook's recipe at full width
    and depth from the bnb-4bit checkpoint in ``tmp``
    (:func:`write_checkpoint` with bnb4): from_pretrained(max_seq_length
    2048, load_in_4bit=True), whose projections must arrive as NF4 with
    bnb's decoded fp32 absmax and without a call of quantize_nf4,
    get_peft_model(r=16, seven projections, "unsloth"),
    SFTTrainer(packing=False) on synthetic conversations in the llama-3.1
    chat format with train_on_responses_only on its user/assistant
    headers, batch 2 x accumulation 4, LLAMA32_STEPS steps: losses finite
    and falling, launches per step exactly K16 forward 2 x 16 x 4, dq and
    dk/dv 16 x 4, K7/K8 4 each, K9-K11 and K18 none. Then evaluate, the
    adapter round trip, a greedy generate of 16 tokens for 2 prompts and
    the merged save reloaded. With ``profile``, one more step runs under
    the profiler (:func:`_profile_train_step`) in place of those."""
    import numpy as np
    import torch

    from unsloth_tpu_torch.models import hf_loader
    from unsloth_tpu_torch.ops.nf4 import NF4Tensor

    texts = _chat_texts(np.random.default_rng(SEED + 17),
                        8 * LLAMA32_STEPS + 8)
    held_out = texts[-8:]
    quantize, quantized = hf_loader.quantize_nf4, []

    def counted(*a, **kw):
        quantized.append(a[0].shape)
        return quantize(*a, **kw)

    hf_loader.quantize_nf4 = counted
    try:
        run = _notebook_recipe(tmp, "llama32", texts[:-8], LLAMA32_STEPS,
                               "sft_llama32",
                               markers=(LLAMA31_USER, LLAMA31_ASSISTANT))
    finally:
        hf_loader.quantize_nf4 = quantize
    model, trainer = run["model"], run["trainer"]
    layer = model.params["layers"][0]
    kinds = {n: (type(w).__name__, getattr(w, "absmax_scale", 0) is None)
             for n, w in layer.items()}
    log(f"[llama32] loaded from the bnb-4bit checkpoint: quantize_nf4 calls "
        f"{len(quantized)}; layer 0 {kinds}")
    if quantized or not all(isinstance(layer[n], NF4Tensor)
                            and layer[n].absmax_scale is None
                            for n in ("q", "k", "v", "o", "gate", "up",
                                      "down")):
        raise RuntimeError("the bnb-4bit projections were not loaded as they "
                           f"are stored: {len(quantized)} quantize_nf4 calls, "
                           f"{kinds}")
    metrics = _recipe_metrics(run)
    _recipe_launches(run, "llama32", UNPACKED_KERNELS,
                     ("packed_attn_fwd", "packed_attn_bwd", "splash_attn_fwd",
                      "splash_attn_dq", "splash_attn_dkv"))
    if profile:
        i = run["order"][0]
        _profile_train_step(trainer, run["batches"][i:i + run["accum"]])
        return run["launches"], None
    ev = _adapter_round_trip(model, trainer, held_out, tmp, "llama32")
    prompts = [list(t_["text"].encode())[:64] for t_ in held_out[:2]]
    t_gen = _greedy_generate(model, prompts, 16, "llama32")
    ids = torch.tensor([list(held_out[0]["text"].encode())[:256]],
                       device=DEVICE)
    launches = run["launches"]
    del trainer, run
    rel = _merged_reload(model, ids, tmp, "llama32")
    del model
    torch.cuda.empty_cache()
    return launches, dict(metrics, eval=ev, generate_s=t_gen, merged_rel=rel)


def phase_qwen25_sft(tmp, profile=False):
    """Qwen2.5-0.5B LoRA SFT (BASELINE.md's first benchmark config, "LoRA
    SFT on Alpaca") at full width and depth from the bf16 checkpoint in
    ``tmp``: from_pretrained(max_seq_length 2048, load_in_4bit=False),
    get_peft_model(r=16, seven projections, "unsloth"),
    SFTTrainer(packing=False) on synthetic Alpaca texts with
    train_on_responses_only, batch 2 x accumulation 4, QWEN25_STEPS steps:
    losses finite and falling; the bf16 base's products stay torch.matmul,
    as in the JAX package (no K1/K2 launch); K16 at head dim 64 exactly as
    in phase 10 (24 layers). Then evaluate and a greedy generate of 16
    tokens for 2 prompts. With ``profile``, one more step runs under the
    profiler in place of those."""
    import numpy as np

    texts = _alpaca_texts(np.random.default_rng(SEED + 18),
                          8 * QWEN25_STEPS + 8)
    held_out = texts[-8:]
    run = _notebook_recipe(tmp, "qwen2.5", texts[:-8], QWEN25_STEPS,
                           "sft_qwen25", load_in_4bit=False)
    model, trainer = run["model"], run["trainer"]
    metrics = _recipe_metrics(run)
    names = [n for n in UNPACKED_KERNELS if not n.startswith("nf4")]
    _recipe_launches(run, "qwen2.5", names,
                     ("nf4_matmul", "nf4_matmul_dx", "packed_attn_fwd",
                      "packed_attn_bwd", "splash_attn_fwd", "splash_attn_dq",
                      "splash_attn_dkv"))
    if profile:
        i = run["order"][0]
        _profile_train_step(trainer, run["batches"][i:i + run["accum"]])
        return run["launches"], None
    t0 = time.perf_counter()
    ev = trainer.evaluate(held_out)
    log(f"[qwen2.5] evaluate on {len(held_out)} texts: {ev} in "
        f"{time.perf_counter() - t0:.1f} s")
    if not (np.isfinite(ev["eval_loss"]) and ev["eval_tokens"] > 0):
        raise RuntimeError(f"bad eval metrics {ev}")
    prompts = [list(t_["text"].encode())[:64] for t_ in held_out[:2]]
    t_gen = _greedy_generate(model, prompts, 16, "qwen2.5")
    launches = run["launches"]
    del trainer, model, run
    return launches, dict(metrics, eval=ev, generate_s=t_gen)


# ---------------------------------------------------------------------------
# GRPO: phase 4f (2 layers, card against CPU) and phase 12 (the notebook)
# ---------------------------------------------------------------------------

#: the Llama 3.1 (8B) GRPO notebook's recipe (phase 12)
GRPO_RECIPE = dict(learning_rate=5e-6, adam_beta1=0.9, adam_beta2=0.99,
                   weight_decay=0.1, warmup_steps=0, warmup_ratio=0.1,
                   lr_scheduler_type="cosine", logging_steps=1,
                   per_device_train_batch_size=1,
                   gradient_accumulation_steps=1, num_generations=6,
                   max_prompt_length=256, max_completion_length=768,
                   max_grad_norm=0.1, beta=0.04, prefix_grouping=True,
                   report_to="none")
GRPO_STEPS = 2             # optimizer steps (rollout rounds) of phase 12
GRPO_LORA_R = 32           # the notebook's lora_rank (and lora_alpha)
#: phase 12's bounds on the grouped LoRA gradients' relative L2 distance
#: from the unpacked ones at 32 layers in bf16: all leaves together, and
#: the worst leaf. On an H100 the two correct layouts differ there by
#: 0.086 together and 0.176 at the worst leaf (moving the unpacked rows
#: one slot gives 0.084 / 0.151), the region rule dropped by 0.69 / 0.83;
#: in fp32 the layouts agree to 1e-4 (tests/test_torch_grpo.py). Phase 12
#: checks that the fault fails them.
GRPO_GRAD_TOL = 0.15
GRPO_LEAF_TOL = 0.3
#: the kernels the grouped GRPO step runs, and those it must never launch
GRPO_KERNELS = ("nf4_matmul", "nf4_matmul_dx", "rms_norm", "rms_norm_bwd",
                "splash_attn_fwd", "splash_attn_dq", "splash_attn_dkv")
GRPO_ABSENT = ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv",
               "packed_attn_fwd", "packed_attn_bwd", "cross_entropy_fwd",
               "cross_entropy_bwd")


@contextlib.contextmanager
def patched_methods(obj, **fns):
    """Shadow methods of ``obj`` by the instance attributes ``fns`` for the
    block; on the way out delete them, so that the class's methods show
    through again. Assigning the bound methods back instead would leave
    ``obj.__dict__`` holding methods bound to ``obj``: a reference cycle
    that keeps ``obj``, and all it holds (a trainer's model), alive until
    the collector runs."""
    for name, fn in fns.items():
        setattr(obj, name, fn)
    try:
        yield obj
    finally:
        for name in fns:
            delattr(obj, name)


def _grpo_trainer(model, out_dir, reward_funcs=(), **kw):
    """A GRPOTrainer over ``model`` with the byte tokenizer: the recipe's
    arguments, updated by ``kw``."""
    from unsloth_tpu_torch.trainer.grpo import GRPOConfig, GRPOTrainer

    args = GRPOConfig(output_dir=out_dir, **dict(GRPO_RECIPE, **kw))
    return GRPOTrainer(model, reward_funcs=list(reward_funcs), args=args,
                       train_dataset=[], processing_class=ByteTokenizer())


def _random_b(lora, gen, std=0.02):
    """The LoRA tree with the same A and a random B (std ``std``), so that
    every adapter's gradient is live."""
    import torch

    from unsloth_tpu_torch.ops.lora import LoRAWeights

    return {"layers": [{name: LoRAWeights(
        a=lw.a, b=torch.randn(lw.b.shape, generator=gen,
                              device=lw.b.device).to(lw.b.dtype) * std,
        scale=lw.scale) for name, lw in layer.items()}
        for layer in lora["layers"]]}


def _grpo_loss_grads(trainer, batch):
    """(loss, {leaf: fp32 grad on the CPU}, launches) of one GRPO loss on
    ``batch`` with the trainer's model's LoRA tree: the reference pass
    with LoRA off, then the policy's forward and backward, the old policy
    the current one, detached."""
    import torch

    kernels = _kernel_fns()
    leaves = _lora_leaves(trainer.model.lora)
    for _, t in leaves:
        t.requires_grad_(True)
    before = {n: fn.launches for n, fn in kernels.items()}
    with torch.no_grad():
        ref = trainer._logps(batch, None)
    loss = trainer._loss(batch, None, ref)
    loss.backward()
    grads = {n: t.grad.float().cpu() for n, t in leaves}
    for _, t in leaves:
        t.grad = None
        t.requires_grad_(False)
    return (float(loss.detach()), grads,
            {n: fn.launches - before[n] for n, fn in kernels.items()})


def _shifted_rows(batch, n_seq, shift):
    """The unpacked GRPO batch as a packed one (the same loss for
    loss_type "grpo": each scored token weighted 1 / (its sequence's
    length * n_seq)) with every row moved ``shift`` slots right behind pad
    of segment 0, positions unchanged: the same function, attended in
    another alignment of the kernels' 64-token tiles."""
    import torch

    from unsloth_tpu_torch.trainer.grpo import PackedGRPOBatch

    n, t = batch.input_ids.shape
    dev = batch.input_ids.device

    def moved(x, fill=0):
        out = torch.full((n, t + shift), fill, dtype=x.dtype, device=dev)
        out[:, shift:] = x
        return out

    mask = batch.completion_mask.to(torch.float32)
    w = mask / (mask.sum(-1, keepdim=True).clamp(min=1.0) * n_seq)
    return PackedGRPOBatch(
        input_ids=moved(batch.input_ids),
        segment_ids=moved(torch.ones_like(batch.input_ids)),
        positions=moved(torch.arange(t, dtype=torch.int32, device=dev)[
            None].expand(n, t)),
        logp_targets=moved(batch.logp_targets, -100),
        adv_tok=moved(batch.advantages[:, None] * mask),
        w_tok=moved(w))


def _grad_distance(got, want):
    """((worst leaf, its relative L2), the median leaf's, the relative L2
    of all leaves together) of two {leaf: gradient} dicts."""
    rels = {n: _rel(got[n], want[n]) for n in want}
    worst = max(rels, key=rels.get)
    num = sum(float((got[n].float() - want[n].float()).norm() ** 2)
              for n in want)
    den = sum(float(want[n].float().norm() ** 2) for n in want)
    return ((worst, rels[worst]), statistics.median(rels.values()),
            (num / den) ** 0.5)


def phase_train_parity_grpo(tmp, seed=SEED + 17):
    """Phase 4f: the grouped GRPO loss and every LoRA gradient at
    Llama-3.1-8B's width in a 2-layer cut, on the card (K1/K2, K3/K4 and
    K18's prefix form, bf16) against the CPU (the plain versions, fp32)
    from the same weights and NF4 codes: random ones from the seed, LoRA
    r=32 with a random B, one fixed rollout batch of the recipe's six
    generations in the layout (128, 6, 128) (max_prompt_length 128,
    max_completion_length 127): a prompt of 100 tokens, completions of
    127, 90, 13, 127, 64 and 40, the reference pass with LoRA off, beta
    0.04. Tolerances as in phase 4e: loss within 1e-2 relative, each
    gradient leaf within 5e-2 relative L2. The card must launch K18 (2
    forward launches for the reference pass, 2 for the policy's forward
    and 2 for its recompute; 2 dq, 2 dk/dv) and none of GRPO_ABSENT.
    Returns the distances and the card's launches."""
    import numpy as np
    import torch

    from unsloth_tpu_torch.models.config import ModelConfig
    from unsloth_tpu_torch.models.loader import LanguageModel
    from unsloth_tpu_torch.models.params import (init_lora_tree, init_params,
                                                 quantize_params, tree_to)
    from unsloth_tpu_torch.trainer.grpo import group_advantages

    cfg = ModelConfig.from_hf_config(dict(LLAMA_31_8B_CONFIG,
                                          num_hidden_layers=2))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = quantize_params(init_params(cfg, gen, dtype=torch.bfloat16),
                             cfg, dtype=torch.bfloat16)
    lora = _random_b(init_lora_tree(cfg, gen, r=GRPO_LORA_R,
                                    alpha=float(GRPO_LORA_R)), gen)
    rng = np.random.default_rng(seed)
    sub = rng.choice(cfg.vocab_size, SUB_VOCAB, replace=False)
    prompt = sub[rng.integers(0, SUB_VOCAB, 100)].tolist()
    completions = [sub[rng.integers(0, SUB_VOCAB, n)].tolist()
                   for n in (127, 90, 13, 127, 64, 40)]
    adv = group_advantages(rng.standard_normal(6), 6)
    results = {}
    for dev in (DEVICE, "cpu"):
        p = params if dev == DEVICE else _tree_f32(tree_to(params, "cpu"))
        lo = lora if dev == DEVICE else tree_to(lora, "cpu")
        trainer = _grpo_trainer(
            LanguageModel(cfg=cfg, params=p, lora=lo),
            os.path.join(tmp, "grpo_parity"), max_prompt_length=128,
            max_completion_length=127)
        batch = trainer._build_grouped_batch([prompt] * 6, completions, adv)
        t0 = time.perf_counter()
        results[dev] = _grpo_loss_grads(trainer, batch)
        if dev == DEVICE:
            torch.cuda.synchronize()
        results[dev] += (time.perf_counter() - t0, batch.layout)
    (l_card, g_card, launches, t_card, layout), (l_cpu, g_cpu, _, t_cpu, _) \
        = results[DEVICE], results["cpu"]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    rels = {n: _rel(g_card[n], g_cpu[n]) for n in g_cpu}
    worst = max(rels, key=rels.get)
    log(f"[grpo parity] 2-layer Llama-3.1-8B NF4 + LoRA r={GRPO_LORA_R}, "
        f"grouped GRPO loss in the layout {layout}: loss card "
        f"{l_card:.6e} cpu (fp32) {l_cpu:.6e} (rel {loss_rel:.2e}, tol "
        f"1e-2); {len(rels)} LoRA grads, worst rel L2 {rels[worst]:.3e} "
        f"({worst}), median {statistics.median(rels.values()):.3e} (tol "
        f"5e-2); card {t_card:.1f} s, cpu {t_cpu:.1f} s; card launches "
        f"{ {n: c for n, c in launches.items() if c} }")
    finite = np.isfinite(l_card) and all(
        bool(torch.isfinite(g).all()) for g in g_card.values())
    if not (finite and loss_rel <= 1e-2 and rels[worst] <= 5e-2):
        raise RuntimeError("card and CPU grouped GRPO loss/grads disagree")
    _check_launched(launches, GRPO_KERNELS, "2-layer GRPO",
                    {"splash_attn_fwd": 6, "splash_attn_dq": 2,
                     "splash_attn_dkv": 2}, steps=1)
    for name in GRPO_ABSENT:
        if launches[name]:
            raise RuntimeError(f"{name} launched on the grouped GRPO loss")
    del params, lora
    torch.cuda.empty_cache()
    return dict(loss_rel=loss_rel, grad_rel_max=rels[worst],
                launches=launches)


def _grpo_prompts(rng, n):
    """Synthetic GSM8K-style prompts for the byte tokenizer, 200-256 bytes:
    the notebook's system prompt's gist and a word problem of random
    numbers."""
    out = []
    for _ in range(n):
        a, b, c = (int(x) for x in rng.integers(2, 999, 3))
        text = (f"Respond in the format <reasoning>...</reasoning>"
                f"<answer>...</answer>. Question: A shop sells {a} apples "
                f"on Monday and {b} apples on Tuesday. Each crate holds {c} "
                "apples. How many crates does the shop fill, and how many "
                "apples are left?")
        out.append(text[:256])
    return out


def _even_digit_reward(prompts=None, completions=None, **kw):
    """A reward computed from the completion text alone: the share of its
    characters that are even digits."""
    return [sum(ch in "02468" for ch in c) / max(len(c), 1)
            for c in completions]


def phase_grpo(tmp, profile=False):
    """Phase 12: GRPO on full-width, full-depth Llama-3.1-8B by the Llama
    3.1 (8B) GRPO notebook's recipe, from the checkpoint in ``tmp``:
    from_pretrained(max_seq_length=1024, load_in_4bit=True),
    get_peft_model(r=32, lora_alpha=32, seven projections, "unsloth"),
    GRPOTrainer(prefix_grouping=True) with GRPO_RECIPE (6 generations,
    prompts up to 256 tokens, completions up to 768, batch 1, learning
    rate 5e-6, cosine, max_grad_norm 0.1, beta 0.04) for GRPO_STEPS steps,
    the reward :func:`_even_digit_reward`. Each round must prefill its
    prompt once and decode 6 streams; each step must launch K18's prefix
    form exactly 96 times forward (32 layers: the reference pass, the
    policy's forward, its recompute), 32 dq and 32 dk/dv, and K16 never;
    losses finite, the LoRA moved. Then, on the last round's rollouts, with
    a random B in the LoRA: the grouped loss against the unpacked one (K16
    on [6, 1024] rows), within 2e-2 relative, and the LoRA gradients within
    GRPO_GRAD_TOL (all leaves together, relative L2) and GRPO_LEAF_TOL
    (the worst leaf); the same comparison with the region rule dropped from
    the grouped pass (K18 given the layout (P, 1, G L), so that each
    completion sees the ones before it) must fail those limits. Printed
    beside them, not gated: the unpacked loss again with its rows moved
    one slot right (:func:`_shifted_rows`), the same function in another
    tile alignment. Prints the rollout seconds and completion tokens/s, the
    reference log-probability pass and the step time, trained tokens/s and
    the peak memory, each time between two device syncs that this phase
    adds around the trainer's own calls. With ``profile``, one more grouped
    step (the reference pass, the loss, its backward and an AdamW update on
    the last batch) runs under the profiler instead of the comparison."""
    import numpy as np
    import torch

    from unsloth_tpu_torch import FastLanguageModel
    tgen = importlib.import_module("unsloth_tpu_torch.inference.generate")
    from unsloth_tpu_torch.trainer import grpo as tgrpo

    kernels = _kernel_fns()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, _ = FastLanguageModel.from_pretrained(
        tmp, max_seq_length=1024, load_in_4bit=True, dtype=torch.bfloat16,
        device=DEVICE)
    model = FastLanguageModel.get_peft_model(
        model, r=GRPO_LORA_R, lora_alpha=GRPO_LORA_R,
        target_modules=["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                        "up_proj", "down_proj"],
        use_gradient_checkpointing="unsloth", random_state=3407)
    torch.cuda.synchronize()
    log(f"[grpo] from_pretrained + get_peft_model(r={GRPO_LORA_R}) in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    trainer = _grpo_trainer(model, os.path.join(tmp, "grpo_out"),
                            [_even_digit_reward], max_steps=GRPO_STEPS)
    trainer.train_dataset = [
        {"prompt": p} for p in _grpo_prompts(np.random.default_rng(SEED + 18),
                                              GRPO_STEPS)]
    calls, rollouts = [], []
    # seconds between two device syncs: each round's rollout and reference
    # pass, each optimizer step (from the loss's call to its logged entry,
    # which reads the loss after the update)
    spans = {"rollout": [], "logps": [], "step": []}
    cache_fn = tgen.forward_with_cache
    generate_batch, logps_fn, loss_fn, log_fn = (
        trainer._generate_batch, trainer._logps, trainer._loss,
        trainer.metrics_logger.log)

    def counted(params, lora, ids, *a, **kw):
        calls.append(tuple(ids.shape))
        return cache_fn(params, lora, ids, *a, **kw)

    def timed(what, fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        spans[what].append(time.perf_counter() - t0)
        return out

    def kept(prompts):
        rollouts.append(timed("rollout", generate_batch, prompts))
        return rollouts[-1]

    def ref_timed(batch, lora):
        # the loss's own policy pass runs with grad and is left untimed
        if torch.is_grad_enabled():
            return logps_fn(batch, lora)
        return timed("logps", logps_fn, batch, lora)

    def step_started(*a):
        torch.cuda.synchronize()
        step_t0.append(time.perf_counter())
        return loss_fn(*a)

    def step_logged(entry):
        torch.cuda.synchronize()
        spans["step"].append(time.perf_counter() - step_t0[-1])
        return log_fn(entry)

    step_t0 = []
    b0 = {n: t.clone() for n, t in _lora_leaves(model.lora) if
          n.endswith(".b")}
    tgen.forward_with_cache = counted
    try:
        with patched_methods(trainer, _generate_batch=kept, _logps=ref_timed,
                             _loss=step_started), \
                patched_methods(trainer.metrics_logger, log=step_logged):
            result = trainer.train()
    finally:
        tgen.forward_with_cache = cache_fn
    peak = torch.cuda.max_memory_allocated()
    launches = {name: fn.launches for name, fn in kernels.items()}
    losses = [e["loss"] for e in trainer.state_log]
    g = GRPO_RECIPE["num_generations"]
    prefills = [c for c in calls if c[1] > 1]
    decodes = [c for c in calls if c[1] == 1]
    log(f"[grpo] losses {losses}; rewards "
        f"{[round(e['reward'], 4) for e in trainer.state_log]}; cache calls: "
        f"prefill {prefills}, decode {len(decodes)} at batch "
        f"{sorted(set(c[0] for c in decodes))}")
    rounds = []
    for i, (prompt_ids, completion_ids) in enumerate(rollouts):
        rollout, lp, step = (spans[w][i] for w in ("rollout", "logps",
                                                    "step"))
        scored = sum(map(len, completion_ids))
        trained = len(prompt_ids[0]) + scored
        rounds.append(dict(rollout_s=rollout, logps_s=lp, step_s=step,
                           completion_tokens=scored))
        log(f"[grpo] round {i + 1}: rollout {rollout:.3f} s for {scored} "
            f"completion tokens ({scored / rollout:.1f} tokens/s, "
            f"{len(prompt_ids[0])}-token prompt, "
            f"{rollout / max(map(len, completion_ids)) * 1e3:.1f} ms a "
            f"decode step); reference log-probability pass {lp:.3f} s; "
            f"training step {step:.3f} s for {trained} trained tokens "
            f"({trained / step:.1f} tokens/s, {scored / step:.1f} scored "
            "tokens/s)")
    log(f"[grpo] peak memory allocated {peak / 1e9:.2f} GB; launches on the "
        f"GRPO path: {launches}")
    if len(losses) != GRPO_STEPS or not all(np.isfinite(losses)):
        raise RuntimeError(f"GRPO losses not finite: {losses}")
    if len(prefills) != GRPO_STEPS or any(c[0] != 1 for c in prefills) or \
            any(c[0] != g for c in decodes) or not decodes:
        raise RuntimeError(f"the rollouts did not prefill each prompt once "
                           f"and decode {g} streams: {prefills}, "
                           f"{sorted(set(decodes))}")
    n_layers = model.cfg.num_layers
    _check_launched(launches, GRPO_KERNELS, "GRPO",
                    {"splash_attn_fwd": 3 * n_layers,
                     "splash_attn_dq": n_layers,
                     "splash_attn_dkv": n_layers}, steps=GRPO_STEPS)
    for name in GRPO_ABSENT:
        if launches[name]:
            raise RuntimeError(f"{name} launched on the grouped GRPO steps")
    moved = [n for n, t in _lora_leaves(model.lora)
             if n in b0 and not torch.equal(t, b0[n])]
    if len(moved) != len(b0) or not all(
            bool(torch.isfinite(t).all()) for _, t in
            _lora_leaves(model.lora)):
        raise RuntimeError(f"the LoRA B did not all move ({len(moved)} of "
                           f"{len(b0)}) or is not finite")
    prompt_ids, completion_ids = rollouts[-1]
    adv = tgrpo.group_advantages(np.asarray(_even_digit_reward(completions=[
        trainer.tokenizer.decode(c) for c in completion_ids])), g)
    grouped = trainer._build_grouped_batch(prompt_ids, completion_ids, adv)
    stats = dict(losses=losses, peak_bytes=peak,
                 rounds=rounds,
                 runtime_s=result.metrics["train_runtime"])
    if profile:
        _profile_grpo_step(trainer, grouped)
        return launches, stats
    model.lora = _random_b(model.lora, torch.Generator(
        device=DEVICE).manual_seed(SEED + 19))
    unpacked = trainer._build_batch(prompt_ids, completion_ids, adv)
    l_g, g_g, n_g = _grpo_loss_grads(trainer, grouped)
    l_u, g_u, n_u = _grpo_loss_grads(trainer, unpacked)
    l_s, g_s, _ = _grpo_loss_grads(trainer, _shifted_rows(
        unpacked, len(completion_ids), 1))
    # the fault: K18 given one region for all completions, on the same path
    P, G, L = grouped.layout
    layout_cm = tgrpo.prefix_attention
    tgrpo.prefix_attention = lambda layout: layout_cm((P, 1, G * L))
    try:
        l_f, g_f, n_f = _grpo_loss_grads(trainer, grouped)
    finally:
        tgrpo.prefix_attention = layout_cm
    rel = {what: (abs(loss - l_u) / abs(l_u), *_grad_distance(g, g_u))
           for what, loss, g in (("grouped", l_g, g_g), ("shifted", l_s, g_s),
                                 ("fault", l_f, g_f))}

    def reading(what):
        loss_rel, worst, median, whole = rel[what]
        return (f"loss rel {loss_rel:.2e}; LoRA grads worst rel L2 "
                f"{worst[1]:.3e} ({worst[0]}), median {median:.3e}, all "
                f"together {whole:.3e}")

    def passes(what):
        loss_rel, worst, _, whole = rel[what]
        return (loss_rel <= 2e-2, worst[1] <= GRPO_LEAF_TOL and
                whole <= GRPO_GRAD_TOL)

    log(f"[grpo] the last round's rollouts, LoRA with a random B: grouped "
        f"{tuple(grouped.input_ids.shape)} in {grouped.layout} loss "
        f"{l_g:.6e} (K18 prefix launches {n_g['splash_attn_fwd']} / "
        f"{n_g['splash_attn_dq']} / {n_g['splash_attn_dkv']}) against "
        f"unpacked {tuple(unpacked.input_ids.shape)} loss {l_u:.6e} (K16 "
        f"launches {n_u['flash_attn_fwd']} / {n_u['flash_attn_dq']} / "
        f"{n_u['flash_attn_dkv']}): {reading('grouped')} (tol 2e-2 on the "
        f"loss, {GRPO_LEAF_TOL} a leaf, {GRPO_GRAD_TOL} all together); "
        f"{len(g_u)} leaves")
    log(f"[grpo] not gated, the unpacked rows moved one slot (loss "
        f"{l_s:.6e}): {reading('shifted')}")
    log(f"[grpo] the fault, the region rule dropped (layout {(P, 1, G * L)}"
        f", K18 prefix launches {n_f['splash_attn_fwd']} / "
        f"{n_f['splash_attn_dq']} / {n_f['splash_attn_dkv']}; loss "
        f"{l_f:.6e}): {reading('fault')}")
    if not (np.isfinite(l_g) and all(passes("grouped"))):
        raise RuntimeError("the grouped GRPO loss/grads disagree with the "
                           "unpacked ones")
    if passes("fault")[1] or not n_f["splash_attn_fwd"]:
        raise RuntimeError("the GRPO gradient check lets the region rule "
                           "dropped through")
    _check_launched(n_g, GRPO_KERNELS, "grouped GRPO loss")
    _check_launched(n_u, ("flash_attn_fwd", "flash_attn_dq",
                          "flash_attn_dkv"), "unpacked GRPO loss")
    if n_g["flash_attn_fwd"] or n_u["splash_attn_fwd"]:
        raise RuntimeError(f"the layouts took each other's attention "
                           f"kernels: {n_g}, {n_u}")
    stats.update(compared=rel)
    del model, trainer
    torch.cuda.empty_cache()
    return launches, stats


def _profile_grpo_step(trainer, batch, top=25):
    """One grouped GRPO step on ``batch`` under ``torch.profiler``: the
    reference pass, the loss and its backward, and a ClippedAdamW update
    (fresh state) of the LoRA; the device time by kernel and family, the
    busy share, and MFU as :func:`_profile_train_step` counts it (4N FLOPs
    a real token: N matmul weights, the row's real slots)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from unsloth_tpu_torch.trainer.sft import build_optimizer, lora_leaves

    params = lora_leaves(trainer.model.lora)
    tx, _ = build_optimizer(trainer.args, 1, params)
    for p in params:
        p.requires_grad_(True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            ref = trainer._logps(batch, None)
        trainer._loss(batch, None, ref).backward()
        tx.step()
        tx.zero_grad()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for p in params:
        p.requires_grad_(False)
    real = int((batch.segment_ids != 0).sum())
    log(f"[profile] one grouped GRPO step, layout {batch.layout}, "
        f"{batch.input_ids.numel()} row tokens, {real} real:")
    _device_report(prof, wall * 1e6, top)
    n_matmul, _ = _matmul_weights(trainer.model.cfg)
    log(f"[profile] N = {n_matmul / 1e9:.3f}e9 matmul weights: MFU "
        f"{100 * 4 * n_matmul * real / wall / 989e12:.2f}%")


#: phase 4d's bound on each LoRA gradient leaf's relative L2 distance
#: from fp32 (see :func:`phase_train_parity_gpt_oss`)
GPT_OSS_GRAD_TOL = 0.3


def phase_train_parity_gpt_oss(seed=SEED + 10, t=2048, docs=None,
                               fixed_routing=False, expect=None,
                               absent=None):
    """gpt-oss-20b at full width cut to 2 layers (one sliding, one global),
    all 32 experts, random weights from the seed, quantize_params (NF4
    attention at block 64, stacked-NF4 experts at block 32), LoRA r=16 on
    q/k/v/o with B nonzero: the loss and every LoRA gradient of one packed
    ``t``-token row (of ``docs``, default synthetic documents), on the card
    in bf16 (K1/K2, K14/K15, K17 on the global layer, K7/K8 over the full
    logits; on the sliding layer the banded form where the window is
    narrow, at t = 2,048, else K18 at head dim 64, the chunked lse and the
    sink rescale) and on the CPU through the plain versions in fp32, from
    the same weights and NF4 codes.

    Tolerance: loss within 1e-2 relative, as in phases 4b/4c. The LoRA
    gradients cannot be held to fp32 as closely as there where the routing
    is live: the top-4 routing is not continuous, a token whose 4th and 5th
    router logits lie within bf16 rounding of each other takes other
    experts in bf16 than in fp32, and at random init a gradient is a sum of
    incoherent per-token terms, so a few such tokens move it by a fifth
    (on an H100 the plain versions in bf16 on the CPU sat 0.15-0.20 from
    fp32 at this shape, the card 0.17-0.21). So each leaf's relative L2
    distance from fp32 must stay below GPT_OSS_GRAD_TOL; a wrong kernel in
    the backward gives errors of the order of the gradient (1 and up), and
    phase 3 holds each kernel on its own. With ``fixed_routing`` the router
    bias is set to 0, 1, ..., 31 times 100 (every token takes experts 28-31
    on both sides, whatever its logits), and the gradients are held to 5e-2
    as in phases 4b/4c. Every kernel of ``expect`` (default: the gpt-oss
    path's) must launch, none of ``absent`` (default: the other attention
    kernels)."""
    import numpy as np
    import torch

    from unsloth_tpu_torch.data.packing import pack_sequences
    from unsloth_tpu_torch.models.config import ModelConfig
    from unsloth_tpu_torch.models.decoder import loss_fn
    from unsloth_tpu_torch.models.params import (init_lora_tree,
                                                 init_params, quantize_params,
                                                 tree_to)

    cfg = ModelConfig.from_hf_config(dict(GPT_OSS_20B_CONFIG,
                                          num_hidden_layers=2))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = quantize_params(init_params(cfg, gen, dtype=torch.bfloat16),
                             cfg, dtype=torch.bfloat16)
    if fixed_routing:
        for layer in params["layers"]:
            layer["router_bias"] = 100.0 * torch.arange(
                cfg.num_experts, device=DEVICE).to(layer["router_bias"].dtype)
    lora = init_lora_tree(cfg, gen, r=16, alpha=16.0)
    for layer in lora["layers"]:
        for lw in layer.values():
            lw.b = torch.randn(lw.b.shape, generator=gen, device=DEVICE) * 0.01
    rng = np.random.default_rng(seed)
    if docs is None:
        docs = _synthetic_docs(rng, cfg.vocab_size, 2 * t)
    else:
        sub = rng.choice(cfg.vocab_size, SUB_VOCAB, replace=False)
        docs = [{"input_ids": sub[rng.integers(0, SUB_VOCAB, n)].tolist()}
                for n in docs]
    row = pack_sequences(docs, t)[0].as_dict()
    kernels = _kernel_fns()
    results = {}
    for side, dev in (("card", DEVICE), ("cpu", "cpu")):
        p = params if dev == DEVICE else _tree_f32(tree_to(params, "cpu"))
        lo = lora if dev == DEVICE else tree_to(lora, "cpu")
        leaves = _lora_leaves(lo)
        for _, t_ in leaves:
            t_.requires_grad_(True)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in row.items()}
        before = {n: fn.launches for n, fn in kernels.items()}
        t0 = time.perf_counter()
        loss = loss_fn(p, lo, batch, cfg, fused_ce=False, remat=False)
        loss.backward()
        if dev == DEVICE:
            torch.cuda.synchronize()
        results[side] = (float(loss.detach()), {n: t_.grad.float().cpu()
                                               for n, t_ in leaves},
                         time.perf_counter() - t0,
                         {n: fn.launches - before[n]
                          for n, fn in kernels.items()})
        for _, t_ in leaves:
            t_.grad = None
            t_.requires_grad_(False)
        del p
    (l_card, g_card, t_card, launches), (l_cpu, g_cpu, t_cpu, _) = \
        results["card"], results["cpu"]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    rels = {n: _rel(g_card[n], g_cpu[n]) for n in g_cpu}
    tol = 5e-2 if fixed_routing else GPT_OSS_GRAD_TOL
    worst = max(rels, key=rels.get)
    n_real = int((row["segment_ids"] != 0).sum())
    log(f"[train parity] 2-layer gpt-oss-20b (sliding + global, 32 experts, "
        f"NF4{', routing fixed by the router bias' if fixed_routing else ''}"
        f") + LoRA r=16 on q/k/v/o, one packed row of {t} ({n_real} real "
        f"tokens): loss card {l_card:.6f} cpu (fp32) {l_cpu:.6f} (rel "
        f"{loss_rel:.2e}, tol 1e-2); {len(rels)} LoRA grads against fp32: "
        f"worst rel L2 {rels[worst]:.3e} ({worst}), median "
        f"{statistics.median(rels.values()):.3e} (tol {tol}); card "
        f"{t_card:.1f} s, cpu fp32 {t_cpu:.1f} s; card launches "
        f"{ {n: c for n, c in launches.items() if c} }")
    finite = np.isfinite(l_card) and all(
        bool(torch.isfinite(g).all()) for g in g_card.values())
    if not (finite and loss_rel <= 1e-2 and rels[worst] <= tol):
        raise RuntimeError(f"card and CPU gpt-oss loss/grads disagree: loss "
                           f"rel {loss_rel}, worst grad {worst} "
                           f"{rels[worst]}")
    for name in expect or GPT_OSS_KERNELS:
        if launches[name] <= 0:
            raise RuntimeError(f"{name} did not launch on the gpt-oss row")
    stray = {n: launches[n] for n in (GPT_OSS_ABSENT if absent is None
                                      else absent) if launches[n]}
    if stray:
        raise RuntimeError(f"other attention kernels ran on the gpt-oss "
                           f"row: {stray}")
    del params, lora
    torch.cuda.empty_cache()
    return dict(loss_rel=loss_rel, grad_rel_max=rels[worst],
                launches=launches)


#: K19's kernels on the full-FT path: the forward, dx and the weight
#: gradient
FULL_FT_EXPERT_KERNELS = ("gmm", "gmm_dx", "tgmm")


def phase_train_parity_gpt_oss_full(seed=SEED + 25, t=SINKS_ROWS):
    """Phase 4i: full fine-tuning's gradients, card against CPU.
    gpt-oss-20b at full width cut to 2 layers (one sliding, one global),
    all 32 experts as dense bf16 stacks (what from_pretrained(
    full_finetuning=True) loads), random weights from the seed, every leaf
    requiring a gradient; one packed row of ``t`` tokens (SINKS_DOCS, as in
    phase 4e): loss_fn(params, None, lm_head_trainable=True), full logits,
    no remat, on the card in bf16 (K19 forward, dx and tgmm; K17 on the
    global layer, K18 at head dim 64 on the sliding one; K3/K4; K7/K8) and
    on the CPU through the plain versions in fp32 from the same weights.
    The routing is fixed by the router bias (100 on experts 28-31, 0 on
    the rest: every token takes those four on both sides, weighted by its
    own logits, so the router and its bias keep a gradient; ROADMAP C3:
    routing ties otherwise set the distance). Limits: the loss within 1e-2
    relative, as phase 4b; each leaf's gradient (experts, expert biases,
    router and its bias, sinks, attention with its biases, norms,
    embedding and lm_head) within 5e-2 relative L2 of fp32, as phase 4e.
    Launches exactly: K19 forward, dx and tgmm 3 a layer each."""
    import numpy as np
    import torch

    from unsloth_tpu_torch.data.packing import pack_sequences
    from unsloth_tpu_torch.models.config import ModelConfig
    from unsloth_tpu_torch.models.decoder import loss_fn
    from unsloth_tpu_torch.models.params import init_params, tree_to
    from unsloth_tpu_torch.trainer.checkpoint import named_leaves

    cfg = ModelConfig.from_hf_config(dict(GPT_OSS_20B_CONFIG,
                                          num_hidden_layers=2))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = init_params(cfg, gen, dtype=torch.bfloat16)
    for layer in params["layers"]:
        bias = torch.zeros(cfg.num_experts, device=DEVICE)
        bias[-cfg.num_experts_per_tok:] = 100.0
        layer["router_bias"] = bias.to(layer["router_bias"].dtype)
    rng = np.random.default_rng(seed)
    sub = rng.choice(cfg.vocab_size, SUB_VOCAB, replace=False)
    docs = [{"input_ids": sub[rng.integers(0, SUB_VOCAB, hi - lo)].tolist()}
            for lo, hi in SINKS_DOCS]
    row = pack_sequences(docs, t)[0].as_dict()
    kernels = _kernel_fns()
    results = {}
    for side, dev in (("card", DEVICE), ("cpu", "cpu")):
        p = params if dev == DEVICE else _tree_f32(tree_to(params, "cpu"))
        leaves = named_leaves(p)
        for _, t_ in leaves:
            t_.requires_grad_(True)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in row.items()}
        before = {n: fn.launches for n, fn in kernels.items()}
        t0 = time.perf_counter()
        loss = loss_fn(p, None, batch, cfg, lm_head_trainable=True,
                       fused_ce=False, remat=False)
        loss.backward()
        if dev == DEVICE:
            torch.cuda.synchronize()
        results[side] = (float(loss.detach()),
                         {n: t_.grad.float().cpu() for n, t_ in leaves},
                         time.perf_counter() - t0,
                         {n: fn.launches - before[n]
                          for n, fn in kernels.items()})
        for _, t_ in leaves:
            t_.grad = None
            t_.requires_grad_(False)
        del p, leaves
    (l_card, g_card, t_card, launches), (l_cpu, g_cpu, t_cpu, _) = \
        results["card"], results["cpu"]
    del results
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    rels = {n: _rel(g_card[n], g_cpu[n]) for n in g_cpu}
    worst = max(rels, key=rels.get)
    expect = {n: 3 * cfg.num_layers for n in FULL_FT_EXPERT_KERNELS}
    by_kind = {}
    for n, r in rels.items():
        kind = n.split(".")[-1] if n.startswith("layers") else n
        by_kind[kind] = max(by_kind.get(kind, 0.0), r)
    log(f"[full-FT parity] 2-layer gpt-oss-20b (sliding + global, "
        f"{cfg.num_experts} dense bf16 experts, routing fixed by the router "
        f"bias), every param "
        f"trained, one packed row of {t}: loss card {l_card:.6f} cpu (fp32) "
        f"{l_cpu:.6f} (rel {loss_rel:.2e}, tol 1e-2); {len(rels)} grads "
        f"against fp32: worst rel L2 {rels[worst]:.3e} ({worst}), median "
        f"{statistics.median(rels.values()):.3e} (tol 5e-2); worst by leaf "
        f"{ {k: round(v, 4) for k, v in sorted(by_kind.items())} }; card "
        f"{t_card:.1f} s, cpu fp32 {t_cpu:.1f} s; card launches "
        f"{ {n: c for n, c in launches.items() if c} } (expected {expect})")
    finite = np.isfinite(l_card) and all(
        bool(torch.isfinite(g).all()) for g in g_card.values())
    if not (finite and loss_rel <= 1e-2 and rels[worst] <= 5e-2):
        raise RuntimeError(f"card and CPU full-FT gpt-oss loss/grads "
                           f"disagree: loss rel {loss_rel}, worst grad "
                           f"{worst} {rels[worst]}")
    _check_launched(launches, FULL_FT_GPT_OSS_KERNELS + (
        "splash_attn_fwd", "splash_attn_dq", "splash_attn_dkv"),
        "gpt-oss full-FT 2-layer", expect, 1)
    stray = {n: launches[n] for n in ("nf4_matmul", "nf4_matmul_dx",
                                      "nf4_gmm", "nf4_gmm_dx") if launches[n]}
    if stray:
        raise RuntimeError(f"NF4 kernels ran on a dense full-FT row: {stray}")
    del params, g_card, g_cpu
    torch.cuda.empty_cache()
    return dict(loss_rel=loss_rel, grad_rel_max=rels[worst],
                launches=launches)


def phase_train_parity_small(tmp):
    """Phase 4e: the head-dim forms of the small Llama-family paths in
    whole 2-layer models, card against CPU (:func:`phase_train_parity_padded`
    and :func:`phase_train_parity_gpt_oss`, fp32 on the CPU on short rows):
    Llama-3.2-1B's width loaded by from_pretrained from a 2-layer bnb-4bit
    checkpoint (K1/K2 on bnb's decoded absmax, K16 at head dim 64), on a
    padded [2, 512] batch; Gemma-7B's width (K16 at head dim 256, no
    softcap), padded [2, 256]; gpt-oss-20b's width on a packed row of
    SINKS_ROWS tokens (its sliding layer K18 at head dim 64, then the
    chunked lse and the sink rescale; its global layer K17), with the
    routing fixed by the router bias. Returns each part's launches."""
    import torch

    from unsloth_tpu_torch import FastLanguageModel

    hf = dict(LLAMA_32_1B_CONFIG, num_hidden_layers=2)
    path = os.path.join(tmp, "llama32_2layer_bnb")
    write_checkpoint(path, hf, bnb4=True)
    model, _ = FastLanguageModel.from_pretrained(
        path, load_in_4bit=True, dtype=torch.bfloat16, device=DEVICE)
    llama = phase_train_parity_padded(
        hf, label="Llama-3.2-1B (bnb-4bit checkpoint)", seed=SEED + 14,
        lengths=(400, 512), params=model.params,
        absent=("packed_attn_fwd", "packed_attn_bwd", "splash_attn_fwd"))
    del model
    shutil.rmtree(path)
    gemma = phase_train_parity_padded(
        GEMMA_7B_CONFIG, label="Gemma-7B", seed=SEED + 15, lengths=(200, 256),
        absent=("packed_attn_fwd", "packed_attn_bwd", "splash_attn_fwd"))
    no_flash = ("packed_attn_fwd", "packed_attn_bwd", "flash_attn_fwd",
                "flash_attn_dq", "flash_attn_dkv")
    gpt_oss = phase_train_parity_gpt_oss(
        SEED + 16, t=SINKS_ROWS,
        docs=[hi - lo for lo, hi in SINKS_DOCS], fixed_routing=True,
        expect=GPT_OSS_KERNELS + ("splash_attn_fwd", "splash_attn_dq",
                                  "splash_attn_dkv"), absent=no_flash)
    return {"llama32": llama["launches"], "gemma": gemma["launches"],
            "gpt_oss": gpt_oss["launches"]}


def _active_flops_per_token(cfg, seq):
    """Forward FLOPs per token as bench.py's flops_per_token counts them for
    an MoE model: 2 per weight of q/k/v/o and of the active experts (top-k
    of gate/up/down), causal attention's 2 * seq * Hq * Dh per layer, and
    the lm_head."""
    dh = cfg.head_dim
    attn_p = cfg.hidden_size * dh * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
    moe_p = cfg.num_experts_per_tok * 3 * cfg.hidden_size * (
        cfg.moe_intermediate_size or cfg.intermediate_size)
    per_layer = 2 * (attn_p + moe_p) + 2 * seq * cfg.num_heads * dh
    return cfg.num_layers * per_layer + 2 * cfg.vocab_size * cfg.hidden_size


#: the grouped expert kernels (forward, dx) of phase 9's two parts
GPT_OSS_EXPERT_KERNELS = {"bf16": ("gmm", "gmm_dx"),
                          "nf4": ("nf4_gmm", "nf4_gmm_dx")}


def _gpt_oss_train(model, tmp, kernels, docs, part, steps, ce):
    """One part of phase 9's training: SFTTrainer with packing on ``docs``
    into GPT_OSS_ROWS-token rows, batch 1 x accumulation 2, ``steps``
    steps, the launch counts set to 0 just before. Losses finite and
    falling; step time, real tokens/s, the training peak, MFU over active
    parameters (:func:`_active_flops_per_token`, x3 for forward and
    backward, at 989 TFLOP/s). Launches per step exactly: the ``part``'s
    expert kernels (GPT_OSS_EXPERT_KERNELS) forward 3 x 24 x 2 (the
    offloaded remat runs each forward twice) x 2 and dx 3 x 24 x 2, the
    other part's none, K17 forward 48, dq 24, dk/dv 24 (12 global layers),
    K7/K8 ``ce`` each; K9-K11, K16 and K18 never. Returns (trainer,
    batches, launches, metrics)."""
    import numpy as np
    import torch

    from unsloth_tpu_torch import SFTConfig, SFTTrainer

    tag = f"[gpt-oss {part}]"
    trainer = SFTTrainer(model, train_dataset=docs, args=SFTConfig(
        output_dir=os.path.join(tmp, f"sft_gpt_oss_{part}"),
        max_seq_length=GPT_OSS_ROWS, packing=True,
        per_device_train_batch_size=1, gradient_accumulation_steps=2,
        max_steps=steps, learning_rate=1e-3, warmup_steps=0,
        logging_steps=1, report_to="none"))
    batches = trainer.prepare_batches()
    real = [int((b.segment_ids != 0).sum()) for b in batches[:2]]
    log(f"{tag} {len(docs)} documents of {DOC_LENGTHS[0]}-{DOC_LENGTHS[1]} "
        f"tokens packed into {len(batches)} rows of {GPT_OSS_ROWS} (real "
        f"tokens {real}), segment bound {trainer._segment_bound}")
    for fn in kernels.values():
        fn.launches = 0
    result = trainer.train()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {name: fn.launches for name, fn in kernels.items()}
    losses = [e["loss"] for e in trainer.state_log]
    times = trainer.step_times
    steady = statistics.median(times[1:])
    tokens = sum(real)
    cfg = model.cfg
    mfu = 3 * _active_flops_per_token(cfg, GPT_OSS_ROWS) * tokens / steady \
        / PEAK_BF16
    n_global = sum(cfg.layer_kind(i) == "global"
                   for i in range(cfg.num_layers))
    accum = 2
    expect = {"flash_sinks_fwd": n_global * 2 * accum,
              "flash_sinks_dq": n_global * accum,
              "flash_sinks_dkv": n_global * accum,
              "cross_entropy_fwd": ce, "cross_entropy_bwd": ce}
    for p_, (fwd, dx) in GPT_OSS_EXPERT_KERNELS.items():
        on = p_ == part
        expect[fwd] = on * 3 * cfg.num_layers * 2 * accum
        expect[dx] = on * 3 * cfg.num_layers * accum
    log(f"{tag} losses {[round(x, 4) for x in losses]}; step times (s) "
        f"{[round(x, 3) for x in times]}")
    log(f"{tag} steady step (median of steps 2-{len(times)}) {steady:.3f} s "
        f"for {tokens} real tokens = {tokens / steady:.1f} real tokens/s; "
        f"first step {times[0]:.3f} s; peak memory allocated in training "
        f"{peak / 1e9:.2f} GB; MFU over active parameters "
        f"{100 * mfu:.2f}% (bench.py's count, x3, 989 TFLOP/s)")
    log(f"{tag} launches on the path: "
        f"{ {n: c for n, c in launches.items() if c} }; per step "
        f"{ {n: launches[n] / len(times) for n in expect} } (expected "
        f"{expect})")
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise RuntimeError(f"{tag} training losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{tag} training loss did not fall: {losses}")
    names = [n for n in TRAIN_KERNELS if ce or not n.startswith("cross")]
    names += [*GPT_OSS_EXPERT_KERNELS[part], "flash_sinks_fwd",
              "flash_sinks_dq", "flash_sinks_dkv"]
    _check_launched(launches, names, f"gpt-oss {part} training", expect,
                    len(times))
    stray = {n: launches[n] for n in GPT_OSS_ABSENT if launches[n]}
    if stray:
        raise RuntimeError(f"other attention kernels ran on the gpt-oss "
                           f"{part} path: {stray}")
    metrics = dict(losses=losses, step_s=steady, first_step_s=times[0],
                   real_tokens_per_s=tokens / steady, peak_bytes=peak,
                   mfu=mfu, runtime_s=result.metrics["train_runtime"])
    return trainer, batches, launches, metrics


def _gpt_oss_bf16_sft(model, tmp, kernels, profile=False):
    """The default MoE path (phase 9's first part): the model as
    from_pretrained(load_in_4bit=True) leaves it, attention NF4 and the
    experts dense bf16 stacks, get_peft_model(r=16, the seven target names,
    "unsloth" checkpointing), :func:`_gpt_oss_train` on the same packed
    rows as the NF4 part for GPT_OSS_BF16_STEPS steps (K19; K7/K8 where
    the fused_ce="auto" gate takes the full logits, none where it takes
    the chunked CE). Then a greedy generate of 8 tokens for one prompt
    (:func:`_expert_generate`: K19's decode form 72 launches a decode
    step), and the trainer, its AdamW state and the adapter are freed.
    With ``profile``, one more step runs under the profiler
    (:func:`_profile_train_step`) in place of the generate. Returns
    (launches, metrics)."""
    import gc

    import numpy as np
    import torch

    from unsloth_tpu_torch import FastLanguageModel
    from unsloth_tpu_torch.models.decoder import fused_ce_gate, tree_bytes

    stacks = {n: w for n, w in model.params["layers"][0]["experts"].items()
              if n in ("gate", "up", "down")}
    if not all(isinstance(w, torch.Tensor) and w.dtype == torch.bfloat16
               for w in stacks.values()):
        kinds = {n: type(w).__name__ for n, w in stacks.items()}
        raise RuntimeError(f"expected dense bf16 expert stacks after "
                           f"from_pretrained: {kinds}")
    model = FastLanguageModel.get_peft_model(
        model, r=16, lora_alpha=16,
        target_modules=["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                        "up_proj", "down_proj"],
        use_gradient_checkpointing="unsloth").for_training()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = model.cfg
    param_bytes = tree_bytes(model.params)
    fused = fused_ce_gate(GPT_OSS_ROWS - 1, cfg.vocab_size, param_bytes,
                          cfg.num_layers, cfg.hidden_size,
                          torch.cuda.get_device_properties(0).total_memory)
    log(f"[gpt-oss bf16] experts dense "
        f"{ {n: tuple(w.shape) for n, w in stacks.items()} } bf16; with LoRA "
        f"{resident / 1e9:.2f} GB allocated; tree_bytes "
        f"{param_bytes / 1e9:.2f} GB, so the fused_ce gate takes the "
        f"{'chunked CE' if fused else 'full logits'} at "
        f"{GPT_OSS_ROWS - 1} rows")
    rng = np.random.default_rng(SEED + 11)
    docs = _synthetic_docs(rng, cfg.vocab_size, 2 * GPT_OSS_ROWS - 300)
    trainer, batches, launches, metrics = _gpt_oss_train(
        model, tmp, kernels, docs, "bf16", GPT_OSS_BF16_STEPS,
        0 if fused else 2)
    metrics.update(resident=resident, fused_ce=fused)
    if profile:
        _profile_train_step(trainer, batches[:2])
        return launches, metrics
    prompt = [docs[-1]["input_ids"][:64]]
    _, t_gen, gen = _expert_generate(model, prompt, 8, "gpt-oss bf16",
                                     kernels, "gmm", "gmm_decode")
    # free the trainer, its AdamW state and the adapter before quantizing
    del trainer
    model.lora = None
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(metrics, generate_s=t_gen,
                          generate_launches=gen)


def _expert_generate(model, prompts, n_new, tag, kernels, kernel,
                     decode_kernel):
    """Phase 9's greedy generate of ``n_new`` tokens for ``prompts`` over
    MoE experts, timed as :func:`_greedy_generate` times one (a prefill
    alone first: ms a decode step); every row must come back with
    ``n_new`` ids of the vocabulary, ``kernel`` (the expert products) must
    launch three times a layer each forward and ``decode_kernel`` (their
    grouped decode form) three times a layer each decode step and never in
    a prefill. Returns (the ids, the seconds, the launches of the full
    generate)."""
    import torch

    per_step = 3 * model.cfg.num_layers
    model.for_inference()
    before = {n_: fn.launches for n_, fn in kernels.items()}
    t0 = time.perf_counter()
    model.generate(prompts, max_new_tokens=1, temperature=0.0,
                   return_token_ids=True)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    mid = {n_: fn.launches for n_, fn in kernels.items()}
    t0 = time.perf_counter()
    out = model.generate(prompts, max_new_tokens=n_new, temperature=0.0,
                         return_token_ids=True)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    gen = {n_: fn.launches - mid[n_] for n_, fn in kernels.items()}
    prefill_decode = mid[decode_kernel] - before[decode_kernel]
    steps = max(len(r) for r in out) - 1
    log(f"[{tag}] generate {len(prompts)} prompts of "
        f"{[len(p_) for p_ in prompts]} tokens, {n_new} new: "
        f"{[len(r) for r in out]} tokens in {t_gen:.2f} s (a prefill alone "
        f"{t_prefill:.3f} s; "
        f"{1e3 * (t_gen - t_prefill) / max(steps, 1):.1f} ms a decode step "
        f"over {steps}); launches "
        f"{ {n_: c for n_, c in gen.items() if c} } ({decode_kernel} "
        f"{per_step} a decode step; {prefill_decode} in the prefill alone)")
    if len(out) != len(prompts) or any(
            len(r) != n_new or not all(0 <= t_ < model.cfg.vocab_size
                                       for t_ in r) for r in out):
        raise RuntimeError(f"generate did not return {len(prompts)} x "
                           f"{n_new} tokens: {out}")
    if gen[kernel] != per_step * n_new:
        raise RuntimeError(f"generate launched {kernel} {gen[kernel]} times "
                           f"in {n_new} forwards, not {per_step} a forward")
    if gen[decode_kernel] != per_step * steps or prefill_decode:
        raise RuntimeError(f"generate launched {decode_kernel} "
                           f"{gen[decode_kernel]} times over {steps} decode "
                           f"steps and {prefill_decode} in a prefill, not "
                           f"{per_step} a decode step and none in a prefill")
    return out, t_gen, gen


def phase_gpt_oss_sft(tmp, profile=False):
    """MoE QLoRA SFT on gpt-oss-20b at full width and depth from the
    checkpoint in ``tmp`` (bench.py's main_gpt_oss path, first rung):
    from_pretrained(max_seq_length 4096, load_in_4bit=True), which loads
    the experts as bf16 stacks as the JAX loader does; first the default
    MoE path on those (:func:`_gpt_oss_bf16_sft`: K19); then
    quantize_params (stacked NF4 at block 32), get_peft_model(r=16, the
    seven target names: q/k/v/o get adapters, the experts none, "unsloth"
    checkpointing) and :func:`_gpt_oss_train` on synthetic documents of
    64-1,024 tokens for GPT_OSS_STEPS steps (K14/K15, K7/K8 2 a step).
    Then evaluate on held-out documents, save_lora -> a fresh adapter ->
    load_lora -> evaluate (equal losses), and a greedy generate of 16
    tokens for 2 prompts (:func:`_expert_generate`: K14's decode form 72
    launches a decode step, the cached attention with sinks and the
    window). With ``profile`` True, the bf16-expert
    part is left out and one more NF4 step runs under the profiler
    (:func:`_profile_train_step`) in place of evaluate and generate; with
    "bf16", one more bf16-expert step runs under it and the NF4 part is
    left out. Returns (NF4 launches, bf16-expert launches, metrics)."""
    import numpy as np
    import torch

    from unsloth_tpu_torch import FastLanguageModel
    from unsloth_tpu_torch.models.params import quantize_params
    from unsloth_tpu_torch.ops.nf4 import NF4Stacked

    kernels = _kernel_fns()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, _ = FastLanguageModel.from_pretrained(
        tmp, max_seq_length=GPT_OSS_ROWS, load_in_4bit=True,
        dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    loaded = torch.cuda.memory_allocated()
    log(f"[gpt-oss] from_pretrained(load_in_4bit=True) in {t_load:.1f} s, "
        f"{loaded / 1e9:.2f} GB allocated (bf16 experts), peak while loading "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    bf16_launches = bf16_metrics = None
    if profile is not True:
        bf16_launches, bf16_metrics = _gpt_oss_bf16_sft(
            model, tmp, kernels, profile=profile == "bf16")
    if profile == "bf16":
        return None, bf16_launches, None
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.params = quantize_params(model.params, model.cfg)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    torch.cuda.empty_cache()
    experts = model.params["layers"][0]["experts"]
    blocks = {n: w.block_size for n, w in experts.items()
              if isinstance(w, NF4Stacked)}
    model = FastLanguageModel.get_peft_model(
        model, r=16, lora_alpha=16,
        target_modules=["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                        "up_proj", "down_proj"],
        use_gradient_checkpointing="unsloth").for_training()
    resident = torch.cuda.memory_allocated()
    load_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    log(f"[gpt-oss] quantize_params in {t_quant:.1f} s (expert blocks "
        f"{blocks}); with LoRA {resident / 1e9:.2f} GB; peak while "
        f"quantizing {load_peak / 1e9:.2f} GB; adapters on "
        f"{sorted(model.lora['layers'][0])}")
    if set(blocks) != {"gate", "up", "down"} or \
            set(model.lora["layers"][0]) != {"q", "k", "v", "o"}:
        raise RuntimeError(f"expected NF4 experts and q/k/v/o adapters: "
                           f"{blocks}, {sorted(model.lora['layers'][0])}")
    rng = np.random.default_rng(SEED + 11)
    docs = _synthetic_docs(rng, model.cfg.vocab_size, 2 * GPT_OSS_ROWS - 300)
    held_out = _synthetic_docs(rng, model.cfg.vocab_size, 1500)[:2]
    trainer, batches, launches, metrics = _gpt_oss_train(
        model, tmp, kernels, docs, "nf4", GPT_OSS_STEPS, 2)
    metrics.update(load_s=t_load, quantize_s=t_quant, load_peak=load_peak,
                   resident=resident)
    if profile:
        _profile_train_step(trainer, batches[:2])
        return launches, bf16_launches, None

    t0 = time.perf_counter()
    ev = trainer.evaluate(held_out)
    t_eval = time.perf_counter() - t0
    lora_dir = os.path.join(tmp, "lora_gpt_oss")
    model.save_lora(lora_dir)
    FastLanguageModel.get_peft_model(
        model, r=8, lora_alpha=64, random_state=SEED + 12,
        use_gradient_checkpointing="unsloth")
    ev_fresh = trainer.evaluate(held_out)
    model.load_lora(lora_dir)
    ev2 = trainer.evaluate(held_out)
    log(f"[gpt-oss] evaluate on {len(held_out)} documents: {ev} in "
        f"{t_eval:.1f} s; with a fresh adapter: {ev_fresh}; after save_lora "
        f"-> fresh adapter -> load_lora: {ev2}")
    if not (np.isfinite(ev["eval_loss"]) and ev["eval_tokens"] > 0):
        raise RuntimeError(f"bad eval metrics {ev}")
    if ev_fresh["eval_loss"] == ev["eval_loss"]:
        raise RuntimeError("the fresh adapter evaluates as the trained one")
    if ev2["eval_loss"] != ev["eval_loss"]:
        raise RuntimeError(f"eval loss changed across the adapter round "
                           f"trip: {ev['eval_loss']} -> {ev2['eval_loss']}")
    prompts = [d_["input_ids"][:64] for d_ in held_out[:2]]
    _, t_gen, gen = _expert_generate(model, prompts, 16, "gpt-oss", kernels,
                                     "nf4_gmm", "nf4_gmm_decode")
    del trainer, model
    torch.cuda.empty_cache()
    return launches, bf16_launches, dict(metrics, eval=ev, generate_s=t_gen,
                                         generate_launches=gen,
                                         bf16=bf16_metrics)


# ---------------------------------------------------------------------------
# Full fine-tuning: phase 16 (gpt-oss-20b, a depth cut at full width) and
# phase 17 (Qwen2.5-0.5B at full depth: resume, GaLore, modules_to_save,
# the merged save)
# ---------------------------------------------------------------------------

GPT_OSS_FULL_FT_LAYERS = 4  # phase 16's depth cut: ~37 GB of weights, grads
                            # and bf16 moments
GPT_OSS_FULL_FT_STEPS = 3
QWEN25_FULL_FT_STEPS = 4    # phase 17's uninterrupted run, saving at 2
QWEN25_FULL_FT_TEXTS = 16   # two steps an epoch: checkpoint-2 ends epoch 0


@contextlib.contextmanager
def first_grads_checked(found):
    """For the block, the first update of the SFT trainer's AdamW first
    records in ``found`` each param's gradient: (finite, nonzero), read
    on the device in one sync."""
    import torch

    from unsloth_tpu_torch.trainer import sft as tsft

    step = tsft.ClippedAdamW.step

    def checked(self):
        if not found:
            flags = torch.stack([
                torch.stack((torch.isfinite(p.grad).all(), p.grad.ne(0).any()))
                if p.grad is not None else torch.zeros(2, dtype=torch.bool,
                                                       device=p.device)
                for p in self.params]).cpu()
            found.update({n: tuple(bool(v) for v in f)
                          for n, f in zip(self.names, flags)})
        return step(self)

    tsft.ClippedAdamW.step = checked
    try:
        yield found
    finally:
        tsft.ClippedAdamW.step = step


def _depth_cut(src, dst, n_layers):
    """A checkpoint directory of ``src``'s files by symlink with a
    config.json cut to ``n_layers`` layers: the loader reads only the
    tensors of the layers the config names."""
    os.makedirs(dst, exist_ok=True)
    for name in os.listdir(src):
        if name != "config.json":
            os.symlink(os.path.join(src, name), os.path.join(dst, name))
    with open(os.path.join(src, "config.json")) as f:
        config = json.load(f)
    config["num_hidden_layers"] = n_layers
    if "layer_types" in config:
        config["layer_types"] = config["layer_types"][:n_layers]
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(config, f)
    return dst


def phase_gpt_oss_full_ft(gpt_oss, tmp):
    """Phase 16: gpt-oss-20b full fine-tuning at full width on a depth cut
    of GPT_OSS_FULL_FT_LAYERS layers (the full depth's bf16 weights alone
    are 41.8 GB, and the gradients as much again): phase 9's checkpoint by
    symlink (:func:`_depth_cut`), from_pretrained(full_finetuning=True,
    max_seq_length 4096), no get_peft_model, SFTTrainer on phase 9's
    packed 4,096-token rows (batch 1 x accumulation 2) for
    GPT_OSS_FULL_FT_STEPS steps: every param trained, the experts through
    K19's tgmm, AdamW's moments in bf16 as optax keeps them. Losses
    finite; every param's first gradient finite and nonzero (not "every
    param moved": bf16 updates of about the learning rate round away on
    weights near 1); launches a step exactly: K19 forward 3 x layers x 2
    (the remat runs each forward again) x 2 micro-batches, dx and tgmm
    3 x layers x 2, K17 forward 2 x global layers x 2, dq and dk/dv
    global layers x 2, K3 (2 x 2 x layers + 1) x 2 and K4 (2 x layers +
    1) x 2, K7/K8 2 (the full logits); no NF4, K16 or K18 launch. Reports
    the step time, real tokens/s, the peak memory and MFU at 6N (three
    times the forward's FLOPs over active parameters: forward, dx and the
    weight gradient; bench.py's count, 989 TFLOP/s). Returns (launches,
    metrics)."""
    import numpy as np
    import torch

    from unsloth_tpu_torch import FastLanguageModel, SFTConfig, SFTTrainer
    from unsloth_tpu_torch.models.decoder import tree_bytes
    from unsloth_tpu_torch.trainer.checkpoint import named_leaves

    path = _depth_cut(gpt_oss, os.path.join(tmp, "gpt_oss_full_ft"),
                      GPT_OSS_FULL_FT_LAYERS)
    kernels = _kernel_fns()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, _ = FastLanguageModel.from_pretrained(
        path, max_seq_length=GPT_OSS_ROWS, full_finetuning=True,
        dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.synchronize()
    cfg = model.cfg
    loaded = torch.cuda.memory_allocated()
    log(f"[gpt-oss full FT] from_pretrained(full_finetuning=True) of "
        f"{cfg.num_layers} layers in {time.perf_counter() - t0:.1f} s: "
        f"{tree_bytes(model.params) / 1e9:.2f} GB of bf16 params, "
        f"{loaded / 1e9:.2f} GB allocated; gc_mode {model.gc_mode!r}")
    rng = np.random.default_rng(SEED + 11)
    docs = _synthetic_docs(rng, cfg.vocab_size, 2 * GPT_OSS_ROWS - 300)
    accum = 2
    trainer = SFTTrainer(model, train_dataset=docs, args=SFTConfig(
        output_dir=os.path.join(tmp, "sft_gpt_oss_full_ft"),
        max_seq_length=GPT_OSS_ROWS, packing=True,
        per_device_train_batch_size=1, gradient_accumulation_steps=accum,
        max_steps=GPT_OSS_FULL_FT_STEPS, warmup_steps=0, logging_steps=1,
        report_to="none"))
    batches = trainer.prepare_batches()
    real = [int((b.segment_ids != 0).sum()) for b in batches[:accum]]
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with first_grads_checked({}) as grads:
        trainer.train()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {name: fn.launches for name, fn in kernels.items()}
    losses = [e["loss"] for e in trainer.state_log]
    times = trainer.step_times
    steady = statistics.median(times[1:])
    tokens = sum(real)
    mfu = 3 * _active_flops_per_token(cfg, GPT_OSS_ROWS) * tokens / steady \
        / PEAK_BF16
    n_layers = cfg.num_layers
    n_global = sum(cfg.layer_kind(i) == "global" for i in range(n_layers))
    expect = {"gmm": 3 * n_layers * 2 * accum, "gmm_dx": 3 * n_layers * accum,
              "tgmm": 3 * n_layers * accum,
              "flash_sinks_fwd": n_global * 2 * accum,
              "flash_sinks_dq": n_global * accum,
              "flash_sinks_dkv": n_global * accum,
              "rms_norm": (2 * 2 * n_layers + 1) * accum,
              "rms_norm_bwd": (2 * n_layers + 1) * accum,
              "cross_entropy_fwd": accum, "cross_entropy_bwd": accum}
    bad = sorted(n for n, (finite, nonzero) in grads.items()
                 if not (finite and nonzero))
    log(f"[gpt-oss full FT] {len(docs)} documents in {len(batches)} rows of "
        f"{GPT_OSS_ROWS} (real tokens {real}); losses "
        f"{[round(x, 4) for x in losses]}; step times (s) "
        f"{[round(x, 3) for x in times]}")
    log(f"[gpt-oss full FT] steady step (median of steps 2-{len(times)}) "
        f"{steady:.3f} s for {tokens} real tokens = {tokens / steady:.1f} "
        f"real tokens/s; first step {times[0]:.3f} s; peak memory allocated "
        f"in training {peak / 1e9:.2f} GB (params, grads and bf16 moments "
        f"{4 * tree_bytes(model.params) / 1e9:.2f} GB); MFU at 6N over "
        f"active parameters {100 * mfu:.2f}% (3 x bench.py's forward count: "
        f"forward, dx and the weight gradient; 989 TFLOP/s); first "
        f"gradients of {len(grads)} params, not finite or all zero: {bad}")
    log(f"[gpt-oss full FT] launches on the path: "
        f"{ {n: c for n, c in launches.items() if c} }; per step "
        f"{ {n: launches[n] / len(times) for n in expect} } (expected "
        f"{expect})")
    if len(losses) != GPT_OSS_FULL_FT_STEPS or not all(np.isfinite(losses)):
        raise RuntimeError(f"gpt-oss full-FT losses not finite: {losses}")
    n_leaves = len(named_leaves(model.params))
    if bad or len(grads) != n_leaves:
        raise RuntimeError(f"gpt-oss full-FT first gradients of "
                           f"{len(grads)} of {n_leaves} params; not finite "
                           f"or zero: {bad}")
    _check_launched(launches, FULL_FT_GPT_OSS_KERNELS, "gpt-oss full-FT",
                    expect, len(times))
    stray = {n: launches[n] for n in GPT_OSS_ABSENT + (
        "nf4_matmul", "nf4_matmul_dx", "nf4_gmm", "nf4_gmm_dx")
        if launches[n]}
    if stray:
        raise RuntimeError(f"kernels off the gpt-oss full-FT path ran: "
                           f"{stray}")
    del trainer, model
    torch.cuda.empty_cache()
    shutil.rmtree(path)
    return launches, dict(losses=losses, step_s=steady, first_step_s=times[0],
                          real_tokens_per_s=tokens / steady, peak_bytes=peak,
                          mfu_6n=mfu)


def _qwen_ft_run(path, tmp, tag, texts, steps, out, resume=None,
                 peft=None, **args):
    """One SFT run of phase 17 on the Qwen2.5-0.5B checkpoint ``path``:
    from_pretrained(max_seq_length 2048, bf16, ``full_finetuning`` unless
    ``peft`` gives get_peft_model's keywords), SFTTrainer(packing=False)
    on ``texts`` with train_on_responses_only, batch 2 x accumulation 4
    (phase 11's recipe), ``steps`` steps, the launch counts set to 0 just
    before training; ``resume`` goes to train(resume_from_checkpoint=).
    Returns (model, trainer, launches, seconds)."""
    import torch

    from unsloth_tpu_torch import (FastLanguageModel, SFTConfig, SFTTrainer,
                                   train_on_responses_only)

    kernels = _kernel_fns()
    model, _ = FastLanguageModel.from_pretrained(
        path, max_seq_length=UNPACKED_ROWS, load_in_4bit=False,
        full_finetuning=peft is None, dtype=torch.bfloat16, device=DEVICE)
    if peft is not None:
        model = FastLanguageModel.get_peft_model(
            model, r=16, lora_alpha=16,
            target_modules=["q_proj", "k_proj", "v_proj", "o_proj",
                            "gate_proj", "up_proj", "down_proj"],
            use_gradient_checkpointing="unsloth", **peft)
    trainer = SFTTrainer(model, tokenizer=ByteTokenizer(), train_dataset=texts,
                         args=SFTConfig(
                             output_dir=os.path.join(tmp, out),
                             max_seq_length=UNPACKED_ROWS, packing=False,
                             per_device_train_batch_size=2,
                             gradient_accumulation_steps=4, max_steps=steps,
                             warmup_steps=0, logging_steps=1,
                             report_to="none", **args))
    train_on_responses_only(trainer, instruction_part=INSTRUCTION,
                            response_part=RESPONSE)
    trainer.prepare_batches()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.train(resume_from_checkpoint=resume)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    losses = [e["loss"] for e in trainer.state_log]
    log(f"[qwen2.5 {tag}] steps {[e['step'] for e in trainer.state_log]} "
        f"losses {[round(x, 4) for x in losses]}; step times (s) "
        f"{[round(x, 3) for x in trainer.step_times]}; {seconds:.1f} s in "
        f"train(); peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not losses or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"qwen2.5 {tag} losses not finite: {losses}")
    return model, trainer, launches, seconds


def phase_qwen25_full_ft(path, tmp):
    """Phase 17: Qwen2.5-0.5B full fine-tuning at full width and depth on
    phase 11's checkpoint and recipe (:func:`_qwen_ft_run`), every param
    trained (the tied embedding through the lookup and the logits):
    (a) QWEN25_FULL_FT_STEPS steps on QWEN25_FULL_FT_TEXTS texts (two steps
    an epoch) with save_steps=2; launches a step exactly K16 forward 2 x
    layers x 4 (the remat), dq and dk/dv layers x 4, K7/K8 4, K3
    (2 x 2 x layers + 1) x 4 and K4 (2 x layers + 1) x 4; no NF4 kernel.
    (b) A fresh trainer resumed from checkpoint-2 runs steps 3-4: its
    losses and final params equal run (a)'s, each leaf within 1e-3
    relative L2 (the bit-equal leaves counted). (c) optim="galore_adamw",
    2 steps: the optimizer state's bytes below AdamW's (bf16 moments, 4
    bytes a param) and equal to state_memory_ratio's count of fp32 floats.
    (d) A LoRA run of 2 steps with modules_to_save=["embed_tokens",
    "lm_head"] (the tied head untied into a copy) and
    embedding_learning_rate: the copies move, the base embedding does not.
    (e) save_pretrained_merged of run (a)'s model, reloaded: logits on two
    held-out rows equal the trained model's (within 1e-2 relative L2;
    whether they are bit-equal is logged). Returns (launches of run (a),
    metrics)."""
    import numpy as np
    import torch

    from unsloth_tpu_torch import FastLanguageModel
    from unsloth_tpu_torch.models.decoder import logits_fn, tree_bytes
    from unsloth_tpu_torch.models.hf_loader import CheckpointReader
    from unsloth_tpu_torch.optimizers.galore import (state_bytes,
                                                     state_memory_ratio)
    from unsloth_tpu_torch.trainer.checkpoint import named_leaves
    from unsloth_tpu_torch.trainer.sft import build_optimizer

    texts = _alpaca_texts(np.random.default_rng(SEED + 26),
                          QWEN25_FULL_FT_TEXTS + 2)
    train, held_out = texts[:QWEN25_FULL_FT_TEXTS], texts[-2:]
    steps = QWEN25_FULL_FT_STEPS
    # (a) uninterrupted, saving at 2
    model, trainer, launches, t_a = _qwen_ft_run(
        path, tmp, "full FT", train, steps, "qwen_ft_a", save_steps=2)
    cfg, accum = model.cfg, 4
    n_layers = cfg.num_layers
    expect = {"flash_attn_fwd": 2 * n_layers * accum,
              "flash_attn_dq": n_layers * accum,
              "flash_attn_dkv": n_layers * accum,
              "rms_norm": (2 * 2 * n_layers + 1) * accum,
              "rms_norm_bwd": (2 * n_layers + 1) * accum,
              "cross_entropy_fwd": accum, "cross_entropy_bwd": accum}
    times = trainer.step_times
    log(f"[qwen2.5 full FT] launches "
        f"{ {n: c for n, c in launches.items() if c} }; per step "
        f"{ {n: launches[n] / len(times) for n in expect} } (expected "
        f"{expect})")
    _check_launched(launches, list(expect), "qwen2.5 full-FT", expect,
                    len(times))
    stray = {n: launches[n] for n in ("nf4_matmul", "nf4_matmul_dx",
                                      "packed_attn_fwd", "splash_attn_fwd")
             if launches[n]}
    if stray:
        raise RuntimeError(f"kernels off the qwen2.5 full-FT path: {stray}")
    losses_a = [e["loss"] for e in trainer.state_log]
    ckpt = os.path.join(tmp, "qwen_ft_a", "checkpoint-2")
    peak_a = torch.cuda.max_memory_allocated()
    state_a = trainer.model.params
    optimizer_bytes = 2 * tree_bytes(model.params)
    del trainer
    torch.cuda.empty_cache()
    # (b) resumed from checkpoint-2
    m_b, tr_b, _, t_b = _qwen_ft_run(path, tmp, "resumed", train, steps,
                                     "qwen_ft_b", resume=ckpt)
    if [e["step"] for e in tr_b.state_log] != [3, 4]:
        raise RuntimeError(f"the resume ran steps {tr_b.state_log}")
    losses_b = [e["loss"] for e in tr_b.state_log]
    leaves_a, leaves_b = named_leaves(state_a), named_leaves(m_b.params)
    rels = {n: _rel(b, a) for (n, a), (_, b) in zip(leaves_a, leaves_b)}
    equal = sum(torch.equal(a, b) for (_, a), (_, b) in zip(leaves_a,
                                                            leaves_b))
    worst = max(rels, key=rels.get)
    log(f"[qwen2.5 resume] losses {losses_b} against the uninterrupted "
        f"{losses_a[2:]}; final params: {equal} of {len(rels)} leaves "
        f"bit-equal, worst rel L2 {rels[worst]:.3e} ({worst}; limit 1e-3)")
    if rels[worst] > 1e-3 or not np.allclose(losses_b, losses_a[2:],
                                             rtol=1e-3):
        raise RuntimeError(f"the resumed run left the uninterrupted one: "
                           f"{worst} {rels[worst]}, losses {losses_b}")
    del tr_b, m_b, leaves_b
    torch.cuda.empty_cache()
    # (c) GaLore
    m_c, tr_c, _, t_c = _qwen_ft_run(path, tmp, "GaLore", train, 2,
                                     "qwen_ft_c", optim="galore_adamw")
    params_c = [t for _, t in named_leaves(m_c.params)]
    galore_tx, _ = build_optimizer(tr_c.args, 2, m_c.params)
    ratio = state_memory_ratio(params_c)
    g_bytes = state_bytes(galore_tx.state)
    n_params = sum(t.numel() for t in params_c)
    log(f"[qwen2.5 GaLore] optimizer state {g_bytes / 1e6:.1f} MB (fp32, "
        f"state_memory_ratio {ratio:.4f} floats a param: "
        f"{ratio * n_params * 4 / 1e6:.1f} MB) against AdamW's "
        f"{optimizer_bytes / 1e6:.1f} MB (bf16 moments) for {n_params} "
        f"params")
    if not (g_bytes < optimizer_bytes
            and abs(g_bytes - ratio * n_params * 4) <= 4 * len(params_c)):
        raise RuntimeError(f"GaLore state {g_bytes} bytes, ratio {ratio}")
    del tr_c, m_c, galore_tx, params_c
    torch.cuda.empty_cache()
    # (d) LoRA with modules_to_save and a separate embedding learning rate
    m_d, tr_d, _, t_d = _qwen_ft_run(
        path, tmp, "LoRA + modules_to_save", train, 2, "qwen_ft_d",
        peft=dict(modules_to_save=["embed_tokens", "lm_head"]),
        learning_rate=1e-3, embedding_learning_rate=1e-4)
    base = m_d.params["embed"]
    stored = CheckpointReader(path).get("model.embed_tokens.weight").to(
        base.device, base.dtype)
    moved = {n: float((m_d.lora[n] - base.float()).abs().max())
             for n in ("embed", "lm_head")}
    untouched = bool(torch.equal(base, stored))
    log(f"[qwen2.5 modules_to_save] fp32 copies moved from the base by "
        f"(max) {moved}; the bf16 base embedding equal to the checkpoint's: "
        f"{untouched}")
    if not (all(v > 0 for v in moved.values()) and untouched
            and "lm_head" not in m_d.params):
        raise RuntimeError(f"modules_to_save copies did not train or the "
                           f"base moved: {moved}, {untouched}")
    del tr_d, m_d, base
    torch.cuda.empty_cache()
    # (e) the merged save of run (a)'s model, reloaded
    out = os.path.join(tmp, "qwen_ft_merged")
    t0 = time.perf_counter()
    model.save_pretrained_merged(out)
    back, _ = FastLanguageModel.from_pretrained(
        out, max_seq_length=UNPACKED_ROWS, full_finetuning=True,
        dtype=torch.bfloat16, device=DEVICE)
    rows = [list(t_["text"].encode()) for t_ in held_out]
    n_ids = min(256, *map(len, rows))
    ids = torch.tensor([r[:n_ids] for r in rows], device=DEVICE)
    with torch.no_grad():
        want = logits_fn(model.params, None, ids, cfg, remat=False)
        got = logits_fn(back.params, None, ids, back.cfg, remat=False)
    rel = _rel(got, want)
    log(f"[qwen2.5 merged] saved and reloaded in "
        f"{time.perf_counter() - t0:.1f} s: logits rel L2 {rel:.3e} (limit "
        f"1e-2), bit-equal {bool(torch.equal(got, want))}")
    if not rel <= 1e-2:
        raise RuntimeError(f"merged reload's logits differ: {rel}")
    del model, back, state_a, want, got
    shutil.rmtree(out)
    torch.cuda.empty_cache()
    return launches, dict(losses=losses_a, step_s=statistics.median(times[1:]),
                          peak_bytes=peak_a, resume_worst_rel=rels[worst],
                          resume_bit_equal=equal, galore_state_bytes=g_bytes,
                          adamw_state_bytes=optimizer_bytes,
                          merged_logits_rel=rel,
                          seconds=dict(a=t_a, b=t_b, c=t_c, d=t_d))


# ---------------------------------------------------------------------------
# text diffusion: phases 4j, 4k (2 layers, card against CPU) and 18 (LLaDA)
# ---------------------------------------------------------------------------

#: every attention kernel; a path lists those of it that must launch
ATTENTION_KERNELS = ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv",
                     "packed_attn_fwd", "packed_attn_bwd", "splash_attn_fwd",
                     "splash_attn_dq", "splash_attn_dkv", "flash_sinks_fwd",
                     "flash_sinks_dq", "flash_sinks_dkv") + FULL_FLASH \
    + FULL_SPLASH


def phase_train_parity_diffusion(hf=LLADA_8B_CONFIG, label="LLaDA-8B",
                                 names=FULL_FLASH, seed=SEED + 31,
                                 all_global=False):
    """Text diffusion on the 2-layer cut of ``hf`` at full width, made
    bidirectional (``causal=False``, the mask id from the config or the
    last vocabulary id, as FastDiffusionModel resolves it; with
    ``all_global`` the sliding window dropped, every layer global), random
    bf16 weights and LoRA r=16 on the seven projections with a random B:
    diffusion_loss of one padded batch of two rows of DIFFUSION_PARITY
    real tokens, its every LoRA gradient, and the logits of the noised
    batch, on the card in bf16 (the non-causal attention kernels ``names``,
    K3/K4, the chunked selective log-softmax) and on the CPU through the
    plain versions in fp32, from the same weights and one mask drawn on
    the CPU (``noise=``). Limits: loss within 1e-2 relative, logits within
    2e-2 relative L2, the worst LoRA leaf within 5e-2 relative L2. The
    same run with the card's config forced causal must fail them (the
    distances are printed). On the card's non-causal run each kernel of
    ``names`` launches exactly twice (one a layer; remat off) and no other
    attention kernel. Returns the distances and the launches."""
    import dataclasses

    import numpy as np
    import torch

    from unsloth_tpu_torch.data.packing import pad_batch
    from unsloth_tpu_torch.models.config import ModelConfig
    from unsloth_tpu_torch.models.decoder import logits_fn
    from unsloth_tpu_torch.models.diffusion import (diffusion_loss,
                                                    diffusion_mask)
    from unsloth_tpu_torch.models.params import (init_lora_tree,
                                                 init_params, tree_to)

    cfg = ModelConfig.from_hf_config(dict(hf, num_hidden_layers=2))
    mid = hf.get("mask_token_id", cfg.vocab_size - 1)
    cfg = dataclasses.replace(cfg, causal=False, mask_token_id=mid,
                              **({"sliding_window": None} if all_global
                                 else {}))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = init_params(cfg, gen, dtype=torch.bfloat16)
    lora = _random_b(init_lora_tree(cfg, gen, r=16, alpha=16.0), gen)
    rng = np.random.default_rng(seed)
    sub = rng.choice(cfg.vocab_size - 1, SUB_VOCAB, replace=False)
    rows = [{"input_ids": sub[rng.integers(0, SUB_VOCAB, n)].tolist()}
            for n in DIFFUSION_PARITY]
    batch_np = {k: v for k, v in pad_batch(
        rows, max(DIFFUSION_PARITY)).as_dict().items()
        if k in ("input_ids", "segment_ids", "positions")}
    ids = torch.from_numpy(batch_np["input_ids"]).long()
    noise = diffusion_mask(torch.Generator().manual_seed(seed), ids, mid)
    kernels = _kernel_fns()
    results = {}
    for run, dev, c in (("card", DEVICE, cfg), ("cpu", "cpu", cfg),
                        ("card forced causal", DEVICE,
                         dataclasses.replace(cfg, causal=True))):
        p = params if dev == DEVICE else _tree_f32(tree_to(params, "cpu"))
        lo = lora if dev == DEVICE else tree_to(lora, "cpu")
        leaves = _lora_leaves(lo)
        for _, t in leaves:
            t.requires_grad_(True)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        nz = tuple(x.to(dev) for x in noise)
        before = {n: fn.launches for n, fn in kernels.items()}
        t0 = time.perf_counter()
        loss = diffusion_loss(p, lo, batch, c, noise=nz, remat=False)
        loss.backward()
        if dev == DEVICE:
            torch.cuda.synchronize()
        launches = {n: fn.launches - before[n] for n, fn in kernels.items()}
        with torch.no_grad():
            logits = logits_fn(p, lo, nz[0], c, remat=False).float().cpu()
        results[run] = (float(loss.detach()), {n: t.grad.float().cpu()
                                               for n, t in leaves},
                        logits, time.perf_counter() - t0, launches)
        for _, t in leaves:
            t.grad = None
            t.requires_grad_(False)
    l_cpu, g_cpu, z_cpu, t_cpu, _ = results["cpu"]
    dist = {}
    for run in ("card", "card forced causal"):
        l_, g_, z_, t_, launches = results[run]
        (worst, w_rel), median, _ = _grad_distance(g_, g_cpu)
        dist[run] = dict(loss_rel=abs(l_ - l_cpu) / abs(l_cpu),
                         logits_rel=_rel(z_, z_cpu), grad_rel_max=w_rel)
        log(f"[train parity] 2-layer {label} diffusion, bf16 + LoRA r=16, "
            f"padded [2, {max(DIFFUSION_PARITY)}] ({DIFFUSION_PARITY[0]} and "
            f"{DIFFUSION_PARITY[1]} real tokens), {run}: loss {l_:.6f} cpu "
            f"(fp32) {l_cpu:.6f} (rel {dist[run]['loss_rel']:.2e}, tol "
            f"1e-2); logits rel L2 {dist[run]['logits_rel']:.3e} (tol 2e-2); "
            f"{len(g_cpu)} LoRA grads, worst rel L2 {w_rel:.3e} ({worst}), "
            f"median {median:.3e} (tol 5e-2); card {t_:.1f} s, cpu "
            f"{t_cpu:.1f} s; launches "
            f"{ {n: k for n, k in launches.items() if k} }")

    def within(d):
        return (d["loss_rel"] <= 1e-2 and d["logits_rel"] <= 2e-2
                and d["grad_rel_max"] <= 5e-2)

    l_card, g_card, _, _, launches = results["card"]
    finite = np.isfinite(l_card) and all(
        bool(torch.isfinite(g).all()) for g in g_card.values())
    if not (finite and within(dist["card"])):
        raise RuntimeError(f"card and CPU diffusion loss/logits/grads "
                           f"disagree on {label}: {dist['card']}")
    if within(dist["card forced causal"]):
        raise RuntimeError(f"the {label} diffusion limits let the causal "
                           f"mask through: {dist['card forced causal']}")
    want = {n: 2 if n in names else 0 for n in ATTENTION_KERNELS}
    wrong = {n: (launches[n], k) for n, k in want.items() if launches[n] != k}
    if wrong or not (launches["rms_norm"] and launches["rms_norm_bwd"]):
        raise RuntimeError(f"{label} diffusion launches (got, want): {wrong}"
                           f"; {launches}")
    del params, lora, results
    torch.cuda.empty_cache()
    return dict(dist, launches=launches)


def _diffusion_texts(rng, n):
    """Synthetic Alpaca-format texts of 1,500 bytes and more: the
    instruction marker, 64-448 random printable bytes, a newline, the
    response marker, 1,420-1,536 random printable bytes. With the byte
    tokenizer they make rows of 1,518-2,019 tokens (every one real)."""
    import numpy as np

    def printable(lo, hi):
        size = int(rng.integers(lo, hi + 1))
        return bytes(rng.integers(32, 127, size).astype(np.uint8)).decode()

    return [{"text": INSTRUCTION + printable(64, 448) + "\n" + RESPONSE
             + printable(1420, 1536)} for _ in range(n)]


def diffusion_launches(n_layers):
    """The launches a step of phase 18 needs: under the offloaded remat the
    non-causal K16 forward twice a layer (the forward and its recompute),
    dq and dk/dv once; K3 on each layer's two norms twice and the final
    norm once; K4 on every norm but layer 0's input norm (nothing before
    it takes a gradient under LoRA)."""
    return {"flash_attn_fwd_full": 2 * n_layers,
            "flash_attn_dq_full": n_layers, "flash_attn_dkv_full": n_layers,
            "rms_norm": 4 * n_layers + 1, "rms_norm_bwd": 2 * n_layers}


def phase_llada(path, profile=False):
    """Text diffusion at full width and depth from the LLaDA-8B checkpoint
    at ``path`` (:func:`write_checkpoint` of LLADA_8B_CONFIG), every
    kernel's launch count and the peak memory reset first:
    FastDiffusionModel.from_pretrained(dtype=bf16) (a bf16 base, JAX's
    default), get_peft_model(r=16, lora_alpha=16, seven projections,
    "unsloth" checkpointing), DiffusionTrainer for DIFFUSION_STEPS steps
    of 2 rows x 2,048 tokens over Alpaca-format texts of 1,500 real tokens
    and more (:func:`_diffusion_texts`), learning rate 2e-4: losses finite,
    the LoRA B leaves moved, launches a step exactly
    :func:`diffusion_launches` and no other attention, NF4 or CE kernel;
    step time, real tokens/s, peak memory, MFU at 4N per real token (N the
    matmul weights; the non-causal attention's FLOPs, twice causal's, are
    not counted). Then diffusion_generate from a 32-token prompt over a
    128-slot canvas in 16 steps at temperature 0: the prompt kept, no mask
    id left, at least floor(96 (k + 1) / 16) slots committed after step k
    (the canvas each step's forward reads, recorded), 16 x 32 launches of
    the non-causal K16 forward and no other attention kernel; ms a
    denoising step. With ``profile``, one more training step under
    torch.profiler instead of the checks after training. Returns (the
    training launches, the generate launches, the metrics)."""
    import numpy as np
    import torch

    from unsloth_tpu_torch import FastDiffusionModel, SFTConfig
    from unsloth_tpu_torch.models import diffusion as tdiff
    from unsloth_tpu_torch.trainer.diffusion import DiffusionTrainer

    kernels = _kernel_fns()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, _ = FastDiffusionModel.from_pretrained(
        path, max_seq_length=UNPACKED_ROWS, dtype=torch.bfloat16,
        device=DEVICE)
    model = FastDiffusionModel.get_peft_model(
        model, r=16, lora_alpha=16,
        target_modules=["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                        "up_proj", "down_proj"],
        use_gradient_checkpointing="unsloth")
    cfg = model.cfg
    torch.cuda.synchronize()
    log(f"[llada] FastDiffusionModel.from_pretrained(bf16) + get_peft_model("
        f"r=16) in {time.perf_counter() - t0:.1f} s, causal={cfg.causal}, "
        f"mask_token_id={cfg.mask_token_id}, q is "
        f"{type(model.params['layers'][0]['q']).__name__} "
        f"{getattr(model.params['layers'][0]['q'], 'dtype', '')}, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    if cfg.causal or cfg.mask_token_id != LLADA_8B_CONFIG["mask_token_id"] \
            or not isinstance(model.params["layers"][0]["q"], torch.Tensor):
        raise RuntimeError("FastDiffusionModel did not give a bidirectional "
                           "bf16 LLaDA with its mask id")
    args = SFTConfig(output_dir=os.path.join(os.path.dirname(path),
                                             "llada_out"),
                     max_seq_length=UNPACKED_ROWS,
                     per_device_train_batch_size=2,
                     max_steps=DIFFUSION_STEPS, learning_rate=2e-4,
                     warmup_steps=0, logging_steps=1, report_to="none")
    trainer = DiffusionTrainer(
        model, tokenizer=ByteTokenizer(), args=args,
        train_dataset=_diffusion_texts(np.random.default_rng(SEED + 33),
                                       2 * DIFFUSION_STEPS))
    batches = trainer.prepare_batches()
    real = [int((b.segment_ids != 0).sum()) for b in batches]
    lengths = [int(n) for b in batches for n in (b.segment_ids != 0).sum(1)]
    log(f"[llada] {len(batches)} padded batches of [2, {UNPACKED_ROWS}]: "
        f"rows of {min(lengths)}-{max(lengths)} real tokens")
    if min(lengths) < 1500 or len(batches) != DIFFUSION_STEPS:
        raise RuntimeError(f"phase 18's rows are not 2 x 2,048 of 1,500 "
                           f"real tokens and more: {lengths}")
    if profile:
        _profile_train_step(trainer, batches[:1])
        return None, None, None
    b_before = [lw.b.detach().clone() for layer in model.lora["layers"]
                for lw in layer.values()]
    result = trainer.train()
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [e["loss"] for e in trainer.state_log]
    times = trainer.step_times
    moved = sum(not torch.equal(b0, lw.b) for b0, lw in zip(
        b_before, (lw for layer in model.lora["layers"]
                   for lw in layer.values())))
    del b_before
    rate = sum(real[1:]) / sum(times[1:])
    n_matmul, _ = _matmul_weights(cfg)
    mfu = 4 * n_matmul * rate / PEAK_BF16
    expect = diffusion_launches(cfg.num_layers)
    log(f"[llada] losses {[round(x, 4) for x in losses]}; step times (s) "
        f"{[round(x, 3) for x in times]}; steady step (median of steps 2-"
        f"{DIFFUSION_STEPS}) {statistics.median(times[1:]):.3f} s, "
        f"{rate:.1f} real tokens/s over steps 2-{DIFFUSION_STEPS}; peak "
        f"memory allocated {peak / 1e9:.2f} GB; MFU {100 * mfu:.2f}% (4N per "
        f"real token, N = {n_matmul / 1e9:.3f}e9 matmul weights, 989 "
        f"TFLOP/s; the non-causal attention, twice causal's FLOPs, not "
        f"counted); {moved} of {7 * cfg.num_layers} LoRA B "
        f"leaves moved")
    log(f"[llada] launches on the path: "
        f"{ {n: c for n, c in launches.items() if c} }; per step "
        f"{ {n: launches[n] / DIFFUSION_STEPS for n in expect} } (expected "
        f"{expect})")
    if len(losses) != DIFFUSION_STEPS or not all(np.isfinite(losses)):
        raise RuntimeError(f"LLaDA diffusion losses not finite: {losses}")
    if moved != 7 * cfg.num_layers:
        raise RuntimeError(f"only {moved} LoRA B leaves moved")
    _check_launched(launches, list(expect), "LLaDA diffusion training",
                    expect, DIFFUSION_STEPS)
    stray = {n: c for n, c in launches.items() if c and n not in expect}
    if stray:
        raise RuntimeError(f"kernels off the LLaDA diffusion path ran: "
                           f"{stray}")
    del trainer
    torch.cuda.empty_cache()

    prompt = [int(x) for x in np.random.default_rng(SEED + 34).integers(
        32, 127, DIFFUSION_PROMPT)]
    seen = []
    inner = tdiff.logits_fn

    def recorder(params, lora, ids, c, **kw):
        seen.append(ids[0].clone())
        return inner(params, lora, ids, c, **kw)

    before = {name: fn.launches for name, fn in kernels.items()}
    tdiff.logits_fn = recorder
    try:
        torch.cuda.synchronize()
        t_gen = time.perf_counter()
        out = tdiff.diffusion_generate(
            model, prompt, canvas_length=DIFFUSION_CANVAS,
            steps=DIFFUSION_GEN_STEPS)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t_gen
    finally:
        tdiff.logits_fn = inner
    gen_launches = {n: fn.launches - before[n] for n, fn in kernels.items()}
    mid = cfg.mask_token_id
    after = [x.tolist() for x in seen[1:]] + [out]
    n_open = DIFFUSION_CANVAS - DIFFUSION_PROMPT
    committed = [sum(t_ != mid for t_ in c[DIFFUSION_PROMPT:]) for c in after]
    floor = [n_open * (k + 1) // DIFFUSION_GEN_STEPS
             for k in range(DIFFUSION_GEN_STEPS)]
    gen_ms = 1e3 * t_gen / DIFFUSION_GEN_STEPS
    log(f"[llada] diffusion_generate: {DIFFUSION_PROMPT}-token prompt, "
        f"canvas {DIFFUSION_CANVAS}, {DIFFUSION_GEN_STEPS} steps in "
        f"{t_gen:.2f} s ({gen_ms:.2f} ms a denoising step); committed after "
        f"each step {committed} (at least {floor}); launches "
        f"{ {n: c for n, c in gen_launches.items() if c} }")
    want_gen = DIFFUSION_GEN_STEPS * cfg.num_layers
    if out[:DIFFUSION_PROMPT] != prompt or mid in out:
        raise RuntimeError("diffusion_generate lost the prompt or left a "
                           "mask id")
    if len(seen) != DIFFUSION_GEN_STEPS or any(
            c < f for c, f in zip(committed, floor)):
        raise RuntimeError(f"the unmasking schedule fell behind: "
                           f"{committed} < {floor}")
    stray = {n: c for n, c in gen_launches.items()
             if c and n in ATTENTION_KERNELS and n != "flash_attn_fwd_full"}
    if gen_launches["flash_attn_fwd_full"] != want_gen or stray:
        raise RuntimeError(f"diffusion_generate launched "
                           f"{gen_launches['flash_attn_fwd_full']} non-causal "
                           f"K16 forwards (want {want_gen}) and {stray}")
    metrics = dict(losses=losses, step_s=statistics.median(times[1:]),
                   real_tokens_per_s=rate, peak_bytes=peak, mfu=mfu,
                   runtime_s=result.metrics["train_runtime"],
                   generate_ms_per_step=gen_ms)
    del model
    torch.cuda.empty_cache()
    return launches, gen_launches, metrics


def _profile_train_step(trainer, rows, top=25):
    """One more optimizer step of ``trainer`` (fresh AdamW state, the same
    ``rows``) under ``torch.profiler``. From the chrome trace's device
    events (cat "kernel", "gpu_memcpy", "gpu_memset") it prints the device
    time by kernel name, and the device busy share: the union of those
    events' intervals over the step's wall time (host clock, ending in a
    sync). MFU counts 4N FLOPs per real token (forward and dx through N
    matmul weights: the projections and lm_head; the NF4 base is frozen,
    so no dW) and HFU per row token 6 FLOPs per projection weight (the
    offloaded checkpointing runs each layer's forward a second time in
    backward) and 4 per lm_head weight (the full-logits CE, which both
    training shapes take on an 80 GB card, runs it once); attention FLOPs
    are left out of both. Peak: 989 TFLOP/s dense bf16."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trainer.args.max_steps = 1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train()
    wall_us = trainer.step_times[-1] * 1e6
    n_matmul, n_head = _matmul_weights(trainer.model.cfg)
    real = sum(int((b.segment_ids != 0).sum()) for b in rows)
    row_tokens = sum(int(b.segment_ids.size) for b in rows)
    wall = wall_us / 1e6
    log(f"[profile] one step, {len(rows)} micro-batches, {row_tokens} row "
        f"tokens, {real} real:")
    _device_report(prof, wall_us, top)
    hfu_flops = (6 * (n_matmul - n_head) + 4 * n_head) * row_tokens
    log(f"[profile] N = {n_matmul / 1e9:.3f}e9 matmul weights: MFU "
        f"{100 * 4 * n_matmul * real / wall / 989e12:.2f}%, HFU "
        f"{100 * hfu_flops / wall / 989e12:.2f}%")


def _device_report(prof, wall_us, top):
    """From a profile's chrome trace, the device events (cat "kernel",
    "gpu_memcpy", "gpu_memset"): the device time by kernel name and by
    kernel family, the busy share (the union of the events' intervals over
    ``wall_us``) and the device spans of the port's profiler ranges."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name = {}
    for e in dev:
        us, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (us + float(e["dur"]), n + 1)
    busy, end = 0.0, float("-inf")
    for s, f in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in dev):
        if f > end:
            busy, end = busy + f - max(s, end), f
    total = sum(us for us, _ in by_name.values())
    log(f"[profile] wall {wall_us / 1e6:.3f} s, device events "
        f"{len(dev)}, summed {total / 1e3:.1f} "
        f"ms, busy (union) {busy / 1e3:.1f} ms = {100 * busy / wall_us:.1f}% "
        f"of wall (idle {100 - 100 * busy / wall_us:.1f}%)")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                )[:top]:
        log(f"[profile] {us / 1e3:10.1f} ms {100 * us / total:5.1f}% "
            f"{n:6d}  {name[:110]}")
    # device time by kernel family (wrapper kernel names), and under the
    # port's profiler ranges (record_function: the MoE routing and
    # permutation glue, the banded attention), from their device spans
    def instances(form, *fwd_form):
        return tuple(f"flash_{w}_kernel<{d}, {form}"
                     + (f", {', '.join(fwd_form)}>" if w == "fwd" else ">")
                     for w in ("fwd", "dq", "dkv") for d in (64, 128, 256))

    families = {"K14/K15 nf4_gmm": ("nf4_gmm",), "K19 gmm": ("::gmm_kernel", "gmm_wgmma_kernel",
                                              "tgmm_kernel"),
                # K12 is K1's Hopper kernel in its e4m3 form (<BX, true>),
                # K13 K2's (<BX, true>); K14's Hopper kernel is
                # nf4_gmm_wgmma_kernel<BX>, counted above
                # (the decode kernel's NF4 policy is 0, its e4m3 ones 1
                # and 2; a parent's K1 decode tiles are nf4_matmul_kernel)
                "K1 nf4_matmul": ("nf4_matmul_kernel",
                                  "nf4_wgmma_kernel<128, false>",
                                  "nf4_wgmma_kernel<256, false>",
                                  "decode_matmul_kernel<0,"),
                # (a parent's K2, profiled by --tree, may carry no format
                # value)
                "K2 nf4_matmul_dx": ("nf4_dx_wgmma_kernel<128>",
                                     "nf4_dx_wgmma_kernel<256>",
                                     "nf4_dx_wgmma_kernel<128, false>",
                                     "nf4_dx_wgmma_kernel<256, false>"),
                "K12/K13 fp8_matmul": ("fp8_matmul_kernel",
                                       "decode_matmul_kernel<1,",
                                       "decode_matmul_kernel<2,",
                                       "nf4_wgmma_kernel<128, true>",
                                       "nf4_wgmma_kernel<256, true>",
                                       "nf4_dx_wgmma_kernel<128, true>",
                                       "nf4_dx_wgmma_kernel<256, true>"),
                # K17's forward is K16's in its kSinks form; its dq and
                # dk/dv are K16's kernels, told apart by the device spans
                # of its profiler range (below)
                "K17 flash sinks": tuple(f"flash_fwd_kernel<{d}, false, true>"
                                         for d in (64, 128, 256)),
                # K18 runs on K16's kernels, instantiated with kSplash
                "K18 splash": instances("true", "false"),
                # K9 (the packed forward) runs K16's forward: on the packed
                # path every flash_fwd_kernel<128, false, false> is K9's
                "K16 flash": instances("false", "false")
                + ("dkv_sum_kernel",),
                # K10/K11 run K18's dq and dk/dv, told apart from K18's by
                # the device spans of their profiler range (below); a
                # parent's wmma kernels by name
                "K10/K11 packed bwd": ("attn_dq_kernel", "attn_dkv_kernel"),
                "K7/K8 CE": ("ce_fwd", "ce_bwd"),
                # the backwards apart (a parent's K4 and K6 shared
                # column_sum_kernel, counted with K4)
                "K4 RMSNorm bwd": ("rms_norm_bwd", "column_sum_kernel"),
                "K3 RMSNorm": ("rms_norm_kernel",),
                "K6 LayerNorm bwd": ("layer_norm_bwd",),
                "K5 LayerNorm": ("layer_norm_kernel",
                                 "layer_norm_warp_kernel")}
    # the profiler ranges whose device spans name the family of every
    # kernel inside them: K17's and K10/K11's, which run K16's and K18's
    ranged = {"unsloth.flash_sinks": "K17 flash sinks",
              "unsloth.packed_attention_bwd": "K10/K11 packed bwd"}
    range_spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), ranged[e["name"]])
        for e in events if e.get("cat") == "gpu_user_annotation"
        and e["name"] in ranged)
    starts = [a for a, _, _ in range_spans]

    def family(e):
        i = bisect.bisect_right(starts, float(e["ts"])) - 1
        if i >= 0 and float(e["ts"]) < range_spans[i][1]:
            return range_spans[i][2]
        return next((f_ for f_, keys in families.items()
                     if any(key in e["name"] for key in keys)), None)

    fam = dict.fromkeys(families, 0.0)
    for e in dev:
        f_ = family(e)
        if f_ is not None:
            fam[f_] += float(e["dur"])
    log("[profile] by family: " + ", ".join(
        f"{f_} {us / 1e3:.1f} ms ({100 * us / total:.1f}%)"
        for f_, us in fam.items() if us))
    spans = {}
    for e in events:
        if e.get("cat") == "gpu_user_annotation":
            spans[e["name"]] = spans.get(e["name"], 0.0) + float(e["dur"])
    if spans:
        log("[profile] device spans of the port's ranges: " + ", ".join(
            f"{n} {us / 1e3:.1f} ms ({100 * us / wall_us:.1f}% of wall)"
            for n, us in sorted(spans.items(), key=lambda kv: -kv[1])
            if n.startswith("unsloth.")))


# ---------------------------------------------------------------------------
# Speech: phase 3's K5/K6, phase 4g (Whisper, 2 layers, card against CPU),
# phase 13 (Whisper-large-v3) and phase 14 (Orpheus-3B)
# ---------------------------------------------------------------------------

WHISPER_LARGE_V3_CONFIG = {
    # openai/whisper-large-v3 config.json (published values)
    "architectures": ["WhisperForConditionalGeneration"],
    "activation_function": "gelu",
    "begin_suppress_tokens": [220, 50257],
    "bos_token_id": 50257,
    "d_model": 1280,
    "decoder_attention_heads": 20,
    "decoder_ffn_dim": 5120,
    "decoder_layers": 32,
    "decoder_start_token_id": 50258,
    "encoder_attention_heads": 20,
    "encoder_ffn_dim": 5120,
    "encoder_layers": 32,
    "eos_token_id": 50257,
    "max_source_positions": 1500,
    "max_target_positions": 448,
    "model_type": "whisper",
    "num_hidden_layers": 32,
    "num_mel_bins": 128,
    "pad_token_id": 50256,
    "scale_embedding": False,
    "torch_dtype": "float16",
    "use_cache": True,
    "vocab_size": 51866,
}

ORPHEUS_3B_CONFIG = dict(
    # meta-llama/Llama-3.2-3B config.json (published values, tied
    # embedding) with Orpheus-3B's SNAC-extended vocabulary of 156,940
    LLAMA_32_1B_CONFIG, head_dim=128, hidden_size=3072,
    intermediate_size=8192, num_attention_heads=24, num_hidden_layers=28,
    num_key_value_heads=8, vocab_size=156940)

#: the recipe of phase 13 (bench_extra.py's main_whisper): batch, mel
#: frames, label tokens, optimizer steps on the repeated batch, LoRA
WHISPER_BATCH, WHISPER_FRAMES, WHISPER_LABELS = 2, 3000, 224
WHISPER_STEPS = 4
WHISPER_LORA = dict(r=32, alpha=64, targets=("q", "v"))
WHISPER_MAX_TOKENS = 32    # whisper_transcribe's id buffer in phase 13
WHISPER_GREEDY = 16        # greedy ids held card against CPU in phase 4g
ORPHEUS_ROWS = 2048        # packed row of phase 14 (main_tts)
ORPHEUS_STEPS = 3
#: phase 4g's limits in bf16 (the card against the CPU's fp32): the loss,
#: every LoRA gradient leaf together and the worst leaf, relative L2
WHISPER_BF16_LOSS_TOL, WHISPER_BF16_GRAD_TOL, WHISPER_BF16_LEAF_TOL = \
    2e-2, 5e-2, 1e-1
SPEECH_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "cross_entropy_fwd",
                  "cross_entropy_bwd")


def whisper_launches(n_enc, n_dec):
    """Launches of K5, K6 and K7/K8 that one LoRA training step (loss and
    backward) of a Whisper with ``n_enc`` + ``n_dec`` layers needs: every
    layer norm once forward (two an encoder layer, three a decoder layer,
    and each stack's final one) and once backward, except the first norm
    of each stack, whose input carries no gradient while the base is
    frozen; the full-logits CE once each way."""
    fwd = (2 * n_enc + 1) + (3 * n_dec + 1)
    return {"layer_norm_fwd": fwd, "layer_norm_bwd": fwd - 2,
            "cross_entropy_fwd": 1, "cross_entropy_bwd": 1}


def ln_out_err(dtype, out, rout):
    """The forward's part of :func:`ln_errs`: out's worst element in units
    of its limit, 1 ulp of a bf16 output or 8 fp32 ulp, each plus 2^-20
    max|out|."""
    import torch

    d = (out.float() - rout.float()).abs()
    return ulps_bf16_or_f32(
        (d - 2.0 ** -20 * rout.float().abs().max()).clamp(min=0), rout,
        dtype) / (1 if dtype == torch.bfloat16 else 8)


def ln_errs(dtype, got, want):
    """Phase 3's check of K5/K6 against their plain versions, each part's
    worst element in units of its limit (<= 1 passes), for (out, dx, dW,
    dB) and their plain counterparts (dW and dB None: the dx-only form,
    dx alone; :func:`ln_bwd_errs`).

    out: <= 1 ulp of the output dtype for bf16, <= 8 fp32 ulp for fp32 (the
    fp32 values differ in their last bits, from sums in another order and
    rsqrtf, then round), plus 2^-20 max|out|: where xhat * w and b cancel
    to near zero the ulp of the result is far below the fp32 error of the
    terms."""
    res = {"out": ln_out_err(dtype, got[0], want[0])}
    res.update(ln_bwd_errs(dtype, got[1:], want[1:]))
    return res


def ln_bwd_errs(dtype, got, want):
    """K6's part of :func:`ln_errs`, for (dx, dW, dB); dW and dB None
    (the dx-only form): dx alone. dx: <= 2^-7 |dx| in bf16 (one rounding
    of values that differ in their last fp32 bits), 2^-20 |dx| in fp32,
    plus 2^-16 (bf16) or 2^-20 (fp32) of max|dx|: its three terms cancel.
    dW, dB: fp32 sums over the rows in another order (a lane's rows, then
    a block's row groups, then the blocks' partial rows in groups) within
    2^-12 of max|ref|; a block's partial row dropped moves them by far
    more (:func:`norm_bwd_faults`)."""
    import torch

    dx, dw, db = got
    rdx, rdw, rdb = want
    bf16 = dtype == torch.bfloat16

    def scaled(d, lim):
        return (d / lim).max().item()

    r = rdx.float().abs()
    res = {"dx": scaled((dx.float() - rdx.float()).abs(),
                        (2.0 ** -7 if bf16 else 2.0 ** -20) * r
                        + (2.0 ** -16 if bf16 else 2.0 ** -20) * r.max())}
    for name, a, b in (("dW", dw, rdw), ("dB", db, rdb)):
        if a is not None:
            res[name] = ((a - b).abs().max()
                         / (2.0 ** -12 * b.abs().max())).item()
    return res


def _layer_norm_launches(dev, g, flush):
    """K6's dx-only form at the shapes of :func:`_layer_norm_kernels` (b
    does not enter K6: three inputs; from a generator of its own, so the
    later parts keep theirs):
    one call launches exactly one device operation (:func:`launched_kernels`;
    run before the parts that compile flex_attention, after which every
    trace in the process came back empty on the card). No rows."""
    import torch

    from unsloth_tpu_torch.ops.rms_norm import layer_norm_bwd

    g = torch.Generator(device=dev).manual_seed(SEED + 43)
    d = WHISPER_LARGE_V3_CONFIG["d_model"]
    enc_rows = WHISPER_BATCH * WHISPER_FRAMES // 2
    for n, dtype in ((enc_rows, torch.bfloat16), (enc_rows, torch.float32),
                     (WHISPER_BATCH * WHISPER_LABELS, torch.bfloat16)):
        x, gy = (torch.randn((n, d), generator=g, device=dev).to(dtype)
                 for _ in range(2))
        w = (1.0 + 0.1 * torch.randn((d,), generator=g, device=dev)
             ).to(dtype)
        ops = launched_kernels(lambda: layer_norm_bwd(
            x, w, gy, 1e-5, need_dw=False), tries=6)
        log(f"[kernels] layer_norm_bwd dx only [{n}, {d}] "
            f"{str(dtype)[6:]}: one call {len(ops)} device op(s): {ops}")
        if len(ops) != 1:
            raise RuntimeError(f"one layer_norm_bwd dx-only call at [{n}, "
                               f"{d}] launched {ops}, not one kernel")
    return {}


def _layer_norm_kernels(dev, g, flush):
    """K5 and K6 against their plain versions at Whisper's shapes: [3000,
    1280] (2 x 1,500 encoder frames) in bf16 and fp32, [448, 1280] (2 x
    224 decoder tokens) in bf16, and [3000, 1280] bf16 with b=None;
    tolerances as :func:`ln_errs` states them; K6 in both forms, dx alone
    (the LoRA path's) and dx with dW and dB, each as
    :func:`_norm_bwd_case` holds it (the same bits twice, dx the same in
    both, the faults rejected; one device operation a dx-only call is
    read by :func:`_layer_norm_launches`, which runs before the parts
    that compile flex_attention: traces taken after them come back
    without a device event).
    Times: the kernels (median, L2 flushed), each plain version once
    (:func:`once_ms`), and the library call ``F.layer_norm`` (its autograd
    backward for K6: dx, or dx, dW and dB). Bounds: forward 2 x bytes of x
    + w and b, 8 fp32 operations an element; backward x and g read, dx
    written, w read, dW and dB written in fp32, 14 operations an
    element."""
    import torch
    import torch.nn.functional as F

    from unsloth_tpu_torch.ops.rms_norm import (layer_norm_bwd_ref,
                                                layer_norm_fwd,
                                                layer_norm_ref)

    rows = {"layer_norm_fwd": [], "layer_norm_bwd": []}
    d = WHISPER_LARGE_V3_CONFIG["d_model"]
    enc_rows = WHISPER_BATCH * WHISPER_FRAMES // 2
    for n, dtype, bias in ((enc_rows, torch.bfloat16, True),
                           (enc_rows, torch.float32, True),
                           (WHISPER_BATCH * WHISPER_LABELS, torch.bfloat16,
                            True),
                           (enc_rows, torch.bfloat16, False)):
        x = (torch.randn((n, d), generator=g, device=dev) * 2 + 0.5
             ).to(dtype)
        w = (1.0 + 0.1 * torch.randn((d,), generator=g, device=dev)
             ).to(dtype)
        b = (0.1 * torch.randn((d,), generator=g, device=dev)).to(dtype) \
            if bias else None
        gy = torch.randn((n, d), generator=g, device=dev).to(dtype)
        out = layer_norm_fwd(x, w, b, 1e-5)
        rout, fwd_plain = once_ms(lambda: layer_norm_ref(x, w, b, 1e-5))
        plain = once_ms(lambda: layer_norm_bwd_ref(x, w, gy, 1e-5))
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"layer norm forward not finite at {n} "
                               f"{dtype}")
        out_err = ln_out_err(dtype, out, rout)
        fwd_ms = time_ms(lambda: layer_norm_fwd(x, w, b, 1e-5), flush=flush)
        lib_fwd = time_ms(lambda: F.layer_norm(x, (d,), w, b, 1e-5),
                          flush=flush)

        def lib_call(x_, w_, b=b):
            return F.layer_norm(x_, (d,), w_, b, 1e-5)

        forms, line = _norm_bwd_case("layer_norm_bwd", x, w, gy, 1e-5, plain,
                                     flush, lib_call=lib_call,
                                     count_ops=False)
        wb = nbytes(w) + (nbytes(b) if bias else 0)
        fb = bound(8 * x.numel(), 2 * nbytes(x) + wb, PEAK_FP32)
        shape = f"[{n}, {d}] {str(dtype)[6:]}" + ("" if bias else " b=None")
        rows["layer_norm_fwd"].append(dict(
            shape=shape, err=(out.float() - rout.float()).abs().max().item(),
            ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fb[0], bound_by=fb[1],
            library_ms=lib_fwd))
        for need, row in forms.items():
            rows["layer_norm_bwd"].append(dict(
                row, shape=shape + (" dx + dW" if need else " dx only")))
        log(f"[kernels] layer_norm {shape}: K5 out error {out_err:.4f} of "
            f"its limit; kernel {fwd_ms:.4f} ms plain {fwd_plain:.4f} ms "
            f"F.layer_norm {lib_fwd:.4f} ms bound {fb[0]:.4f} ms ({fb[1]}); "
            f"K6 {line}")
        if not out_err <= 1.0:
            raise RuntimeError(f"layer norm forward disagrees at {shape}: "
                               f"{out_err}")
        del x, gy, out, rout, plain
    torch.cuda.empty_cache()
    return rows


def whisper_checkpoint_entries(config):
    """(HF tensor name, shape) of every tensor of a Whisper checkpoint of
    the HF ``config`` as WhisperForConditionalGeneration saves it
    ("model." names; k_proj without a bias; the output projection tied to
    the token embedding, so not stored)."""
    d, f = config["d_model"], config["encoder_ffn_dim"]
    entries = [("model.encoder.conv1.weight", (d, config["num_mel_bins"], 3)),
               ("model.encoder.conv1.bias", (d,)),
               ("model.encoder.conv2.weight", (d, d, 3)),
               ("model.encoder.conv2.bias", (d,)),
               ("model.encoder.embed_positions.weight",
                (config["max_source_positions"], d))]

    def attn(p):
        return [(p + f"{n}_proj.weight", (d, d)) for n in ("q", "k", "v",
                                                           "out")] + [
            (p + f"{n}_proj.bias", (d,)) for n in ("q", "v", "out")]

    def block(p, norms):
        out = [(p + n + s, (d,)) for n in norms for s in (".weight", ".bias")]
        return out + [(p + "fc1.weight", (f, d)), (p + "fc1.bias", (f,)),
                      (p + "fc2.weight", (d, f)), (p + "fc2.bias", (d,))]

    for i in range(config["encoder_layers"]):
        p = f"model.encoder.layers.{i}."
        entries += attn(p + "self_attn.") + block(
            p, ("self_attn_layer_norm", "final_layer_norm"))
    entries += [("model.encoder.layer_norm.weight", (d,)),
                ("model.encoder.layer_norm.bias", (d,)),
                ("model.decoder.embed_tokens.weight",
                 (config["vocab_size"], d)),
                ("model.decoder.embed_positions.weight",
                 (config["max_target_positions"], d))]
    for i in range(config["decoder_layers"]):
        p = f"model.decoder.layers.{i}."
        entries += attn(p + "self_attn.") + attn(p + "encoder_attn.") + block(
            p, ("self_attn_layer_norm", "encoder_attn_layer_norm",
                "final_layer_norm"))
    return entries + [("model.decoder.layer_norm.weight", (d,)),
                      ("model.decoder.layer_norm.bias", (d,))]


def write_whisper_checkpoint(path, config):
    """Random-init bf16 Whisper checkpoint of ``config`` at its published
    shapes: config.json plus index-sharded safetensors, one tensor at a
    time. Each tensor comes from a generator on DEVICE seeded by the seed
    and its index: N(0, 0.02), layer norm weights 1 + N(0, 0.1) and their
    biases N(0, 0.1), so that K5's weight and bias matter."""
    import torch

    from unsloth_tpu_torch.io_safetensors import save_sharded

    entries = whisper_checkpoint_entries(config)
    index = {n: i for i, (n, _) in enumerate(entries)}
    shapes = dict(entries)

    def produce(name):
        g = torch.Generator(device=DEVICE).manual_seed(SEED * 1000
                                                       + index[name])
        w = torch.randn(shapes[name], generator=g, device=DEVICE)
        if "layer_norm" in name:
            w = w * 0.1 + (1.0 if name.endswith(".weight") else 0.0)
        else:
            w = w * 0.02
        return w.to(torch.bfloat16).cpu()

    os.makedirs(path, exist_ok=True)
    save_sharded(path, [(n, torch.bfloat16, s) for n, s in entries], produce)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(config, fh, indent=2)
    return path


def _whisper_inputs(cfg, dev, batch, labels, seed):
    """(features [batch, mel bins, 3000] fp32 from the port's log-mel of
    seeded 2-s waveforms, decoder ids [batch, labels], label ids shifted
    by one with the last tenth of row 0 ignored), on ``dev``; the
    waveforms and ids from numpy."""
    import numpy as np
    import torch

    from unsloth_tpu_torch.models.whisper import log_mel_spectrogram

    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((batch, 32000)) * 0.1).astype(np.float32)
    feats = log_mel_spectrogram(torch.from_numpy(audio).to(dev),
                                n_mels=cfg.num_mel_bins)
    ids = rng.integers(0, cfg.eos_token_id, (batch, labels + 1))
    lab = ids[:, 1:].copy()
    lab[0, -labels // 10:] = -100
    return (feats, torch.from_numpy(ids[:, :-1].astype(np.int32)).to(dev),
            torch.from_numpy(lab.astype(np.int32)).to(dev))


def _whisper_lora(cfg, dev, seed):
    """Phase 4g's adapters: init_whisper_lora (r 32, alpha 64, q/v) from a
    CPU generator, B drawn N(0, 0.02) so that every leaf has a gradient."""
    import torch

    from unsloth_tpu_torch.models.whisper import (init_whisper_lora,
                                                  whisper_lora_leaves)

    gen = torch.Generator().manual_seed(seed)
    lora = init_whisper_lora(cfg, gen, **WHISPER_LORA)
    for t in whisper_lora_leaves(lora)[1::2]:
        t.copy_(torch.randn(t.shape, generator=gen) * 0.02)
    return lora


def _whisper_loss_grads(params, cfg, lora, feats, ids, labels):
    """(loss, [each LoRA leaf's gradient]) of whisper_loss, on the
    params' device; the gradients as fp32 CPU tensors."""
    from unsloth_tpu_torch.models.whisper import (whisper_lora_leaves,
                                                  whisper_loss)

    leaves = whisper_lora_leaves(lora)
    for t in leaves:
        t.requires_grad_(True)
    loss = whisper_loss(params, feats, ids, labels, cfg, lora=lora)
    loss.backward()
    grads = [t.grad.float().cpu() for t in leaves]
    for t in leaves:
        t.grad = None
        t.requires_grad_(False)
    return float(loss.detach()), grads


def phase_whisper_parity(tmp, seed=SEED + 21):
    """Whisper-large-v3 at full width cut to 2 encoder and 2 decoder layers
    (a random bf16 checkpoint, :func:`write_whisper_checkpoint`, loaded by
    load_whisper), LoRA r 32 on q/v with a random B: whisper_loss and every
    LoRA gradient of a [2, 128, 3000] log-mel batch and 32 decoder tokens,
    on the card (K5/K6 and K7/K8) against the CPU (plain versions), both
    in fp32 (TF32 off): loss within 1e-4 relative, each leaf within 1e-3
    relative L2 (fp32 sums in other orders through 2 + 2 layers); then
    the card in bf16 (weights and activations; fp32 LoRA, softmax and
    statistics) against the CPU's fp32, within WHISPER_BF16_*_TOL; and
    whisper_greedy_decode's ids over WHISPER_GREEDY tokens in fp32, equal
    (argmax ties of random weights flip in bf16, not in fp32). The launches
    of one loss and backward must be what :func:`whisper_launches`
    predicts for 2 + 2 layers."""
    import torch

    from unsloth_tpu_torch.models.params import tree_to
    from unsloth_tpu_torch.models.whisper import (load_whisper,
                                                  whisper_greedy_decode)

    hf = dict(WHISPER_LARGE_V3_CONFIG, encoder_layers=2, decoder_layers=2,
              num_hidden_layers=2)
    path = write_whisper_checkpoint(os.path.join(tmp, "whisper_2layer"), hf)
    cpu, cfg = load_whisper(path, dtype=torch.float32, device="cpu")
    card, _ = load_whisper(path, dtype=torch.float32, device=DEVICE)
    shutil.rmtree(path)
    lora = _whisper_lora(cfg, "cpu", seed)
    lora_card = tree_to(lora, DEVICE)
    feats, ids, labels = _whisper_inputs(cfg, "cpu", 2, 32, seed)
    on_card = [t.to(DEVICE) for t in (feats, ids, labels)]
    t0 = time.perf_counter()
    loss_cpu, g_cpu = _whisper_loss_grads(cpu, cfg, lora, feats, ids, labels)
    t_cpu = time.perf_counter() - t0
    kernels = _kernel_fns()
    for fn in kernels.values():
        fn.launches = 0
    loss_card, g_card = _whisper_loss_grads(card, cfg, lora_card, *on_card)
    launches = {n: kernels[n].launches for n in SPEECH_KERNELS}
    want = whisper_launches(2, 2)
    rel_loss = abs(loss_card - loss_cpu) / abs(loss_cpu)
    leaf = max(_rel(a, b) for a, b in zip(g_card, g_cpu))
    log(f"[whisper parity] 2 + 2 layers fp32, B=2, 3000 frames, 32 tokens: "
        f"loss card {loss_card:.6f} cpu {loss_cpu:.6f} (rel {rel_loss:.2e}, "
        f"tol 1e-4); LoRA grads rel L2 worst leaf {leaf:.2e} (tol 1e-3) of "
        f"{len(g_cpu)}; launches {launches} (expected {want}); cpu "
        f"{t_cpu:.1f} s")
    if launches != want:
        raise RuntimeError(f"whisper parity launches {launches} != {want}")
    if not (rel_loss <= 1e-4 and leaf <= 1e-3):
        raise RuntimeError("whisper fp32 card and CPU disagree")
    ids_card = whisper_greedy_decode(card, on_card[0], cfg,
                                     max_tokens=WHISPER_GREEDY + 1,
                                     lora=lora_card).cpu()
    ids_cpu = whisper_greedy_decode(cpu, feats, cfg,
                                    max_tokens=WHISPER_GREEDY + 1, lora=lora)
    log(f"[whisper parity] greedy ids fp32, {WHISPER_GREEDY} tokens: card "
        f"{ids_card[:, 1:].tolist()} cpu {ids_cpu[:, 1:].tolist()}")
    if not torch.equal(ids_card, ids_cpu):
        raise RuntimeError("whisper greedy ids differ between card and CPU")
    # bf16 on the card: the same weights rounded, fp32 adapters
    card_bf16 = _cast_tree(card, torch.bfloat16)
    del card
    loss_b, g_b = _whisper_loss_grads(card_bf16, cfg, lora_card, *on_card)
    rel_b = abs(loss_b - loss_cpu) / abs(loss_cpu)
    tog_b = _rel(torch.cat([a.ravel() for a in g_b]),
                 torch.cat([b.ravel() for b in g_cpu]))
    leaf_b = max(_rel(a, b) for a, b in zip(g_b, g_cpu))
    log(f"[whisper parity] bf16 on the card against fp32 on the CPU: loss "
        f"rel {rel_b:.2e} (tol {WHISPER_BF16_LOSS_TOL}); LoRA grads rel L2 "
        f"together {tog_b:.2e} (tol {WHISPER_BF16_GRAD_TOL}), worst leaf "
        f"{leaf_b:.2e} (tol {WHISPER_BF16_LEAF_TOL})")
    if not (rel_b <= WHISPER_BF16_LOSS_TOL and tog_b <= WHISPER_BF16_GRAD_TOL
            and leaf_b <= WHISPER_BF16_LEAF_TOL):
        raise RuntimeError("whisper bf16 card and fp32 CPU disagree")
    del card_bf16, lora_card, on_card
    torch.cuda.empty_cache()
    return dict(launches=launches, loss_rel=rel_loss, grad_leaf=leaf,
                bf16=(rel_b, tog_b, leaf_b))


def _cast_tree(tree, dtype):
    """A Whisper param tree with every tensor in ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return None if tree is None else tree.to(dtype)


def phase_whisper(tmp, profile=False):
    """Whisper-large-v3 at full width and depth, by the recipe of
    bench_extra.py's main_whisper: a random bf16 checkpoint of its
    published config (:func:`write_whisper_checkpoint`, 32 + 32 layers,
    d 1,280, 20 heads, 128 mel bins, vocabulary 51,866) loaded by
    from_pretrained(dtype=bf16). First whisper_transcribe of a seeded 2-s
    waveform with an id buffer of WHISPER_MAX_TOKENS: the encoder's time,
    the time of a decode step (the whole decoder over the buffer, no KV
    cache), the ids; launches K5 once for each of the encoder's 65 norms
    and the decoder's 97 a step, K6-K8 none. Then WhisperTrainer with fp32
    LoRA r 32, alpha 64 on q/v, batch 2 of {"features": the port's
    128-bin log-mel of seeded waveforms, "labels": 224 token ids}, lr 1e-4
    constant, WHISPER_STEPS steps on the repeated batch: losses finite and
    falling, step time, decoder tokens/s, peak memory, and launches per
    step exactly :func:`whisper_launches` (K5 162, K6 160, K7/K8 1). With ``profile``, one more
    step runs under the profiler (:func:`_profile_whisper_step`) and the
    phase ends there."""
    import numpy as np
    import torch

    from unsloth_tpu_torch import FastLanguageModel, SFTConfig
    from unsloth_tpu_torch.models.whisper import (WhisperConfig,
                                                  init_whisper_lora,
                                                  log_mel_spectrogram,
                                                  whisper_encode,
                                                  whisper_lora_leaves,
                                                  whisper_transcribe)
    from unsloth_tpu_torch.trainer.whisper import WhisperTrainer

    kernels = _kernel_fns()
    path = os.path.join(tmp, "whisper_large_v3")
    t0 = time.perf_counter()
    write_whisper_checkpoint(path, WHISPER_LARGE_V3_CONFIG)
    size = sum(os.path.getsize(os.path.join(path, n))
               for n in os.listdir(path))
    t_write = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (params, cfg), tok = FastLanguageModel.from_pretrained(
        path, dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.synchronize()
    log(f"[whisper] wrote {size / 1e9:.2f} GB in {t_write:.1f} s; "
        f"from_pretrained(dtype=bf16) in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; tokenizer "
        f"{tok}")
    if cfg != WhisperConfig.from_hf(WHISPER_LARGE_V3_CONFIG):
        raise RuntimeError(f"unexpected config {cfg}")
    rng = np.random.default_rng(SEED + 22)
    audio = (rng.standard_normal(32000) * 0.1).astype(np.float32)
    feats = log_mel_spectrogram(torch.from_numpy(audio).to(DEVICE)[None],
                                n_mels=cfg.num_mel_bins)
    with torch.no_grad():
        whisper_encode(params, feats, cfg)       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whisper_encode(params, feats, cfg)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    ids = whisper_transcribe(params, cfg, audio, max_tokens=WHISPER_MAX_TOKENS)
    torch.cuda.synchronize()
    t_tr = time.perf_counter() - t0
    tr_launches = {n: kernels[n].launches for n in SPEECH_KERNELS}
    enc_norms = 2 * cfg.encoder_layers + 1
    dec_norms = 3 * cfg.decoder_layers + 1
    steps = (tr_launches["layer_norm_fwd"] - enc_norms) / dec_norms
    log(f"[whisper] transcribe 2 s: {t_tr:.3f} s; encoder {1e3 * enc_s:.1f} "
        f"ms; {steps:g} decode steps, {1e3 * (t_tr - enc_s) / steps:.1f} ms a "
        f"step (the whole decoder over {WHISPER_MAX_TOKENS} slots); ids "
        f"{ids}; launches {tr_launches}")
    if (len(ids) != 1 or steps != int(steps) or not 1 <= steps
            <= WHISPER_MAX_TOKENS - 1 or any(tr_launches[n] for n in
                                            SPEECH_KERNELS[1:])
            or not all(0 <= t_ < cfg.vocab_size for t_ in ids[0])):
        raise RuntimeError(f"whisper_transcribe went wrong: {ids} "
                           f"{tr_launches}")
    # training
    train = []
    for i in range(WHISPER_BATCH):
        wav = (rng.standard_normal(32000) * 0.1).astype(np.float32)
        f = log_mel_spectrogram(torch.from_numpy(wav).to(DEVICE)[None],
                                n_mels=cfg.num_mel_bins)[0]
        train.append({"features": f.cpu().numpy(), "labels": rng.integers(
            0, cfg.eos_token_id, WHISPER_LABELS).tolist()})
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    lora = init_whisper_lora(cfg, gen, **WHISPER_LORA)
    args = SFTConfig(output_dir=os.path.join(tmp, "whisper_out"),
                     per_device_train_batch_size=WHISPER_BATCH,
                     max_steps=WHISPER_STEPS, learning_rate=1e-4,
                     lr_scheduler_type="constant", warmup_steps=0,
                     max_seq_length=cfg.max_target_positions, logging_steps=1)
    trainer = WhisperTrainer((params, cfg), train_dataset=train, args=args,
                             lora=lora)
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    trainer.train()
    peak = torch.cuda.max_memory_allocated()
    launches = {name: fn.launches for name, fn in kernels.items()}
    losses = [e["loss"] for e in trainer.state_log]
    times = trainer.step_times
    step_s = statistics.median(times[1:])
    tokens = WHISPER_BATCH * WHISPER_LABELS
    per_step = whisper_launches(cfg.encoder_layers, cfg.decoder_layers)
    log(f"[whisper] LoRA r={WHISPER_LORA['r']} on q/v, batch "
        f"{WHISPER_BATCH} x {WHISPER_FRAMES} frames, {WHISPER_LABELS} "
        f"labels: losses {[round(x, 4) for x in losses]}; step times (s) "
        f"{[round(x, 3) for x in times]}; steady step {step_s:.3f} s = "
        f"{tokens / step_s:.1f} decoder tokens/s; peak memory allocated "
        f"{peak / 1e9:.2f} GB; launches per step "
        f"{ {n: launches[n] / len(times) for n in per_step} } (expected "
        f"{per_step})")
    if len(losses) != WHISPER_STEPS or not all(np.isfinite(losses)):
        raise RuntimeError(f"whisper losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"whisper loss did not fall: {losses}")
    _check_launched(launches, SPEECH_KERNELS, "whisper training", per_step,
                    len(times))
    if profile:
        _profile_whisper_step(trainer)
        return launches, tr_launches, None
    if not all(bool(torch.isfinite(t).all())
               for t in whisper_lora_leaves(trainer.lora)):
        raise RuntimeError("trained whisper LoRA is not finite")
    del trainer, lora, params
    shutil.rmtree(path)
    torch.cuda.empty_cache()
    return launches, tr_launches, dict(
        losses=losses, step_s=step_s, decoder_tokens_per_s=tokens / step_s,
        peak_bytes=peak, encoder_s=enc_s, transcribe_s=t_tr,
        decode_steps=steps, ids=ids)


def _profile_whisper_step(trainer, top=25):
    """One more WhisperTrainer step (a fresh optimizer, the same batch)
    under ``torch.profiler``: the device time by kernel and by family, the
    busy share (:func:`_device_report`)."""
    from torch.profiler import ProfilerActivity, profile

    trainer.args.max_steps = 1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train()
    log(f"[profile] one Whisper LoRA step, batch {WHISPER_BATCH} x "
        f"{WHISPER_FRAMES} frames, {WHISPER_LABELS} labels:")
    _device_report(prof, trainer.step_times[-1] * 1e6, top)


def _orpheus_rows(rng, n_tokens):
    """Orpheus training examples of about ``n_tokens`` tokens: byte text
    of 20-200 printable characters and seeded SNAC code lists of 40-250
    frames (4,096 codes a layer; 7 tokens a frame), through the port's
    prepare_tts_dataset."""
    from unsloth_tpu_torch.data.tts import prepare_tts_dataset

    ds, total = [], 0
    while total < n_tokens:
        n = int(rng.integers(40, 251))
        text = bytes(rng.integers(32, 127, int(rng.integers(20, 201)))
                     .astype("uint8")).decode()
        ds.append({"text": text, "source": "tara", "snac_codes": [
            rng.integers(0, 4096, k * n).tolist() for k in (1, 2, 4)]})
        total += 7 * n + len(text) + 16
    return prepare_tts_dataset(ds, ByteTokenizer())


def orpheus_launches(n_layers, full_logits):
    """Launches of the packed path's kernels that one step of phase 14
    needs (one packed row, accumulation 1) on a Llama decoder of
    ``n_layers`` layers: the offloaded remat runs every layer's forward
    twice (K1 on its seven projections, K3 on its two norms, K9), the
    final norm once; the backward runs K2 on each projection but the first
    layer's q/k/v, whose input (the frozen embedding) needs no gradient,
    K4 on every norm but the first layer's input norm, for the same
    reason (2 x n_layers), and K10/K11 (one wrapper) once a layer;
    K7/K8 once each where fused_ce="auto" takes the full logits, never
    where it takes the chunked CE."""
    ce = int(full_logits)
    return {"nf4_matmul": 2 * 7 * n_layers, "nf4_matmul_dx": 7 * n_layers - 3,
            "rms_norm": 2 * 2 * n_layers + 1, "rms_norm_bwd": 2 * n_layers,
            "packed_attn_fwd": 2 * n_layers, "packed_attn_bwd": n_layers,
            "cross_entropy_fwd": ce, "cross_entropy_bwd": ce}


def phase_orpheus(tmp):
    """Orpheus-3B QLoRA SFT by the recipe of bench_extra.py's main_tts: a
    random bf16 checkpoint of the Llama-3.2-3B backbone with the
    vocabulary of 156,940 (28 layers, hidden 3,072, 24/8 heads of 128,
    llama3 rope, tied embedding), from_pretrained(load_in_4bit=True),
    get_peft_model(r=64, alpha 64, seven projections, "unsloth"),
    SFTTrainer packing prepare_tts_dataset's rows into 2,048-token rows,
    batch 1, ORPHEUS_STEPS steps: losses finite, the LoRA moved; step
    time, real tokens/s, peak memory, the CE route fused_ce="auto" took
    (K7/K8 launched: the full logits), and each kernel of the packed path
    launched exactly as often a step as :func:`orpheus_launches`
    predicts."""
    import numpy as np
    import torch

    from unsloth_tpu_torch import FastLanguageModel, SFTConfig, SFTTrainer
    from unsloth_tpu_torch.models.decoder import fused_ce_gate, tree_bytes

    kernels = _kernel_fns()
    path = _write_model(os.path.join(tmp, "orpheus_3b"), ORPHEUS_3B_CONFIG)
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, _ = FastLanguageModel.from_pretrained(
        path, max_seq_length=ORPHEUS_ROWS, load_in_4bit=True,
        dtype=torch.bfloat16, device=DEVICE)
    model = FastLanguageModel.get_peft_model(
        model, r=64, lora_alpha=64,
        target_modules=["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                        "up_proj", "down_proj"],
        use_gradient_checkpointing="unsloth").for_training()
    torch.cuda.synchronize()
    log(f"[orpheus] from_pretrained(load_in_4bit=True) + get_peft_model(r=64)"
        f" in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    rows = _orpheus_rows(np.random.default_rng(SEED + 24),
                         ORPHEUS_STEPS * ORPHEUS_ROWS - 300)
    trainer = SFTTrainer(model, tokenizer=ByteTokenizer(), train_dataset=rows,
                         args=SFTConfig(
                             output_dir=os.path.join(tmp, "orpheus_out"),
                             max_seq_length=ORPHEUS_ROWS,
                             per_device_train_batch_size=1,
                             gradient_accumulation_steps=1,
                             max_steps=ORPHEUS_STEPS, learning_rate=2e-4,
                             warmup_steps=0, logging_steps=1))
    batches = trainer.prepare_batches()
    real = [int((b.segment_ids != 0).sum()) for b in batches]
    full = not fused_ce_gate(ORPHEUS_ROWS - 1, model.cfg.vocab_size,
                             tree_bytes(model.params), model.cfg.num_layers,
                             model.cfg.hidden_size,
                             torch.cuda.get_device_properties(0).total_memory)
    log(f"[orpheus] {len(rows)} examples of {min(len(r['input_ids']) for r in rows)}"
        f"-{max(len(r['input_ids']) for r in rows)} tokens packed into "
        f"{len(batches)} rows of {ORPHEUS_ROWS} (real tokens {real}); "
        f"fused_ce='auto' takes the {'full logits (K7/K8)' if full else 'chunked fused CE'}")
    before = [t.clone() for _, t in _lora_leaves(model.lora)][:4]
    trainer.train()
    peak = torch.cuda.max_memory_allocated()
    launches = {name: fn.launches for name, fn in kernels.items()}
    losses = [e["loss"] for e in trainer.state_log]
    times = trainer.step_times
    step_s = statistics.median(times[1:])
    # the trainer's row order for epoch 0 (SFTTrainer.train, accumulation 1)
    order = list(range(len(batches)))
    np.random.RandomState(trainer.args.seed).shuffle(order)
    tok_s = sum(real[i] for i in order[1:len(times)]) / sum(times[1:])
    moved = max((t - b).abs().max().item() for (_, t), b in
                zip(_lora_leaves(model.lora)[:4], before))
    log(f"[orpheus] losses {[round(x, 4) for x in losses]}; step times (s) "
        f"{[round(x, 3) for x in times]}; steady step {step_s:.3f} s; "
        f"{tok_s:.1f} real tokens/s over steps 2-{len(times)}; peak memory "
        f"allocated "
        f"{peak / 1e9:.2f} GB; LoRA moved by up to {moved:.3e}; launches "
        f"{ {n: c for n, c in launches.items() if c} }")
    if len(losses) != ORPHEUS_STEPS or not all(np.isfinite(losses)):
        raise RuntimeError(f"orpheus losses not finite: {losses}")
    if not moved > 0:
        raise RuntimeError("orpheus training did not move the LoRA")
    expect = orpheus_launches(model.cfg.num_layers, full)
    log(f"[orpheus] launches per step "
        f"{ {n: launches[n] / len(times) for n in expect} } (expected "
        f"{expect})")
    _check_launched(launches, [n for n, k in expect.items() if k],
                    "orpheus training", expect, len(times))
    _check_absent(launches, PACKED_ABSENT, "orpheus training")
    del trainer, model
    shutil.rmtree(path)
    torch.cuda.empty_cache()
    return launches, dict(losses=losses, step_s=step_s, real_tokens_per_s=tok_s,
                          peak_bytes=peak, full_logits=full)


# ---------------------------------------------------------------------------
# FP8: phase 3's K12/K13, phase 4h (2 layers, card against CPU) and phase 15
# (LoRA SFT and generate over a block-FP8 Llama-3.1-8B)
# ---------------------------------------------------------------------------

FP8_BLOCK = 128            # quantize_fp8_block's block on the path
FP8_STEPS = 3              # optimizer steps of phase 15
FP8_DECODE_ROWS = (1, 4, 16)  # K12's decode kernel in phase 3
#: and its ragged case: (name, N, K, block, M)
FP8_DECODE_RAGGED = ("ragged", 1000, 1404, 32, 4)
#: phase 3's ragged case: (name, N, K, block, M); K % 16 and K % 8 are not
#: 0, so every load and store of the kernels takes its masked path
FP8_RAGGED = ("ragged", 1000, 1404, 32, 333)
#: K12/K13's check: every element within MM_ULPS bf16 ulps of its plain
#: value, the ulp taken of max(|ref|, 2^-4 rms(ref)) (see mm_ulps)
MM_ULPS = 1
FP8_PROJECTIONS = ("q", "k", "v", "o", "gate", "up", "down")
#: the kernels the FP8 path must launch, and those it must not
FP8_KERNELS = ("fp8_matmul_fwd", "fp8_matmul_dx", "rms_norm", "rms_norm_bwd",
               "cross_entropy_fwd", "cross_entropy_bwd", "flash_attn_fwd",
               "flash_attn_dq", "flash_attn_dkv")
FP8_ABSENT = ("nf4_matmul", "nf4_matmul_dx", "packed_attn_fwd",
              "packed_attn_bwd", "splash_attn_fwd", "splash_attn_dq",
              "splash_attn_dkv")


def mm_ulps(got, ref) -> float:
    """Worst |got - ref| in bf16 ulps of max(|ref|, 2^-4 rms(ref)). K12/K13
    and their plain versions round the same bf16 weights, sum the same
    products in fp32 in other orders (a difference near 1e-6 of the rms at
    these depths) and round once to bf16: one ulp apart where the fp32
    sums straddle a rounding point. The floor keeps the outputs that cancel
    to near zero, whose own ulp is far below that fp32 difference, from
    deciding the check."""
    import torch

    r = ref.float()
    floor = 2.0 ** -4 * r.square().mean().sqrt()
    return ulps_bf16_or_f32(got.float() - r, torch.maximum(r.abs(), floor),
                            torch.bfloat16)


def fp8_weight(n, k, g, dev, block=FP8_BLOCK):
    """A bf16 [n, k] weight: randn * 0.02 times 2^u per block x block tile,
    u uniform in [-2, 2], so that the tiles' scales differ, as a
    checkpoint's do, and a kernel that reads the wrong scale shows."""
    import torch

    nb, kb = -(-n // block), -(-k // block)
    f = torch.exp2(torch.rand((nb, kb), generator=g, device=dev) * 4 - 2)
    f = f.repeat_interleave(block, 0).repeat_interleave(block, 1)[:n, :k]
    return (torch.randn((n, k), generator=g, device=dev) * 0.02 * f).to(
        torch.bfloat16)


def fp8_faults(q, dx):
    """FP8 weights as a wrong K12 (``dx`` False) or K13 would read ``q``:
    each block of the contraction (in-blocks for K12, out-blocks for K13)
    with its neighbour's scale, the scales ignored (all 1), the last block
    of the contraction dropped, and for K13 each block of its output
    columns with its neighbour's scale (the two faults of K13's walk's twin,
    ``fp8_matmul_dx_tiles_ref(scale_shift=...)``, are a neighbouring scale
    row and column) and the scale grid read as if it were stored [in/B,
    out/B]."""
    import dataclasses

    import torch

    axis = 0 if dx else 1
    faults = {"neighbouring k-block's scale": dataclasses.replace(
        q, scales=torch.roll(q.scales, 1, dims=axis)),
        "scales ignored": dataclasses.replace(
            q, scales=torch.ones_like(q.scales))}
    if dx:
        faults["neighbouring column block's scale"] = dataclasses.replace(
            q, scales=torch.roll(q.scales, 1, dims=1))
    v = q.values.clone()
    last = (q.shape[axis] - 1) // q.block * q.block
    if dx:
        v.view(torch.uint8)[last:] = 0
    else:
        v.view(torch.uint8)[:, last:] = 0
    faults["last k-block dropped"] = dataclasses.replace(q, values=v)
    if dx:
        nb_o, nb_i = q.scales.shape
        faults["scale grid read untransposed"] = dataclasses.replace(
            q, scales=q.scales.reshape(nb_i, nb_o).t().contiguous())
    return faults


def _fp8_kernels(dev, g, flush):
    """K12 and K13 against their plain versions (fp8_matmul_ref,
    fp8_matmul_dx_ref) at the FP8 path's shapes: Llama-3.1-8B's four
    projection shapes at M = 4,096 (2 x 2,048: phase 15's micro-batch) and
    both at FP8_RAGGED (block 32); K12's decode rows are
    :func:`_decode_kernels`'. Weights from :func:`fp8_weight`, quantized at
    block 128. Tolerance: :func:`mm_ulps` <= MM_ULPS; each fault of
    :func:`fp8_faults` must exceed it, run through the kernel itself (its
    Hopper form where ``fp8_wgmma_form`` / ``fp8_dx_wgmma_form`` holds: the
    faulty scales and bytes are what a kernel reading the wrong ones would
    see). Where a Hopper form runs, its tile counters (output tiles,
    stages) must equal its schedule: K12's K1's (``fp8_tile_schedule``),
    K13's K2's with 128-column tiles (``fp8_dx_tile_schedule``). Times: the kernel's median, the plain version's one call (once_ms),
    the labelled yardstick dequantize_fp8 + torch.matmul (two calls: no
    single PyTorch call computes the function), the bound."""
    import torch

    from unsloth_tpu_torch.ops.fp8 import fp8_matmul_ref, quantize_fp8_block
    from unsloth_tpu_torch.ops.fp8_matmul import (DX_STAGE_ROWS, STAGE_BYTES,
                                                  fp8_dx_tile_schedule,
                                                  fp8_dx_wgmma_form,
                                                  fp8_matmul_dx,
                                                  fp8_matmul_dx_ref,
                                                  fp8_matmul_fwd,
                                                  fp8_tile_schedule,
                                                  fp8_wgmma_form)

    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    cases = [(name, n, k, FP8_BLOCK, 2 * UNPACKED_ROWS, True)
             for name, n, k in PROJ_SHAPES]
    name, n, k, block, m = FP8_RAGGED
    cases.append((name, n, k, block, m, True))
    rows = {"fp8_matmul_fwd": [], "fp8_matmul_dx": []}
    library = "dequantize_fp8 + torch.matmul (two calls)"
    for name, n, k, block, m, with_dx in cases:
        q = quantize_fp8_block(fp8_weight(n, k, g, dev, block), block)
        for kname, dx in [("fp8_matmul_fwd", False)] + (
                [("fp8_matmul_dx", True)] if with_dx else []):
            a = torch.randn((m, n if dx else k), generator=g,
                            device=dev).to(torch.bfloat16)
            kernel = fp8_matmul_dx if dx else fp8_matmul_fwd
            plain = fp8_matmul_dx_ref if dx else fp8_matmul_ref
            counts.zero_()
            got = kernel(a, q, tile_counts=counts)
            ref, plain_ms = once_ms(lambda: plain(a, q))
            torch.cuda.synchronize()
            ulps = mm_ulps(got, ref)
            err = (got.float() - ref.float()).abs().max().item()
            got_c, want_c = counts.tolist(), [0, 0]
            ptrs = (a.data_ptr(), q.values.data_ptr(), got.data_ptr())
            if dx and fp8_dx_wgmma_form(m, n, k, block, *ptrs):
                tiles = sum(map(len, fp8_dx_tile_schedule(m, k)))
                want_c = [tiles, tiles * -(-n // DX_STAGE_ROWS)]
            elif not dx and fp8_wgmma_form(m, k, block, *ptrs):
                tiles = sum(map(len, fp8_tile_schedule(m, n)))
                want_c = [tiles, tiles * -(-k // STAGE_BYTES)]
            faults = {f_: mm_ulps(kernel(a, fq), ref)
                      for f_, fq in fp8_faults(q, dx).items()}
            ms = time_ms(lambda: kernel(a, q), flush=flush)
            lib_ms = time_ms(lambda: plain(a, q), runs=10, flush=flush)
            b_ms, b_by = bound(2 * m * n * k,
                               nbytes(a) + q.nbytes + m * (k if dx else n) * 2)
            shape = f"{name} M={m} N={n} K={k} block {block}"
            rows[kname].append(dict(
                shape=shape, err=err, ulps=ulps, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                library=library, tile_counts=got_c))
            log(f"[kernels] {kname} {shape}: max|d|={err:.3e} "
                f"({ulps:.2f} ulp, limit {MM_ULPS}); faults "
                + ", ".join(f"{f_} {u:.1f} ulp" for f_, u in faults.items())
                + f"; kernel {ms:.4f} ms plain {plain_ms:.4f} ms {library} "
                f"{lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}, "
                f"{100 * b_ms / ms:.1f}% of it); tiles, stages {got_c} "
                f"(schedule {want_c})")
            if not (bool(torch.isfinite(got).all()) and ulps <= MM_ULPS):
                raise RuntimeError(f"{kname} disagrees at {shape}: {ulps} "
                                   "ulp")
            if got_c != want_c:
                raise RuntimeError(f"{kname} at {shape}: the kernel counted "
                                   f"{got_c} (tiles, stages), its schedule "
                                   f"{want_c}")
            missed = [f_ for f_, u in faults.items() if not u > MM_ULPS]
            if missed:
                raise RuntimeError(f"the {kname} check lets faults through "
                                   f"at {shape}: {missed}")
            del a, got, ref
        del q
        torch.cuda.empty_cache()
    return rows


def nf4_decode_faults(q, plan):
    """NF4 weights as a wrong decode kernel would read ``q`` (each run
    through the kernel itself, with the absmax passed as plain fp32 where
    the fault is in the absmax): (a) every low-side chunk with the absmax
    of its high-side chunk; (b) the middle K slice of ``plan``
    (``decode_schedule``) dropped, its blocks' absmax zero; (c) each
    double-quant group's codes with the next group's scale."""
    import dataclasses

    import torch

    from unsloth_tpu_torch.ops.nf4 import _decode_absmax

    n, k = q.shape
    half, per_row = k // 2, k // 64
    am = _decode_absmax(q).float().reshape(n, per_row)

    def plain(a):
        return dataclasses.replace(q, absmax=a.reshape(-1).contiguous(),
                                   absmax_scale=None, absmax_offset=None)

    low_high = am.clone()
    j0 = torch.arange(0, half, 16, device=am.device)
    low_high[:, (half + j0) // 64] = am[:, j0 // 64]
    dropped = am.clone()
    sl = plan.slices // 2
    st0 = sl * plan.slice_steps
    st1 = min(st0 + plan.slice_steps, plan.steps)
    dropped[:, st0:st1] = 0.0
    dropped[:, half // 64 + st0:min(half // 64 + st1 + 1, per_row)] = 0.0
    return {"low side with the high side's absmax": plain(low_high),
            f"K slice {sl} of {plan.slices} dropped": plain(dropped),
            "the next double-quant group's scale": dataclasses.replace(
                q, absmax_scale=torch.roll(q.absmax_scale, -1))}


def launched_kernels(fn, tries=3):
    """The names of the CUDA kernels one call of ``fn`` launches, from
    ``torch.profiler``. A trace that recorded no device event at all is
    not a reading (the card's CUPTI tracing drops one now and then: a call
    whose output was right came back with none) and is taken again, up
    to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


def decode_twin_within(got, want, product=None, rare=1e-3) -> bool:
    """The grouped decode kernel's tolerance against its walk's twin (or
    the twin's against JAX): every output within one bf16 ulp of ``want``
    plus 2^-20 of its largest (the same bf16 weights summed in fp32 in
    other orders, one rounding). Where a bias is added to a ``product``
    rounded first (K19: ``want`` without its bias), one ulp of that product
    more (two sums in other orders may round it an ulp apart, which the
    bias carries whole into an output it cancels to a fraction of the
    product), and at most a ``rare`` share of the outputs past two ulps of
    their own: such a flip needs a product within a rounding error of a
    bf16 midpoint, while the bias added before the rounding misses that far
    wherever it cancels much of the product."""
    import numpy as np

    def arr(t):
        return t.float().cpu().numpy() if hasattr(t, "float") else \
            np.asarray(t, dtype=np.float32)

    got, want = arr(got), arr(want)
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16
    d = np.abs(got - want) - 2.0 ** -20 * np.abs(want).max()
    if product is None:
        return bool(np.all(d <= ulp))
    p = arr(product)
    ulp_p = np.spacing(np.abs(p).astype(np.float32)) * 2.0 ** 16
    return bool(np.all(d <= ulp + ulp_p)) and \
        float(np.mean(d > 2 * ulp)) <= rare


def _bf16_ulps(got, ref) -> float:
    """Worst |got - ref| in bf16 ulps of |ref| (the ulp of 2^-126 and up)."""
    import torch

    r = ref.float()
    return ulps_bf16_or_f32(got.float() - r, r.abs(), torch.bfloat16)


def _decode_kernels(dev, g, flush):
    """K1's and K12's decode forms (csrc/decode_matmul.cu) against their
    plain versions. K1 at K1_DECODE_CASES, weights double-quantized as the
    loader stores them: the gate max|y - two calls| <= 1e-2 max|ref|, the
    worst output's distance in bf16 ulps (:func:`mm_ulps`, and of |ref|
    alone), the counters (units stored, 16-byte chunks read) equal to
    ``decode_schedule``'s, the same bits from the same tensor with its
    absmax decoded to fp32 (the bnb-4bit form) and from a second run, and
    each fault of :func:`nf4_decode_faults` above the gate; one M = 4 call
    launches exactly one kernel (``torch.profiler``). K12 at Llama's four
    shapes at FP8_DECODE_ROWS (block 128) and FP8_DECODE_RAGGED:
    :func:`mm_ulps` <= MM_ULPS, the counters, the same bits from a second
    run, each fault of :func:`fp8_faults` above the limit. Times: the
    wrapper's median (the L2 flushed), the two calls', the bound (the
    bytes: x, the stored weight and its scales, y)."""
    import dataclasses

    import torch

    from unsloth_tpu_torch.ops.fp8 import fp8_matmul_ref, quantize_fp8_block
    from unsloth_tpu_torch.ops.fp8_matmul import (dequantize_fp8,
                                                  fp8_matmul_decode)
    from unsloth_tpu_torch.ops.nf4 import (_decode_absmax, dequantize_nf4,
                                           quantize_nf4)
    from unsloth_tpu_torch.ops.qlora_matmul import (decode_schedule,
                                                    nf4_matmul_decode)

    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    rows = {"nf4_matmul_decode": [], "fp8_matmul_decode": []}
    profiled = False
    for name, n, k, row_counts in K1_DECODE_CASES:
        w = (torch.randn((n, k), generator=g, device=dev) * 0.02
             ).to(torch.bfloat16)
        q = quantize_nf4(w, dtype=torch.bfloat16)
        del w
        q_f32 = dataclasses.replace(q, absmax=_decode_absmax(q).contiguous(),
                                    absmax_scale=None, absmax_offset=None)
        for m in row_counts:
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            plan = decode_schedule(m, n, k, "nf4")

            def two_calls():
                return torch.matmul(x, dequantize_nf4(q, torch.bfloat16).t())

            counts.zero_()
            y = nf4_matmul_decode(x, q, tile_counts=counts)
            again = nf4_matmul_decode(x, q)
            from_f32 = nf4_matmul_decode(x, q_f32)
            ref, plain_ms = once_ms(two_calls)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            tol = 1e-2 * ref.float().abs().max().item()
            ulps, ulps_abs = mm_ulps(y, ref), _bf16_ulps(y, ref)
            got_c, want_c = counts.tolist(), plan.counts(n)
            same = [bool(torch.equal(y, again)),
                    bool(torch.equal(y, from_f32))]
            faults = {f_: (nf4_matmul_decode(x, fq).float() - ref.float()
                           ).abs().max().item()
                      for f_, fq in nf4_decode_faults(q, plan).items()}
            ms = time_ms(lambda: nf4_matmul_decode(x, q), flush=flush)
            lib_ms = time_ms(two_calls, runs=10, flush=flush)
            b_ms, b_by = bound(2 * m * n * k, nbytes(x) + q.nbytes + m * n * 2)
            shape = f"{name} M={m} N={n} K={k}"
            rows["nf4_matmul_decode"].append(dict(
                shape=shape, err=err, tol=tol, ulps=ulps, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library=NF4_LIBRARY, tile_counts=got_c,
                same_bits=same, schedule=plan[:3]))
            log(f"[kernels] nf4_matmul decode {shape}: max|d|={err:.3e} "
                f"(tol {tol:.3e}; {ulps:.2f} ulp of max(|ref|, rms/16), "
                f"{ulps_abs:.1f} of |ref|); units, chunks {got_c} (schedule "
                f"{want_c}, row warps/slices/steps {tuple(plan[:3])}); same "
                f"bits run twice {same[0]}, from fp32 absmax {same[1]}; "
                "faults " + ", ".join(f"{f_} {e:.3e}"
                                      for f_, e in faults.items())
                + f"; kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                f"{NF4_LIBRARY} {lib_ms:.4f} ms bound {b_ms:.4f} ms "
                f"({b_by}, {100 * b_ms / ms:.1f}% of it)")
            if not (bool(torch.isfinite(y).all()) and err <= tol):
                raise RuntimeError(f"nf4_matmul decode disagrees at {shape}: "
                                   f"max|d| {err} > {tol}")
            if got_c != want_c:
                raise RuntimeError(f"nf4_matmul decode at {shape}: the "
                                   f"kernel counted {got_c}, its schedule "
                                   f"{want_c}")
            if not all(same):
                raise RuntimeError(f"nf4_matmul decode at {shape}: not the "
                                   "same bits (run twice, from fp32 absmax): "
                                   f"{same}")
            missed = [f_ for f_, e in faults.items() if not e > tol]
            if missed:
                raise RuntimeError(f"the nf4_matmul decode check lets faults "
                                   f"through at {shape}: {missed}")
            if m == 4 and not profiled:
                launched = launched_kernels(lambda: nf4_matmul_decode(x, q))
                log(f"[kernels] nf4_matmul decode {shape}: one call launched "
                    f"{len(launched)} kernel(s): {launched}")
                if len(launched) != 1:
                    raise RuntimeError(f"one nf4_matmul decode call launched "
                                       f"{launched}, not one kernel")
                profiled = True
            del x, y, again, from_f32, ref
        del q, q_f32
        torch.cuda.empty_cache()
    library = "dequantize_fp8 + torch.matmul (two calls)"
    fp8_cases = [(name, n, k, FP8_BLOCK, m) for name, n, k in PROJ_SHAPES
                 for m in FP8_DECODE_ROWS] + [FP8_DECODE_RAGGED]
    for name, n, k, block, m in fp8_cases:
        q = quantize_fp8_block(fp8_weight(n, k, g, dev, block), block)
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        plan = decode_schedule(m, n, k, "fp8")

        def two_calls_fp8():
            return torch.matmul(x, dequantize_fp8(q, torch.bfloat16).t())

        counts.zero_()
        y = fp8_matmul_decode(x, q, tile_counts=counts)
        again = fp8_matmul_decode(x, q)
        ref, plain_ms = once_ms(lambda: fp8_matmul_ref(x, q))
        torch.cuda.synchronize()
        ulps = mm_ulps(y, ref)
        err = (y.float() - ref.float()).abs().max().item()
        got_c, want_c = counts.tolist(), plan.counts(n)
        same = bool(torch.equal(y, again))
        faults = {f_: mm_ulps(fp8_matmul_decode(x, fq), ref)
                  for f_, fq in fp8_faults(q, False).items()}
        ms = time_ms(lambda: fp8_matmul_decode(x, q), flush=flush)
        lib_ms = time_ms(two_calls_fp8, runs=10, flush=flush)
        b_ms, b_by = bound(2 * m * n * k, nbytes(x) + q.nbytes + m * n * 2)
        shape = f"{name} M={m} N={n} K={k} block {block}"
        rows["fp8_matmul_decode"].append(dict(
            shape=shape, err=err, ulps=ulps, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, library=library,
            tile_counts=got_c, same_bits=same, schedule=plan[:3]))
        log(f"[kernels] fp8_matmul decode {shape}: max|d|={err:.3e} "
            f"({ulps:.2f} ulp, limit {MM_ULPS}); units, chunks {got_c} "
            f"(schedule {want_c}, row warps/slices/steps {tuple(plan[:3])}); "
            f"same bits run twice {same}; faults "
            + ", ".join(f"{f_} {u:.1f} ulp" for f_, u in faults.items())
            + f"; kernel {ms:.4f} ms plain {plain_ms:.4f} ms {library} "
            f"{lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}, "
            f"{100 * b_ms / ms:.1f}% of it)")
        if not (bool(torch.isfinite(y).all()) and ulps <= MM_ULPS):
            raise RuntimeError(f"fp8_matmul decode disagrees at {shape}: "
                               f"{ulps} ulp")
        if got_c != want_c or not same:
            raise RuntimeError(f"fp8_matmul decode at {shape}: counted "
                               f"{got_c} (schedule {want_c}), same bits "
                               f"{same}")
        missed = [f_ for f_, u in faults.items() if not u > MM_ULPS]
        if missed:
            raise RuntimeError(f"the fp8_matmul decode check lets faults "
                               f"through at {shape}: {missed}")
        del q, x, y, again, ref
        torch.cuda.empty_cache()
    return rows


def fp8_projections(params):
    """``params`` with the seven projections of every layer quantized by
    quantize_fp8_block at FP8_BLOCK, each on its own device, one at a time
    (the dense weight freed as its FP8 form takes its place), as
    tests/test_ops_fp8.py quantizes a JAX tree. Returns ``params``."""
    from unsloth_tpu_torch.ops.fp8 import quantize_fp8_block

    for layer in params["layers"]:
        for name in FP8_PROJECTIONS:
            layer[name] = quantize_fp8_block(layer[name], FP8_BLOCK)
    return params


def fp8_launches(n_layers, accum=1, remat=True):
    """K12 and K13 launches of one loss and backward over ``accum``
    micro-batches of an ``n_layers`` FP8 Llama with LoRA on all seven
    projections: K12 once a projection, twice under remat (the recompute);
    K13 once a projection, less layer 0's q/k/v, whose input (the norm of
    the frozen embedding) needs no gradient. Phase 7's K1/K2 counts."""
    per = len(FP8_PROJECTIONS) * n_layers
    return {"fp8_matmul_fwd": (2 if remat else 1) * per * accum,
            "fp8_matmul_dx": (per - 3) * accum}


def phase_train_parity_fp8(seed=SEED + 23):
    """Llama-3.1-8B at full width cut to 2 layers, random bf16 weights from
    the seed with the seven projections in FP8 (:func:`fp8_projections`),
    LoRA r=16 with a random B: the loss and every LoRA gradient of one
    padded [2, 1024] batch, the card (K12/K13, K3/K4, K16, K7/K8) against
    the CPU (plain versions, fp32), at phase 4b's limits
    (:func:`phase_train_parity_padded`); K12 and K13 launch exactly
    :func:`fp8_launches` (2 layers, no remat). Then the logits of a prefill
    of 64 tokens (two rows, one left-padded from 50) and
    PARITY_DECODE_STEPS decode steps, the card in bf16 against the CPU in
    fp32 on the same fed tokens, at phase 4's limits (||d||_2 <= 2e-2
    ||ref||_2, max|d| <= 0.1 max|ref|), K12 launching 14 times a forward.
    Returns the loss and backward's launches and the distances."""
    import numpy as np
    import torch

    from unsloth_tpu_torch.models.config import ModelConfig
    from unsloth_tpu_torch.models.params import init_params, tree_to

    cfg = ModelConfig.from_hf_config(dict(LLAMA_31_8B_CONFIG,
                                          num_hidden_layers=2))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = fp8_projections(init_params(cfg, gen, dtype=torch.bfloat16))
    train = phase_train_parity_padded(
        LLAMA_31_8B_CONFIG, params=params, expect=FP8_KERNELS, absent=FP8_ABSENT,
        label="Llama-3.1-8B", seed=seed)
    want = fp8_launches(cfg.num_layers, remat=False)
    got = {n: train["launches"][n] for n in want}
    if got != want:
        raise RuntimeError(f"K12/K13 launches on the 2-layer loss and "
                           f"backward are {got}, not {want}")
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
    mask = torch.ones((2, 64), dtype=torch.int32)
    ids[1, :14] = 0
    mask[1, :14] = 0
    kernels = _kernel_fns()
    before = {n: fn.launches for n, fn in kernels.items()}
    card, fed = _prefill_decode_logits(params, cfg, ids.to(DEVICE),
                                       mask.to(DEVICE), PARITY_DECODE_STEPS)
    torch.cuda.synchronize()
    logits_launches = {n: fn.launches - before[n]
                       for n, fn in kernels.items()}
    ref, _ = _prefill_decode_logits(_tree_f32(tree_to(params, "cpu")), cfg,
                                    ids, mask, PARITY_DECODE_STEPS, feed=fed)
    d = card - ref
    rel = (d.norm() / ref.norm()).item()
    mx = d.abs().max().item()
    scale = ref.abs().max().item()
    agree = (card.argmax(-1) == ref.argmax(-1)).float().mean().item()
    n_fwd = (1 + PARITY_DECODE_STEPS) * len(FP8_PROJECTIONS) * cfg.num_layers
    log(f"[parity] 2-layer Llama-3.1-8B FP8, prefill 64 + "
        f"{PARITY_DECODE_STEPS} steps, B=2, card bf16 against CPU fp32: "
        f"||d||/||ref|| = {rel:.3e} (tol 2e-2), max|d| = {mx:.3e} (tol "
        f"{0.1 * scale:.3e}), argmax agreement {agree:.3f}; K12 launches "
        f"{logits_launches['fp8_matmul_fwd']} (expected {n_fwd})")
    if not (bool(torch.isfinite(card).all()) and rel <= 2e-2
            and mx <= 0.1 * scale):
        raise RuntimeError("FP8 card and CPU logits disagree beyond "
                           "tolerance")
    if logits_launches["fp8_matmul_fwd"] != n_fwd or any(
            logits_launches[n] for n in ("fp8_matmul_dx", "nf4_matmul")):
        raise RuntimeError(f"FP8 prefill/decode launches {logits_launches}")
    del params
    torch.cuda.empty_cache()
    return dict(train, logits_rel=rel, logits_max=mx)


def phase_fp8_sft(tmp, unpacked_launches, profile=False):
    """LoRA SFT and generate over a block-FP8 Llama-3.1-8B at full width and
    depth, from the checkpoint in ``tmp``: from_pretrained(max_seq_length
    2048, load_in_4bit=False) in bf16, the seven projections of all 32
    layers quantized by quantize_fp8_block at block 128
    (:func:`fp8_projections`, the JAX package's way: it has no FP8 loader
    switch), get_peft_model(r=16, seven projections, "unsloth"), the
    notebook recipe (:func:`_notebook_recipe`: padded 2,048-token Alpaca
    rows, train_on_responses_only, batch 2 x accumulation 4) for FP8_STEPS
    steps. Losses finite and falling; launches a step exactly K12 = phase
    7's K1 and K13 = phase 7's K2 (``unpacked_launches``, its counts over
    UNPACKED_STEPS steps; :func:`fp8_launches`), K16 and K7/K8 as phase 7,
    K1/K2 and K9-K11 never. Then evaluate, the adapter round trip,
    save_pretrained_merged raising NotImplementedError (no merge over FP8
    in either package), and a greedy generate of 16 tokens for 2 prompts,
    K12 launched at its decode rows. Returns the training launches, the
    generate's and the metrics. With ``profile`` (``unpacked_launches``
    may then be None), one more step runs under the profiler
    (:func:`_profile_train_step`) in place of evaluate, the saves and
    generate."""
    import numpy as np
    import torch

    # the GRPO phase before this one frees its model at its return
    # (patched_methods leaves no reference cycle), so the peak below is
    # this path's own without a collection
    torch.cuda.empty_cache()
    log(f"[fp8] resident before loading: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    n_train = 8 * FP8_STEPS
    texts = _alpaca_texts(np.random.default_rng(SEED + 24), n_train + 8)
    held_out = texts[n_train:]
    run = _notebook_recipe(tmp, "fp8", texts[:n_train], FP8_STEPS, "sft_fp8",
                           load_in_4bit=False,
                           prepare=lambda m: fp8_projections(m.params))
    model, trainer, launches = run["model"], run["trainer"], run["launches"]
    metrics = _recipe_metrics(run)
    _recipe_launches(run, "fp8", FP8_KERNELS, FP8_ABSENT)
    n_layers, accum = model.cfg.num_layers, run["accum"]
    per_step = fp8_launches(n_layers, accum)
    phase7 = per_step if unpacked_launches is None else {
        "fp8_matmul_fwd": unpacked_launches["nf4_matmul"] / UNPACKED_STEPS,
        "fp8_matmul_dx": unpacked_launches["nf4_matmul_dx"] / UNPACKED_STEPS}
    if phase7 != per_step:
        raise RuntimeError(f"phase 7's K1/K2 launches a step {phase7} are "
                           f"not {per_step}")
    log(f"[fp8] K12/K13 launches a step "
        f"{ {n: launches[n] / FP8_STEPS for n in per_step} } (phase 7's "
        f"K1/K2: {per_step})")
    _check_launched(launches, (), "fp8 training", per_step, FP8_STEPS)
    if profile:
        i = run["order"][0]
        _profile_train_step(trainer, run["batches"][i:i + run["accum"]])
        return launches, None, None

    ev = _adapter_round_trip(model, trainer, held_out, tmp, "fp8")
    merged_dir = os.path.join(tmp, "merged_fp8")
    try:
        model.save_pretrained_merged(merged_dir)
    except NotImplementedError as exc:
        log(f"[fp8] save_pretrained_merged raised NotImplementedError: {exc}")
    else:
        raise RuntimeError("save_pretrained_merged over an FP8 base did not "
                           "raise")
    if os.path.exists(merged_dir) and os.listdir(merged_dir):
        raise RuntimeError(f"the refused merged save wrote "
                           f"{os.listdir(merged_dir)}")
    kernels = _kernel_fns()
    before = {n: fn.launches for n, fn in kernels.items()}
    prompts = [list(t_["text"].encode())[:64] for t_ in held_out[:2]]
    t_gen = _greedy_generate(model, prompts, 16, "fp8")
    gen_launches = {n: fn.launches - before[n] for n, fn in kernels.items()}
    per_fwd = len(FP8_PROJECTIONS) * n_layers
    log(f"[fp8] generate launches "
        f"{ {n: c for n, c in gen_launches.items() if c} } "
        f"({gen_launches['fp8_matmul_fwd'] / per_fwd:.0f} forwards of "
        f"{per_fwd} K12 launches)")
    if gen_launches["fp8_matmul_fwd"] < 2 * per_fwd or \
            gen_launches["fp8_matmul_fwd"] % per_fwd or any(
                gen_launches[n] for n in ("nf4_matmul", "fp8_matmul_dx")) \
            or gen_launches["fp8_matmul_decode"] <= 0:
        raise RuntimeError(f"generate over FP8 launched {gen_launches}")
    del trainer, model, run
    torch.cuda.empty_cache()
    return launches, gen_launches, dict(metrics, eval=ev, generate_s=t_gen)


#: CPU threads of the parity process (phases 4-4k): its fp32 references
#: take most of its time, and the main process keeps the other cores of
#: the card's 8 to launch the main path's phases
PARITY_THREADS = 6


def phase_parity(tmp):
    """Phases 4-4k in order, the 2-layer models at full width on the card
    against the CPU, each timed; returns the launches of each part that
    the kernels line reads (the ``by_path`` entries of :func:`main`)."""
    t_start = time.perf_counter()

    def timed(phase, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        log(f"[time] {phase}: {time.perf_counter() - t0:.1f} s (parity "
            f"process {time.perf_counter() - t_start:.1f} s)")
        return out

    timed("4 parity", phase_slice_parity)
    timed("4b train parity", phase_train_parity)
    timed("4b train parity padded", phase_train_parity_padded)
    timed("4c Gemma-2 train parity", phase_train_parity_padded,
          GEMMA2_9B_CONFIG, expect=GEMMA2_KERNELS,
          absent=("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv",
                  "packed_attn_fwd", "packed_attn_bwd"),
          label="Gemma-2-9B (a sliding and a global layer)", seed=SEED + 8)
    timed("4d gpt-oss train parity", phase_train_parity_gpt_oss)
    small = timed("4e small-model train parity", phase_train_parity_small,
                  tmp)
    grpo = timed("4f GRPO train parity", phase_train_parity_grpo, tmp)
    whisper = timed("4g Whisper train parity", phase_whisper_parity, tmp)
    fp8 = timed("4h FP8 train parity", phase_train_parity_fp8)
    full_ft = timed("4i gpt-oss full-FT train parity",
                    phase_train_parity_gpt_oss_full)
    diffusion = timed("4j LLaDA-8B diffusion train parity",
                      phase_train_parity_diffusion)
    gemma2_diffusion = timed(
        "4k Gemma-2 diffusion train parity", phase_train_parity_diffusion,
        GEMMA2_9B_CONFIG, label="Gemma-2-9B (every layer global)",
        names=FULL_SPLASH, seed=SEED + 32, all_global=True)
    return {"llama32_2layer_parity": small["llama32"],
            "gemma7b_2layer_parity": small["gemma"],
            "gpt_oss_sinks_row_parity": small["gpt_oss"],
            "grpo_2layer_parity": grpo["launches"],
            "whisper_2layer_parity": whisper["launches"],
            "fp8_2layer_parity": fp8["launches"],
            "gpt_oss_full_ft_2layer_parity": full_ft["launches"],
            "diffusion_2layer_parity": diffusion["launches"],
            "gemma2_diffusion_2layer_parity": gemma2_diffusion["launches"]}


class ParityProcess:
    """:func:`phase_parity` in a process of its own (this script with
    ``--parity-phases DIR``), its output kept in ``DIR/parity.log`` and its
    result in ``DIR/parity.json``; :meth:`join` prints the log and returns
    the result, :meth:`stop` ends the process if it still runs."""

    def __init__(self, tmp):
        self.dir = os.path.join(tmp, "parity")
        os.makedirs(self.dir)
        self.log_path = os.path.join(self.dir, "parity.log")
        self.t0 = time.perf_counter()
        with open(self.log_path, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--parity-phases",
                 self.dir], stdout=out, stderr=subprocess.STDOUT)
        self.printed = False

    def _print_log(self):
        if not self.printed:
            self.printed = True
            with open(self.log_path) as f:
                for line in f:
                    log(line.rstrip("\n"))

    def join(self):
        rc = self.proc.wait()
        self._print_log()
        import resource

        rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 2**20
        log(f"[time] 4-4k parity process: joined "
            f"{time.perf_counter() - self.t0:.1f} s after its start, exit "
            f"code {rc}, the largest child process's peak host memory "
            f"{rss:.1f} GiB")
        if rc:
            raise RuntimeError(f"the parity phases 4-4k failed (exit code "
                               f"{rc})")
        with open(os.path.join(self.dir, "parity.json")) as f:
            return json.load(f)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._print_log()


def _parity_main(out_dir) -> int:
    """``--parity-phases DIR``: :func:`phase_parity` with DIR as its
    scratch, its result written to ``DIR/parity.json``."""
    import torch

    torch.set_num_threads(PARITY_THREADS)
    result = phase_parity(out_dir)
    with open(os.path.join(out_dir, "parity.json"), "w") as f:
        json.dump(result, f, default=int)
    return 0


def _kernel_fns():
    """Each kernel's wrapper (its ``launches`` counter) by name."""
    from unsloth_tpu_torch.ops import cross_entropy as tce
    from unsloth_tpu_torch.ops import flash_attention as tfa
    from unsloth_tpu_torch.ops import flash_sinks as tfs
    from unsloth_tpu_torch.ops import gmm as tgmm
    from unsloth_tpu_torch.ops import nf4_gmm as tng
    from unsloth_tpu_torch.ops import packed_attention as tpa
    from unsloth_tpu_torch.ops import splash_attention as tsa
    from unsloth_tpu_torch.ops.fp8_matmul import (fp8_matmul_decode,
                                                  fp8_matmul_dx,
                                                  fp8_matmul_fwd)
    from unsloth_tpu_torch.ops.qlora_matmul import (nf4_matmul,
                                                    nf4_matmul_decode,
                                                    nf4_matmul_dx)
    from unsloth_tpu_torch.ops.rms_norm import (layer_norm_bwd,
                                                layer_norm_fwd, rms_norm,
                                                rms_norm_bwd)

    return {"nf4_matmul": nf4_matmul, "nf4_matmul_dx": nf4_matmul_dx,
            "rms_norm": rms_norm, "rms_norm_bwd": rms_norm_bwd,
            "layer_norm_fwd": layer_norm_fwd,
            "layer_norm_bwd": layer_norm_bwd,
            "cross_entropy_fwd": tce.cross_entropy_fwd,
            "cross_entropy_bwd": tce.cross_entropy_bwd,
            "packed_attn_fwd": tpa.packed_attention_fwd,
            "packed_attn_bwd": tpa.packed_attention_bwd,
            "flash_attn_fwd": tfa.flash_attention_fwd,
            "flash_attn_dq": tfa.flash_attention_dq,
            "flash_attn_dkv": tfa.flash_attention_dkv,
            "flash_attn_fwd_full": tfa.flash_attention_fwd_full,
            "flash_attn_dq_full": tfa.flash_attention_dq_full,
            "flash_attn_dkv_full": tfa.flash_attention_dkv_full,
            "splash_attn_fwd": tsa.splash_attention_fwd,
            "splash_attn_dq": tsa.splash_attention_dq,
            "splash_attn_dkv": tsa.splash_attention_dkv,
            "splash_attn_fwd_full": tsa.splash_attention_fwd_full,
            "splash_attn_dq_full": tsa.splash_attention_dq_full,
            "splash_attn_dkv_full": tsa.splash_attention_dkv_full,
            "nf4_gmm": tng.nf4_gmm, "nf4_gmm_dx": tng.nf4_gmm_dx,
            "flash_sinks_fwd": tfs.flash_sinks_fwd,
            "flash_sinks_dq": tfs.flash_sinks_dq,
            "flash_sinks_dkv": tfs.flash_sinks_dkv,
            "gmm": tgmm.gmm, "gmm_dx": tgmm.gmm_dx, "tgmm": tgmm.tgmm,
            "fp8_matmul_fwd": fp8_matmul_fwd, "fp8_matmul_dx": fp8_matmul_dx,
            # the decode forms, also counted under their kernel's name
            "nf4_matmul_decode": nf4_matmul_decode,
            "fp8_matmul_decode": fp8_matmul_decode,
            "nf4_gmm_decode": tng.nf4_gmm_decode,
            "gmm_decode": tgmm.gmm_decode}


# the kernels each main path must launch
SERVING_KERNELS = ("nf4_matmul", "nf4_matmul_decode", "rms_norm")
TRAIN_KERNELS = ("nf4_matmul", "nf4_matmul_dx", "rms_norm", "rms_norm_bwd",
                 "cross_entropy_fwd", "cross_entropy_bwd")
PACKED_KERNELS = TRAIN_KERNELS + ("packed_attn_fwd", "packed_attn_bwd")
#: attention kernels the packed paths must never launch: K9 and K10/K11
#: (whose backward runs K18's dq and dk/dv, counted as K10/K11's alone)
#: take every layer
PACKED_ABSENT = ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv",
                 "splash_attn_fwd", "splash_attn_dq", "splash_attn_dkv")
UNPACKED_KERNELS = TRAIN_KERNELS + ("flash_attn_fwd", "flash_attn_dq",
                                    "flash_attn_dkv")
GEMMA2_KERNELS = TRAIN_KERNELS + ("splash_attn_fwd", "splash_attn_dq",
                                  "splash_attn_dkv")
GPT_OSS_KERNELS = TRAIN_KERNELS + ("nf4_gmm", "nf4_gmm_dx", "flash_sinks_fwd",
                                   "flash_sinks_dq", "flash_sinks_dkv")
#: the kernels gpt-oss's full-FT path must launch (dense bf16 weights: no
#: NF4 kernel; its sliding layers take K18 or the banded form by the row)
FULL_FT_GPT_OSS_KERNELS = ("rms_norm", "rms_norm_bwd", "cross_entropy_fwd",
                           "cross_entropy_bwd", "flash_sinks_fwd",
                           "flash_sinks_dq", "flash_sinks_dkv", "gmm",
                           "gmm_dx", "tgmm")
#: attention kernels the gpt-oss path must never launch: its global layers
#: take K17, its sliding ones the banded form
GPT_OSS_ABSENT = ("packed_attn_fwd", "packed_attn_bwd", "flash_attn_fwd",
                  "flash_attn_dq", "flash_attn_dkv", "splash_attn_fwd",
                  "splash_attn_dq", "splash_attn_dkv")


def _check_launched(launches, names, path, per_step=None, steps=0):
    """Every kernel of ``names`` launched on the path, and each of
    ``per_step`` exactly that many times a step over ``steps`` steps."""
    for name in names:
        if launches[name] <= 0:
            raise RuntimeError(f"{name} kernel never launched on the {path} "
                               "path")
    wrong = {n: launches[n] for n, k in (per_step or {}).items()
             if launches[n] != k * steps}
    if wrong:
        raise RuntimeError(f"launches on the {path} path over {steps} steps "
                           f"are {wrong}, not {per_step} a step")


def _check_absent(launches, names, path):
    """None of the kernels ``names`` launched on the path."""
    stray = {n: launches[n] for n in names if launches[n]}
    if stray:
        raise RuntimeError(f"kernels off the {path} path ran: {stray}")


#: the kernel behind a kernels-line entry whose wrapper picks between forms
KERNEL_FORMS = {
    "nf4_matmul": "nf4_wgmma_kernel<256> (Hopper: TMA ring, the NF4 decode "
                  "into wgmma's A fragments, y^T = W x^T; <128> at M <= "
                  "128; decode_matmul.cu's split-K kernel at M <= 16)",
    "nf4_matmul_decode": "decode_matmul_kernel<K1, NT> (split K over 128-, "
                         "64- or 32-row groups, 16-byte loads four steps "
                         "ahead, the NF4 decode and the stored int8 absmax "
                         "into mma.sync A fragments, y^T = W x^T, the "
                         "slices summed in order by the last block)",
    "nf4_gmm_decode": "grouped_decode_kernel<K14, NT> (decode_matmul.cu's "
                      "split-K loop under a grouped schedule: (slot, row "
                      "group, K slice) units for min(m, E) slots, each slot "
                      "an expert with rows found on the card, the NF4 decode "
                      "of the stacked fp32 absmax, the fp32 bias before the "
                      "one rounding; one launch a call)",
    "gmm_decode": "grouped_decode_kernel<K19, NT> (the grouped decode "
                  "kernel with dense bf16 rows, eight steps in flight, the "
                  "bf16 bias after the first rounding; one launch a call)",
    "fp8_matmul_decode": "decode_matmul_kernel<K12, NT> (the decode kernel "
                         "with the e4m3 cvt and the block's scale; <K12 any "
                         "shape, NT> where K % 16, the pointers or B % 16 "
                         "do not allow 16-byte chunks)",
    "nf4_matmul_dx": "nf4_dx_wgmma_kernel<256> (Hopper: dx^T = W^T g^T, TMA "
                     "ring, the NF4 decode into wgmma's A fragments; <128> "
                     "at M <= 128)",
    "fp8_matmul_fwd": "nf4_wgmma_kernel<256, true> (K1's Hopper kernel with "
                      "the e4m3 decode; <128, true> at M <= 128; "
                      "fp8_matmul.cu's fp8_matmul_kernel<64, false> outside "
                      "fp8_wgmma_form; decode_matmul.cu at M <= 16)",
    "layer_norm_fwd": "layer_norm_warp_kernel (one warp a row, the row in "
                      "registers; layer_norm_kernel at other widths)",
    "nf4_gmm_dx": "nf4_gmm_dx_wgmma_kernel<256> (Hopper: K2's dx^T = W_g^T "
                  "g^T under K14's grouped schedule, row tiles laid from "
                  "each group's first row; <128> at m <= 128; every row "
                  "count)",
    "packed_attn_fwd": "flash_fwd_kernel<128, false, false> (K16's Hopper "
                       "forward on q * bf16(scale) at scale 1, the tile "
                       "pairs the segments rule out skipped)",
    "packed_attn_bwd": "flash_dq_kernel<128, true> (csrc/flash_dq.cu) then "
                       "flash_dkv_kernel<128, true> (csrc/flash_dkv.cu): "
                       "K18's Hopper dq and dk/dv at bf16(scale), no window, "
                       "softcap or layout, the tile pairs the segments rule "
                       "out skipped",
    "packed_attn_fwd_d256": "flash_fwd_kernel<256, false, false>",
    "packed_attn_bwd_d256": "flash_dq_kernel<256, true> (csrc/flash_dq.cu) "
                            "then flash_dkv_kernel<256, true> "
                            "(csrc/flash_dkv.cu)"}


def _kernels_line(rows, by_path):
    """The result's "kernels" list: each kernel at a shape of phase 3
    (``rows``) on the path whose launches it reports (``by_path``: the
    launch counts of each main path's run), and the head-dim forms of the
    small-model paths as entries of their own."""
    k16 = "unsloth_tpu/ops/attention.py:415 (bundled flash_attention "
    k18 = "unsloth_tpu/ops/attention.py:231 (_splash_kernel: bundled splash "
    k16_full = ("unsloth_tpu/ops/attention.py:415 (_tpu_flash with causal="
                "False, from attention :689-692 and :697-699: bundled "
                "flash_attention ")
    k18_full = ("unsloth_tpu/ops/attention.py:231 (_splash_kernel with "
                "FullMask :253, through _tpu_splash :260, from attention "
                ":693-696: bundled splash ")
    picks = {
        "nf4_matmul": ("nf4_wgmma.cu", "unsloth_tpu/ops/qlora_matmul.py:155",
                       "gate/up M=8192 N=14336 K=4096"),
        "nf4_matmul_decode": ("decode_matmul.cu",
                              "unsloth_tpu/ops/qlora_matmul.py:155 "
                              "(_fwd_kernel, pallas_call :236; here at M "
                              "<= 16)", "gate/up M=1 "),
        "fp8_matmul_decode": ("decode_matmul.cu",
                              "unsloth_tpu/ops/fp8_matmul.py:85 "
                              "(_fwd_kernel, pallas_call :153; here at M "
                              "<= 16)", "gate/up M=1 "),
        "nf4_matmul_dx": ("nf4_wgmma.cu",
                          "unsloth_tpu/ops/qlora_matmul.py:267",
                          "gate/up M=8192 N=14336 K=4096"),
        "rms_norm": ("rms_norm.cu", "unsloth_tpu/ops/rms_norm.py:70",
                     "[8192, 4096] bfloat16 gemma=False"),
        "rms_norm_bwd": ("rms_norm.cu", "unsloth_tpu/ops/rms_norm.py:80",
                         "[8192, 4096] bfloat16 gemma=False"),
        "cross_entropy_fwd": ("cross_entropy.cu",
                              "unsloth_tpu/ops/cross_entropy.py:66", None),
        "cross_entropy_bwd": ("cross_entropy.cu",
                              "unsloth_tpu/ops/cross_entropy.py:111", None),
        "packed_attn_fwd": ("flash_fwd.cu",
                            "unsloth_tpu/ops/packed_attention.py:109 "
                            "(_fwd_kernel, pallas_call :205 in _fwd :161)",
                            None),
        "packed_attn_bwd": ("flash_dq.cu",
                            "unsloth_tpu/ops/packed_attention.py:224 "
                            "(_dq_kernel, pallas_call :301 in _dq :265) and "
                            ":316 (_dkv_kernel, pallas_call :409 in _dkv "
                            ":366)", None),
        "flash_attn_fwd": ("flash_fwd.cu", k16 + "forward)", None),
        "flash_attn_dq": ("flash_dq.cu", k16 + "_flash_attention_bwd_dq)",
                          None),
        "flash_attn_dkv": ("flash_dkv.cu",
                           k16 + "_flash_attention_bwd_dkv)", None),
        "splash_attn_fwd": ("flash_fwd.cu", k18 + "forward)",
                            "(a) sliding"),
        "splash_attn_dq": ("flash_dq.cu", k18 + "dq)", "(a) sliding"),
        "splash_attn_dkv": ("flash_dkv.cu", k18 + "dk/dv)",
                            "(a) sliding"),
        "nf4_gmm": ("nf4_wgmma.cu", "unsloth_tpu/ops/nf4_gmm.py:86 "
                    "(_fwd_kernel, pallas_call :243 in _nf4_gmm_fwd_impl "
                    ":204)", "(a) path"),
        "nf4_gmm_decode": ("decode_matmul.cu",
                           "unsloth_tpu/ops/nf4_gmm.py:86 (_fwd_kernel, "
                           "pallas_call :243 in _nf4_gmm_fwd_impl :204; here "
                           "at m <= 16)", "decode m=8"),
        "gmm_decode": ("decode_matmul.cu", "unsloth_tpu/ops/moe.py:249 "
                       "(tiled_gmm: bundled megablox gmm, gmm.py:314, "
                       "pallas_call :526, transpose_rhs=True; the bias "
                       ":258-276; here at m <= 16)", "decode m=8"),
        "nf4_gmm_dx": ("nf4_wgmma.cu", "unsloth_tpu/ops/nf4_gmm.py:135 "
                       "(_bwd_kernel, pallas_call :307 in _nf4_gmm_bwd_impl "
                       ":274)", "(a) path"),
        "flash_sinks_fwd": ("flash_fwd.cu",
                            "unsloth_tpu/ops/attention.py:456 (_tpu_flash_"
                            "sinks: bundled _flash_attention_impl)",
                            "(a) packed row"),
        "flash_sinks_dq": ("flash_dq.cu",
                           "unsloth_tpu/ops/attention.py:487 (_tpu_flash_"
                           "sinks: bundled _flash_attention_bwd_dq)",
                           "(a) packed row"),
        "flash_sinks_dkv": ("flash_dkv.cu",
                            "unsloth_tpu/ops/attention.py:480 (_tpu_flash_"
                            "sinks: bundled _flash_attention_bwd_dkv)",
                            "(a) packed row"),
        "gmm": ("gmm.cu", "unsloth_tpu/ops/moe.py:249 (tiled_gmm: bundled "
                "megablox gmm, gmm.py:314, pallas_call :526, "
                "transpose_rhs=True)", "(a) path"),
        "gmm_dx": ("gmm.cu", "unsloth_tpu/ops/moe.py:249 (megablox gmm's "
                   "VJP, ops.py:80: gmm with transpose_rhs flipped)",
                   "(a) path"),
        "tgmm": ("tgmm.cu", "jax/experimental/pallas/ops/tpu/megablox/"
                 "gmm.py:573 (tgmm, pallas_call :763; megablox _gmm_bwd "
                 "ops.py:90, reached from unsloth_tpu/ops/moe.py:249 when "
                 "the experts train)", "(a) path"),
        "layer_norm_fwd": ("layer_norm.cu", "unsloth_tpu/ops/rms_norm.py:243 "
                           "(_ln_fwd_kernel, launched by _ln_fwd_pallas "
                           ":289)", "[3000, 1280] bfloat16"),
        "layer_norm_bwd": ("layer_norm.cu", "unsloth_tpu/ops/rms_norm.py:253 "
                           "(_ln_bwd_kernel, launched by _ln_bwd_pallas "
                           ":313)", "[3000, 1280] bfloat16"),
        "fp8_matmul_fwd": ("nf4_wgmma.cu", "unsloth_tpu/ops/fp8_matmul.py:85 "
                           "(_fwd_kernel, launched by _fwd_pallas :138, "
                           "pallas_call :153)", "gate/up M=4096"),
        "fp8_matmul_dx": ("nf4_wgmma.cu", "unsloth_tpu/ops/fp8_matmul.py:113 "
                          "(_bwd_kernel, launched by _bwd_pallas :177, "
                          "pallas_call :192)", "gate/up M=4096"),
        "flash_attn_fwd_full": ("flash_fwd.cu", k16_full + "forward)",
                                "(a) LLaDA-8B"),
        "flash_attn_dq_full": ("flash_dq.cu",
                               k16_full + "_flash_attention_bwd_dq)",
                               "(a) LLaDA-8B"),
        "flash_attn_dkv_full": ("flash_dkv.cu",
                                k16_full + "_flash_attention_bwd_dkv)",
                                "(a) LLaDA-8B"),
        "splash_attn_fwd_full": ("flash_fwd.cu", k18_full + "forward)",
                                 "(e) Gemma-2-9B"),
        "splash_attn_dq_full": ("flash_dq.cu", k18_full + "dq)",
                                "(e) Gemma-2-9B"),
        "splash_attn_dkv_full": ("flash_dkv.cu", k18_full + "dk/dv)",
                                 "(e) Gemma-2-9B"),
    }
    # the main path each kernel's "launches" comes from
    main_path = {"packed_attn_fwd": "packed_training",
                 "packed_attn_bwd": "packed_training",
                 "splash_attn_fwd": "gemma2_training",
                 "splash_attn_dq": "gemma2_training",
                 "splash_attn_dkv": "gemma2_training",
                 **{k_: "gpt_oss_training" for k_ in (
                     "nf4_gmm", "nf4_gmm_dx", "flash_sinks_fwd",
                     "flash_sinks_dq", "flash_sinks_dkv")},
                 "gmm": "gpt_oss_bf16_training",
                 "gmm_dx": "gpt_oss_bf16_training",
                 "tgmm": "gpt_oss_full_ft_training",
                 "layer_norm_fwd": "whisper_training",
                 "layer_norm_bwd": "whisper_training",
                 "fp8_matmul_fwd": "fp8_training",
                 "fp8_matmul_dx": "fp8_training",
                 "nf4_matmul_decode": "serving",
                 "nf4_gmm_decode": "gpt_oss_generate",
                 "gmm_decode": "gpt_oss_bf16_generate",
                 "fp8_matmul_decode": "fp8_generate",
                 **{k_: "diffusion_training" for k_ in FULL_FLASH},
                 **{k_: "gemma2_diffusion_2layer_parity"
                    for k_ in FULL_SPLASH}}
    # the head-dim forms: (kernel, form, shape in phase 3, the path whose
    # launches are all of this form; None: no model path runs the form, and
    # its launches are phase 3's run through ops.attention.attention)
    forms = {
        **{f"{k_}_d{d_}": (k_, f"d{d_}", f"(c) Dh {d_}", None)
           for k_ in ("flash_sinks_fwd", "flash_sinks_dq", "flash_sinks_dkv")
           for d_, *_ in SINKS_WIDE_HEADS},
        "flash_attn_fwd_d64": ("flash_attn_fwd", "d64", "Llama-3.2-1B",
                               "llama32_training"),
        "flash_attn_dq_d64": ("flash_attn_dq", "d64", "Llama-3.2-1B",
                              "llama32_training"),
        "flash_attn_dkv_d64": ("flash_attn_dkv", "d64", "Llama-3.2-1B",
                               "llama32_training"),
        "flash_attn_fwd_d256": ("flash_attn_fwd", "d256", "Gemma-7B",
                                "gemma7b_2layer_parity"),
        "flash_attn_dq_d256": ("flash_attn_dq", "d256", "Gemma-7B",
                               "gemma7b_2layer_parity"),
        "flash_attn_dkv_d256": ("flash_attn_dkv", "d256", "Gemma-7B",
                                "gemma7b_2layer_parity"),
        "splash_attn_fwd_d64": ("splash_attn_fwd", "d64", "gpt-oss sliding",
                                "gpt_oss_sinks_row_parity"),
        "splash_attn_dq_d64": ("splash_attn_dq", "d64", "gpt-oss sliding",
                               "gpt_oss_sinks_row_parity"),
        "splash_attn_dkv_d64": ("splash_attn_dkv", "d64", "gpt-oss sliding",
                                "gpt_oss_sinks_row_parity"),
        "splash_attn_fwd_prefix": ("splash_attn_fwd", "prefix",
                                   "GRPO prefix layout", "grpo_training"),
        "splash_attn_dq_prefix": ("splash_attn_dq", "prefix",
                                  "GRPO prefix layout", "grpo_training"),
        "splash_attn_dkv_prefix": ("splash_attn_dkv", "prefix",
                                   "GRPO prefix layout", "grpo_training"),
        "flash_attn_fwd_full_canvas": ("flash_attn_fwd_full", "canvas",
                                       "(d) generate canvas",
                                       "diffusion_generate"),
        "packed_attn_fwd_d256": ("packed_attn_fwd", "d256", "Gemma-7B",
                                 None),
        "packed_attn_bwd_d256": ("packed_attn_bwd", "d256", "Gemma-7B",
                                 None),
    }
    # the TPU kernel a form replaces, where it is not the base form's
    form_replaces = {"prefix": "unsloth_tpu/ops/attention.py:246-247 "
                     "(_splash_kernel with NumpyMask(prefix_mask_array(P, G, "
                     "L)), from attention :600-617 under prefix_attention)"}
    has_forms = {k_ for k_, *_ in forms.values()}

    def attention_call(kname):
        """The phase-3 call of ops.attention.attention whose launches a
        form no model path runs reports."""
        return ("attention_packed" if kname.startswith("packed")
                else "attention_with_sinks")

    form_paths = {p_ for *_, p_ in forms.values()} | {
        "qwen25_training", "llama32_2layer_parity", "grpo_2layer_parity",
        "qwen25_full_ft_training", "gpt_oss_full_ft_2layer_parity"}
    entries = [(k_, k_, None, shape, main_path.get(k_, "unpacked_training"))
               for k_, (_, _, shape) in picks.items()]
    entries += [(n_, k_, form, shape, path)
                for n_, (k_, form, shape, path) in forms.items()]
    kernels_line = []
    for name_, kname, form, shape, path in entries:
        src, replaces, _ = picks[kname]
        replaces = form_replaces.get(form, replaces)
        of_form = [r for r in rows[kname] if r.get("form") == form]
        row = next(r for r in of_form
                   if shape is None or r["shape"].startswith(shape))
        # a kernel with head-dim forms counts, under each form, only the
        # paths that run that form
        if form is None:
            by_form = {p_: n[kname] for p_, n in by_path.items()
                       if kname in n
                       and not (kname in has_forms and p_ in form_paths)}
        elif path is None:
            by_form = {attention_call(kname): row["path_launches"][kname]}
        else:
            by_form = {path: by_path[path][kname]}
        if form == "d64" and kname.startswith("flash"):
            by_form["qwen25_training"] = by_path["qwen25_training"][kname]
            by_form["qwen25_full_ft_training"] = \
                by_path["qwen25_full_ft_training"][kname]
        if form == "d64" and kname.startswith("splash"):
            by_form["gpt_oss_full_ft_2layer_parity"] = \
                by_path["gpt_oss_full_ft_2layer_parity"][kname]
        if form == "prefix":
            by_form["grpo_2layer_parity"] = \
                by_path["grpo_2layer_parity"][kname]
        kernels_line.append({
            "name": name_, "route": "cuda",
            "source": f"unsloth_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": (by_form[attention_call(kname)] if path is None
                         else by_path[path][kname]),
            "max_abs_err": max(r["err"] for r in of_form),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "pct_of_bound": 100 * row["bound_ms"] / row["ms"],
            "library_ms": row["library_ms"], "shape": row["shape"],
            "launches_by_path": by_form,
            **({"kernel": KERNEL_FORMS[name_]} if name_ in KERNEL_FORMS
               else {}),
            **{key: row[key] for key in ("sdpa_no_softcap_ms", "library",
                                         "k16_ms",
                                         "tile_classes_one_segment",
                                         "causal_tile_classes", "tile_classes",
                                         "same_bits", "library_ratio",
                                         "unit_counts", "tile_counts",
                                         "prescale_ms",
                                         "absmax_transpose_ms", "schedule")
               if key in row}})
    return kernels_line


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    profiles = {
        (): None,
        ("--profile-train",): (phase_train_main, LLAMA_31_8B_CONFIG),
        ("--profile-train-unpacked",): (phase_unpacked_sft,
                                        LLAMA_31_8B_CONFIG),
        ("--profile-train-gemma2",): (phase_gemma2_sft, GEMMA2_9B_CONFIG),
        ("--profile-train-gpt-oss",): (phase_gpt_oss_sft,
                                       GPT_OSS_20B_CONFIG),
        ("--profile-train-gpt-oss-bf16",): (
            lambda path, profile: phase_gpt_oss_sft(path, profile="bf16"),
            GPT_OSS_20B_CONFIG),
        ("--profile-train-llama32",): (phase_llama32_sft, LLAMA_32_1B_CONFIG,
                                       True),
        ("--profile-train-grpo",): (phase_grpo, LLAMA_31_8B_CONFIG),
        ("--profile-train-fp8",): (
            lambda path, profile: phase_fp8_sft(path, None, profile=profile),
            LLAMA_31_8B_CONFIG),
        ("--profile-train-diffusion",): (phase_llada, LLADA_8B_CONFIG),
        ("--profile-train-whisper",): (phase_whisper, None),
        ("--profile-serve",): (phase_profile_serve, LLAMA_31_8B_CONFIG)}
    args = tuple(sys.argv[1:])
    if len(args) == 2 and args[0] == "--parity-phases":
        return _parity_main(args[1])
    tree = None
    if len(args) == 3 and args[:1] in profiles and args[1] == "--tree":
        # profile another checkout's package (a parent unpacked under
        # build/ by git archive) with this script's harness; phase 2 then
        # reports that build's Hopper rows without holding them to this
        # tree's
        tree = os.path.abspath(args[2])
        sys.path.insert(0, tree)
        args = args[:1]
        log(f"[tree] unsloth_tpu_torch from {tree}")
    if args == ("--library-times",):
        # phases 1 and 2, then the library yardsticks; no result line
        phase_device()
        phase_build()
        t0 = time.perf_counter()
        phase_library_times()
        log(f"[time] library times: {time.perf_counter() - t0:.1f} s")
        return 0
    if args not in profiles:
        print(f"usage: {sys.argv[0]} [--library-times | --profile-train | "
              "--profile-train-unpacked | --profile-train-gemma2 | "
              "--profile-train-gpt-oss | --profile-train-gpt-oss-bf16 | "
              "--profile-train-llama32 | --profile-train-grpo | "
              "--profile-train-fp8 | --profile-train-diffusion | "
              "--profile-train-whisper | --profile-serve] [--tree DIR, "
              "after a --profile flag]",
              file=sys.stderr)
        return 2
    profile = profiles[args]
    t_start = time.perf_counter()

    def timed(phase, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        log(f"[time] {phase}: {time.perf_counter() - t0:.1f} s (script "
            f"{time.perf_counter() - t_start:.1f} s)")
        return out

    name, smi = timed("1 device", phase_device)
    timed("2 build", phase_build, hold=tree is None)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    parity = None
    try:
        if profile:
            # phases 1, 2 and 6, 7, 8, 9, 10 or 12 only, then a profiled
            # step (--profile-serve: phase 5's model, a decode step); no
            # result line
            fn, config, *bnb4 = profile
            fn(tmp if config is None else
               _write_model(os.path.join(tmp, "model"), config, *bnb4),
               profile=True)
            return 0
        rows = timed("3 kernels", phase_kernels)
        timed("3b CE routes", phase_ce_routes)
        parity = ParityProcess(tmp)
        llama = timed("5 write Llama", _write_model,
                      os.path.join(tmp, "llama31_8b"), LLAMA_31_8B_CONFIG)
        serve_launches, _ = timed("5 serving", phase_main_path, llama)
        packed_launches, _ = timed("6 packed training", phase_train_main,
                                   llama)
        unpacked_launches, _ = timed("7 unpacked SFT", phase_unpacked_sft,
                                     llama)
        # phases 12 and 15 run on the Llama-3.1-8B checkpoint while it is
        # written
        grpo_launches, _ = timed("12 GRPO", phase_grpo, llama)
        fp8_launches_, fp8_gen_launches, _ = timed(
            "15 FP8 SFT", phase_fp8_sft, llama, unpacked_launches)
        shutil.rmtree(llama)   # the disk holds one checkpoint at a time
        llada = timed("18 write LLaDA-8B", _write_model,
                      os.path.join(tmp, "llada_8b"), LLADA_8B_CONFIG)
        diffusion_launches_, diffusion_gen_launches, _ = timed(
            "18 LLaDA-8B diffusion", phase_llada, llada)
        shutil.rmtree(llada)
        gemma2 = timed("8 write Gemma-2", _write_model,
                       os.path.join(tmp, "gemma2_9b"), GEMMA2_9B_CONFIG)
        gemma2_launches, _ = timed("8 Gemma-2 SFT", phase_gemma2_sft, gemma2)
        shutil.rmtree(gemma2)
        llama32 = timed("10 write Llama-3.2 (bnb-4bit)", _write_model,
                        os.path.join(tmp, "llama32_1b_bnb"),
                        LLAMA_32_1B_CONFIG, True)
        llama32_launches, _ = timed("10 Llama-3.2 SFT", phase_llama32_sft,
                                    llama32)
        shutil.rmtree(llama32)
        qwen = timed("11 write Qwen2.5", _write_model,
                     os.path.join(tmp, "qwen25_05b"), QWEN25_05B_CONFIG)
        qwen_launches, _ = timed("11 Qwen2.5 SFT", phase_qwen25_sft, qwen)
        qwen_ft_launches, _ = timed("17 Qwen2.5 full FT",
                                    phase_qwen25_full_ft, qwen, tmp)
        shutil.rmtree(qwen)
        whisper_launches_, transcribe_launches, _ = timed(
            "13 Whisper-large-v3", phase_whisper, tmp)
        orpheus_launches, _ = timed("14 Orpheus-3B SFT", phase_orpheus, tmp)
        # the largest checkpoint and the largest device footprint wait
        # for the parity process to end
        parity_launches = timed("4-4k parity (joined)", parity.join)
        gpt_oss = timed("9 write gpt-oss", _write_model,
                        os.path.join(tmp, "gpt_oss_20b"), GPT_OSS_20B_CONFIG)
        gpt_oss_launches, bf16_launches, gpt_oss_metrics = timed(
            "9 gpt-oss SFT", phase_gpt_oss_sft, gpt_oss)
        gpt_oss_ft_launches, _ = timed("16 gpt-oss full FT",
                                       phase_gpt_oss_full_ft, gpt_oss, tmp)
        shutil.rmtree(gpt_oss)
    finally:
        if parity is not None:
            parity.stop()
        shutil.rmtree(tmp, ignore_errors=True)

    # the launch counts of each main path's run
    by_path = {"serving": serve_launches, "packed_training": packed_launches,
               "unpacked_training": unpacked_launches,
               "gemma2_training": gemma2_launches,
               "gpt_oss_training": gpt_oss_launches,
               "gpt_oss_bf16_training": bf16_launches,
               "llama32_training": llama32_launches,
               "qwen25_training": qwen_launches,
               "grpo_training": grpo_launches,
               "whisper_training": whisper_launches_,
               "whisper_transcribe": transcribe_launches,
               "orpheus_training": orpheus_launches,
               "fp8_training": fp8_launches_,
               "fp8_generate": fp8_gen_launches,
               "gpt_oss_generate": gpt_oss_metrics["generate_launches"],
               "gpt_oss_bf16_generate":
                   gpt_oss_metrics["bf16"]["generate_launches"],
               "gpt_oss_full_ft_training": gpt_oss_ft_launches,
               "qwen25_full_ft_training": qwen_ft_launches,
               "diffusion_training": diffusion_launches_,
               "diffusion_generate": diffusion_gen_launches,
               **parity_launches}
    import resource

    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    log(f"[time] whole script {time.perf_counter() - t_start:.1f} s, its "
        f"own process's peak host memory {rss:.1f} GiB")
    kernels_line = _kernels_line(rows, by_path)
    print(json.dumps({"kernels": kernels_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
