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
               the main paths' shapes, with median times: the NF4 matmul
               (K1) and its backward (K2) at every Llama-3.1-8B projection
               shape, RMSNorm forward (K3) and backward (K4), packed flash
               attention forward and backward (K9-K11) on an 8K row, the
               full-logits CE forward (K7) and backward (K8) at 4,094 rows
               of the 128,256 vocabulary, and unpacked flash attention
               (K16: forward, dq, dk/dv) on a padded [2, 2048] batch; then
               the Gemma-2-9B path's: K1/K2 at its five projection shapes
               (M = 4,096), K3/K4 with gemma=True at [4096, 3584], K7/K8
               over 256,000 logits with softcap 30, and splash attention
               (K18: forward, dq, dk/dv) with softcap 50 at (a) the path's
               padded [2, 2048] batch, 16/8 heads, head dim 256, with and
               without the window of 4,096, (b) one 8K row where the window
               bites, (c) Gemma-2-27B's heads (32/16, head dim 128), (d)
               a packed 8K row and (e), without window or softcap, at
               K16's shape; then the gpt-oss-20b path's: K1/K2 at its
               three attention projection shapes (M = 4,096; K = 2,880
               for q/k/v, whose K/2 is not a multiple of 64), the grouped
               NF4 expert kernels K14 (with the bias epilogue) and K15 at
               the path's 16,384 rows routed top-4 over 32 experts (N = K
               = 2,880, block 32), a skewed routing and the 8 rows of a
               decode step, the grouped dense bf16 matmul K19 (forward
               with the bias epilogue, and dx) on the same three
               routings, and flash attention with sinks (K17: forward,
               dq, dk/dv, dsinks; 64/8 heads of 64) on the path's packed
               4,096-token row and a padded [2, 2048] batch; then the
               small Llama-family paths' head-dim forms: K16 at head dim
               64 on the padded [2, 2048] batch with Llama-3.2-1B's 32/8
               and Qwen2.5-0.5B's 14/2 heads, at head dim 256 with
               Gemma-7B's 16/16, and K18 at head dim 64 on a packed
               384-token row with gpt-oss's 64/8 heads and window 128; the
               check must reject injected faults (K16: a dropped kv tile,
               an ignored pad mask, a late-half error; K18 also: the
               window ignored, the softcap's derivative dropped; K14/K15:
               one expert's rows through the next expert's weights, the
               bias dropped; K19 the same; K17: the sink ignored, dsinks
               dropped). For each
               kernel, its bound (the least time the card could take) and
               the time of the one PyTorch call that computes the same
               function, where there is one (K18: the compiled
               flex_attention with the softcap as its score_mod; SDPA with
               the same mask and no softcap is timed beside it; K14/K15,
               labelled: dequantize + torch._grouped_mm; K17, labelled:
               compiled flex_attention with return_lse and the sink
               rescale; K19, labelled: torch._grouped_mm + a bias gather;
               K18 at head dim 64, labelled: SDPA with the causal, window
               and segment mask, which has no softcap to miss);
  3b. CE routes  full logits (cuBLAS + K7/K8) against the chunked fused CE,
               forward + backward time and peak memory, at 4,094 and 8,191
               rows;
  4. parity    Llama-3.1-8B cut to 2 layers, random NF4 weights: prefill 64
               tokens + 8 decode steps on the card (kernels) and on the CPU
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
  5. main path (serving) a random-init bf16 Llama-3.1-8B checkpoint (full
               width, all 32 layers) is written as index-sharded
               safetensors, loaded with FastLanguageModel.from_pretrained(
               load_in_4bit=True), served by InferenceServer over HTTP (3
               requests) and run through model.generate on 4 prompts;
  6. main path (packed training) the same checkpoint, get_peft_model(r=16,
               all seven projections, use_gradient_checkpointing="unsloth"),
               SFTTrainer on synthetic documents packed into 8,192-token
               rows: batch 1, accumulation 2, 4 steps; losses finite and
               falling; step time, real tokens/s and peak memory;
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
               a greedy generate of 8 tokens for 1 prompt (K19 at decode
               rows); the trainer, its AdamW state and the adapter freed;
               then quantize_params (stacked NF4 at block 32),
               get_peft_model(r=16, "unsloth"),
               SFTTrainer with packing into 4,096-token rows, batch 1 x
               accumulation 2, 4 steps: losses finite and falling, step
               time, tokens/s, peak memory, MFU over active parameters,
               launches per step exactly K14 288, K15 144, K17 48/24/24 and
               K19/K9-K11/K16/K18 never; evaluate, the adapter round trip,
               and a greedy generate of 16 tokens for 2 prompts;
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
               launches exactly; evaluate and a greedy generate.

Then one JSON line with each kernel's launches on its main path, its
largest error against its plain version, its time beside the plain
version's, its bound and the library call's time (the head-dim forms of
K16 and K18 as entries of their own); the nvidia-smi line;
and last the result line {"ok": true, "device": {...}}. It needs one CUDA
card and exits non-zero without it.

    python3 chip_smoke.py --profile-train
    python3 chip_smoke.py --profile-train-unpacked
    python3 chip_smoke.py --profile-train-gemma2
    python3 chip_smoke.py --profile-train-gpt-oss
    python3 chip_smoke.py --profile-train-gpt-oss-bf16
    python3 chip_smoke.py --profile-train-llama32

run phases 1, 2 and 6 (or 7 without evaluate and the saves, or 8, or 9's
NF4 part, or 9's bf16-expert part, or 10, each without evaluate, generate
and the saves) only, then one more training step under
torch.profiler, and print that step's device time by kernel and by kernel
family, the device spans of the port's profiler ranges (the MoE routing
glue, the banded attention), its device busy share and its MFU/HFU (no
result line). Every phase prints its time ("[time]").
"""

from __future__ import annotations

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
GPT_OSS_ROWS = 4096        # packed row of phase 9 (bench.py's first rung)
SINKS_ROWS = 384           # a gpt-oss row where the window of 128 is not
                           # narrow (4 bands do not fit): K18 at head dim 64
SINKS_DOCS = ((0, 260), (260, 360))   # its documents, then a pad tail
PARITY_ROWS = 1024         # row length of the card-vs-CPU parity phases 4b-4c
DECODE_ROWS = (1, 4, 7)
PREFILL_ROWS = 4096
TRAIN_ROWS = 8192          # one packed 8K row: the training path's M
DOC_LENGTHS = (64, 1024)   # synthetic document lengths, inclusive
SUB_VOCAB = 512            # documents draw ids from this many token ids
UNPACKED_ROWS = 2048       # max_seq_length of the notebook recipe
CE_ROWS = (4094, 8191)     # CE rows: 2 x 2,048 and 1 x 8,192, shifted
SEED = 0
DEVICE = "cuda:0"

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
                    softcap=None):
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
    (dq and dk only: the forward and dv do not use dS). Returns {fault:
    {tensor: (row-wise error, whether the old check, max|d| <= 2e-2
    max|ref|, passes it)}}; every row-wise error must exceed
    ATTN_ROW_TOL."""
    import torch

    from unsloth_tpu_torch.ops import flash_attention as tfa
    from unsloth_tpu_torch.ops import splash_attention as tsa

    splash = window is not None or softcap is not None

    def plain(fseg, fwindow=window):
        if not splash:
            fout, flse = tfa.flash_attention_fwd_ref(q, k, v, fseg, scale)
            return (fout,) + tuple(tfa.flash_attention_bwd_ref(
                q, k, v, fseg, fout, flse, dout, scale))
        opts = dict(window=fwindow, softcap=softcap, scale=scale)
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
    if softcap is not None:
        faults["softcap derivative dropped"] = (None,) + _grads_without_dtanh(
            q, k, v, seg, dout, window, softcap, scale) + (None,)
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


def _grads_without_dtanh(q, k, v, seg, dout, window, softcap, scale):
    """(dq, dk) of capped attention as a kernel that leaves the softcap's
    1 - tanh^2 factor out of dS would give them: autograd through the
    capped scores with the cap's derivative taken as 1, one kv head (and
    its query heads) at a time, in fp32."""
    import torch

    from unsloth_tpu_torch.ops.flash_attention import _mask

    b, t, hq, _ = q.shape
    n_rep = hq // k.shape[2]
    mask = _mask(seg, b, t, q.device, window)[:, None]
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


def phase_build():
    from unsloth_tpu_torch import kernels

    t0 = time.perf_counter()
    path = kernels.build()
    kernels.library()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {kernels.build_seconds} s)")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("[build]  ", line.strip())


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
    computes the same function (``library_ms``; none for the NF4 matmuls,
    which no single call dequantizes and multiplies)."""
    import torch
    import torch.nn.functional as F

    from unsloth_tpu_torch.ops.nf4 import dequantize_nf4, quantize_nf4
    from unsloth_tpu_torch.ops.qlora_matmul import nf4_matmul
    from unsloth_tpu_torch.ops.rms_norm import rms_norm, rms_norm_ref

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = {"nf4_matmul": [], "rms_norm": []}
    for name, n, k, row_counts in (
            [(name, n, k, DECODE_ROWS + (PREFILL_ROWS, TRAIN_ROWS))
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
            y = nf4_matmul(x, q)
            ref = torch.matmul(x, dequantize_nf4(q, torch.bfloat16).t())
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            ok = bool(torch.isfinite(y).all()) and err <= 1e-2 * scale
            plain = lambda: torch.matmul(  # noqa: E731
                x, dequantize_nf4(q, torch.bfloat16).t())
            ms = time_ms(lambda: nf4_matmul(x, q), flush=flush)
            plain_ms = time_ms(plain, flush=flush)
            b_ms, b_by = bound(2 * m * n * k, nbytes(x) + q.nbytes + m * n * 2)
            rows["nf4_matmul"].append(dict(shape=f"{name} M={m} N={n} K={k}",
                                           err=err, tol=1e-2 * scale,
                                           ms=ms, plain_ms=plain_ms,
                                           bound_ms=b_ms, bound_by=b_by,
                                           library_ms=None))
            log(f"[kernels] nf4_matmul {name:15s} M={m:<5d} N={n:<6d} "
                f"K={k:<6d}"
                f" max|d|={err:.3e} (tol {1e-2 * scale:.3e})"
                f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
            if not ok:
                raise RuntimeError(f"nf4_matmul disagrees at {name} M={m}: "
                                   f"max|d| {err} > 1e-2 * {scale}")
    for shape in ((TRAIN_ROWS, 4096), (4096, 4096), (4, 4096),
                  (2 * UNPACKED_ROWS, GEMMA2_9B_CONFIG["hidden_size"])):
        for dtype in (torch.bfloat16, torch.float32):
            for gemma in (False, True):
                x = torch.randn(shape, generator=g, device=dev).to(dtype)
                w = (1.0 + 0.1 * torch.randn((shape[-1],), generator=g,
                                             device=dev)).to(dtype)
                y = rms_norm(x, w, 1e-5, gemma)
                ref = rms_norm_ref(x, w, 1e-5, gemma)
                torch.cuda.synchronize()
                d = y.float() - ref.float()
                ulps = ulps_bf16_or_f32(d, ref, dtype)
                limit = 1 if dtype == torch.bfloat16 else 8
                ms = time_ms(lambda: rms_norm(x, w, 1e-5, gemma), flush=flush)
                plain_ms = time_ms(lambda: rms_norm_ref(x, w, 1e-5, gemma),
                                   flush=flush)
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
    rows.update(_training_kernels(dev, g, flush))
    rows.update(_unpacked_kernels(dev, g, flush))
    rows.update(_splash_kernels(dev, g, flush))
    rows.update(_gpt_oss_kernels(dev, g, flush))
    for name, extra in _small_model_kernels(dev, g, flush).items():
        rows[name] += extra
    del flush
    torch.cuda.empty_cache()
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


def _sdpa_ms(q, k, v, segment_ids, dout, flush, window=None):
    """(forward ms, backward ms) of the one PyTorch call that computes the
    attention kernels' function: ``F.scaled_dot_product_attention`` with a
    boolean mask (causal, equal segment ids and, where given, within the
    window) and ``enable_gqa=True``, in its [B, H, T, D] layout. A
    yardstick only; the port never calls it."""
    import torch
    import torch.nn.functional as F

    from unsloth_tpu_torch.ops.flash_attention import _mask

    mask = _mask(segment_ids, q.shape[0], q.shape[1], q.device,
                 window)[:, None]
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
             scale):
    """(forward ms, backward ms, row-wise error of its out against
    ``want``) of the one PyTorch call that computes the splash kernels'
    function: ``torch.compile``d ``flex_attention`` in its [B, H, T, D]
    layout, with the softcap c * tanh(s / c) as its ``score_mod``, a block
    mask of causal, within the window and equal segment ids, and
    ``enable_gqa=True``, on q * scale rounded to q's dtype (what the kernels
    and the JAX wrapper score; the timed call includes that product). The
    window and segment ids reach the mask as
    tensors, so cases of one shape share a compiled kernel. A yardstick
    only; the port never calls it."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask

    flex_compiled = _compiled_flex()
    b, t = segment_ids.shape
    seg = segment_ids.to(torch.int32)
    win = torch.tensor(window or t, device=q.device)

    def mask_mod(bi, h, qi, ki):
        return (ki <= qi) & (qi - ki < win) & (seg[bi, qi] == seg[bi, ki])

    def score_mod(s, bi, h, qi, ki):
        return softcap * torch.tanh(s / softcap)

    mask = create_block_mask(mask_mod, b, None, t, t, device=q.device)

    def flex(a, b_, c):
        # q scaled and rounded in its dtype first, as the kernels take it
        return flex_compiled((a * scale).to(a.dtype), b_, c,
                     score_mod=score_mod if softcap else None,
                     block_mask=mask, scale=1.0, enable_gqa=True)

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    err = attn_row_err(flex(qt, kt, vt).transpose(1, 2), want)
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


def _training_kernels(dev, g, flush):
    """K2 at every Llama-3.1-8B projection shape at M = 8192 and every
    Gemma-2-9B one at M = 4096; K4 at [8192, 4096] bf16, plain and Gemma,
    and at Gemma-2-9B's [4096, 3584]; packed attention forward and backward
    on one 8K row of Llama-3.1-8B attention (32/8 heads, head dim 128).

    Tolerances. K2: max|dx - ref| <= 1e-2 max|ref| (as K1: the same bf16
    weights, fp32 sums in another order, one bf16 rounding). K4: dx
    within 2 bf16 ulps plus 1e-5 of max|dx| (the fp32 result differs in
    its last bits before rounding; the floor covers values that cancel
    to near zero), dW within one bf16 ulp of max|dW| (an fp32 sum over
    8,192 rows in another order, then rounded to bf16). Attention, at positions
    with segment id != 0 (pad outputs are unspecified): out, dq, dk, dv
    row by row (:func:`attn_row_err`; the kernels round P and dS to bf16
    before their products, the plain version keeps fp32), lse within
    1e-3; the backward pair is fed the kernel forward's (out, lse) on both
    sides."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from unsloth_tpu_torch.data.packing import max_segment_length
    from unsloth_tpu_torch.ops import packed_attention as tpa
    from unsloth_tpu_torch.ops.nf4 import quantize_nf4
    from unsloth_tpu_torch.ops.qlora_matmul import (nf4_matmul_dx,
                                                    nf4_matmul_dx_ref)
    from unsloth_tpu_torch.ops.rms_norm import rms_norm_bwd, rms_norm_bwd_ref

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
        dx = nf4_matmul_dx(gy, q)
        ref = nf4_matmul_dx_ref(gy, q)
        torch.cuda.synchronize()
        err = (dx.float() - ref.float()).abs().max().item()
        tol = 1e-2 * ref.float().abs().max().item()
        ms = time_ms(lambda: nf4_matmul_dx(gy, q), flush=flush)
        plain_ms = time_ms(lambda: nf4_matmul_dx_ref(gy, q), flush=flush)
        b_ms, b_by = bound(2 * m * n * k, nbytes(gy) + q.nbytes + m * k * 2)
        rows["nf4_matmul_dx"].append(dict(
            shape=f"{name} M={m} N={n} K={k}", err=err, tol=tol, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None))
        log(f"[kernels] nf4_matmul_dx {name:15s} M={m} N={n:<6d} K={k:<6d} "
            f"max|d|={err:.3e} (tol {tol:.3e}) kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms")
        if not (bool(torch.isfinite(dx).all()) and err <= tol):
            raise RuntimeError(f"nf4_matmul_dx disagrees at {name}: {err}")
        del q, gy, dx, ref

    m = TRAIN_ROWS
    for n_rows, hidden, gemma in (
            (m, 4096, False), (m, 4096, True),
            (2 * UNPACKED_ROWS, GEMMA2_9B_CONFIG["hidden_size"], True)):
        shape = (n_rows, hidden)
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        w = (1.0 + 0.1 * torch.randn((hidden,), generator=g, device=dev)
             ).to(torch.bfloat16)
        gy = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        dx, dw = rms_norm_bwd(x, w, gy, 1e-5, gemma)
        rdx, rdw = rms_norm_bwd_ref(x, w, gy, 1e-5, gemma)
        torch.cuda.synchronize()
        d = (dx.float() - rdx.float()).abs()
        dx_ulps = ulps_bf16_or_f32(d, rdx, torch.bfloat16)
        dx_ok = bool((d <= 2.0 ** -7 * rdx.float().abs()
                      + 1e-5 * rdx.float().abs().max()).all())
        dw_err = (dw.float() - rdw.float()).abs().max().item()
        dw_tol = 2.0 ** -7 * rdw.float().abs().max().item()
        ms = time_ms(lambda: rms_norm_bwd(x, w, gy, 1e-5, gemma), flush=flush)
        plain_ms = time_ms(lambda: rms_norm_bwd_ref(x, w, gy, 1e-5, gemma),
                           flush=flush)
        lib_ms = None if gemma else _autograd_ms(
            lambda a, b: F.rms_norm(a, (hidden,), b, 1e-5), (x, w), gy, flush)
        b_ms, b_by = bound(8 * x.numel(), 3 * nbytes(x) + 2 * nbytes(w),
                           PEAK_FP32)
        rows["rms_norm_bwd"].append(dict(
            shape=f"{list(shape)} bfloat16 gemma={gemma}",
            err=max(d.max().item(), dw_err),
            ulps=dx_ulps, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms))
        log(f"[kernels] rms_norm_bwd {list(shape)} bfloat16 "
            f"gemma={gemma!s:5s} "
            f"dx max {dx_ulps:.2f} ulp (limit 2 + 1e-5 max|dx|: "
            f"{'ok' if dx_ok else 'FAIL'}), max|d dW|={dw_err:.3e} (tol "
            f"{dw_tol:.3e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if not (bool(torch.isfinite(dx).all()) and dx_ok
                and dw_err <= dw_tol):
            raise RuntimeError(f"rms_norm_bwd disagrees at {shape} "
                               f"(gemma={gemma})")
        del x, gy, dx, rdx, d

    c = LLAMA_31_8B_CONFIG
    hq, hkv, d = (c["num_attention_heads"], c["num_key_value_heads"],
                  c["head_dim"])
    seg = torch.from_numpy(_packed_segments(np.random.default_rng(SEED), m)
                           ).to(dev)
    max_len = int(max_segment_length(seg.cpu().numpy()))
    q, k, v, dout = (torch.randn((1, m, h, d), generator=g, device=dev)
                     .to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
    scale = d ** -0.5
    n_kv = tpa.bound_blocks(max_len, tpa.BLOCK)
    kv_lo, q_hi = tpa.segment_block_metadata(seg, tpa.BLOCK)
    real = seg[0] != 0
    out, lse = tpa.packed_attention_fwd(q, k, v, seg, kv_lo, scale=scale,
                                        n_kv=n_kv)
    rout, rlse = tpa.packed_attention_fwd_ref(q, k, v, seg, scale)
    dq, dk, dv = tpa.packed_attention_bwd(q, k, v, seg, kv_lo, q_hi, out, lse,
                                          dout, scale=scale, n_kv=n_kv)
    rdq, rdk, rdv = tpa.packed_attention_bwd_ref(q, k, v, seg, out, lse, dout,
                                                 scale)
    torch.cuda.synchronize()
    n_docs = int(seg.max().item())
    shape = (f"B=1 T={m} Hq={hq} Hkv={hkv} D={d} bf16, {n_docs} segments "
             f"of {DOC_LENGTHS[0]}-{DOC_LENGTHS[1]} + pad tail "
             f"{int((~real).sum())}")
    errs = {}
    for name, got, ref in (("out", out, rout), ("dq", dq, rdq),
                           ("dk", dk, rdk), ("dv", dv, rdv)):
        got, ref = got[:, real].float(), ref[:, real].float()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"packed attention {name} is not finite")
        errs[name] = ((got - ref).abs().max().item(),
                      attn_row_err(got, ref))
    lse_err = (lse - rlse)[..., real].abs().max().item()
    fwd_ms = time_ms(lambda: tpa.packed_attention_fwd(
        q, k, v, seg, kv_lo, scale=scale, n_kv=n_kv), runs=10, flush=flush)
    fwd_plain = time_ms(lambda: tpa.packed_attention_fwd_ref(
        q, k, v, seg, scale), runs=5, warmup=1, flush=flush)
    bwd_ms = time_ms(lambda: tpa.packed_attention_bwd(
        q, k, v, seg, kv_lo, q_hi, out, lse, dout, scale=scale, n_kv=n_kv),
        runs=10, flush=flush)
    bwd_plain = time_ms(lambda: tpa.packed_attention_bwd_ref(
        q, k, v, seg, out, lse, dout, scale), runs=5, warmup=1, flush=flush)
    # the work the real tokens need: each segment's causal pairs
    seg_np = seg[0].cpu().numpy()
    lens = np.bincount(seg_np[seg_np != 0])
    pairs = int((lens * (lens + 1) // 2).sum())
    lib_fwd, lib_bwd = _sdpa_ms(q, k, v, seg, dout, flush)
    fb = bound(4 * d * hq * pairs, nbytes(q, k, v, out, lse))
    bb = bound(10 * d * hq * pairs,
               nbytes(q, k, v, out, dout, lse, q, k, v))
    rows["packed_attn_fwd"].append(dict(
        shape=shape, err=max(errs["out"][0], lse_err), ms=fwd_ms,
        plain_ms=fwd_plain, bound_ms=fb[0], bound_by=fb[1],
        library_ms=lib_fwd))
    rows["packed_attn_bwd"].append(dict(
        shape=shape, err=max(errs[n][0] for n in ("dq", "dk", "dv")),
        ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bb[0], bound_by=bb[1],
        library_ms=lib_bwd))
    log(f"[kernels] packed attention {shape}: " + ", ".join(
        f"{n} max|d|={e:.3e} row-wise {r:.3e}" for n, (e, r) in errs.items())
        + f" (row-wise tol {ATTN_ROW_TOL:.3e}); lse max|d|={lse_err:.3e} "
        "(tol 1e-3)")
    log(f"[kernels] packed attention fwd kernel {fwd_ms:.4f} ms plain "
        f"{fwd_plain:.4f} ms SDPA {lib_fwd:.4f} ms bound {fb[0]:.4f} ms "
        f"({fb[1]}); bwd (dq + dk/dv) kernel {bwd_ms:.4f} ms plain "
        f"{bwd_plain:.4f} ms SDPA {lib_bwd:.4f} ms bound {bb[0]:.4f} ms "
        f"({bb[1]}); {pairs} causal pairs per head")
    bad = [n for n, (e, r) in errs.items() if not r <= ATTN_ROW_TOL]
    if bad or not lse_err <= 1e-3:
        raise RuntimeError(f"packed attention disagrees in {bad}: {errs}, "
                           f"lse {lse_err}")
    return rows


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
        rloss, rlse = tce.cross_entropy_ref(logits, labels, softcap)
        rdx = tce.cross_entropy_bwd_ref(logits, labels, lse, gr, softcap)
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
        fwd_plain = time_ms(lambda: tce.cross_entropy_ref(
            logits, labels, softcap), runs=5, flush=flush)
        bwd_plain = time_ms(lambda: tce.cross_entropy_bwd_ref(
            logits, labels, lse, gr, softcap), runs=5, flush=flush)
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
                      c["num_key_value_heads"], c["head_dim"])
    for name, row in res.items():
        rows[name].append(row)
    return rows


def _flash_case(dev, g, flush, label, seg, hq, hkv, hd, form=None):
    """K16 forward, dq and dk/dv at one shape against the plain versions, at
    every position, pad queries included: out, dq, dk, dv row by row
    (:func:`attn_row_err`), lse within 1e-3, the backward fed the kernel
    forward's (out, lse) on both sides; then the check must reject the
    plain versions under a dropped kv tile and under an ignored pad mask
    (:func:`attn_fault_errs`). Times: the kernels, the plain versions, and
    SDPA with the padding mask (the same function). Returns a row per
    kernel, tagged with ``form`` (the head-dim form of the kernels line)."""
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
    rout, rlse = tfa.flash_attention_fwd_ref(q, k, vv, seg, scale)
    rdq, rdk, rdv = tfa.flash_attention_bwd_ref(q, k, vv, seg, out, lse,
                                                dout, scale)
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
    del rout, rdq, rdk, rdv
    fwd_ms = time_ms(lambda: tfa.flash_attention_fwd(
        q, k, vv, seg, lo, hi, scale=scale), runs=10, flush=flush)
    dq_ms = time_ms(lambda: tfa.flash_attention_dq(
        q, k, vv, seg, lo, hi, out, lse, dout, scale=scale), runs=10,
        flush=flush)
    dkv_ms = time_ms(lambda: tfa.flash_attention_dkv(
        q, k, vv, seg, lo, hi, lse, di, dout, scale=scale), runs=10,
        flush=flush)
    fwd_plain = time_ms(lambda: tfa.flash_attention_fwd_ref(
        q, k, vv, seg, scale), runs=5, warmup=1, flush=flush)
    bwd_plain = time_ms(lambda: tfa.flash_attention_bwd_ref(
        q, k, vv, seg, out, lse, dout, scale), runs=5, warmup=1, flush=flush)
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
            library_ms=lib_fwd),
        "flash_attn_dq": dict(
            common, err=errs["dq"][0], ms=dq_ms, plain_ms=bwd_plain,
            bound_ms=qb[0], bound_by=qb[1], library_ms=lib_bwd),
        "flash_attn_dkv": dict(
            common, err=max(errs["dk"][0], errs["dv"][0]), ms=dkv_ms,
            plain_ms=bwd_plain, bound_ms=kb[0], bound_by=kb[1],
            library_ms=lib_bwd)}
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
    window ignored and the softcap's derivative dropped among them."""
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
    for label, seg, h_q, h_kv, dh, sc, win, sc_cap, faults in (
            ("(a) sliding", padded, hq, hkv, hd, scale, window, cap, False),
            ("(a) global", padded, hq, hkv, hd, scale, None, cap, False),
            ("(b)", one, hq, hkv, hd, scale, window, cap, True),
            ("(c) Gemma-2-27B heads", one, 32, 16, 128, 144 ** -0.5, window,
             cap, False),
            ("(d) packed", packed, hq, hkv, hd, scale, window, cap, False),
            ("(e) K16's shape", padded, llama["num_attention_heads"],
             llama["num_key_value_heads"], llama["head_dim"],
             llama["head_dim"] ** -0.5, None, None, False)):
        res = _splash_case(dev, g, flush, label, seg, h_q, h_kv, dh, sc, win,
                           sc_cap, faults)
        for name, row in res.items():
            rows[name].append(row)
    return rows


def _splash_case(dev, g, flush, label, seg, hq, hkv, d, scale, window,
                 softcap, faults, flex=True, form=None):
    """K18 forward, dq and dk/dv at one shape against the plain versions,
    every position row by row (:func:`attn_row_err`), lse within 1e-3, the
    backward fed the kernel forward's (out, lse) on both sides. q and k
    are N(0, 4^2), so the scores are of the order of the softcap and its
    tanh bites. With ``faults`` the check must also reject each fault of
    :func:`attn_fault_errs`. Times: the kernels, the plain versions, the
    library call that computes the same function (:func:`_flex_ms`, whose
    out must agree with the plain version's as the kernel's does) and,
    beside it, SDPA with the same boolean mask and no softcap; without
    ``flex`` (no softcap), that SDPA call is the library call, which
    computes the same function, and flex_attention is not compiled.
    Returns a row per kernel, tagged with ``form`` (the head-dim form of
    the kernels line)."""
    import torch

    from unsloth_tpu_torch.ops import flash_attention as tfa
    from unsloth_tpu_torch.ops import splash_attention as tsa

    b, t = seg.shape
    q, k = ((torch.randn((b, t, h, d), generator=g, device=dev) * 4)
            .to(torch.bfloat16) for h in (hq, hkv))
    v, dout = (torch.randn((b, t, h, d), generator=g, device=dev)
               .to(torch.bfloat16) for h in (hkv, hq))
    lo, hi = tfa.tile_segment_ranges(seg)
    opts = dict(window=window, softcap=softcap, scale=scale)
    out, lse = tsa.splash_attention_fwd(q, k, v, seg, lo, hi, **opts)
    dq, di = tsa.splash_attention_dq(q, k, v, seg, lo, hi, out, lse, dout,
                                     **opts)
    dk, dv = tsa.splash_attention_dkv(q, k, v, seg, lo, hi, lse, di, dout,
                                      **opts)
    rout, rlse = tsa.splash_attention_fwd_ref(q, k, v, seg, **opts)
    rdq, rdk, rdv = tsa.splash_attention_bwd_ref(q, k, v, seg, out, lse,
                                                 dout, **opts)
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
    fault_res = attn_fault_errs(q, k, v, seg, dout, scale,
                                (rout, rdq, rdk, rdv), window=window,
                                softcap=softcap) if faults else {}
    del rdq, rdk, rdv
    flex_fwd = flex_bwd = flex_err = None
    if flex:
        flex_fwd, flex_bwd, flex_err = _flex_ms(q, k, v, seg, dout, flush,
                                                rout, **opts)
    elif softcap is not None:
        raise ValueError("SDPA computes K18's function only without a "
                         "softcap")
    del rout
    fwd_ms = time_ms(lambda: tsa.splash_attention_fwd(
        q, k, v, seg, lo, hi, **opts), runs=10, flush=flush)
    dq_ms = time_ms(lambda: tsa.splash_attention_dq(
        q, k, v, seg, lo, hi, out, lse, dout, **opts), runs=10, flush=flush)
    dkv_ms = time_ms(lambda: tsa.splash_attention_dkv(
        q, k, v, seg, lo, hi, lse, di, dout, **opts), runs=10, flush=flush)
    fwd_plain = time_ms(lambda: tsa.splash_attention_fwd_ref(
        q, k, v, seg, **opts), runs=3, warmup=1, flush=flush)
    bwd_plain = time_ms(lambda: tsa.splash_attention_bwd_ref(
        q, k, v, seg, out, lse, dout, **opts), runs=3, warmup=1, flush=flush)
    sdpa_fwd, sdpa_bwd = _sdpa_ms(q, k, v, seg, dout, flush, window=window)
    # the valid (query, key) pairs of this data: the work the kernels need
    pairs = int(tfa._mask(seg, b, t, dev, window).sum())
    fb = bound(4 * d * hq * pairs, nbytes(q, k, v, seg, out, lse))
    qb = bound(6 * d * hq * pairs, nbytes(q, k, v, seg, out, dout, lse, q,
                                          di))
    kb = bound(8 * d * hq * pairs, nbytes(q, k, v, seg, dout, lse, di, k, v))
    n_seg = len(torch.unique(seg[seg != 0]))
    shape = (f"{label}: B={b} T={t} Hq={hq} Hkv={hkv} D={d} bf16 scale="
             f"{scale:.5f} softcap={softcap} window={window}, {n_seg} "
             f"segment(s), {int((seg == 0).sum())} pad")
    common = dict(shape=shape, form=form)
    lib = {} if flex else dict(library="SDPA with the causal, window and "
                               "segment mask (no softcap: the same function)")
    res = {
        "splash_attn_fwd": dict(
            common, err=max(errs["out"][0], lse_err), ms=fwd_ms,
            plain_ms=fwd_plain, bound_ms=fb[0], bound_by=fb[1],
            library_ms=flex_fwd if flex else sdpa_fwd,
            sdpa_no_softcap_ms=sdpa_fwd, **lib),
        "splash_attn_dq": dict(
            common, err=errs["dq"][0], ms=dq_ms, plain_ms=bwd_plain,
            bound_ms=qb[0], bound_by=qb[1],
            library_ms=flex_bwd if flex else sdpa_bwd,
            sdpa_no_softcap_ms=sdpa_bwd, **lib),
        "splash_attn_dkv": dict(
            common, err=max(errs["dk"][0], errs["dv"][0]), ms=dkv_ms,
            plain_ms=bwd_plain, bound_ms=kb[0], bound_by=kb[1],
            library_ms=flex_bwd if flex else sdpa_bwd,
            sdpa_no_softcap_ms=sdpa_bwd, **lib)}
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
    log(f"[kernels] splash attention {label} fwd kernel {fwd_ms:.4f} ms plain "
        f"{fwd_plain:.4f} ms bound {fb[0]:.4f} ms ({fb[1]}); dq kernel "
        f"{dq_ms:.4f} ms bound {qb[0]:.4f} ms; dk/dv kernel {dkv_ms:.4f} ms "
        f"bound {kb[0]:.4f} ms; plain backward {bwd_plain:.4f} ms; "
        f"{flex_text}SDPA with the same mask and "
        f"no softcap: fwd {sdpa_fwd:.4f} ms, backward {sdpa_bwd:.4f} ms; "
        f"{pairs} valid pairs per head")
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
        res = _flash_case(dev, g, flush, label, seg, hq, hkv, d, form=form)
        for name, row in res.items():
            rows.setdefault(name, []).append(row)
    c = GPT_OSS_20B_CONFIG
    packed = torch.zeros((1, SINKS_ROWS), dtype=torch.int32, device=dev)
    for sid, (lo, hi) in enumerate(SINKS_DOCS, start=1):
        packed[0, lo:hi] = sid      # two documents and a pad tail
    res = _splash_case(dev, g, flush, "gpt-oss sliding, D=64", packed,
                       c["num_attention_heads"], c["num_key_value_heads"],
                       c["head_dim"], c["head_dim"] ** -0.5,
                       c["sliding_window"], None, True, flex=False,
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
    top-4 routing of 2 tokens); and K17 (:func:`_sinks_case`) on (a) the
    path's packed 4,096-token row and (b) a padded [2, 2048] batch, 64/8
    heads of 64."""
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
                                  "flash_sinks_fwd", "flash_sinks_dq",
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
        for name, row in res.items():
            rows[name].append(row)
    del q, w, x_path, x_dec
    torch.cuda.empty_cache()

    hq, hkv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                   c["head_dim"])
    packed = torch.from_numpy(_packed_segments(np.random.default_rng(SEED + 9),
                                               GPT_OSS_ROWS)).to(dev)
    padded = torch.ones((2, UNPACKED_ROWS), dtype=torch.int32, device=dev)
    padded[0, 1500:] = 0
    for label, seg, lib in (("(a) packed row", packed, True),
                            ("(b) padded", padded, False)):
        res = _sinks_case(dev, g, flush, label, seg, hq, hkv, hd, hd ** -0.5,
                          lib)
        for name, row in res.items():
            rows[name].append(row)
    return rows


def _row_faults(want, faults):
    """{fault: row-wise error (:func:`attn_row_err`) of the faulty result
    against ``want``}; each must exceed ATTN_ROW_TOL."""
    return {name: attn_row_err(got, want) for name, got in faults.items()}


def _gmm_case(dev, g, flush, label, x, q, sizes, bias):
    """K14 (with the bias epilogue) and K15 at one routing against
    nf4_gmm_ref, row by row (:func:`attn_row_err`: each output row on its
    own rms; the kernels round each weight to bf16, the plain version keeps
    fp32, both sum in fp32), and max|d| beside it. The check must reject
    the rows of one expert multiplied by the next expert's weights (in both
    kernels) and the bias dropped (K14). Times: the kernels, the plain
    versions, and the library yardstick, which dequantizes the whole stack
    to bf16 and runs ``torch._grouped_mm`` (where the card's torch has
    it; labelled: it is dequantize + a grouped product, not one call).
    Bound: 2 m N K operations; bytes of the rows, of the experts this
    routing visits (packed and absmax) and of the output."""
    import torch

    from unsloth_tpu_torch.ops import nf4_gmm as tng
    from unsloth_tpu_torch.ops.nf4 import dequantize_nf4_stacked

    e, n, k = q.shape
    m = x.shape[0]
    gy = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
    y = tng.nf4_gmm(x, q, sizes, bias)
    dx = tng.nf4_gmm_dx(gy, q, sizes)
    ref = tng.nf4_gmm_ref(x, q, sizes, bias)
    rdx = tng.nf4_gmm_ref(gy, q, sizes, transpose=True)
    torch.cuda.synchronize()
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
        "bias dropped": tng.nf4_gmm_ref(x, q, sizes)}),
        "nf4_gmm_dx": _row_faults(rdx, {"next expert's weights": wrong_dx})}
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
                            flush=flush),
                    time_ms(lambda: tng.nf4_gmm_ref(x, q, sizes, bias),
                            runs=3, warmup=1, flush=flush)),
        "nf4_gmm_dx": (time_ms(lambda: tng.nf4_gmm_dx(gy, q, sizes),
                               flush=flush),
                       time_ms(lambda: tng.nf4_gmm_ref(
                           gy, q, sizes, transpose=True), runs=3, warmup=1,
                           flush=flush))}
    n_live = len(live)
    w_bytes = n_live * (n * k // 2 + n * k // q.block_size * 4)
    b_fwd = bound(2 * m * n * k, m * k * 2 + w_bytes + n_live * n * 2
                  + m * n * 2 + 4 * e)
    b_dx = bound(2 * m * n * k, m * n * 2 + w_bytes + m * k * 2 + 4 * e)
    shape = (f"{label}: m={m} E={e} N={n} K={k} block {q.block_size}, "
             f"{n_live} experts with rows (largest {max(sz)})")
    del y, dx, ref, rdx, wrong_y, wrong_dx, gy
    torch.cuda.empty_cache()
    return _grouped_rows("grouped NF4", shape, errs, faults, times,
                         {"nf4_gmm": b_fwd, "nf4_gmm_dx": b_dx}, lib, lib_err,
                         "dequantize + torch._grouped_mm")


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
    dropped (forward). Times: the kernels, the plain versions, and the
    library call ``torch._grouped_mm`` (+ the bias gathered by row; where
    the card's torch has it), fed W in the column-major layout it takes,
    made once outside the timing. Bound: 2 m N K operations; bytes of the
    rows, of the experts this routing visits and of the output."""
    import torch

    from unsloth_tpu_torch.ops import gmm as tgmm

    e, n, k = w.shape
    m = x.shape[0]
    gy = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
    y = tgmm.gmm(x, w, sizes, bias)
    dx = tgmm.gmm_dx(gy, w, sizes)
    ref = tgmm.gmm_ref(x, w, sizes, bias)
    rdx = tgmm.gmm_ref(gy, w, sizes, transpose=True)
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in (("gmm", y, ref), ("gmm_dx", dx, rdx)):
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
    w1 = w[g1].float()
    wrong_y = ref.clone()
    wrong_y[r0:r1] = ((x[r0:r1].float() @ w1.t()).to(ref.dtype)
                      + bias[g0].to(ref.dtype))
    wrong_dx = rdx.clone()
    wrong_dx[r0:r1] = (gy[r0:r1].float() @ w1).to(rdx.dtype)
    del w1
    faults = {"gmm": _row_faults(ref, {
        "next expert's weights": wrong_y,
        "bias dropped": tgmm.gmm_ref(x, w, sizes)}),
        "gmm_dx": _row_faults(rdx, {"next expert's weights": wrong_dx})}
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
                lib[name] = time_ms(fn, runs=10, flush=flush)
            except Exception as exc:  # the yardstick only; logged
                lib_err[name] = f"torch._grouped_mm failed: {exc!r}"[:200]
        del w_cm
    times = {
        "gmm": (time_ms(lambda: tgmm.gmm(x, w, sizes, bias), flush=flush),
                time_ms(lambda: tgmm.gmm_ref(x, w, sizes, bias), runs=3,
                        warmup=1, flush=flush)),
        "gmm_dx": (time_ms(lambda: tgmm.gmm_dx(gy, w, sizes), flush=flush),
                   time_ms(lambda: tgmm.gmm_ref(gy, w, sizes, transpose=True),
                           runs=3, warmup=1, flush=flush))}
    n_live = len(live)
    w_bytes = n_live * n * k * 2
    b_fwd = bound(2 * m * n * k, m * k * 2 + w_bytes + n_live * n * 2
                  + m * n * 2 + 4 * e)
    b_dx = bound(2 * m * n * k, m * n * 2 + w_bytes + m * k * 2 + 4 * e)
    shape = (f"{label}: m={m} E={e} N={n} K={k} bf16, {n_live} experts "
             f"with rows (largest {max(sz)})")
    del y, dx, ref, rdx, wrong_y, wrong_dx, gy
    torch.cuda.empty_cache()
    return _grouped_rows("grouped dense", shape, errs, faults, times,
                         {"gmm": b_fwd, "gmm_dx": b_dx}, lib, lib_err,
                         "torch._grouped_mm")


def _sinks_case(dev, g, flush, label, seg, hq, hkv, d, scale, lib):
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
    rescale)."""
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
    rout, rlse = tfs.flash_sinks_fwd_ref(q, k, v, seg, sinks, scale)
    rdq, rdk, rdv, rdsk = tfs.flash_sinks_bwd_ref(q, k, v, seg, out, lse,
                                                  dout, sinks, scale)
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
    fwd_plain = time_ms(lambda: tfs.flash_sinks_fwd_ref(
        q, k, v, seg, sinks, scale), runs=3, warmup=1, flush=flush)
    bwd_plain = time_ms(lambda: tfs.flash_sinks_bwd_ref(
        q, k, v, seg, out, lse, dout, sinks, scale), runs=3, warmup=1,
        flush=flush)
    flex_fwd = flex_bwd = flex_err = None
    if lib:
        flex_fwd, flex_bwd, flex_err = _flex_sinks_ms(q, k, v, seg, sinks,
                                                      dout, flush, rout,
                                                      scale)
    pairs = int(tfa._mask(seg, b, t, dev).sum())
    fb = bound(4 * d * hq * pairs, nbytes(q, k, v, seg, out, lse, sinks))
    qb = bound(6 * d * hq * pairs, nbytes(q, k, v, seg, out, dout, lse, q,
                                          di))
    kb = bound(8 * d * hq * pairs, nbytes(q, k, v, seg, dout, lse, di, k, v))
    n_seg = len(torch.unique(seg[seg != 0]))
    shape = (f"{label}: B={b} T={t} Hq={hq} Hkv={hkv} D={d} bf16, {n_seg} "
             f"segment(s), {int((seg == 0).sum())} pad")
    common = dict(shape=shape, library="compiled flex_attention(return_lse)"
                  " + sigmoid(lse - sink) rescale")
    res = {
        "flash_sinks_fwd": dict(common, err=max(errs["out"][0], lse_err),
                                ms=fwd_ms, plain_ms=fwd_plain,
                                bound_ms=fb[0], bound_by=fb[1],
                                library_ms=flex_fwd),
        "flash_sinks_dq": dict(common, err=max(errs["dq"][0], dsk_err),
                               ms=dq_ms, plain_ms=bwd_plain, bound_ms=qb[0],
                               bound_by=qb[1], library_ms=flex_bwd),
        "flash_sinks_dkv": dict(common, err=max(errs["dk"][0],
                                                errs["dv"][0]),
                                ms=dkv_ms, plain_ms=bwd_plain,
                                bound_ms=kb[0], bound_by=kb[1],
                                library_ms=flex_bwd)}
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
        f"bound {kb[0]:.4f} ms; plain backward {bwd_plain:.4f} ms; compiled "
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


def _flex_sinks_ms(q, k, v, segment_ids, sinks, dout, flush, want, scale):
    """(forward ms, backward ms, row-wise error of its out against
    ``want``) of the library yardstick of K17: ``torch.compile``d
    ``flex_attention`` with ``return_lse`` (block mask of causal and equal
    segment ids, GQA, ``scale``) times sigmoid(lse - sink), in its [B, H, T,
    D] layout; the backward through both. A yardstick only, never called
    by the port; where flex refuses (an lse without a gradient), the
    failure is logged in place of the time."""
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

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        err = attn_row_err(flex(qt, kt, vt).transpose(1, 2), want)
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
    cache = init_cache(cfg, b, t + steps, device=dev)
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
    plus 8 decode steps on the card (kernels) and on the CPU (plain
    versions), same weights, same fed tokens.

    Tolerance: ||d||_2 <= 2e-2 ||ref||_2 and max|d| <= 0.1 max|ref| over
    all 9 steps' logits. Both run bf16 activations and round them at every
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
    card, fed = _prefill_decode_logits(params, cfg, ids.to(DEVICE), mask.to(DEVICE), 8)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref, _ = _prefill_decode_logits(cpu_params, cfg, ids, mask, 8, feed=fed)
    t_cpu = time.perf_counter() - t0
    d = card - ref
    rel = (d.norm() / ref.norm()).item()
    mx = d.abs().max().item()
    scale = ref.abs().max().item()
    agree = (card.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"[parity] 2-layer Llama-3.1-8B NF4, prefill 64 + 8 steps, B=2: "
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
    the card, as a loader gave it). Tolerance as in phase 4b: loss within
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

    cfg = ModelConfig.from_hf_config(dict(hf, num_hidden_layers=2))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    if params is None:
        params = quantize_params(init_params(cfg, gen, dtype=torch.bfloat16),
                                 cfg, dtype=torch.bfloat16)
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
    log(f"[train parity] 2-layer {label} NF4 + LoRA r=16, padded "
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
    from unsloth_tpu_torch.ops.qlora_matmul import nf4_matmul
    from unsloth_tpu_torch.ops.rms_norm import rms_norm

    nf4_matmul.launches = 0
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
                "rms_norm": rms_norm.launches}
    peak = torch.cuda.max_memory_allocated()
    n_new = sum(len(r) for r in out)
    decode_tps = (n_new - len(out)) / max(t_gen - t_prefill, 1e-9)
    log(f"[main] generate B=4, prompt 1000 tokens (bucketed to 1024), 64 "
        f"new: prefill {t_prefill:.3f} s (M = 4096 rows), total "
        f"{t_gen:.3f} s, {n_new} new tokens, decode {decode_tps:.1f} "
        f"tokens/s ({decode_tps / 4:.1f} per row)")
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
    _check_launched(launches, PACKED_KERNELS, "packed training")
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
                     markers=(INSTRUCTION, RESPONSE), load_in_4bit=True):
    """The notebook recipe's training at full width and depth from the
    checkpoint in ``tmp`` (phases 7, 8, 10 and 11), with every kernel's
    launch count and the peak memory reset first: from_pretrained(
    max_seq_length 2048, ``load_in_4bit``), get_peft_model(r=16, seven
    projections, "unsloth" checkpointing), SFTTrainer(packing=False) on the
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
    out = model.generate(prompts, max_new_tokens=n_new, temperature=0.0,
                         return_token_ids=True)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    log(f"[{tag}] generate {len(prompts)} prompts of "
        f"{[len(p_) for p_ in prompts]} tokens, {n_new} new: "
        f"{[len(r) for r in out]} tokens in {t_gen:.2f} s")
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
    the chunked CE). Then a greedy generate of 8 tokens for one prompt,
    which must launch K19 at decode rows (more launches than its prefill's
    3 x 24), and the trainer, its AdamW state and the adapter are freed.
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
    before = kernels["gmm"].launches
    model.for_inference()
    t0 = time.perf_counter()
    out = model.generate(prompt, max_new_tokens=8, temperature=0.0,
                         return_token_ids=True)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    gen_k19 = kernels["gmm"].launches - before
    log(f"[gpt-oss bf16] generate 1 prompt of {len(prompt[0])} tokens, 8 "
        f"new: {out} in {t_gen:.2f} s; K19 launches {gen_k19} (prefill "
        f"{3 * cfg.num_layers})")
    if len(out) != 1 or len(out[0]) != 8 or not all(
            0 <= t_ < cfg.vocab_size for t_ in out[0]):
        raise RuntimeError(f"generate did not return 1 x 8 tokens: {out}")
    if gen_k19 <= 3 * cfg.num_layers:
        raise RuntimeError(f"generate launched K19 {gen_k19} times: not at "
                           f"decode rows")
    # free the trainer, its AdamW state and the adapter before quantizing
    del trainer
    model.lora = None
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(metrics, generate_s=t_gen, generate_k19=gen_k19)


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
    tokens for 2 prompts (K14 at decode row counts, the cached attention
    with sinks and the window). With ``profile`` True, the bf16-expert
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
    before = {n: fn.launches for n, fn in kernels.items()}
    model.for_inference()
    t0 = time.perf_counter()
    out = model.generate(prompts, max_new_tokens=16, temperature=0.0,
                         return_token_ids=True)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    gen_k14 = kernels["nf4_gmm"].launches - before["nf4_gmm"]
    log(f"[gpt-oss] generate 2 prompts of {[len(p_) for p_ in prompts]} "
        f"tokens, 16 new: {[len(r) for r in out]} tokens in {t_gen:.2f} s; "
        f"K14 launches {gen_k14}")
    if len(out) != 2 or any(
            len(r) != 16 or not all(0 <= t_ < model.cfg.vocab_size for t_ in r)
            for r in out):
        raise RuntimeError(f"generate did not return 2 x 16 tokens: {out}")
    if gen_k14 <= 0:
        raise RuntimeError("generate ran the experts without K14")
    del trainer, model
    torch.cuda.empty_cache()
    return launches, bf16_launches, dict(metrics, eval=ev, generate_s=t_gen,
                                         bf16=bf16_metrics)


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
    n_matmul, n_head = _matmul_weights(trainer.model.cfg)
    real = sum(int((b.segment_ids != 0).sum()) for b in rows)
    row_tokens = sum(int(b.segment_ids.size) for b in rows)
    wall = wall_us / 1e6
    log(f"[profile] one step, {len(rows)} micro-batches, {row_tokens} row "
        f"tokens, {real} real: wall {wall:.3f} s, device events "
        f"{len(dev)}, summed {total / 1e3:.1f} "
        f"ms, busy (union) {busy / 1e3:.1f} ms = {100 * busy / wall_us:.1f}% "
        f"of wall (idle {100 - 100 * busy / wall_us:.1f}%)")
    hfu_flops = (6 * (n_matmul - n_head) + 4 * n_head) * row_tokens
    log(f"[profile] N = {n_matmul / 1e9:.3f}e9 matmul weights: MFU "
        f"{100 * 4 * n_matmul * real / wall / 989e12:.2f}%, HFU "
        f"{100 * hfu_flops / wall / 989e12:.2f}%")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                )[:top]:
        log(f"[profile] {us / 1e3:10.1f} ms {100 * us / total:5.1f}% "
            f"{n:6d}  {name[:110]}")
    # device time by kernel family (wrapper kernel names), and under the
    # port's profiler ranges (record_function: the MoE routing and
    # permutation glue, the banded attention), from their device spans
    families = {"K14/K15 nf4_gmm": ("nf4_gmm",), "K19 gmm": ("::gmm_kernel",),
                "K1/K2 nf4_matmul":
                ("nf4_matmul",), "K17 flash sinks": ("sinks_",),
                "K18 splash": ("splash_",), "K16 flash": ("attn_fwd_kernel",
                                                           "attn_dq_kernel",
                                                           "attn_dkv_kernel"),
                "K7/K8 CE": ("ce_fwd", "ce_bwd"), "K3/K4 RMSNorm":
                ("rms_norm",)}
    fam = {f_: sum(us for name, (us, _) in by_name.items()
                   if any(key in name for key in keys))
           for f_, keys in families.items()}
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


def _kernel_fns():
    """Each kernel's wrapper (its ``launches`` counter) by name."""
    from unsloth_tpu_torch.ops import cross_entropy as tce
    from unsloth_tpu_torch.ops import flash_attention as tfa
    from unsloth_tpu_torch.ops import flash_sinks as tfs
    from unsloth_tpu_torch.ops import gmm as tgmm
    from unsloth_tpu_torch.ops import nf4_gmm as tng
    from unsloth_tpu_torch.ops import packed_attention as tpa
    from unsloth_tpu_torch.ops import splash_attention as tsa
    from unsloth_tpu_torch.ops.qlora_matmul import nf4_matmul, nf4_matmul_dx
    from unsloth_tpu_torch.ops.rms_norm import rms_norm, rms_norm_bwd

    return {"nf4_matmul": nf4_matmul, "nf4_matmul_dx": nf4_matmul_dx,
            "rms_norm": rms_norm, "rms_norm_bwd": rms_norm_bwd,
            "cross_entropy_fwd": tce.cross_entropy_fwd,
            "cross_entropy_bwd": tce.cross_entropy_bwd,
            "packed_attn_fwd": tpa.packed_attention_fwd,
            "packed_attn_bwd": tpa.packed_attention_bwd,
            "flash_attn_fwd": tfa.flash_attention_fwd,
            "flash_attn_dq": tfa.flash_attention_dq,
            "flash_attn_dkv": tfa.flash_attention_dkv,
            "splash_attn_fwd": tsa.splash_attention_fwd,
            "splash_attn_dq": tsa.splash_attention_dq,
            "splash_attn_dkv": tsa.splash_attention_dkv,
            "nf4_gmm": tng.nf4_gmm, "nf4_gmm_dx": tng.nf4_gmm_dx,
            "flash_sinks_fwd": tfs.flash_sinks_fwd,
            "flash_sinks_dq": tfs.flash_sinks_dq,
            "flash_sinks_dkv": tfs.flash_sinks_dkv,
            "gmm": tgmm.gmm, "gmm_dx": tgmm.gmm_dx}


# the kernels each main path must launch
SERVING_KERNELS = ("nf4_matmul", "rms_norm")
TRAIN_KERNELS = ("nf4_matmul", "nf4_matmul_dx", "rms_norm", "rms_norm_bwd",
                 "cross_entropy_fwd", "cross_entropy_bwd")
PACKED_KERNELS = TRAIN_KERNELS + ("packed_attn_fwd", "packed_attn_bwd")
UNPACKED_KERNELS = TRAIN_KERNELS + ("flash_attn_fwd", "flash_attn_dq",
                                    "flash_attn_dkv")
GEMMA2_KERNELS = TRAIN_KERNELS + ("splash_attn_fwd", "splash_attn_dq",
                                  "splash_attn_dkv")
GPT_OSS_KERNELS = TRAIN_KERNELS + ("nf4_gmm", "nf4_gmm_dx", "flash_sinks_fwd",
                                   "flash_sinks_dq", "flash_sinks_dkv")
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


def _kernels_line(rows, by_path):
    """The result's "kernels" list: each kernel at a shape of phase 3
    (``rows``) on the path whose launches it reports (``by_path``: the
    launch counts of each main path's run), and the head-dim forms of the
    small-model paths as entries of their own."""
    k16 = "unsloth_tpu/ops/attention.py:415 (bundled flash_attention "
    k18 = "unsloth_tpu/ops/attention.py:231 (_splash_kernel: bundled splash "
    picks = {
        "nf4_matmul": ("nf4_matmul.cu", "unsloth_tpu/ops/qlora_matmul.py:155",
                       "gate/up M=8192 N=14336 K=4096"),
        "nf4_matmul_dx": ("nf4_matmul.cu",
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
        "packed_attn_fwd": ("packed_attention.cu",
                            "unsloth_tpu/ops/packed_attention.py:109", None),
        "packed_attn_bwd": ("packed_attention.cu",
                            "unsloth_tpu/ops/packed_attention.py:224 and "
                            ":316", None),
        "flash_attn_fwd": ("flash_attention.cu", k16 + "forward)", None),
        "flash_attn_dq": ("flash_attention.cu",
                          k16 + "_flash_attention_bwd_dq)", None),
        "flash_attn_dkv": ("flash_attention.cu",
                           k16 + "_flash_attention_bwd_dkv)", None),
        "splash_attn_fwd": ("splash_attention.cu", k18 + "forward)",
                            "(a) sliding"),
        "splash_attn_dq": ("splash_attention.cu", k18 + "dq)", "(a) sliding"),
        "splash_attn_dkv": ("splash_attention.cu", k18 + "dk/dv)",
                            "(a) sliding"),
        "nf4_gmm": ("nf4_gmm.cu", "unsloth_tpu/ops/nf4_gmm.py:86", "(a) path"),
        "nf4_gmm_dx": ("nf4_gmm.cu", "unsloth_tpu/ops/nf4_gmm.py:135",
                       "(a) path"),
        "flash_sinks_fwd": ("flash_sinks.cu",
                            "unsloth_tpu/ops/attention.py:456 (_tpu_flash_"
                            "sinks: bundled _flash_attention_impl)",
                            "(a) packed row"),
        "flash_sinks_dq": ("flash_sinks.cu",
                           "unsloth_tpu/ops/attention.py:487 (_tpu_flash_"
                           "sinks: bundled _flash_attention_bwd_dq)",
                           "(a) packed row"),
        "flash_sinks_dkv": ("flash_sinks.cu",
                            "unsloth_tpu/ops/attention.py:480 (_tpu_flash_"
                            "sinks: bundled _flash_attention_bwd_dkv)",
                            "(a) packed row"),
        "gmm": ("gmm.cu", "unsloth_tpu/ops/moe.py:249 (tiled_gmm: bundled "
                "megablox gmm, transpose_rhs=True)", "(a) path"),
        "gmm_dx": ("gmm.cu", "unsloth_tpu/ops/moe.py:249 (megablox gmm's "
                   "VJP: gmm with transpose_rhs flipped)", "(a) path"),
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
                 "gmm_dx": "gpt_oss_bf16_training"}
    # the head-dim forms of this slice: (kernel, form, shape in phase 3,
    # the path whose launches are all of this form)
    forms = {
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
    }
    has_forms = {k_ for k_, *_ in forms.values()}
    form_paths = {p_ for *_, p_ in forms.values()} | {"qwen25_training",
                                                       "llama32_2layer_parity"}
    entries = [(k_, k_, None, shape, main_path.get(k_, "unpacked_training"))
               for k_, (_, _, shape) in picks.items()]
    entries += [(n_, k_, form, shape, path)
                for n_, (k_, form, shape, path) in forms.items()]
    kernels_line = []
    for name_, kname, form, shape, path in entries:
        src, replaces, _ = picks[kname]
        of_form = [r for r in rows[kname] if r.get("form") == form]
        row = next(r for r in of_form
                   if shape is None or r["shape"].startswith(shape))
        # a kernel with head-dim forms counts, under each form, only the
        # paths that run that form
        by_form = ({p_: n[kname] for p_, n in by_path.items() if kname in n
                    and not (kname in has_forms and p_ in form_paths)}
                   if form is None else {path: by_path[path][kname]})
        if form == "d64" and kname.startswith("flash"):
            by_form["qwen25_training"] = by_path["qwen25_training"][kname]
        kernels_line.append({
            "name": name_, "route": "cuda",
            "source": f"unsloth_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": by_path[path][kname],
            "max_abs_err": max(r["err"] for r in of_form),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
            "launches_by_path": by_form,
            **{key: row[key] for key in ("sdpa_no_softcap_ms", "library")
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
                                       True)}
    if tuple(sys.argv[1:]) not in profiles:
        print(f"usage: {sys.argv[0]} [--profile-train | "
              "--profile-train-unpacked | --profile-train-gemma2 | "
              "--profile-train-gpt-oss | --profile-train-gpt-oss-bf16 | "
              "--profile-train-llama32]", file=sys.stderr)
        return 2
    profile = profiles[tuple(sys.argv[1:])]
    t_start = time.perf_counter()

    def timed(phase, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        log(f"[time] {phase}: {time.perf_counter() - t0:.1f} s (script "
            f"{time.perf_counter() - t_start:.1f} s)")
        return out

    name, smi = timed("1 device", phase_device)
    timed("2 build", phase_build)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if profile:
            # phases 1, 2 and 6, 7, 8, 9 or 10 only, then a profiled step;
            # no result line
            fn, config, *bnb4 = profile
            fn(_write_model(os.path.join(tmp, "model"), config, *bnb4),
               profile=True)
            return 0
        rows = timed("3 kernels", phase_kernels)
        timed("3b CE routes", phase_ce_routes)
        timed("4 parity", phase_slice_parity)
        timed("4b train parity", phase_train_parity)
        timed("4b train parity padded", phase_train_parity_padded)
        timed("4c Gemma-2 train parity", phase_train_parity_padded,
              GEMMA2_9B_CONFIG, expect=GEMMA2_KERNELS,
              absent=("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv",
                      "packed_attn_fwd", "packed_attn_bwd"),
              label="Gemma-2-9B (a sliding and a global layer)",
              seed=SEED + 8)
        timed("4d gpt-oss train parity", phase_train_parity_gpt_oss)
        small = timed("4e small-model train parity",
                      phase_train_parity_small, tmp)
        llama = timed("5 write Llama", _write_model,
                      os.path.join(tmp, "llama31_8b"), LLAMA_31_8B_CONFIG)
        serve_launches, _ = timed("5 serving", phase_main_path, llama)
        packed_launches, _ = timed("6 packed training", phase_train_main,
                                   llama)
        unpacked_launches, _ = timed("7 unpacked SFT", phase_unpacked_sft,
                                     llama)
        shutil.rmtree(llama)   # the disk holds one checkpoint at a time
        gemma2 = timed("8 write Gemma-2", _write_model,
                       os.path.join(tmp, "gemma2_9b"), GEMMA2_9B_CONFIG)
        gemma2_launches, _ = timed("8 Gemma-2 SFT", phase_gemma2_sft, gemma2)
        shutil.rmtree(gemma2)
        gpt_oss = timed("9 write gpt-oss", _write_model,
                        os.path.join(tmp, "gpt_oss_20b"), GPT_OSS_20B_CONFIG)
        gpt_oss_launches, bf16_launches, _ = timed(
            "9 gpt-oss SFT", phase_gpt_oss_sft, gpt_oss)
        shutil.rmtree(gpt_oss)
        llama32 = timed("10 write Llama-3.2 (bnb-4bit)", _write_model,
                        os.path.join(tmp, "llama32_1b_bnb"),
                        LLAMA_32_1B_CONFIG, True)
        llama32_launches, _ = timed("10 Llama-3.2 SFT", phase_llama32_sft,
                                    llama32)
        shutil.rmtree(llama32)
        qwen = timed("11 write Qwen2.5", _write_model,
                     os.path.join(tmp, "qwen25_05b"), QWEN25_05B_CONFIG)
        qwen_launches, _ = timed("11 Qwen2.5 SFT", phase_qwen25_sft, qwen)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the launch counts of each main path's run
    by_path = {"serving": serve_launches, "packed_training": packed_launches,
               "unpacked_training": unpacked_launches,
               "gemma2_training": gemma2_launches,
               "gpt_oss_training": gpt_oss_launches,
               "gpt_oss_bf16_training": bf16_launches,
               "llama32_training": llama32_launches,
               "qwen25_training": qwen_launches,
               "llama32_2layer_parity": small["llama32"],
               "gemma7b_2layer_parity": small["gemma"],
               "gpt_oss_sinks_row_parity": small["gpt_oss"]}
    log(f"[time] whole script {time.perf_counter() - t_start:.1f} s")
    kernels_line = _kernels_line(rows, by_path)
    print(json.dumps({"kernels": kernels_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
