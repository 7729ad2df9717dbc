#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing a result:

  1. device    card name, capability (must be 9.0), CUDA and nvcc versions,
               the card's name and power limit from nvidia-smi;
  2. build     compile the package's CUDA kernels from csrc/ (timed);
  3. kernels   each kernel against its plain PyTorch version on the card at
               every Llama-3.1-8B projection shape, with median times;
  4. parity    Llama-3.1-8B cut to 2 layers, random NF4 weights: prefill 64
               tokens + 8 decode steps on the card (kernels) and on the CPU
               (plain versions, same weights), logits compared;
  5. main path a random-init bf16 Llama-3.1-8B checkpoint (full width, all
               32 layers) is written as index-sharded safetensors, loaded
               with FastLanguageModel.from_pretrained(load_in_4bit=True),
               served by InferenceServer over HTTP (3 requests) and run
               through model.generate on 4 prompts of 1,000 tokens.

Then one JSON line with each kernel's launches on the main path, its
largest error against its plain version, and its time beside the plain
version's; the nvidia-smi line; and last the result line
{"ok": true, "device": {...}}. It needs one CUDA card and exits non-zero
without it.
"""

from __future__ import annotations

import json
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

# (name, N = out features, K = in features) of every Llama-3.1-8B projection
PROJ_SHAPES = [("q/o", 4096, 4096), ("k/v", 1024, 4096),
               ("gate/up", 14336, 4096), ("down", 4096, 14336)]
DECODE_ROWS = (1, 4, 7)
PREFILL_ROWS = 4096
SEED = 0
DEVICE = "cuda:0"


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


def ulps_bf16_or_f32(err, ref, dtype):
    """|err| in units of the last place of ref in ``dtype``."""
    import torch

    _, e = torch.frexp(ref.to(torch.float32))
    mant = 8 if dtype == torch.bfloat16 else 24
    ulp = torch.ldexp(torch.ones_like(ref, dtype=torch.float32), e - mant)
    ulp = torch.where(ref == 0, torch.full_like(ulp, 2.0 ** -133), ulp)
    return (err.abs() / ulp).max().item()


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
    """Each kernel against its plain version at the main path's shapes.

    Tolerances: NF4 matmul in bf16, max|y - ref| <= 1e-2 * max|ref| (both
    round the same bf16 weights and sum in fp32, in another order, then
    round the output to bf16: one output ulp is <= 2^-8 of the value).
    RMSNorm: <= 1 ulp of the output dtype for bf16 (the fp32 result differs
    in the last fp32 bits, then rounds); <= 8 fp32 ulp for fp32 (another
    sum order and rsqrtf)."""
    import torch

    from unsloth_tpu_torch.ops.nf4 import dequantize_nf4, quantize_nf4
    from unsloth_tpu_torch.ops.qlora_matmul import nf4_matmul
    from unsloth_tpu_torch.ops.rms_norm import rms_norm, rms_norm_ref

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = {"nf4_matmul": [], "rms_norm": []}
    for name, n, k in PROJ_SHAPES:
        w = (torch.randn((n, k), generator=g, device=dev) * 0.02
             ).to(torch.bfloat16)
        q = quantize_nf4(w, dtype=torch.bfloat16)
        del w
        for m in DECODE_ROWS + (PREFILL_ROWS,):
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
            rows["nf4_matmul"].append(dict(shape=f"{name} M={m} N={n} K={k}",
                                           err=err, tol=1e-2 * scale,
                                           ms=ms, plain_ms=plain_ms))
            log(f"[kernels] nf4_matmul {name:8s} M={m:<5d} N={n:<6d} K={k:<6d}"
                f" max|d|={err:.3e} (tol {1e-2 * scale:.3e})"
                f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
            if not ok:
                raise RuntimeError(f"nf4_matmul disagrees at {name} M={m}: "
                                   f"max|d| {err} > 1e-2 * {scale}")
    for shape in ((4096, 4096), (4, 4096)):
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
                rows["rms_norm"].append(dict(
                    shape=f"{list(shape)} {str(dtype)[6:]} gemma={gemma}",
                    err=d.abs().max().item(), ulps=ulps, ms=ms,
                    plain_ms=plain_ms))
                log(f"[kernels] rms_norm {list(shape)} {str(dtype)[6:]:8s} "
                    f"gemma={gemma!s:5s} max|d|={d.abs().max().item():.3e} "
                    f"({ulps:.2f} ulp, limit {limit}) kernel {ms:.4f} ms "
                    f"plain {plain_ms:.4f} ms")
                if not (bool(torch.isfinite(y).all()) and ulps <= limit):
                    raise RuntimeError(f"rms_norm disagrees at {shape} {dtype}"
                                       f" gemma={gemma}: {ulps} ulp")
    del flush
    torch.cuda.empty_cache()
    return rows


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


def write_checkpoint(path):
    """Random-init bf16 checkpoint with the published Llama-3.1-8B shapes:
    config.json plus index-sharded safetensors, one tensor at a time."""
    import torch

    from unsloth_tpu_torch.io_safetensors import save_sharded

    c = LLAMA_31_8B_CONFIG
    d, f, v = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    dkv = c["num_key_value_heads"] * c["head_dim"]
    entries = [("model.embed_tokens.weight", (v, d))]
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        entries += [(p + "input_layernorm.weight", (d,)),
                    (p + "self_attn.q_proj.weight", (d, d)),
                    (p + "self_attn.k_proj.weight", (dkv, d)),
                    (p + "self_attn.v_proj.weight", (dkv, d)),
                    (p + "self_attn.o_proj.weight", (d, d)),
                    (p + "post_attention_layernorm.weight", (d,)),
                    (p + "mlp.gate_proj.weight", (f, d)),
                    (p + "mlp.up_proj.weight", (f, d)),
                    (p + "mlp.down_proj.weight", (d, f))]
    entries += [("model.norm.weight", (d,)), ("lm_head.weight", (v, d))]
    index = {name: i for i, (name, _) in enumerate(entries)}
    shapes = dict(entries)

    def produce(name):
        if name.endswith("norm.weight"):
            return torch.ones(shapes[name], dtype=torch.bfloat16)
        g = torch.Generator(device=DEVICE).manual_seed(SEED * 1000 + index[name])
        w = torch.randn(shapes[name], generator=g, device=DEVICE) * 0.02
        return w.to(torch.bfloat16).cpu()

    save_sharded(path, [(n, torch.bfloat16, s) for n, s in entries], produce)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(c, fh, indent=2)


def _http(method, url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def phase_main_path():
    """The user's path at full width and depth: load + quantize, serve three
    greedy requests over HTTP, then one batch-4 generate."""
    import numpy as np
    import torch

    from unsloth_tpu_torch import FastLanguageModel, InferenceServer
    from unsloth_tpu_torch.ops.qlora_matmul import nf4_matmul
    from unsloth_tpu_torch.ops.rms_norm import rms_norm

    tmp = tempfile.mkdtemp(prefix="chip_smoke_llama31_8b_")
    try:
        t0 = time.perf_counter()
        write_checkpoint(tmp)
        size = sum(os.path.getsize(os.path.join(tmp, n)) for n in os.listdir(tmp))
        n_files = sum(n.endswith(".safetensors") for n in os.listdir(tmp))
        log(f"[main] wrote {n_files} safetensors files, "
            f"{size / 1e9:.2f} GB, in {time.perf_counter() - t0:.1f} s")

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
        for name, n in launches.items():
            if n <= 0:
                raise RuntimeError(f"{name} kernel never launched on the main "
                                   "path")

        # the served model's logits are finite and of the expected shape
        ids = torch.tensor(prompts, device=DEVICE)[:, :64]
        logits, _ = _prefill_decode_logits(model.params, model.cfg, ids,
                                           torch.ones_like(ids), 1)
        if logits.shape != (2, 4, model.cfg.vocab_size) or \
                not torch.isfinite(logits).all():
            raise RuntimeError(f"bad logits {tuple(logits.shape)}")
        return launches, dict(load_s=t_load, prefill_s=t_prefill,
                              decode_tps=decode_tps, peak_bytes=peak)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    name, smi = phase_device()
    phase_build()
    rows = phase_kernels()
    phase_slice_parity()
    launches, _ = phase_main_path()

    picks = {"nf4_matmul": ("unsloth_tpu_torch/csrc/nf4_matmul.cu",
                            "unsloth_tpu/ops/qlora_matmul.py:155",
                            "gate/up M=1 N=14336 K=4096"),
             "rms_norm": ("unsloth_tpu_torch/csrc/rms_norm.cu",
                          "unsloth_tpu/ops/rms_norm.py:70",
                          "[4, 4096] bfloat16 gemma=False")}
    kernels_line = []
    for kname, (src, replaces, shape) in picks.items():
        row = next(r for r in rows[kname] if r["shape"] == shape)
        kernels_line.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max(r["err"] for r in rows[kname]),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "shape": shape})
    print(json.dumps({"kernels": kernels_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
