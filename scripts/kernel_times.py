"""Time K1 (the NF4 matmul forward), K2 (its backward, dx = g @ W), K4
(the RMSNorm backward), K5 and K6 (the LayerNorm forward and backward),
K12 and K13 (the FP8 matmul forward and its dx),
K14 and K15 (the grouped NF4 expert forward and its dx), K9 (the packed
attention forward) and K10/K11 (its backward) of one tree of the port on
the card, at the shapes of ``chip_smoke.py``'s phase 3, beside the
two-call yardsticks of K1, K2, K12 and K13 (dequantize, then
``torch.matmul``), of K14 and K15 (dequantize the stack, then
``torch._grouped_mm``, K14 plus the bias gathered by row),
``F.layer_norm`` and, for K9 and K10/K11, ``F.scaled_dot_product_attention``
with the segments' causal mask (forward; backward by autograd).

    python scripts/kernel_times.py [--tree DIR] [--label NAME]
                                   [--only K1|K2|K4|K5|K6|K9|K10|K12|K13|K14|K15|K19[,...]]
                                   [--repeats R] [--decode] [--sweep]

Imports ``unsloth_tpu_torch`` from DIR (default: this checkout), so that a
parent commit unpacked with ``git archive`` and this tree can be timed in
turns in one call on one card; builds DIR's kernels; prints the card's
name and power limit, then one JSON object a shape: the kernel's time and
the yardstick's (medians of 20 CUDA-event runs after 3 warm-up runs, a
256-MB buffer zeroed before each run so that the weights come from device
memory), the bound (the larger of 2 M N K operations at 989 TFLOP/s and
the bytes at 3.35 TB/s; K5 bytes only) and max|y - ref| / max|ref|
against the two calls (``x @ dequantize_nf4(W)^T``, ``g @
dequantize_nf4(W)``, ``x @ dequantize_fp8(W)^T``, ``g @
dequantize_fp8(W)``, the grouped two calls) or ``layer_norm_ref``.
Inputs are made on the card from seed 0 as phase 3 makes them (K12's and
K13's weights with per-block magnitudes, as ``chip_smoke.fp8_weight``;
K14's routings (a) a top-4 of 4,096 random tokens over 32 experts by a
random router, (b) one expert half the rows and three the rest, (c) a
top-4 of 2 tokens; K15's g the same rows' gradients, and its per-call
absmax transpose timed on its own; K9's 8K packed row of 15 documents of
64-1,024 tokens and a pad tail, Llama-3.1-8B's 32/8 heads of 128, with
the time of the q * bf16(scale) pass that the tree's K9 adds on its own;
K10/K11 on that row and on a 2,048-token row of Orpheus-3B's 24/8 heads of
128 with documents of 316-1,966 tokens, the lengths of phase 14's TTS
examples, fed the tree's K9 out and lse, beside K16's dq and dk/dv at
scale 1 on the pre-scaled q with dq * scale in one bf16 pass, and the
bound of 10 D operations a valid pair and head). A tree whose
``packed_attention_fwd`` or ``packed_attention_bwd`` still takes the
segment metadata (``kv_lo``, ``q_hi``, ``n_kv``) is called with it.

K1 and K12 also run at the decode rows M = 1, 4, 7 and 16 at all four
Llama-3.1-8B shapes (block 128 for K12); there the line adds the device
time of one call (``device_ms``: CUDA events around the call, recorded
behind the 256-MB zeroing and a 50-us ``torch.cuda._sleep``, so that the
host has queued the call before the card reaches it and the time is the
card's alone; median of 20) and ``kernels_per_call`` (the kernels one
call launches, from ``torch.profiler``'s trace over 10 calls, the
zeroing's own kernel left out).
K4 (the RMSNorm backward) and K6 (the LayerNorm backward) run at
NORM_SHAPES (``--only K4`` or ``K6``), in both forms where the tree has
them (``need_dw`` False: dx alone, as every LoRA path asks; True: dx with
dW, and dB for K6; a parent without the flag computes dW always and is
timed once): the wrapper's time, the card's, the host's time to queue
a call (``host_ms``: 50 calls back to back on the host's clock), the
device operations of one call by name (``split``: ms a call of each kernel, memset and copy in
``torch.profiler``'s trace, L2 flushed before each call; ``device_ms``
their sum), the library's backward (``F.rms_norm`` with
the scale ``w`` or ``1 + w``, ``F.layer_norm``, under autograd with the
same leaves; its wrapper, card, host and device times), the bound (x and g read, dx written, w read, dW and dB
written; bytes at 3.35 TB/s against 8 (K4) or 14 (K6) fp32 operations an
element at 67 TFLOP/s) and the largest errors against the plain versions.
K14 and K19's forward also run at decode rows (``--only K14`` or
``K19``, or ``--decode``): gpt-oss-20b's experts (E = 32, N = K = 2,880,
K14 at block 32; the bf16 bias), routed top-4 from 1, 2 and 4 random
tokens by a random router (m = 4, 8, 16) and 16 rows skewed over 4
experts, with ``device_ms`` and ``kernels_per_call`` as above, beside
K14's grouped two calls and K19's ``torch._grouped_mm`` (each + the bias
gathered by row) and the bound (the bytes of the rows, of the experts with
rows and their bias rows, and of the output), and for K19 the card's time of a plain
``torch.sum`` read of the experts with rows; ``--sweep`` adds the card's
time of each under every row group (128, 64, 32 W rows) and slice count
(1, 2, 4) the x slice allows (the tree's grouped schedule patched).
``--repeats R`` reports every time as the median of R medians;
``--decode`` runs those decode rows of K1, K12, K14 and K19 alone.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# rows of x at which K1 and K12 run their decode form
DECODE_M = (1, 4, 7, 16)
# (name, N, K, rows) of phase 3's K1 rows, and K5's (rows, D, dtype, bias)
K1_SHAPES = (
    [(name, n, k, (1, 4, 7, 16, 64, 256, 1500, 4096, 8192))
     for name, n, k in
     (("q/o", 4096, 4096), ("k/v", 1024, 4096), ("gate/up", 14336, 4096),
      ("down", 4096, 14336))]
    + [("gemma2 " + name, n, k, (4096,)) for name, n, k in
       (("q", 4096, 3584), ("k/v", 2048, 3584), ("o", 3584, 4096),
        ("gate/up", 14336, 3584), ("down", 3584, 14336))]
    + [("gpt-oss " + name, n, k, (4096,)) for name, n, k in
       (("q", 4096, 2880), ("k/v", 512, 2880), ("o", 2880, 4096))])
K5_SHAPES = ((3000, 1280, "bfloat16", True), (3000, 1280, "float32", True),
             (448, 1280, "bfloat16", True), (3000, 1280, "bfloat16", False))
# (name, N, K, rows) of phase 3's K2 rows: g [rows, N], W [N, K]
K2_SHAPES = (
    [(name, n, k, 8192) for name, n, k in
     (("q/o", 4096, 4096), ("k/v", 1024, 4096), ("gate/up", 14336, 4096),
      ("down", 4096, 14336))]
    + [("gemma2 " + name, n, k, 4096) for name, n, k in
       (("q", 4096, 3584), ("k/v", 2048, 3584), ("o", 3584, 4096),
        ("gate/up", 14336, 3584), ("down", 3584, 14336))]
    + [("gpt-oss " + name, n, k, 4096) for name, n, k in
       (("q", 4096, 2880), ("k/v", 512, 2880), ("o", 2880, 4096))])
# (name, N, K, block, rows) of phase 3's K12 rows
K12_SHAPES = (
    [(name, n, k, 128, 4096) for name, n, k in
     (("q/o", 4096, 4096), ("k/v", 1024, 4096), ("gate/up", 14336, 4096),
      ("down", 4096, 14336))]
    + [(name, n, k, 128, m) for name, n, k in
       (("q/o", 4096, 4096), ("k/v", 1024, 4096), ("gate/up", 14336, 4096),
        ("down", 4096, 14336)) for m in DECODE_M]
    + [("ragged", 1000, 1404, 32, 333), ("ragged", 1000, 1404, 32, 4)])
# (name, N, K, block, rows) of phase 3's K13 rows: g [rows, N], W [N, K]
K13_SHAPES = (
    [(name, n, k, 128, 4096) for name, n, k in
     (("q/o", 4096, 4096), ("k/v", 1024, 4096), ("gate/up", 14336, 4096),
      ("down", 4096, 14336))]
    + [("ragged", 1000, 1404, 32, 333)])
# (kernel, rows, D, dtype, gemma) of K4 at every main path's width (Llama-
# 3.1-8B's packed 8K row, Gemma-2-9B's 2 x 2,048 rows, gpt-oss-20b's 4,096,
# Orpheus-3B's 2,048, Llama-3.2-1B's and Qwen2.5-0.5B's 2 x 2,048) and of
# K6 at Whisper-large-v3's (2 x 1,500 encoder frames, 2 x 224 decoder
# tokens; the fp32 form of phase 4g)
NORM_SHAPES = (("K4", 8192, 4096, "bfloat16", False),
               ("K4", 4096, 3584, "bfloat16", True),
               ("K4", 4096, 2880, "bfloat16", False),
               ("K4", 2048, 3072, "bfloat16", False),
               ("K4", 4096, 2048, "bfloat16", False),
               ("K4", 4096, 896, "bfloat16", False),
               ("K6", 3000, 1280, "bfloat16", False),
               ("K6", 448, 1280, "bfloat16", False),
               ("K6", 3000, 1280, "float32", False))
# K14, K15: gpt-oss-20b's experts (E, N = K, block) and the routed rows
K14_EXPERTS = (32, 2880, 32)
K14_TOKENS, K14_TOP_K = 4096, 4
# K9: one packed row of Llama-3.1-8B attention (T, Hq, Hkv, D) and its
# documents' lengths (chip_smoke.DOC_LENGTHS)
K9_SHAPE = (8192, 32, 8, 128)
K9_DOCS = (64, 1024)
# K10/K11: (name, (T, Hq, Hkv, D), documents' lengths): the K9 row, and a
# packed row of phase 14 (Orpheus-3B: 7 SNAC codes a frame for 40-250
# frames, 20-200 text bytes and 16 more tokens an example)
K10_ROWS = (("Llama-3.1-8B 8K row", K9_SHAPE, K9_DOCS),
            ("Orpheus-3B 2K row", (2048, 24, 8, 128), (316, 1966)))


def fp8_weight(n, k, g, dev, block):
    """randn * 0.02 times 2^u per block x block tile, u uniform in [-2,
    2] (chip_smoke.fp8_weight)."""
    import torch

    nb, kb = -(-n // block), -(-k // block)
    f = torch.exp2(torch.rand((nb, kb), generator=g, device=dev) * 4 - 2)
    f = f.repeat_interleave(block, 0).repeat_interleave(block, 1)[:n, :k]
    return (torch.randn((n, k), generator=g, device=dev) * 0.02 * f).to(
        torch.bfloat16)


def bound_ms(m, n, k, nbytes):
    return 1e3 * max(2 * m * n * k / 989e12, nbytes / 3.35e12)


REPEATS = 1


def time_ms(fn, flush, runs=20, warmup=3):
    """The median of REPEATS medians of ``runs`` CUDA-event-timed runs."""
    return statistics.median(_time_once(fn, flush, runs, warmup)
                             for _ in range(REPEATS))


def device_ms(fn, flush, runs=20):
    """(the median of REPEATS medians of the card's time of one call, the
    kernels a call launches): :func:`card_ms` and :func:`kernels_per_call`."""
    return card_ms(fn, flush, runs), kernels_per_call(fn, flush)


def card_ms(fn, flush, runs=20):
    """The median of REPEATS medians of the card's time of one call. Each
    call is timed by CUDA events recorded after ``flush`` is zeroed and the
    card has slept ~50 us, time in which the host queues the call: the
    events then bracket the card's work alone, not the host's launch
    overhead."""
    import torch

    fn()
    times = []
    for _ in range(REPEATS):
        one = []
        for _ in range(runs):
            flush.zero_()
            torch.cuda._sleep(100_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            one.append(start.elapsed_time(end))
        times.append(statistics.median(one))
    return statistics.median(times)


def host_ms(fn, runs=50):
    """The median of five host times to queue one call of ``fn``: ``runs``
    calls back to back (no flush, nothing synchronized between them) on
    the host's clock, the card synchronized before: what a call costs the
    host, however short its kernels."""
    import torch

    fn()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        times.append(1e3 * (time.perf_counter() - t0) / runs)
    torch.cuda.synchronize()
    return statistics.median(times)


def kernels_per_call(fn, flush, runs=10):
    """The kernels one call of ``fn`` launches, from ``torch.profiler``'s
    chrome trace over ``runs`` calls, each after ``flush`` is zeroed; the
    zeroing's kernels (their names profiled alone first) are left out."""
    return _device_once(fn, flush, runs)[1]


def _kernel_events(body, cats=("kernel",)):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        body()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    return [e for e in events if e.get("cat") in cats]


def op_split(fn, flush, runs=10):
    """{name: ms a call} of every device operation (kernel, memset, copy)
    one call of ``fn`` runs, from ``torch.profiler``'s chrome trace over
    ``runs`` calls, each after ``flush``'s bits are flipped (a kernel that
    no call runs, where a zeroing could share its name with a zero fill or
    a memset of the call), that kernel (profiled alone first) left out;
    and the operations a call."""
    fn()
    cats = ("kernel", "gpu_memset", "gpu_memcpy")
    flush_names = {e["name"] for e in _kernel_events(flush.bitwise_not_,
                                                     cats)}

    def body():
        for _ in range(runs):
            flush.bitwise_not_()
            fn()

    split = {}
    ops = [e for e in _kernel_events(body, cats)
           if e["name"] not in flush_names]
    for e in ops:
        split[e["name"]] = split.get(e["name"], 0.0) + float(e["dur"]) \
            / runs / 1e3
    return split, len(ops) / runs


def _device_once(fn, flush, runs):
    fn()
    flush_names = {e["name"] for e in _kernel_events(flush.zero_)}

    def body():
        for _ in range(runs):
            flush.zero_()
            fn()

    ks = [e for e in _kernel_events(body) if e["name"] not in flush_names]
    return (sum(float(e["dur"]) for e in ks) / runs / 1e3,
            len(ks) / runs)


def _time_once(fn, flush, runs, warmup):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k14_times(dev, g, flush, label, dx=False):
    """K14 (``dx`` False) or K15 at phase 3's three routings of
    gpt-oss-20b's experts (K14 with the bias), beside the grouped two
    calls."""
    import torch

    from unsloth_tpu_torch.ops import nf4_gmm as tng
    from unsloth_tpu_torch.ops.nf4 import (dequantize_nf4_stacked,
                                           quantize_nf4_stacked)

    e, d, block = K14_EXPERTS
    q = quantize_nf4_stacked((torch.randn((e, d, d), generator=g, device=dev)
                              * 0.02).to(torch.bfloat16), block_size=block)
    bias = (torch.randn((e, d), generator=g, device=dev) * 0.5).to(
        torch.bfloat16)
    router = torch.randn((e, d), generator=g, device=dev) * 0.02

    def routed(tokens):
        x = torch.randn((tokens, d), generator=g, device=dev).to(
            torch.bfloat16)
        sel = torch.topk(x.float() @ router.t(), K14_TOP_K, dim=-1).indices
        flat = sel.reshape(-1)
        order = torch.argsort(flat, stable=True)
        sizes = torch.bincount(flat, minlength=e).to(torch.int32)
        return x[order // K14_TOP_K], sizes

    m = K14_TOKENS * K14_TOP_K
    skew = torch.zeros(e, dtype=torch.int32)
    skew[3] = m // 2
    skew[[0, e // 2 + 1, e - 1]] = torch.tensor(
        [m // 6, m // 6, m - m // 2 - 2 * (m // 6)], dtype=torch.int32)
    for case, (x, sizes) in (
            ("(a) path", routed(K14_TOKENS)),
            ("(b) skewed", (torch.randn((m, d), generator=g, device=dev
                                        ).to(torch.bfloat16), skew.to(dev))),
            ("(c) decode", routed(2))):
        rows = x.shape[0]
        offs = sizes.cumsum(0).to(torch.int32)

        def two_calls():
            wd = dequantize_nf4_stacked(q, torch.bfloat16)
            return torch._grouped_mm(x, wd.transpose(1, 2), offs=offs) \
                + bias[torch.repeat_interleave(
                    torch.arange(e, device=dev), sizes.long(),
                    output_size=rows)]

        gy = torch.randn((rows, d), generator=g, device=dev).to(
            torch.bfloat16)

        def two_calls_dx():
            wd = dequantize_nf4_stacked(q, torch.bfloat16)
            return torch._grouped_mm(
                gy, wd.transpose(1, 2).contiguous().transpose(1, 2),
                offs=offs)

        if dx:
            ref = tng.nf4_gmm_ref(gy, q, sizes, transpose=True)
            fn, lib_fn = (lambda: tng.nf4_gmm_dx(gy, q, sizes)), two_calls_dx
        else:
            ref = tng.nf4_gmm_ref(x, q, sizes, bias)
            fn, lib_fn = (lambda: tng.nf4_gmm_fwd(x, q, sizes, bias)), \
                two_calls
        try:
            lib = time_ms(lib_fn, flush)
        except RuntimeError as exc:  # the yardstick only: reported
            lib = f"torch._grouped_mm failed: {exc!r}"[:160]
        live = int((sizes > 0).sum())
        nbytes = rows * d * 2 + live * (d * d // 2 + d * d // block * 4
                                        + (0 if dx else d * 2)) + rows * d * 2
        y = fn()
        err = ((y.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        ms = time_ms(fn, flush)
        extra = {}
        if dx:
            extra["absmax_transpose_ms"] = time_ms(
                lambda: q.absmax.reshape(e, d, d // block).transpose(
                    1, 2).contiguous(), flush)
        print(json.dumps({"label": label, "kernel": "K15" if dx else "K14",
                          "shape": f"{case}: m={rows} E={e} N=K={d} "
                                   f"block {block}, {live} experts",
                          "ms": ms, "two_calls_ms": lib,
                          "bound_ms": bound_ms(rows, d, d, nbytes),
                          "rel_err": err, **extra}), flush=True)


def schedule_sweep(fn, module, policy, m, e, d, flush):
    """{"R rows x S": card ms} of ``fn`` (a call of ``module``'s decode
    form) under each row group R (128, 64, 32) and slice count S (1, 2, 4)
    whose x slice fits the shared memory, ``module.grouped_decode_schedule``
    patched for the sweep."""
    from unsloth_tpu_torch.ops import qlora_matmul as qm

    base = module.grouped_decode_schedule
    plan0 = base(m, e, d, d, policy)
    out = {}
    try:
        for rw in (8, 4, 2):
            for slices in (1, 2, 4):
                steps = -(-plan0.steps // slices)
                if qm._smem_bytes(policy, plan0.n_tiles, steps,
                                  rw) > qm.DECODE_MAX_SMEM:
                    continue
                plan = plan0._replace(
                    row_warps=rw, slices=-(-plan0.steps // steps),
                    slice_steps=steps, groups=-(-d // (16 * rw)))
                module.grouped_decode_schedule = \
                    lambda *a, plan=plan, **k: plan
                out[f"{16 * rw} rows x {plan.slices}"] = card_ms(fn, flush)
    finally:
        module.grouped_decode_schedule = base
    return out


def grouped_decode_times(dev, g, flush, label, which, sweep=False):
    """K14's and K19's forwards (``which``: "K14", "K19") at phase 3's
    decode routings of gpt-oss-20b's experts: the wrapper's time, the
    card's (:func:`device_ms`), the kernels a call launches, the
    yardstick's time and the bound; for K19 also the card's time of a
    plain read (``torch.sum``) of the experts with rows; with ``sweep``,
    the card's time under every row group and slice count
    (:func:`schedule_sweep`; the tree's decode forms only)."""
    import torch

    from unsloth_tpu_torch.ops import gmm as tgmm
    from unsloth_tpu_torch.ops import nf4_gmm as tng
    from unsloth_tpu_torch.ops.nf4 import (dequantize_nf4_stacked,
                                           quantize_nf4_stacked)

    e, d, block = K14_EXPERTS
    w = (torch.randn((e, d, d), generator=g, device=dev) * 0.02).to(
        torch.bfloat16)
    q = quantize_nf4_stacked(w, block_size=block)
    bias = (torch.randn((e, d), generator=g, device=dev) * 0.5).to(
        torch.bfloat16)
    router = torch.randn((e, d), generator=g, device=dev) * 0.02

    def routed(tokens):
        x = torch.randn((tokens, d), generator=g, device=dev).to(
            torch.bfloat16)
        sel = torch.topk(x.float() @ router.t(), K14_TOP_K, dim=-1).indices
        flat = sel.reshape(-1)
        order = torch.argsort(flat, stable=True)
        sizes = torch.bincount(flat, minlength=e).to(torch.int32)
        return x[order // K14_TOP_K], sizes

    skew = torch.zeros(e, dtype=torch.int32, device=dev)
    skew[[3, 9, 17, 30]] = torch.tensor([7, 5, 3, 1], dtype=torch.int32,
                                        device=dev)
    cases = [("m=4", routed(1)), ("m=8", routed(2)), ("m=16", routed(4)),
             ("m=16 skewed", (torch.randn((16, d), generator=g, device=dev
                                          ).to(torch.bfloat16), skew))]
    for case, (x, sizes) in cases:
        rows = x.shape[0]
        offs = sizes.cumsum(0).to(torch.int32)
        bias_rows = bias[torch.repeat_interleave(
            torch.arange(e, device=dev), sizes.long(), output_size=rows)]
        live = int((sizes > 0).sum())
        for kernel in which:
            if kernel == "K14":
                def fn():
                    return tng.nf4_gmm_fwd(x, q, sizes, bias)

                def lib_fn():
                    wd = dequantize_nf4_stacked(q, torch.bfloat16)
                    return torch._grouped_mm(x, wd.transpose(1, 2),
                                             offs=offs) + bias_rows

                ref = tng.nf4_gmm_ref(x, q, sizes, bias)
                w_bytes = d * d // 2 + d * d // block * 4
                module, policy = tng, "nf4"
            else:
                def fn():
                    return tgmm.gmm_fwd(x, w, sizes, bias)

                def lib_fn():
                    return torch._grouped_mm(x, w.transpose(1, 2),
                                             offs=offs) + bias_rows

                ref = tgmm.gmm_ref(x, w, sizes, bias)
                w_bytes = d * d * 2
                module, policy = tgmm, "bf16"
            extra = {}
            if kernel == "K19":
                live_w = w[sizes > 0]
                extra["read_ms"] = card_ms(
                    lambda: live_w.sum(dtype=torch.float32), flush)
                del live_w
            if sweep:
                extra["sweep"] = schedule_sweep(fn, module, policy, rows, e,
                                                d, flush)
            y = fn()
            err = ((y.float() - ref.float()).abs().max()
                   / ref.float().abs().max()).item()
            ms = time_ms(fn, flush)
            dev_ms, per_call = device_ms(fn, flush)
            try:
                lib = time_ms(lib_fn, flush)
            except RuntimeError as exc:  # the yardstick only: reported
                lib = f"torch._grouped_mm failed: {exc!r}"[:160]
            nbytes = rows * d * 2 + live * (w_bytes + d * 2) + rows * d * 2
            print(json.dumps({"label": label, "kernel": kernel,
                              "shape": f"decode {case}: m={rows} E={e} "
                                       f"N=K={d}, {live} experts",
                              "ms": ms, "library_ms": lib,
                              "bound_ms": bound_ms(rows, d, d, nbytes),
                              "rel_err": err, "device_ms": dev_ms,
                              "kernels_per_call": per_call, **extra}),
                  flush=True)


def norm_times(dev, g, flush, label, which):
    """K4 and K6 (``which``) at NORM_SHAPES, each form the tree has, beside
    the library's backward and the bound (the module's docstring)."""
    import importlib
    import inspect

    import torch
    import torch.nn.functional as F

    # the ops package's exports shadow the module's name
    trn = importlib.import_module("unsloth_tpu_torch.ops.rms_norm")

    for kernel, rows, d, dt, gemma in NORM_SHAPES:
        if kernel not in which:
            continue
        dtype = getattr(torch, dt)
        x = (torch.randn((rows, d), generator=g, device=dev) * 2 + 0.5
             ).to(dtype)
        w = (1.0 + 0.1 * torch.randn((d,), generator=g, device=dev)
             ).to(dtype)
        gy = torch.randn((rows, d), generator=g, device=dev).to(dtype)
        eps = 1e-5 if kernel == "K6" else 1e-6
        bwd = trn.layer_norm_bwd if kernel == "K6" else trn.rms_norm_bwd
        forms = (False, True) if "need_dw" in inspect.signature(
            bwd).parameters else (None,)
        if kernel == "K4":
            ref = trn.rms_norm_bwd_ref(x, w, gy, eps, gemma)
            scale = (1.0 + w.float()).to(dtype) if gemma else w

            def lib_out(xl, wl):
                return F.rms_norm(xl, (d,), wl, eps)
        else:
            ref = trn.layer_norm_bwd_ref(x, w, gy, eps)
            scale = w

            def lib_out(xl, wl):
                return F.layer_norm(xl, (d,), wl, None, eps)
        for need_dw in forms:
            kw = {} if need_dw is None else {"need_dw": need_dw}
            if kernel == "K4":
                def fn():
                    return bwd(x, w, gy, eps, gemma, **kw)
            else:
                def fn():
                    return bwd(x, w, gy, eps, **kw)
            got = fn()
            errs = [(a.float() - b.float()).abs().max().item()
                    for a, b in zip(got, ref) if a is not None]
            leaves = [x.detach().clone().requires_grad_(True)]
            if need_dw is not False:
                leaves.append(scale.detach().clone().requires_grad_(True))
            y = lib_out(leaves[0], leaves[1] if len(leaves) > 1 else scale)

            def lib_fn():
                return torch.autograd.grad(y, leaves, gy, retain_graph=True)

            split, per_call = op_split(fn, flush)
            lib_split, lib_per_call = op_split(lib_fn, flush)
            with_dw = need_dw is not False
            nbytes = (3 * x.numel() * x.element_size()
                      + d * w.element_size()
                      + (d * (w.element_size() if kernel == "K4" else 8)
                         if with_dw else 0))
            ops = (8 if kernel == "K4" else 14) * x.numel()
            print(json.dumps({
                "label": label, "kernel": kernel,
                "shape": f"[{rows}, {d}] {dt}" + (" gemma" if gemma else ""),
                "form": {None: "dx + dW (parent)", False: "dx only",
                         True: "dx + dW"}[need_dw],
                "ms": time_ms(fn, flush), "card_ms": card_ms(fn, flush),
                "host_ms": host_ms(fn),
                "device_ms": sum(split.values()), "split": split,
                "ops_per_call": per_call,
                "library_ms": time_ms(lib_fn, flush),
                "library_card_ms": card_ms(lib_fn, flush),
                "library_device_ms": sum(lib_split.values()),
                "library_ops_per_call": lib_per_call,
                "library_host_ms": host_ms(lib_fn),
                "bound_ms": 1e3 * max(nbytes / 3.35e12, ops / 67e12),
                "max_abs_errs": errs}), flush=True)
            del y, leaves
        del x, w, gy, ref


def packed_row(t, docs, seed=0):
    """Segment ids [1, t] (numpy): documents of ``docs`` tokens laid end to
    end while they fit, then a pad tail (id 0); chip_smoke's
    ``_packed_segments``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    seg = np.zeros((1, t), np.int32)
    pos, sid = 0, 1
    while True:
        n = int(rng.integers(docs[0], docs[1] + 1))
        if pos + n > t - 1:
            break
        seg[0, pos:pos + n] = sid
        pos, sid = pos + n, sid + 1
    return seg


def k10_times(dev, g, flush, label):
    """K10/K11 (the packed attention backward) at K10_ROWS, fed the tree's
    K9 out and lse, beside K16's pair with its dq pass, SDPA's backward
    with the segments' causal mask, and the bound."""
    import inspect

    import numpy as np
    import torch
    import torch.nn.functional as F

    from unsloth_tpu_torch.ops import flash_attention as tfa
    from unsloth_tpu_torch.ops import packed_attention as tpa

    for name, (t, hq, hkv, d), docs in K10_ROWS:
        seg = torch.from_numpy(packed_row(t, docs)).to(dev)
        q, k, v, dout = (torch.randn((1, t, h, d), generator=g, device=dev)
                         .to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
        scale = d ** -0.5
        real = seg[0] != 0
        lens = np.bincount(seg[0][real].cpu().numpy())
        out, lse = tpa.packed_attention_fwd(q, k, v, seg, scale=scale)
        lo, hi = tfa.tile_segment_ranges(seg)
        if "n_kv" in inspect.signature(tpa.packed_attention_bwd).parameters:
            n_kv = min(tpa.bound_blocks(int(lens.max()), tpa.BLOCK),
                       t // tpa.BLOCK)
            kv_lo, q_hi = tpa.segment_block_metadata(seg, tpa.BLOCK)

            def bwd():
                return tpa.packed_attention_bwd(q, k, v, seg, kv_lo, q_hi,
                                                out, lse, dout, scale=scale,
                                                n_kv=n_kv)
        else:
            def bwd():
                return tpa.packed_attention_bwd(q, k, v, seg, lo, hi, out,
                                                lse, dout, scale=scale)
        qs = tpa._prescale(q, scale)

        def k16_pair():
            dq, di = tfa.flash_attention_dq(qs, k, v, seg, lo, hi, out, lse,
                                            dout, scale=1.0)
            dk, dv = tfa.flash_attention_dkv(qs, k, v, seg, lo, hi, lse, di,
                                             dout, scale=1.0)
            return dq * scale, dk, dv

        pos_ = torch.arange(t, device=dev)
        mask = ((pos_[:, None] >= pos_[None, :])
                & (seg[0][:, None] == seg[0][None, :]))[None, None]
        leaves = [x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v)]
        y = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                           enable_gqa=True)
        gy = dout.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(y, leaves, gy, retain_graph=True)

        refs = tpa.packed_attention_bwd_ref(q, k, v, seg, out, lse, dout,
                                            scale)
        errs = {}
        for route, fn in (("kernel", bwd), ("k16_pair", k16_pair)):
            errs[route] = max(
                ((a[:, real].float() - r[:, real].float()).abs().max()
                 / r[:, real].float().abs().max()).item()
                for a, r in zip(fn(), refs))
        del refs
        pairs = int((lens * (lens + 1) // 2).sum())
        nbytes = sum(x.numel() * x.element_size()
                     for x in (q, k, v, out, dout, lse, q, k, v))
        print(json.dumps({
            "label": label, "kernel": "K10/K11",
            "shape": f"{name}: B=1 T={t} Hq={hq} Hkv={hkv} D={d}, "
                     f"{int(seg.max())} segments, pad {int((~real).sum())}",
            "ms": time_ms(bwd, flush), "k16_pair_ms": time_ms(k16_pair, flush),
            "sdpa_bwd_ms": time_ms(sdpa_bwd, flush),
            "bound_ms": 1e3 * max(10 * d * hq * pairs / 989e12,
                                  nbytes / 3.35e12),
            "rel_err": errs["kernel"], "k16_pair_rel_err": errs["k16_pair"]}),
            flush=True)
        del y, leaves, mask


def k9_times(dev, g, flush, label):
    """K9 (the packed attention forward) on the 8K packed row beside SDPA
    with the segments' causal mask, and the pre-scale pass alone."""
    import inspect

    import numpy as np
    import torch
    import torch.nn.functional as F

    from unsloth_tpu_torch.ops import packed_attention as tpa

    t, hq, hkv, d = K9_SHAPE
    seg = torch.from_numpy(packed_row(t, K9_DOCS)).to(dev)
    q, k, v = (torch.randn((1, t, h, d), generator=g, device=dev).to(
        torch.bfloat16) for h in (hq, hkv, hkv))
    scale = d ** -0.5
    real = seg[0] != 0
    if "n_kv" in inspect.signature(tpa.packed_attention_fwd).parameters:
        n_kv = tpa.bound_blocks(int(np.bincount(seg[0][real].cpu()).max()),
                                tpa.BLOCK)
        kv_lo, _ = tpa.segment_block_metadata(seg, tpa.BLOCK)

        def fwd():
            return tpa.packed_attention_fwd(q, k, v, seg, kv_lo, scale=scale,
                                            n_kv=n_kv)
    else:
        def fwd():
            return tpa.packed_attention_fwd(q, k, v, seg, scale=scale)

    pos_ = torch.arange(t, device=dev)
    mask = ((pos_[:, None] >= pos_[None, :])
            & (seg[0][:, None] == seg[0][None, :]))[None, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    out, lse = fwd()
    rout, rlse = tpa.packed_attention_fwd_ref(q, k, v, seg, scale)
    err = (out[:, real].float() - rout[:, real].float()).abs().max().item()
    lse_err = (lse - rlse)[..., real].abs().max().item()
    lens = np.bincount(seg[0][real].cpu().numpy())
    pairs = int((lens * (lens + 1) // 2).sum())
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, out, lse))
    print(json.dumps({
        "label": label, "kernel": "K9",
        "shape": f"B=1 T={t} Hq={hq} Hkv={hkv} D={d}, {int(seg.max())} "
                 f"segments, pad {int((~real).sum())}",
        "ms": time_ms(fwd, flush), "sdpa_ms": time_ms(sdpa, flush),
        "prescale_ms": time_ms(lambda: tpa._prescale(q, scale), flush),
        "bound_ms": 1e3 * max(4 * d * hq * pairs / 989e12, nbytes / 3.35e12),
        "max_abs_err": err, "lse_err": lse_err}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--only", type=lambda v: v.split(","), default=None,
                    help="a kernel, or several joined by commas")
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    names = ("K1", "K2", "K4", "K5", "K6", "K9", "K10", "K12", "K13", "K14",
             "K15", "K19")
    if args.only and not set(args.only) <= set(names):
        ap.error(f"--only takes {', '.join(names)}")

    def want(kernel):
        return args.only is None or kernel in args.only

    if args.decode and args.only and not set(args.only) <= {"K1", "K12",
                                                              "K14", "K19"}:
        ap.error("--decode times K1's, K12's, K14's and K19's decode rows "
                 "only")
    global REPEATS
    REPEATS = args.repeats
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("kernel_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from unsloth_tpu_torch import kernels
    from unsloth_tpu_torch.ops.fp8 import dequantize_fp8, quantize_fp8_block
    from unsloth_tpu_torch.ops.fp8_matmul import (fp8_matmul_dx,
                                                  fp8_matmul_fwd)
    from unsloth_tpu_torch.ops.nf4 import dequantize_nf4, quantize_nf4
    from unsloth_tpu_torch.ops.qlora_matmul import nf4_matmul, nf4_matmul_dx
    from unsloth_tpu_torch.ops.rms_norm import layer_norm_fwd, layer_norm_ref

    kernels.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"label": args.label, "tree": args.tree, "card": smi}),
          flush=True)
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    decode = args.decode
    k1_shapes = [(name, n, k, [m for m in rows if m in DECODE_M or not decode])
                 for name, n, k, rows in K1_SHAPES]
    for name, n, k, row_counts in (k1_shapes if want("K1")
                                   else ()):
        w = (torch.randn((n, k), generator=g, device=dev) * 0.02
             ).to(torch.bfloat16)
        q = quantize_nf4(w, dtype=torch.bfloat16)
        del w
        for m in row_counts:
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)

            def two_calls():
                return torch.matmul(x, dequantize_nf4(q, torch.bfloat16).t())

            y, ref = nf4_matmul(x, q), two_calls()
            err = ((y.float() - ref.float()).abs().max()
                   / ref.float().abs().max()).item()
            ms = time_ms(lambda: nf4_matmul(x, q), flush)
            lib = time_ms(two_calls, flush)
            bound = bound_ms(m, n, k, x.numel() * 2 + q.nbytes + m * n * 2)
            dev_ms, per_call = device_ms(lambda: nf4_matmul(x, q), flush) \
                if m in DECODE_M else (None, None)
            print(json.dumps({"label": args.label, "kernel": "K1",
                              "shape": f"{name} M={m} N={n} K={k}",
                              "ms": ms, "two_calls_ms": lib,
                              "bound_ms": bound, "rel_err": err,
                              "device_ms": dev_ms,
                              "kernels_per_call": per_call}),
                  flush=True)
    for name, n, k, m in (K2_SHAPES if want("K2")
                          and not decode else ()):
        w = (torch.randn((n, k), generator=g, device=dev) * 0.02
             ).to(torch.bfloat16)
        q = quantize_nf4(w, dtype=torch.bfloat16)
        del w
        gy = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)

        def two_calls_dx():
            return torch.matmul(gy, dequantize_nf4(q, torch.bfloat16))

        dx, ref = nf4_matmul_dx(gy, q), two_calls_dx()
        err = ((dx.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        ms = time_ms(lambda: nf4_matmul_dx(gy, q), flush)
        lib = time_ms(two_calls_dx, flush)
        bound = bound_ms(m, n, k, gy.numel() * 2 + q.nbytes + m * k * 2)
        print(json.dumps({"label": args.label, "kernel": "K2",
                          "shape": f"{name} M={m} N={n} K={k}", "ms": ms,
                          "two_calls_ms": lib, "bound_ms": bound,
                          "rel_err": err}), flush=True)
        del q, gy, dx, ref
    for name, n, k, block, m in (
            [c for c in K12_SHAPES if c[4] in DECODE_M or not decode]
            if want("K12") else ()):
        q = quantize_fp8_block(fp8_weight(n, k, g, dev, block), block)
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)

        def two_calls_fp8():
            return torch.matmul(x, dequantize_fp8(q, torch.bfloat16).t())

        y, ref = fp8_matmul_fwd(x, q), two_calls_fp8()
        err = ((y.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        ms = time_ms(lambda: fp8_matmul_fwd(x, q), flush)
        lib = time_ms(two_calls_fp8, flush)
        bound = bound_ms(m, n, k, x.numel() * 2 + q.nbytes + m * n * 2)
        dev_ms, per_call = device_ms(lambda: fp8_matmul_fwd(x, q), flush) \
            if m in DECODE_M else (None, None)
        print(json.dumps({"label": args.label, "kernel": "K12",
                          "shape": f"{name} M={m} N={n} K={k} block {block}",
                          "ms": ms, "two_calls_ms": lib, "bound_ms": bound,
                          "rel_err": err, "device_ms": dev_ms,
                          "kernels_per_call": per_call}), flush=True)
        del q, x, y, ref
    for name, n, k, block, m in (K13_SHAPES if want("K13")
                                 and not decode else ()):
        q = quantize_fp8_block(fp8_weight(n, k, g, dev, block), block)
        gy = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)

        def two_calls_fp8_dx():
            return torch.matmul(gy, dequantize_fp8(q, torch.bfloat16))

        dx, ref = fp8_matmul_dx(gy, q), two_calls_fp8_dx()
        err = ((dx.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        ms = time_ms(lambda: fp8_matmul_dx(gy, q), flush)
        lib = time_ms(two_calls_fp8_dx, flush)
        bound = bound_ms(m, n, k, gy.numel() * 2 + q.nbytes + m * k * 2)
        print(json.dumps({"label": args.label, "kernel": "K13",
                          "shape": f"{name} M={m} N={n} K={k} block {block}",
                          "ms": ms, "two_calls_ms": lib, "bound_ms": bound,
                          "rel_err": err, "bitwise": bool(torch.equal(dx, ref))
                          }), flush=True)
        del q, gy, dx, ref
    if want("K14") and not decode:
        k14_times(dev, g, flush, args.label)
    grouped = [k_ for k_ in ("K14", "K19") if want(k_)]
    if grouped:
        grouped_decode_times(dev, g, flush, args.label, grouped, args.sweep)
    if want("K15") and not decode:
        k14_times(dev, g, flush, args.label, dx=True)
    if want("K9") and not decode:
        k9_times(dev, g, flush, args.label)
    if want("K10") and not decode:
        k10_times(dev, g, flush, args.label)
    norms = [k_ for k_ in ("K4", "K6") if want(k_)]
    if norms and not decode:
        norm_times(dev, g, flush, args.label, norms)
    for rows, d, dt, bias in (K5_SHAPES if want("K5")
                              and not decode else ()):
        dtype = getattr(torch, dt)
        x = (torch.randn((rows, d), generator=g, device=dev) * 2 + 0.5
             ).to(dtype)
        w = (1.0 + 0.1 * torch.randn((d,), generator=g, device=dev)).to(dtype)
        b = (0.1 * torch.randn((d,), generator=g, device=dev)).to(dtype) \
            if bias else None
        out, ref = layer_norm_fwd(x, w, b, 1e-5), layer_norm_ref(x, w, b, 1e-5)
        err = (out.float() - ref.float()).abs().max().item()
        ms = time_ms(lambda: layer_norm_fwd(x, w, b, 1e-5), flush)
        lib = time_ms(lambda: F.layer_norm(x, (d,), w, b, 1e-5), flush)
        nbytes = 2 * x.numel() * x.element_size() + (2 if bias else 1) * \
            d * w.element_size()
        print(json.dumps({"label": args.label, "kernel": "K5",
                          "shape": f"[{rows}, {d}] {dt}"
                          + ("" if bias else " b=None"),
                          "ms": ms, "f_layer_norm_ms": lib,
                          "bound_ms": 1e3 * nbytes / 3.35e12,
                          "max_abs_err": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
