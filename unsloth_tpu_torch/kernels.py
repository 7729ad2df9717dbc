"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The kernels are compiled on first use, one ``nvcc`` process per source,
all started together, and linked into one shared library with a plain C
interface, which is loaded with ``ctypes``. The library
goes to ``<repo>/build/unsloth_tpu_torch/`` under a name keyed by a hash of
the sources and flags, so an edited source builds anew and an unchanged
one is loaded as it is. Nothing is prebuilt or downloaded.

Each C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; :func:`check` turns a nonzero code into
a ``RuntimeError``. A missing ``nvcc`` or a compile error raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "unsloth_tpu_torch"
SOURCES = ("nf4_matmul.cu", "nf4_wgmma.cu", "decode_matmul.cu",
           "rms_norm.cu", "flash_attention.cu", "flash_fwd.cu", "flash_dq.cu",
           "flash_dkv.cu", "cross_entropy.cu",
           "splash_attention.cu", "nf4_gmm.cu", "flash_sinks.cu", "gmm.cu",
           "tgmm.cu", "layer_norm.cu", "fp8_matmul.cu")
#: headers the sources include; part of the library's hash
HEADERS = ("hopper_common.cuh", "hopper_tiles.cuh", "gmm_tiles.cuh",
           "expert_visits.cuh", "norm_common.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log: str = ""


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libunsloth_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if no library with their hash exists yet: one
    ``nvcc -c`` per source in parallel, then one link. ``build_log`` holds
    the compiler's output, read back from beside a library built before
    (the log is written before the library is published; a library
    without one is built again)."""
    global build_seconds, build_log
    out = _library_path()
    log = out.with_suffix(".log")
    if out.exists() and log.exists():
        build_log = log.read_text()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    t0 = time.perf_counter()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC_DIR / s)]
            for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    failed = [(c, log) for c, p, log in zip(cmds, procs, logs) if p.returncode]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        r = subprocess.run(link, capture_output=True, text=True)
        build_log += r.stdout + r.stderr
        if r.returncode:
            failed = [(link, r.stdout + r.stderr)]
    for o in objs:
        o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    if failed:
        cmd, log = failed[0]
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{log}")
    log_tmp = log.with_suffix(f".{os.getpid()}.logtmp")
    log_tmp.write_text(build_log)
    os.replace(log_tmp, log)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        # x, packed, absmax, y, M, N, K, the Hopper kernel's tile counters
        # (or null), stream
        lib.unsloth_nf4_matmul_bf16.argtypes = [p, p, p, p, i, i, i, p, p]
        lib.unsloth_nf4_matmul_bf16.restype = i
        # the decode kernel (M <= 16): x, packed, fp32 absmax (or null),
        # int8 codes, their group scales and offset (or nulls), the
        # double-quant group, y, partials, arrivals, M, N, K, row warps,
        # slices, steps a slice, counters (or null), stream
        lib.unsloth_decode_matmul_nf4.argtypes = [p, p, p, p, p, p, i, p, p,
                                                  p, i, i, i, i, i, i, p, p]
        lib.unsloth_decode_matmul_nf4.restype = i
        # x, e4m3 W, fp32 scales, block, then as the NF4 form from y
        lib.unsloth_decode_matmul_fp8.argtypes = [p, p, p, i, p, p, p, i, i,
                                                  i, i, i, i, p, p]
        lib.unsloth_decode_matmul_fp8.restype = i
        lib.unsloth_rms_norm.argtypes = [p, p, p, i, i, ctypes.c_float, i, i,
                                         i, p]
        lib.unsloth_rms_norm.restype = i
        # g, packed, the absmax transposed, dx, M, N, K, the tile counters
        # (or null), stream
        lib.unsloth_nf4_matmul_dx_bf16.argtypes = [p, p, p, p, i, i, i, p, p]
        lib.unsloth_nf4_matmul_dx_bf16.restype = i
        # x, w, g, dx, dW (or null), the fp32 scratch and its arrival
        # counters (or null), rows, D, chunks a lane, warps a row, blocks,
        # blocks a group, eps, gemma, x and w dtype codes, stream
        lib.unsloth_rms_norm_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                             i, i, ctypes.c_float, i, i, i, p]
        lib.unsloth_rms_norm_bwd.restype = i
        # chunks a lane, warps a row, dW, D, x and w dtype codes
        lib.unsloth_rms_norm_bwd_blocks_per_sm.argtypes = [i, i, i, i, i, i]
        lib.unsloth_rms_norm_bwd_blocks_per_sm.restype = i
        f = ctypes.c_float
        b = ctypes.c_bool
        # pointers, B, T, Hq, Hkv, D, scale, causal, the tile-pair class
        # counters (or null), stream; dk/dv also its fp32 scratch (or null)
        # and head-slice count before B
        lib.unsloth_flash_attn_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i,
                                               i, i, i, f, b, p, p]
        lib.unsloth_flash_attn_fwd.restype = i
        lib.unsloth_flash_attn_dq.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                              p, i, i, i, i, i, f, b, p, p]
        lib.unsloth_flash_attn_dq.restype = i
        lib.unsloth_flash_attn_dkv.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                               p, p, i, i, i, i, i, i, f, b,
                                               p, p]
        lib.unsloth_flash_attn_dkv.restype = i
        # pointers, the prefix layout (P, G, L), B, T, Hq, Hkv, D, scale,
        # window, softcap, causal, the tile-pair class counters (or null),
        # stream
        lib.unsloth_splash_attn_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i,
                                                i, i, i, i, i, i, f, i, f, b,
                                                p, p]
        lib.unsloth_splash_attn_fwd.restype = i
        lib.unsloth_splash_attn_dq.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                               p, i, i, i, i, i, i, i, i, f, i,
                                               f, b, p, p]
        lib.unsloth_splash_attn_dq.restype = i
        lib.unsloth_splash_attn_dkv.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                                p, i, i, i, i, i, i, i, i, f, i,
                                                f, b, p, p]
        lib.unsloth_splash_attn_dkv.restype = i
        lib.unsloth_ce_fwd.argtypes = [p, p, p, p, i, i, f, f, i, p]
        lib.unsloth_ce_fwd.restype = i
        lib.unsloth_ce_bwd.argtypes = [p, p, p, p, p, i, i, f, f, i, p]
        lib.unsloth_ce_bwd.restype = i
        # x, packed, absmax, bias (or null), the bias is fp32 (else bf16),
        # group sizes, out, m, E, N, K, block, the decode kernel's row
        # warps, slices, steps a slice, partials and arrivals (m <= 16),
        # the kernel's counters or null, stream; the dx: g, packed, the
        # absmax transposed, group sizes, dx, m, E, N, K, block, counters,
        # stream
        lib.unsloth_nf4_gmm_bf16.argtypes = [p, p, p, p, i, p, p, i, i, i, i,
                                             i, i, i, i, p, p, p, p]
        lib.unsloth_nf4_gmm_bf16.restype = i
        lib.unsloth_nf4_gmm_dx_bf16.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                                p, p]
        lib.unsloth_nf4_gmm_dx_bf16.restype = i
        # pointers (the forward's sinks after the segment ranges), B, T,
        # Hq, Hkv, D, scale, stream; dk/dv also its fp32 scratch (or null)
        # and head-slice count before B
        lib.unsloth_flash_sinks_fwd.argtypes = [p, p, p, p, p, p, p, p, p, i,
                                                i, i, i, i, f, p]
        lib.unsloth_flash_sinks_fwd.restype = i
        lib.unsloth_flash_sinks_dq.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                               p, i, i, i, i, i, f, p]
        lib.unsloth_flash_sinks_dq.restype = i
        lib.unsloth_flash_sinks_dkv.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                                p, p, i, i, i, i, i, i, f, p]
        lib.unsloth_flash_sinks_dkv.restype = i
        # lhs (or g), W, bias (or null; the forward only), group sizes,
        # out, m, E, N, K, (the forward only) the decode kernel's row
        # warps, slices, steps a slice, partials and arrivals (m <= 16),
        # the work-unit counters (or null), stream
        lib.unsloth_gmm_bf16.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                         p, p, p, p]
        lib.unsloth_gmm_bf16.restype = i
        lib.unsloth_gmm_dx_bf16.argtypes = [p, p, p, p, i, i, i, i, p, p]
        lib.unsloth_gmm_dx_bf16.restype = i
        # lhs, g, group sizes, dW, m, E, N, K, the work-unit counters (or
        # null), stream
        lib.unsloth_gmm_tgmm_bf16.argtypes = [p, p, p, p, i, i, i, i, p, p]
        lib.unsloth_gmm_tgmm_bf16.restype = i
        # x, w, b (or null), out, rows, D, eps, x and w dtype codes, stream
        lib.unsloth_layer_norm.argtypes = [p, p, p, p, i, i, f, i, i, p]
        lib.unsloth_layer_norm.restype = i
        # x, w, g, dx, dW and dB (or null), the scratch and counters (or
        # null), rows, D, chunks a lane, warps a row, blocks, blocks a
        # group, eps, x and w dtype codes, stream
        lib.unsloth_layer_norm_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i,
                                               i, i, i, i, f, i, i, p]
        lib.unsloth_layer_norm_bwd.restype = i
        lib.unsloth_layer_norm_bwd_blocks_per_sm.argtypes = [i, i, i, i, i,
                                                             i]
        lib.unsloth_layer_norm_bwd_blocks_per_sm.restype = i
        # x (or g), e4m3 W, fp32 scales, out, M, N, K, block, the Hopper
        # kernel's tile counters or null, stream
        lib.unsloth_fp8_matmul_bf16.argtypes = [p, p, p, p, i, i, i, i, p, p]
        lib.unsloth_fp8_matmul_bf16.restype = i
        lib.unsloth_fp8_matmul_dx_bf16.argtypes = [p, p, p, p, i, i, i, i, p,
                                                   p]
        lib.unsloth_fp8_matmul_dx_bf16.restype = i
        lib.unsloth_cuda_error_string.argtypes = [i]
        lib.unsloth_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


#: per (device, stream): the fp32 partials and int32 arrival counters of
#: the kernels that sum their blocks' partials in the launch itself (the
#: decode matmuls, the norm backwards). Each such kernel leaves the
#: counters it used back at 0, and launches on one stream run one after
#: another, so every launch on that stream reuses them; a launch on
#: another stream gets its own.
_SCRATCH = {}


def device_scratch(floats: int, counters: int, device, stream: int):
    """(partials, arrivals) pointers for a launch on ``stream`` (a CUDA
    stream handle) of ``device``: at least ``floats`` fp32 and
    ``counters`` zeroed int32, made once and grown where a call needs more
    (no launch once they are large enough)."""
    import torch

    key = device, stream
    partials, arrivals = _SCRATCH.get(key, (None, None))
    if partials is None or partials.numel() < floats:
        partials = torch.empty(max(floats, 1 << 20), dtype=torch.float32,
                               device=device)
    if arrivals is None or arrivals.numel() < counters:
        arrivals = torch.zeros(max(counters, 4096), dtype=torch.int32,
                               device=device)
    _SCRATCH[key] = partials, arrivals
    return partials.data_ptr(), arrivals.data_ptr()


def check(code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = library().unsloth_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code} at launch: {msg}")
