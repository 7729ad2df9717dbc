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
SOURCES = ("nf4_matmul.cu", "rms_norm.cu", "packed_attention.cu",
           "flash_attention.cu", "cross_entropy.cu", "splash_attention.cu",
           "nf4_gmm.cu", "flash_sinks.cu", "gmm.cu")
#: headers the sources include; part of the library's hash
HEADERS = ("attention_tiles.cuh", "expert_visits.cuh")
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
    ``nvcc -c`` per source in parallel, then one link."""
    global build_seconds, build_log
    out = _library_path()
    if out.exists():
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
    os.replace(tmp, out)
    (BUILD_DIR / (out.stem + ".log")).write_text(build_log)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.unsloth_nf4_matmul_bf16.argtypes = [p, p, p, p, i, i, i, p]
        lib.unsloth_nf4_matmul_bf16.restype = i
        lib.unsloth_rms_norm.argtypes = [p, p, p, i, i, ctypes.c_float, i, i,
                                         i, p]
        lib.unsloth_rms_norm.restype = i
        lib.unsloth_nf4_matmul_dx_bf16.argtypes = [p, p, p, p, i, i, i, p]
        lib.unsloth_nf4_matmul_dx_bf16.restype = i
        lib.unsloth_rms_norm_bwd.argtypes = [p, p, p, p, p, p, i, i, i,
                                             ctypes.c_float, i, i, i, p]
        lib.unsloth_rms_norm_bwd.restype = i
        f = ctypes.c_float
        lib.unsloth_packed_attn_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                                i, i, f, p]
        lib.unsloth_packed_attn_fwd.restype = i
        lib.unsloth_packed_attn_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                                p, p, p, i, i, i, i, i, f, f,
                                                p]
        lib.unsloth_packed_attn_bwd.restype = i
        lib.unsloth_flash_attn_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i,
                                               i, i, i, f, p]
        lib.unsloth_flash_attn_fwd.restype = i
        lib.unsloth_flash_attn_dq.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                              p, i, i, i, i, i, f, p]
        lib.unsloth_flash_attn_dq.restype = i
        lib.unsloth_flash_attn_dkv.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                               p, i, i, i, i, i, f, p]
        lib.unsloth_flash_attn_dkv.restype = i
        lib.unsloth_splash_attn_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i,
                                                i, i, i, f, i, f, p]
        lib.unsloth_splash_attn_fwd.restype = i
        lib.unsloth_splash_attn_dq.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                               p, i, i, i, i, i, f, i, f, p]
        lib.unsloth_splash_attn_dq.restype = i
        lib.unsloth_splash_attn_dkv.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                                p, i, i, i, i, i, f, i, f, p]
        lib.unsloth_splash_attn_dkv.restype = i
        lib.unsloth_ce_fwd.argtypes = [p, p, p, p, i, i, f, f, i, p]
        lib.unsloth_ce_fwd.restype = i
        lib.unsloth_ce_bwd.argtypes = [p, p, p, p, p, i, i, f, f, i, p]
        lib.unsloth_ce_bwd.restype = i
        lib.unsloth_nf4_gmm_bf16.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                             p]
        lib.unsloth_nf4_gmm_bf16.restype = i
        lib.unsloth_nf4_gmm_dx_bf16.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                                p]
        lib.unsloth_nf4_gmm_dx_bf16.restype = i
        lib.unsloth_flash_sinks_fwd.argtypes = [p, p, p, p, p, p, p, p, p, i,
                                                i, i, i, f, p]
        lib.unsloth_flash_sinks_fwd.restype = i
        lib.unsloth_flash_sinks_dq.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                               p, i, i, i, i, f, p]
        lib.unsloth_flash_sinks_dq.restype = i
        lib.unsloth_flash_sinks_dkv.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                                p, i, i, i, i, f, p]
        lib.unsloth_flash_sinks_dkv.restype = i
        lib.unsloth_gmm_bf16.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.unsloth_gmm_bf16.restype = i
        lib.unsloth_gmm_dx_bf16.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.unsloth_gmm_dx_bf16.restype = i
        lib.unsloth_cuda_error_string.argtypes = [i]
        lib.unsloth_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = library().unsloth_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code} at launch: {msg}")
