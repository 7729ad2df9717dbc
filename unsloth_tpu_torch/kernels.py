"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The kernels are compiled on first use by one ``nvcc`` call into a shared
library with a plain C interface, and loaded with ``ctypes``. The library
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
SOURCES = ("nf4_matmul.cu", "rms_norm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libunsloth_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if no library with their hash exists yet."""
    global build_seconds, build_log
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC_DIR / s) for s in SOURCES]]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                           f"{build_log}")
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
        lib.unsloth_cuda_error_string.argtypes = [i]
        lib.unsloth_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = library().unsloth_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code} at launch: {msg}")
