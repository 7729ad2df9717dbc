"""Compare the machine code of kernels in two builds of the port's kernel
library, kernel by kernel.

    python scripts/compare_sass.py PARENT.so TREE.so [PATTERN]

Runs ``cuobjdump -sass`` on both libraries (the CUDA toolkit's, next to
``nvcc``), splits the listings into functions, drops the instruction
addresses, and compares the instructions and their encodings of every
kernel of the first library whose mangled name PATTERN (a regular
expression, searched) finds with the same kernel of the second. The
default pattern is the Hopper attention set: every
``flash_{fwd,dq,dkv}_kernel`` instantiation and ``dkv_sum_kernel``. Names are compared
after three normalisations: the anonymous namespace's per-file tag, the
forward's third template value (``flash_fwd_kernel<D, kSplash, false>`` in
a tree that has the sinks form is ``flash_fwd_kernel<D, kSplash>`` in one
that has not), and the NF4 kernels' format value
(``nf4_wgmma_kernel<BX, false>``, K1's form in a tree where K12 runs the
same kernel, is ``nf4_wgmma_kernel<BX>`` in one where it does not; so
``nf4_dx_wgmma_kernel<BX, false>``, K2's form beside K13's). Prints
one line a kernel and exits 1 if any kernel differs or is missing from
the second library.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

ATTENTION = r"flash_(?:fwd|dq|dkv)_kernel|dkv_sum_kernel"
_ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]{8}")
_FWD3 = re.compile(r"(flash_fwd_kernelILi\d+ELb\dE)Lb0E")
_NF4W = re.compile(r"(nf4_(?:dx_)?wgmma_kernelILi\d+E)Lb0E")
_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")


def _cuobjdump() -> str:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from unsloth_tpu_torch import kernels

    return str(Path(kernels.find_nvcc()).with_name("cuobjdump"))


def normalise(name: str) -> str:
    """The kernel's mangled name with the file tag, a false third forward
    template value and the NF4 kernels' false format value dropped."""
    return _NF4W.sub(r"\1", _FWD3.sub(r"\1", _ANON.sub(r"ANON_\1", name)))


def functions(lib: str, pattern: str = ATTENTION) -> dict:
    """{normalised name: [instruction lines without addresses]} of the
    kernels in ``lib`` whose name ``pattern`` finds."""
    kernel = re.compile(pattern)
    text = subprocess.run([_cuobjdump(), "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = normalise(m.group(1)) if kernel.search(m.group(1)) else None
            if name is not None:
                out[name] = []
            continue
        if name is not None and line.strip().startswith("/*"):
            out[name].append(" ".join(_ADDR.sub("", line).split()))
    return out


def main(argv) -> int:
    if len(argv) not in (3, 4):
        print(__doc__, file=sys.stderr)
        return 2
    pattern = argv[3] if len(argv) == 4 else ATTENTION
    a, b = functions(argv[1], pattern), functions(argv[2], pattern)
    bad = 0
    for name in sorted(a):
        if name not in b:
            print(f"missing  {name}")
            bad += 1
        elif a[name] != b[name]:
            diff = sum(x != y for x, y in zip(a[name], b[name]))
            print(f"differs  {name}: {len(a[name])} / {len(b[name])} lines, "
                  f"{diff + abs(len(a[name]) - len(b[name]))} differ")
            bad += 1
        else:
            print(f"same     {name}: {len(a[name])} lines")
    extra = sorted(set(b) - set(a))
    for name in extra:
        print(f"new      {name}: {len(b[name])} lines")
    print(f"{len(a) - bad} of {len(a)} kernels identical; {len(extra)} new in "
          f"{argv[2]}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
