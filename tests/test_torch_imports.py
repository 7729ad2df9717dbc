"""The PyTorch port imports no JAX: importing the package and every one of
its submodules in a fresh interpreter leaves "jax" out of sys.modules."""

import os
import subprocess
import sys

CODE = r"""
import importlib, pkgutil, sys
import unsloth_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(unsloth_tpu_torch.__path__,
                                              "unsloth_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules if k == "jax" or k.startswith(("jax.", "jaxlib", "unsloth_tpu.")) or k == "unsloth_tpu")
print(len(mods), bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    r = subprocess.run([sys.executable, "-c", CODE], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 18, r.stdout
