"""The PyTorch port imports no JAX: importing the package and every one of
its submodules (the serving and the training slices alike, the MoE ops
and the MXFP4 and bnb-4bit loaders among them) in a fresh interpreter
leaves "jax" out of sys.modules."""

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
print(len(mods), bad, " ".join(mods))
assert not bad, bad
"""

# the training slice's modules, which must be among those imported
TRAINING = ("data.packing", "ops.attention", "ops.cross_entropy",
            "ops.flash_attention", "ops.fused_ce_linear",
            "ops.packed_attention", "ops.splash_attention", "trainer.sft",
            "utils.logging", "export.save", "ops.moe", "ops.nf4_gmm",
            "ops.flash_sinks", "ops.gmm", "models.mxfp4", "models.bnb")


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    r = subprocess.run([sys.executable, "-c", CODE], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 37, r.stdout
    imported = set(r.stdout.split())
    for name in TRAINING:
        assert f"unsloth_tpu_torch.{name}" in imported, name
