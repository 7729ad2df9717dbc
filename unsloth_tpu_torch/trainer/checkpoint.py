"""Training-state checkpoints and resume.

Counterpart of unsloth_tpu/trainer/checkpoint.py, with its functions and
its layout: ``{output_dir}/checkpoint-{step}/state/`` holds the trainables
(the LoRA tree, or every param under full fine-tuning), the optimizer
state and the step, beside the peft adapter that the SFT trainer writes
for LoRA. :func:`latest_checkpoint` skips a checkpoint without its
``state`` directory (incomplete); :func:`restore_latest` walks from the
newest checkpoint back past any that fails to load.

Divergence by design: JAX writes an Orbax tree; the port writes its own
format, ``state/trainables.safetensors`` and ``state/optimizer.safetensors``
(through the package's safetensors writer, each tensor under its path in
the tree, e.g. ``layers.0.q.a``) and ``state/meta.json`` (the step and the
optimizer's update count). A restore reads each tensor back onto the
device and into the dtype of its template, and raises when the names or
shapes differ from the template's.

An optimizer state is ``{"count": int, "tensors": {name: tensor}}``, what
the trainer's optimizers give from ``state_dict()`` and take in
``load_state_dict()``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..io_safetensors import SafetensorsFile, save_file
from ..ops.lora import LoRAWeights

_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")


def named_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """Every tensor of a param or LoRA tree with its path (dict keys in
    sorted order, as JAX flattens a tree; list indices; a LoRA adapter's
    ``a`` and ``b``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in named_leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree)
                for leaf in named_leaves(v, f"{prefix}{i}.")]
    if isinstance(tree, LoRAWeights):
        return [(prefix + "a", tree.a), (prefix + "b", tree.b)]
    if isinstance(tree, torch.Tensor):
        return [(prefix[:-1], tree)]
    return []


def _map_named(fn: Callable[[str, torch.Tensor], torch.Tensor], tree: Any,
               prefix: str = "") -> Any:
    """``tree`` with each tensor t at path p replaced by fn(p, t)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_named(fn, v, f"{prefix}{i}.") for i, v in enumerate(tree)]
    if isinstance(tree, LoRAWeights):
        return dataclasses.replace(tree, a=fn(prefix + "a", tree.a),
                                   b=fn(prefix + "b", tree.b))
    if isinstance(tree, torch.Tensor):
        return fn(prefix[:-1], tree)
    return tree


def _read_like(f: SafetensorsFile, name: str, like: torch.Tensor
               ) -> torch.Tensor:
    if name not in f:
        raise ValueError(f"{f.path}: no tensor {name!r}")
    t = f.get(name)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{f.path}: {name!r} has shape {tuple(t.shape)}, "
                         f"the template {tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


def save_train_state(ckpt_dir: str, step: int, trainables: Any,
                     opt_state: Dict[str, Any]) -> None:
    """Write the trainables, the optimizer state and the step under
    ``ckpt_dir/state``."""
    path = os.path.abspath(os.path.join(ckpt_dir, "state"))
    os.makedirs(path, exist_ok=True)
    save_file(dict(named_leaves(trainables)),
              os.path.join(path, "trainables.safetensors"))
    save_file(dict(opt_state["tensors"]),
              os.path.join(path, "optimizer.safetensors"))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": int(step), "count": int(opt_state["count"])}, f)


def restore_train_state(ckpt_dir: str, trainables_like: Any,
                        opt_state_like: Dict[str, Any]
                        ) -> Tuple[int, Any, Dict[str, Any]]:
    """(step, trainables, opt_state) from ``ckpt_dir/state``, shaped after
    the templates: new tensors on each template tensor's device and in its
    dtype. A missing or corrupt file, or a name or shape that differs from
    the template's, raises."""
    path = os.path.abspath(os.path.join(ckpt_dir, "state"))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    tf = SafetensorsFile(os.path.join(path, "trainables.safetensors"))
    trainables = _map_named(lambda n, t: _read_like(tf, n, t),
                            trainables_like)
    of = SafetensorsFile(os.path.join(path, "optimizer.safetensors"))
    tensors = {n: _read_like(of, n, t)
               for n, t in opt_state_like["tensors"].items()}
    return (int(meta["step"]), trainables,
            {"count": int(meta["count"]), "tensors": tensors})


def restore_latest(output_dir: str, trainables_like: Any,
                   opt_state_like: Dict[str, Any]
                   ) -> Optional[Tuple[str, int, Any, Dict[str, Any]]]:
    """(checkpoint dir, step, trainables, opt_state) from the newest
    checkpoint that loads, walking from newest to oldest past corrupt or
    truncated ones; None when none loads."""
    for _, path in sorted(_checkpoints(output_dir), reverse=True):
        try:
            step, t, o = restore_train_state(path, trainables_like,
                                             opt_state_like)
            return path, step, t, o
        except Exception:
            continue  # corrupt checkpoint: fall back to the previous one
    return None


def _checkpoints(output_dir: str) -> List[Tuple[int, str]]:
    """(step, path) of every ``checkpoint-{step}`` with a ``state`` dir."""
    if not os.path.isdir(output_dir):
        return []
    out = []
    for name in os.listdir(output_dir):
        m = _CKPT_RE.match(name)
        path = os.path.join(output_dir, name)
        if m and os.path.isdir(os.path.join(path, "state")):
            out.append((int(m.group(1)), path))
    return out


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The newest complete checkpoint directory (one with its ``state``
    dir), or None."""
    found = _checkpoints(output_dir)
    return max(found)[1] if found else None
