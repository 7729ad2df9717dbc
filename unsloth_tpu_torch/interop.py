"""Carry the JAX package's parameter and LoRA trees into this package, and
LoRA trees back out.

The ``*_from_numpy`` functions take a tree as
``jax.tree_util.tree_map(np.asarray, tree)``
leaves it: dicts and lists of numpy arrays, NF4 objects with
``packed/absmax/absmax_scale/absmax_offset/shape/block_size/
double_block_size``, stacked-expert NF4 objects with
``packed/absmax/shape/block_size`` (3-D shape) and LoRA objects with
``a/b/scale``. They return the
port's tree with every array on ``device``; NF4 bytes and codes are copied
unchanged. :func:`lora_to_numpy` goes the other way for trained adapters.
JAX imports nothing here: the trees travel as numpy.
"""

from __future__ import annotations

import types
from typing import Any, Optional

import numpy as np
import torch

from .ops.lora import LoRAWeights
from .ops.nf4 import NF4Stacked, NF4Tensor

_FLOAT_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16}


def to_tensor(a, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16, which ``torch.from_numpy``
    refuses: its bits go across as uint16) -> torch on ``device``."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _convert(tree: Any, device, dtype: Optional[torch.dtype]) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype) for v in tree]
    if hasattr(tree, "packed") and len(getattr(tree, "shape", ())) == 3:
        e = int(tree.shape[0])
        return NF4Stacked(
            packed=to_tensor(tree.packed, device),
            absmax=to_tensor(tree.absmax, device).reshape(e, -1),
            shape=tuple(int(s) for s in tree.shape),
            block_size=int(tree.block_size),
            dtype=dtype or _FLOAT_DTYPES[np.dtype(tree.dtype).name])
    if hasattr(tree, "packed") and hasattr(tree, "absmax"):
        opt = (lambda v: None if v is None else to_tensor(v, device))
        return NF4Tensor(
            packed=to_tensor(tree.packed, device),
            absmax=to_tensor(tree.absmax, device),
            absmax_scale=opt(tree.absmax_scale),
            absmax_offset=opt(tree.absmax_offset),
            shape=tuple(int(s) for s in tree.shape),
            block_size=int(tree.block_size),
            dtype=dtype or _FLOAT_DTYPES[np.dtype(tree.dtype).name],
            double_block_size=int(tree.double_block_size))
    if hasattr(tree, "a") and hasattr(tree, "b") and hasattr(tree, "scale"):
        return LoRAWeights(a=to_tensor(tree.a, device, dtype),
                           b=to_tensor(tree.b, device, dtype),
                           scale=float(tree.scale))
    return to_tensor(tree, device, dtype)


def params_from_numpy(tree: Any, device, dtype: Optional[torch.dtype] = None
                      ) -> Any:
    """The JAX param tree (numpy leaves) as the port's, on ``device``;
    ``dtype`` casts the dense floating-point weights (and sets the NF4
    dequant dtype), leaving NF4 bytes, codes and scales as they are."""
    return _convert(tree, device, dtype)


def lora_from_numpy(tree: Any, device) -> Any:
    """The JAX LoRA tree (numpy leaves) as the port's, on ``device``."""
    return _convert(tree, device, None)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def lora_to_numpy(tree: Any) -> Any:
    """The port's LoRA tree with numpy leaves: dicts and lists as they are,
    each ``LoRAWeights`` as an object with numpy ``a``/``b`` (bf16 widened
    to fp32) and float ``scale``, which :func:`lora_from_numpy` takes
    back."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: lora_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [lora_to_numpy(v) for v in tree]
    if isinstance(tree, LoRAWeights):
        return types.SimpleNamespace(a=_to_numpy(tree.a), b=_to_numpy(tree.b),
                                     scale=float(tree.scale))
    return _to_numpy(tree)
