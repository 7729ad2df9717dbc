"""Gated-MLP activations (SwiGLU / GEGLU) and plain activations, in PyTorch.

Counterpart of unsloth_tpu/ops/activations.py: ``act(e)`` in fp32, cast
back to e's dtype, times the up projection ``g``. The gated forms carry the
JAX package's custom backward: it saves only (e, g) and recomputes the
activation in fp32 (de = act'(e) * dh * g, dg = dh * act(e), each rounded
once to its input's dtype). gpt-oss's clamped GLU, :func:`gpt_oss_glu`,
has no custom backward, as in JAX: autograd through the fp32 formula.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _make_glu(act_fn):
    class _Glu(torch.autograd.Function):
        @staticmethod
        def forward(ctx, e, g):
            ctx.save_for_backward(e, g)
            return act_fn(e.to(torch.float32)).to(e.dtype) * g

        @staticmethod
        def backward(ctx, dh):
            e, g = ctx.saved_tensors
            with torch.enable_grad():
                ef = e.detach().to(torch.float32).requires_grad_(True)
                f = act_fn(ef)
            dhf = dh.to(torch.float32)
            (de,) = torch.autograd.grad(f, ef, dhf * g.to(torch.float32))
            return de.to(e.dtype), (dhf * f.detach()).to(g.dtype)

    def glu(e: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and (e.requires_grad or g.requires_grad):
            return _Glu.apply(e, g)
        return act_fn(e.to(torch.float32)).to(e.dtype) * g

    return glu


def _silu(e):
    return e * torch.sigmoid(e)


swiglu = _make_glu(_silu)
geglu_exact = _make_glu(lambda e: F.gelu(e, approximate="none"))
geglu_approx = _make_glu(lambda e: F.gelu(e, approximate="tanh"))

def _gpt_oss_act(e, g, alpha: float = 1.702, limit: float = 7.0):
    """gpt-oss GLU (HF GptOssExperts): gate clamped above at ``limit``, up
    clamped to [-limit, limit], gated swish with the (g + 1) linear term."""
    e = torch.clamp(e, max=limit)
    g = torch.clamp(g, min=-limit, max=limit)
    return (e * torch.sigmoid(alpha * e)) * (g + 1.0)


def gpt_oss_glu(e: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gpt-oss expert activation in fp32, cast to e's dtype."""
    return _gpt_oss_act(e.to(torch.float32),
                        g.to(torch.float32)).to(e.dtype)


ACT2GLU = {
    "silu": swiglu,
    "swish": swiglu,
    "gelu": geglu_exact,
    "gelu_new": geglu_approx,
    "gelu_tanh": geglu_approx,
    "gelu_pytorch_tanh": geglu_approx,
    "gpt_oss_glu": gpt_oss_glu,
}


def glu_for(act_name: str):
    try:
        return ACT2GLU[act_name]
    except KeyError:
        raise ValueError(f"Unsupported gated activation: {act_name!r}") from None


def _relu2(x):
    r = torch.relu(x.to(torch.float32))
    return (r * r).to(x.dtype)


_ACT = {
    "silu": lambda x: F.silu(x.to(torch.float32)).to(x.dtype),
    "gelu": lambda x: F.gelu(x.to(torch.float32)).to(x.dtype),
    "gelu_tanh": lambda x: F.gelu(x.to(torch.float32),
                                  approximate="tanh").to(x.dtype),
    "relu": torch.relu,
    "relu2": _relu2,
}


def act_for(act_name: str):
    """Plain (non-gated) activation."""
    try:
        return _ACT[act_name]
    except KeyError:
        raise ValueError(f"Unsupported activation: {act_name!r}") from None
