"""Grouped dense matmul over experts (the MoE expert products when the
experts are dense bf16 stacks), forward, dx and the weight gradient.

Counterpart of megablox ``gmm`` as unsloth_tpu/ops/moe.py:moe_mlp_grouped
calls it (``tiled_gmm``, with ``transpose_rhs=True``), and of its VJP
(megablox ``_gmm_bwd``). Rows of the input are sorted by expert;
``group_sizes`` [E] (int32, on the input's device) says how many rows each
expert owns. On a CUDA tensor :func:`gmm` launches the hand-written kernels
of K19: ``csrc/gmm.cu``'s forward, the same kernel with W untransposed for
its dx (megablox's VJP with ``transpose_rhs`` flipped), and
``csrc/tgmm.cu``'s :func:`tgmm`, the expert weight gradient (megablox
``tgmm``), when W is trained (full fine-tuning). At more than
``KERNEL_TILES["small_m"]`` rows the forward and dx are one persistent
Hopper kernel (wgmma fed by a TMA ring) over work units of (visit,
192-column tile), a visit being a 128-row tile's rows of one expert; at
fewer they are a small-tile wmma kernel, except the forward at 16 rows or
fewer (decode), which runs ``csrc/decode_matmul.cu``'s split-K kernel
under a grouped schedule (:func:`gmm_decode`; one launch a call, each
expert that owns rows read once; :func:`gmm_decode_tiles_ref` and
``qlora_matmul.grouped_decode_schedule`` are its walk's twins). On a CPU
tensor they run the
plain versions :func:`gmm_ref` and :func:`tgmm_ref`. The device of the tensor is the only
thing that chooses; there is no fallback from a kernel to its plain
version.

The optional per-expert bias is added as the JAX package adds it: the
product is rounded to the input dtype, then the bias (in that dtype) is
added and the sum rounded again. The kernel does both in its store
epilogue (no [m, N] bias gather), so :func:`gmm_ref` and the kernel differ
only by the order of the fp32 sums. The bias gradient is, in JAX, the
autodiff of a row gather (a scatter-add, no Pallas kernel); here it is
:func:`group_sum`, a plain segment sum in fp32 rounded once.

Divergences by design: the kernels mask ragged N and K (gpt-oss's 2,880)
where JAX pads them in memory to a multiple of 128, and :func:`tgmm` writes
W's [E, N, K] layout directly where megablox returns [E, K, N] and swaps
the axes.

The kernels take an optional ``unit_counts`` (int32 [4] on the card) to
which they add what they did: the forward and dx their work units of an
expert, their units of the rows past the groups (zeros), and the 64-row
halves they stored by TMA and by masked stores; :func:`tgmm` its units of
an expert with rows, its units of an empty expert, the 64-row chunks it
reduced and those of them it zeroed past the group's end; the decode
forward (an int32 [3]) its units, the 16-byte chunks of W it read and its
slots that found no expert. CPU calls count nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .nf4_gmm import _ALIGN, _aligned, grouped_decode_walk
from .qlora_matmul import (DECODE_ROWS, DECODE_STEP, H100_SMS,
                           _decode_scratch, grouped_decode_schedule)

#: the kernels' tiles: the forward and dx at more than ``small_m`` rows
#: take output tiles of ``rows`` x ``cols``; tgmm tiles [N, K] by
#: ``tgmm_n`` x ``tgmm_k`` and reduces a group's rows in chunks of
#: ``tgmm_chunk``
KERNEL_TILES = {"rows": 128, "cols": 192, "small_m": 64, "tgmm_n": 128,
                "tgmm_k": 192, "tgmm_chunk": 64}
#: the most experts the kernels take
MAX_EXPERTS = 1024


def gmm_ref(lhs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
            bias: Optional[torch.Tensor] = None, *,
            transpose: bool = False) -> torch.Tensor:
    """Plain grouped product: rows of group g times W_g^T (or, with
    ``transpose``, times W_g: the dx of the forward) in fp32, one cast to
    lhs.dtype, then + bias[g] in lhs.dtype (forward only). Rows outside
    every group are zero."""
    ends = torch.cumsum(group_sizes.to(torch.int64), 0).tolist()
    n_out = w.shape[2] if transpose else w.shape[1]
    out = torch.zeros((lhs.shape[0], n_out), dtype=lhs.dtype,
                      device=lhs.device)
    start = 0
    for g, end in enumerate(ends):
        if end > start:
            wg = w[g].to(torch.float32)
            y = (lhs[start:end].to(torch.float32)
                 @ (wg if transpose else wg.t())).to(lhs.dtype)
            if bias is not None and not transpose:
                y = y + bias[g].to(lhs.dtype)
            out[start:end] = y
        start = end
    return out


def _check_cuda(name: str, t: torch.Tensor, w: torch.Tensor,
                group_sizes: torch.Tensor, inner: int) -> None:
    if t.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device {t.device}")
    if t.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise NotImplementedError(f"{name} CUDA kernel takes bfloat16 input "
                                  f"and weights, got {t.dtype} and {w.dtype}")
    if t.ndim != 2 or w.ndim != 3 or t.shape[1] != inner:
        raise ValueError(f"{name}: input {tuple(t.shape)}, W "
                         f"{tuple(w.shape)}")
    e, n, k = w.shape
    if n % 8 or k % 8:
        raise NotImplementedError(f"{name} CUDA kernel needs N and K "
                                  f"multiples of 8; got W {tuple(w.shape)}")
    if w.device != t.device or group_sizes.device != t.device:
        raise ValueError(f"{name}: input on {t.device}, W on {w.device}, "
                         f"group sizes on {group_sizes.device}")
    if not w.is_contiguous() or w.data_ptr() % _ALIGN:
        raise ValueError(f"{name}: W must be contiguous and 16-byte aligned")
    if group_sizes.shape != (e,):
        raise ValueError(f"{name}: group_sizes {tuple(group_sizes.shape)} "
                         f"for {e} experts")
    if e > MAX_EXPERTS:
        raise NotImplementedError(f"{name} CUDA kernel takes at most "
                                  f"{MAX_EXPERTS} experts, got {e}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _counts(unit_counts: Optional[torch.Tensor], t: torch.Tensor,
            size: int = 4):
    """The counters' pointer, or None."""
    if unit_counts is None:
        return None
    if (unit_counts.dtype != torch.int32 or unit_counts.device != t.device
            or tuple(unit_counts.shape) != (size,)):
        raise ValueError(f"gmm: unit_counts must be an int32 [{size}] on "
                         f"{t.device}; got {unit_counts.dtype} "
                         f"{tuple(unit_counts.shape)} on {unit_counts.device}")
    return unit_counts.data_ptr()


def _out(m: int, n: int, like: torch.Tensor, decode: bool = False
         ) -> torch.Tensor:
    """The forward's or dx's output: the training-row kernel and the
    grouped decode kernel (``decode``) write every row (zeros past the
    groups), the small-tile kernel only the groups'."""
    if decode or m > KERNEL_TILES["small_m"]:
        return torch.empty((m, n), dtype=like.dtype, device=like.device)
    return torch.zeros((m, n), dtype=like.dtype, device=like.device)


def gmm_fwd(lhs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
            bias: Optional[torch.Tensor] = None, *,
            unit_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out [m, N] = lhs [m, K] @ W_g^T (+ bias[g]) per group, W [E, N, K];
    the plain version on a CPU tensor, K19 on a CUDA one. ``unit_counts``
    (CUDA only): an int32 [4] above 16 rows, an int32 [3] at 16 or fewer
    (``grouped_decode_schedule(...).grouped_counts``)."""
    if lhs.device.type == "cpu":
        return gmm_ref(lhs, w, group_sizes, bias)
    _check_cuda("gmm", lhs, w, group_sizes, w.shape[2])
    e, n, k = w.shape
    m = lhs.shape[0]
    if bias is not None and (tuple(bias.shape) != (e, n)
                             or bias.device != lhs.device):
        raise ValueError(f"gmm: bias {tuple(bias.shape)} on {bias.device} "
                         f"for W {tuple(w.shape)} on {lhs.device}")
    decode = m <= DECODE_ROWS
    out = _out(m, n, lhs, decode)
    if m == 0 or e == 0:
        return out.zero_()
    x = _aligned(lhs)
    b = None if bias is None else _aligned(bias.to(lhs.dtype))
    gs = group_sizes.to(torch.int32).contiguous()
    plan = (0, 0, 0)
    partials = arrivals = None
    if decode:
        # the schedule from the shapes, the sizes left on the device
        schedule = grouped_decode_schedule(m, e, n, k, "bf16")
        plan = schedule[:3]
        partials, arrivals = _decode_scratch(schedule, lhs.device,
                                             _stream(lhs))
    rc = kernels.library().unsloth_gmm_bf16(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        gs.data_ptr(), out.data_ptr(), m, e, n, k, *plan, partials, arrivals,
        _counts(unit_counts, lhs, 3 if decode else 4), _stream(lhs))
    kernels.check(rc, "gmm")
    gmm.launches += 1
    if decode:
        gmm_decode.launches += 1
    return out


def gmm_decode(lhs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
               bias: Optional[torch.Tensor] = None, *,
               unit_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward at 16 routed rows or fewer, no autograd: what
    :func:`gmm` runs there (the grouped decode kernel on a CUDA tensor,
    the plain version on a CPU one); more rows raise. ``unit_counts`` as
    :func:`gmm_fwd`'s."""
    if lhs.shape[0] > DECODE_ROWS:
        raise ValueError(f"gmm_decode: {lhs.shape[0]} rows, at most "
                         f"{DECODE_ROWS}")
    return gmm_fwd(lhs, w, group_sizes, bias, unit_counts=unit_counts)


#: launches of the grouped decode kernel (K19's forward at 16 rows or
#: fewer), also counted in ``gmm.launches``
gmm_decode.launches = 0


def gmm_decode_tiles_ref(x: torch.Tensor, w: torch.Tensor, group_sizes,
                         bias: Optional[torch.Tensor] = None, *,
                         next_expert: bool = False,
                         drop_slice: Optional[int] = None,
                         bias_first: bool = False, sms: int = H100_SMS):
    """y = x @ W_g^T (+ bias[g]) at 16 rows or fewer, rebuilt from the
    grouped decode kernel's walk in plain PyTorch: (y in x.dtype, visits
    [slots, row groups, slices]).

    As the kernel (``grouped_decode_schedule(m, E, N, K, "bf16")``,
    :func:`~unsloth_tpu_torch.ops.nf4_gmm.grouped_decode_walk`): a step
    reads 64 bytes (32 weights) of each W row against x columns 32 st..;
    the sums are fp32 (in another order than the tensor cores'), rounded
    to x.dtype, then the bias (in x.dtype) added and the sum rounded
    again, as the JAX package adds its gathered bias rows to gmm's
    output. Faults as the walk's, and ``bias_first``: the bias added to
    the fp32 sum before the one rounding (K14's epilogue, not K19's)."""
    e, n, k = w.shape
    m = x.shape[0]
    plan = grouped_decode_schedule(m, e, n, k, "bf16", sms)
    step = DECODE_STEP // 2

    def cols_of(st):
        return torch.arange(step * st, min(step * (st + 1), k))

    def finish(total, g, rows):
        if bias is None:
            return total.to(x.dtype)
        if bias_first:
            return (total + bias[g, rows].float()).to(x.dtype)
        return total.to(x.dtype) + bias[g, rows].to(x.dtype)

    return grouped_decode_walk(x, group_sizes, plan, n,
                               lambda g: w[g].float(), cols_of, finish,
                               next_expert=next_expert,
                               drop_slice=drop_slice)


def gmm_dx(g: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
           *, unit_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dx [m, K] = g [m, N] @ W_g per group, the backward of :func:`gmm`
    with respect to its input; the plain version on a CPU tensor, K19's dx
    on a CUDA one."""
    if g.device.type == "cpu":
        return gmm_ref(g, w, group_sizes, transpose=True)
    _check_cuda("gmm_dx", g, w, group_sizes, w.shape[1])
    e, n, k = w.shape
    m = g.shape[0]
    dx = _out(m, k, g)
    if m == 0 or e == 0:
        return dx.zero_()
    gg = _aligned(g)
    gs = group_sizes.to(torch.int32).contiguous()
    rc = kernels.library().unsloth_gmm_dx_bf16(
        gg.data_ptr(), w.data_ptr(), gs.data_ptr(), dx.data_ptr(), m, e, n,
        k, _counts(unit_counts, g), _stream(g))
    kernels.check(rc, "gmm_dx")
    gmm_dx.launches += 1
    return dx


#: number of kernel launches since the last reset (CPU calls do not count)
gmm_dx.launches = 0


def tgmm_ref(lhs: torch.Tensor, gy: torch.Tensor, group_sizes: torch.Tensor
             ) -> torch.Tensor:
    """Plain weight gradient: dW [E, N, K] with dW[g] = gy[rows of g]^T @
    lhs[rows of g] in fp32, one cast to lhs.dtype; an expert with no rows
    gets zeros, rows past the groups count for none."""
    ends = torch.cumsum(group_sizes.to(torch.int64), 0).tolist()
    out = torch.zeros((len(ends), gy.shape[1], lhs.shape[1]),
                      dtype=lhs.dtype, device=lhs.device)
    start = 0
    for g, end in enumerate(ends):
        if end > start:
            out[g] = (gy[start:end].to(torch.float32).t()
                      @ lhs[start:end].to(torch.float32)).to(lhs.dtype)
        start = end
    return out


def _check_tgmm(lhs: torch.Tensor, gy: torch.Tensor,
                group_sizes: torch.Tensor) -> None:
    if lhs.device.type != "cuda":
        raise NotImplementedError(f"tgmm: no kernel for device {lhs.device}")
    if lhs.dtype != torch.bfloat16 or gy.dtype != torch.bfloat16:
        raise NotImplementedError(f"tgmm CUDA kernel takes bfloat16 input "
                                  f"and gradient, got {lhs.dtype} and "
                                  f"{gy.dtype}")
    if lhs.ndim != 2 or gy.ndim != 2 or gy.shape[0] != lhs.shape[0] \
            or group_sizes.ndim != 1:
        raise ValueError(f"tgmm: input {tuple(lhs.shape)}, gradient "
                         f"{tuple(gy.shape)}, group sizes "
                         f"{tuple(group_sizes.shape)}")
    if gy.shape[1] % 8 or lhs.shape[1] % 8:
        raise NotImplementedError(f"tgmm CUDA kernel needs N and K "
                                  f"multiples of 8; got N={gy.shape[1]}, "
                                  f"K={lhs.shape[1]}")
    if gy.device != lhs.device or group_sizes.device != lhs.device:
        raise ValueError(f"tgmm: input on {lhs.device}, gradient on "
                         f"{gy.device}, group sizes on {group_sizes.device}")
    if group_sizes.shape[0] > MAX_EXPERTS:
        raise NotImplementedError(f"tgmm CUDA kernel takes at most "
                                  f"{MAX_EXPERTS} experts, got "
                                  f"{group_sizes.shape[0]}")


def tgmm(lhs: torch.Tensor, gy: torch.Tensor, group_sizes: torch.Tensor,
         *, unit_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dW [E, N, K] = gy[rows of g]^T @ lhs[rows of g] per group, the
    gradient of :func:`gmm` with respect to W [E, N, K]: the plain version
    on a CPU tensor, K19's tgmm on a CUDA one (bf16 lhs [m, K] and gy
    [m, N], N and K multiples of 8; anything else raises)."""
    if lhs.device.type == "cpu":
        return tgmm_ref(lhs, gy, group_sizes)
    _check_tgmm(lhs, gy, group_sizes)
    e, (m, k), n = group_sizes.shape[0], lhs.shape, gy.shape[1]
    dw = torch.empty((e, n, k), dtype=torch.bfloat16, device=lhs.device)
    if m == 0 or e == 0:
        return dw.zero_()
    x, g = _aligned(lhs), _aligned(gy)
    gs = group_sizes.to(torch.int32).contiguous()
    rc = kernels.library().unsloth_gmm_tgmm_bf16(
        x.data_ptr(), g.data_ptr(), gs.data_ptr(), dw.data_ptr(), m, e, n, k,
        _counts(unit_counts, lhs), _stream(lhs))
    kernels.check(rc, "tgmm")
    tgmm.launches += 1
    return dw


#: number of kernel launches since the last reset (CPU calls do not count)
tgmm.launches = 0


def group_sum(gy: torch.Tensor, group_sizes: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """[E, N]: the sum of gy's rows of each group in fp32, one cast to
    ``dtype`` (the gradient of the per-expert bias; rows past the groups
    count for none). Plain PyTorch on every device, without a host sync."""
    e = group_sizes.shape[0]
    ends = torch.cumsum(group_sizes.to(torch.int64), 0)
    rows = torch.arange(gy.shape[0], device=gy.device)
    expert = torch.searchsorted(ends, rows, right=True)   # E past the groups
    out = torch.zeros((e + 1, gy.shape[1]), dtype=torch.float32,
                      device=gy.device)
    out.index_add_(0, expert, gy.to(torch.float32))
    return out[:e].to(dtype)


class _Gmm(torch.autograd.Function):
    """Grouped y = x @ W_g^T + b_g and megablox's VJP: dx by
    :func:`gmm_dx`, dW by :func:`tgmm`, db by :func:`group_sum`, each only
    where its input needs a gradient; x is saved only when W is
    trained."""

    @staticmethod
    def forward(ctx, x, w, group_sizes, bias):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w,
                              group_sizes)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return gmm_fwd(x, w, group_sizes, bias)

    @staticmethod
    def backward(ctx, gy):
        x, w, group_sizes = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx = gmm_dx(gy, w, group_sizes) if need[0] else None
        dw = tgmm(x, gy, group_sizes).to(w.dtype) if need[1] else None
        db = (group_sum(gy, group_sizes, ctx.bias_dtype) if need[3]
              else None)
        return dx, dw, None, db


def gmm(lhs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped lhs[rows of group g] @ W_g^T (+ bias[g]) with W [E, N, K]
    dense and rows sorted by expert; differentiable in lhs (the backward
    is :func:`gmm_dx`), in W (:func:`tgmm`) and in the bias
    (:func:`group_sum`).

    CUDA: bf16 lhs and W, W contiguous, N and K multiples of 8; anything
    else raises."""
    if torch.is_grad_enabled() and (
            lhs.requires_grad or w.requires_grad
            or (bias is not None and bias.requires_grad)):
        return _Gmm.apply(lhs, w, group_sizes, bias)
    return gmm_fwd(lhs, w, group_sizes, bias)


#: number of kernel launches since the last reset (CPU calls do not count)
gmm.launches = 0
