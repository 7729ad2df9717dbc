"""RMSNorm and LayerNorm forward and backward, in PyTorch with hand-written
CUDA kernels.

Counterpart of unsloth_tpu/ops/rms_norm.py:rms_norm: fp32 statistics
whatever the input dtype, and the Gemma variant's ``(1 + w)`` scale in
fp32. On a CUDA tensor :func:`rms_norm` launches ``csrc/rms_norm.cu``
(TPU ``_fwd_kernel``) and its backward :func:`rms_norm_bwd` the second
kernel of that file (TPU ``_bwd_kernel``); on a CPU tensor they run
:func:`rms_norm_ref` and :func:`rms_norm_bwd_ref`.

The backwards (K4, K6; ``csrc/norm_common.cuh``) take a form from
:func:`norm_bwd_form`: a row in registers over 1-8 warps, or strided;
dx alone where no weight gradient is asked for (``need_dw=False``, what
the autograd Functions pass for frozen weights: every LoRA path), one
launch a call either way. The TPU kernels always return dW; the port's
dx is the same with or without it.

LayerNorm, counterpart of the same module's ``layer_norm``: on a CUDA
tensor :func:`layer_norm_fwd` launches ``csrc/layer_norm.cu`` (TPU
``_ln_fwd_kernel``, K5) and :func:`layer_norm_bwd` its backward (TPU
``_ln_bwd_kernel``, K6); on a CPU tensor they run :func:`layer_norm_ref`
and :func:`layer_norm_bwd_ref`. K5 has two forms, one warp a row with
the row in registers where :func:`layer_norm_warp_form` takes the width,
else one block a row; :func:`layer_norm_rows_ref` is the plain twin of
their sum orders. JAX's ``_use_pallas`` gate (TPU only,
opt-in, ``d % 128 == 0``) is TPU machinery and is left out: the kernels
take fp32 and bf16 at any width. The device of ``x`` is the only thing
that chooses.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from .. import kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rms_norm_ref(x: torch.Tensor, w: torch.Tensor, eps: float,
                 gemma: bool = False) -> torch.Tensor:
    """Plain RMSNorm. x: [..., D], w: [D]; output in x.dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xhat = xf * torch.rsqrt(var + eps)
    wf = w.to(torch.float32)
    out = xhat * (1.0 + wf) if gemma else xhat * wf
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             gemma: bool = False) -> torch.Tensor:
    """RMSNorm over the last axis. x: [..., D] (bf16 or f32), w: [D].
    Differentiable in x and w (the backward is :func:`rms_norm_bwd`)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, eps, gemma)
    return _rms_norm_fwd(x, w, eps, gemma)


def _check_cuda(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise NotImplementedError(
            f"{name} CUDA kernel takes float32/bfloat16, got x {x.dtype}, "
            f"w {w.dtype}")
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"{name}: w shape {tuple(w.shape)} != ({d},)")
    if w.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, w on {w.device}")


def _rms_norm_fwd(x: torch.Tensor, w: torch.Tensor, eps: float,
                  gemma: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return rms_norm_ref(x, w, eps, gemma)
    _check_cuda("rms_norm", x, w)
    d = x.shape[-1]
    xc = x.contiguous()
    wc = w.contiguous()
    out = torch.empty_like(xc)
    rows = xc.numel() // d if d else 0
    if rows == 0:
        return out
    lib = kernels.library()
    rc = lib.unsloth_rms_norm(
        xc.data_ptr(), wc.data_ptr(), out.data_ptr(), rows, d, float(eps),
        int(bool(gemma)), _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "rms_norm")
    rms_norm.launches += 1
    return out


#: number of kernel launches since the last reset (CPU calls do not count)
rms_norm.launches = 0

# ---------------------------------------------------------------------------
# The backward kernels' form (K4, K6)
# ---------------------------------------------------------------------------

#: 32-bit registers a lane of the backward's row form may give to its
#: chunks of x and g (four each a chunk) and its fp32 dW (and dB) columns,
#: of the 128 a thread that __launch_bounds__(256, 2) leaves (the other
#: half holds w, the sums, addresses and temporaries)
NORM_LANE_REGS = 64
#: 16-byte chunks of a row a lane of the row form holds (the kernels'
#: instantiations)
NORM_CHUNKS = (2, 4)
#: warps of a backward block (256 threads), and the blocks an SM holds at
#: least (__launch_bounds__(256, 2)): the wave that decides whether a row
#: takes more warps (the grid itself takes the kernel's occupancy)
NORM_WARPS, NORM_BLOCKS_PER_SM = 8, 2


class NormBwdForm(NamedTuple):
    """How K4's and K6's kernels run a backward (:func:`norm_bwd_form`)."""
    #: 16-byte chunks of x (and of g) a lane holds in registers (the
    #: template C), 0 for the strided form
    chunks: int
    #: warps of a row group (the strided form: the block's eight)
    warps_per_row: int
    #: the grid: about one wave, each block walking rows in a grid-stride
    #: loop; with dW each leaves one fp32 partial row
    blocks: int
    #: blocks whose partial rows the last of them to arrive sums (Q); 0 in
    #: the dx-only form
    group_blocks: int

    @property
    def rows_per_block(self) -> int:
        """Row groups a block runs at a time, 8 / W."""
        return NORM_WARPS // self.warps_per_row

    @property
    def groups(self) -> int:
        """Groups of partial rows (0 in the dx-only form)."""
        return -(-self.blocks // self.group_blocks) if self.group_blocks \
            else 0

    def block_of_rows(self, rows: int) -> torch.Tensor:
        """The block whose partial row takes each of ``rows`` rows: row r is
        row group r % G of the block's (r // G) // blocks-th visit."""
        return (torch.arange(rows) // self.rows_per_block) % self.blocks

    def scratch(self, d: int, sums: int):
        """(fp32 floats, int32 counters) of the dW form's scratch: a
        partial row a block and a row a group, each ``sums`` rows (dW, and
        dB) of d rounded up to 4; a counter a group and one more."""
        groups = self.groups
        return ((self.blocks + groups) * sums * (-(-d // 4) * 4), groups + 1)


def norm_lane_registers(chunks: int, per_chunk: int, sums: int) -> int:
    """32-bit registers a lane of the row form gives its data: ``chunks``
    16-byte chunks of x and of g, and ``sums`` fp32 columns (dW; and dB)
    for each of their ``per_chunk`` elements."""
    return 8 * chunks + sums * per_chunk * chunks


@functools.lru_cache(maxsize=4096)
def norm_bwd_form(rows: int, d: int, dtype: torch.dtype, need_dw: bool,
                  layer: bool = False, aligned: bool = True, sms: int = 132,
                  blocks_per_sm: int = NORM_BLOCKS_PER_SM) -> NormBwdForm:
    """K4's (``layer`` False) or K6's form for ``rows`` rows of ``d``
    elements of ``dtype`` (x's) on a card of ``sms`` SMs that holds
    ``blocks_per_sm`` blocks of the form's kernel; ``need_dw``: dW (and
    K6's dB) too. The row form where ``d`` is a whole number of 16-byte
    chunks and the tensors are 16-byte aligned: the fewest warps a row (1,
    2, 4, 8) whose lanes hold the row in NORM_CHUNKS chunks each within
    NORM_LANE_REGS with the dW (and dB) columns
    (:func:`norm_lane_registers`), then, while the rows make less than a
    wave of NORM_BLOCKS_PER_SM blocks an SM and every lane keeps a chunk,
    twice the warps; else the strided form. The layout does not depend on
    ``need_dw``, so that dx is the same bits in both forms. The grid: the
    row groups in the fewest rounds of at most ``blocks_per_sm * sms``
    blocks, spread evenly over the blocks; with dW, groups of
    ceil(sqrt(blocks)) blocks."""
    chunks, warps = norm_bwd_layout(rows, d, dtype, layer, aligned, sms)
    units = -(-rows // (NORM_WARPS // warps))
    rounds = max(1, -(-units // (max(1, blocks_per_sm) * sms)))
    blocks = max(1, -(-units // rounds))
    return NormBwdForm(chunks, warps, blocks,
                       math.isqrt(blocks - 1) + 1 if need_dw else 0)


@functools.lru_cache(maxsize=4096)
def norm_bwd_layout(rows: int, d: int, dtype: torch.dtype, layer: bool,
                    aligned: bool = True, sms: int = 132):
    """(chunks a lane, warps a row) of :func:`norm_bwd_form`: the row's
    layout, which neither ``need_dw`` nor the occupancy moves."""
    per_chunk = 16 // torch.empty((), dtype=dtype).element_size()
    n = d // per_chunk
    wave = NORM_BLOCKS_PER_SM * sms

    def fit(warps):
        return next((c for c in NORM_CHUNKS if c * 32 * warps >= n), None)

    chunks, warps = 0, NORM_WARPS
    if aligned and d % per_chunk == 0:
        for w in (1, 2, 4, 8):
            c = fit(w)
            if c is not None and norm_lane_registers(
                    c, per_chunk, 2 if layer else 1) <= NORM_LANE_REGS:
                chunks, warps = c, w
                break
        while (chunks and warps < NORM_WARPS
               and -(-rows // (NORM_WARPS // warps)) < wave
               and n >= 64 * warps):
            warps *= 2
            chunks = fit(warps)
    return chunks, warps


@functools.lru_cache(maxsize=4096)
def _launch_form(rows: int, d: int, x_dtype: torch.dtype,
                 w_dtype: torch.dtype, need_dw: bool, layer: bool,
                 aligned: bool, device: torch.device):
    """(:func:`norm_bwd_form` on ``device``'s card at the occupancy of the
    kernel the form takes (the CUDA occupancy query; at least
    NORM_BLOCKS_PER_SM by its launch bounds), the dW form's scratch size
    or None): what a wrapper launches, one lookup a call."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunks, warps = norm_bwd_layout(rows, d, x_dtype, layer, aligned, sms)
    lib = kernels.library()
    fn = (lib.unsloth_layer_norm_bwd_blocks_per_sm if layer
          else lib.unsloth_rms_norm_bwd_blocks_per_sm)
    n = fn(chunks, warps, int(need_dw), d, _DTYPE_CODE[x_dtype],
           _DTYPE_CODE[w_dtype])
    if n < 0:
        kernels.check(-n, "layer_norm_bwd" if layer else "rms_norm_bwd")
    form = norm_bwd_form(rows, d, x_dtype, need_dw, layer, aligned, sms,
                         max(n, 1))
    return form, form.scratch(d, 2 if layer else 1) if need_dw else None


def norm_bwd_form_for(x: torch.Tensor, w: torch.Tensor, need_dw: bool,
                      layer: bool, aligned: bool = True) -> NormBwdForm:
    """:func:`norm_bwd_form` for x [..., D] and w on x's card, with the
    occupancy of the kernel the form takes (what the wrappers launch)."""
    d = x.shape[-1]
    return _launch_form(x.numel() // d, d, x.dtype, w.dtype, need_dw, layer,
                        aligned, x.device)[0]


def _aligned16(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def rms_norm_bwd_ref(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                     eps: float, gemma: bool = False):
    """Plain backward of :func:`rms_norm_ref`: (dx in x.dtype, dW in
    w.dtype), with the TPU kernel's formula in fp32:
    dx = inv * (wg - xhat * mean(wg * xhat)), dW = sum_rows(g * xhat)."""
    xf = x.to(torch.float32)
    gf = g.to(torch.float32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    wf = w.to(torch.float32)
    wg = gf * ((1.0 + wf) if gemma else wf)
    dx = inv * (wg - xhat * torch.mean(wg * xhat, dim=-1, keepdim=True))
    dw = (gf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def rms_norm_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                 eps: float = 1e-6, gemma: bool = False,
                 need_dw: bool = True):
    """Gradients of RMSNorm: (dx [..., D] in x.dtype, dW [D] in w.dtype, or
    None where ``need_dw`` is False). g is the output's gradient, in
    x.dtype. dW is an fp32 sum over all rows in a fixed order, rounded
    once. On the card one launch a call (K4, :func:`norm_bwd_form`)."""
    if x.device.type == "cpu":
        dx, dw = rms_norm_bwd_ref(x, w, g, eps, gemma)
        return dx, dw if need_dw else None
    _check_cuda("rms_norm_bwd", x, w)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"rms_norm_bwd: g {tuple(g.shape)} {g.dtype} on "
                         f"{g.device} does not match x {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    d = x.shape[-1]
    xc, gc, wc = x.contiguous(), g.contiguous(), w.contiguous()
    dx = torch.empty_like(xc)
    rows = xc.numel() // d if d else 0
    if rows == 0:
        return dx, (torch.zeros((d,), dtype=w.dtype, device=x.device)
                    if need_dw else None)
    form, scratch = _launch_form(rows, d, x.dtype, w.dtype, need_dw, False,
                                 _aligned16(xc, gc, wc, dx), x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dw, partials, arrivals = None, None, None
    if need_dw:
        dw = torch.empty((d,), dtype=w.dtype, device=x.device)
        partials, arrivals = kernels.device_scratch(*scratch, x.device,
                                                    stream)
    rc = kernels.library().unsloth_rms_norm_bwd(
        xc.data_ptr(), wc.data_ptr(), gc.data_ptr(), dx.data_ptr(),
        None if dw is None else dw.data_ptr(), partials, arrivals, rows, d,
        *form, float(eps), int(bool(gemma)), _DTYPE_CODE[x.dtype],
        _DTYPE_CODE[w.dtype], stream)
    kernels.check(rc, "rms_norm_bwd")
    rms_norm_bwd.launches += 1
    return dx, dw


#: number of kernel launches since the last reset (CPU calls do not count)
rms_norm_bwd.launches = 0


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with the TPU package's custom backward (JAX ``_vjp_bwd``):
    saves x and w, recomputes the statistics in the backward."""

    @staticmethod
    def forward(ctx, x, w, eps, gemma):
        ctx.save_for_backward(x, w)
        ctx.eps, ctx.gemma = eps, gemma
        return _rms_norm_fwd(x, w, eps, gemma)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dw = rms_norm_bwd(x, w, g.to(x.dtype), ctx.eps, ctx.gemma,
                              need_dw=need[1])
        return dx if need[0] else None, dw, None, None


# ---------------------------------------------------------------------------
# LayerNorm (K5 forward, K6 backward)
# ---------------------------------------------------------------------------

def layer_norm_ref(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor], eps: float = 1e-5
                   ) -> torch.Tensor:
    """Plain LayerNorm in fp32, output in x.dtype: mean, then
    var = mean((x - mean)^2), xhat * w (+ b). x: [..., D]; w, b: [D]."""
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * w.to(torch.float32)
    if b is not None:
        out = out + b.to(torch.float32)
    return out.to(x.dtype)


#: chunks of 16 bytes a lane of K5's warp form holds in registers, at most
#: (csrc/layer_norm.cu: bf16 rows up to 4,096 wide, fp32 up to 2,048)
LN_WARP_CHUNKS = 16


def layer_norm_warp_form(d: int, dtype: torch.dtype) -> bool:
    """Whether K5 runs a row of ``d`` elements of ``dtype`` one warp a row
    (16-byte aligned tensors; the wrapper's are unless x is an odd view):
    ``d`` a multiple of the 16-byte chunk and at most LN_WARP_CHUNKS
    chunks a lane."""
    per_chunk = 16 // torch.empty((), dtype=dtype).element_size()
    return d % per_chunk == 0 and -(-(d // per_chunk) // 32) <= LN_WARP_CHUNKS


def _shuffle_tree(p: torch.Tensor) -> torch.Tensor:
    """A warp's sum of p [..., 32] (lane partials) as its shuffle tree
    adds them: lane l adds lane l ^ off's value, off = 16, 8, 4, 2, 1."""
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        p = p + p[..., lanes ^ off]
    return p[..., 0]


def _row_sum(v: torch.Tensor, warp: bool, per_chunk: int) -> torch.Tensor:
    """The sum over the last axis of v [R, D] (fp32) in the order of K5's
    form: the warp form's lane l adds its chunks l, l + 32, ... element by
    element, then the shuffle tree; the block form's thread t adds
    elements t, t + 256, ..., then each warp's tree, then the tree over
    the eight warp sums (the other lanes zero)."""
    r, d = v.shape
    if warp:
        chunks = d // per_chunk
        order = [[c * per_chunk + e for c in range(lane, chunks, 32)
                  for e in range(per_chunk)] for lane in range(32)]
    else:
        order = [list(range(t, d, 256)) for t in range(256)]
    width = max(len(o) for o in order)
    idx = torch.tensor([o + [d] * (width - len(o)) for o in order])
    vp = torch.cat([v, torch.zeros((r, 1))], dim=1)
    part = torch.zeros((r, idx.shape[0]))
    for i in range(width):
        part = part + vp[:, idx[:, i]]
    if warp:
        return _shuffle_tree(part)
    warps = _shuffle_tree(part.reshape(r, 8, 32))
    return _shuffle_tree(torch.cat([warps, torch.zeros((r, 24))], dim=1))


def layer_norm_rows_ref(x: torch.Tensor, w: torch.Tensor,
                        b: Optional[torch.Tensor], eps: float = 1e-5
                        ) -> torch.Tensor:
    """:func:`layer_norm_ref` with K5's sum orders: the two statistics of
    each row summed in fp32 as the form the kernel takes for x's width
    and dtype sums them (:func:`_row_sum`), then divided by D; the output
    ``(x - mean) * rsqrt(var + eps) * w + b`` in fp32, rounded once."""
    d = x.shape[-1]
    warp = layer_norm_warp_form(d, x.dtype)
    per_chunk = 16 // x.element_size()
    xf = x.reshape(-1, d).to(torch.float32)
    mean = _row_sum(xf, warp, per_chunk)[:, None] / d
    var = _row_sum(torch.square(xf - mean), warp, per_chunk)[:, None] / d
    out = (xf - mean) * torch.rsqrt(var + eps) * w.to(torch.float32)
    if b is not None:
        out = out + b.to(torch.float32)
    return out.to(x.dtype).reshape(x.shape)


def layer_norm_bwd_ref(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                       eps: float = 1e-5):
    """Plain backward of :func:`layer_norm_ref`, the TPU kernel's formula
    in fp32: (dx in x.dtype, dW fp32, dB fp32) with dxhat = g * w,
    dx = inv * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
    dW = sum_rows(g * xhat), dB = sum_rows(g)."""
    d = x.shape[-1]
    xf = x.to(torch.float32)
    gf = g.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mean) * inv
    dxhat = gf * w.to(torch.float32)
    m1 = torch.mean(dxhat, dim=-1, keepdim=True)
    m2 = torch.mean(dxhat * xhat, dim=-1, keepdim=True)
    dx = inv * (dxhat - m1 - xhat * m2)
    dw = (gf * xhat).reshape(-1, d).sum(dim=0)
    db = gf.reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dw, db


def _check_ln_cuda(name: str, x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor]) -> None:
    _check_cuda(name, x, w)
    if b is not None and (b.dtype != w.dtype or b.shape != w.shape
                          or b.device != w.device):
        raise NotImplementedError(
            f"{name} CUDA kernel takes b like w ({w.dtype} {tuple(w.shape)} "
            f"on {w.device}), got {b.dtype} {tuple(b.shape)} on {b.device}")


def layer_norm_fwd(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor], eps: float = 1e-5
                   ) -> torch.Tensor:
    """LayerNorm forward (K5), not differentiable: x [..., D] fp32 or bf16,
    w [D], b [D] in w's dtype or None (zeros); output in x.dtype."""
    if x.device.type == "cpu":
        return layer_norm_ref(x, w, b, eps)
    _check_ln_cuda("layer_norm_fwd", x, w, b)
    d = x.shape[-1]
    xc = x.contiguous()
    out = torch.empty_like(xc)
    rows = xc.numel() // d if d else 0
    if rows == 0:
        return out
    rc = kernels.library().unsloth_layer_norm(
        xc.data_ptr(), w.contiguous().data_ptr(),
        None if b is None else b.contiguous().data_ptr(), out.data_ptr(),
        rows, d, float(eps), _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    return out


#: number of kernel launches since the last reset (CPU calls do not count)
layer_norm_fwd.launches = 0


def layer_norm_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                   eps: float = 1e-5, need_dw: bool = True):
    """LayerNorm gradients (K6): (dx [..., D] in x.dtype, dW [D] fp32,
    dB [D] fp32), dW and dB None where ``need_dw`` (the weight gradients)
    is False. g is the output's gradient, in x.dtype. dW and dB are fp32
    sums over all rows in a fixed order (no atomics). On the card one
    launch a call (K6, :func:`norm_bwd_form`)."""
    if x.device.type == "cpu":
        dx, dw, db = layer_norm_bwd_ref(x, w, g, eps)
        return (dx, dw, db) if need_dw else (dx, None, None)
    _check_cuda("layer_norm_bwd", x, w)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"layer_norm_bwd: g {tuple(g.shape)} {g.dtype} on "
                         f"{g.device} does not match x {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    d = x.shape[-1]
    xc, gc, wc = x.contiguous(), g.contiguous(), w.contiguous()
    dx = torch.empty_like(xc)
    rows = xc.numel() // d if d else 0
    if rows == 0:
        return dx, *(torch.zeros((2, d), dtype=torch.float32,
                                 device=x.device).unbind()
                     if need_dw else (None, None))
    form, scratch = _launch_form(rows, d, x.dtype, w.dtype, need_dw, True,
                                 _aligned16(xc, gc, wc, dx), x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dw = db = partials = arrivals = None
    if need_dw:
        dw, db = torch.empty((2, d), dtype=torch.float32,
                             device=x.device).unbind()
        partials, arrivals = kernels.device_scratch(*scratch, x.device,
                                                    stream)
    rc = kernels.library().unsloth_layer_norm_bwd(
        xc.data_ptr(), wc.data_ptr(), gc.data_ptr(), dx.data_ptr(),
        None if dw is None else dw.data_ptr(),
        None if db is None else db.data_ptr(), partials, arrivals, rows, d,
        *form, float(eps), _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], stream)
    kernels.check(rc, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    return dx, dw, db


#: number of kernel launches since the last reset (CPU calls do not count)
layer_norm_bwd.launches = 0


class _LayerNorm(torch.autograd.Function):
    """LayerNorm with the TPU package's custom backward (JAX
    ``_ln_vjp_bwd``): saves x and w, recomputes the statistics in the
    backward; dW and dB come out in w's and b's dtype, and no dB for
    ``b=None``."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        ctx.b_dtype = None if b is None else b.dtype
        return layer_norm_fwd(x, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        need_db = ctx.b_dtype is not None and need[2]
        dx, dw, db = layer_norm_bwd(x, w, g.to(x.dtype), ctx.eps,
                                    need_dw=need[1] or need_db)
        return (dx if need[0] else None,
                dw.to(w.dtype) if need[1] else None,
                db.to(ctx.b_dtype) if need_db else None, None)


def layer_norm(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None, eps: float = 1e-5
               ) -> torch.Tensor:
    """LayerNorm over the last axis. x: [..., D] (bf16 or f32), w: [D], b:
    [D] or None (zeros). Differentiable in x, w and b (the backward is
    :func:`layer_norm_bwd`)."""
    if torch.is_grad_enabled() and (
            x.requires_grad or w.requires_grad
            or (b is not None and b.requires_grad)):
        return _LayerNorm.apply(x, w, b, eps)
    return layer_norm_fwd(x, w, b, eps)
