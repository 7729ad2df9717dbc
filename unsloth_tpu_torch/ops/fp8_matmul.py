"""Fused FP8 block-dequant-inside-matmul (a projection over an FP8 base),
forward and backward.

Counterpart of unsloth_tpu/ops/fp8_matmul.py:fp8_matmul. On a CUDA tensor
the forward launches the hand-written kernel K12 (TPU ``_fwd_kernel``):
at 16 rows or fewer ``csrc/decode_matmul.cu``'s split-K decode kernel in
its e4m3 form (K1's decode kernel), above 16 rows, where
:func:`fp8_wgmma_form` holds, ``csrc/nf4_wgmma.cu``'s persistent Hopper
kernel in its e4m3 form (K1's kernel: the e4m3 bytes decoded and scaled
straight into the tensor cores' A operand, y^T = W x^T), else
``csrc/fp8_matmul.cu``'s tiles, which decode into shared memory; the e4m3
weight streams from device memory at one byte a parameter, so the dense
weight never exists there. :func:`fp8_matmul_tiles_ref` is the plain twin
of the Hopper form's walk, :func:`fp8_decode_tiles_ref` the decode
kernel's.
The backward, dx = g @ W, is K13 (TPU ``_bwd_kernel``): above 16 rows,
where :func:`fp8_dx_wgmma_form` holds, K2's Hopper kernel in its e4m3 form
(``csrc/nf4_wgmma.cu``: dx^T = W^T g^T, the bytes decoded into the A
operand, g the B operand), else ``csrc/fp8_matmul.cu``'s tiles;
:func:`fp8_matmul_dx_tiles_ref` and :func:`fp8_dx_tile_schedule` are the
Hopper form's walk's twins. W is frozen, so the gradient goes to x only. On
a CPU tensor both run their plain versions, :func:`~.fp8.fp8_matmul_ref`
and :func:`fp8_matmul_dx_ref`. The device of the tensor is the only thing that
chooses: the JAX package's opt-in switch (``UNSLOTH_FUSED_FP8``) and its
``% 128`` shape gate have no counterpart, and there is no fallback from a
kernel to its plain version.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .. import kernels
from .fp8 import FP8_DTYPE, FP8Tensor, dequantize_fp8, fp8_matmul_ref
from .qlora_matmul import (DECODE_ROWS, DECODE_STEP, DX_STAGE_ROWS, H100_SMS,
                           STAGE_BYTES, TILE_W, _decode_scratch,
                           _pair_schedule, _slice_sums, decode_schedule,
                           nf4_tile_schedule, tile_rows_x)

_MAX_ROW_TILES = 65535   # the kernels' grid.y: ceil(M / 64) row tiles


def fp8_matmul(x: torch.Tensor, q: FP8Tensor) -> torch.Tensor:
    """y = x @ dequant(W)^T; x [..., in], W [out, in] FP8; y in x.dtype.
    Differentiable in x (the backward is :func:`fp8_matmul_dx`).

    CUDA: bf16 x only (any row count, any out/in and block size);
    anything else raises."""
    if isinstance(x, torch.Tensor) and x.requires_grad \
            and torch.is_grad_enabled():
        return _FP8Matmul.apply(x, q)
    return fp8_matmul_fwd(x, q)


def _check_cuda(name: str, t: torch.Tensor, q: FP8Tensor, inner: int,
                inner_name: str) -> None:
    if t.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device {t.device}")
    if t.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{name} CUDA kernel takes bfloat16, got {t.dtype}")
    if t.shape[-1] != inner:
        raise ValueError(f"{name}: input has {t.shape[-1]} features, "
                         f"W expects {inner} ({inner_name})")
    out_f, in_f = q.shape
    grid = (-(-out_f // q.block), -(-in_f // q.block))
    if q.values.dtype != FP8_DTYPE or q.scales.dtype != torch.float32:
        raise TypeError(f"{name}: W must be float8_e4m3fn values with fp32 "
                        f"scales, got {q.values.dtype} and {q.scales.dtype}")
    if tuple(q.values.shape) != (out_f, in_f) or \
            tuple(q.scales.shape) != grid:
        raise ValueError(f"{name}: values {tuple(q.values.shape)} and scales "
                         f"{tuple(q.scales.shape)} do not fit shape "
                         f"{q.shape} at block {q.block} (scales {grid})")
    if q.values.device != t.device or q.scales.device != t.device:
        raise ValueError(f"{name}: input on {t.device}, W on "
                         f"{q.values.device}")


def fp8_wgmma_form(m: int, k: int, block: int, *ptrs: int) -> bool:
    """Whether K12 runs the Hopper kernel (csrc/fp8_matmul.cu's
    ``fp8_wgmma_form`` mirrors it): more than 16 rows, the scale block a
    multiple of the 32-byte stage (a stage then lies in one scale column,
    a warp's 16 W rows in one scale row), ``in`` a multiple of 16 (the TMA
    maps' row strides) and the pointers (x, W, y) 16-byte aligned. Other
    shapes above 16 rows run ``fp8_matmul_kernel<64, false>``; decode rows
    run ``csrc/decode_matmul.cu`` at every shape and block."""
    return (m > DECODE_ROWS and block % STAGE_BYTES == 0 and k % 16 == 0
            and all(p % 16 == 0 for p in ptrs))


#: the Hopper form's persistent schedule at y [m, n]: K1's, whose kernel
#: it runs
fp8_tile_schedule = nf4_tile_schedule


def fp8_matmul_tiles_ref(x: torch.Tensor, q: FP8Tensor, *,
                         scale_shift: int = 0, sms: int = H100_SMS):
    """y = x @ dequant(W)^T rebuilt from the Hopper form's walk, in plain
    PyTorch: (y in x.dtype, visits [tiles of x rows, tiles of W rows], the
    times the schedule stores each output tile).

    As the kernel: x and W come in tiles padded with zeros past M, N and K
    (TMA's fill; an e4m3 zero byte is 0); stage st reads bytes [32 st, 32
    st + 32) of the tile's 128 W rows against x columns [32 st, ..); each
    warp's 16 W rows read one scale row, (their first row) / B, past the
    grid's last row its last, and each stage one scale column, 32 st / B
    (``scale_shift`` reads the one that many columns further, the
    neighbour's); each weight is fp32(e4m3) * scale, rounded to x.dtype;
    the sums are fp32 (in another order than the tensor cores'), each
    output rounded once."""
    m, k = x.shape
    n = q.shape[0]
    if q.block % STAGE_BYTES:
        raise ValueError(f"block {q.block} is not a multiple of the "
                         f"{STAGE_BYTES}-byte stage")
    bx = tile_rows_x(m)
    schedule = fp8_tile_schedule(m, n, sms)
    mp, np_ = -(-m // bx) * bx, -(-n // TILE_W) * TILE_W
    nst = -(-k // STAGE_BYTES)
    kp = nst * STAGE_BYTES
    xp = torch.zeros((mp, kp), dtype=torch.float32)
    xp[:m, :k] = x.float()
    wv = torch.zeros((np_, kp), dtype=torch.float32)
    wv[:n, :k] = q.values.float()
    rows = (torch.arange(np_) // 16 * 16 // q.block).clamp(
        max=q.scales.shape[0] - 1)
    cols = (torch.arange(nst) * STAGE_BYTES // q.block + scale_shift
            ).clamp(max=q.scales.shape[1] - 1)
    sc = q.scales.float()[rows][:, cols].repeat_interleave(STAGE_BYTES, 1)
    w = (wv * sc).to(x.dtype).float()
    acc = torch.zeros((mp, np_), dtype=torch.float32)
    for st in range(nst):
        c = slice(st * STAGE_BYTES, (st + 1) * STAGE_BYTES)
        acc += xp[:, c] @ w[:, c].t()
    y = torch.empty((m, n), dtype=x.dtype)
    visits = torch.zeros((mp // bx, np_ // TILE_W), dtype=torch.int64)
    for tiles in schedule:
        for m0, n0 in tiles:
            visits[m0 // bx, n0 // TILE_W] += 1
            y[m0:m0 + bx, n0:n0 + TILE_W] = \
                acc[m0:min(m0 + bx, m), n0:min(n0 + TILE_W, n)].to(x.dtype)
    return y, visits


def fp8_decode_tiles_ref(x: torch.Tensor, q: FP8Tensor, *,
                         scale_shift: int = 0,
                         drop_slice: Optional[int] = None,
                         sms: int = H100_SMS):
    """y = x @ dequant(W)^T rebuilt from the decode kernel's e4m3 walk, in
    plain PyTorch: (y in x.dtype, visits [row groups, K slices]: the times
    the schedule runs each unit).

    As the kernel (``decode_schedule(m, n, k, "fp8")``): unit (group,
    slice) reads bytes [64 st, 64 st + 64) of its W rows for its steps st,
    zero past K; each weight is fp32(e4m3) * scale[n / B][k / B] (one scale
    a 16-byte chunk where B % 16 == 0, the same value), rounded to
    x.dtype (``scale_shift`` reads the scale that many columns further
    along, the last past the grid's end: a neighbour's); a unit's products
    are summed in fp32 (in another order than the tensor cores'), the units
    of a group in slice order, each output rounded once. ``drop_slice``
    leaves that slice out of every group's sum."""
    m, k = x.shape
    n = q.shape[0]
    plan = decode_schedule(m, n, k, "fp8", sms)
    rows = torch.arange(n) // q.block
    cols = (torch.arange(k) // q.block + scale_shift).clamp(
        max=q.scales.shape[1] - 1)
    w32 = (q.values.float() * q.scales.float()[rows][:, cols]).to(
        x.dtype).float()

    def cols_of(st):
        return torch.arange(DECODE_STEP * st, min(DECODE_STEP * (st + 1), k))

    return _slice_sums(x.float(), w32, plan, cols_of, drop_slice, x.dtype)


def fp8_dx_wgmma_form(m: int, n: int, k: int, block: int, *ptrs: int
                      ) -> bool:
    """Whether K13 runs the Hopper kernel (csrc/fp8_matmul.cu's
    ``fp8_dx_wgmma_form`` mirrors it): K12's rule (more than 16 rows, the
    scale block a multiple of 32, so that a k step's 16 W rows and a warp's
    16 columns lie in one block; ``in`` a multiple of 16) with ``out`` a
    multiple of 8 (g's TMA row stride) and the pointers (g, W, dx) 16-byte
    aligned. Other shapes run ``fp8_matmul_kernel<64, true>``, decode rows
    ``<16, true>``."""
    return fp8_wgmma_form(m, k, block, *ptrs) and n % 8 == 0


#: K13's Hopper form (csrc/nf4_wgmma.cu, nf4_dx_wgmma_kernel<BX, true>): dx
#: columns a tile (warpgroup 0 the first 64, warpgroup 1 the rest; one
#: e4m3 byte a weight) and W rows a stage (K2's)
FP8_DX_TILE = 128
#: the rows and columns of W that one scale of the walk covers: a k step's
#: 16 W rows and a warp's 16 dx columns
FP8_DX_SCALE_TILE = 16


def fp8_dx_tile_schedule(m: int, k: int, sms: int = H100_SMS
                         ) -> List[List[Tuple[int, int]]]:
    """K13's Hopper form's persistent schedule at dx [m, k]: for each block
    of its grid, the (first row of g, first dx column) of the 128-column
    tiles it stores, in order. K2's schedule with 128-column tiles:
    clusters of two, as many as ``sms`` holds (at most one a unit); unit u
    is the g tile u // P against the column tiles 2 p and 2 p + 1, p = u %
    P; the partner of an odd last tile (past K) stores nothing."""
    return _pair_schedule(m, -(-k // FP8_DX_TILE), FP8_DX_TILE, sms)


def fp8_matmul_dx_tiles_ref(g: torch.Tensor, q: FP8Tensor, *,
                            scale_shift: Tuple[int, int] = (0, 0),
                            sms: int = H100_SMS):
    """dx = g @ dequant(W) rebuilt from K13's Hopper walk, in plain
    PyTorch: (dx in g.dtype, visits [tiles of g rows, 128-column tiles],
    the times the schedule stores each output tile).

    As the kernel: g comes in tiles padded with zeros past M and past N
    (TMA's fill), W [N, K] in 128-column tiles of 64-row stages padded with
    zero bytes past N and K (an e4m3 zero is 0); each 16 x 16 piece of W (a
    k step's rows, a warp's columns) reads one scale, the grid's entry at
    (its first row / B, its first column / B), past the grid's last row or
    column its last (``scale_shift`` (rows, columns) reads the one that
    many further along, a neighbour's); each weight is fp32(e4m3) * scale,
    rounded to g.dtype; the sums are fp32 (in another order than the tensor
    cores'), stage after stage, each output rounded once. Only the tiles
    the schedule stores are written, clipped at M and K."""
    m, n = g.shape
    k = q.shape[1]
    if q.block % STAGE_BYTES:
        raise ValueError(f"block {q.block} is not a multiple of the "
                         f"{STAGE_BYTES}-row and -column scale pieces")
    bx = tile_rows_x(m)
    schedule = fp8_dx_tile_schedule(m, k, sms)
    tiles_k = -(-k // FP8_DX_TILE)
    mp, kp = -(-m // bx) * bx, tiles_k * FP8_DX_TILE
    nst = -(-n // DX_STAGE_ROWS)
    np_ = nst * DX_STAGE_ROWS
    gp = torch.zeros((mp, np_), dtype=torch.float32)
    gp[:m, :n] = g.float()
    wv = torch.zeros((np_, kp), dtype=torch.float32)
    wv[:n, :k] = q.values.float()
    t = FP8_DX_SCALE_TILE
    rows = (torch.arange(np_) // t * t // q.block + scale_shift[0]).clamp(
        max=q.scales.shape[0] - 1)
    cols = (torch.arange(kp) // t * t // q.block + scale_shift[1]).clamp(
        max=q.scales.shape[1] - 1)
    w = (wv * q.scales.float()[rows][:, cols]).to(g.dtype).float()
    acc = torch.zeros((mp, kp), dtype=torch.float32)
    for st in range(nst):
        r = slice(st * DX_STAGE_ROWS, (st + 1) * DX_STAGE_ROWS)
        acc += gp[:, r] @ w[r]
    dx = torch.empty((m, k), dtype=g.dtype)
    visits = torch.zeros((mp // bx, tiles_k), dtype=torch.int64)
    for tiles in schedule:
        for m0, k0 in tiles:
            visits[m0 // bx, k0 // FP8_DX_TILE] += 1
            dx[m0:m0 + bx, k0:k0 + FP8_DX_TILE] = \
                acc[m0:min(m0 + bx, m), k0:min(k0 + FP8_DX_TILE, k)].to(
                    g.dtype)
    return dx, visits


def _launch(fn, name: str, a: torch.Tensor, q: FP8Tensor, cols: int,
            *extra) -> torch.Tensor:
    """Run ``fn`` (a C entry point) on a's rows, ``extra`` arguments (the
    Hopper kernels' tile counters) before the stream; returns [..., cols]."""
    lead = a.shape[:-1]
    a2d = a.reshape(-1, a.shape[-1]).contiguous()
    m = a2d.shape[0]
    out = torch.empty((m, cols), dtype=a.dtype, device=a.device)
    if m == 0:
        return out.reshape(*lead, cols)
    if -(-m // 64) > _MAX_ROW_TILES:
        raise NotImplementedError(f"{name}: {m} rows exceed the kernel's "
                                  f"grid ({_MAX_ROW_TILES} tiles of 64)")
    out_f, in_f = q.shape
    values, scales = q.values.contiguous(), q.scales.contiguous()
    rc = fn(a2d.data_ptr(), values.data_ptr(), scales.data_ptr(),
            out.data_ptr(), m, out_f, in_f, q.block, *extra,
            torch.cuda.current_stream(a.device).cuda_stream)
    kernels.check(rc, name)
    return out.reshape(*lead, cols)


def fp8_matmul_fwd(x: torch.Tensor, q: FP8Tensor,
                   tile_counts: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """y = x @ dequant(W)^T without autograd: K12 on a CUDA tensor, the
    plain :func:`~.fp8.fp8_matmul_ref` on a CPU one. ``tile_counts`` (CUDA
    only: an int32 [2] on x's device, or None) receives what the kernel
    adds to it: at 16 rows or fewer the decode kernel's units stored and
    16-byte chunks of W read (``decode_schedule(..., "fp8").counts``),
    above where :func:`fp8_wgmma_form` holds the Hopper form's output
    tiles stored and stages consumed, else nothing."""
    if x.device.type == "cpu":
        return fp8_matmul_ref(x, q)
    _check_cuda("fp8_matmul", x, q, q.shape[1], "in")
    counts = None if tile_counts is None else tile_counts.data_ptr()
    m = x.numel() // x.shape[-1] if x.shape[-1] else 0
    if 0 < m <= DECODE_ROWS:
        y = _launch_decode(x, q, counts)
    else:
        y = _launch(kernels.library().unsloth_fp8_matmul_bf16, "fp8_matmul",
                    x, q, q.shape[0], counts)
    fp8_matmul_fwd.launches += 1
    return y


def _launch_decode(x: torch.Tensor, q: FP8Tensor, counts) -> torch.Tensor:
    """K12 at 16 rows or fewer: csrc/decode_matmul.cu's e4m3 form under
    ``decode_schedule(m, out, in, "fp8")``. Counted under
    ``fp8_matmul_decode.launches``."""
    out_f, in_f = q.shape
    lead = x.shape[:-1]
    x2d = x.reshape(-1, in_f).contiguous()
    m = x2d.shape[0]
    y = torch.empty((m, out_f), dtype=x.dtype, device=x.device)
    plan = decode_schedule(m, out_f, in_f, "fp8")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    partials, arrivals = _decode_scratch(plan, x.device, stream)
    values, scales = q.values.contiguous(), q.scales.contiguous()
    rc = kernels.library().unsloth_decode_matmul_fp8(
        x2d.data_ptr(), values.data_ptr(), scales.data_ptr(), q.block,
        y.data_ptr(), partials, arrivals, m, out_f, in_f, plan.row_warps,
        plan.slices, plan.slice_steps, counts, stream)
    kernels.check(rc, "fp8_matmul (decode rows)")
    fp8_matmul_decode.launches += 1
    return y.reshape(*lead, out_f)


def fp8_matmul_decode(x: torch.Tensor, q: FP8Tensor,
                      tile_counts: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The forward at 16 rows of x or fewer: what :func:`fp8_matmul_fwd`
    runs there (the decode kernel on a CUDA tensor, the plain version on a
    CPU one); more rows raise."""
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    if rows > DECODE_ROWS:
        raise ValueError(f"fp8_matmul_decode: {rows} rows of x, at most "
                         f"{DECODE_ROWS}")
    return fp8_matmul_fwd(x, q, tile_counts)


#: launches of the decode kernel (K12 at 16 rows or fewer), also counted
#: in ``fp8_matmul_fwd.launches``
fp8_matmul_decode.launches = 0


#: number of kernel launches since the last reset (CPU calls do not count)
fp8_matmul_fwd.launches = 0


def fp8_matmul_dx_ref(g: torch.Tensor, q: FP8Tensor) -> torch.Tensor:
    """Plain dx = g @ dequant(W): W dequantized to g.dtype, one matmul whose
    output is in g.dtype (the TPU kernel's rounding points). The plain
    version of K13."""
    return torch.matmul(g, dequantize_fp8(q, g.dtype))


def fp8_matmul_dx(g: torch.Tensor, q: FP8Tensor,
                  tile_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dx = g @ dequant(W); g [..., out], W [out, in] FP8; dx [..., in] in
    g.dtype. The backward of :func:`fp8_matmul` with respect to x: K13 on a
    CUDA tensor (bf16 g only), the plain version on a CPU one.
    ``tile_counts`` (CUDA only: an int32 [2] on g's device, or None)
    receives what the Hopper form adds to it, the 128-column tiles it
    stored and the stages it consumed (nothing where
    :func:`fp8_dx_wgmma_form` does not hold)."""
    if g.device.type == "cpu":
        return fp8_matmul_dx_ref(g, q)
    _check_cuda("fp8_matmul_dx", g, q, q.shape[0], "out")
    dx = _launch(kernels.library().unsloth_fp8_matmul_dx_bf16,
                 "fp8_matmul_dx", g, q, q.shape[1],
                 None if tile_counts is None else tile_counts.data_ptr())
    fp8_matmul_dx.launches += 1
    return dx


#: number of kernel launches since the last reset (CPU calls do not count)
fp8_matmul_dx.launches = 0


class _FP8Matmul(torch.autograd.Function):
    """y = x @ W^T with the gradient to x only (JAX ``_vjp_bwd``, which
    gives the FP8 base zeros). The weight is frozen and kept on ``ctx``; no
    activation is saved."""

    @staticmethod
    def forward(ctx, x, q):
        ctx.q = q
        return fp8_matmul_fwd(x, q)

    @staticmethod
    def backward(ctx, g):
        return fp8_matmul_dx(g, ctx.q), None
