"""Grouped NF4 dequant-inside-matmul over experts (the MoE QLoRA hot
path), forward and backward.

Counterpart of unsloth_tpu/ops/nf4_gmm.py. Rows of the input are sorted by
expert; ``group_sizes`` [E] (int32, on the input's device) says how many
rows each expert owns. On a CUDA tensor :func:`nf4_gmm` launches a
hand-written kernel (TPU ``_fwd_kernel``, K14), with the optional
per-expert bias [E, N] added in its epilogue: above 16 rows
``csrc/nf4_wgmma.cu``'s persistent Hopper kernel (K1's, the packed bytes
decoded straight into the tensor cores' A operand, under a grouped
schedule of row tiles laid from each group's first row), at 16 rows or
fewer ``csrc/decode_matmul.cu``'s split-K decode kernel under a grouped
schedule (one launch a call, each expert that owns rows read once:
:func:`nf4_gmm_decode`). :func:`nf4_gmm_tiles_ref` and
:func:`nf4_gmm_tile_schedule` are the Hopper kernel's walk's twins,
:func:`nf4_gmm_decode_tiles_ref` and ``qlora_matmul.grouped_decode_schedule``
the decode kernel's. The
backward, dx = g @ W_g per group (TPU ``_bwd_kernel``, K15), is
``csrc/nf4_wgmma.cu``'s grouped Hopper dx kernel at every row count (K2's
kernel, dx^T = W_g^T g^T with the bytes decoded into the A operand, under
the forward's grouped schedule); :func:`nf4_gmm_dx_tiles_ref` and
:func:`nf4_gmm_dx_tile_schedule` are its walk's twins. W and the bias are
frozen, so the gradient goes to the input only. The packed uint8 expert
weights stream from device memory, so the dense [E, N, K] stack never
exists there. On a CPU tensor both run the plain version
:func:`nf4_gmm_ref`. The device of the tensor is the only thing that
chooses; there is no fallback from a kernel to its plain version.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .. import kernels
from .nf4 import NF4_CODE, NF4Stacked, dequantize_nf4_stacked
from .qlora_matmul import (DECODE_ROWS, DECODE_STEP, DX_STAGE_ROWS,
                           DX_TILE_BYTES, H100_SMS, STAGE_BYTES, TILE_W,
                           DecodeSchedule, _decode_scratch,
                           grouped_decode_schedule, tile_rows_x)

_ALIGN = 16  # bytes: the kernels read x and the packed bytes 16 at a time
#: the most experts the Hopper kernel's shared-memory group tables hold
MAX_EXPERTS = 1024


def nf4_gmm_ref(lhs: torch.Tensor, q: NF4Stacked, group_sizes: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *,
                transpose: bool = False) -> torch.Tensor:
    """Plain grouped product (JAX ``nf4_gmm_ref``): W dequantized to fp32,
    rows of group g times W_g^T (or, with ``transpose``, times W_g: the
    dx of the forward) in fp32, plus bias[g] (forward only), one cast to
    lhs.dtype. Rows outside every group are zero."""
    w = dequantize_nf4_stacked(q, torch.float32)
    ends = torch.cumsum(group_sizes.to(torch.int64), 0)
    starts = ends - group_sizes.to(torch.int64)
    n_out = q.shape[2] if transpose else q.shape[1]
    x = lhs.to(torch.float32)
    out = torch.zeros((lhs.shape[0], n_out), dtype=torch.float32,
                      device=lhs.device)
    for g, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
        if e <= s:
            continue
        y = x[s:e] @ (w[g] if transpose else w[g].t())
        if bias is not None and not transpose:
            y = y + bias[g].to(torch.float32)
        out[s:e] = y
    return out.to(lhs.dtype)


def use_nf4_gmm(q) -> bool:
    """Quant blocks align to the split-half boundary (``in/2 % bs == 0``):
    the JAX package's condition for its fused kernel, and the port's for
    its kernels."""
    return (isinstance(q, NF4Stacked) and q.shape[2] % 2 == 0
            and (q.shape[2] // 2) % q.block_size == 0)


def _check_cuda(name: str, t: torch.Tensor, q: NF4Stacked,
                group_sizes: torch.Tensor, inner: int) -> None:
    if t.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device {t.device}")
    e, n, k = q.shape
    if t.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{name} CUDA kernel takes bfloat16, got {t.dtype}")
    if t.ndim != 2 or t.shape[1] != inner:
        raise ValueError(f"{name}: input {tuple(t.shape)}, W {q.shape}")
    if (q.block_size not in (32, 64) or not use_nf4_gmm(q) or (k // 2) % 32
            or n % 8):
        raise NotImplementedError(
            f"{name} CUDA kernel needs block_size 32 or 64, in/2 a multiple "
            f"of 32 and of the block, out a multiple of 8; got W {q.shape} "
            f"block_size {q.block_size}")
    if q.packed.device != t.device or group_sizes.device != t.device:
        raise ValueError(f"{name}: input on {t.device}, W on "
                         f"{q.packed.device}, group sizes on "
                         f"{group_sizes.device}")
    if group_sizes.shape != (e,):
        raise ValueError(f"{name}: group_sizes {tuple(group_sizes.shape)} "
                         f"for {e} experts")


def _group_bounds(group_sizes, m: int) -> List[Tuple[int, int]]:
    """[(first row, end)] of each group, the sizes clamped to [0, m] as the
    kernel clamps them."""
    out, off = [], 0
    for size in [int(v) for v in group_sizes]:
        end = min(off + max(size, 0), m)
        out.append((off, end))
        off = end
    return out


def nf4_gmm_tile_schedule(group_sizes, m: int, n: int, sms: int = H100_SMS
                          ) -> List[List[Tuple[int, int, int, int]]]:
    """The Hopper kernel's persistent schedule at y [m, n]: for each block
    of its grid, the (group, first row, end of the group's rows in the
    tile, first W row) of the output tiles it stores, in order.

    Group g's row tiles are laid from its first row: ceil(size_g / BX)
    tiles of BX rows (:func:`tile_rows_x`), the last
    ending at the group's end. Unit u is (row tile, pair p of W_g's
    128-row tiles), numbered group by group with the group's row tiles
    fastest; the grid is clusters of two, as many as ``sms`` holds and at
    most one for each unit the sizes could need (each group adds at most
    one partial tile: the launch does not know them); cluster c takes
    units c, c + clusters, ..., its block of rank r the W tile 2 p + r
    (past N, where the W tiles are odd in number, nothing is stored)."""
    return _grouped_schedule(group_sizes, m, -(-n // TILE_W), TILE_W, sms)


def _grouped_schedule(group_sizes, m: int, tiles: int, width: int, sms: int
                      ) -> List[List[Tuple[int, int, int, int]]]:
    """The grouped Hopper kernels' schedule over ``tiles`` column tiles of
    ``width`` (see :func:`nf4_gmm_tile_schedule`)."""
    bx = tile_rows_x(m)
    pairs = -(-tiles // 2)
    groups = _group_bounds(group_sizes, m)
    units = []
    for g, (lo, end) in enumerate(groups):
        nt = -(-(end - lo) // bx)
        units += [(g, lo + t * bx, min(end, lo + (t + 1) * bx), p)
                  for p in range(pairs) for t in range(nt)]
    bound = (-(-m // bx) + len(groups)) * pairs
    clusters = min(bound, max(1, sms // 2))
    return [[(g, row0, hi, (2 * p + r) * width)
             for g, row0, hi, p in units[c::clusters]
             if 2 * p + r < tiles]
            for c in range(clusters) for r in (0, 1)]


def nf4_gmm_tile_counts(group_sizes, m: int, n: int, k: int) -> List[int]:
    """The Hopper kernel's counters at these sizes: [output tiles stored,
    their stages, tiles stored by masked stores (a group's last where it
    is short)]."""
    bx = tile_rows_x(m)
    tiles = [t for block in nf4_gmm_tile_schedule(group_sizes, m, n)
             for t in block]
    return [len(tiles), len(tiles) * (k // 2 // STAGE_BYTES),
            sum(hi - row0 < bx for _, row0, hi, _ in tiles)]


def nf4_gmm_tiles_ref(x: torch.Tensor, q: NF4Stacked, group_sizes,
                      bias: Optional[torch.Tensor] = None, *,
                      past_end: bool = False, low_with_high: bool = False,
                      sms: int = H100_SMS):
    """y = x @ dequant(W_g)^T + bias[g] rebuilt from the Hopper kernel's
    walk, in plain PyTorch: (y in x.dtype, stores [m, W tiles], the times
    the schedule stores each row of each 128-column output tile).

    As the kernel: the tiles of :func:`nf4_gmm_tile_schedule`; a tile reads
    BX rows of x from its first row on (the next group's rows, or zeros past
    m, where the group ends sooner); stage st reads bytes [32 st, 32 st +
    32) of each of W_g's rows, their high nibbles against x columns 32 st..
    with the absmax block 32 st / B and their low nibbles against x columns
    K/2 + 32 st.. with the block (K/2 + 32 st) / B; each weight is code *
    absmax in fp32, rounded to x.dtype; the sums are fp32 (in another order
    than the tensor cores'), stage after stage; the fp32 bias is added to
    the sum, which is rounded once; a tile stores its group's rows only, and
    the rows outside every group are zeros. Two faults: ``past_end`` stores
    each tile's rows past its group's end too (over the next group's rows,
    after their own stores), ``low_with_high`` reads the low side with the
    high side's absmax block."""
    e, n, k = q.shape
    m = x.shape[0]
    half, bs = k // 2, q.block_size
    bx = tile_rows_x(m)
    code = NF4_CODE.float()
    xp = torch.zeros((m + bx, k), dtype=torch.float32)
    xp[:m] = x.float()
    absmax = q.absmax.float().reshape(e, n, k // bs)
    j = torch.arange(half)
    stage0 = j // STAGE_BYTES * STAGE_BYTES   # each byte's stage's first
    blk_hi = stage0 // bs
    blk_lo = blk_hi if low_with_high else (half + stage0) // bs
    nst = half // STAGE_BYTES
    y = torch.zeros((m, n), dtype=x.dtype)
    stores = torch.zeros((m, -(-n // TILE_W)), dtype=torch.int64)
    late = []
    weights = {}
    for tiles in nf4_gmm_tile_schedule(group_sizes, m, n, sms):
        for g, row0, hi, n0 in tiles:
            if g not in weights:
                pk = q.packed[g].to(torch.int64)
                w_hi = (code[pk >> 4] * absmax[g][:, blk_hi]).to(x.dtype)
                w_lo = (code[pk & 15] * absmax[g][:, blk_lo]).to(x.dtype)
                weights[g] = (w_hi.float(), w_lo.float())
            w_hi, w_lo = weights[g]
            n1 = min(n0 + TILE_W, n)
            acc = torch.zeros((bx, n1 - n0), dtype=torch.float32)
            for st in range(nst):
                c = slice(st * STAGE_BYTES, (st + 1) * STAGE_BYTES)
                acc += xp[row0:row0 + bx, c] @ w_hi[n0:n1, c].t()
                acc += xp[row0:row0 + bx, half + st * STAGE_BYTES:
                          half + (st + 1) * STAGE_BYTES] @ w_lo[n0:n1, c].t()
            if bias is not None:
                acc += bias[g, n0:n1].float()
            out = acc.to(x.dtype)
            y[row0:hi, n0:n1] = out[:hi - row0]
            stores[row0:hi, n0 // TILE_W] += 1
            end = min(row0 + bx, m)
            if past_end and end > hi:
                late.append((out[hi - row0:end - row0], hi, end, n0, n1))
    for out, hi, end, n0, n1 in late:
        y[hi:end, n0:n1] = out
        stores[hi:end, n0 // TILE_W] += 1
    return y, stores


def nf4_gmm_dx_tile_schedule(group_sizes, m: int, k: int,
                             sms: int = H100_SMS
                             ) -> List[List[Tuple[int, int, int, int]]]:
    """The grouped Hopper dx kernel's persistent schedule at dx [m, k]: for
    each block of its grid, the (group, first row, end of the group's rows
    in the tile, first packed byte column j0) of the tiles it stores, in
    order; a tile is dx[rows, j0..j0 + 63] (the high-nibble side) and
    dx[rows, k/2 + j0..] (the low side). The forward's schedule
    (:func:`nf4_gmm_tile_schedule`) with K/2's 64-byte tiles for W_g's
    128-row tiles: row tiles laid from each group's first row, units (row
    tile, byte tile pair) group by group with the row tiles fastest, the
    block of rank r taking the byte tile 2 p + r (past K/2, where the byte
    tiles are odd in number: computed, not stored)."""
    return _grouped_schedule(group_sizes, m, -(-(k // 2) // DX_TILE_BYTES),
                             DX_TILE_BYTES, sms)


def nf4_gmm_dx_tile_counts(group_sizes, m: int, n: int, k: int) -> List[int]:
    """The grouped Hopper dx kernel's counters at these sizes: [output
    tiles stored, their stages (ceil(N / 64) each), tiles stored by masked
    stores (a group's last where it is short)]."""
    bx = tile_rows_x(m)
    tiles = [t for block in nf4_gmm_dx_tile_schedule(group_sizes, m, k)
             for t in block]
    return [len(tiles), len(tiles) * -(-n // DX_STAGE_ROWS),
            sum(hi - row0 < bx for _, row0, hi, _ in tiles)]


def nf4_gmm_dx_tiles_ref(g: torch.Tensor, q: NF4Stacked, group_sizes, *,
                         past_end: bool = False, first_block: bool = False,
                         sms: int = H100_SMS):
    """dx = g @ dequant(W_g) per group rebuilt from the grouped Hopper dx
    kernel's walk, in plain PyTorch: (dx in g.dtype, stores [m, byte
    tiles], the times the schedule stores each row of each tile).

    As the kernel: the tiles of :func:`nf4_gmm_dx_tile_schedule`; a tile
    reads BX rows of g from its first row on (the next group's rows, or
    zeros past m, where the group ends sooner) against 64 packed byte
    columns j0.. of W_g, in stages of 64 of W_g's rows (the rows past N
    add nothing: their absmax and g's columns there are zeros); its high
    nibbles are dx columns j0.., its low nibbles K/2 + j0..; the absmax of
    the tile's columns 0-31 on each side is the block of its column 0 (j0
    / B, (K/2 + j0) / B), of its columns 32-63 the block of its column 32
    (at B = 32 every 64-byte tile spans two blocks a side); each weight is
    code * absmax in fp32, rounded to g.dtype; the sums are fp32 (in
    another order than the tensor cores'), stage after stage, rounded
    once; a tile stores its group's rows only, and neither side past K/2;
    the rows outside every group are zeros. Two faults: ``past_end``
    stores each tile's rows past its group's end too (over the next
    group's rows, after their own stores), ``first_block`` reads a tile's
    columns 32-63 with the block of its column 0."""
    e, n, k = q.shape
    m = g.shape[0]
    half, bs = k // 2, q.block_size
    bx = tile_rows_x(m)
    code = NF4_CODE.float()
    gp = torch.zeros((m + bx, n), dtype=torch.float32)
    gp[:m] = g.float()
    absmax = q.absmax.float().reshape(e, n, k // bs)
    j = torch.arange(half)
    j0 = j - j % DX_TILE_BYTES
    part = j0 if first_block else j0 + 32 * (j % DX_TILE_BYTES >= 32)
    blk_hi, blk_lo = part // bs, (half + part) // bs
    nst = -(-n // DX_STAGE_ROWS)
    dx = torch.zeros((m, k), dtype=g.dtype)
    stores = torch.zeros((m, -(-half // DX_TILE_BYTES)), dtype=torch.int64)
    late = []
    weights = {}
    for tiles in nf4_gmm_dx_tile_schedule(group_sizes, m, k, sms):
        for grp, row0, hi, c0 in tiles:
            if grp not in weights:
                pk = q.packed[grp].to(torch.int64)
                w_hi = (code[pk >> 4] * absmax[grp][:, blk_hi]).to(g.dtype)
                w_lo = (code[pk & 15] * absmax[grp][:, blk_lo]).to(g.dtype)
                weights[grp] = (w_hi.float(), w_lo.float())
            w_hi, w_lo = weights[grp]
            c1 = min(c0 + DX_TILE_BYTES, half)
            rows = gp[row0:row0 + bx]
            acc_hi = torch.zeros((bx, c1 - c0), dtype=torch.float32)
            acc_lo = torch.zeros((bx, c1 - c0), dtype=torch.float32)
            for st in range(nst):
                r = slice(st * DX_STAGE_ROWS, min((st + 1) * DX_STAGE_ROWS, n))
                acc_hi += rows[:, r] @ w_hi[r, c0:c1]
                acc_lo += rows[:, r] @ w_lo[r, c0:c1]
            out = torch.cat([acc_hi, acc_lo], 1).to(g.dtype)
            cols = torch.cat([torch.arange(c0, c1),
                              half + torch.arange(c0, c1)])
            dx[row0:hi, cols] = out[:hi - row0]
            stores[row0:hi, c0 // DX_TILE_BYTES] += 1
            end = min(row0 + bx, m)
            if past_end and end > hi:
                late.append((out[hi - row0:end - row0], hi, end, cols, c0))
    for out, hi, end, cols, c0 in late:
        dx[hi:end, cols] = out
        stores[hi:end, c0 // DX_TILE_BYTES] += 1
    return dx, stores


def grouped_decode_walk(x: torch.Tensor, group_sizes, plan: DecodeSchedule,
                        n: int, weights, cols_of, finish, *,
                        next_expert: bool = False,
                        drop_slice: Optional[int] = None):
    """y [m, n] rebuilt from the grouped decode kernel's walk: (y in
    x.dtype, visits [slots, row groups, slices], the times the walk runs
    each unit). Slot s takes the s-th expert that owns rows (the sizes
    clamped as :func:`_group_bounds`; a slot past them does nothing); its
    unit (group, slice) multiplies the expert's x rows by
    ``weights(expert)`` ([n, K] fp32, the kernel's weights) at the columns
    ``cols_of(step)`` of its steps, in fp32; a row group's slices are
    summed in slice order and ``finish(sum, expert, rows)`` rounds the
    result; the rows past the groups are zeros. Faults: ``next_expert``
    reads each slot's weights from the next expert that owns rows;
    ``drop_slice`` leaves that slice out of every sum."""
    m = x.shape[0]
    x32 = x.float()
    live = [(g, lo, hi) for g, (lo, hi) in
            enumerate(_group_bounds(group_sizes, m)) if hi > lo]
    y = torch.zeros((m, n), dtype=x.dtype)
    visits = torch.zeros((plan.slots, plan.groups, plan.slices),
                         dtype=torch.int64)
    for slot, (g, lo, hi) in enumerate(live[:plan.slots]):
        w = weights(live[(slot + 1) % len(live)][0] if next_expert else g)
        for gi in range(plan.groups):
            rows = slice(gi * plan.rows, min((gi + 1) * plan.rows, n))
            total = torch.zeros((hi - lo, rows.stop - rows.start))
            for si in range(plan.slices):
                visits[slot, gi, si] += 1
                st0 = si * plan.slice_steps
                st1 = min(st0 + plan.slice_steps, plan.steps)
                cols = torch.cat([cols_of(st) for st in range(st0, st1)])
                if si != drop_slice:
                    total = total + x32[lo:hi, cols] @ w[rows][:, cols].t()
            y[lo:hi, rows] = finish(total, g, rows)
    return y, visits


def nf4_gmm_decode_tiles_ref(x: torch.Tensor, q: NF4Stacked, group_sizes,
                             bias: Optional[torch.Tensor] = None, *,
                             next_expert: bool = False,
                             drop_slice: Optional[int] = None,
                             sms: int = H100_SMS):
    """y = x @ dequant(W_g)^T + bias[g] at 16 rows or fewer, rebuilt from
    the grouped decode kernel's walk in plain PyTorch: (y in x.dtype,
    visits [slots, row groups, slices]).

    As the kernel (``grouped_decode_schedule(m, E, N, K, "nf4")``,
    :func:`grouped_decode_walk`): a step reads 64 bytes of a W row, their
    high nibbles against x columns 64 st.., their low nibbles against
    K/2 + 64 st..; each 16-byte chunk of a side takes the absmax block of
    its first element (K/2 % 32 == 0: one block a chunk at B = 32 and
    64); each weight is code * absmax in fp32, rounded to x.dtype; the
    sums are fp32 (in another order than the tensor cores'); the fp32
    bias is added to the sum, which is rounded once."""
    e, n, k = q.shape
    m = x.shape[0]
    half, bs = k // 2, q.block_size
    plan = grouped_decode_schedule(m, e, n, k, "nf4", sms)
    code = NF4_CODE.float()
    absmax = q.absmax.float().reshape(e, n, k // bs)
    first = torch.arange(half) // 16 * 16     # each chunk's first byte
    blk_hi, blk_lo = first // bs, (half + first) // bs

    def weights(g):
        pk = q.packed[g].to(torch.int64)
        w_hi = (code[pk >> 4] * absmax[g][:, blk_hi]).to(x.dtype)
        w_lo = (code[pk & 15] * absmax[g][:, blk_lo]).to(x.dtype)
        return torch.cat([w_hi, w_lo], 1).float()

    def cols_of(st):
        c = torch.arange(DECODE_STEP * st, min(DECODE_STEP * (st + 1), half))
        return torch.cat([c, half + c])

    def finish(total, g, rows):
        if bias is not None:
            total = total + bias[g, rows].float()
        return total.to(x.dtype)

    return grouped_decode_walk(x, group_sizes, plan, n, weights, cols_of,
                               finish, next_expert=next_expert,
                               drop_slice=drop_slice)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % _ALIGN else t


def nf4_gmm_fwd(lhs: torch.Tensor, q: NF4Stacked, group_sizes: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                tile_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out [m, N] = lhs [m, K] @ dequant(W_g)^T (+ bias[g]) per group; the
    plain version on a CPU tensor, K14 on a CUDA one. ``tile_counts``
    (CUDA only: an int32 [3] on lhs's device, or None) receives what the
    kernel adds to it: above 16 rows the Hopper kernel's tiles
    (:func:`nf4_gmm_tile_counts`), at 16 or fewer the decode kernel's
    units, 16-byte chunks and empty slots
    (``grouped_decode_schedule(...).grouped_counts``)."""
    if lhs.device.type == "cpu":
        return nf4_gmm_ref(lhs, q, group_sizes, bias)
    _check_cuda("nf4_gmm", lhs, q, group_sizes, q.shape[2])
    e, n, k = q.shape
    m = lhs.shape[0]
    if e > MAX_EXPERTS:
        raise NotImplementedError(f"nf4_gmm CUDA kernel takes at most "
                                  f"{MAX_EXPERTS} experts, got {e}")
    # both kernels write every row (zeros past the groups)
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    if m == 0:
        return out
    x = _aligned(lhs)
    packed = q.packed.contiguous()
    if packed.data_ptr() % _ALIGN:
        raise ValueError(f"nf4_gmm: packed weight is not {_ALIGN}-byte "
                         "aligned")
    absmax = q.absmax.to(torch.float32).contiguous()
    gs = group_sizes.to(torch.int32).contiguous()
    plan = (0, 0, 0)
    partials = arrivals = None
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    if m <= DECODE_ROWS:
        # the bias as stored (bf16 or fp32: no cast pass); the schedule
        # from the shapes, the sizes left on the device
        b = None if bias is None else (
            bias if bias.dtype in (torch.bfloat16, torch.float32)
            else bias.to(torch.float32)).contiguous()
        schedule = grouped_decode_schedule(m, e, n, k, "nf4")
        plan = schedule[:3]
        partials, arrivals = _decode_scratch(schedule, lhs.device,
                                             stream)
    else:
        b = None if bias is None else bias.to(torch.float32).contiguous()
    rc = kernels.library().unsloth_nf4_gmm_bf16(
        x.data_ptr(), packed.data_ptr(), absmax.data_ptr(),
        None if b is None else b.data_ptr(),
        int(b is None or b.dtype == torch.float32), gs.data_ptr(),
        out.data_ptr(),
        m, e, n, k, q.block_size, *plan, partials, arrivals,
        None if tile_counts is None else tile_counts.data_ptr(), stream)
    kernels.check(rc, "nf4_gmm")
    nf4_gmm.launches += 1
    if m <= DECODE_ROWS:
        nf4_gmm_decode.launches += 1
    return out


def nf4_gmm_decode(lhs: torch.Tensor, q: NF4Stacked,
                   group_sizes: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   tile_counts: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """The forward at 16 routed rows or fewer, no autograd: what
    :func:`nf4_gmm` runs there (the grouped decode kernel on a CUDA
    tensor, the plain version on a CPU one); more rows raise.
    ``tile_counts`` as :func:`nf4_gmm_fwd`'s."""
    if lhs.shape[0] > DECODE_ROWS:
        raise ValueError(f"nf4_gmm_decode: {lhs.shape[0]} rows, at most "
                         f"{DECODE_ROWS}")
    return nf4_gmm_fwd(lhs, q, group_sizes, bias, tile_counts)


#: launches of the grouped decode kernel (K14 at 16 rows or fewer), also
#: counted in ``nf4_gmm.launches``
nf4_gmm_decode.launches = 0


def nf4_gmm_dx(g: torch.Tensor, q: NF4Stacked, group_sizes: torch.Tensor,
               tile_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dx [m, K] = g [m, N] @ dequant(W_g) per group, the backward of
    :func:`nf4_gmm` with respect to its input; the plain version on a CPU
    tensor, K15 on a CUDA one. ``tile_counts`` (CUDA only: an int32 [3] on
    g's device, or None) receives what the kernel adds to it
    (:func:`nf4_gmm_dx_tile_counts`)."""
    if g.device.type == "cpu":
        return nf4_gmm_ref(g, q, group_sizes, transpose=True)
    _check_cuda("nf4_gmm_dx", g, q, group_sizes, q.shape[1])
    e, n, k = q.shape
    m = g.shape[0]
    if e > MAX_EXPERTS:
        raise NotImplementedError(f"nf4_gmm_dx CUDA kernel takes at most "
                                  f"{MAX_EXPERTS} experts, got {e}")
    # the kernel writes every row (zeros past the groups)
    dx = torch.empty((m, k), dtype=g.dtype, device=g.device)
    if m == 0:
        return dx
    gg = _aligned(g)
    packed = q.packed.contiguous()
    if packed.data_ptr() % _ALIGN:
        raise ValueError(f"nf4_gmm_dx: packed weight is not {_ALIGN}-byte "
                         "aligned")
    # [E K / bs, N]: the kernel reads a stage's absmax as one row a block
    absmax_t = q.absmax.to(torch.float32).reshape(
        e, n, k // q.block_size).transpose(1, 2).contiguous()
    gs = group_sizes.to(torch.int32).contiguous()
    rc = kernels.library().unsloth_nf4_gmm_dx_bf16(
        gg.data_ptr(), packed.data_ptr(), absmax_t.data_ptr(), gs.data_ptr(),
        dx.data_ptr(), m, e, n, k, q.block_size,
        None if tile_counts is None else tile_counts.data_ptr(),
        torch.cuda.current_stream(g.device).cuda_stream)
    kernels.check(rc, "nf4_gmm_dx")
    nf4_gmm_dx.launches += 1
    return dx


#: number of kernel launches since the last reset (CPU calls do not count)
nf4_gmm_dx.launches = 0


class _NF4Gmm(torch.autograd.Function):
    """Grouped y = x @ W_g^T + b_g with the gradient to x only (JAX
    ``_vjp_bwd``: dW and dbias are zero, the base is frozen). The NF4
    weight and the group sizes are kept on ``ctx``; no activation is
    saved."""

    @staticmethod
    def forward(ctx, x, q, group_sizes, bias):
        ctx.q = q
        ctx.save_for_backward(group_sizes)
        return nf4_gmm_fwd(x, q, group_sizes, bias)

    @staticmethod
    def backward(ctx, gy):
        (group_sizes,) = ctx.saved_tensors
        return nf4_gmm_dx(gy, ctx.q, group_sizes), None, None, None


def nf4_gmm(lhs: torch.Tensor, q: NF4Stacked, group_sizes: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped lhs[rows of group g] @ dequant(W_g)^T (+ bias[g]) with W
    NF4Stacked [E, N, K] and rows sorted by expert; differentiable in lhs
    (the backward is :func:`nf4_gmm_dx`).

    CUDA: bf16 lhs, block size 32 or 64 with ``K/2`` a multiple of it and
    of 32, ``N`` a multiple of 8; anything else raises."""
    if lhs.requires_grad and torch.is_grad_enabled():
        return _NF4Gmm.apply(lhs, q, group_sizes, bias)
    return nf4_gmm_fwd(lhs, q, group_sizes, bias)


#: number of kernel launches since the last reset (CPU calls do not count)
nf4_gmm.launches = 0
