"""Fused NF4 dequant-inside-matmul (the QLoRA projection), forward and
backward.

Counterpart of unsloth_tpu/ops/qlora_matmul.py:nf4_matmul. On a CUDA
tensor the forward launches a hand-written kernel (TPU ``_fwd_kernel``):
above 16 rows ``csrc/nf4_wgmma.cu``'s persistent Hopper kernel, which
decodes the packed bytes straight into the tensor cores' A operand (the
product is computed transposed, y^T = W x^T), at 16 rows or fewer
``csrc/decode_matmul.cu``'s split-K decode kernel, which reads the absmax
as stored (int8 codes, group scales and offset, or fp32) and decodes it
itself; either way the packed uint8 weight streams from device memory
and the dense weight never exists there. :func:`nf4_matmul_tiles_ref` is
the plain twin of the Hopper kernel's walk (tiles, stages, bytes, scales,
x columns, masks), :func:`nf4_decode_tiles_ref` and
:func:`decode_schedule` those of the decode kernel's. The
backward, dx = g @ W (TPU ``_bwd_kernel``), is ``csrc/nf4_wgmma.cu``'s
second Hopper kernel at every row count, computed transposed (dx^T = W^T
g^T: the bytes decoded into the A operand, g the B operand);
:func:`nf4_matmul_dx_tiles_ref` and :func:`nf4_dx_tile_schedule` are its
walk's twins. W is frozen, so the gradient goes to x only. On a CPU
tensor both run their plain versions, :func:`nf4_matmul_ref` and
:func:`nf4_matmul_dx_ref`. The device of the tensor is the only thing
that chooses; there is no fallback from a kernel to its plain version.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from .. import kernels
from .nf4 import (NF4_CODE, NF4Tensor, _decode_absmax, dequantize_nf4,
                  nf4_matmul_ref)

_ALIGN = 16  # bytes: the kernel reads x and the packed bytes 16 at a time


def nf4_matmul(x: torch.Tensor, q: NF4Tensor) -> torch.Tensor:
    """y = x @ dequant(W)^T; x [..., in], W [out, in] NF4; y in x.dtype.
    Differentiable in x (the backward is :func:`nf4_matmul_dx`).

    CUDA: bf16 x only, ``in/2`` a multiple of 32 and ``block_size`` 64
    (each 16-column chunk looks up its own absmax, so a block may straddle
    the split-half boundary, as at gpt-oss's in = 2,880); anything else
    raises."""
    if isinstance(x, torch.Tensor) and x.requires_grad \
            and torch.is_grad_enabled():
        return _NF4Matmul.apply(x, q)
    return _nf4_matmul_fwd(x, q)


def _check_cuda(name: str, t: torch.Tensor, q: NF4Tensor, inner: int,
                inner_name: str) -> None:
    if t.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device {t.device}")
    out_f, in_f = q.shape
    if t.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{name} CUDA kernel takes bfloat16, got {t.dtype}")
    if t.shape[-1] != inner:
        raise ValueError(f"{name}: input has {t.shape[-1]} features, "
                         f"W expects {inner} ({inner_name})")
    if q.block_size != 64 or (in_f // 2) % 32:
        raise NotImplementedError(
            f"{name} CUDA kernel needs block_size 64 and in/2 % 32 == 0,"
            f" got block_size {q.block_size}, in {in_f}")
    if q.packed.device != t.device:
        raise ValueError(f"{name}: input on {t.device}, W on "
                         f"{q.packed.device}")


def _nf4_matmul_fwd(x: torch.Tensor, q: NF4Tensor,
                    tile_counts: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The forward; ``tile_counts`` (CUDA only: an int32 [2] on x's
    device, or None) receives what the kernel adds to it: above 16 rows
    the Hopper kernel's output tiles stored and stages consumed, at 16 or
    fewer the decode kernel's units stored and 16-byte chunks of W read
    (:func:`decode_schedule`'s ``counts``)."""
    if x.device.type == "cpu":
        return nf4_matmul_ref(x, q)
    _check_cuda("nf4_matmul", x, q, q.shape[1], "in")
    out_f, in_f = q.shape
    lead = x.shape[:-1]
    x2d = x.reshape(-1, in_f).contiguous()
    m = x2d.shape[0]
    y = torch.empty((m, out_f), dtype=x.dtype, device=x.device)
    if m == 0:
        return y.reshape(*lead, out_f)
    if x2d.data_ptr() % _ALIGN:   # a view at an odd offset: fresh copy
        x2d = x2d.clone()
    packed = q.packed.contiguous()
    if packed.data_ptr() % _ALIGN:
        raise ValueError(f"nf4_matmul: packed weight is not {_ALIGN}-byte "
                         "aligned")
    if m <= DECODE_ROWS:
        _nf4_decode_launch(x2d, packed, q, y, tile_counts)
    else:
        absmax = _decode_absmax(q).contiguous()
        rc = kernels.library().unsloth_nf4_matmul_bf16(
            x2d.data_ptr(), packed.data_ptr(), absmax.data_ptr(),
            y.data_ptr(), m, out_f, in_f,
            None if tile_counts is None else tile_counts.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
        kernels.check(rc, "nf4_matmul")
    nf4_matmul.launches += 1
    return y.reshape(*lead, out_f)


#: number of kernel launches since the last reset (CPU calls do not count)
nf4_matmul.launches = 0


def _nf4_decode_launch(x2d: torch.Tensor, packed: torch.Tensor, q: NF4Tensor,
                       y: torch.Tensor, tile_counts: Optional[torch.Tensor]
                       ) -> None:
    """K1 at 16 rows or fewer: ``csrc/decode_matmul.cu``'s NF4 form under
    :func:`decode_schedule`, the absmax passed as stored (no decode pass:
    one launch a call). Counted under ``nf4_matmul_decode.launches``."""
    m, (out_f, in_f) = x2d.shape[0], q.shape
    plan = decode_schedule(m, out_f, in_f, "nf4")
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    partials, arrivals = _decode_scratch(plan, x2d.device, stream)
    if q.is_double_quant:
        absmax = (None, q.absmax.contiguous().data_ptr(),
                  q.absmax_scale.contiguous().data_ptr(),
                  q.absmax_offset.data_ptr())
    else:
        absmax = (q.absmax.float().contiguous().data_ptr(), None, None, None)
    rc = kernels.library().unsloth_decode_matmul_nf4(
        x2d.data_ptr(), packed.data_ptr(), *absmax, q.double_block_size,
        y.data_ptr(), partials, arrivals, m, out_f, in_f, plan.row_warps,
        plan.slices, plan.slice_steps,
        None if tile_counts is None else tile_counts.data_ptr(), stream)
    kernels.check(rc, "nf4_matmul (decode rows)")
    nf4_matmul_decode.launches += 1


def nf4_matmul_decode(x: torch.Tensor, q: NF4Tensor,
                      tile_counts: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The forward at 16 rows of x or fewer, no autograd: what
    :func:`nf4_matmul` runs there (the decode kernel on a CUDA tensor, the
    plain version on a CPU one); more rows raise. ``tile_counts`` as
    :func:`_nf4_matmul_fwd`'s."""
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    if rows > DECODE_ROWS:
        raise ValueError(f"nf4_matmul_decode: {rows} rows of x, at most "
                         f"{DECODE_ROWS}")
    return _nf4_matmul_fwd(x, q, tile_counts)


#: launches of the decode kernel (K1 at 16 rows or fewer), also counted in
#: ``nf4_matmul.launches``
nf4_matmul_decode.launches = 0

#: the Hopper kernel's tiles (csrc/nf4_wgmma.cu): W rows a tile, packed
#: bytes of a W row a stage, and the SMs of an H100 (its persistent grid,
#: in clusters of two)
TILE_W = 128
STAGE_BYTES = 32
H100_SMS = 132

#: rows of x at or below which the forward runs the decode kernel
#: (``csrc/decode_matmul.cu``); above, the Hopper kernel
DECODE_ROWS = 16
#: the decode kernel's block (csrc/decode_matmul.cu): warps, bytes of a W
#: row a step, and the dynamic shared memory a block may take (two blocks
#: an SM)
DECODE_WARPS = 8
DECODE_STEP = 64
DECODE_MAX_SMEM = 100 * 1024


class DecodeSchedule(NamedTuple):
    """The decode kernel's schedule at y [m, n] over W rows of ``row_bytes``
    (K/2 for NF4, K for e4m3, 2K for bf16): units (row group, K slice),
    one 256-thread block each, for each of ``slots`` experts (1 for the
    plain form; min(m, E) for the grouped one, slot s taking the s-th
    expert that owns rows); a group is 16 * ``row_warps`` W rows, a slice
    ``slice_steps`` 64-byte steps of each row (the last slice fewer)."""
    row_warps: int
    slices: int
    slice_steps: int
    steps: int
    groups: int
    row_bytes: int
    n_tiles: int          # n-tiles of 8 x rows: 1 at m <= 8, else 2
    slots: int = 1

    @property
    def rows(self) -> int:
        return 16 * self.row_warps

    @property
    def units(self) -> List[Tuple[int, int, int]]:
        """(first W row, first step, end step) of each unit of one slot,
        in block order: unit u is group u // slices, slice u % slices."""
        return [(gi * self.rows, si * self.slice_steps,
                 min((si + 1) * self.slice_steps, self.steps))
                for gi in range(self.groups) for si in range(self.slices)]

    def counts(self, n: int) -> List[int]:
        """What the kernel's counters must read after one call: [units
        stored, 16-byte chunks of W read]; every W row below ``n`` reads
        each of its chunks once, whichever unit holds it."""
        return [self.groups * self.slices,
                n * -(-self.row_bytes // 16)]

    def grouped_counts(self, n: int, live: int) -> List[int]:
        """What the grouped kernel's counters must read after one call in
        which ``live`` experts own rows: [units stored, 16-byte chunks of W
        read, slots that found no expert]; each live expert's W rows read
        each of their chunks once."""
        return [live * self.groups * self.slices,
                live * n * -(-self.row_bytes // 16), self.slots - live]

    @property
    def scratch(self) -> Tuple[int, int]:
        """(fp32 partials, arrival counters) of a launch at S > 1: a tile
        of 16 WR x 8 NT floats a unit, a counter a (slot, row group)."""
        units = self.slots * self.groups * self.slices
        return (units * self.rows * 8 * self.n_tiles,
                self.slots * self.groups)


#: x columns one 64-byte step of a W row covers, both NF4 sides, by weight
#: policy
_STEP_COLS = {"nf4": 2 * DECODE_STEP, "fp8": DECODE_STEP,
              "bf16": DECODE_STEP // 2}


def _x_ld(policy: str, slice_steps: int) -> int:
    """The x slice's row stride in elements (the kernels' ``x_ld``): rows
    16 bytes apart modulo 128, or 64 for bf16, whose lanes read 16 bytes
    apart (no bank conflicts)."""
    cols = _STEP_COLS[policy] * slice_steps
    if policy == "bf16":
        return cols + (32 if cols % 64 == 0 else 0)
    return cols + 8


def _smem_bytes(policy: str, n_tiles: int, slice_steps: int,
                row_warps: int) -> int:
    xs = 8 * n_tiles * _x_ld(policy, slice_steps) * 2
    red = (DECODE_WARPS - row_warps) * 32 * n_tiles * 16
    return max(xs, red)


def decode_smem_bytes(fp8: bool, n_tiles: int, slice_steps: int,
                      row_warps: int) -> int:
    """The decode kernel's dynamic shared memory a block (its
    ``smem_bytes``): the x slice, or the warps' partials if larger."""
    return _smem_bytes("fp8" if fp8 else "nf4", n_tiles, slice_steps,
                       row_warps)


@functools.lru_cache(maxsize=None)
def _decode_plan(n: int, row_bytes: int, policy: str, n_tiles: int,
                 sms: int, slots: int = 1) -> DecodeSchedule:
    steps = -(-row_bytes // DECODE_STEP)
    target = 2 * sms                 # one wave of two blocks an SM
    for row_warps in (8, 4, 2):      # the tallest row group that fills
        groups = -(-n // (16 * row_warps))
        slices = min(steps, max(1, target // (slots * groups)))
        if slots * groups * slices >= sms:
            break
    slice_steps = -(-steps // slices)
    while slice_steps > 1 and _smem_bytes(
            policy, n_tiles, slice_steps, row_warps) > DECODE_MAX_SMEM:
        slice_steps -= 1
    return DecodeSchedule(row_warps, -(-steps // slice_steps), slice_steps,
                          steps, groups, row_bytes, n_tiles, slots)


def decode_schedule(m: int, n: int, k: int, policy: str = "nf4",
                    sms: int = H100_SMS) -> DecodeSchedule:
    """The decode kernel's schedule at y [m, n] = x [m, k] @ W^T (``policy``
    "nf4": W packed [n, k/2]; "fp8": W e4m3 [n, k]). The rows of a group
    are the most (128, 64, then 32) that still give ``sms`` units, with as
    many slices as make at most two blocks an SM (at most one a step);
    the slices then take equal steps, fewer where the x slice would not
    fit the shared memory. The wrapper passes it to the kernel; the
    kernel's counters must equal ``counts(n)``."""
    if policy not in ("nf4", "fp8"):
        raise ValueError(f"policy {policy!r} is not 'nf4' or 'fp8'")
    fp8 = policy == "fp8"
    return _decode_plan(n, k if fp8 else k // 2, policy, 1 if m <= 8 else 2,
                        sms)


def grouped_decode_schedule(m: int, e: int, n: int, k: int,
                            policy: str = "nf4", sms: int = H100_SMS
                            ) -> DecodeSchedule:
    """The grouped decode kernel's schedule at y [m, n] = x [m, k] @ W_g^T
    over E = ``e`` experts (``policy`` "nf4": NF4Stacked, packed [e, n,
    k/2]; "bf16": W [e, n, k]), from the shapes alone: min(m, e) slots (at
    most that many experts own rows). Where the slots' row groups give
    ``sms`` units without splitting K, one slice (a split adds partials and
    their sum and stages x again: slower at every gpt-oss decode shape),
    and the rows of a group (128, 64 or 32) whose waves of two blocks an SM
    stream the fewest rows each; on a tie the one that fits one wave, else
    the shorter (a shorter last wave); else the slices as
    :func:`decode_schedule` picks them with every
    slot's units counted. Fewer steps a slice where the x slice would not
    fit the shared memory. The wrappers pass it to the kernel; its
    counters must equal ``grouped_counts(n, live)`` for ``live`` experts
    with rows."""
    if policy not in ("nf4", "bf16"):
        raise ValueError(f"policy {policy!r} is not 'nf4' or 'bf16'")
    row_bytes = k // 2 if policy == "nf4" else 2 * k
    return _grouped_plan(n, row_bytes, policy, 1 if m <= 8 else 2, sms,
                         max(1, min(m, e)))


@functools.lru_cache(maxsize=None)
def _grouped_plan(n: int, row_bytes: int, policy: str, n_tiles: int,
                  sms: int, slots: int) -> DecodeSchedule:
    fits = []
    for rw in (8, 4, 2):
        units = slots * -(-n // (16 * rw))
        waves = -(-units // (2 * sms))
        if units >= sms:             # rows a block streams in all waves;
            # on a tie one wave (no tail), else the shorter last wave
            fits.append((waves * rw, -rw if waves == 1 else rw, rw))
    if not fits:                     # too few row groups: split K
        return _decode_plan(n, row_bytes, policy, n_tiles, sms, slots)
    row_warps = min(fits)[2]
    steps = -(-row_bytes // DECODE_STEP)
    slice_steps = steps
    while slice_steps > 1 and _smem_bytes(
            policy, n_tiles, slice_steps, row_warps) > DECODE_MAX_SMEM:
        slice_steps -= 1
    return DecodeSchedule(row_warps, -(-steps // slice_steps), slice_steps,
                          steps, -(-n // (16 * row_warps)), row_bytes,
                          n_tiles, slots)


def _decode_scratch(plan: DecodeSchedule, device: torch.device,
                    stream: int):
    """(partials, arrivals) pointers for a decode launch on ``stream``:
    None and None at one slice, else :func:`kernels.device_scratch`."""
    if plan.slices == 1:
        return None, None
    return kernels.device_scratch(*plan.scratch, device, stream)


def decode_absmax_ref(q: NF4Tensor) -> torch.Tensor:
    """The absmax as the decode kernel decodes it from what is stored:
    fp32 as it is, or each int8 code times its group's fp32 scale, then
    plus the offset (two fp32 roundings, no fused multiply-add)."""
    if not q.is_double_quant:
        return q.absmax.to(torch.float32)
    idx = torch.arange(q.absmax.shape[0], device=q.absmax.device)
    scale = q.absmax_scale[idx // q.double_block_size]
    return q.absmax.to(torch.float32) * scale + q.absmax_offset


def _slice_sums(x32: torch.Tensor, w32: torch.Tensor, plan: DecodeSchedule,
                cols_of, drop_slice: Optional[int], dtype: torch.dtype):
    """y from the decode walk's per-unit fp32 partials (``cols_of(step)``:
    the x and W columns a step reads) summed in slice order, one rounding;
    visits [groups, slices]: the times the walk runs each unit."""
    m, n = x32.shape[0], w32.shape[0]
    y = torch.empty((m, n), dtype=torch.float32)
    visits = torch.zeros((plan.groups, plan.slices), dtype=torch.int64)
    for gi in range(plan.groups):
        rows = slice(gi * plan.rows, min((gi + 1) * plan.rows, n))
        total = None
        for si in range(plan.slices):
            visits[gi, si] += 1
            st0 = si * plan.slice_steps
            st1 = min(st0 + plan.slice_steps, plan.steps)
            cols = torch.cat([cols_of(st) for st in range(st0, st1)])
            part = x32[:, cols] @ w32[rows][:, cols].t()
            if si == drop_slice:
                continue
            total = part if total is None else total + part
        y[:, rows] = total
    return y.to(dtype), visits


def nf4_decode_tiles_ref(x: torch.Tensor, q: NF4Tensor, *,
                         low_reads_high: bool = False,
                         drop_slice: Optional[int] = None,
                         sms: int = H100_SMS):
    """y = x @ dequant(W)^T rebuilt from the decode kernel's walk, in plain
    PyTorch: (y in x.dtype, visits [row groups, K slices]: the times the
    schedule runs each unit).

    As the kernel (:func:`decode_schedule`): unit (group, slice) reads
    bytes [64 st, 64 st + 64) of its W rows for its steps st, zero past
    K/2; their high nibbles are columns 64 st.. of W, their low nibbles
    K/2 + 64 st..; each 16-byte chunk of a side looks up the absmax block
    of its first element, decoded from what is stored
    (:func:`decode_absmax_ref`: the code times its group's scale, then
    plus the offset); each weight is code * absmax in fp32, rounded to
    x.dtype; a unit's products are summed in fp32 (in another order than
    the tensor cores'), the units of a group in slice order, each output
    rounded once. Faults: ``low_reads_high`` gives each low-side chunk the
    absmax of its high-side chunk; ``drop_slice`` leaves that slice out of
    every group's sum."""
    m, k = x.shape
    n = q.shape[0]
    half = k // 2
    plan = decode_schedule(m, n, k, "nf4", sms)
    am = decode_absmax_ref(q).float().reshape(n, k // 64)
    j = torch.arange(half)
    first = j - j % 16                  # each chunk's first byte
    blk_hi = first // 64
    blk_lo = blk_hi if low_reads_high else (half + first) // 64
    code = NF4_CODE.float()
    pk = q.packed.to(torch.int64)
    w_hi = (code[pk >> 4] * am[:, blk_hi]).to(x.dtype).float()
    w_lo = (code[pk & 15] * am[:, blk_lo]).to(x.dtype).float()
    w32 = torch.cat([w_hi, w_lo], dim=1)            # [n, k]: j, then K/2 + j

    def cols_of(st):
        c = torch.arange(DECODE_STEP * st, min(DECODE_STEP * (st + 1), half))
        return torch.cat([c, half + c])

    return _slice_sums(x.float(), w32, plan, cols_of, drop_slice, x.dtype)


def tile_rows_x(m: int) -> int:
    """Rows of x in one of the Hopper kernel's tiles at ``m`` rows."""
    return 128 if m <= 128 else 256


def nf4_tile_schedule(m: int, n: int, sms: int = H100_SMS
                      ) -> List[List[Tuple[int, int]]]:
    """The Hopper kernel's persistent schedule at y [m, n]: for each block
    of its grid, the (first row of x, first W row) of the tiles it stores,
    in order. The grid is clusters of two blocks, as many as ``sms`` holds
    (at most one a unit). Unit u is the x tile u // P against the W tiles
    2 p and 2 p + 1, p = u % P (P pairs of W tiles); cluster c takes units
    c, c + clusters, ..., its block of rank r the W tile 2 p + r (where
    the W tiles are odd in number, the last unit's second tile lies past
    N: that block computes it and stores nothing)."""
    return _pair_schedule(m, -(-n // TILE_W), TILE_W, sms)


def _pair_schedule(m: int, tiles: int, width: int, sms: int
                   ) -> List[List[Tuple[int, int]]]:
    """The Hopper NF4 kernels' schedule over ``tiles`` column tiles of
    ``width`` against tiles of m rows (:func:`tile_rows_x`), tile pairs
    fastest (see :func:`nf4_tile_schedule`)."""
    bx = tile_rows_x(m)
    pairs = -(-tiles // 2)
    units = -(-m // bx) * pairs
    clusters = min(units, max(1, sms // 2))
    return [[((u // pairs) * bx, (2 * (u % pairs) + r) * width)
             for u in range(c, units, clusters)
             if 2 * (u % pairs) + r < tiles]
            for c in range(clusters) for r in (0, 1)]


def nf4_matmul_tiles_ref(x: torch.Tensor, q: NF4Tensor, *,
                         stage_bytes: int = STAGE_BYTES, mask: bool = True,
                         sms: int = H100_SMS):
    """y = x @ dequant(W)^T rebuilt from the Hopper kernel's walk, in plain
    PyTorch: (y in x.dtype, visits [tiles of x rows, tiles of W rows], the
    times the schedule stores each output tile).

    As the kernel: x and the packed bytes come in tiles padded with zeros
    past M and past N (TMA's fill); the rows past N take absmax 0. Stage st
    reads bytes [32 st, 32 st + 32) of each W row (``stage_bytes`` 32),
    their high nibbles against x columns [32 st, ..) and their low nibbles
    against x columns [K/2 + 32 st, ..); each 16-byte chunk of a side
    looks up the absmax block of its first element; each weight is
    code * absmax in fp32, rounded to x.dtype; the sums are fp32 (in
    another order than the tensor cores'), each output rounded once.
    ``stage_bytes`` 64 is a walk whose last stage crosses K/2 where K/2 %
    64 == 32: its bytes past K/2 arrive as zeros, which decode to
    -absmax, its high side reads x's real low-side columns, and its low
    side's absmax blocks run into the next row; ``mask`` zeroes those
    weights, as a kernel with such stages has to (the kernel's 32-byte
    stage never crosses K/2)."""
    m, k = x.shape
    n = q.shape[0]
    half = k // 2
    bx = tile_rows_x(m)
    schedule = nf4_tile_schedule(m, n, sms)
    mp, np_ = -(-m // bx) * bx, -(-n // TILE_W) * TILE_W
    nst = -(-half // stage_bytes)
    xp = torch.zeros((mp, nst * stage_bytes + half), dtype=torch.float32)
    xp[:m, :k] = x.float()
    pk = torch.zeros((np_, nst * stage_bytes), dtype=torch.int64)
    pk[:n, :half] = q.packed.to(torch.int64)
    blocks = k // 64
    am = torch.zeros(np_ * blocks + 2 * blocks)  # past the last row: zeros
    am[:n * blocks] = _decode_absmax(q).float()
    am = am.reshape(-1, blocks)
    am[n:] = 0.0
    code = NF4_CODE.float()
    rows = torch.arange(np_)
    acc = torch.zeros((mp, np_), dtype=torch.float32)
    for st in range(nst):
        j = st * stage_bytes
        cols = j + torch.arange(stage_bytes)
        b = pk[:, cols]
        for base, nib in ((0, b >> 4), (half, b & 15)):
            elem = base + j + 16 * (torch.arange(stage_bytes) // 16)
            blk = elem // 64    # each 16-byte chunk: its first element's
            scale = am.reshape(-1)[(rows[:, None] * blocks + blk[None, :])]
            w = (code[nib] * scale).to(x.dtype).float()
            if mask:
                w[:, cols >= half] = 0.0
            acc += xp[:, base + cols] @ w.t()
    y = torch.empty((m, n), dtype=x.dtype)
    visits = torch.zeros((mp // bx, np_ // TILE_W), dtype=torch.int64)
    for tiles in schedule:
        for m0, n0 in tiles:
            visits[m0 // bx, n0 // TILE_W] += 1
            y[m0:m0 + bx, n0:n0 + TILE_W] = \
                acc[m0:min(m0 + bx, m), n0:min(n0 + TILE_W, n)].to(x.dtype)
    return y, visits


#: the backward kernel's tiles (csrc/nf4_wgmma.cu, nf4_dx_wgmma_kernel):
#: packed byte columns a tile (64 output columns on each nibble side) and
#: W rows a stage
DX_TILE_BYTES = 64
DX_STAGE_ROWS = 64


def nf4_dx_tile_schedule(m: int, k: int, sms: int = H100_SMS
                         ) -> List[List[Tuple[int, int]]]:
    """The backward kernel's persistent schedule at dx [m, k]: for each
    block of its grid, the (first row of g, first packed byte column j0) of
    the tiles it stores, in order; a tile is dx[rows, j0..j0 + 63] (the
    high-nibble side) and dx[rows, k/2 + j0..] (the low side). As the
    forward's schedule with byte tiles for W tiles: clusters of two, as
    many as ``sms`` holds (at most one a unit); unit u is the g tile u // P
    against the byte tiles 2 p and 2 p + 1, p = u % P; cluster c takes
    units c, c + clusters, ..., its block of rank r the byte tile 2 p + r
    (past K/2, where the byte tiles are odd in number: computed, not
    stored)."""
    return _pair_schedule(m, -(-(k // 2) // DX_TILE_BYTES), DX_TILE_BYTES,
                          sms)


def nf4_matmul_dx_tiles_ref(g: torch.Tensor, q: NF4Tensor, *,
                            clip: bool = True, split_low: bool = True,
                            sms: int = H100_SMS):
    """dx = g @ dequant(W) rebuilt from the backward kernel's walk, in plain
    PyTorch: (dx in g.dtype, visits [tiles of g rows, byte tiles], the
    times the schedule stores each output tile).

    As the kernel: g comes in tiles padded with zeros past M; a tile is 64
    packed byte columns j0.. (zeros past K/2, TMA's fill) read for stages
    of 64 W rows; its high nibbles are dx columns j0.., its low nibbles
    K/2 + j0..; each weight is code * absmax in fp32, rounded to g.dtype;
    the sums are fp32 (in another order than the tensor cores'), each
    output rounded once. The absmax of a stage's rows: the high side's
    block j0 / 64; the low side's (K/2 + j0) / 64 for the tile's columns
    0-31 and (K/2 + j0 + 32) / 64 for 32-63 (``split_low``; where K/2 %
    64 == 32 the low tile straddles two blocks); columns past K/2 take
    absmax 0 and the high side's store ends at K/2 (``clip``). A walk
    without the clip decodes the zero bytes past K/2 to -absmax and stores
    the high side's columns past K/2 over dx's real low-side columns K/2..
    (after the low side's, as a high-side map as wide as dx would); one
    without ``split_low`` reads the low tile's columns 32-63 with the
    absmax of the block before theirs."""
    m, n = g.shape
    k = q.shape[1]
    half = k // 2
    if n % DX_STAGE_ROWS:
        raise ValueError(f"out = {n} is not a multiple of {DX_STAGE_ROWS}")
    bx = tile_rows_x(m)
    schedule = nf4_dx_tile_schedule(m, k, sms)
    tiles_j = -(-half // DX_TILE_BYTES)
    mp, jp = -(-m // bx) * bx, tiles_j * DX_TILE_BYTES
    gp = torch.zeros((mp, n), dtype=torch.float32)
    gp[:m] = g.float()
    pk = torch.zeros((n, jp), dtype=torch.int64)
    pk[:, :half] = q.packed.to(torch.int64)
    blocks = k // 64
    am = _decode_absmax(q).float().reshape(n, blocks)
    j = torch.arange(jp)
    j0 = j - j % DX_TILE_BYTES
    blk_hi = j0 // 64
    lo_col = j0 + (32 * ((j % DX_TILE_BYTES) >= 32) if split_low else 0)
    blk_lo = ((half + lo_col) // 64).clamp(max=blocks - 1)
    dead = (j0 + 16 * ((j % DX_TILE_BYTES) // 16)) >= half
    s_hi, s_lo = am[:, blk_hi], am[:, blk_lo]
    if clip:
        s_hi[:, dead] = 0.0
        s_lo[:, dead] = 0.0
    code = NF4_CODE.float()
    w_hi = (code[pk >> 4] * s_hi).to(g.dtype).float()
    w_lo = (code[pk & 15] * s_lo).to(g.dtype).float()
    acc_hi = torch.zeros((mp, jp), dtype=torch.float32)
    acc_lo = torch.zeros((mp, jp), dtype=torch.float32)
    for st in range(n // DX_STAGE_ROWS):
        rows = slice(st * DX_STAGE_ROWS, (st + 1) * DX_STAGE_ROWS)
        acc_hi += gp[:, rows] @ w_hi[rows]
        acc_lo += gp[:, rows] @ w_lo[rows]
    dx = torch.empty((m, k), dtype=g.dtype)
    visits = torch.zeros((mp // bx, tiles_j), dtype=torch.int64)
    stores = [t for tiles in schedule for t in tiles]
    for m0, c0 in stores:
        visits[m0 // bx, c0 // DX_TILE_BYTES] += 1
        r1 = min(m0 + bx, m)
        c1 = min(c0 + DX_TILE_BYTES, half)
        dx[m0:r1, half + c0:half + c1] = acc_lo[m0:r1, c0:c1].to(g.dtype)
    for m0, c0 in stores:
        r1 = min(m0 + bx, m)
        c1 = min(c0 + DX_TILE_BYTES, half if clip else k)
        dx[m0:r1, c0:c1] = acc_hi[m0:r1, c0:c1].to(g.dtype)
    return dx, visits


def nf4_matmul_dx_ref(g: torch.Tensor, q: NF4Tensor) -> torch.Tensor:
    """Plain dx = g @ dequant(W): W dequantized to g.dtype, one matmul whose
    output is in g.dtype (the TPU kernel's rounding points)."""
    return torch.matmul(g, dequantize_nf4(q, dtype=g.dtype))


def nf4_matmul_dx(g: torch.Tensor, q: NF4Tensor,
                  tile_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dx = g @ dequant(W); g [..., out], W [out, in] NF4; dx [..., in] in
    g.dtype. The backward of :func:`nf4_matmul` with respect to x.

    CUDA: bf16 g only, ``out`` a multiple of 64 (the kernel's stage of W
    rows), ``in/2`` a multiple of 32 and ``block_size`` 64.
    ``tile_counts`` (CUDA only: an int32 [2] on g's device, or None)
    receives what the kernel adds to it, the output tiles it stored (a
    byte tile's two 64-column sides) and the stages it consumed."""
    if g.device.type == "cpu":
        return nf4_matmul_dx_ref(g, q)
    _check_cuda("nf4_matmul_dx", g, q, q.shape[0], "out")
    out_f, in_f = q.shape
    if out_f % DX_STAGE_ROWS:
        raise NotImplementedError(
            f"nf4_matmul_dx CUDA kernel needs out % {DX_STAGE_ROWS} == 0, "
            f"got {out_f}")
    lead = g.shape[:-1]
    g2d = g.reshape(-1, out_f).contiguous()
    m = g2d.shape[0]
    dx = torch.empty((m, in_f), dtype=g.dtype, device=g.device)
    if m == 0:
        return dx.reshape(*lead, in_f)
    if g2d.data_ptr() % _ALIGN:
        g2d = g2d.clone()
    packed = q.packed.contiguous()
    if packed.data_ptr() % _ALIGN:
        raise ValueError(f"nf4_matmul_dx: packed weight is not {_ALIGN}-byte "
                         "aligned")
    # [in/64, out]: the kernel reads a stage's absmax as one row a block
    absmax_t = _decode_absmax(q).reshape(out_f, in_f // 64).t().contiguous()
    rc = kernels.library().unsloth_nf4_matmul_dx_bf16(
        g2d.data_ptr(), packed.data_ptr(), absmax_t.data_ptr(), dx.data_ptr(),
        m, out_f, in_f,
        None if tile_counts is None else tile_counts.data_ptr(),
        torch.cuda.current_stream(g.device).cuda_stream)
    kernels.check(rc, "nf4_matmul_dx")
    nf4_matmul_dx.launches += 1
    return dx.reshape(*lead, in_f)


#: number of kernel launches since the last reset (CPU calls do not count)
nf4_matmul_dx.launches = 0


class _NF4Matmul(torch.autograd.Function):
    """y = x @ W^T with the gradient to x only (JAX ``_nf4_vjp_bwd``). The
    NF4 weight is frozen and kept on ``ctx``; no activation is saved."""

    @staticmethod
    def forward(ctx, x, q):
        ctx.q = q
        return _nf4_matmul_fwd(x, q)

    @staticmethod
    def backward(ctx, g):
        return nf4_matmul_dx(g, ctx.q), None
