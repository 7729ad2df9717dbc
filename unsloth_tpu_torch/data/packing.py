"""Sequence packing and collation (numpy only).

Counterpart of unsloth_tpu/data/packing.py, with the same semantics, so
that both packages pack a dataset into identical rows: first-fit-
decreasing packing into fixed-length rows that carry ``segment_ids`` (one
id per source sequence, 0 = pad) and intra-sequence ``positions``;
attention masks across segments and RoPE uses the per-token positions.

Label semantics: token i predicts token i+1 *within its segment*; the
first token of each packed sequence gets label -100 so the loss never
crosses sequences. The model shifts labels internally.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

IGNORE_INDEX = -100
PAD_SEGMENT = 0  # padding tokens get segment id 0; real segments start at 1


@dataclasses.dataclass
class PackedBatch:
    input_ids: np.ndarray    # [B, T] int32
    labels: np.ndarray       # [B, T] int32, aligned with input positions
                             # (the model shifts internally)
    segment_ids: np.ndarray  # [B, T] int32, 0 = pad
    positions: np.ndarray    # [B, T] int32, position within segment

    def as_dict(self) -> Dict[str, np.ndarray]:
        return {
            "input_ids": self.input_ids,
            "labels": self.labels,
            "segment_ids": self.segment_ids,
            "positions": self.positions,
        }


def pack_sequences(
    sequences: Sequence[Dict[str, Sequence[int]]],
    seq_length: int,
    pad_token_id: int = 0,
    *,
    sort_by_length: bool = True,
) -> List[PackedBatch]:
    """First-fit-decreasing packing of tokenized examples into fixed-length
    rows. Each example: {"input_ids": [...], "labels": [...]} (labels
    optional; defaults to input_ids). Sequences longer than seq_length are
    truncated. Returns one PackedBatch per packed row (batch them later).
    """
    items = []
    for ex in sequences:
        ids = list(ex["input_ids"])[:seq_length]
        labels = list(ex.get("labels", ex["input_ids"]))[:seq_length]
        if ids:
            items.append((ids, labels))
    if sort_by_length:
        items.sort(key=lambda x: -len(x[0]))

    rows: List[List] = []       # each: list of (ids, labels)
    space: List[int] = []
    for ids, labels in items:
        placed = False
        for ri in range(len(rows)):
            if space[ri] >= len(ids):
                rows[ri].append((ids, labels))
                space[ri] -= len(ids)
                placed = True
                break
        if not placed:
            rows.append([(ids, labels)])
            space.append(seq_length - len(ids))

    out = []
    for row in rows:
        input_ids = np.full(seq_length, pad_token_id, np.int32)
        labels = np.full(seq_length, IGNORE_INDEX, np.int32)
        segment_ids = np.zeros(seq_length, np.int32)
        positions = np.zeros(seq_length, np.int32)
        off = 0
        for si, (ids, labs) in enumerate(row, start=1):
            n = len(ids)
            input_ids[off:off + n] = ids
            labels[off:off + n] = labs
            # Boundary masking: the model shifts labels left internally
            # (target of position t is labels[t+1]), so the label at each
            # segment START must be ignored — it would otherwise become the
            # target of the previous segment's last token.
            labels[off] = IGNORE_INDEX
            segment_ids[off:off + n] = si
            positions[off:off + n] = np.arange(n)
            off += n
        out.append(PackedBatch(input_ids[None], labels[None],
                               segment_ids[None], positions[None]))
    return out


def pad_batch(
    examples: Sequence[Dict[str, Sequence[int]]],
    seq_length: int,
    pad_token_id: int = 0,
) -> PackedBatch:
    """Plain padded (non-packed) collation, one example per row."""
    b = len(examples)
    input_ids = np.full((b, seq_length), pad_token_id, np.int32)
    labels = np.full((b, seq_length), IGNORE_INDEX, np.int32)
    segment_ids = np.zeros((b, seq_length), np.int32)
    positions = np.zeros((b, seq_length), np.int32)
    for i, ex in enumerate(examples):
        ids = list(ex["input_ids"])[:seq_length]
        labs = list(ex.get("labels", ex["input_ids"]))[:seq_length]
        n = len(ids)
        input_ids[i, :n] = ids
        labels[i, :n] = labs
        segment_ids[i, :n] = 1
        positions[i, :n] = np.arange(n)
    return PackedBatch(input_ids, labels, segment_ids, positions)


def batch_packed_rows(rows: Sequence[PackedBatch], batch_size: int,
                      seq_length: int, pad_token_id: int = 0,
                      drop_last: bool = False) -> List[PackedBatch]:
    """Group packed rows into [B, T] batches, padding the final batch with
    empty rows so shapes stay static."""
    batches = []
    for i in range(0, len(rows), batch_size):
        chunk = list(rows[i:i + batch_size])
        if len(chunk) < batch_size:
            if drop_last:
                break
            empty = PackedBatch(
                np.full((1, seq_length), pad_token_id, np.int32),
                np.full((1, seq_length), IGNORE_INDEX, np.int32),
                np.zeros((1, seq_length), np.int32),
                np.zeros((1, seq_length), np.int32))
            chunk.extend([empty] * (batch_size - len(chunk)))
        batches.append(PackedBatch(
            np.concatenate([c.input_ids for c in chunk]),
            np.concatenate([c.labels for c in chunk]),
            np.concatenate([c.segment_ids for c in chunk]),
            np.concatenate([c.positions for c in chunk])))
    return batches


def max_segment_length(segment_ids: np.ndarray) -> int:
    """Longest real (id != 0) segment across a [B, T] segment-id array.
    Segments are contiguous runs of equal nonzero ids (pack_sequences
    layout)."""
    seg = np.asarray(segment_ids)
    if seg.ndim == 1:
        seg = seg[None]
    longest = 0
    for row in seg:
        # run-length encode: boundaries where the id changes
        change = np.flatnonzero(np.diff(row)) + 1
        bounds = np.concatenate(([0], change, [row.shape[0]]))
        lens = np.diff(bounds)
        ids = row[bounds[:-1]]
        real = lens[ids != PAD_SEGMENT]
        if real.size:
            longest = max(longest, int(real.max()))
    return longest


def validate_segment_bound(batches, max_segment_len: int) -> None:
    """Fail fast when any packed segment exceeds the declared cap.

    The segment-block-sparse attention kernel (ops/packed_attention.py)
    bounds each query block's kv range by ``max_segment_len``; a longer
    segment would silently lose attention to its oldest tokens.
    Validating at pack/prepare time turns that contract into a
    ValueError."""
    for b in batches:
        seg = b.segment_ids if isinstance(b, PackedBatch) \
            else b["segment_ids"]
        got = max_segment_length(seg)
        if got > max_segment_len:
            raise ValueError(
                f"packed batch contains a {got}-token segment but the "
                f"declared max_segment_len is {max_segment_len}; the "
                "segment-block-sparse attention kernel would silently "
                "truncate its attention span. Raise the bound (or fix "
                "the packer).")


def packing_efficiency(rows: Sequence[PackedBatch]) -> float:
    """Fraction of non-pad tokens across packed rows."""
    total = sum(r.input_ids.size for r in rows)
    used = sum(int((r.segment_ids != 0).sum()) for r in rows)
    return used / max(total, 1)
