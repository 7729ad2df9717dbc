"""A safetensors reader and writer of the package's own.

The format: an 8-byte little-endian header length, a JSON header mapping
each tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(offsets relative to the end of the header; an optional
``"__metadata__"`` of strings), then the raw little-endian bytes.

The reader reads one tensor at a time with a seek and never loads a whole
shard. The writer streams: the header is written first from the tensors'
dtypes and shapes, then each tensor in turn, so a checkpoint larger than
host memory can be written one tensor at a time (``save_sharded``).
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_CODES = {v: k for k, v in DTYPES.items()}

Entry = Tuple[str, torch.dtype, Sequence[int]]


class SafetensorsFile:
    """Random access to the tensors of one .safetensors file."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            if n > size - 8:
                raise ValueError(f"{path}: header length {n} exceeds file")
            header = json.loads(f.read(n))
        self.metadata: Optional[Dict[str, str]] = header.pop("__metadata__",
                                                             None)
        self._data_start = 8 + n
        self._data_size = size - self._data_start
        self.tensors: Dict[str, dict] = header

    def keys(self) -> Iterable[str]:
        return self.tensors.keys()

    def __contains__(self, name: str) -> bool:
        return name in self.tensors

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name`` as a CPU tensor owning its bytes."""
        meta = self.tensors[name]
        dtype = DTYPES.get(meta["dtype"])
        if dtype is None:
            raise NotImplementedError(f"{self.path}: {name} has dtype "
                                      f"{meta['dtype']}")
        shape = [int(s) for s in meta["shape"]]
        lo, hi = meta["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not 0 <= lo <= hi <= self._data_size or \
                hi - lo != math.prod(shape) * itemsize:
            raise ValueError(f"{self.path}: {name} offsets [{lo}, {hi}) do "
                             f"not fit shape {shape} {meta['dtype']}")
        if hi == lo:
            return torch.empty(shape, dtype=dtype)
        buf = bytearray(hi - lo)
        with open(self.path, "rb") as f:
            f.seek(self._data_start + lo)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{self.path}: {name} is truncated")
        return torch.frombuffer(buf, dtype=dtype).reshape(shape)


def _nbytes(dtype: torch.dtype, shape: Sequence[int]) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _header(entries: Sequence[Entry],
            metadata: Optional[Dict[str, str]]) -> bytes:
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    off = 0
    for name, dtype, shape in entries:
        n = _nbytes(dtype, shape)
        header[name] = {"dtype": _CODES[dtype], "shape": [int(s) for s in shape],
                        "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    return struct.pack("<Q", len(raw)) + raw


class SafetensorsWriter:
    """Write one .safetensors file tensor by tensor, in ``entries`` order.

        with SafetensorsWriter(path, [(name, dtype, shape), ...]) as w:
            w.write(name, tensor)      # for each entry, in order
    """

    def __init__(self, path: str, entries: Sequence[Entry],
                 metadata: Optional[Dict[str, str]] = None):
        for _, dtype, _ in entries:
            if dtype not in _CODES:
                raise NotImplementedError(f"safetensors writer: {dtype}")
        self._entries = list(entries)
        self._next = 0
        self._f = open(path, "wb")
        self._f.write(_header(self._entries, metadata))

    def write(self, name: str, tensor: torch.Tensor) -> None:
        if self._next >= len(self._entries):
            raise ValueError(f"unexpected tensor {name!r}: all written")
        want, dtype, shape = self._entries[self._next]
        if (name, tensor.dtype, tuple(tensor.shape)) != \
                (want, dtype, tuple(shape)):
            raise ValueError(
                f"expected {want!r} {dtype} {tuple(shape)}, got {name!r} "
                f"{tensor.dtype} {tuple(tensor.shape)}")
        data = tensor.detach().to("cpu").contiguous().reshape(-1)
        if data.numel():
            self._f.write(memoryview(data.view(torch.uint8).numpy()))
        self._next += 1

    def close(self) -> None:
        self._f.close()
        if self._next != len(self._entries):
            raise ValueError(f"{self._f.name}: {len(self._entries) - self._next}"
                             " tensors were never written")

    def __enter__(self) -> "SafetensorsWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self._f.close()


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    entries = [(n, t.dtype, tuple(t.shape)) for n, t in tensors.items()]
    with SafetensorsWriter(path, entries, metadata) as w:
        for n, t in tensors.items():
            w.write(n, t)


def save_sharded(path: str, entries: Sequence[Entry],
                 produce: Callable[[str], torch.Tensor],
                 max_shard_bytes: int = 5 << 30,
                 metadata: Optional[Dict[str, str]] = None) -> List[str]:
    """Write an HF-style checkpoint directory: shards of at most
    ``max_shard_bytes`` (one tensor may exceed it alone) named
    ``model-0000i-of-0000n.safetensors`` plus ``model.safetensors.index.json``,
    or a single ``model.safetensors``. ``produce(name)`` makes each tensor
    when its turn comes, so only one is held at a time. Returns the file
    names."""
    os.makedirs(path, exist_ok=True)
    shards: List[List[Entry]] = [[]]
    size = 0
    for e in entries:
        n = _nbytes(e[1], e[2])
        if shards[-1] and size + n > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(e)
        size += n
    names = (["model.safetensors"] if len(shards) == 1 else
             [f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
              for i in range(len(shards))])
    weight_map = {}
    for fname, shard in zip(names, shards):
        with SafetensorsWriter(os.path.join(path, fname), shard,
                               metadata) as w:
            for name, _, _ in shard:
                w.write(name, produce(name))
                weight_map[name] = fname
    if len(shards) > 1:
        total = sum(_nbytes(d, s) for _, d, s in entries)
        with open(os.path.join(path, "model.safetensors.index.json"),
                  "w") as f:
            json.dump({"metadata": {"total_size": total},
                       "weight_map": weight_map}, f, indent=2)
    return names
