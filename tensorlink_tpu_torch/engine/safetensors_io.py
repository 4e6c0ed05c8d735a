"""The safetensors file format, read and written without the
``safetensors`` package (which the card's machine does not have).

    header_len u64le | header JSON (space-padded to 8 bytes) | data

The header maps each tensor name to ``{"dtype", "shape",
"data_offsets": [begin, end]}`` (offsets into the data section), plus an
optional ``"__metadata__"`` dict of strings. :func:`save_file` writes the
bytes ``safetensors.numpy.save_file`` writes for the same tensors: the
metadata first, then the tensors ordered by dtype (the library's dtype
order, widest first) and then by name, packed without gaps, and the
compact JSON header padded with spaces to a multiple of 8 bytes. The
library writes metadata keys in its hash map's order, which changes from
run to run; this writer sorts them, so files agree byte for byte when
the metadata has at most one key.

:class:`SafetensorsFile` maps a file (copy-on-write, so the tensors it
hands out are writable without touching the file) and returns CPU tensors
that view the mapping: a caller copies each onto its device in turn and
never holds the whole checkpoint on the host. numpy has no bfloat16, so a
BF16 payload is read as 16-bit integers and viewed as ``torch.bfloat16``.
A dtype outside the table raises.
"""

from __future__ import annotations

import json
import math
import struct
from pathlib import Path

import numpy as np
import torch

# code -> (torch dtype, numpy dtype of the raw payload); the table's order
# is the library's write order (its dtype enum, descending)
# tlint: disable=TL006(read-only constant table)
_CODES = {
    "I64": (torch.int64, np.dtype("<i8")),
    "F64": (torch.float64, np.dtype("<f8")),
    "F32": (torch.float32, np.dtype("<f4")),
    "I32": (torch.int32, np.dtype("<i4")),
    "BF16": (torch.bfloat16, np.dtype("<i2")),
    "F16": (torch.float16, np.dtype("<f2")),
    "I16": (torch.int16, np.dtype("<i2")),
    "I8": (torch.int8, np.dtype("i1")),
    "U8": (torch.uint8, np.dtype("u1")),
    "BOOL": (torch.bool, np.dtype("?")),
}
_RANK = {code: i for i, code in enumerate(_CODES)}


def _code(t: torch.Tensor) -> str:
    """The safetensors dtype code of a torch tensor."""
    for code, (dt, _) in _CODES.items():
        if dt == t.dtype:
            return code
    raise TypeError(f"safetensors has no code for {t.dtype}")


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's little-endian payload as a contiguous host array (one
    tensor at a time: a device tensor is copied to the host here)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _header(tensors: dict, metadata: dict | None = None):
    """``(header, names)``: the padded header JSON and the tensor names in
    the order their payloads follow it."""
    names = sorted(tensors,
                   key=lambda n: (_RANK[_code(tensors[n])], n))
    head: dict = {}
    if metadata is not None:
        if not all(isinstance(v, str) for v in metadata.values()):
            raise TypeError("safetensors metadata values must be strings")
        head["__metadata__"] = {k: metadata[k] for k in sorted(metadata)}
    offset = 0
    for n in names:
        t = tensors[n]
        size = t.numel() * t.element_size()
        head[n] = {"dtype": _code(t), "shape": list(t.shape),
                   "data_offsets": [offset, offset + size]}
        offset += size
    raw = json.dumps(head, separators=(",", ":"),
                     ensure_ascii=False).encode("utf-8")
    return raw + b" " * (-len(raw) % 8), names


def save_file(tensors: dict, path, metadata: dict | None = None) -> None:
    """Write ``tensors`` (name → torch tensor, on any device, contiguous
    or not) as one safetensors file, byte-identical to
    ``safetensors.numpy.save_file`` of the same arrays (with at most one
    metadata key). Payloads stream to the file one tensor at a time."""
    header, names = _header(tensors, metadata)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        for n in names:
            a = _host_bytes(tensors[n])
            if a.nbytes:
                f.write(memoryview(a.reshape(-1).view(np.uint8)))


class SafetensorsFile:
    """One safetensors file, mapped: :meth:`keys`, :meth:`get`,
    :attr:`metadata`. The header is checked on open (offsets inside the
    file, sizes matching shapes and dtypes, known dtypes)."""

    def __init__(self, path):
        self.path = Path(path)
        size = self.path.stat().st_size
        with open(self.path, "rb") as f:
            raw = f.read(8)
            if len(raw) != 8:
                raise ValueError(f"{self.path}: not a safetensors file")
            (n,) = struct.unpack("<Q", raw)
            if 8 + n > size:
                raise ValueError(f"{self.path}: header runs past the file")
            header = json.loads(f.read(n))
        self.metadata: dict | None = header.pop("__metadata__", None)
        self._start = 8 + n
        for name, e in header.items():
            if e["dtype"] not in _CODES:
                raise TypeError(f"{self.path}: tensor {name!r} has dtype "
                                f"{e['dtype']!r}, which is not supported")
            lo, hi = e["data_offsets"]
            want = math.prod(e["shape"]) * _CODES[e["dtype"]][1].itemsize
            if hi - lo != want or lo < 0 or self._start + hi > size:
                raise ValueError(f"{self.path}: tensor {name!r} has offsets "
                                 f"{[lo, hi]} for {want} bytes")
        self._entries = header
        self._map = None

    def keys(self) -> list[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name`` as a CPU tensor viewing the mapped file."""
        e = self._entries[name]
        tdt, ndt = _CODES[e["dtype"]]
        lo, hi = e["data_offsets"]
        if hi == lo:
            return torch.empty(e["shape"], dtype=tdt)
        if self._map is None:
            self._map = np.memmap(self.path, dtype=np.uint8, mode="c")
        raw = self._map[self._start + lo:self._start + hi]
        if raw.ctypes.data % ndt.itemsize:  # a writer that did not align
            raw = raw.copy()
        t = torch.from_numpy(raw.view(ndt).reshape(e["shape"]))
        return t.view(torch.bfloat16) if tdt == torch.bfloat16 else t


__all__ = ["SafetensorsFile", "save_file"]
