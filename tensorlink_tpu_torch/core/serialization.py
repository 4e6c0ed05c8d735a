"""Pickle-free structured array serialization (port of
``tensorlink_tpu/core/serialization.py``: the TLTS frame and its content
digest).

    MAGIC "TLTS" | version u8 | header_len u32le | header JSON | payload

The header carries the container tree with ``{"__arr__": i}`` placeholders
and an array table (dtype, shape, offset, nbytes); the payload is the raw
little-endian array bytes, 64-byte aligned. The frame is byte-for-byte the
JAX package's, so a migration blob and its :func:`content_digest` agree
across the two packages.

numpy has no bfloat16 and this module imports neither torch nor
``ml_dtypes``: a bfloat16 array travels as :data:`BFLOAT16`, a one-field
structured dtype over the 16-bit payload, whose header name is written as
``"bfloat16"`` exactly as the JAX encoder writes it. An ``ml_dtypes``
bfloat16 array (a JAX package's numpy output) encodes to the same bytes.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any

import numpy as np

# the host representation of bfloat16: the 16-bit payload under a marker
BFLOAT16 = np.dtype([("bfloat16", "<u2")])

MAGIC = b"TLTS"
VERSION = 1
_ALIGN = 64


def dtype_name(dt: np.dtype) -> str:
    """The TLTS header name of a numpy dtype (``"bfloat16"`` for
    :data:`BFLOAT16` and for ``ml_dtypes``' bfloat16)."""
    dt = np.dtype(dt)
    if dt == BFLOAT16:
        return "bfloat16"
    return dt.name


def _dtype_from_name(name: str) -> np.dtype:
    if name == "bfloat16":
        return BFLOAT16
    return np.dtype(name)


def encode(obj: Any) -> memoryview:
    """Serialize a nested container of numpy arrays and scalars into one
    frame, returned as a bytes-compatible ``memoryview``."""
    arrays: list[np.ndarray] = []
    table: list[dict[str, Any]] = []

    def walk(x: Any) -> Any:
        if isinstance(x, np.ndarray):
            a = x if x.flags.c_contiguous else np.ascontiguousarray(x)
            idx = len(arrays)
            arrays.append(a)
            table.append({"dtype": dtype_name(a.dtype), "shape": list(a.shape)})
            return {"__arr__": idx}
        if isinstance(x, np.generic):
            return walk(np.asarray(x))
        if isinstance(x, bytes):
            return {"__bytes__": x.hex()}
        if isinstance(x, dict):
            return {"__dict__": [[walk(k), walk(v)] for k, v in x.items()]}
        if isinstance(x, tuple):
            return {"__tuple__": [walk(v) for v in x]}
        if isinstance(x, list):
            return [walk(v) for v in x]
        if x is None or isinstance(x, (bool, int, str, float)):
            return x
        raise TypeError(f"cannot serialize {type(x).__name__}")

    tree = walk(obj)
    offset = 0
    for a, meta in zip(arrays, table):
        offset = (offset + _ALIGN - 1) // _ALIGN * _ALIGN
        meta["offset"] = offset
        meta["nbytes"] = a.nbytes
        offset += a.nbytes

    header = json.dumps({"tree": tree, "arrays": table}).encode()
    prefix = 9 + len(header)
    buf = np.empty(prefix + offset, np.uint8)
    mv = memoryview(buf)
    mv[0:4] = MAGIC
    mv[4] = VERSION
    mv[5:9] = len(header).to_bytes(4, "little")
    mv[9:prefix] = header
    pos = 0
    for a, meta in zip(arrays, table):
        if meta["offset"] != pos:  # zero the alignment gap
            buf[prefix + pos : prefix + meta["offset"]] = 0
        n = meta["nbytes"]
        if n:
            np.copyto(
                buf[prefix + meta["offset"] : prefix + meta["offset"] + n],
                a.reshape(-1).view(np.uint8),
            )
        pos = meta["offset"] + n
    return mv


def decode(data: bytes | memoryview, *, copy: bool = False) -> Any:
    """Inverse of :func:`encode`. Arrays come back as numpy views over the
    input buffer unless ``copy=True``; bfloat16 arrays as
    :data:`BFLOAT16`."""
    mv = memoryview(data)
    if len(mv) < 9:
        raise ValueError(f"truncated TLTS frame: {len(mv)} bytes")
    if bytes(mv[:4]) != MAGIC:
        raise ValueError("bad magic: not a TLTS frame")
    if mv[4] != VERSION:
        raise ValueError(f"unsupported TLTS version {mv[4]}")
    hlen = int.from_bytes(mv[5:9], "little")
    if 9 + hlen > len(mv):
        raise ValueError("truncated TLTS frame: header exceeds buffer")
    header = json.loads(bytes(mv[9 : 9 + hlen]).decode())
    payload = mv[9 + hlen :]

    def get_array(i: int) -> np.ndarray:
        meta = header["arrays"][i]
        dt = _dtype_from_name(meta["dtype"])
        if meta["offset"] + meta["nbytes"] > len(payload):
            raise ValueError(
                f"truncated TLTS frame: array {i} needs bytes up to "
                f"{meta['offset'] + meta['nbytes']}, payload has {len(payload)}"
            )
        raw = payload[meta["offset"] : meta["offset"] + meta["nbytes"]]
        a = np.frombuffer(raw, dtype=dt).reshape(meta["shape"])
        return a.copy() if copy else a

    def walk(x: Any) -> Any:
        if isinstance(x, dict):
            if "__arr__" in x:
                return get_array(x["__arr__"])
            if "__bytes__" in x:
                return bytes.fromhex(x["__bytes__"])
            if "__dict__" in x:
                return {walk(k): walk(v) for k, v in x["__dict__"]}
            if "__tuple__" in x:
                return tuple(walk(v) for v in x["__tuple__"])
            raise ValueError(f"malformed node: {list(x)[:3]}")
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x

    return walk(header["tree"])


def content_digest(obj: Any) -> str:
    """Stable sha256 over an object's TLTS encoding: the integrity tag a
    migration or prefix blob carries over its KV payload, recomputed by
    the importer before it adopts the bytes."""
    return hashlib.sha256(bytes(encode(obj))).hexdigest()


__all__ = ["BFLOAT16", "content_digest", "decode", "dtype_name", "encode"]
