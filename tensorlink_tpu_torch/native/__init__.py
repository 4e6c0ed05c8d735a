"""Native (C++) runtime components with build-on-demand + pure-Python
fallback.

The reference has no native code of its own (SURVEY §2: 100% Python, all
native perf from dependencies); here the runtime hot paths are C++ where it
pays: the ML↔network shared-memory message ring (tlring.cpp). The library
compiles on first use with g++ into the checkout's ``build/`` directory
(beside the CUDA kernels, never under the user's home); import never fails —
``load_tlring()`` returns None when the toolchain or platform can't build,
and callers fall back to mp.Queue transports.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

_SRC = Path(__file__).parent / "tlring.cpp"
_lib = None
_tried = False


def _cache_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "tensorlink_tpu_torch"


def _build() -> Path | None:
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + sys.version.encode()).hexdigest()[:16]
    out = _cache_dir() / f"libtlring-{tag}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
        "-o", str(tmp), str(_SRC), "-lpthread", "-lrt",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError, OSError):
        tmp.unlink(missing_ok=True)
        return None
    tmp.replace(out)
    return out


def load_tlring():
    """ctypes handle to the ring library, or None (fallback mode)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not sys.platform.startswith("linux"):
        return None
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.tlring_create.restype = ctypes.c_void_p
    lib.tlring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.tlring_attach.restype = ctypes.c_void_p
    lib.tlring_attach.argtypes = [ctypes.c_char_p]
    lib.tlring_write.restype = ctypes.c_int
    # payload as c_void_p: accepts bytes AND writable buffers
    # ((c_char * n).from_buffer(...)) so callers can write straight from a
    # serialization buffer without a bytes() copy (core/ring.py::put)
    lib.tlring_write.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_double,
    ]
    lib.tlring_next_size.restype = ctypes.c_int64
    lib.tlring_next_size.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.tlring_read.restype = ctypes.c_int64
    lib.tlring_read.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
    ]
    lib.tlring_close.argtypes = [ctypes.c_void_p]
    lib.tlring_detach.argtypes = [ctypes.c_void_p]
    lib.tlring_unlink.restype = ctypes.c_int
    lib.tlring_unlink.argtypes = [ctypes.c_char_p]
    _lib = lib
    return _lib
