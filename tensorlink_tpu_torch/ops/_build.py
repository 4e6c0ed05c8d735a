"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` into a shared library
with a plain C interface, ``build/tensorlink_tpu_torch/<name>-<hash>.so``
at the root of the checkout, loaded with ``ctypes``; ``ENTRY_POINTS``
names the C functions each library exports. Nothing includes
PyTorch's headers, so a build takes seconds. The file name carries a hash
of the sources and flags: an edited source never loads a stale build.

Builds happen at first use (``load``) or all at once (``build_all``, one
``nvcc`` per source, started together). A failed build raises with the
compiler's output; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tensorlink_tpu_torch"
KERNELS = ("flash_attention", "ragged_paged_attention")  # csrc/<name>.cu
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: the source that defines each, and its argument types
# (ctypes passes an undeclared pointer as a 32-bit int)
ENTRY_POINTS = {
    "tl_flash_attention": (
        "flash_attention",
        [_P] * 4 + [_I] * 6 + [ctypes.c_longlong] * 6 + [_I, _F, _P],
    ),
    "tl_paged_attention": (
        "ragged_paged_attention",
        [_P] * 10 + [_I] * 8 + [_F, _P],
    ),
    "tl_ragged_paged_attention": (
        "ragged_paged_attention",
        [_P] * 11 + [_I] * 9 + [_F, _P],
    ),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}  #: guarded by _lock
build_seconds: dict[str, float] = {}  #: guarded by _lock


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, the ``PATH`` or ``/usr/local/cuda``."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path,
            t0: float) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    out.with_suffix(".log").write_text(log)
    build_seconds[name] = time.monotonic() - t0


def build_all(names=KERNELS) -> dict[str, float]:
    """Compile every kernel not built yet, one ``nvcc`` per source, all
    started together. Returns the wall seconds each build took (0.0 for
    one found already built)."""
    with _lock:
        t0 = time.monotonic()
        jobs = []
        for name in names:
            if _target(name).exists():
                build_seconds.setdefault(name, 0.0)
            else:
                jobs.append((name, *_start(name)))
        for name, proc, tmp, out in jobs:
            _finish(name, proc, tmp, out, t0)
        return {n: build_seconds[n] for n in names}


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) of the current build of ``name``."""
    path = _target(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, building it first if
    needed; its C entry points have ``argtypes``/``restype`` declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
    build_all((name,))
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            for fn_name, (src, argtypes) in ENTRY_POINTS.items():
                if src == name:
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            lib.tl_error_string.argtypes = [ctypes.c_int]
            lib.tl_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


__all__ = ["BUILD_DIR", "ENTRY_POINTS", "KERNELS", "build_all", "build_log",
           "load"]
