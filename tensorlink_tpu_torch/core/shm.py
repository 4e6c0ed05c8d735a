"""POSIX shared-memory hop between co-located processes.

Reference parity: nodes/shared_memory.py:6-38 — ``store_in_shared_memory``
returns ``(size, name)``, ``get_from_shared_memory`` reads and unlinks.
Payloads are TLTS frames (core/serialization.py), never pickle; the
reference's optional trusted-pickle path is deliberately dropped
(SURVEY §7.4).
"""

from __future__ import annotations

from multiprocessing import resource_tracker, shared_memory
from typing import Any

from . import serialization


def _unregister(shm: shared_memory.SharedMemory) -> None:
    # The producing process hands ownership to the consumer; stop the
    # resource tracker from double-unlinking at exit.
    try:  # pragma: no cover - depends on interpreter internals
        resource_tracker.unregister(shm._name, "shared_memory")  # type: ignore[attr-defined]
    # tlint: disable=TL005(resource_tracker is an interpreter internal; on mismatch the tracker just warns at exit)
    except Exception:
        pass


def store(obj: Any) -> tuple[int, str]:
    """Encode ``obj`` into a fresh shared-memory segment; returns (size, name).

    The receiver owns the segment and must call :func:`load` (which unlinks)
    or :func:`unlink`.
    """
    data = serialization.encode(obj)
    shm = shared_memory.SharedMemory(create=True, size=max(len(data), 1))
    shm.buf[: len(data)] = data
    name = shm.name
    _unregister(shm)
    shm.close()
    return len(data), name


def load(size: int, name: str, *, unlink: bool = True) -> Any:
    """Read an object back; unlinks the segment by default (reference
    get_from_shared_memory reads **and unlinks**, shared_memory.py:23)."""
    shm = shared_memory.SharedMemory(name=name)
    try:
        # One memcpy of the frame, then zero-copy array views into it; views
        # must not point at the mapping itself or close() would fail with
        # exported-pointer BufferError.
        obj = serialization.decode(bytes(shm.buf[:size]), copy=False)
    finally:
        shm.close()
        if unlink:
            try:
                shm.unlink()
            # tlint: disable=TL005(consumer/producer race on unlink — either side may have won)
            except FileNotFoundError:
                pass
    return obj


def unlink(name: str) -> None:
    try:
        shm = shared_memory.SharedMemory(name=name)
        shm.close()
        shm.unlink()
    # tlint: disable=TL005(already gone is the desired end state of unlink)
    except FileNotFoundError:
        pass
