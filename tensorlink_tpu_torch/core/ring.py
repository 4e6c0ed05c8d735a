"""RingChannel — queue-shaped Python wrapper over the native shm ring.

Drop-in for the ``mp.Queue`` trio in nodes/ipc.py: ``put(obj)`` /
``get(timeout)`` with ``queue.Empty`` on timeout. Objects serialize through
TLTS (core/serialization.py — arrays are raw buffers, never pickled);
messages bigger than half the ring spill to a TLTS temp file and ship as a
path marker (the reference spills >20 MB frames the same way,
p2p/connection.py:110-122).

Pickling a RingChannel transfers only ``(name, capacity)`` — the spawned
process attaches to the same shm segment (creator side unlinks on close).
"""

from __future__ import annotations

import os
import queue as queue_mod
import secrets
import tempfile
import threading
from pathlib import Path

from tensorlink_tpu_torch.core import serialization as ser

_FILE_MARKER = b"TLF1"
DEFAULT_CAPACITY = 64 << 20


class RingChannel:
    def __init__(self, capacity: int = DEFAULT_CAPACITY, *, _name: str | None = None):
        from tensorlink_tpu_torch.native import load_tlring

        self._lib = load_tlring()
        if self._lib is None:
            raise RuntimeError("native tlring unavailable")
        self.capacity = capacity
        self._wlock = threading.Lock()
        self._rlock = threading.Lock()
        if _name is None:
            sweep_orphans()  # SIGKILLed owners can't unlink; reap them here
            self.name = f"/tlring-{os.getpid()}-{secrets.token_hex(6)}"
            self._h = self._lib.tlring_create(self.name.encode(), capacity)
            self.owner = True
        else:
            self.name = _name
            self._h = self._lib.tlring_attach(self.name.encode())
            self.owner = False
        if not self._h:
            raise RuntimeError(f"tlring setup failed for {self.name}")

    # -- pickling: child attaches ---------------------------------------
    def __reduce__(self):
        return (_attach, (self.name, self.capacity))

    # -- queue interface -------------------------------------------------
    def put(self, obj, timeout: float = 120.0) -> None:
        import ctypes

        blob = ser.encode(obj)
        if len(blob) + 8 > self.capacity // 2:
            # oversized → spill the ALREADY-BUILT frame + tiny marker
            # message (re-encoding here would pay the whole frame assembly
            # twice on exactly the large-payload path)
            fd, path = tempfile.mkstemp(prefix="tlring-", suffix=".tlts")
            os.close(fd)
            with open(path, "wb") as f:
                f.write(blob)
            blob = _FILE_MARKER + path.encode()
        if isinstance(blob, bytes):
            carg = blob
        else:
            # write straight from encode()'s buffer — no bytes() copy on
            # the hot IPC path (tlring_write takes c_void_p)
            carg = (ctypes.c_char * len(blob)).from_buffer(blob)
        with self._wlock:
            if self._h is None:
                raise OSError(f"ring {self.name} released")
            rc = self._lib.tlring_write(self._h, carg, len(blob), timeout)
        if rc == -1:
            raise queue_mod.Full(f"ring {self.name} full after {timeout}s")
        if rc == -2:
            raise OSError(f"ring {self.name} closed")
        if rc != 0:
            raise OSError(f"ring write failed rc={rc}")

    def get(self, timeout: float | None = None):
        t = 3600.0 if timeout is None else float(timeout)
        with self._rlock:
            if self._h is None:
                raise EOFError(f"ring {self.name} released")
            size = self._lib.tlring_next_size(self._h, t)
            if size == -1:
                raise queue_mod.Empty
            if size == -2:
                raise EOFError(f"ring {self.name} closed")
            if size < 0:
                raise OSError(f"ring read failed rc={size}")
            import ctypes

            cbuf = ctypes.create_string_buffer(size)
            n = self._lib.tlring_read(self._h, cbuf, size)
            if n != size:
                raise OSError(f"ring read short: {n} != {size}")
            buf = cbuf.raw
        if buf[:4] == _FILE_MARKER:
            path = Path(buf[4:].decode())
            obj = ser.decode_from_file(path)
            path.unlink(missing_ok=True)
            return obj
        return ser.decode(buf, copy=True)

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        if self._h:
            self._lib.tlring_close(self._h)

    def release(self) -> None:
        """Detach (and unlink when owner). Thread-safe against concurrent
        put/get: close() first wakes any thread blocked inside the C calls
        (they return closed), then the detach waits for both user locks so
        the munmap can never pull memory out from under a live call."""
        if self._h is None:
            return
        self._lib.tlring_close(self._h)
        with self._wlock, self._rlock:
            if self._h is None:
                return
            self._lib.tlring_detach(self._h)
            self._h = None
        if self.owner:
            self._lib.tlring_unlink(self.name.encode())

    def __del__(self):  # best-effort; explicit release preferred
        try:
            self.release()
        # tlint: disable=TL005(__del__ must never raise; explicit release() is the loud path)
        except Exception:
            pass


def _attach(name: str, capacity: int) -> RingChannel:
    return RingChannel(capacity, _name=name)


def sweep_orphans() -> int:
    """Unlink shm segments whose creating process is gone. Ring names embed
    the creator pid (``tlring-<pid>-<token>``); a SIGKILLed node can never
    unlink its segments, and a long-lived host would otherwise exhaust
    /dev/shm. Attachers of a dead creator are orphaned regardless, so
    reaping by creator-liveness is safe. Returns segments removed."""
    import re

    n = 0
    shm = Path("/dev/shm")
    if not shm.is_dir():
        return 0
    for p in shm.glob("tlring-*"):
        m = re.match(r"tlring-(\d+)-", p.name)
        if not m:
            continue
        try:
            os.kill(int(m.group(1)), 0)
        except ProcessLookupError:
            try:
                p.unlink()
                n += 1
            # tlint: disable=TL005(stale-segment sweep races other processes unlinking the same file)
            except OSError:
                pass
        # tlint: disable=TL005(pid exists under another uid — its segment is not ours to sweep)
        except PermissionError:
            pass  # pid exists under another uid — leave it
    return n


def ring_supported() -> bool:
    from tensorlink_tpu_torch.native import load_tlring

    return load_tlring() is not None
