"""One authenticated peer link = one asyncio ``Connection``.

Replaces the reference's thread-per-socket ``Connection`` (p2p/connection.py:
recv loop scanning for a sentinel, writer threads spilling >20 MB to
``tmp/streamed_data_*`` files). Here:

- frames are length-prefixed (protocol.py) and read with ``readexactly``;
- bulk frames above ``SPILL_THRESHOLD`` stream straight to a spill file and
  are delivered as a path, never materialized in RAM;
- writes are serialized by an asyncio lock instead of a file lock;
- an idle ping fires after ``idle_ping_s`` (reference: 30 s PING health
  check, connection.py:333-353).

A received frame is delivered to the owner's ``on_frame(conn, kind, tag,
payload)`` coroutine; ``payload`` is ``bytes`` or a ``pathlib.Path`` for
spilled bulk frames.
"""

from __future__ import annotations

import asyncio
import os
import tempfile
import time
import uuid
from pathlib import Path
from typing import Awaitable, Callable

from tensorlink_tpu_torch.core import faults
from tensorlink_tpu_torch.core.logging import get_logger
from tensorlink_tpu_torch.p2p import protocol as proto

log = get_logger("p2p.conn")

_IO_CHUNK = 4 << 20  # stream spill files in 4 MiB slices


class Connection:
    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        *,
        spill_dir: str | Path | None = None,
        idle_ping_s: float = 30.0,
    ):
        self.reader = reader
        self.writer = writer
        self.spill_dir = Path(spill_dir or tempfile.gettempdir()) / "tlnk_spill"
        self.idle_ping_s = idle_ping_s
        self.node_id: str | None = None  # set after handshake
        self.role: str | None = None
        self.pub_pem: bytes | None = None
        self.last_seen = time.monotonic()
        self.latency_s: float | None = None
        self.ghosts = 0  # unexpected-message counter (reference connection.py:60)
        # the write lock serializes frame writes AND the sent counter —
        # concurrent senders would interleave header/payload on the wire
        self.bytes_sent = 0  #: guarded by self._wlock
        self.bytes_received = 0
        self.closed = asyncio.Event()
        self._wlock = asyncio.Lock()
        self._pump_task: asyncio.Task | None = None
        self._ping_task: asyncio.Task | None = None
        self._ping_sent_at: float | None = None

    # -- identity ----------------------------------------------------------
    @property
    def peername(self) -> tuple[str, int]:
        peer = self.writer.get_extra_info("peername")
        return (peer[0], peer[1]) if peer else ("?", 0)

    def __repr__(self):
        nid = (self.node_id or "?")[:8]
        return f"<Connection {nid} {self.peername[0]}:{self.peername[1]}>"

    # -- sending -----------------------------------------------------------
    async def send_control(self, tag: str, body: dict) -> None:
        kind, tag, payload = proto.control(tag, body)
        await self.send_frame(kind, tag, payload)

    async def send_frame(self, kind: int, tag: str, payload: bytes) -> None:
        dup = False
        if faults.ENABLED:  # fault site "p2p.send": drop / delay / dup
            act = faults.inject("p2p.send", tag)
            if act == "drop":
                return
            if isinstance(act, tuple):
                await asyncio.sleep(act[1])
            dup = act == "dup"
        header = proto.pack_header(kind, tag, len(payload))
        async with self._wlock:
            for _ in range(2 if dup else 1):
                self.writer.write(header)
                self.writer.write(payload)
                await self.writer.drain()
                self.bytes_sent += len(header) + len(payload)

    async def send_file(self, kind: int, tag: str, path: str | Path, *, delete: bool = True) -> None:
        """Stream a file as one bulk frame without loading it (reference
        ``send_from_file``, connection.py:164-213)."""
        path = Path(path)
        size = path.stat().st_size
        header = proto.pack_header(kind, tag, size)
        async with self._wlock:
            self.writer.write(header)
            with path.open("rb") as f:
                while chunk := f.read(_IO_CHUNK):
                    self.writer.write(chunk)
                    await self.writer.drain()
            self.bytes_sent += proto.HEADER_SIZE + len(tag) + size
        if delete:
            path.unlink(missing_ok=True)

    # -- receiving ---------------------------------------------------------
    async def run(
        self, on_frame: Callable[["Connection", int, str, bytes | Path], Awaitable[None]]
    ) -> None:
        """Read frames until EOF, dispatching each to ``on_frame``."""
        self._ping_task = asyncio.ensure_future(self._idle_ping())
        try:
            while True:
                try:
                    head = await self.reader.readexactly(proto.HEADER_SIZE)
                    hdr = proto.unpack_header(head)
                    tag = (await self.reader.readexactly(hdr.tag_len)).decode("ascii")
                    payload: bytes | Path
                    if hdr.kind == proto.BULK and hdr.payload_len > proto.SPILL_THRESHOLD:
                        payload = await self._recv_to_spill(hdr.payload_len)
                    else:
                        payload = await self._recv_exact(hdr.payload_len)
                except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
                    break
                self.bytes_received += proto.HEADER_SIZE + hdr.tag_len + hdr.payload_len
                self.last_seen = time.monotonic()
                deliveries = 1
                if faults.ENABLED:  # fault site "connection.frame"
                    act = faults.inject("connection.frame", tag)
                    if act == "drop":
                        if isinstance(payload, Path):
                            # spilled frames are consumed on delivery — a
                            # dropped one must still release its temp file
                            payload.unlink(missing_ok=True)
                        continue
                    if isinstance(act, tuple):
                        await asyncio.sleep(act[1])
                    if act == "dup" and not isinstance(payload, Path):
                        # spilled frames are consumed (unlinked) on first
                        # delivery — only in-memory payloads can duplicate
                        deliveries = 2
                if tag == proto.PING:
                    await self.send_control(proto.PONG, {})
                    continue
                if tag == proto.PONG:
                    if self._ping_sent_at is not None:
                        self.latency_s = time.monotonic() - self._ping_sent_at
                        self._ping_sent_at = None
                    continue
                for _ in range(deliveries):
                    await on_frame(self, hdr.kind, tag, payload)
        except proto.ProtocolError as e:
            log.warning("protocol error from %s: %s", self.peername, e)
        finally:
            await self.close()

    async def _recv_exact(self, n: int) -> bytes:
        if n == 0:
            return b""
        return await self.reader.readexactly(n)

    async def _recv_to_spill(self, n: int) -> Path:
        self.spill_dir.mkdir(parents=True, exist_ok=True)
        path = self.spill_dir / f"rx_{uuid.uuid4().hex}.tlts"
        remaining = n
        with path.open("wb") as f:
            while remaining > 0:
                chunk = await self.reader.read(min(_IO_CHUNK, remaining))
                if not chunk:
                    raise proto.ProtocolError("EOF mid bulk frame")
                f.write(chunk)
                remaining -= len(chunk)
        return path

    # -- health ------------------------------------------------------------
    async def _idle_ping(self) -> None:
        try:
            while not self.closed.is_set():
                await asyncio.sleep(self.idle_ping_s / 2)
                idle = time.monotonic() - self.last_seen
                if idle >= self.idle_ping_s:
                    self._ping_sent_at = time.monotonic()
                    try:
                        await self.send_control(proto.PING, {})
                    except (ConnectionError, OSError):
                        break
        # tlint: disable=TL005(task cancellation is the ping loop's normal shutdown signal)
        except asyncio.CancelledError:
            pass

    async def ping(self) -> float | None:
        """Measure round-trip latency; returns seconds or None on timeout."""
        self._ping_sent_at = time.monotonic()
        await self.send_control(proto.PING, {})
        for _ in range(50):
            await asyncio.sleep(0.02)
            if self.latency_s is not None and self._ping_sent_at is None:
                return self.latency_s
        return None

    async def close(self) -> None:
        if self.closed.is_set():
            return
        self.closed.set()
        if self._ping_task:
            self._ping_task.cancel()
        try:
            self.writer.close()
            await self.writer.wait_closed()
        # tlint: disable=TL005(closing an already-dead transport)
        except (ConnectionError, OSError):
            pass


def cleanup_spill(spill_dir: str | Path, max_age_s: float = 3600) -> int:
    """Delete stale spill files; returns count removed."""
    d = Path(spill_dir)
    if not d.is_dir():
        return 0
    now = time.time()
    n = 0
    for p in d.glob("rx_*.tlts"):
        try:
            # tlint: disable=TL004(st_mtime is epoch — wall clock is the only comparable base)
            if now - p.stat().st_mtime > max_age_s:
                p.unlink()
                n += 1
        # tlint: disable=TL005(spill sweep races the consumer unlinking its own file)
        except OSError:
            pass
    return n


def spill_write(obj_bytes: bytes, spill_dir: str | Path) -> Path:
    d = Path(spill_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"tx_{uuid.uuid4().hex}.tlts"
    with path.open("wb") as f:
        f.write(obj_bytes)
    return path


__all__ = ["Connection", "cleanup_spill", "spill_write"]


if os.name == "nt":  # pragma: no cover
    raise RuntimeError("tensorlink_tpu_torch.p2p requires a POSIX platform")
