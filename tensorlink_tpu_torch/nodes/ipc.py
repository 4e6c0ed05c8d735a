"""ML↔network process bridge.

Reference equivalent: ``BaseNode.send_request`` — a blocking round-trip
through two ``mp.Queue``s under one global ``mpc_lock`` (nodes/nodes.py:
201-235), answered by a 1 ms poll loop (p2p/torch_node.py:932-935). That
lock serializes *all* ML↔net traffic; here each request carries its own id
and resolves its own future, so any number of ML threads can have requests
in flight, and the network side executes each command as its own asyncio
task (a slow ``tensor_request`` does not block a ``status`` call).

Three queues:

- ``cmd``   ML → net: ``(rid, verb, payload)`` — commands for the net loop.
- ``resp``  net → ML: ``(rid, ok, result)`` — command results.
- ``work``  net → ML: ``(kind, item)`` — events the ML executor consumes
  with a *blocking* get (no polling; the reference's main_loop polls five
  queues per module per tick, ml/worker.py:1386-1435).

Payloads may contain numpy arrays (pickled efficiently by mp via buffer
protocol). torch tensors must be converted to numpy before crossing.
"""

from __future__ import annotations

import asyncio
import itertools
import multiprocessing as mp
import queue as queue_mod
import threading
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable


class RemoteError(RuntimeError):
    """A command failed in the network process; carries its traceback."""


@dataclass
class BridgeQueues:
    """The picklable bundle handed to the spawned network process."""

    cmd: mp.Queue = field(default_factory=mp.Queue)
    resp: mp.Queue = field(default_factory=mp.Queue)
    work: mp.Queue = field(default_factory=mp.Queue)


class MLBridge:
    """ML-process side: issue commands, consume work events."""

    def __init__(self, queues: BridgeQueues):
        self.q = queues
        self._pending: dict[int, queue_mod.Queue] = {}
        self._lock = threading.Lock()
        self._rid = itertools.count(1)
        self._dispatcher: threading.Thread | None = None
        self._closed = threading.Event()

    def start(self) -> None:
        if self._dispatcher:
            return
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="ipc-dispatch", daemon=True
        )
        self._dispatcher.start()

    def _dispatch_loop(self) -> None:
        while not self._closed.is_set():
            try:
                rid, ok, result = self.q.resp.get(timeout=0.5)
            # tlint: disable=TL005(the poll timeout IS the loop cadence — Empty means check the stop flag)
            except queue_mod.Empty:
                continue
            except (EOFError, OSError):
                break
            with self._lock:
                slot = self._pending.pop(rid, None)
            if slot is not None:
                slot.put((ok, result))

    def request(self, verb: str, payload: Any = None, timeout: float = 30.0) -> Any:
        """Blocking command round-trip; safe from any ML thread."""
        rid = next(self._rid)
        slot: queue_mod.Queue = queue_mod.Queue(1)
        with self._lock:
            self._pending[rid] = slot
        self.q.cmd.put((rid, verb, payload))
        try:
            ok, result = slot.get(timeout=timeout)
        except queue_mod.Empty:
            with self._lock:
                self._pending.pop(rid, None)
            raise TimeoutError(f"ipc command {verb!r} timed out after {timeout}s")
        if not ok:
            raise RemoteError(f"{verb}: {result}")
        return result

    def notify(self, verb: str, payload: Any = None) -> None:
        """Fire-and-forget command (no reply expected)."""
        self.q.cmd.put((0, verb, payload))

    def get_work(self, timeout: float | None = None):
        """Blocking get of the next work event; None on timeout."""
        try:
            return self.q.work.get(timeout=timeout)
        except queue_mod.Empty:
            return None

    def close(self) -> None:
        self._closed.set()


class NetBridge:
    """Network-process side: executes commands against the role server.

    Queue writes from the event loop go through an executor thread — the
    native ring's put blocks when the consumer lags, and a blocked event
    loop would stall all networking (heartbeats, every connection)."""

    def __init__(self, queues: BridgeQueues):
        self.q = queues
        self._task: asyncio.Task | None = None

    def post_work(self, kind: str, item: Any) -> None:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if loop is not None:
            loop.run_in_executor(None, self._safe_put, self.q.work, (kind, item))
        else:
            self._safe_put(self.q.work, (kind, item))

    @staticmethod
    def _safe_put(q, item) -> None:
        try:
            q.put(item)
        # tlint: disable=TL005(_safe_put's contract: consumer gone at shutdown means nothing to deliver to)
        except Exception:
            pass  # consumer gone (shutdown) — nothing to deliver to

    async def serve(self, dispatch: Callable[[str, Any], Any]) -> None:
        """Pump the cmd queue; run each command as its own task.

        ``dispatch(verb, payload)`` is an async callable on the role server.
        """
        loop = asyncio.get_running_loop()
        while True:
            item = await loop.run_in_executor(None, self._blocking_get)
            if item is None:
                continue
            rid, verb, payload = item
            if verb == "_stop":
                break
            asyncio.ensure_future(self._run_cmd(dispatch, rid, verb, payload))

    def _blocking_get(self):
        try:
            return self.q.cmd.get(timeout=0.5)
        except queue_mod.Empty:
            return None
        except (EOFError, OSError):
            return (0, "_stop", None)

    async def _run_cmd(self, dispatch, rid: int, verb: str, payload: Any) -> None:
        try:
            result = await dispatch(verb, payload)
            ok = True
        except Exception:
            result = traceback.format_exc(limit=20)
            ok = False
        if rid:  # rid 0 = notify, no reply wanted
            await asyncio.get_running_loop().run_in_executor(
                None, self._safe_put, self.q.resp, (rid, ok, result)
            )
