"""Request spans and the engine flight recorder.

A copy of the part of ``tensorlink_tpu/core/trace.py`` the serving engine
uses: the process-global :class:`Tracer` (spans recorded only for requests
that carry a trace id, only at boundaries the engine already synchronizes)
and the per-engine :class:`FlightRecorder` ring of per-chunk records.
Cross-worker ingest and the ``/trace`` query stay with the API stack.
"""

from __future__ import annotations

import itertools
import secrets
import threading
import time
from collections import OrderedDict, deque


class Tracer:
    """Bounded per-process span store keyed by trace id."""

    def __init__(self, max_traces: int = 512, max_spans: int = 256):
        self.max_traces = int(max_traces)
        self.max_spans = int(max_spans)
        self._lock = threading.Lock()
        self._traces: OrderedDict[str, list[dict]] = OrderedDict()  #: guarded by self._lock
        self._sid = itertools.count(1)
        self._tag = secrets.token_hex(4)

    def record(
        self,
        trace_id: str,
        name: str,
        *,
        site: str = "",
        dur_s: float | None = None,
        **attrs,
    ) -> None:
        """Append one span. ``dur_s`` is a monotonic-pair duration
        measured by the caller (None = instantaneous event)."""
        if not trace_id:
            return
        span = {
            "sid": f"{self._tag}:{next(self._sid)}",
            "name": str(name),
            "site": str(site),
            # wall anchor for ordering only; durations come from dur_ms
            "ts": time.time(),
        }
        if dur_s is not None:
            span["dur_ms"] = round(float(dur_s) * 1e3, 4)
        if attrs:
            span.update(attrs)
        with self._lock:
            spans = self._traces.get(trace_id)
            if spans is None:
                spans = []
                self._traces[trace_id] = spans
                while len(self._traces) > self.max_traces:
                    self._traces.popitem(last=False)
            if len(spans) < self.max_spans:
                spans.append(span)

    def collect(self, trace_id: str) -> list[dict]:
        """All spans recorded for a trace (ts-ordered copy)."""
        with self._lock:
            spans = list(self._traces.get(trace_id, ()))
        return sorted(spans, key=lambda s: s.get("ts", 0.0))


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer."""
    return _TRACER


class FlightRecorder:
    """Bounded ring of per-engine-step records — the postmortem buffer,
    appended once per ``step_chunk`` boundary and dumped on engine error."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=self.capacity)  #: guarded by self._lock
        self._step = itertools.count(1)
        self.last_dump: dict | None = None  #: guarded by self._lock

    def record(self, **fields) -> None:
        rec = {"step": next(self._step), **fields}
        with self._lock:
            self._ring.append(rec)

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def dump(self, error: BaseException | None = None) -> dict:
        """Snapshot the ring (with the triggering error) into
        ``last_dump``."""
        with self._lock:
            out = {
                "error": (
                    f"{type(error).__name__}: {error}" if error else None
                ),
                "n_records": len(self._ring),
                "records": list(self._ring),
            }
            self.last_dump = out
        return out


__all__ = ["FlightRecorder", "Tracer", "get_tracer"]
