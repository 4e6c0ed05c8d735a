"""End-to-end request tracing + the engine flight recorder.

**Tracing.** The API server mints one trace id per HTTP request (echoed
as ``X-Request-Id``); the id rides the GENERATE / session-op / MIGRATE
wire frames, and every hop records *spans* — host-side timing records
(queue-wait, admission, per-prefill-chunk, first-token, decode,
freeze/export/stage/adopt) — into its process-local :class:`Tracer`.
Spans recorded on a remote worker ride its responses back (the
``trace`` field next to the serving snapshot) and are :meth:`ingested
<Tracer.ingest>` into the validator's tracer, so a stream migrated
between workers stitches spans from BOTH under one trace id, queryable
at ``GET /trace/<rid>``.

Hot-path contract (the reason this is a module and not a logging
sprinkle): spans are recorded only at boundaries the host already
synchronizes (the per-chunk boundary in the slot engine, admission, the
migration verbs). Recording is a ``time.monotonic()`` read plus a dict
append under a short lock — no device sync, no compiled programs, and
with no trace id on a request the engine skips the calls entirely
(bench-measured disabled-mode overhead).

Span timestamps: ``dur_ms`` comes from ``time.monotonic`` pairs on one
host (drift-free). ``ts`` is a wall-clock epoch anchor recorded ONCE per
span for cross-worker ordering/joining only — it is never subtracted or
compared for durations (tlint TL004 discipline).

**Flight recorder.** A bounded per-engine ring of per-step records
(occupied slots, prefill grants, tokens emitted, page occupancy,
preemptions), appended at the same per-chunk boundary, dumped on engine
error — chaos-test postmortems read data instead of print archaeology.
"""

from __future__ import annotations

import contextvars
import itertools
import secrets
import threading
import time
from collections import OrderedDict, deque

# active trace id for log joining (core/logging.py json mode): set by the
# code driving a request on the CURRENT thread (generate_api entry, the
# API handler); contextvars keep thread/task isolation for free
current_trace: contextvars.ContextVar[str] = contextvars.ContextVar(
    "tlink_trace", default=""
)


def mint_trace_id() -> str:
    """A fresh request/trace id (also the ``X-Request-Id`` echo)."""
    return secrets.token_hex(8)


class Tracer:
    """Bounded per-process span store keyed by trace id.

    One instance per process (:func:`get_tracer`); several in-process
    nodes (the test clusters run every node's ML thread in one process)
    share it, so every span carries its recording ``site`` (node id /
    engine tag) and a process-unique ``sid`` — :meth:`ingest` dedups on
    ``sid`` so a span that arrives both locally and over the wire lands
    once."""

    def __init__(self, max_traces: int = 512, max_spans: int = 256):
        self.max_traces = int(max_traces)
        self.max_spans = int(max_spans)
        self._lock = threading.Lock()
        self._traces: OrderedDict[str, list[dict]] = OrderedDict()  #: guarded by self._lock
        self._sid = itertools.count(1)
        # process-unique sid prefix: two processes ingesting each other's
        # spans must never collide on (prefix, n)
        self._tag = secrets.token_hex(4)

    # -- recording -------------------------------------------------------
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
            # wall anchor for cross-worker ordering/log joining ONLY —
            # durations always come from the monotonic pair in dur_ms
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
                    self._traces.popitem(last=False)  # LRU-ish: oldest out
            if len(spans) < self.max_spans:
                spans.append(span)

    class _SpanCtx:
        __slots__ = ("tracer", "trace_id", "name", "site", "attrs", "_t0")

        def __init__(self, tracer, trace_id, name, site, attrs):
            self.tracer = tracer
            self.trace_id = trace_id
            self.name = name
            self.site = site
            self.attrs = attrs

        def __enter__(self):
            self._t0 = time.monotonic()
            return self

        def __exit__(self, *exc):
            self.tracer.record(
                self.trace_id, self.name, site=self.site,
                dur_s=time.monotonic() - self._t0, **self.attrs,
            )
            return False

    def span(self, trace_id: str, name: str, *, site: str = "", **attrs):
        """Context manager measuring a monotonic duration around a block
        (records nothing when ``trace_id`` is empty — record() gates)."""
        return Tracer._SpanCtx(self, trace_id, name, site, attrs)

    # -- merge / query ---------------------------------------------------
    def ingest(self, trace_id: str, spans: list[dict]) -> int:
        """Merge spans that arrived over the wire (a worker's response).
        Dedups on ``sid`` — duplicated frames / in-process double-sight
        (local record + wire echo) land once. Returns spans added."""
        if not trace_id or not spans:
            return 0
        added = 0
        with self._lock:
            mine = self._traces.get(trace_id)
            if mine is None:
                mine = []
                self._traces[trace_id] = mine
                while len(self._traces) > self.max_traces:
                    self._traces.popitem(last=False)
            seen = {s.get("sid") for s in mine}
            for s in spans:
                if not isinstance(s, dict) or s.get("sid") in seen:
                    continue
                if len(mine) >= self.max_spans:
                    break
                mine.append(dict(s))
                seen.add(s.get("sid"))
                added += 1
        return added

    def collect(self, trace_id: str) -> list[dict]:
        """All spans recorded/ingested for a trace (ts-ordered copy)."""
        with self._lock:
            spans = list(self._traces.get(trace_id, ()))
        return sorted(spans, key=lambda s: s.get("ts", 0.0))

    def known(self, trace_id: str) -> bool:
        with self._lock:
            return trace_id in self._traces

    def reset(self) -> None:
        """Drop every stored trace (tests / bench isolation)."""
        with self._lock:
            self._traces.clear()


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer: the API server, locally-hosted engines
    and the DistributedModel ingest side all share it, which is what
    makes ``GET /trace/<rid>`` one lookup."""
    return _TRACER


class FlightRecorder:
    """Bounded ring of per-engine-step records — the postmortem buffer.

    The engine appends one record per ``step_chunk`` boundary (already a
    host sync point; the append is a deque op). On engine error the ring
    is dumped (``last_dump``) so a chaos failure ships its final N steps
    of slot/page state with the exception instead of losing them."""

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

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def dump(self, error: BaseException | None = None) -> dict:
        """Snapshot the ring (with the triggering error) and remember it
        on ``last_dump`` for tests/operators to query after teardown."""
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


__all__ = [
    "FlightRecorder",
    "Tracer",
    "current_trace",
    "get_tracer",
    "mint_trace_id",
]
