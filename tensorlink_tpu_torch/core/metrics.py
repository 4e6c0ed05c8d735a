"""Unified metrics registry with Prometheus text exposition.

The serving stack's telemetry used to live in ad-hoc counter dicts
stitched through one ``/stats`` blob (``ContinuousEngine.stats``, the
scheduler's ``_ClassStats``, the batchers' loose ints). This module is
the typed replacement: every counter/gauge/histogram is registered once,
``/stats`` keys are *derived* from the registry (byte-compatible — the
test-pinned key set did not move), and the same registry renders as
Prometheus text exposition for the validator's ``GET /metrics``.

Threading contract: metric OBJECTS are cheap namespaced cells, not
synchronized abstractions. Counters follow the single-writer discipline
of the code that owns them (the engine's driver thread, or writes under
the engine lock); readers see int/float snapshots whose worst-case skew
is one increment — exactly the guarantee the old dicts gave. Histograms
take a tiny internal lock because ``observe`` and ``render`` may race
across threads (API thread vs driver).

Exposition grouping: one process may hold several registries (one per
hosted model's engine, one for the API server). :func:`render_prometheus`
merges them into a single valid exposition — HELP/TYPE emitted once per
family, per-registry constant labels (e.g. ``model="tiny"``) applied to
every sample.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Callable, Iterable, Mapping

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*$")
_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_:]")

# default histogram buckets: latency seconds, log-ish spaced — wide
# enough for queue waits on an overloaded CPU host and tight enough for
# TPU-step-scale observations
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def sanitize_metric_name(raw: str) -> str:
    """Best-effort mapping of an arbitrary snapshot key to a legal
    Prometheus metric name."""
    name = _SANITIZE_RE.sub("_", str(raw))
    if not name or not _NAME_RE.match(name):
        name = "_" + name
    return name


class Counter:
    """Monotonic counter. ``inc`` only; writers follow the owner's
    single-writer/lock discipline (see module docstring)."""

    __slots__ = ("name", "help", "labels", "_value")

    def __init__(self, name: str, help: str, labels: Mapping[str, str]):
        self.name = name
        self.help = help
        self.labels = dict(labels)
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        self._value += n

    @property
    def value(self) -> int | float:
        return self._value

    # counters compare like the plain ints they replaced, so the
    # pre-registry test pins (`stats.preempted == 1`) stay byte-valid
    def __int__(self) -> int:
        return int(self._value)

    def __float__(self) -> float:
        return float(self._value)

    def __eq__(self, other):
        if isinstance(other, (int, float)):
            return self._value == other
        return NotImplemented

    def __lt__(self, other):
        return self._value < other

    def __le__(self, other):
        return self._value <= other

    def __gt__(self, other):
        return self._value > other

    def __ge__(self, other):
        return self._value >= other

    __hash__ = object.__hash__

    def samples(self) -> "list[tuple[str, dict, float]]":
        return [(self.name, self.labels, self._value)]


class Gauge:
    """Settable instantaneous value, or a callback gauge (``fn``) read at
    collection time — the shape occupancy/free-list metrics want."""

    __slots__ = ("name", "help", "labels", "_value", "_fn")

    def __init__(
        self,
        name: str,
        help: str,
        labels: Mapping[str, str],
        fn: Callable[[], float] | None = None,
    ):
        self.name = name
        self.help = help
        self.labels = dict(labels)
        self._value = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        if self._fn is not None:
            raise ValueError(f"gauge {self.name} is callback-backed")
        self._value = v

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                # a collection-time probe must never take /metrics down
                return float("nan")
        return self._value

    def samples(self) -> "list[tuple[str, dict, float]]":
        return [(self.name, self.labels, self.value)]


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus semantics:
    ``_bucket{le=...}`` counts observations <= bound, plus ``_sum`` and
    ``_count``)."""

    __slots__ = ("name", "help", "labels", "buckets", "_counts", "_sum",
                 "_count", "_lock")

    def __init__(
        self,
        name: str,
        help: str,
        labels: Mapping[str, str],
        buckets: Iterable[float] = DEFAULT_BUCKETS,
    ):
        self.name = name
        self.help = help
        self.labels = dict(labels)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")
        self._counts = [0] * len(self.buckets)  #: guarded by self._lock
        self._sum = 0.0  #: guarded by self._lock
        self._count = 0  #: guarded by self._lock
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._sum += v
            self._count += 1
            # per-bucket counts; samples() cumulates once at render time
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    break

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def samples(self) -> "list[tuple[str, dict, float]]":
        out: list[tuple[str, dict, float]] = []
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum = 0
        for b, c in zip(self.buckets, counts):
            cum += c
            out.append(
                (f"{self.name}_bucket", {**self.labels, "le": _fmt(b)}, cum)
            )
        out.append((f"{self.name}_bucket", {**self.labels, "le": "+Inf"}, total))
        out.append((f"{self.name}_sum", self.labels, s))
        out.append((f"{self.name}_count", self.labels, total))
        return out


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


# tlint: disable=TL006(read-only type-name table — never mutated at runtime)
_TYPES = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}


class MetricsRegistry:
    """A namespace of typed metrics. One registry per subsystem instance
    (engine, scheduler shares the engine's, API server owns its own)."""

    def __init__(self):
        self._metrics: dict[tuple[str, tuple], object] = {}  #: guarded by self._lock
        self._families: dict[str, tuple[type, str]] = {}  #: guarded by self._lock
        self._lock = threading.Lock()

    # -- registration ----------------------------------------------------
    def _register(self, cls, name: str, help: str, labels, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labels = dict(labels or {})
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            fam = self._families.get(name)
            if fam is not None and fam[0] is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as {fam[0].__name__}"
                )
            existing = self._metrics.get(key)
            if existing is not None:
                return existing
            m = cls(name, help, labels, **kw)
            self._metrics[key] = m
            self._families.setdefault(name, (cls, help))
            return m

    def counter(self, name: str, help: str, **labels) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(
        self, name: str, help: str,
        fn: Callable[[], float] | None = None, **labels,
    ) -> Gauge:
        return self._register(Gauge, name, help, labels, fn=fn)

    def histogram(
        self, name: str, help: str,
        buckets: Iterable[float] = DEFAULT_BUCKETS, **labels,
    ) -> Histogram:
        return self._register(Histogram, name, help, labels, buckets=buckets)

    # -- collection ------------------------------------------------------
    def collect(self) -> "list[object]":
        with self._lock:
            return list(self._metrics.values())

    def family_meta(self) -> dict[str, tuple[str, str]]:
        """name -> (prom type, help)"""
        with self._lock:
            return {
                n: (_TYPES[cls], help)
                for n, (cls, help) in self._families.items()
            }

    def render(self, extra_labels: Mapping[str, str] | None = None) -> str:
        return render_prometheus([(extra_labels or {}, self)])


def snapshot_gauges(
    registry: MetricsRegistry,
    snapshot: Mapping[str, object],
    *,
    prefix: str = "tlink_snapshot_",
    help: str = "remote serving-snapshot value",
    skip: tuple = ("prefix_digest", "host_tier_digest"),
) -> None:
    """Flatten a remote engine's serving snapshot (the dict riding
    GENERATE_RESP) into gauges on ``registry`` — how /metrics exposes an
    engine whose registry lives in another process. Non-numeric leaves
    are skipped; nested dicts flatten with ``_``-joined keys. ``skip``
    names subtrees that must never become gauges — the prefix-cache
    digest's keys are CONTENT HASHES, so flattening it would mint an
    unbounded, never-collected metric family (one per chain ever seen)."""

    def walk(d: Mapping[str, object], path: str):
        for k, v in d.items():
            if k in skip:
                continue
            key = f"{path}{k}"
            if isinstance(v, Mapping):
                walk(v, f"{key}_")
            elif isinstance(v, bool):
                continue
            elif isinstance(v, (int, float)) and math.isfinite(float(v)):
                name = sanitize_metric_name(f"{prefix}{key}")
                registry.gauge(name, help).set(float(v))

    walk(snapshot, "")


def _render_labels(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _escape(v: object) -> str:
    return (
        str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


def render_prometheus(
    groups: "Iterable[tuple[Mapping[str, str], MetricsRegistry]]",
) -> str:
    """Merge registries into one valid Prometheus text exposition.
    ``groups`` pairs per-registry constant labels (e.g. ``{"model":
    name}``) with the registry; HELP/TYPE lines are emitted once per
    family even when several registries share a family name."""
    meta: dict[str, tuple[str, str]] = {}
    by_family: dict[str, list[str]] = {}
    for labels, reg in groups:
        for name, (typ, help) in reg.family_meta().items():
            meta.setdefault(name, (typ, help))
        for metric in reg.collect():
            fam = metric.name  # family name (histogram samples suffix it)
            lines = by_family.setdefault(fam, [])
            for sample_name, sample_labels, value in metric.samples():
                merged = {**sample_labels, **dict(labels)}
                if isinstance(value, float):
                    if math.isnan(value):
                        val = "NaN"
                    elif value == int(value) and abs(value) < 1e15:
                        val = str(int(value))
                    else:
                        val = repr(value)
                else:
                    val = str(value)
                lines.append(
                    f"{sample_name}{_render_labels(merged)} {val}"
                )
    out: list[str] = []
    for fam in sorted(by_family):
        typ, help = meta.get(fam, ("untyped", ""))
        out.append(f"# HELP {fam} {_escape_help(help)}")
        out.append(f"# TYPE {fam} {typ}")
        out.extend(by_family[fam])
    return "\n".join(out) + "\n" if out else ""


def _escape_help(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_BUCKETS",
    "render_prometheus",
    "sanitize_metric_name",
    "snapshot_gauges",
]
