"""Typed metric cells for the serving engine and its scheduler.

A copy of the part of ``tensorlink_tpu/core/metrics.py`` the engine uses:
counters, callback gauges and fixed-bucket histograms registered once in a
:class:`MetricsRegistry`. The engine's ``stats``/``serving_snapshot`` keys
are derived from these cells, exactly as in the JAX package. The
Prometheus exposition stays with the API stack, which a later slice ports.

Threading contract (unchanged): counters follow the single-writer
discipline of their owner (the engine's dispatcher thread, or writes under the
engine lock); histograms take a small lock because ``observe`` may race a
reader on another thread.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Iterable, Mapping

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*$")

DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Counter:
    """Monotonic counter; ``inc`` only."""

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

    def __int__(self) -> int:
        return int(self._value)


class Gauge:
    """Settable value, or a callback gauge (``fn``) read on access."""

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
            return float(self._fn())
        return self._value


class Histogram:
    """Fixed-bucket histogram: per-bucket counts plus ``sum``/``count``."""

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


class MetricsRegistry:
    """A namespace of typed metrics (one per engine; its scheduler shares
    it). Registering an existing (name, labels) pair returns the cell
    already there."""

    def __init__(self):
        self._metrics: dict[tuple[str, tuple], object] = {}  #: guarded by self._lock
        self._families: dict[str, type] = {}  #: guarded by self._lock
        self._lock = threading.Lock()

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
            if fam is not None and fam is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.__name__}"
                )
            existing = self._metrics.get(key)
            if existing is not None:
                return existing
            m = cls(name, help, labels, **kw)
            self._metrics[key] = m
            self._families.setdefault(name, cls)
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

    def collect(self) -> "list[object]":
        with self._lock:
            return list(self._metrics.values())


__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
]
