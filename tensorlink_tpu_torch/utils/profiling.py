"""Profiling and memory diagnostics (port of
``tensorlink_tpu/utils/profiling.py``).

``trace`` captures the enclosed block with ``torch.profiler``: host
activity always, and the card's kernels when a card is present, written
as a Chrome trace (``trace.json``, viewable in Perfetto or
chrome://tracing) into ``log_dir``. ``annotate`` names a region inside
it, ``device_memory`` reports the card's live, peak and total bytes, and
``StepTimer`` times steps with a warm-up skip.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[Any]:
    """Capture a trace of the enclosed block::

        with profiling.trace("logs/trace") as prof:
            engine.generate_compiled(...)

    Yields the ``torch.profiler.profile`` (its ``events()`` and
    ``key_averages()`` are there once the block ends); the Chrome trace
    lands in ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace (shows up on the trace timeline)."""
    with torch.profiler.record_function(name):
        yield


def device_memory() -> list[dict[str, Any]]:
    """Per-device memory: bytes in use, peak bytes in use and the card's
    total, from the caching allocator's statistics and
    ``torch.cuda.mem_get_info``. The host, when no card is visible,
    reports ``None`` for each, as the JAX version's CPU backend does."""
    if not torch.cuda.is_available():
        return [{"device": "cpu", "platform": "cpu", "bytes_in_use": None,
                 "peak_bytes_in_use": None, "bytes_limit": None}]
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _free, total = torch.cuda.mem_get_info(i)
        out.append({
            "device": f"cuda:{i}",
            "platform": "gpu",
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": total,
        })
    return out


class StepTimer:
    """Wall-clock step timing with warmup skip — the number bench.py
    reports (compile time excluded the same way everywhere)."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: list[float] = []
        self._n = 0

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    @property
    def p50(self) -> float:
        if not self.times:
            return float("nan")
        s = sorted(self.times)
        return s[len(s) // 2]
