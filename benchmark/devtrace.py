"""The traced run's instruments: host spans around the program's layers,
the profiler over a steady part of the window, and the reduction of its
trace to the numbers the per-layer readers take.

Spans are timed by the benchmark around calls into the program (it wraps
them for the traced run only; the untraced run calls the program as it
is), on the thread that steps the engine:

- ``engine.step_chunk``, ``engine.admit``, ``engine.pack``: the slot
  engine's chunk, its admission round and its packing of the slot table;
- ``paged.step#<k>``: chunk ``k``'s call of the serving step (the launch
  of every kernel of the chunk; the host sync follows it);
- ``paged.ragged_pass``, ``paged.decode_step``, ``sampler``,
  ``moe_block``: the ragged prefill+decode pass, one decode-continuation
  step, the sampler, a MoE block;
- ``tl_ragged_paged_attention``, ``tl_paged_attention``: the wrappers
  that launch the two CUDA attention kernels.

The profiler runs on the main thread and records the card's activity and
every thread's CUDA calls; each kernel is tied to the launch call the
profiler correlates it with, and that call to the spans open on its
thread at the time. The spans' clock (``time.monotonic_ns``) is mapped
onto the trace's by short ``bench.cal`` ranges the main thread opens at
the start and at the end of the profiled part. The trace is reduced in
this process and deleted.
"""

from __future__ import annotations

import bisect
import functools
import json
import os
import tempfile
import time

import torch

KERNEL_SPANS = ("tl_ragged_paged_attention", "tl_paged_attention")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
CAL_N = 32


class Spans:
    """Wraps the program's layer entry points in timed spans (``log``:
    ``(name, start_ns, end_ns)`` in the order they close) and keeps each
    chunk's slot table (``packs[k]``, the host arrays the engine packed
    for chunk ``k``)."""

    def __init__(self, engine, page_size: int):
        from tensorlink_tpu_torch.engine import paged
        from tensorlink_tpu_torch.models import transformer

        self.packs: dict[int, dict] = {}
        self.log: list[tuple[str, int, int]] = []
        self._pending = None
        self._k = 0
        eng = engine
        pack, step, n_steps = eng._pack_ragged, eng._step, eng.chunk_steps

        def pack_fn():
            out = pack()
            if out is not None:
                _blk, starts, n_valid, _n_spec, emit, remaining = out[:6]
                self._pending = {
                    "page": int(page_size), "n_steps": int(n_steps),
                    "starts": starts.tolist(), "n_valid": n_valid.tolist(),
                    "emit": emit.tolist(), "remaining": remaining.tolist(),
                }
            return out

        def step_fn(*a, **kw):
            self._k += 1
            self.packs[self._k] = self._pending
            return self._timed(f"paged.step#{self._k}", step)(*a, **kw)

        eng._pack_ragged = self._timed("engine.pack", pack_fn)
        eng._step = step_fn
        eng._admit = self._timed("engine.admit", eng._admit)
        eng.step_chunk = self._timed("engine.step_chunk", eng.step_chunk)
        self._saved = []
        for mod, attr, name in (
            (paged, "ragged_paged_attention", KERNEL_SPANS[0]),
            (paged, "paged_attention", KERNEL_SPANS[1]),
            (paged, "paged_decode_step", "paged.decode_step"),
            (paged, "_sample_rows", "sampler"),
            (transformer, "_moe_mlp", "moe_block"),
            (paged._Whole, "ragged", "paged.ragged_pass"),
        ):
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, self._timed(name, orig))

    def _timed(self, name: str, fn):
        log, clock = self.log, time.monotonic_ns

        @functools.wraps(fn)
        def inner(*a, **kw):
            t0 = clock()
            try:
                return fn(*a, **kw)
            finally:
                log.append((name, t0, clock()))
        return inner

    def restore(self) -> None:
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved = []


def profiler():
    """A profiler of the card's activity and the CUDA calls of every
    thread (host ops of the thread that starts it)."""
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def calibrate(marks: list) -> None:
    """Open :data:`CAL_N` ``bench.cal`` ranges, noting the span clock
    just before and after each opens (``marks``)."""
    for _ in range(CAL_N):
        a = time.monotonic_ns()
        rf = torch.profiler.record_function("bench.cal")
        rf.__enter__()
        b = time.monotonic_ns()
        rf.__exit__(None, None, None)
        marks.append((a, b))


def reduce_prof(prof, log: list, marks: list) -> dict:
    """:func:`reduce_trace` of a stopped profiler's trace, written to a
    temporary file, read back and deleted."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce_trace(events, log, marks)


def _offsets(events: list[dict], marks: list) -> tuple:
    """``(t_a, o_a, t_b, o_b)``: the trace clock minus the span clock
    (us) at span-clock times ``t_a`` and ``t_b``, from the first and the
    last :data:`CAL_N` calibration ranges; each offset is the middle of
    the interval every range of its group allows."""
    cal = sorted((e for e in events if e.get("name") == "bench.cal"
                  and e.get("ph") == "X"), key=lambda e: e["ts"])
    if len(cal) != len(marks) or len(marks) < 2 * CAL_N:
        raise RuntimeError(f"{len(cal)} calibration ranges in the trace, "
                           f"{len(marks)} noted")
    out = []
    for grp in (slice(0, CAL_N), slice(len(marks) - CAL_N, len(marks))):
        lo = max(e["ts"] - b / 1e3 for e, (a, b) in zip(cal[grp], marks[grp]))
        hi = min(e["ts"] - a / 1e3 for e, (a, b) in zip(cal[grp], marks[grp]))
        out += [marks[grp][0][0] / 1e3, (lo + hi) / 2]
    return tuple(out)


def _base(name: str) -> str:
    return name.split("#", 1)[0]


class _Stacks:
    """Nested host spans of one thread, queried by time: the innermost
    span that contains ``t``."""

    def __init__(self, spans: list[dict]):
        spans = sorted(spans, key=lambda e: (e["ts"], -e["dur"]))
        self.starts = [e["ts"] for e in spans]
        self.spans = spans
        self.parent: list[int] = []
        stack: list[int] = []
        for i, e in enumerate(spans):
            while stack and spans[stack[-1]]["ts"] + spans[stack[-1]]["dur"] < e["ts"]:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def chain(self, t: float) -> list[dict]:
        """Every span containing ``t``, innermost first."""
        i = bisect.bisect_right(self.starts, t) - 1
        out = []
        while i >= 0:
            e = self.spans[i]
            if e["ts"] <= t <= e["ts"] + e["dur"]:
                out.append(e)
            i = self.parent[i]
        return out


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_trace(events: list[dict], log: list, marks: list) -> dict:
    """The traced window's device numbers from a Chrome trace's events
    and the span log (times in microseconds there, seconds here):

    - ``window_s`` and ``busy_s``: the ``bench.window`` range's length and
      the union of device activity inside it;
    - ``device_ops``: device seconds by kernel name, most first;
    - ``idle_gaps``: device idle seconds inside the window by the
      innermost span open on the stepping thread at the gap's middle
      (``host`` where none was), most first;
    - ``chunks``: for each chunk ``k`` whose step and host sync both lie
      inside the window, the device seconds and activity count of the
      kernels each span in :data:`KERNEL_SPANS` launched.
    """
    window = [e for e in events if e.get("name") == "bench.window"
              and e.get("ph") == "X"]
    if not window:
        raise RuntimeError("the trace holds no bench.window range")
    w0 = window[0]["ts"]
    w1 = w0 + window[0]["dur"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in _DEVICE_CATS]
    if not any(e.get("cat") == "kernel" for e in dev):
        raise RuntimeError("the trace holds no device kernel")
    t_a, o_a, t_b, o_b = _offsets(events, marks)
    slope = (o_b - o_a) / (t_b - t_a) if t_b > t_a else 0.0

    def to_trace(ns: int) -> float:
        us = ns / 1e3
        return us + o_a + slope * (us - t_a)

    spans = [{"name": n, "ts": to_trace(a), "dur": (b - a) / 1e3}
             for n, a, b in log]
    stack = _Stacks(spans)
    launches = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in _LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e

    # chunks complete inside the window: step span starts after w0, and
    # the enclosing engine.step_chunk (which ends with the host sync)
    # ends before w1
    complete = set()
    for e in stack.spans:
        if e["name"].startswith("paged.step#") and e["ts"] >= w0:
            outer = [p for p in stack.chain(e["ts"])
                     if p["name"] == "engine.step_chunk"]
            if outer and outer[0]["ts"] + outer[0]["dur"] <= w1:
                complete.add(int(e["name"].split("#", 1)[1]))
    chunks: dict[int, dict] = {k: {n: 0.0 for n in KERNEL_SPANS}
                               | {n + ".n": 0 for n in KERNEL_SPANS}
                               for k in complete}
    ops: dict[str, float] = {}
    busy = []
    for k in dev:
        a, b = k["ts"], k["ts"] + k["dur"]
        if b <= w0 or a >= w1:
            continue
        busy.append((max(a, w0), min(b, w1)))
        ops[k["name"]] = ops.get(k["name"], 0.0) + (min(b, w1) - max(a, w0))
        src = launches.get((k.get("args") or {}).get("correlation"))
        if src is None:
            continue
        names = [c["name"] for c in stack.chain(src["ts"] + src["dur"] / 2)]
        step = next((n for n in names if n.startswith("paged.step#")), None)
        span = next((n for n in names if n in KERNEL_SPANS), None)
        if step is not None and span is not None:
            kk = int(step.split("#", 1)[1])
            if kk in chunks:
                chunks[kk][span] += k["dur"] * 1e-6
                chunks[kk][span + ".n"] += 1
    merged = _union(busy)
    busy_s = sum(b - a for a, b in merged) * 1e-6
    gaps: dict[str, float] = {}
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        chain = stack.chain((a + b) / 2)
        name = _base(chain[0]["name"]) if chain else "host"
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_s,
        "device_ops": [[n, s * 1e-6] for n, s in top],
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()),
                            key=lambda x: -x[1])[:10],
        "chunks": chunks,
    }
