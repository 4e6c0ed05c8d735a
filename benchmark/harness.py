"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line's contents.

Set-up makes the weights on the device from the seed, builds the
program's serving stack as a worker does (``GenerationEngine`` →
``ContinuousEngine`` → ``ContinuousBatcher``), warms every shape the
serving step runs (one request per slot, prompt pieces of a full and a
part row, sampled and greedy decoding) and prefills what the mix asks
for. Then one client thread per slot calls the batcher's blocking
``generate`` with a stream callback, sending its next request when the
last one returns (a closed loop: the validator routes to a worker by its
free slots). The clients' first requests all arrive at once, so the mix's
``settle_s`` seconds of traffic pass before the window opens (set-up
counts them); the window measures the next ``--seconds``. At its end
every request still queued or in a slot is shed; the program's state is
freed and the reference judges a sample of what the window finished.

The traced run (``trace``) also gives every request a trace id, opens
host spans around the program's layers (``devtrace.Spans``) and profiles
the last part of the window.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import correctness, devtrace, stats
from .flops import Widths
from .generator import Traffic
from .weights import make_params

HERE = Path(__file__).resolve().parent
# the engine's flight ring keeps every chunk record of a window
FLIGHT_CAPACITY = 1 << 16
# the traced run profiles the window's last PROFILE_S seconds at most
PROFILE_S = 4.0
REQUEST_TIMEOUT_S = 300.0
JOIN_TIMEOUT_S = 120.0
# the file's own keys; the rest of a configuration file is the model's
# published config
CONFIG_KEYS = ("source", "reduced", "assumed", "deployment", "engine",
               "reference")


class WindowClosed(RuntimeError):
    """A request shed when the window closed."""


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def hf(self) -> dict:
        return {k: v for k, v in self.config.items() if k not in CONFIG_KEYS}


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    cfg = next(c for c in manifest["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, name)],
    )


def reader(kind: str, name: str):
    """The ``read(rec)`` function of metric ``name``
    (``<kind>/<name>.py``)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _device_info(device: torch.device, count: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}


def _all_done(threads: list[threading.Thread], timeout: float) -> None:
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.0))
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        raise RuntimeError(f"client threads still running: {alive}")


def _concurrently(batcher, reqs) -> None:
    """Serve ``reqs`` at once, one thread each (set-up's warm-up)."""
    errors: list[BaseException] = []

    def one(r):
        try:
            batcher.generate(r.prompt, max_new_tokens=r.max_new_tokens,
                             timeout=REQUEST_TIMEOUT_S, **r.knobs)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(r,), name=f"warm{i}")
               for i, r in enumerate(reqs)]
    for t in threads:
        t.start()
    _all_done(threads, REQUEST_TIMEOUT_S)
    if errors:
        raise errors[0]


def _shed(cont) -> None:
    """Close the engine to new work and fail every queued and resident
    request with :class:`WindowClosed` (on the engine's stepping
    thread)."""
    cont.begin_drain()
    for r in cont.shed_queued():
        cont.fail_queued(r, WindowClosed("the window closed"))
    for s in range(cont.max_slots):
        r = cont.shed_slot(s)
        if r is not None:
            cont.fail_queued(r, WindowClosed("the window closed"))


class _Clients:
    """One closed-loop client thread per slot."""

    def __init__(self, batcher, traffic: Traffic, n: int, trace: bool):
        from tensorlink_tpu_torch.core.trace import get_tracer

        self.batcher, self.traffic, self.trace = batcher, traffic, trace
        self.tracer = get_tracer()
        self.stop = threading.Event()
        self.records: list[dict] = []
        self._lock = threading.Lock()
        self.threads = [threading.Thread(target=self._run, args=(c,),
                                         name=f"client{c}", daemon=True)
                        for c in range(n)]

    def start(self) -> None:
        for t in self.threads:
            t.start()

    def _run(self, c: int) -> None:
        for i, req in enumerate(self.traffic.stream(c)):
            if self.stop.wait(req.think_s):
                return
            times: list[float] = []
            rec = {"client": c, "i": i, "prompt": req.prompt,
                   "prompt_len": len(req.prompt),
                   "max_new": req.max_new_tokens, "greedy": req.greedy,
                   "knobs": req.knobs, "times": times, "tokens": [], "error": None,
                   "cut": False, "spans": []}
            tid = f"bench-{c}-{i}" if self.trace else None

            def cb(toks, times=times):
                times.append(time.monotonic())
                return False

            rec["t_sub"] = time.monotonic()
            try:
                rec["tokens"] = self.batcher.generate(
                    req.prompt, max_new_tokens=req.max_new_tokens,
                    stream_cb=cb, timeout=REQUEST_TIMEOUT_S, trace_id=tid,
                    **req.knobs)
            except Exception as e:  # noqa: BLE001 — recorded, judged later
                rec["cut"] = self.stop.is_set()
                rec["error"] = None if rec["cut"] else repr(e)
            rec["t_done"] = time.monotonic()
            if tid is not None:
                rec["spans"] = self.tracer.collect(tid)
            with self._lock:
                self.records.append(rec)
            if rec["error"] is not None or rec["cut"]:
                return


def _last_step(recorder) -> int:
    recs = recorder.records()
    return recs[-1]["step"] if recs else 0


def _run_window(batcher, cont, clients: _Clients, settle: float,
                seconds: float, spans) -> dict:
    """Start the clients, let the closed loop settle for ``settle``
    seconds (the clients' first requests all arrive at once; by then
    they no longer do), then run the window for ``seconds``; returns the
    window's times, counters, flight records, chunk range and (traced)
    profiler."""
    recorder = cont.recorder
    clients.start()
    time.sleep(settle)
    counters0 = dict(cont.stats)
    step0 = _last_step(recorder)
    k0 = spans._k if spans else 0
    t0 = time.monotonic()
    log(f"window {seconds} s")
    devtr = None
    marks: list = []
    if spans is None:
        time.sleep(max(t0 + seconds - time.monotonic(), 0.0))
        t1 = time.monotonic()
        clients.stop.set()
        counters1 = dict(cont.stats)
        step1 = _last_step(recorder)
        k1 = 0
    else:
        # the profiler is switched on and off on the engine's stepping
        # thread between chunks, never while another thread runs ops
        prof_s = min(PROFILE_S, seconds / 2)
        prof = devtrace.profiler()
        span = torch.profiler.record_function("bench.window")

        def begin(_cont):
            prof.start()
            devtrace.calibrate(marks)
            span.__enter__()

        def end(_cont):
            span.__exit__(None, None, None)
            devtrace.calibrate(marks)
            prof.stop()

        time.sleep(max(t0 + seconds - prof_s - time.monotonic(), 0.0))
        batcher.run_on_driver(begin)
        time.sleep(max(t0 + seconds - time.monotonic(), 0.0))
        batcher.run_on_driver(end)
        t1 = time.monotonic()
        clients.stop.set()
        counters1 = dict(cont.stats)
        step1 = _last_step(recorder)
        k1 = spans._k
        devtr = prof
    flight = [r for r in recorder.records() if step0 < r["step"] <= step1]
    batcher.run_on_driver(_shed)
    _all_done(clients.threads, JOIN_TIMEOUT_S)
    return {"window": (t0, t1), "counters": {"start": counters0,
                                             "end": counters1},
            "flight_all": flight, "chunks": (k0, k1), "prof": devtr,
            "marks": marks}


def run(cell: Cell, *, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, control: bool = False
        ) -> dict:
    """One run; returns the result line's fields (without the JAX check,
    which the entry point makes last)."""
    from tensorlink_tpu_torch.engine.continuous import ContinuousEngine
    from tensorlink_tpu_torch.engine.generate import GenerationEngine
    from tensorlink_tpu_torch.ml.batching import ContinuousBatcher
    from tensorlink_tpu_torch.models.registry import config_from_hf

    hf, eng = cell.hf, cell.config["engine"]
    widths = Widths.from_hf(hf)
    # the type the configuration is served in
    dtype = getattr(torch, hf.get("torch_dtype", "bfloat16"))
    t = time.monotonic()
    params = make_params(widths, hf["model_type"], seed, device, dtype)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"weights {time.monotonic() - t:.2f} s")
    if trace:
        # the profiler's first start initialises it for seconds: in
        # set-up, on this thread, before the engine's thread exists
        warm = devtrace.profiler()
        warm.start()
        warm.stop()
    gen = GenerationEngine(config_from_hf(hf, dtype=dtype), params,
                           max_seq_len=int(eng["max_seq_len"]),
                           quant="int8+kv" if control else None,
                           device=device)
    cont = ContinuousEngine(
        gen, max_slots=int(eng["max_slots"]), page_size=int(eng["page_size"]),
        chunk_steps=int(eng["chunk_steps"]),
        prefill_chunk=int(eng["prefill_chunk"]),
        prefix_cache=bool(eng["prefix_cache"]),
        kv_quant=str(eng["kv_quant"]), flight_capacity=FLIGHT_CAPACITY)
    batcher = ContinuousBatcher(engine=cont, seed=int(seed) % (1 << 30))
    n = int(eng["max_slots"])
    traffic = Traffic(cell.traffic, widths.vocab, n, seed)
    t = time.monotonic()
    C = int(eng["prefill_chunk"])
    _concurrently(batcher, traffic.warmup_requests(C + C // 2,
                                                   2 * int(eng["chunk_steps"])))
    log(f"warm-up {time.monotonic() - t:.2f} s ({cont.chunks} chunks)")
    pre = traffic.prewarm_prompts()
    if pre:
        t = time.monotonic()
        from .generator import Request
        _concurrently(batcher, [Request(prompt=p, max_new_tokens=1,
                                        greedy=True) for p in pre])
        log(f"prefilled {len(pre)} prompts {time.monotonic() - t:.2f} s")
    spans = None
    if trace:
        spans = devtrace.Spans(cont, int(eng["page_size"]))
    clients = _Clients(batcher, traffic, n, trace)
    settle = float(cell.traffic.get("settle_s", 0.0))
    log(f"set-up {time.monotonic() - t_start:.2f} s before {settle} s of "
        f"settling traffic")
    win = _run_window(batcher, cont, clients, settle, seconds, spans)
    setup_s = win["window"][0] - t_start
    dev = _device_info(device, 1)
    batcher.close()
    if spans is not None:
        spans.restore()
    del batcher, cont, gen
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    rec = {
        "cell": cell.name, "setup_s": setup_s, "window": win["window"],
        "requests": clients.records, "counters": win["counters"],
        "flight": win["flight_all"], "widths": widths,
    }
    fl = win["flight_all"]
    hits = stats.counter_delta(rec, "prefill_tokens_skipped")
    log(f"window: {len(fl)} chunks, chunk_ms "
        f"{sum(f['chunk_ms'] for f in fl) / max(len(fl), 1):.2f}, host_ms "
        f"{sum(f['host_ms'] for f in fl) / max(len(fl), 1):.3f}, prompt "
        f"tokens {hits} cached of "
        f"{hits + stats.counter_delta(rec, 'prefill_tokens')}")
    breakdown = None
    if spans is not None:
        k0, k1 = win["chunks"]
        rec["packs"] = spans.packs
        rec["window_packs"] = [spans.packs[k] for k in range(k0 + 1, k1 + 1)
                               if spans.packs.get(k)]
        t = time.monotonic()
        rec["devtrace"] = devtrace.reduce_prof(win["prof"], spans.log,
                                               win["marks"])
        log(f"trace reduced {time.monotonic() - t:.2f} s")
        dev["busy_s"] = rec["devtrace"]["busy_s"]
        dev["window_s"] = rec["devtrace"]["window_s"]
        breakdown = {"device_ops": rec["devtrace"]["device_ops"],
                     "idle_gaps": rec["devtrace"]["idle_gaps"]}
    metrics = {}
    for kind, entries in (("per_layer", cell.per_layer) if trace
                          else ("end_to_end", cell.end_to_end),):
        folder = "layer_metrics" if kind == "per_layer" else "e2e_metrics"
        for m in entries:
            v = reader(folder, m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    reqs = clients.records
    t0, t1 = win["window"]
    in_window = [r for r in reqs if t0 <= r["t_sub"] <= t1]
    failed = sum(1 for r in reqs if r["error"] is not None)
    bad = correctness.output_faults(reqs, widths.vocab)
    samp = cell.limits.get("sample", {})
    t = time.monotonic()
    # the requests the window finished (the shed ones are not finished)
    done = [r for r in reqs if r["t_done"] >= t0]
    picks = [r for greedy in (True, False)
             for r in correctness.pick(done, seed,
                                       int(samp.get("target_tokens", 400)),
                                       int(samp.get("max_requests", 12)),
                                       greedy)]
    per_token = correctness.gaps(hf, params, picks)
    gstats = correctness.gap_stats(per_token,
                                  cell.limits.get("router_margin"))
    log(f"reference over {len(picks)} requests, {per_token['gap'].size} "
        f"tokens: {time.monotonic() - t:.2f} s")
    ok, checks = correctness.judge(cell.limits, gstats, failed, bad,
                                   int(samp.get("min_tokens", 200)))
    out = {"correct": ok, "attempted": len(in_window), "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["gap_stats"] = gstats
    out["checks"] = checks
    return out
