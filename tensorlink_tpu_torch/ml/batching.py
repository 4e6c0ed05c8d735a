"""Request scheduling for the serving path (port of
``tensorlink_tpu/ml/batching.py``).

:class:`ContinuousBatcher` — continuous batching, in two modes:

- ``engine=`` (a ``GenerationEngine`` or ``ContinuousEngine`` of this
  package): drives the local slot engine on one dispatcher thread. Client
  threads call the blocking :meth:`ContinuousBatcher.generate`, each
  request joins the running slot batch within one chunk, and a finished
  request frees its KV at once. Stepping-thread work (migration verbs,
  prefix pulls, weight publishes) reaches the engine through
  :meth:`ContinuousBatcher.run_on_driver` between chunks, and a background
  hook (:meth:`set_background`) runs there too.
- ``model=`` a single-stage ``DistributedModel``: a pass-through. Each
  request RPCs the worker with ``continuous=True`` and the worker's slot
  engine co-batches concurrent requests (the validator's hosted models).
- ``model=`` a pipelined ``DistributedModel``: a
  :class:`PipelinedSlotSession` on the dispatcher thread admits requests
  into the rows of one decode session that spans every stage worker,
  and re-establishes it on repaired workers when a stage dies.

:class:`GenBatcher` — the static batcher for models the paged engine
refuses: requests coalesce over a short window into one batched
``model.generate`` that runs to completion.

"""

from __future__ import annotations

import itertools
import logging
import queue
import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from ..core.metrics import MetricsRegistry
from ..core.trace import get_tracer
from ..engine.continuous import ContinuousEngine
from ..engine.sampling import SamplingParams
from ..engine.scheduler import (
    DEFAULT_PRIORITY,
    PRIORITY_RANK,
    normalize_priority,
)


@dataclass
class _Pending:
    ids: list[int]
    max_new_tokens: int
    temperature: float
    top_k: int
    top_p: float
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # prompt-lookup decode wish (the static batcher, greedy B=1 only):
    # honored when the request dispatches alone; the tokens are the same
    lookahead: bool = False
    # opts into draft/verify decoding on a spec_decode engine (the stream
    # is the same either way)
    speculative: bool = False
    done: threading.Event = field(default_factory=threading.Event)
    stream_cb: Callable[[list[int]], None] | None = None
    result: list[int] | None = None
    error: BaseException | None = None
    seed: int = 0
    priority: str | None = None
    trace_id: str = ""
    submit_t: float = 0.0
    eos_ids: list[int] = field(default_factory=list)


def _headroom_from(snap: dict) -> dict:
    """The per-replica headroom fields of a ``router_snapshot``."""
    return {
        k: snap[k]
        for k in ("slots_free", "kv_pages_free", "queue_depth", "draining")
    }


class GenBatcher:
    """One per hosted model; owns the model's generation serialization."""

    def __init__(
        self,
        model: Any,  # DistributedModel (or anything with .generate/.plan)
        eos_ids: list[int],
        *,
        max_batch: int = 8,
        window_s: float = 0.01,
        seed: int = 0,
        queue_cap: int = 256,
    ):
        self.model = model
        self.eos_ids = list(eos_ids)
        self.max_batch = max_batch
        self.window_s = window_s
        self.seed = seed
        self.queue_cap = int(queue_cap)
        self._q: queue.Queue[_Pending | None] = queue.Queue()
        self._seq = 0
        self._closed = False  #: guarded by self._submit_lock
        self._submit_lock = threading.Lock()  # orders submits vs close()
        self._stats_lock = threading.Lock()
        # dispatch stats: typed counters (core/metrics.py) plus the
        # bounded sample window stats() derives its batch shape from
        self.metrics = MetricsRegistry()
        self._m_requests = self.metrics.counter(
            "tlink_batcher_requests_total", "requests dispatched",
            mode="static",
        )
        self._m_dispatches = self.metrics.counter(
            "tlink_batcher_dispatches_total", "batched dispatches issued",
            mode="static",
        )
        self.batch_sizes: deque[int] = deque(maxlen=1000)  #: guarded by self._stats_lock
        self._thread = threading.Thread(
            target=self._loop, name="gen-batcher", daemon=True
        )
        self._thread.start()

    # -- client side -----------------------------------------------------
    def generate(
        self,
        ids: list[int],
        *,
        max_new_tokens: int,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        stream_cb: Callable[[list[int]], None] | None = None,
        timeout: float = 600.0,
        lookahead: bool = False,
        speculative: bool = False,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
        priority: str | None = None,
        trace_id: str | None = None,
        handoff: bool = True,
        jrid: str = "",
    ) -> list[int]:
        """Blocking submit; returns this request's generated ids.
        ``stream_cb`` receives this request's new tokens as they decode.
        ``priority``, ``speculative``, ``handoff``, and ``jrid`` are
        accepted for API symmetry with the continuous scheduler; the
        windowed batcher itself stays FCFS and decodes vanilla
        (speculation, the prefill→decode handoff, and journal re-attach
        are paged-engine features — all pure hints, streams identical
        either way).
        ``trace_id`` (core/trace.py) records the window-wait +
        batched-decode span."""
        req = _Pending(
            ids=list(ids), max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), stream_cb=stream_cb,
            presence_penalty=float(presence_penalty),
            frequency_penalty=float(frequency_penalty),
            # speculation emits exactly vanilla greedy — penalties change
            # greedy's choices, so a penalized request takes the normal loop
            lookahead=bool(lookahead) and float(temperature) == 0.0
            and not presence_penalty and not frequency_penalty,
            trace_id=str(trace_id or ""),
        )
        req.submit_t = time.monotonic()
        # check-and-put under the lock close() drains under — a submit
        # racing close() must either land before the sentinel or fail fast,
        # never sit in a dead queue until the timeout
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("model is being unhosted")
            self._q.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("generation timed out in the batcher")
        if req.trace_id:
            # the static batcher has no admission seam to decompose — one
            # span covers window-wait + the run-to-completion batch
            get_tracer().record(
                req.trace_id, "static_batch", site="batcher",
                dur_s=time.monotonic() - req.submit_t,
                tokens=len(req.result or ()),
            )
        if req.error is not None:
            raise req.error
        return req.result or []

    def admission_check(self, priority=None, n: int = 1) -> dict | None:
        """Flat backpressure for the windowed batcher: reject when the
        dispatch queue is deeper than ``queue_cap``. Classes don't
        reorder anything here (FCFS), but the API layer's 429 +
        Retry-After contract is shared with the continuous scheduler."""
        depth = self._q.qsize()
        if depth + n > self.queue_cap:
            return {
                "priority": str(priority or "interactive"),
                "queue_depth": depth,
                "cap": self.queue_cap,
                "retry_after": max(1.0, min(depth * 0.5, 600.0)),
            }
        return None

    def router_snapshot(self) -> dict:
        """Fleet-router scoring view (docs/SERVING.md "Fleet serving").
        The windowed batcher has no paged engine behind it: no digest,
        no per-class queues — the flat dispatch depth stands in for
        every class so a fleet mixing batcher kinds still balances."""
        depth = self._q.qsize()
        return {
            "draining": False,
            "worker_role": "mixed",
            "max_slots": self.max_batch,
            "slots_free": max(self.max_batch - depth, 0),
            "kv_pages_free": 0,
            "kv_pages_total": 0,
            "service_ewma_s": 0.0,
            "queue_depth": {c: depth for c in PRIORITY_RANK},
            "prefix_digest": {},
        }

    def headroom(self) -> dict:
        """The /healthz per-replica headroom fields — cheap, no ML
        round trip (the same contract as health_snapshot)."""
        return _headroom_from(self.router_snapshot())

    def close(self, timeout: float = 600.0) -> None:
        """Serve everything already queued, then stop. Blocks until the
        dispatcher drains (unhost must not tear the model down under an
        in-flight batched decode); anything enqueued after the sentinel
        (submit/close race) is failed fast rather than left hanging."""
        with self._submit_lock:
            self._closed = True
            self._q.put(None)
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            # the dispatcher is still driving a decode on this model; the
            # caller is about to shut the model down under it — say so
            # instead of silently proceeding
            logging.getLogger("tensorlink_tpu_torch.ml.batching").warning(
                "GenBatcher.close(): dispatcher did not drain within %.0fs; "
                "a batched decode may still be in flight", timeout,
            )
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.error = RuntimeError("model is being unhosted")
                req.done.set()

    # -- dispatcher ------------------------------------------------------
    def _take_batch(self) -> list[_Pending] | None:
        head = self._q.get()
        if head is None:
            return None
        batch = [head]
        if self.max_batch > 1:
            # bounded wait: collect whatever arrives in the window
            t0 = time.monotonic()
            while len(batch) < self.max_batch:
                remaining = self.window_s - (time.monotonic() - t0)
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._q.put(None)  # re-post the shutdown sentinel
                    break
                batch.append(nxt)
        return batch

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                self._run(batch)
            except BaseException as e:  # noqa: BLE001 — fan the error out
                for r in batch:
                    r.error = e
                    r.done.set()

    def stats(self) -> dict | None:
        """Dispatch stats snapshot, safe against the dispatcher's appends
        (iterating a deque mutated concurrently raises RuntimeError)."""
        with self._stats_lock:
            sizes = list(self.batch_sizes)
        if not sizes:
            return None
        return {
            "dispatches": len(sizes),
            "requests": sum(sizes),
            "mean_batch": round(sum(sizes) / len(sizes), 2),
            "max_batch": max(sizes),
        }

    def _run(self, batch: list[_Pending]) -> None:
        self._m_dispatches.inc()
        self._m_requests.inc(len(batch))
        with self._stats_lock:
            self.batch_sizes.append(len(batch))
        budgets = [r.max_new_tokens for r in batch]
        emitted_counts = [0] * len(batch)

        def demux(emitted: list[int | None]) -> list[int]:
            # returns rows to CANCEL: a request's stream_cb may return
            # truthy (confirmed stop-sequence match) — the decode loop
            # freezes that row (host-driven paths) or the drain stops
            # forwarding it (compiled-loop paths)
            cancel: list[int] = []
            for i, r in enumerate(batch):
                if i < len(emitted) and emitted[i] is not None:
                    if emitted_counts[i] < budgets[i] and r.stream_cb:
                        if r.stream_cb([int(emitted[i])]):
                            cancel.append(i)
                    emitted_counts[i] += 1
            return cancel

        any_stream = any(r.stream_cb for r in batch)
        self._seq += 1
        if len(batch) == 1 and batch[0].lookahead:
            # quiet moment + speculative wish: run the prompt-lookup decode
            # (greedy B=1; same tokens as vanilla, fewer model passes)
            r = batch[0]
            seqs = self.model.generate(
                [r.ids],
                max_new_tokens=budgets[0],
                temperature=0.0,
                eos_ids=self.eos_ids,
                stream_cb=demux if any_stream else None,
                lookahead=True,
            )
            r.result = [int(t) for t in seqs[0][: budgets[0]]]
            r.done.set()
            return
        seqs = self.model.generate(
            [r.ids for r in batch],
            max_new_tokens=max(budgets),
            temperature=[r.temperature for r in batch],
            top_k=[r.top_k for r in batch],
            top_p=[r.top_p for r in batch],
            presence_penalty=[r.presence_penalty for r in batch],
            frequency_penalty=[r.frequency_penalty for r in batch],
            eos_ids=self.eos_ids,
            seed=self.seed + self._seq,
            stream_cb=demux if any_stream else None,
            budgets=budgets,
        ) if self.max_batch > 1 else self.model.generate(
            [batch[0].ids],
            max_new_tokens=budgets[0],
            temperature=batch[0].temperature,
            top_k=batch[0].top_k,
            top_p=batch[0].top_p,
            presence_penalty=batch[0].presence_penalty,
            frequency_penalty=batch[0].frequency_penalty,
            eos_ids=self.eos_ids,
            seed=self.seed + self._seq,
            stream_cb=demux if any_stream else None,
        )
        for i, r in enumerate(batch):
            r.result = [int(t) for t in seqs[i][: budgets[i]]]
            r.done.set()


class PipelinedSlotSession:
    """Slot admission for a pipelined (multi-stage) job through the
    session path: one decode session of ``B = max_slots`` rows across
    every stage worker. A queued request is admitted into a free row by a
    masked prefill op (only its row's tokens carry the attention mask, so
    the neighbours' caches don't move); a finished row is recycled by
    zeroing its write offset on every stage (``reset_rows`` rides the next
    op) — the dense session's counterpart of freeing KV pages.

    Every op carries the session's increasing ``seq`` (the workers dedup
    it, so retries and duplicated frames are idempotent), and a lost stage
    worker triggers repair and a re-prefill of each live row's prompt +
    emitted tokens under a fresh session. Sampling is per row and
    stateless — ``fold_in(PRNGKey(seed_r), n)`` for row r's nth token —
    so co-residency and recovery leave every stream unchanged.

    One dispatcher thread calls ``pump``/``step``."""

    MAX_RECOVERIES = 3

    def __init__(self, model: Any, *, max_slots: int = 4):
        self.model = model
        self.B = int(max_slots)
        self.cache_len = int(model.spec["seq_len"])
        self.session = secrets.token_hex(8)
        self.seq = 0
        self.slots: list[dict | None] = [None] * self.B
        self.queue: deque = deque()
        self.reset_rows: set[int] = set()
        self.recoveries = 0

    # -- helpers ---------------------------------------------------------
    def _live(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    @property
    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _samp(self) -> dict:
        def rows(key, fill):
            return [(s[key] if s is not None else fill) for s in self.slots]

        return {
            "temperature": rows("temperature", 0.0),
            "top_k": rows("top_k", 0),
            "top_p": rows("top_p", 1.0),
            "seeds": rows("seed", 0),
            "steps": rows("step", 0),
        }

    def _emit(self, slot: dict, tok: int) -> bool:
        """Deliver one token to a slot's request; True when it finished."""
        req: _Pending = slot["req"]
        slot["emitted"].append(tok)
        slot["step"] += 1
        cancel = False
        if req.stream_cb is not None:
            cancel = bool(req.stream_cb([tok]))
        return (
            cancel
            or tok in slot["eos"]
            or len(slot["emitted"]) >= slot["budget"]
        )

    def _finish_row(self, row: int) -> None:
        slot = self.slots[row]
        self.slots[row] = None
        self.reset_rows.add(row)
        req: _Pending = slot["req"]
        req.result = [int(t) for t in slot["emitted"][: req.max_new_tokens]]
        req.done.set()

    def _apply_step_tokens(self, tok, rows: list[int]) -> None:
        for r in rows:
            slot = self.slots[r]
            if slot is None:
                continue
            slot["last_tok"] = int(tok[r])
            if self._emit(slot, int(tok[r])):
                self._finish_row(r)

    def _forward(self, **kw):
        """One session op with in-flight recovery. When a stage worker
        died (SessionLost), the whole slot set re-establishes — the rows
        this op was admitting too, their slots being placed already — and
        the re-prefill advances every live row one token, so the lost op
        is subsumed: the caller gets ``None`` and must not re-apply."""
        from .module import SessionLost, _transportish

        try:
            out = self.model.forward(
                session=self.session, cache_len=self.cache_len,
                seq=self.seq, **kw,
            )
            self.seq += 1
            self.reset_rows.clear()  # applied by this op
            # a clean op ends a recovery episode: the budget bounds
            # CONSECUTIVE failures, not a long-lived session's lifetime
            self.recoveries = 0
            return out
        except Exception as e:
            recoverable = isinstance(e, SessionLost) or _transportish(e)
            if not recoverable or self.recoveries >= self.MAX_RECOVERIES:
                raise
            # the re-establishment may itself hit a transient failure
            # while the mesh churns: retry within the same budget
            while True:
                self.recoveries += 1
                try:
                    self._reestablish()
                    return None
                except Exception as e2:
                    still = (isinstance(e2, SessionLost)
                             or _transportish(e2)
                             or "no connection" in str(e2))
                    if not still or self.recoveries >= self.MAX_RECOVERIES:
                        raise

    def _reestablish(self) -> None:
        """Repair the dead stages and re-prefill every live row's prompt +
        emitted tokens under a FRESH session id. Each row's sampled token
        at its last position is exactly its next pending draw (the keys
        are stateless in the step), so streams resume with no duplicated
        and no missing tokens."""
        import numpy as np

        self.model._repair_dead_stages()
        self.model._end_decode_session(self.session)
        self.session = secrets.token_hex(8)
        self.seq = 0
        self.reset_rows.clear()
        rows = self._live()
        if not rows:
            return
        seqs = {
            r: self.slots[r]["prompt"] + self.slots[r]["emitted"]
            for r in rows
        }
        T = max(len(v) for v in seqs.values())
        toks = np.zeros((self.B, T), np.int32)
        mask = np.zeros((self.B, T), bool)
        last_idx = np.zeros((self.B,), np.int32)
        for r, ids in seqs.items():
            toks[r, : len(ids)] = ids
            mask[r, : len(ids)] = True
            last_idx[r] = len(ids) - 1
        tok = self.model.forward(
            toks, mask, session=self.session, cache_len=self.cache_len,
            sample=self._samp(), last_idx=last_idx, seq=0,
        )
        self.seq = 1
        self._apply_step_tokens(tok, rows)

    # -- the dispatcher's API --------------------------------------------
    def submit(self, req: _Pending) -> None:
        self.queue.append(req)

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self._live())

    def pump(self) -> None:
        """Admit queued requests into free rows. The admission op's masked
        ``[B, T]`` write lands at every LIVE row's offset too (invisible
        past its length); a row within ``T`` of the cache end would see
        that write clamp back over real KV, so admission waits until such
        rows finish (bounded: their budgets are capped by their room)."""
        while self.queue:
            free = self.free_slots
            if not free:
                return
            group: list[_Pending] = []
            # class-ordered admission, FIFO within a class
            ordered = sorted(
                self.queue,
                key=lambda r: PRIORITY_RANK.get(r.priority or "", 0),
            )
            for req in ordered[: len(free)]:
                eff = min(req.max_new_tokens, self.cache_len - len(req.ids))
                if eff <= 0:
                    # no room: an empty completion, as the static paths
                    self.queue.remove(req)
                    req.result = []
                    req.done.set()
                    continue
                group.append(req)
            if not group:
                continue
            live_max = max(
                (len(s["prompt"]) + len(s["emitted"])
                 for s in self.slots if s is not None),
                default=0,
            )
            # drop the LONGEST prompts until the op's write span is safe;
            # the shorter ones admit now, the rest wait for evictions
            while group:
                longest = max(group, key=lambda r: len(r.ids))
                if live_max + len(longest.ids) <= self.cache_len:
                    break
                group.remove(longest)
            if not group:
                return
            for req in group:
                self.queue.remove(req)
            self._admit_group(group)

    def _admit_group(self, group: list[_Pending]) -> None:
        """One masked prefill op admits the whole group and emits each
        member's first token."""
        import numpy as np

        placed: list[tuple[int, _Pending]] = []
        for req in group:
            row = self.free_slots[0]
            self.slots[row] = {
                "req": req,
                "prompt": [int(t) for t in req.ids],
                "emitted": [],
                "budget": min(req.max_new_tokens,
                              self.cache_len - len(req.ids)),
                "eos": set(req.eos_ids),
                "seed": req.seed,
                "step": 0,
                "last_tok": 0,
                "temperature": req.temperature,
                "top_k": req.top_k,
                "top_p": req.top_p,
            }
            placed.append((row, req))
        # a recycled row re-admitted now stays in the reset list: the op
        # zeroes its stale offset BEFORE the prefill's writes land
        recycled = sorted(self.reset_rows)
        now = time.monotonic()
        for row, req in placed:
            if req.trace_id:
                get_tracer().record(
                    req.trace_id, "queue_wait", site="pipeline",
                    dur_s=(now - req.submit_t) if req.submit_t else None,
                    row=row,
                )
        traces = [req.trace_id for _, req in placed if req.trace_id]
        T = max(len(req.ids) for _, req in placed)
        toks = np.zeros((self.B, T), np.int32)
        mask = np.zeros((self.B, T), bool)
        last_idx = np.zeros((self.B,), np.int32)
        for row, req in placed:
            toks[row, : len(req.ids)] = req.ids
            mask[row, : len(req.ids)] = True
            last_idx[row] = len(req.ids) - 1
        tok = self._forward(
            tokens=toks, attn_mask=mask, sample=self._samp(),
            last_idx=last_idx, reset_rows=recycled, trace=traces or None,
        )
        if tok is not None:
            self._apply_step_tokens(tok, [r for r, _ in placed])

    def step(self) -> None:
        """One decode step over the active rows (idle rows ride the fixed
        batch shape with a zero attention mask: their caches don't
        move)."""
        import numpy as np

        rows = self._live()
        if not rows:
            return
        toks = np.zeros((self.B, 1), np.int32)
        mask = np.zeros((self.B, 1), bool)
        for r in rows:
            toks[r, 0] = self.slots[r]["last_tok"]
            mask[r, 0] = True
        tok = self._forward(
            tokens=toks, attn_mask=mask, sample=self._samp(),
            reset_rows=sorted(self.reset_rows),
        )
        if tok is not None:
            self._apply_step_tokens(tok, rows)

    def fail(self, err: BaseException) -> None:
        """Fail every live and queued request with ``err``."""
        for r in self._live():
            slot = self.slots[r]
            self.slots[r] = None
            slot["req"].error = err
            slot["req"].done.set()
        while self.queue:
            req = self.queue.popleft()
            req.error = err
            req.done.set()

    def close(self) -> None:
        try:
            self.model._end_decode_session(self.session)
        except Exception as e:  # noqa: BLE001 — best-effort teardown
            logging.getLogger("tensorlink_tpu_torch.ml.batching").debug(
                "end_decode_session at close failed: %s", e)
        self.fail(RuntimeError("model is being unhosted"))


class ContinuousBatcher:
    """Continuous serving scheduler: blocking ``generate`` with a
    per-token stream callback, ``stats`` and ``close``, over a local slot
    engine (``engine=``), a single-stage remote job or a pipelined job's
    slot session (``model=``). Request ``n`` (from 1) samples with seed
    ``seed + n``. On a pipelined job, the requests the slot session does
    not carry (presence/frequency penalties, lookahead) run as a direct
    ``model.generate``."""

    def __init__(
        self,
        model: Any = None,
        eos_ids: list[int] | None = None,
        *,
        engine: Any = None,
        max_slots: int = 8,
        page_size: int = 16,
        chunk_steps: int = 8,
        prefill_chunk: int = 128,
        prefix_cache: bool = True,
        host_tier_pages: int = 0,
        kv_quant: str = "none",
        spec_decode: bool = False,
        spec_draft: int = 8,
        spec_budget: int = 0,
        seed: int = 0,
        default_priority: str = DEFAULT_PRIORITY,
        sched_queue_cap: int = 64,
        sched_aging_ticks: int = 32,
        sched_preemption: bool = True,
        sched_policy: str = "slo",
        sched_max_wait_s: float = 60.0,
        trace_site: str = "",
        pool: Any = None,
        model_id: str = "",
        page_quota: int = 0,
        worker_role: str = "mixed",
    ):
        if engine is None and model is None:
            raise ValueError("pass engine= or model=")
        self.model = model
        self.eos_ids = list(eos_ids or [])
        self.seed = int(seed)
        # control-plane journal hook: (jrid, seed) called write-ahead per
        # jrid-tagged admission (the validator wires its journal here)
        self.on_admit: Callable[[str, int], None] | None = None
        self.default_priority = normalize_priority(default_priority)
        self.max_slots = int(max_slots)
        self.sched_queue_cap = int(sched_queue_cap)
        # remote mode: per-class in-flight counts, the validator-side view
        # of a queue that lives on the worker's engine
        self._inflight_cls = {c: 0 for c in PRIORITY_RANK}  #: guarded by self._idle
        self._inflight = 0  #: guarded by self._idle
        self._idle = threading.Condition()
        self._seq = itertools.count(1)
        self._closed = False  #: guarded by self._submit_lock
        self._submit_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._served = 0  #: guarded by self._stats_lock
        self.live_samples: deque[int] = deque(maxlen=1000)  #: guarded by self._stats_lock
        self._q: queue.Queue[_Pending | None] = queue.Queue()
        self._wake = threading.Event()
        # dispatcher-confined control work: (fn, box) pairs the dispatcher
        # runs against the engine between chunks
        self._ctl: deque = deque()
        # background hook the dispatcher runs once per loop iteration,
        # between chunks; True = it did work (keeps the loop hot)
        self._bg: Callable[[], bool] | None = None
        self._thread: threading.Thread | None = None
        # the configured throughput modes a remote engine reports before
        # (and besides) its serving snapshots
        self._modes = {
            "kv_quant": str(kv_quant or "none"),
            "weight_quant": str(
                (getattr(model, "model_spec", None) or {}).get("quant")
                or "none"
            ),
            "spec_decode": bool(spec_decode),
            "host_tier": int(host_tier_pages) > 0,
            # the entry worker's advertised pool role (placement stats)
            "worker_role": str(worker_role or "mixed"),
        }
        self._sess: PipelinedSlotSession | None = None
        if engine is None:
            self._cont = None
            if model.plan.n_stages == 1:
                self.mode = "remote"
                return
            self._sess = PipelinedSlotSession(model, max_slots=max_slots)
            self.mode = "pipelined"
            self._thread = threading.Thread(
                target=self._drive_pipelined, name="cont-batcher",
                daemon=True,
            )
            self._thread.start()
            return
        self._cont = (
            engine if isinstance(engine, ContinuousEngine)
            else ContinuousEngine(
                engine, max_slots=max_slots, page_size=page_size,
                chunk_steps=chunk_steps, prefill_chunk=prefill_chunk,
                prefix_cache=prefix_cache,
                host_tier_pages=host_tier_pages, kv_quant=kv_quant,
                spec_decode=spec_decode, spec_draft=spec_draft,
                spec_budget=spec_budget,
                default_priority=self.default_priority,
                sched_queue_cap=sched_queue_cap,
                sched_aging_ticks=sched_aging_ticks,
                sched_preemption=sched_preemption,
                sched_policy=sched_policy,
                sched_max_wait_s=sched_max_wait_s,
                trace_site=trace_site or "local",
                pool=pool, model_id=model_id, page_quota=page_quota,
                worker_role=worker_role,
            )
        )
        self.mode = "local"
        self._thread = threading.Thread(
            target=self._drive, name="cont-batcher", daemon=True
        )
        self._thread.start()

    @property
    def engine(self) -> ContinuousEngine | None:
        """The local slot engine (None in the remote and pipelined modes,
        and once the dispatcher closed it on an error)."""
        return self._cont

    def metrics_registry(self):
        """The local engine's metrics registry (None once it closed, and in
        remote mode, whose counters ride the serving snapshot instead)."""
        return self._cont.metrics if self._cont is not None else None

    def _remote_snapshot(self) -> dict:
        """The worker engine's last serving snapshot (riding each
        GENERATE_RESP), {} before any traffic."""
        snap = getattr(self.model, "cont_serving_stats", None)
        return snap if isinstance(snap, dict) else {}

    def serving_modes(self) -> dict:
        """Throughput-mode summary (attribute reads, no engine round
        trip), under the JAX batcher's keys: KV storage, weight storage,
        speculation, host tier, pool role, weights version, and the
        tenant's quota view on a shared pool. A remote engine reports the
        configured knobs (the worker builds its engine from the same
        MLConfig) and the weights version of its last snapshot."""
        if self.mode != "local":
            modes = dict(self._modes)
            modes["weights_version"] = int(
                self._remote_snapshot().get("weights_version", 1)
            )
            return modes
        cont = self._cont
        if cont is None:
            raise RuntimeError("local engine is closed")
        modes = {
            "kv_quant": cont.kv_quant,
            "weight_quant": getattr(cont.engine, "quant", None) or "none",
            "spec_decode": bool(cont.spec_decode),
            "host_tier": cont.host_tier is not None,
            "worker_role": str(cont.worker_role),
            "weights_version": int(cont.weights_version),
        }
        if cont.pool is not None:
            modes["pool"] = {
                "quota": cont.alloc.quota,
                "used": cont.alloc.used,
                "free": cont.pool.alloc.n_free,
            }
        return modes

    def router_snapshot(self) -> dict:
        """The engine's fleet-router view (headroom, per-class depth,
        service EWMA, both tiers' digests). Remote mode reads the last
        serving snapshot, floored by the validator-side in-flight counts."""
        if self.mode == "remote":
            snap = self._remote_snapshot()
            with self._idle:
                inflight = dict(self._inflight_cls)
            classes = snap.get("sched_classes") or {}
            depth = {
                c: max(
                    int((classes.get(c) or {}).get("queue_depth", 0)),
                    inflight.get(c, 0),
                )
                for c in PRIORITY_RANK
            }
            live = sum(inflight.values())
            return {
                "draining": snap.get("drain_state") == "draining",
                "worker_role": self._modes["worker_role"],
                "max_slots": int(snap.get("max_slots") or self.max_slots),
                "slots_free": int(
                    snap.get("slots_free", max(self.max_slots - live, 0))
                ),
                "kv_pages_free": int(snap.get("kv_pages_free") or 0),
                "kv_pages_total": int(snap.get("kv_pages_total") or 0),
                "service_ewma_s": float(
                    snap.get("sched_service_ewma_s") or 0.0
                ),
                "queue_depth": depth,
                "prefix_digest": snap.get("prefix_digest") or {},
            }
        if self.mode == "pipelined":
            sess = self._sess
            queued = len(sess.queue)
            return {
                "draining": False,
                "worker_role": "mixed",
                "max_slots": self.max_slots,
                "slots_free": len(sess.free_slots),
                "kv_pages_free": 0,
                "kv_pages_total": 0,
                "service_ewma_s": 0.0,
                "queue_depth": {c: queued for c in PRIORITY_RANK},
                "prefix_digest": {},
            }
        cont = self._cont
        if cont is None:
            raise RuntimeError("local engine is closed")
        return cont.router_snapshot()

    def headroom(self) -> dict:
        """The per-replica headroom fields of :meth:`router_snapshot`."""
        return _headroom_from(self.router_snapshot())

    def set_background(self, fn: "Callable[[], bool] | None") -> None:
        """Attach (or clear) the dispatcher's background hook: it runs on
        the DISPATCHER thread after each chunk (and while idle); an
        exception detaches it rather than stopping serving."""
        if fn is not None and (self._cont is None
                               or not self._thread.is_alive()):
            raise RuntimeError("background work requires a live engine")
        self._bg = fn
        self._wake.set()

    def publish_weights(
        self, params, *, version: int | None = None, timeout: float = 120.0,
    ) -> int:
        """Live weight publish: the tree is copied onto the engine's device
        and swapped in at a chunk boundary on the dispatcher thread
        (``ContinuousEngine.publish_weights``). Returns the new version."""
        if self._cont is None:
            raise RuntimeError("weight publish requires a live engine")
        return self.run_on_driver(
            lambda e: e.publish_weights(params, version=version),
            timeout=timeout,
        )

    def run_on_driver(self, fn, timeout: float = 60.0):
        """Execute ``fn(engine)`` on the dispatcher thread between chunks:
        the entry to the engine's stepping-thread-only verbs (migration,
        prefix export, publish). A call not picked up within ``timeout``
        is cancelled, never run later."""
        if self._cont is None or self._thread is None:
            raise RuntimeError("run_on_driver requires a live engine")
        box: dict = {"done": threading.Event()}
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("model is being unhosted")
            self._ctl.append((fn, box))
            self._wake.set()
        if not box["done"].wait(timeout):
            box["abandoned"] = True
            raise TimeoutError("the dispatcher did not pick up control work")
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def pull_prefix(self, chain, limit: int, n_skip: int = 0):
        """Source side of a fleet prefix pull: this replica's resident
        pages covering ``chain`` as a stageable blob, or None."""
        return self.run_on_driver(
            lambda cont: cont.export_prefix_pages(
                chain, int(limit), n_skip=int(n_skip)
            )
        )

    def _run_ctl(self, cont) -> None:
        """Drain the control queue on the dispatcher (or fail it when the
        engine is gone)."""
        while self._ctl:
            try:
                fn, box = self._ctl.popleft()
            except IndexError:
                return
            if box.get("abandoned"):
                box["done"].set()
                continue
            try:
                if cont is None:
                    raise RuntimeError("engine is closed")
                box["result"] = fn(cont)
            except BaseException as e:  # noqa: BLE001 — hand to the waiter
                box["error"] = e
            finally:
                box["done"].set()

    # -- client side -----------------------------------------------------
    def generate(
        self,
        ids: list[int],
        *,
        max_new_tokens: int,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        stream_cb: Callable[[list[int]], None] | None = None,
        timeout: float = 600.0,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
        priority: str | None = None,
        trace_id: str | None = None,
        speculative: bool = False,
        handoff: bool = True,
        lookahead: bool = False,
        jrid: str = "",
    ) -> list[int]:
        """Queue one request and block until it finishes; returns its
        tokens. ``stream_cb([tok])`` sees each token as it is delivered
        (a true return cancels the request). ``speculative`` opts into
        draft/verify decoding on a ``spec_decode`` engine. ``handoff`` is
        the remote mode's per-request opt-out of the prefill→decode
        handoff, and ``lookahead`` its prompt-lookup decode wish (greedy,
        unpenalized: the worker's solo engine path); a local engine serves
        the request where it is and ignores both, as the JAX batcher's
        local mode does. ``jrid`` (remote and pipelined modes) is the
        journal id the ``on_admit`` hook sees with the request's seed
        before dispatch."""
        if self.mode == "pipelined":
            return self._generate_pipelined(
                ids, max_new_tokens=max_new_tokens, temperature=temperature,
                top_k=top_k, top_p=top_p, stream_cb=stream_cb,
                timeout=timeout, presence_penalty=presence_penalty,
                frequency_penalty=frequency_penalty, priority=priority,
                trace_id=str(trace_id or ""), lookahead=lookahead,
                jrid=str(jrid or ""),
            )
        if self.mode == "remote":
            req_seed = self._admission_seed(jrid)
            priority = normalize_priority(priority or self.default_priority)
            # drain accounting for close(): unhost must not tear the job
            # down under requests the worker is still decoding
            with self._idle:
                self._inflight += 1
                self._inflight_cls[priority] += 1
            try:
                return self._generate_remote(
                    ids, max_new_tokens=max_new_tokens,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    stream_cb=stream_cb, lookahead=lookahead,
                    speculative=speculative,
                    presence_penalty=presence_penalty,
                    frequency_penalty=frequency_penalty, seed=req_seed,
                    priority=priority, trace_id=str(trace_id or ""),
                    handoff=handoff, jrid=str(jrid or ""),
                )
            finally:
                with self._idle:
                    self._inflight -= 1
                    self._inflight_cls[priority] -= 1
                    self._idle.notify_all()
        req = _Pending(
            ids=[int(t) for t in ids],
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), stream_cb=stream_cb,
            presence_penalty=float(presence_penalty),
            frequency_penalty=float(frequency_penalty),
            priority=normalize_priority(priority or self.default_priority),
            trace_id=str(trace_id or ""),
            speculative=bool(speculative),
        )
        return self._submit_and_wait(req, timeout, seeded=False)

    def _admission_seed(self, jrid: str) -> int:
        """The next request's seed (``seed + n``), handed with ``jrid`` to
        the ``on_admit`` journal hook before the request dispatches."""
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("model is being unhosted")
            seed = self.seed + next(self._seq)
        if jrid and self.on_admit is not None:
            try:
                self.on_admit(str(jrid), int(seed))
            # tlint: disable=TL005(journal telemetry must never fail an admission)
            except Exception:
                pass
        return seed

    def _submit_and_wait(self, req: _Pending, timeout: float, *,
                         seeded: bool) -> list[int]:
        """Queue ``req`` for the dispatcher (its seed drawn now unless
        ``seeded``) and block until it finishes."""
        req.submit_t = time.monotonic()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("model is being unhosted")
            if not seeded:
                req.seed = self.seed + next(self._seq)
            self._q.put(req)
            self._wake.set()
        if not req.done.wait(timeout):
            raise TimeoutError("generation timed out in the batcher")
        if req.error is not None:
            raise req.error
        self._note_served()
        return req.result or []

    def _generate_pipelined(
        self, ids, *, max_new_tokens, temperature, top_k, top_p, stream_cb,
        timeout, presence_penalty, frequency_penalty, priority, trace_id,
        lookahead, jrid,
    ) -> list[int]:
        """A request on a pipelined job: into the slot session, or — with
        penalties or lookahead, which the session does not carry — a
        direct solo ``model.generate``."""
        req_seed = self._admission_seed(jrid)
        penalized = bool(presence_penalty or frequency_penalty)
        if penalized or lookahead:
            cb = None
            if stream_cb is not None:
                def cb(emitted):
                    if emitted[0] is not None and stream_cb([int(emitted[0])]):
                        return [0]
                    return None
            seqs = self.model.generate(
                [list(ids)], max_new_tokens=int(max_new_tokens),
                temperature=float(temperature), top_k=int(top_k),
                top_p=float(top_p), eos_ids=self.eos_ids, seed=req_seed,
                stream_cb=cb,
                lookahead=lookahead and float(temperature) == 0.0
                and not penalized,
                presence_penalty=presence_penalty,
                frequency_penalty=frequency_penalty,
            )
            self._note_served()
            return [int(t) for t in seqs[0][: int(max_new_tokens)]]
        if trace_id and stream_cb is not None:
            # the slot session has no engine-side spans: the first
            # delivered token gives the trace its TTFT
            inner_cb, first_seen, t_sub = stream_cb, [False], time.monotonic()

            def stream_cb(toks, _cb=inner_cb):
                if not first_seen[0]:
                    first_seen[0] = True
                    get_tracer().record(
                        trace_id, "first_token", site="batcher",
                        dur_s=time.monotonic() - t_sub,
                    )
                return _cb(toks)

        req = _Pending(
            ids=[int(t) for t in ids],
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), stream_cb=stream_cb,
            priority=normalize_priority(priority or self.default_priority),
            trace_id=trace_id, seed=req_seed, eos_ids=list(self.eos_ids),
        )
        return self._submit_and_wait(req, timeout, seeded=True)

    def _generate_remote(
        self, ids, *, max_new_tokens, temperature, top_k, top_p, stream_cb,
        lookahead, presence_penalty, frequency_penalty, seed,
        speculative=False, priority=None, trace_id="", handoff=True,
        jrid="",
    ) -> list[int]:
        """Single-stage pass-through: the worker's slot engine is the
        scheduler, so each request ships immediately — concurrency comes
        from the API's request threads, admission (and any preemption)
        from the worker's scheduler, which reads ``priority`` off the
        GENERATE body."""
        spec = bool(lookahead) and float(temperature) == 0.0 \
            and not presence_penalty and not frequency_penalty
        cb = None
        if stream_cb is not None:
            def cb(emitted):
                if emitted and emitted[0] is not None:
                    if stream_cb([int(emitted[0])]):
                        return [0]
                return None
        seqs = self.model.generate(
            [list(ids)], max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), eos_ids=self.eos_ids, seed=int(seed),
            stream_cb=cb, lookahead=spec,
            speculative=bool(speculative),
            presence_penalty=presence_penalty,
            frequency_penalty=frequency_penalty,
            priority=priority,
            trace_id=trace_id,
            handoff=handoff,
            jrid=str(jrid or ""),
            # legacy lookahead runs the solo engine path; everything else
            # joins the worker's slot batch
            continuous=not spec,
        )
        self._note_served()
        return [int(t) for t in seqs[0][: int(max_new_tokens)]]

    def _note_served(self) -> None:
        with self._stats_lock:
            self._served += 1

    def admission_check(self, priority=None, n: int = 1) -> dict | None:
        """Backpressure gate: None = admit, else a rejection record the API
        turns into 429 + Retry-After. Local mode asks the engine
        scheduler; remote mode holds the validator-side per-class
        in-flight count against the same cap (the worker's scheduler
        still backstops with SchedulerOverloaded), and the pipelined mode
        its session's queue."""
        cls = normalize_priority(priority or self.default_priority)
        if self.mode != "local":
            with self._idle:
                depth = self._inflight_cls.get(cls, 0)
            if self._sess is not None:
                depth = max(depth, len(self._sess.queue))
            if depth + n > self.sched_queue_cap:
                return {
                    "priority": cls,
                    "queue_depth": depth,
                    "cap": self.sched_queue_cap,
                    "retry_after": max(
                        1.0, min(depth / max(self.max_slots, 1) * 5.0, 600.0)
                    ),
                }
            return None
        cont = self._cont
        if cont is None:
            raise RuntimeError("local engine is closed")
        return cont.admission_check(cls, n)

    # -- dispatcher ------------------------------------------------------
    def _drain_queue(self) -> list[_Pending]:
        out: list[_Pending] = []
        while True:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                with self._submit_lock:
                    self._closed = True
                break
            out.append(nxt)
        return out

    def _drive(self) -> None:
        """Dispatcher loop: admit whatever is queued, run one chunk,
        repeat; park on the wake event when idle. An engine error fails
        every queued and in-flight request and stops the dispatcher."""
        cont = self._cont
        while True:
            try:
                self._run_ctl(cont)
                for req in self._drain_queue():
                    self._submit_local(cont, req)
                busy = cont.has_work()
                if busy:
                    with self._stats_lock:
                        self.live_samples.append(cont.live_slots)
                    cont.step_chunk()
                bg = self._bg
                if bg is not None:
                    try:
                        if bg():
                            busy = True
                    except Exception:  # noqa: BLE001 — detach, keep serving
                        logging.getLogger(
                            "tensorlink_tpu_torch.ml.batching"
                        ).exception("background task failed — detaching it")
                        self._bg = None
            except Exception as e:  # noqa: BLE001 — fail the waiters, stop
                with self._submit_lock:
                    self._closed = True
                self._cont = None
                cont.close(e)
                self._run_ctl(None)
                while True:
                    try:
                        req = self._q.get_nowait()
                    except queue.Empty:
                        return
                    if req is not None:
                        req.error = e
                        req.done.set()
            with self._submit_lock:
                closed = self._closed
            if closed and not busy and self._q.empty():
                self._run_ctl(None)
                return
            if not busy:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    def _drive_pipelined(self) -> None:
        """The pipelined mode's dispatcher: admit into free rows, decode
        one step over the live rows, repeat. A failure the session could
        not recover fails its live and queued requests; serving goes on."""
        sess = self._sess
        while True:
            try:
                for req in self._drain_queue():
                    sess.submit(req)
                sess.pump()
                live = sess._live()
                if live:
                    with self._stats_lock:
                        self.live_samples.append(len(live))
                    sess.step()
                busy = sess.has_work()
            except Exception as e:  # noqa: BLE001 — fail them, keep serving
                sess.fail(e)
                busy = False
            with self._submit_lock:
                closed = self._closed
            if closed and not busy and self._q.empty():
                return
            if not busy:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    def _submit_local(self, cont: ContinuousEngine, req: _Pending) -> None:
        def tok_cb(tok: int) -> bool:
            if req.stream_cb is not None:
                return bool(req.stream_cb([int(tok)]))
            return False

        def on_finish(creq) -> None:
            if creq.error is not None:
                req.error = creq.error
            else:
                req.result = [int(t) for t in creq.tokens[: req.max_new_tokens]]
            req.done.set()

        cont.submit(
            req.ids, max_new_tokens=req.max_new_tokens,
            sampling=SamplingParams.make(
                temperature=req.temperature, top_k=req.top_k,
                top_p=req.top_p, presence_penalty=req.presence_penalty,
                frequency_penalty=req.frequency_penalty,
            ),
            eos_ids=self.eos_ids, seed=req.seed, priority=req.priority,
            stream_cb=tok_cb, on_finish=on_finish, trace_id=req.trace_id,
            speculative=req.speculative,
        )

    def stats(self) -> dict | None:
        """Requests served, slot occupancy and the engine's
        ``serving_snapshot`` under ``"engine"`` (None before any work)."""
        with self._stats_lock:
            served = self._served
            live = list(self.live_samples)
        if not served and not live:
            return None
        out = {"requests": served, "continuous": True, "mode": self.mode}
        if live:
            out["mean_live_slots"] = round(sum(live) / len(live), 2)
            out["max_live_slots"] = max(live)
        if self.mode == "remote":
            snap = self._remote_snapshot()
            if snap:
                out["engine"] = snap
            return out
        cont = self._cont
        if cont is not None:
            st = cont.stats
            if st["slot_steps_total"]:
                out["slot_occupancy"] = round(
                    st["slot_steps_live"] / st["slot_steps_total"], 3
                )
            out["engine"] = cont.serving_snapshot()
        return out

    def close(self, timeout: float = 600.0) -> None:
        """Serve everything already submitted, then stop the dispatcher and
        close the engine (which checks page conservation). Remote mode
        waits out the requests still decoding on the worker."""
        if self.mode == "remote":
            with self._submit_lock:
                self._closed = True
            deadline = time.monotonic() + timeout
            with self._idle:
                while self._inflight > 0:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._idle.wait(timeout=min(left, 5.0))
            return
        with self._submit_lock:
            self._closed = True
            self._q.put(None)
            self._wake.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise TimeoutError(
                f"ContinuousBatcher.close(): the dispatcher did not drain "
                f"within {timeout:.0f}s"
            )
        if self._cont is not None:
            self._cont.close()
            self._cont = None
        if self._sess is not None:
            self._sess.close()
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.error = RuntimeError("model is being unhosted")
                req.done.set()
        self._run_ctl(None)  # control waiters must not hang on a close


__all__ = ["ContinuousBatcher", "GenBatcher", "PipelinedSlotSession"]
