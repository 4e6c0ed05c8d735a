"""Continuous-batching engine over the paged KV cache (port of
``tensorlink_tpu/engine/continuous.py``).

The engine decodes a fixed slot batch (``max_slots``) in chunks; every
chunk boundary admits queued requests into free slots and returns
finished slots' pages to the free-list. Admission walks the automatic
prefix cache (the longest cached chain of full pages maps into the new
slot's block table with zero prefill compute; the first divergent page
is copy-on-write) and queues the rest of the prompt for chunked prefill.
Each chunk runs ONE step (``engine/paged.py::paged_ragged_step``): every
mid-prefill slot's next prompt piece and every decoding slot's next token
ride one packed ``[slots, chunk]`` block, then the decode continuation
runs ``chunk_steps - 1`` more slot-batched steps. The host reads the
results once per chunk.

Determinism contract (as in the JAX package): token ``n`` of a request
draws from ``fold_in(PRNGKey(seed), n)`` and a slot's logits depend only
on its own pages, so a stream is token-for-token the same whether the
request runs alone, co-batched, admitted mid-flight or resumed after a
preemption, with the prefix cache on or off.

On a CUDA device the step's attention runs the CUDA kernels
(``use_kernel``); on the CPU it runs their plain versions. Not in this
slice (each raises naming the later slice): int8/int4 KV pages
(``kv_quant``), speculative decoding, tensor parallelism, the shared page
pool, the host-RAM tier, and live migration/handoff.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..core.metrics import MetricsRegistry
from ..core.trace import FlightRecorder, get_tracer
from .generate import GenerationEngine
from .paged import (
    PageAllocator,
    PagedKVCache,
    PrefixCache,
    bind_slot,
    clear_slot,
    copy_page,
    paged_ragged_step,
    pages_needed,
)
from .sampling import SamplingParams
from .scheduler import (
    DEFAULT_PRIORITY,
    RequestScheduler,
    SchedulerOverloaded,
    normalize_priority,
)


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet — it arrives with the {slice_name} slice "
        "of the port"
    )


def pack_prefill_budgets(
    remaining: "list[int]", chunk: int, budget: "int | None" = None,
    phase: int = 0,
) -> list[int]:
    """How many prefill tokens each mid-prefill slot gets this step: up to
    ``chunk`` per slot, under an optional TOTAL ``budget`` split
    round-robin one token at a time from slot ``phase % n`` (the caller
    advances ``phase`` every step, so a small budget rotates instead of
    starving the tail). A pure function of its inputs."""
    n = len(remaining)
    want = [min(int(chunk), max(int(r), 0)) for r in remaining]
    if budget is None or sum(want) <= int(budget):
        return want
    grants = [0] * n
    left = int(budget)
    start = int(phase) % n if n else 0
    while left > 0:
        progressed = False
        for j in range(n):
            i = (start + j) % n
            if grants[i] < want[i] and left > 0:
                grants[i] += 1
                left -= 1
                progressed = True
        if not progressed:
            break
    return grants


# the engine's counter families this slice has: (serving_snapshot key,
# metric name, help) — the same keys and names as the JAX engine
_ENGINE_COUNTERS = (
    ("admitted", "tlink_engine_admitted_total",
     "requests admitted into a slot"),
    ("evicted", "tlink_engine_evicted_total",
     "finished slots evicted at a chunk boundary"),
    ("preemptions", "tlink_engine_preemptions_total",
     "slots preempted for a higher-ranked candidate"),
    ("decode_steps", "tlink_engine_decode_steps_total",
     "slot-batched decode steps executed"),
    ("slot_steps_live", "tlink_engine_slot_steps_live_total",
     "slot-steps that delivered a token"),
    ("slot_steps_total", "tlink_engine_slot_steps_total",
     "slot-steps executed including padding rows"),
    ("prefill_chunks", "tlink_engine_prefill_chunks_total",
     "prefill grants executed"),
    ("prefill_tokens", "tlink_engine_prefill_tokens_total",
     "prompt tokens prefilled on device"),
    ("prefill_tokens_skipped", "tlink_engine_prefill_tokens_skipped_total",
     "prompt tokens served from the prefix cache"),
)


@dataclass
class ContinuousRequest:
    """One in-flight (or queued) request's host-side state."""

    rid: int
    prompt: list[int]
    budget: int  # total tokens wanted THIS submission (incl. pre-preempt)
    sampling: SamplingParams
    eos: frozenset
    seed: int
    start_step: int = 0  # tokens emitted before this submission (resume)
    stream_cb: Callable[[int], bool | None] | None = None
    on_finish: Callable[["ContinuousRequest"], None] | None = None
    tokens: list[int] = field(default_factory=list)  # emitted THIS run
    finished: bool = False
    slot: int = -1
    pages: list[int] = field(default_factory=list)  # pages this slot OWNS
    shared_nodes: list = field(default_factory=list)  # prefix-cache hits
    prefill_pos: int = 0  # prefill tokens written so far
    # the sequence the CURRENT admission prefills (prompt + any tokens
    # emitted before a preemption) and its length — the promotion cap
    prefill_tokens: list[int] = field(default_factory=list)
    prefill_target: int = 0
    error: BaseException | None = None
    done: threading.Event = field(default_factory=threading.Event)
    # -- scheduling (engine/scheduler.py) -------------------------------
    priority: str = DEFAULT_PRIORITY
    sched_seq: int = 0
    admit_seq: int = 0
    enqueue_tick: int = 0
    enqueue_t: float = 0.0
    admit_rank: int = -1
    submit_t: float = 0.0
    admit_t: float = 0.0
    # -- observability ---------------------------------------------------
    trace_id: str = ""
    prefill_done_t: float = 0.0
    cache_tier: str = "none"  # "none" | "hbm": where the hit region came from
    weights_version: int = 0


class ContinuousEngine:
    """Slot-batched continuous decode over one GenerationEngine's model.

    Single-stepper discipline: ``submit`` is thread-safe; ``step_chunk``
    must be called from one thread (a ContinuousBatcher's
    dispatcher, or the caller's loop).
    """

    _EOS_WIDTH = 8  # per-slot EOS ids carried into the step

    def __init__(
        self,
        engine: GenerationEngine,
        *,
        max_slots: int = 8,
        page_size: int = 16,
        chunk_steps: int = 8,
        prefill_chunk: int = 128,
        prefix_cache: bool = True,
        kv_quant: str = "none",
        spec_decode: bool = False,
        sched_queue_cap: int = 64,
        sched_aging_ticks: int = 32,
        sched_preemption: bool = True,
        sched_policy: str = "slo",
        sched_max_wait_s: float = 60.0,
        default_priority: str = DEFAULT_PRIORITY,
        trace_site: str = "",
        metrics: MetricsRegistry | None = None,
        pool=None,
        tensor_parallel: int = 1,
    ):
        if engine.cfg.sliding_window is not None:
            raise ValueError(
                "continuous batching does not support sliding-window "
                "attention"
            )
        if int(prefill_chunk) <= 0:
            raise ValueError("prefill_chunk must be >= 1")
        if str(kv_quant or "none") != "none" or engine.cache_quant:
            raise _later(f"kv_quant={kv_quant!r}", "int8/int4")
        if spec_decode:
            raise _later("spec_decode=True", "speculative-decoding")
        if int(tensor_parallel or 1) > 1:
            raise _later("tensor_parallel > 1", "tensor-parallel")
        if pool is not None:
            raise _later("a shared page pool (pool=)", "co-hosting")
        self.kv_quant = "none"
        self.engine = engine
        self.cfg = engine.cfg
        self.device = engine.device
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.chunk_steps = max(int(chunk_steps), 1)
        self.max_seq_len = engine.max_seq_len
        # the CUDA kernels on the card; their plain versions on the CPU
        self.use_kernel = self.device.type == "cuda"
        self.spec_decode = False
        self.spec_width = 1
        self.tensor_parallel = 1
        self.pool = None
        self.cache = PagedKVCache.init(
            self.cfg, self.max_slots, page_size=self.page_size,
            max_len=self.max_seq_len, dtype=engine.cache_dtype,
            device=self.device,
        )
        self.alloc = PageAllocator(self.cache.n_pages)
        self.prefill_chunk = min(int(prefill_chunk), self.max_seq_len)
        self.prefix = PrefixCache(self.page_size) if prefix_cache else None
        self._prefix_digest: dict = {}
        self._digest_version = -1
        self._prefilling: dict[int, ContinuousRequest] = {}
        self._lock = threading.Lock()
        self.default_priority = normalize_priority(default_priority)
        self.tracer = get_tracer()
        self.trace_site = str(trace_site)
        self.recorder = FlightRecorder()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._stat = {
            key: self.metrics.counter(name, help)
            for key, name, help in _ENGINE_COUNTERS
        }
        self.metrics.gauge(
            "tlink_engine_kv_pages_free", "free KV pages",
            fn=lambda: self.alloc.n_free,
        )
        self.metrics.gauge(
            "tlink_engine_live_slots", "slots decoding or mid-prefill",
            fn=lambda: self.live_slots,
        )
        self.weights_version = 1
        # host work between the previous chunk's sync and this chunk's
        # dispatch (admission, packing), ms
        self._host_gap_ms = 0.0
        # steps dispatched (one paged_ragged_step each): each launches the
        # ragged kernel once and the decode kernel chunk_steps - 1 times
        # per layer
        self.chunks = 0
        self.sched = RequestScheduler(  #: guarded by self._lock
            max_slots=self.max_slots,
            queue_cap=sched_queue_cap,
            aging_ticks=sched_aging_ticks,
            preemption=sched_preemption,
            policy=sched_policy,
            max_wait_s=sched_max_wait_s,
            metrics=self.metrics,
        )
        self._rid = itertools.count(1)
        self._slots: list[ContinuousRequest | None] = [None] * self.max_slots
        # host mirrors of per-slot decode state, uploaded every chunk
        self._tok = np.zeros(self.max_slots, np.int32)
        self._seeds = np.zeros(self.max_slots, np.int32)
        self._steps = np.zeros(self.max_slots, np.int32)
        self._active = np.zeros(self.max_slots, bool)
        self._temp = np.zeros(self.max_slots, np.float32)
        self._topk = np.zeros(self.max_slots, np.int32)
        self._topp = np.ones(self.max_slots, np.float32)
        self._pres = np.zeros(self.max_slots, np.float32)
        self._freq = np.zeros(self.max_slots, np.float32)
        self._counts = torch.zeros(
            (self.max_slots, self.cfg.vocab_size), dtype=torch.int32,
            device=self.device,
        )

    @property
    def stats(self) -> dict:
        """The counters as a plain dict (the JAX engine's key set for the
        counters this slice has)."""
        return {k: int(c.value) for k, c in self._stat.items()}

    def _count(self, key: str, n: int = 1) -> None:
        self._stat[key].inc(n)

    def _trace(self, req, name: str, dur_s: float | None = None,
               **attrs) -> None:
        if req is not None and req.trace_id:
            self.tracer.record(
                req.trace_id, name, site=self.trace_site, dur_s=dur_s,
                **attrs,
            )

    # -- client side -----------------------------------------------------
    def submit(
        self,
        prompt: list[int],
        *,
        max_new_tokens: int,
        sampling: SamplingParams | None = None,
        eos_ids=(),
        seed: int = 0,
        start_step: int = 0,
        priority: str | None = None,
        stream_cb: Callable[[int], bool | None] | None = None,
        on_finish: Callable[[ContinuousRequest], None] | None = None,
        trace_id: str | None = None,
    ) -> ContinuousRequest:
        """Queue a request; the scheduler decides when it joins the slot
        batch. ``start_step`` > 0 resumes a key chain (the prompt then
        carries the original prompt + tokens already delivered). Past the
        class queue cap the request fails at once with
        :class:`SchedulerOverloaded` on ``req.error``."""
        req = ContinuousRequest(
            rid=next(self._rid),
            prompt=[int(t) for t in prompt],
            budget=int(max_new_tokens),
            sampling=sampling or SamplingParams.make(),
            eos=frozenset(int(e) for e in eos_ids),
            seed=int(seed),
            start_step=int(start_step),
            priority=normalize_priority(
                priority if priority else self.default_priority
            ),
            stream_cb=stream_cb,
            on_finish=on_finish,
            trace_id=str(trace_id or ""),
        )
        req.submit_t = time.monotonic()
        overload: SchedulerOverloaded | None = None
        with self._lock:
            try:
                self.sched.push(req)
            except SchedulerOverloaded as e:
                overload = e
        if overload is not None:
            self._trace(req, "rejected", priority=overload.priority,
                        queue_depth=overload.queue_depth)
            req.error = overload
            self._finish(req, finished=False)
        return req

    def admission_check(self, priority: str | None = None, n: int = 1):
        """Backpressure probe: None = would admit, else a rejection
        record (queue depth, cap, retry-after estimate)."""
        with self._lock:
            return self.sched.admission_check(
                priority if priority else self.default_priority, n
            )

    def has_work(self) -> bool:
        with self._lock:
            return (
                len(self.sched) > 0
                or bool(self._active.any())
                or bool(self._prefilling)
            )

    @property
    def live_slots(self) -> int:
        """Slots holding a live request — decoding or mid-prefill."""
        return int(self._active.sum()) + len(self._prefilling)

    # -- admission / eviction -------------------------------------------
    def _finish(self, req: ContinuousRequest, *, finished: bool) -> None:
        req.finished = finished
        cb = req.on_finish
        req.done.set()
        if cb is not None:
            cb(req)

    def _emit(self, req: ContinuousRequest, tok: int) -> bool:
        """Deliver one token; True when the request is done (EOS, budget
        or a downstream cancel)."""
        if not req.tokens:
            now = time.monotonic()
            with self._lock:
                self.sched.note_first_token(req, now - req.submit_t)
            if req.trace_id:
                base = req.prefill_done_t or req.admit_t or req.submit_t
                self._trace(req, "first_decode", dur_s=now - base)
                self._trace(req, "first_token", dur_s=now - req.submit_t)
        req.tokens.append(tok)
        cancel = False
        if req.stream_cb is not None:
            cancel = bool(req.stream_cb(tok))
        return cancel or tok in req.eos or len(req.tokens) >= req.budget

    def _admit_one(self, req: ContinuousRequest, slot: int) -> bool:
        """Place ``req`` into ``slot``; False when no pages are free (the
        request stays queued). A preempted request re-admits with
        ``req.tokens`` non-empty: it re-prefills prompt + emitted."""
        seq = req.prompt + req.tokens
        if len(seq) > self.max_seq_len:
            req.error = ValueError(
                f"prompt length {len(seq)} exceeds max_seq_len "
                f"{self.max_seq_len}"
            )
            self._finish(req, finished=False)
            return True
        room = self.max_seq_len - len(seq)
        eff = min(req.budget - len(req.tokens), room)
        if eff <= 0:
            self._finish(req, finished=True)
            return True
        req.budget = len(req.tokens) + eff
        total = min(len(seq) + eff, self.max_seq_len)
        req.prefill_tokens = seq
        req.prefill_target = len(seq)
        return self._admit_paged(req, slot, total)

    def _alloc_pages(self, n: int) -> list[int] | None:
        """All-or-nothing page grab; when short, evicts unreferenced cached
        prefixes LRU-leaf-first — but only when that can cover the
        deficit, so a request too big to fit leaves the cache intact."""
        pages = self.alloc.alloc(n)
        if pages is None and self.prefix is not None:
            deficit = n - self.alloc.n_free
            if deficit > 0 and self.prefix.n_evictable() >= deficit:
                self.alloc.free(self.prefix.evict(deficit))
                pages = self.alloc.alloc(n)
        return pages

    def _admit_paged(self, req: ContinuousRequest, slot: int,
                     total: int) -> bool:
        """Chunked-prefill admission: map the longest cached chain of full
        pages, copy-on-write the first divergent page when a cached
        sibling shares a partial prefix, allocate private pages for the
        rest, and queue the non-hit suffix for chunked prefill."""
        seq = req.prefill_tokens
        T = len(seq)
        hit_nodes: list = []
        cow = None
        if self.prefix is not None:
            # at least ONE token must prefill, so the last prompt
            # position's logits exist for the first draw
            limit = T - 1
            hit_nodes = self.prefix.match(seq, limit)
            self.prefix.acquire(hit_nodes)
            req.cache_tier = "hbm" if hit_nodes else "none"
            cow = self.prefix.partial_match(hit_nodes, seq, limit)
            if cow is not None:
                self.prefix.acquire([cow[0]])
        n_hit = len(hit_nodes)
        pages = self._alloc_pages(pages_needed(total, self.page_size) - n_hit)
        if pages is None:
            if self.prefix is not None:
                self.prefix.release(hit_nodes)
                if cow is not None:
                    self.prefix.release([cow[0]])
            return False
        hit_len = n_hit * self.page_size
        cow_released = False
        try:
            bt_row = np.zeros(self.cache.pages_per_slot, np.int32)
            bt_row[:n_hit] = [n.page for n in hit_nodes]
            bt_row[n_hit : n_hit + len(pages)] = pages
            if cow is not None:
                src, n_match = cow
                self.cache = copy_page(self.cache, src.page, pages[0])
                hit_len += n_match
                self.prefix.stats["cow_copies"] += 1
                self.prefix.release([src])
                cow_released = True
            self.cache = bind_slot(self.cache, slot, bt_row, hit_len)
        except BaseException:
            # a failed admission must not leak pages or pinned refs
            self.alloc.free(pages)
            if self.prefix is not None:
                self.prefix.release(hit_nodes)
                if cow is not None and not cow_released:
                    self.prefix.release([cow[0]])
            raise
        req.slot = slot
        req.pages = pages
        req.shared_nodes = hit_nodes
        req.prefill_pos = hit_len
        self._slots[slot] = req
        self._prefilling[slot] = req
        self._arm_slot(req, slot)
        self._count("admitted")
        self._count("prefill_tokens_skipped", hit_len)
        if self.prefix is not None:
            self.prefix.stats["lookups"] += 1
            if hit_len > 0:
                self.prefix.stats["hits"] += 1
            self.prefix.stats["hit_tokens"] += hit_len
        return True

    def _set_knob_mirrors(self, slot: int, sp: SamplingParams) -> None:
        self._temp[slot] = float(sp.temperature)
        self._topk[slot] = int(sp.top_k)
        self._topp[slot] = float(sp.top_p)
        self._pres[slot] = float(sp.presence_penalty)
        self._freq[slot] = float(sp.frequency_penalty)

    def _arm_slot(self, req: ContinuousRequest, slot: int) -> None:
        """Land the request's sampling state at admission, before its first
        packed block: key index ``start_step + len(tokens)``, knobs, and
        the context histogram of the prefill sequence."""
        self._seeds[slot] = req.seed
        self._steps[slot] = req.start_step + len(req.tokens)
        req.weights_version = self.weights_version
        self._set_knob_mirrors(slot, req.sampling)
        self._counts[slot] = self._ctx_counts(
            req, req.prefill_tokens or req.prompt
        )

    def _ctx_counts(self, req: ContinuousRequest, ctx) -> torch.Tensor:
        """Histogram of ``ctx`` when the request's penalties need one
        (zeros otherwise)."""
        c = np.zeros(self.cfg.vocab_size, np.int32)
        if req.sampling.presence_penalty or req.sampling.frequency_penalty:
            np.add.at(c, np.asarray(ctx, np.int64), 1)
        return torch.from_numpy(c).to(self.device)

    def _evict(self, slot: int) -> None:
        """Free a finished slot at a step boundary: shared prefix pages
        drop their refcount, promotable private pages move INTO the
        prefix cache, the rest return to the free-list."""
        req = self._teardown_slot(slot)
        if req is not None:
            self._count("evicted")
            base = req.prefill_done_t or req.admit_t
            self._trace(
                req, "decode",
                dur_s=(time.monotonic() - base) if base else None,
                tokens=len(req.tokens),
            )
            if req.admit_t:
                with self._lock:
                    self.sched.note_finished(
                        req, time.monotonic() - req.admit_t
                    )
            self._finish(req, finished=True)

    def _teardown_slot(self, slot: int) -> ContinuousRequest | None:
        """Shared teardown for eviction and preemption: device row →
        scratch, pages released (promotable prefill-written pages enter
        the prefix cache), host mirrors cleared."""
        req = self._slots[slot]
        self._slots[slot] = None
        self._prefilling.pop(slot, None)
        self._active[slot] = False
        self._tok[slot] = 0
        self._temp[slot] = 0.0
        self.cache = clear_slot(self.cache, slot)
        self._counts[slot] = 0
        if req is not None:
            if self.prefix is not None:
                self._release_pages(req)
            else:
                self.alloc.free(req.pages)
            req.pages = []
            req.shared_nodes = []
        return req

    def _preempt(self, slot: int) -> None:
        """Preempt a running (or mid-prefill) slot at an admission
        boundary: tear it down (its prefill-written pages promote into the
        prefix cache) and re-queue the request with its arrival order.
        The resume re-prefills prompt + emitted and continues the key
        chain, so the full stream is bit-identical."""
        req = self._teardown_slot(slot)
        if req is None:
            return
        req.slot = -1
        req.prefill_pos = 0
        req.prefill_tokens = []
        req.prefill_target = 0
        req.prefill_done_t = 0.0
        self._count("preemptions")
        self._trace(req, "preempt", tokens=len(req.tokens))
        with self._lock:
            self.sched.requeue(req)

    def _release_pages(self, req: ContinuousRequest) -> None:
        """Return a released slot's pages, promoting the full pages every
        position of which was prefill-written from this admission's
        prefill sequence (decode-written KV is never cached: the cache's
        contract is that a hit is the KV a prefill would compute)."""
        self.prefix.release(req.shared_nodes)
        lim = min(req.prefill_target, req.prefill_pos)
        page = self.page_size
        n_hit = len(req.shared_nodes)
        node = req.shared_nodes[-1] if req.shared_nodes else None
        free_list: list[int] = []
        promoting = (
            req.error is None and req.weights_version == self.weights_version
        )
        for j, pid in enumerate(req.pages):
            hi = (n_hit + j + 1) * page
            if promoting and hi <= lim:
                block = tuple(
                    int(t) for t in req.prefill_tokens[hi - page : hi]
                )
                node, adopted = self.prefix.insert(
                    node, block, pid, freed=free_list
                )
                if not adopted:
                    free_list.append(pid)
            else:
                promoting = False
                free_list.append(pid)
        self.alloc.free(free_list)

    def page_accounting(self) -> dict:
        """Ownership snapshot over physical pages 1..P-1."""
        slot_pages: list[int] = []
        for req in self._slots:
            if req is not None:
                slot_pages.extend(req.pages)
        return {
            "free": set(self.alloc._free),
            "cached": self.prefix.resident_pages if self.prefix else set(),
            "slots": slot_pages,
        }

    def check_page_conservation(self) -> None:
        """free + slot-owned + cache-resident == total usable pages,
        pairwise disjoint, scratch page 0 in none of them. Raises
        AssertionError (with the per-term breakdown) on violation."""
        acc = self.page_accounting()
        free, cached, slots = acc["free"], acc["cached"], acc["slots"]
        total = self.cache.n_pages - 1
        problems = []
        if len(free) != len(self.alloc._free):
            problems.append("the free-list holds a duplicate page")
        if len(slots) != len(set(slots)):
            problems.append("a page is owned by two slots")
        if free & cached:
            problems.append("free-list and cache overlap")
        if set(slots) & (free | cached):
            problems.append("slot-owned page also free or cached")
        if 0 in (free | cached | set(slots)):
            problems.append("scratch page 0 entered an ownership set")
        if len(free) + len(cached) + len(slots) != total:
            problems.append("leak: the ownership terms do not sum to the pool")
        if problems:
            raise AssertionError(
                "page conservation violated: " + "; ".join(problems)
                + f" [free={len(free)} slots={len(slots)} "
                f"cached={len(cached)} vs total={total}]"
            )

    def serving_snapshot(self) -> dict:
        """Telemetry: the engine counters, KV occupancy, scheduler
        per-class stats and prefix-cache stats, under the JAX engine's
        keys."""
        out = dict(self.stats)
        c = self.cache
        page_bytes = (
            c.k.numel() * c.k.element_size() + c.v.numel() * c.v.element_size()
        ) // c.n_pages
        out.update({
            "kv_quant": self.kv_quant,
            "weight_quant": "none",
            "kv_pages_total": c.n_pages - 1,
            "kv_pages_free": self.alloc.n_free,
            "kv_page_bytes": int(page_bytes),
            "spec_decode": False,
            "kv_pages_slots": sum(
                len(r.pages) for r in self._slots if r is not None
            ),
            "slots_free": sum(1 for r in self._slots if r is None),
            "weights_version": self.weights_version,
            "tensor_parallel": self.tensor_parallel,
            "host_gap_ms": self._host_gap_ms,
        })
        with self._lock:
            out.update(self.sched.snapshot())
        if self.prefix is not None:
            ps = self.prefix.stats
            out.update({
                "prefix_lookups": ps["lookups"],
                "prefix_hits": ps["hits"],
                "prefix_hit_tokens": ps["hit_tokens"],
                "prefix_cow_copies": ps["cow_copies"],
                "prefix_evictions": ps["evictions"],
                "prefix_inserts": ps["inserts"],
                "prefix_resident_pages": self.prefix.n_resident,
                "prefix_digest": self._prefix_digest,
            })
        out["host_tier"] = False
        return out

    def _admit(self) -> None:
        """One admission round (one scheduler tick): admit the scheduler's
        best queued request into a free slot, preempting a strictly
        lower-ranked resident when the candidate would otherwise miss
        admission (no free slot, or no pages even after cache eviction)."""
        with self._lock:
            self.sched.tick()
        while True:
            with self._lock:
                free = [
                    s for s in range(self.max_slots)
                    if self._slots[s] is None
                ]
                req = self.sched.select()
                victim = None
                if req is not None and not free:
                    victim = self.sched.victim(self._preemptable(), req)
            if req is None:
                return
            if not free:
                if victim is None:
                    return  # every resident outranks the best candidate
                self._preempt(victim.slot)
                continue
            t_adm = time.monotonic()
            while not self._admit_one(req, free[0]):
                with self._lock:
                    victim = self.sched.victim(self._preemptable(), req)
                if victim is not None:
                    self._preempt(victim.slot)
                    continue
                return  # head-of-line waits for pages
            with self._lock:
                self.sched.remove(req)
                if req.slot >= 0:
                    self.sched.note_admitted(req)
                    req.admit_t = time.monotonic()
            if req.slot >= 0 and req.trace_id:
                self._trace(
                    req, "queue_wait", dur_s=req.admit_t - req.submit_t,
                    priority=req.priority,
                )
                self._trace(
                    req, "admission", dur_s=req.admit_t - t_adm,
                    slot=req.slot, cache_hit_tokens=req.prefill_pos,
                    tier=req.cache_tier,
                )

    def _preemptable(self) -> list:
        return list(self._slots)

    # -- the decode loop -------------------------------------------------
    def _pack_ragged(self):
        """Assemble the step's packed ``[S, C]`` token block: each
        mid-prefill slot's next prompt piece (its grant from
        :func:`pack_prefill_budgets`) and each decoding slot's current
        token, with per-slot ``(start, n_valid)`` as data. ``emit`` marks
        the slots that sample this step. None when nothing is live."""
        if not self._prefilling and not self._active.any():
            return None
        S, C = self.max_slots, self.prefill_chunk
        blk = np.zeros((S, C), np.int32)
        starts = np.zeros(S, np.int32)
        n_valid = np.zeros(S, np.int32)
        emit = np.zeros(S, bool)
        remaining = np.zeros(S, np.int32)
        eos_arr = np.full((S, self._EOS_WIDTH), -1, np.int32)
        completing: list[int] = []
        grants: dict[int, int] = {}
        pf_slots = sorted(self._prefilling)
        pf_rem = [
            len(self._prefilling[s].prefill_tokens)
            - self._prefilling[s].prefill_pos
            for s in pf_slots
        ]
        budgets = pack_prefill_budgets(pf_rem, C)
        for s, g in zip(pf_slots, budgets):
            req = self._prefilling[s]
            if g <= 0:
                continue
            blk[s, :g] = req.prefill_tokens[
                req.prefill_pos : req.prefill_pos + g
            ]
            starts[s] = req.prefill_pos
            n_valid[s] = g
            grants[s] = g
            if req.prefill_pos + g >= len(req.prefill_tokens):
                completing.append(s)
                emit[s] = True
        for s in range(S):
            req = self._slots[s]
            if req is None:
                continue
            if self._active[s]:
                blk[s, 0] = self._tok[s]
                starts[s] = len(req.prompt) + len(req.tokens) - 1
                n_valid[s] = 1
                emit[s] = True
            if emit[s]:
                remaining[s] = req.budget - len(req.tokens)
                ids = sorted(req.eos)[: self._EOS_WIDTH]
                eos_arr[s, : len(ids)] = ids
        return blk, starts, n_valid, emit, remaining, eos_arr, completing, \
            grants

    def step_chunk(self, *, admit_only: bool = False) -> bool:
        """Admit queued requests, then run ONE step (the packed ragged
        block plus ``chunk_steps - 1`` decode steps), deliver each slot's
        tokens up to its own done-point, and evict finished slots at the
        boundary. Returns True while any work remains."""
        t_host = time.monotonic()
        self._admit()
        if admit_only:
            return self.has_work()
        S = self.max_slots
        pack = self._pack_ragged()
        if pack is None:
            return self.has_work()
        blk, starts, n_valid, emit, remaining, eos_arr, completing, grants = \
            pack
        dev = self.device

        def up(a):
            return torch.tensor(a, device=dev)

        t_chunk = time.monotonic()
        self._host_gap_ms = round((t_chunk - t_host) * 1e3, 3)
        self.chunks += 1
        tokens, n_tok, _spec_m, n_exec, self.cache, _done, _steps, \
            self._counts, _rem = paged_ragged_step(
                self.engine.params, up(blk), self.cache, up(starts),
                up(n_valid), up(np.zeros(S, np.int32)), up(emit),
                up(self._seeds), up(self._steps), up(self._temp),
                up(self._topk), up(self._topp), up(self._pres),
                up(self._freq), self._counts, up(remaining), up(eos_arr),
                self.cfg, self.chunk_steps, self.spec_width,
                kernel=self.use_kernel,
            )
        # the chunk's one host sync: the results the delivery loop reads
        toks_host = tokens.cpu().numpy()
        n_tok_host = n_tok.cpu().numpy()
        n_exec = int(n_exec)
        chunk_dur = time.monotonic() - t_chunk
        for s, g in grants.items():
            req = self._prefilling[s]
            req.prefill_pos += g
            self._count("prefill_chunks")
            self._count("prefill_tokens", g)
            self._trace(req, "prefill_chunk", dur_s=chunk_dur, tokens=g,
                        pos=req.prefill_pos)
        now = time.monotonic()
        for s in completing:
            req = self._prefilling.pop(s)
            req.prefill_done_t = now
            self._trace(
                req, "prefill",
                dur_s=(now - req.admit_t) if req.admit_t else None,
                tokens=req.prefill_pos,
            )
            self._active[s] = True
        if emit.any():
            self._count("decode_steps", n_exec)
            self._count("slot_steps_total", n_exec * S)
        delivered_total = 0
        for s in range(S):
            if not emit[s]:
                continue
            req = self._slots[s]
            finished = False
            emitted = 0
            for i in range(int(n_tok_host[s])):
                tok = int(toks_host[s, i])
                self._tok[s] = tok
                emitted += 1
                if self._emit(req, tok):
                    finished = True
                    break
            self._steps[s] += emitted
            self._count("slot_steps_live", emitted)
            delivered_total += emitted
            if finished:
                self._evict(s)
        self.recorder.record(
            live_slots=self.live_slots,
            prefilling=len(self._prefilling),
            decode_steps=n_exec if bool(emit.any()) else 0,
            prefill_granted=int(sum(grants.values())),
            tokens_emitted=delivered_total,
            pages_free=self.alloc.n_free,
            preemptions=int(self._stat["preemptions"].value),
            chunk_ms=round(chunk_dur * 1e3, 3),
            host_ms=self._host_gap_ms,
        )
        self._refresh_prefix_digest()
        return self.has_work()

    def _refresh_prefix_digest(self) -> None:
        """Rebuild the resident-chain digest when trie membership changed
        (stepping thread only; readers see an atomically swapped dict)."""
        if self.prefix is not None and (
            self.prefix.version != self._digest_version
        ):
            self._digest_version = self.prefix.version
            self._prefix_digest = self.prefix.digest()

    def run_until_idle(self) -> None:
        """Drive the loop to quiescence (tests, local serving)."""
        while self.step_chunk():
            pass

    def close(self, error: BaseException | None = None) -> None:
        """Fail everything still queued or in flight, then check page
        conservation. A real error dumps the flight recorder into
        ``recorder.last_dump``."""
        err = error or RuntimeError("continuous engine closed")
        if error is not None:
            self.recorder.dump(error)
        with self._lock:
            pending = self.sched.pending()
            for req in pending:
                self.sched.remove(req)
        for s in range(self.max_slots):
            req = self._slots[s]
            if req is not None:
                req.error = err
                self._evict(s)
        for req in pending:
            req.error = err
            self._finish(req, finished=False)
        self.check_page_conservation()


__all__ = [
    "ContinuousEngine", "ContinuousRequest", "pack_prefill_budgets",
]
