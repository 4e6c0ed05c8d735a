"""Continuous-batching engine over the paged KV cache (port of
``tensorlink_tpu/engine/continuous.py``).

The engine decodes a fixed slot batch (``max_slots``) in chunks; every
chunk boundary admits queued requests into free slots and returns
finished slots' pages to the free-list. Admission walks the tiered prefix
cache (the HBM trie, then the host-RAM tier, then a sibling replica
through ``fetch_prefix``), copy-on-writes the first divergent page, and
queues the rest of the prompt for chunked prefill. Each chunk runs ONE
step (``engine/paged.py::paged_ragged_step``): every mid-prefill slot's
next prompt piece, every decoding slot's next token and any speculating
slot's draft tokens ride one packed ``[slots, chunk]`` block, then the
decode continuation runs ``chunk_steps - 1`` more slot-batched steps. The
host reads the results once per chunk.

Around the step: speculative decoding (prompt-lookup drafts verified in
the step, ``spec_decode``), live slot migration (freeze, export, stage,
adopt; drain and the prefill→decode handoff), live weight publish with a
version-fenced prefix cache, the host-RAM prefix tier with fleet pulls,
and co-hosting several engines on one ``SharedPagePool``.

Determinism contract (as in the JAX package): token ``n`` of a request
draws from ``fold_in(PRNGKey(seed), n)`` and a slot's logits depend only
on its own pages, so a stream is token-for-token the same whether the
request runs alone, co-batched, admitted mid-flight, resumed after a
preemption, migrated, or speculating, with the prefix cache on or off.

On a CUDA device the step's attention runs the CUDA kernels
(``use_kernel``); on the CPU it runs their plain versions. KV pages are
full precision, int8 or packed int4 (``kv_quant``; a ``quant="int8+kv"``
engine forces int8). Tensor parallelism is not in this slice and raises.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..core import faults
from ..core.metrics import MetricsRegistry
from ..core.serialization import content_digest, dtype_name as np_dtype_name
from ..core.trace import FlightRecorder, get_tracer
from ..models.quant import QTensor
from .generate import GenerationEngine
from .kvtier import HostPagePool
from .paged import (
    PageAllocator,
    PagedKVCache,
    PrefixCache,
    SharedPagePool,
    bind_slot,
    clear_slot,
    copy_page,
    dtype_name,
    gather_page,
    paged_ragged_step,
    pages_needed,
    scatter_page,
)
from .sampling import SamplingParams
from .scheduler import (
    DEFAULT_PRIORITY,
    PRIORITY_CLASSES,
    PRIORITY_RANK,
    RequestScheduler,
    SchedulerOverloaded,
    normalize_priority,
)
from .spec import SpecController

_log = logging.getLogger("tensorlink_tpu_torch.engine")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _blob_dtype(a) -> str:
    """The dtype name of a blob's payload array (``"bfloat16"`` for the
    16-bit host payload)."""
    return np_dtype_name(np.asarray(a).dtype)


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


# the engine's counter families: (serving_snapshot key, metric name, help)
# — the JAX engine's keys and names
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
    ("migrations_started", "tlink_engine_migrations_started_total",
     "slots frozen for export (source side)"),
    ("migrations_completed", "tlink_engine_migrations_completed_total",
     "migrations whose pages shipped and committed (source side)"),
    ("migrations_failed", "tlink_engine_migrations_failed_total",
     "migrations aborted or fallen back (source side)"),
    ("migrations_fell_back", "tlink_engine_migrations_fell_back_total",
     "streams redirected down the re-prefill rung"),
    ("migrations_adopted", "tlink_engine_migrations_adopted_total",
     "staged migrations adopted into a slot (destination side)"),
    ("handoffs_started", "tlink_engine_handoffs_started_total",
     "prefill-completed slots frozen for prefill→decode handoff"),
    ("handoffs_completed", "tlink_engine_handoffs_completed_total",
     "handoffs whose pages shipped and committed (source side)"),
    ("handoffs_fell_back", "tlink_engine_handoffs_fell_back_total",
     "handoffs that fell back (re-prefill redirect or local resume)"),
    ("spec_drafted", "tlink_engine_spec_drafted_total",
     "draft tokens packed for in-step verification"),
    ("spec_accepted", "tlink_engine_spec_accepted_total",
     "draft tokens accepted by in-step verification"),
    ("spec_verify_passes", "tlink_engine_spec_verify_passes_total",
     "verify passes executed (one per speculating slot per step)"),
    ("spec_killed", "tlink_engine_spec_killed_total",
     "requests whose acceptance-rate kill switch fired"),
    ("preempted_cross_tenant", "tlink_engine_preempted_cross_tenant_total",
     "slots preempted for another tenant's higher-ranked candidate"),
    ("weights_published", "tlink_engine_weights_published_total",
     "weight versions hot-swapped into the serving engine"),
    ("train_steps", "tlink_engine_train_steps_total",
     "background train steps run between serving chunks"),
    ("prefix_demotions", "tlink_engine_prefix_demotions_total",
     "refcount-0 prefix pages demoted to the host-RAM tier at eviction"),
    ("host_tier_hits", "tlink_engine_host_tier_hits_total",
     "pages promoted from the host tier back into HBM at admission"),
    ("fleet_pulls", "tlink_engine_fleet_pulls_total",
     "admissions that attempted a cross-replica prefix pull"),
    ("fleet_pull_fallbacks", "tlink_engine_fleet_pull_fallbacks_total",
     "fleet pulls that degraded to the next rung (local prefill)"),
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
    # -- live migration --------------------------------------------------
    # staged-adoption ticket id: admission binds the shipped KV pages
    # instead of prefilling (engine._migrations); cleared on fallback
    adopt: str | None = None
    # -- prefill→decode handoff ------------------------------------------
    # on a handoff-armed engine the prefill stops ONE token short of the
    # prompt and the slot freezes for shipment; the destination feeds the
    # last prompt token as its first decode row and makes the first draw
    handoff: bool = False
    # opaque transport context a worker layer attaches for redirection
    client_meta: dict | None = None
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
    # deepest tier that fed the hit region: "none" | "hbm" | "host" | "fleet"
    cache_tier: str = "none"
    # the weights version this request was ADMITTED under: its pages may
    # promote into the prefix cache only while it equals the engine's
    weights_version: int = 0
    # -- speculative decoding (engine/spec.py) ----------------------------
    # the request opted in; only effective on a spec_decode engine
    speculative: bool = False
    # per-request drafting state (made at the first decode pack; survives
    # preemption so the kill switch never re-probes; NOT shipped by a
    # migration — the destination re-probes)
    spec_state: object = None


class ContinuousEngine:
    """Slot-batched continuous decode over one GenerationEngine's model.

    Single-stepper discipline: ``submit`` is thread-safe; ``step_chunk``
    and every migration, tier and publish verb run on one stepping thread
    (a ContinuousBatcher's dispatcher through ``run_on_driver``, or the
    caller's loop).
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
        host_tier_pages: int = 0,
        kv_quant: str = "none",
        prefill_budget: int = 0,
        spec_decode: bool = False,
        spec_draft: int = 8,
        spec_budget: int = 0,
        sched_queue_cap: int = 64,
        sched_aging_ticks: int = 32,
        sched_preemption: bool = True,
        sched_policy: str = "slo",
        sched_max_wait_s: float = 60.0,
        default_priority: str = DEFAULT_PRIORITY,
        migration_ttl_s: float = 120.0,
        handoff_after_prefill: bool = False,
        worker_role: str = "mixed",
        trace_site: str = "",
        metrics: MetricsRegistry | None = None,
        flight_capacity: int = 256,
        pool: SharedPagePool | None = None,
        model_id: str = "",
        page_quota: int = 0,
        tensor_parallel: int = 1,
    ):
        if engine.cfg.sliding_window is not None:
            raise ValueError(
                "continuous batching does not support sliding-window "
                "attention"
            )
        if int(prefill_chunk) <= 0:
            raise ValueError("prefill_chunk must be >= 1")
        kv_quant = str(kv_quant or "none")
        if engine.cache_quant and kv_quant == "none":
            # the model spec asked for an int8 KV cache ("int8+kv")
            kv_quant = "int8"
        if kv_quant not in ("none", "int8", "int4"):
            raise ValueError(f"unknown kv_quant mode {kv_quant!r}")
        if int(tensor_parallel or 1) > 1:
            raise NotImplementedError(
                "tensor_parallel > 1 is not ported yet — it arrives with "
                "the tensor-parallel slice of the port"
            )
        self.kv_quant = kv_quant
        self.engine = engine
        self.cfg = engine.cfg
        self.device = engine.device
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.chunk_steps = max(int(chunk_steps), 1)
        self.max_seq_len = engine.max_seq_len
        # the CUDA kernels on the card; their plain versions on the CPU
        self.use_kernel = self.device.type == "cuda"
        self.tensor_parallel = 1
        # -- co-hosting: with a shared pool the page tensors live in the
        # pool and this engine keeps only its own block tables + lengths;
        # `self.cache` is a view stitching the two
        self.pool = pool
        self.model_id = str(model_id or "default")
        if pool is not None:
            n_pp = pages_needed(self.max_seq_len, self.page_size)
            self._bt = torch.zeros((self.max_slots, n_pp), dtype=torch.int32,
                                   device=self.device)
            self._lengths = torch.zeros((self.max_slots,), dtype=torch.int32,
                                        device=self.device)
            # pool.attach is the LAST statement of __init__: a failure
            # after it would wedge the tenant id on the pool
            self.alloc = None
        else:
            self.cache = PagedKVCache.init(
                self.cfg, self.max_slots, page_size=self.page_size,
                max_len=self.max_seq_len, dtype=engine.cache_dtype,
                kv_quant=kv_quant, device=self.device,
            )
            self.alloc = PageAllocator(self.cache.n_pages)
        self.prefill_chunk = min(int(prefill_chunk), self.max_seq_len)
        self.prefix = PrefixCache(self.page_size) if prefix_cache else None
        # -- tiered prefix cache: refcount-0 pages the trie evicts DEMOTE
        # to host RAM, and admission PROMOTES host-resident chains back
        self.host_tier = None
        if int(host_tier_pages) > 0 and self.prefix is not None:
            self.host_tier = HostPagePool(int(host_tier_pages), self.page_size)
            self.prefix.spill = self._demote_page
        # rung 3 of the admission ladder: an optional hook
        # ``(chain_tokens, limit, n_local_pages) -> blob | None`` fetching
        # the prefix pages from a sibling replica (fleet/prefixmap.py);
        # any failure inside it degrades to local prefill
        self.fetch_prefix = None
        # device pages pinned by an in-progress tier transfer (allocated,
        # being byte-filled, not yet trie-resident)
        self._tier_pinned: list[int] = []
        self._host_digest: dict = {}
        self._host_digest_version = -1
        self._prefix_digest: dict = {}
        self._digest_version = -1
        # optional TOTAL prefill tokens per step across mid-prefill slots
        # (0 = each slot gets a full chunk row)
        self.prefill_budget = int(prefill_budget)
        # -- speculative decoding: spec_width is the step's static verify
        # row count; per-slot draft lengths are data. Drafts ride the
        # block row's columns, so the width caps at the chunk row.
        self.spec_decode = bool(spec_decode)
        self.spec_draft = max(0, min(int(spec_draft), self.prefill_chunk - 1))
        self.spec_width = 1 + (self.spec_draft if self.spec_decode else 0)
        # optional TOTAL draft tokens per step across speculating slots
        self.spec_budget = int(spec_budget)
        self._spec_phase = 0  # round-robin origin for a draft budget
        self._prefilling: dict[int, ContinuousRequest] = {}
        # -- live slot migration: frozen slots stop stepping and their
        # pages count IN TRANSIT until commit/abort; staged inbound
        # adoptions mig_id -> {pages, nodes, chain, length, last_tok,
        # prefill_target, weights_version, t}
        self._frozen: set[int] = set()
        self._migrations: dict[str, dict] = {}
        self.migration_ttl_s = float(migration_ttl_s)
        self.drain_state = "serving"  # "serving" | "draining"
        # -- prefill→decode handoff: opted-in slots freeze at the prefill
        # boundary and wait in _handoff_ready for the stepping thread to ship;
        # admission stays open meanwhile
        self.handoff_after_prefill = bool(handoff_after_prefill)
        self.worker_role = str(worker_role or "mixed")
        self._handoff_ready: list[int] = []
        self._pack_phase = 0
        self._lock = threading.Lock()
        self.default_priority = normalize_priority(default_priority)
        self.tracer = get_tracer()
        self.trace_site = str(trace_site)
        self.recorder = FlightRecorder(flight_capacity)
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
        self.metrics.gauge(
            "tlink_engine_pages_in_transit",
            "pages held by in-flight migrations (either side)",
            fn=lambda: self._pages_in_transit(),
        )
        self.metrics.gauge(
            "tlink_engine_host_tier_resident_pages",
            "prefix pages resident in the host-RAM tier",
            fn=lambda: self.host_tier.n_resident if self.host_tier else 0,
        )
        self._tier_hist = self.metrics.histogram(
            "tlink_engine_tier_fetch_ms",
            "host-tier promote / fleet prefix pull latency per page (ms)",
            buckets=(0.05, 0.2, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                     100.0, 250.0, 1000.0),
        )
        self.metrics.gauge(
            "tlink_engine_spec_decode",
            "1 when speculative decoding is enabled on this engine",
            fn=lambda: int(self.spec_decode),
        )
        # the weights version this engine serves: 1 for the loaded
        # weights, bumped on every publish_weights
        self.weights_version = 1
        self._train_step_ms = 0.0
        self._train_mfu = 0.0
        self.metrics.gauge(
            "tlink_engine_weights_version",
            "model weights version this engine serves (bumps per publish)",
            fn=lambda: self.weights_version,
        )
        self.metrics.gauge(
            "tlink_engine_train_step_ms",
            "last background train step wall time (ms)",
            fn=lambda: self._train_step_ms,
        )
        self.metrics.gauge(
            "tlink_engine_train_mfu",
            "model FLOPs utilization of the last background train step",
            fn=lambda: self._train_mfu,
        )
        # host work between the previous chunk's sync and this chunk's
        # dispatch (admission, packing, draft lookup), ms
        self._host_gap_ms = 0.0
        self.metrics.gauge(
            "tlink_engine_host_gap_ms",
            "host work between chunk syncs (admission + grant assembly), ms",
            fn=lambda: self._host_gap_ms,
        )
        if pool is not None:
            self.metrics.gauge(
                "tlink_engine_pool_quota",
                "this tenant's page quota on the shared pool",
                fn=lambda: self.alloc.quota,
            )
            self.metrics.gauge(
                "tlink_engine_pool_pages_used",
                "pages this tenant holds (slots + cached + in transit)",
                fn=lambda: self.alloc.used,
            )
            self.metrics.gauge(
                "tlink_engine_pool_pages_free",
                "free pages on the shared pool (all tenants)",
                fn=lambda: self.pool.alloc.n_free,
            )
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
        if pool is not None:
            # nothing fallible may follow
            self.alloc = pool.attach(self.model_id, self,
                                     quota=int(page_quota))

    @property
    def cache(self) -> PagedKVCache:
        """This engine's paged-cache view. A solo engine owns its cache; a
        pool tenant stitches the SHARED page tensors to its own block
        tables and lengths. Steps and page operations write the page
        tensors in place, so the next tenant's step reads them."""
        if self.pool is None:
            return self._cache
        kv = self.pool.kv
        ks, vs = (kv[2], kv[3]) if len(kv) == 4 else (None, None)
        return PagedKVCache(
            k=kv[0], v=kv[1], block_tables=self._bt,
            lengths=self._lengths, k_scale=ks, v_scale=vs,
        )

    @cache.setter
    def cache(self, value: PagedKVCache) -> None:
        if self.pool is None:
            self._cache = value
            return
        self.pool.kv = (
            (value.k, value.v) if value.k_scale is None
            else (value.k, value.v, value.k_scale, value.v_scale)
        )
        self._bt = value.block_tables
        self._lengths = value.lengths

    @property
    def stats(self) -> dict:
        """The counters as a plain dict (the JAX engine's key set)."""
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
        adopt: str | None = None,
        trace_id: str | None = None,
        speculative: bool = False,
        handoff: bool = False,
    ) -> ContinuousRequest:
        """Queue a request; the scheduler decides when it joins the slot
        batch. ``start_step`` > 0 resumes a key chain (the prompt then
        carries the original prompt + tokens already delivered). Past the
        class queue cap the request fails at once with
        :class:`SchedulerOverloaded` on ``req.error``. ``adopt`` names a
        staged migration ticket (:meth:`stage_migration`): admission binds
        the shipped pages instead of prefilling, or re-prefills when the
        ticket is missing or stale. ``speculative`` opts into draft/verify
        decoding on a ``spec_decode`` engine (the stream is the same
        either way). ``handoff`` marks the request for the prefill→decode
        handoff on a ``handoff_after_prefill`` engine (prompts of one
        token are exempt)."""
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
            adopt=adopt,
            trace_id=str(trace_id or ""),
            speculative=bool(speculative) and self.spec_decode,
            handoff=(
                bool(handoff) and self.handoff_after_prefill
                and len(prompt) > 1
            ),
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
                        queue_depth=overload.queue_depth,
                        retry_after=overload.retry_after)
            # the stepping thread's next GC sweep frees the ticket's pages (submit
            # may run on a client thread: never touch the allocator here)
            self._expire_ticket(req)
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

    def router_snapshot(self) -> dict:
        """Placement view for a fleet router: headroom, per-class queue
        depth, service EWMA, role and drain state, and both cache tiers'
        digests as the stepping thread last refreshed them. No device
        work."""
        with self._lock:
            depth = {c: self.sched.depth(c) for c in PRIORITY_CLASSES}
            ewma = self.sched._service_ewma
        return {
            "draining": self.drain_state != "serving",
            "worker_role": self.worker_role,
            "max_slots": self.max_slots,
            "slots_free": sum(1 for r in self._slots if r is None),
            "kv_pages_free": self.alloc.n_free,
            "kv_pages_total": self.cache.n_pages - 1,
            "service_ewma_s": float(ewma),
            "queue_depth": depth,
            "prefix_digest": self._prefix_digest,
            "host_tier_digest": self._host_digest,
        }

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
        ``req.tokens`` non-empty: it re-prefills prompt + emitted. A
        request naming a staged ticket that matches adopts its pages."""
        seq = req.prompt + req.tokens
        if len(seq) > self.max_seq_len:
            req.error = ValueError(
                f"prompt length {len(seq)} exceeds max_seq_len "
                f"{self.max_seq_len}"
            )
            self._drop_ticket(req)
            self._finish(req, finished=False)
            return True
        room = self.max_seq_len - len(seq)
        eff = min(req.budget - len(req.tokens), room)
        if eff <= 0:
            self._drop_ticket(req)
            self._finish(req, finished=True)
            return True
        req.budget = len(req.tokens) + eff
        total = min(len(seq) + eff, self.max_seq_len)
        if req.adopt is not None:
            ticket = self._migrations.get(req.adopt)
            if ticket is not None and self._ticket_matches(ticket, seq):
                return self._admit_adopted(req, slot, total, ticket)
            # missing / stale ticket: the request carries the full resume
            # shape, so the next rung is the re-prefill below
            self._drop_ticket(req)
        req.prefill_tokens = seq
        req.prefill_target = len(seq)
        return self._admit_paged(req, slot, total)

    def _alloc_pages(self, n: int) -> list[int] | None:
        """All-or-nothing page grab; when short, evicts unreferenced cached
        prefixes LRU-leaf-first — but only when that can cover the
        deficit. On a shared pool, other tenants' cold prefixes reclaim
        next, but only while this tenant's quota has room."""
        pages = self.alloc.alloc(n)
        if pages is None and self.prefix is not None:
            deficit = n - self.alloc.n_free
            if deficit > 0 and self.prefix.n_evictable() >= deficit:
                self.alloc.free(self.prefix.evict(deficit))
                pages = self.alloc.alloc(n)
        if pages is None and self.pool is not None:
            quota_room = self.alloc.quota - self.alloc.used
            deficit = n - self.pool.alloc.n_free
            if n <= quota_room and 0 < deficit <= self.pool.reclaim_cache(
                deficit, self
            ):
                pages = self.alloc.alloc(n)
        return pages

    def _admit_paged(self, req: ContinuousRequest, slot: int,
                     total: int) -> bool:
        """Chunked-prefill admission down the tiered-cache ladder: (1) the
        longest chain of full pages resident in the trie, (2) extended by
        host-tier promotes, (3) then by a fleet pull, (4) copy-on-write of
        the first divergent page; then private pages for the rest and the
        non-hit suffix queued for chunked prefill. Every rung fails safe
        to the next."""
        seq = req.prefill_tokens
        T = len(seq)
        hit_nodes: list = []
        cow = None
        if self.prefix is not None:
            # at least ONE token must prefill, so the last prompt
            # position's logits exist for the first draw
            limit = T - 1
            hit_nodes = self.prefix.match(seq, limit)
            # pin the chain first: the tier rungs allocate, and eviction
            # must not free the chain we stand on
            self.prefix.acquire(hit_nodes)
            req.cache_tier = "hbm" if hit_nodes else "none"
            if self.host_tier is not None:
                n0 = len(hit_nodes)
                hit_nodes = self._promote_chain(seq, limit, hit_nodes)
                if len(hit_nodes) > n0:
                    req.cache_tier = "host"
            if (
                self.fetch_prefix is not None
                and limit - len(hit_nodes) * self.page_size
                >= self.page_size
            ):
                n0 = len(hit_nodes)
                hit_nodes = self._pull_chain(seq, limit, hit_nodes)
                if len(hit_nodes) > n0:
                    req.cache_tier = "fleet"
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

    # -- tiered prefix cache ---------------------------------------------
    def _demote_page(self, node) -> None:
        """The demote seam (``PrefixCache.spill``): an evicted refcount-0
        page's bytes move to the host tier instead of dying with the page
        id (they are still intact on the card when the trie calls this).
        Best-effort: an injected fault destroys the page instead, as
        without the tier; an injected crash propagates."""
        if node.weights_version != self.prefix.weights_version:
            return  # publish-fenced: stale-weights KV must not survive
        try:
            if faults.ENABLED:
                faults.inject("kvtier.demote", "demote:" + node.key_hash)
            got = gather_page(self.cache, node.page)
        except faults.FaultInjected:
            return
        blocks: list[tuple] = []
        walk = node
        while walk is not None and walk.parent is not None:
            blocks.append(walk.block)
            walk = walk.parent
        blocks.reverse()
        self.host_tier.put(
            tuple(blocks), got[0], got[1],
            got[2] if len(got) == 4 else None,
            got[3] if len(got) == 4 else None,
            weights_version=node.weights_version,
        )
        self._count("prefix_demotions")

    def _promote_chain(self, seq, limit: int, hit_nodes: list) -> list:
        """Rung 2: extend the trie hit chain with host-tier residents. Each
        promoted page is a fresh allocation filled by ``scatter_page``,
        inserted into the trie and pinned like any other hit node — the
        demoted payload is the prefill's exact bytes, so the hit is
        bitwise a cold re-prefill. Any failure stops the walk."""
        p = self.page_size
        node = hit_nodes[-1] if hit_nodes else None
        blocks = [
            tuple(int(t) for t in seq[i * p : (i + 1) * p])
            for i in range(limit // p)
        ]
        while len(hit_nodes) < len(blocks):
            depth = len(hit_nodes) + 1
            entry = self.host_tier.lookup(
                tuple(blocks[:depth]), self.prefix.weights_version
            )
            if entry is None:
                break
            t0 = time.monotonic()
            pages = self._alloc_pages(1)
            if pages is None:
                break  # allocator dry: the suffix prefills instead
            pid = pages[0]
            self._tier_pinned.append(pid)
            try:
                if faults.ENABLED:
                    faults.inject("kvtier.fetch", "promote:" + entry.key_hash)
                self.cache = scatter_page(
                    self.cache, pid, entry.k, entry.v, entry.k_scale,
                    entry.v_scale,
                )
            except faults.FaultInjected:
                self._tier_pinned.remove(pid)
                self.alloc.free([pid])
                break
            except BaseException:
                self._tier_pinned.remove(pid)
                self.alloc.free([pid])
                raise
            self._tier_pinned.remove(pid)
            freed: list[int] = []
            new_node, adopted = self.prefix.insert(
                node, blocks[depth - 1], pid, freed=freed
            )
            self.alloc.free(freed)
            if not adopted:
                self.alloc.free([pid])
            self.prefix.acquire([new_node])
            hit_nodes.append(new_node)
            node = new_node
            self._count("host_tier_hits")
            self._tier_hist.observe((time.monotonic() - t0) * 1e3)
        return hit_nodes

    def _pull_chain(self, seq, limit: int, hit_nodes: list) -> list:
        """Rung 3: on a still-short chain, ask the fleet hook for a
        sibling's prefix pages, stage them into the trie and re-walk the
        match. A dead sibling, a refused staging or an injected fault all
        fall through to local prefill (``fleet_pull_fallbacks``)."""
        p = self.page_size
        n_local = len(hit_nodes)
        chain = [int(t) for t in seq[: (limit // p) * p]]
        self._count("fleet_pulls")
        t0 = time.monotonic()
        staged = 0
        try:
            if faults.ENABLED:
                faults.inject("kvtier.fetch", f"pull:{len(chain)}")
            blob = self.fetch_prefix(chain, limit, n_local)
            if blob is not None:
                staged = self.stage_prefix(blob)
        except faults.FaultInjected:
            staged = 0
        except Exception as e:  # noqa: BLE001 — degrade to local prefill
            _log.debug("fleet prefix pull failed (falling back to "
                       "prefill): %s", e)
            staged = 0
        if staged > n_local * p:
            ext = self.prefix.match(seq, limit)
            if len(ext) > n_local and ext[:n_local] == hit_nodes:
                self.prefix.acquire(ext[n_local:])
                self._tier_hist.observe((time.monotonic() - t0) * 1e3)
                return ext
        self._count("fleet_pull_fallbacks")
        return hit_nodes

    def _page_payload(self, pages) -> dict:
        """The host copies of ``pages`` stacked as a blob's payload:
        ``k``/``v`` ``[n, L, n_kv, page, hd]`` (+ the scales)."""
        payload: dict[str, list] = {"k": [], "v": [], "ks": [], "vs": []}
        for pid in pages:
            got = gather_page(self.cache, pid)
            payload["k"].append(got[0])
            payload["v"].append(got[1])
            if len(got) == 4:
                payload["ks"].append(got[2])
                payload["vs"].append(got[3])
        return payload

    @staticmethod
    def _sign(blob: dict) -> None:
        """The integrity tag over the blob's KV payload."""
        blob["digest"] = content_digest(
            {f: blob[f] for f in ("k", "v", "k_scale", "v_scale")
             if f in blob}
        )

    @staticmethod
    def _signed_ok(blob: dict) -> bool:
        if not blob.get("digest"):
            return True
        got = content_digest(
            {f: np.asarray(blob[f])
             for f in ("k", "v", "k_scale", "v_scale") if f in blob}
        )
        return got == blob["digest"]

    def export_prefix_pages(
        self, chain, limit: int, *, n_skip: int = 0
    ) -> dict | None:
        """Source side of a fleet prefix pull: the resident prefix pages
        of ``chain`` past the first ``n_skip``, as a blob shaped like a
        migration export (same storage-mode triple, same payload digest).
        Read-only. None when nothing useful is resident."""
        if self.prefix is None:
            return None
        chain = [int(t) for t in chain]
        limit = min(int(limit), (len(chain) // self.page_size)
                    * self.page_size)
        nodes = self.prefix.match(chain, limit)
        n_skip = max(0, int(n_skip))
        if len(nodes) <= n_skip:
            return None
        self.prefix.acquire(nodes)
        try:
            if faults.ENABLED:
                faults.inject("kvtier.fetch", f"export:{len(nodes)}")
            payload = self._page_payload([n.page for n in nodes[n_skip:]])
        finally:
            self.prefix.release(nodes)
        blob = {
            "blob_v": 2,
            "chain": np.asarray(
                chain[: len(nodes) * self.page_size], np.int32
            ),
            "n_skip": int(n_skip),
            "page_size": int(self.page_size),
            "kv_quant": self.kv_quant,
            "dtype": dtype_name(self.cache.k.dtype),
            # match() returns current-version nodes only
            "weights_version": int(self.weights_version),
            "k": np.stack(payload["k"]),
            "v": np.stack(payload["v"]),
        }
        if payload["ks"]:
            blob["k_scale"] = np.stack(payload["ks"])
            blob["v_scale"] = np.stack(payload["vs"])
        self._sign(blob)
        return blob

    def stage_prefix(self, blob: dict) -> int:
        """Destination side of a fleet prefix pull: check a sibling's
        prefix blob (storage-mode triple, weights version, payload
        digest) and adopt its pages into the trie as refcount-0
        residents. Returns the leading chain tokens now resident (0 =
        refused). An allocator that dries up mid-blob keeps what it
        staged."""
        if self.prefix is None:
            return 0
        ours = self.migration_mode()
        theirs = (
            str(blob.get("kv_quant", "none")),
            int(blob["page_size"]),
            str(blob.get("dtype") or ours[2]),
        )
        if theirs != ours:
            _log.warning("refusing pulled prefix: storage mode %r does not "
                         "match ours %r — falling back to prefill",
                         theirs, ours)
            return 0
        if int(blob.get("weights_version", 0)) != self.weights_version:
            return 0  # per-tier publish fence
        chain = [int(t) for t in np.asarray(blob["chain"]).reshape(-1)]
        p = self.page_size
        n_total = len(chain) // p
        n_skip = int(blob.get("n_skip", 0))
        k = np.asarray(blob["k"])
        v = np.asarray(blob["v"])
        n_ship = int(k.shape[0]) if k.ndim > 1 else 0
        if n_total == 0 or n_skip + n_ship != n_total:
            return 0
        if n_ship and _blob_dtype(k) != ours[2]:
            return 0
        if not self._signed_ok(blob):
            return 0  # corrupted transfer → prefill rung
        nodes = self.prefix.match(chain, n_total * p)
        if len(nodes) < n_skip:
            return 0  # the promised local prefix was evicted mid-pull
        node = nodes[-1] if nodes else None
        self.prefix.acquire(nodes)
        try:
            for i in range(len(nodes), n_total):
                pages = self._alloc_pages(1)
                if pages is None:
                    break  # keep what we staged; the rest prefills
                pid = pages[0]
                self._tier_pinned.append(pid)
                try:
                    j = i - n_skip  # index into the shipped payload
                    self.cache = scatter_page(
                        self.cache, pid, k[j], v[j],
                        *((blob["k_scale"][j], blob["v_scale"][j])
                          if self.cache.quantized else ()),
                    )
                except BaseException:
                    self._tier_pinned.remove(pid)
                    self.alloc.free([pid])
                    raise
                self._tier_pinned.remove(pid)
                freed: list[int] = []
                block = tuple(chain[i * p : (i + 1) * p])
                new_node, adopted = self.prefix.insert(
                    node, block, pid, freed=freed
                )
                self.alloc.free(freed)
                if not adopted:
                    self.alloc.free([pid])
                # pin through our own later allocations in this loop
                self.prefix.acquire([new_node])
                nodes.append(new_node)
                node = new_node
        finally:
            self.prefix.release(nodes)
        return len(nodes) * p

    # -- live slot migration (adopt side) --------------------------------
    def _drop_ticket(self, req: ContinuousRequest) -> None:
        """Release a request's staged-adoption ticket (fallback, early
        finish). Stepping thread only: it frees pages."""
        if req.adopt is not None:
            self.drop_staged_migration(req.adopt)
            req.adopt = None

    def _expire_ticket(self, req: ContinuousRequest) -> None:
        """Client-thread-safe ticket release: expire the ticket in place so
        the stepping thread's next GC sweep frees its pages."""
        if req.adopt is None:
            return
        ticket = self._migrations.get(req.adopt)
        if ticket is not None:
            ticket["t"] = float("-inf")
        req.adopt = None

    @staticmethod
    def _ticket_matches(ticket: dict, seq: list[int]) -> bool:
        """A staged ticket is usable only when the resubmitted sequence is
        EXACTLY the chain whose KV was shipped."""
        return (
            ticket["chain"] == seq
            and ticket["length"] == len(seq) - 1
            and ticket["last_tok"] == seq[-1]
        )

    def _admit_adopted(self, req: ContinuousRequest, slot: int,
                       total: int, ticket: dict) -> bool:
        """Bind a staged migration's pages into ``slot`` and resume
        decoding: the shipped pages (the source's KV bytes) plus any
        locally resident prefix become the block table, growth pages
        cover the rest of the budget, and sampling re-arms at
        ``fold_in(seed, start_step)`` — the draw the source would have
        made next, so the stream continues unchanged. False while the
        growth pages are short (the ticket is kept)."""
        seq = req.prompt + req.tokens
        length = int(ticket["length"])
        n_skip = len(ticket["nodes"])
        n_have = n_skip + len(ticket["pages"])
        grow = self._alloc_pages(
            max(pages_needed(total, self.page_size) - n_have, 0)
        )
        if grow is None:
            return False
        bt_row = np.zeros(self.cache.pages_per_slot, np.int32)
        bt_row[:n_skip] = [n.page for n in ticket["nodes"]]
        bt_row[n_skip:n_have] = ticket["pages"]
        bt_row[n_have : n_have + len(grow)] = grow
        self.cache = bind_slot(self.cache, slot, bt_row, length)
        req.slot = slot
        req.pages = list(ticket["pages"]) + grow
        req.shared_nodes = list(ticket["nodes"])
        # only the source's prefill-written region may promote later
        req.prefill_target = int(ticket["prefill_target"])
        req.prefill_tokens = seq[: req.prefill_target]
        req.prefill_pos = length
        self._slots[slot] = req
        self._arm_slot(req, slot, ctx=seq)
        # the adopted KV was computed under the SOURCE's weights version
        req.weights_version = int(ticket.get("weights_version", 0))
        self._tok[slot] = int(ticket["last_tok"])
        self._active[slot] = True
        del self._migrations[req.adopt]
        req.adopt = None
        self._count("admitted")
        self._count("migrations_adopted")
        self._trace(req, "adopt", slot=slot, length=length,
                    pages=len(req.pages), shared=n_skip)
        return True

    def _set_knob_mirrors(self, slot: int, sp: SamplingParams) -> None:
        self._temp[slot] = float(sp.temperature)
        self._topk[slot] = int(sp.top_k)
        self._topp[slot] = float(sp.top_p)
        self._pres[slot] = float(sp.presence_penalty)
        self._freq[slot] = float(sp.frequency_penalty)

    def _arm_slot(self, req: ContinuousRequest, slot: int,
                  ctx=None) -> None:
        """Land the request's sampling state at admission, before its first
        packed block: key index ``start_step + len(tokens)``, knobs, the
        weights version, and the context histogram (of the prefill
        sequence, or ``ctx``: an adopted slot's whole chain)."""
        self._seeds[slot] = req.seed
        self._steps[slot] = req.start_step + len(req.tokens)
        req.weights_version = self.weights_version
        self._set_knob_mirrors(slot, req.sampling)
        if ctx is None:
            ctx = req.prefill_tokens or req.prompt
        self._counts[slot] = self._ctx_counts(req, ctx)

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
            st = req.spec_state
            if st is not None and st.verify_passes:
                self._trace(
                    req, "spec", drafted=st.drafted, accepted=st.accepted,
                    passes=st.verify_passes,
                    tokens_per_pass=round(st.tokens_per_pass or 0.0, 3),
                    killed=st.dead,
                )
            if req.admit_t:
                with self._lock:
                    self.sched.note_finished(
                        req, time.monotonic() - req.admit_t
                    )
            self._finish(req, finished=True)

    def _teardown_slot(self, slot: int) -> ContinuousRequest | None:
        """Shared teardown for eviction, preemption and migration commit:
        device row → scratch, pages released (promotable prefill-written
        pages enter the prefix cache), host mirrors cleared."""
        req = self._slots[slot]
        self._slots[slot] = None
        self._prefilling.pop(slot, None)
        self._frozen.discard(slot)
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
        prefill sequence under the current weights (decode-written KV is
        never cached: a hit must be the KV a prefill would compute)."""
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

    # -- live slot migration (export side) + drain -----------------------
    # The stepping thread freezes a decoding slot at a chunk boundary, exports its
    # KV pages byte-exactly, a destination stages them into fresh pages,
    # and the source commits (teardown without finishing: the stream
    # continues elsewhere). Every rung degrades to the re-prefill resume.

    def freeze_slot(self, slot: int) -> None:
        """Freeze a DECODING slot for export: it stops stepping but keeps
        its pages and request, which page accounting reports in transit.
        Mid-prefill and idle slots refuse. Stepping thread, at a chunk
        boundary."""
        req = self._slots[slot]
        if req is None or not self._active[slot] or slot in self._prefilling:
            raise ValueError(
                f"slot {slot} is not a steady decoding slot — only active "
                "decode slots freeze for migration (mid-prefill and idle "
                "slots take the re-prefill fallback)"
            )
        self._active[slot] = False
        self._frozen.add(slot)
        self._count("migrations_started")
        self._trace(req, "freeze", slot=slot, tokens=len(req.tokens))

    def migration_chain(self, slot: int) -> tuple[list[int], int]:
        """The frozen slot's token chain (prompt + emitted) and the
        prefix-probe limit: resident pages on the destination may stand in
        for shipped bytes only in the PREFILL-written region."""
        req = self._slots[slot]
        assert req is not None and slot in self._frozen
        length = int(self.cache.lengths[slot])
        return req.prompt + req.tokens, min(length, req.prefill_target)

    def export_slot(self, slot: int, *, n_skip: int = 0) -> dict:
        """Serialize a frozen slot into a TLTS-encodable migration blob:
        resume metadata plus the KV bytes of every valid page past the
        first ``n_skip`` (pages the destination reported resident) — the
        JAX package's blob, key for key."""
        req = self._slots[slot]
        if req is None or slot not in self._frozen:
            raise ValueError(f"slot {slot} is not frozen for export")
        t_export = time.monotonic()
        length = int(self.cache.lengths[slot])
        chain, limit = self.migration_chain(slot)
        n_valid_pages = pages_needed(length, self.page_size)
        n_skip = max(0, min(int(n_skip), limit // self.page_size,
                            n_valid_pages))
        row = [n.page for n in req.shared_nodes] + list(req.pages)
        ship = row[n_skip:n_valid_pages]
        payload = self._page_payload(ship)
        blob = {
            "blob_v": 2,
            "chain": np.asarray(chain, np.int32),
            "length": int(length),
            "last_tok": int(self._tok[slot]),
            "prefill_target": int(req.prefill_target),
            "n_skip": int(n_skip),
            "page_size": int(self.page_size),
            "kv_quant": self.kv_quant,
            # the storage-mode triple the importer must match: int4 and
            # int8 pages share the int8 dtype, kv_quant tells them apart
            "dtype": dtype_name(self.cache.k.dtype),
            # the weights version this slot's KV was computed under
            "weights_version": int(req.weights_version),
            "k": np.stack(payload["k"]) if ship else np.zeros(0, np.int8),
            "v": np.stack(payload["v"]) if ship else np.zeros(0, np.int8),
        }
        if payload["ks"]:
            blob["k_scale"] = np.stack(payload["ks"])
            blob["v_scale"] = np.stack(payload["vs"])
        self._sign(blob)
        blob["trace"] = req.trace_id
        self._trace(req, "export", dur_s=time.monotonic() - t_export,
                    pages=len(ship), skipped=n_skip)
        return blob

    def commit_migration(
        self, slot: int, *, fell_back: bool = False
    ) -> ContinuousRequest | None:
        """The frozen slot's stream now lives elsewhere (adopted, or
        redirected down the re-prefill rung): tear the slot down through
        the normal release path WITHOUT finishing the request."""
        if slot not in self._frozen:
            raise ValueError(f"slot {slot} is not frozen")
        req = self._teardown_slot(slot)
        if fell_back:
            self._count("migrations_failed")
            self._count("migrations_fell_back")
            self._trace(req, "migrate_fallback", slot=slot)
        else:
            self._count("migrations_completed")
            self._trace(req, "migrate_commit", slot=slot)
        return req

    def abort_migration(self, slot: int) -> None:
        """Un-freeze: the slot resumes decoding HERE where it stopped
        (export is read-only)."""
        if slot not in self._frozen:
            raise ValueError(f"slot {slot} is not frozen")
        self._frozen.discard(slot)
        self._count("migrations_failed")
        if self._slots[slot] is not None:
            self._active[slot] = True

    def shed_slot(self, slot: int) -> ContinuousRequest | None:
        """Drain fallback for a slot that cannot page-ship: release it
        without finishing the request (the caller redirects the stream to
        a re-prefill elsewhere)."""
        req = self._teardown_slot(slot)
        if req is not None:
            self._count("migrations_fell_back")
            self._trace(req, "migrate_fallback", slot=slot)
        return req

    def shed_queued(self) -> list[ContinuousRequest]:
        """Pop every queued (not yet admitted) request for redirection
        during a drain."""
        with self._lock:
            pending = self.sched.pending()
            for r in pending:
                self.sched.remove(r)
        for r in pending:
            self._drop_ticket(r)
        self._count("migrations_fell_back", len(pending))
        return pending

    def fail_queued(self, req: ContinuousRequest, err: BaseException) -> None:
        """Fail a request popped by :meth:`shed_queued` that has nowhere
        to go."""
        self._drop_ticket(req)
        req.error = err
        self._finish(req, finished=False)

    def begin_drain(self) -> None:
        """Admission fence: submit fails fast and admission_check rejects,
        so a drain can shed every slot without racing new arrivals."""
        self.drain_state = "draining"
        with self._lock:
            self.sched.set_draining(True)

    def end_drain(self) -> None:
        """Lower the fence: serve in place again."""
        self.drain_state = "serving"
        with self._lock:
            self.sched.set_draining(False)

    # -- live weight publish ---------------------------------------------
    def publish_weights(self, params, *, version: int | None = None) -> int:
        """Hot-swap the serving weights at the chunk boundary. Stepping
        thread only.

        The published tree must match the serving tree leaf for leaf
        (structure, shapes, dtypes); it is copied onto the engine's
        device, so no tensor of the serving tree changes shape, dtype or
        device. A weight-quantized engine quantizes the published tree as
        its load did. Live streams continue (their KV is not recomputed);
        admissions from here on prefill under the new weights. The prefix
        cache and the host tier are version-fenced: older chains stop
        matching, their unreferenced pages free now, and requests
        admitted under an older version never promote their pages.
        Returns the new version."""
        new_version = (
            int(version) if version is not None else self.weights_version + 1
        )
        if new_version <= self.weights_version:
            raise ValueError(
                f"weights version must grow: {new_version} <= "
                f"{self.weights_version}"
            )
        eng = self.engine
        staged = _staged(params, self.device)
        if getattr(eng, "quant", None):
            from ..models.quant import quantize_params

            staged = quantize_params(staged)
        why = _tree_mismatch(eng.params, staged)
        if why is not None:
            raise ValueError(
                "published params do not match the serving model's tree "
                f"(leaf shapes/dtypes): {why}"
            )
        eng.params = staged
        self.weights_version = new_version
        if self.prefix is not None:
            self.prefix.weights_version = new_version
            self.alloc.free(self.prefix.drop_all())
            if self.host_tier is not None:
                self.host_tier.drop_stale(new_version)
            self._refresh_prefix_digest()
        self._count("weights_published")
        return new_version

    def note_train_step(self, step_ms: float, mfu: float = 0.0) -> None:
        """Record one background train step's telemetry (stepping thread)."""
        self._train_step_ms = float(step_ms)
        self._train_mfu = float(mfu)
        self._count("train_steps")

    def foreground_work(self, above: str = "best_effort") -> bool:
        """True when any live or queued request outranks ``above`` — the
        background trainer's yield gate. Thread-safe."""
        bar = PRIORITY_RANK[normalize_priority(above)]
        with self._lock:
            if any(
                PRIORITY_RANK.get(r.priority, bar) < bar
                for r in self.sched.pending()
            ):
                return True
        for req in self._slots:
            if req is not None and PRIORITY_RANK.get(req.priority, bar) < bar:
                return True
        return False

    def frozen_slots(self) -> list[int]:
        return sorted(self._frozen)

    def live_manifest(self) -> list[tuple[str, int, ContinuousRequest]]:
        """What a drain must move: ("decode"|"prefill", slot, request) for
        every live, unfrozen slot. Stepping thread."""
        out: list[tuple[str, int, ContinuousRequest]] = []
        for s in range(self.max_slots):
            req = self._slots[s]
            if req is None or s in self._frozen:
                continue
            kind = "prefill" if s in self._prefilling else "decode"
            out.append((kind, s, req))
        return out

    # -- prefill→decode handoff (source side) ----------------------------
    def handoff_manifest(self) -> list[tuple[int, ContinuousRequest]]:
        """Pop the slots frozen at their prefill→decode boundary since the
        last call: the stepping thread ships, redirects or aborts each."""
        ready, self._handoff_ready = self._handoff_ready, []
        return [
            (s, self._slots[s]) for s in ready
            if s in self._frozen and self._slots[s] is not None
        ]

    def commit_handoff(
        self, slot: int, *, fell_back: bool = False
    ) -> ContinuousRequest | None:
        """The handed-off stream now lives on the decode engine (shipped,
        or ``fell_back`` to a re-prefill there): tear the slot down
        without finishing the request."""
        if slot not in self._frozen:
            raise ValueError(f"slot {slot} is not frozen for handoff")
        req = self._slots[slot]
        dur = (
            time.monotonic() - req.prefill_done_t
            if req is not None and req.prefill_done_t else None
        )
        out = self._teardown_slot(slot)
        if fell_back:
            self._count("handoffs_fell_back")
            self._trace(out, "handoff_fallback", slot=slot)
        else:
            self._count("handoffs_completed")
            self._trace(out, "handoff", dur_s=dur, slot=slot)
        return out

    def abort_handoff(self, slot: int) -> None:
        """No usable destination: un-freeze and finish the prefill HERE —
        the next block grants the final prompt token and the first draw
        happens in the step, as on a mixed engine."""
        if slot not in self._frozen:
            raise ValueError(f"slot {slot} is not frozen for handoff")
        self._frozen.discard(slot)
        self._count("handoffs_fell_back")
        req = self._slots[slot]
        if req is not None:
            req.handoff = False
            self._prefilling[slot] = req
            self._trace(req, "handoff_fallback", slot=slot, local=True)

    # -- live slot migration (import side) -------------------------------
    def migration_mode(self) -> tuple[str, int, str]:
        """The (kv_quant, page_size, cache dtype) triple a shipped page
        blob is portable within."""
        return (self.kv_quant, self.page_size,
                dtype_name(self.cache.k.dtype))

    def resident_prefix_pages(self, chain, limit: int) -> int:
        """The probe: how many leading FULL pages of ``chain`` are
        resident in this engine's prefix cache."""
        if self.prefix is None:
            return 0
        return len(self.prefix.match(chain, int(limit)))

    def stage_migration(self, mig_id: str, blob: dict) -> bool:
        """Stage an inbound migration blob: pin the promised resident
        prefix, allocate pages for the shipped rest and write the bytes in
        (one ``scatter_page`` each). Idempotent by ``mig_id``. False when
        the blob cannot be honoured (storage mode, promised prefix gone,
        page count, digest, allocator dry): the source re-prefills. Pages
        stay in transit until a resume adopts them or the TTL/close GC
        frees them."""
        if mig_id in self._migrations:
            return True
        if self.drain_state != "serving":
            return False  # a draining engine must not adopt new streams
        t_stage = time.monotonic()
        ours = self.migration_mode()
        theirs = (
            str(blob.get("kv_quant", "none")),
            int(blob["page_size"]),
            str(blob.get("dtype") or ours[2]),
        )
        if theirs != ours:
            _log.warning(
                "refusing inbound migration %s: storage mode (kv_quant, "
                "page_size, dtype) %r does not match ours %r — source "
                "takes the re-prefill rung", mig_id, theirs, ours,
            )
            return False
        chain = [int(t) for t in np.asarray(blob["chain"]).reshape(-1)]
        length = int(blob["length"])
        limit = min(length, int(blob["prefill_target"]))
        n_skip = int(blob["n_skip"])
        nodes: list = []
        if n_skip:
            if self.prefix is None:
                return False
            nodes = self.prefix.match(chain, limit)[:n_skip]
            if len(nodes) < n_skip:
                return False  # the promised prefix was evicted meanwhile
        k = np.asarray(blob["k"])
        v = np.asarray(blob["v"])
        n_ship = int(k.shape[0]) if k.ndim > 1 else 0
        if n_skip + n_ship != pages_needed(length, self.page_size):
            return False
        if n_ship and _blob_dtype(k) != ours[2]:
            return False  # the bytes are not portable
        if not self._signed_ok(blob):
            return False  # corrupted transfer → re-prefill rung
        pages = self._alloc_pages(n_ship)
        if pages is None:
            return False
        if self.prefix is not None:
            self.prefix.acquire(nodes)
        try:
            for i, pid in enumerate(pages):
                self.cache = scatter_page(
                    self.cache, pid, k[i], v[i],
                    *((blob["k_scale"][i], blob["v_scale"][i])
                      if self.cache.quantized else ()),
                )
        except BaseException:
            self.alloc.free(pages)
            if self.prefix is not None:
                self.prefix.release(nodes)
            raise
        self._migrations[mig_id] = {
            "pages": pages,
            "nodes": nodes,
            "chain": chain,
            "length": length,
            "last_tok": int(blob["last_tok"]),
            "prefill_target": int(blob["prefill_target"]),
            "weights_version": int(blob.get("weights_version", 0)),
            "t": time.monotonic(),
        }
        tid = str(blob.get("trace") or "")
        if tid:
            self.tracer.record(
                tid, "stage", site=self.trace_site,
                dur_s=time.monotonic() - t_stage, pages=n_ship,
                shared=n_skip,
            )
        return True

    def drop_staged_migration(self, mig_id: str) -> None:
        """Free a staged migration's pages (fallback, TTL GC, close)."""
        ticket = self._migrations.pop(mig_id, None)
        if ticket is None:
            return
        self.alloc.free(ticket["pages"])
        if self.prefix is not None:
            self.prefix.release(ticket["nodes"])

    def staged_migrations(self) -> list[str]:
        """Ticket ids staged and awaiting adoption."""
        return list(self._migrations)

    def _gc_staged_migrations(self) -> None:
        """Free staged tickets whose resume never arrived."""
        now = time.monotonic()
        for mig_id in [
            m for m, t in self._migrations.items()
            if now - t["t"] > self.migration_ttl_s
        ]:
            self.drop_staged_migration(mig_id)

    # -- page accounting -------------------------------------------------
    def page_accounting(self) -> dict:
        """Ownership snapshot over physical pages 1..P-1: the free-list,
        the cache-resident set, live slots' pages, the IN-TRANSIT set (a
        frozen slot's pages; a staged ticket's pages) and the pages a tier
        transfer pins mid-copy."""
        slot_pages: list[int] = []
        in_transit: list[int] = []
        for s in range(self.max_slots):
            req = self._slots[s]
            if req is not None:
                (in_transit if s in self._frozen else slot_pages).extend(
                    req.pages
                )
        for ticket in self._migrations.values():
            in_transit.extend(ticket["pages"])
        return {
            "free": set(self.alloc._free),
            "cached": self.prefix.resident_pages if self.prefix else set(),
            "slots": slot_pages,
            "in_transit": in_transit,
            "host_tier": list(self._tier_pinned),
        }

    def check_page_conservation(self) -> None:
        """free + slot-owned + cache-resident + tier-pinned + in-transit
        == total usable pages, pairwise disjoint, scratch page 0 in none
        of them (on a shared pool: the pool's check across tenants); the
        host tier's own ledger alongside. Raises AssertionError with the
        per-term breakdown."""
        if self.pool is not None:
            self.pool.check_page_conservation()
            if self.host_tier is not None:
                self.host_tier.check_conservation()
            return
        acc = self.page_accounting()
        free, cached = acc["free"], acc["cached"]
        slots, transit = acc["slots"], acc["in_transit"]
        tier = acc["host_tier"]
        total = self.cache.n_pages - 1
        problems = []
        if len(free) != len(self.alloc._free):
            problems.append("the free-list holds a duplicate page")
        if len(slots) != len(set(slots)):
            problems.append("a page is owned by two slots")
        if len(transit) != len(set(transit)):
            problems.append("a page is in transit twice")
        if len(tier) != len(set(tier)):
            problems.append("a page is tier-pinned twice")
        if free & cached:
            problems.append("free-list and cache overlap")
        if set(slots) & (free | cached):
            problems.append("slot-owned page also free or cached")
        if set(transit) & (free | cached | set(slots)):
            problems.append("in-transit page also free, cached, or owned")
        if set(tier) & (free | cached | set(slots) | set(transit)):
            problems.append(
                "tier-pinned page also free, cached, owned, or in transit"
            )
        if 0 in (free | cached | set(slots) | set(transit) | set(tier)):
            problems.append("scratch page 0 entered an ownership set")
        if (
            len(free) + len(cached) + len(slots) + len(transit) + len(tier)
            != total
        ):
            problems.append("leak: the ownership terms do not sum to the pool")
        if problems:
            raise AssertionError(
                "page conservation violated: " + "; ".join(problems)
                + f" [free={len(free)} slots={len(slots)} "
                f"cached={len(cached)} host_tier={len(tier)} "
                f"in_transit={len(transit)} vs total={total}]"
            )
        if self.host_tier is not None:
            self.host_tier.check_conservation()

    def _pages_in_transit(self) -> int:
        """Pages held by an in-flight migration on either side."""
        return (
            sum(len(t["pages"]) for t in self._migrations.values())
            + sum(
                len(self._slots[s].pages)
                for s in self._frozen
                if self._slots[s] is not None
            )
        )

    def serving_snapshot(self) -> dict:
        """Telemetry under the JAX engine's keys: counters, KV storage and
        occupancy, speculation, migration and drain state, role, weights
        version, the pool's and the host tier's occupancy, scheduler and
        prefix-cache stats."""
        out = dict(self.stats)
        c = self.cache
        kv = [c.k, c.v] + ([c.k_scale, c.v_scale] if c.quantized else [])
        page_bytes = sum(_nbytes(t) // c.n_pages for t in kv)
        passes = out.get("spec_verify_passes", 0)
        out.update({
            "kv_quant": self.kv_quant,
            "weight_quant": getattr(self.engine, "quant", None) or "none",
            "kv_pages_total": c.n_pages - 1,
            "kv_pages_free": self.alloc.n_free,
            "kv_page_bytes": int(page_bytes),
            "spec_decode": self.spec_decode,
            "spec_tokens_per_pass": round(
                (out.get("spec_accepted", 0) + passes) / passes, 3
            ) if passes else 0.0,
            "drain_state": self.drain_state,
            "pages_in_transit": self._pages_in_transit(),
            "worker_role": self.worker_role,
            "kv_pages_slots": sum(
                len(r.pages) for s, r in enumerate(self._slots)
                if r is not None and s not in self._frozen
            ),
            "slots_free": sum(1 for r in self._slots if r is None),
            "weights_version": self.weights_version,
            "train_step_ms": round(self._train_step_ms, 3),
            "train_mfu": round(self._train_mfu, 5),
            "tensor_parallel": self.tensor_parallel,
            "host_gap_ms": self._host_gap_ms,
        })
        if self.pool is not None:
            out.update(self.pool.snapshot())
            out["pool_quota"] = self.alloc.quota
            out["pool_pages_used"] = self.alloc.used
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
        out["host_tier"] = self.host_tier is not None
        if self.host_tier is not None:
            out.update({
                "host_tier_capacity": self.host_tier.capacity,
                "host_tier_resident_pages": self.host_tier.n_resident,
                "host_tier_evictions": self.host_tier.stats["evictions"],
                "host_tier_digest": self._host_digest,
                "tier_fetch_ms_count": self._tier_hist.count,
                "tier_fetch_ms_sum": round(self._tier_hist.sum, 3),
            })
        return out

    def _admit(self) -> None:
        """One admission round (one scheduler tick): admit the scheduler's
        best queued request into a free slot, preempting a strictly
        lower-ranked resident (of this engine, or on a shared pool of
        another tenant) when the candidate would otherwise miss admission
        (no free slot, or no pages even after cache eviction)."""
        if self._migrations:
            self._gc_staged_migrations()
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
                    cand_rank = self.sched.effective_rank(req)
                if victim is not None:
                    self._preempt(victim.slot)
                    continue
                if self.pool is not None and (
                    self.alloc.quota - self.alloc.used
                    >= pages_needed(
                        min(len(req.prompt) + req.budget, self.max_seq_len),
                        self.page_size,
                    )
                ):
                    # cross-tenant rung: a strictly-lower-ranked slot of
                    # another tenant, torn down through ITS preemption path
                    cross = self.pool.cross_model_victim(cand_rank, self)
                    if cross is not None:
                        owner, vreq = cross
                        owner._preempt(vreq.slot)
                        owner._count("preempted_cross_tenant")
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
        """Residents a preemption may consider: a frozen slot is mid-
        migration and invisible to the victim search."""
        return [
            r if s not in self._frozen else None
            for s, r in enumerate(self._slots)
        ]

    # -- the decode loop -------------------------------------------------
    def _pack_ragged(self):
        """Assemble the step's packed ``[S, C]`` token block: each
        mid-prefill slot's next prompt piece (its grant from
        :func:`pack_prefill_budgets` under ``prefill_budget``), each
        decoding slot's current token, and each speculating slot's draft
        tokens after it, with per-slot ``(start, n_valid, n_spec)`` as
        data. ``emit`` marks the slots that sample this step. A handoff
        slot prefills to T-1 and freezes without a draw. None when
        nothing is live."""
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
        handoff_done: list[int] = []
        grants: dict[int, int] = {}
        pf_slots = sorted(self._prefilling)
        pf_rem = [
            len(self._prefilling[s].prefill_tokens)
            - self._prefilling[s].prefill_pos
            - (1 if self._prefilling[s].handoff else 0)
            for s in pf_slots
        ]
        budgets = pack_prefill_budgets(
            pf_rem, C,
            self.prefill_budget if self.prefill_budget > 0 else None,
            phase=self._pack_phase,
        )
        self._pack_phase += 1
        for s, g, rem in zip(pf_slots, budgets, pf_rem):
            req = self._prefilling[s]
            if req.handoff and rem <= 0:
                # a cache hit already covered everything shippable
                handoff_done.append(s)
                continue
            if g <= 0:
                continue  # budget exhausted: the slot idles this step
            blk[s, :g] = req.prefill_tokens[
                req.prefill_pos : req.prefill_pos + g
            ]
            starts[s] = req.prefill_pos
            n_valid[s] = g
            grants[s] = g
            if req.handoff:
                if req.prefill_pos + g >= len(req.prefill_tokens) - 1:
                    handoff_done.append(s)  # freeze — no first draw here
            elif req.prefill_pos + g >= len(req.prefill_tokens):
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
        n_spec = self._pack_drafts(blk, n_valid, remaining)
        return (blk, starts, n_valid, n_spec, emit, remaining, eos_arr,
                completing, handoff_done, grants)

    def _pack_drafts(self, blk, n_valid, remaining):
        """The speculative half of the packed block: each opted-in
        DECODING slot proposes a prompt-lookup draft (engine/spec.py,
        host-side) and packs it as extra valid rows after its current
        token; the step verifies them. Grants split ``spec_budget``
        round-robin like prefill budgets. Returns the per-slot draft
        counts ``n_spec`` (``blk``/``n_valid`` are updated in place)."""
        S = self.max_slots
        n_spec = np.zeros(S, np.int32)
        if self.spec_width <= 1:
            return n_spec
        cands: list[tuple[int, list[int]]] = []
        for s in range(S):
            req = self._slots[s]
            if req is None or not self._active[s] or not req.speculative:
                continue
            if req.spec_state is None:
                # armed once per request: the controller lives with the
                # request, so a preemption keeps its kill switch
                req.spec_state = SpecController(self.spec_draft, rearm=True)
                req.spec_state.prescan(req.prompt + req.tokens)
            ctl = req.spec_state
            if not ctl.active:
                continue
            # at most remaining tokens emit this pass (k drafts + 1)
            cap = min(self.spec_draft, int(remaining[s]) - 1)
            if cap < 1:
                continue
            draft = ctl.draft(req.prompt + req.tokens, cap=cap)
            if draft:
                cands.append((s, draft))
        if not cands:
            return n_spec
        grants = pack_prefill_budgets(
            [len(d) for _, d in cands], self.spec_draft,
            self.spec_budget if self.spec_budget > 0 else None,
            phase=self._spec_phase,
        )
        self._spec_phase += 1
        for (s, draft), g in zip(cands, grants):
            if g <= 0:
                continue
            d = draft[:g]
            blk[s, 1 : 1 + len(d)] = d
            n_valid[s] = 1 + len(d)
            n_spec[s] = len(d)
            self._slots[s].spec_state.drafted += len(d)
        return n_spec

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
        blk, starts, n_valid, n_spec, emit, remaining, eos_arr, \
            completing, handoff_done, grants = pack
        dev = self.device

        def up(a):
            return torch.tensor(a, device=dev)

        t_chunk = time.monotonic()
        self._host_gap_ms = round((t_chunk - t_host) * 1e3, 3)
        self.chunks += 1
        tokens, n_tok, spec_m, n_exec, self.cache, _done, _steps, \
            self._counts, _rem = paged_ragged_step(
                self.engine.params, up(blk), self.cache, up(starts),
                up(n_valid), up(n_spec), up(emit),
                up(self._seeds), up(self._steps), up(self._temp),
                up(self._topk), up(self._topp), up(self._pres),
                up(self._freq), self._counts, up(remaining), up(eos_arr),
                self.cfg, self.chunk_steps, self.spec_width,
                kernel=self.use_kernel,
            )
        # the chunk's host sync: the results the delivery loop reads
        toks_host = tokens.cpu().numpy()
        n_tok_host = n_tok.cpu().numpy()
        spec_m_host = spec_m.cpu().numpy()
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
            # a locally resumed handoff already traced its prefill
            already_traced = bool(req.prefill_done_t)
            req.prefill_done_t = now
            if not already_traced:
                self._trace(
                    req, "prefill",
                    dur_s=(now - req.admit_t) if req.admit_t else None,
                    tokens=req.prefill_pos,
                )
            self._active[s] = True
        for s in handoff_done:
            # the prefill→decode boundary, frozen WITHOUT a first draw:
            # _tok carries the final prompt token for the export
            req = self._prefilling.pop(s)
            req.prefill_done_t = now
            self._trace(
                req, "prefill",
                dur_s=(now - req.admit_t) if req.admit_t else None,
                tokens=req.prefill_pos,
            )
            self._tok[s] = int(req.prefill_tokens[-1])
            self._frozen.add(s)
            self._handoff_ready.append(s)
            self._count("handoffs_started")
            self._trace(req, "freeze", slot=s, tokens=0)
        if emit.any():
            self._count("decode_steps", n_exec)
            self._count("slot_steps_total", n_exec * S)
        delivered_total = 0
        for s in range(S):
            if not emit[s]:
                continue
            req = self._slots[s]
            if n_spec[s] > 0 and req.spec_state is not None:
                # spec_m is the pass's emitted count: accepted drafts + 1
                m = int(spec_m_host[s])
                self._count("spec_drafted", int(n_spec[s]))
                self._count("spec_accepted", max(m - 1, 0))
                self._count("spec_verify_passes")
                if req.spec_state.note_verify(m):
                    self._count("spec_killed")
            finished = False
            emitted = 0
            for i in range(int(n_tok_host[s])):
                tok = int(toks_host[s, i])
                if req.spec_state is not None:
                    prev = req.tokens[-1] if req.tokens else (
                        req.prompt[-1] if req.prompt else tok
                    )
                    req.spec_state.note_pair(prev, tok)
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
            spec_drafted=int(n_spec.sum()),
            tokens_emitted=delivered_total,
            pages_free=self.alloc.n_free,
            pages_in_transit=self._pages_in_transit(),
            preemptions=int(self._stat["preemptions"].value),
            chunk_ms=round(chunk_dur * 1e3, 3),
            host_ms=self._host_gap_ms,
        )
        self._refresh_prefix_digest()
        return self.has_work()

    def _refresh_prefix_digest(self) -> None:
        """Rebuild both tiers' digests when membership changed (stepping
        thread; readers see an atomically swapped dict)."""
        if self.prefix is None:
            return
        if self.prefix.version != self._digest_version:
            self._digest_version = self.prefix.version
            self._prefix_digest = self.prefix.digest()
        if self.host_tier is not None and (
            self.host_tier.version != self._host_digest_version
        ):
            self._host_digest_version = self.host_tier.version
            self._host_digest = self.host_tier.digest()

    def run_until_idle(self) -> None:
        """Drive the loop to quiescence (tests, local serving)."""
        while self.step_chunk():
            pass

    def close(self, error: BaseException | None = None) -> None:
        """Fail everything still queued or in flight, free staged
        migrations (and a pool tenant's resident prefixes), then check
        page conservation and detach from the pool. A real error dumps
        the flight recorder into ``recorder.last_dump``."""
        err = error or RuntimeError("continuous engine closed")
        if error is not None:
            dump = self.recorder.dump(error)
            _log.warning(
                "engine error — flight recorder dumped %d step records",
                dump["n_records"],
            )
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
        for mig_id in list(self._migrations):
            self.drop_staged_migration(mig_id)
        if self.pool is not None and self.prefix is not None:
            # the trie's pages belong to the shared pool
            self.alloc.free(self.prefix.drop_all())
        self.check_page_conservation()
        if self.pool is not None:
            frozen = self.cache
            self.pool.detach(self.model_id)
            self.pool = None
            self._cache = frozen


def _staged(tree, device):
    """A published tree copied onto ``device`` (the engine never shares a
    tensor with the publisher)."""
    if isinstance(tree, dict):
        return {k: _staged(v, device) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(q=_staged(tree.q, device),
                       scale=_staged(tree.scale, device))
    if not isinstance(tree, torch.Tensor):
        raise ValueError(
            f"published leaf is a {type(tree).__name__}, not a tensor"
        )
    return tree.detach().to(device, copy=True)


def _tree_mismatch(old, new, path: str = "") -> str | None:
    """Where the published tree ``new`` departs from the serving tree
    ``old`` (structure, leaf shape, dtype, device), or None."""
    where = path or "<root>"
    if isinstance(old, dict):
        if not isinstance(new, dict) or set(old) != set(new):
            return f"{where}: keys differ"
        for k in old:
            why = _tree_mismatch(old[k], new[k], f"{path}/{k}")
            if why is not None:
                return why
        return None
    if isinstance(old, QTensor):
        if not isinstance(new, QTensor):
            return f"{where}: quantized leaf replaced by {type(new).__name__}"
        return (_tree_mismatch(old.q, new.q, path + ".q")
                or _tree_mismatch(old.scale, new.scale, path + ".scale"))
    if not isinstance(new, torch.Tensor):
        return f"{where}: {type(new).__name__} is not a tensor"
    if (tuple(old.shape), old.dtype, old.device) != (
        tuple(new.shape), new.dtype, new.device
    ):
        return (f"{where}: {tuple(new.shape)} {new.dtype} on {new.device} "
                f"vs {tuple(old.shape)} {old.dtype} on {old.device}")
    return None


__all__ = [
    "ContinuousEngine", "ContinuousRequest", "pack_prefill_budgets",
]
