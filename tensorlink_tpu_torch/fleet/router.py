"""FleetRouter — cache- and SLO-aware placement over N engine replicas.

One hosted model, N replicas (each a batcher over its own engine — local,
remote single-stage, or pipelined). The router is the ADMISSION policy
that multiplies one replica into a fleet: every request is scored against
every replica and dispatched to the best, where

- **cache affinity** comes from the compact prefix-trie digest each
  replica exports (``PrefixCache.digest`` → ``serving_snapshot()`` →
  ``/stats``): the request's leading page blocks are rolling-hashed
  (:func:`~tensorlink_tpu_torch.engine.paged.prompt_chain_hashes`) and matched
  against the replica's resident chains — the deepest match estimates the
  prefill tokens a placement would skip. The digest is advisory only:
  admission re-walks the replica's real trie, so staleness or a hash
  collision can misplace a request but never corrupt a stream.
- **load** comes from the same telemetry the metrics registry already
  exports: the request class's queue depth and the scheduler's service
  EWMA (their product over the slot count is the wait estimate the 429
  path uses), plus live-slot pressure.
- **role/health** come from the ``/healthz`` shape: draining replicas
  are fenced out, decode-pool replicas are penalized as admission points
  (disaggregated serving places new work on prefill/mixed entries), and
  a replica that recently failed sits out a cooldown.

Replica failure rides the existing recovery contract: a remote replica's
``DistributedModel`` repairs its own workers first; only when the whole
dispatch fails BEFORE the first token does the router fail over to the
next-best replica (exactly-once delivery — a mid-stream failure belongs
to the model-level repair ladder, which owns resumption). Placement is
not part of the determinism contract — greedy streams are bit-identical
on every replica; sampled streams draw from the batcher seed sequence of
wherever they land.

Thread-safety: ``register``/``deregister``/``refresh``/``route``/
``dispatch`` are all safe from concurrent API threads (one internal
lock guards the replica table; scoring reads atomically-swapped view
dicts).

See docs/SERVING.md "Fleet serving" for the operator view.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from tensorlink_tpu_torch.core.logging import get_logger
from tensorlink_tpu_torch.core.metrics import MetricsRegistry
from tensorlink_tpu_torch.core.trace import get_tracer
from tensorlink_tpu_torch.engine.paged import prompt_chain_hashes
from tensorlink_tpu_torch.engine.scheduler import (
    SchedulerOverloaded,
    normalize_priority,
)

# deepest prompt prefix the affinity scorer hashes: bounds per-request
# scoring cost on pathological prompts (64 pages ≫ any digest's depth)
MAX_AFFINITY_PAGES = 64


class NoReplicaAvailable(RuntimeError):
    """Every registered replica is draining, failed, or absent."""


class _Replica:
    """Router-side record of one replica: its batcher, the last refreshed
    telemetry view, and failure/inflight bookkeeping."""

    __slots__ = (
        "rid", "batcher", "view", "inflight", "fails", "cooldown_until",
        "routed", "generation",
    )

    def __init__(self, rid: str, batcher: Any, routed):
        self.rid = rid
        self.batcher = batcher
        self.view: dict = {}  # atomically-swapped snapshot dict
        self.inflight = 0  #: guarded by the router lock
        self.fails = 0  #: guarded by the router lock
        self.cooldown_until = 0.0  #: guarded by the router lock
        self.routed = routed  # labeled counter cell
        self.generation = 0  # bumped by the autopilot's rolling deploy


class FleetRouter:
    """Scored per-request placement across a model's replica set."""

    def __init__(
        self,
        *,
        metrics: MetricsRegistry | None = None,
        refresh_s: float = 0.5,
        w_cache: float = 2.0,
        w_wait: float = 0.25,
        w_busy: float = 1.0,
        w_role: float = 1.0,
        failover_attempts: int = 3,
        failure_cooldown_s: float = 3.0,
        trace_site: str = "fleet",
    ):
        self.log = get_logger("fleet.router")
        self.refresh_s = float(refresh_s)
        self.w_cache = float(w_cache)
        self.w_wait = float(w_wait)
        self.w_busy = float(w_busy)
        self.w_role = float(w_role)
        self.failover_attempts = max(int(failover_attempts), 1)
        self.failure_cooldown_s = float(failure_cooldown_s)
        self.trace_site = str(trace_site or "fleet")
        self.tracer = get_tracer()
        self._lock = threading.Lock()
        self._replicas: dict[str, _Replica] = {}  #: guarded by self._lock
        self._last_refresh = 0.0  #: guarded by self._lock
        # the new labeled fleet families: per-replica routed counts plus
        # fleet-wide failover/overflow/affinity counters — rendered under
        # the hosted model's label group at /metrics
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_failovers = self.metrics.counter(
            "tlink_fleet_failovers_total",
            "dispatches retried on another replica after a failure",
        )
        self._m_overflow = self.metrics.counter(
            "tlink_fleet_overflow_reroutes_total",
            "dispatches rerouted after a replica's scheduler rejected",
        )
        self._m_cache_tokens = self.metrics.counter(
            "tlink_fleet_route_cache_tokens_total",
            "prompt tokens the chosen replica's digest predicted resident",
        )
        self.metrics.gauge(
            "tlink_fleet_replicas", "registered replicas",
            fn=lambda: len(self._replicas),
        )

    # -- membership ------------------------------------------------------
    def register(self, rid: str, batcher: Any) -> None:
        """Add (or replace — a rolling deploy's rejoin) a replica."""
        rid = str(rid)
        routed = self.metrics.counter(
            "tlink_fleet_routed_total", "requests routed to this replica",
            replica=rid,
        )
        with self._lock:
            prev = self._replicas.get(rid)
            rep = _Replica(rid, batcher, routed)
            if prev is not None:
                rep.generation = prev.generation + 1
            self._replicas[rid] = rep
        # first view before any traffic: a fresh replica must be
        # routable without waiting a refresh period
        self._refresh_one(rep)

    def deregister(self, rid: str) -> Any:
        """Drop a replica from routing; returns its batcher (the caller
        owns teardown — the router never closes what it didn't open)."""
        with self._lock:
            rep = self._replicas.pop(str(rid), None)
        return rep.batcher if rep is not None else None

    # -- state carry-over (control-plane crash safety) -------------------
    def export_state(self) -> dict:
        """Routing state worth surviving a validator restart: per-replica
        routed counts and deploy generations. Snapshot-shaped so it can
        ride the journal or /stats."""
        with self._lock:
            return {
                "routed": {r.rid: int(r.routed.value)
                           for r in self._replicas.values()},
                "generation": {r.rid: int(r.generation)
                               for r in self._replicas.values()},
            }

    def seed_state(self, state: dict) -> None:
        """Re-seed a freshly-built router from journal replay (validator
        recovery): per-replica routed counters resume from the journaled
        admission counts instead of cold-starting at zero, so routing
        telemetry and any count-derived policy stay continuous across the
        restart. Unknown rids are ignored (their replicas didn't
        re-attach); counters only ever move FORWARD (inc by the gap)."""
        routed = dict(state.get("routed") or {})
        gens = dict(state.get("generation") or {})
        with self._lock:
            for rep in self._replicas.values():
                gap = int(routed.get(rep.rid, 0)) - int(rep.routed.value)
                if gap > 0:
                    rep.routed.inc(gap)
                if int(gens.get(rep.rid, 0)) > rep.generation:
                    rep.generation = int(gens[rep.rid])

    def replica_ids(self) -> list[str]:
        with self._lock:
            return list(self._replicas)

    def batcher(self, rid: str) -> Any:
        with self._lock:
            rep = self._replicas.get(str(rid))
        return rep.batcher if rep is not None else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._replicas)

    # -- telemetry refresh ----------------------------------------------
    def _refresh_one(self, rep: _Replica) -> None:
        try:
            snap = rep.batcher.router_snapshot()
            snap["ok"] = True
        except Exception as e:
            # keep the stale view for scoring-as-last-resort but mark it
            # UNHEALTHY — the autopilot must never pick a dead replica
            # as a rebalance endpoint off a view frozen at its death
            snap = {**rep.view, "ok": False}
            self.log.debug("router snapshot for %s failed: %s", rep.rid, e)
        rep.view = snap  # atomic swap

    def refresh(self, force: bool = False) -> None:
        """Pull every replica's scoring inputs (cheap — attribute reads
        or the last remote snapshot; no device work). Rate-limited to
        ``refresh_s`` unless forced; the stats sweep and the autopilot
        both land here."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_refresh < self.refresh_s:
                return
            self._last_refresh = now
            reps = list(self._replicas.values())
        for rep in reps:
            self._refresh_one(rep)

    def views(self) -> dict[str, dict]:
        """rid → last refreshed view (the autopilot's watch input)."""
        with self._lock:
            return {rid: dict(r.view) for rid, r in self._replicas.items()}

    # -- scoring (the hot path: pure host arithmetic, no device, no I/O) -
    # tlint: hot-path
    def cache_affinity(
        self, view: dict, prompt_ids, _hash_memo: dict | None = None,
    ) -> int:
        """Prompt tokens the replica's digest predicts are resident: the
        deepest leading block chain of ``prompt_ids`` whose rolling hash
        appears in the digest. 0 on no digest / no full-page prefix.
        ``_hash_memo`` (page_size → hash list) lets route() hash the
        prompt ONCE per request instead of once per replica. Both tiers
        count: a chain demoted to the replica's host RAM still scores
        (promote is far cheaper than re-prefill), with HBM precedence
        when a hash appears in both digests."""
        dig = view.get("prefix_digest") or {}
        chains = dig.get("chains") or {}
        page = int(dig.get("page_size") or 0)
        host = view.get("host_tier_digest") or {}
        if int(host.get("page_size") or 0) == page or not chains:
            host_chains = host.get("chains") or {}
            if host_chains and not chains:
                page = int(host.get("page_size") or 0)
                chains = host_chains
            elif host_chains:
                chains = {**host_chains, **chains}
        if not chains or page <= 0:
            return 0
        hs = _hash_memo.get(page) if _hash_memo is not None else None
        if hs is None:
            hs = prompt_chain_hashes(prompt_ids, page, MAX_AFFINITY_PAGES)
            if _hash_memo is not None:
                _hash_memo[page] = hs
        covered = 0
        for i, h in enumerate(hs):
            if h in chains:
                covered = (i + 1) * page
        return min(covered, len(prompt_ids))

    # tlint: hot-path
    def score(
        self, view: dict, prompt_ids, priority: str, inflight: int = 0,
        _hash_memo: dict | None = None,
    ) -> tuple[float, int]:
        """Placement desirability of one replica for one request:
        ``w_cache``·(predicted hit fraction) − ``w_wait``·(est. queue
        seconds for the request's class) − ``w_busy``·(slot pressure) −
        ``w_role``·(decode-role admission penalty). Returns (score,
        predicted cache tokens)."""
        cache_tokens = self.cache_affinity(view, prompt_ids, _hash_memo)
        cache_frac = cache_tokens / max(len(prompt_ids), 1)
        depth = int((view.get("queue_depth") or {}).get(priority, 0))
        ewma = float(view.get("service_ewma_s") or 0.0)
        slots = max(int(view.get("max_slots") or 1), 1)
        wait_est = depth * ewma / slots
        free = int(view.get("slots_free") or 0)
        busy = min(max((slots - free + inflight) / slots, 0.0), 2.0)
        role_pen = 1.0 if view.get("worker_role") == "decode" else 0.0
        return (
            self.w_cache * cache_frac
            - self.w_wait * wait_est
            - self.w_busy * busy
            - self.w_role * role_pen,
            cache_tokens,
        )

    def route(
        self,
        prompt_ids,
        priority: str | None = None,
        trace_id: str = "",
        exclude: set[str] | frozenset = frozenset(),
    ) -> str | None:
        """Pick the replica this request should land on (None when no
        replica is registered). Draining and cooling-down replicas are
        skipped while any alternative exists — when NOTHING else exists
        the least-bad replica still serves (a fleet of one draining
        replica beats a dropped request; its admission fence will reject
        cleanly if it must)."""
        self.refresh()
        now = time.monotonic()
        with self._lock:
            reps = [
                r for r in self._replicas.values() if r.rid not in exclude
            ]
            if not reps:
                return None
            preferred = [
                r for r in reps
                if not r.view.get("draining") and r.cooldown_until <= now
                and r.view.get("ok", True)
            ]
            pool = preferred or reps
            inflight = {r.rid: r.inflight for r in pool}
        cls = normalize_priority(priority)
        best: tuple[tuple, int, _Replica] | None = None
        hash_memo: dict = {}  # one prompt hashing per request, not per replica
        for r in pool:
            s, cache_tokens = self.score(
                r.view, prompt_ids, cls, inflight.get(r.rid, 0),
                _hash_memo=hash_memo,
            )
            # deterministic total order: higher score, then fewer
            # inflight, then replica id — stable under equal telemetry
            key = (s, -inflight.get(r.rid, 0), r.rid)
            if best is None or key > best[0]:
                best = (key, cache_tokens, r)
        (_score, _, _), cache_tokens, rep = best
        rep.routed.inc()
        if cache_tokens:
            self._m_cache_tokens.inc(cache_tokens)
        if trace_id:
            self.tracer.record(
                trace_id, "route", site=self.trace_site, replica=rep.rid,
                score=round(_score, 4), cache_tokens=cache_tokens,
                candidates=len(pool),
            )
        return rep.rid

    # -- dispatch with failover -----------------------------------------
    def admission_check(self, priority=None, n: int = 1) -> dict | None:
        """The API backpressure gate for a fleet: admit when ANY
        non-draining replica admits; the rejection returned is the one
        with the smallest retry-after (the fleet's honest wait). A
        draining replica's empty queue must NOT admit on the fleet's
        behalf — route() would never place the request there, so its
        gate answer is a lie about where the request actually lands."""
        best_rej: dict | None = None
        with self._lock:
            reps = list(self._replicas.values())
            serving = [r for r in reps if not r.view.get("draining")]
            reps = serving or reps
        for rep in reps:
            check = getattr(rep.batcher, "admission_check", None)
            rej = check(priority, n) if callable(check) else None
            if rej is None:
                return None
            if best_rej is None or float(rej.get("retry_after", 1e9)) < float(
                best_rej.get("retry_after", 1e9)
            ):
                best_rej = rej
        return best_rej or {
            "priority": normalize_priority(priority),
            "queue_depth": 0, "cap": 0, "retry_after": 1.0,
        }

    def note_failure(self, rid: str) -> None:
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None:
                return
            rep.fails += 1
            rep.cooldown_until = time.monotonic() + (
                self.failure_cooldown_s * min(rep.fails, 5)
            )

    def note_ok(self, rid: str) -> None:
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is not None:
                rep.fails = 0
                rep.cooldown_until = 0.0

    def dispatch(
        self,
        ids,
        *,
        max_new_tokens: int,
        stream_cb: Callable | None = None,
        priority: str | None = None,
        trace_id: str = "",
        on_route: Callable[[str], None] | None = None,
        **kw,
    ) -> list[int]:
        """Route then ``generate`` on the chosen replica's batcher, with
        bounded failover. Delivery stays exactly-once on every rung:

        - before the first token (or a scheduler rejection): resubmit
          the prompt on the next-best replica — nothing was shown.
        - mid-stream, GREEDY request: greedy streams are placement-
          invariant (bit-identical on every replica), so the survivor's
          replay has the identical prefix — the router suppresses the
          already-delivered tokens and the client sees one continuous
          stream, the crash-recovery ladder's local analogue.
        - mid-stream, SAMPLED request: a replay would draw a different
          stream — the error propagates (the model-level repair ladder
          owns resumption for remote replicas).
        """
        tried: set[str] = set()
        last_err: BaseException | None = None
        # tokens already shown to the client (greedy replay suppression)
        delivered: list[int] = []
        greedy = float(kw.get("temperature", 0.0) or 0.0) == 0.0
        for _ in range(self.failover_attempts):
            rid = self.route(
                ids, priority=priority, trace_id=trace_id, exclude=tried
            )
            if rid is None:
                break
            with self._lock:
                rep = self._replicas.get(rid)
                if rep is not None:
                    rep.inflight += 1
            if rep is None:
                tried.add(rid)
                continue
            if on_route is not None:
                # placement telemetry (the control journal's "place"
                # record); observers must never fail a dispatch
                try:
                    on_route(rid)
                except Exception:  # tlint: disable=TL005(placement telemetry is best-effort)
                    pass
            skip = [len(delivered)]

            def counting_cb(toks, _inner=stream_cb, _skip=skip):
                fresh = [int(t) for t in toks if t is not None]
                if _skip[0]:
                    # a replay's prefix re-decodes what the dead replica
                    # already streamed — suppress, don't re-deliver
                    drop = min(_skip[0], len(fresh))
                    _skip[0] -= drop
                    fresh = fresh[drop:]
                if not fresh:
                    return None
                delivered.extend(fresh)
                return _inner(fresh)

            try:
                out = rep.batcher.generate(
                    ids, max_new_tokens=max_new_tokens,
                    stream_cb=counting_cb if stream_cb is not None else None,
                    priority=priority, trace_id=trace_id, **kw,
                )
                self.note_ok(rid)
                return out
            except SchedulerOverloaded as e:
                if delivered and not greedy:
                    # a sampled stream rejected MID-STREAM (a rebalance
                    # resume bounced): a respill would splice a
                    # divergent draw onto what was shown — propagate,
                    # exactly like the generic mid-stream sampled case
                    raise
                # backpressure, not failure: no cooldown — spill to the
                # next replica, re-raise only when the whole fleet is full
                self._m_overflow.inc()
                tried.add(rid)
                last_err = e
            except TimeoutError:
                raise  # tokens may still be in flight — never resubmit
            except BaseException as e:
                self.note_failure(rid)
                if delivered and not greedy:
                    # a sampled replay would diverge from what was shown:
                    # propagate so the client sees the truth
                    raise
                self._m_failovers.inc()
                self.log.warning(
                    "replica %s failed after %d token(s) (%s: %s) — "
                    "failing over%s", rid, len(delivered),
                    type(e).__name__, e,
                    " with greedy replay dedup" if delivered else "",
                )
                tried.add(rid)
                last_err = e
            finally:
                with self._lock:
                    rep2 = self._replicas.get(rid)
                    if rep2 is rep:
                        rep2.inflight = max(rep2.inflight - 1, 0)
        if last_err is not None:
            raise last_err
        raise NoReplicaAvailable("no replica available for dispatch")

    # -- observability ---------------------------------------------------
    def snapshot(self) -> dict:
        """Router telemetry for /stats and the /fleet route."""
        now = time.monotonic()
        with self._lock:
            reps = {
                rid: {
                    "inflight": r.inflight,
                    "fails": r.fails,
                    "cooling": r.cooldown_until > now,
                    "generation": r.generation,
                    "routed": int(r.routed.value),
                    "draining": bool(r.view.get("draining")),
                    "worker_role": r.view.get("worker_role", "mixed"),
                    # explicit TP (docs/SHARDING.md): the replica's shard
                    # degree — a tp=N replica is ONE placement unit over
                    # N chips, so headroom (slots_free, kv_pages_free)
                    # already describes the whole mesh, never per-chip
                    "tensor_parallel": int(
                        r.view.get("tensor_parallel", 1) or 1
                    ),
                    "slots_free": r.view.get("slots_free"),
                    "kv_pages_free": r.view.get("kv_pages_free"),
                    "queue_depth": dict(r.view.get("queue_depth") or {}),
                }
                for rid, r in self._replicas.items()
            }
        return {
            "replicas": reps,
            "failovers": int(self._m_failovers.value),
            "overflow_reroutes": int(self._m_overflow.value),
            "route_cache_tokens": int(self._m_cache_tokens.value),
        }


__all__ = ["FleetRouter", "NoReplicaAvailable", "MAX_AFFINITY_PAGES"]
