"""FleetAutopilot — the drain-driven control loop over a replica fleet.

The :class:`~tensorlink_tpu_torch.fleet.router.FleetRouter` decides where NEW
requests land; the autopilot watches the same refreshed telemetry and
moves EXISTING load with the engine's own mechanisms — live slot
migration (freeze → export → stage → adopt) and the drain fence — so
every action preserves the bit-identical-stream contract by
construction:

- **rebalance**: when one replica runs hot (live-slot pressure + queue
  depth) while another runs cold beyond ``rebalance_spread``, up to
  ``max_moves_per_tick`` decode streams page-ship from hot to cold.
- **rolling deploy** (``request_deploy``): per replica — raise the drain
  fence, migrate its live streams to the coldest sibling, re-dispatch
  its queued work, rebuild ("upgrade") the replica, rejoin the router.
  Zero dropped tokens: moved streams resume mid-stream through the
  staged-adoption path, queued work re-submits whole.
- **decode-pool scaling**: on a disaggregated fleet the autopilot asks
  the actions layer to grow/shrink the decode pool when decode-role
  headroom crosses the water marks (the validator's actions implement
  it with the handoff-pool push; a harness may decline).
- **fleet weight publish** (``request_publish``, docs/TRAINING.md): a
  serve-and-train loop's new weight version propagates to sibling
  replicas ONE per tick — each picks it up at its own chunk boundary
  with zero dropped streams and zero new compiled programs; remote
  actions decline (their replicas take the rolling-deploy path).

Safety rails: the autopilot never acts with fewer than
``min_replicas_for_action`` healthy replicas, never deploys two replicas
at once, never drains the last non-draining replica, bounds moves per
tick, enforces a global action cooldown, and in ``dry_run`` records
decisions without acting. Every decision lands in a bounded history
(the ``/fleet`` route) and in labeled ``tlink_autopilot_*`` counters.

The loop is a plain daemon thread (``start``/``stop``) but every
decision lives in :meth:`tick`, directly callable — tests and the bench
drive ticks synchronously between engine chunks.

The ACTIONS layer is pluggable: :class:`EngineFleetActions` operates on
in-process :class:`~tensorlink_tpu_torch.engine.continuous.ContinuousEngine`
replicas (the bench/test harness and local serving), honoring the
engines' single-driver discipline through a caller-supplied ``exec_on``
(e.g. ``ContinuousBatcher.run_on_driver``); the validator wires a
bridge-backed actions object for remote replicas (DRAIN verbs).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Callable

from tensorlink_tpu_torch.core.logging import get_logger
from tensorlink_tpu_torch.core.metrics import MetricsRegistry


class EngineFleetActions:
    """Autopilot actions over in-process slot-engine replicas.

    ``get_engine(rid)`` resolves a replica id to its live
    ``ContinuousEngine``; ``exec_on(rid, fn)`` runs ``fn(engine)`` with
    that engine's single-driver discipline honored (default: direct call
    — correct for manually-stepped harnesses; pass the batcher's
    ``run_on_driver`` for threaded replicas). ``rebuild(rid)`` performs
    the rolling-deploy "upgrade" step and returns the handle the router
    should re-register (or None to keep the existing registration).

    Every stream move is the migration resume contract verbatim: export
    the frozen slot's byte-exact pages, stage at the destination, commit
    at the source, re-submit ``prompt + emitted`` with
    ``start_step + len(emitted)`` adopting the staged ticket — so a
    moved stream is bit-identical to an unmoved one, test-pinned.
    """

    def __init__(
        self,
        get_engine: Callable[[str], Any],
        *,
        exec_on: Callable[[str, Callable[[Any], Any]], Any] | None = None,
        rebuild: Callable[[str], Any] | None = None,
    ):
        self.get_engine = get_engine
        self._exec_on = exec_on
        self._rebuild = rebuild
        self._mig_seq = itertools.count(1)
        self.log = get_logger("fleet.actions")

    def _exec(self, rid: str, fn: Callable[[Any], Any]):
        if self._exec_on is not None:
            return self._exec_on(rid, fn)
        return fn(self.get_engine(rid))

    # -- introspection ---------------------------------------------------
    def live_work(self, rid: str) -> int:
        """Streams still on the replica: live slots + a queued marker."""
        return self._exec(
            rid, lambda e: int(e.live_slots) + (1 if e.has_work() else 0)
        )

    def movable_streams(self, rid: str) -> int:
        """Decode slots eligible for a page-ship move."""
        return self._exec(
            rid,
            lambda e: sum(1 for k, _s, _r in e.live_manifest()
                          if k == "decode"),
        )

    # -- stream movement -------------------------------------------------
    def _resubmit(self, dst_rid: str, moved, adopt: str | None):
        """Resume a committed/shed stream on ``dst`` — the crash-recovery
        resume contract: prompt + emitted, advanced start_step, the
        staged ticket when pages shipped. The original request object and
        its callbacks stay live: tokens keep flowing to the same
        ``stream_cb``, and completion mirrors back onto the original so
        engine-level holders (and batcher ``on_finish`` closures) see
        ONE continuous stream."""
        prior = list(moved.tokens)
        inner_finish = moved.on_finish

        def on_finish(creq, _prior=prior, _inner=inner_finish, _orig=moved):
            # the resumed request decoded only the remainder; present the
            # FULL stream to every consumer
            creq.tokens = _prior + list(creq.tokens)
            _orig.tokens = list(creq.tokens)
            _orig.error = creq.error
            _orig.finished = creq.finished
            if _inner is not None:
                _inner(creq)
            _orig.done.set()

        def submit(eng, _m=moved, _adopt=adopt, _fin=on_finish):
            return eng.submit(
                _m.prompt + list(_m.tokens),
                max_new_tokens=_m.budget - len(_m.tokens),
                sampling=_m.sampling,
                eos_ids=list(_m.eos),
                seed=_m.seed,
                start_step=_m.start_step + len(_m.tokens),
                priority=_m.priority,
                stream_cb=_m.stream_cb,
                on_finish=_fin,
                adopt=_adopt,
                trace_id=_m.trace_id or None,
                speculative=_m.speculative,
            )

        return self._exec(dst_rid, submit)

    def _fail_stream(self, moved, err: BaseException) -> None:
        """Last rung of the move ladder: no engine can host the stream —
        fail it LOUDLY through its own completion path (error + done +
        on_finish) so the client raises instead of hanging to its
        timeout. Mirrors ContinuousEngine._finish's ordering."""
        self.log.error(
            "stream rid=%s could not be resumed anywhere: %s",
            getattr(moved, "rid", "?"), err,
        )
        moved.error = err
        moved.done.set()
        fin = moved.on_finish
        if fin is not None:
            try:
                fin(moved)
            except Exception:
                self.log.exception("on_finish of failed stream raised")

    def rebalance(
        self, src_rid: str, dst_rid: str, max_streams: int = 1,
    ) -> int:
        """Page-ship up to ``max_streams`` decode streams src → dst.
        Returns the number moved; a refused staging aborts that slot in
        place (the stream keeps decoding at the source — never worse
        off)."""
        # pre-flight rail: a destination that would reject the resumes
        # (per-CLASS queue cap / wait bound, drain fence) must not
        # receive committed streams — their tickets would expire and the
        # moves degrade to errors. Checked per candidate class: a full
        # best_effort queue must not be masked by an empty interactive
        # one (admission_check(None) would only probe the default class)
        def candidates(eng, _k=int(max_streams)):
            return [
                (slot, req.priority)
                for kind, slot, req in eng.live_manifest()
                if kind == "decode"
            ][:_k]

        cands = self._exec(src_rid, candidates)
        if not cands:
            return 0
        want: dict[str, int] = {}
        for _slot, cls in cands:
            want[cls] = want.get(cls, 0) + 1
        ok_classes = set()
        for cls, n in want.items():
            rej = self._exec(
                dst_rid,
                lambda e, _c=cls, _n=n: e.admission_check(_c, _n),
            )
            if rej is None:
                ok_classes.add(cls)
            else:
                self.log.warning(
                    "rebalance %s→%s: destination rejects %d %s "
                    "stream(s) (%s) — leaving them at the source",
                    src_rid, dst_rid, n, cls, rej,
                )
        moving = [slot for slot, cls in cands if cls in ok_classes]
        if not moving:
            return 0

        def freeze_and_export(eng, _slots=tuple(moving)):
            out = []
            for slot in _slots:
                try:
                    eng.freeze_slot(slot)
                # tlint: disable=TL005(the slot finished/preempted between the scan and this freeze — skip it, the scan was advisory)
                except ValueError:
                    continue
                # n_skip=0: the destination trie is another driver's
                # state — probing it from here would race; staging still
                # dedups against its resident chains on adoption
                try:
                    out.append((slot, eng.export_slot(slot)))
                except BaseException:
                    # a failed export must not leave the slot frozen
                    # forever — resume it in place and keep going
                    eng.abort_migration(slot)
                    raise
            return out

        exports = self._exec(src_rid, freeze_and_export)
        moved = 0
        # per-item containment: ONE failing move (a destination dying
        # mid-loop) must neither strand the remaining frozen slots nor
        # drop the stream it was moving — every rung falls to the next:
        # abort-in-place (pre-commit) → re-prefill at the source
        # (post-commit) → loud failure (never a silent hang)
        for slot, blob in exports:
            mig_id = f"autopilot-{next(self._mig_seq)}"
            req = None
            try:
                staged = self._exec(
                    dst_rid,
                    lambda e, _m=mig_id, _b=blob: e.stage_migration(_m, _b),
                )
            except Exception as e:
                staged = False
                self.log.warning(
                    "rebalance %s→%s: staging slot %d raised (%s)",
                    src_rid, dst_rid, slot, e,
                )
            if not staged:
                try:
                    self._exec(
                        src_rid, lambda e, _s=slot: e.abort_migration(_s)
                    )
                    self.log.warning(
                        "rebalance %s→%s: slot %d resumes at the source",
                        src_rid, dst_rid, slot,
                    )
                except Exception:
                    self.log.exception(
                        "abort of frozen slot %d failed", slot
                    )
                continue
            try:
                req = self._exec(
                    src_rid, lambda e, _s=slot: e.commit_migration(_s)
                )
                self._resubmit(dst_rid, req, mig_id)
                moved += 1
            except Exception as e:
                if req is None:
                    # commit itself failed: the slot is still frozen at
                    # the source — resume it there
                    try:
                        self._exec(
                            src_rid,
                            lambda e2, _s=slot: e2.abort_migration(_s),
                        )
                    except Exception:
                        self.log.exception(
                            "abort of frozen slot %d failed", slot
                        )
                    continue
                # committed away but the destination can't take the
                # resume (its driver died): the staged ticket TTL-GCs;
                # fall back to a re-prefill resume at the SOURCE
                try:
                    self._resubmit(src_rid, req, None)
                    self.log.warning(
                        "rebalance %s→%s: destination lost slot %d "
                        "mid-move (%s) — stream re-prefills at the "
                        "source", src_rid, dst_rid, slot, e,
                    )
                except Exception as e2:
                    self._fail_stream(req, e2)
        return moved

    # -- drain / deploy --------------------------------------------------
    def drain(self, rid: str) -> None:
        self._exec(rid, lambda e: e.begin_drain())

    def undrain(self, rid: str) -> None:
        self._exec(rid, lambda e: e.end_drain())

    def drain_step(
        self, src_rid: str, dst_rid: str, max_streams: int = 4,
    ) -> int:
        """One drain round: page-ship decode streams, re-submit queued
        and mid-prefill work at the destination down the re-prefill rung.
        Returns the work remaining on the source (0 = drained)."""
        self.rebalance(src_rid, dst_rid, max_streams)

        # pre-flight the SHED load too: shedding pops the requests off a
        # DRAINING source, so a destination rejection would error
        # already-admitted streams (no way back through the fence). If
        # the destination can't take a class yet, leave everything
        # queued/prefilling at the source and retry next tick.
        def pending_classes(eng):
            depth = dict(eng.router_snapshot().get("queue_depth") or {})
            for kind, _s, req in eng.live_manifest():
                if kind == "prefill":
                    depth[req.priority] = depth.get(req.priority, 0) + 1
            return {c: n for c, n in depth.items() if n > 0}

        want = self._exec(src_rid, pending_classes)
        for cls, n in want.items():
            rej = self._exec(
                dst_rid,
                lambda e, _c=cls, _n=n: e.admission_check(_c, _n),
            )
            if rej is not None:
                self.log.warning(
                    "drain %s→%s: destination rejects %d %s shed "
                    "request(s) (%s) — retrying next tick",
                    src_rid, dst_rid, n, cls, rej,
                )
                return self.live_work(src_rid)

        def shed(eng):
            out = list(eng.shed_queued())
            for kind, slot, _req in eng.live_manifest():
                if kind == "prefill":
                    r = eng.shed_slot(slot)
                    if r is not None:
                        out.append(r)
            return out

        for req in self._exec(src_rid, shed):
            # per-item containment: one failed resume (destination died
            # mid-loop) must not strand the remaining popped requests —
            # a shed request can't go back through the drain fence, so
            # the last rung is a LOUD failure, never a silent hang
            try:
                self._resubmit(dst_rid, req, None)
            except Exception as e:
                self._fail_stream(req, e)
        return self.live_work(src_rid)

    def rehost(self, rid: str):
        """The rolling deploy's "upgrade" step — delegate to the
        caller-supplied rebuild (swap binaries, rebuild the engine,
        re-plan the job). Returns the handle to re-register, or None."""
        if self._rebuild is None:
            raise RuntimeError(
                f"no rebuild hook configured — cannot deploy {rid}"
            )
        return self._rebuild(rid)

    def publish_weights(self, rid: str, params, version: int) -> bool:
        """Hot-swap ``params`` into one replica's live engine at its next
        chunk boundary (docs/TRAINING.md "Serve-and-train") — the fleet
        propagation leg of a live weight publish. Returns True on
        success; already-at-version replicas are a no-op success (the
        version check makes re-publishes idempotent)."""

        def do(eng, _p=params, _v=int(version)):
            if int(getattr(eng, "weights_version", 0)) >= _v:
                return eng.weights_version  # already there — idempotent
            return eng.publish_weights(_p, version=_v)

        self._exec(rid, do)
        return True

    def scale_decode(self, up: bool) -> bool:
        """Decode-pool scaling is a validator-level verb (the
        handoff-pool push); an engine-level harness has no pool to
        resize."""
        return False


class FleetAutopilot:
    """Watch the router's refreshed views; act through the actions layer."""

    def __init__(
        self,
        router,
        actions,
        *,
        interval_s: float = 2.0,
        rebalance_spread: float = 0.75,
        max_moves_per_tick: int = 2,
        action_cooldown_s: float = 3.0,
        min_replicas_for_action: int = 2,
        decode_low_water: float = 0.25,
        decode_high_water: float = 0.75,
        dry_run: bool = False,
        metrics: MetricsRegistry | None = None,
        on_action=None,
    ):
        self.router = router
        self.actions = actions
        # control-plane crash safety hook: on_action(phase, kind, rid,
        # token=None) -> token. Called with phase="intent" BEFORE a
        # mutating action starts (the return value is the intent token),
        # then phase="commit"/"abort" with that token when it resolves —
        # the validator wires its write-ahead journal here so a crash
        # mid-deploy is resumed or rolled back at recovery, never
        # forgotten. Must never raise into the control loop (wrapped).
        self.on_action = on_action
        self.interval_s = float(interval_s)
        self.rebalance_spread = float(rebalance_spread)
        self.max_moves_per_tick = max(int(max_moves_per_tick), 1)
        self.action_cooldown_s = float(action_cooldown_s)
        self.min_replicas_for_action = max(int(min_replicas_for_action), 1)
        self.decode_low_water = float(decode_low_water)
        self.decode_high_water = float(decode_high_water)
        self.dry_run = bool(dry_run)
        self.log = get_logger("fleet.autopilot")
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_actions = {
            kind: self.metrics.counter(
                "tlink_autopilot_actions_total",
                "autopilot actions executed", kind=kind,
            )
            for kind in (
                "rebalance", "deploy", "scale_up", "scale_down", "publish",
            )
        }
        self._m_moved = self.metrics.counter(
            "tlink_autopilot_streams_moved_total",
            "live streams migrated between replicas by the autopilot",
        )
        self._lock = threading.Lock()
        self._deploy_queue: deque[str] = deque()  #: guarded by self._lock
        self._deploying: dict | None = None  #: guarded by self._lock
        # in-flight fleet-wide weight publish (docs/TRAINING.md):
        # {"version", "params", "pending", "published", "failed", "ticks"}
        self._publish: dict | None = None  #: guarded by self._lock
        self.history: deque[dict] = deque(maxlen=100)  #: guarded by self._lock
        self._last_action_t = 0.0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "FleetAutopilot":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="fleet-autopilot", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # the control loop must outlive any single bad decision
                self.log.exception("autopilot tick failed")

    # -- operator API ----------------------------------------------------
    def request_deploy(self, rids: list[str] | None = None) -> list[str]:
        """Queue a zero-dropped-token rolling deploy: each replica in
        turn drains (streams migrate to siblings), upgrades (the actions
        layer's rebuild), and rejoins. ``None`` = every current
        replica."""
        targets = [str(r) for r in (rids or self.router.replica_ids())]
        with self._lock:
            for r in targets:
                if r not in self._deploy_queue and (
                    self._deploying is None or self._deploying["rid"] != r
                ):
                    self._deploy_queue.append(r)
        return targets

    def request_publish(self, params, version: int) -> list[str]:
        """Queue a fleet-wide live weight publish: every replica picks
        ``version`` up at its own chunk boundary, ONE replica per tick
        (the deploy ladder's replica-by-replica temperament, though a
        publish never drains anything — streams keep flowing on every
        replica throughout). Draining/unhealthy replicas stay pending
        until they return; a newer request_publish supersedes an
        unfinished one (latest version wins). Typically wired as
        ``ServeTrainLoop.on_publish``. Returns the target replica ids."""
        targets = [str(r) for r in self.router.replica_ids()]
        with self._lock:
            self._publish = {
                "version": int(version), "params": params,
                "pending": list(targets), "published": [],
                "failed": {}, "ticks": 0,
            }
        return targets

    def status(self) -> dict:
        with self._lock:
            pub = self._publish
            return {
                "running": self._thread is not None,
                "dry_run": self.dry_run,
                "deploy_queue": list(self._deploy_queue),
                "deploying": (
                    dict(self._deploying) if self._deploying else None
                ),
                "publishing": (
                    # params deliberately excluded — status is a wire/API
                    # payload (/fleet), not a tensor transport
                    {k: v for k, v in pub.items() if k != "params"}
                    if pub else None
                ),
                "history": list(self.history),
                "streams_moved": int(self._m_moved.value),
            }

    def _record(self, kind: str, **detail) -> dict:
        entry = {"kind": kind, "t": time.monotonic(), **detail}
        with self._lock:
            self.history.append(entry)
        return entry

    # -- load model ------------------------------------------------------
    @staticmethod
    def load_of(view: dict) -> float:
        """One replica's load in slot units: live-slot pressure plus
        queued work per slot. Pure view arithmetic — the unit both the
        rebalance spread and the scaling water marks are expressed in."""
        slots = max(int(view.get("max_slots") or 1), 1)
        free = int(view.get("slots_free") or 0)
        queued = sum(int(v) for v in (view.get("queue_depth") or {}).values())
        return (slots - free) / slots + queued / slots

    # -- the control loop body ------------------------------------------
    def tick(self) -> list[dict]:
        """One decision round. Returns the action records it produced
        (possibly empty). Deterministic given the refreshed views —
        tests drive this directly. A failing ACTION (a replica dying
        under the verb's hands) is recorded, never raised: the control
        loop must outlive any single bad decision, whether the driver
        thread or a direct tick() caller runs it."""
        self.router.refresh(force=True)
        views = self.router.views()
        out: list[dict] = []

        def safe(step, *a) -> dict | None:
            try:
                return step(*a)
            except Exception as e:
                self.log.warning(
                    "autopilot %s failed: %s: %s",
                    step.__name__, type(e).__name__, e,
                )
                return self._record(
                    "error", step=step.__name__,
                    error=f"{type(e).__name__}: {e}"[:200],
                )

        # weight publish first: non-structural (no drain, no rebuild —
        # replicas keep serving through it), so it proceeds even while a
        # deploy holds the one-structural-action rail
        rec = safe(self._publish_step, views)
        if rec:
            out.append(rec)
        with self._lock:
            deploying = self._deploying
        if deploying is not None:
            rec = safe(self._deploy_step, deploying, views)
            if rec:
                out.append(rec)
            return out  # one structural action at a time — the rail
        with self._lock:
            queued_deploy = bool(self._deploy_queue)
        if queued_deploy:
            rec = safe(self._start_deploy, views)
            if rec:
                out.append(rec)
                return out
        rec = safe(self._maybe_rebalance, views)
        if rec:
            out.append(rec)
        rec = safe(self._maybe_scale_decode, views)
        if rec:
            out.append(rec)
        return out

    # a publish whose remaining replicas never become eligible (stuck
    # draining, dead-but-registered) must finish with those marked
    # failed instead of pinning the queue forever
    MAX_PUBLISH_TICKS = 120

    def _publish_step(self, views: dict) -> dict | None:
        """Push the queued weight version to ONE eligible replica (see
        request_publish). Never raises past safe(): a replica dying
        under the publish lands in ``failed`` and the ladder moves on —
        it can pick the version up on rejoin via a fresh request."""
        finish: tuple | None = None
        with self._lock:
            pub = self._publish
            if pub is None:
                return None
            # replicas that left the fleet have nothing to pick up
            pub["pending"] = [r for r in pub["pending"] if r in views]
            eligible = self._eligible(views)
            target = next(
                (r for r in pub["pending"] if r in eligible), None
            )
            if not pub["pending"]:
                self._publish = None
                finish = ("publish_done", pub)
            elif target is None:
                pub["ticks"] += 1
                if pub["ticks"] <= self.MAX_PUBLISH_TICKS:
                    return None  # all pending are draining/dead — retry
                pub["failed"].update({
                    r: "never became eligible" for r in pub["pending"]
                })
                self._publish = None
                finish = ("publish_aborted", pub)
            else:
                version, params = pub["version"], pub["params"]
        if finish is not None:
            # recorded OUTSIDE the lock — _record takes it too
            kind, pub = finish
            return self._record(
                kind, version=pub["version"],
                published=list(pub["published"]),
                failed=dict(pub["failed"]),
            )
        if self.dry_run:
            with self._lock:
                pub["pending"].remove(target)
                pub["published"].append(target)
            return self._record(
                "publish", rid=target, version=version, dry_run=True,
            )
        err = None
        try:
            ok = self.actions.publish_weights(target, params, version)
            if not ok:
                err = "declined (remote replica — deploy path)"
        except Exception as e:  # noqa: BLE001 — per-replica containment
            err = f"{type(e).__name__}: {e}"[:200]
        with self._lock:
            if target in pub["pending"]:
                pub["pending"].remove(target)
            if err is None:
                pub["published"].append(target)
            else:
                pub["failed"][target] = err
        if err is None:
            self._m_actions["publish"].inc()
        return self._record(
            "publish", rid=target, version=version,
            **({"error": err} if err else {}),
        )

    def _cooldown_open(self) -> bool:
        return (
            time.monotonic() - self._last_action_t >= self.action_cooldown_s
        )

    def _eligible(self, views: dict) -> dict:
        return {
            rid: v for rid, v in views.items()
            if v.get("ok", True) and not v.get("draining")
        }

    # -- rebalance -------------------------------------------------------
    def _maybe_rebalance(self, views: dict) -> dict | None:
        eligible = self._eligible(views)
        if len(eligible) < self.min_replicas_for_action:
            return None
        if not self._cooldown_open():
            return None
        loads = {rid: self.load_of(v) for rid, v in eligible.items()}
        hot = max(loads, key=lambda r: (loads[r], r))
        cold = min(loads, key=lambda r: (loads[r], r))
        if hot == cold or loads[hot] - loads[cold] < self.rebalance_spread:
            return None
        if self.dry_run:
            return self._record(
                "rebalance", src=hot, dst=cold, dry_run=True,
                spread=round(loads[hot] - loads[cold], 3),
            )
        moved = self.actions.rebalance(hot, cold, self.max_moves_per_tick)
        self._last_action_t = time.monotonic()
        if moved:
            self._m_actions["rebalance"].inc()
            self._m_moved.inc(moved)
        return self._record(
            "rebalance", src=hot, dst=cold, moved=moved,
            spread=round(loads[hot] - loads[cold], 3),
        )

    def _note_action(self, phase: str, kind: str, rid: str,
                     token=None):
        """Fire the on_action journal hook; a hook failure must never
        take down the control loop (journal trouble degrades to
        un-journaled actions, same as running without one)."""
        if self.on_action is None:
            return None
        try:
            return self.on_action(phase, kind, str(rid), token)
        except Exception:
            self.log.exception("on_action hook (%s %s %s)", phase, kind, rid)
            return token

    # -- rolling deploy --------------------------------------------------
    def _start_deploy(self, views: dict) -> dict | None:
        eligible = self._eligible(views)
        with self._lock:
            if not self._deploy_queue:
                return None
            rid = self._deploy_queue[0]
            if rid not in views:
                # unknown/deregistered target: DROP it — leaving it at
                # the head would wedge every later (valid) deploy behind
                # a typo forever
                self._deploy_queue.popleft()
                dropped = rid
            else:
                dropped = None
        if dropped is not None:
            return self._record(
                "deploy_skipped", rid=dropped, reason="unknown replica"
            )
        with self._lock:
            if not self._deploy_queue or self._deploy_queue[0] != rid:
                return None
            # rail: draining this replica must leave at least one
            # serving replica behind — WAIT (keep it queued) until a
            # sibling is healthy rather than drop the request
            others = [r for r in eligible if r != rid]
            if not others:
                return None
            self._deploy_queue.popleft()
            self._deploying = {"rid": rid, "phase": "draining"}
        # write-ahead: the intent is durable BEFORE the drain starts, so
        # a validator crash mid-deploy finds an open intent at replay
        token = self._note_action("intent", "deploy", rid)
        with self._lock:
            if self._deploying is not None and self._deploying["rid"] == rid:
                self._deploying["token"] = token
        if not self.dry_run:
            self.actions.drain(rid)
            self._last_action_t = time.monotonic()
        return self._record("deploy_drain", rid=rid, dry_run=self.dry_run)

    # a deploy stuck draining (dead destination, a remote replica whose
    # stale snapshot never reads empty) must eventually ABORT instead of
    # blocking rebalancing/scaling forever behind the one-action rail
    MAX_DEPLOY_TICKS = 120

    def _abort_deploy(self, rid: str, reason: str) -> dict:
        try:
            self.actions.undrain(rid)  # resume serving in place
        except Exception:
            self.log.exception("undrain of %s after failed deploy", rid)
        with self._lock:
            token = (self._deploying or {}).get("token")
            self._deploying = None
        self._note_action("abort", "deploy", rid, token)
        return self._record("deploy_aborted", rid=rid, reason=reason)

    def _deploy_step(self, deploying: dict, views: dict) -> dict | None:
        rid = deploying["rid"]
        if self.dry_run:
            with self._lock:
                self._deploying = None
            self._note_action("commit", "deploy", rid, deploying.get("token"))
            return self._record("deploy_done", rid=rid, dry_run=True)
        deploying["ticks"] = deploying.get("ticks", 0) + 1
        if deploying["ticks"] > self.MAX_DEPLOY_TICKS:
            return self._abort_deploy(rid, "drain never completed")
        # coldest sibling takes the drained streams
        others = {
            r: v for r, v in self._eligible(views).items() if r != rid
        }
        if not others:
            # nothing to drain onto: abort the deploy, resume serving
            return self._abort_deploy(rid, "no destination replica")
        dst = min(others, key=lambda r: (self.load_of(others[r]), r))
        remaining = self.actions.drain_step(
            rid, dst, max_streams=self.max_moves_per_tick
        )
        if remaining > 0:
            return self._record(
                "deploy_draining", rid=rid, dst=dst, remaining=remaining
            )
        # drained: upgrade + rejoin. A failing upgrade must not wedge the
        # state machine — abort, resume the (drained, empty) replica in
        # place, and surface the error in the history
        try:
            handle = self.actions.rehost(rid)
        except Exception as e:
            self.log.exception("rehost of %s failed", rid)
            rec = self._abort_deploy(
                rid, f"rehost failed: {type(e).__name__}: {e}"[:200]
            )
            return rec
        if handle is not None:
            self.router.register(rid, handle)
        else:
            self.actions.undrain(rid)
        self._m_actions["deploy"].inc()
        self._last_action_t = time.monotonic()
        with self._lock:
            self._deploying = None
        self._note_action("commit", "deploy", rid, deploying.get("token"))
        return self._record("deploy_done", rid=rid, dst=dst)

    # -- decode-pool scaling ---------------------------------------------
    def _maybe_scale_decode(self, views: dict) -> dict | None:
        decode = [
            v for v in views.values() if v.get("worker_role") == "decode"
        ]
        if not decode or not self._cooldown_open():
            return None
        # free-slot fraction across the decode pool: below the low water
        # mark the pool is saturating (grow), above the high water mark
        # it idles (shrink)
        frac = sum(
            int(v.get("slots_free") or 0) for v in decode
        ) / max(sum(int(v.get("max_slots") or 1) for v in decode), 1)
        up = frac < self.decode_low_water
        down = frac > self.decode_high_water
        if not up and not down:
            return None
        if self.dry_run:
            return self._record(
                "scale_decode", up=up, free_frac=round(frac, 3),
                dry_run=True,
            )
        direction = "up" if up else "down"
        token = self._note_action("intent", "scale_decode", direction)
        acted = self.actions.scale_decode(up)
        if not acted:
            # the actions layer declined (no pool to resize)
            self._note_action("abort", "scale_decode", direction, token)
            return None
        self._note_action("commit", "scale_decode", direction, token)
        self._last_action_t = time.monotonic()
        self._m_actions["scale_up" if up else "scale_down"].inc()
        return self._record(
            "scale_decode", up=up, free_frac=round(frac, 3)
        )


__all__ = ["EngineFleetActions", "FleetAutopilot"]
