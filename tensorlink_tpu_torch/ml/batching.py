"""Continuous serving front-end (port of
``tensorlink_tpu/ml/batching.py::ContinuousBatcher``, local mode).

A :class:`ContinuousBatcher` wraps a local slot engine (a
``GenerationEngine`` or ``ContinuousEngine`` from this package) and drives
it on one dispatcher thread: client threads call the blocking
:meth:`ContinuousBatcher.generate`, each request joins the running slot
batch within one chunk, and a finished request frees its KV at once.
Stepping-thread work (migration verbs, prefix pulls, weight publishes)
reaches the engine through :meth:`ContinuousBatcher.run_on_driver`
between chunks, and a background hook (:meth:`set_background`) runs
there too. The remote (``model=`` single-stage) and pipelined modes and
the static ``GenBatcher`` wait for the node/API slice.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from ..engine.continuous import ContinuousEngine
from ..engine.sampling import SamplingParams
from ..engine.scheduler import DEFAULT_PRIORITY, normalize_priority


@dataclass
class _Pending:
    ids: list[int]
    max_new_tokens: int
    temperature: float
    top_k: int
    top_p: float
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
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


def _headroom_from(snap: dict) -> dict:
    """The per-replica headroom fields of a ``router_snapshot``."""
    return {
        k: snap[k]
        for k in ("slots_free", "kv_pages_free", "queue_depth", "draining")
    }


class ContinuousBatcher:
    """Continuous serving scheduler over a local slot engine: blocking
    ``generate`` with a per-token stream callback, ``stats`` and
    ``close``. Request ``n`` (from 1) samples with seed ``seed + n``."""

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
        if engine is None or model is not None:
            raise NotImplementedError(
                "only local mode (engine=) is ported; the remote and "
                "pipelined modes arrive with the node/API slice of the port"
            )
        self.eos_ids = list(eos_ids or [])
        self.seed = int(seed)
        self.default_priority = normalize_priority(default_priority)
        self.max_slots = int(max_slots)
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
        """The slot engine (None once the dispatcher closed it on an error)."""
        return self._cont


    def metrics_registry(self):
        """The engine's metrics registry (None once the engine closed)."""
        return self._cont.metrics if self._cont is not None else None

    def serving_modes(self) -> dict:
        """Throughput-mode summary (attribute reads, no engine round
        trip), under the JAX batcher's keys: KV storage, weight storage,
        speculation, host tier, pool role, weights version, and the
        tenant's quota view on a shared pool."""
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
        service EWMA, both tiers' digests)."""
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
    ) -> list[int]:
        """Queue one request and block until it finishes; returns its
        tokens. ``stream_cb([tok])`` sees each token as it is delivered
        (a true return cancels the request). ``speculative`` opts into
        draft/verify decoding on a ``spec_decode`` engine. ``handoff`` is
        the remote mode's per-request opt-out of the prefill→decode
        handoff; a local engine serves the request where it is, as the
        JAX batcher's local mode does."""
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
        req.submit_t = time.monotonic()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("model is being unhosted")
            req.seed = self.seed + next(self._seq)
            self._q.put(req)
            self._wake.set()
        if not req.done.wait(timeout):
            raise TimeoutError("generation timed out in the batcher")
        if req.error is not None:
            raise req.error
        with self._stats_lock:
            self._served += 1
        return req.result or []

    def admission_check(self, priority=None, n: int = 1) -> dict | None:
        """Backpressure gate: None = admit, else the engine scheduler's
        rejection record."""
        cont = self._cont
        if cont is None:
            raise RuntimeError("local engine is closed")
        return cont.admission_check(
            normalize_priority(priority or self.default_priority), n
        )

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
        close the engine (which checks page conservation)."""
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
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.error = RuntimeError("model is being unhosted")
                req.done.set()
        self._run_ctl(None)  # control waiters must not hang on a close


__all__ = ["ContinuousBatcher"]
