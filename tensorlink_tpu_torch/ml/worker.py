"""DistributedWorker — the ML-side executor of a worker node (port of the
serving part of ``tensorlink_tpu/ml/worker.py``).

The executor blocks on one event queue fed by the network process and
serves whole-model jobs on one device:

- ``load_stage`` builds the job's :class:`GenerationEngine` from a
  checkpoint (``engine/loader.py::load_params``) or from seeded random
  weights, optionally weight-only int8 (``quant`` "int8" / "int8+kv");
- GENERATE requests flagged ``continuous`` join the job's
  :class:`ContinuousEngine` slot batch and stream each token back over the
  TOKEN relay; a ``cont_continue`` marker on the work queue drives one
  chunk per trip, so requests that arrive meanwhile are admitted at the
  next chunk boundary;
- every other GENERATE takes the dense engine's static paths
  (``generate_compiled``, ``generate``/``generate_chunked`` when streamed,
  ``generate_lookahead``, chunked beam search).

Pipelined stages, training, live migration and the disaggregated
prefill→decode handoff wait for later slices of the port: their verbs
raise ``NotImplementedError`` naming their ROADMAP item, and the run
loop's error reply carries that message to the peer.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any

from tensorlink_tpu_torch import unported
from tensorlink_tpu_torch.core.faults import FaultCrash, FaultPlan
from tensorlink_tpu_torch.core.logging import get_logger
from tensorlink_tpu_torch.p2p import protocol as proto

# verbs of the JAX worker that later slices port, with their ROADMAP
# queue 1 item
_UNPORTED = {
    proto.FORWARD: ("pipelined stage forwards", 8),
    proto.BACKWARD: ("training", 9),
    proto.OPTIMIZER: ("training", 9),
    proto.PROOF_REQ: ("training proofs", 9),
    proto.CHECKPOINT: ("training checkpoints", 9),
    proto.PARAMS_REQ: ("parameter download for training", 9),
    proto.TRAIN_MODE: ("training", 9),
    proto.DRAIN: ("worker drain and live migration", 7),
    proto.MIGRATE: ("live slot migration", 7),
    proto.HANDOFF: ("the prefill→decode handoff", 7),
    proto.REPLICA_SET: ("fleet replica sets", 7),
}


@dataclass
class StageRuntime:
    """One loaded whole-model job: config + serving engines."""

    job_id: str
    cfg: Any  # ModelConfig
    stage: dict  # StagePlan as dict (layer_lo/hi, first, last, holds_head)
    # the model spec this stage was shipped with (name, config, ckpt/seed,
    # quant, flash, page_quota)
    model_spec: dict = field(default_factory=dict)
    engine: Any = None  # GenerationEngine
    cache_quant: bool = False  # int8 dense KV caches ("int8+kv")
    # in-flight chunked beam-search sessions: rid -> (BeamState, payload,
    # effective K). A long beam decode advances _BEAM_CHUNK_STEPS at a
    # time and requeues itself, so queued generates interleave with it
    beam_sessions: dict[str, Any] = field(default_factory=dict)
    # the continuous-batching slot engine: GENERATE requests flagged
    # "continuous" submit into its slot batch and a cont_continue marker
    # drives chunked decode through the work queue
    cont: Any = None
    cont_scheduled: bool = False
    # journal rid -> live ContinuousRequest for every continuous stream
    # admitted with a jrid (what an attach_only re-handshake reports)...
    jstreams: dict[str, Any] = field(default_factory=dict)
    # ...and jrid -> {"tokens", "base", "t"} for streams that finished —
    # a bounded ledger (MLConfig.orphan_keep / orphan_ttl_s) for streams
    # whose final response may have gone to a dead peer
    orphans: dict[str, dict] = field(default_factory=dict)

    @property
    def n_layers(self) -> int:
        return self.stage["layer_hi"] - self.stage["layer_lo"]


# beam-search chunk size: steps a beam session may run per trip through the
# worker's serial loop before requeueing itself behind waiting work
_BEAM_CHUNK_STEPS = 32


class DistributedWorker:
    """Event-driven executor; one instance per WorkerNode."""

    def __init__(self, node):
        from tensorlink_tpu_torch.core.devices import resolve_device

        self.node = node
        self.bridge = node.bridge
        self.log = get_logger(f"ml.worker{node.config.duplicate}")
        # the card (MLConfig.device None) or the host; no card raises here
        self.device = resolve_device(node.config.ml.device)
        self.jobs: dict[str, StageRuntime] = {}
        self._lock = threading.Lock()
        # shared multi-tenant KV page pools (engine/paged.py::
        # SharedPagePool), keyed by page geometry — created lazily at the
        # first continuous engine when MLConfig.cont_pool_pages > 0 and
        # touched only from the serial run loop
        self._kv_pools: dict = {}
        # per-node fault plan (core/faults.py); None keeps the hot paths
        # free of fault-site calls
        fspec = getattr(node.config, "faults", None)
        self.faults: FaultPlan | None = (
            FaultPlan.from_dict(fspec) if fspec else None
        )

    # -- capacity -------------------------------------------------------
    def capacity(self) -> dict:
        """What this worker advertises: the device's free memory, one
        device, its platform, and its serving role."""
        from tensorlink_tpu_torch.core.devices import probe_device

        ml = self.node.config.ml
        probe = probe_device(self.device, ml.max_memory_gb)
        out = {
            "hbm_bytes": probe.hbm_bytes,
            "n_devices": probe.n_devices,
            "platform": probe.platform,
            "training": True,
            "serving_role": str(getattr(ml, "worker_role", "mixed") or "mixed"),
            "tensor_parallel": int(getattr(ml, "tensor_parallel", 1) or 1),
        }
        if ml.slice_id:
            out["slice_id"] = ml.slice_id
        return out

    # -- main loop ------------------------------------------------------
    def run(self) -> None:
        while True:
            item = self.bridge.get_work(timeout=1.0)
            if item is None:
                continue
            kind, payload = item
            if kind == "_stop":
                return
            try:
                self._handle(kind, payload)
            except FaultCrash as e:
                # injected node death: kill the network process abruptly so
                # every peer sees a dropped connection, and exit this loop
                self.log.warning("fault injection: %s — node going down", e)
                self.node.crash()
                return
            except Exception as e:
                self.log.exception("work %s failed", kind)
                rid, peer = payload.get("rid"), payload.get("peer")
                if rid and peer:
                    resp_tag = {
                        proto.FORWARD: proto.FORWARD_RESP,
                        proto.BACKWARD: proto.BACKWARD_RESP,
                        proto.GENERATE: proto.GENERATE_RESP,
                        proto.OPTIMIZER: proto.OPTIMIZER_RESP,
                        proto.PARAMS_REQ: proto.PARAMETERS,
                        proto.CHECKPOINT: proto.CHECKPOINT_RESP,
                        proto.PROOF_REQ: proto.PROOF_RESP,
                        proto.MIGRATE: proto.MIGRATE_RESP,
                        proto.DRAIN: proto.DRAIN_RESP,
                        "load_stage": proto.MODULE_LOADED,
                        "beam_continue": proto.GENERATE_RESP,
                    }.get(kind, proto.FORWARD_RESP)
                    err_peer = payload.get("reply_to") or peer
                    try:
                        self._respond(
                            err_peer, resp_tag, rid,
                            {"error": f"{type(e).__name__}: {e}",
                             "worker": self.node.node_id},
                        )
                    except Exception as e2:
                        # the requester died too: an undeliverable reply
                        # must never kill this loop
                        self.log.warning(
                            "error reply for %s to %s undeliverable: %s",
                            kind, str(err_peer)[:8], e2,
                        )

    def _handle(self, kind: str, p: dict) -> None:
        if kind == "load_stage":
            self._load_stage(p)
        elif kind == proto.GENERATE:
            self._generate(p)
        elif kind == "beam_continue":
            self._beam_step(p["job_id"], p["rid"])
        elif kind == "cont_continue":
            self._cont_step(p["job_id"])
        elif kind in _UNPORTED:
            raise unported(*_UNPORTED[kind])
        elif kind == "shutdown_job":
            self.shutdown_job(p.get("job_id", ""))
        elif kind == "token":
            pass  # token relays are user/validator side
        else:
            self.log.warning("unhandled work kind %s", kind)

    def shutdown_job(self, job_id: str) -> None:
        """Drop a job: fail its queued and in-flight continuous requests
        fast, and release a shared page pool it leaves empty."""
        with self._lock:
            rt = self.jobs.pop(job_id, None)
        if rt is not None and rt.cont is not None:
            rt.cont.close(RuntimeError("job shut down"))
            rt.cont = None
            self._gc_kv_pools()

    def _respond(self, peer: str, tag: str, rid: str, body: dict) -> None:
        self.bridge.request(
            "respond", {"peer": peer, "tag": tag, "rid": rid, "body": body}
        )

    # -- loading --------------------------------------------------------
    def _load_stage(self, p: dict) -> None:
        import torch

        from tensorlink_tpu_torch.engine.generate import GenerationEngine
        from tensorlink_tpu_torch.models.base import ModelConfig
        from tensorlink_tpu_torch.models.transformer import init_params

        t0 = time.monotonic()
        job_id = p["job_id"]
        if p.get("attach_only"):
            # validator re-handshake: ACK a live stage without rebuilding
            # it (a rebuild would kill every live slot) and announce its
            # live and finished streams
            with self._lock:
                rt = self.jobs.get(job_id)
            if rt is not None:
                body = {
                    "job_id": job_id, "ok": True, "attached": True,
                    "n_layers": rt.n_layers,
                    "live_slots": (
                        rt.cont.live_slots if rt.cont is not None else 0
                    ),
                    "orphans": self._orphan_report(rt),
                }
                self._respond(p["peer"], proto.MODULE_LOADED, p["rid"], body)
                return
        model = p["model"]
        stage = p["stage"]
        ml = self.node.config.ml
        cfg = ModelConfig.from_json(model["config"])
        n_mesh = 1
        for v in (stage.get("mesh_axes") or {}).values():
            n_mesh *= int(v)
        if (
            not (stage["first"] and stage["last"] and stage["holds_head"])
            or stage["layer_lo"] != 0 or stage["layer_hi"] != cfg.n_layers
            or n_mesh > 1 or stage.get("coworkers")
            or int(getattr(ml, "tensor_parallel", 1) or 1) > 1
            or ml.collective_quant
        ):
            raise unported(
                "a pipeline stage, a device mesh or tensor parallelism", 8
            )
        if p.get("training", False):
            raise unported("training", 9)
        if model.get("ckpt"):
            from tensorlink_tpu_torch.engine.loader import load_params

            _, params = load_params(
                model["ckpt"], cfg, layer_range=(0, cfg.n_layers),
                device=self.device,
            )
        else:
            gen = torch.Generator(self.device)
            gen.manual_seed(int(model.get("seed", 0)))
            params = init_params(cfg, gen, self.device)
        if model.get("flash"):
            cfg = cfg.with_(flash_attention=True)
        quant = model.get("quant")
        if quant and quant not in ("int8", "int8+kv"):
            # fail the MODULE load rather than serve a mode nobody asked for
            raise ValueError(f"unknown quant mode {quant!r}")
        rt = StageRuntime(
            job_id=job_id,
            cfg=cfg,
            stage=stage,
            model_spec=dict(model),
            cache_quant=quant == "int8+kv",
        )
        rt.engine = GenerationEngine(
            cfg,
            params,
            max_seq_len=min(cfg.max_seq_len, ml.max_seq_len),
            seq_buckets=ml.seq_buckets,
            batch_buckets=ml.batch_buckets,
            # the engine quantizes the weights itself; "+kv" also sets
            # its dense cache mode, and the mode rides serving snapshots
            quant=quant or None,
            device=self.device,
        )
        with self._lock:
            old = self.jobs.get(job_id)
            self.jobs[job_id] = rt
        if old is not None and old.cont is not None:
            # a re-shipped stage replaces the runtime: fail the old slot
            # engine's in-flight requests fast
            old.cont.close(RuntimeError("stage reloaded"))
            old.cont = None
        self.log.info(
            "loaded %s layers [0,%d) on %s in %.1fs",
            model.get("name", "?"), cfg.n_layers, self.device,
            time.monotonic() - t0,
        )
        self._respond(
            p["peer"], proto.MODULE_LOADED, p["rid"],
            {"job_id": job_id, "ok": True, "n_layers": cfg.n_layers},
        )
        warm_toks = ml.warmup_tokens
        if warm_toks:
            # after the ack: warming must not time out the deploy, and a
            # warmup failure must not double-respond on this rid
            try:
                dt = rt.engine.warmup(max_new_tokens=warm_toks)
                self.log.info(
                    "warmed serving programs in %.1fs (%d tokens)",
                    dt, warm_toks,
                )
            except Exception:
                self.log.exception("serving warmup failed (serving anyway)")

    def _runtime(self, job_id: str) -> StageRuntime:
        rt = self.jobs.get(job_id)
        if rt is None:
            raise KeyError(f"job {job_id} not loaded")
        return rt

    # -- generate (whole-model jobs) ------------------------------------
    def _generate(self, p: dict) -> None:
        """Generation on a whole-model job. Streams token ids over the
        TOKEN relay when ``stream`` is set, then resolves with the full
        sequences."""
        from tensorlink_tpu_torch.engine.sampling import SamplingParams

        rt = self._runtime(p["job_id"])
        prompts = [list(map(int, row)) for row in p["prompts"]]
        if p.get("continuous") and self._generate_continuous(rt, p, prompts):
            return  # admitted into the slot batch; responds via on_finish
        knobs = (
            p.get("temperature", 0.0), p.get("top_k", 0), p.get("top_p", 1.0),
            p.get("presence_penalty", 0.0), p.get("frequency_penalty", 0.0),
        )
        # per-row knobs (ml/batching.py mixes requests); a scalar among
        # sequences applies to every row
        n = len(prompts)

        def rows(v):
            return list(v) if isinstance(v, (list, tuple)) else [v] * n

        per_row = [
            SamplingParams.make(
                temperature=float(t), top_k=int(k), top_p=float(tp),
                presence_penalty=float(pp), frequency_penalty=float(fp),
            )
            for t, k, tp, pp, fp in zip(*(rows(v) for v in knobs))
        ]
        sampling = SamplingParams.stack(per_row, pad_to=n)
        budgets = p.get("budgets")
        reuse_prefix = bool(p.get("reuse_prefix", False)) and len(prompts) == 1
        # prompt-lookup speculation: greedy B=1 only, and a penalized
        # request takes the vanilla loop (penalties change greedy's picks)
        greedy = not isinstance(p.get("temperature", 0.0), (list, tuple)) \
            and float(p.get("temperature", 0.0)) <= 0.0
        lookahead = (
            bool(p.get("lookahead", False)) and len(prompts) == 1 and greedy
            and not any(
                isinstance(v, (list, tuple)) or float(v or 0.0) != 0.0
                for v in knobs[3:]
            )
        )
        stream_id = p.get("stream")
        peer = p["peer"]
        chunk_cfg = int(self.node.config.ml.stream_chunk_steps or 0)
        # confirmed stop-sequence cancels ride back as STREAM_CANCEL frames
        # parked on the network server; poll them once per `poll_every`
        # steps (one blocking IPC round trip per chunk, not per token)
        poll_every = chunk_cfg if chunk_cfg > 0 else 32
        steps_seen = 0

        def stream_cb(emitted):
            nonlocal steps_seen
            pairs = [[i, t] for i, t in enumerate(emitted) if t is not None]
            if pairs:
                # fire-and-forget: a blocking round trip here would add a
                # full IPC latency to every decode step
                self.bridge.notify(
                    "send_token",
                    {"peer": peer, "stream": stream_id, "tokens": pairs},
                )
            steps_seen += 1
            if stream_id and steps_seen % poll_every == 0:
                try:
                    rows = self.bridge.request(
                        "poll_cancel", {"stream": stream_id}, timeout=5.0
                    )
                except Exception:
                    rows = None  # relay hiccup must not kill the decode
                return rows or None
            return None

        if int(p.get("num_beams", 1)) > 1:
            # beams ride the engine's batch axis: clamp to the largest
            # batch bucket, logged, with the effective width in the reply
            k = min(int(p["num_beams"]), max(rt.engine.batch_buckets))
            if k < int(p["num_beams"]):
                self.log.warning(
                    "num_beams=%d clamped to %d (largest batch bucket; "
                    "configure batch_buckets to serve wider beams)",
                    int(p["num_beams"]), k,
                )
            st = rt.engine.beam_start(
                prompts,
                num_beams=k,
                max_new_tokens=int(p.get("max_new_tokens", 128)),
                eos_ids=p.get("eos_ids", ()),
            )
            rt.beam_sessions[p["rid"]] = (st, p, k)
            self._beam_step(p["job_id"], p["rid"])
            return
        if lookahead:
            result = rt.engine.generate_lookahead(
                prompts,
                max_new_tokens=int(p.get("max_new_tokens", 128)),
                eos_ids=p.get("eos_ids", ()),
                reuse_prefix=reuse_prefix,
                stream_cb=stream_cb if stream_id else None,
            )
            if stream_id:
                self.bridge.request(
                    "send_token",
                    {"peer": peer, "stream": stream_id, "tokens": [],
                     "done": True},
                )
        elif stream_id:
            gen_kw = dict(
                max_new_tokens=int(p.get("max_new_tokens", 128)),
                sampling=sampling,
                eos_ids=p.get("eos_ids", ()),
                seed=int(p.get("seed", 0)),
                stream_cb=stream_cb,
                budgets=budgets,
                reuse_prefix=reuse_prefix,
            )
            if chunk_cfg > 0:
                # chunked streaming: one host round trip per chunk
                result = rt.engine.generate_chunked(
                    prompts, chunk_steps=chunk_cfg, **gen_kw
                )
            else:
                result = rt.engine.generate(prompts, **gen_kw)
            self.bridge.request(
                "send_token",
                {"peer": peer, "stream": stream_id, "tokens": [], "done": True},
            )
        else:
            result = rt.engine.generate_compiled(
                prompts,
                max_new_tokens=int(p.get("max_new_tokens", 128)),
                sampling=sampling,
                eos_ids=p.get("eos_ids", ()),
                seed=int(p.get("seed", 0)),
                budgets=budgets,
                reuse_prefix=reuse_prefix,
            )
        if stream_id:
            # release any cancel rows parked for this stream server-side
            self.bridge.notify("clear_cancels", {"stream": stream_id})
        self._respond(
            peer, proto.GENERATE_RESP, p["rid"],
            {
                "sequences": [list(map(int, s)) for s in result.sequences],
                "finished": list(map(bool, result.finished)),
            },
        )

    def _beam_step(self, job_id: str, rid: str) -> None:
        """Advance an in-flight beam session one bounded chunk; unfinished
        sessions requeue a marker behind the waiting work (FIFO)."""
        rt = self._runtime(job_id)
        entry = rt.beam_sessions.get(rid)
        if entry is None:
            return  # job shut down / duplicate marker
        st, p, k = entry
        try:
            # the engine the session STARTED on: a load_stage between
            # chunks may swap rt.engine
            done = st.engine.beam_advance(st, max_steps=_BEAM_CHUNK_STEPS)
        except BaseException:
            rt.beam_sessions.pop(rid, None)
            raise  # the run-loop error path responds on this rid
        if not done:
            self.bridge.q.work.put(
                ("beam_continue",
                 {"job_id": job_id, "rid": rid, "peer": p["peer"]})
            )
            return
        rt.beam_sessions.pop(rid, None)
        result = st.engine.beam_finish(st)
        stream_id = p.get("stream")
        if stream_id:
            # beams emit nothing until the search completes; close the
            # relay so a streaming caller never stalls on the drain
            self.bridge.request(
                "send_token",
                {"peer": p["peer"], "stream": stream_id, "tokens": [],
                 "done": True},
            )
        self._respond(
            p["peer"], proto.GENERATE_RESP, rid,
            {"sequences": [list(map(int, s)) for s in result.sequences],
             "finished": list(map(bool, result.finished)),
             "num_beams_used": k},
        )

    # -- continuous batching (engine/continuous.py) ----------------------
    def _generate_continuous(self, rt: StageRuntime, p: dict,
                             prompts: list[list[int]]) -> bool:
        """Admit a GENERATE flagged ``continuous`` into the job's slot
        engine. Returns False when the request can't take the continuous
        path (per-row knob lists, beams, lookahead, or a model the paged
        engine refuses): the caller then falls through to the static
        paths."""
        from tensorlink_tpu_torch.engine.sampling import SamplingParams

        knobs = (
            p.get("temperature", 0.0), p.get("top_k", 0),
            p.get("top_p", 1.0), p.get("presence_penalty", 0.0),
            p.get("frequency_penalty", 0.0),
        )
        if (
            len(prompts) != 1
            or any(isinstance(v, (list, tuple)) for v in knobs)
            or int(p.get("num_beams", 1)) > 1
            or p.get("lookahead")
        ):
            return False
        if p.get("reattach"):
            raise unported("stream re-attach", 7)
        cont = self._ensure_cont(rt)
        if cont is None:
            return False
        tid = str(p.get("trace") or "")
        jrid = str(p.get("jrid") or "")
        t, k, tp, pp, fp = knobs
        sampling = SamplingParams.make(
            temperature=float(t), top_k=int(k), top_p=float(tp),
            presence_penalty=float(pp or 0.0),
            frequency_penalty=float(fp or 0.0),
        )
        stream_id = p.get("stream")
        peer = p["peer"]
        stream_cb, on_finish = self._cont_channels(
            rt, cont, peer=peer, rid=p["rid"], stream_id=stream_id,
            tid=tid, jrid=jrid,
        )
        req = cont.submit(
            prompts[0],
            max_new_tokens=int(p.get("max_new_tokens", 128)),
            sampling=sampling,
            eos_ids=p.get("eos_ids", ()),
            seed=int(p.get("seed", 0)),
            start_step=int(p.get("start_step", 0)),
            priority=p.get("priority"),
            stream_cb=stream_cb if stream_id else None,
            on_finish=on_finish,
            trace_id=tid,
            # draft/verify opt-in (no-op unless this engine's spec_decode
            # is on; streams bit-identical either way)
            speculative=bool(p.get("speculative", False)),
        )
        req.client_meta = {
            "peer": peer, "rid": p["rid"], "stream": stream_id,
            "trace": tid, "jrid": jrid,
        }
        if jrid:
            rt.jstreams[jrid] = req
        self._schedule_cont(rt)
        return True

    def _cont_channels(self, rt: StageRuntime, cont, *, peer, rid,
                       stream_id, tid, jrid=""):
        """The (stream_cb, on_finish) transport closures of a continuous
        stream: one TOKEN frame per token, cancel polls once per chunk, and
        the final GENERATE_RESP carrying the engine's serving snapshot and
        the request's spans."""
        state = {"n": 0}

        def stream_cb(tok: int):
            self.bridge.notify(
                "send_token",
                {"peer": peer, "stream": stream_id, "tokens": [[0, int(tok)]]},
            )
            state["n"] += 1
            if state["n"] % cont.chunk_steps == 0:
                try:
                    rows = self.bridge.request(
                        "poll_cancel", {"stream": stream_id}, timeout=5.0
                    )
                except Exception:
                    rows = None  # relay hiccup must not kill the decode
                return bool(rows)
            return False

        def on_finish(req):
            if stream_id:
                try:
                    self.bridge.request(
                        "send_token",
                        {"peer": peer, "stream": stream_id, "tokens": [],
                         "done": True},
                    )
                    self.bridge.notify("clear_cancels", {"stream": stream_id})
                except Exception as e:
                    self.log.debug(
                        "stream %s done-marker push failed: %s",
                        stream_id, e,
                    )
            if jrid:
                rt.jstreams.pop(jrid, None)
                if req.error is None:
                    self._stash_orphan(rt, jrid, req)
            if req.error is not None:
                try:
                    self._respond(
                        peer, proto.GENERATE_RESP, rid,
                        {"error": f"{type(req.error).__name__}: {req.error}",
                         "worker": self.node.node_id},
                    )
                except Exception as e:
                    # the requester is gone: an undeliverable reply must
                    # not reach step_chunk and close the ENGINE
                    self.log.warning(
                        "error response for %s undeliverable: %s", rid, e)
                return
            body = {
                "sequences": [list(map(int, req.tokens))],
                "finished": [bool(req.finished)],
                "continuous": True,
                # engine occupancy + counters ride every response, so the
                # validator's /stats needs no polling RPC
                "serving": cont.serving_snapshot(),
            }
            if tid:
                body["trace"] = {
                    "id": tid, "spans": cont.tracer.collect(tid),
                }
            try:
                self._respond(peer, proto.GENERATE_RESP, rid, body)
            except Exception as e:
                self.log.warning(
                    "final response for %s undeliverable (orphan %s kept): %s",
                    rid, jrid or "-", e)

        return stream_cb, on_finish

    def _stash_orphan(self, rt: StageRuntime, jrid: str, req) -> None:
        """Record a finished continuous stream in the bounded orphan
        ledger (MLConfig.orphan_keep / orphan_ttl_s)."""
        ml = self.node.config.ml
        keep = int(getattr(ml, "orphan_keep", 64))
        if keep <= 0:
            return
        now = time.monotonic()
        ttl = float(getattr(ml, "orphan_ttl_s", 180.0))
        for k in [k for k, v in rt.orphans.items() if now - v["t"] > ttl]:
            rt.orphans.pop(k, None)
        while len(rt.orphans) >= keep:  # dict preserves insertion order
            rt.orphans.pop(next(iter(rt.orphans)), None)
        rt.orphans[jrid] = {
            "tokens": [int(t) for t in req.tokens],
            "base": int(req.start_step),
            "t": now,
        }

    def _orphan_report(self, rt: StageRuntime) -> list[dict]:
        """Per-jrid live/finished stream announcement riding the
        attach_only MODULE_LOADED ack."""
        out = []
        for jrid, req in rt.jstreams.items():
            out.append({
                "jrid": jrid,
                "n": int(req.start_step) + len(req.tokens),
                "finished": bool(req.finished),
            })
        for jrid, o in rt.orphans.items():
            out.append({
                "jrid": jrid,
                "n": int(o["base"]) + len(o["tokens"]),
                "finished": True,
            })
        return out

    def _ensure_cont(self, rt: StageRuntime):
        """The job's slot engine, (re)built after load_stage swapped the
        generation engine. None when the model can't serve continuous —
        callers fall back to the static paths."""
        cont = rt.cont
        if cont is not None and cont.engine is rt.engine:
            return cont
        from tensorlink_tpu_torch.engine.continuous import ContinuousEngine

        ml = self.node.config.ml
        pool = None
        quota = 0
        if int(getattr(ml, "cont_pool_pages", 0)) > 0:
            pool = self._shared_kv_pool(rt, ml)
            quota = int(
                (rt.model_spec or {}).get("page_quota")
                or getattr(ml, "cont_pool_quota", 0)
            )
        try:
            rt.cont = cont = ContinuousEngine(
                rt.engine,
                worker_role=str(getattr(ml, "worker_role", "mixed") or "mixed"),
                # co-hosting: jobs whose page geometry matches share ONE
                # pool under a per-model quota; job_id keys the tenant
                pool=pool, model_id=rt.job_id, page_quota=quota,
                # spans this engine records carry the worker's identity
                trace_site=str(self.node.node_id or ""),
                max_slots=int(ml.cont_max_slots),
                page_size=int(ml.cont_page_size),
                chunk_steps=int(ml.cont_chunk_steps),
                prefill_chunk=int(ml.prefill_chunk),
                prefix_cache=bool(ml.prefix_cache),
                host_tier_pages=int(getattr(ml, "cont_host_tier_pages", 0)),
                # `or` before str(): a null kv_quant reads as "none"
                kv_quant=str(ml.kv_quant or "none"),
                spec_decode=bool(getattr(ml, "spec_decode", False)),
                spec_draft=int(getattr(ml, "spec_draft", 8)),
                spec_budget=int(getattr(ml, "spec_budget", 0)),
                default_priority=str(ml.default_priority),
                sched_queue_cap=int(ml.sched_queue_cap),
                sched_aging_ticks=int(ml.sched_aging_ticks),
                sched_preemption=bool(ml.sched_preemption),
                sched_policy=str(ml.sched_policy),
                sched_max_wait_s=float(ml.sched_max_wait_s),
            )
        except ValueError as e:
            # sliding window (or a bad knob): static batcher territory
            self.log.info("continuous batching unavailable: %s", e)
            return None
        return cont

    def _shared_kv_pool(self, rt: StageRuntime, ml):
        """Get-or-create the shared page pool this job's engine draws from
        (MLConfig.cont_pool_pages > 0), keyed by page geometry so models
        that cannot share pages get separate pools."""
        from tensorlink_tpu_torch.engine.paged import SharedPagePool

        cfg = rt.cfg
        kvq = str(ml.kv_quant or "none")
        if rt.cache_quant and kvq == "none":
            kvq = "int8"  # mirror of the engine's cache_quant forcing
        page_size = int(ml.cont_page_size)
        dtype_str = (
            "int8" if kvq in ("int8", "int4") else str(rt.engine.cache_dtype)
        )
        key = (
            cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, page_size, kvq,
            dtype_str,
        )
        self._gc_kv_pools(keep=key)
        pool = self._kv_pools.get(key)
        if pool is None:
            pool = SharedPagePool(
                cfg, int(ml.cont_pool_pages), page_size=page_size,
                dtype=rt.engine.cache_dtype, kv_quant=kvq,
                device=self.device,
            )
            self._kv_pools[key] = pool
            self.log.info(
                "created shared KV page pool %s (%d pages, kv_quant=%s)",
                key, int(ml.cont_pool_pages), kvq,
            )
        return pool

    def _gc_kv_pools(self, keep=None) -> None:
        """Drop shared pools whose last tenant detached (their page tensors
        would otherwise pin device memory); ``keep`` spares the key about
        to be reused. Called from the serial run loop only."""
        for k in [
            k for k, p in self._kv_pools.items()
            if not p.tenants and k != keep
        ]:
            del self._kv_pools[k]
            self.log.info("released empty shared KV page pool %s", k)

    def _schedule_cont(self, rt: StageRuntime) -> None:
        if not rt.cont_scheduled:
            rt.cont_scheduled = True
            self.bridge.q.work.put(("cont_continue", {"job_id": rt.job_id}))

    def _cont_step(self, job_id: str) -> None:
        """Drive the slot engine one decode chunk, then requeue — FIFO, so
        every GENERATE that arrived meanwhile is admitted before the next
        chunk."""
        with self._lock:
            rt = self.jobs.get(job_id)
        if rt is None or rt.cont is None:
            return
        rt.cont_scheduled = False
        if self.faults is not None:
            # fault site "worker.cont_step": one count per decode chunk
            self.faults.inject("worker.cont_step", job_id)
        try:
            more = rt.cont.step_chunk()
        except FaultCrash:
            raise  # the run loop takes the node down
        except BaseException as e:  # noqa: BLE001 — fan out per request
            self.log.exception("continuous decode chunk failed")
            rt.cont.close(e)  # responds the error on every live rid
            rt.cont = None
            self._gc_kv_pools()  # release a now-tenantless shared pool
            return
        if more or rt.cont.has_work():
            self._schedule_cont(rt)


__all__ = ["DistributedWorker", "StageRuntime"]
