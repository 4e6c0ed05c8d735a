"""DistributedValidator — the ML side of a validator node (port of
``tensorlink_tpu/ml/validator.py``).

The validator hosts models for its HTTP API: resolve the model config
(an inline config, a preset, or a checkpoint's HF config.json),
``plan_sharding`` over the live worker capacities, recruit through the
network process (roles.py ``cmd_create_job``), attach a
:class:`DistributedModel` and wrap it in a batcher; ``generate_api`` then
serves each API request through it and writes the control journal. A
plan may split the model into pipeline stages over several workers; the
batcher then runs its pipelined slot session, and beam search and stop
detection ride the session-cached stage chain.

With ``MLConfig.fleet_replicas > 1`` a model is hosted as a fleet of
replicas behind a :class:`~tensorlink_tpu_torch.fleet.router.FleetRouter`
(``_grow_fleet``), with an optional
:class:`~tensorlink_tpu_torch.fleet.autopilot.FleetAutopilot` whose
actions ride the wire verbs (:class:`ValidatorFleetActions`: DRAIN, the
rolling deploy's rehost, the decode-pool push). A restarted validator
replays its control journal (``recover``): it re-attaches the journaled
replicas without rebuilding them, expires migration tickets a crash left
open at both endpoints, re-queues interrupted deploys, and serves
``{"reattach": jrid}`` requests from the workers' live slots or orphan
ledgers.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

from tensorlink_tpu_torch.core.logging import get_logger


@dataclass
class HostedJob:
    """A model the validator serves through the HTTP API (reference hosted
    jobs, ml/validator.py:901-1041)."""

    name: str
    status: str = "loading"  # loading | ready | failed
    model: Any = None  # DistributedModel
    tokenizer: Any = None  # TokenizerAdapter
    cfg: Any = None
    seq_len: int = 2048
    error: str = ""
    t0: float = field(default_factory=time.time)
    lock: threading.Lock = field(default_factory=threading.Lock)
    # dynamic request batching (ml/batching.py): concurrent API requests
    # coalesce into one batched decode instead of queueing on the lock
    batcher: Any = None
    # -- fleet serving (tensorlink_tpu_torch/fleet, docs/SERVING.md "Fleet
    # serving"): N replicas of this model behind a cache-/SLO-aware
    # router. ``replicas`` holds [{rid, model, batcher, job_id}];
    # ``model``/``batcher`` above stay replica 0 (the single-replica
    # path is byte-identical when the fleet knobs are off).
    replicas: list = field(default_factory=list)
    router: Any = None  # FleetRouter when > 1 replica hosted
    autopilot: Any = None  # FleetAutopilot when enabled


class DistributedValidator:
    def __init__(self, node):
        self.node = node
        self.bridge = node.bridge
        self.log = get_logger(f"ml.validator{node.config.duplicate}")
        # model demand tracking, persisted across restarts (reference
        # logs/models.json, ml/utils.py:663-674 + ml/validator.py:169-365)
        self._demand_path = Path(node.config.log_dir) / "models.json"
        self._demand_lock = threading.Lock()
        self._demand_written = 0.0
        self._demand_flush_s = 5.0  # debounce between disk writes
        self.demand: dict[str, int] = self._load_demand()
        self.hosted: dict[str, HostedJob] = {}
        self._host_lock = threading.Lock()
        # surfaced by /healthz for load balancers / the cluster router
        # (ROADMAP item 3): a draining validator keeps serving in-flight
        # work but should stop receiving new placements
        self.draining = False
        # control-plane crash safety (core/journal.py, docs/FAILURE_MODEL
        # "Control plane"): the write-ahead journal this validator records
        # hosting / admissions / tickets / autopilot intents into, and the
        # recovery-window flag /healthz + the API surface while recover()
        # replays it (api/server.py answers 503 + Retry-After meanwhile)
        self.recovering = False
        self._journal_errors = 0
        self.journal = None
        ml_cfg = node.config.ml
        if getattr(ml_cfg, "journal", True):
            try:
                from tensorlink_tpu_torch.core.journal import ControlJournal

                self.journal = ControlJournal(
                    Path(node.config.log_dir) / "control_journal.jsonl",
                    flush_every=int(
                        getattr(ml_cfg, "journal_flush_every", 16)
                    ),
                    flush_s=float(getattr(ml_cfg, "journal_flush_s", 0.05)),
                )
            except OSError as e:
                # no journal ≠ no serving: run as without one,
                # just without crash recovery — and say so loudly
                self.log.warning("control journal unavailable: %s", e)
        if node.config.ml.autoload_default_models:
            threading.Thread(
                target=self._autoload_defaults,
                name="ml-autoload",
                daemon=True,
            ).start()

    # -- demand persistence / default-model auto-load -------------------
    def _load_demand(self) -> dict[str, int]:
        try:
            data = json.loads(self._demand_path.read_text())
            if not isinstance(data, dict):
                return {}
            return {str(k): int(v) for k, v in data.items()}
        except Exception:  # stats must never block startup
            return {}

    def _bump_demand(self, name: str) -> None:
        with self._demand_lock:
            self.demand[name] = self.demand.get(name, 0) + 1
            now = time.monotonic()
            if now - self._demand_written < self._demand_flush_s:
                return  # debounce: no disk write per inference request
            self._demand_written = now
            snapshot = dict(self.demand)
        try:
            self._demand_path.parent.mkdir(parents=True, exist_ok=True)
            tmp = self._demand_path.with_suffix(".tmp")
            tmp.write_text(json.dumps(snapshot))
            tmp.replace(self._demand_path)
        except OSError as e:
            # stats persistence must never break planning — but say so
            self.log.debug("demand persistence failed: %s", e)

    def _autoload_defaults(self) -> None:
        """Host each configured default model so the API serves it without a
        first-request cold start (reference DEFAULT_MODELS auto-load)."""
        from tensorlink_tpu_torch.core.config import DEFAULT_CONFIG

        for name in DEFAULT_CONFIG.get("default_models", []):
            try:
                job = self.host_model(name)
                self.log.info(
                    "default model %s: %s", name, job.status
                )
            except Exception:
                self.log.exception("default model %s failed to host", name)

    # -- control-plane journal (crash safety) ----------------------------
    # every helper swallows journal failures: the journal is a durability
    # layer, and a full disk / injected journal.write fault must degrade
    # to "no crash recovery", never to a failed request
    def _journal_rec(self, kind: str, data: dict | None = None, *,
                     flush: bool = False):
        j = self.journal
        if j is None:
            return None
        try:
            return j.append(kind, data, flush=flush)
        except Exception as e:
            self._journal_errors += 1
            self.log.debug("journal write failed (%s): %s", kind, e)
            return None

    def _jintent(self, kind: str, data: dict | None = None):
        j = self.journal
        if j is None:
            return None
        try:
            return j.intent(kind, data)
        except Exception as e:
            self._journal_errors += 1
            self.log.debug("journal intent failed (%s): %s", kind, e)
            return None

    def _jcommit(self, iid, data: dict | None = None) -> None:
        if self.journal is None or iid is None:
            return
        try:
            self.journal.commit(iid, data)
        except Exception as e:
            self._journal_errors += 1
            self.log.debug("journal commit failed: %s", e)

    def _jabort(self, iid, data: dict | None = None) -> None:
        if self.journal is None or iid is None:
            return
        try:
            self.journal.abort(iid, data)
        except Exception as e:
            self._journal_errors += 1
            self.log.debug("journal abort failed: %s", e)

    def _journal_replica(self, job: HostedJob, rep: dict) -> None:
        self._journal_rec("replica_up", {
            "name": job.name, "rid": rep["rid"], "job_id": rep["job_id"],
            "attach": rep.get("attach") or {},
            "spec": rep.get("spec") or {},
            "batch": rep.get("batch", 1), "seed": rep.get("seed", 0),
            "seq_len": job.seq_len,
        }, flush=True)

    def _note_admit_seed(self, jrid: str, seed: int) -> None:
        """ContinuousBatcher.on_admit hook: pair the admission record with
        the decode seed the batcher assigned (write-ahead — called before
        dispatch), completing the journal's replayable admission tuple."""
        self._journal_rec("seed", {"jrid": jrid, "seed": int(seed)})

    def run(self) -> None:
        # a RESTARTED validator replays its journal before serving (a
        # fresh one no-ops in microseconds: empty journal, nothing live).
        # Failures degrade to a cold start — recovery must never wedge
        # the work loop.
        try:
            self.recover()
        except Exception:
            self.log.exception("startup recovery failed — cold start")
        while True:
            try:
                item = self.bridge.get_work(timeout=1.0)
            except EOFError:
                # the bridge ring closed under us — a crashed/stopped node;
                # exit the loop instead of dying with an unhandled thread
                # exception (the chaos suite kills validators mid-decode)
                self.log.info("work bridge closed — validator loop exiting")
                return
            if item is None:
                continue
            kind, payload = item
            if kind == "_stop":
                return
            try:
                if kind == "job_req":
                    self._plan_job(payload)
                elif kind == "token":
                    pass  # API streaming relay lands here in the serving layer
                else:
                    self.log.warning("unhandled work kind %s", kind)
            except Exception:
                self.log.exception("work %s failed", kind)
                if kind == "job_req":
                    self.bridge.request(
                        "decline_job",
                        {"req_id": payload.get("req_id"), "error": "planning failed"},
                    )

    # -- planning -------------------------------------------------------
    def _resolve_config(self, model_spec: dict):
        """Model identity → ModelConfig. Accepts an explicit config dict, a
        preset name (registry), or a checkpoint dir with an HF config.json
        (reference resolves HF names via AutoConfig, ml/validator.py:367)."""
        from tensorlink_tpu_torch.models.base import ModelConfig
        from tensorlink_tpu_torch.models.registry import config_presets

        if model_spec.get("config"):
            return ModelConfig.from_json(model_spec["config"])
        name = model_spec.get("name", "")
        presets = config_presets()
        if name in presets:
            return presets[name]
        if model_spec.get("ckpt"):
            import json

            from tensorlink_tpu_torch.engine.loader import resolve_checkpoint
            from tensorlink_tpu_torch.models.registry import config_from_hf

            ckpt = resolve_checkpoint(model_spec["ckpt"], config_only=True)
            return config_from_hf(
                json.loads((ckpt / "config.json").read_text())
            )
        raise ValueError(f"cannot resolve model {name!r}")

    def _plan_and_create(
        self,
        model_spec: dict,
        cfg,
        *,
        batch: int = 1,
        seq_len: int = 2048,
        training: bool = False,
        n_micro=None,
        mesh_hints: dict | None = None,
        req_id: str | None = None,
        user_id: str | None = None,
    ) -> dict:
        """Shared plan→recruit path for user jobs and hosted models: live
        worker capacities → plan_sharding → create_job on the net process.
        Returns the create_job result. Raises AssignmentError on no fit."""
        from tensorlink_tpu_torch.parallel.planner import (
            AssignmentError,
            WorkerCapacity,
            plan_sharding,
        )

        name = model_spec.get("name", "")
        stats = self.bridge.request("stats_workers", timeout=15.0)
        # -- disaggregated prefill/decode placement (docs/SERVING.md) ----
        # Workers advertise a serving_role with every stats sweep. When a
        # SERVING job is planned against a pool that contains decode-role
        # workers, those are reserved as handoff destinations: the job's
        # stages (= the admission point new requests hit) land on
        # prefill/mixed workers, and each prefill-role worker the plan
        # touches gets the decode-pool membership pushed at recruit time
        # (roles.py cmd_create_job → HANDOFF frames) so it can ship every
        # completed prefill there. Training jobs, pools with no decode
        # workers, and models that can never hand off (the paged slot
        # engine refuses them, or continuous batching is off — either way
        # they serve through the windowed batcher, which has no
        # prefill→decode boundary) place exactly as before: reserving
        # decode workers for them would only shrink the plannable pool.
        from tensorlink_tpu_torch.engine.continuous import paged_unsupported

        roles = {
            s.get("id"): str(s.get("serving_role") or "mixed")
            for s in stats
        }
        # explicit tensor parallelism (docs/SHARDING.md): each worker's
        # advertised serving shard degree. A tp=N worker is ONE placement
        # unit over N chips (its continuous engine runs a single sharded
        # program), so the plan carries the degree through to consumers
        # (router placement, /healthz) rather than splitting the mesh. A
        # worker advertising more tp than devices would refuse TP at
        # hosting time and serve static — surface that misfit here, at
        # plan time, where the operator is looking.
        tp_degrees = {
            s.get("id"): int(s.get("tensor_parallel", 1) or 1)
            for s in stats
        }
        for s in stats:
            tp_adv = tp_degrees.get(s.get("id"), 1)
            if tp_adv > 1 and tp_adv > int(s.get("n_devices", 1)):
                self.log.warning(
                    "worker %s advertises tensor_parallel=%d but only %d "
                    "device(s) — its engines will fall back to static "
                    "batching", s.get("id"), tp_adv,
                    int(s.get("n_devices", 1)),
                )
        decode_pool = [
            {"id": s["id"], "addr": list(s["addr"])}
            for s in stats
            if roles.get(s.get("id")) == "decode" and s.get("addr")
        ]
        if decode_pool and not (
            self.node.config.ml.continuous_batching
            and paged_unsupported(cfg) is None
        ):
            decode_pool = []
        placement = stats
        if not training and decode_pool:
            non_decode = [
                s for s in stats if roles.get(s.get("id")) != "decode"
            ]
            if non_decode:
                placement = non_decode
            else:
                # every worker is decode-role: nothing to disaggregate
                # against — serve single-pool rather than fail planning
                decode_pool = []
        def _plan(pool):
            workers = [
                WorkerCapacity(
                    node_id=s["id"],
                    hbm_bytes=float(
                        s.get("free_bytes", s.get("hbm_bytes", 0.0))
                    ),
                    n_devices=int(s.get("n_devices", 1)),
                    slice_id=str(s.get("slice_id", "") or ""),
                )
                for s in pool
            ]
            return plan_sharding(
                cfg, workers, model_name=name, batch=batch,
                seq_len=seq_len, training=training, n_micro=n_micro,
                mesh_hints=mesh_hints,
                merge_co_slice=self.node.config.ml.co_slice_planning,
            )

        try:
            plan = _plan(placement)
        except AssignmentError:
            if placement is stats:
                raise
            # the prefill/mixed subset alone can't fit the model (the
            # reserved decode workers hold the missing capacity): a
            # single-pool placement over the FULL pool beats a failed
            # host — disaggregation is a latency optimization, not worth
            # declining a job the cluster can serve
            self.log.warning(
                "disaggregated placement for %s does not fit the "
                "prefill/mixed subset; falling back to single-pool "
                "placement over all %d workers", name, len(stats),
            )
            decode_pool = []
            plan = _plan(stats)
        total_layers = max(cfg.n_layers, 1)
        job = {
            "job_id": uuid.uuid4().hex,
            "model": model_spec,
            "plan": plan.to_json(),
            "stage_bytes": {
                s.worker_id: plan.estimate.total
                * (s.layer_hi - s.layer_lo) / total_layers
                for s in plan.stages
            },
        }
        if not training and decode_pool:
            handoff_push = {
                s.worker_id: decode_pool
                for s in plan.stages
                if roles.get(s.worker_id) == "prefill"
            }
            if handoff_push:
                job["handoff_push"] = handoff_push
                self.log.info(
                    "disaggregated placement for %s: %d prefill worker(s) "
                    "→ %d decode worker(s)",
                    name, len(handoff_push), len(decode_pool),
                )
        result = self.bridge.request(
            "create_job",
            {"req_id": req_id, "user_id": user_id, "job": job},
            timeout=30.0,
        )
        # the planned workers' advertised pool roles, for consumers that
        # must know the shape BEFORE any traffic produces a serving
        # snapshot (/healthz serving_modes on a fresh replica)
        result["serving_roles"] = {
            s.worker_id: roles.get(s.worker_id, "mixed")
            for s in plan.stages
        }
        # ...and their serving shard degrees, same reasoning: a router
        # scoring this replica needs to know a tp=N worker is one engine
        # over N chips before the first serving snapshot exists
        result["tensor_parallel"] = {
            s.worker_id: tp_degrees.get(s.worker_id, 1)
            for s in plan.stages
        }
        self.log.info(
            "job %s (%s): accepted=%s stages=%d",
            job["job_id"][:8], name, result.get("accepted"), plan.n_stages,
        )
        return result

    def _plan_job(self, p: dict) -> None:
        """A user's job request (UserNode / DistributedModel), serving or
        training: resolve the model's config, plan it and create the job,
        or decline with the reason. A plan, serving or training, may split
        the model into pipeline stages over several workers."""
        from tensorlink_tpu_torch.parallel.planner import AssignmentError

        spec = p["spec"]
        model_spec = dict(spec.get("model", {}))
        name = model_spec.get("name", "")
        self._bump_demand(name)
        try:
            cfg = self._resolve_config(model_spec)
        except Exception as e:
            self.bridge.request(
                "decline_job", {"req_id": p["req_id"], "error": str(e)}
            )
            return
        model_spec["config"] = cfg.to_json()
        try:
            self._plan_and_create(
                model_spec, cfg,
                batch=int(spec.get("batch", 1)),
                seq_len=int(spec.get("seq_len", 2048)),
                training=bool(spec.get("training", False)),
                n_micro=spec.get("n_micro"),
                mesh_hints=spec.get("parallelism"),
                req_id=p["req_id"],
                user_id=p.get("user_id"),
            )
        except AssignmentError as e:
            self.log.info("declining job %s: %s", name, e)
            self.bridge.request(
                "decline_job", {"req_id": p["req_id"], "error": str(e)}
            )

    # ------------------------------------------------------------------
    # hosted models (reference _initialize_hosted_job → DistributedModel,
    # ml/validator.py:901-1041) — the validator is its own "user"
    # ------------------------------------------------------------------
    def host_model(
        self,
        name: str,
        *,
        batch: int = 1,
        seq_len: int | None = None,
        config: dict | None = None,
        seed: int = 0,
        quant: str | None = None,
    ) -> HostedJob:
        """Plan, recruit, and attach a model for API serving. Synchronous and
        thread-safe; callable from API handler threads. ``quant`` ("int8" /
        "int8+kv") serves the model weight-only-quantized on the paged
        engine — weights and KV shrink together (docs/SERVING.md
        "Quantized KV")."""
        with self._host_lock:
            job = self.hosted.get(name)
            if job is not None and job.status in ("loading", "ready"):
                return job
            job = HostedJob(name=name)
            self.hosted[name] = job
        try:
            self._do_host(
                job, batch=batch, seq_len=seq_len, config=config, seed=seed,
                quant=quant,
            )
        except Exception as e:
            job.status = "failed"
            job.error = f"{type(e).__name__}: {e}"
            self.log.exception("hosting %s failed", name)
        return job

    def _build_replica(
        self, job: HostedJob, model_spec: dict, cfg, *, batch, seed,
    ) -> tuple:
        """Plan, recruit, attach, and wrap ONE serving replica of
        ``job``'s model: (model, batcher, job_id, attach) — ``attach`` is
        the JSON-safe job result a recovered validator replays to
        re-attach this replica without rebuilding it
        (DistributedModel.from_job(..., attach_only=True)). Raises on
        failure after releasing whatever recruiting reserved."""
        from tensorlink_tpu_torch.ml.module import DistributedModel

        result = self._plan_and_create(
            model_spec, cfg, batch=batch, seq_len=job.seq_len, training=False,
        )
        if not result.get("accepted"):
            raise RuntimeError(f"recruiting failed: {result.get('declined')}")
        try:
            model = DistributedModel.from_job(
                self.node, result, seq_len=job.seq_len, seed=seed,
            )
        except Exception:
            # release what recruiting reserved — workers that accepted would
            # otherwise keep the reservation forever (same leak the recruit
            # decline path guards against, roles.py cmd_create_job)
            try:
                self.bridge.request(
                    "shutdown_job", {"job_id": result["job_id"]}, timeout=15.0
                )
            except Exception:
                self.log.warning("rollback of job %s failed", result["job_id"][:8])
            raise
        batcher = self._make_batcher(
            job, model, cfg, result.get("serving_roles") or {},
        )
        self.log.info(
            "replica of %s ready (%d stages, job %s)",
            job.name, len(result["plan"]["stages"]), result["job_id"][:8],
        )
        attach = {
            k: result[k]
            for k in ("job_id", "plan", "model", "workers", "serving_roles")
            if k in result
        }
        return model, batcher, result["job_id"], attach

    def _make_batcher(self, job: HostedJob, model, cfg, serving_roles: dict):
        """ONE construction site for a replica's batcher — first host and
        crash-recovery re-attach must pick the same kind with the same
        knobs or replayed replicas would silently change behavior."""
        from tensorlink_tpu_torch.ml.batching import ContinuousBatcher, GenBatcher

        ml_cfg = self.node.config.ml
        merged = any(s.coworkers for s in model.plan.stages)
        # models the paged slot engine refuses must get the WINDOWED
        # batcher here — routing them continuous would degrade each
        # request to a serialized solo generate on the worker's fallback.
        # The predicate lives with the engine (paged_unsupported) so this
        # routing can never drift from what the engine actually accepts:
        # int8-KV models ("int8+kv") serve CONTINUOUS now — the paged
        # cache stores int8 pages natively (kv_quant, docs/SERVING.md)
        from tensorlink_tpu_torch.engine.continuous import paged_unsupported

        unpageable = paged_unsupported(cfg) is not None
        # the ENTRY worker's advertised pool role (disaggregated serving):
        # what /healthz serving_modes reports until live snapshots arrive
        entry_role = "mixed"
        if getattr(model, "plan", None) is not None:
            entry_role = str(
                (serving_roles or {}).get(
                    model.plan.stages[0].worker_id
                ) or "mixed"
            )
        if ml_cfg.continuous_batching and not merged and not unpageable:
            # continuous batching (docs/SERVING.md): no arrival window, no
            # drain barrier — requests join the model's running slot batch
            # at decode-chunk boundaries.
            batcher = ContinuousBatcher(
                model, job.tokenizer.eos_ids,
                worker_role=entry_role,
                max_slots=min(ml_cfg.cont_max_slots, ml_cfg.max_serve_batch),
                chunk_steps=ml_cfg.cont_chunk_steps,
                kv_quant=ml_cfg.kv_quant,
                host_tier_pages=int(
                    getattr(ml_cfg, "cont_host_tier_pages", 0)
                ),
                spec_decode=bool(getattr(ml_cfg, "spec_decode", False)),
                spec_draft=int(getattr(ml_cfg, "spec_draft", 8)),
                spec_budget=int(getattr(ml_cfg, "spec_budget", 0)),
                default_priority=ml_cfg.default_priority,
                sched_queue_cap=ml_cfg.sched_queue_cap,
                sched_aging_ticks=ml_cfg.sched_aging_ticks,
                sched_preemption=ml_cfg.sched_preemption,
                sched_policy=ml_cfg.sched_policy,
                sched_max_wait_s=ml_cfg.sched_max_wait_s,
            )
        else:
            batcher = GenBatcher(
                model, job.tokenizer.eos_ids,
                # a batch never exceeds what the engine's buckets compile for
                max_batch=min(ml_cfg.max_serve_batch, ml_cfg.batch_buckets[-1]),
            )
        if hasattr(batcher, "on_admit"):
            # write-ahead seed journaling: the batcher tells the journal
            # each jrid-tagged admission's decode seed before dispatch
            batcher.on_admit = self._note_admit_seed
        return batcher

    def _do_host(
        self, job: HostedJob, *, batch, seq_len, config, seed, quant=None
    ) -> None:
        from tensorlink_tpu_torch.api.tokenizer import load_tokenizer

        name = job.name
        model_spec: dict = {"name": name, "seed": seed}
        if config:
            model_spec["config"] = config
        if quant:
            # weight-only-quantized serving rides the job spec to the
            # worker (ml/worker.py::load_stage quantizes the stage params;
            # the paged engine dequantizes through quant.matmul on the fly)
            if quant not in ("int8", "int8+kv"):
                raise ValueError(f"unknown quant mode {quant!r}")
            model_spec["quant"] = quant
        if "/" in name or name.startswith("."):
            model_spec.setdefault("ckpt", name)
        cfg = self._resolve_config(model_spec)
        model_spec["config"] = cfg.to_json()
        job.cfg = cfg
        job.seq_len = min(seq_len or cfg.max_seq_len, cfg.max_seq_len)
        job.tokenizer = load_tokenizer(model_spec)

        # write-ahead: the host intent (with everything needed to rebuild
        # the job shell at recovery) is durable before recruiting starts
        iid = self._jintent("host", {
            "name": name, "spec": dict(model_spec), "batch": batch,
            "seed": seed, "seq_len": job.seq_len,
        })
        try:
            job.model, job.batcher, jid, attach = self._build_replica(
                job, model_spec, cfg, batch=batch, seed=seed,
            )
            job.replicas = [{
                "rid": "r0", "model": job.model, "batcher": job.batcher,
                "job_id": jid, "spec": dict(model_spec), "batch": batch,
                "seed": seed, "attach": attach,
            }]
            self._journal_replica(job, job.replicas[0])
            ml_cfg = self.node.config.ml
            n_replicas = max(int(getattr(ml_cfg, "fleet_replicas", 1)), 1)
            if n_replicas > 1:
                self._grow_fleet(job, model_spec, cfg, n_replicas,
                                 batch=batch, seed=seed)
        except Exception as e:
            self._jabort(iid, {"error": f"{type(e).__name__}: {e}"[:200]})
            raise
        job.status = "ready"
        self._jcommit(iid, {"replicas": len(job.replicas)})
        self.log.info(
            "hosting %s ready (%d replica(s))", name, len(job.replicas)
        )

    def _grow_fleet(
        self, job: HostedJob, model_spec: dict, cfg, n_replicas: int,
        *, batch, seed,
    ) -> None:
        """Host replicas 1..N-1 behind a FleetRouter (docs/SERVING.md
        "Fleet serving"). A replica that fails to plan/recruit degrades
        the fleet instead of failing the host — a model served by fewer
        replicas beats a model not served at all."""
        from tensorlink_tpu_torch.fleet.router import FleetRouter

        ml_cfg = self.node.config.ml
        router = FleetRouter(
            refresh_s=float(getattr(ml_cfg, "fleet_refresh_s", 0.5)),
        )
        router.register("r0", job.batcher)
        for i in range(1, n_replicas):
            try:
                model, batcher, jid, attach = self._build_replica(
                    job, model_spec, cfg, batch=batch, seed=seed,
                )
            except Exception as e:
                self.log.warning(
                    "fleet replica %d of %s failed to host (%s: %s) — "
                    "serving with %d replica(s)",
                    i, job.name, type(e).__name__, e, len(job.replicas),
                )
                break
            job.replicas.append({
                "rid": f"r{i}", "model": model, "batcher": batcher,
                "job_id": jid, "spec": dict(model_spec), "batch": batch,
                "seed": seed, "attach": attach,
            })
            self._journal_replica(job, job.replicas[-1])
            router.register(f"r{i}", batcher)
        if len(job.replicas) < 2:
            return  # no fleet materialized: the single-replica path stands
        job.router = router
        self._push_replica_sets(job)
        if bool(getattr(ml_cfg, "fleet_autopilot", False)):
            self._start_autopilot(job)

    def _start_autopilot(self, job: HostedJob) -> None:
        """ONE construction site for a fleet's control loop — host-time
        (fleet_autopilot=True) and the on-demand /fleet/deploy path must
        build it identically or silently drift."""
        from tensorlink_tpu_torch.fleet.autopilot import FleetAutopilot

        ml_cfg = self.node.config.ml
        job.autopilot = FleetAutopilot(
            job.router,
            ValidatorFleetActions(self, job),
            interval_s=float(
                getattr(ml_cfg, "fleet_autopilot_interval_s", 2.0)
            ),
            on_action=self._journal_action(job.name),
        ).start()

    def _journal_action(self, name: str):
        """The autopilot's on_action hook bound to one hosted model:
        intent/commit/abort pairs land in the control journal so a crash
        mid-deploy is resumed (open "action" intents at replay → re-queued
        via request_deploy) or rolled back — never forgotten."""

        def hook(phase: str, kind: str, rid: str, token=None):
            if phase == "intent":
                return self._jintent(
                    "action", {"verb": kind, "rid": rid, "name": name},
                )
            if token is None:
                return None
            if phase == "commit":
                self._jcommit(token)
            else:
                self._jabort(token)
            return token

        return hook

    # ------------------------------------------------------------------
    # crash recovery (docs/FAILURE_MODEL.md "Control
    # plane"): a restarted validator replays its journal, re-handshakes
    # the workers that kept serving through the crash, and reconciles the
    # journal's view of in-flight streams against theirs
    # ------------------------------------------------------------------
    def recover(self) -> dict:
        """Replay the control journal and re-attach to whatever the fleet
        kept alive across this validator's crash/restart.

        - hosted jobs with journaled replicas re-attach WITHOUT rebuilding
          (``DistributedModel.from_job(..., attach_only=True)`` — a
          rebuild would kill the live slots the workers preserved);
        - open migration tickets (drains the crash interrupted) are
          expired deterministically at both endpoints — staged pages drop,
          page conservation re-checked;
        - open autopilot action intents resolve: deploys re-queue,
          everything else aborts (the control loop re-decides from live
          state);
        - in-flight admissions reconcile against the worker-reported
          live/orphan streams — journal wins for PLACEMENT, worker wins
          for TOKENS.

        ``self.recovering`` is True for the duration; /healthz surfaces it
        and the API answers 503 + Retry-After meanwhile. Safe to call on a
        fresh validator (empty journal → fast no-op)."""
        from tensorlink_tpu_torch.core.journal import ControlJournal

        if self.journal is None:
            return {"recovered": False, "reason": "journal disabled"}
        self.journal.flush()
        st = ControlJournal.replay(self.journal.path)
        live = {
            name: jrec for name, jrec in st.live_jobs().items()
            if name not in self.hosted
        }
        open_migs = st.open_intents("mig")
        open_actions = st.open_intents("action")
        if not live and not open_migs and not open_actions:
            return {
                "recovered": False, "reason": "nothing to recover",
                "torn": st.torn,
            }
        self.recovering = True
        info: dict = {
            "recovered": True, "torn": st.torn, "jobs": {},
            "streams": [], "expired_migrations": 0, "requeued_deploys": 0,
        }
        t0 = time.monotonic()
        try:
            for name, jrec in live.items():
                try:
                    job = self._recover_job(name, jrec, st, info)
                    info["jobs"][name] = {
                        "status": job.status, "replicas": len(job.replicas),
                    }
                except Exception as e:
                    self.log.exception("recovery of %s failed", name)
                    info["jobs"][name] = {
                        "status": "failed",
                        "error": f"{type(e).__name__}: {e}"[:200],
                    }
            self._expire_open_migrations(open_migs, info)
            self._resume_open_actions(open_actions, info)
            self._journal_rec("recovered", {
                "jobs": {
                    n: str(j.get("status", "")) for n, j in info["jobs"].items()
                },
                "streams": len(info["streams"]),
                "expired_migrations": info["expired_migrations"],
                "t_s": round(time.monotonic() - t0, 3),
            }, flush=True)
        finally:
            self.recovering = False
        self.log.info(
            "control-plane recovery: %d job(s), %d in-flight stream(s) "
            "reconciled, %d staged ticket(s) expired, %d deploy(s) "
            "re-queued, %d torn record(s) skipped (%.2fs)",
            len(info["jobs"]), len(info["streams"]),
            info["expired_migrations"], info["requeued_deploys"], st.torn,
            time.monotonic() - t0,
        )
        return info

    def _recover_job(self, name: str, jrec: dict, st, info: dict) -> HostedJob:
        """Rebuild one hosted job's shell from its journal record and
        re-attach every journaled replica. A replica that fails to
        re-attach (its worker died too) degrades the job instead of
        failing the recovery — same posture as ``_grow_fleet``."""
        from tensorlink_tpu_torch.api.tokenizer import load_tokenizer
        from tensorlink_tpu_torch.fleet.router import FleetRouter

        reps = jrec["replicas"]  # rid -> replica_up record
        any_rep = next(iter(reps.values()))
        spec = dict(
            (jrec["data"] or {}).get("spec") or any_rep.get("spec") or {}
        )
        if not spec:
            raise RuntimeError("journal carries no model spec to rebuild from")
        cfg = self._resolve_config(spec)
        seq_len = int(
            (jrec["data"] or {}).get("seq_len")
            or any_rep.get("seq_len") or cfg.max_seq_len
        )
        job = HostedJob(name=name)
        job.cfg = cfg
        job.seq_len = min(seq_len, cfg.max_seq_len)
        job.tokenizer = load_tokenizer(spec)
        with self._host_lock:
            cur = self.hosted.get(name)
            if cur is not None and cur.status in ("loading", "ready"):
                return cur  # hosted since the replay snapshot — keep it
            self.hosted[name] = job
        recovered: list[dict] = []
        for rid in sorted(reps, key=lambda r: (r != "r0", r)):
            try:
                recovered.append(
                    self._reattach_replica(job, rid, reps[rid])
                )
            except Exception as e:
                self.log.warning(
                    "replica %s of %s did not re-attach (%s: %s) — "
                    "recovering without it", rid, name, type(e).__name__, e,
                )
                self._journal_rec(
                    "replica_down", {"name": name, "rid": rid}, flush=True,
                )
        if not recovered:
            job.status = "failed"
            job.error = "no replica re-attached"
            raise RuntimeError(job.error)
        job.replicas = recovered
        job.model = recovered[0]["model"]
        job.batcher = recovered[0]["batcher"]
        self._reconcile_streams(job, recovered, st, info)
        if len(recovered) > 1:
            ml_cfg = self.node.config.ml
            router = FleetRouter(
                refresh_s=float(getattr(ml_cfg, "fleet_refresh_s", 0.5)),
            )
            for rep in recovered:
                router.register(rep["rid"], rep["batcher"])
            # journaled admission placements seed the routed counters so
            # routing telemetry survives the restart (fleet/router.py)
            router.seed_state({"routed": st.routed_counts()})
            job.router = router
            self._push_replica_sets(job)
            if bool(getattr(ml_cfg, "fleet_autopilot", False)):
                self._start_autopilot(job)
        job.status = "ready"
        return job

    def _reattach_replica(self, job: HostedJob, rid: str, rdata: dict) -> dict:
        """attach_only re-handshake of one journaled replica: the workers
        ACK their already-live stage (no rebuild — a rebuild would kill
        the slots that survived us) and re-announce live/orphan streams
        into ``model.attach_report``."""
        from tensorlink_tpu_torch.ml.module import DistributedModel

        attach = dict(rdata.get("attach") or {})
        if not attach.get("plan"):
            raise RuntimeError("replica_up record carries no attach payload")
        model = DistributedModel.from_job(
            self.node, attach, seq_len=job.seq_len,
            seed=int(rdata.get("seed", 0) or 0), attach_only=True,
        )
        batcher = self._make_batcher(
            job, model, job.cfg, attach.get("serving_roles") or {},
        )
        return {
            "rid": rid, "model": model, "batcher": batcher,
            "job_id": attach.get("job_id") or rdata.get("job_id", ""),
            "spec": dict(rdata.get("spec") or {}),
            "batch": int(rdata.get("batch", 1) or 1),
            "seed": int(rdata.get("seed", 0) or 0),
            "attach": attach,
        }

    def _reconcile_streams(
        self, job: HostedJob, recovered: list, st, info: dict,
    ) -> None:
        """Merge the journal's in-flight admissions with the
        worker-reported live/orphaned streams from the attach_only acks.
        Contract (core/journal.py): the journal is authoritative for
        PLACEMENT, the worker for TOKENS — its count can only be >= the
        journaled high-water mark, so the mark is raised, never cut."""
        worker_view: dict[str, dict] = {}
        for rep in recovered:
            report = getattr(rep["model"], "attach_report", None) or {}
            for wid, ack in report.items():
                for o in ack.get("orphans", []) or []:
                    jrid = str(o.get("jrid", ""))
                    if jrid:
                        worker_view[jrid] = {
                            "rid": rep["rid"], "worker": wid,
                            "n": int(o.get("n", 0) or 0),
                            "finished": bool(o.get("finished")),
                        }
        for jrid, adm in st.orphan_admissions():
            if str(adm["data"].get("model", "")) != job.name:
                continue
            wv = worker_view.get(jrid)
            if wv is not None and wv["n"] > int(adm["hwm"]):
                # worker wins for tokens: raise the journaled mark to what
                # actually decoded while the control plane was down
                self._journal_rec("hwm", {"jrid": jrid, "n": int(wv["n"])})
            info["streams"].append({
                "jrid": jrid,
                "journal_hwm": int(adm["hwm"]),
                "worker_n": int(wv["n"]) if wv else None,
                "live": bool(wv and not wv["finished"]),
                # a stream the worker no longer holds is NOT resumable
                # from the buffer — the client's re-attach falls through
                # to a plain re-prefill resume (exactly-once regardless)
                "resumable": wv is not None,
            })

    def _expire_open_migrations(self, open_migs: list, info: dict) -> None:
        """Satellite fix: a drain in flight when the validator died may
        have left page-carrying migration tickets STAGED (exported, never
        committed). Expire them deterministically at replay — both
        endpoints drop staged pages and re-check page conservation — then
        abort the journal intent so the next replay sees it closed."""
        for iid, ent in open_migs:
            data = ent.get("data") or {}
            wids = {
                str(data.get("src") or ""), str(data.get("dest") or ""),
            } - {""}
            # dial the ticket's journaled endpoint addresses first: the
            # drain DESTINATION is usually outside the re-attached plan,
            # so this restarted validator holds no connection to it and
            # the per-wid expiry below would fail as "unknown worker"
            for addr_key in ("src_addr", "dest_addr"):
                addr = data.get(addr_key) or []
                if len(addr) == 2:
                    try:
                        self.bridge.request(
                            "connect",
                            {"host": str(addr[0]), "port": int(addr[1])},
                            timeout=10.0,
                        )
                    except Exception as e:
                        self.log.debug(
                            "dial of %s for ticket expiry failed: %s",
                            addr, e,
                        )
            if not data.get("dest"):
                # dest-less drain: the net layer chose the destination and
                # the choice died with it — sweep every worker (expire is
                # a no-op where nothing is staged)
                try:
                    stats = self.bridge.request("stats_workers", timeout=15.0)
                    wids |= {
                        str(s.get("id")) for s in stats if s.get("id")
                    }
                except Exception as e:
                    self.log.warning("worker sweep for expiry failed: %s", e)
            expired = 0
            for wid in sorted(wids):
                try:
                    r = self.bridge.request(
                        "expire_migrations",
                        {"worker": wid, "job_id": data.get("job_id", "")},
                        timeout=30.0,
                    )
                    if isinstance(r, dict):
                        expired += int(r.get("expired", 0) or 0)
                except Exception as e:
                    self.log.warning(
                        "migration-ticket expiry on %s failed: %s",
                        wid[:8], e,
                    )
            info["expired_migrations"] += expired
            self._jabort(iid, {"recovery": "expired", "expired": expired})

    def _resume_open_actions(self, open_actions: list, info: dict) -> None:
        """Open autopilot intents — the crash interrupted a control
        action. Deploys re-queue (rehost converges; repeating one is
        idempotent), everything else aborts and the control loop
        re-decides from live state."""
        for iid, ent in open_actions:
            data = ent.get("data") or {}
            verb = str(data.get("verb", ""))
            job = self.hosted.get(str(data.get("name", "")))
            requeued = False
            if verb == "deploy" and job is not None and job.autopilot is not None:
                rid = str(data.get("rid", ""))
                try:
                    job.autopilot.request_deploy([rid] if rid else None)
                    info["requeued_deploys"] += 1
                    requeued = True
                except Exception:
                    self.log.exception(
                        "deploy re-queue for %s failed", data.get("name"),
                    )
            self._jabort(
                iid, {"recovery": "requeued" if requeued else "dropped"},
            )

    def _replica_entry_worker(self, rep: dict) -> str:
        model = rep.get("model")
        plan = getattr(model, "plan", None)
        if plan is None or not plan.stages:
            return ""
        return str(plan.stages[0].worker_id)

    def _push_replica_sets(self, job: HostedJob) -> None:
        """Mirror of the HANDOFF push at fleet granularity: tell
        each replica's entry worker who its sibling replicas are
        (REPLICA_SET frames), so a destination-less DRAIN — the
        autopilot's rolling deploy — lands on a sibling that already
        serves the same model. Best-effort: an unreached worker just
        keeps the validator-chosen drain destination."""
        entries = [
            (rep, self._replica_entry_worker(rep)) for rep in job.replicas
        ]
        for rep, wid in entries:
            if not wid:
                continue
            peers = [
                {"id": w2, "job_id": r2["job_id"]}
                for r2, w2 in entries
                if r2 is not rep and w2
            ]
            if not peers:
                continue
            try:
                self.bridge.request(
                    "set_replica_set",
                    {"worker": wid, "job_id": rep["job_id"], "peers": peers},
                    timeout=10.0,
                )
            except Exception as e:
                self.log.warning(
                    "replica-set push to %s failed: %s", wid[:8], e
                )

    def unhost_model(self, name: str) -> bool:
        """Drop a hosted model and release its workers (reference
        _remove_hosted_job, ml/validator.py:1043)."""
        with self._host_lock:
            job = self.hosted.pop(name, None)
        if job is None:
            return False
        self._journal_rec("unhost", {"name": name}, flush=True)
        if job.autopilot is not None:
            job.autopilot.stop()  # no control actions during teardown
        # fleet replicas beyond r0 (r0 IS job.model/job.batcher below)
        for rep in job.replicas[1:]:
            if job.router is not None:
                job.router.deregister(rep["rid"])
            try:
                rep["batcher"].close()
            except Exception:
                self.log.exception(
                    "replica %s of %s batcher close failed", rep["rid"],
                    name,
                )
            try:
                # shutdown ALWAYS runs — a wedged batcher close must not
                # leave this replica's recruited workers reserved forever
                rep["model"].shutdown()
            except Exception:
                self.log.exception(
                    "replica %s of %s failed to unhost", rep["rid"], name
                )
        if job.batcher is not None:
            job.batcher.close()  # drain the dispatcher first
        if job.model is not None:
            with job.lock:  # let an in-flight generation finish first
                job.model.shutdown()
        return True

    def health_snapshot(self) -> dict:
        """The ``GET /healthz`` body: status, hosted model names, drain
        flag. Deliberately CHEAP — dict reads under the host lock, no
        batcher stats, no ML-process round trip — so load balancers and
        the cluster router (ROADMAP item 3) can probe at high frequency
        without touching the serving path."""
        with self._host_lock:
            jobs = {
                name: (j.batcher, list(j.replicas))
                for name, j in self.hosted.items()
            }
        modes = {}
        headroom: dict = {}
        for name, (batcher, replicas) in jobs.items():
            get_modes = getattr(batcher, "serving_modes", None)
            if callable(get_modes):
                modes[name] = get_modes()
            else:
                # windowed batcher (or no batcher yet): vanilla decode
                modes[name] = {
                    "kv_quant": "none", "weight_quant": "none",
                    "spec_decode": False, "host_tier": False,
                    "worker_role": "mixed", "weights_version": 1,
                }
            # per-replica headroom (kv_pages_free, slots_free, per-class
            # queue depth): enough for an EXTERNAL load balancer to
            # route without scraping /metrics — same cheap contract
            reps = replicas or (
                [{"rid": "r0", "batcher": batcher}] if batcher is not None
                else []
            )
            hr = {}
            for rep in reps:
                get_hr = getattr(rep.get("batcher"), "headroom", None)
                if not callable(get_hr):
                    continue
                try:
                    hr[rep["rid"]] = get_hr()
                except Exception:
                    # one dead replica must not 500 the whole node's
                    # probe — report it unroutable, keep the siblings
                    hr[rep["rid"]] = {
                        "slots_free": 0, "kv_pages_free": 0,
                        "queue_depth": {}, "draining": True,
                        "dead": True,
                    }
            if hr:
                headroom[name] = hr
        return {
            "status": "ok",
            "hosted_models": list(jobs),
            # per-model throughput modes (kv_quant, spec_decode): which
            # decode shape a replica actually runs — a router must see
            # this before placing traffic (cheap attribute reads, the
            # same no-ML-round-trip contract as the rest of the body)
            "serving_modes": modes,
            # per-model, per-replica headroom (docs/SERVING.md "Fleet
            # serving" — the external-LB routing fields)
            "headroom": headroom,
            "draining": bool(self.draining),
            # recovery window (control-plane crash safety): True while
            # recover() is replaying the journal — the API answers new
            # generations 503 + Retry-After until it drops
            "recovering": bool(self.recovering),
        }

    def metrics_groups(self) -> list[tuple[dict, Any]]:
        """(labels, registry) pairs for the /metrics exposition: each
        hosted model's engine registry when it lives in-process (local
        continuous batching), or its last remote serving snapshot
        flattened into gauges (the dict riding every GENERATE_RESP)."""
        from tensorlink_tpu_torch.core.metrics import (
            MetricsRegistry,
            snapshot_gauges,
        )

        groups: list[tuple[dict, Any]] = []
        with self._host_lock:
            jobs = list(self.hosted.values())
        for j in jobs:
            # one label group per replica (single-replica models keep
            # the unlabeled-model shape — byte-compatible with pre-fleet
            # scrapes); the router/autopilot registries render under the
            # model label alone
            fleet = j.router is not None
            replicas = j.replicas or [
                {"rid": "r0", "model": j.model, "batcher": j.batcher}
            ]
            for rep in replicas:
                labels = {"model": j.name}
                if fleet:
                    labels["replica"] = rep["rid"]
                batcher = rep.get("batcher")
                reg = None
                if batcher is not None:
                    get_reg = getattr(batcher, "metrics_registry", None)
                    reg = get_reg() if callable(get_reg) else None
                    if reg is None:
                        reg = getattr(batcher, "metrics", None)
                if reg is not None:
                    groups.append((labels, reg))
                snap = getattr(
                    rep.get("model"), "cont_serving_stats", None
                )
                if isinstance(snap, dict) and snap:
                    sreg = MetricsRegistry()
                    snapshot_gauges(sreg, snap, prefix="tlink_engine_")
                    groups.append((labels, sreg))
            if fleet:
                groups.append(({"model": j.name}, j.router.metrics))
            if j.autopilot is not None:
                groups.append(({"model": j.name}, j.autopilot.metrics))
        return groups

    def hosted_snapshot(self) -> list[dict]:
        """Consistent view for API threads (the hosted dict is mutated by
        pool threads under _host_lock; readers must take it too)."""
        with self._host_lock:
            out = []
            for j in self.hosted.values():
                entry = {"name": j.name, "status": j.status}
                stats = j.batcher.stats() if j.batcher is not None else None
                if stats:
                    entry["serving"] = stats
                model = j.model
                if model is not None and getattr(model, "plan", None):
                    entry["stages"] = model.plan.n_stages
                    cf = getattr(model, "chain_forwards", 0)
                    if cf:  # worker-to-worker chained calls completed
                        entry["chain_forwards"] = cf
                if j.router is not None:
                    # fleet view: per-replica routed counts + health,
                    # and each replica's own serving stats under its rid
                    entry["replicas"] = len(j.replicas)
                    entry["fleet"] = j.router.snapshot()
                    entry["replica_serving"] = {
                        rep["rid"]: rep["batcher"].stats()
                        for rep in j.replicas[1:]
                        if rep.get("batcher") is not None
                    }
                out.append(entry)
            return out

    def model_status(self, name: str) -> dict:
        job = self.hosted.get(name)
        if job is None:
            return {"model": name, "status": "absent"}
        out = {"model": name, "status": job.status}
        if job.error:
            out["error"] = job.error
        # serving telemetry (scheduler + slot-engine/prefix-cache counters
        # when the continuous path is active) — same dict /stats carries
        # per hosted model via hosted_snapshot()
        stats = job.batcher.stats() if job.batcher is not None else None
        if stats:
            out["serving"] = stats
        return out

    # ------------------------------------------------------------------
    # generation service for the API (reference _prepare_generation /
    # _generate / _generate_streaming, ml/validator.py:579-850)
    # ------------------------------------------------------------------
    def generate_api(
        self,
        req,  # schemas.GenerationRequest
        on_delta: Callable[[str], None] | None = None,
        trace_id: str | None = None,
        meta_cb: Callable[[dict], None] | None = None,
    ) -> dict:
        """Run one generation on a hosted model. Returns
        ``{text, reasoning, prompt_tokens, completion_tokens, finish_reason,
        jrid}``.
        ``on_delta`` receives visible-answer text pieces as they decode.
        ``meta_cb`` (streaming only) fires once at admission with
        ``{"jrid": ...}`` so SSE clients hold their re-attach handle
        BEFORE any crash can interrupt the stream.
        ``trace_id`` (minted by the API server) threads through the
        batcher to the engine so every hop's spans land under it, and is
        installed as the ACTIVE trace on this worker thread so json-mode
        log lines join the trace too (core/logging.py)."""
        from tensorlink_tpu_torch.core.trace import current_trace

        tid = str(trace_id or "")
        token = current_trace.set(tid)
        try:
            return self._generate_api(req, on_delta, tid, meta_cb)
        finally:
            # the pool thread serves many requests — never leak the id
            current_trace.reset(token)

    def _generate_api(self, req, on_delta, trace_id: str,
                      meta_cb=None) -> dict:
        from tensorlink_tpu_torch.api.formatter import (
            StopStream,
            ThinkStripStream,
            extract_reasoning_and_answer,
            format_chat_prompt,
            normalize_generate_args,
        )

        job = self.hosted.get(req.hf_name)
        if job is None or job.status != "ready":
            raise ModelNotReady(req.hf_name, job.status if job else "absent")
        self._bump_demand(req.hf_name)
        tok = job.tokenizer

        prompt = format_chat_prompt(
            req.message,
            req.history,
            tokenizer=tok if tok.chat_template else None,
            model_name=req.hf_name,
            enable_thinking=req.enable_thinking,
        )
        ids = tok.encode(prompt)
        max_ctx = min(job.seq_len, tok.model_max_length)
        # clamp the prompt against the context window while reserving room
        # for the requested completion (reference formatter.py:47-71
        # truncates against model_max_length)
        reserve = min(int(req.max_new_tokens), max(max_ctx // 2, 1))
        if len(ids) > max_ctx - reserve:
            ids = ids[-(max_ctx - reserve):]
        args = normalize_generate_args(req, prompt_len=len(ids), max_context=max_ctx)

        # control-plane journal: write-ahead admission record. jrid is the
        # durable re-attach handle — the worker keys its live-stream and
        # orphan ledgers on it, so a restarted validator (or a client that
        # outlived one) can resume this exact stream. The prompt travels
        # as a digest only (the journal is an ops artifact, not a prompt
        # store); the seed record pairs up via the batcher's on_admit hook.
        # A re-attach request REUSES the pre-crash jrid: its admission is
        # already journaled (and open — no finish record), so a second
        # admit would reset the replayed high-water mark.
        rjid = str(getattr(req, "reattach", "") or "")
        jrid = rjid or uuid.uuid4().hex
        if not rjid:
            self._journal_rec(
                "admit",
                {
                    "jrid": jrid,
                    "model": req.hf_name,
                    "prompt_sha": hashlib.sha256(
                        ",".join(map(str, ids)).encode()
                    ).hexdigest()[:16],
                    "n_prompt": len(ids),
                    "priority": str(getattr(req, "priority", None) or ""),
                    "max_new_tokens": int(args["max_new_tokens"]),
                    "placement": "router" if job.router is not None else "r0",
                },
                flush=True,
            )
        if meta_cb is not None:
            meta_cb({"jrid": jrid})

        stripper = ThinkStripStream() if not req.enable_thinking else None
        # Incremental detokenization via the offset algorithm (HF
        # TextStreamer): both decodes share the same start token, so
        # SentencePiece leading-space handling stays consistent, and each
        # step decodes only a bounded window — not the whole sequence
        # (O(n²) otherwise on the SSE hot path).
        emitted_ids: list[int] = []
        prefix_offset = 0
        read_offset = 0

        # OpenAI-style stop sequences (applied HERE, not just declared like
        # the reference's schema field). Stream-side filtering runs only
        # when the deltas are ANSWER text (think blocks stripped) — with
        # enable_thinking=true the raw reasoning streams through unfiltered
        # and only the final answer field is truncated, since a stop match
        # inside the think block must not silence the whole stream.
        stop_list = list(getattr(req, "stop", []) or [])
        multi_stage = (
            job.model is not None
            and getattr(job.model, "plan", None) is not None
            and job.model.plan.n_stages > 1
        )
        # stop DETECTION also runs for NON-streamed requests on pipelined
        # models: their decode is host-driven anyway, so a confirmed match
        # cancels the loop and saves the remaining per-token stage hops.
        # (Non-streamed single-stage requests stay on the fully-compiled
        # loop — trading it for a host loop to enable cancel would cost
        # far more than the cancel saves.)
        stream_stops = (
            StopStream(stop_list, on_delta or (lambda _s: None))
            if stop_list and stripper is not None
            and (on_delta is not None or multi_stage)
            else None
        )

        def _deliver(delta: str) -> None:
            if stream_stops is not None:
                stream_stops.feed(delta)
            elif on_delta is not None:
                on_delta(delta)

        def _emit(delta: str) -> None:
            if stripper is not None:
                delta = stripper.feed(delta)
            if delta:
                _deliver(delta)

        use_cb = on_delta is not None or stream_stops is not None
        # delivered-token high-water marks, journaled every N tokens at
        # chunk granularity (streamed requests only — a non-streamed
        # request has delivered nothing until it returns, so its whole
        # outcome is the single finish record)
        hwm_every = max(int(getattr(self.node.config.ml, "journal_hwm_every", 16)), 1)
        hwm_next = [hwm_every]

        def stream_cb(new_tokens: list[int | None]):
            nonlocal prefix_offset, read_offset
            if not use_cb:
                return None
            emitted_ids.extend(t for t in new_tokens if t is not None)
            if len(emitted_ids) >= hwm_next[0]:
                self._journal_rec("hwm", {"jrid": jrid, "n": len(emitted_ids)})
                hwm_next[0] = len(emitted_ids) + hwm_every
            prefix_text = tok.decode(emitted_ids[prefix_offset:read_offset])
            new_text = tok.decode(emitted_ids[prefix_offset:])
            if len(new_text) > len(prefix_text) and not new_text.endswith("�"):
                delta = new_text[len(prefix_text):]
                prefix_offset = read_offset
                read_offset = len(emitted_ids)
                _emit(delta)
            if stream_stops is not None and stream_stops.stopped:
                # confirmed stop match: truthy return cancels this row —
                # host-driven decode loops stop generating it, compiled
                # loops stop forwarding its stream
                return [0]
            return None

        n_beams = int(getattr(req, "num_beams", 1) or 1)
        # beam search works on BOTH distributions: the engine session on
        # whole-model jobs, the session-cached stage chain on pipelined
        # jobs (ml/module.py::_generate_beam_pipelined) — the r4 400s for
        # multi-stage beams and penalties are both gone.
        # presence/frequency penalties work on BOTH distributions: the
        # engine path carries counts in its compiled loop, the pipelined
        # path keeps them session-resident on the head-holding worker
        # (ml/worker.py::_sample_from_logits) — the r4 400 is gone.
        # legacy lookahead is greedy-only; the emitted tokens are identical
        # to vanilla greedy, so the flag is a pure speed hint. Continuous
        # speculation ({"speculative": true}) rides the slot batch instead
        # and works under any sampling — also a pure hint.
        spec = bool(getattr(req, "lookahead", False)) and args["temperature"] == 0.0
        spec_cont = bool(getattr(req, "speculative", False))
        beams_used = None
        if (
            rjid
            and n_beams == 1
            and job.batcher is not None
            and job.model is not None
            and getattr(job.model, "plan", None) is not None
            and job.model.plan.n_stages == 1
        ):
            out_ids = self._reattach_api(
                job, rjid, ids, args, req,
                stream_cb=stream_cb if use_cb else None,
                trace_id=trace_id,
            )
        elif n_beams > 1:
            # deterministic beam decode: bypass the batcher (beams cannot
            # co-batch with other requests — they ARE the batch rows) and
            # serialize on the model lock like the non-batcher path; the
            # shared post-processing tail below handles eos/stop/finish
            # the worker may clamp the width to its largest compiled batch
            # bucket — info_out is per-call, so a concurrent batcher
            # dispatch on this model cannot clobber it
            info: dict = {}
            with job.lock:
                seqs = job.model.generate(
                    [ids],
                    max_new_tokens=args["max_new_tokens"],
                    eos_ids=tok.eos_ids,
                    num_beams=n_beams,
                    info_out=info,
                    trace_id=trace_id,
                )
            beams_used = info.get("num_beams_used")
            out_ids = seqs[0]
        elif job.batcher is not None:
            # concurrent requests coalesce into one batched decode
            # (ml/batching.py); the batcher demuxes this request's tokens.
            # A fleet-hosted model routes through the FleetRouter first:
            # same generate contract, placement scored per request
            # (prefix-cache affinity + per-class load), replica failure
            # failing over before the first token (docs/SERVING.md
            # "Fleet serving")
            gen = (
                job.router.dispatch if job.router is not None
                else job.batcher.generate
            )
            kw: dict = {}
            if job.router is not None:
                # journal the replica actually chosen (the admit record
                # could only say "router") so replayed routed-counts seed
                # the recovered router's real per-replica counters
                kw["on_route"] = lambda rid: self._journal_rec(
                    "place", {"jrid": jrid, "rid": rid}
                )
            out_ids = gen(
                ids,
                jrid=jrid,
                max_new_tokens=args["max_new_tokens"],
                temperature=args["temperature"],
                top_k=args["top_k"],
                top_p=args["top_p"],
                presence_penalty=args["presence_penalty"],
                frequency_penalty=args["frequency_penalty"],
                stream_cb=stream_cb if use_cb else None,
                lookahead=spec,
                speculative=spec_cont,
                priority=getattr(req, "priority", None) or None,
                trace_id=trace_id,
                # per-request opt-out of the disaggregated prefill→decode
                # handoff ({"handoff": false}; default opted in)
                handoff=bool(getattr(req, "handoff", True)),
                **kw,
            )
        else:
            with job.lock:  # serialize per-model generation
                seqs = job.model.generate(
                    [ids],
                    max_new_tokens=args["max_new_tokens"],
                    temperature=args["temperature"],
                    top_k=args["top_k"],
                    top_p=args["top_p"],
                    presence_penalty=args["presence_penalty"],
                    frequency_penalty=args["frequency_penalty"],
                    eos_ids=tok.eos_ids,
                    stream_cb=stream_cb if use_cb else None,
                    lookahead=spec,
                    trace_id=trace_id,
                )
            out_ids = seqs[0]
        if on_delta is not None:
            # flush whatever the offset algorithm still holds (including a
            # trailing partial-UTF8 replacement char — the stream must match
            # the non-stream text for the same request)
            prefix_text = tok.decode(emitted_ids[prefix_offset:read_offset])
            new_text = tok.decode(emitted_ids[prefix_offset:])
            if len(new_text) > len(prefix_text):
                _emit(new_text[len(prefix_text):])
            if stripper is not None:
                tail = stripper.flush()
                if tail:
                    _deliver(tail)
            if stream_stops is not None:
                stream_stops.flush()  # resolve pending prefixes / holdback
        eos = set(tok.eos_ids)
        full_text = tok.decode([i for i in out_ids if i not in eos])
        reasoning, answer = extract_reasoning_and_answer(full_text)
        hit_eos = bool(out_ids) and out_ids[-1] in eos
        finish = "stop" if hit_eos else "length"
        completion = len(out_ids)
        hits = [i for i in (answer.find(s) for s in stop_list) if i != -1]
        if hits:
            answer = answer[: min(hits)]
            finish = "stop"
            # bill tokens generated THROUGH the stop match, not the whole
            # decode (OpenAI semantics): the smallest prefix of out_ids
            # whose decoded answer contains a stop. Monotone in k, so
            # binary search; host-driven decode paths also CANCEL at the
            # match, while the fully-compiled loop runs out its budget —
            # either way the count is the truncated output's.
            def _stopped_at(k: int) -> bool:
                r_, a_ = extract_reasoning_and_answer(
                    tok.decode([t for t in out_ids[:k] if t not in eos])
                )
                return any(a_.find(s) != -1 for s in stop_list)

            lo_k, hi_k = 1, len(out_ids)
            while lo_k < hi_k:
                mid = (lo_k + hi_k) // 2
                if _stopped_at(mid):
                    hi_k = mid
                else:
                    lo_k = mid + 1
            completion = lo_k
        # finish closes the admission in the journal: replay no longer
        # treats this jrid as an orphaned stream needing reconciliation
        self._journal_rec("finish", {"jrid": jrid, "n": completion, "reason": finish})
        out = {
            "text": answer,
            "reasoning": reasoning,
            "prompt_tokens": len(ids),
            "completion_tokens": completion,
            "finish_reason": finish,
            # the durable re-attach handle: a client that outlives this
            # validator repeats its request with {"reattach": jrid} against
            # the recovered one (docs/FAILURE_MODEL.md "Control plane")
            "jrid": jrid,
        }
        if beams_used is not None and beams_used != n_beams:
            out["num_beams_used"] = int(beams_used)  # worker clamped
        return out

    def _reattach_api(self, job, rjid: str, ids, args, req, *,
                      stream_cb, trace_id: str):
        """Serve a ``{"reattach": jrid}`` request: rung 1 of the client
        re-attach ladder over REST. The journaled admission supplies the
        decode seed and (fleet) the replica placement; the worker rebinds
        its still-live slot or replays its finished-orphan buffer, and a
        miss falls through to a plain re-prefill generate — every rung
        returns the COMPLETE stream from token 0, so the client replaces
        its partial pre-crash text (exactly-once by replacement)."""
        from tensorlink_tpu_torch.core.journal import ControlJournal

        seed = 0
        placement = ""
        if self.journal is not None:
            try:
                adm = ControlJournal.replay(
                    self.journal.path
                ).admissions.get(rjid)
                if adm is not None:
                    if adm.get("seed") is not None:
                        seed = int(adm["seed"])
                    placement = str(adm["data"].get("placement", "") or "")
            except Exception as e:
                self.log.debug("journal lookup for re-attach failed: %s", e)
        model = job.model
        for rep in job.replicas or []:
            if placement and rep.get("rid") == placement:
                model = rep["model"]
                break
        return model.reattach_continuous(
            rjid,
            prompt=ids,
            delivered=[],
            max_new_tokens=args["max_new_tokens"],
            temperature=args["temperature"],
            top_k=args["top_k"],
            top_p=args["top_p"],
            presence_penalty=args["presence_penalty"],
            frequency_penalty=args["frequency_penalty"],
            eos_ids=job.tokenizer.eos_ids,
            seed=seed,
            stream_cb=stream_cb,
            priority=getattr(req, "priority", None) or None,
            trace_id=trace_id,
        )

    # ------------------------------------------------------------------
    # fleet serving (tensorlink_tpu_torch/fleet, docs/SERVING.md "Fleet
    # serving") — the /fleet route's view + the rolling-deploy verb
    # ------------------------------------------------------------------
    def fleet_snapshot(self) -> dict:
        """Per-model fleet state for ``GET /fleet``: router telemetry
        (per-replica routed counts, health, headroom) and the autopilot's
        status/history when one runs."""
        with self._host_lock:
            jobs = list(self.hosted.values())
        out = {}
        for j in jobs:
            if j.router is None:
                continue
            out[j.name] = {
                "replicas": len(j.replicas),
                "router": j.router.snapshot(),
                "autopilot": (
                    j.autopilot.status() if j.autopilot is not None else None
                ),
            }
        return out

    def fleet_deploy(self, model: str, replicas: list | None = None) -> dict:
        """Operator trigger for a zero-dropped-token rolling deploy
        (``POST /fleet/deploy``): each named replica (default all) in
        turn drains onto a sibling, rebuilds, rejoins. Requires a fleet;
        an autopilot is started on demand when none is running."""
        # under the host lock: a deploy racing unhost_model must either
        # see the job gone, or install the autopilot BEFORE unhost pops
        # the job — so unhost's stop() always finds and kills it (no
        # orphan control thread issuing verbs against released workers)
        with self._host_lock:
            job = self.hosted.get(model)
            if job is None or job.router is None:
                return {
                    "ok": False, "error": f"no fleet hosted for {model!r}"
                }
            if job.autopilot is None:
                self._start_autopilot(job)
            autopilot = job.autopilot
        queued = autopilot.request_deploy(replicas)
        return {"ok": True, "queued": queued}


def _attach_addr(rep: dict | None, wid: str) -> list:
    """``[host, port]`` of ``wid`` from a replica's journaled attach
    payload (the create_job worker map), ``[]`` when unknown — used to
    make migration tickets self-contained for crash recovery."""
    if not rep or not wid:
        return []
    addr = ((rep.get("attach") or {}).get("workers") or {}).get(wid)
    return list(addr) if addr else []


class ValidatorFleetActions:
    """FleetAutopilot actions over REMOTE replicas — every verb rides
    the existing wire machinery, so moved streams stay bit-identical by
    the migration contract:

    - ``drain``/``drain_step``: the validator's DRAIN verb sheds the
      replica's entry worker (page-ship, re-prefill fallback, zero
      dropped streams); in-flight client requests follow the migration
      redirects transparently (ml/module.py).
    - ``rehost``: the rolling deploy's upgrade — shut the replica's job
      down, re-plan/recruit a fresh one (the drained worker sits fenced
      until its operator restarts it, which IS the binary-upgrade
      window), return the new batcher for the router to re-register.
    - ``rebalance``: declined (returns 0). The wire moves streams at
      WORKER granularity only — a per-stream rebalance would drain the
      whole replica, which is the deploy verb's job, not a load tweak.
      (The in-process :class:`~tensorlink_tpu_torch.fleet.autopilot.
      EngineFleetActions` does per-stream moves.)
    - ``scale_decode``: re-push the handoff pool to every
      replica's entry worker with one more / one fewer decode-role
      worker.
    - ``publish_weights``: declined (returns False). A live weight
      hot-swap needs the engine in-process (docs/TRAINING.md); a remote
      replica picks a new model version up through the rolling-deploy
      path (rehost reloads the checkpoint), which the autopilot records
      per replica so the operator sees exactly who is on what.
    """

    def __init__(self, validator: DistributedValidator, job: HostedJob):
        self.validator = validator
        self.job = job
        self.log = validator.log
        self._decode_pool_n: int | None = None
        # replicas whose wire DRAIN completed: the serving snapshot only
        # refreshes on GENERATE_RESP traffic, and a drained (fenced)
        # replica receives none — judging "drained" from the stale
        # snapshot would loop the deploy forever
        self._drained: set[str] = set()

    def _job_live(self) -> bool:
        """The job is still THE hosted job for its model. unhost_model's
        autopilot.stop() only joins 10s while wire verbs run minutes —
        an in-flight tick that outlives the unhost must not keep acting
        (a post-unhost rehost would recruit workers nothing ever
        releases)."""
        return self.validator.hosted.get(self.job.name) is self.job

    def _rep(self, rid: str) -> dict | None:
        for rep in self.job.replicas:
            if rep["rid"] == rid:
                return rep
        return None

    def live_work(self, rid: str) -> int:
        rep = self._rep(rid)
        if rep is None:
            return 0
        snap = rep["batcher"].router_snapshot()
        live = max(
            int(snap.get("max_slots") or 0) - int(snap.get("slots_free") or 0),
            0,
        )
        return live + sum(
            int(v) for v in (snap.get("queue_depth") or {}).values()
        )

    def movable_streams(self, rid: str) -> int:
        return self.live_work(rid)

    def rebalance(self, src: str, dst: str, max_streams: int = 1) -> int:
        self.log.debug(
            "fleet rebalance %s→%s declined: remote replicas move at "
            "worker granularity (use the deploy/drain verb)", src, dst,
        )
        return 0

    def drain(self, rid: str) -> None:
        rep = self._rep(rid)
        if rep is None or not self._job_live():
            return
        wid = self.validator._replica_entry_worker(rep)
        if not wid:
            return
        # primary path: drain onto a SIBLING replica's entry worker (it
        # already hosts the model — no stage ship, prefix probes hit).
        # When no sibling runs on a different worker the verb goes out
        # dest-less: the net layer picks most-free, and the worker's own
        # REPLICA_SET fallback backstops a validator with no candidates.
        dest, dest_rep = next(
            (
                (w, r2) for r2 in self.job.replicas
                if r2 is not rep
                and (w := self.validator._replica_entry_worker(r2))
                and w != wid
            ),
            (None, None),
        )
        req = {"worker": wid}
        if dest:
            req["dest"] = dest
        # write-ahead migration ticket: a validator that dies while this
        # drain is in flight leaves an OPEN "mig" intent in the journal;
        # recovery expires the staged pages at both endpoints
        # deterministically (no half-staged tickets leak), then aborts it.
        # The endpoint ADDRESSES ride the ticket: the recovered validator
        # re-dials only the plan workers, and the drain destination is
        # outside the source plan by construction — without its address
        # the expiry could never reach the staged pages.
        iid = self.validator._jintent("mig", {
            "name": self.job.name, "rid": rid, "src": wid,
            "dest": dest or "", "job_id": rep["job_id"],
            "src_addr": _attach_addr(rep, wid),
            "dest_addr": _attach_addr(dest_rep, dest or ""),
        })
        try:
            summary = self.validator.bridge.request(
                "drain_worker", req, timeout=600.0,
            )
        except Exception as e:
            self.validator._jabort(iid, {"error": str(e)[:200]})
            raise
        if isinstance(summary, dict) and summary.get("ok"):
            self._drained.add(rid)
            self.validator._jcommit(iid, {"ok": True})
        else:
            self.validator._jabort(iid, {"summary": str(summary)[:200]})
        self.log.info(
            "autopilot drain of replica %s (worker %s → %s): %s",
            rid, wid[:8], (dest or "auto")[:8], summary,
        )

    def undrain(self, rid: str) -> None:
        # the DRAIN verb is synchronous and terminal for the worker (it
        # stays capacity-fenced for its upgrade); nothing to lower here
        return

    def drain_step(self, src: str, dst: str, max_streams: int = 4) -> int:
        # a COMPLETED wire drain moved everything synchronously —
        # in-flight client requests finish through their migration
        # redirects regardless, and the stale snapshot must not gate the
        # deploy (it stops refreshing the moment the replica is fenced)
        if src in self._drained:
            return 0
        return self.live_work(src)

    def rehost(self, rid: str):
        """Rebuild the replica on current capacity; returns the new
        batcher (the autopilot re-registers it under the same rid)."""
        if not self._job_live():
            raise RuntimeError(
                f"{self.job.name} was unhosted mid-deploy — refusing to "
                "recruit workers for a released job"
            )
        rep = self._rep(rid)
        if rep is None:
            return None
        old_batcher, old_model = rep["batcher"], rep["model"]
        model, batcher, jid, attach = self.validator._build_replica(
            self.job, dict(rep["spec"]), self.job.cfg,
            batch=rep.get("batch", 1), seed=rep.get("seed", 0),
        )
        self.validator._journal_rec(
            "replica_down", {"name": self.job.name, "rid": rid}, flush=True,
        )
        rep.update({
            "model": model, "batcher": batcher, "job_id": jid,
            "attach": attach,
        })
        self.validator._journal_replica(self.job, rep)
        self._drained.discard(rid)  # the rebuilt replica serves again
        if rep is self.job.replicas[0]:
            self.job.model, self.job.batcher = model, batcher
        try:
            old_batcher.close()
        except Exception:
            self.log.exception("old replica %s batcher close failed", rid)
        try:
            # shutdown ALWAYS runs — a wedged batcher close must not
            # leave the old replica's recruited workers reserved forever
            # (the same invariant unhost_model keeps)
            old_model.shutdown()
        except Exception:
            self.log.exception("old replica %s teardown failed", rid)
        self.validator._push_replica_sets(self.job)
        return batcher

    def publish_weights(self, rid: str, params, version: int) -> bool:
        """Declined — see the class docstring: remote replicas take the
        rolling-deploy path for model updates."""
        self.log.info(
            "fleet weight publish v%s declined for remote replica %s "
            "(rolling-deploy path)", version, rid,
        )
        return False

    def scale_decode(self, up: bool) -> bool:
        if not self._job_live():
            return False
        stats = self.validator.bridge.request(
            "stats_workers", timeout=15.0
        )
        decode = [
            s for s in stats
            if str(s.get("serving_role") or "mixed") == "decode"
            and s.get("addr")
        ]
        if not decode:
            return False
        cur = (
            self._decode_pool_n
            if self._decode_pool_n is not None else len(decode)
        )
        target = max(1, min(len(decode), cur + (1 if up else -1)))
        if target == cur and self._decode_pool_n is not None:
            return False
        pool = [
            {"id": s["id"], "addr": list(s["addr"])}
            for s in decode[:target]
        ]
        pushed = False
        for rep in self.job.replicas:
            wid = self.validator._replica_entry_worker(rep)
            if not wid:
                continue
            try:
                self.validator.bridge.request(
                    "set_handoff_pool", {"worker": wid, "pool": pool},
                    timeout=10.0,
                )
                pushed = True
            except Exception as e:
                self.log.warning(
                    "handoff-pool push to %s failed: %s", wid[:8], e
                )
        if pushed:
            self._decode_pool_n = target
        return pushed


class ModelNotReady(RuntimeError):
    def __init__(self, name: str, status: str):
        super().__init__(f"model {name!r} is {status}")
        self.model = name
        self.status = status
