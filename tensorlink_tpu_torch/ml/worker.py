"""DistributedWorker — the ML-side executor of a worker node (port of
``tensorlink_tpu/ml/worker.py``; one device per worker).

The executor blocks on one event queue fed by the network process and
serves and trains whole-model jobs, and serves pipeline stages:

- ``load_stage`` loads the stage's layer slice (plus the embedding on the
  first stage and the final norm and head on the head's stage) from a
  checkpoint (``engine/loader.py::load_params``) or cut from seeded random
  weights, optionally weight-only int8 (``quant`` "int8" / "int8+kv",
  ignored for a training job); a whole-model stage also gets its
  :class:`GenerationEngine`;
- GENERATE requests flagged ``continuous`` join the job's
  :class:`ContinuousEngine` slot batch and stream each token back over the
  TOKEN relay; a ``cont_continue`` marker on the work queue drives one
  chunk per trip, so requests that arrive meanwhile are admitted at the
  next chunk boundary;
- every other GENERATE takes the dense engine's static paths
  (``generate_compiled``, ``generate``/``generate_chunked`` when streamed,
  ``generate_lookahead``, chunked beam search);
- the training verbs: FORWARD (``op`` "stage" or "head"; ``train=True``
  keeps the inputs under the driver's ``tag``), BACKWARD (recomputes the
  forward under autograd from those inputs and accumulates the parameter
  gradients across micro-batches), OPTIMIZER (init, zero, grad_norm,
  step — ``engine/optimizers.py``, optax's formulas — with a
  proof-of-learning entry per step), PROOF_REQ, CHECKPOINT (one TLTS file
  of params and optimizer state per stage, the JAX package's layout),
  PARAMS_REQ and TRAIN_MODE.

- fleet serving and live migration: DRAIN (fence admissions, ship every
  steady decode slot's KV pages to the destination worker and redirect
  the rest for a re-prefill there), MIGRATE (the destination's probe,
  put, prefix pull and ticket expiry), HANDOFF (the decode pool a
  prefill-role worker ships each completed prefill to) and REPLICA_SET
  (the sibling replicas a destination-less DRAIN falls back to);
- stream re-attach: a GENERATE carrying ``reattach`` rebinds a live
  stream to the new peer, or replays a finished one from the orphan
  ledger.

- pipeline stages: a FORWARD with a ``session`` runs the stage's slice
  over a dense ``KVCache`` sized to the slice, kept per session in
  ``StageRuntime.sessions``; its ops are sequence-numbered (``seq``) and a
  duplicate never applies twice (``_session_dup``). ``op="chain"`` ships
  the hidden state straight to the next stage's worker, looping back to
  stage 0 for a tied head (``head_hop``); the head's worker samples,
  ships per-position argmax ids (speculative verify) or beam candidates.
  ``reset_rows``, ``reset_len`` and ``reorder_idx`` edit the cached
  session before the op's writes, and ``end_session`` drops it. A stage
  runs the einsum attention, as the JAX worker's: the flash prefill is a
  whole-model engine's.

- pipelined training: a layer slice trains like a whole model, with the
  stage's own ``first``/``last`` flags; its BACKWARD also answers the
  gradient of its input (the hidden state) when the stage is not first,
  and so does the tied head's hop, so the driver passes each cotangent
  one stage back.

- a planned stage mesh: its tree placed by the plan's specs; a ``stage``
  axis runs the slice's whole-sequence forwards through the in-mesh GPipe
  (``parallel/pipeline.py``) and a ``seq`` axis through ring attention
  (``parallel/ring.py``), training forwards and the BACKWARD's recompute
  too; ``MLConfig.collective_quant`` makes a serving job's tp gathers
  int8.

- a co-slice merged stage (``coworkers``): every member process joined
  one ``torch.distributed`` group at start (``parallel/multihost.py``,
  from ``MLConfig.coordinator_address``/``num_processes``/``process_id``)
  and builds the stage mesh over the group's global device list; the
  driver mirrors each work item to every member (``mirror``), each runs
  it over its own positions of the mesh, every value that crosses the
  members moves by ``parallel/mesh.py::hop``, and a value leaves the mesh
  whole on every member (:meth:`_to_host`). The primary answers; a
  coworker answers ``{"ok": True, "mirror": True}``, and only the primary
  writes a checkpoint or ships the full tree. Serving such a stage is
  refused (as in the JAX worker), and so is a ``data``, ``expert``,
  ``seq`` or ``stage`` axis over the members (ROADMAP queue 1 item 6).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np

from tensorlink_tpu_torch import unported
from tensorlink_tpu_torch.core.faults import FaultCrash, FaultPlan
from tensorlink_tpu_torch.core.logging import get_logger
from tensorlink_tpu_torch.p2p import protocol as proto


@dataclass
class StageRuntime:
    """One loaded job stage: config, params, serving engines, decode
    sessions and training state."""

    job_id: str
    cfg: Any  # ModelConfig
    stage: dict  # StagePlan as dict (layer_lo/hi, first, last, holds_head)
    # the model spec this stage was shipped with (name, config, ckpt/seed,
    # quant, flash, page_quota)
    model_spec: dict = field(default_factory=dict)
    params: Any = None  # the stage's tree (QTensor leaves when quantized)
    engine: Any = None  # GenerationEngine (whole-model stages only)
    # the stage's planned {data, fsdp, tensor} mesh (params placed on it
    # by stage_param_specs), else None
    mesh: Any = None
    # decode sessions: session id -> this stage's KVCache (its layers)
    sessions: dict[str, Any] = field(default_factory=dict)
    # per-session [B, V] context counts for presence/frequency penalties
    # on pipelined decode (the head's worker samples with them)
    penalty_counts: dict[str, Any] = field(default_factory=dict)
    # idempotency ledger of sequence-numbered session ops: dedup key
    # ("{session}:{phase}") -> the last applied seq, and -> that op's
    # outcome, re-sent to a duplicate instead of re-applying its writes
    session_seq: dict[str, int] = field(default_factory=dict)
    session_resp: dict[str, tuple] = field(default_factory=dict)
    training: bool = False
    cache_quant: bool = False  # int8 dense KV caches ("int8+kv")
    # training inputs kept for BACKWARD: tag -> (kind, x, attn_mask,
    # first, apply_head); the backward recomputes the forward from them
    # under autograd with the stage's flags
    saved: dict[str, Any] = field(default_factory=dict)
    grad_accum: Any = None  # summed parameter gradients across micros
    n_accum: int = 0
    opt: Any = None  # engine.training.ChainedOptimizer
    opt_state: Any = None
    # proof-of-learning log: one chained entry per optimizer step
    # (platform/proofs.py; the validator pulls it with PROOF_REQ)
    proof_log: list = field(default_factory=list)
    opt_steps: int = 0
    # in-flight chunked beam-search sessions: rid -> (BeamState, payload,
    # effective K). A long beam decode advances _BEAM_CHUNK_STEPS at a
    # time and requeues itself, so queued generates interleave with it
    beam_sessions: dict[str, Any] = field(default_factory=dict)
    # the continuous-batching slot engine: GENERATE requests flagged
    # "continuous" submit into its slot batch and a cont_continue marker
    # drives chunked decode through the work queue
    cont: Any = None
    cont_scheduled: bool = False
    # a tensor_parallel > 1 whole-model job: the devices of its serving
    # mesh (its slot engine's shards), else None
    tp_devices: Any = None
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
        # drain state (live slot migration): set to the DRAIN verb's
        # destination {"id", "addr"} — new continuous requests are
        # redirected there instead of admitted, and the recruiting
        # capacity is zeroed. None = serving normally.
        self.draining: dict | None = None
        # disaggregated prefill/decode (docs/SERVING.md): the decode-pool
        # memberships a prefill-role worker hands completed prefills to —
        # pushed by the validator (HANDOFF frames). Keyed PER JOB (the
        # recruit-time push names the job it was planned for — a job
        # recruited before any decode worker existed must NOT start
        # shipping its streams to another job's pool), with "" as the
        # worker-wide fallback an operator's set_handoff_pool installs.
        # Empty = no handoffs (mixed-style serving even under
        # worker_role="prefill").
        self._handoff_pools: dict[str, list[dict]] = {}
        self._handoff_rr = 0  # round-robin cursor over the pool
        # fleet serving (docs/SERVING.md "Fleet serving"): the sibling-
        # replica memberships pushed by the validator (REPLICA_SET
        # frames, keyed by this worker's job id) — the destination a
        # DRAIN with no explicit dest falls back to, so a rolling-deploy
        # drain lands on a replica that already serves the same model
        self._replica_sets: dict[str, list[dict]] = {}
        # destinations already probed loaded/ready per job — skips the
        # per-handoff MODULE-ship round trip on the steady-state path;
        # invalidated on any ship failure so a restarted destination is
        # re-prepared instead of redirected into blind
        self._handoff_dest_ready: set[tuple[str, str]] = set()
        # (job, dest) prepares currently in flight (the warm-up thread or
        # the run loop): a second prepare for the same key must neither
        # block nor double-ship — a duplicate MODULE load REPLACES the
        # destination's runtime, killing any stream adopted in between
        self._handoff_preparing: set[tuple[str, str]] = set()
        self._handoff_prep_lock = threading.Lock()
        # shared multi-tenant KV page pools (engine/paged.py::
        # SharedPagePool), keyed by page geometry and placement — created
        # lazily at the first continuous engine when
        # MLConfig.cont_pool_pages > 0 and touched only from the serial
        # run loop
        self._kv_pools: dict = {}
        # per-node fault plan (core/faults.py); None keeps the hot paths
        # free of fault-site calls
        fspec = getattr(node.config, "faults", None)
        self.faults: FaultPlan | None = (
            FaultPlan.from_dict(fspec) if fspec else None
        )
        # join the member processes BEFORE first device use when the
        # deployment spans worker processes of one slice
        # (parallel/multihost.py) — then a merged stage's mesh spans the
        # slice's pooled devices
        ml = node.config.ml
        from tensorlink_tpu_torch.parallel.multihost import maybe_initialize

        maybe_initialize(ml.coordinator_address, ml.num_processes,
                         ml.process_id, devices=self._advertised_devices())

    # -- capacity -------------------------------------------------------
    def capacity(self) -> dict:
        """What this worker advertises: its devices for a planned mesh
        (:meth:`_advertised_devices`) and the free memory of the distinct
        ones (a CPU worker's host counts once, however many times a mesh
        repeats it), its platform, and its serving role."""
        from tensorlink_tpu_torch.core.devices import probe_device

        ml = self.node.config.ml
        probe = probe_device(self.device, ml.max_memory_gb)
        devs = self._advertised_devices()
        hbm = sum(probe_device(d, ml.max_memory_gb).hbm_bytes
                  for d in dict.fromkeys(devs))
        out = {
            "hbm_bytes": hbm,
            "n_devices": len(devs),
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
        elif kind == proto.FORWARD:
            self._forward(p)
        elif kind == proto.BACKWARD:
            self._backward(p)
        elif kind == proto.OPTIMIZER:
            self._optimizer(p)
        elif kind == proto.PROOF_REQ:
            self._proof_req(p)
        elif kind == proto.CHECKPOINT:
            self._checkpoint(p)
        elif kind == proto.PARAMS_REQ:
            self._params_req(p)
        elif kind == proto.TRAIN_MODE:
            self._train_mode(p)
        elif kind == proto.DRAIN:
            self._drain(p)
        elif kind == proto.MIGRATE:
            self._migrate_in(p)
        elif kind == proto.HANDOFF:
            self._set_handoff_pool(p)
        elif kind == proto.REPLICA_SET:
            self._set_replica_set(p)
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
        # the job's handoff state goes with it: its decode-pool list and
        # per-destination readiness would otherwise pin the dead job id
        self._handoff_pools.pop(job_id, None)
        self._replica_sets.pop(job_id, None)
        with self._handoff_prep_lock:  # vs the warm thread's add
            self._handoff_dest_ready = {
                k for k in self._handoff_dest_ready if k[0] != job_id
            }
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
        from tensorlink_tpu_torch.engine.optimizers import tree_map
        from tensorlink_tpu_torch.models.base import ModelConfig
        from tensorlink_tpu_torch.models.quant import quantize_params
        from tensorlink_tpu_torch.models.transformer import (
            init_params,
            slice_stage_params,
        )

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
        lo, hi = int(stage["layer_lo"]), int(stage["layer_hi"])
        first, holds_head = bool(stage["first"]), bool(stage["holds_head"])
        # the planned mesh first: too few devices fail the load before any
        # weight is made
        mesh = self._build_stage_mesh(stage)
        training = bool(p.get("training", False))
        if ml.collective_quant and not training:
            # the quantized collectives (parallel/ring.py): the tp serving
            # step's gathers and the seq ring move int8 with per-row
            # scales. Serving only: quantize_kv's round() has a zero
            # gradient, so a training job keeps exact collectives
            cfg = cfg.with_(collective_quant=True)
        whole = bool(first and stage["last"] and holds_head)
        tp = int(getattr(ml, "tensor_parallel", 1) or 1)
        # a tp job's mesh from this worker's card on: too few cards fail
        # the load (it never serves on fewer shards); a planned mesh
        # takes its place
        tp_devices = (self._mesh_devices(tp)
                      if whole and tp > 1 and mesh is None else None)
        placed = False
        if model.get("ckpt") and mesh is not None:
            # straight onto the stage's mesh: the whole tree never sits on
            # one device
            from tensorlink_tpu_torch.engine.loader import load_params

            _, full = load_params(model["ckpt"], cfg, layer_range=(lo, hi),
                                  mesh=mesh, specs=self._load_specs(cfg,
                                                                    stage))
            params = slice_stage_params(full, 0, 0, first=first,
                                        holds_head=holds_head)
            params["layers"] = full["layers"]
            placed = True
        elif model.get("ckpt"):
            from tensorlink_tpu_torch.engine.loader import load_params

            _, full = load_params(model["ckpt"], cfg, layer_range=(lo, hi),
                                  device=self.device)
            # the loader reads the embedding, norm and head too; keep what
            # the stage owns
            params = slice_stage_params(full, 0, hi - lo, first=first,
                                        holds_head=holds_head)
        else:
            # the whole model from the seed, then the stage's cut: a split
            # model's weights equal the unsplit model's
            gen = torch.Generator(self.device)
            gen.manual_seed(int(model.get("seed", 0)))
            full = init_params(cfg, gen, self.device)
            params = slice_stage_params(full, lo, hi, first=first,
                                        holds_head=holds_head)
            if not whole:
                # the slice's layers are views of the whole stack: copy
                # them so the rest of the model is freed
                params["layers"] = tree_map(lambda t: t.clone(),
                                            params["layers"])
        del full
        if mesh is not None and not placed:
            params = self._shard_params(params, cfg, stage, mesh)
        quant = model.get("quant")
        if model.get("flash"):
            if whole:
                cfg = cfg.with_(flash_attention=True)
            else:
                self.log.warning(
                    "flash_attention ignored on a pipelined (multi-stage) "
                    "job — only whole-model serving engines take the "
                    "flash prefill path"
                )
        if quant and quant not in ("int8", "int8+kv"):
            # fail the MODULE load rather than serve a mode nobody asked for
            raise ValueError(f"unknown quant mode {quant!r}")
        if quant and training:
            # the optimizer needs exact weights
            self.log.warning("quant=%s ignored for a TRAINING job", quant)
            quant = None
        rt = StageRuntime(
            job_id=job_id,
            cfg=cfg,
            stage=stage,
            model_spec=dict(model),
            training=training,
            cache_quant=quant == "int8+kv",
            tp_devices=tp_devices,
            mesh=mesh,
        )
        if whole and not self._spans_processes(mesh):
            # (a merged stage serves nothing: its engine loops would run
            # in one member only)
            rt.engine = GenerationEngine(
                cfg,
                params,
                mesh=mesh,
                # batch buckets include 1: the engine's cache keeps its
                # batch whole; kv heads ride the tensor axis
                cache_specs=(self._cache_specs_for(rt, batch=1)
                             if mesh is not None else None),
                max_seq_len=min(cfg.max_seq_len, ml.max_seq_len),
                seq_buckets=ml.seq_buckets,
                batch_buckets=ml.batch_buckets,
                # the engine quantizes the weights itself; "+kv" also sets
                # its dense cache mode, and the mode rides serving
                # snapshots
                quant=quant or None,
                device=self.device,
            )
            rt.params = rt.engine.params
        else:
            # a stage quantizes its slice (per-layer scales: slicing then
            # quantizing equals quantizing then slicing)
            rt.params = quantize_params(params) if quant else params
        with self._lock:
            old = self.jobs.get(job_id)
            self.jobs[job_id] = rt
        if old is not None and old.cont is not None:
            # a re-shipped stage replaces the runtime: fail the old slot
            # engine's in-flight requests fast
            old.cont.close(RuntimeError("stage reloaded"))
            old.cont = None
        if tp_devices is not None:
            # a tp job serves through its sharded slot engine: build it
            # now, so no request runs on the whole tree before it
            self._ensure_cont(rt)
        self.log.info(
            "loaded %s layers [%d,%d) first=%s head=%s on %s in %.1fs",
            model.get("name", "?"), lo, hi, first, holds_head, self.device,
            time.monotonic() - t0,
        )
        self._respond(
            p["peer"], proto.MODULE_LOADED, p["rid"],
            {"job_id": job_id, "ok": True, "n_layers": hi - lo},
        )
        warm_toks = ml.warmup_tokens
        if (rt.engine is not None and warm_toks and not training
                and not _tp_hosted(rt)):
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

    def _advertised_devices(self) -> list:
        """The devices a plan may mesh over: ``MLConfig.mesh_devices`` of
        them from this worker's own, or the devices it names
        (:meth:`_mesh_devices`); by default (None) every local card from
        this worker's own on, as the JAX worker advertises every local
        device, or a CPU worker's host once."""
        from tensorlink_tpu_torch.parallel.mesh import local_devices

        named = getattr(self.node.config.ml, "mesh_devices", None)
        if named is None:
            if self.device.type == "cpu":
                return [self.device]
            return local_devices()[self._first_card():]
        return self._mesh_devices(named if isinstance(named, int)
                                  else len(named))

    def _first_card(self) -> int:
        import torch

        first = self.device.index
        return torch.cuda.current_device() if first is None else first

    def _mesh_devices(self, n: int) -> list:
        """``n`` devices from this worker's on: the first ``n`` that
        ``MLConfig.mesh_devices`` names (one card may repeat), else ``n``
        times a CPU worker's host, else ``n`` distinct cards from this
        worker's card on (ValueError when there are fewer)."""
        import torch

        from tensorlink_tpu_torch.parallel.mesh import local_devices

        named = getattr(self.node.config.ml, "mesh_devices", None)
        if isinstance(named, (list, tuple)):
            devs = [torch.device(d) for d in named]
        elif self.device.type == "cpu":
            return [self.device] * n
        else:
            devs = local_devices()[self._first_card():]
        if n > len(devs):
            raise ValueError(f"mesh needs {n} devices, have {len(devs)}")
        return devs[:n]

    def _build_stage_mesh(self, stage: dict):
        """This stage's device mesh from the plan's ``mesh_axes`` (None
        for a one-device stage), over :meth:`_mesh_devices` — or, for a
        MERGED co-slice stage, over the member processes' global device
        list (``multihost.global_devices()``: the same list, in the same
        order, on every member, so all build one mesh). Too few devices
        fail the load: the JAX worker runs unsharded then, the port never
        serves on fewer shards than planned."""
        from tensorlink_tpu_torch.parallel import multihost
        from tensorlink_tpu_torch.parallel.mesh import build_mesh

        axes = {k: int(v) for k, v in (stage.get("mesh_axes") or {}).items()}
        n = 1
        for v in axes.values():
            n *= v
        if n <= 1:
            return None
        if not stage.get("coworkers"):
            return build_mesh(axes, self._mesh_devices(n))
        if not multihost.is_multihost():
            raise RuntimeError(
                "a co-slice merged stage needs its members joined in one "
                "group: set MLConfig.coordinator_address / num_processes "
                "/ process_id (or TLTPU_COORDINATOR / TLTPU_NUM_PROCESSES "
                "/ TLTPU_PROCESS_ID) on every member")
        devs = multihost.global_devices()
        if n > len(devs):
            raise ValueError(f"mesh needs {n} devices, have {len(devs)}")
        mesh = build_mesh(axes, devs[:n])
        if mesh.spans and any(axes.get(a, 1) > 1
                              for a in ("data", "expert", "seq", "stage")):
            raise unported("a data, expert, seq or stage axis over a "
                           "process-spanning mesh", 6)
        return mesh

    def _shard_params(self, params, cfg, stage: dict, mesh):
        """A stage's tree placed on its mesh by ``stage_param_specs``."""
        from tensorlink_tpu_torch.parallel.mesh import put
        from tensorlink_tpu_torch.parallel.planner import (
            StagePlan,
            stage_param_specs,
        )

        return put(mesh, params, stage_param_specs(cfg, StagePlan(**stage)))

    @staticmethod
    def _load_specs(cfg, stage: dict) -> dict:
        """The spec tree a checkpoint loads by onto a stage's mesh: the
        stage's specs over every leaf the loader reads (the embedding,
        final norm and head included; the stage keeps what it owns)."""
        from tensorlink_tpu_torch.parallel.planner import (
            StagePlan,
            stage_param_specs,
        )

        return stage_param_specs(cfg, StagePlan(**dict(
            stage, first=True, holds_head=True)))

    def _cache_specs_for(self, rt: StageRuntime, batch: int):
        """The dense cache's spec on this stage's mesh: kv heads on
        ``tensor`` when they divide it, the batch on ``data`` only when
        the batch divides it (serving batches of 1 never fail against a
        data axis)."""
        from tensorlink_tpu_torch.models.transformer import cache_specs

        axes = rt.stage.get("mesh_axes") or {}
        tp = int(axes.get("tensor", 1))
        dp = int(axes.get("data", 1))
        return cache_specs(
            rt.cfg,
            data_axis="data" if dp > 1 and batch % dp == 0 else None,
            tensor_axis=("tensor" if tp > 1 and rt.cfg.n_kv_heads % tp == 0
                         else None),
            quantized=rt.cache_quant,
        )

    def _runtime(self, job_id: str) -> StageRuntime:
        rt = self.jobs.get(job_id)
        if rt is None:
            raise KeyError(f"job {job_id} not loaded")
        return rt

    # -- multihost (co-slice merged mesh) transfers ----------------------
    @staticmethod
    def _spans_processes(mesh) -> bool:
        """Whether a stage's mesh holds positions of OTHER processes (a
        co-slice merged plan)."""
        return mesh is not None and mesh.spans

    def _to_host(self, rt: StageRuntime, t, at: int = 0):
        """A value of the stage's mesh as a host array. On a spanning
        mesh position ``at``'s value (the placed forward's output lies on
        the mesh's first) is sent to every member first — every member
        runs this inside the same mirrored work item."""
        if self._spans_processes(rt.mesh):
            from tensorlink_tpu_torch.parallel.mesh import replicate

            t = replicate(t, rt.mesh, at)
        return _host(t)

    def _to_device(self, rt: StageRuntime, arr, dtype=None):
        """A host array as an input of the stage: on this member's first
        device of a spanning mesh (every member received the same bytes
        in its mirrored work item), else on the worker's device."""
        import torch

        from tensorlink_tpu_torch.engine.paged import device_tensor

        dev = (rt.mesh.local_device() if self._spans_processes(rt.mesh)
               else self.device)
        if dtype is not None:
            return torch.as_tensor(np.asarray(arr, dtype), device=dev)
        return device_tensor(arr, dev)

    def _mirror_ack(self, p: dict, tag: str) -> bool:
        """Answer a coworker's mirrored work item with the slim ack;
        False (nothing sent) for the primary's."""
        if not p.get("mirror"):
            return False
        self._respond(p["peer"], tag, p["rid"], {"ok": True, "mirror": True})
        return True

    # -- generate (whole-model jobs) ------------------------------------
    def _generate(self, p: dict) -> None:
        """Generation on a whole-model job. Streams token ids over the
        TOKEN relay when ``stream`` is set, then resolves with the full
        sequences."""
        from tensorlink_tpu_torch.engine.sampling import SamplingParams

        rt = self._runtime(p["job_id"])
        if self._spans_processes(rt.mesh):
            raise RuntimeError(
                "generation on a co-slice merged mesh is not supported — "
                "host the model without co_slice_planning for serving")
        prompts = [list(map(int, row)) for row in p["prompts"]]
        if p.get("continuous") and self._generate_continuous(rt, p, prompts):
            return  # admitted into the slot batch; responds via on_finish
        # the static paths run the dense engine; a placed tree (a planned
        # mesh's, a tp job's) runs its placed forward
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
        if self.draining is not None:
            # admission fence: this worker is shedding its slots — redirect
            # the request to the drain destination (the client re-issues
            # there; an empty tokens_so_far means a plain resubmission)
            self._respond_migrated(
                rt.cont,
                {"peer": p["peer"], "rid": p["rid"],
                 "stream": p.get("stream"),
                 "trace": str(p.get("trace") or "")},
                self.draining, None, [],
            )
            return True
        cont = self._ensure_cont(rt)
        if cont is None:
            return False
        tid = str(p.get("trace") or "")
        jrid = str(p.get("jrid") or "")
        want = str(p.get("reattach") or "")
        if want and self._reattach_continuous(rt, cont, p, want):
            return True
        # a re-attach MISS falls through here on purpose: the request body
        # already carries prompt+delivered and start_step, so plain
        # admission below IS the re-prefill resume rung (bit-identical by
        # the fold_in sampling contract) — no extra round trip
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
            # resume-after-migration: bind the staged KV pages instead of
            # re-prefilling (engine falls back when the ticket is stale)
            adopt=p.get("adopt") or None,
            trace_id=tid,
            # draft/verify opt-in (no-op unless this engine's spec_decode
            # is on; streams bit-identical either way)
            speculative=bool(p.get("speculative", False)),
            # disaggregated prefill/decode: on a prefill-pool worker with
            # a live decode pool, this admission freezes at its
            # prefill→decode boundary and _run_handoffs ships it —
            # unless the request opted out ({"handoff": false}) or is
            # itself a migration resume (adopt) bouncing through
            handoff=bool(
                self._handoff_pool_for(rt.job_id)
                and p.get("handoff", True) is not False
                and not p.get("adopt")
            ),
        )
        # transport context for live migration: a drain must redirect this
        # stream mid-flight, which needs the original peer/rid/stream —
        # the on_finish/stream closures are opaque, this is not
        req.client_meta = {
            "peer": peer, "rid": p["rid"], "stream": stream_id,
            "trace": tid, "jrid": jrid,
        }
        if jrid:
            rt.jstreams[jrid] = req
        self._schedule_cont(rt)
        return True

    def _cont_channels(self, rt: "StageRuntime", cont, *, peer, rid,
                       stream_id, tid, jrid="", resume_base=None):
        """Build the (stream_cb, on_finish) transport-closure pair for a
        continuous stream. Shared by first admission and by the re-attach
        rebinding so both transports behave identically — the only
        difference is ``resume_base``: set on a re-attach, the final
        response carries {"reattached": True, "resume_base": base} so the
        client merges sequences (this-submission tokens) onto its
        delivered[:base] prefix exactly-once."""
        state = {"n": 0}

        def stream_cb(tok: int):
            # fire-and-forget per token; cancel frames (confirmed stop
            # matches) poll once per chunk — overrun bounded like the
            # compiled chunked stream
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
                    # the GENERATE_RESP below may be going to a dead
                    # validator — keep the result in the bounded orphan
                    # ledger so a re-attach can still drain it
                    self._stash_orphan(rt, jrid, req)
            if req.error is not None:
                try:
                    self._respond(
                        peer, proto.GENERATE_RESP, rid,
                        {"error": f"{type(req.error).__name__}: {req.error}",
                         "worker": self.node.node_id},
                    )
                except Exception as e:
                    # the requester is gone — an undeliverable error reply
                    # must not propagate into step_chunk and error the
                    # ENGINE (closing it evicts every other live stream
                    # that is decoding through the validator outage)
                    self.log.warning(
                        "error response for %s undeliverable: %s", rid, e)
                return
            body = {
                "sequences": [list(map(int, req.tokens))],
                "finished": [bool(req.finished)],
                "continuous": True,
                # engine occupancy + prefix-cache counters ride every
                # response so the validator's /stats can surface them
                # without a dedicated polling RPC
                "serving": cont.serving_snapshot(),
            }
            if resume_base is not None:
                body["reattached"] = True
                body["resume_base"] = int(resume_base)
            if tid:
                # this worker's spans for the request ride home the same
                # way — the validator ingests them so /trace stitches a
                # request's hops without any polling RPC
                body["trace"] = {
                    "id": tid, "spans": cont.tracer.collect(tid),
                }
            try:
                self._respond(peer, proto.GENERATE_RESP, rid, body)
            except Exception as e:
                # dead validator (the crash-safety orphan path): the
                # result is already stashed in the orphan ledger above —
                # letting this propagate would error the ENGINE via
                # step_chunk and evict every OTHER stream still decoding
                # through the outage
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

    def _reattach_continuous(self, rt: "StageRuntime", cont, p: dict,
                             jrid: str) -> bool:
        """Worker half of the re-attach ladder. Returns True when handled:
        a LIVE orphaned stream is rebound to the new peer/rid/stream (its
        backlog past the client's high-water mark topped up atomically —
        this runs on the same serial ML thread as decode chunks), or a
        FINISHED orphan is replayed from the ledger. False = miss; the
        caller falls through to plain admission (re-prefill resume)."""
        peer, rid = p["peer"], p["rid"]
        stream_id = p.get("stream")
        tid = str(p.get("trace") or "")
        hwm = int(p.get("hwm", 0))
        req = rt.jstreams.get(jrid)
        if req is not None and not req.finished:
            base = int(req.start_step)
            stream_cb, on_finish = self._cont_channels(
                rt, cont, peer=peer, rid=rid, stream_id=stream_id,
                tid=tid, jrid=jrid, resume_base=base,
            )
            req.client_meta = {
                "peer": peer, "rid": rid, "stream": stream_id,
                "trace": tid, "jrid": jrid,
            }
            req.stream_cb = stream_cb if stream_id else None
            req.on_finish = on_finish
            if stream_id:
                # top up the fresh relay with everything the slot emitted
                # past the client's high-water mark while orphaned
                backlog = req.tokens[max(hwm - base, 0):]
                if backlog:
                    self.bridge.notify(
                        "send_token",
                        {"peer": peer, "stream": stream_id,
                         "tokens": [[0, int(t)] for t in backlog]},
                    )
            self.log.info(
                "reattached live stream jrid=%s (slot tokens=%d, "
                "client hwm=%d)", jrid, len(req.tokens), hwm,
            )
            self._schedule_cont(rt)
            return True
        orphan = rt.orphans.pop(jrid, None)
        if orphan is not None:
            toks = [int(t) for t in orphan["tokens"]]
            base = int(orphan["base"])
            if stream_id:
                try:
                    backlog = toks[max(hwm - base, 0):]
                    if backlog:
                        self.bridge.notify(
                            "send_token",
                            {"peer": peer, "stream": stream_id,
                             "tokens": [[0, int(t)] for t in backlog]},
                        )
                    self.bridge.request(
                        "send_token",
                        {"peer": peer, "stream": stream_id, "tokens": [],
                         "done": True},
                    )
                except Exception as e:
                    self.log.debug(
                        "orphan replay stream push failed: %s", e
                    )
            self._respond(
                peer, proto.GENERATE_RESP, rid,
                {"sequences": [toks], "finished": [True],
                 "continuous": True, "reattached": True,
                 "resume_base": base, "serving": cont.serving_snapshot()},
            )
            self.log.info(
                "replayed finished orphan jrid=%s (%d tokens)",
                jrid, len(toks),
            )
            return True
        return False

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
        role = str(getattr(ml, "worker_role", "mixed") or "mixed")
        try:
            if int(getattr(ml, "cont_pool_pages", 0)) > 0:
                pool = self._shared_kv_pool(rt, ml)
                quota = int(
                    (rt.model_spec or {}).get("page_quota")
                    or getattr(ml, "cont_pool_quota", 0)
                )
            rt.cont = cont = ContinuousEngine(
                rt.engine,
                # disaggregated prefill/decode: a prefill-role worker's
                # engine freezes opted-in slots at the prefill→decode
                # boundary for _run_handoffs to ship
                handoff_after_prefill=(role == "prefill"),
                worker_role=role,
                # co-hosting: jobs whose page geometry and placement
                # match share ONE pool under a per-model quota; job_id
                # keys the tenant
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
                # explicit TP: shard the hot path over the job's mesh
                # (load_stage found its devices); engines that cannot
                # (MoE, indivisible heads, a pool, quantized weights)
                # refuse with ValueError into the fallback below. A tree
                # placed on the job's planned mesh serves on that mesh
                # (the engine reads it off the tree)
                tensor_parallel=len(rt.tp_devices) if rt.tp_devices else 1,
                tp_devices=rt.tp_devices,
            )
        except ValueError as e:
            # sliding window (or a bad knob): static batcher territory
            self.log.info("continuous batching unavailable: %s", e)
            return None
        if cont.tensor_parallel > 1:
            # the engine placed the weights on its mesh: the job's tree
            # is that one, so the whole tree is freed
            rt.params = rt.engine.params
        return cont

    def _shared_kv_pool(self, rt: StageRuntime, ml):
        """Get-or-create the shared page pool this job's engine draws from
        (MLConfig.cont_pool_pages > 0), keyed by page geometry and page
        placement so models that cannot share pages get separate pools: a
        job placed on a planned mesh draws from a pool made where its
        slot engine's pages lie (``placed_cache_mesh``; a ValueError for
        a tree that engine refuses)."""
        from tensorlink_tpu_torch.engine.paged import (
            SharedPagePool,
            page_placement,
            placed_cache_mesh,
        )
        from tensorlink_tpu_torch.parallel.mesh import is_sharded

        cfg = rt.cfg
        device, mesh = self.device, None
        if is_sharded(rt.engine.params) and not rt.tp_devices:
            device, mesh = placed_cache_mesh(rt.engine.params, cfg)
        kvq = str(ml.kv_quant or "none")
        if rt.cache_quant and kvq == "none":
            kvq = "int8"  # mirror of the engine's cache_quant forcing
        page_size = int(ml.cont_page_size)
        dtype_str = (
            "int8" if kvq in ("int8", "int4") else str(rt.engine.cache_dtype)
        )
        key = (
            cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, page_size, kvq,
            dtype_str, page_placement(device, mesh),
        )
        self._gc_kv_pools(keep=key)
        pool = self._kv_pools.get(key)
        if pool is None:
            pool = SharedPagePool(
                cfg, int(ml.cont_pool_pages), page_size=page_size,
                dtype=rt.engine.cache_dtype, kv_quant=kvq,
                device=device, mesh=mesh,
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
        # steady-state prefill→decode handoff: ship every slot the chunk
        # froze at its prefill boundary BEFORE deciding whether to
        # requeue — a frozen slot is invisible to step_chunk's has_work,
        # so resolving the manifest here is what keeps the engine free of
        # parked in-transit slots between work items. Re-check has_work
        # after: an aborted handoff resumes the slot's prefill HERE, and
        # that revived work must requeue even when the chunk saw none.
        self._run_handoffs(rt)
        if more or (rt.cont is not None and rt.cont.has_work()):
            self._schedule_cont(rt)

    # -- live slot migration + drain (docs/FAILURE_MODEL.md) -------------
    # DRAIN (validator → this worker): fence admissions, then move every
    # live continuous stream to the destination worker — KV-page shipping
    # for steady decode slots (bit-identical resume), the crash-recovery
    # re-prefill rung for everything else (mid-prefill slots, queued
    # requests, and any failed export/wire/import). The client learns via
    # a {"migrated": ...} GENERATE_RESP and re-issues at the destination;
    # a stream is never dropped, only redirected.

    # -- disaggregated prefill/decode: steady-state handoff --------------
    # (docs/SERVING.md "Disaggregated prefill/decode") A prefill-role
    # worker is permanently "draining" its completed prefills: every
    # opted-in admission freezes at the prefill→decode boundary and is
    # shipped here to a decode-pool worker through the SAME
    # export/stage/adopt path a drain uses — but with no admission
    # fence, no capacity zeroing, and a per-slot fallback ladder
    # (page-ship → re-prefill redirect at the destination → resume
    # locally) instead of a worker-wide abort. The client follows the
    # redirect exactly like a drain redirect, except the plan keeps
    # pointing HERE — this worker stays the admission point.

    def _set_replica_set(self, p: dict) -> None:
        """A REPLICA_SET push from the validator (mirrors the HANDOFF
        pool push): the other replicas of the fleet this worker's job
        belongs to, as ``[{id, addr, job_id}, ...]``. Pure wire state —
        consulted only when a DRAIN arrives with no destination."""
        peers = [
            dict(e) for e in (p.get("peers") or [])
            if e.get("id") and e.get("id") != self.node.node_id
            and e.get("addr")
        ]
        job_id = str(p.get("job_id") or "")
        self._replica_sets[job_id] = peers
        self.log.info(
            "replica set (%s): %d sibling(s) %s",
            job_id[:8] or "worker-wide", len(peers),
            [str(e["id"])[:8] for e in peers],
        )

    def _set_handoff_pool(self, p: dict) -> None:
        """A HANDOFF push from the validator: the decode-pool membership
        this (prefill-role) worker ships completed prefills to — scoped
        to the named job ("" = worker-wide operator push)."""
        pool = [
            dict(e) for e in (p.get("pool") or [])
            if e.get("id") and e.get("id") != self.node.node_id
            and e.get("addr")
        ]
        job_id = str(p.get("job_id") or "")
        self._handoff_pools[job_id] = pool
        # membership changed: stale readiness could point at a departed
        # worker, and a fresh pool deserves fresh probes — but only for
        # the job whose pool this push names (a new job's recruit must
        # not cost every OTHER job an inline re-probe on the run loop);
        # the worker-wide "" push refreshes everything
        with self._handoff_prep_lock:
            # the lock covers every mutation of _handoff_dest_ready: the
            # warm thread adds concurrently, and an unguarded add during
            # this comprehension's iteration would raise "set changed
            # size during iteration" in the control-frame handler
            if job_id:
                self._handoff_dest_ready = {
                    k for k in self._handoff_dest_ready if k[0] != job_id
                }
            else:
                self._handoff_dest_ready.clear()
        self.log.info(
            "handoff pool set (%s): %d decode worker(s) %s",
            job_id[:8] or "worker-wide", len(pool),
            [str(e["id"])[:8] for e in pool],
        )
        if pool:
            # pre-warm OFF the run loop: a cold destination's stage ship
            # can take minutes (MODULE timeout 120s), and paying it
            # inside _run_handoffs would stall every co-resident
            # stream's decode between chunks. The push arrives at
            # recruit time — usually before any traffic — so the warm
            # thread normally has the readiness cache populated before
            # the first prefill completes; a handoff that races it just
            # pays the old synchronous prepare once.
            threading.Thread(
                target=self._warm_handoff_dests, args=(job_id,),
                name="handoff-warm", daemon=True,
            ).start()

    def _warm_handoff_dests(self, job_id: str) -> None:
        """Background half of the pool push: probe/ship the job's stage
        to every decode-pool member so the run loop's _pick_handoff_dest
        finds them ready instead of preparing them inline. Job-scoped
        pushes wait briefly for the runtime (HANDOFF and MODULE race at
        recruit time); failures are dropped — the synchronous path
        re-probes on demand and the slot falls back locally at worst."""
        deadline = time.monotonic() + 30.0
        while True:
            with self._lock:
                if job_id:
                    rts = [self.jobs[job_id]] if job_id in self.jobs else []
                else:
                    rts = list(self.jobs.values())
            if rts or time.monotonic() >= deadline:
                break
            time.sleep(0.25)
        for rt in rts:
            pool = self._handoff_pool_for(rt.job_id)
            for dest in pool:
                key = (rt.job_id, str(dest.get("id", "")))
                with self._handoff_prep_lock:
                    if key in self._handoff_dest_ready \
                            or key in self._handoff_preparing:
                        continue
                    self._handoff_preparing.add(key)
                try:
                    ok = self._prepare_dest(rt, dest)
                    # the job may have been shut down during the ship
                    # (MODULE can take minutes): marking it ready now
                    # would re-pin the dead job id shutdown_job just
                    # purged
                    with self._lock:
                        alive = rt.job_id in self.jobs
                    if ok and alive:
                        with self._handoff_prep_lock:
                            self._handoff_dest_ready.add(key)
                # tlint: disable=TL005(best-effort warm-up — the handoff path re-probes on demand)
                except Exception:
                    pass
                finally:
                    with self._handoff_prep_lock:
                        self._handoff_preparing.discard(key)

    def _handoff_pool_for(self, job_id: str) -> list[dict]:
        """The decode pool a job's completed prefills ship to: the
        job-scoped push wins; the worker-wide operator push stands in
        for jobs recruited without one."""
        return (
            self._handoff_pools.get(job_id)
            or self._handoff_pools.get("")
            or []
        )

    def _pick_handoff_dest(self, rt: "StageRuntime") -> dict | None:
        """Round-robin over the job's decode pool, skipping members that
        can't host this job right now (unreachable / refusing /
        stage-load failure). Readiness is cached per (job, dest) so the
        steady-state path pays one probe per handoff, not a MODULE round
        trip."""
        pool = self._handoff_pool_for(rt.job_id)
        n = len(pool)
        for j in range(n):
            dest = pool[(self._handoff_rr + j) % n]
            key = (rt.job_id, str(dest["id"]))
            if key in self._handoff_dest_ready:
                self._handoff_rr = (self._handoff_rr + j + 1) % n
                return dest
            with self._handoff_prep_lock:
                if key in self._handoff_preparing:
                    # the warm-up thread is mid-ship to this member:
                    # waiting would stall the run loop and a second
                    # MODULE ship would replace the destination runtime
                    # — try the next member (or resume locally)
                    continue
                self._handoff_preparing.add(key)
            try:
                ok = self._prepare_dest(rt, dest)
            finally:
                with self._handoff_prep_lock:
                    self._handoff_preparing.discard(key)
            if ok:
                with self._handoff_prep_lock:
                    self._handoff_dest_ready.add(key)
                self._handoff_rr = (self._handoff_rr + j + 1) % n
                return dest
        return None

    def _run_handoffs(self, rt: "StageRuntime") -> None:
        """Ship every slot the last chunk froze at its prefill→decode
        boundary. Runs on the worker's serial run loop right after the
        chunk, so every freeze-to-ship window is one work item — no
        frozen slot ever parks across items."""
        cont = rt.cont
        if cont is None:
            return
        manifest = cont.handoff_manifest()
        if not manifest:
            return
        for slot, req in manifest:
            meta = req.client_meta
            if meta is None or self.draining is not None \
                    or not self._handoff_pool_for(rt.job_id):
                # no transport context to redirect (in-process driver),
                # or this worker is itself mid-drain (the drain ladder
                # owns its slots): finish the prefill locally
                cont.abort_handoff(slot)
                continue
            dest = self._pick_handoff_dest(rt)
            if dest is None:
                # no decode worker usable: degrade to mixed serving for
                # this slot — one grant finishes the prompt and the
                # stream decodes here, never dropped, never slower
                self.log.warning(
                    "handoff: no usable decode-pool destination; "
                    "slot %d resumes locally", slot,
                )
                cont.abort_handoff(slot)
                continue
            committed = False
            try:
                if self.faults is not None:
                    # fault site "worker.handoff": error sends the slot
                    # down the re-prefill redirect rung; crash is the
                    # prefill-worker-dies-mid-handoff chaos case
                    self.faults.inject(
                        "worker.handoff", str(meta.get("rid", ""))
                    )
                mig_id = self._ship_migration(rt, cont, slot, dest)
                moved = cont.commit_handoff(slot)
                committed = True
                self._respond_migrated(
                    cont, meta, dest, mig_id, moved.tokens, handoff=True
                )
            except FaultCrash:
                raise  # the run loop takes the node down
            except Exception as e:
                # per-slot containment: ONE failed handoff must neither
                # re-commit a torn-down slot nor abandon the rest of the
                # manifest (the popped entries would freeze forever)
                if committed:
                    # the slot already committed — its pages are staged
                    # at the destination and the redirect send was
                    # already retried (_respond_migrated); landing here
                    # means the client's relay is genuinely gone (peer
                    # hung up), so there is no one left to redirect. The
                    # staged ticket expires via the migration TTL;
                    # nothing to roll back, but say so loudly.
                    self.log.warning(
                        "handoff redirect for slot %d failed post-commit "
                        "(%s); staged ticket left to TTL expiry", slot, e,
                    )
                    continue
                # drop the readiness cache so the NEXT handoff re-probes
                # this member, and kick the warm thread so that re-probe
                # (and a possible stage re-ship to a restarted worker)
                # happens OFF the run loop instead of inline between a
                # future chunk and its handoffs
                with self._handoff_prep_lock:
                    self._handoff_dest_ready.discard(
                        (rt.job_id, str(dest["id"]))
                    )
                threading.Thread(
                    target=self._warm_handoff_dests, args=(rt.job_id,),
                    name="handoff-rewarm", daemon=True,
                ).start()
                try:
                    self._dial_dest(dest)
                except Exception:
                    # the destination is UNREACHABLE, not merely refusing
                    # the transfer: redirecting the client at it would
                    # just bounce off a dead worker — resume locally (the
                    # slot's prefilled state is intact; one grant
                    # finishes the prompt)
                    self.log.warning(
                        "handoff of slot %d failed and destination %s is "
                        "unreachable (%s); resuming locally",
                        slot, str(dest.get("id", ""))[:8], e,
                    )
                    cont.abort_handoff(slot)
                    continue
                self.log.warning(
                    "handoff of slot %d to %s failed (%s); redirecting "
                    "for re-prefill at the destination",
                    slot, str(dest.get("id", ""))[:8], e,
                )
                # the destination hosts the job and is reachable — only
                # the transfer failed. Send this stream down the
                # re-prefill rung: redirect FIRST, commit after — if the
                # redirect send itself fails, the slot is still frozen
                # and the local-resume rung below stays reachable (a
                # commit-first ordering would tear the slot down and
                # strand the stream against its RPC timeout). Its
                # prefill-region pages promote into the trie at commit,
                # so even a bounce-back re-admission here walks them for
                # free.
                try:
                    self._respond_migrated(
                        cont, meta, dest, None, req.tokens, handoff=True,
                    )
                    cont.commit_handoff(slot, fell_back=True)
                except Exception as e2:
                    # even the fallback redirect failed: keep the stream
                    # serving HERE rather than stranding it frozen
                    self.log.warning(
                        "handoff fallback redirect for slot %d failed "
                        "(%s); resuming locally", slot, e2,
                    )
                    if slot in cont.frozen_slots():
                        cont.abort_handoff(slot)

    def _drain(self, p: dict) -> None:
        dest = dict(p.get("dest") or {})
        if self.faults is not None:
            # fault site "worker.drain": a worker that dies the moment it
            # is asked to shed its slots (crash) or refuses (error)
            self.faults.inject("worker.drain", str(dest.get("id", "")))
        if not dest.get("id") or not dest.get("addr"):
            # fleet fallback (docs/SERVING.md "Fleet serving"): a DRAIN
            # with no destination drains onto a sibling replica's entry
            # worker from the REPLICA_SET push — but _drain ships EVERY
            # job to the one destination, so the fallback applies only
            # when the candidate is UNAMBIGUOUS: all pushed sets agree
            # on one sibling (a worker co-hosting two fleets must not
            # drain model A's streams onto model B's sibling)
            candidates = {
                e["id"]: dict(e)
                for peers in self._replica_sets.values()
                for e in peers
                if e.get("id") and e.get("id") != self.node.node_id
                and e.get("addr")
            }
            if len(candidates) == 1:
                dest = next(iter(candidates.values()))
        if not dest.get("id") or not dest.get("addr"):
            self._respond(
                p["peer"], proto.DRAIN_RESP, p["rid"],
                {"ok": False, "error": "drain needs a destination {id, addr}"},
            )
            return
        if dest["id"] == self.node.node_id:
            # a self-targeted drain would make this worker permanently
            # redirect every request back to itself
            self._respond(
                p["peer"], proto.DRAIN_RESP, p["rid"],
                {"ok": False, "error": "refusing to drain a worker onto itself"},
            )
            return
        self.draining = dest
        try:
            # recruiting fence: advertise zero capacity so planners stop
            # placing new stages here while the worker sheds its slots
            self.bridge.request(
                "set_capacity", {"hbm_bytes": 0.0}, timeout=10.0
            )
        except Exception as e:
            self.log.warning("drain: capacity fence failed: %s", e)
        summary = {"ok": True, "jobs": 0, "migrated": 0, "fell_back": 0,
                   "aborted": 0}
        with self._lock:
            jobs = list(self.jobs.items())
        for _job_id, rt in jobs:
            if rt.cont is None:
                continue
            summary["jobs"] += 1
            self._drain_engine(rt, dest, summary)
        if summary["aborted"]:
            # a job the destination can't host keeps serving HERE:
            # redirecting its streams into a jobless worker would drop
            # them. Lower the worker fence and restore the recruiting
            # capacity — the drain failed, loudly, with nothing lost.
            self.draining = None
            try:
                self.bridge.request(
                    "set_capacity", self.capacity(), timeout=30.0
                )
            except Exception as e:
                self.log.warning("drain abort: capacity restore failed: %s", e)
            summary["ok"] = False
            summary["error"] = (
                "destination could not host every job; drain aborted for "
                f"{summary['aborted']} job(s), streams kept serving locally"
            )
        self.log.info(
            "drained to %s: %d migrated, %d fell back, %d aborted",
            str(dest.get("id", ""))[:8], summary["migrated"],
            summary["fell_back"], summary["aborted"],
        )
        self._respond(p["peer"], proto.DRAIN_RESP, p["rid"], summary)

    def _drain_engine(self, rt: "StageRuntime", dest: dict,
                      summary: dict) -> None:
        """Shed one job's slot engine. Runs on the worker's serial run
        loop, so every freeze happens at a chunk boundary by
        construction."""
        cont = rt.cont
        cont.begin_drain()
        if not self._prepare_dest(rt, dest):
            # the destination can't host this job (unreachable, refuses,
            # stage load failed): redirecting streams there would strand
            # them against a jobless worker. Abort THIS job's drain —
            # nothing was shed yet, so lowering the fence resumes serving
            # exactly where it stood.
            cont.end_drain()
            summary["aborted"] += 1
            return
        manifest = cont.live_manifest()
        queued = cont.shed_queued()
        for kind, slot, req in manifest:
            meta = req.client_meta
            if meta is None:
                # no transport context (in-process driver): nothing to
                # redirect — the slot finishes locally under the fence
                continue
            if kind == "decode":
                try:
                    if self.faults is not None:
                        self.faults.inject(
                            "migrate.export", str(meta.get("rid", ""))
                        )
                    cont.freeze_slot(slot)
                    mig_id = self._ship_migration(rt, cont, slot, dest)
                    moved = cont.commit_migration(slot)
                    self._respond_migrated(
                        cont, meta, dest, mig_id, moved.tokens
                    )
                    summary["migrated"] += 1
                    continue
                except FaultCrash:
                    raise  # the run loop takes the node down
                except Exception as e:
                    self.log.warning(
                        "migration of slot %d failed (%s); falling back "
                        "to re-prefill on the destination", slot, e,
                    )
            # fallback ladder: mid-prefill slot, or a failed
            # export/wire/import — redirect for re-prefill resume (the
            # destination hosts the job; only the page transfer failed)
            if slot in cont.frozen_slots():
                moved = cont.commit_migration(slot, fell_back=True)
            else:
                moved = cont.shed_slot(slot)
            self._respond_migrated(
                cont, meta, dest, None, (moved or req).tokens
            )
            summary["fell_back"] += 1
        for req in queued:
            if req.client_meta is not None:
                self._respond_migrated(
                    cont, req.client_meta, dest, None, req.tokens
                )
            else:
                # an in-process submitter can't be redirected: fail fast
                # rather than strand it in a popped-from-queue limbo
                cont.fail_queued(
                    req, RuntimeError("worker draining; resubmit elsewhere")
                )

    def _dial_dest(self, dest: dict) -> str:
        """Peer id of a live connection to the destination worker (the
        network process dedupes dials by address)."""
        return self.bridge.request(
            "connect",
            {"host": dest["addr"][0], "port": int(dest["addr"][1])},
            timeout=15.0,
        )

    def _mig_request(self, peer: str, body: dict, timeout: float = 60.0):
        return self.bridge.request(
            "tensor_request",
            {"peer": peer, "tag": proto.MIGRATE, "body": body,
             "timeout": timeout},
            timeout=timeout + 10.0,
        )

    def _prepare_dest(self, rt: "StageRuntime", dest: dict) -> bool:
        """Make sure the destination can adopt this job's slots: probe it,
        and ship the stage (same model spec → same seeded params → an
        engine whose streams are bit-identical to ours) when it doesn't
        host the job yet. False = page-shipping unavailable; every slot
        takes the re-prefill rung instead."""
        try:
            peer = self._dial_dest(dest)
            pr = self._mig_request(
                peer,
                {"op": "probe", "job_id": rt.job_id,
                 "chain": np.zeros(0, np.int32), "limit": 0},
            )
            if not pr.get("ok"):
                return False
            if not pr.get("loaded"):
                resp = self.bridge.request(
                    "tensor_request",
                    {"peer": peer, "tag": proto.MODULE,
                     "body": {
                         "job_id": rt.job_id,
                         "model": rt.model_spec,
                         "stage": dict(rt.stage, worker_id=dest["id"]),
                         "training": False,
                     },
                     "timeout": 120.0},
                    timeout=130.0,
                )
                if not resp.get("ok"):
                    return False
            return True
        except Exception as e:
            self.log.warning(
                "drain destination %s unreachable/unready: %s",
                str(dest.get("id", ""))[:8], e,
            )
            return False

    def _ship_migration(self, rt: "StageRuntime", cont, slot: int,
                        dest: dict) -> str:
        """Probe + export + transfer one frozen slot's pages. Returns the
        staged ticket id the client's resume request will adopt. Raises
        on any failure — the caller falls back to re-prefill."""
        import secrets

        peer = self._dial_dest(dest)
        chain, limit = cont.migration_chain(slot)
        n_skip = 0
        try:
            pr = self._mig_request(
                peer,
                {"op": "probe", "job_id": rt.job_id,
                 "chain": np.asarray(chain, np.int32), "limit": int(limit)},
            )
            n_skip = int(pr.get("resident_pages", 0) or 0)
        except Exception as e:
            self.log.debug("migration probe failed (%s); shipping all", e)
        blob = cont.export_slot(slot, n_skip=n_skip)
        mig_id = secrets.token_hex(8)
        act = (
            self.faults.inject("migrate.wire", mig_id)
            if self.faults is not None else None
        )
        if act == "drop":
            raise RuntimeError("migrate.wire: transfer dropped")
        if isinstance(act, tuple):  # ("delay", seconds)
            time.sleep(act[1])
        reply = None
        # dup really sends the staging frame twice — idempotency by
        # mig_id is the destination's contract, chaos-tested
        for _ in range(2 if act == "dup" else 1):
            reply = self._mig_request(
                peer,
                {"op": "put", "job_id": rt.job_id, "mig": mig_id,
                 "blob": blob},
            )
        if not (reply or {}).get("ok"):
            raise RuntimeError(
                f"destination refused migration: "
                f"{(reply or {}).get('error', 'not ok')}"
            )
        return mig_id

    def _respond_migrated(self, cont, meta: dict, dest: dict,
                          mig_id: str | None, tokens, *,
                          handoff: bool = False) -> None:
        """Tell the waiting client its stream moved: where to re-issue,
        which staged ticket to adopt (None = plain re-prefill resume), and
        the authoritative emitted-so-far list (fire-and-forget stream
        frames may have dropped — the client tops up exactly-once from
        this). ``cont`` may be None (the admission-fence redirect fires
        before any slot engine exists). ``handoff`` marks a steady-state
        prefill→decode redirect: the client follows it for THIS request
        only and keeps its plan pointed at this worker — the admission
        point — instead of rewriting the plan like a drain redirect."""
        tid = str(meta.get("trace") or "")
        body = {
            "migrated": {
                "worker": dest["id"],
                "addr": list(dest["addr"]),
                "mig": mig_id,
                "tokens_so_far": [int(t) for t in tokens],
                "handoff": bool(handoff),
                # the redirect carries the request's trace id (and, below,
                # the source worker's spans): the client re-issues at the
                # destination under the SAME id, so both halves stitch
                "trace_id": tid or None,
            },
        }
        if cont is not None:
            body["serving"] = cont.serving_snapshot()
            if tid:
                body["trace"] = {"id": tid, "spans": cont.tracer.collect(tid)}
        # the redirect IS the stream at this point — on the handoff path
        # the slot is already torn down and its pages staged at the
        # destination, so a transiently failed send here would strand the
        # client against its RPC timeout (not the recovery ladder, which
        # only catches lost-worker shapes). Absorb transient relay
        # hiccups with short retries — handoffs only: a drain's manifest
        # may hold many slots with hung-up clients, and serializing
        # blocking backoffs across it would stall the run loop for the
        # healthy streams (the drain path keeps its fail-fast shape).
        # The client matches by rid, so a duplicate delivery is dropped
        # as stale.
        attempts = 3 if handoff else 1
        for attempt in range(attempts):
            try:
                self._respond(
                    meta["peer"], proto.GENERATE_RESP, meta["rid"], body
                )
                break
            except Exception as e:
                if attempt == attempts - 1:
                    raise
                self.log.warning(
                    "handoff redirect send failed (attempt %d/%d): %s",
                    attempt + 1, attempts, e,
                )
                time.sleep(0.25 * (attempt + 1))
        if meta.get("stream"):
            try:
                # close the relay so a streaming client's drain loop
                # unblocks immediately instead of riding out its timeout
                self.bridge.request(
                    "send_token",
                    {"peer": meta["peer"], "stream": meta["stream"],
                     "tokens": [], "done": True},
                )
            except Exception as e:
                self.log.debug("migrate stream close failed: %s", e)

    def _migrate_in(self, p: dict) -> None:
        """Destination side of a migration: ``probe`` answers whether the
        job is loaded and how many leading pages of the chain are
        prefix-cache-resident (the exporter skips shipping those);
        ``put`` stages the blob's pages into this engine (idempotent by
        mig id). The staged ticket is adopted by the client's resume
        request (``adopt`` on GENERATE)."""
        op = p.get("op")
        rt = self.jobs.get(p.get("job_id", ""))
        if op in ("probe", "put") and self.draining is not None:
            # worker-level fence: a draining worker must not adopt inbound
            # streams — its engines are fenced, so a staged ticket here
            # could never be adopted (the resume gets redirected away) and
            # its pages would pin until process exit
            self._respond(
                p["peer"], proto.MIGRATE_RESP, p["rid"],
                {"ok": False, "error": "destination is draining"},
            )
            return
        if op == "probe":
            loaded = rt is not None and rt.engine is not None
            body: dict = {"ok": True, "loaded": loaded}
            if loaded:
                cont = self._ensure_cont(rt)
                if cont is None or cont.drain_state != "serving":
                    body = {"ok": False,
                            "error": "destination cannot adopt (no slot "
                                     "engine, or draining itself)"}
                else:
                    chain = [
                        int(t)
                        for t in np.asarray(p.get("chain", [])).reshape(-1)
                    ]
                    body["resident_pages"] = cont.resident_prefix_pages(
                        chain, int(p.get("limit", 0))
                    )
            self._respond(p["peer"], proto.MIGRATE_RESP, p["rid"], body)
            return
        if op == "put":
            if self.faults is not None:
                # fault site "migrate.import": error refuses the staging
                # (source falls back), crash kills the destination mid-
                # migration — the chaos suite's kill-the-receiver case
                self.faults.inject("migrate.import", str(p.get("mig", "")))
            if rt is None or rt.engine is None:
                self._respond(
                    p["peer"], proto.MIGRATE_RESP, p["rid"],
                    {"ok": False, "error": "job not loaded"},
                )
                return
            cont = self._ensure_cont(rt)
            if cont is None:
                self._respond(
                    p["peer"], proto.MIGRATE_RESP, p["rid"],
                    {"ok": False, "error": "continuous unsupported"},
                )
                return
            ok = cont.stage_migration(str(p.get("mig", "")), p["blob"])
            self._respond(
                p["peer"], proto.MIGRATE_RESP, p["rid"],
                {"ok": bool(ok)} if ok else
                {"ok": False,
                 "error": "staging refused (mode mismatch, evicted "
                          "prefix, bad digest, or allocator dry)"},
            )
            return
        if op == "pull":
            # fleet prefix pull (docs/SERVING.md "Tiered prefix cache"):
            # a sibling replica on a local cache miss asks for our
            # resident pages covering its prompt's leading chain. READ-
            # ONLY on this side (gather, never alloc/scatter), so it is
            # deliberately outside the draining fence above — a draining
            # worker's cache is exactly the one worth raiding before its
            # pages die with the drain.
            if self.faults is not None:
                # fault site "kvtier.fetch": error refuses the export
                # (the puller degrades to re-prefill), crash kills this
                # SOURCE mid-pull — the chaos suite's tiered-cache case
                self.faults.inject(
                    "kvtier.fetch", f"pull-src:{p.get('job_id', '')}"
                )
            cont = self._ensure_cont(rt) if (
                rt is not None and rt.engine is not None
            ) else None
            if cont is None:
                self._respond(
                    p["peer"], proto.MIGRATE_RESP, p["rid"],
                    {"ok": False, "error": "job not loaded"},
                )
                return
            chain = [
                int(t) for t in np.asarray(p.get("chain", [])).reshape(-1)
            ]
            blob = cont.export_prefix_pages(
                chain, int(p.get("limit", 0)),
                n_skip=int(p.get("n_skip", 0)),
            )
            # blob=None (chain fell out of both tiers since the digest
            # was published) is ok:True with no blob — losing the race
            # to eviction is a degrade rung, never an error
            self._respond(
                p["peer"], proto.MIGRATE_RESP, p["rid"],
                {"ok": True, "blob": blob},
            )
            return
        if op == "expire":
            # a recovered source validator expiring stranded tickets
            # deterministically at journal replay — without this, a
            # validator restart mid-drain left staged pages pinned until
            # the destination's TTL GC happened to fire
            n = 0
            if rt is not None and rt.cont is not None:
                cont = rt.cont
                want = str(p.get("mig", "") or "")
                for mig_id in cont.staged_migrations():
                    if want and mig_id != want:
                        continue
                    cont.drop_staged_migration(mig_id)
                    n += 1
                cont.check_page_conservation()
            self._respond(
                p["peer"], proto.MIGRATE_RESP, p["rid"],
                {"ok": True, "expired": n},
            )
            return
        raise ValueError(f"unknown migrate op {op!r}")


    # -- forward (single-stage FORWARD; training inputs for BACKWARD) ----
    def _forward(self, p: dict) -> None:
        """op="stage": run this stage's layer slice over ``tokens`` (first
        stage) or ``hidden``, with a decode-session KV cache when the op
        carries ``session``. op="head": final norm + logits of ``hidden``
        (the tied head's hop). op="chain": the same stage op, forwarded
        worker to worker (``head_hop`` marks the tied head's final hop).
        op="end_session" drops a session. ``train=True`` keeps the inputs
        under the caller's ``tag`` for BACKWARD."""
        import torch

        from tensorlink_tpu_torch.engine.paged import device_tensor
        from tensorlink_tpu_torch.models.transformer import (
            head_forward,
            stage_forward,
        )

        rt = self._runtime(p["job_id"])
        op = p.get("op", "stage")
        if self._spans_processes(rt.mesh) and (
                op != "stage" or p.get("session") is not None):
            raise RuntimeError(
                "a co-slice merged stage runs whole-sequence forwards only "
                "(serving on a merged mesh is not supported)")
        if op == "end_session":
            sid = p.get("session")
            rt.sessions.pop(sid, None)
            rt.penalty_counts.pop(sid, None)
            for phase in ("s", "h"):
                rt.session_seq.pop(f"{sid}:{phase}", None)
                rt.session_resp.pop(f"{sid}:{phase}", None)
            self._respond(p["peer"], proto.FORWARD_RESP, p["rid"],
                          {"ok": True})
            return
        if p.get("session") is not None and p.get("seq") is not None:
            # a duplicate delivery (a frame dup on the wire, an RPC retry
            # after a lost reply) must never re-apply the KV writes:
            # re-send the cached outcome instead
            if self._session_dup(rt, p):
                return
        if self.faults is not None and p.get("session") is not None:
            # fault site "worker.session_step": counted per APPLIED op, so
            # transport dups never perturb the plan's decisions
            self.faults.inject("worker.session_step", op)
        if p.get("trace"):
            # the admission op carries the admitted requests' trace ids:
            # record this stage's hop under each
            from tensorlink_tpu_torch.core.trace import get_tracer

            tracer = get_tracer()
            for tid in p["trace"]:
                tracer.record(
                    str(tid), "session_prefill", site=self.node.node_id,
                    layers=f"{rt.stage['layer_lo']}-{rt.stage['layer_hi']}",
                )
        train = bool(p.get("train", False))
        tag = p.get("tag", "")
        if op == "head" or (op == "chain" and p.get("head_hop")):
            hidden = device_tensor(p["hidden"], self.device)
            with torch.no_grad():
                logits = head_forward(rt.params, hidden, rt.cfg)
            if train:
                rt.saved[tag + ".head"] = ("head", hidden, None, False, True)
                self._respond(p["peer"], proto.FORWARD_RESP, p["rid"],
                              {"out": _host(logits)})
                return
            self._finish_fwd(rt, p, logits, True)
            return
        if op not in ("stage", "chain"):
            raise ValueError(f"unknown forward op {op!r}")
        stage = rt.stage
        first = bool(stage["first"])
        apply_head = bool(stage["last"] and stage["holds_head"])
        if first:
            x_in = self._to_device(rt, p["tokens"], np.int32)
        else:
            x_in = self._to_device(rt, p["hidden"])
        mask = None
        if p.get("attn_mask") is not None:
            mask = self._to_device(rt, p["attn_mask"], bool)
        kw = {"tokens": x_in} if first else {"hidden": x_in}
        if train:
            fwd = _stage_fwd_fn(rt, _train_cfg(rt), mask, apply_head,
                                     int(x_in.shape[0]))
            with torch.no_grad():
                out = fwd(rt.params, x_in, mask)
            # no KV cache in training: the backward recomputes the forward
            # from these inputs when the cotangent arrives
            rt.saved[tag] = ("stage", x_in, mask, first, apply_head)
            host_out = self._to_host(rt, out)  # every member, then the ack
            if self._mirror_ack(p, proto.FORWARD_RESP):
                return
            self._respond(p["peer"], proto.FORWARD_RESP, p["rid"],
                          {"out": host_out, "is_logits": apply_head})
            return
        session = p.get("session")
        if session is None and _in_mesh(rt, mask) is not None:
            # a stage or seq axis: the in-mesh GPipe or the ring (neither
            # has a KV cache path; the planner gives serving neither)
            fwd = _stage_fwd_fn(rt, rt.cfg, mask, apply_head,
                                     int(x_in.shape[0]))
            with torch.no_grad():
                out = fwd(rt.params, x_in, mask)
            self._finish_fwd(rt, p, out, apply_head)
            return
        cache = None
        if session is not None:
            cache = self._session_cache(rt, p, x_in.shape[0])
        with torch.no_grad():
            out, new_cache = stage_forward(
                rt.params, rt.cfg, cache=cache, attn_mask=mask,
                first=first, last=apply_head, **kw)
            if session is not None and mask is not None:
                _clear_empty_rows(cache, new_cache, mask)
        if session is not None:
            rt.sessions[session] = new_cache
        if self._spans_processes(rt.mesh):
            from tensorlink_tpu_torch.parallel.mesh import replicate

            out = replicate(out, rt.mesh, 0)  # every member, then the ack
            if self._mirror_ack(p, proto.FORWARD_RESP):
                return
        self._finish_fwd(rt, p, out, apply_head)

    def _session_cache(self, rt: StageRuntime, p: dict, batch: int):
        """The session's cache with this op's edits applied, or a fresh
        one sized to the stage's layers: ``reset_rows`` zeroes recycled
        rows' write offsets (slot admission), ``reset_len`` rolls back the
        previous verify pass's rejected positions (speculative decode),
        ``reorder_idx`` makes each row follow its source beam. Stale KV
        past a row's length is invisible (attention masks by length)."""
        import torch

        from tensorlink_tpu_torch.models.base import KVCache

        cache = rt.sessions.get(p["session"])
        if cache is None:
            scfg = rt.cfg.with_(n_layers=rt.n_layers)
            cache = KVCache.init(
                scfg, batch,
                max_len=int(p.get("cache_len", rt.cfg.max_seq_len)),
                quantized=rt.cache_quant, device=self.device,
            )
            if rt.mesh is not None:
                cache = cache.place(rt.mesh, self._cache_specs_for(rt, batch))
            return cache
        if p.get("reset_rows"):
            rows = torch.as_tensor(np.asarray(p["reset_rows"], np.int64),
                                   device=cache.length.device)
            length = cache.length.clone()
            length[rows] = 0
            cache = KVCache(k=cache.k, v=cache.v, length=length,
                            k_scale=cache.k_scale, v_scale=cache.v_scale)
        if p.get("reset_len") is not None:
            cache = KVCache(
                k=cache.k, v=cache.v,
                length=torch.full_like(cache.length, int(p["reset_len"])),
                k_scale=cache.k_scale, v_scale=cache.v_scale)
        if p.get("reorder_idx") is not None:
            cache = cache.take(torch.as_tensor(
                np.asarray(p["reorder_idx"], np.int64)))
        return cache

    # chain fields every forwarded hop carries onward
    _CHAIN_KEYS = (
        "job_id", "session", "cache_len", "attn_mask", "sample",
        "last_idx", "reply_to", "reorder_idx", "reset_len", "reset_rows",
        "seq", "trace",
    )

    # -- session-op idempotency (seq dedup) ------------------------------
    @staticmethod
    def _session_dedup_key(p: dict) -> str:
        # a first stage that holds a tied head sees TWO ops per decode
        # step (its slice, then the head hop) under the same seq: separate
        # phases, so the head hop is not taken for a duplicate
        return f"{p['session']}:{'h' if p.get('head_hop') else 's'}"

    def _session_dup(self, rt: StageRuntime, p: dict) -> bool:
        """True when this seq was already applied for its session and
        phase. For the latest applied seq the cached outcome is
        re-delivered: a direct response is re-sent under the retry's rid,
        and a mid-chain hop re-drives the chain from its cached output (so
        a retry whose original died downstream still reaches the final
        hop without any stage recomputing or re-absorbing KV)."""
        key = self._session_dedup_key(p)
        seq = int(p["seq"])
        if seq > rt.session_seq.get(key, -1):
            return False
        cached = rt.session_resp.get(key)
        if cached is not None and cached[0] == seq:
            _, kind, payload = cached
            if kind == "resp" and p.get("rid"):
                self._respond(
                    p.get("reply_to") or p["peer"], proto.FORWARD_RESP,
                    p["rid"], payload,
                )
            elif kind == "chain":
                body = dict(payload["body"], _rid=p.get("rid"))
                self.bridge.request(
                    "chain_send", {**payload, "body": body}, timeout=150.0
                )
        return True

    def _session_applied(self, rt: StageRuntime, p: dict, kind: str,
                         payload) -> None:
        """Record a completed session op (seq watermark + its outcome) —
        at completion, not at entry, so a failed op stays retryable."""
        if p.get("session") is None or p.get("seq") is None:
            return
        key = self._session_dedup_key(p)
        rt.session_seq[key] = int(p["seq"])
        rt.session_resp[key] = (int(p["seq"]), kind, payload)

    def _finish_fwd(self, rt: StageRuntime, p: dict, out,
                    is_logits: bool) -> None:
        """Deliver an eval forward: hand the hidden state to the next
        chain hop's worker (``op="chain"``), or — on the final logits —
        sample one token per row, ship per-position argmax ids
        (``verify``) or beam candidates (``beam_k``), or respond with the
        array. ``reply_to`` names a chain's originator; a direct request
        answers its peer."""
        import torch

        chain = p.get("chain") or []
        if p.get("op") == "chain" and chain:
            nxt = chain[0]
            body = {k: p[k] for k in self._CHAIN_KEYS if p.get(k) is not None}
            body.update(
                op="chain",
                chain=chain[1:],
                head_hop=bool(nxt.get("head")),
                hidden=_host(out),
                _rid=p["rid"],  # the originator's future resolves on this
            )
            req = {"addr": list(nxt["addr"]), "tag": proto.FORWARD,
                   "body": body}
            self._session_applied(rt, p, "chain", req)
            # generous: a large activation can outlive the 30 s IPC
            # default, and a spurious timeout would race an error reply
            # against the still-progressing chain
            self.bridge.request("chain_send", req, timeout=150.0)
            return
        reply_peer = p.get("reply_to") or p["peer"]

        def respond_final(body: dict) -> None:
            if p.get("trace"):
                # ship this process's spans of the op's trace ids home
                from tensorlink_tpu_torch.core.trace import get_tracer

                tracer = get_tracer()
                body["trace_spans"] = {
                    str(t): tracer.collect(str(t)) for t in p["trace"]
                }
            self._session_applied(rt, p, "resp", body)
            self._respond(reply_peer, proto.FORWARD_RESP, p["rid"], body)

        if p.get("sample") is not None and is_logits:
            samp = p["sample"]
            if samp.get("verify"):
                # pipelined speculative decode: the argmax id at EVERY
                # position of this step
                ids = out.argmax(dim=-1).to(torch.int32)
                respond_final({"verify_ids": ids.cpu().numpy()})
                return
            if samp.get("beam_k"):
                vals, idx = self._beam_topk_from_logits(out, p)
                respond_final({"beam_vals": vals, "beam_idx": idx})
                return
            respond_final({"token": self._sample_from_logits(rt, out, p)})
            return
        respond_final({"out": _host(out), "is_logits": is_logits})

    @staticmethod
    def _step_logits(logits, p: dict):
        """Each row's logits at its last real position (``last_idx``), or
        at the step's one position."""
        import torch

        if logits.dim() != 3:
            return logits
        B = logits.shape[0]
        dev = logits.device
        last_idx = p.get("last_idx")
        if last_idx is not None:
            idx = torch.as_tensor(np.asarray(last_idx, np.int64), device=dev)
        else:
            idx = torch.full((B,), logits.shape[1] - 1, device=dev,
                             dtype=torch.int64)
        return logits[torch.arange(B, device=dev), idx]

    def _beam_topk_from_logits(self, logits, p: dict):
        """The head's half of pipelined beam search: the top-(K + n_eos)
        of each row's step log-softmax (``engine/generate.py::_beam_topk``,
        ties to the lower index), as host arrays."""
        import torch

        from tensorlink_tpu_torch.engine.generate import _beam_topk

        samp = p["sample"]
        step_logits = self._step_logits(logits, p)
        K = int(samp["beam_k"])
        kk = K + int(samp.get("beam_n_eos", 0))
        vals, idx = _beam_topk(step_logits[:K], max(kk, 1))
        return vals.cpu().numpy(), idx.to(torch.int32).cpu().numpy()

    def _sample_from_logits(self, rt: StageRuntime, logits, p: dict):
        """Sampling on the worker: each row's last real position (or the
        one position ``last_idx`` names), then the sampler with the key
        ``fold_in(PRNGKey(seed), step)`` — or, with ``seeds``, each row's
        own key chain ``fold_in(PRNGKey(seed_r), step_r)`` (pipelined slot
        admission: a row's stream never depends on its neighbours).

        Presence/frequency penalties keep ``[B, V]`` context counts across
        a session's steps (``rt.penalty_counts``): the first op counts the
        prompt ids it ships, and each sampled token folds back in."""
        import torch

        from tensorlink_tpu_torch.engine import prng
        from tensorlink_tpu_torch.engine.sampling import (
            SamplingParams,
            _row_keys,
            _sample_rows,
            sample,
        )

        samp: dict = p["sample"]
        dev = logits.device
        B = logits.shape[0]
        step_logits = self._step_logits(logits, p)
        t = samp.get("temperature", 0.0)
        pen_p = samp.get("presence_penalty", 0.0)
        pen_f = samp.get("frequency_penalty", 0.0)

        def is_rows(v):
            return isinstance(v, (list, tuple, np.ndarray))

        def row(v, dtype, fill):
            vals = list(v) if is_rows(v) else \
                [v if v is not None else fill] * B
            return torch.as_tensor(np.asarray(vals, dtype), device=dev)

        if samp.get("seeds") is not None:
            keys = _row_keys(row(samp["seeds"], np.int64, 0),
                             row(samp.get("steps", 0), np.int64, 0))
            tok = _sample_rows(
                step_logits, keys,
                row(t, np.float32, 0.0),
                row(samp.get("top_k", 0), np.int32, 0),
                row(samp.get("top_p", 1.0), np.float32, 1.0),
                row(pen_p, np.float32, 0.0),
                row(pen_f, np.float32, 0.0),
                torch.zeros((B, rt.cfg.vocab_size), dtype=torch.int32,
                            device=dev),
            )
            return tok.cpu().numpy()
        if is_rows(t):
            n = len(list(t))

            def col(v, dtype):
                if not is_rows(v):
                    v = [v] * n
                return torch.as_tensor(np.asarray(v, dtype),
                                       device=dev).reshape(-1, 1)

            sp = SamplingParams(
                temperature=col(t, np.float32),
                top_k=col(samp.get("top_k", 0), np.int32),
                top_p=col(samp.get("top_p", 1.0), np.float32),
                presence_penalty=col(pen_p, np.float32),
                frequency_penalty=col(pen_f, np.float32),
            )
        else:
            sp = SamplingParams.make(
                temperature=float(t), top_k=int(samp.get("top_k", 0)),
                top_p=float(samp.get("top_p", 1.0)),
                presence_penalty=float(pen_p or 0.0),
                frequency_penalty=float(pen_f or 0.0),
            )
        penalized = any(
            float(x or 0.0) != 0.0
            for v in (pen_p, pen_f) for x in (v if is_rows(v) else [v])
        )
        counts = None
        session = p.get("session")
        if penalized and session is not None:
            counts = rt.penalty_counts.get(session)
            if counts is None:
                # session start: the prompt's token histogram
                pt = np.asarray(samp["prompt_tokens"], np.int64)
                pm = np.asarray(samp["prompt_mask"], bool)
                c = np.zeros((pt.shape[0], rt.cfg.vocab_size), np.int32)
                for i in range(pt.shape[0]):
                    np.add.at(c[i], pt[i][pm[i]], 1)
                counts = torch.as_tensor(c, device=dev)
        key = prng.fold_in(
            prng.PRNGKey(int(samp.get("seed", 0)), device=dev),
            torch.tensor(int(samp.get("step", 0)), device=dev),
        )
        tok = sample(step_logits, key, sp, counts)
        if counts is not None:
            # fold the sampled token into the next step's context
            counts = counts.clone()
            counts[torch.arange(B, device=dev), tok.long()] += 1
            rt.penalty_counts[session] = counts
        return tok.cpu().numpy()

    # -- backward: the forward recomputed under autograd ------------------
    def _backward(self, p: dict) -> None:
        import torch

        from tensorlink_tpu_torch.engine.training import _grads_like, \
            _trainable
        from tensorlink_tpu_torch.models.transformer import (
            head_forward,
            stage_forward,
        )
        from tensorlink_tpu_torch.parallel.mesh import is_sharded

        rt = self._runtime(p["job_id"])
        tag = p.get("tag", "")
        op = p.get("op", "stage")
        key = tag + ".head" if op == "head" else tag
        entry = rt.saved.pop(key, None)
        if entry is None:
            raise KeyError(f"no saved activations for tag {key!r}")
        kind, x_in, mask, first, apply_head = entry
        # the cotangent in the stage's dtype, as the JAX worker casts it
        g = self._to_device(rt, p["grad"]).to(rt.cfg.dtype)
        # a stage that is not first (and the head hop) also answers the
        # gradient of its input, which the driver passes one stage back
        wrt_input = kind == "head" or not first
        if is_sharded(rt.params):
            grads, grad_input = self._placed_backward(
                rt, kind, x_in, mask, first, apply_head, g, wrt_input)
        else:
            tree, leaves = _trainable(rt.params)
            h = x_in.detach().requires_grad_(True) if wrt_input else x_in
            with torch.enable_grad():
                if kind == "head":
                    out = head_forward(tree, h, rt.cfg)
                else:
                    kw = {"hidden": h} if wrt_input else {"tokens": h}
                    out, _ = stage_forward(tree, _train_cfg(rt),
                                           attn_mask=mask, first=first,
                                           last=apply_head, remat=True, **kw)
                grads = torch.autograd.grad(
                    out, leaves + ([h] if wrt_input else []), g,
                    allow_unused=True)
            grad_input = None
            if wrt_input:
                *grads, grad_input = grads
            grads = _grads_like(rt.params, leaves, grads)
        # a tied head's stage 0 sums two gradients of the embedding per
        # micro-batch (the head hop's, then the token lookup's) in the
        # order their BACKWARDs arrive
        self._accumulate(rt, grads)
        if self._mirror_ack(p, proto.BACKWARD_RESP):
            return
        body: dict = {"ok": True}
        if grad_input is not None:
            body["grad"] = _host(grad_input)
        self._respond(p["peer"], proto.BACKWARD_RESP, p["rid"], body)

    @staticmethod
    def _placed_backward(rt: StageRuntime, kind, x_in, mask, first,
                         apply_head, g, wrt_input) -> tuple:
        """BACKWARD over a placed tree: each (data × fsdp) group recomputes
        its block of the rows (``models/sharded.py``, remat with the fsdp
        gathers inside) and differentiates it against the cotangent's
        rows; the gradients reduce per piece in group order
        (``engine/training.py::GradFold``) and stay placed. A stage or
        seq axis recomputes every row once through the in-mesh GPipe or
        the ring (:func:`_stage_fwd_fn`). Returns the placed gradients
        and the input's gradient (rows in order) or None."""
        import torch

        from tensorlink_tpu_torch.engine.training import GradFold, \
            _dispatch_plans, _group_rows
        from tensorlink_tpu_torch.models import sharded
        from tensorlink_tpu_torch.parallel.mesh import replicate, to_device

        fold = GradFold(rt.params)
        parts = []
        cfg = _train_cfg(rt)
        if _in_mesh(rt, mask) is not None:
            # the in-mesh GPipe or the ring: one run over every row
            h = x_in.detach().requires_grad_(True) if wrt_input else x_in
            fwd = _stage_fwd_fn(rt, cfg, mask, apply_head,
                                     int(x_in.shape[0]), remat=True)

            def fn(take):
                if kind == "head":
                    out = sharded.head(rt.params, h, rt.cfg, take=take)
                else:
                    out = fwd(rt.params, h, mask, take=take)
                return out, g.to(out.device)

            got = fold.run(fn, [h] if wrt_input else [])
            return fold.result(), (to_device(got[0], x_in.device)
                                   if wrt_input else None)
        runs = _group_rows(x_in.shape[0], 1, sharded.n_groups(rt.params))
        plans = ({} if kind == "head" else _dispatch_plans(
            rt.params, cfg, runs, attn_mask=mask, first=first,
            **({"hidden": x_in} if wrt_input else {"tokens": x_in})))
        for _m, grp, rows in runs:
            h = (x_in[rows].detach().requires_grad_(True) if wrt_input
                 else x_in[rows])

            def fn(take, grp=grp, rows=rows, h=h, plan=plans.get((0, grp))):
                if kind == "head":
                    out = sharded.head(rt.params, h, rt.cfg, group=grp,
                                       take=take)
                else:
                    kw = {"hidden": h} if wrt_input else {"tokens": h}
                    out, _ = sharded.stage(
                        rt.params, cfg, first=first, last=apply_head,
                        attn_mask=None if mask is None else mask[rows],
                        remat=True, group=grp, take=take, dispatch=plan,
                        **kw)
                return out, g[rows].to(out.device)

            got = fold.run(fn, [h] if wrt_input else [])
            if wrt_input:
                # on a spanning mesh the input's gradient lies with the
                # group's first shard: every member receives it
                parts.append(to_device(replicate(
                    got[0], rt.mesh, sharded.group_first(rt.mesh, grp))
                    if rt.mesh.spans else got[0], x_in.device))
        grad_input = torch.cat(parts, dim=0) if wrt_input else None
        return fold.result(), grad_input

    def _accumulate(self, rt: StageRuntime, grads) -> None:
        """Add a BACKWARD's gradients onto the accumulated ones (a placed
        job's piece onto piece)."""
        import torch

        from tensorlink_tpu_torch.engine.optimizers import tree_map
        from tensorlink_tpu_torch.parallel.mesh import Sharded, map_pieces

        def add(a, b):
            return (map_pieces(torch.add, a, b) if isinstance(a, Sharded)
                    else a + b)

        if rt.grad_accum is None:
            rt.grad_accum = grads
        else:
            rt.grad_accum = tree_map(add, rt.grad_accum, grads)
        rt.n_accum += 1

    # -- optimizer -------------------------------------------------------
    def _optimizer(self, p: dict) -> None:
        import torch

        from tensorlink_tpu_torch.engine import optimizers as optim
        from tensorlink_tpu_torch.engine.training import (
            make_optimizer,
            placed_state,
            sharded_update,
        )
        from tensorlink_tpu_torch.parallel.mesh import (
            Sharded,
            is_sharded,
            map_pieces,
            tree_mesh,
        )

        rt = self._runtime(p["job_id"])
        op = p.get("op")
        placed = is_sharded(rt.params)
        if op == "init":
            spec = dict(p.get("spec", {}))
            name = spec.pop("name", "adamw")
            rt.opt = make_optimizer(name, **spec)
            if placed:
                # piece by piece on the params' devices (over data too
                # on a ZeRO-1 plan)
                dp = self._zero1_dp(rt)
                rt.opt_state = placed_state(
                    rt.opt, rt.params, self._update_slices(rt),
                    dp_axis="data" if dp > 1 else None, dp_size=dp)
            else:
                rt.opt_state = rt.opt.init(rt.params)
            body = {"ok": True, "op": op}
        elif op == "zero":
            rt.grad_accum = None
            rt.n_accum = 0
            body = {"ok": True, "op": op}
        elif op == "grad_norm":
            # this stage's raw accumulated-gradient norm; the driver
            # combines stages into the global norm and folds the clip into
            # the step's scale
            gn = (float(optim.global_norm(rt.grad_accum))
                  if rt.grad_accum is not None else 0.0)
            body = {"ok": True, "op": op, "grad_norm": gn}
        elif op == "step":
            if self.faults is not None:
                # fault site "worker.train_step": before the update applies
                self.faults.inject("worker.train_step", op)
            if rt.opt is None:
                raise ValueError("optimizer not initialized")
            if rt.grad_accum is None:
                raise ValueError("no accumulated gradients")
            scale = float(p.get("scale", 1.0))
            with torch.no_grad():
                if scale != 1.0:
                    # the driver's 1/total_tokens: the accumulated sum-NLL
                    # gradients become the token-mean gradient
                    rt.grad_accum = optim.tree_map(
                        lambda g: map_pieces(lambda x: x * scale, g)
                        if isinstance(g, Sharded) else g * scale,
                        rt.grad_accum)
                if placed:
                    # the inner update on each device's pieces against
                    # its resident state (its slice over data on ZeRO-1)
                    params, rt.opt_state = sharded_update(
                        rt.opt, rt.grad_accum, rt.opt_state, rt.params,
                        self._update_slices(rt), tree_mesh(rt.params))
                else:
                    updates, rt.opt_state = rt.opt.update(
                        rt.grad_accum, rt.opt_state, rt.params)
                    params = optim.apply_updates(rt.params, updates)
                gnorm = float(optim.global_norm(rt.grad_accum))
            self._set_params(rt, params)
            self._record_proof(rt, gnorm)
            rt.grad_accum = None
            rt.n_accum = 0
            body = {"ok": True, "op": op, "grad_norm": gnorm}
        else:
            raise ValueError(f"unknown optimizer op {op!r}")
        if self._mirror_ack(p, proto.OPTIMIZER_RESP):
            return
        self._respond(p["peer"], proto.OPTIMIZER_RESP, p["rid"], body)

    def _set_params(self, rt: StageRuntime, params) -> None:
        """Make ``params`` the job's weights: a whole tree placed on a
        planned mesh (a placed one as it is), published through a tp
        job's slot engine."""
        from tensorlink_tpu_torch.parallel.mesh import is_sharded

        if rt.mesh is not None and not is_sharded(params):
            params = self._shard_params(params, rt.cfg, rt.stage, rt.mesh)
        _set_params(rt, params)

    def _zero1_dp(self, rt: StageRuntime) -> int:
        """The stage's ZeRO-1 data-parallel degree: above 1 only when the
        plan gave this training stage a data axis (``planner.
        training_update_mode``, the one predicate) on a real mesh."""
        from tensorlink_tpu_torch.parallel.planner import (
            training_update_mode,
        )

        if rt.mesh is None or not rt.training:
            return 0
        axes = rt.stage.get("mesh_axes") or {}
        if training_update_mode(axes, rt.training) != "zero1":
            return 0
        return int(axes.get("data", 1))

    def _update_slices(self, rt: StageRuntime) -> dict:
        """Each placed param's update slice: its own spec, its leading dim
        also over ``data`` where the ZeRO-1 degree divides it — the spec
        its optimizer-state twins are placed by."""
        from tensorlink_tpu_torch.engine.optimizers import tree_map
        from tensorlink_tpu_torch.engine.training import dp_extended

        dp = self._zero1_dp(rt)
        return tree_map(lambda p: dp_extended(p.spec, tuple(p.shape),
                                              "data", dp), rt.params)

    def _place_opt_state(self, rt: StageRuntime) -> None:
        """A placed job's optimizer state (a restored one from the host, or
        one a TRAIN_MODE switch re-lays over data) placed by its params'
        specs, over ``data`` too on a ZeRO-1 plan
        (``optimizer_state_specs``)."""
        from tensorlink_tpu_torch.engine.training import (
            _specs_of,
            optimizer_state_specs,
        )
        from tensorlink_tpu_torch.parallel.mesh import (
            is_sharded,
            put,
            tree_mesh,
        )

        if rt.opt_state is None or not is_sharded(rt.params):
            return
        dp = self._zero1_dp(rt)
        sspecs = optimizer_state_specs(
            rt.opt, rt.params, _specs_of(rt.params),
            dp_axis="data" if dp > 1 else None, dp_size=dp)
        rt.opt_state = put(tree_mesh(rt.params), rt.opt_state, sspecs)

    # -- proof of learning (platform/proofs.py) ---------------------------
    MAX_PROOF_LOG = 256
    PROOF_WINDOW = 32  # entries shipped per PROOF_REQ

    def _record_proof(self, rt: StageRuntime, grad_norm: float) -> None:
        from tensorlink_tpu_torch.platform import proofs

        rt.opt_steps += 1
        try:
            sketch = proofs.gradient_sketch(
                rt.grad_accum, seed=int(rt.job_id[:8], 16))
        except Exception:  # noqa: BLE001 — the sketch is telemetry; the
            # proof chain (the hash over grad_norm) keeps growing regardless
            self.log.debug("gradient sketch unavailable", exc_info=True)
            sketch = np.zeros(0)
        prev = rt.proof_log[-1]["hash"] if rt.proof_log else ""
        rt.proof_log.append(
            proofs.proof_entry(rt.opt_steps, grad_norm, sketch, prev))
        if len(rt.proof_log) > self.MAX_PROOF_LOG:
            del rt.proof_log[: -self.MAX_PROOF_LOG]

    def _proof_req(self, p: dict) -> None:
        rt = self._runtime(p["job_id"])
        window = [dict(e) for e in rt.proof_log[-self.PROOF_WINDOW:]]
        if window and len(rt.proof_log) > len(window):
            # chain root for a truncated window = hash of the entry just
            # before it, so the verifier can still check integrity
            window[0]["_chain_root"] = rt.proof_log[-len(window) - 1]["hash"]
        self._respond(
            p["peer"], proto.PROOF_RESP, p["rid"],
            {"ok": True, "log": window, "total_steps": rt.opt_steps},
        )

    # -- checkpoint ------------------------------------------------------
    def _checkpoint(self, p: dict) -> None:
        """Save or restore this stage's params and optimizer state as one
        TLTS file, ``stage_{lo}_{hi}.tlts`` under ``dir`` — the JAX
        worker's layout, so either package restores the other's file."""
        from tensorlink_tpu_torch.core import serialization as ser
        from tensorlink_tpu_torch.engine import optimizers as optim
        from tensorlink_tpu_torch.engine.paged import device_tensor
        from tensorlink_tpu_torch.parallel.mesh import is_sharded

        rt = self._runtime(p["job_id"])
        op = p.get("op", "save")
        st = rt.stage
        path = Path(p["dir"]) / f"stage_{st['layer_lo']}_{st['layer_hi']}.tlts"
        if op == "save":
            # every member of a merged stage joins the leaves; only the
            # primary writes the file
            state = {"params": _host_tree(self._exact_params(rt)),
                     "stage": rt.stage}
            if rt.opt_state is not None:
                from tensorlink_tpu_torch.parallel.mesh import full_tree

                # a placed state joined on the host
                state["opt_state"] = _host_tree(full_tree(rt.opt_state,
                                                          "cpu"))
            if self._mirror_ack(p, proto.CHECKPOINT_RESP):
                return
            path.parent.mkdir(parents=True, exist_ok=True)
            ser.encode_to_file(state, path)
            body = {"ok": True, "path": str(path)}
        elif op == "restore":
            state = ser.decode_from_file(path)
            # a placed job's trees stay on the host until each device's
            # piece is cut from them
            dev = "cpu" if is_sharded(rt.params) else self.device
            params = optim.tree_map(lambda a: device_tensor(a, dev),
                                    state["params"])
            restored_opt = False
            if "opt_state" in state and rt.opt is not None:
                # the saved leaves, laid into a fresh state of this
                # optimizer (its structure and devices)
                tmpl = rt.opt.init(params)
                rt.opt_state = optim.tree_unflatten(tmpl, [
                    device_tensor(a, dev)
                    for a in optim.tree_leaves(state["opt_state"])
                ])
                restored_opt = True
            # a planned mesh's stage re-places the restored tree (and its
            # optimizer state) there
            self._set_params(rt, params)
            if restored_opt:
                self._place_opt_state(rt)
            body = {"ok": True, "restored_opt": restored_opt,
                    "opt_in_checkpoint": "opt_state" in state}
            if self._mirror_ack(p, proto.CHECKPOINT_RESP):
                return
        else:
            raise ValueError(f"unknown checkpoint op {op!r}")
        self._respond(p["peer"], proto.CHECKPOINT_RESP, p["rid"], body)

    # -- parameters ------------------------------------------------------
    @staticmethod
    def _exact_params(rt: StageRuntime):
        """rt.params with int8-serving QTensor leaves dequantized — the
        wire and disk formats carry plain arrays."""
        from tensorlink_tpu_torch.models.quant import QTensor, dequantize
        from tensorlink_tpu_torch.models.sharded import whole
        from tensorlink_tpu_torch.parallel.mesh import is_sharded

        def fix(node):
            if isinstance(node, dict):
                return {k: fix(v) for k, v in node.items()}
            if isinstance(node, QTensor):
                return dequantize(node, rt.cfg.dtype)
            return node

        # a placed job's leaves joined on the host
        return fix(whole(rt.params, "cpu") if is_sharded(rt.params)
                   else rt.params)

    def _params_req(self, p: dict) -> None:
        """Ship this stage's parameters back in one bulk frame."""
        rt = self._runtime(p["job_id"])
        tree = _host_tree(self._exact_params(rt))  # every member joins
        if self._mirror_ack(p, proto.PARAMETERS):
            return
        self._respond(p["peer"], proto.PARAMETERS, p["rid"],
                      {"params": tree})

    def _train_mode(self, p: dict) -> None:
        rt = self._runtime(p["job_id"])
        if bool(p.get("training", True)) and _quantized(rt.params):
            raise ValueError(
                "int8-quantized serving job cannot switch to training — "
                "request the job with quant=None for fine-tuning"
            )
        rt.training = bool(p.get("training", True))
        if rt.training and rt.opt_state is not None:
            self._place_opt_state(rt)
        self._respond(
            p["peer"], proto.TRAIN_MODE_ACK, p["rid"],
            {"job_id": rt.job_id, "training": rt.training},
        )


def _tp_hosted(rt: StageRuntime) -> bool:
    """Whether the job serves through a tensor-parallel slot engine."""
    return rt.cont is not None and rt.cont.tensor_parallel > 1


def _set_params(rt: StageRuntime, params) -> None:
    """Make ``params`` the job's weights (a whole tree, or one placed on
    the job's planned mesh). A tensor-parallel slot engine publishes
    them, which re-places them on its mesh."""
    if _tp_hosted(rt):
        rt.cont.publish_weights(params)
        rt.params = rt.engine.params
        return
    rt.params = params
    if rt.engine is not None:
        rt.engine.params = params


def _clear_empty_rows(cache, new_cache, mask) -> None:
    """Zero what an op wrote for the session rows that hold nothing: a row
    of length 0 whose tokens are all masked (an idle slot of the
    pipelined slot session) attends to no key, so its softmax, and the
    keys and values it writes at positions ``[0, T)``, are NaN. Past a
    row's length a position is masked out, but a NaN value there still
    poisons the row once a request is admitted into it (0 x NaN in the
    attention's value product). Live rows are untouched. A masked fill
    over every row, so the host never waits on the device here."""
    from tensorlink_tpu_torch.parallel.mesh import Sharded

    empty = (cache.length == 0) & ~mask.any(-1)
    T = mask.shape[1]

    def clear(x, rows):
        head = x[:, :, :T]
        head.masked_fill_(rows.view(1, -1, *[1] * (head.dim() - 2)), 0)

    for t in (new_cache.k, new_cache.v, new_cache.k_scale, new_cache.v_scale):
        if t is None:
            continue
        if not isinstance(t, Sharded):
            clear(t, empty)
            continue
        # a placed field: each piece's rows (its data block, or all)
        n_d, keys = t.grid[1], t.keys()
        b = t.shape[1] // n_d
        for j in t.distinct():
            d = keys[j][1]
            clear(t.shards[j], empty[d * b:(d + 1) * b].to(
                t.shards[j].device))


def _in_mesh(rt: StageRuntime, mask) -> str | None:
    """Which in-mesh program a whole-sequence forward of the stage runs:
    ``"stage"`` (the GPipe over a stage axis above 1), ``"seq"`` (the
    ring over a seq axis above 1, when no padding mask comes with the
    op), or None."""
    if rt.mesh is None:
        return None
    axes = rt.stage.get("mesh_axes") or {}
    if int(axes.get("stage", 1)) > 1:
        return "stage"
    if int(axes.get("seq", 1)) > 1 and mask is None:
        return "seq"
    return None


def _stage_fwd_fn(rt: StageRuntime, cfg, mask, apply_head: bool,
                  batch: int, *, remat: bool = False):
    """The ``(params, x, mask, take=None) -> out`` function of this
    stage's layer slice (``x`` tokens on the first stage, else hidden
    states), the JAX worker's ``_stage_fwd_fn``. Dispatch, in order: a
    mesh with a ``stage`` axis runs the slice through the in-mesh GPipe
    (``parallel/pipeline.py``, ``pp_n_micro`` micro-batches, sized to
    this stage's mesh whatever the plan's ``n_micro``); a ``seq`` axis,
    with no padding mask, runs it sequence parallel with ring attention;
    else the plain stage forward. Each is differentiable; ``take`` reads
    a placed tree's pieces (the BACKWARD's reader)."""
    from tensorlink_tpu_torch.models.transformer import (
        _seq_stage,
        stage_forward,
    )
    from tensorlink_tpu_torch.parallel.pipeline import (
        pipelined_stage_forward,
        pp_n_micro,
    )

    first = bool(rt.stage["first"])
    kind = _in_mesh(rt, mask)

    def fwd(params, x, mask, take=None):
        kw = {"tokens": x} if first else {"hidden": x}
        if kind == "stage":
            out, _ = pipelined_stage_forward(
                params, cfg, rt.mesh, attn_mask=mask,
                n_micro=pp_n_micro(int(rt.mesh.shape["stage"]), batch),
                first=first, last=apply_head, remat=remat, take=take, **kw)
        elif kind == "seq":
            out, _ = _seq_stage(params, cfg, rt.mesh, first=first,
                                last=apply_head, remat=remat, take=take,
                                **kw)
        else:
            out, _ = stage_forward(params, cfg, attn_mask=mask,
                                   first=first, last=apply_head,
                                   remat=remat, **kw)
        return out

    return fwd


def _train_cfg(rt: StageRuntime):
    """The config a stage's TRAINING forwards and their BACKWARD
    recompute run: a MoE stage with an expert axis takes the
    capacity-factor sparse dispatch (``parallel/expert.py``), as the JAX
    worker does; eval forwards, decode sessions and the engine keep the
    exact dense dispatch, since a dropped token must never change served
    logits."""
    axes = rt.stage.get("mesh_axes") or {}
    if rt.cfg.moe and int(axes.get("expert", 1)) > 1:
        return rt.cfg.with_(moe_dispatch="sparse")
    return rt.cfg


def _host(t):
    """A tensor as a host numpy array (bfloat16 as its 16-bit payload
    under ``core/serialization.py::BFLOAT16``)."""
    from tensorlink_tpu_torch.engine.paged import host_array

    return host_array(t)


def _host_tree(tree):
    """Every tensor of nested dicts, tuples and lists on the host."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_host_tree(v) for v in tree)
    if isinstance(tree, list):
        return [_host_tree(v) for v in tree]
    if tree is None:
        return None
    return _host(tree)


def _quantized(tree) -> bool:
    """Whether a parameter tree holds weight-only int8 leaves."""
    from tensorlink_tpu_torch.models.quant import QTensor

    if isinstance(tree, dict):
        return any(_quantized(v) for v in tree.values())
    return isinstance(tree, QTensor)


__all__ = ["DistributedWorker", "StageRuntime"]
