"""DistributedModel — the caller's handle on a distributed job (port of
``tensorlink_tpu/ml/module.py``).

A user's job (``DistributedModel(model, training=...)`` through a
``UserNode``) or a validator-hosted model
(:meth:`DistributedModel.from_job`) attaches to a job the validator
planned and recruited: it connects to the job's worker, ships the stage
assignment (plan slice + model config + checkpoint reference or seed,
never code) and then generates, runs forwards, or trains:

- ``generate(..., continuous=True)`` on a single-request call joins the
  worker's running slot batch (``_generate_continuous_remote``), streamed
  token by token over the TOKEN relay when a ``stream_cb`` is given;
- every other call runs the worker's dense engine
  (``_generate_remote``: batched, beam, lookahead);
- ``forward`` returns the logits (or worker-sampled token ids). On a
  pipelined job (a model split by layers over several workers) one
  request drives the chain: each stage's worker ships its hidden state
  straight to the next (``_forward_chain``), looping back to stage 0 for
  a tied head, and ``session`` keeps each stage's KV cache between calls;
- ``generate`` on a pipelined job runs a host-driven decode over those
  session caches (``_generate_pipelined``; beam search and prompt-lookup
  speculation ride the same session), with each token sampled on the
  worker that holds the head;
- ``train_step`` runs each micro-batch's forward down the stages (the
  hidden state hops through this node, and a tied head's logits come
  from stage 0's head hop), the cross-entropy and its logits gradient
  here (on :attr:`device`), the backward up the stages, each passing the
  gradient of its input one stage back, then the optimizer step with the
  driver's clip folded into the scale. On a pipelined job the
  micro-batches overlap across the stages in driver threads;
  ``save_checkpoint``/``restore_checkpoint``, ``parameters`` and
  ``export_hf_checkpoint`` complete the surface.

Job repair: a dead worker is replaced through the validator
(``JOB_REPAIR``, or a pushed ``JOB_UPDATE``), its stage re-shipped, and a
training job rolled back to its last checkpoint. A lost decode session
re-prefills prompt + emitted tokens on the repaired stages; the sampler's
per-step keys make the resumed stream equal to the uninterrupted one.

Co-slice (merged-mesh) plans wait for ROADMAP queue 1 item 4 and raise
at attach. All waits are bounded (MAX_WAIT_TIME).
"""

from __future__ import annotations

import random
import secrets
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np

from tensorlink_tpu_torch import unported
from tensorlink_tpu_torch.core.logging import get_logger
from tensorlink_tpu_torch.p2p import protocol as proto

MAX_WAIT_TIME = 150.0  # reference ml/module.py:58

# retry envelope for worker RPCs (exponential backoff with jitter — the
# single bare retry this replaces would hammer a recovering worker and give
# up exactly when a second replacement was one more attempt away)
RETRY_ATTEMPTS = 4
BACKOFF_BASE_S = 0.1
BACKOFF_CAP_S = 5.0
# transport-failure signatures: errors cross the IPC bridge as RemoteError
# (stringified "TimeoutError: ..." / "ConnectionError: ...", nodes/ipc.py),
# so match on text as well as type
_TRANSPORT_SIGNS = (
    "TimeoutError", "ConnectionError", "no connection", "IncompleteReadError",
    "timed out",
)


def _transportish(e: BaseException) -> bool:
    return isinstance(e, (TimeoutError, ConnectionError)) or any(
        s in str(e) for s in _TRANSPORT_SIGNS
    )


class WorkerLost(RuntimeError):
    """A worker's connection died mid-request (or a migration redirect
    named an unreachable destination): the continuous path's recovery
    ladder decides what to re-issue where, and a training step re-drives
    from the last checkpoint (a transparent retry would apply a partial
    gradient)."""

    def __init__(self, worker_id: str | None, cause: BaseException):
        super().__init__(f"worker {str(worker_id)[:12]} lost: {cause}")
        self.worker_id = worker_id
        self.cause = cause


class SessionLost(WorkerLost):
    """A worker holding decode-session KV died mid-generate. A retry on a
    replacement would decode against an empty cache: the session is
    re-established by re-prefilling prompt + tokens emitted so far."""


def _any_nonzero(v) -> bool:
    """True when a scalar-or-per-row sampling knob has a nonzero entry
    (None counts as 0)."""
    vals = v if isinstance(v, (list, tuple, np.ndarray)) else [v]
    return any(float(x or 0.0) != 0.0 for x in vals)


def _head_result(resp: dict):
    """The terminal result of a head worker's FORWARD reply: sampled token
    ids, per-position argmax ids (speculative verify) or beam candidates
    ``(vals, idx)`` — None when it carries an array (``resp["out"]``)."""
    spans = resp.get("trace_spans")
    if isinstance(spans, dict):
        # session-op spans shipped home by the responding stage worker
        from tensorlink_tpu_torch.core.trace import get_tracer

        tracer = get_tracer()
        for tid, ss in spans.items():
            tracer.ingest(str(tid), ss or [])
    if "token" in resp:
        return np.asarray(resp["token"], np.int32)
    if "verify_ids" in resp:
        return np.asarray(resp["verify_ids"], np.int32)
    if "beam_vals" in resp:
        return np.asarray(resp["beam_vals"]), np.asarray(resp["beam_idx"])
    return None


class JobDeclinedError(RuntimeError):
    pass


class DistributedModel:
    def __init__(
        self,
        model: Any,  # preset name | ModelConfig | checkpoint dir
        node=None,
        *,
        training: bool = False,
        batch: int = 1,
        seq_len: int | None = None,
        n_micro: int | None = None,
        parallelism: dict[str, int] | None = None,
        seed: int = 0,
        ckpt: str | None = None,
        quant: str | None = None,  # "int8" | "int8+kv" quantized serving
        flash_attention: bool = False,  # flash prefill kernel on workers
        start_session: bool = True,
        ckpt_every_steps: int = 0,  # auto-checkpoint cadence (0 = off)
        ckpt_dir: str | None = None,  # auto-checkpoint target directory
        device=None,  # user-side tensors: None = the card, or "cpu"
        request_timeout: float = MAX_WAIT_TIME,
        retry_attempts: int = RETRY_ATTEMPTS,
        **node_kw,
    ):
        from tensorlink_tpu_torch.models.base import ModelConfig

        self.log = get_logger("ml.model")
        self._device_arg = device
        self._device = None
        if training:
            _ = self.device  # no card and no device="cpu": fail before the job
        self._owns_node = node is None
        if node is None:
            from tensorlink_tpu_torch.nodes.runners import UserNode

            node = UserNode(**node_kw).start()
        self.node = node
        self.training = training

        # model identity → job spec (resolution happens on the validator)
        if isinstance(model, ModelConfig):
            self.model_spec = {"name": "custom", "config": model.to_json()}
        elif isinstance(model, str) and ("/" in model or model.startswith(".")):
            self.model_spec = {"name": model, "ckpt": model}
        else:
            self.model_spec = {"name": str(model)}
        if ckpt:
            self.model_spec["ckpt"] = ckpt
        if quant:
            self.model_spec["quant"] = quant
        if flash_attention:
            self.model_spec["flash"] = True
        self.model_spec["seed"] = seed

        self.spec = {
            "model": self.model_spec,
            "batch": batch,
            "seq_len": seq_len or 2048,
            "training": training,
            "n_micro": n_micro,
            # explicit per-worker mesh axes (tensor/seq/stage/expert/...);
            # validated by the planner (parallel/planner._apply_mesh_hints)
            "parallelism": parallelism,
        }
        self.job_id: str | None = None
        self.plan = None
        self.cfg = None
        self.workers: dict[str, str] = {}  # worker plan id -> connected node id
        self.worker_addrs: dict[str, list] = {}  # worker id -> [host, port]
        self.chain_forwards = 0  # completed worker-to-worker chained calls
        self._repair_lock = threading.Lock()
        self._repaired: dict[str, str] = {}  # dead worker id -> replacement
        self._request_timeout = float(request_timeout)
        self._retry_attempts = max(int(retry_attempts), 1)
        # jitter source for retry backoff — seeded so chaos runs replay
        self._retry_rng = random.Random(seed)
        self._ckpt_every_steps = int(ckpt_every_steps)
        self._ckpt_dir = ckpt_dir
        if start_session:
            self._initialize_distribution()

    # ------------------------------------------------------------------
    # job setup (reference _initialize_distribution → distribute_model,
    # module.py:987-1021,699)
    # ------------------------------------------------------------------
    @classmethod
    def from_job(cls, node, job_result: dict, *, attach_only: bool = False,
                 **kw) -> "DistributedModel":
        """Attach to an already-created job (validator-hosted models: the
        validator plans + recruits itself — reference _initialize_hosted_job,
        ml/validator.py:901 — then drives the job through its own node).

        ``attach_only=True`` is the control-plane recovery handshake: the
        MODULE frames tell each worker to ACK an already-live stage
        instead of rebuilding it (a rebuild would kill every live slot),
        and the acks re-announce live/orphaned streams into
        ``self.attach_report`` for journal reconciliation."""
        model = cls(
            job_result["model"].get("name", "hosted"),
            node=node,
            start_session=False,
            **kw,
        )
        model._attach(job_result, attach_only=attach_only)
        return model

    def _initialize_distribution(self) -> None:
        reply = self.node.send_request(
            "request_job", {"spec": self.spec}, timeout=MAX_WAIT_TIME
        )
        if not reply.get("accepted"):
            raise JobDeclinedError(str(reply.get("error", reply)))
        self._attach(reply)

    def _attach(self, reply: dict, attach_only: bool = False) -> None:
        from tensorlink_tpu_torch.models.base import ModelConfig
        from tensorlink_tpu_torch.parallel.planner import ShardingPlan

        #: wid -> {"attached", "live_slots", "orphans"} from attach_only
        #: re-handshakes (empty on a normal attach)
        self.attach_report: dict[str, dict] = {}
        self.job_id = reply["job_id"]
        self.plan = ShardingPlan.from_json(reply["plan"])
        self.model_spec = reply.get("model", self.model_spec)
        self.cfg = ModelConfig.from_json(self.model_spec["config"])
        if any(s.coworkers for s in self.plan.stages):
            raise unported("a co-slice merged job (coworkers)", 4)

        # connect to each stage's worker and ship its stage
        for stage in self.plan.stages:
            wid = stage.worker_id
            if wid in self.workers:
                continue
            if wid not in reply["workers"]:
                raise RuntimeError(
                    f"job reply has no address for worker {wid[:8]}"
                )
            host, port = reply["workers"][wid]
            self.workers[wid] = self.node.connect_to(host, int(port))
            self.worker_addrs[wid] = [host, int(port)]
        for stage in self.plan.stages:
            body = {
                "job_id": self.job_id,
                "model": self.model_spec,
                "stage": _stage_dict(stage),
                "training": self.training,
            }
            if attach_only:
                body["attach_only"] = True
            resp = self._request(
                stage.worker_id, proto.MODULE, body, timeout=MAX_WAIT_TIME,
            )
            if not resp.get("ok"):
                raise RuntimeError(f"stage load failed: {resp}")
            if attach_only:
                self.attach_report[stage.worker_id] = {
                    "attached": bool(resp.get("attached", False)),
                    "live_slots": int(resp.get("live_slots", 0) or 0),
                    "orphans": list(resp.get("orphans", []) or []),
                }
        self.log.info(
            "job %s distributed over %d stage(s)",
            self.job_id[:8], self.plan.n_stages,
        )

    def _backoff_delay(self, attempt: int) -> float:
        """Exponential backoff with jitter: base·2^(k-1), capped, scaled by
        a seeded uniform in [0.5, 1.5) so synchronized retry storms from
        concurrent driver threads decorrelate."""
        base = min(BACKOFF_BASE_S * 2 ** (attempt - 1), BACKOFF_CAP_S)
        return base * self._retry_rng.uniform(0.5, 1.5)

    def _request(
        self, worker_plan_id: str, tag: str, body: dict, timeout=None,
        _repaired: bool = False,
    ):
        """One worker RPC with a bounded retry envelope.

        - Transport timeouts retry the SAME worker with exponential backoff
          — but only when the op is idempotent (it carries a session ``seq``,
          which the worker dedups, ml/worker.py::_session_dup); anything
          else could double-apply.
        - A dead connection on a stateless op pulls a replacement from the
          validator (:meth:`_repair`) and retries there.
        - A dead connection on a SESSION op raises :class:`SessionLost`:
          the replacement has no KV, so the generate loop re-establishes
          the session (re-prefill) instead of retrying the RPC.
        - A dead connection mid-training-step (optimizer initialized)
          raises :class:`WorkerLost`: the step's inputs and gradients died
          with the worker, so ``train_step`` re-drives the whole step from
          the last checkpoint instead of applying a partial gradient.
        - ``_repaired``: one attempt, no repair (the continuous path runs
          its own recovery ladder; repair re-ships through it).
        """
        timeout = self._request_timeout if timeout is None else timeout
        session_op = tag == proto.FORWARD and body.get("session") is not None
        idempotent = body.get("seq") is not None
        attempts = 1 if _repaired else self._retry_attempts
        worker = worker_plan_id
        resp = None
        for attempt in range(attempts):
            if attempt:
                time.sleep(self._backoff_delay(attempt))
            try:
                resp = self.node.send_request(
                    "tensor_request",
                    {
                        "peer": self.workers[worker],
                        "tag": tag,
                        "body": body,
                        "timeout": timeout,
                    },
                    timeout=timeout + 10.0,
                )
            except Exception as e:
                if _repaired:
                    raise
                conn_lost = "no connection" in str(e)
                if conn_lost and session_op:
                    raise SessionLost(worker, e) from e
                if conn_lost and getattr(self, "_opt_ready", False) \
                        and getattr(self, "_step_active", False):
                    raise WorkerLost(worker, e) from e
                if conn_lost:
                    if attempt == attempts - 1:
                        raise
                    worker = self._repair(worker)
                    continue
                if idempotent and _transportish(e) and attempt < attempts - 1:
                    self.log.warning(
                        "%s to %s timed out (attempt %d); retrying "
                        "(seq-idempotent)", tag, worker[:8], attempt + 1,
                    )
                    continue
                raise
            break
        if isinstance(resp, dict) and resp.get("error"):
            # chained hops attribute the failing worker (ml/worker.py run
            # loop ships "worker" alongside the error)
            who = str(resp.get("worker", ""))[:12]
            raise RuntimeError(
                f"{tag} failed on worker{' ' + who if who else ''}: "
                f"{resp['error']}"
            )
        return resp

    # ------------------------------------------------------------------
    # worker replacement (pulled by the user through JOB_REPAIR; the
    # validator's monitor may also push a JOB_UPDATE,
    # platform/job_monitor.py)
    # ------------------------------------------------------------------
    def _repair(self, dead_plan_wid: str) -> str:
        """Ask the validator for a replacement, connect, re-ship the stage.
        Returns the new plan worker id; raises if none is available.

        Concurrent requests can all hit the same dead worker: the repair
        lock serializes them, and the repair map makes followers reuse the
        first thread's replacement instead of recruiting again."""
        with self._repair_lock:
            fixed = self._chase_repaired(dead_plan_wid)
            if fixed:
                return fixed
            return self._repair_locked(dead_plan_wid)

    # tlint: holds-lock(self._repair_lock)
    def _chase_repaired(self, dead_plan_wid: str) -> str | None:
        """Resolve chained repairs (A→B then B→C): a straggler holding the
        oldest id lands on the live replacement. None when this id was
        never repaired. The caller holds ``_repair_lock``."""
        fixed = self._repaired.get(dead_plan_wid)
        if not fixed:
            return None
        seen = {dead_plan_wid}
        while fixed in self._repaired and fixed not in seen:
            seen.add(fixed)
            fixed = self._repaired[fixed]
        return fixed

    # tlint: holds-lock(self._repair_lock)
    def _repair_locked(self, dead_plan_wid: str) -> str:
        validators = self.node.send_request("validators", timeout=10.0)
        if not validators:
            raise RuntimeError("no validator available for job repair")
        update = self.node.send_request(
            "control_request",
            {"peer": validators[0], "tag": proto.JOB_REPAIR,
             "body": {"job_id": self.job_id, "worker_id": dead_plan_wid},
             "timeout": 15.0},
            timeout=25.0,
        )
        if not isinstance(update, dict) or "worker" not in update:
            # the validator's monitor may have beaten this pull to the
            # same dead worker (its replacement already rewrote the plan,
            # so the pull finds no stage to fix): apply the pushed
            # JOB_UPDATEs waiting in our buffer and reuse that replacement
            # (inline, not poll_job_updates(): we hold _repair_lock)
            try:
                for u in self.node.send_request("job_updates", timeout=10.0):
                    if u.get("job_id") == self.job_id and "worker" in u:
                        old = u.get("old_worker", "")
                        if old in self.workers and old not in self._repaired:
                            self._apply_update(u, old)
            except Exception as e:
                self.log.debug("job_updates scan during repair failed: %s", e)
            fixed = self._chase_repaired(dead_plan_wid)
            if fixed:
                return fixed
            err = update.get("error") if isinstance(update, dict) else update
            raise RuntimeError(f"job repair failed: {err}")
        return self._apply_update(update, dead_plan_wid)

    def _apply_update(self, update: dict, dead_plan_wid: str) -> str:
        """Point every stage of the dead worker at its replacement: connect,
        re-ship the MODULE and, for a training job, re-init the optimizer
        there and roll EVERY stage back to the last checkpoint (a fresh
        replacement beside trained survivors would mix parameter
        versions), with the model's step counter reset from the
        checkpoint's manifest."""
        new_id = update["worker"]["id"]
        host, port = update["worker"]["addr"]
        conn_id = self.node.connect_to(host, int(port))
        self.worker_addrs[new_id] = [host, int(port)]
        # order matters for concurrent readers: the new mapping exists
        # before any stage names it; the old one stays (its connection is
        # dead, so a straggler on it re-enters repair and finds the
        # recorded replacement)
        self.workers[new_id] = conn_id
        affected = [
            s for s in self.plan.stages if s.worker_id == dead_plan_wid
        ]
        for s in affected:
            s.worker_id = new_id
        self._repaired[dead_plan_wid] = new_id
        for s in affected:
            resp = self._request(
                new_id, proto.MODULE,
                {
                    "job_id": self.job_id,
                    "model": self.model_spec,
                    "stage": _stage_dict(s),
                    "training": self.training,
                },
                timeout=MAX_WAIT_TIME, _repaired=True,
            )
            if not resp.get("ok"):
                raise RuntimeError(f"replacement stage load failed: {resp}")
        if getattr(self, "_opt_ready", False):
            self._request(
                new_id, proto.OPTIMIZER,
                {"job_id": self.job_id, "op": "init",
                 "spec": {"name": getattr(self, "_opt_name", "adamw"),
                          "grad_clip": None,
                          **getattr(self, "_opt_spec", {})}},
                _repaired=True,
            )
            if getattr(self, "_last_ckpt", None):
                self._roll_back_to_checkpoint()
            elif getattr(self, "_step", 0) > 0:
                raise RuntimeError(
                    "worker replaced mid-training with no checkpoint to roll "
                    "back to: trained state on surviving stages is "
                    "inconsistent with the fresh replacement stage — set "
                    "ckpt_every_steps (auto-checkpoint) or call "
                    "save_checkpoint() periodically to make repair lossless"
                )
        self.log.info(
            "repaired job %s: %s -> %s", self.job_id[:8],
            dead_plan_wid[:8], new_id[:8],
        )
        return new_id

    def _roll_back_to_checkpoint(self) -> None:
        """Restore every stage from ``_last_ckpt`` and set the model's
        step counter to the checkpoint's, so a repaired job loses at most
        ``ckpt_every_steps`` steps, in its accounting too."""
        import json
        from pathlib import Path

        for s in self.plan.stages:
            self._request(
                s.worker_id, proto.CHECKPOINT,
                {"job_id": self.job_id, "op": "restore",
                 "dir": self._last_ckpt},
                _repaired=True,
            )
        try:
            manifest = json.loads(
                (Path(self._last_ckpt) / "manifest.json").read_text()
            )
            self._step = int(manifest.get("step", getattr(self, "_step", 0)))
        except Exception as e:
            self.log.warning(
                "checkpoint manifest %s unreadable: %s", self._last_ckpt, e,
            )

    def poll_job_updates(self) -> int:
        """Apply validator-pushed replacements (the monitor path); returns
        how many were applied."""
        updates = self.node.send_request("job_updates", timeout=10.0)
        n = 0
        for u in updates:
            if u.get("job_id") == self.job_id and "worker" in u:
                old = u.get("old_worker", "")
                with self._repair_lock:
                    if old in self.workers and old not in self._repaired:
                        self._apply_update(u, old)
                        n += 1
        return n

    def _repair_dead_stages(self) -> None:
        """Repair every stage whose worker connection is gone."""
        live = set(self.node.send_request("peers", timeout=10.0))
        for st in self.plan.stages:
            if self.workers.get(st.worker_id) not in live:
                self._repair(st.worker_id)

    @property
    def device(self):
        """Where the user-side tensors live (the card unless the model was
        made with ``device="cpu"``); resolved at first use."""
        if self._device is None:
            from tensorlink_tpu_torch.core.devices import resolve_device

            self._device = resolve_device(self._device_arg)
        return self._device

    # ------------------------------------------------------------------
    # forward (reference module.py:348-411 + OffloadedModule.forward:1536)
    # ------------------------------------------------------------------
    def forward(
        self,
        tokens,  # int [B, T]
        attn_mask=None,
        *,
        session: str | None = None,
        cache_len: int | None = None,
        sample: dict | None = None,
        last_idx=None,
        reorder_idx=None,
        reset_len: int | None = None,
        reset_rows: Sequence[int] | None = None,
        seq: int | None = None,
        trace: Sequence[str] | None = None,
    ):
        """Chain the stages: the logits ``[B, T, V]`` as a tensor on
        :attr:`device`, or with ``sample`` ({temperature, top_k, top_p,
        seed, step}) one token id per row sampled on the head's worker (an
        int32 numpy array; ``last_idx`` names each row's final real
        position). ``sample`` may instead ask for per-position argmax ids
        (``verify``) or beam candidates (``beam_k``).

        ``session`` keeps each stage's KV cache alive on its worker
        between calls (decode), ``seq`` numbers its ops so a duplicated
        or retried frame never applies twice, and ``reorder_idx`` (beam
        search), ``reset_len`` (speculative rollback) and ``reset_rows``
        (slot recycling) edit the cached session before this op's
        writes. ``trace`` names the requests this op admits."""
        from tensorlink_tpu_torch.engine.paged import device_tensor

        assert self.plan is not None
        x = np.asarray(_host_ids(tokens), np.int32)
        body_common: dict[str, Any] = {"job_id": self.job_id}
        if session is not None:
            body_common["session"] = session
            body_common["cache_len"] = cache_len or self.spec["seq_len"]
            if seq is not None:
                body_common["seq"] = int(seq)
        if reorder_idx is not None:
            body_common["reorder_idx"] = np.asarray(reorder_idx, np.int32)
        if reset_len is not None:
            body_common["reset_len"] = int(reset_len)
        if reset_rows:
            body_common["reset_rows"] = [int(r) for r in reset_rows]
        if trace:
            body_common["trace"] = [str(t) for t in trace if t]
        if attn_mask is not None:
            body_common["attn_mask"] = np.asarray(_host_ids(attn_mask), bool)

        def samp_body(base: dict) -> dict:
            if sample is not None:
                base["sample"] = sample
                if last_idx is not None:
                    base["last_idx"] = np.asarray(_host_ids(last_idx),
                                                  np.int32)
            return base

        def result(resp: dict):
            res = _head_result(resp)
            if res is not None:
                return res
            return device_tensor(resp["out"], self.device)

        if len(self.plan.stages) > 1 and all(
            s.worker_id in self.worker_addrs for s in self.plan.stages
        ):
            # worker-to-worker chain: ONE request; activations hop
            # straight between the stage workers and only the final result
            # returns here. A stateless call falls back to the per-hop path
            # (which repairs workers) on a transport failure; a session
            # call raises SessionLost — a mid-chain stage may already have
            # absorbed this op's KV writes, so the generate loop
            # re-establishes the session instead.
            try:
                return result(self._forward_chain(x, body_common, samp_body))
            except SessionLost:
                raise
            except Exception as e:
                if not _transportish(e):
                    raise
                if session is not None:
                    raise SessionLost(None, e) from e
                self.log.warning(
                    "chained forward failed (%s); per-hop fallback", e
                )

        last = self.plan.stages[-1]
        head_on_last = last.last and last.holds_head
        out = None
        for stage in self.plan.stages:
            body = dict(body_common, op="stage")
            if stage.first:
                body["tokens"] = x
            else:
                body["hidden"] = out
            if head_on_last and stage is last:
                body = samp_body(body)
            resp = self._request(stage.worker_id, proto.FORWARD, body)
            if head_on_last and stage is last:
                return result(resp)
            out = resp["out"]
        head_stage = next(s for s in self.plan.stages if s.holds_head)
        resp = self._request(
            head_stage.worker_id, proto.FORWARD,
            samp_body({"job_id": self.job_id, "op": "head", "hidden": out}),
        )
        return result(resp)

    def _forward_chain(self, x, body_common: dict, samp_body) -> dict:
        """One request drives the whole pipeline: each stage's worker
        computes its slice and ships the hidden state DIRECTLY to the next
        stage's worker (nodes/roles.py::cmd_chain_send); the final hop
        (the head holder — stage 0 again for a tied head) answers this
        user. Per token that is stages + 1 one-way transfers instead of
        2 x stages, and the activations never cross the user's link.
        Returns the final hop's reply."""
        stages = self.plan.stages
        entries = [
            {"addr": list(self.worker_addrs[s.worker_id]), "head": False}
            for s in stages[1:]
        ]
        last = stages[-1]
        if not (last.last and last.holds_head):
            head_stage = next(s for s in stages if s.holds_head)
            entries.append(
                {"addr": list(self.worker_addrs[head_stage.worker_id]),
                 "head": True}
            )
        body = samp_body(dict(
            body_common, op="chain", chain=entries,
            reply_to=self.node.node_id, tokens=x,
        ))
        # session chains retry safely through _request: every hop dedups
        # on the op's seq and re-drives its cached output downstream, so a
        # retry after a lost reply reaches the final hop without any stage
        # re-absorbing KV writes; a dead worker raises SessionLost
        resp = self._request(stages[0].worker_id, proto.FORWARD, body)
        self.chain_forwards += 1
        return resp

    __call__ = forward

    # ------------------------------------------------------------------
    # training (reference module.py:414-524; explicit tags and
    # token-weighted accumulation, engine/training.py::make_train_step)
    # ------------------------------------------------------------------
    def _train_forward(self, tokens, attn_mask, tag: str):
        """The forward down the stages with ``train=True``: each worker
        keeps its inputs under ``tag``, and a tied head's logits come from
        stage 0's head hop. Returns the logits as a tensor on
        :attr:`device`."""
        from tensorlink_tpu_torch.engine.paged import device_tensor

        out = None
        for stage in self.plan.stages:
            body = {"job_id": self.job_id, "op": "stage", "train": True,
                    "tag": tag}
            if attn_mask is not None:
                body["attn_mask"] = np.asarray(attn_mask, bool)
            if stage.first:
                body["tokens"] = np.asarray(tokens, np.int32)
            else:
                body["hidden"] = out
            out = self._request(stage.worker_id, proto.FORWARD, body)["out"]
        head_stage = self._head_hop_stage()
        if head_stage is not None:
            out = self._request(
                head_stage.worker_id, proto.FORWARD,
                {"job_id": self.job_id, "op": "head", "hidden": out,
                 "train": True, "tag": tag},
            )["out"]
        return device_tensor(out, self.device)

    def _head_hop_stage(self):
        """The stage that holds a tied head away from the last stage
        (stage 0), or None when the last stage applies the head itself."""
        last = self.plan.stages[-1]
        if last.last and last.holds_head:
            return None
        return next(s for s in self.plan.stages if s.holds_head)

    def _train_backward(self, dlogits, tag: str) -> None:
        """The cotangents up the stages, last to first (the head hop first
        when the head lives on stage 0), each stage passing on the
        gradient of its input."""
        g = dlogits
        head_stage = self._head_hop_stage()
        if head_stage is not None:
            g = self._request(
                head_stage.worker_id, proto.BACKWARD,
                {"job_id": self.job_id, "op": "head", "tag": tag, "grad": g},
            )["grad"]
        for stage in reversed(self.plan.stages):
            resp = self._request(
                stage.worker_id, proto.BACKWARD,
                {"job_id": self.job_id, "op": "stage", "tag": tag,
                 "grad": g},
            )
            if "grad" in resp:
                g = resp["grad"]

    def init_optimizer(self, name: str = "adamw", **spec) -> None:
        """Send the optimizer spec to every stage. The driver clips, not
        the stages: they get ``grad_clip=None`` and :meth:`optimizer_step`
        folds ``min(1, clip / global_norm)`` into the step's scale."""
        self._grad_clip = spec.pop("grad_clip", 1.0)
        self._opt_name, self._opt_spec = name, dict(spec)
        for stage in self.plan.stages:
            self._request(
                stage.worker_id, proto.OPTIMIZER,
                {"job_id": self.job_id, "op": "init",
                 "spec": {"name": name, "grad_clip": None, **spec}},
            )
        self._opt_ready = True

    def _global_grad_norm(self, scale: float = 1.0) -> float:
        sq = 0.0
        for stage in self.plan.stages:
            resp = self._request(
                stage.worker_id, proto.OPTIMIZER,
                {"job_id": self.job_id, "op": "grad_norm"},
            )
            sq += float(resp.get("grad_norm", 0.0)) ** 2
        return (sq**0.5) * scale

    def optimizer_step(self, scale: float = 1.0) -> dict:
        """Apply the accumulated gradients on every stage; returns the
        global norm of the scaled, pre-clip gradients (the number the
        compiled train step reports)."""
        gnorm = self._global_grad_norm(scale)
        final_scale = scale
        clip = getattr(self, "_grad_clip", None)
        if clip and gnorm > clip:
            final_scale = scale * clip / gnorm
        self._opt_step_partial = True
        for stage in self.plan.stages:
            self._request(
                stage.worker_id, proto.OPTIMIZER,
                {"job_id": self.job_id, "op": "step", "scale": final_scale},
            )
        self._opt_step_partial = False
        return {"grad_norm": gnorm}

    def zero_grad(self) -> None:
        for stage in self.plan.stages:
            self._request(stage.worker_id, proto.OPTIMIZER,
                          {"job_id": self.job_id, "op": "zero"})

    def train_step(
        self,
        tokens,  # int [B, T]
        loss_mask=None,  # bool [B, T]
        attn_mask=None,
        *,
        step_optimizer: bool = True,
        overlap: bool = True,
    ) -> dict:
        """One durable training step (:meth:`_train_step_once`). When a
        worker dies mid-step (:class:`WorkerLost`),
        :meth:`_recover_training` repairs the dead stages — the
        replacement and every survivor restore params and optimizer state
        from ``_last_ckpt`` and the step counter rolls back to it — and the
        step is re-driven from clean gradients, so a crash loses at most
        ``ckpt_every_steps`` steps, never a partial gradient. Every
        ``ckpt_every_steps`` optimizer steps the job checkpoints itself."""
        self._step_active = True
        try:
            for attempt in range(2):
                try:
                    out = self._train_step_once(
                        tokens, loss_mask, attn_mask,
                        step_optimizer=step_optimizer, overlap=overlap,
                    )
                    break
                except Exception as e:
                    if attempt or not (
                        isinstance(e, WorkerLost) or _transportish(e)
                    ):
                        raise
                    self.log.warning(
                        "training step lost a worker (%s); repairing and "
                        "re-driving the step from the last checkpoint", e,
                    )
                    self._recover_training()
        finally:
            self._step_active = False
        if (
            step_optimizer and self._ckpt_every_steps > 0
            and self._step % self._ckpt_every_steps == 0
        ):
            self.save_checkpoint(self._auto_ckpt_dir())
        return out

    def _auto_ckpt_dir(self) -> str:
        if self._ckpt_dir is None:
            import tempfile
            from pathlib import Path

            d = Path(tempfile.gettempdir()) / f"tltpu_ckpt_{self.job_id[:12]}"
            self._ckpt_dir = str(d)
        return self._ckpt_dir

    def _recover_training(self) -> None:
        """Repair every stage whose worker connection died (each repair
        re-ships the stage and restores the last checkpoint on ALL stages,
        :meth:`_apply_update`), then clear half-accumulated gradients
        everywhere so the re-driven step starts clean.

        If the failed step had begun fanning out its OPTIMIZER "step" ops
        (``_opt_step_partial``), some stages may hold the update and others
        not — re-driving on that mixed state would apply a second update on
        the fast stages. So every stage rolls back to the last checkpoint
        first, and with no checkpoint the recovery refuses."""
        self._repair_dead_stages()
        if getattr(self, "_opt_step_partial", False):
            if not getattr(self, "_last_ckpt", None):
                raise RuntimeError(
                    "optimizer step failed after possibly applying updates "
                    "on some stages, and no checkpoint exists to roll back "
                    "to — set ckpt_every_steps (auto-checkpoint) to make "
                    "this recoverable"
                )
            self._roll_back_to_checkpoint()
            self._opt_step_partial = False
        self.zero_grad()

    def _train_step_once(
        self,
        tokens,  # int [B, T]
        loss_mask=None,  # bool [B, T]
        attn_mask=None,
        *,
        step_optimizer: bool = True,
        overlap: bool = True,
    ) -> dict:
        """One token-weighted causal-LM step over the job: per micro-batch
        a train forward, the cross-entropy's sum and its logits gradient
        here (:func:`_ce_sum_and_grad`), and a backward; then the optimizer
        with ``scale = 1 / total tokens`` — the compiled
        ``engine.training.make_train_step`` within float rounding.

        ``overlap`` runs the micro-batches of a pipelined job in driver
        threads, at most ``n_stages + 1`` in flight: each worker takes its
        queue in order, so micro ``m + 1`` occupies stage 0 while micro
        ``m`` is on stage 1, and each worker keeps the inputs of a bounded
        number of micro-batches. The gradients accumulate as sums, so the
        order in which the BACKWARDs arrive changes the result only in
        float summation order."""
        from tensorlink_tpu_torch.engine.paged import host_array

        assert self.plan is not None
        tokens = np.asarray(_host_ids(tokens), np.int32)
        if loss_mask is not None:
            loss_mask = np.asarray(_host_ids(loss_mask), bool)
        if attn_mask is not None:
            attn_mask = np.asarray(_host_ids(attn_mask), bool)
        B = tokens.shape[0]
        n_micro = self.plan.n_micro if B % max(self.plan.n_micro, 1) == 0 \
            else 1
        mb = B // n_micro
        self._step = getattr(self, "_step", 0) + 1

        def micro_mask(m: int):
            sl = slice(m * mb, (m + 1) * mb)
            am = attn_mask[sl] if attn_mask is not None else None
            lm = loss_mask[sl] if loss_mask is not None else (
                am if am is not None else np.ones_like(tokens[sl], bool)
            )
            return sl, am, np.asarray(lm, bool)

        total_tok = max(
            float(sum(micro_mask(m)[2][:, 1:].sum() for m in range(n_micro))),
            1.0,
        )
        def run_micro(m: int) -> float:
            sl, am, lm = micro_mask(m)
            tag = f"s{self._step}m{m}"
            logits = self._train_forward(tokens[sl], am, tag)
            nll_sum, dlogits, _ = _ce_sum_and_grad(logits, tokens[sl], lm)
            self._train_backward(host_array(dlogits), tag)
            return float(nll_sum)

        if overlap and n_micro > 1 and self.plan.n_stages > 1:
            from concurrent.futures import ThreadPoolExecutor

            in_flight = min(n_micro, self.plan.n_stages + 1)
            with ThreadPoolExecutor(max_workers=in_flight) as pool:
                total_nll = sum(pool.map(run_micro, range(n_micro)))
        else:
            total_nll = sum(run_micro(m) for m in range(n_micro))

        out = {"loss": total_nll / total_tok, "n_tokens": int(total_tok),
               "n_micro": n_micro}
        if step_optimizer:
            if not getattr(self, "_opt_ready", False):
                raise RuntimeError("call init_optimizer() before train_step()")
            out.update(self.optimizer_step(scale=1.0 / total_tok))
        return out

    # ------------------------------------------------------------------
    # checkpoints and parameters
    # ------------------------------------------------------------------
    def save_checkpoint(self, ckpt_dir: str) -> dict:
        """Each stage writes its params and optimizer state under
        ``ckpt_dir``; a manifest records the model, the plan and the
        step."""
        import json
        from pathlib import Path

        paths = []
        for stage in self.plan.stages:
            resp = self._request(
                stage.worker_id, proto.CHECKPOINT,
                {"job_id": self.job_id, "op": "save", "dir": str(ckpt_dir)},
            )
            paths.append(resp["path"])
        manifest = {
            "model": {k: v for k, v in self.model_spec.items()},
            "plan": self.plan.to_json(),
            "step": getattr(self, "_step", 0),
        }
        Path(ckpt_dir).mkdir(parents=True, exist_ok=True)
        (Path(ckpt_dir) / "manifest.json").write_text(
            json.dumps(manifest, indent=2))
        self._last_ckpt = str(ckpt_dir)
        return {"paths": paths}

    def restore_checkpoint(self, ckpt_dir: str) -> None:
        for stage in self.plan.stages:
            self._request(
                stage.worker_id, proto.CHECKPOINT,
                {"job_id": self.job_id, "op": "restore", "dir": str(ckpt_dir)},
            )

    def export_hf_checkpoint(self, out_dir: str):
        """Download the stages' params, merge them, and write an HF-layout
        safetensors checkpoint (``engine/loader.py::export_hf``)."""
        from tensorlink_tpu_torch.engine.loader import export_hf
        from tensorlink_tpu_torch.engine.optimizers import tree_map
        from tensorlink_tpu_torch.engine.paged import device_tensor

        merged = self._merge_stage_params(self.parameters())
        tree = tree_map(lambda a: device_tensor(a, "cpu"), merged)
        return export_hf(self.cfg, tree, out_dir)

    def _merge_stage_params(self, trees: list[dict]) -> dict:
        full: dict = {}
        layer_trees = []
        for stage, tree in zip(self.plan.stages, trees):
            if stage.first and "embed" in tree:
                full["embed"] = tree["embed"]
            if stage.holds_head:
                if "final_norm" in tree:
                    full["final_norm"] = tree["final_norm"]
                if "lm_head" in tree:
                    full["lm_head"] = tree["lm_head"]
                if "embed" in tree and "embed" not in full:
                    full["embed"] = tree["embed"]
            if "layers" in tree:
                layer_trees.append(tree["layers"])

        def cat(*xs):
            if isinstance(xs[0], dict):
                return {k: cat(*(x[k] for x in xs)) for k in xs[0]}
            return np.concatenate(xs, axis=0)

        full["layers"] = cat(*layer_trees)
        return full

    def parameters(self) -> list[dict]:
        """Each stage's parameter tree from its worker, as host numpy
        arrays (bfloat16 as ``core/serialization.py::BFLOAT16``)."""
        out = []
        for stage in self.plan.stages:
            resp = self._request(stage.worker_id, proto.PARAMS_REQ,
                                 {"job_id": self.job_id})
            out.append(resp["params"])
        return out

    # ------------------------------------------------------------------
    # generate (reference module.py:763-769, OffloadedModule.generate:1496)
    # ------------------------------------------------------------------
    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        *,
        max_new_tokens: int = 64,
        temperature: float | Sequence[float] = 0.0,
        top_k: int | Sequence[int] = 0,
        top_p: float | Sequence[float] = 1.0,
        eos_ids: Sequence[int] = (),
        seed: int = 0,
        stream_cb: Callable[[list[int | None]], None] | None = None,
        budgets: Sequence[int] | None = None,
        reuse_prefix: bool = False,
        lookahead: bool = False,
        presence_penalty: float | Sequence[float] = 0.0,
        frequency_penalty: float | Sequence[float] = 0.0,
        num_beams: int = 1,
        info_out: dict | None = None,
        continuous: bool = False,
        priority: str | None = None,
        trace_id: str | None = None,
        speculative: bool = False,
        handoff: bool = True,
        jrid: str = "",
    ) -> list[list[int]]:
        """``reuse_prefix`` (B=1, single-stage): the worker's engine seeds
        the cache from the longest stored prompt prefix and prefills only
        the suffix — conversation turns re-pay just the delta.

        ``stream_cb`` receives, per decode step, one new token per row
        (None for rows already finished) — the engine's contract. Sampling
        knobs may be per-row sequences and ``budgets`` caps rows
        individually (both used by the serving batcher, ml/batching.py, to
        mix concurrent requests in one decode) — on a single-stage job
        through the worker engine's bucketed batch, on a pipelined job
        through the head worker's per-row sampler."""
        if self.plan is None:
            raise RuntimeError("the model is not attached to a job")
        prompts = [list(p) for p in prompts]
        if self.plan.n_stages > 1:
            return self._generate_staged(
                prompts, max_new_tokens=max_new_tokens,
                temperature=temperature, top_k=top_k, top_p=top_p,
                eos_ids=eos_ids, seed=seed, stream_cb=stream_cb,
                budgets=budgets, lookahead=lookahead,
                presence_penalty=presence_penalty,
                frequency_penalty=frequency_penalty, num_beams=num_beams,
            )
        if (
            continuous
            and len(prompts) == 1
            and int(num_beams) <= 1
            and not lookahead
            and not any(
                isinstance(v, (list, tuple))
                for v in (temperature, top_k, top_p,
                          presence_penalty, frequency_penalty)
            )
        ):
            # continuous batching: this request joins the worker's
            # RUNNING slot batch instead of dispatching a static batch
            return self._generate_continuous_remote(
                prompts[0], max_new_tokens=int(max_new_tokens),
                temperature=float(temperature), top_k=int(top_k),
                top_p=float(top_p), eos_ids=eos_ids, seed=int(seed),
                stream_cb=stream_cb,
                presence_penalty=float(presence_penalty or 0.0),
                frequency_penalty=float(frequency_penalty or 0.0),
                priority=priority,
                trace_id=str(trace_id or ""),
                speculative=bool(speculative),
                handoff=bool(handoff),
                jrid=str(jrid or ""),
            )
        return self._generate_remote(
            prompts, max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, eos_ids=eos_ids, seed=seed,
            stream_cb=stream_cb, budgets=budgets,
            reuse_prefix=reuse_prefix, lookahead=lookahead,
            presence_penalty=presence_penalty,
            frequency_penalty=frequency_penalty,
            num_beams=num_beams, info_out=info_out,
        )

    def _generate_remote(
        self, prompts, *, max_new_tokens, temperature, top_k, top_p,
        eos_ids, seed, stream_cb, budgets=None, reuse_prefix=False,
        lookahead=False, presence_penalty=0.0, frequency_penalty=0.0,
        num_beams=1, info_out=None,
    ) -> list[list[int]]:
        """Whole model on one worker → its compiled engine does the loop."""
        stage = self.plan.stages[0]
        def _wire(v):
            return list(v) if isinstance(v, (list, tuple)) else v
        body = {
            "job_id": self.job_id,
            "prompts": [list(map(int, p)) for p in prompts],
            "max_new_tokens": max_new_tokens,
            "num_beams": int(num_beams),
            "presence_penalty": _wire(presence_penalty),
            "frequency_penalty": _wire(frequency_penalty),
            "temperature": _wire(temperature),
            "top_k": _wire(top_k),
            "top_p": _wire(top_p),
            "eos_ids": list(eos_ids),
            "seed": seed,
        }
        if budgets:
            body["budgets"] = [int(b) for b in budgets]
        if reuse_prefix:
            body["reuse_prefix"] = True
        if lookahead:
            body["lookahead"] = True
        stream_id = None
        if stream_cb is not None:
            stream_id = secrets.token_hex(8)
            body["stream"] = stream_id

        if stream_id is None:
            resp = self._request(stage.worker_id, proto.GENERATE, body)
            # response metadata (e.g. the worker's num_beams clamp) fills
            # the CALLER's dict — an attribute on self would race the
            # batcher thread, which drives concurrent generates on this
            # same model without job.lock
            if info_out is not None:
                info_out.update(
                    {k: resp[k] for k in ("num_beams_used",) if k in resp}
                )
            return [list(map(int, s)) for s in resp["sequences"]]

        # streaming: issue the request in a thread so we can drain tokens
        result: dict = {}

        def issue():
            try:
                result["resp"] = self._request(stage.worker_id, proto.GENERATE, body)
            except Exception as e:  # surfaced after the stream drains
                result["err"] = e

        t = threading.Thread(target=issue, daemon=True)
        t.start()
        B = len(prompts)
        cancelled: set[int] = set()
        notified: set[int] = set()
        drained: list[list[int]] = [[] for _ in range(B)]

        def feed(row_map: dict[int, int]) -> None:
            for i, tk_ in row_map.items():
                if 0 <= i < B:
                    drained[i].append(int(tk_))
            cancel = stream_cb([row_map.get(i) for i in range(B)])
            cancelled.update(int(i) for i in cancel or ())

        def push_cancels() -> None:
            # confirmed stop-sequence matches ride back to the worker as a
            # STREAM_CANCEL control frame; its compiled chunked decode polls
            # them at chunk boundaries and stops those rows early — overrun
            # past a stop is ≤ one chunk instead of the full token budget
            new = cancelled - notified
            if not new:
                return
            notified.update(new)
            try:
                self.node.send_request(
                    "send_control",
                    {"peer": self.workers[stage.worker_id],
                     "tag": proto.STREAM_CANCEL,
                     "body": {"stream": stream_id,
                              "rows": sorted(cancelled)}},
                    timeout=10.0,
                )
            # tlint: disable=TL005(best-effort cancel push — the chunk budget bound still applies)
            except Exception:
                pass  # best-effort: the budget bound still applies

        while True:
            tk = self.node.send_request(
                "next_tokens",
                {"stream": stream_id, "timeout": 30.0},
                timeout=35.0,
            )
            if tk.get("tokens"):
                # the worker streams (row, token) pairs; the relay buffer
                # may merge several decode steps into one drain, so start a
                # fresh emission whenever a row repeats
                cur: dict[int, int] = {}
                for r, tok in tk["tokens"]:
                    if r in cur:
                        feed(cur)
                        cur = {}
                    cur[int(r)] = int(tok)
                if cur:
                    feed(cur)
                push_cancels()
            if tk.get("done"):
                break
            if len(cancelled) >= B:
                # every row's downstream (stop filters) confirmed a cancel:
                # stop forwarding so the client stream closes NOW. The
                # STREAM_CANCEL backchannel (push_cancels above) stops the
                # worker's compiled loop at its next chunk boundary, so the
                # response arrives within ~one chunk of decode.
                break
            if tk.get("timeout") and not t.is_alive():
                break
        t.join(timeout=MAX_WAIT_TIME)
        if len(cancelled) >= B:
            # early break never observed the done marker, so the relay's
            # drop-on-done cleanup didn't run — release the buffer (the
            # worker has responded by now, so its trailing pushes landed)
            try:
                self.node.send_request(
                    "drop_stream", {"stream": stream_id}, timeout=10.0
                )
            # tlint: disable=TL005(best-effort buffer release — the relay's stale-stream bound reclaims it)
            except Exception:
                pass
        if "err" in result:
            raise result["err"]
        if "resp" not in result:
            if len(cancelled) >= B and any(drained):
                # cancelled early and the worker's compiled loop is still
                # burning its residual budget past MAX_WAIT_TIME: the
                # drained tokens already contain everything through the
                # stop match, which is all the caller will keep anyway
                return [list(map(int, s)) for s in drained]
            raise TimeoutError(
                "streamed generate: worker response did not arrive within "
                f"{MAX_WAIT_TIME}s"
            )
        return [list(map(int, s)) for s in result["resp"]["sequences"]]

    def _note_serving(self, resp: dict) -> None:
        """Keep the worker's latest slot-engine snapshot (occupancy +
        prefix-cache counters, riding each continuous GENERATE_RESP) so
        the validator's /stats endpoint can surface it through
        ContinuousBatcher.stats() without a polling RPC."""
        snap = resp.get("serving")
        if isinstance(snap, dict):
            self.cont_serving_stats = snap
        self._note_trace(resp)

    @staticmethod
    def _note_trace(resp: dict) -> None:
        """Merge the worker's span payload (riding GENERATE_RESP next to
        the serving snapshot) into this process's tracer — the stitch
        that makes ``GET /trace/<rid>`` show a request's spans from every
        worker it touched, including both sides of a live migration."""
        tr = resp.get("trace")
        if isinstance(tr, dict) and tr.get("id"):
            from tensorlink_tpu_torch.core.trace import get_tracer

            get_tracer().ingest(str(tr["id"]), tr.get("spans") or [])

    def _merge_migrated_tokens(
        self, mig: dict, delivered_prior: list[int],
        seen_total: list[int], stream_cb,
    ) -> list[int]:
        """Reconcile a migrated stream's token state: the redirect's
        ``tokens_so_far`` is the authoritative list of everything the
        draining worker emitted THIS submission (fire-and-forget relay
        frames may have dropped some). Tokens the caller hasn't seen yet
        are fed to ``stream_cb`` here — exactly once, in order — BEFORE
        any re-pointing that could fail, so a later repair can never
        re-emit or lose them."""
        auth = [int(t) for t in mig.get("tokens_so_far") or []]
        merged = list(delivered_prior) + auth
        for tok in merged[len(seen_total):]:
            if stream_cb is not None:
                stream_cb([tok])
        return merged

    @staticmethod
    def _count_redirect(redirects: int, cap: int) -> int:
        """Bound migration-redirect hops for one request: tokens already
        merged are preserved (the caller raises AFTER merging), but a
        redirect cycle must fail loudly instead of bouncing forever."""
        if redirects + 1 > cap:
            raise RuntimeError(
                f"migration redirect loop: request bounced {cap} times "
                "(draining workers pointing at each other?)"
            )
        return redirects + 1

    def _attach_migrated(
        self, old_wid: str, mig: dict, *, rewrite_plan: bool = True
    ) -> str | None:
        """Re-point this job at a migration redirect's destination worker
        (connect, rewrite the plan stage, record the repair mapping so
        concurrent requests chase to it too). Returns the staged-adoption
        ticket id (None = plain re-prefill resume). An unreachable
        destination raises :class:`WorkerLost` — the caller's recovery
        path then pulls a validator replacement, the ladder's last rung.

        ``rewrite_plan=False`` is the steady-state prefill→decode handoff
        shape (the redirect carries ``handoff: true``): only THIS request
        follows to the destination — the plan keeps naming the prefill
        worker, which stays the admission point for every later request."""
        dest_id = str(mig.get("worker") or "")
        addr = list(mig.get("addr") or [])
        if not dest_id or len(addr) != 2:
            raise WorkerLost(
                old_wid, RuntimeError("malformed migration redirect")
            )
        # ALWAYS (re)dial: the net layer dedupes live connections by
        # address, and a stale cached peer id (the destination restarted,
        # a dropped link) would otherwise make every future redirect to
        # it fail with "no connection" forever — the steady-state handoff
        # path hits the same destination on every request, so a dead
        # cache entry must heal here. The dial happens OUTSIDE the
        # repair lock (dedupe makes concurrent dials safe): holding the
        # model-wide lock across a cross-process round trip would
        # serialize every concurrent request's redirect on a path that
        # is now per-request, not per-drain.
        try:
            conn_id = self.node.connect_to(addr[0], int(addr[1]))
        except Exception as e:
            raise WorkerLost(old_wid, e) from e
        with self._repair_lock:
            self.workers[dest_id] = conn_id
            self.worker_addrs[dest_id] = [addr[0], int(addr[1])]
            if rewrite_plan:
                for s in self.plan.stages:
                    if s.worker_id == old_wid:
                        s.worker_id = dest_id
                if old_wid != dest_id:
                    self._repaired[old_wid] = dest_id
        self.log.info(
            "stream %s %s -> %s (%s)",
            "handed off" if not rewrite_plan else "migrated",
            old_wid[:8], dest_id[:8],
            "page-shipped" if mig.get("mig") else "re-prefill resume",
        )
        return mig.get("mig") or None

    def _follow_redirect(
        self, wid: str, mig: dict, *, off_plan: bool = False
    ) -> tuple[str | None, str | None, bool]:
        """Follow a migration/handoff redirect. Returns ``(adopt,
        wid_override, retry_at_source)``: ``wid_override`` names the
        destination for a HANDOFF redirect (this request only — the plan
        keeps naming the prefill worker, the admission point), and
        ``retry_at_source=True`` means a handoff destination was
        unreachable — the prefill source is alive, so the caller simply
        resubmits there (fresh prefill; the worker retries or serves the
        stream locally) instead of escalating to validator repair.

        ``off_plan=True`` marks a redirect received while already
        decoding OFF the plan (at an earlier handoff's destination) —
        e.g. the decode worker itself draining. The plan rewrite finds
        no stage naming it, so the ticket's new home must ride the
        override: re-issuing at the plan's prefill worker would carry a
        ticket staged somewhere else entirely (it could never adopt)."""
        is_handoff = bool(mig.get("handoff"))
        try:
            adopt = self._attach_migrated(
                wid, mig, rewrite_plan=not is_handoff
            )
        except WorkerLost:
            if not is_handoff:
                raise  # drain ladder: recovery pulls a validator repair
            self.log.warning(
                "handoff destination %s unreachable; resubmitting at the "
                "prefill worker", str(mig.get("worker") or "")[:8],
            )
            return None, None, True
        follow = is_handoff or off_plan
        return adopt, (str(mig["worker"]) if follow else None), False

    def reattach_continuous(
        self, jrid: str, *, prompt, delivered=(), max_new_tokens: int,
        temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
        eos_ids=(), seed: int = 0, stream_cb=None,
        presence_penalty: float = 0.0, frequency_penalty: float = 0.0,
        priority: str | None = None, trace_id: str = "",
    ) -> list[int]:
        """Client half of the re-attach ladder (validator loss mid-decode,
        docs/FAILURE_MODEL.md "Control plane"). ``jrid`` is the journal
        rid the original request carried; ``delivered`` is every token the
        pre-crash client consumed (its high-water mark); the sampling
        knobs and ``max_new_tokens`` must repeat the ORIGINAL request's
        values. Rung 1 rebinds the worker's still-decoding slot (or
        replays its finished-orphan ledger) and tops up past the
        high-water mark exactly-once; a miss falls through on the worker
        to rung 2, the re-prefill resume — both rungs bit-identical
        to the uninterrupted stream by the fold_in sampling contract."""
        out = self._generate_continuous_remote(
            [int(t) for t in prompt],
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), eos_ids=eos_ids, seed=int(seed),
            stream_cb=stream_cb,
            presence_penalty=float(presence_penalty or 0.0),
            frequency_penalty=float(frequency_penalty or 0.0),
            priority=priority, trace_id=str(trace_id or ""),
            jrid=str(jrid), reattach=str(jrid),
            _delivered=[int(t) for t in delivered],
        )
        return out[0]

    def _generate_continuous_remote(
        self, prompt: list[int], *, max_new_tokens: int, temperature: float,
        top_k: int, top_p: float, eos_ids, seed: int, stream_cb,
        presence_penalty: float, frequency_penalty: float,
        priority: str | None = None, trace_id: str = "",
        speculative: bool = False, handoff: bool = True,
        jrid: str = "", reattach: str = "",
        _delivered: list[int] | None = None,
    ) -> list[list[int]]:
        """One request through the worker's continuous slot engine
        (B=1 per RPC; the worker co-batches concurrent requests into its
        slot batch at chunk boundaries).

        Recovery keeps PR 1's re-prefill semantics on paged slots: a lost
        worker triggers repair, then the request re-submits with prompt =
        original prompt + every token already DELIVERED and start_step =
        len(delivered). The slot engine's per-token keys are
        ``fold_in(PRNGKey(seed), n)`` — stateless in n — so the resumed
        stream continues bit-identically: no duplicated, no missing
        tokens, and the replacement worker's fresh page allocator can't
        hand this session another session's KV blocks."""
        # a re-attach (validator recovery) pre-seeds delivered with what
        # the pre-crash client already consumed — its high-water mark
        delivered: list[int] = [int(t) for t in (_delivered or [])]
        recoveries = 0
        MAX_RECOVERIES = 3
        adopt: str | None = None  # staged-migration ticket on the dest
        redirects = 0
        # redirect hops are bounded separately from crash recoveries: a
        # drain cycle (A drained onto B, B later drained onto A before A
        # was stopped) must surface as an error, not an infinite bounce
        MAX_REDIRECTS = 8
        # a prefill→decode HANDOFF redirect moves only THIS request: the
        # override names the decode worker to re-issue at while the plan
        # keeps naming the prefill worker (the admission point)
        wid_override: str | None = None
        while True:
            # capture the id this attempt ISSUES to: a concurrent request's
            # repair may rewrite the plan mid-flight, and recovery must
            # repair the worker that actually failed us — _repair's chase
            # map then reuses the concurrent thread's replacement instead
            # of trying to "replace" the live one
            wid = wid_override or self.plan.stages[0].worker_id
            budget = int(max_new_tokens) - len(delivered)
            if budget <= 0:
                return [delivered]
            body = {
                "job_id": self.job_id,
                "prompts": [[int(t) for t in prompt] + delivered],
                "max_new_tokens": budget,
                "start_step": len(delivered),
                "continuous": True,
                "temperature": temperature, "top_k": top_k, "top_p": top_p,
                "presence_penalty": presence_penalty,
                "frequency_penalty": frequency_penalty,
                "eos_ids": list(eos_ids), "seed": int(seed),
            }
            if jrid:
                # the journal rid rides every attempt: the worker keys its
                # live-stream / orphan ledgers on it, which is what makes
                # the re-attach ladder (and validator-recovery
                # reconciliation) possible at all
                body["jrid"] = jrid
            if reattach:
                # re-attach ladder rung 1: ask the worker to rebind the
                # still-decoding (or finished-orphaned) stream and top up
                # past our high-water mark. A MISS falls through to plain
                # admission of THIS body — which already carries
                # prompt+delivered / start_step, i.e. rung 2 (re-prefill
                # resume) — on the worker, with no extra round trip.
                body["reattach"] = reattach
                body["hwm"] = len(delivered)
            if priority:
                # the worker's scheduler reads the class off the wire; an
                # old worker simply ignores the extra key (FCFS for it)
                body["priority"] = str(priority)
            if speculative:
                # draft/verify opt-in: the worker's engine packs draft
                # rows when its spec_decode is on; streams bit-identical
                # either way, so an ignoring worker changes nothing
                body["speculative"] = True
            if not handoff:
                # per-request opt-out of the prefill→decode handoff on a
                # disaggregated pool (the default is to follow the
                # worker's role); absence of the key means opted in
                body["handoff"] = False
            if trace_id:
                # the trace id rides the GENERATE frame: the worker's
                # engine records its spans under it and ships them back on
                # the response (docs/SERVING.md "Telemetry")
                body["trace"] = trace_id
            if adopt:
                # resume-after-migration: the destination staged our KV
                # pages under this ticket — admission binds them instead
                # of re-prefilling (and quietly falls back if it can't)
                body["adopt"] = adopt
            try:
                if stream_cb is None:
                    resp = self._request(
                        wid, proto.GENERATE, body, _repaired=True
                    )
                    self._note_serving(resp)
                    mig = resp.get("migrated")
                    if mig is not None:
                        # the worker is draining (or handing our freshly
                        # prefilled slot to the decode pool): top up
                        # delivered from the authoritative list, re-point
                        # at the destination, and re-issue there
                        delivered = self._merge_migrated_tokens(
                            mig, delivered, delivered, None
                        )
                        redirects = self._count_redirect(redirects,
                                                         MAX_REDIRECTS)
                        adopt, wid_override, retry = \
                            self._follow_redirect(
                                wid, mig,
                                off_plan=wid_override is not None,
                            )
                        if retry:
                            # the destination is unreachable FROM US
                            # (asymmetric routing) even though the
                            # prefill worker can ship to it — opt the
                            # resubmission out of handoff, or the worker
                            # would bounce us to the same dead end until
                            # the redirect cap drops the stream
                            recoveries += 1
                            handoff = False
                        continue
                    seq = [int(t) for t in resp["sequences"][0]]
                    if resp.get("reattached"):
                        # a re-attach HIT: sequences is the ORIGINAL
                        # submission's full token list (everything since
                        # its start_step = resume_base) — merge it onto
                        # the prefix delivered BEFORE that submission, or
                        # the overlap would be double-counted
                        base = int(resp.get("resume_base", 0))
                        return [delivered[:base] + seq]
                    return [delivered + seq]
                out, finished, mig = self._drain_continuous_stream(
                    wid, body, delivered, stream_cb
                )
                if mig is not None:
                    delivered = self._merge_migrated_tokens(
                        mig, delivered, out, stream_cb
                    )
                    redirects = self._count_redirect(redirects,
                                                     MAX_REDIRECTS)
                    adopt, wid_override, retry = \
                        self._follow_redirect(
                            wid, mig, off_plan=wid_override is not None,
                        )
                    if retry:
                        # see above: client-unreachable destination —
                        # pin the resubmission to the prefill worker
                        recoveries += 1
                        handoff = False
                    continue
                if finished:
                    return [out]
                delivered = out  # resume from what the relay delivered
                raise WorkerLost(wid, RuntimeError("stream interrupted"))
            except Exception as e:
                # ONLY a dead connection means the worker (and its slots)
                # are gone — a plain RPC timeout may just be a long decode
                # queued behind a busy slot batch, and "repairing" the live
                # worker for it would re-ship its stage and disturb every
                # other session it serves (the static path draws the same
                # line)
                recoverable = isinstance(e, WorkerLost) \
                    or "no connection" in str(e)
                if not recoverable or recoveries >= MAX_RECOVERIES:
                    raise
                recoveries += 1
                if wid_override is not None and all(
                    s.worker_id != wid for s in self.plan.stages
                ):
                    # the handoff DESTINATION died mid-decode. The
                    # admission point (the plan's prefill worker) is not
                    # implicated — resubmit there with a dead ticket
                    # dropped, instead of "repairing" a healthy worker
                    # (which would re-recruit and re-ship its stage)
                    self.log.warning(
                        "handoff destination lost mid-decode (%s); "
                        "resubmitting prompt + %d delivered tokens at "
                        "the prefill worker (recovery %d/%d)",
                        e, len(delivered), recoveries, MAX_RECOVERIES,
                    )
                    wid_override = None
                    adopt = None
                    # the decode pool just ate our stream once — decode
                    # the resubmission at the admission point instead of
                    # letting the worker's (possibly stale) readiness
                    # cache bounce it toward the same dead destination
                    handoff = False
                    continue
                wid_override = None
                adopt = None
                self.log.warning(
                    "continuous generate lost its worker (%s); re-prefilling "
                    "prompt + %d delivered tokens on a replacement "
                    "(recovery %d/%d)",
                    e, len(delivered), recoveries, MAX_RECOVERIES,
                )
                self._repair(wid)

    def _drain_continuous_stream(
        self, wid: str, body: dict, delivered: list[int], stream_cb
    ) -> tuple[list[int], bool, dict | None]:
        """Issue a streamed continuous GENERATE and drain its relay.
        Returns ``(tokens_so_far, finished, migrated)`` —
        ``finished=False`` with ``migrated=None`` means the worker died
        mid-stream and the caller should resume from ``tokens_so_far`` on
        a replacement; a non-None ``migrated`` dict means the worker
        DRAINED and redirected this stream (live slot migration) — the
        caller re-points at the named destination."""
        stream_id = secrets.token_hex(8)
        body = dict(body, stream=stream_id)
        result: dict = {}

        def issue():
            try:
                result["resp"] = self._request(
                    wid, proto.GENERATE, body, _repaired=True
                )
            except Exception as e:
                result["err"] = e

        t = threading.Thread(target=issue, daemon=True)
        t.start()
        toks = list(delivered)
        notified = False
        while True:
            tk = self.node.send_request(
                "next_tokens", {"stream": stream_id, "timeout": 5.0},
                timeout=10.0,
            )
            for _row, tok in tk.get("tokens") or ():
                toks.append(int(tok))
                cancel = stream_cb([int(tok)])
                if cancel and not notified:
                    # confirmed stop match: the worker's slot engine stops
                    # this request at its next emitted token (cancel polls
                    # ride the chunk cadence)
                    notified = True
                    try:
                        self.node.send_request(
                            "send_control",
                            {"peer": self.workers[wid],
                             "tag": proto.STREAM_CANCEL,
                             "body": {"stream": stream_id, "rows": [0]}},
                            timeout=10.0,
                        )
                    # tlint: disable=TL005(best-effort cancel push — the chunk budget bound still applies)
                    except Exception:
                        pass  # best-effort; the budget bound still applies
            if tk.get("done"):
                break
            if tk.get("timeout") and not t.is_alive():
                break  # issuer finished (response or death) with no marker
        t.join(timeout=MAX_WAIT_TIME)
        if "resp" not in result:
            # worker died mid-stream: scoop any frames that beat the crash
            # onto the relay AFTER our last drain, so the resumed request
            # can't re-emit a token the caller already saw
            try:
                tk = self.node.send_request(
                    "next_tokens", {"stream": stream_id, "timeout": 0.5},
                    timeout=5.0,
                )
                for _row, tok in tk.get("tokens") or ():
                    toks.append(int(tok))
                    stream_cb([int(tok)])
            # tlint: disable=TL005(draining trailing tokens of a finished stream — the worker may be gone)
            except Exception:
                pass
        try:
            self.node.send_request(
                "drop_stream", {"stream": stream_id}, timeout=10.0
            )
        # tlint: disable=TL005(best-effort buffer release — the relay's stale-stream bound reclaims it)
        except Exception:
            pass
        if "resp" in result:
            # the response is authoritative (fire-and-forget stream frames
            # may drop); it holds THIS submission's tokens only
            self._note_serving(result["resp"])
            mig = result["resp"].get("migrated")
            if mig is not None:
                # drained mid-stream: hand the redirect up with what the
                # relay delivered so far (the migrated body's
                # tokens_so_far is the authoritative top-up source)
                return toks, False, mig
            resp = result["resp"]
            seq = [int(x) for x in resp["sequences"][0]]
            if resp.get("reattached"):
                # re-attach HIT: sequences spans the ORIGINAL submission
                # (since resume_base) — merge onto the prefix delivered
                # before it, not onto everything we've seen (overlap)
                base = int(resp.get("resume_base", 0))
                return delivered[:base] + seq, True, None
            return delivered + seq, True, None
        err = result.get("err")
        if err is not None and "no connection" not in str(err):
            # compute errors and plain timeouts surface to the caller —
            # only a dead connection licenses the resume-on-replacement
            raise err
        return toks, False, None

    # ------------------------------------------------------------------
    # generate on a pipelined job: host-driven decode over per-stage
    # session caches
    # ------------------------------------------------------------------
    def _generate_staged(
        self, prompts, *, max_new_tokens, temperature, top_k, top_p,
        eos_ids, seed, stream_cb, budgets, lookahead, presence_penalty,
        frequency_penalty, num_beams,
    ) -> list[list[int]]:
        """The pipelined job's paths: beam search, prompt-lookup
        speculation (greedy, unpenalized, B = 1) or the session decode."""
        if int(num_beams) > 1:
            return self._generate_beam_pipelined(
                prompts, num_beams=int(num_beams),
                max_new_tokens=max_new_tokens, eos_ids=eos_ids,
            )
        if (
            lookahead and len(prompts) == 1
            and not isinstance(temperature, (list, tuple))
            and float(temperature) <= 0.0
            and not _any_nonzero(presence_penalty)
            and not _any_nonzero(frequency_penalty)
        ):
            # per-token cost here is the cross-stage hops, so accepted
            # drafts divide the round trips; the tokens are vanilla greedy
            return self._generate_lookahead_pipelined(
                prompts, max_new_tokens=max_new_tokens, eos_ids=eos_ids,
                stream_cb=stream_cb,
            )
        return self._generate_pipelined(
            prompts, max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, eos_ids=eos_ids, seed=seed,
            stream_cb=stream_cb, budgets=budgets,
            presence_penalty=presence_penalty,
            frequency_penalty=frequency_penalty,
        )

    def _generate_pipelined(
        self, prompts, *, max_new_tokens, temperature, top_k=0, top_p=1.0,
        eos_ids=(), seed=0, stream_cb=None, budgets=None,
        presence_penalty=0.0, frequency_penalty=0.0,
    ) -> list[list[int]]:
        """Host-driven decode across the stages with per-stage session
        caches. The head's worker samples each step with the key
        ``fold_in(PRNGKey(seed), step)`` and ships one id per row; knobs
        may be per-row and ``budgets`` caps rows individually.
        Presence/frequency penalties ride the session: the head's worker
        keeps the ``[B, V]`` context counts across steps.

        A stage worker lost mid-decode: the dead stages are repaired and
        prompt + emitted tokens re-prefill under a fresh session. The
        re-prefilled row's last logits are the decode step's, and the key
        depends only on (seed, step), so the resumed stream equals the
        uninterrupted one — no duplicated, no missing tokens."""
        prompts = [list(map(int, p)) for p in prompts]
        B = len(prompts)
        T = max(len(p) for p in prompts)
        toks = np.zeros((B, T), np.int32)
        mask = np.zeros((B, T), bool)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
            mask[i, : len(p)] = True
        cache_len = min(self.spec["seq_len"], T + max_new_tokens)
        eos = set(int(e) for e in eos_ids)
        per_row = any(
            isinstance(v, (list, tuple))
            for v in (temperature, top_k, top_p,
                      presence_penalty, frequency_penalty)
        )
        for name, v in (("temperature", temperature), ("top_k", top_k),
                        ("top_p", top_p), ("budgets", budgets),
                        ("presence_penalty", presence_penalty),
                        ("frequency_penalty", frequency_penalty)):
            if isinstance(v, (list, tuple)) and len(v) != B:
                raise ValueError(
                    f"per-row {name} has {len(v)} entries for {B} prompts"
                )
        # per-row budgets, each capped by its OWN cache room
        eff = []
        for i, p in enumerate(prompts):
            want = int(budgets[i]) if budgets else int(max_new_tokens)
            eff.append(max(min(want, cache_len - len(p)), 0))
        steps = max(eff) if eff else 0

        def rows(v, cast):
            # all or none: one per-row knob makes every knob a B-list
            if not per_row:
                return cast(v)
            if isinstance(v, (list, tuple)):
                return [cast(x) for x in v]
            return [cast(v)] * B

        samp = {
            "temperature": rows(temperature, float),
            "top_k": rows(top_k, int),
            "top_p": rows(top_p, float),
            "presence_penalty": rows(presence_penalty, float),
            "frequency_penalty": rows(frequency_penalty, float),
            "seed": int(seed),
        }
        penalized = (
            _any_nonzero(presence_penalty) or _any_nonzero(frequency_penalty)
        )

        def with_prompt(d: dict, t, m) -> dict:
            # the head's worker sees hidden states, not ids: the prompt
            # seeds the session's context counts once
            if penalized:
                d["prompt_tokens"] = t
                d["prompt_mask"] = m
            return d

        seqs: list[list[int]] = [[] for _ in range(B)]
        state = {"session": secrets.token_hex(8), "seq": 0, "recoveries": 0}
        MAX_RECOVERIES = 3

        def prefill(t, m, step_idx: int):
            lens = m.sum(-1)
            out = self.forward(
                t, m, session=state["session"], cache_len=cache_len,
                sample=with_prompt(dict(samp, step=step_idx), t, m),
                last_idx=(lens - 1).astype(np.int32), seq=0,
            )
            state["seq"] = 1
            return out

        def reestablish(step_idx: int):
            self._repair_dead_stages()
            self._end_decode_session(state["session"])
            state["session"] = secrets.token_hex(8)
            rows_ = [prompts[i] + seqs[i] for i in range(B)]
            t2 = np.zeros((B, max(len(r) for r in rows_)), np.int32)
            m2 = np.zeros_like(t2, bool)
            for i, r in enumerate(rows_):
                t2[i, : len(r)] = r
                m2[i, : len(r)] = True
            return prefill(t2, m2, step_idx)

        def next_tok(step_idx: int, step_tok):
            mode = "prefill" if step_tok is None else "decode"
            while True:
                try:
                    if mode == "decode":
                        out = self.forward(
                            step_tok[:, None].astype(np.int32),
                            session=state["session"], cache_len=cache_len,
                            sample=dict(samp, step=step_idx),
                            seq=state["seq"],
                        )
                        state["seq"] += 1
                        return out
                    if mode == "prefill":
                        return prefill(toks, mask, 0)
                    return reestablish(step_idx)
                except Exception as e:
                    recoverable = isinstance(e, SessionLost) \
                        or _transportish(e)
                    if not recoverable \
                            or state["recoveries"] >= MAX_RECOVERIES:
                        raise
                    state["recoveries"] += 1
                    self.log.warning(
                        "decode session lost (%s); re-establishing on live "
                        "workers (recovery %d/%d)",
                        e, state["recoveries"], MAX_RECOVERIES,
                    )
                    mode = "reestablish"

        try:
            tok = next_tok(0, None)
            done = np.asarray([e <= 0 for e in eff], bool)
            for step in range(steps):
                emitted: list[int | None] = []
                for i in range(B):
                    if not done[i]:
                        seqs[i].append(int(tok[i]))
                        emitted.append(int(tok[i]))
                    else:
                        emitted.append(None)
                    done[i] |= int(tok[i]) in eos or len(seqs[i]) >= eff[i]
                if stream_cb is not None and any(
                    e is not None for e in emitted
                ):
                    # the callback may name rows to cancel (confirmed stop
                    # matches): they stop now, saving their stage hops
                    for i in stream_cb(emitted) or ():
                        if 0 <= int(i) < B:
                            done[int(i)] = True
                if done.all() or step == steps - 1:
                    break
                tok = next_tok(step + 1, tok)
            return seqs
        finally:
            # on failure paths too: survivors must not leak the session's
            # KV and its dedup ledger
            self._end_decode_session(state["session"])

    def _end_decode_session(self, session: str) -> None:
        """Drop a session's KV caches (and seq-dedup ledger) on every stage
        worker; best-effort — a dead worker's cache died with it."""
        for stage in self.plan.stages:
            try:
                self._request(
                    stage.worker_id, proto.FORWARD,
                    {"job_id": self.job_id, "op": "end_session",
                     "session": session},
                    timeout=10.0,
                )
            # tlint: disable=TL005(session teardown fanout — a dead stage has no session left to end)
            except Exception:
                pass

    def _generate_beam_pipelined(
        self, prompts, *, num_beams: int, max_new_tokens: int,
        eos_ids=(), length_penalty: float = 1.0,
    ) -> list[list[int]]:
        """Beam search across the stages (B = 1): the K beams ride the
        session's batch axis, the head's worker ships K x (K + n_eos)
        candidate (score, id) pairs per step from its top-k (never [K, V]
        logits), the frontier logic is the engine's
        (``engine/generate.py::beam_frontier_step``), and each step
        reorders every stage's cache rows to follow their source beam."""
        from tensorlink_tpu_torch.engine.generate import beam_frontier_step

        prompts = [list(map(int, p)) for p in prompts]
        if len(prompts) != 1:
            raise ValueError("beam search is B=1")
        K = int(num_beams)
        prompt = prompts[0]
        eos_set = set(int(e) for e in eos_ids)
        cache_len = min(self.spec["seq_len"], len(prompt) + max_new_tokens)
        room = min(max_new_tokens, cache_len - len(prompt))
        if room <= 0:
            return [[]]
        session = secrets.token_hex(8)
        samp = {"beam_k": K, "beam_n_eos": len(eos_set)}
        # K identical prompt rows prefill K identical session caches
        toks = np.tile(np.asarray(prompt, np.int32), (K, 1))
        mask = np.ones((K, len(prompt)), bool)
        last_idx = np.full((K,), len(prompt) - 1, np.int32)
        try:
            vals, idx = self.forward(
                toks, mask, session=session, cache_len=cache_len,
                sample=samp, last_idx=last_idx,
            )
            row_v, row_i = np.asarray(vals)[0], np.asarray(idx)[0]
            scores = row_v[:K].astype(np.float64)
            beams = [[int(t)] for t in row_i[:K]]
            alive = [int(t) not in eos_set for t in row_i[:K]]
            done_pool: list[tuple[float, list[int]]] = []
            for k, b in enumerate(beams):
                if not alive[k]:
                    done_pool.append((scores[k] / 1.0, b))
            tok = np.asarray([b[-1] for b in beams], np.int32)
            pending_src: list[int] | None = None
            for _step in range(1, room):
                if not any(alive):
                    break
                vals, idx = self.forward(
                    tok[:, None], session=session, cache_len=cache_len,
                    sample=samp,
                    reorder_idx=(
                        np.asarray(pending_src, np.int32)
                        if pending_src is not None else None
                    ),
                )
                nxt = beam_frontier_step(
                    beams, scores, alive, done_pool,
                    np.asarray(vals), np.asarray(idx), K,
                    eos_set, room, length_penalty,
                )
                if nxt is None:
                    break
                beams, scores, alive, src = nxt
                # a stable frontier skips the gather
                pending_src = None if src == list(range(K)) else src
                tok = np.asarray([b[-1] for b in beams], np.int32)
            for k in range(K):
                if alive[k]:
                    done_pool.append(
                        (scores[k] / (len(beams[k]) ** length_penalty),
                         beams[k])
                    )
            _score, best = max(done_pool, key=lambda d: d[0])
            return [best]
        finally:
            self._end_decode_session(session)

    def _generate_lookahead_pipelined(
        self, prompts, *, max_new_tokens: int, eos_ids=(),
        n_draft: int = 8, stream_cb=None,
    ) -> list[list[int]]:
        """Greedy decode with prompt-lookup speculation across the stages
        (B = 1): draft from the history's own n-grams, verify the whole
        draft in ONE multi-token session forward (the head's worker ships
        per-position argmax ids), keep the matched prefix + correction,
        and roll back rejected cache positions with a length reset that
        rides the next forward. Emits exactly the vanilla greedy
        sequence."""
        from tensorlink_tpu_torch.engine.generate import GenerationEngine

        prompts = [list(map(int, p)) for p in prompts]
        if len(prompts) != 1:
            raise ValueError("lookahead decode is B=1")
        prompt = prompts[0]
        eos_set = set(int(e) for e in eos_ids)
        cache_len = min(self.spec["seq_len"], len(prompt) + max_new_tokens)
        limit = min(max_new_tokens, cache_len - len(prompt))
        if limit <= 0:
            return [[]]
        session = secrets.token_hex(8)
        lookup = GenerationEngine._lookup_draft
        try:
            tok = int(self.forward(
                np.asarray([prompt], np.int32),
                np.ones((1, len(prompt)), bool),
                session=session, cache_len=cache_len,
                sample={"temperature": 0.0, "seed": 0, "step": 0},
                last_idx=np.asarray([len(prompt) - 1], np.int32),
            )[0])
            history = list(prompt) + [tok]
            seq = [tok]
            if stream_cb is not None:
                stream_cb([tok])
            cur_len = len(prompt)  # cache rows written past the prompt
            # a rollback set after a verify pass rides the next forward
            pending_reset: int | None = None
            while len(seq) < limit and tok not in eos_set:
                remaining = limit - len(seq)
                k = min(n_draft, remaining - 1, cache_len - cur_len - 1 - 1)
                draft = lookup(history, k) if k > 0 else []
                pad_to = len(draft)
                if cur_len + 1 + n_draft + 1 <= cache_len:
                    # a fixed [1, 1 + n_draft] verify shape whenever the
                    # cache has room
                    pad_to = n_draft if draft else 0
                step_toks = np.zeros((1, 1 + pad_to), np.int32)
                step_toks[0, 0] = tok
                step_toks[0, 1 : 1 + len(draft)] = draft
                targets = self.forward(
                    step_toks, session=session, cache_len=cache_len,
                    sample={"verify": True}, reset_len=pending_reset,
                )[0]
                base = cur_len if pending_reset is None else pending_reset
                cur_len = base + step_toks.shape[1]
                accepted = 0
                while (
                    accepted < len(draft)
                    and draft[accepted] == int(targets[accepted])
                ):
                    if draft[accepted] in eos_set:
                        break
                    accepted += 1
                emitted = list(draft[:accepted]) + [int(targets[accepted])]
                pending_reset = base + 1 + accepted
                taken: list[int] = []
                for t in emitted:
                    seq.append(t)
                    history.append(t)
                    taken.append(t)
                    tok = t
                    if t in eos_set or len(seq) >= limit:
                        break
                cancelled = False
                if stream_cb is not None:
                    for t in taken:  # the per-token callback contract
                        if stream_cb([t]):
                            cancelled = True  # a confirmed stop (B = 1)
                if cancelled or tok in eos_set:
                    break
            return [seq[:limit]]
        finally:
            self._end_decode_session(session)

    # ------------------------------------------------------------------
    def shutdown(self) -> None:
        """Release the job: workers drop the stage runtime and free the
        reserved capacity (reference SHUTDOWN-JOB, worker_thread.py:92-95;
        the reference's users leak reservations on exit — see Keeper
        cleanup gap, SURVEY §5 failure-detection notes)."""
        if self.job_id is None:
            return
        peers = set(self.workers.values())
        try:
            peers |= set(self.node.send_request("validators", timeout=10.0))
        except Exception as e:
            self.log.debug("validator list for shutdown fanout failed: %s", e)
        for conn_id in peers:
            try:
                self.node.send_request(
                    "send_control",
                    {"peer": conn_id, "tag": proto.JOB_SHUTDOWN,
                     "body": {"job_id": self.job_id}},
                    timeout=10.0,
                )
            # tlint: disable=TL005(best-effort release fanout — dead peers free the reservation by dying)
            except Exception:
                pass
        self.job_id = None

    def close(self) -> None:
        self.shutdown()
        if self._owns_node:
            self.node.stop()

    def __enter__(self) -> "DistributedModel":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _stage_dict(stage) -> dict:
    from dataclasses import asdict

    return asdict(stage)


def _host_ids(x) -> np.ndarray:
    """Host numpy view of ids or masks given as a tensor, array or list."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _ce_sum_and_grad(logits, tokens, loss_mask):
    """Next-token cross-entropy SUM (not mean) and its gradient with
    respect to the logits, in float32 on the logits' device. Sums add up
    across micro-batches, so one division by the total token count at the
    optimizer step gives ``engine/training.py::causal_lm_loss``'s
    token-mean. Returns ``(nll_sum, dlogits, n_tokens)``, tensors."""
    import torch

    dev = logits.device
    tg = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)[:, 1:]
    m = torch.as_tensor(np.asarray(loss_mask, bool), device=dev)[:, 1:]
    lg = logits.detach().requires_grad_(True)
    with torch.enable_grad():
        lg32 = lg[:, :-1].float()
        logz = torch.logsumexp(lg32, dim=-1)
        gold = torch.gather(lg32, -1, tg[..., None])[..., 0]
        nll_sum = ((logz - gold) * m).sum()
        (dlogits,) = torch.autograd.grad(nll_sum, lg)
    return nll_sum.detach(), dlogits, m.sum()
