"""DistributedModel — the caller's handle on a distributed job (port of
the serving part of ``tensorlink_tpu/ml/module.py``).

A validator-hosted model attaches to a job the validator planned and
recruited (:meth:`DistributedModel.from_job`): it connects to the job's
worker, ships the stage assignment (plan slice + model config +
checkpoint reference or seed, never code) and then generates:

- ``generate(..., continuous=True)`` on a single-request call joins the
  worker's running slot batch (``_generate_continuous_remote``), streamed
  token by token over the TOKEN relay when a ``stream_cb`` is given;
- every other call runs the worker's dense engine
  (``_generate_remote``: batched, beam, lookahead).

Pipelined (multi-stage) jobs, job repair and training wait for later
slices of the port and raise ``NotImplementedError`` naming their ROADMAP
item. All waits are bounded (MAX_WAIT_TIME).
"""

from __future__ import annotations

import random
import secrets
import threading
import time
from typing import Any, Callable, Sequence

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
    ladder decides what to re-issue where."""

    def __init__(self, worker_id: str | None, cause: BaseException):
        super().__init__(f"worker {str(worker_id)[:12]} lost: {cause}")
        self.worker_id = worker_id
        self.cause = cause


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
        request_timeout: float = MAX_WAIT_TIME,
        retry_attempts: int = RETRY_ATTEMPTS,
        **node_kw,
    ):
        from tensorlink_tpu_torch.models.base import ModelConfig

        self.log = get_logger("ml.model")
        if training:
            raise unported("training", 9)
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
        self._repair_lock = threading.Lock()
        self._repaired: dict[str, str] = {}  # dead worker id -> replacement
        self._request_timeout = float(request_timeout)
        self._retry_attempts = max(int(retry_attempts), 1)
        # jitter source for retry backoff — seeded so chaos runs replay
        self._retry_rng = random.Random(seed)
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
        if self.plan.n_stages > 1 or any(
            s.coworkers for s in self.plan.stages
        ):
            raise unported("a pipelined or co-slice merged job", 8)

        # connect to the assigned worker and ship its stage
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
          validator (the reference's "request another worker" TODO,
          module.py:510-511, made real) and retries there.
        - ``_repaired``: one attempt, no repair (the continuous path runs
          its own recovery ladder).
        """
        timeout = self._request_timeout if timeout is None else timeout
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
    # paths later slices of the port bring
    # ------------------------------------------------------------------
    def _repair(self, dead_plan_wid: str) -> str:
        """Replace a dead worker (validator JOB_REPAIR pull)."""
        raise unported("job repair", 7)

    def poll_job_updates(self) -> int:
        """Apply validator-pushed worker replacements."""
        raise unported("job repair", 7)

    def forward(self, tokens, attn_mask=None, **kw):
        """Chain the pipeline stages (FORWARD requests)."""
        raise unported("stage forwards", 8)

    __call__ = forward

    def init_optimizer(self, name: str = "adamw", **spec) -> None:
        raise unported("training", 9)

    def optimizer_step(self, scale: float = 1.0) -> dict:
        raise unported("training", 9)

    def zero_grad(self) -> None:
        raise unported("training", 9)

    def train_step(self, tokens, attn_mask=None, **kw) -> dict:
        raise unported("training", 9)

    def save_checkpoint(self, ckpt_dir: str) -> dict:
        raise unported("training checkpoints", 9)

    def restore_checkpoint(self, ckpt_dir: str) -> None:
        raise unported("training checkpoints", 9)

    def export_hf_checkpoint(self, out_dir: str):
        raise unported("training checkpoints", 9)

    def parameters(self) -> list[dict]:
        raise unported("parameter download for training", 9)

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
        mix concurrent requests in one decode) through the worker engine's
        bucketed batch."""
        if self.plan is None:
            raise RuntimeError("the model is not attached to a job")
        prompts = [list(p) for p in prompts]
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

    def _generate_continuous_remote(
        self, prompt: list[int], *, max_new_tokens: int, temperature: float,
        top_k: int, top_p: float, eos_ids, seed: int, stream_cb,
        presence_penalty: float, frequency_penalty: float,
        priority: str | None = None, trace_id: str = "",
        speculative: bool = False, handoff: bool = True,
        jrid: str = "",
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
        delivered: list[int] = []
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
            return delivered + seq, True, None
        err = result.get("err")
        if err is not None and "no connection" not in str(err):
            # compute errors and plain timeouts surface to the caller —
            # only a dead connection licenses the resume-on-replacement
            raise err
        return toks, False, None

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

