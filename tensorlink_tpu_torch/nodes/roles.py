"""Role servers — the network-process half of each node.

Reference equivalents: WorkerThread / ValidatorThread / UserThread
(nodes/worker_thread.py, validator_thread.py, user_thread.py) running inside
the spawned networking process. Redesigned around asyncio + the IPC bridge:
wire handlers post work events; the ML process answers with commands; no
shared-memory parking lots or poll loops.

Job lifecycle (asyncio version of SURVEY §3.2):

1. user ML → ``request_job`` cmd → UserServer sends JOB_REQ to a validator.
2. ValidatorServer posts ``job_req`` work → DistributedValidator plans
   (sharding planner) → ``recruit`` cmd → ValidatorServer asks each chosen
   worker JOB_REQ (3 s accept window, reference validator_thread.py:845-887);
   workers reserve capacity and accept.
3. Validator replies to the user's JOB_REQ with the plan + worker addresses
   and stores the job in the DHT.
4. The user connects to each worker and ships MODULE (plan slice + model
   config + checkpoint ref — never code; reference ships serialized modules,
   torch_node.py:879-924). Worker ML loads and the MODULE request resolves
   with MODULE_LOADED.
5. FORWARD / BACKWARD / GENERATE are correlated tensor requests straight to
   the owning worker.

Neither torch nor jax is imported here.
"""

from __future__ import annotations

import asyncio
import json
import time
import uuid
from pathlib import Path
from typing import Any

from tensorlink_tpu_torch import unported
from tensorlink_tpu_torch.core.config import NodeConfig
from tensorlink_tpu_torch.nodes.ipc import BridgeQueues, NetBridge
from tensorlink_tpu_torch.p2p import protocol as proto
from tensorlink_tpu_torch.p2p.connection import Connection
from tensorlink_tpu_torch.p2p.tensor_node import TensorNode

RECRUIT_TIMEOUT = 3.0  # reference validator_thread.py:871
JOB_REQS_PER_MINUTE = 30  # reference validator_thread.py:508-516
JOB_REQ_TIMEOUT = 120.0  # reference user_thread.py:406
MODULE_LOAD_TIMEOUT = 150.0  # reference MAX_WAIT_TIME ml/module.py:58


def verify_proof_log(log: list) -> tuple[bool, dict]:
    """Proof-of-learning check of a training job's log: training is not
    ported yet, and a serving job's worker sends no log."""
    raise unported("training proofs (platform/proofs.py)", 9)


class RoleServer(TensorNode):
    """TensorNode + IPC command surface shared by all roles."""

    def __init__(self, cfg: NodeConfig, queues: BridgeQueues):
        if getattr(cfg, "faults", None):
            # deterministic fault injection (core/faults.py): install the
            # plan process-globally HERE — this network process is one OS
            # process per node, so the global cannot leak across nodes
            from tensorlink_tpu_torch.core import faults

            faults.install(faults.FaultPlan.from_dict(cfg.faults))
        super().__init__(
            cfg.role,
            host=cfg.effective_host(),
            port=cfg.port or 0,
            key_dir=cfg.key_dir,
            local_test=cfg.local_test,
            identity_name=cfg.role + cfg.duplicate,
        )
        self.cfg = cfg
        self.bridge = NetBridge(queues)
        self.work = queues.work  # TensorNode.post_work target
        self.capacity: dict[str, Any] = {
            "hbm_bytes": 0.0,
            "n_devices": 0,
            "slice_id": "",
            "role": cfg.role,
            "training": True,
        }
        self.reserved: dict[str, float] = {}  # job_id -> reserved bytes
        self.register(proto.STATS_REQUEST, self._handle_stats_request)

    def post_work(self, kind: str, item: Any) -> None:
        # executor-offloaded put: the ring transport blocks when full and
        # must never stall the event loop (see NetBridge.post_work)
        self.bridge.post_work(kind, item)

    # -- entrypoint (net process main) ----------------------------------
    def main(self) -> None:
        self.start()  # event loop thread + listener
        self.port_mapper = None
        if self.cfg.upnp and not self.cfg.local_test:
            # public-network mode: map the listen port on the NAT gateway
            # (reference smart_node.py:1200-1312; best-effort — a missing
            # gateway degrades to a warning, not a dead node)
            from tensorlink_tpu_torch.p2p.upnp import PortMapper

            self.port_mapper = PortMapper()
            ext_ip = self.port_mapper.map_port(self.port)
            if ext_ip:
                self.capacity["external_addr"] = [ext_ip, self.port]
        info = {"port": self.port, "id": self.node_id, "role": self.role}
        self.bridge.q.resp.put((-1, True, info))
        self.on_started()
        fut = asyncio.run_coroutine_threadsafe(
            self.bridge.serve(self.dispatch), self._loop
        )
        try:
            fut.result()  # blocks until _stop
        finally:
            try:
                self.on_shutdown()
            except Exception:
                self.log.exception("shutdown hook failed")
            if self.port_mapper is not None:
                self.port_mapper.close()
            self.stop()

    def on_started(self) -> None:
        """Role hook: schedule background tasks after the listener is up."""

    def on_shutdown(self) -> None:
        """Role hook: flush state before the event loop stops."""

    # -- command dispatch ----------------------------------------------
    async def dispatch(self, verb: str, payload: Any) -> Any:
        fn = getattr(self, f"cmd_{verb}", None)
        if fn is None:
            raise ValueError(f"unknown ipc verb {verb!r}")
        return await fn(payload or {})

    def _conn(self, peer: str) -> Connection:
        conn = self.connections.get(peer)
        if conn is None:
            raise ConnectionError(f"no connection to {peer[:12]}")
        return conn

    async def _control_fault(self, verb: str) -> None:
        """``control.frame`` fault site (core/faults.py): fires at the top
        of the control verbs that mutate fleet state (drain / recruit /
        pool- and replica-set pushes / ticket expiry). "drop" maps to a
        raised error — a control frame that vanishes must surface to the
        caller as a loud failure, never a silent hang; "crash"
        (FaultCrash) propagates so the run loop takes the node down."""
        from tensorlink_tpu_torch.core import faults

        if not faults.ENABLED:
            return
        act = faults.inject("control.frame", verb)
        if act == "drop":
            raise faults.FaultInjected(
                f"injected control-frame drop at {verb}"
            )
        if isinstance(act, tuple) and act[0] == "delay":
            await asyncio.sleep(act[1])

    async def cmd_status(self, p) -> dict:
        return self.status()

    async def cmd_validators(self, p) -> list[str]:
        return self.validator_ids()

    async def cmd_peers(self, p) -> list[str]:
        """Full node ids of live connections (``status`` truncates ids for
        display; session recovery needs exact membership to tell which
        stage workers died)."""
        return list(self.connections)

    async def cmd_bootstrap(self, p) -> int:
        seeds = [tuple(s) for s in p.get("seeds", self.cfg.seed_validators)]
        return await self.bootstrap(seeds, retries=p.get("retries", 3))

    async def cmd_connect(self, p) -> str:
        conn = await self.connect(p["host"], p["port"])
        return conn.node_id

    async def cmd_disconnect(self, p) -> bool:
        """Close the connection to a peer by id (or unique id prefix) —
        ops/testing surface for pruning a mesh link. An ambiguous prefix
        matches nothing rather than severing an arbitrary peer."""
        pid = p.get("peer", "")
        if not pid:
            return False
        matches = [c for nid, c in self.connections.items()
                   if nid.startswith(pid)]
        if len(matches) != 1:
            return False
        await matches[0].close()
        return True

    async def cmd_dht_get(self, p):
        return await self.dht_query(p["key"])

    async def cmd_dht_store(self, p) -> bool:
        await self.dht_store_global(p["key"], p["value"])
        return True

    async def cmd_set_capacity(self, p) -> bool:
        self.capacity.update(p)
        return True

    async def cmd_tensor_request(self, p) -> dict:
        """Generic correlated array-carrying request to a peer."""
        reply = await self.tensor_request(
            self._conn(p["peer"]), p["tag"], p.get("body", {}),
            timeout=p.get("timeout"),
        )
        reply.pop("_rid", None)
        reply.pop("_resp", None)
        return reply

    async def cmd_send_tensor(self, p) -> bool:
        await self.send_tensor(self._conn(p["peer"]), p["tag"], p.get("body", {}))
        return True

    async def cmd_chain_send(self, p) -> bool:
        """Forward a chained-stage frame to the NEXT stage's worker by
        address, dialing on demand (ml/worker.py::_finish_fwd — worker-to-
        worker pipelined forward; connect() dedupes by address)."""
        addr = p["addr"]
        conn = await self.connect(addr[0], int(addr[1]))
        await self.send_tensor(conn, p["tag"], p.get("body", {}))
        return True

    async def cmd_respond(self, p) -> bool:
        """Resolve an earlier inbound tensor request (ML finished the work)."""
        await self.tensor_respond(
            self._conn(p["peer"]), p["tag"], {"_rid": p["rid"]}, p.get("body", {})
        )
        return True

    async def cmd_send_control(self, p) -> bool:
        """Generic fire-and-forget control frame to a peer."""
        await self._conn(p["peer"]).send_control(p["tag"], p.get("body", {}))
        return True

    async def cmd_control_request(self, p) -> dict:
        """Generic correlated control-frame request to a peer."""
        reply = await self.request(
            self._conn(p["peer"]), p["tag"], p.get("body", {}),
            timeout=p.get("timeout"),
        )
        reply.pop("_rid", None)
        reply.pop("_resp", None)
        return reply

    async def cmd_send_token(self, p) -> bool:
        await self.send_token(
            self._conn(p["peer"]), p["stream"], p.get("tokens", []),
            done=p.get("done", False),
        )
        return True

    async def cmd_next_tokens(self, p):
        try:
            tokens, done = await self.next_tokens(
                p["stream"], timeout=p.get("timeout", 30.0)
            )
            if done:
                self.drop_stream(p["stream"])
            return {"tokens": tokens, "done": done}
        except asyncio.TimeoutError:
            return {"tokens": [], "done": False, "timeout": True}

    async def cmd_drop_stream(self, p) -> bool:
        """Release a stream buffer without draining it to the done marker
        (stop-sequence cancel stops forwarding early; the generation's
        trailing tokens would otherwise sit in the buffer forever)."""
        self.drop_stream(p["stream"])
        return True

    # -- stats ----------------------------------------------------------
    async def _handle_stats_request(self, conn, kind, tag, body) -> None:
        free = self.capacity["hbm_bytes"] - sum(self.reserved.values())
        await self.respond(
            conn, proto.STATS_RESPONSE, body,
            {**self.capacity, "free_bytes": max(free, 0.0), "id": self.node_id},
        )


class WorkerServer(RoleServer):
    """Accepts jobs when capacity allows; relays tensor work to the ML
    process (reference WorkerThread, nodes/worker_thread.py:14)."""

    def __init__(self, cfg: NodeConfig, queues: BridgeQueues):
        super().__init__(cfg, queues)
        self.jobs: dict[str, dict] = {}
        # stream id -> cancelled row indices (STREAM_CANCEL pushes from the
        # driving user); the ML generate loop polls these at chunk
        # boundaries via cmd_poll_cancel so a confirmed stop-sequence match
        # ends the compiled decode within one chunk
        self.stream_cancels: dict[str, set] = {}
        self.register(proto.JOB_REQ, self._handle_job_req)
        self.register(proto.JOB_SHUTDOWN, self._handle_job_shutdown)
        self.register(proto.MODULE, self._handle_module)
        self.register(proto.STREAM_CANCEL, self._handle_stream_cancel)
        for tag in (
            proto.FORWARD, proto.BACKWARD, proto.GENERATE,
            proto.PARAMS_REQ, proto.OPTIMIZER, proto.TRAIN_MODE,
            proto.CHECKPOINT, proto.PROOF_REQ,
            # live slot migration: DRAIN from a validator, MIGRATE
            # (probe / page transfer) worker-to-worker; HANDOFF pushes
            # the decode-pool membership a prefill worker ships to;
            # REPLICA_SET pushes the sibling-replica membership a fleet
            # entry worker may drain onto (docs/SERVING.md "Fleet
            # serving")
            proto.DRAIN, proto.MIGRATE, proto.HANDOFF, proto.REPLICA_SET,
        ):
            self.register(tag, self._relay_to_ml)

    async def _handle_job_req(self, conn, kind, tag, body) -> None:
        """Validator recruiting (reference worker_thread.py:128-166):
        accept iff free capacity covers the stage estimate."""
        est = float(body.get("est_bytes", 0.0))
        free = self.capacity["hbm_bytes"] - sum(self.reserved.values())
        job_id = body.get("job_id", "")
        if est and est > free:
            await self.respond(conn, proto.JOB_DECLINE, body, {"job_id": job_id})
            return
        self.reserved[job_id] = est
        self.jobs[job_id] = {"stage": body.get("stage"), "t0": time.time()}
        await self.respond(
            conn, proto.JOB_ACCEPT, body,
            {"job_id": job_id, "id": self.node_id,
             "addr": [self.host, self.port]},
        )

    async def _handle_job_shutdown(self, conn, kind, tag, body) -> None:
        job_id = body.get("job_id", "")
        self.reserved.pop(job_id, None)
        self.jobs.pop(job_id, None)
        self.post_work("shutdown_job", {"job_id": job_id})

    async def _handle_module(self, conn, kind, tag, body) -> None:
        """A stage assignment arrives (plan + model config + ckpt ref).
        ML loads it and resolves the request via the ``respond`` cmd."""
        self.post_work(
            "load_stage",
            {**{k: v for k, v in body.items() if k not in ("_rid",)},
             "peer": conn.node_id, "rid": body.get("_rid")},
        )

    async def _relay_to_ml(self, conn, kind, tag, body) -> None:
        rid = body.pop("_rid", None)
        body.pop("_resp", None)
        self.post_work(tag, {**body, "peer": conn.node_id, "rid": rid})

    async def _handle_stream_cancel(self, conn, kind, tag, body) -> None:
        """Record confirmed stop-sequence cancels for a streamed generate.
        Kept server-side (not relayed through the work queue): the ML run
        loop is busy inside the generate and polls via cmd_poll_cancel."""
        rows = self.stream_cancels.setdefault(str(body.get("stream", "")), set())
        rows.update(int(r) for r in body.get("rows", []))
        if len(self.stream_cancels) > 1024:  # stale-stream bound
            self.stream_cancels.pop(next(iter(self.stream_cancels)))

    async def cmd_poll_cancel(self, p) -> list[int]:
        return sorted(self.stream_cancels.get(p.get("stream", ""), ()))

    async def cmd_clear_cancels(self, p) -> bool:
        self.stream_cancels.pop(p.get("stream", ""), None)
        return True


class ValidatorServer(RoleServer):
    """Job orchestration (reference ValidatorThread,
    nodes/validator_thread.py:22). Plans come from the validator ML process;
    this side recruits workers and answers users."""

    def __init__(self, cfg: NodeConfig, queues: BridgeQueues):
        super().__init__(cfg, queues)
        from tensorlink_tpu_torch.platform.contract import ContractManager
        from tensorlink_tpu_torch.platform.job_monitor import JobMonitor
        from tensorlink_tpu_torch.platform.keeper import Keeper

        self.jobs: dict[str, dict] = {}
        self._job_requests: dict[str, tuple[Connection, dict]] = {}
        self.keeper = Keeper(Path(cfg.log_dir) / "dht_state.json")
        self.monitor = JobMonitor(self)
        chain = None
        if not cfg.off_chain:
            raise unported("on-chain mode (platform/chain.py)", 7)
        self.contract = ContractManager(self.node_id, chain=chain)
        self.worker_capacity_total = 0.0
        # workers seen disconnecting since the last proposal round —
        # keeper.clean_node prunes addresses/roles, so the proposal's
        # offline list must come from its own record
        self.offline_workers: dict[str, float] = {}
        from tensorlink_tpu_torch.p2p.monitor import RateLimiter

        # per-IP JOB_REQ rate limiting: a connected (authenticated) peer must
        # not be able to spam planning work — each request costs the ML
        # process a full plan_sharding pass (reference
        # validator_thread.py:508-516; r2 gap — only connection attempts
        # were limited)
        self.job_req_limiter = RateLimiter(
            max_per_minute=JOB_REQS_PER_MINUTE, block_s=600.0
        )
        self._restore_state()
        self.register(proto.JOB_REQ, self._handle_job_req)
        self.register(proto.JOB_SHUTDOWN, self._handle_job_shutdown)
        self.register(proto.JOB_REPAIR, self._handle_job_repair)
        self.register(proto.PROPOSAL, self._handle_proposal)
        self.register(proto.REQUEST_WORKERS, self._handle_request_workers)
        # workers advertised by OTHER validators (id -> [host, port]) so a
        # plan can place stages on them; connections are made lazily at
        # recruit time (reference REQUEST-WORKERS, validator_thread.py:889-928)
        self.remote_workers: dict[str, list] = {}

    def _restore_state(self) -> None:
        """Reload persisted DHT entries + stats (reference keeper restore at
        validator startup, validator_thread.py:135-137)."""
        state = self.keeper.load_previous_state()
        for k, ts in state.get("dht_tombstones", {}).items():
            try:
                self.dht.delete(k, ts=float(ts))
            # tlint: disable=TL005(malformed persisted tombstone — skip it, keep restoring the rest)
            except (TypeError, ValueError):
                continue
        for k, v in state.get("dht", {}).items():
            # restore with the ORIGIN ts — an untimestamped store would
            # stamp restart-time and beat every write/delete that happened
            # while this validator was down (stale-resurrection)
            try:
                ts = float(v.get("ts"))
            except (TypeError, ValueError):
                ts = None
            self.dht.store(k, v.get("value"), ts=ts)
        self.reputation.load_json(state.get("reputation", {}))
        now = time.time()
        for jid, j in state.get("jobs", {}).items():
            j.setdefault("t0_restored", now)  # don't credit downtime
            self.jobs.setdefault(jid, j)

    def on_started(self) -> None:
        asyncio.run_coroutine_threadsafe(self._platform_loop(), self._loop)

    def on_shutdown(self) -> None:
        self.keeper.write_state(self)

    def _on_disconnect(self, conn) -> None:
        if conn.node_id and self.roles.get(conn.node_id) == "worker":
            self.offline_workers[conn.node_id] = time.time()
        super()._on_disconnect(conn)

    async def _platform_loop(self) -> None:
        """Keeper writes, job monitoring, stats, contract rounds — the
        validator run loop's periodic duties (validator_thread.py:978-1011)."""
        last_keeper = last_round = time.monotonic()
        interval = max(min(self.cfg.monitor_interval, self.cfg.keeper_interval), 0.5)
        while not self.terminate.is_set():
            await asyncio.sleep(min(interval, self.cfg.monitor_interval))
            try:
                await self.monitor.check_jobs()
                self.keeper.update_statistics(self)
                self.keeper.clean_node(self)
                now = time.monotonic()
                if now - last_keeper >= self.cfg.keeper_interval:
                    self.keeper.write_state(self)
                    last_keeper = now
                if (
                    self.cfg.proposal_interval
                    and now - last_round >= self.cfg.proposal_interval
                ):
                    await self._run_proposal_round()
                    last_round = now
            except Exception:
                self.log.exception("platform loop iteration failed")

    # -- worker replacement (net-new working path; reference stubs it,
    # job_monitor.py:293-328) -------------------------------------------
    async def replace_worker(self, job_id: str, dead_wid: str) -> dict | None:
        """Recruit a spare worker for a dead stage; rewrite plan + DHT and
        push JOB_UPDATE to the user. Returns the update dict or None."""
        job = self.jobs.get(job_id)
        if job is None:
            # failover: the validator that created the job may be gone, but
            # its record replicated (dht_store_global + validator sync) —
            # adopt it and become the monitoring validator
            record = self.dht.get_local(f"job:{job_id}") or await self.dht_query(
                f"job:{job_id}"
            )
            if not isinstance(record, dict) or "plan" not in record:
                return None
            job = dict(record)
            job["t0_restored"] = time.time()
            self.jobs[job_id] = job
            self.log.info("job %s: adopted from replicated DHT record", job_id[:8])
        stages = [
            s for s in job.get("plan", {}).get("stages", [])
            if s["worker_id"] == dead_wid
        ]
        if not stages:
            return None
        current = set(job.get("workers", {}))
        candidates = [
            nid for nid in self.connections
            if self.roles.get(nid) == "worker" and nid not in current
        ]
        est = float(job.get("stage_bytes", {}).get(dead_wid, 0.0))
        for cand in candidates:
            try:
                reply = await self.request(
                    self._conn(cand), proto.JOB_REQ,
                    {"job_id": job_id, "stage": stages[0], "est_bytes": est},
                    timeout=RECRUIT_TIMEOUT,
                )
            # tlint: disable=TL005(recruit probe — a dead/slow candidate just means try the next one)
            except (TimeoutError, asyncio.TimeoutError, ConnectionError):
                continue
            if "addr" not in reply:
                continue
            host, _ = self.addresses.get(cand, (None, None))
            addr = [host or reply["addr"][0], reply["addr"][1]]
            for s in stages:
                s["worker_id"] = cand
            job["workers"].pop(dead_wid, None)
            job["workers"][cand] = addr
            job["stage_bytes"][cand] = job.get("stage_bytes", {}).pop(dead_wid, est)
            await self.dht_store_global(f"job:{job_id}", _json_safe(job))
            update = {
                "job_id": job_id,
                "old_worker": dead_wid,
                "worker": {"id": cand, "addr": addr},
                "stages": [s["layer_lo"] for s in stages],
            }
            user_conn = self.connections.get(job.get("user_id", ""))
            if user_conn is not None:
                try:
                    await user_conn.send_control(proto.JOB_UPDATE, update)
                except (ConnectionError, OSError) as e:
                    # the user will pull the replacement via JOB_REPAIR
                    self.log.warning(
                        "job %s: JOB_UPDATE push to user failed (%s)",
                        job_id[:8], e,
                    )
            self.reputation.record(dead_wid, "worker_dropped")
            self.log.info(
                "job %s: replaced worker %s -> %s", job_id[:8],
                dead_wid[:8], cand[:8],
            )
            return update
        self.log.warning("job %s: no replacement for %s", job_id[:8], dead_wid[:8])
        return None

    async def _handle_job_repair(self, conn, kind, tag, body) -> None:
        """User pulls a replacement synchronously after a failed request."""
        update = await self.replace_worker(
            body.get("job_id", ""), body.get("worker_id", "")
        )
        await self.respond(
            conn, proto.JOB_UPDATE, body,
            update or {"error": "no replacement available"},
        )

    async def _handle_job_shutdown(self, conn, kind, tag, body) -> None:
        """User ends a job: drop validator state + DHT record and make sure
        the workers released it (idempotent on their side)."""
        job = self.jobs.get(body.get("job_id", ""))
        if job is not None:
            self.contract.record_job(job)
        await self.cmd_shutdown_job({"job_id": body.get("job_id", "")})

    # -- contract / stats commands --------------------------------------
    async def _run_proposal_round(self) -> dict:
        """Create → collect validator votes → execute one reward round
        (reference proposal_creator flow, contract_manager.py:317-683):
        the full proposal body goes to every connected validator, each
        recomputes the hash and votes; quorum over validators + self."""
        offline = [
            nid for nid in self.offline_workers if nid not in self.connections
        ]
        self.offline_workers.clear()
        prop = self.contract.create_proposal(offline)
        h = prop.hash()
        await self.dht_store_global(f"proposal:{h}", prop.to_json())
        self.contract.vote(h, self.node_id, True)
        for vid in self.validator_ids():
            try:
                reply = await self.request(
                    self._conn(vid), proto.PROPOSAL,
                    {"proposal": prop.to_json(), "hash": h},
                    timeout=10.0,
                )
                self.contract.vote(h, vid, bool(reply.get("approve")))
            # tlint: disable=TL005(a validator missing a vote round is normal liveness; quorum math tolerates it)
            except (TimeoutError, asyncio.TimeoutError, ConnectionError):
                continue
        n_validators = len(self.validator_ids()) + 1
        executed = self.contract.try_execute(h, n_validators)
        record = prop.to_json()
        self.keeper.proposals.append(record)
        self.log.info("proposal round %d: executed=%s", prop.round, executed)
        return record

    async def _handle_proposal(self, conn, kind, tag, body) -> None:
        """Another validator asks for our vote: recompute the hash from the
        full body (reference proposal_validator, contract_manager.py:45-242)."""
        ok = False
        try:
            ok = self.contract.validate_proposal(
                body.get("proposal", {}), body.get("hash", "")
            )
        except Exception:
            self.log.exception("proposal validation failed")
        if not ok:
            self.reputation.record(conn.node_id or "", "proposal_mismatch")
        await self.respond(conn, proto.PROPOSAL_VOTE, body, {"approve": ok})

    # -- proof of learning (monitor pull path; reference job_monitor.py
    # PoL hooks are commented out, :193-207 — here they enforce) ----------
    async def collect_job_proofs(self, job_id: str) -> dict:
        """Pull + verify each worker's PoL log for a job; failed
        verification flags the job record and dings worker reputation."""
        job = self.jobs.get(job_id)
        if job is None:
            return {"error": "unknown job"}

        async def pull(wid: str) -> tuple[str, dict] | None:
            conn = self.connections.get(wid)
            if conn is None:
                return None  # liveness is the monitor's concern, not PoL's
            try:
                reply = await self.request(
                    conn, proto.PROOF_REQ, {"job_id": job_id}, timeout=10.0
                )
            except (TimeoutError, asyncio.TimeoutError, ConnectionError):
                return wid, {"ok": False, "reason": "unreachable"}
            if "log" not in reply:
                # worker-side error (e.g. job released in a shutdown race) —
                # not a passing verdict, but not evidence of faked work
                return wid, {
                    "ok": False, "reason": "no-log",
                    "error": str(reply.get("error", ""))[:200],
                }
            log = reply.get("log", [])
            total = int(reply.get("total_steps", 0) or 0)
            ok, detail = verify_proof_log(log)
            if ok and total > 0 and not log:
                # claiming optimizer steps while returning no entries is the
                # trivial bypass of an "empty log passes" rule — flag it
                ok, detail = False, {"reason": "empty-log-with-steps"}
            return wid, {"ok": ok, **detail, "total_steps": total}

        results = await asyncio.gather(
            *(pull(w) for w in list(job.get("workers", {})))
        )
        verdicts = dict(r for r in results if r is not None)
        # SOFT_REASONS are liveness matters (busy worker timing out a pull,
        # shutdown-race error replies), not evidence of faked work — but a
        # worker that NEVER verifiably answers is opting out of PoL, so
        # persistent softness escalates to one penalty per streak. Hard
        # verification failures are rate-limited per worker instead of
        # keyed by chain position (position keys either collide forever —
        # the empty-log faker pays once — or churn every pull as the window
        # slides): one glitch costs one ding that decays, while a
        # persistent cheat re-dings every cooldown and reaches the ban
        # threshold in ~3 cooldowns.
        SOFT_REASONS = ("unreachable", "no-log")
        SOFT_STREAK_LIMIT = 5
        PENALTY_COOLDOWN_S = 600.0
        dinged = job.setdefault("pol_dinged", {})  # wid -> last penalty ts
        misses = job.setdefault("pol_misses", {})  # wid -> consecutive softs
        now = time.time()
        for wid, v in verdicts.items():
            if v["ok"]:
                misses.pop(wid, None)
                continue
            if v.get("reason") in SOFT_REASONS:
                misses[wid] = misses.get(wid, 0) + 1
                if misses[wid] >= SOFT_STREAK_LIMIT:
                    self.reputation.record(wid, "proof_failed")
                    misses[wid] = 0
            else:
                misses.pop(wid, None)
                # tlint: disable=TL004(dinged stamps ride the persisted job record — epoch by design)
                if now - dinged.get(wid, 0.0) > PENALTY_COOLDOWN_S:
                    self.reputation.record(wid, "proof_failed")
                    dinged[wid] = now
            self.log.warning(
                "job %s: PoL verification failed for %s: %s",
                job_id[:8], wid[:8], v,
            )
        job["pol"] = {"ts": time.time(), "verdicts": verdicts}
        return job["pol"]

    async def cmd_job_proofs(self, p) -> dict:
        return await self.collect_job_proofs(p["job_id"])

    async def cmd_run_proposal_round(self, p) -> dict:
        return await self._run_proposal_round()

    async def cmd_proposal_history(self, p) -> list[dict]:
        return list(self.keeper.proposals)

    async def cmd_claim_info(self, p) -> dict:
        for h, prop in reversed(list(self.contract.proposals.items())):
            claim = self.contract.claim_data(h, p["worker_id"])
            if claim is not None:
                return claim
        return {"error": "no executed proposal covers this worker"}

    async def cmd_network_history(self, p) -> dict:
        return self.keeper.get_network_status(self)

    async def _handle_job_req(self, conn, kind, tag, body) -> None:
        """A user asks for a model (reference validator_thread.py:583-609).
        Hand the spec to the validator ML process for planning."""
        # key on the socket peer address (untainted), not the advertised
        # handshake address a peer could rotate to evade the limit
        try:
            ip = conn.peername[0]
        except Exception:
            ip = (self.addresses.get(conn.node_id) or ("?",))[0]
        if not self.job_req_limiter.allow(str(ip)):
            self.log.warning("rate-limiting job requests from %s", ip)
            self.reputation.record(conn.node_id or "", "spam")
            await self.respond(
                conn, proto.JOB_DECLINE, body,
                {"error": "job request rate limit exceeded"},
            )
            return
        req_id = uuid.uuid4().hex
        self._job_requests[req_id] = (conn, body)
        self.post_work(
            "job_req",
            {"spec": body.get("spec", {}), "user_id": conn.node_id,
             "req_id": req_id},
        )

    async def _own_worker_stats(self) -> list[dict]:
        """Fan STATS_REQUEST out to this validator's connected workers
        CONCURRENTLY (one slow worker must not serialize the sweep — the
        peer validator asking via REQUEST-WORKERS waits on the total),
        tagging each with its reachable listen address."""

        async def one(nid: str) -> dict | None:
            try:
                reply = await self.request(
                    self._conn(nid), proto.STATS_REQUEST, {}, timeout=5.0
                )
            except (TimeoutError, asyncio.TimeoutError, ConnectionError):
                return None
            stat = {k: v for k, v in reply.items()
                    if k not in ("_rid", "_resp")}
            addr = self.addresses.get(nid)
            if addr:
                stat["addr"] = list(addr)
            return stat

        wids = [nid for nid in list(self.connections)
                if self.roles.get(nid) == "worker"]
        replies = await asyncio.gather(*(one(n) for n in wids))
        return [s for s in replies if s is not None]

    async def cmd_stats_workers(self, p) -> list[dict]:
        """Worker pool for planning: this validator's own workers PLUS the
        pools of its validator peers (reference REQUEST-WORKERS,
        validator_thread.py:889-928) — so a job can be placed on a worker
        known only to another validator. Own stats win on id collision (a
        worker connected to several validators)."""
        out = await self._own_worker_stats()
        seen = {s.get("id") for s in out}

        async def ask(nid: str) -> list[dict]:
            try:
                reply = await self.request(
                    self._conn(nid), proto.REQUEST_WORKERS, {}, timeout=7.0
                )
            except (TimeoutError, asyncio.TimeoutError, ConnectionError):
                return []
            return list(reply.get("workers", []))

        vids = [nid for nid in list(self.connections)
                if self.roles.get(nid) == "validator"]
        peer_pools = await asyncio.gather(*(ask(n) for n in vids))
        advertised: dict[str, list] = {}
        for pool in peer_pools:
            for stat in pool:
                wid = stat.get("id")
                if not wid or wid in seen:
                    continue
                seen.add(wid)
                if stat.get("addr"):
                    advertised[wid] = list(stat["addr"])
                out.append(stat)
        # rebuilt wholesale each sweep so departed workers' addresses are
        # pruned rather than accumulating for the process lifetime
        self.remote_workers = advertised
        self.worker_capacity_total = sum(
            float(s.get("hbm_bytes", 0.0)) for s in out
        )
        return out

    def _resolve_worker(self, prefix: str) -> str | None:
        """Unique connected worker whose id starts with ``prefix`` (ops
        surfaces pass truncated ids); ambiguity matches nothing."""
        matches = [
            nid for nid in self.connections
            if self.roles.get(nid) == "worker" and nid.startswith(prefix)
        ]
        return matches[0] if len(matches) == 1 else None

    async def cmd_drain_worker(self, p) -> dict:
        """Operator surface for live slot migration (docs/SERVING.md
        "Draining a worker"): tell ``worker`` to shed every live serving
        slot onto ``dest`` — page-shipping migration with the
        crash-recovery re-prefill as the fallback rung, zero dropped
        streams. ``dest`` defaults to the connected worker with the most
        free capacity; the DRAIN body carries the destination's id and
        LISTEN address so the source can dial it worker-to-worker."""
        await self._control_fault("drain_worker")
        src = self._resolve_worker(str(p.get("worker", "")))
        if src is None:
            return {"ok": False, "error": "unknown or ambiguous worker"}
        dest = None
        if p.get("dest"):
            dest = self._resolve_worker(str(p["dest"]))
            if dest is None or dest == src or dest not in self.addresses:
                # an EXPLICITLY named destination that doesn't resolve
                # stays a loud error — silently draining onto a fallback
                # the operator never chose is worse than refusing
                return {"ok": False, "error": "no usable destination worker"}
        else:
            # destination choice: most free capacity among the OTHER
            # connected workers with a known listen address
            stats = await self._own_worker_stats()
            ranked = sorted(
                (s for s in stats
                 if s.get("id") != src and s.get("id") in self.addresses),
                key=lambda s: -float(
                    s.get("free_bytes", s.get("hbm_bytes", 0.0))
                ),
            )
            dest = ranked[0]["id"] if ranked else None
        if dest is not None and (dest == src or dest not in self.addresses):
            dest = None
        if dest is None:
            # no candidate from here — still send the DRAIN: a fleet
            # entry worker holds a REPLICA_SET push and can drain onto
            # its sibling replica itself (docs/SERVING.md "Fleet
            # serving"); a worker with neither answers with the error
            body = {}
        else:
            body = {"dest": {"id": dest, "addr": list(self.addresses[dest])}}
        reply = await self.request(
            self._conn(src), proto.DRAIN,
            body,
            # generous default: a drain to a COLD destination ships the
            # whole stage (up to ~130s) before the per-slot transfers
            # (60s each) — a shorter operator timeout would report a
            # still-succeeding drain as failed and lose its summary
            timeout=float(p.get("timeout", 600.0)),
        )
        reply.pop("_rid", None)
        reply.pop("_resp", None)
        return {**reply, "dest": dest}

    async def _handle_request_workers(self, conn, kind, tag, body) -> None:
        """A validator peer asks for this validator's spare workers. Answer
        with OWN workers only — never relayed ones — so a two-validator
        cycle cannot amplify into a request storm. The stats sweep runs as
        a task: handlers are awaited inline on the connection's read loop
        (p2p/node.py::_on_frame), and a multi-second fan-out must not
        head-of-line-block every other frame on this link."""
        if self.roles.get(conn.node_id) != "validator":
            await self.respond(conn, proto.WORKERS, body, {"workers": []})
            return

        async def answer() -> None:
            stats = await self._own_worker_stats()
            try:
                await self.respond(conn, proto.WORKERS, body, {"workers": stats})
            # tlint: disable=TL005(the asking validator hung up while we gathered stats — nobody to answer)
            except (ConnectionError, OSError):
                pass

        t = asyncio.ensure_future(answer())
        self._conn_tasks.add(t)
        t.add_done_callback(self._conn_tasks.discard)

    async def _worker_conn(self, wid: str) -> Connection:
        """Connection to a worker, dialing out lazily when the worker is
        known only via another validator's REQUEST-WORKERS advertisement."""
        conn = self.connections.get(wid)
        if conn is not None:
            return conn
        addr = self.remote_workers.get(wid)
        if not addr:
            raise ConnectionError(f"no connection to {wid[:12]}")
        conn = await self.connect(addr[0], int(addr[1]))
        if conn.node_id != wid:
            raise ConnectionError(
                f"worker at {addr[0]}:{addr[1]} is {conn.node_id[:12]}, "
                f"not {wid[:12]}"
            )
        return conn

    async def cmd_create_job(self, p) -> dict:
        """Recruit the planned workers, store the job, answer the user.

        ``p`` = {req_id, job: {job_id, model, plan}} from the validator ML.
        Recruiting = JOB_REQ to each stage's worker with a 3 s accept window
        (reference recruit_worker, validator_thread.py:845-887).
        """
        await self._control_fault("create_job")
        job = p["job"]
        job_id = job["job_id"]
        plan = job["plan"]
        accepted: dict[str, list] = {}
        declined: list[str] = []
        for stage in plan["stages"]:
            wid = stage["worker_id"]
            # co-slice members share the stage's reservation — each must
            # accept (and reserve its share) or the whole recruit fails
            members = [wid] + [
                c for c in stage.get("coworkers", []) if c not in accepted
            ]
            est = job.get("stage_bytes", {}).get(wid, 0.0) / max(len(members), 1)
            for member in members:
                if member in accepted:
                    continue
                try:
                    reply = await self.request(
                        await self._worker_conn(member), proto.JOB_REQ,
                        {"job_id": job_id, "stage": stage, "est_bytes": est},
                        timeout=RECRUIT_TIMEOUT,
                    )
                except (TimeoutError, asyncio.TimeoutError, ConnectionError):
                    declined.append(member)
                    continue
                if "addr" not in reply:  # decline replies carry no address
                    declined.append(member)
                else:
                    # the worker reports its *bind* host (may be 0.0.0.0);
                    # the routable address is the one this validator observed
                    # at handshake (P2PNode.addresses) + the advertised
                    # listen port
                    host, _ = self.addresses.get(member, (None, None))
                    accepted[member] = [
                        host or reply["addr"][0], reply["addr"][1]
                    ]

        ok = not declined
        if not ok:
            # release reservations on the workers that already accepted —
            # otherwise every failed recruit permanently shrinks their
            # advertised free capacity
            for wid in accepted:
                try:
                    await self._conn(wid).send_control(
                        proto.JOB_SHUTDOWN, {"job_id": job_id}
                    )
                # tlint: disable=TL005(best-effort reservation release — a dead worker frees it by dying)
                except (ConnectionError, OSError):
                    pass
        result = {
            "job_id": job_id,
            "accepted": ok,
            "workers": accepted,
            "declined": declined,
            "model": job.get("model"),
            "plan": plan,
        }
        if ok:
            self.jobs[job_id] = {
                "job_id": job_id, "plan": plan, "workers": accepted,
                "user_id": p.get("user_id"), "t0": time.time(),
                "model": job.get("model", {}).get("name", ""),
                "stage_bytes": dict(job.get("stage_bytes", {})),
                "status": "active",
            }
            await self.dht_store_global(f"job:{job_id}", _json_safe(self.jobs[job_id]))

        if ok:
            # disaggregated prefill/decode: the validator ML's plan named
            # which recruited workers serve the prefill pool and which
            # decode workers they should hand completed prefills to —
            # push the membership now (fire-and-forget; a worker that
            # never hears it simply serves mixed, never a failed job)
            for wid, pool in (job.get("handoff_push") or {}).items():
                if wid not in accepted:
                    continue
                try:
                    await (await self._worker_conn(wid)).send_control(
                        proto.HANDOFF, {"job_id": job_id, "pool": pool}
                    )
                # tlint: disable=TL005(best-effort pool push — an unreached prefill worker degrades to mixed serving)
                except Exception as e:
                    # truly fire-and-forget: a re-dial here can also raise
                    # asyncio.TimeoutError / HandshakeError, and NONE of
                    # them may abort cmd_create_job — the job is already
                    # recruited and the JOB_ACCEPT below must still send
                    self.log.warning(
                        "job %s: handoff-pool push to %s failed: %s",
                        job_id[:8], wid[:8], e,
                    )
        req = self._job_requests.pop(p.get("req_id", ""), None)
        if req is not None:
            conn, body = req
            await self.respond(conn, proto.JOB_ACCEPT if ok else proto.JOB_DECLINE,
                               body, result)
        return result

    async def cmd_set_handoff_pool(self, p) -> dict:
        """Operator surface for disaggregated serving (docs/SERVING.md
        "Disaggregated prefill/decode"): push a decode-pool membership to
        ``worker`` (a prefill-pool worker). ``pool`` defaults to every
        connected worker advertising ``serving_role == "decode"`` — the
        refresh an operator runs after decode workers join or leave, the
        same information recruit-time pushes carry automatically."""
        await self._control_fault("set_handoff_pool")
        wid = self._resolve_worker(str(p.get("worker", "")))
        if wid is None:
            return {"ok": False, "error": "unknown or ambiguous worker"}
        pool = p.get("pool")
        if pool is None:
            stats = await self._own_worker_stats()
            pool = [
                {"id": s["id"], "addr": list(s["addr"])}
                for s in stats
                if str(s.get("serving_role") or "mixed") == "decode"
                and s.get("addr") and s["id"] != wid
            ]
        await self._conn(wid).send_control(proto.HANDOFF, {"pool": pool})
        return {"ok": True, "pool": [str(x.get("id", ""))[:16] for x in pool]}

    async def cmd_set_replica_set(self, p) -> dict:
        """Fleet serving (docs/SERVING.md "Fleet serving"): push a
        sibling-replica membership to ``worker`` — the entry worker of
        one replica of a hosted fleet. Mirrors the HANDOFF pool push:
        fire-and-forget wire state the worker uses when a DRAIN arrives
        with no explicit destination (the autopilot's rolling deploy
        drains a replica onto a sibling), scoped to the replica's own
        ``job_id``. ``peers`` is ``[{id, addr, job_id}, ...]`` naming the
        OTHER replicas' entry workers."""
        await self._control_fault("set_replica_set")
        wid = self._resolve_worker(str(p.get("worker", "")))
        if wid is None:
            return {"ok": False, "error": "unknown or ambiguous worker"}
        peers = []
        for e in p.get("peers") or []:
            pid = self._resolve_worker(str(e.get("id", "")))
            if pid is None:
                continue
            # the ML process knows worker IDS, not transports — fill each
            # sibling's LISTEN address here, where the net process keeps
            # them (the same table the DRAIN destination uses)
            addr = list(e.get("addr") or self.addresses.get(pid) or [])
            if not addr:
                continue
            peers.append({
                "id": pid, "addr": addr,
                "job_id": str(e.get("job_id", "")),
            })
        await self._conn(wid).send_control(
            proto.REPLICA_SET,
            {"job_id": str(p.get("job_id", "")), "peers": peers},
        )
        return {"ok": True, "peers": [e["id"][:16] for e in peers]}

    async def cmd_expire_migrations(self, p) -> dict:
        """Control-plane recovery (docs/FAILURE_MODEL.md "Control
        plane"): tell ``worker`` to drop its STAGED — exported but never
        committed — migration tickets for ``job_id``, the deterministic
        expiry a restarted validator runs for every journal "mig" intent
        the crash left open. The worker re-checks page conservation after
        dropping; a worker with nothing staged answers ``expired: 0``.
        ``mig`` narrows the expiry to one ticket id."""
        await self._control_fault("expire_migrations")
        wid = self._resolve_worker(str(p.get("worker", "")))
        if wid is None:
            return {"ok": False, "error": "unknown or ambiguous worker"}
        body = {"op": "expire", "job_id": str(p.get("job_id", ""))}
        if p.get("mig"):
            body["mig"] = str(p["mig"])
        reply = await self.request(
            self._conn(wid), proto.MIGRATE, body,
            timeout=float(p.get("timeout", 30.0)),
        )
        reply.pop("_rid", None)
        reply.pop("_resp", None)
        return reply

    async def cmd_decline_job(self, p) -> bool:
        """Planning failed (no capacity / unknown model)."""
        req = self._job_requests.pop(p.get("req_id", ""), None)
        if req is not None:
            conn, body = req
            await self.respond(conn, proto.JOB_DECLINE, body,
                               {"error": p.get("error", "declined")})
        return True

    async def cmd_shutdown_job(self, p) -> bool:
        job = self.jobs.pop(p["job_id"], None)
        if job:
            for wid in job.get("workers", {}):
                self.reputation.record(wid, "job_completed")
                try:
                    await self._conn(wid).send_control(
                        proto.JOB_SHUTDOWN, {"job_id": p["job_id"]}
                    )
                # tlint: disable=TL005(best-effort release — a worker already gone freed its reservation by dying)
                except (ConnectionError, OSError):
                    pass
            await self.dht_delete_global(f"job:{p['job_id']}")
        return True


class UserServer(RoleServer):
    """User-side networking (reference UserThread, nodes/user_thread.py:13).
    The DistributedModel drives everything through generic commands; the only
    role-specific verb is the job request."""

    def __init__(self, cfg: NodeConfig, queues: BridgeQueues):
        super().__init__(cfg, queues)
        self.forward_tokens_to_ml = False  # drained via cmd_next_tokens
        self.job_updates: list[dict] = []  # JOB_UPDATE pushes from validators
        self.register(proto.JOB_UPDATE, self._handle_job_update)

    async def _handle_job_update(self, conn, kind, tag, body) -> None:
        """A validator replaced one of our workers (monitor push path)."""
        body.pop("_rid", None)
        body.pop("_resp", None)
        self.job_updates.append(body)

    async def cmd_job_updates(self, p) -> list[dict]:
        out, self.job_updates = self.job_updates, []
        return out

    async def cmd_request_job(self, p) -> dict:
        """Send JOB_REQ to a connected validator and await the decision
        (reference user_thread.py:242-415, 120 s timeout)."""
        validators = self.validator_ids()
        if not validators:
            raise ConnectionError("no validator connections (bootstrap first)")
        reply = await self.request(
            self._conn(validators[0]), proto.JOB_REQ, {"spec": p.get("spec", {})},
            timeout=p.get("timeout", JOB_REQ_TIMEOUT),
        )
        reply.pop("_rid", None)
        reply.pop("_resp", None)
        return reply


def _json_safe(obj: Any) -> Any:
    return json.loads(json.dumps(obj, default=str))


# tlint: disable=TL006(read-only constant table — never mutated at runtime)
SERVERS = {
    "worker": WorkerServer,
    "validator": ValidatorServer,
    "user": UserServer,
}


def run_server(role: str, cfg: NodeConfig, queues: BridgeQueues) -> None:
    """Entry point for the spawned network process."""
    if cfg.json_logs:
        # the network half logs too — both processes of a node must agree
        # on the structured format for cluster log aggregation
        from tensorlink_tpu_torch.core.logging import set_json_logs

        set_json_logs(True)
    SERVERS[role](cfg, queues).main()
