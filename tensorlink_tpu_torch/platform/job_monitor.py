"""JobMonitor — per-job health, expiry, and REAL worker replacement.

Reference: nodes/job_monitor.py:88 — a 30 s watchdog with an
ACTIVE→PENDING_OFFLINE→FAILED/COMPLETED state machine whose recovery is a
comment ("request another worker", module.py:510-511) and stubbed penalty
hooks (job_monitor.py:293-328). Here replacement is a working, tested path
(SURVEY §5 explicitly calls this out as the gap to close):

- a job whose worker connection drops goes PENDING_OFFLINE;
- the validator recruits a spare worker for the dead stage (same 3 s accept
  window as initial recruiting), rewrites the plan + DHT record, and pushes
  a JOB_UPDATE to the user;
- the user side (DistributedModel._repair) can also *pull* a replacement
  synchronously via JOB_REPAIR when a request fails mid-flight;
- free jobs expire after FREE_JOB_MAX_TIME and completed/failed jobs fold
  into the contract layer's capacity accounting.
"""

from __future__ import annotations

import asyncio
import time

FREE_JOB_MAX_TIME = 3600.0  # reference validator_thread.py:19
OFFLINE_GRACE = 5.0  # default; NodeConfig.offline_grace overrides
PROOF_INTERVAL = 60.0  # seconds between PoL log pulls per job
# a job that keeps losing workers is flapping — endless recruit loops burn
# the spare pool for a job that cannot hold a placement; fail it instead
MAX_REPAIRS_PER_JOB = 16


class JobMonitor:
    """Operates on a ValidatorServer from its event loop."""

    def __init__(self, server):
        self.server = server
        self.grace = float(
            getattr(getattr(server, "cfg", None), "offline_grace", OFFLINE_GRACE)
            or OFFLINE_GRACE
        )

    async def check_jobs(self) -> None:
        now = time.time()
        for job_id, job in list(self.server.jobs.items()):
            status = job.get("status", "active")
            if status in ("failed", "completed"):
                continue
            # tlint: disable=TL004(job t0 is persisted/replicated — epoch is the record's clock)
            if now - job.get("t0", now) > FREE_JOB_MAX_TIME:
                await self._finish(job_id, job, "completed")
                continue
            missing = [
                wid for wid in job.get("workers", {})
                if wid not in self.server.connections
            ]
            if not missing:
                if status != "active":
                    job["status"] = "active"
                job.pop("offline_since", None)  # full self-recovery resets grace
                # healthy job: periodically verify proof-of-learning logs
                # (reference PoL hooks exist but are commented out,
                # job_monitor.py:193-207 — here a bad log costs reputation)
                # tlint: disable=TL004(pol.ts rides the persisted job record — epoch)
                if now - job.get("pol", {}).get("ts", 0.0) > PROOF_INTERVAL:
                    # fire-and-forget: the pull awaits per-worker replies
                    # (10 s timeouts) and must never stall this tick's
                    # OFFLINE_GRACE liveness handling for other jobs; stamp
                    # ts first so a slow pull isn't re-fired every tick
                    job.setdefault("pol", {})["ts"] = now
                    # strong ref + done-callback: the loop holds tasks
                    # weakly, and an unreferenced pull could be GC'd
                    # mid-await (same pattern as P2PNode.sync_dht)
                    t = asyncio.ensure_future(
                        self.server.collect_job_proofs(job_id)
                    )
                    self.server._conn_tasks.add(t)
                    t.add_done_callback(self.server._conn_tasks.discard)
                continue
            job.setdefault("offline_since", now)
            job["status"] = "pending_offline"
            # tlint: disable=TL004(offline_since rides the persisted job record — epoch)
            if now - job["offline_since"] < self.grace:
                continue
            if job.get("repairs", 0) >= MAX_REPAIRS_PER_JOB:
                # flapping: this job has churned through too many
                # replacements — stop feeding it the worker pool
                await self._finish(job_id, job, "failed")
                continue
            ok = True
            for wid in missing:
                update = await self.server.replace_worker(job_id, wid)
                ok = ok and update is not None
                if update is not None:
                    job["repairs"] = job.get("repairs", 0) + 1
            if ok:
                job["status"] = "active"
                job.pop("offline_since", None)
            # tlint: disable=TL004(offline_since rides the persisted job record — epoch)
            elif now - job["offline_since"] > 6 * self.grace:
                await self._finish(job_id, job, "failed")

    async def _finish(self, job_id: str, job: dict, status: str) -> None:
        job["status"] = status
        self.server.contract.record_job(job)
        await self.server.cmd_shutdown_job({"job_id": job_id})
