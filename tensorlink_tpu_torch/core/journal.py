"""ControlJournal — the validator's durable control-plane write-ahead log.

The validator's in-memory state (hosted jobs, replica sets, in-flight
admissions, migration tickets, autopilot actions) is the last single
point of failure in the stack: every data-plane failure has a recovery
ladder, but a validator crash used to strand every live engine and drop
every in-flight stream even though the workers kept decoding. This
module is the durability half of the fix (docs/FAILURE_MODEL.md
"Control plane"):

- **Write-ahead**: intent records (`intent`/`commit`/`abort` triples)
  are fsynced BEFORE the action they describe executes, so a half-done
  rolling deploy or drain is visible at replay — resumed or rolled
  back, never forgotten. Plain records (admissions, token high-water
  marks) are fsync-BATCHED: buffered in memory and flushed when the
  batch fills or the flush window elapses, so the serving hot path
  never pays a per-token fsync.
- **Replay** (:meth:`ControlJournal.replay`) folds the record stream
  into a :class:`JournalState`: live hosted jobs with per-replica
  re-attach payloads, per-request admissions with their delivered-token
  high-water marks, and every intent that never committed. A torn final
  line (the crash landed mid-write) is tolerated and counted, never
  fatal.
- **Reconciliation contract**: the journal is authoritative for
  PLACEMENT (which job/replica/worker a stream was admitted to); the
  WORKER is authoritative for TOKENS (its live slot state survived the
  validator, so its counts can only be >= the journaled high-water
  mark). Recovery (ml/validator.py::recover) re-handshakes each worker
  and merges on that rule.

Record shape — one JSON object per line::

    {"seq": 17, "t": 1699..., "kind": "admit", "data": {...}}
    {"seq": 18, "t": ..., "kind": "mig", "phase": "intent", "iid": "..."}

The ``journal.write`` fault site (core/faults.py) fires per append:
``drop`` silently loses the record (recovery must tolerate holes),
``error`` raises out of :meth:`append` (callers keep serving — a
journal hiccup must never fail a request).
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path

from tensorlink_tpu_torch.core import faults
from tensorlink_tpu_torch.core.logging import get_logger

# record kinds with intent -> commit/abort pairing (everything else is a
# plain single record)
INTENT_KINDS = ("host", "mig", "action")


class ControlJournal:
    """Append-only JSONL journal with batched fsync.

    Thread-safe: API handler threads journal admissions concurrently
    with the autopilot journaling action intents.
    """

    def __init__(
        self,
        path: str | Path,
        *,
        flush_every: int = 16,
        flush_s: float = 0.05,
    ):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.flush_every = max(int(flush_every), 1)
        self.flush_s = float(flush_s)
        self.log = get_logger("core.journal")
        self._lock = threading.Lock()
        self._buf: list[str] = []  #: guarded by self._lock
        self._seq = 0  #: guarded by self._lock
        self._last_flush = time.monotonic()  #: guarded by self._lock
        self._f = open(self.path, "a", encoding="utf-8")
        self._closed = False

    # -- writing ---------------------------------------------------------
    def append(self, kind: str, data: dict | None = None, *,
               phase: str | None = None, iid: str | None = None,
               flush: bool = False) -> int:
        """Append one record; returns its seq. ``flush=True`` forces the
        write-ahead fsync (intents always force). Raises
        :class:`~tensorlink_tpu_torch.core.faults.FaultInjected` when the
        ``journal.write`` fault site fires with op="error"; a "drop"
        decision silently loses the record (the chaos suite's
        lost-record case)."""
        act = None
        if faults.ENABLED:
            act = faults.inject("journal.write", kind)
        with self._lock:
            if self._closed:
                raise RuntimeError("journal is closed")
            self._seq += 1
            seq = self._seq
            if act == "drop":
                return seq  # the record is LOST — replay sees a hole
            rec: dict = {"seq": seq, "t": time.time(), "kind": str(kind)}
            if phase:
                rec["phase"] = phase
            if iid:
                rec["iid"] = iid
            if data:
                rec["data"] = data
            self._buf.append(json.dumps(rec, separators=(",", ":")))
            now = time.monotonic()
            if (
                flush
                or len(self._buf) >= self.flush_every
                or now - self._last_flush >= self.flush_s
            ):
                self._flush_locked(now)
        return seq

    def intent(self, kind: str, data: dict | None = None) -> str:
        """Durably record that ``kind`` is ABOUT to happen (write-ahead:
        fsynced before this returns). Pair with :meth:`commit` /
        :meth:`abort`; an intent neither committed nor aborted is an
        OPEN intent at replay — recovery's resume-or-rollback input."""
        iid = uuid.uuid4().hex
        self.append(kind, data, phase="intent", iid=iid, flush=True)
        return iid

    def commit(self, iid: str, data: dict | None = None,
               *, kind: str = "") -> None:
        self.append(kind or "intent", data, phase="commit", iid=iid,
                    flush=True)

    def abort(self, iid: str, data: dict | None = None,
              *, kind: str = "") -> None:
        self.append(kind or "intent", data, phase="abort", iid=iid,
                    flush=True)

    def _flush_locked(self, now: float | None = None) -> None:  # tlint: holds-lock(self._lock)
        if self._buf:
            self._f.write("\n".join(self._buf) + "\n")
            self._buf.clear()
            self._f.flush()
            os.fsync(self._f.fileno())
        self._last_flush = time.monotonic() if now is None else now

    def flush(self) -> None:
        with self._lock:
            if not self._closed:
                self._flush_locked()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._flush_locked()
            self._closed = True
            self._f.close()

    # -- replay ----------------------------------------------------------
    @staticmethod
    def replay(path: str | Path) -> "JournalState":
        """Fold the journal file into a :class:`JournalState`. Missing
        file → empty state. A torn final line (crash mid-write) is
        skipped and counted; a torn line ANYWHERE else is also skipped
        (a dropped-record fault leaves the same shape) — replay is
        total, never raises on journal contents."""
        st = JournalState()
        p = Path(path)
        if not p.exists():
            return st
        lines = p.read_text(encoding="utf-8").splitlines()
        for ln in lines:
            ln = ln.strip()
            if not ln:
                continue
            try:
                rec = json.loads(ln)
            except ValueError:
                st.torn += 1
                continue
            if isinstance(rec, dict):
                st._fold(rec)
        return st


@dataclass
class JournalState:
    """The replayed view of a control journal — what recovery consumes."""

    records: int = 0
    torn: int = 0  # unparseable (torn / corrupted) lines skipped
    #: name -> {"data": host-intent data, "committed": bool,
    #:          "unhosted": bool, "replicas": {rid: replica_up data}}
    jobs: dict = field(default_factory=dict)
    #: jrid -> {"data": admit data, "hwm": int, "finished": bool,
    #:          "seed": int | None, "reason": str}
    admissions: dict = field(default_factory=dict)
    #: iid -> {"kind", "data", "state": intent|commit|abort,
    #:         "close_data": dict}
    intents: dict = field(default_factory=dict)
    recovered: int = 0  # completed recovery replays recorded

    def _fold(self, rec: dict) -> None:
        self.records += 1
        kind = str(rec.get("kind", ""))
        phase = rec.get("phase")
        data = rec.get("data") or {}
        if phase:
            iid = str(rec.get("iid", ""))
            if phase == "intent":
                self.intents[iid] = {
                    "kind": kind, "data": data, "state": "intent",
                    "close_data": {},
                }
                if kind == "host" and data.get("name"):
                    self.jobs.setdefault(
                        str(data["name"]),
                        {"data": data, "committed": False,
                         "unhosted": False, "replicas": {}},
                    )["data"] = data
            else:  # commit | abort
                ent = self.intents.setdefault(
                    iid, {"kind": kind, "data": {}, "state": "intent",
                          "close_data": {}},
                )
                ent["state"] = phase
                ent["close_data"] = data
                if ent["kind"] == "host" and phase == "commit":
                    name = str(ent["data"].get("name", ""))
                    if name in self.jobs:
                        self.jobs[name]["committed"] = True
            return
        if kind == "replica_up":
            name = str(data.get("name", ""))
            job = self.jobs.setdefault(
                name, {"data": {}, "committed": False, "unhosted": False,
                       "replicas": {}},
            )
            job["replicas"][str(data.get("rid", "r0"))] = data
            job["unhosted"] = False
        elif kind == "replica_down":
            job = self.jobs.get(str(data.get("name", "")))
            if job is not None:
                job["replicas"].pop(str(data.get("rid", "")), None)
        elif kind == "unhost":
            job = self.jobs.get(str(data.get("name", "")))
            if job is not None:
                job["unhosted"] = True
                job["replicas"].clear()
        elif kind == "admit":
            jrid = str(data.get("jrid", ""))
            if jrid:
                self.admissions[jrid] = {
                    "data": data, "hwm": 0, "finished": False,
                    "seed": data.get("seed"), "reason": "",
                }
        elif kind == "place":
            # fleet dispatch resolves "router" placements to the replica
            # actually chosen (last record wins — that's the replica that
            # served it after any failover)
            adm = self.admissions.get(str(data.get("jrid", "")))
            if adm is not None and data.get("rid"):
                adm["data"]["placement"] = str(data["rid"])
        elif kind == "seed":
            adm = self.admissions.get(str(data.get("jrid", "")))
            if adm is not None:
                adm["seed"] = data.get("seed")
        elif kind == "hwm":
            adm = self.admissions.get(str(data.get("jrid", "")))
            if adm is not None:
                # monotone: a replayed out-of-order/duplicated record
                # can only raise the mark, never lower it
                adm["hwm"] = max(adm["hwm"], int(data.get("n", 0)))
        elif kind == "finish":
            adm = self.admissions.get(str(data.get("jrid", "")))
            if adm is not None:
                adm["finished"] = True
                adm["hwm"] = max(adm["hwm"], int(data.get("n", 0)))
                adm["reason"] = str(data.get("reason", ""))
        elif kind == "recovered":
            self.recovered += 1

    # -- recovery queries -------------------------------------------------
    def live_jobs(self) -> dict:
        """name -> job record for every hosted model that should exist:
        host intent seen (committed or not — a crash mid-host with
        replicas already up must still recover them), not unhosted, at
        least one replica journaled up."""
        return {
            name: job for name, job in self.jobs.items()
            if not job["unhosted"] and job["replicas"]
        }

    def open_intents(self, kind: str | None = None) -> list[tuple[str, dict]]:
        """(iid, entry) for every intent never committed nor aborted —
        the in-flight actions a crash interrupted."""
        return [
            (iid, ent) for iid, ent in self.intents.items()
            if ent["state"] == "intent"
            and (kind is None or ent["kind"] == kind)
        ]

    def orphan_admissions(self) -> list[tuple[str, dict]]:
        """(jrid, record) for admissions with no finish record — streams
        that were (possibly) still decoding when the validator died.
        The worker's live/orphan report is the authority on whether each
        still exists (worker wins for tokens)."""
        return [
            (jrid, adm) for jrid, adm in self.admissions.items()
            if not adm["finished"]
        ]

    def routed_counts(self) -> dict[str, int]:
        """placement rid -> admissions journaled there; seeds the
        recovered FleetRouter's per-replica routed counters so routing
        telemetry survives the restart instead of cold-starting."""
        out: dict[str, int] = {}
        for adm in self.admissions.values():
            rid = str(adm["data"].get("placement", "") or "")
            if rid:
                out[rid] = out.get(rid, 0) + 1
        return out


__all__ = ["ControlJournal", "JournalState", "INTENT_KINDS"]
