"""Keeper — network-state persistence and statistics.

Reference: nodes/keeper.py:165 (855 LoC): persists DHT entity state to
``logs/dht_state.json`` (write_state:616), restores with age filters — 7 d
for jobs/users, 30 d for others (load_previous_state:658) — and maintains
daily→weekly network statistics with gap filling and chart-shaped API
output (get_network_status:502). Same capability, pure functions + one
class, no thread; the role server schedules ``tick()`` on its event loop.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any

JOB_MAX_AGE = 7 * 86400  # reference keeper.py:658 age filters
NODE_MAX_AGE = 30 * 86400
WEEKLY_ARCHIVE_DAYS = 7


def _day(ts: float) -> str:
    return time.strftime("%Y-%m-%d", time.gmtime(ts))


class Keeper:
    def __init__(self, state_path: str | Path):
        self.path = Path(state_path)
        self.daily: dict[str, dict] = {}  # day -> counters
        self.weekly: list[dict] = []
        self.proposals: list[dict] = []  # archived proposals (contract layer)
        self._last_write = 0.0

    # -- persistence ----------------------------------------------------
    def write_state(self, node) -> dict:
        """Snapshot the node's live state (peers, DHT, jobs, stats)."""
        now = time.time()
        jobs = getattr(node, "jobs", {})
        state = {
            "ts": now,
            "node_id": node.node_id,
            "peers": {
                nid: {
                    "role": node.roles.get(nid),
                    "addr": list(node.addresses.get(nid, ())),
                    "ts": now,
                }
                for nid in node.connections
            },
            # per-key ORIGIN timestamps (not snapshot time): a restored
            # record must not outrank writes/deletes that happened while
            # this validator was down; tombstones persist for the same
            # reason (a restart must not resurrect deleted records)
            "dht": {
                k: {"value": v,
                    "ts": getattr(node.dht, "updated_at", {}).get(k, now)}
                for k, v in node.dht.store_map.items()
                if _json_safe_check(v)
            },
            "dht_tombstones": dict(getattr(node.dht, "tombstones", {})),
            "jobs": {jid: {**j, "ts": j.get("t0", now)} for jid, j in jobs.items()},
            "reputation": (
                node.reputation.to_json()
                if getattr(node, "reputation", None) is not None else {}
            ),
            "daily": self.daily,
            "weekly": self.weekly,
            "proposals": self.proposals[-200:],
        }
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(state, default=str))
        tmp.replace(self.path)
        self._last_write = now
        return state

    def load_previous_state(self) -> dict:
        """Restore with freshness filters (reference keeper.py:658-700)."""
        if not self.path.exists():
            return {}
        try:
            state = json.loads(self.path.read_text())
        except (json.JSONDecodeError, OSError):
            return {}
        now = time.time()
        state["peers"] = {
            k: v for k, v in state.get("peers", {}).items()
            # tlint: disable=TL004(restored-state freshness vs persisted epoch stamps)
            if now - float(v.get("ts", 0)) < NODE_MAX_AGE
        }
        state["jobs"] = {
            k: v for k, v in state.get("jobs", {}).items()
            # tlint: disable=TL004(restored-state freshness vs persisted epoch stamps)
            if now - float(v.get("ts", 0)) < JOB_MAX_AGE
        }
        self.daily = state.get("daily", {})
        self.weekly = state.get("weekly", [])
        self.proposals = state.get("proposals", [])
        return state

    # -- statistics (reference keeper.py:341-572) -----------------------
    def update_statistics(self, node) -> None:
        now = time.time()
        day = _day(now)
        roles = [node.roles.get(nid) for nid in node.connections]
        cap = getattr(node, "worker_capacity_total", 0.0)
        entry = self.daily.setdefault(
            day,
            {"workers": 0, "validators": 0, "users": 0, "jobs": 0,
             "capacity_bytes": 0.0},
        )
        entry["workers"] = max(entry["workers"], roles.count("worker"))
        entry["validators"] = max(entry["validators"], roles.count("validator") + 1)
        entry["users"] = max(entry["users"], roles.count("user"))
        entry["jobs"] = max(entry["jobs"], len(getattr(node, "jobs", {})))
        entry["capacity_bytes"] = max(entry["capacity_bytes"], cap)
        self._archive_old_days(day)

    def _archive_old_days(self, today: str) -> None:
        """Days older than a week fold into weekly aggregates (reference
        daily→weekly archival, keeper.py:341-420)."""
        old = sorted(d for d in self.daily if d != today)[:-WEEKLY_ARCHIVE_DAYS]
        if not old:
            return
        for day in old:
            e = self.daily.pop(day)
            wk = f"{day[:4]}-W{time.strftime('%W', time.strptime(day, '%Y-%m-%d'))}"
            slot = next((w for w in self.weekly if w["week"] == wk), None)
            if slot is None:
                slot = {"week": wk,
                        **{k: (0.0 if isinstance(v, float) else 0)
                           for k, v in e.items()}}
                self.weekly.append(slot)
            for k, v in e.items():
                slot[k] = max(slot.get(k, 0), v)

    def get_network_status(self, node) -> dict:
        """Chart-ready output for /network-history. Day labels are
        contiguous: days with no recorded sample (node offline) appear as
        zero entries so charts show the outage instead of splicing it out
        (reference gap filling, keeper.py:341-420)."""
        days = _fill_day_gaps(sorted(self.daily))
        zero = {"workers": 0, "validators": 0, "users": 0, "jobs": 0,
                "capacity_bytes": 0.0}

        def series(key):
            return [self.daily.get(d, zero)[key] for d in days]

        return {
            "current": {
                "peers": len(node.connections),
                "jobs": len(getattr(node, "jobs", {})),
            },
            "daily": {
                "labels": days,
                "workers": series("workers"),
                "validators": series("validators"),
                "users": series("users"),
                "jobs": series("jobs"),
                "capacity_bytes": series("capacity_bytes"),
            },
            "weekly": self.weekly,
        }

    # -- pruning (reference clean_node, keeper.py:702-733) --------------
    @staticmethod
    def clean_node(node) -> int:
        """Drop dead connections' bookkeeping; returns number pruned."""
        dead = [
            nid for nid in list(node.addresses)
            if nid not in node.connections
        ]
        for nid in dead:
            node.addresses.pop(nid, None)
            node.roles.pop(nid, None)
        return len(dead)


MAX_CHART_DAYS = 30


def _fill_day_gaps(days: list[str]) -> list[str]:
    """Contiguous YYYY-MM-DD labels from the first to the last recorded day,
    capped to the most recent :data:`MAX_CHART_DAYS` — a sporadically-online
    node can retain recorded days months apart (archival keeps the newest 7
    by count, not calendar age), and an unbounded fill would zero-pad the
    whole span into the API payload."""
    if not days:
        return []
    import datetime as dt

    d0 = dt.date.fromisoformat(days[0])
    d1 = dt.date.fromisoformat(days[-1])
    span = [(d0 + dt.timedelta(n)).isoformat() for n in range((d1 - d0).days + 1)]
    return span[-MAX_CHART_DAYS:]


def _json_safe_check(v: Any) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False
