"""Per-node reputation scoring, checked at handshake.

Capability match for the reference's handshake reputation gate
(smart_node.py:681-698, which consults on-chain validator credentials and a
local score before accepting a peer). Off-chain design: every node keeps a
local, decaying score per peer id fed by observed behavior — ghost frames,
job failures/completions, planning-spam — and refuses the handshake when a
peer's score falls below the ban threshold. Scores decay toward neutral so
a flaky-but-reformed node can return (and a griefer can't bank goodwill
forever).
"""

from __future__ import annotations

import math
import time

# event -> score delta. Magnitudes are relative to BAN_THRESHOLD: one failed
# job is forgivable, three in a half-life window are not; ghost frames only
# ban at sustained-flood volume.
# tlint: disable=TL006(read-only constant table — never mutated at runtime)
EVENT_WEIGHTS = {
    "handshake_ok": 0.5,
    "ghost": -1.0,  # unparseable/unexpected frame
    "spam": -8.0,  # rate-limit violation after authentication
    "job_completed": 5.0,
    "job_failed": -10.0,  # died mid-job / failed to deliver
    "worker_dropped": -3.0,  # liveness replacement — may be a network blip,
    # so three in a day (half-life) must NOT cross BAN_THRESHOLD the way
    # three verified job failures do
    "proof_failed": -12.0,  # PoL log that didn't verify (platform/proofs.py)
    "proposal_mismatch": -15.0,  # contract-round hash that didn't validate
}
BAN_THRESHOLD = -25.0
HALF_LIFE_S = 24 * 3600.0
MAX_SCORE = 50.0  # cap banked goodwill


class ReputationTracker:
    def __init__(
        self,
        *,
        threshold: float = BAN_THRESHOLD,
        half_life_s: float = HALF_LIFE_S,
    ):
        self.threshold = threshold
        self.half_life_s = half_life_s
        self._scores: dict[str, float] = {}
        self._at: dict[str, float] = {}

    def _decayed(self, node_id: str, now: float) -> float:
        s = self._scores.get(node_id)
        if s is None:
            return 0.0
        dt = max(now - self._at.get(node_id, now), 0.0)
        return s * math.pow(0.5, dt / self.half_life_s)

    def record(self, node_id: str, event: str, weight: float | None = None) -> float:
        """Apply an observed event; returns the new score."""
        if not node_id:
            return 0.0
        now = time.time()
        w = EVENT_WEIGHTS[event] if weight is None else weight
        s = min(self._decayed(node_id, now) + w, MAX_SCORE)
        self._scores[node_id] = s
        self._at[node_id] = now
        return s

    def score(self, node_id: str) -> float:
        return self._decayed(node_id, time.time())

    def allowed(self, node_id: str) -> bool:
        return self.score(node_id) > self.threshold

    # -- persistence (rides the keeper snapshot) ------------------------
    def to_json(self) -> dict:
        now = time.time()
        return {
            nid: {"score": round(self._decayed(nid, now), 3), "ts": now}
            for nid in self._scores
            if abs(self._decayed(nid, now)) > 0.05  # drop ~neutral entries
        }

    def load_json(self, data: dict) -> None:
        for nid, e in (data or {}).items():
            try:
                self._scores[nid] = float(e["score"])
                self._at[nid] = float(e["ts"])
            # tlint: disable=TL005(malformed persisted entry — skip it, keep the rest of the snapshot)
            except (KeyError, TypeError, ValueError):
                continue


__all__ = ["ReputationTracker", "EVENT_WEIGHTS", "BAN_THRESHOLD"]
