"""Reward accounting — merkle proposals and worker claims, off-chain first.

Reference: nodes/contract_manager.py:12 (1037 LoC): the round's proposal
creator aggregates completed jobs into per-worker byte-hour capacities,
builds a merkle tree of ``(worker, capacity)`` leaves (:785-836), stores the
full proposal in the DHT keyed by its hash, submits the hash on-chain, and
other validators recompute + vote; workers later claim rewards with merkle
proofs (get_worker_claim_data:911).

Here the same consensus artifacts are produced off-chain (sha256 in place of
keccak, DHT in place of the EVM): proposals, deterministic hashes, votes,
and verifiable claim proofs. With ``off_chain=False`` the lifecycle also
submits to the EVM through :mod:`tensorlink_tpu_torch.platform.chain` (stdlib
keccak/RLP/secp256k1 + JSON-RPC — web3 is absent from the TPU image):
proposal hashes at creation, votes at validation, execution at quorum,
each guarded so a flaky RPC degrades to off-chain instead of killing the
validator.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass, field


def _h(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def leaf_hash(worker_id: str, capacity: int) -> bytes:
    return _h(f"{worker_id}:{capacity}".encode())


def build_merkle(leaves: list[bytes]) -> tuple[bytes, list[list[bytes]]]:
    """Returns (root, levels) — levels[0] = leaves, last = [root]. Odd nodes
    promote unchanged (reference pairs-with-duplicate is a detail, not a
    contract — this tree is self-consistent with its own proofs)."""
    if not leaves:
        return _h(b""), [[]]
    levels = [list(leaves)]
    while len(levels[-1]) > 1:
        cur = levels[-1]
        nxt = []
        for i in range(0, len(cur) - 1, 2):
            nxt.append(_h(cur[i] + cur[i + 1]))
        if len(cur) % 2:
            nxt.append(cur[-1])
        levels.append(nxt)
    return levels[-1][0], levels


def merkle_proof(levels: list[list[bytes]], index: int) -> list[tuple[str, bytes]]:
    """Sibling path for ``leaves[index]``; entries are (side, hash) with
    side "L"/"R" = sibling position."""
    proof = []
    for level in levels[:-1]:
        sib = index ^ 1
        if sib < len(level):
            proof.append(("L" if sib < index else "R", level[sib]))
        index //= 2
    return proof


def verify_proof(leaf: bytes, proof: list[tuple[str, bytes]], root: bytes) -> bool:
    h = leaf
    for side, sib in proof:
        h = _h(sib + h) if side == "L" else _h(h + sib)
    return h == root


@dataclass
class Proposal:
    round: int
    creator: str
    capacities: dict[str, int]  # worker_id -> byte-seconds served
    offline: list[str] = field(default_factory=list)
    ts: float = field(default_factory=time.time)
    votes: dict[str, bool] = field(default_factory=dict)
    executed: bool = False

    def ordered(self) -> list[tuple[str, int]]:
        return sorted(self.capacities.items())

    def merkle(self):
        leaves = [leaf_hash(w, c) for w, c in self.ordered()]
        return build_merkle(leaves)

    def hash(self) -> str:
        root, _ = self.merkle()
        body = json.dumps(
            {"round": self.round, "creator": self.creator,
             "root": root.hex(), "offline": sorted(self.offline)},
            sort_keys=True,
        )
        return _h(body.encode()).hex()

    def to_json(self) -> dict:
        return {
            "round": self.round, "creator": self.creator,
            "capacities": self.capacities, "offline": self.offline,
            "ts": self.ts, "votes": self.votes, "executed": self.executed,
            "hash": self.hash(),
        }

    @classmethod
    def from_json(cls, d: dict) -> "Proposal":
        return cls(
            round=d["round"], creator=d["creator"],
            capacities=dict(d["capacities"]), offline=list(d.get("offline", [])),
            ts=d.get("ts", 0.0), votes=dict(d.get("votes", {})),
            executed=bool(d.get("executed", False)),
        )


class ContractManager:
    """Round-based proposal lifecycle over completed-job accounting."""

    def __init__(self, node_id: str, *, quorum: float = 0.5, chain=None):
        self.node_id = node_id
        self.quorum = quorum
        self.chain = chain  # ChainSubmitter | None (platform/chain.py)
        self.round = 0
        self.usage: dict[str, float] = {}  # worker -> accumulated byte·s
        self.proposals: dict[str, Proposal] = {}  # hash -> proposal

    # -- accounting -----------------------------------------------------
    def record_job(self, job: dict, *, ended: float | None = None) -> None:
        """Fold a completed/expired job into per-worker byte-seconds
        (reference capacity aggregation, contract_manager.py:283-315).
        Jobs restored after a validator restart carry ``t0_restored`` so
        downtime is never credited as served capacity."""
        t0 = float(job.get("t0_restored") or job.get("t0", time.time()))
        # tlint: disable=TL004(job t0 is persisted/replicated — epoch is the record's clock)
        dt = max((ended or time.time()) - t0, 0.0)
        stage_bytes = job.get("stage_bytes", {})
        for s in job.get("plan", {}).get("stages", []):
            wid = s["worker_id"]
            self.usage[wid] = self.usage.get(wid, 0.0) + dt * float(
                stage_bytes.get(wid, 0.0)
            )

    # -- proposal lifecycle --------------------------------------------
    def create_proposal(self, offline: list[str] = ()) -> Proposal:
        self.round += 1
        prop = Proposal(
            round=self.round,
            creator=self.node_id,
            capacities={w: int(c) for w, c in self.usage.items()},
            offline=list(offline),
        )
        h = prop.hash()
        self.proposals[h] = prop
        if self.chain is not None:  # reference createProposal, :534
            self.chain.submit_proposal(h, prop.round)
        return prop

    def validate_proposal(self, data: dict, claimed_hash: str) -> bool:
        """Recompute the hash from the full proposal body (reference
        proposal_validator, contract_manager.py:45-242)."""
        ok = Proposal.from_json(data).hash() == claimed_hash
        if self.chain is not None:  # reference voteForProposal, :208-242
            self.chain.submit_vote(claimed_hash, ok)
        return ok

    def vote(self, prop_hash: str, voter: str, approve: bool = True) -> None:
        prop = self.proposals.get(prop_hash)
        if prop is not None:
            prop.votes[voter] = approve

    def try_execute(self, prop_hash: str, n_validators: int) -> bool:
        prop = self.proposals.get(prop_hash)
        if prop is None or prop.executed:
            return False
        yes = sum(1 for v in prop.votes.values() if v)
        if yes / max(n_validators, 1) > self.quorum:
            prop.executed = True
            self.usage = {}  # rewarded usage resets for the next round
            if self.chain is not None:  # reference executeProposal, :683
                self.chain.execute_proposal(prop.round)
            return True
        return False

    # -- worker claims (reference get_worker_claim_data:911) ------------
    def claim_data(self, prop_hash: str, worker_id: str) -> dict | None:
        prop = self.proposals.get(prop_hash)
        if prop is None or not prop.executed:
            return None
        ordered = prop.ordered()
        ids = [w for w, _ in ordered]
        if worker_id not in ids:
            return None
        idx = ids.index(worker_id)
        root, levels = prop.merkle()
        proof = merkle_proof(levels, idx)
        return {
            "worker": worker_id,
            "capacity": ordered[idx][1],
            "index": idx,  # leaf position — the on-chain fold derives
            # sibling sides from it (chain.py submit_claim)
            "root": root.hex(),
            "round": prop.round,
            "proof": [(s, h.hex()) for s, h in proof],
        }

    def submit_claim(self, prop_hash: str, worker_id: str) -> str | None:
        """On-chain reward claim for a worker's share of an executed
        proposal (reference get_worker_claim_data + claim submission,
        contract_manager.py:911-1000). Returns the tx hash, or None when
        there is nothing to claim / no chain configured / RPC failed."""
        claim = self.claim_data(prop_hash, worker_id)
        if claim is None or self.chain is None:
            return None
        return self.chain.submit_claim(claim["round"], claim)

    @staticmethod
    def verify_claim(claim: dict) -> bool:
        return verify_proof(
            leaf_hash(claim["worker"], claim["capacity"]),
            [(s, bytes.fromhex(h)) for s, h in claim["proof"]],
            bytes.fromhex(claim["root"]),
        )
