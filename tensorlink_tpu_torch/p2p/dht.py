"""Kademlia-style DHT: XOR-distance buckets, replicated store, routing.

Capability match for the reference's DHT (p2p/dht.py): 256 buckets with
exponentially growing capacity (dht.py:13-16) and local-first ``query`` that
forwards misses to the XOR-nearest *validator* peer (dht.py:110-121). Keys
are 64-hex sha256 ids (or prefixed record names like ``job:{id}``); values
are JSON-able dicts.

Where the reference leaves replication as a TODO (dht.py:135-137) —
meaning a validator death loses the job records repair depends on — stores
here carry an origin timestamp and replicate two ways: writers fan
``DHT_STORE`` out to their connected validators (p2p/node.py
``dht_store_global``), and validators anti-entropy-sync replicated key
prefixes with each other on connect (``digest``/``merge`` +
``P2PNode.sync_dht``), so records survive the storing validator and reach
validators that join later. Conflicts resolve last-writer-wins on the
origin timestamp.

Async redesign: ``query`` awaits a remote answer with timeout + reroute
(reference polls with a 3 s timeout then re-routes, smart_node.py:533-577).
"""

from __future__ import annotations

import asyncio
import hashlib
import time
from typing import Any, Awaitable, Callable

ID_BITS = 256
# deletion markers survive this long so anti-entropy can't resurrect a
# deleted record from a replica that missed the delete; long-dead tombstones
# age out to bound memory
TOMBSTONE_TTL_S = 7 * 86400.0


def hash_key(data: bytes | str) -> str:
    if isinstance(data, str):
        data = data.encode()
    return hashlib.sha256(data).hexdigest()


def _key_int(key: str) -> int:
    """Record keys may be prefixed names (``job:{id}``) rather than 64-hex
    node ids — map them into the id space by hashing, so XOR routing works
    for any key (a raw int() would crash the first routed query for a
    prefixed key that misses locally)."""
    try:
        return int(key, 16)
    except ValueError:
        return int(hash_key(key), 16)


def xor_distance(a: str, b: str) -> int:
    return _key_int(a) ^ _key_int(b)


def bucket_index(a: str, b: str) -> int:
    d = xor_distance(a, b)
    return d.bit_length() - 1 if d else 0


class Bucket:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.keys: list[str] = []

    def add(self, key: str) -> bool:
        if key in self.keys:
            return True
        if len(self.keys) >= self.capacity:
            return False
        self.keys.append(key)
        return True

    def remove(self, key: str) -> None:
        if key in self.keys:
            self.keys.remove(key)


class DHT:
    """Local routing table + key/value store.

    ``forward`` — async callback ``(peer_id, key) -> value | None`` used when
    a queried key is not local; the node wires it to a DHT_GET round-trip.
    """

    def __init__(
        self,
        node_id: str,
        *,
        forward: Callable[[str, str], Awaitable[Any]] | None = None,
        base_capacity: int = 2,
    ):
        self.node_id = node_id
        self.store_map: dict[str, Any] = {}
        self.updated_at: dict[str, float] = {}
        self.tombstones: dict[str, float] = {}  # key -> deletion ts
        # bucket i covers distances [2^i, 2^(i+1)); capacity grows with range
        self.buckets = [
            Bucket(base_capacity * max(1, 2 ** (i // 32))) for i in range(ID_BITS)
        ]
        self.forward = forward

    # -- routing table -----------------------------------------------------
    def add_node(self, key: str) -> bool:
        if key == self.node_id:
            return False
        return self.buckets[bucket_index(self.node_id, key)].add(key)

    def remove_node(self, key: str) -> None:
        self.buckets[bucket_index(self.node_id, key)].remove(key)

    def known_nodes(self) -> list[str]:
        return [k for b in self.buckets for k in b.keys]

    def nearest(self, key: str, candidates: list[str] | None = None, n: int = 1) -> list[str]:
        pool = candidates if candidates is not None else self.known_nodes()
        return sorted(pool, key=lambda c: xor_distance(key, c))[:n]

    # -- store -------------------------------------------------------------
    def store(self, key: str, value: Any, ts: float | None = None) -> None:
        """``ts`` is the origin write time; replicated stores pass it along
        so last-writer-wins comparisons use one clock per record. A
        timestamped store loses to BOTH a newer tombstone and a newer live
        record (e.g. a fanout write that merged while a ``query`` was
        awaiting a lagging peer's stale copy); an untimestamped store is a
        fresh local write and always wins."""
        t = time.time() if ts is None else ts
        dead = self.tombstones.get(key)
        if dead is not None:
            # tlint: disable=TL004(LWW origin timestamps are cross-node epoch stamps)
            if ts is not None and t <= dead:
                return  # the record was deleted after this write happened
            del self.tombstones[key]  # genuinely re-created
        # tlint: disable=TL004(LWW origin timestamps are cross-node epoch stamps)
        if ts is not None and self.updated_at.get(key, -1.0) > t:
            return  # a newer live record wins
        self.store_map[key] = value
        self.updated_at[key] = t

    def delete(self, key: str, ts: float | None = None) -> bool:
        """Remove a record, leaving a tombstone so replication can't bring
        it back. Returns True if local state changed (used by the relay to
        terminate the delete flood)."""
        t = time.time() if ts is None else ts
        # tlint: disable=TL004(LWW origin timestamps are cross-node epoch stamps)
        if ts is not None and self.updated_at.get(key, -1.0) > t:
            return False  # a newer write beats this replicated delete
        existed = self.store_map.pop(key, None) is not None
        self.updated_at.pop(key, None)
        prev = self.tombstones.get(key, -1.0)
        # tlint: disable=TL004(LWW origin timestamps are cross-node epoch stamps)
        if t > prev:
            self.tombstones[key] = t
        return existed or t > prev  # tlint: disable=TL004(LWW epoch stamps)

    def get_local(self, key: str) -> Any:
        return self.store_map.get(key)

    # -- replication (anti-entropy) ----------------------------------------
    def _known_ts(self, key: str) -> float:
        return max(
            self.updated_at.get(key, -1.0), self.tombstones.get(key, -1.0)
        )

    def digest(self, prefixes: tuple[str, ...]) -> dict[str, float]:
        """``key -> origin ts`` for every local record (and live tombstone)
        under ``prefixes``."""
        now = time.time()
        for k in [
            # tlint: disable=TL004(tombstone TTL compares cross-node epoch stamps)
            k for k, t in self.tombstones.items() if now - t > TOMBSTONE_TTL_S
        ]:
            del self.tombstones[k]
        d = {
            k: self.updated_at.get(k, 0.0)
            for k in self.store_map
            if k.startswith(prefixes)
        }
        for k, t in self.tombstones.items():
            if k.startswith(prefixes):
                d[k] = t
        return d

    def missing_for(
        self, their_digest: dict[str, float], prefixes: tuple[str, ...]
    ) -> dict[str, dict]:
        """Entries the peer lacks or holds stale: ``key -> {value, ts}`` for
        live records, ``{deleted: True, ts}`` for tombstones."""
        out: dict[str, dict] = {}
        for k, ts in self.digest(prefixes).items():
            if their_digest.get(k, -1.0) < ts:
                if k in self.store_map:
                    out[k] = {"value": self.store_map[k], "ts": ts}
                else:
                    out[k] = {"deleted": True, "ts": ts}
        return out

    def merge(self, entries: dict[str, dict]) -> list[str]:
        """Apply sync entries last-writer-wins; returns the keys accepted."""
        accepted = []
        for k, e in entries.items():
            ts = float(e.get("ts", 0.0))
            if self._known_ts(k) < ts:
                if e.get("deleted"):
                    self.delete(k, ts=ts)
                else:
                    self.store(k, e.get("value"), ts=ts)
                accepted.append(k)
        return accepted

    # -- query -------------------------------------------------------------
    async def query(
        self,
        key: str,
        *,
        route_pool: list[str] | None = None,
        timeout: float = 3.0,
        max_retries: int = 3,
        hops: int = 0,
    ) -> Any:
        """Local lookup, then forward to XOR-nearest peers in ``route_pool``
        (normally the connected validators), rerouting on timeout. ``hops``
        rides along on the wire so a chain of misses terminates instead of
        cycling between validators.

        ``forward`` returns ``(value, origin_ts)`` (or a bare value from
        legacy/fake forwards); remote answers cache with the ORIGIN
        timestamp so a stale copy fetched from a lagging peer can't outrank
        newer writes or resurrect a tombstoned record."""
        if key in self.store_map:
            return self.store_map[key]
        if self.forward is None or not route_pool:
            return None
        tried: set[str] = set()
        for _ in range(max_retries):
            remaining = [p for p in route_pool if p not in tried]
            if not remaining:
                return None
            peer = self.nearest(key, remaining)[0]
            tried.add(peer)
            try:
                result = await asyncio.wait_for(
                    self.forward(peer, key, hops), timeout
                )
            # tlint: disable=TL005(the continue IS the reroute — the next nearest peer is tried)
            except (asyncio.TimeoutError, ConnectionError, OSError):
                continue
            if result is None:
                continue
            value, ts = (
                result if isinstance(result, tuple) else (result, None)
            )
            if value is not None:
                if ts is not None:
                    self.store(key, value, ts=float(ts))
                    # a tombstone newer than the fetched copy rejects it
                    if key not in self.store_map:
                        return None
                else:
                    self.store(key, value)
                return value
        return None


__all__ = ["DHT", "Bucket", "hash_key", "xor_distance", "bucket_index"]
