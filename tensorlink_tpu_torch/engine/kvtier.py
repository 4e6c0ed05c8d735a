"""Host-RAM tier of the tiered prefix cache (port of
``tensorlink_tpu/engine/kvtier.py``).

The HBM prefix cache (``engine/paged.py::PrefixCache``) destroys a
refcount-0 page at LRU eviction. A :class:`HostPagePool` is the tier below:
it holds the DEMOTED pages as plain numpy payloads (k/v bytes plus the
quantization scales that make a page self-describing; bfloat16 pages as
the 16-bit payload, ``core/serialization.py::BFLOAT16``), keyed by the
exact token chain the page covers. Admission's trie walk extends one rung:
a chain that fell off the HBM trie but is host-resident PROMOTES back into
a freshly allocated device page (one ``scatter_page``), and the stream
that hits it is bitwise what a cold re-prefill would have computed,
because the page round-trips byte-exactly.

Keying mirrors the trie: the STRUCTURAL chain (the tuple of page-size
token blocks from position 0) is the key; the rolling ``chain_hash`` rides
each entry only so the fleet digest can name the chain compactly.
Entries are version-fenced like trie nodes: a weight publish makes every
older-version entry unmatchable, and :meth:`drop_stale` reaps them.

The pool owns nothing on the device; :meth:`check_conservation` asserts
its own invariants (bounded residency, unique structural keys, paired
scales). This module imports numpy and ``chain_hash`` only.
"""

from __future__ import annotations

import numpy as np

from .paged import chain_hash


class _HostEntry:
    """One demoted page: the byte-exact KV payload of ``blocks[-1]`` at
    the chain position its depth implies, plus the identity needed to
    re-admit it (rolling hash for the fleet digest, weights version for
    the publish fence)."""

    __slots__ = (
        "blocks", "key_hash", "depth", "k", "v", "k_scale", "v_scale",
        "weights_version", "tick",
    )

    def __init__(self, blocks, key_hash, k, v, k_scale, v_scale,
                 weights_version):
        self.blocks = blocks  # tuple of page-size token-id tuples
        self.key_hash = key_hash
        self.depth = len(blocks)
        self.k = k
        self.v = v
        self.k_scale = k_scale
        self.v_scale = v_scale
        self.weights_version = int(weights_version)
        self.tick = 0


class HostPagePool:
    """LRU pool of demoted prefix pages in host RAM.

    Single-stepper discipline like the trie it backs: every method runs
    on the engine's stepping thread (demote fires inside the trie's
    evict, promote inside admission)."""

    def __init__(self, capacity: int, page_size: int):
        if int(capacity) <= 0:
            raise ValueError("host tier capacity must be >= 1 page")
        self.capacity = int(capacity)
        self.page_size = int(page_size)
        self._entries: dict[tuple, _HostEntry] = {}
        self._tick = 0
        # bumped on every membership change so the engine can skip
        # rebuilding the host-tier fleet digest when nothing moved
        self.version = 0
        # counted here (the tier's own ledger, like PrefixCache.stats);
        # the engine mirrors demotions/hits into its registry counters
        self.stats = {
            "demotions": 0,
            "hits": 0,
            "evictions": 0,
            "stale_dropped": 0,
        }

    # -- introspection ---------------------------------------------------
    @property
    def n_resident(self) -> int:
        return len(self._entries)

    def digest(self, max_chains: int = 32) -> dict:
        """Host-tier resident chains as ``{chain_hash: covered_tokens}``
        — same shape as :meth:`PrefixCache.digest`, so the fleet router
        and prefix map score both tiers with one code path. MRU-first,
        bounded, and advisory only: a promote re-checks the structural
        chain, so a stale digest misguides placement, never bytes."""
        entries = sorted(
            self._entries.values(), key=lambda e: e.tick, reverse=True,
        )[: max(int(max_chains), 0)]
        return {
            "page_size": self.page_size,
            "chains": {
                e.key_hash: e.depth * self.page_size for e in entries
            },
        }

    def _touch(self, entry: _HostEntry) -> None:
        self._tick += 1
        entry.tick = self._tick

    # -- the demote seam (PrefixCache.evict -> spill) --------------------
    def put(self, blocks: tuple, k, v, k_scale=None, v_scale=None,
            *, weights_version: int = 1) -> bool:
        """Adopt one evicted page's payload under its structural chain.
        ``k``/``v`` (and the scales on a quantized cache) are the host
        copies ``gather_page`` made of the page. An already-resident chain
        just refreshes (same chain ⇒ same bytes by the cache contract); at
        capacity the LRU entry falls off the bottom tier."""
        blocks = tuple(tuple(int(t) for t in b) for b in blocks)
        existing = self._entries.get(blocks)
        if existing is not None and (
            existing.weights_version == int(weights_version)
        ):
            self._touch(existing)
            return True
        while len(self._entries) >= self.capacity and (
            blocks not in self._entries
        ):
            lru = min(self._entries.values(), key=lambda e: e.tick)
            del self._entries[lru.blocks]
            self.stats["evictions"] += 1
            self.version += 1
        prev = ""
        for b in blocks:
            prev = chain_hash(prev, b)
        entry = _HostEntry(
            blocks, prev,
            np.asarray(k), np.asarray(v),
            np.asarray(k_scale) if k_scale is not None else None,
            np.asarray(v_scale) if v_scale is not None else None,
            weights_version,
        )
        self._entries[blocks] = entry
        self.stats["demotions"] += 1
        self.version += 1
        self._touch(entry)
        return True

    # -- the promote seam (admission ladder, rung 2) ---------------------
    # tlint: hot-path
    def lookup(self, blocks: tuple, weights_version: int):
        """The structural-key probe: the entry covering exactly
        ``blocks`` under the CURRENT weights version, or None. A
        version-mismatched entry is as good as absent (the publish
        fence, per tier) — it stays resident only until drop_stale."""
        entry = self._entries.get(
            tuple(tuple(int(t) for t in b) for b in blocks)
        )
        if entry is None or entry.weights_version != int(weights_version):
            return None
        self._touch(entry)
        self.stats["hits"] += 1
        return entry

    # -- maintenance -----------------------------------------------------
    def drop_stale(self, weights_version: int) -> int:
        """Reap every entry fenced off by a weight publish (their KV can
        never match again). Returns the count dropped."""
        stale = [
            key for key, e in self._entries.items()
            if e.weights_version != int(weights_version)
        ]
        for key in stale:
            del self._entries[key]
        if stale:
            self.stats["stale_dropped"] += len(stale)
            self.version += 1
        return len(stale)

    def drop_all(self) -> int:
        n = len(self._entries)
        self._entries.clear()
        if n:
            self.version += 1
        return n

    # -- conservation ----------------------------------------------------
    def check_conservation(self) -> None:
        """The host tier's own invariants, asserted alongside the device
        equation at engine close and by the chaos tests: residency never
        exceeds capacity, every entry's structural key matches its
        stored chain, quantized payloads carry both scales or neither,
        and each chain covers depth*page_size tokens."""
        problems = []
        if len(self._entries) > self.capacity:
            problems.append(
                f"residency {len(self._entries)} exceeds capacity "
                f"{self.capacity}"
            )
        for key, e in self._entries.items():
            if key != e.blocks:
                problems.append(f"entry keyed off its own chain: {e.key_hash}")
            if (e.k_scale is None) != (e.v_scale is None):
                problems.append(f"entry with one-sided scales: {e.key_hash}")
            if any(len(b) != self.page_size for b in e.blocks):
                problems.append(
                    f"entry with a non-page-size block: {e.key_hash}"
                )
        if problems:
            raise AssertionError(
                "host-tier conservation violated: " + "; ".join(problems)
            )


__all__ = ["HostPagePool"]
