"""Fleet-wide prefix digest map (port of
``tensorlink_tpu/fleet/prefixmap.py``).

A request landed on a replica and missed locally: which sibling replica
holds the prefix, in either tier, so admission can PULL the pages instead
of re-prefilling? :class:`FleetPrefixMap` reads the per-tier digests each
engine publishes on its ``router_snapshot`` (``prefix_digest`` for the
HBM trie, ``host_tier_digest`` for the host-RAM tier) from an rid → view
mapping. Digests are advisory (rolling hashes, possibly stale), so
:meth:`FleetPrefixMap.locate` only ranks candidates: the source re-walks
its real trie at export and the destination re-checks the sha256 content
digest at staging (``ContinuousEngine.stage_prefix``).

:func:`make_fleet_fetcher` builds the ``engine.fetch_prefix`` hook from a
view provider and per-replica pull functions (in-process, a sibling
batcher's ``pull_prefix``): best candidate first, the next on refusal,
None (→ local prefill) when nothing covers the prompt.
"""

from __future__ import annotations

import logging
from typing import Callable

from ..engine.paged import prompt_chain_hashes

# Hashing more leading pages than this per locate() is wasted host work:
# a pull that deep already amortizes; same bound as router affinity.
MAX_LOCATE_PAGES = 64


class FleetPrefixMap:
    """Rank sibling replicas by how much of a prompt's leading chain
    their published digests cover — the lookup behind the fleet-pull
    rung of admission's ladder.

    Stateless over the view dict it is handed: callers pass the
    router's current ``views()`` (or any rid → view mapping of the same
    shape), so the map never runs its own refresh sweep or holds a
    second copy of fleet state that could drift."""

    def __init__(self, page_size: int):
        self.page_size = int(page_size)

    def coverage(self, view: dict, hashes: list[str]) -> tuple[int, int]:
        """(covered_tokens, hbm_tokens) this view's digests predict for
        a prompt whose leading page hashes are ``hashes``. hbm_tokens
        counts only trie-resident coverage — a pull from HBM skips the
        source's own promote, so ties break toward it."""
        covered = hbm = 0
        for tier_key in ("prefix_digest", "host_tier_digest"):
            dig = view.get(tier_key) or {}
            if int(dig.get("page_size") or 0) != self.page_size:
                continue
            chains = dig.get("chains") or {}
            if not chains:
                continue
            deep = 0
            for i, h in enumerate(hashes):
                if h in chains:
                    deep = (i + 1) * self.page_size
            covered = max(covered, deep)
            if tier_key == "prefix_digest":
                hbm = deep
        return covered, hbm

    def locate(
        self,
        views: dict[str, dict],
        prompt_ids,
        *,
        exclude: tuple | frozenset = (),
        min_tokens: int = 0,
    ) -> list[tuple[str, int]]:
        """Candidate source replicas for a fleet pull, best first:
        ``[(rid, predicted_covered_tokens), ...]`` over every healthy,
        non-excluded view whose digests cover more than ``min_tokens``
        of the prompt's leading chain (pass the puller's own local
        coverage so a pull is only attempted when a sibling beats it).
        Deeper coverage wins; HBM residency breaks ties."""
        hashes = prompt_chain_hashes(
            prompt_ids, self.page_size, MAX_LOCATE_PAGES
        )
        if not hashes:
            return []
        ranked = []
        for rid, view in views.items():
            if rid in exclude or not view.get("ok", True):
                continue
            covered, hbm = self.coverage(view, hashes)
            if covered > max(int(min_tokens), 0):
                ranked.append((covered, hbm, rid))
        ranked.sort(key=lambda t: (-t[0], -t[1], t[2]))
        return [(rid, covered) for covered, _hbm, rid in ranked]


def make_fleet_fetcher(
    rid: str,
    page_size: int,
    views_fn: Callable[[], dict[str, dict]],
    pull_fns: dict[str, Callable],
    max_candidates: int = 2,
):
    """Build an ``engine.fetch_prefix`` callback — the fleet-pull rung —
    from a view provider (the router's ``views``) and per-replica pull
    functions (``(chain, limit, n_skip) -> blob | None``; in-process
    that is the sibling batcher's ``pull_prefix``, cross-process the
    MIGRATE ``pull`` RPC).

    ``rid`` is the PULLING replica (excluded from candidates — a
    replica must never pull from itself). The fetcher tries at most
    ``max_candidates`` sources best-coverage-first and returns the
    first blob, or None when every candidate refused / had nothing —
    the engine then falls through to re-prefill. Candidate errors are
    swallowed into the degrade (logged at debug): a sibling dying
    mid-pull must cost this request a re-prefill, not an exception."""
    fleet_map = FleetPrefixMap(page_size)
    log = logging.getLogger("tensorlink_tpu_torch.fleet.prefixmap")

    def fetch(chain, limit, n_local_pages):
        views = views_fn()
        candidates = fleet_map.locate(
            views, chain,
            exclude=(rid,),
            min_tokens=int(n_local_pages) * int(page_size),
        )
        for src, _covered in candidates[: max(int(max_candidates), 1)]:
            pull = pull_fns.get(src)
            if pull is None:
                continue
            try:
                blob = pull(chain, int(limit), int(n_local_pages))
            except Exception as e:
                log.debug("fleet pull %s -> %s failed: %s", src, rid, e)
                continue
            if blob:
                return blob
        return None

    return fetch


__all__ = ["FleetPrefixMap", "make_fleet_fetcher", "MAX_LOCATE_PAGES"]
