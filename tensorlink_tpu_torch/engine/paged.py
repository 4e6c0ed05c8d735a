"""Block-paged KV cache and the unified serving step (port of
``tensorlink_tpu/engine/paged.py``).

KV lives in fixed-size pages ``[L, P, n_kv, page, hd]`` (the JAX layout)
with a per-slot block table ``[S, n_pp]`` and per-slot lengths ``[S]``.
Page 0 is a reserved scratch page: idle slots ride the fixed slot batch
with an all-zero block-table row and length 0, and every padding row's KV
write lands there, unreachable from any block table.

The JAX package donates the cache into each compiled step so XLA updates
it in place; here the step updates the page tensors **in place**
(``index_put_`` through :func:`_scatter_kv`, per-layer views of the
stacked pages), and ``copy_page``/``bind_slot``/``clear_slot`` write the
cache's tensors in place too. A step returns a cache object whose
``lengths`` is a fresh tensor and whose pages are the same tensors it
was given.

:func:`paged_ragged_step` is the serving hot loop's single step: one
ragged prefill+decode forward over a packed ``[S, C]`` token block
through :func:`~tensorlink_tpu_torch.ops.attention.ragged_paged_attention`,
then the decode continuation — ``n_steps - 1`` slot-batched decode steps
through :func:`~tensorlink_tpu_torch.ops.attention.paged_attention` with
in-step sampling. JAX runs the continuation as a ``while_loop`` that
stops once every slot is done; here it is a fixed-count Python loop, so
no iteration has to ask the host whether to go on. A done slot is frozen
(its length stops, it re-feeds its own token, its key index stops), so
the extra iterations change no slot's stream; the only state they would
touch, a frozen slot's token column past its count, is gated on "some
slot still live" exactly like the JAX loop condition, and ``n_exec``
counts the iterations in which some slot was live — on the device, with
no host sync inside the step.

The host half (:class:`PageAllocator`, :func:`chain_hash`,
:func:`prompt_chain_hashes`, :class:`PrefixCache`, :func:`pages_needed`)
is a verbatim copy of the JAX package's pure-Python code, so digests and
allocator/trie state match it exactly.

Quantized pages (``kv_quant="int8"``/``"int4"``): ``k``/``v`` hold int8
codes (packed two per byte for int4, trailing dim ``hd / 2``) and
``k_scale``/``v_scale`` ``[L, P, n_kv, page]`` one f32 scale per
(page, position, head). :func:`_scatter_kv` is the one quantize site, and
every page operation (``copy_page``, ``clone``) moves payload and scales
together.

Pages move between engines and tiers through :func:`gather_page` (one
page of every layer copied to host numpy, bfloat16 as its 16-bit
payload) and :func:`scatter_page` (the inverse, in place), byte-exactly.
:class:`SharedPagePool` holds one set of page tensors for several
co-hosted tenant engines under per-tenant quotas (:class:`PoolTenant`).

Not in this slice: the tensor-parallel step.
"""

from __future__ import annotations

import hashlib
import heapq
from dataclasses import dataclass, replace

import torch

import numpy as np

from ..core.devices import resolve_device
from ..core.serialization import BFLOAT16
from ..models.base import ModelConfig, dtype_name
from ..models.quant import quantize_kv as _quant_kv
from ..models.quant import quantize_kv4 as _quant_kv4
from ..models.transformer import (
    _attn_scale,
    _embed_tokens,
    _layers,
    _logits,
    _norm,
    _qkv,
    _residual,
    _rope_dim,
    rope_tables,
)
from ..ops.attention import (
    paged_attention,
    paged_attention_ref,
    ragged_paged_attention,
    ragged_paged_attention_ref,
)
from .sampling import _row_keys, _sample_rows


@dataclass
class PagedKVCache:
    """Paged decode cache: ``k``/``v`` are ``[L, P, n_kv, page, hd]``,
    ``block_tables`` maps each serving slot to its pages ``[S, n_pp]``
    (0 = the reserved scratch page), ``lengths`` counts valid positions
    per slot ``[S]`` (both int32, on the pages' device).

    int8/int4 mode (``quantized``): ``k``/``v`` hold int8 codes (int4:
    packed, last dim ``hd / 2``) and ``k_scale``/``v_scale``
    ``[L, P, n_kv, page]`` the f32 per-(page, position, head) scales."""

    k: torch.Tensor
    v: torch.Tensor
    block_tables: torch.Tensor
    lengths: torch.Tensor
    k_scale: torch.Tensor | None = None  # f32 [L, P, n_kv, page]
    v_scale: torch.Tensor | None = None

    @classmethod
    def init(
        cls,
        cfg: ModelConfig,
        max_slots: int,
        *,
        page_size: int = 16,
        max_len: int | None = None,
        dtype: torch.dtype | None = None,
        kv_quant: str | None = None,
        n_pages: int | None = None,
        device=None,
    ) -> "PagedKVCache":
        """Zeroed pages for ``max_slots`` slots of ``max_len`` positions
        (plus scratch page 0), or ``n_pages`` pages when given, on
        ``device`` (None = the CUDA card). ``kv_quant`` is ``"none"``
        (pages in ``dtype``), ``"int8"`` or ``"int4"`` (int8 pages, packed
        to ``hd / 2`` for int4, with zeroed f32 scales)."""
        mode = kv_quant or "none"
        if mode not in ("none", "int8", "int4"):
            raise ValueError(f"unknown kv_quant mode {mode!r}")
        hd = cfg.head_dim
        if mode == "int4":
            if hd % 2:
                raise ValueError(
                    f"kv_quant='int4' packs two values per byte — "
                    f"head_dim {hd} must be even"
                )
            hd //= 2
        device = resolve_device(device)
        S_max = max_len or cfg.max_seq_len
        n_pp = -(-S_max // page_size)
        P = n_pages if n_pages is not None else 1 + max_slots * n_pp
        shape = (cfg.n_layers, P, cfg.n_kv_heads, page_size, hd)
        dt = torch.int8 if mode != "none" else (dtype or cfg.dtype)

        def scales():
            if mode == "none":
                return None
            return torch.zeros(shape[:-1], dtype=torch.float32,
                               device=device)

        return cls(
            k=torch.zeros(shape, dtype=dt, device=device),
            v=torch.zeros(shape, dtype=dt, device=device),
            block_tables=torch.zeros(
                (max_slots, n_pp), dtype=torch.int32, device=device
            ),
            lengths=torch.zeros((max_slots,), dtype=torch.int32,
                                device=device),
            k_scale=scales(),
            v_scale=scales(),
        )

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def n_pages(self) -> int:
        return self.k.shape[1]

    @property
    def max_slots(self) -> int:
        return self.block_tables.shape[0]

    @property
    def pages_per_slot(self) -> int:
        return self.block_tables.shape[1]

    def clone(self) -> "PagedKVCache":
        """An independent copy (the step updates pages in place)."""
        return PagedKVCache(
            k=self.k.clone(), v=self.v.clone(),
            block_tables=self.block_tables.clone(),
            lengths=self.lengths.clone(),
            k_scale=None if self.k_scale is None else self.k_scale.clone(),
            v_scale=None if self.v_scale is None else self.v_scale.clone(),
        )

    def layer_kv(self, i: int) -> tuple:
        """Layer ``i``'s page views: ``(k, v)`` for fp pages, ``(k, v,
        k_scale, v_scale)`` for quantized ones — the blocks branch on the
        arity, as the JAX package's ``_cache_kv`` tuples do."""
        if self.k_scale is None:
            return (self.k[i], self.v[i])
        return (self.k[i], self.v[i], self.k_scale[i], self.v_scale[i])


class PageAllocator:
    """Host-side free-list over physical page ids 1..P-1 (0 is scratch).

    Pure bookkeeping — allocation order is irrelevant to correctness (the
    block table names pages explicitly), so a freed page is reused LIFO
    for locality. ``alloc`` is all-or-nothing: admission either gets every
    page a request could need or stays queued."""

    def __init__(self, n_pages: int):
        self._free = list(range(n_pages - 1, 0, -1))  # pop() yields 1 first

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: list[int]) -> None:
        for p in pages:
            if p > 0:
                self._free.append(p)


# ---------------------------------------------------------------------------
# Shared multi-tenant page pool (co-hosted models)
# ---------------------------------------------------------------------------


class PoolTenant:
    """One co-hosted model's quota-bounded allocator over a
    :class:`SharedPagePool`: the ``PageAllocator`` interface a
    ``ContinuousEngine`` consumes (``n_free``/``alloc``/``free``), where an
    allocation must fit BOTH the shared free list and this tenant's page
    quota, and every page the tenant holds (slot-owned, prefix-cache
    resident or in transit) counts against ``used`` until it returns
    through :meth:`free`."""

    def __init__(self, pool: "SharedPagePool", model_id: str, quota: int):
        self.pool = pool
        self.model_id = str(model_id)
        # 0 = uncapped (bounded by the pool alone)
        self.quota = int(quota) if quota else pool.n_pages - 1
        self.used = 0
        self.engine = None  # bound by SharedPagePool.attach

    @property
    def n_free(self) -> int:
        return min(self.pool.alloc.n_free, self.quota - self.used)

    @property
    def _free(self):
        # page_accounting reads the authoritative (shared) free list
        return self.pool.alloc._free

    def alloc(self, n: int) -> list[int] | None:
        if self.used + n > self.quota:
            return None  # quota dry: this tenant's own ladder reclaims
        pages = self.pool.alloc.alloc(n)
        if pages is not None:
            self.used += len(pages)
        return pages

    def free(self, pages: list[int]) -> None:
        n = sum(1 for p in pages if p > 0)
        self.pool.alloc.free(pages)
        self.used -= n
        assert self.used >= 0, (
            f"tenant {self.model_id!r} freed more pages than it held"
        )


class SharedPagePool:
    """ONE set of physical KV page tensors shared by several co-hosted
    tenant engines of the same page geometry (layers, kv heads, head_dim,
    page size, storage mode, dtype). Each tenant keeps its own block
    tables, slots, scheduler and prefix cache; the pages and the free list
    are shared under per-tenant quotas.

    Every attached engine must be stepped from one thread: a
    tenant's step writes the shared page tensors in place, the next
    tenant's step reads them, and cross-tenant reclaim and preemption walk
    another tenant's host state.

    Cross-tenant policy: when a tenant's allocation fails on the SHARED
    free list (not its quota), admission may (1) evict other tenants'
    refcount-0 prefix pages LRU-first (:meth:`reclaim_cache`), then (2)
    preempt another tenant's strictly-lower-ranked running slot
    (:meth:`cross_model_victim`) through that engine's own preemption
    path."""

    def __init__(
        self,
        cfg: ModelConfig,
        n_pages: int,
        *,
        page_size: int = 16,
        dtype: torch.dtype | None = None,
        kv_quant: str = "none",
        device=None,
    ):
        self.page_size = int(page_size)
        self.kv_quant = str(kv_quant or "none")
        proto = PagedKVCache.init(
            cfg, 0, page_size=self.page_size, max_len=self.page_size,
            dtype=dtype, kv_quant=self.kv_quant, n_pages=1 + int(n_pages),
            device=device,
        )
        self.device = proto.k.device
        # the canonical layer-stacked page tensors: tenant engines read
        # them through their cache view and their steps write them in place
        self.kv: tuple = (
            (proto.k, proto.v) if proto.k_scale is None
            else (proto.k, proto.v, proto.k_scale, proto.v_scale)
        )
        self.alloc = PageAllocator(1 + int(n_pages))
        self.tenants: dict[str, PoolTenant] = {}
        self.geometry = (
            cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, self.page_size,
            self.kv_quant, dtype_name(proto.k.dtype),
        )
        self.cross_preemptions = 0
        self.cache_reclaims = 0

    @property
    def n_pages(self) -> int:
        return self.kv[0].shape[1]

    @property
    def n_free(self) -> int:
        return self.alloc.n_free

    def attach(self, model_id: str, engine, *, quota: int = 0) -> PoolTenant:
        """Register a tenant engine. Its geometry (and device) must match
        the pool's — a mismatched model cannot share physical pages."""
        t_dtype = (
            "int8" if engine.kv_quant in ("int8", "int4")
            else dtype_name(engine.engine.cache_dtype)
        )
        geo = (
            engine.cfg.n_layers, engine.cfg.n_kv_heads,
            engine.cfg.head_dim, engine.page_size, engine.kv_quant,
            t_dtype,
        )
        if geo != self.geometry:
            raise ValueError(
                f"tenant {model_id!r} page geometry {geo} does not match "
                f"the shared pool's {self.geometry} — co-hosted models "
                "must share (layers, kv_heads, head_dim, page_size, "
                "kv_quant, dtype)"
            )
        if engine._counts.device != self.device:
            raise ValueError(
                f"tenant {model_id!r} runs on {engine._counts.device}, the "
                f"shared pool's pages live on {self.device}"
            )
        if model_id in self.tenants:
            raise ValueError(f"tenant {model_id!r} already attached")
        t = PoolTenant(self, model_id, quota)
        t.engine = engine
        self.tenants[model_id] = t
        return t

    def detach(self, model_id: str) -> None:
        t = self.tenants.pop(model_id, None)
        assert t is None or t.used == 0, (
            f"tenant {model_id!r} detached holding {t.used} pages"
        )

    # -- cross-tenant reclaim / preemption (single stepping thread) -----
    def reclaim_cache(self, n: int, exclude) -> int:
        """Evict up to ``n`` refcount-0 prefix-cache pages from OTHER
        tenants (LRU within each trie) back to the shared free list.
        Returns how many pages came back."""
        freed = 0
        for t in self.tenants.values():
            if t.engine is exclude or t.engine.prefix is None:
                continue
            need = n - freed
            if need <= 0:
                break
            pages = t.engine.prefix.evict(need)
            if pages:
                t.engine.alloc.free(pages)
                freed += len(pages)
        self.cache_reclaims += freed
        return freed

    def cross_model_victim(self, cand_rank: int, exclude):
        """The running request another tenant should preempt for a
        candidate of effective rank ``cand_rank``, or None: only slots
        whose admission-time rank is strictly worse are eligible, worst
        rank first, ties toward the tenant holding the most pages.
        Returns ``(engine, request)``."""
        best = None
        for t in self.tenants.values():
            eng = t.engine
            if eng is exclude:
                continue
            with eng._lock:
                v = eng.sched.victim_for_rank(eng._preemptable(), cand_rank)
            if v is None:
                continue
            key = (v.admit_rank, t.used)
            if best is None or key > best[0]:
                best = (key, eng, v)
        if best is None:
            return None
        self.cross_preemptions += 1
        return best[1], best[2]

    # -- conservation ----------------------------------------------------
    def check_page_conservation(self) -> None:
        """Shared free + Σ per tenant (slot-owned + cache-resident +
        in-transit + tier-pinned) == total usable pages, every set
        pairwise disjoint ACROSS tenants, each tenant's ``used`` equal to
        what its engine holds, scratch page 0 nowhere. Raises
        AssertionError on violation."""
        problems: list[str] = []
        free = set(self.alloc._free)
        if len(free) != len(self.alloc._free):
            problems.append("shared free-list holds a duplicate page")
        seen: dict[int, str] = {p: "free" for p in free}
        total_held = 0
        for mid, t in self.tenants.items():
            acc = t.engine.page_accounting()
            slots, cached = list(acc["slots"]), set(acc["cached"])
            transit = list(acc["in_transit"]) + list(acc["host_tier"])
            if len(slots) != len(set(slots)):
                problems.append(f"[{mid}] a page is owned by two slots")
            if len(transit) != len(set(transit)):
                problems.append(f"[{mid}] a page is in transit twice")
            held = set(slots) | cached | set(transit)
            if len(held) != len(slots) + len(cached) + len(transit):
                problems.append(f"[{mid}] page in two ownership classes")
            for p in held:
                prev = seen.get(p)
                if prev is not None:
                    problems.append(
                        f"page {p} held by both {prev} and {mid}"
                    )
                seen[p] = mid
            n_held = len(slots) + len(cached) + len(transit)
            total_held += n_held
            if n_held != t.used:
                problems.append(
                    f"[{mid}] quota accounting drifted: engine holds "
                    f"{n_held} pages, tenant.used={t.used}"
                )
            if t.used > t.quota:
                problems.append(
                    f"[{mid}] over quota: used={t.used} > {t.quota}"
                )
        if 0 in seen:
            problems.append("scratch page 0 entered an ownership set")
        total = self.n_pages - 1
        if len(free) + total_held != total:
            problems.append(
                f"leak: free={len(free)} + held={total_held} != "
                f"total={total}"
            )
        if problems:
            raise AssertionError(
                "pool page conservation violated: " + "; ".join(problems)
            )

    def snapshot(self) -> dict:
        """Pool-level telemetry (each tenant merges it into its
        ``serving_snapshot``)."""
        return {
            "pool_pages_total": self.n_pages - 1,
            "pool_pages_free": self.alloc.n_free,
            "pool_tenants": len(self.tenants),
            "pool_cross_preemptions": self.cross_preemptions,
            "pool_cache_reclaims": self.cache_reclaims,
            "pool_used": {
                mid: {"used": t.used, "quota": t.quota}
                for mid, t in self.tenants.items()
            },
        }


# ---------------------------------------------------------------------------
# Automatic prefix cache (host-side index over physical pages)
# ---------------------------------------------------------------------------


def chain_hash(parent_hash: str, block) -> str:
    """16-hex-char rolling hash of a trie chain: the previous prefix's
    hash folded with one page-size token block. Structural trie equality
    stays the CACHE key (no collision can ever map a wrong page); these
    hashes exist only so a chain can be NAMED compactly off-box — the
    fleet router scores a replica's cache affinity against a digest of
    them (docs/SERVING.md "Fleet serving") without shipping the trie. A
    collision merely misguides placement by one request, never
    correctness."""
    h = hashlib.blake2b(digest_size=8)
    h.update(parent_hash.encode("ascii"))
    h.update(",".join(str(int(t)) for t in block).encode("ascii"))
    return h.hexdigest()


def prompt_chain_hashes(tokens, page_size: int, max_pages: int) -> list[str]:
    """The rolling chain hashes of ``tokens``' leading full page blocks
    (up to ``max_pages``) — what the router matches against a replica's
    :meth:`PrefixCache.digest`. Index i covers ``(i + 1) * page_size``
    tokens. Host-only, no trie required."""
    out: list[str] = []
    prev = ""
    p = int(page_size)
    limit = min((len(tokens) // p), int(max_pages))
    for i in range(limit):
        prev = chain_hash(prev, tokens[i * p : (i + 1) * p])
        out.append(prev)
    return out


class _TrieNode:
    """One cached FULL page: the KV of ``block`` (page_size token ids) at
    the absolute positions its chain depth implies."""

    __slots__ = (
        "block", "page", "parent", "children", "refs", "tick",
        "depth", "key_hash", "weights_version",
    )

    def __init__(self, block: tuple, page: int, parent: "_TrieNode | None"):
        self.block = block
        self.page = page
        self.parent = parent
        self.children: dict[tuple, _TrieNode] = {}
        self.refs = 0  # slots currently mapping this page
        self.tick = 0  # LRU recency (monotonic engine counter)
        # the model weights version this page's KV was computed under
        # (PrefixCache.insert stamps it): the match fence for live weight
        # publishes — see ContinuousEngine.publish_weights
        self.weights_version = 1
        # chain identity for the fleet digest: pages-from-root count and
        # the rolling chain hash (root carries depth 0 / hash "")
        if parent is None:
            self.depth = 0
            self.key_hash = ""
        else:
            self.depth = parent.depth + 1
            self.key_hash = chain_hash(parent.key_hash, block)


class PrefixCache:
    """Host-side automatic-prefix-cache index over ``PagedKVCache`` pages.

    A trie over page-size token blocks: a node's path from the root IS the
    cache key — the exact token chain from position 0 — so two prompts
    share a cached page only when every earlier token matches, which makes
    the key rope-offset-invariant by construction (same tokens at the same
    absolute positions ⇒ bitwise the same KV). The cache is per engine,
    hence per (model, dtype): no model id needs to ride the key.

    Only FULL pages are cached. ``refs`` counts slots whose block tables
    currently name the page; refcount-0 pages stay resident and are
    evicted leaf-first in LRU order when the allocator runs dry (evicting
    an interior node would orphan descendants whose positions assume it).
    Structural equality (no hashing) means no collision can ever map a
    wrong page — the "hash map" is Python's dict over the block tuples.
    """

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self.root = _TrieNode((), 0, None)
        self._by_page: dict[int, _TrieNode] = {}
        self._tick = 0
        # bumped on every membership change (insert/evict) so the engine
        # can skip rebuilding the fleet digest when nothing moved
        self.version = 0
        # the CURRENT model weights version (the engine bumps it on every
        # live weight publish, docs/TRAINING.md): inserts stamp it onto
        # their nodes, and match() refuses chains stamped with any other
        # version — cached KV from older weights can never become a hit,
        # which is what keeps the bitwise cache contract true across a
        # hot-swap. Stale refcount-0 chains are evicted at publish time;
        # still-referenced ones free as their slots do.
        self.weights_version = 1
        # the demote seam (docs/SERVING.md "Tiered prefix cache"): when
        # set, evict() hands each victim node to this callable BEFORE the
        # page id returns to the free-list — the engine wires it to the
        # host-RAM tier so the bytes survive the eviction. Best-effort by
        # contract: the spill contains its own failures (a page that
        # fails to demote is simply destroyed, the pre-tier behavior),
        # so eviction itself can never be blocked by the tier below.
        self.spill = None
        self.stats = {
            "lookups": 0,
            "hits": 0,
            "hit_tokens": 0,
            "cow_copies": 0,
            "evictions": 0,
            "inserts": 0,
        }

    # -- introspection ---------------------------------------------------
    @property
    def resident_pages(self) -> set[int]:
        return set(self._by_page)

    @property
    def n_resident(self) -> int:
        return len(self._by_page)

    def digest(self, max_chains: int = 32) -> dict:
        """Compact export of the resident chains for off-box cache-
        affinity scoring (docs/SERVING.md "Fleet serving"): the
        ``max_chains`` most-recently-used nodes as ``{chain_hash:
        covered_tokens}``. Interior prefixes of a hot chain are touched
        by every hit, so recency order naturally exports them too — a
        prompt matching only part of a resident chain still scores.
        Bounded bytes by construction (~26 B/entry serialized), JSON-
        safe, and NEVER authoritative: admission re-walks the real trie,
        so a stale or colliding digest can only misplace a request, not
        corrupt a stream."""
        nodes = sorted(
            (
                n for n in self._by_page.values()
                if n.weights_version == self.weights_version
            ),
            key=lambda n: n.tick, reverse=True,
        )[: max(int(max_chains), 0)]
        return {
            "page_size": self.page_size,
            "chains": {
                n.key_hash: n.depth * self.page_size for n in nodes
            },
        }

    def _touch(self, node: _TrieNode) -> None:
        self._tick += 1
        node.tick = self._tick

    # -- lookup ----------------------------------------------------------
    def _blocks(self, tokens, limit: int):
        p = self.page_size
        for i in range(0, (limit // p) * p, p):
            yield tuple(int(t) for t in tokens[i : i + p])

    def match(self, tokens, limit: int) -> list[_TrieNode]:
        """Longest chain of cached full pages covering ``tokens[:limit]``.
        Returns the matched nodes in position order (refs NOT yet taken —
        callers acquire() before anything can evict, single-threaded).
        lookup/hit telemetry is counted at successful ADMISSION, not
        here: a head-of-line request waiting for pages re-matches every
        chunk and must not inflate the operator-facing hit rate."""
        node = self.root
        out: list[_TrieNode] = []
        for block in self._blocks(tokens, limit):
            child = node.children.get(block)
            if child is None or child.weights_version != self.weights_version:
                # a version mismatch fences the WHOLE chain below: its KV
                # was computed under different weights (publish_weights)
                break
            out.append(child)
            self._touch(child)  # a hit IS a use: refresh LRU recency
            node = child
        return out

    def partial_match(
        self, nodes: list[_TrieNode], tokens, limit: int
    ) -> tuple[_TrieNode, int] | None:
        """Best divergent child for copy-on-write: among the children of
        the last matched node, the page whose block shares the LONGEST
        non-empty token prefix with what the request still needs (capped
        at ``limit`` tokens past the full-page hit). The caller copies
        that page and owns the copy — the cached original is never
        written."""
        parent = nodes[-1] if nodes else self.root
        done = len(nodes) * self.page_size
        want = [int(t) for t in tokens[done : done + min(self.page_size, limit - done)]]
        if not want:
            return None
        best: tuple[_TrieNode, int] | None = None
        for block, child in parent.children.items():
            if child.weights_version != self.weights_version:
                # stale-version KV (live weight publish) must not seed a
                # COW copy any more than it may full-page match
                continue
            n = 0
            for a, b in zip(want, block):
                if a != b:
                    break
                n += 1
            if n > 0 and (best is None or n > best[1]):
                best = (child, n)
        return best

    # -- refcounts -------------------------------------------------------
    def acquire(self, nodes: list[_TrieNode]) -> None:
        for n in nodes:
            n.refs += 1
            self._touch(n)

    def release(self, nodes: list[_TrieNode]) -> None:
        for n in nodes:
            assert n.refs > 0, "prefix-cache refcount underflow"
            n.refs -= 1
            self._touch(n)

    # -- insert / evict --------------------------------------------------
    def insert(
        self, parent: "_TrieNode | None", block: tuple, page: int,
        freed: "list[int] | None" = None,
    ) -> tuple[_TrieNode, bool]:
        """Adopt ``page`` as the cached KV of ``block`` under ``parent``
        (None = root). Returns ``(node, adopted)`` — ``adopted=False``
        means an identical chain is already resident: the caller keeps
        ownership of ``page`` (frees it) and continues the walk from the
        existing node.

        A STALE-version unreferenced leaf shadowing this block (its KV
        predates a weight publish, so it can never match again) is
        evicted in place and the fresh page adopted — its page id lands
        in ``freed`` for the caller's allocator. A stale node that still
        has refs or children stays (its readers are mid-stream); the
        fresh page is declined and the chain re-caches once they drain."""
        parent = parent or self.root
        existing = parent.children.get(block)
        if (
            existing is not None
            and existing.weights_version != self.weights_version
            and existing.refs == 0
            and not existing.children
        ):
            del parent.children[block]
            del self._by_page[existing.page]
            self.stats["evictions"] += 1
            self.version += 1
            if freed is not None:
                freed.append(existing.page)
            existing = None
        if existing is not None:
            self._touch(existing)
            return existing, False
        node = _TrieNode(block, int(page), parent)
        node.weights_version = self.weights_version
        parent.children[block] = node
        self._by_page[int(page)] = node
        self._touch(node)
        self.stats["inserts"] += 1
        self.version += 1
        return node, True

    def n_evictable(self) -> int:
        """Pages a (cascading) evict could free in the limit: nodes whose
        WHOLE subtree is unreferenced — a referenced descendant pins its
        ancestors because eviction is leaf-first. Lets the allocator skip
        a destructive cache wipe when eviction can never satisfy the
        allocation anyway."""
        def walk(node: _TrieNode) -> tuple[int, bool]:
            total, clear = 0, node.refs == 0
            for child in node.children.values():
                c_total, c_clear = walk(child)
                total += c_total
                clear = clear and c_clear
            return total + (1 if clear else 0), clear
        return sum(walk(c)[0] for c in self.root.children.values())

    def evict(self, k: int) -> list[int]:
        """Free up to ``k`` least-recently-used unreferenced LEAF pages
        in one pass (a parent whose last child evicts becomes a leaf and
        is eligible within the same call); returns the freed page ids.
        One resident scan amortized over the whole batch — the allocator
        asks for the full deficit at once instead of one page per retry."""
        heap = [
            (n.tick, n.page, n)
            for n in self._by_page.values()
            if n.refs == 0 and not n.children
        ]
        heapq.heapify(heap)
        freed: list[int] = []
        while heap and len(freed) < k:
            _, _, victim = heapq.heappop(heap)
            if self.spill is not None:
                # tiered demotion: the victim's bytes are still intact in
                # HBM (its page id hasn't been reused yet) — offer them
                # to the tier below before the trie forgets the chain
                self.spill(victim)
            del victim.parent.children[victim.block]
            del self._by_page[victim.page]
            self.stats["evictions"] += 1
            self.version += 1
            freed.append(victim.page)
            parent = victim.parent
            if (
                parent is not self.root
                and parent.refs == 0
                and not parent.children
            ):
                heapq.heappush(heap, (parent.tick, parent.page, parent))
        return freed

    def evict_one(self) -> int | None:
        """Free the least-recently-used unreferenced LEAF page; returns
        its physical page id (for the allocator's free-list) or None when
        nothing is evictable."""
        freed = self.evict(1)
        return freed[0] if freed else None

    def drop_all(self) -> list[int]:
        """Evict everything evictable (teardown): returns the freed page
        ids. Referenced pages stay — their slots still map them."""
        return self.evict(len(self._by_page))


def _ragged_write_indices(block_tables, starts, n_valid, page, n_pp, C):
    """Physical ``(page, offset)`` write targets for a ragged ``[S, C]``
    token block: position ``j`` of slot ``s`` lands at absolute position
    ``starts[s] + j`` when ``j < n_valid[s]``; every other write lands on
    scratch page 0. THE one page-write path (a decode token is the
    ``C = 1`` case). Also returns the absolute positions (the rope
    offsets) and the validity mask. Indices are int64."""
    idx = torch.arange(C, device=starts.device)[None, :]
    pos = starts.long()[:, None] + idx  # [S, C]
    valid = idx < n_valid.long()[:, None]
    cpos = torch.clamp(pos, max=n_pp * page - 1)
    pg = torch.gather(block_tables.long(), 1, cpos // page)
    zero = torch.zeros_like(pg)
    write_pg = torch.where(valid, pg, zero)
    write_off = torch.where(valid, cpos % page, zero)
    return write_pg, write_off, pos, valid


def _scatter_kv(cache_kv: tuple, write_pg, write_off, k, v) -> tuple:
    """THE one page-write path's scatter, in place: land this block's KV
    rows ``[..., Hkv, hd]`` at their ``(page, offset)`` targets in one
    layer's pages ``[P, Hkv, page, hd]``. For quantized pages (a 4-tuple
    with the scales) this is the single quantize site: each row
    quantizes on its own (``quantize_kv4`` when the page dim is half the
    row's, else ``quantize_kv``) and codes and scales land together."""
    if len(cache_kv) == 4:
        ck, cv, cks, cvs = cache_kv
        quant = _quant_kv4 if ck.shape[-1] != k.shape[-1] else _quant_kv
        k8, ks = quant(k)
        v8, vs = quant(v)
        ck[write_pg, :, write_off] = k8
        cv[write_pg, :, write_off] = v8
        cks[write_pg, :, write_off] = ks
        cvs[write_pg, :, write_off] = vs
        return ck, cv, cks, cvs
    ck, cv = cache_kv
    ck[write_pg, :, write_off] = k.to(ck.dtype)
    cv[write_pg, :, write_off] = v.to(cv.dtype)
    return ck, cv


def _attn_pages(kv: tuple, dtype) -> tuple:
    """What attention reads from one layer's pages: ``(k, v, scales)``.
    Quantized pages go as stored with their scales (the kernels and plain
    versions dequantize them); only fp pages are cast, to q's dtype."""
    if len(kv) == 4:
        return kv[0], kv[1], dict(k_scale=kv[2], v_scale=kv[3])
    return kv[0].to(dtype), kv[1].to(dtype), {}


def _paged_block(x, lp, cfg: ModelConfig, cos, sin, cache_kv, write_pg,
                 write_off, att_len, block_tables, kernel: bool):
    """One transformer block over a slot batch of single tokens (T=1),
    reading and writing KV through pages; attention is
    :func:`paged_attention` (``kernel``) or its plain version."""
    h = x if cfg.norm_position == "post" else _norm(x, lp["ln1"], cfg)
    q, k, v = _qkv(h, lp, cfg, cos, sin)  # [S, 1, H, hd]
    kv = _scatter_kv(cache_kv, write_pg, write_off, k[:, 0], v[:, 0])
    attn = paged_attention if kernel else paged_attention_ref
    kp, vp, sc = _attn_pages(kv, q.dtype)
    attn_raw = attn(
        q[:, 0].contiguous(), kp, vp, block_tables, att_len,
        scale=_attn_scale(cfg), **sc,
    )[:, None]  # [S, 1, Hq, hd]
    return _residual(x, attn_raw, lp, cfg), kv


def paged_decode_step(params, tok, cache: PagedKVCache, active,
                      cfg: ModelConfig, *, kernel: bool,
                      layers: list | None = None):
    """ONE fixed-shape decode step over every serving slot. Returns
    ``(logits [S, V], cache)`` with each active slot's new KV written to
    its pages (in place) and its length advanced by one. Idle slots write
    their masked token to the scratch page and attend over nothing.
    ``kernel`` (required) selects :func:`paged_attention` or its plain
    version."""
    layers = layers if layers is not None else _layers(params)
    lengths = cache.lengths
    page, n_pp = cache.page_size, cache.pages_per_slot
    write_pg, write_off, _, _ = _ragged_write_indices(
        cache.block_tables, lengths, active.to(torch.int32), page, n_pp, 1
    )
    write_pg, write_off = write_pg[:, 0], write_off[:, 0]
    att_len = torch.where(active, lengths + 1, torch.zeros_like(lengths))

    x = _embed_tokens(params, tok.long()[:, None], cfg)  # [S, 1, d]
    positions = lengths.long()[:, None]
    if cfg.pos == "learned":
        x = x + params["embed"]["pos"][positions].to(cfg.dtype)
    cos = sin = None
    if cfg.pos == "rope":
        cos, sin = rope_tables(positions, _rope_dim(cfg), cfg.rope_theta)
    for i, lp in enumerate(layers):
        x, _ = _paged_block(
            x, lp, cfg, cos, sin, cache.layer_kv(i), write_pg,
            write_off, att_len, cache.block_tables, kernel,
        )
    x = _norm(x, params["final_norm"], cfg)
    logits = _logits(params, x, cfg)[:, 0]
    new_len = torch.where(active, lengths + 1, lengths)
    return logits, replace(cache, lengths=new_len)


def _decode_loop_body(params, layers, seeds, temp, top_k, top_p, pres, freq,
                      eos, cfg: ModelConfig, kernel: bool):
    """The decode continuation's loop body (one slot-batched decode step
    plus in-step sampling). A slot that finishes (EOS / budget) freezes:
    its length stops, it re-feeds its own token and its key index stops,
    so its stream is bit-identical to stepping one token at a time.
    Tokens land at each slot's own column cursor ``col``. ``run`` is the
    JAX loop condition (some slot still live): it gates the one write a
    frozen slot would still make and counts ``n_exec``."""
    S = seeds.shape[0]
    rows = torch.arange(S, device=seeds.device)

    def body(st):
        tok, cache, done, steps, counts, remaining, col, tokens, n_exec = st
        run = ~done.all()
        logits, cache = paged_decode_step(
            params, tok, cache, ~done, cfg, kernel=kernel, layers=layers
        )
        keys = _row_keys(seeds, steps)
        nxt = _sample_rows(
            logits, keys, temp, top_k, top_p, pres, freq, counts
        )
        nxt = torch.where(done, tok, nxt)  # frozen slots re-feed their token
        live = (~done).to(torch.int32)
        counts.index_put_((rows, nxt.long()), live, accumulate=True)
        steps = steps + live
        remaining = remaining - live
        done = done | (nxt[:, None] == eos).any(-1) | (remaining <= 0)
        c = torch.clamp(col, max=tokens.shape[1] - 1).long()
        tokens[rows, c] = torch.where(run, nxt, tokens[rows, c])
        return (nxt, cache, done, steps, counts, remaining, col + live,
                tokens, n_exec + run.to(torch.int32))

    return body


def _verify_emit(blk, logits_v, base, n_spec, emit, seeds, steps, temp,
                 top_k, top_p, pres, freq, counts, remaining, eos):
    """The step's sampling epilogue over each slot's verification rows
    ``logits_v [S, W]``: accepts the longest prefix of draft tokens equal
    to their own-row draws and emits one more (a non-speculating slot
    walks exactly its last valid row — the plain single draw). Updates
    the penalty histogram (in place), key index and budget per emitted
    token. Returns ``(tokens [S, W], last, m, ended, counts, steps,
    remaining)``."""
    S, W, _V = logits_v.shape
    dev = blk.device
    rows = torch.arange(S, device=dev)
    j_idx = torch.arange(W, device=dev)[None, :]
    nxt_rows = torch.clamp(base.long()[:, None] + j_idx + 1, 0,
                           blk.shape[1] - 1)
    draft_next = torch.gather(blk, 1, nxt_rows)  # [S, W]
    has_draft = j_idx < n_spec.long()[:, None]
    stopped = ~emit
    ended = torch.zeros_like(emit)
    last = torch.zeros(S, dtype=torch.int32, device=dev)
    m = torch.zeros(S, dtype=torch.int32, device=dev)
    toks = []
    for j in range(W):
        keys = _row_keys(seeds, steps)
        t = _sample_rows(logits_v[:, j], keys, temp, top_k, top_p, pres,
                         freq, counts)
        live = emit & ~stopped
        liv32 = live.to(torch.int32)
        t = torch.where(live, t, torch.zeros_like(t))
        counts.index_put_((rows, t.long()), liv32, accumulate=True)
        steps = steps + liv32
        remaining = remaining - liv32
        end_now = live & ((t[:, None] == eos).any(-1) | (remaining <= 0))
        accept = live & has_draft[:, j] & (draft_next[:, j] == t) & ~end_now
        last = torch.where(live, t, last)
        m = m + liv32
        ended = ended | end_now
        stopped = stopped | (live & ~accept)
        toks.append(t)
    return torch.stack(toks, 1), last, m, ended, counts, steps, remaining


def _ragged_block(x, lp, cfg: ModelConfig, cos, sin, cache_kv, write_pg,
                  write_off, block_tables, starts, n_valid, kernel: bool):
    """One transformer block over the ragged ``[S, C]`` token block:
    project, scatter the block's KV through the one write path, then
    :func:`ragged_paged_attention` (``kernel``) or its plain version over
    every slot's pages at once."""
    h = x if cfg.norm_position == "post" else _norm(x, lp["ln1"], cfg)
    q, k, v = _qkv(h, lp, cfg, cos, sin)  # [S, C, H, hd]
    kv = _scatter_kv(cache_kv, write_pg, write_off, k, v)
    attn = ragged_paged_attention if kernel else ragged_paged_attention_ref
    kp, vp, sc = _attn_pages(kv, q.dtype)
    attn_raw = attn(
        q.contiguous(), kp, vp, block_tables, starts, n_valid,
        scale=_attn_scale(cfg), **sc,
    )  # [S, C, Hq, hd]
    return _residual(x, attn_raw, lp, cfg), kv


def paged_ragged_step(
    params,
    blk: torch.Tensor,  # int32 [S, C] — packed ragged token block
    cache: PagedKVCache,
    starts: torch.Tensor,  # int32 [S] — absolute position of blk[s, 0]
    n_valid: torch.Tensor,  # int32 [S] — valid tokens per slot (0 = idle)
    n_spec: torch.Tensor,  # int32 [S] — draft tokens per slot
    emit: torch.Tensor,  # bool [S] — slot samples from its last valid row
    seeds: torch.Tensor,  # int32 [S] — per-slot RNG seeds
    steps: torch.Tensor,  # int32 [S] — per-slot next draw index
    temp: torch.Tensor,  # f32 [S] sampling knobs …
    top_k: torch.Tensor,  # int32 [S]
    top_p: torch.Tensor,  # f32 [S]
    pres: torch.Tensor,  # f32 [S]
    freq: torch.Tensor,  # f32 [S]
    counts: torch.Tensor,  # int32 [S, V] context histograms (in place)
    remaining: torch.Tensor,  # int32 [S] — tokens still wanted per slot
    eos: torch.Tensor,  # int32 [S, E] per-slot EOS ids (pad with -1)
    cfg: ModelConfig,
    n_steps: int,
    spec_width: int = 1,
    *,
    kernel: bool,
):
    """THE serving hot loop's step: one ragged prefill+decode forward over
    the packed ``[S, C]`` block, sampling of each emitting slot's last
    valid row, then ``n_steps - 1`` decode-continuation steps. Every
    slot's role is data: a decode slot carries its current token at
    ``starts = length``, a mid-prefill slot its next prompt piece, an
    idle slot nothing. ``kernel`` (a required keyword) selects the CUDA
    attention kernels (on CPU tensors their wrappers take the plain
    versions); ``False`` runs the plain versions everywhere.

    Returns ``(tokens [S, n_steps + spec_width - 1], n_tok [S], spec_m
    [S], n_exec, cache, done, steps, counts, remaining)`` as the JAX step
    does: slot ``s``'s draws are columns ``0 .. n_tok[s] - 1``, ``spec_m``
    is the ragged pass's emitted count, ``n_exec`` the number of
    slot-batched steps in which some slot was live (a 0-d int32 tensor).
    Pages are written in place; no host sync happens inside."""
    S, C = blk.shape
    page, n_pp = cache.page_size, cache.pages_per_slot
    bt = cache.block_tables
    write_pg, write_off, pos, _valid = _ragged_write_indices(
        bt, starts, n_valid, page, n_pp, C
    )
    layers = _layers(params)
    x = _embed_tokens(params, blk.long(), cfg)  # [S, C, d]
    if cfg.pos == "learned":
        x = x + params["embed"]["pos"][pos].to(cfg.dtype)
    cos = sin = None
    if cfg.pos == "rope":
        cos, sin = rope_tables(pos, _rope_dim(cfg), cfg.rope_theta)
    for i, lp in enumerate(layers):
        x, _ = _ragged_block(
            x, lp, cfg, cos, sin, cache.layer_kv(i), write_pg,
            write_off, bt, starts, n_valid, kernel,
        )
    x = _norm(x, params["final_norm"], cfg)
    # verification rows: the last spec_width rows of each slot's valid
    # span; a non-speculating slot gathers exactly its last valid row
    W = int(spec_width)
    dev = blk.device
    base = torch.clamp(n_valid - 1 - n_spec, min=0)
    gather = torch.minimum(
        base.long()[:, None] + torch.arange(W, device=dev)[None, :],
        torch.clamp(n_valid.long() - 1, min=0)[:, None],
    )  # [S, W]
    h_v = x[torch.arange(S, device=dev)[:, None], gather]  # [S, W, d]
    logits_v = _logits(params, h_v, cfg)  # [S, W, V]

    toks0, nxt, spec_m, ended, counts, steps, remaining = _verify_emit(
        blk, logits_v, base, n_spec, emit, seeds, steps, temp, top_k,
        top_p, pres, freq, counts, remaining, eos,
    )
    done = ~emit | ended
    # a speculating slot's length advances only past its accepted tokens
    adv = torch.where((n_spec > 0) & emit, spec_m, n_valid)
    cache = replace(
        cache, lengths=torch.where(n_valid > 0, starts + adv, cache.lengths)
    )
    tokens = torch.zeros((S, n_steps + W - 1), dtype=torch.int32, device=dev)
    tokens[:, :W] = toks0
    body = _decode_loop_body(
        params, layers, seeds, temp, top_k, top_p, pres, freq, eos, cfg,
        kernel,
    )
    st = (nxt, cache, done, steps, counts, remaining, spec_m, tokens,
          torch.ones((), dtype=torch.int32, device=dev))
    for _ in range(n_steps - 1):
        st = body(st)
    _tok, cache, done, steps, counts, remaining, n_tok, tokens, n_exec = st
    return (
        tokens, n_tok, spec_m, n_exec, cache, done, steps, counts,
        remaining,
    )


def copy_page(cache: PagedKVCache, src: int, dst: int) -> PagedKVCache:
    """Copy-on-write: duplicate a cached page's KV (every layer) into a
    page the admitting slot owns, in place. Quantized pages move their
    scale rows with the payload, so the copy dequantizes exactly as the
    original does."""
    cache.k[:, dst] = cache.k[:, src]
    cache.v[:, dst] = cache.v[:, src]
    if cache.k_scale is not None:
        cache.k_scale[:, dst] = cache.k_scale[:, src]
        cache.v_scale[:, dst] = cache.v_scale[:, src]
    return cache


def bind_slot(cache: PagedKVCache, slot: int, bt_row, length: int
              ) -> PagedKVCache:
    """Point a slot at its allocated pages (admission), in place."""
    cache.block_tables[slot] = torch.as_tensor(
        bt_row, dtype=torch.int32
    ).to(cache.block_tables.device)
    cache.lengths[slot] = int(length)
    return cache


def clear_slot(cache: PagedKVCache, slot: int) -> PagedKVCache:
    """Detach an evicted slot, in place: zero its table row (→ scratch)
    and its length. The pages return to the host free-list; their stale
    contents are unreachable once no table row names them."""
    cache.block_tables[slot] = 0
    cache.lengths[slot] = 0
    return cache


def host_array(t: torch.Tensor) -> np.ndarray:
    """A host numpy COPY of ``t`` (synchronizes with the card): bfloat16
    as its 16-bit payload under ``BFLOAT16``, every other dtype as
    itself."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BFLOAT16)
    return t.numpy()


def device_tensor(a, device) -> torch.Tensor:
    """The inverse of :func:`host_array`: a numpy page payload (bfloat16
    as ``BFLOAT16`` or an ``ml_dtypes`` bfloat16 array) as a tensor on
    ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    if a.dtype == BFLOAT16 or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def gather_page(cache: PagedKVCache, page: int) -> tuple:
    """Read one physical page's KV across every layer to the host: the
    migration EXPORT and the host-tier demote path. Returns host numpy
    copies ``(k, v)`` (``[L, n_kv, page, hd]``) or ``(k, v, k_scale,
    v_scale)`` for quantized pages — the stored bytes (no dequantize, no
    cast), so a shipped page is byte-exact on the destination. The copies
    are taken after the card finished writing and are not views: a later
    step cannot change them."""
    page = int(page)
    out = [cache.k[:, page], cache.v[:, page]]
    if cache.k_scale is not None:
        out += [cache.k_scale[:, page], cache.v_scale[:, page]]
    return tuple(host_array(t) for t in out)


def scatter_page(cache: PagedKVCache, page: int, k, v, k_scale=None,
                 v_scale=None) -> PagedKVCache:
    """Write one shipped page's KV into a destination-owned physical page,
    in place: the migration IMPORT and the host-tier promote path (the
    inverse of :func:`gather_page`, byte-exact)."""
    page = int(page)
    dev = cache.k.device
    cache.k[:, page] = device_tensor(k, dev)
    cache.v[:, page] = device_tensor(v, dev)
    if k_scale is not None:
        cache.k_scale[:, page] = device_tensor(k_scale, dev)
        cache.v_scale[:, page] = device_tensor(v_scale, dev)
    return cache


def pages_needed(total_len: int, page_size: int) -> int:
    """Pages a request of ``total_len`` positions (prompt + budget, capped
    at the engine's max_seq_len) occupies."""
    return -(-int(total_len) // int(page_size))


__all__ = [
    "PageAllocator",
    "PagedKVCache",
    "PoolTenant",
    "PrefixCache",
    "SharedPagePool",
    "bind_slot",
    "chain_hash",
    "clear_slot",
    "copy_page",
    "device_tensor",
    "dtype_name",
    "gather_page",
    "host_array",
    "paged_decode_step",
    "paged_ragged_step",
    "pages_needed",
    "prompt_chain_hashes",
    "scatter_page",
]
