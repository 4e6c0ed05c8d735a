"""Dense generation engine: bucketed prefill and decode over the dense
``KVCache`` (port of ``tensorlink_tpu/engine/generate.py``).

``GenerationEngine`` owns one model's config and parameters on one
device (optionally weight-only int8: ``quant="int8"``; ``"int8+kv"`` also
keeps the KV cache in int8). It serves every request that continuous
batching does not:

- :meth:`prefill` pads prompts into (batch, seq) buckets and prefills a
  fresh cache; prompts longer than the largest bucket prefill in
  bucket-sized chunks. With ``cfg.flash_attention`` set, the fresh-cache
  prefill (and the first chunk of a chunked one) runs
  ``ops.attention.flash_attention`` — on the card, the CUDA kernel
  ``ops/csrc/flash_attention.cu``;
- :meth:`generate` (host-driven, per-token streaming),
  :meth:`generate_compiled` (the decode loop with early exit on EOS) and
  :meth:`generate_chunked` (streaming a chunk of loop steps at a time,
  re-bucketing survivors when rows finish);
- the beam session (:meth:`beam_start` / :meth:`beam_advance` /
  :meth:`beam_finish`, :meth:`generate_beam`);
- :meth:`generate_lookahead` (greedy prompt-lookup speculation);
- the prompt-prefix LRU (``reuse_prefix=True``).

The JAX package compiles prefill, decode and the ``while_loop`` decode;
here they are module functions on tensors run eagerly. The cache is
written in place where JAX donates it. ``_decode_loop`` runs the
``while_loop``'s iterations as a loop bounded on the host by the rows'
limits, gates each on "some row still live" on the device (so the
returned ``n_exec`` and advanced key equal JAX's), and asks the host
whether every row is done only every few steps. ``ContinuousEngine``
reads ``cfg``, ``device``, ``params``, ``max_seq_len``, ``cache_dtype``,
``quant`` and ``cache_quant``.

On a mesh (``mesh=`` with a tree placed by ``models/transformer.py::
partition_specs`` or ``tp_partition_specs``, ``cache_specs=``) the engine
runs the same loops over the placed tree: the forward runs per shard
(``models/sharded.py``, flash per (data, tensor) shard, once per distinct
device set of the expert shards; a MoE layer in the dense dispatch over
its expert shards), the cache's
payload is placed by the specs — its batch on ``data`` only when
``data`` divides it, else replicated over ``data`` — and its ``length``
stays whole on the engine's device for the host loops. The beam reorder
is the cross-shard row gather ``parallel/mesh.py::take_rows``. A tree
placed on a mesh quantizes as the whole tree does (``quant=``).
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from ..core.devices import resolve_device
from ..models.base import KVCache, ModelConfig
from ..models.quant import quantize_params
from ..models.transformer import _logits, cache_specs as _cache_specs
from ..models.transformer import flash_gate, forward
from ..parallel import mesh as _mesh
from ..parallel.mesh import Sharded
from . import prng
from .sampling import SamplingParams, sample

DEFAULT_SEQ_BUCKETS = (128, 256, 512, 1024, 2048, 4096)
DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8)
# how often the decode loop asks the host whether every row is done: the
# steps run past that point change no token, key or count (each is gated
# on "some row live" on the device), so only time is at stake
_DONE_CHECK_EVERY = 8


def _bucket(value: int, buckets: Sequence[int]) -> int:
    i = bisect.bisect_left(buckets, value)
    if i == len(buckets):
        raise ValueError(f"{value} exceeds largest bucket {buckets[-1]}")
    return buckets[i]


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        return tree  # placed on a mesh: a tensor-parallel engine's tree
    return tree.to(device)  # a tensor or a QTensor


def _prefill(params, tokens, attn_mask, cache, cfg: ModelConfig):
    """Fresh-cache prefill (flash when ``cfg.flash_attention``): the
    logits of each row's last real token ``[B, V]`` and the grown cache.
    The head runs on those rows only."""
    hidden, cache = forward(
        params, tokens, cfg, cache=cache, attn_mask=attn_mask,
        return_hidden=True, flash_prefill=cfg.flash_attention,
    )
    last = torch.clamp(attn_mask.sum(-1) - 1, min=0)
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    return _head_from_hidden(params, hidden[rows, last], cfg), cache


def _prefill_chunk(params, tokens, attn_mask, cache, cfg: ModelConfig,
                   first: bool):
    """One chunk of a long-prompt prefill: the final-normed hidden states
    and the grown cache. Flash only on the first chunk (offset 0)."""
    return forward(
        params, tokens, cfg, cache=cache, attn_mask=attn_mask,
        return_hidden=True, flash_prefill=cfg.flash_attention and first,
    )


def _head_from_hidden(params, hidden, cfg: ModelConfig):
    """The vocab head over already final-normed ``hidden [B, d]``."""
    return _logits(params, hidden[:, None], cfg)[:, 0]


def _decode_step(params, tok, cache, cfg: ModelConfig):
    logits, cache = forward(params, tok[:, None], cfg, cache=cache)
    return logits[:, 0], cache


def _verify_step(params, toks, cache, cfg: ModelConfig):
    """Speculative verification: one forward over ``[tok, draft...]``
    returns greedy targets at every position. The cache absorbs all
    positions; rejected ones are rolled back by resetting ``length``."""
    logits, cache = forward(params, toks, cfg, cache=cache)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def _decode_loop(
    params,
    first_tok: torch.Tensor,  # int32 [B] — token sampled from the prefill
    cache: KVCache,
    key,
    sampling: SamplingParams,
    eos_ids: torch.Tensor,  # int32 [n_eos] (pad with -1)
    limits: Sequence[int],  # loop tokens allowed per row (after first_tok)
    counts: torch.Tensor | None,  # int32 [B, V] context counts (penalize)
    cfg: ModelConfig,
    n_steps: int,
    penalize: bool = False,
):
    """The JAX ``while_loop`` decode with EOS early exit. Returns
    ``(tokens [B, n_steps], cache, done [B], n_exec, key)``: ``tokens``
    holds the newly generated tokens after ``first_tok``, ``n_exec`` (a
    0-d tensor) the iterations the JAX loop would run and ``key`` the key
    advanced once per such iteration — so chunked callers continue the
    exact split chain. ``limits`` freezes rows individually: a finished
    row keeps its length, re-feeds its token and adds no count.

    Iterations run up to ``min(n_steps, max(limits))`` (known on the
    host); each is gated on "some row live" on the device, and the host
    checks for "every row done" every ``_DONE_CHECK_EVERY`` steps."""
    B = first_tok.shape[0]
    dev = first_tok.device
    tokens = torch.zeros((B, n_steps), dtype=torch.int32, device=dev)
    lim = torch.as_tensor(np.asarray(limits, np.int64), device=dev)
    done = torch.isin(first_tok, eos_ids) | (lim <= 0)
    n_exec = torch.zeros((), dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    any_sampled = sampling.any_sampled()
    tok = first_tok
    for i in range(min(n_steps, max(int(x) for x in limits))):
        if i and i % _DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        run = ~done.all()
        prev_len = cache.length
        logits, cache = forward(params, tok[:, None], cfg, cache=cache)
        # a finished row writes one scratch slot at its frozen length
        cache.length = torch.where(done, prev_len, cache.length)
        new_key, sub = prng.split(key)
        nxt = sample(logits[:, 0], sub, sampling, counts if penalize else
                     None, any_sampled=any_sampled)
        nxt = torch.where(done, tok, nxt)  # freeze finished rows
        if penalize:
            counts.index_put_((rows, nxt.long()), (~done).to(torch.int32),
                              accumulate=True)
        tokens[:, i] = torch.where(run, nxt, tokens[:, i])
        key = tuple(torch.where(run, a, b) for a, b in zip(new_key, key))
        n_exec = n_exec + run.to(torch.int32)
        done = done | torch.isin(nxt, eos_ids) | (i + 1 >= lim)
        tok = nxt
    return tokens, cache, done, n_exec, key


def _beam_topk(logits, k: int):
    """Per-row top-k of the log-softmax: ``(scores, ids) [rows, k]``. Ties
    resolve to the lowest index, as ``lax.top_k`` does: the top k of a
    stable descending sort."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(logp, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def beam_frontier_step(
    beams: list, scores, alive: list, done_pool: list,
    vals, idx, K: int, eos_set: set, room: int, length_penalty: float,
):
    """Pure host-side frontier advance: fold the per-beam top-k candidates
    ``vals/idx [K, kk]`` into the next frontier. Returns ``(beams, scores,
    alive, src)`` — ``src`` names each surviving beam's source row for the
    KV-cache reorder — or ``None`` when no live candidates remain.
    ``done_pool`` is appended in place."""
    kk = vals.shape[1]
    cand: list[tuple[float, int, int]] = []  # (score, beam, token)
    for k in range(K):
        if not alive[k]:
            continue
        for j in range(kk):
            cand.append((scores[k] + float(vals[k, j]), k, int(idx[k, j])))
    cand.sort(key=lambda c: -c[0])
    new_beams, new_scores, new_alive, src = [], [], [], []
    for sc, k, t in cand:
        if len(new_beams) >= K:
            break
        seq = beams[k] + [t]
        if t in eos_set or len(seq) >= room:
            done_pool.append((sc / (len(seq) ** length_penalty), seq))
            if t in eos_set:
                continue  # finished beams leave the frontier
        new_beams.append(seq)
        new_scores.append(sc)
        new_alive.append(t not in eos_set and len(seq) < room)
        src.append(k)
    if not new_beams:
        return None
    # pad the frontier back to K rows (duplicates of row 0, alive=False)
    while len(new_beams) < K:
        new_beams.append(new_beams[0])
        new_scores.append(-np.inf)
        new_alive.append(False)
        src.append(src[0])
    return new_beams, np.asarray(new_scores), new_alive, src


@dataclass
class BeamState:
    """Resumable beam-search session (``beam_start`` / ``beam_advance`` /
    ``beam_finish``): the host-side frontier plus the tiled KV cache on
    the device, advanced a bounded chunk of steps at a time."""

    engine: "GenerationEngine"
    K: int
    B: int
    room: int
    prompt_len: int
    eos_set: set
    length_penalty: float
    beams: list = None  # type: ignore[assignment]
    scores: "np.ndarray" = None  # type: ignore[assignment]
    alive: list = None  # type: ignore[assignment]
    done_pool: list = None  # type: ignore[assignment]
    cache: KVCache | None = None
    tok: torch.Tensor | None = None
    step: int = 0

    def __post_init__(self):
        if self.beams is None:
            self.beams = []
        if self.alive is None:
            self.alive = []
        if self.done_pool is None:
            self.done_pool = []


@dataclass
class GenerationResult:
    sequences: list[list[int]]  # newly generated tokens per row (EOS included)
    prompt_lens: list[int]
    finished: list[bool]


class GenerationEngine:
    """One loaded model on one device. ``device=None`` is the CUDA card.
    ``quant`` is None, ``"int8"`` (weight-only int8: ``quantize_params``)
    or ``"int8+kv"`` (the same, and an int8 KV cache: ``cache_quant``)."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        *,
        mesh=None,
        cache_specs=None,
        max_seq_len: int | None = None,
        seq_buckets: Sequence[int] = DEFAULT_SEQ_BUCKETS,
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        cache_dtype: torch.dtype | None = None,
        quant: str | None = None,
        device=None,
    ):
        if quant and quant not in ("int8", "int8+kv"):
            raise ValueError(f"unknown quant mode {quant!r}")
        self.cfg = cfg
        # a placed engine's device is its mesh's first: the host loops'
        # tensors and the joined logits live there
        self.device = (mesh.flat()[0] if mesh is not None
                       else resolve_device(device))
        self.params = _to_device(params, self.device)
        if quant:
            # on the device: the codes and scales are the same bits there
            # (a placed tree quantizes each weight whole, then places it)
            self.params = quantize_params(self.params)
        self.quant = quant
        self.cache_quant = quant == "int8+kv"
        if self.cache_quant and cache_specs is not None \
                and cache_specs.k_scale is None:
            # the int8 cache's scales split like their payload
            cache_specs = KVCache(
                k=cache_specs.k, v=cache_specs.v, length=cache_specs.length,
                k_scale=cache_specs.k, v_scale=cache_specs.v)
        self.mesh = mesh
        self.cache_specs = cache_specs
        self.max_seq_len = int(
            max_seq_len or min(cfg.max_seq_len, seq_buckets[-1])
        )
        self.seq_buckets = tuple(
            b for b in seq_buckets if b <= self.max_seq_len
        ) or (self.max_seq_len,)
        self.batch_buckets = tuple(batch_buckets)
        self.cache_dtype = cache_dtype or cfg.dtype
        # prompt-prefix cache (reuse_prefix=True): host-side LRU of
        # token tuple -> per-position cache rows on the CPU, bounded by
        # count and by bytes
        self._prefix_lru: OrderedDict[tuple, dict] = OrderedDict()
        self.prefix_lru_size = 4
        self.prefix_lru_bytes = 512 << 20
        # prefills whose attention ran flash_attention (the engine's count
        # of the kernel's callers: each runs it once per layer)
        self.flash_prefills = 0

    # -- batch bucketing --------------------------------------------------
    def batch_bucket(self, n_live: int) -> int:
        """The smallest batch bucket that holds ``n_live`` rows."""
        return _bucket(max(int(n_live), 1), self.batch_buckets)

    # -- mesh -------------------------------------------------------------
    def _placed_mesh(self):
        """The mesh the tree lies on: the one given, or the one a
        tensor-parallel slot engine placed the tree on."""
        return self.mesh if self.mesh is not None \
            else _mesh.tree_mesh(self.params)

    @property
    def _fmesh(self):
        """The mesh the flash prefill runs per shard over (JAX's
        ``_fmesh``): the engine's mesh when ``cfg.flash_attention``."""
        return self._placed_mesh() if self.cfg.flash_attention else None

    def _cache_specs_for(self, batch: int) -> KVCache:
        """The cache spec for ``batch`` rows: the engine's (by default the
        kv heads on the axis the forward splits its heads over), its
        batch kept whole when ``data`` does not divide it."""
        mesh = self._placed_mesh()
        specs = self.cache_specs
        if specs is None:
            from ..models.sharded import head_axis

            specs = _cache_specs(
                self.cfg, data_axis=None,
                tensor_axis=head_axis(self.params, self.cfg),
                quantized=self.cache_quant)
        dp = mesh.shape.get("data", 1)
        if specs.k.data_dim is not None and batch % dp:
            def whole(sp):
                return None if sp is None else dataclasses.replace(
                    sp, data_dim=None)

            specs = KVCache(k=whole(specs.k), v=whole(specs.v),
                            length=_mesh.REPLICATED,
                            k_scale=whole(specs.k_scale),
                            v_scale=whole(specs.v_scale))
        return specs

    def _take(self, cache: KVCache, idx: torch.Tensor) -> KVCache:
        """The rows ``idx`` of a cache (the beam tile and reorder, the
        chunked decode's shrink); on a mesh laid out for ``len(idx)``
        rows, each row copied from the shard that holds it."""
        if not isinstance(cache.k, Sharded):
            return cache.take(idx)
        return cache.take(idx, specs=self._cache_specs_for(len(idx)))

    # -- cache ------------------------------------------------------------
    def new_cache(self, batch: int) -> KVCache:
        """A zeroed cache of ``batch`` rows; on a mesh each shard's piece
        is made on its device (``parallel/mesh.py::zeros``)."""
        if self._placed_mesh() is None:
            return KVCache.init(
                self.cfg, batch, max_len=self.max_seq_len,
                dtype=self.cache_dtype, quantized=self.cache_quant,
                device=self.device,
            )
        specs = self._cache_specs_for(batch)
        mesh = self._placed_mesh()
        c = self.cfg
        shape = (c.n_layers, batch, self.max_seq_len, c.n_kv_heads,
                 c.head_dim)
        dt = torch.int8 if self.cache_quant else self.cache_dtype

        def z(shp, dtype, sp):
            return _mesh.zeros(mesh, shp, dtype, sp)

        scales = {}
        if self.cache_quant:
            sshape = shape[:-1] + (1,)
            scales = dict(k_scale=z(sshape, torch.float32, specs.k_scale),
                          v_scale=z(sshape, torch.float32, specs.v_scale))
        return KVCache(
            k=z(shape, dt, specs.k), v=z(shape, dt, specs.v),
            length=torch.zeros((batch,), dtype=torch.int32,
                               device=self.device),
            **scales)

    def _chunk_shape(self, span: int, room: int) -> int:
        """Padded shape for a prefill piece of ``span`` tokens with ``room``
        cache slots left: a bucket value, except when room is below the
        smallest bucket."""
        usable = [b for b in self.seq_buckets if b <= room]
        if not usable:
            return room
        if span >= usable[-1]:
            return usable[-1]
        return next(b for b in usable if b >= span)

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _run_prefill(self, toks, mask, cache, *, chunk: bool, first: bool):
        """One prefill forward, counting it in ``flash_prefills`` when its
        attention runs flash_attention."""
        T = toks.shape[1]
        if flash_gate(self.cfg, T, True, self.cfg.flash_attention and first):
            self.flash_prefills += 1
        toks, mask = self._tensor(toks), self._tensor(mask, torch.bool)
        if chunk:
            return _prefill_chunk(self.params, toks, mask, cache, self.cfg,
                                  first)
        return _prefill(self.params, toks, mask, cache, self.cfg)

    # -- prompt-prefix cache ---------------------------------------------
    def _prefix_store(
        self,
        prompt: list[int],
        cache: KVCache,
        base_entry: dict | None = None,
        base_len: int = 0,
    ) -> None:
        """Keep this prompt's per-position cache rows (host copies) as a
        reusable prefix for a later turn extending it; on a hit only the
        new rows are copied from the device."""
        L = len(prompt)
        if self._entry_nbytes_for(L) > self.prefix_lru_bytes:
            return  # larger than the whole budget: skip the copy

        def rows(arr, base):
            if isinstance(arr, Sharded):
                arr = arr.full()  # a prefix entry is one row
            if base is None:
                return arr[:, 0, :L].to("cpu", copy=True)
            new = arr[:, 0, base_len:L].to("cpu", copy=True)
            return torch.cat([base[:, :base_len], new], dim=1)

        b = base_entry or {}
        entry = {"k": rows(cache.k, b.get("k")),
                 "v": rows(cache.v, b.get("v"))}
        if cache.quantized:
            entry["k_scale"] = rows(cache.k_scale, b.get("k_scale"))
            entry["v_scale"] = rows(cache.v_scale, b.get("v_scale"))
        key = tuple(prompt)
        self._prefix_lru[key] = entry
        self._prefix_lru.move_to_end(key)
        while len(self._prefix_lru) > self.prefix_lru_size or (
            len(self._prefix_lru) > 1
            and self._prefix_total_bytes() > self.prefix_lru_bytes
        ):
            self._prefix_lru.popitem(last=False)

    @staticmethod
    def _entry_nbytes(entry: dict) -> int:
        return sum(t.numel() * t.element_size() for t in entry.values())

    def _entry_nbytes_for(self, n_tokens: int) -> int:
        """Bytes a stored prefix of ``n_tokens`` positions would occupy,
        computed without the device copy: layers × kv-heads × head-dim ×
        2 (k+v) per position, plus f32 scales in int8 mode."""
        c = self.cfg
        per_pos = c.n_layers * c.n_kv_heads * c.head_dim * 2
        if self.cache_quant:
            per_pos_bytes = per_pos + c.n_layers * c.n_kv_heads * 2 * 4
        else:
            per_pos_bytes = per_pos * self.cache_dtype.itemsize
        return n_tokens * per_pos_bytes

    def _prefix_total_bytes(self) -> int:
        return sum(self._entry_nbytes(e) for e in self._prefix_lru.values())

    def _prefix_match(self, prompt: list[int]) -> tuple[int, dict] | None:
        """Longest stored key that is a prefix of ``prompt``, used up to
        ``len(prompt) - 1`` positions (a repeated prompt still prefills one
        real token for its logits). A hit refreshes the entry's recency."""
        best = None
        best_key = None
        p = tuple(prompt)
        for key, entry in self._prefix_lru.items():
            if p[: len(key)] == key:
                L_use = min(len(key), len(prompt) - 1)
                if L_use > 0 and (best is None or L_use > best[0]):
                    best = (L_use, entry)
                    best_key = key
        if best_key is not None:
            self._prefix_lru.move_to_end(best_key)
        return best

    def _prefill_with_prefix(self, prompt: list[int], L: int, entry: dict):
        """Seed a fresh B=1-bucket cache with the stored prefix rows, then
        prefill only the suffix in chunks (never flash: offset > 0)."""
        B = _bucket(1, self.batch_buckets)
        cache = KVCache.init(
            self.cfg, B, max_len=self.max_seq_len, dtype=self.cache_dtype,
            quantized=self.cache_quant, device=self.device)
        names = ("k", "v") + (("k_scale", "v_scale") if cache.quantized
                              else ())
        for name in names:
            getattr(cache, name)[:, 0, :L] = entry[name][:, :L].to(
                self.device)
        cache.length[0] = L
        if self._placed_mesh() is not None:
            cache = cache.place(self._placed_mesh(),
                                self._cache_specs_for(B))
        rest = prompt[L:]
        off = 0
        hidden_last = None
        while off < len(rest):
            span = min(len(rest) - off, self.seq_buckets[-1])
            Tc = self._chunk_shape(span, self.max_seq_len - L - off)
            span = min(span, Tc)
            toks = np.zeros((B, Tc), np.int32)
            mask = np.zeros((B, Tc), bool)
            toks[0, :span] = rest[off : off + span]
            mask[0, :span] = True
            hid, cache = self._run_prefill(toks, mask, cache, chunk=True,
                                           first=False)
            if off + span >= len(rest):
                hidden_last = hid[:, span - 1]
            off += span
        logits = _head_from_hidden(self.params, hidden_last, self.cfg)
        return logits, cache, [len(prompt)], B

    def warmup(self, *, max_new_tokens: int = 128) -> float:
        """One ``generate_compiled`` per batch bucket at the smallest
        sequence bucket, with stacked ``[B, 1]`` knobs as the serving
        worker sends them (eager PyTorch compiles nothing; this touches
        the allocator and the cuBLAS handles once). Returns seconds."""
        t0 = time.perf_counter()
        span = max(self.seq_buckets[0] // 2, 1)
        for b in self.batch_buckets:
            self.generate_compiled(
                [[1] * span] * b, max_new_tokens=max_new_tokens,
                sampling=SamplingParams.stack([SamplingParams.make()] * b,
                                              pad_to=b),
            )
        return time.perf_counter() - t0

    # -- host-driven API --------------------------------------------------
    def prefill(
        self, prompts: Iterable[Sequence[int]], *, reuse_prefix: bool = False
    ):
        """Pad prompts into (batch, seq) buckets; returns ``(last_logits
        [B, V], cache, prompt_lens, batch_pad)``. Prompts longer than the
        largest seq bucket prefill in bucket-sized chunks through the
        cache, with the vocab head applied once to each row's last-token
        hidden state. ``reuse_prefix`` (one prompt): seed the cache from
        the longest stored prompt prefix and prefill only the suffix; the
        full prompt's rows are stored back for the next turn."""
        prompts = [list(p) for p in prompts]
        if reuse_prefix and len(prompts) == 1:
            prompt = prompts[0]
            if len(prompt) > self.max_seq_len:
                raise ValueError(
                    f"prompt length {len(prompt)} exceeds max_seq_len "
                    f"{self.max_seq_len}"
                )
            hit = self._prefix_match(prompt)
            if hit is not None:
                L_use, entry = hit
                out = self._prefill_with_prefix(prompt, L_use, entry)
                self._prefix_store(prompt, out[1], base_entry=entry,
                                   base_len=L_use)
                return out
            out = self.prefill(prompts)
            self._prefix_store(prompt, out[1])
            return out
        B = self.batch_bucket(len(prompts))
        lens = [len(p) for p in prompts]
        T_max = max(lens)
        if T_max > self.max_seq_len:
            raise ValueError(
                f"prompt length {T_max} exceeds max_seq_len {self.max_seq_len}"
            )
        if T_max <= self.seq_buckets[-1]:
            T = _bucket(T_max, self.seq_buckets)
            toks = np.zeros((B, T), np.int32)
            mask = np.zeros((B, T), bool)
            for i, p in enumerate(prompts):
                toks[i, : len(p)] = p
                mask[i, : len(p)] = True
            logits, cache = self._run_prefill(toks, mask, self.new_cache(B),
                                              chunk=False, first=True)
            return logits, cache, lens, B
        return self._prefill_chunked(prompts, lens, B)

    def _prefill_chunked(self, prompts, lens, B):
        C = self.seq_buckets[-1]
        T_max = max(lens)
        cache = self.new_cache(B)
        lens_a = np.asarray(lens + [0] * (B - len(lens)))
        hidden_last = None
        off = 0
        rows = torch.arange(B, device=self.device)
        while off < T_max:
            span = min(C, T_max - off)
            # the chunk may not overrun the cache (a clamped write would
            # shift it backward over real keys)
            Tc = self._chunk_shape(span, self.max_seq_len - off)
            toks = np.zeros((B, Tc), np.int32)
            mask = np.zeros((B, Tc), bool)
            for i, p in enumerate(prompts):
                part = p[off : off + Tc]
                toks[i, : len(part)] = part
                mask[i, : len(part)] = True
            hid, cache = self._run_prefill(toks, mask, cache, chunk=True,
                                           first=off == 0)
            if hidden_last is None:
                hidden_last = torch.zeros((B, hid.shape[-1]), dtype=hid.dtype,
                                          device=self.device)
            # rows whose last real token falls inside this chunk grab its
            # (already final-normed) hidden state
            last_idx = lens_a - 1
            in_chunk = (last_idx >= off) & (last_idx < off + Tc)
            local = self._tensor(np.clip(last_idx - off, 0, Tc - 1),
                                 torch.int64)
            hidden_last = torch.where(
                self._tensor(in_chunk, torch.bool)[:, None], hid[rows, local],
                hidden_last,
            )
            off += Tc
        logits = _head_from_hidden(self.params, hidden_last, self.cfg)
        return logits, cache, lens, B

    def _start(self, prompts, sampling, max_new_tokens, budgets,
               reuse_prefix, seed):
        """The three decode APIs' shared prologue: prefill, knobs padded to
        the batch bucket and moved to the device, per-row limits, and the
        first split of the key walk."""
        logits, cache, lens, B = self.prefill(prompts,
                                              reuse_prefix=reuse_prefix)
        sampling = sampling.pad_rows(B).to(self.device)
        eff = self._row_limits(lens, B, max_new_tokens, budgets)
        key, sub = prng.split(prng.PRNGKey(seed, device=self.device))
        return logits, cache, lens, B, sampling, eff, key, sub

    def _eos(self, eos_ids) -> torch.Tensor:
        return self._tensor(list(eos_ids) or [-1])

    def generate(
        self,
        prompts: Iterable[Sequence[int]],
        *,
        max_new_tokens: int = 128,
        sampling: SamplingParams | None = None,
        eos_ids: Sequence[int] = (),
        seed: int = 0,
        stream_cb: Callable[[list[int | None]], None] | None = None,
        budgets: Sequence[int] | None = None,
        reuse_prefix: bool = False,
    ) -> GenerationResult:
        """Host-driven loop (per-token streaming callbacks).

        ``stream_cb`` receives, per step, one new token id per live row
        (None for rows already finished); it may return row indices to
        cancel, which freeze at once. ``budgets`` caps rows individually;
        each row is limited by its own budget and cache room."""
        sampling = sampling or SamplingParams.make()
        prompts = [list(p) for p in prompts]
        logits, cache, lens, B, sampling, eff, key, sub = self._start(
            prompts, sampling, max_new_tokens, budgets, reuse_prefix, seed)
        n_rows = len(lens)
        steps = max(eff)
        eos = np.asarray(list(eos_ids) or [-1], np.int32)
        pen = sampling.penalized()
        any_sampled = sampling.any_sampled()
        counts = self._prompt_counts(prompts, B) if pen else None
        tok = sample(logits, sub, sampling, counts, any_sampled=any_sampled)
        seqs: list[list[int]] = [[] for _ in range(n_rows)]
        done = np.asarray([e <= 0 for e in eff])
        rows = torch.arange(B, device=self.device)
        for step in range(steps):
            tok_host = tok.cpu().numpy()
            emitted: list[int | None] = []
            for i in range(n_rows):
                if not done[i]:
                    seqs[i].append(int(tok_host[i]))
                    emitted.append(int(tok_host[i]))
                else:
                    emitted.append(None)
            if pen:
                # fold the just-emitted token into the context counts
                live = [i < n_rows and emitted[i] is not None
                        for i in range(B)]
                counts.index_put_((rows, tok.long()),
                                  self._tensor(live), accumulate=True)
            done |= np.isin(tok_host, eos)
            for i in range(n_rows):
                if len(seqs[i]) >= eff[i]:
                    done[i] = True
            if stream_cb is not None:
                cancel = stream_cb(emitted)
                for i in cancel or ():
                    if 0 <= int(i) < B:
                        done[int(i)] = True
            if done[:n_rows].all() or step == steps - 1:
                break
            key, sub = prng.split(key)
            logits, cache = _decode_step(self.params, tok, cache, self.cfg)
            nxt = sample(logits, sub, sampling, counts,
                         any_sampled=any_sampled)
            tok = torch.where(self._tensor(done, torch.bool), tok, nxt)
        del cache
        return GenerationResult(
            sequences=seqs, prompt_lens=lens, finished=list(done[:n_rows])
        )

    def generate_chunked(
        self,
        prompts: Iterable[Sequence[int]],
        *,
        max_new_tokens: int = 128,
        sampling: SamplingParams | None = None,
        eos_ids: Sequence[int] = (),
        seed: int = 0,
        stream_cb: Callable[[list[int | None]], None] | None = None,
        budgets: Sequence[int] | None = None,
        reuse_prefix: bool = False,
        chunk_steps: int = 32,
        shrink_on_eviction: bool = True,
    ) -> GenerationResult:
        """Streaming at the decode loop's speed: the decode runs as a
        sequence of ``_decode_loop`` chunks of ``chunk_steps`` steps, with
        the host touched once per chunk while keeping the stream
        callback's per-step contract. A cancel from the callback stops
        that row's emission at once. Penalized requests take the per-token
        host loop (context counts do not ride across chunks).

        ``shrink_on_eviction``: when rows finish mid-batch, the next chunk
        gathers the survivors' cache rows into the smallest bucket that
        holds them. Greedy-only: a sampled row's draw depends on the
        batch's shared key walk, so sampled mixes keep their shape (seed
        parity with ``generate_compiled``). ``self.last_chunk_batches``
        records each chunk's batch shape."""
        sampling = sampling or SamplingParams.make()
        if sampling.penalized():
            return self.generate(
                prompts, max_new_tokens=max_new_tokens, sampling=sampling,
                eos_ids=eos_ids, seed=seed, stream_cb=stream_cb,
                budgets=budgets, reuse_prefix=reuse_prefix,
            )
        prompts = [list(p) for p in prompts]
        logits, cache, lens, B, sampling, eff, key, sub = self._start(
            prompts, sampling, max_new_tokens, budgets, reuse_prefix, seed)
        n_rows = len(lens)
        eos_set = set(int(e) for e in eos_ids)
        eos = self._eos(eos_ids)
        tok = sample(logits, sub, sampling, None)
        chunk_steps = max(int(chunk_steps), 1)

        seqs: list[list[int]] = [[] for _ in range(n_rows)]
        done = np.zeros(n_rows, bool)
        remaining = np.asarray(eff[:n_rows], np.int64)
        done |= remaining <= 0
        # batch row -> request index (None for bucket padding)
        rowmap: list[int | None] = list(range(n_rows)) + [None] * (B - n_rows)
        shrinkable = shrink_on_eviction and not sampling.any_sampled()
        self.last_chunk_batches: list[int] = []

        def emit(step_tokens: np.ndarray) -> None:
            """Deliver one decode step's tokens (one entry per request,
            None for finished rows) and fold them into the sequences and
            done flags."""
            emitted: list[int | None] = [None] * n_rows
            for r, i in enumerate(rowmap):
                if i is None or done[i]:
                    continue
                t = int(step_tokens[r])
                seqs[i].append(t)
                emitted[i] = t
                remaining[i] -= 1
                if t in eos_set or remaining[i] <= 0:
                    done[i] = True
            if stream_cb is not None:
                cancel = stream_cb(emitted)
                for i in cancel or ():
                    if 0 <= int(i) < n_rows:
                        done[int(i)] = True

        emit(tok.cpu().numpy())
        while not done.all():
            if shrinkable:
                live = [i for i in range(n_rows) if not done[i]]
                newB = self.batch_bucket(len(live))
                if newB < len(rowmap):
                    # gather the survivors' rows into the smaller bucket
                    # (padding rows copy a live row: no NaN row rides on)
                    keep = [rowmap.index(i) for i in live]
                    gidx = self._tensor(keep + [keep[0]] * (newB - len(keep)),
                                        torch.int64)
                    cache = self._take(cache, gidx)
                    tok = tok[gidx]
                    sampling = sampling.take(gidx)
                    rowmap = list(live) + [None] * (newB - len(live))
            self.last_chunk_batches.append(len(rowmap))
            # finished rows freeze for the whole chunk (limit 0); live rows
            # run up to their remaining budget, capped by the chunk. The
            # loop returns its advanced key, so the split chain continues
            # across chunks exactly as one long loop walks it
            lims = [0 if (i is None or done[i]) else int(remaining[i])
                    for i in rowmap]
            tokens, cache, _dd, n_exec, key = _decode_loop(
                self.params, tok, cache, key, sampling, eos, lims, None,
                self.cfg, chunk_steps,
            )
            n_exec = int(n_exec)
            if n_exec <= 0:
                break
            toks_host = tokens[:, :n_exec].cpu().numpy()
            for s in range(n_exec):
                emit(toks_host[:, s])
                if done.all():
                    break
            # the next chunk resumes from each row's last token (frozen
            # rows re-fed their own token, so column n_exec - 1 holds it)
            tok = tokens[:, n_exec - 1].clone()
        del cache
        return GenerationResult(
            sequences=seqs, prompt_lens=lens, finished=list(done[:n_rows])
        )

    # -- beam search ------------------------------------------------------
    def beam_start(
        self,
        prompts: Iterable[Sequence[int]],
        *,
        num_beams: int = 4,
        max_new_tokens: int = 128,
        eos_ids: Sequence[int] = (),
        length_penalty: float = 1.0,
    ) -> BeamState:
        """Prefill and first-token expansion of a resumable beam session.
        Beams ride the batch axis: each step is one batched decode plus a
        cache reorder; candidate selection (:func:`_beam_topk`) runs on
        the device and ships ``[K, kk]`` (score, id) pairs to the host."""
        prompts = [list(p) for p in prompts]
        if len(prompts) != 1:
            raise ValueError("beam search is B=1")
        K = int(num_beams)
        if K < 1:
            raise ValueError("num_beams must be >= 1")
        if K > max(self.batch_buckets):
            raise ValueError(
                f"num_beams {K} exceeds the largest batch bucket "
                f"{max(self.batch_buckets)}"
            )
        prompt = prompts[0]
        eos_set = set(int(e) for e in eos_ids)
        room = min(max_new_tokens, self.max_seq_len - len(prompt))
        if room <= 0:
            return BeamState(
                engine=self, K=K, B=0, room=0, prompt_len=len(prompt),
                eos_set=eos_set, length_penalty=float(length_penalty),
            )
        # prefill once at B=1 and tile the cache rows to K
        logits1, cache1, _lens, _ = self.prefill([prompt])
        B = _bucket(K, self.batch_buckets)
        cache = self._take(cache1, torch.zeros((B,), dtype=torch.int64))
        del cache1
        st = BeamState(
            engine=self, K=K, B=B, room=room, prompt_len=len(prompt),
            eos_set=eos_set, length_penalty=float(length_penalty),
        )
        vals, idx = _beam_topk(logits1[:1], K)
        row_v = vals[0].cpu().numpy()
        row_i = idx[0].cpu().numpy()
        st.scores = row_v.astype(np.float64)
        st.beams = [[int(t)] for t in row_i]
        st.alive = [int(t) not in eos_set for t in row_i]
        for k, b in enumerate(st.beams):
            if not st.alive[k]:
                st.done_pool.append((st.scores[k] / 1.0, b))
        st.cache = cache
        st.tok = self._tensor(np.resize(row_i.astype(np.int32), (B,)))
        st.step = 1
        return st

    def beam_advance(self, st: BeamState, max_steps: int | None = None) -> bool:
        """Run up to ``max_steps`` beam steps (all remaining when None).
        Returns True when the session is finished."""
        if st.room <= 0:
            return True
        n = 0
        K = st.K
        kk = K + len(st.eos_set)
        while st.step < st.room and any(st.alive):
            if max_steps is not None and n >= max_steps:
                return False
            n += 1
            st.step += 1
            logits, st.cache = _decode_step(self.params, st.tok, st.cache,
                                            self.cfg)
            vals, idx = _beam_topk(logits[:K], kk)
            nxt = beam_frontier_step(
                st.beams, st.scores, st.alive, st.done_pool,
                vals.cpu().numpy(), idx.cpu().numpy(), K, st.eos_set,
                st.room, st.length_penalty,
            )
            if nxt is None:
                break
            st.beams, st.scores, st.alive, src = nxt
            # reorder every beam's cache row to follow its source beam
            st.cache = self._take(st.cache, torch.as_tensor(
                np.resize(np.asarray(src, np.int64), (st.B,))))
            st.tok = self._tensor(np.resize(
                np.asarray([b[-1] for b in st.beams], np.int32), (st.B,)))
        return True

    def beam_finish(self, st: BeamState) -> GenerationResult:
        """Close the session: fold surviving beams into the pool and pick
        the best by GNMT length-normalized log-probability."""
        if st.room <= 0:
            return GenerationResult(
                sequences=[[]], prompt_lens=[st.prompt_len], finished=[True]
            )
        st.cache = None  # free the tiled KV
        for k in range(st.K):
            if st.alive[k]:
                st.done_pool.append(
                    (st.scores[k] / (len(st.beams[k]) ** st.length_penalty),
                     st.beams[k])
                )
        _best_score, best = max(st.done_pool, key=lambda d: d[0])
        fin = bool(best and best[-1] in st.eos_set)
        return GenerationResult(
            sequences=[best], prompt_lens=[st.prompt_len], finished=[fin]
        )

    def generate_beam(
        self,
        prompts: Iterable[Sequence[int]],
        *,
        num_beams: int = 4,
        max_new_tokens: int = 128,
        eos_ids: Sequence[int] = (),
        length_penalty: float = 1.0,
    ) -> GenerationResult:
        """One-shot beam-search decode (B=1): start + advance + finish.
        Returns the best finished beam by length-normalized
        log-probability (``len ** length_penalty``)."""
        st = self.beam_start(
            prompts, num_beams=num_beams, max_new_tokens=max_new_tokens,
            eos_ids=eos_ids, length_penalty=length_penalty,
        )
        self.beam_advance(st)
        return self.beam_finish(st)

    # -- speculative decode (prompt-lookup) -------------------------------
    # The drafting and acceptance policy lives in engine/spec.py; these
    # staticmethods are the engine-level override points.
    @staticmethod
    def _lookup_draft(
        history: list[int], n_draft: int, ngram: int = 8, min_ngram: int = 2,
    ) -> list[int]:
        """Prompt-lookup drafting (engine/spec.py::lookup_draft)."""
        from .spec import lookup_draft

        return lookup_draft(history, n_draft, ngram=ngram, min_ngram=min_ngram)

    @staticmethod
    def _spec_worthwhile(tokens_per_pass: float, t_verify: float,
                         t_decode: float) -> bool:
        """The break-even rule (engine/spec.py::spec_worthwhile)."""
        from .spec import spec_worthwhile

        return spec_worthwhile(tokens_per_pass, t_verify, t_decode)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate_lookahead(
        self,
        prompts: Iterable[Sequence[int]],
        *,
        max_new_tokens: int = 128,
        eos_ids: Sequence[int] = (),
        n_draft: int = 8,
        reuse_prefix: bool = False,
        stream_cb: Callable[[list[int | None]], None] | None = None,
        compiled_fallback: bool = True,
    ) -> GenerationResult:
        """Greedy decode with prompt-lookup speculation (B=1): draft up to
        ``n_draft`` tokens from the history's own n-grams, verify them in
        one forward, keep the matched prefix plus the model's correction
        token. Emits exactly the plain greedy sequence; speculation only
        changes how many passes it takes.

        Adaptive as in JAX: a step with no n-gram hit runs a plain decode
        step; both pass kinds are timed (EMA over synchronised wall time,
        the first sample dropped) and once speculation measures slower
        than plain decode, or its acceptance stays low
        (engine/spec.py::SpecController), the remainder decodes plainly —
        through ``_decode_loop`` when ``compiled_fallback`` and not
        streaming."""
        from .spec import SpecController

        prompts = [list(p) for p in prompts]
        if len(prompts) != 1:
            raise ValueError("lookahead decode is B=1 (serving conversations)")
        logits, cache, lens, B = self.prefill(prompts,
                                              reuse_prefix=reuse_prefix)
        n_passes = 1  # the prefill pass produced the first token
        n_verify = 0
        n_decode = 0
        eos_set = set(int(e) for e in eos_ids)
        history = list(prompts[0])
        tok = int(torch.argmax(logits[0]))
        seq: list[int] = [tok]
        history.append(tok)
        if stream_cb is not None:
            stream_cb([tok])
        room = self.max_seq_len - lens[0]
        limit = min(max_new_tokens, room)

        ema_tv: float | None = None
        ema_td: float | None = None
        seen_tv = seen_td = 0
        ctrl = SpecController(
            n_draft=n_draft, rearm=stream_cb is not None,
            draft_fn=self._lookup_draft,
        )
        ctrl.prescan(history)

        def note_pair() -> None:
            ctrl.note_pair(history[-2], history[-1])

        def full_tok(t: int) -> torch.Tensor:
            return torch.full((B,), t, dtype=torch.int32, device=self.device)

        compiled_tail = 0
        while len(seq) < limit and tok not in eos_set:
            remaining = limit - len(seq)
            if not ctrl.on and compiled_fallback and stream_cb is None:
                # speculation measured itself out: decode the remainder in
                # one _decode_loop
                n_steps = 1
                while n_steps < remaining:
                    n_steps <<= 1
                n_steps = max(min(n_steps, self.max_seq_len), 1)
                sp = SamplingParams.stack([SamplingParams.make()],
                                          pad_to=B).to(self.device)
                tokens, cache, _done, n_exec, _key = _decode_loop(
                    self.params, full_tok(tok), cache,
                    prng.PRNGKey(0, device=self.device), sp,
                    self._tensor(sorted(eos_set) or [-1]),
                    [remaining] + [0] * (B - 1), None, self.cfg, n_steps,
                )
                compiled_tail = int(n_exec)
                n_passes += compiled_tail
                row = tokens[0].cpu().numpy()
                for t in row[: min(compiled_tail, remaining)]:
                    t = int(t)
                    seq.append(t)
                    tok = t
                    if t in eos_set:
                        break
                break
            k = min(n_draft, remaining - 1,
                    self.max_seq_len - lens[0] - len(seq))
            was_on = ctrl.active
            draft = ctrl.draft(history, cap=k) if k > 0 else []
            ctrl.drafted += len(draft)  # no budget here: granted = proposed
            if not draft:
                if was_on and not ctrl.on:
                    # the miss-run disarm just fired: non-stream hands the
                    # remainder to the loop above
                    continue
                # no hit (or speculation off): one plain decode step
                t0 = time.perf_counter()
                logits, cache = _decode_step(self.params, full_tok(tok),
                                             cache, self.cfg)
                tok = int(torch.argmax(logits[0]))
                dt = time.perf_counter() - t0
                seen_td += 1
                if seen_td > 1:  # the first sample warms the allocator
                    ema_td = dt if ema_td is None else 0.5 * dt + 0.5 * ema_td
                n_passes += 1
                n_decode += 1
                seq.append(tok)
                history.append(tok)
                note_pair()
                if stream_cb is not None:
                    stream_cb([tok])
                continue
            base_len = int(cache.length[0])
            # a fixed [1, 1 + n_draft] verify shape whenever the cache has
            # room; padded positions are rolled back with the rejects
            pad_to = len(draft)
            if base_len + 1 + n_draft <= self.max_seq_len:
                pad_to = n_draft
            toks = np.zeros((B, 1 + pad_to), np.int32)
            toks[0, 0] = tok
            toks[0, 1 : 1 + len(draft)] = draft
            self._sync()
            t0 = time.perf_counter()
            targets, cache = _verify_step(self.params, self._tensor(toks),
                                          cache, self.cfg)
            t_host = targets[0].cpu().numpy()
            dt = time.perf_counter() - t0
            n_passes += 1
            n_verify += 1
            accepted = 0
            while accepted < len(draft) and draft[accepted] == int(
                    t_host[accepted]):
                if draft[accepted] in eos_set:
                    break
                accepted += 1
            emitted = list(draft[:accepted]) + [int(t_host[accepted])]
            ctrl.note_verify(accepted + 1)
            seen_tv += 1
            if seen_tv > 1:
                ema_tv = dt if ema_tv is None else 0.5 * dt + 0.5 * ema_tv
                if ema_td is not None and seen_tv > 3 and not ctrl.dead:
                    if not self._spec_worthwhile(ctrl.ema_acc, ema_tv, ema_td):
                        ctrl.kill()
            # roll back rejected positions by resetting length only
            cache.length = torch.full_like(cache.length,
                                           base_len + 1 + accepted)
            taken: list[int] = []
            for t in emitted:
                seq.append(t)
                history.append(t)
                note_pair()
                taken.append(t)
                tok = t
                if t in eos_set or len(seq) >= limit:
                    break
            if stream_cb is not None and taken:
                for t in taken:  # per-token, as the host loop streams
                    stream_cb([t])
            if tok in eos_set:
                break
        del cache
        seq = seq[:limit]
        self.last_lookahead_stats = {
            "tokens": len(seq),
            "passes": n_passes,
            "verify_passes": n_verify,
            "decode_steps": n_decode,
            "tokens_per_pass": round(len(seq) / max(n_passes, 1), 3),
            "tokens_per_verify_pass": round(ctrl.tokens_per_pass, 3)
            if n_verify else None,
            "spec_disabled": not ctrl.on,
            "compiled_tail": compiled_tail,
        }
        fin = bool(seq and seq[-1] in eos_set)
        return GenerationResult(sequences=[seq], prompt_lens=lens, finished=[fin])

    # -- repetition penalties --------------------------------------------
    def _prompt_counts(self, prompts, B: int) -> torch.Tensor:
        """Per-row token counts over the prompt — the context the
        presence/frequency penalties score against."""
        c = np.zeros((B, self.cfg.vocab_size), np.int32)
        for i, p in enumerate(prompts):
            np.add.at(c[i], np.asarray(list(p), np.int64), 1)
        return self._tensor(c)

    def _row_limits(
        self,
        lens: list[int],
        B: int,
        max_new_tokens: int,
        budgets: Sequence[int] | None,
    ) -> list[int]:
        """Per-row total-token limits: each row capped by its own budget
        and its own cache room; bucket-padding rows get 0."""
        eff = []
        for i in range(len(lens)):
            want = int(budgets[i]) if budgets else max_new_tokens
            eff.append(max(min(want, self.max_seq_len - lens[i]), 0))
        eff += [0] * (B - len(lens))
        return eff

    # -- the decode loop API (throughput / bench) -------------------------
    def generate_compiled(
        self,
        prompts: Iterable[Sequence[int]],
        *,
        max_new_tokens: int = 128,
        sampling: SamplingParams | None = None,
        eos_ids: Sequence[int] = (),
        seed: int = 0,
        budgets: Sequence[int] | None = None,
        reuse_prefix: bool = False,
    ) -> GenerationResult:
        """The whole token loop in ``_decode_loop`` (EOS early exit, no
        host round trip per token). ``budgets`` caps rows individually."""
        sampling = sampling or SamplingParams.make()
        prompts = [list(p) for p in prompts]
        logits, cache, lens, B, sampling, eff, key, sub = self._start(
            prompts, sampling, max_new_tokens, budgets, reuse_prefix, seed)
        total = max(eff)
        if total <= 0:
            del cache
            return GenerationResult(
                sequences=[[] for _ in lens], prompt_lens=lens,
                finished=[True] * len(lens),  # zero room = nothing left
            )
        pen = sampling.penalized()
        counts = self._prompt_counts(prompts, B) if pen else None
        first = sample(logits, sub, sampling, counts)
        eos = self._eos(eos_ids)
        limits = [e - 1 for e in eff]  # after first
        if pen:
            counts.index_put_(
                (torch.arange(B, device=self.device), first.long()),
                self._tensor([e > 0 for e in eff]), accumulate=True)
        # n_steps bucketed to powers of two, as the JAX engine compiles it
        # (the loop exits once every row is at its limit)
        n_steps = 1
        while n_steps < total - 1:
            n_steps <<= 1
        n_steps = max(min(n_steps, self.max_seq_len), 1)
        tokens, cache, done, n_exec, _key = _decode_loop(
            self.params, first, cache, key, sampling, eos, limits, counts,
            self.cfg, n_steps, penalize=pen,
        )
        del cache
        toks = tokens.cpu().numpy()
        first_host = first.cpu().numpy()
        n_exec = int(n_exec)
        out: list[list[int]] = []
        fin: list[bool] = []
        done_host = done.cpu().numpy()
        eos_set = set(int(e) for e in eos.cpu().numpy())
        for i in range(len(lens)):
            if eff[i] <= 0:
                out.append([])
                fin.append(True)  # as generate(): zero-room rows are done
                continue
            row = [int(first_host[i])]
            if row[0] not in eos_set:
                for t in toks[i, : min(n_exec, eff[i] - 1)]:
                    t = int(t)
                    row.append(t)
                    if t in eos_set:
                        break
            out.append(row)
            fin.append(bool(done_host[i]))
        return GenerationResult(sequences=out, prompt_lens=lens, finished=fin)


__all__ = [
    "BeamState",
    "GenerationEngine",
    "GenerationResult",
    "beam_frontier_step",
]
