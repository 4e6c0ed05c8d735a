"""The port's serving path (tensorlink_tpu_torch/engine/, ml/batching.py)
against the JAX package on the same weights and inputs, plus the port's
own contracts.

- One ``paged_ragged_step`` on a mixed block (two prefills at offsets, a
  decode, an idle slot): integers exact (tokens, n_tok, spec_m, n_exec,
  lengths, write indices, histograms), pages within float32 2e-5; over
  int8 and packed int4 pages, written codes within 1 of JAX's, scales
  within 2e-5, and every unwritten position byte-equal.
- ``ContinuousEngine`` on the same requests (greedy and sampled, one
  admitted mid-flight, two sharing a 2-page prefix): every stream token-
  equal to the JAX engine's, and the allocator/trie end in the same state.
- The same for ``kv_quant="int8"`` and ``"int4"``: streams token-equal
  to the JAX engine's, allocator and trie state identical.
- Bitwise, inside the port: solo == co-batched == mid-flight, prefix cache
  on == off, page conservation after the run; for quantized pages also
  the codes and scales a copy-on-write landing leaves behind.
- ``chain_hash``/``prompt_chain_hashes`` digests, a scripted
  allocator/trie sequence and ``pack_prefill_budgets`` equal the JAX
  package's.
- ``ContinuousBatcher(engine=…)`` answers 4 threaded ``generate`` calls,
  and over a fake two-stage model its pipelined mode makes the JAX
  batcher's session ops.
"""

import dataclasses
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.engine import paged as jpaged
from tensorlink_tpu.engine.continuous import ContinuousEngine as JEngine
from tensorlink_tpu.engine.continuous import \
    pack_prefill_budgets as j_pack_prefill_budgets
from tensorlink_tpu.engine.generate import GenerationEngine as JGen
from tensorlink_tpu.engine.sampling import SamplingParams as JSP
from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu_torch.convert import config_from_jax, params_from_jax
from tensorlink_tpu_torch.core.devices import resolve_device
from tensorlink_tpu_torch.engine import paged as tpaged
from tensorlink_tpu_torch.engine.continuous import (
    ContinuousEngine,
    pack_prefill_budgets,
)
from tensorlink_tpu_torch.engine.generate import GenerationEngine
from tensorlink_tpu_torch.engine.sampling import SamplingParams
from tensorlink_tpu_torch.ml.batching import ContinuousBatcher

# one intra-op thread: a JAX call in this process can leave torch's worker
# threads computing exp off by up to 1e-4 (tests/test_torch_flash.py)
torch.set_num_threads(1)

JCFG = JModelConfig(
    family="qwen3", vocab_size=258, d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, max_seq_len=64, qk_norm=True,
    tie_embeddings=True, rope_theta=1e6, dtype=jnp.float32,
)
# tlint: disable=TL006(read-only constant table)
ENGINE_KW = dict(max_slots=4, page_size=8, chunk_steps=4, prefill_chunk=16)
SHARED = (17, 3, 99, 42, 8, 250, 61, 5, 77, 12, 190, 33, 4, 120, 7, 88)


@pytest.fixture(scope="module")
def models():
    jparams = j_init_params(JCFG, jax.random.PRNGKey(0))
    cfg = config_from_jax(dataclasses.asdict(JCFG))
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    jgen = JGen(JCFG, jparams, seq_buckets=(8, 32), batch_buckets=(1,),
                max_seq_len=64)
    tgen = GenerationEngine(cfg, tparams, max_seq_len=64, device="cpu")
    return jgen, tgen


# -- one step ----------------------------------------------------------
def _step_inputs(rng):
    S, C, page, n_pp, L = 4, 8, 8, 8, JCFG.n_layers
    P = 1 + S * n_pp
    shape = (L, P, JCFG.n_kv_heads, page, JCFG.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    bt = np.zeros((S, n_pp), np.int32)
    bt[:3] = rng.permutation(np.arange(1, P))[: 3 * n_pp].reshape(3, n_pp)
    lengths = np.array([8, 13, 20, 0], np.int32)
    blk = rng.integers(1, 258, size=(S, C)).astype(np.int32)
    arrays = dict(
        blk=blk,
        starts=np.array([8, 13, 20, 0], np.int32),  # prefill, prefill, decode
        n_valid=np.array([8, 5, 1, 0], np.int32),  # ..., idle
        n_spec=np.zeros(S, np.int32),
        emit=np.array([True, False, True, False]),
        seeds=np.array([1, 2, 3, 4], np.int32),
        steps=np.array([0, 0, 7, 0], np.int32),
        temp=np.array([0.0, 0.0, 0.8, 0.0], np.float32),
        top_k=np.array([0, 0, 20, 0], np.int32),
        top_p=np.ones(S, np.float32),
        pres=np.array([0.0, 0.0, 0.4, 0.0], np.float32),
        freq=np.array([0.0, 0.0, 0.2, 0.0], np.float32),
        counts=rng.integers(0, 2, size=(S, 258)).astype(np.int32),
        remaining=np.array([5, 0, 2, 0], np.int32),  # slot 2 ends mid-chunk
        eos=np.full((S, 8), -1, np.int32),
    )
    return (k, v, bt, lengths), arrays


ORDER = ("blk", "cache", "starts", "n_valid", "n_spec", "emit", "seeds",
         "steps", "temp", "top_k", "top_p", "pres", "freq", "counts",
         "remaining", "eos")


def _codes(a, kv_quant):
    """int8 codes of a page array (packed int4 unpacked), as int32."""
    from tensorlink_tpu.models.quant import unpack_int4

    a = np.asarray(a)
    if kv_quant == "int4":
        return np.asarray(unpack_int4(jnp.asarray(a)))
    return a.astype(np.int32)


def _check_quantized_pages(j, t, init, kv_quant):
    """The caches after one step over quantized pages: the same positions
    were written (per layer, page, head and offset); there the codes
    differ by at most 1 (the two frameworks' f32 k/v rows may straddle a
    rounding boundary) and the scales by 2e-5 relative; everywhere else
    both equal the initial bytes. Returns the count of codes that differ."""
    k0, v0, ks0, vs0 = init
    n_diff = 0
    for jp, tp, p0, js, ts, s0 in ((j.k, t.k, k0, j.k_scale, t.k_scale, ks0),
                                   (j.v, t.v, v0, j.v_scale, t.v_scale, vs0)):
        jp, tp, js, ts = (np.asarray(jp), tp.numpy(), np.asarray(js),
                          ts.numpy())
        # page 0 is scratch: padding rows race to write it, unread
        jp, tp, p0, js, ts, s0 = (a[:, 1:] for a in (jp, tp, p0, js, ts, s0))
        written = js != s0
        assert np.array_equal(written, ts != s0)
        assert written.any()
        np.testing.assert_allclose(ts[written], js[written], rtol=2e-5,
                                   atol=0)
        assert np.array_equal(ts[~written], s0[~written])
        assert np.array_equal(tp[~written], p0[~written])
        assert np.array_equal(jp[~written], p0[~written])
        dc = np.abs(_codes(tp, kv_quant) - _codes(jp, kv_quant))
        assert dc.max() <= 1, dc.max()
        n_diff += int((dc > 0).sum())
    return n_diff


STEP_CASES = (
    pytest.param(False, "none", id="False"),
    pytest.param(True, "none", id="True"),
    pytest.param(False, "int8", id="int8-False"),
    pytest.param(True, "int8", id="int8-True"),
    pytest.param(False, "int4", id="int4-False"),
    pytest.param(True, "int4", id="int4-True"),
)


@pytest.mark.parametrize("kernel,kv_quant", STEP_CASES)
def test_one_ragged_step_matches_jax(models, kernel, kv_quant):
    jgen, tgen = models
    rng = np.random.default_rng(5)
    (k, v, bt, lengths), arrays = _step_inputs(rng)
    ks = vs = None
    if kv_quant != "none":
        # pages quantized once from the same floats, handed to both sides
        from tensorlink_tpu.models import quant as jq

        quant = jq.quantize_kv if kv_quant == "int8" else jq.quantize_kv4
        (k, ks), (v, vs) = (tuple(np.asarray(a) for a in quant(jnp.asarray(x)))
                            for x in (k, v))
    jcache = jpaged.PagedKVCache(
        k=jnp.asarray(k), v=jnp.asarray(v), block_tables=jnp.asarray(bt),
        lengths=jnp.asarray(lengths),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs),
    )
    tcache = tpaged.PagedKVCache(
        k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()),
        block_tables=torch.from_numpy(bt.copy()),
        lengths=torch.from_numpy(lengths.copy()),
        k_scale=None if ks is None else torch.from_numpy(ks.copy()),
        v_scale=None if vs is None else torch.from_numpy(vs.copy()),
    )
    jargs = [jcache if n == "cache" else jnp.asarray(arrays[n]) for n in ORDER]
    targs = [tcache if n == "cache" else torch.from_numpy(arrays[n].copy())
             for n in ORDER]
    jout = jpaged.paged_ragged_step(jgen.params, *jargs, JCFG, 4, 1, False)
    tout = tpaged.paged_ragged_step(tgen.params, *targs, tgen.cfg, 4, 1,
                                    kernel=kernel)
    names = ("tokens", "n_tok", "spec_m", "n_exec", "cache", "done", "steps",
             "counts", "remaining")
    for name, j, t in zip(names, jout, tout):
        if name == "cache":
            assert np.array_equal(np.asarray(j.lengths), t.lengths.numpy())
            assert np.array_equal(np.asarray(j.block_tables),
                                  t.block_tables.numpy())
            if kv_quant != "none":
                n_diff = _check_quantized_pages(j, t, (k, v, ks, vs),
                                                kv_quant)
                print(f"{kv_quant}: {n_diff} written codes differ by 1")
                continue
            # page 0 is scratch: padding rows race to write it, unread
            for jt, tt in ((j.k, t.k), (j.v, t.v)):
                np.testing.assert_allclose(tt.numpy()[:, 1:],
                                           np.asarray(jt)[:, 1:],
                                           rtol=2e-5, atol=2e-5)
        else:
            assert np.array_equal(np.asarray(j), t.numpy()), name
    assert int(tout[1][2]) == 2  # slot 2 emitted its budget, then froze
    jw = jpaged._ragged_write_indices(
        jnp.asarray(bt), jnp.asarray(arrays["starts"]),
        jnp.asarray(arrays["n_valid"]), 8, 8, 8,
    )
    tw = tpaged._ragged_write_indices(
        torch.from_numpy(bt), torch.from_numpy(arrays["starts"]),
        torch.from_numpy(arrays["n_valid"]), 8, 8, 8,
    )
    for j, t in zip(jw, tw):
        assert np.array_equal(np.asarray(j), t.numpy())


# -- the engine --------------------------------------------------------
REQS = (
    # (prompt, budget, sampling kwargs, seed)
    ([*SHARED, 9, 9, 1, 2], 3, {}, 11),
    ([5, 6, 7, 200, 1, 1, 3], 10, dict(temperature=0.9, top_p=0.9), 12),
    (list(range(30, 42)), 8, dict(temperature=0.7, top_k=10,
                                  presence_penalty=0.5,
                                  frequency_penalty=0.2), 13),
)
LATE = ([*SHARED, 250, 4, 4, 8, 16, 23], 8, {}, 14)  # shares 2 pages


def _run(eng_cls, gen, sp_cls, reqs, late, **kw):
    """Submit ``reqs``, step twice, submit ``late`` mid-flight, drain."""
    ce = eng_cls(gen, **{**ENGINE_KW, **kw})
    out = [ce.submit(p, max_new_tokens=n, sampling=sp_cls.make(**s), seed=sd)
           for p, n, s, sd in reqs]
    ce.step_chunk()
    ce.step_chunk()
    if late is not None:
        p, n, s, sd = late
        out.append(ce.submit(p, max_new_tokens=n, sampling=sp_cls.make(**s),
                             seed=sd))
    ce.run_until_idle()
    assert all(r.finished and r.error is None for r in out)
    return ce, [list(r.tokens) for r in out]


@pytest.fixture(scope="module")
def served(models):
    jgen, tgen = models
    jce, jstreams = _run(JEngine, jgen, JSP, REQS, LATE)
    tce, tstreams = _run(ContinuousEngine, tgen, SamplingParams, REQS, LATE)
    return jce, jstreams, tce, tstreams


def test_engine_streams_token_equal_to_jax(served):
    jce, jstreams, tce, tstreams = served
    assert tstreams == jstreams
    assert [len(s) for s in tstreams] == [3, 10, 8, 8]
    assert tce.stats["prefill_tokens_skipped"] > 0
    assert tce.stats["prefill_tokens_skipped"] == \
        jce.stats["prefill_tokens_skipped"]
    for key in ("admitted", "evicted", "decode_steps", "prefill_chunks",
                "prefill_tokens", "slot_steps_live"):
        assert tce.stats[key] == jce.stats[key], key


def test_engine_allocator_and_trie_state_equal_jax(served):
    jce, _, tce, _ = served
    assert tce.alloc._free == jce.alloc._free
    assert tce.prefix.stats == jce.prefix.stats
    assert tce.prefix.resident_pages == jce.prefix.resident_pages
    assert tce.prefix.digest() == jce.prefix.digest()
    tsnap, jsnap = tce.serving_snapshot(), jce.serving_snapshot()
    assert set(tsnap) <= set(jsnap)
    for key in tce.stats:
        assert tsnap[key] == jsnap[key], key
    tce.check_page_conservation()


def test_port_solo_cobatched_and_prefix_cache_bitwise(models, served):
    _, tgen = models
    _, _, _, tstreams = served
    for (p, n, s, sd), want in zip((*REQS, LATE), tstreams):
        _, solo = _run(ContinuousEngine, tgen, SamplingParams,
                       [(p, n, s, sd)], None)
        assert solo[0] == want
    off, streams = _run(ContinuousEngine, tgen, SamplingParams, REQS, LATE,
                        prefix_cache=False)
    assert streams == tstreams
    assert off.stats["prefill_tokens_skipped"] == 0
    off.check_page_conservation()
    off.close()


# -- quantized pages: int8 and packed int4 --------------------------------
@pytest.fixture(scope="module", params=["int8", "int4"])
def served_q(request, models):
    jgen, tgen = models
    kv = request.param
    jce, jstreams = _run(JEngine, jgen, JSP, REQS, LATE, kv_quant=kv)
    tce, tstreams = _run(ContinuousEngine, tgen, SamplingParams, REQS, LATE,
                         kv_quant=kv)
    assert tce.cache.quantized and tce.kv_quant == kv
    return kv, jce, jstreams, tce, tstreams


def test_quantized_engine_streams_token_equal_to_jax(served_q):
    _, jce, jstreams, tce, tstreams = served_q
    assert tstreams == jstreams
    assert [len(s) for s in tstreams] == [3, 10, 8, 8]
    assert tce.stats["prefill_tokens_skipped"] > 0
    for key in tce.stats:
        assert tce.stats[key] == jce.stats[key], key


def test_quantized_engine_allocator_and_trie_state_equal_jax(served_q):
    kv, jce, _, tce, _ = served_q
    assert tce.alloc._free == jce.alloc._free
    assert tce.prefix.stats == jce.prefix.stats
    assert tce.prefix.resident_pages == jce.prefix.resident_pages
    assert tce.prefix.digest() == jce.prefix.digest()
    tsnap, jsnap = tce.serving_snapshot(), jce.serving_snapshot()
    for key in ("kv_quant", "weight_quant", "kv_page_bytes",
                "kv_pages_total"):
        assert tsnap[key] == jsnap[key], key
    assert tsnap["kv_quant"] == kv
    tce.check_page_conservation()


def _landed_kv(ce, req):
    """A request's codes and scales at positions ``0 .. len(prompt) - 1``,
    read through its slot's block table (the slot stays bound until the
    request is evicted)."""
    c, page = ce.cache, ce.page_size
    n = len(req.prompt)
    pos = torch.arange(n)
    pg = c.block_tables[req.slot].long()[pos // page]
    off = pos % page
    return [t[:, pg, :, off] for t in (c.k, c.v, c.k_scale, c.v_scale)]


def _prefill_only(ce, prompt, seed=0):
    """Admit ``prompt`` and step until its prompt is in its pages."""
    req = ce.submit(prompt, max_new_tokens=40, seed=seed)
    while req.prefill_pos < len(prompt) and not req.finished:
        ce.step_chunk()
    assert not req.finished and req.slot >= 0
    return req


def test_port_quantized_solo_cobatched_prefix_and_cow_bitwise(models,
                                                               served_q):
    """Within the port, for each quantized page mode: solo == co-batched
    == prefix cache off, and a copy-on-write landing leaves exactly the
    codes and scales a cold prefill writes (a copy_page that dropped the
    scale rows would leave the destination page's stale ones)."""
    _, tgen = models
    kv, _, _, _, tstreams = served_q
    for (p, n, s, sd), want in zip((*REQS, LATE), tstreams):
        _, solo = _run(ContinuousEngine, tgen, SamplingParams,
                       [(p, n, s, sd)], None, kv_quant=kv)
        assert solo[0] == want
    off, streams = _run(ContinuousEngine, tgen, SamplingParams, REQS, LATE,
                        prefix_cache=False, kv_quant=kv)
    assert streams == tstreams
    off.check_page_conservation()
    off.close()

    base = [*SHARED, 21, 22, 23, 24, 25, 26, 27, 28, 29]
    fork = [*SHARED, 21, 22, 23, 24, 99, 98, 97]  # diverges mid-page 2
    hot = ContinuousEngine(tgen, **{**ENGINE_KW, "kv_quant": kv})
    warm = hot.submit(base, max_new_tokens=2, seed=0)
    hot.run_until_idle()
    assert warm.finished and hot.prefix.n_resident >= 3
    got = _landed_kv(hot, _prefill_only(hot, fork))
    assert hot.prefix.stats["cow_copies"] >= 1
    cold = ContinuousEngine(tgen, **{**ENGINE_KW, "kv_quant": kv,
                                     "prefix_cache": False})
    want = _landed_kv(cold, _prefill_only(cold, fork))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for ce in (hot, cold):
        ce.run_until_idle()
        ce.check_page_conservation()
        ce.close()


class _FakeStages:
    """A two-stage DistributedModel stand-in for the pipelined batcher: it
    records each session op (the session id aside, which is random) and
    answers each row's token from the row's inputs, seed and step."""

    def __init__(self):
        self.plan = types.SimpleNamespace(n_stages=2)
        self.spec = {"seq_len": 64}
        self.model_spec = {}
        self.ops = []

    def forward(self, tokens, attn_mask=None, **kw):
        kw.pop("session")
        samp = kw["sample"]
        self.ops.append((np.asarray(tokens).tolist(),
                         np.asarray(attn_mask).tolist(),
                         {k: (np.asarray(v).tolist()
                              if isinstance(v, np.ndarray) else v)
                          for k, v in kw.items()}))
        t = np.asarray(tokens) * np.asarray(attn_mask)
        return np.asarray([(int(t[r].sum()) + 7 * samp["steps"][r]
                            + samp["seeds"][r]) % 251
                           for r in range(t.shape[0])], np.int32)

    def _end_decode_session(self, session):
        pass


def _pipelined_run(batcher_cls):
    model = _FakeStages()
    b = batcher_cls(model, [250], max_slots=2, seed=5)
    streamed = []
    outs = [b.generate(p, max_new_tokens=n, stream_cb=streamed.extend)
            for p, n in (([3, 4, 5], 6), ([9, 1], 4), ([2] * 60, 8))]
    snap = (b.mode, b.router_snapshot(), b.admission_check("batch"))
    b.close(timeout=10)
    return outs, streamed, model.ops, snap


def test_unported_variants_are_refused(models):
    """A tensor-parallel engine with no devices named takes the local
    cards and refuses fewer than it needs (never the CPU); the batcher's
    pipelined mode is ported and makes the JAX batcher's session ops over
    a fake two-stage model (admission, recycled rows, the cache-room
    cap)."""
    from tensorlink_tpu.ml.batching import ContinuousBatcher as JBatcher

    _, tgen = models
    # speculative decoding, the shared pool, the batcher's remote and
    # pipelined modes and tensor parallelism are ported
    # (tests/test_torch_tp.py); too few cards is a ValueError
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="needs as many devices"):
            ContinuousEngine(tgen, **ENGINE_KW, tensor_parallel=2)
    got = _pipelined_run(ContinuousBatcher)
    assert got == _pipelined_run(JBatcher)
    assert got[3][0] == "pipelined" and got[0][2] == got[1][-4:]
    # int8/int4 pages are served now; an unknown mode is refused as JAX does
    with pytest.raises(ValueError, match="kv_quant"):
        ContinuousEngine(tgen, **ENGINE_KW, kv_quant="nf4")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)


# -- host half: digests and allocator/trie state -------------------------
def test_chain_hash_digests_equal_jax():
    rng = np.random.default_rng(2)
    for _ in range(20):
        toks = rng.integers(0, 151936, size=int(rng.integers(1, 80)))
        toks = [int(t) for t in toks]
        for page in (1, 8, 16):
            assert tpaged.prompt_chain_hashes(toks, page, 6) == \
                jpaged.prompt_chain_hashes(toks, page, 6)
    assert tpaged.chain_hash("", (1, 2, 3)) == jpaged.chain_hash("", (1, 2, 3))


def _script(mod):
    """A scripted admit/evict sequence over one package's allocator and
    trie; returns everything observable about the end state."""
    alloc = mod.PageAllocator(12)
    pc = mod.PrefixCache(4)
    seqs = [list(range(16)), list(range(8)) + [50, 51, 52, 53],
            list(range(12)) + [9, 9, 9, 9], [7] * 10]
    log = []
    for seq in seqs:
        nodes = pc.match(seq, len(seq) - 1)
        pc.acquire(nodes)
        cow = pc.partial_match(nodes, seq, len(seq) - 1)
        pages = alloc.alloc(4 - len(nodes)) or []
        log.append((len(nodes), cow[1] if cow else None, list(pages)))
        pc.release(nodes)
        node = nodes[-1] if nodes else None
        freed = []
        for j, pid in enumerate(pages):
            hi = (len(nodes) + j + 1) * 4
            if hi > len(seq) - 1:
                freed.append(pid)
                continue
            node, adopted = pc.insert(node, tuple(seq[hi - 4:hi]), pid,
                                      freed=freed)
            if not adopted:
                freed.append(pid)
        alloc.free(freed)
    alloc.free(pc.evict(2))
    return (log, list(alloc._free), dict(pc.stats), pc.digest(),
            sorted(pc.resident_pages), pc.n_evictable(), pc.version)


def test_allocator_and_trie_script_equals_jax():
    assert _script(tpaged) == _script(jpaged)
    assert tpaged.pages_needed(33, 16) == jpaged.pages_needed(33, 16)


@pytest.mark.parametrize("budget", [None, 0, 5, 17, 40, 1000])
def test_pack_prefill_budgets_equal_jax(budget):
    rng = np.random.default_rng(3)
    for phase in range(6):
        rem = [int(r) for r in rng.integers(-2, 40, size=phase + 1)]
        assert pack_prefill_budgets(rem, 16, budget, phase) == \
            j_pack_prefill_budgets(rem, 16, budget, phase)


def test_device_and_kernel_must_be_asked_for():
    cfg = config_from_jax(dataclasses.asdict(JCFG))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpaged.PagedKVCache.init(cfg, 2, page_size=8, max_len=16)
    cache = tpaged.PagedKVCache.init(cfg, 2, page_size=8, max_len=16,
                                     device="cpu")
    assert cache.k.device.type == "cpu"
    with pytest.raises(TypeError, match="kernel"):
        tpaged.paged_decode_step(None, None, cache, None, cfg)


# -- the batcher --------------------------------------------------------
def test_batcher_answers_threaded_generates(models, served):
    _, tgen = models
    _, _, _, tstreams = served
    b = ContinuousBatcher(engine=tgen, seed=0, **ENGINE_KW)
    reqs = (*REQS, LATE)
    results: dict[int, list[int]] = {}
    streamed: dict[int, list[int]] = {i: [] for i in range(len(reqs))}

    def call(i):
        p, n, s, _ = reqs[i]
        results[i] = b.generate(
            p, max_new_tokens=n, timeout=120,
            stream_cb=lambda toks, i=i: streamed[i].extend(toks), **s,
        )

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)
    assert sorted(results) == list(range(len(reqs)))
    for i, (p, n, s, _) in enumerate(reqs):
        assert len(results[i]) == n
        assert results[i] == streamed[i]
        if not s:  # greedy streams do not depend on the per-request seed
            assert results[i] == tstreams[i]
    st = b.stats()
    assert st["requests"] == len(reqs) and st["engine"]["admitted"] >= 4
    b.close()


# -- live weight publish ----------------------------------------------------
def _publish_run(eng_cls, gen, sp_cls, new_params):
    """A request decoding across a publish, a prefix cached before it, and
    a request admitted after it."""
    ce = eng_cls(gen, **ENGINE_KW)
    warm = ce.submit([*SHARED, 1, 2], max_new_tokens=2, seed=3)
    ce.run_until_idle()
    assert warm.finished and ce.prefix.n_resident > 0
    live = ce.submit([5, 6, 7, 200], max_new_tokens=20,
                     sampling=sp_cls.make(temperature=0.9, top_k=5), seed=12)
    while len(live.tokens) < 6:
        ce.step_chunk()
    v = ce.publish_weights(new_params)
    assert v == 2 and ce.weights_version == 2
    assert ce.prefix.n_resident == 0  # the fence freed the old chains
    after = ce.submit([*SHARED, 1, 2], max_new_tokens=8, seed=3)
    ce.run_until_idle()
    assert live.finished and len(live.tokens) == 20
    return ce, live.tokens, after.tokens


def _fresh(models):
    """Engines of their own over the fixture's weights: a publish replaces
    the engine's tree, which the module's other tests must not see."""
    jgen, tgen = models
    return (JGen(JCFG, jgen.params, seq_buckets=(8, 32), batch_buckets=(1,),
                 max_seq_len=64),
            GenerationEngine(tgen.cfg, tgen.params, max_seq_len=64,
                             device="cpu"))


def test_publish_weights_mid_stream_equal_jax(models):
    jgen, tgen = _fresh(models)
    jnew = jax.tree.map(lambda x: x * 0.5, jgen.params)
    tnew = params_from_jax(jax.device_get(jnew), device="cpu")
    jce, jlive, jafter = _publish_run(JEngine, jgen, JSP, jnew)
    shapes = {k: (tuple(v.shape), v.dtype, v.device)
              for k, v in _leaves(tgen.params)}
    tce, tlive, tafter = _publish_run(ContinuousEngine, tgen,
                                      SamplingParams, tnew)
    assert tlive == jlive and tafter == jafter
    assert tce.stats == {k: jce.stats[k] for k in tce.stats}
    # no tensor changed shape, dtype or device; the engine owns copies
    assert {k: (tuple(v.shape), v.dtype, v.device)
            for k, v in _leaves(tgen.params)} == shapes
    assert all(a is not b for (_, a), (_, b) in zip(
        _leaves(tgen.params), _leaves(tnew)))
    assert tce.serving_snapshot()["weights_version"] == 2
    # refusals: a version that does not grow, a mismatched leaf or tree
    with pytest.raises(ValueError, match="grow"):
        tce.publish_weights(tnew, version=2)
    bad = dict(tnew, final_norm={"scale": tnew["final_norm"]["scale"][:1]})
    with pytest.raises(ValueError, match="final_norm"):
        tce.publish_weights(bad)
    with pytest.raises(ValueError, match="keys"):
        tce.publish_weights({"nope": torch.zeros(2)})
    assert tce.weights_version == 2
    tce.note_train_step(12.5, 0.25)
    snap = tce.serving_snapshot()
    assert snap["train_steps"] == 1 and snap["train_step_ms"] == 12.5
    assert not tce.foreground_work()
    tce.check_page_conservation()
    tce.close()


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def test_engine_registers_the_jax_engines_counters_and_gauges(models):
    jgen, tgen = models
    jce, tce = JEngine(jgen, **ENGINE_KW), ContinuousEngine(tgen, **ENGINE_KW)
    names = [sorted(m.name for m in ce.metrics.collect())
             for ce in (jce, tce)]
    assert names[1] == names[0]
    assert set(tce.stats) == set(jce.stats)
    tsnap, jsnap = tce.serving_snapshot(), jce.serving_snapshot()
    assert set(tsnap) == set(jsnap)
    assert tce.router_snapshot().keys() == jce.router_snapshot().keys()


# -- the batcher's control surface --------------------------------------------
def test_batcher_control_surface_keys_equal_jax(models):
    from tensorlink_tpu.ml.batching import ContinuousBatcher as JBatcher

    jgen, tgen = _fresh(models)
    jb = JBatcher(engine=jgen, seed=0, spec_decode=True, host_tier_pages=8,
                  **ENGINE_KW)
    tb = ContinuousBatcher(engine=tgen, seed=0, spec_decode=True,
                           host_tier_pages=8, **ENGINE_KW)
    try:
        for b in (jb, tb):
            b.generate([*SHARED, 1, 2], max_new_tokens=4, speculative=True)
        assert tb.serving_modes() == jb.serving_modes()
        tsnap, jsnap = tb.router_snapshot(), jb.router_snapshot()
        assert tsnap.keys() == jsnap.keys()
        assert tsnap["prefix_digest"] == jsnap["prefix_digest"]
        assert tb.headroom() == jb.headroom()
        assert tb.metrics_registry() is tb.engine.metrics
        # stepping-thread verbs
        assert tb.run_on_driver(lambda e: e.live_slots) == 0
        blob = tb.pull_prefix([*SHARED, 1, 2], 17)
        assert blob is not None and blob["chain"].shape == (16,)
        ticks = []
        tb.set_background(lambda: ticks.append(1) and False)
        toks = tb.generate([9, 9, 9, 9], max_new_tokens=6,
                           speculative=True, handoff=False)
        assert len(toks) == 6 and ticks
        tb.set_background(None)
        new = {k: v for k, v in tgen.params.items()}
        assert tb.publish_weights(new) == 2
        assert tb.serving_modes()["weights_version"] == 2
        assert len(tb.generate([1, 2, 3], max_new_tokens=4)) == 4
    finally:
        jb.close()
        tb.close()
    with pytest.raises(RuntimeError):
        tb.run_on_driver(lambda e: 0)
