"""The host-RAM prefix tier and the fleet pull in the port
(engine/kvtier.py, fleet/prefixmap.py, core/faults.py and the engine's
demote / promote / pull rungs) against the JAX package.

- ``HostPagePool`` driven by one script in both packages ends in the same
  state (stats, digest, residency, version, lookups); ``FleetPrefixMap``
  ranks the same candidates.
- A prefix evicted into the host tier and promoted back: streams token-
  equal to the JAX engine's and to a cold run, the tier counters equal to
  JAX's, in fp and int8 pages; the demoted and promoted bytes equal the
  cold prefill's pages bitwise, solo and with a co-batched neighbour.
- The fleet pull through ``make_fleet_fetcher`` over live
  ``router_snapshot`` views: the cold stream, prefill skipped; a stale
  weights version and a source that lost its pages degrade to prefill.
- The fault sites ``kvtier.demote``/``kvtier.fetch`` degrade to the next
  rung with the stream unchanged and pages conserved.
- JAX state carried over: a JAX host tier's entries and a JAX
  ``export_prefix_pages`` blob serve as hits in the port, with JAX's
  stream.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.engine import kvtier as jkvtier
from tensorlink_tpu.engine.continuous import ContinuousEngine as JEngine
from tensorlink_tpu.engine.generate import GenerationEngine as JGen
from tensorlink_tpu.fleet import prefixmap as jprefixmap
from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu_torch.convert import (
    blob_from_jax,
    config_from_jax,
    host_pool_from_jax,
    params_from_jax,
)
from tensorlink_tpu_torch.core import faults
from tensorlink_tpu_torch.engine import kvtier
from tensorlink_tpu_torch.engine.continuous import ContinuousEngine
from tensorlink_tpu_torch.engine.generate import GenerationEngine
from tensorlink_tpu_torch.engine.paged import gather_page
from tensorlink_tpu_torch.engine.sampling import SamplingParams
from tensorlink_tpu_torch.fleet import prefixmap

torch.set_num_threads(1)

JCFG = JModelConfig(
    family="qwen3", vocab_size=258, d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, max_seq_len=64, qk_norm=True,
    tie_embeddings=True, rope_theta=1e6, dtype=jnp.float32,
)
PAGE = 8
# tlint: disable=TL006(read-only constant table)
ENGINE_KW = dict(max_slots=4, page_size=PAGE, chunk_steps=4,
                 prefill_chunk=16)
# 3 pages: the 2 full pages before the last prompt token are cached
# tlint: disable=TL006(read-only shared-prompt data)
PROMPT = list(range(1, 25))


@pytest.fixture(scope="module")
def models():
    jparams = j_init_params(JCFG, jax.random.PRNGKey(0))
    cfg = config_from_jax(dataclasses.asdict(JCFG))
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    jgen = JGen(JCFG, jparams, seq_buckets=(8, 32), batch_buckets=(1,),
                max_seq_len=64)
    tgen = GenerationEngine(cfg, tparams, max_seq_len=64, device="cpu")
    return jgen, tgen


def _serve_one(ce, prompt=PROMPT, n=8, **kw):
    req = ce.submit(prompt, max_new_tokens=n, **kw)
    ce.run_until_idle()
    assert req.finished and req.error is None
    return req


def _evict_all(ce):
    while ce.prefix.n_evictable():
        ce.alloc.free(ce.prefix.evict(ce.prefix.n_evictable()))


def _trie_pages(ce, prompt=PROMPT):
    """The host bytes of the trie pages that cover ``prompt``."""
    nodes = ce.prefix.match(prompt, len(prompt) - 1)
    return [gather_page(ce.cache, n.page) for n in nodes]


# -- the host pool and the prefix map, script for script --------------------
def _blocks(*starts):
    return tuple(tuple(range(s, s + PAGE)) for s in starts)


def _pool_script(mod):
    pool = mod.HostPagePool(capacity=3, page_size=PAGE)
    k = np.arange(2 * 2 * PAGE * 4, dtype=np.float32).reshape(2, 2, PAGE, 4)
    sc = np.ones((2, 2, PAGE), np.float32)
    log = []
    pool.put(_blocks(0), k, k, weights_version=1)
    pool.put(_blocks(0, 100), k, k, sc, sc, weights_version=1)
    log.append(pool.lookup(_blocks(0), 1) is not None)
    pool.put(_blocks(200), k, k, weights_version=1)
    pool.put(_blocks(300), k, k, weights_version=2)  # evicts the LRU
    pool.put(_blocks(0), k, k, weights_version=1)  # refresh
    log += [pool.lookup(b, v) is not None for b, v in (
        (_blocks(0, 100), 1), (_blocks(0), 1), (_blocks(300), 1),
        (_blocks(300), 2))]
    log.append(pool.drop_stale(2))
    pool.check_conservation()
    return (log, pool.stats, pool.digest(), pool.n_resident, pool.version)


def test_host_pool_script_and_prefix_map_equal_jax():
    assert _pool_script(kvtier) == _pool_script(jkvtier)
    assert "kvtier.demote" in faults.SITES and "kvtier.fetch" in faults.SITES
    from tensorlink_tpu.engine.paged import prompt_chain_hashes

    def dig(tokens):
        hs = prompt_chain_hashes(tokens, PAGE, 8)
        return {"page_size": PAGE,
                "chains": {h: (i + 1) * PAGE for i, h in enumerate(hs)}}

    views = {
        "a": {"prefix_digest": dig(PROMPT[:PAGE])},
        "b": {"host_tier_digest": dig(PROMPT[: 2 * PAGE])},
        "c": {"prefix_digest": dig([99] * 2 * PAGE)},
        "d": {"prefix_digest": dig(PROMPT[:PAGE]),
              "host_tier_digest": dig(PROMPT[: 2 * PAGE])},
        "dead": {"ok": False, "prefix_digest": dig(PROMPT)},
    }
    for kw in ({}, dict(min_tokens=PAGE), dict(exclude=("b",))):
        assert prefixmap.FleetPrefixMap(PAGE).locate(views, PROMPT, **kw) \
            == jprefixmap.FleetPrefixMap(PAGE).locate(views, PROMPT, **kw)


# -- demote and promote ------------------------------------------------------
def _tiered(cls, gen, kv_quant):
    cold_ce = cls(gen, **ENGINE_KW, kv_quant=kv_quant)
    cold = _serve_one(cold_ce).tokens
    ce = cls(gen, **ENGINE_KW, kv_quant=kv_quant, host_tier_pages=8)
    _serve_one(ce)
    _evict_all(ce)
    assert ce.prefix.n_resident == 0 and ce.host_tier.n_resident >= 2
    req = _serve_one(ce)
    assert req.cache_tier == "host"
    return cold_ce, cold, ce, req


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_host_tier_streams_and_counters_equal_jax(models, kv_quant):
    jgen, tgen = models
    _, jcold, jce, jreq = _tiered(JEngine, jgen, kv_quant)
    cold_ce, cold, ce, req = _tiered(ContinuousEngine, tgen, kv_quant)
    assert req.tokens == cold == jreq.tokens == jcold
    for key in ("prefix_demotions", "host_tier_hits",
                "prefill_tokens_skipped", "prefill_tokens", "admitted"):
        assert ce.stats[key] == jce.stats[key], key
    assert ce.host_tier.stats == jce.host_tier.stats
    snap = ce.serving_snapshot()
    assert snap["host_tier"] is True and snap["tier_fetch_ms_count"] >= 1
    assert snap["host_tier_digest"] == jce.serving_snapshot()[
        "host_tier_digest"]
    # the promoted pages are the cold prefill's bytes
    for got, want in zip(_trie_pages(ce), _trie_pages(cold_ce)):
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
    for e in (ce, cold_ce, jce):
        e.check_page_conservation()
        e.close()


def test_host_tier_demoted_bytes_and_cobatched_promote(models):
    _, tgen = models
    sp = SamplingParams.make(temperature=0.8, top_k=5)
    ref = ContinuousEngine(tgen, **ENGINE_KW)
    cold = _serve_one(ref).tokens
    cold_n = _serve_one(ref, prompt=[4, 5, 6], n=6, sampling=sp,
                        seed=3).tokens
    want_pages = _trie_pages(ref)
    ce = ContinuousEngine(tgen, **ENGINE_KW, host_tier_pages=8)
    _serve_one(ce)
    _evict_all(ce)
    for depth, pages in enumerate(want_pages, 1):
        entry = ce.host_tier.lookup(
            tuple(tuple(PROMPT[i * PAGE:(i + 1) * PAGE])
                  for i in range(depth)), 1)
        assert np.array_equal(entry.k, pages[0])
        assert np.array_equal(entry.v, pages[1])
    r1 = ce.submit([4, 5, 6], max_new_tokens=6, sampling=sp, seed=3)
    ce.step_chunk()  # r1 is mid-flight when the tiered hit admits
    r2 = ce.submit(PROMPT, max_new_tokens=8)
    ce.run_until_idle()
    assert r1.tokens == cold_n and r2.tokens == cold
    assert r2.cache_tier == "host" and ce.stats["host_tier_hits"] >= 1
    ce.check_page_conservation()
    ce.close()


# -- the fleet pull ---------------------------------------------------------
def test_fleet_pull_through_the_fetcher_and_its_refusals(models):
    _, tgen = models
    src = ContinuousEngine(tgen, **ENGINE_KW)
    cold = _serve_one(src).tokens
    dst = ContinuousEngine(tgen, **ENGINE_KW)
    engines = {"r0": dst, "r1": src}
    dst.fetch_prefix = prefixmap.make_fleet_fetcher(
        "r0", PAGE, lambda: {r: e.router_snapshot()
                             for r, e in engines.items()},
        {r: (lambda ch, lim, ns, e=e: e.export_prefix_pages(ch, lim,
                                                             n_skip=ns))
         for r, e in engines.items()},
    )
    req = _serve_one(dst)
    assert req.tokens == cold and req.cache_tier == "fleet"
    assert dst.stats["fleet_pulls"] == 1
    assert dst.stats["fleet_pull_fallbacks"] == 0
    assert dst.stats["prefill_tokens_skipped"] >= 2 * PAGE
    # a blob from other weights is refused at staging
    stale = ContinuousEngine(tgen, **ENGINE_KW)

    def stale_fetch(chain, limit, n_local):
        blob = src.export_prefix_pages(chain, limit, n_skip=n_local)
        return dict(blob, weights_version=99)

    stale.fetch_prefix = stale_fetch
    r = _serve_one(stale)
    assert r.tokens == cold and r.cache_tier == "none"
    assert stale.stats["fleet_pull_fallbacks"] == 1
    # the source lost the race to eviction mid-pull
    racing = ContinuousEngine(tgen, **ENGINE_KW)

    def racing_fetch(chain, limit, n_local):
        src.alloc.free(src.prefix.drop_all())
        return src.export_prefix_pages(chain, limit, n_skip=n_local)

    racing.fetch_prefix = racing_fetch
    r = _serve_one(racing)
    assert r.tokens == cold and racing.stats["fleet_pull_fallbacks"] == 1
    for e in (src, dst, stale, racing):
        e.check_page_conservation()
        e.close()


# -- the fault sites --------------------------------------------------------
@pytest.mark.parametrize("site", ["kvtier.demote", "kvtier.fetch"])
def test_fault_sites_degrade_and_conserve(models, site):
    _, tgen = models
    cold = _serve_one(ContinuousEngine(tgen, **ENGINE_KW)).tokens
    ce = ContinuousEngine(tgen, **ENGINE_KW, host_tier_pages=8)
    _serve_one(ce)
    plan = faults.FaultPlan.from_dict({
        "rules": [{"site": site, "op": "error", "prob": 1.0,
                   "max_fires": None}],
    })
    if site == "kvtier.demote":
        faults.install(plan)
        try:
            _evict_all(ce)
        finally:
            faults.uninstall()
        assert ce.host_tier.n_resident == 0  # destroyed, not demoted
        req = _serve_one(ce)
    else:
        _evict_all(ce)
        faults.install(plan)
        try:
            req = _serve_one(ce)
        finally:
            faults.uninstall()
    assert req.tokens == cold and req.cache_tier == "none"
    ce.check_page_conservation()
    ce.close()


# -- JAX state carried into the port ------------------------------------------
def test_jax_host_tier_and_prefix_blob_serve_in_the_port(models):
    jgen, tgen = models
    jcold_ce = JEngine(jgen, **ENGINE_KW)
    jcold = _serve_one(jcold_ce).tokens
    # a JAX host tier's entries, loaded into the port's tier
    jce = JEngine(jgen, **ENGINE_KW, host_tier_pages=8)
    _serve_one(jce)
    _evict_all(jce)
    ce = ContinuousEngine(tgen, **ENGINE_KW, host_tier_pages=8)
    assert host_pool_from_jax(jce.host_tier, ce.host_tier) >= 2
    req = _serve_one(ce)
    assert req.cache_tier == "host" and req.tokens == jcold
    # a JAX prefix export staged into a cold port engine
    blob = jcold_ce.export_prefix_pages(PROMPT, len(PROMPT) - 1)
    port = ContinuousEngine(tgen, **ENGINE_KW)
    assert port.stage_prefix(blob_from_jax(jax.device_get(blob))) == 2 * PAGE
    req = _serve_one(port)
    assert req.cache_tier == "hbm" and req.tokens == jcold
    assert port.stats["prefill_tokens_skipped"] == 2 * PAGE
    for e in (ce, port, jce, jcold_ce):
        e.check_page_conservation()
        e.close()
