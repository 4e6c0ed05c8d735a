"""Co-hosting in the port: several ``ContinuousEngine`` tenants on one
``SharedPagePool`` (engine/paged.py ``PoolTenant``/``SharedPagePool``,
engine/continuous.py's cache view and cross-tenant paths), against the
JAX package and against each tenant's private-pool run.

- Two tenants over packed-int4 pages, one preempting the other's
  best_effort slot when the shared free list runs dry: every stream
  token-equal to the JAX pooled run and to a private-pool run, the pool's
  and tenants' counters equal JAX's, per-tenant quotas and pool-wide
  conservation holding at every chunk boundary, every page back at close.
- The tenants read and write ONE set of page tensors (the cache view),
  and a tenant with weight-only int8 weights streams as it does alone.
- Refusals: a mismatched page geometry, a second attach of one model id,
  and an allocation past the tenant's quota (which never takes a
  neighbour's pages).
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from tensorlink_tpu.engine.continuous import ContinuousEngine as JEngine
from tensorlink_tpu.engine.generate import GenerationEngine as JGen
from tensorlink_tpu.engine.paged import SharedPagePool as JPool
from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu_torch.convert import config_from_jax, params_from_jax
from tensorlink_tpu_torch.engine.continuous import ContinuousEngine
from tensorlink_tpu_torch.engine.generate import GenerationEngine
from tensorlink_tpu_torch.engine.paged import SharedPagePool

torch.set_num_threads(1)

JCFG = JModelConfig(
    family="qwen3", vocab_size=258, d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, max_seq_len=64, qk_norm=True,
    tie_embeddings=True, rope_theta=1e6, dtype=jnp.float32,
)
# tlint: disable=TL006(read-only constant table)
ENGINE_KW = dict(max_slots=4, page_size=8, chunk_steps=4, prefill_chunk=16)


@pytest.fixture(scope="module")
def models():
    jparams = j_init_params(JCFG, jax.random.PRNGKey(0))
    cfg = config_from_jax(dataclasses.asdict(JCFG))
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    jgen = JGen(JCFG, jparams, seq_buckets=(8, 32), batch_buckets=(1,),
                max_seq_len=64)
    tgen = GenerationEngine(cfg, tparams, max_seq_len=64, device="cpu")
    return jgen, tgen


def _solo(cls, gen, prompt, n, seed, priority="interactive", **kw):
    ce = cls(gen, **ENGINE_KW, **kw)
    req = ce.submit(prompt, max_new_tokens=n, seed=seed, priority=priority)
    ce.run_until_idle()
    ce.close()
    return req.tokens


def _pooled(cls, pool_cls, gen, cfg):
    """Two int4 tenants on a 10-page pool: B's best_effort stream holds
    pages when A's interactive request needs more than the pool has
    free, so A's admission preempts B across tenants."""
    pool = pool_cls(cfg, 10, page_size=8, kv_quant="int4",
                    **({} if pool_cls is JPool else {"device": "cpu"}))
    a = cls(gen, **ENGINE_KW, kv_quant="int4", pool=pool, model_id="a",
            page_quota=10)
    b = cls(gen, **ENGINE_KW, kv_quant="int4", pool=pool, model_id="b",
            page_quota=10)
    rb = b.submit([3, 1, 4], max_new_tokens=20, seed=7,
                  priority="best_effort")
    while len(rb.tokens) < 3:
        b.step_chunk()
    pool.check_page_conservation()
    assert b.alloc.used >= 3
    ra = a.submit([40] * 44, max_new_tokens=16, seed=5,
                  priority="interactive")
    a.step_chunk(admit_only=True)
    assert ra.slot >= 0, "the candidate should preempt across tenants"
    pool.check_page_conservation()
    while a.step_chunk() | b.step_chunk():
        pool.check_page_conservation()
        assert a.alloc.used <= a.alloc.quota
        assert b.alloc.used <= b.alloc.quota
    assert ra.finished and rb.finished
    out = dict(
        streams=(list(ra.tokens), list(rb.tokens)),
        stats=(a.stats, b.stats),
        pool=(pool.cross_preemptions, pool.cache_reclaims),
        snap=a.serving_snapshot(),
    )
    a.close()
    b.close()
    assert pool.alloc.n_free == 10 and not pool.tenants
    return out


def test_pool_cross_tenant_preemption_equal_jax_and_solo(models):
    jgen, tgen = models
    got = _pooled(ContinuousEngine, SharedPagePool, tgen, tgen.cfg)
    want = _pooled(JEngine, JPool, jgen, JCFG)
    assert got["streams"] == want["streams"]
    assert got["stats"] == want["stats"]
    assert got["pool"] == want["pool"] and got["pool"][0] >= 1
    assert got["stats"][1]["preempted_cross_tenant"] >= 1
    for key in ("pool_pages_total", "pool_tenants", "pool_quota",
                "pool_pages_used", "pool_used"):
        assert got["snap"][key] == want["snap"][key], key
    ra, rb = got["streams"]
    assert ra == _solo(ContinuousEngine, tgen, [40] * 44, 16, 5,
                       kv_quant="int4")
    assert rb == _solo(ContinuousEngine, tgen, [3, 1, 4], 20, 7,
                       "best_effort", kv_quant="int4")


def test_tenants_share_page_tensors_int8_weights_tenant_streams_as_alone(
        models):
    _, tgen = models
    q8 = GenerationEngine(tgen.cfg, tgen.params, max_seq_len=64,
                          quant="int8", device="cpu")
    pool = SharedPagePool(tgen.cfg, 40, page_size=8, device="cpu")
    a = ContinuousEngine(tgen, **ENGINE_KW, pool=pool, model_id="a",
                         page_quota=20)
    b = ContinuousEngine(q8, **ENGINE_KW, pool=pool, model_id="b",
                         page_quota=20)
    assert a.cache.k is b.cache.k is pool.kv[0]
    reqs = []
    for i, ce in enumerate((a, b, a, b)):
        reqs.append((ce, ce.submit([9, 8, 7, 6, 5, i], max_new_tokens=10,
                                   seed=i)))
    while a.step_chunk() | b.step_chunk():
        pool.check_page_conservation()
        assert a.alloc.used <= 20 and b.alloc.used <= 20
    for (ce, r), i in zip(reqs, range(4)):
        gen = tgen if ce is a else q8
        assert r.tokens == _solo(ContinuousEngine, gen, [9, 8, 7, 6, 5, i],
                                 10, i), i
    assert b.serving_snapshot()["weight_quant"] == "int8"
    a.close()
    b.close()
    assert pool.alloc.n_free == 40


def test_pool_refusals_and_quota(models):
    _, tgen = models
    pool = SharedPagePool(tgen.cfg, 12, page_size=8, device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        ContinuousEngine(tgen, **ENGINE_KW, kv_quant="int8", pool=pool,
                         model_id="x")
    with pytest.raises(ValueError, match="geometry"):
        ContinuousEngine(tgen, **{**ENGINE_KW, "page_size": 16}, pool=pool,
                         model_id="x")
    small = ContinuousEngine(tgen, **ENGINE_KW, pool=pool, model_id="s",
                             page_quota=3)
    with pytest.raises(ValueError, match="already attached"):
        ContinuousEngine(tgen, **ENGINE_KW, pool=pool, model_id="s")
    big = ContinuousEngine(tgen, **ENGINE_KW, pool=pool, model_id="big")
    # 4 pages wanted, a quota of 3: the request waits, nobody's pages move
    r = small.submit(list(range(1, 30)), max_new_tokens=2, seed=1)
    small.step_chunk()
    assert r.slot < 0 and small.alloc.used == 0
    rb = big.submit([1, 2, 3], max_new_tokens=4, seed=2)
    big.run_until_idle()
    assert rb.finished and small.alloc.used <= 3
    pool.check_page_conservation()
    snap = small.serving_snapshot()
    assert snap["pool_quota"] == 3 and snap["pool_tenants"] == 2
    big.close()
    small.close()
    assert pool.alloc.n_free == 12
