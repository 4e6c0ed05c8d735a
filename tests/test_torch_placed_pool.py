"""Co-hosting on a planned mesh: several port ``ContinuousEngine``s over
trees a worker placed on its planned mesh, tenants of one
``SharedPagePool(mesh=)`` whose pages split by kv head over the engines'
page mesh (engine/paged.py ``SharedPagePool``/``page_placement``,
``placed_cache_mesh``), against two tenants of the JAX package's
``SharedPagePool`` over the same trees ``put`` by ``stage_param_specs``
on the conftest's virtual host devices (GSPMD reads its whole pages).

The meshes, models and mixes are tests/test_torch_placed_serving.py's.
Held here:

- on ``{tensor: 2}``, ``{fsdp: 2, tensor: 2}`` and ``{expert: 2, tensor:
  2}`` with fp and int8 pages: both tenants' streams token-equal to
  JAX's, the pool's pages (all but scratch page 0) joined by kv head
  within float32 2e-5 of JAX's (int8 codes within one level), the shared
  free lists equal, quotas
  held and the pool conserved at every chunk boundary, whole at close;
- the port's own contracts on placed tenants (OLMo-2's split pages and
  whole pages of heads the axis does not divide too), bitwise: pooled ==
  private, a migration blob round trip between tenants of two pools in
  the reference layout;
- cross-tenant reclaim and preemption on a small pool, as
  tests/test_torch_pool.py does unplaced: streams, counters and the
  pool's reclaims and preemptions equal JAX's, each stream equal to its
  private run;
- ``attach`` refuses a tenant whose pages lie elsewhere, naming both
  placements, and a worker keys its pools by placement: jobs whose pages
  lie on the same positions share one, others get their own.
"""

import types


import numpy as np
import pytest
import torch

from tensorlink_tpu.engine.continuous import ContinuousEngine as JEngine
from tensorlink_tpu.engine.generate import GenerationEngine as JGen
from tensorlink_tpu.engine.paged import SharedPagePool as JPool
from tensorlink_tpu.engine.sampling import SamplingParams as JSP
from tensorlink_tpu_torch.core import serialization as tser
from tensorlink_tpu_torch.engine import paged
from tensorlink_tpu_torch.engine.continuous import ContinuousEngine
from tensorlink_tpu_torch.engine.generate import GenerationEngine
from tensorlink_tpu_torch.engine.sampling import SamplingParams
from test_torch_placed_serving import (  # noqa: F401 — `models` a fixture
    ENGINE_KW,
    MESHES,
    MIXES,
    PAGE_TOL,
    _jax_pages,
    _jax_tree,
    _joined_pages,
    _page_tp,
    _port_tree,
    _worker,
    models,
)

torch.set_num_threads(1)

# tlint: disable=TL006(read-only test data)
POOL_CASES = [(m, q) for m in ("tensor2", "fsdp2-tensor2", "expert2-tensor2")
              for q in ("none", "int8")]
POOL_PAGES = 40
QUOTA = 24


def _gens(models, mesh: str):
    """The port's and JAX's generation engines over the same placed
    tree."""
    kind, axes = MESHES[mesh]
    jcfg, host, cfg = models[kind]
    jgen = JGen(jcfg, _jax_tree(jcfg, host, axes), seq_buckets=(8, 32),
                batch_buckets=(1,), max_seq_len=64)
    gen = GenerationEngine(cfg, _port_tree(cfg, host, axes), max_seq_len=64,
                           device="cpu")
    return gen, jgen


def _pool(gen, n_pages: int, **kw) -> paged.SharedPagePool:
    """A port pool made where ``gen``'s slot engine places its pages."""
    dev, cmesh = paged.placed_cache_mesh(gen.params, gen.cfg)
    return paged.SharedPagePool(gen.cfg, n_pages, page_size=8, device=dev,
                                mesh=cmesh, **kw)


def _submit(ce, sp_cls, mixes):
    return [ce.submit(p, max_new_tokens=n, sampling=sp_cls.make(**knobs),
                      seed=seed, speculative=spec)
            for p, n, knobs, seed, spec in mixes]


def _co_serve(a, b, pool, sp_cls, mixes_a, mixes_b):
    """Both tenants' requests, stepped from one thread; quotas and the
    pool's conservation held at every chunk boundary."""
    ra, rb = _submit(a, sp_cls, mixes_a), _submit(b, sp_cls, mixes_b)
    while a.step_chunk() | b.step_chunk():
        pool.check_page_conservation()
        assert a.alloc.used <= a.alloc.quota
        assert b.alloc.used <= b.alloc.quota
    assert all(r.finished and r.error is None for r in ra + rb)
    return [list(r.tokens) for r in ra], [list(r.tokens) for r in rb]


def _private(gen, mixes, **kw) -> list:
    ce = ContinuousEngine(gen, **{**ENGINE_KW, **kw})
    rs = _submit(ce, SamplingParams, mixes)
    ce.run_until_idle()
    ce.close()
    return [list(r.tokens) for r in rs]


@pytest.mark.parametrize("mesh,kv_quant", POOL_CASES,
                         ids=[f"{m}-{q}" for m, q in POOL_CASES])
def test_placed_pool_tenants_equal_jax(models, mesh, kv_quant):
    gen, jgen = _gens(models, mesh)
    jpool = JPool(jgen.cfg, POOL_PAGES, page_size=8, kv_quant=kv_quant)
    pool = _pool(gen, POOL_PAGES, kv_quant=kv_quant)
    assert pool.placement == tuple(
        ["cpu"] * _page_tp(gen.cfg, MESHES[mesh][1]))
    got, want = [], []
    for cls, g, p, sp, out in ((ContinuousEngine, gen, pool,
                                SamplingParams, got),
                               (JEngine, jgen, jpool, JSP, want)):
        a = cls(g, **ENGINE_KW, kv_quant=kv_quant, pool=p, model_id="a",
                page_quota=QUOTA)
        b = cls(g, **ENGINE_KW, kv_quant=kv_quant, pool=p, model_id="b",
                page_quota=QUOTA)
        out.append(_co_serve(a, b, p, sp, MIXES[::2], MIXES[1::2]))
        out.append((a, b))
    assert got[0] == want[0]
    a, b = got[1]
    ja, jb = want[1]
    assert a.cache.k is b.cache.k is pool.kv[0]
    assert a.cache.tp == _page_tp(gen.cfg, MESHES[mesh][1])
    # every page but scratch page 0, which both tenants' padding rows
    # write in an order neither framework fixes
    got_p, want_p = ([t[:, 1:] for t in f(c)] for f, c in (
        (_joined_pages, a.cache), (_jax_pages, ja.cache)))
    assert [g.shape for g in got_p] == [w.shape for w in want_p]
    if kv_quant == "none":
        for g, w in zip(got_p, want_p):
            np.testing.assert_allclose(g, w, **PAGE_TOL)
    else:
        for g, w in zip(got_p[:2], want_p[:2]):
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
        for g, w in zip(got_p[2:], want_p[2:]):
            np.testing.assert_allclose(g, w, **PAGE_TOL)
    assert pool.alloc._free == jpool.alloc._free
    assert (a.alloc.used, b.alloc.used) == (ja.alloc.used, jb.alloc.used)
    for ce in (a, b, ja, jb):
        ce.close()
    assert pool.alloc.n_free == POOL_PAGES and not pool.tenants


@pytest.mark.parametrize("mesh", ["fsdp2-tensor2", "olmo2-tensor2",
                                  "heads6-tensor4"])
def test_placed_pool_tenants_stream_as_private_bitwise(models, mesh):
    """Each tenant's streams (two trees of one geometry, the second a
    weight-only int8 engine over the same placed tree) equal its private
    placed engine's; the tenants read one set of page tensors."""
    gen, _ = _gens(models, mesh)
    q8 = GenerationEngine(gen.cfg, gen.params, max_seq_len=64, quant="int8",
                          device="cpu")
    pool = _pool(gen, POOL_PAGES)
    a = ContinuousEngine(gen, **ENGINE_KW, pool=pool, model_id="a",
                         page_quota=QUOTA)
    b = ContinuousEngine(q8, **ENGINE_KW, pool=pool, model_id="b",
                         page_quota=QUOTA)
    assert a.cache.k is b.cache.k is pool.kv[0]
    sa, sb = _co_serve(a, b, pool, SamplingParams, MIXES, MIXES)
    assert sa == _private(gen, MIXES)
    assert sb == _private(q8, MIXES)
    a.close()
    b.close()
    assert pool.alloc.n_free == POOL_PAGES and not pool.tenants


def _reclaim_and_preempt(cls, sp_cls, pool, gen):
    """Two fp tenants on a 10-page pool: B's finished warm-up leaves its
    pages in B's prefix cache and B's best_effort stream holds pages when
    A's interactive request needs more than the pool has free, so A's
    admission reclaims B's cached pages and then preempts B's slot."""
    a = cls(gen, **ENGINE_KW, pool=pool, model_id="a", page_quota=10)
    b = cls(gen, **ENGINE_KW, pool=pool, model_id="b", page_quota=10)
    warm = b.submit(list(range(20, 37)), max_new_tokens=8, seed=1)
    while not warm.finished:
        b.step_chunk()
    rb = b.submit([3, 1, 4], max_new_tokens=20, seed=7,
                  priority="best_effort")
    while len(rb.tokens) < 3:
        b.step_chunk()
    pool.check_page_conservation()
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
    out = dict(streams=(list(warm.tokens), list(ra.tokens),
                        list(rb.tokens)),
               stats=(a.stats, b.stats),
               pool=(pool.cross_preemptions, pool.cache_reclaims))
    a.close()
    b.close()
    assert pool.alloc.n_free == 10 and not pool.tenants
    return out


@pytest.mark.parametrize("mesh", ["fsdp2-tensor2", "mqa-tensor2"])
def test_placed_pool_reclaim_and_preemption_equal_jax_and_private(models,
                                                                   mesh):
    gen, jgen = _gens(models, mesh)
    got = _reclaim_and_preempt(ContinuousEngine, SamplingParams,
                               _pool(gen, 10), gen)
    want = _reclaim_and_preempt(JEngine, JSP,
                                JPool(jgen.cfg, 10, page_size=8), jgen)
    assert got == want
    preempted, reclaimed = got["pool"]
    assert preempted >= 1 and reclaimed >= 1
    assert got["stats"][1]["preempted_cross_tenant"] >= 1
    warm, ra, rb = got["streams"]
    assert [warm] == _private(gen, [(list(range(20, 37)), 8, {}, 1, False)])
    assert [ra] == _private(gen, [([40] * 44, 16, {}, 5, False)])
    assert [rb] == _private(gen, [([3, 1, 4], 20, {}, 7, False)])


@pytest.mark.parametrize("mesh,kv_quant", [("fsdp2-tensor2", "int8"),
                                           ("olmo2-tensor2", "none"),
                                           ("heads6-tensor4", "none")])
def test_placed_pool_migration_blob_round_trip(models, mesh, kv_quant):
    """A stream frozen mid-decode on a tenant of one placed pool, shipped
    through the TLTS frame in the reference layout (every kv head of a
    page) and adopted by a tenant of another: its tokens equal the
    uninterrupted private run's."""
    gen, _ = _gens(models, mesh)
    sp = SamplingParams.make(temperature=0.9, top_k=5)
    prompt = [5, 6, 7, 8, 9, 10, 11]
    want = _private(gen, [(prompt, 14, dict(temperature=0.9, top_k=5), 9,
                           False)], kv_quant=kv_quant)[0]
    pools = [_pool(gen, POOL_PAGES, kv_quant=kv_quant) for _ in range(2)]
    src, dst = (ContinuousEngine(gen, **ENGINE_KW, kv_quant=kv_quant,
                                 pool=p, model_id=f"m{i}")
                for i, p in enumerate(pools))
    r = src.submit(prompt, max_new_tokens=14, sampling=sp, seed=9)
    while len(r.tokens) < 5:
        src.step_chunk()
    assert not r.finished
    src.freeze_slot(r.slot)
    chain, limit = src.migration_chain(r.slot)
    blob = src.export_slot(r.slot, n_skip=dst.resident_prefix_pages(chain,
                                                                    limit))
    assert np.asarray(blob["k"]).shape[2] == gen.cfg.n_kv_heads
    blob = tser.decode(tser.encode(blob), copy=True)
    assert dst.stage_migration("m", blob)
    moved = src.commit_migration(r.slot)
    r2 = dst.submit(
        moved.prompt + moved.tokens,
        max_new_tokens=moved.budget - len(moved.tokens), sampling=sp,
        eos_ids=sorted(moved.eos), seed=moved.seed,
        start_step=moved.start_step + len(moved.tokens), adopt="m")
    dst.run_until_idle()
    assert moved.tokens + r2.tokens == want
    assert dst.stats["migrations_adopted"] == 1
    for ce, p in zip((src, dst), pools):
        p.check_page_conservation()
        ce.close()
        assert p.alloc.n_free == POOL_PAGES


def test_attach_refuses_a_tenant_placed_elsewhere(models):
    gen, _ = _gens(models, "fsdp2-tensor2")
    whole = GenerationEngine(gen.cfg, _port_tree(gen.cfg, models["dense"][1],
                                                 {"fsdp": 2}),
                             max_seq_len=64, device="cpu")
    split = _pool(gen, 16)
    with pytest.raises(ValueError, match=r"places its pages on \('cpu',\), "
                       r"the shared pool's pages lie on \('cpu', 'cpu'\)"):
        ContinuousEngine(whole, **ENGINE_KW, pool=split, model_id="w")
    one = paged.SharedPagePool(gen.cfg, 16, page_size=8, device="cpu")
    with pytest.raises(ValueError, match=r"places its pages on \('cpu', "
                       r"'cpu'\), the shared pool's pages lie on \('cpu',\)"):
        ContinuousEngine(gen, **ENGINE_KW, pool=one, model_id="s")
    assert not split.tenants and not one.tenants
    # a tree on {tensor: 2} splits its pages over the same two positions
    # as the first group of {fsdp: 2, tensor: 2}: the same pool takes it
    gen2 = GenerationEngine(gen.cfg, _port_tree(gen.cfg, models["dense"][1],
                                                {"tensor": 2}),
                            max_seq_len=64, device="cpu")
    ok = ContinuousEngine(gen2, **ENGINE_KW, pool=split, model_id="t")
    assert ok.cache.k is split.kv[0]
    ok.close()


def test_worker_keys_its_pools_by_page_placement(models):
    """A worker with ``cont_pool_pages`` gives jobs whose slot engines
    place their pages on the same positions one pool ({tensor: 2} and
    the first group of {fsdp: 2, tensor: 2}), and a job of the same page
    geometry whose pages lie whole ({fsdp: 2}) a pool of its own."""
    w = _worker("port", mesh_devices=4, cont_pool_pages=32)
    ml = w.node.config.ml
    _, host, cfg = models["dense"]

    def job(axes):
        gen = GenerationEngine(cfg, _port_tree(cfg, host, axes),
                               max_seq_len=64, device="cpu")
        return types.SimpleNamespace(cfg=cfg, engine=gen, cache_quant=False,
                                     tp_devices=None)

    a = w._shared_kv_pool(job({"tensor": 2}), ml)
    b = w._shared_kv_pool(job({"fsdp": 2, "tensor": 2}), ml)
    c = w._shared_kv_pool(job({"fsdp": 2}), ml)
    assert a is b and a.placement == ("cpu", "cpu")
    assert len(a.kv[0].shards) == 2
    assert c is not a and c.placement == ("cpu",)
    # a pool no tenant attached to is released at the next creation
    assert list(w._kv_pools.values()) == [c]
