"""The port's explicit tensor-parallel serving path
(tensorlink_tpu_torch/parallel/mesh.py, models/transformer.py
``tp_shardable``/``tp_partition_specs``, engine/paged.py
``make_tp_ragged_step`` and the sharded cache, engine/continuous.py
``tensor_parallel=``, engine/loader.py ``load_params(tensor_parallel=)``,
the worker's tp hosting) against the JAX package on the same weights.

The shards lie on the CPU: the port names its devices (``[cpu] * tp``),
as the JAX package's tests lay theirs on 8 virtual host devices. Held
here:

- ``tp_shardable``'s reasons word for word over a grid of configs and
  tp 1–4; the spec tree's structure and split dimension leaf for leaf;
  the mesh's axis order, device order and too-few-devices error.
- Streams of the port at tp 2 and tp 4 equal to the port's tp=1 engine
  and the JAX tp=1 engine over fp, int8 and int4 pages, greedy, sampled
  and speculative streams co-resident (tests/test_tp.py's ``MIXES``).
- Each shard's pages within 2e-6 of the port's tp=1 pages split by kv
  head (bitwise at layer 0), and within the cross-framework bound of the JAX engine's pages split the
  same way (float32 2e-5: the two frameworks' f32 k/v rows differ in
  the last bits, tests/test_torch_engine.py; int8/int4 codes within 1
  and scales within 2e-5 relative, the same cause).
- Page conservation, the snapshot, the prefix cache on and off, the
  host tier and a fleet pull on a tp=2 engine (tests/test_kvtier.py's
  tp=2 case), a weight publish.
- Every refusal, with the JAX engine's words where JAX refuses too.
- ``load_params(tensor_parallel=2)`` shards equal to JAX's
  ``addressable_shards`` of the same checkpoint.
- A bare port worker with ``MLConfig(device="cpu", tensor_parallel=2)``
  serving continuous requests equal to the in-process tp=1 engine; a tp
  job's training (loaded for it or switched to it) bitwise the tp=1
  worker's, and its static, beam and lookahead answers in either order
  equal the tp=1 worker's; a checkpoint restore republished onto the
  mesh, and its mesh taken from its own card on.

On this host a column slice of a float32 product is bitwise the
product's columns at every height the tests run, and the streams of the
port at every tp are equal. The pages of a tp engine are not bitwise its
tp=1 pages: the plain decode attention rounds one kv head a shard
differently in the last place (``test_tp_shard_pages_equal_split_pages``
says where, and holds them within 2e-6).
"""

import dataclasses
import queue
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.engine.continuous import ContinuousEngine as JEngine
from tensorlink_tpu.engine.generate import GenerationEngine as JGen
from tensorlink_tpu.engine.sampling import SamplingParams as JSP
from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu.models.transformer import (
    tp_partition_specs as j_tp_partition_specs,
)
from tensorlink_tpu.models.transformer import tp_shardable as j_tp_shardable
from tensorlink_tpu_torch.convert import (
    config_from_jax,
    params_from_jax,
    tp_shards,
)
from tensorlink_tpu_torch.engine.continuous import ContinuousEngine
from tensorlink_tpu_torch.engine.generate import GenerationEngine
from tensorlink_tpu_torch.engine.paged import SharedPagePool
from tensorlink_tpu_torch.engine.sampling import SamplingParams
from tensorlink_tpu_torch.models.transformer import (
    init_params,
    tp_partition_specs,
    tp_shardable,
)
from tensorlink_tpu_torch.parallel import mesh as tmesh

# one intra-op thread: a JAX call in this process can leave torch's worker
# threads computing exp off by up to 1e-4 (tests/test_torch_flash.py)
torch.set_num_threads(1)

CPU = torch.device("cpu")
# tlint: disable=TL006(read-only test data)
REP = [5, 9, 5, 9, 5, 9, 5, 9]
# tlint: disable=TL006(read-only test data)
PAGE_TOL = dict(rtol=2e-5, atol=2e-5)


def _jcfg(**kw):
    base = dict(
        family="llama", vocab_size=128, d_model=32, n_layers=2, n_heads=2,
        n_kv_heads=2, head_dim=16, d_ff=64, max_seq_len=64,
        dtype=jnp.float32, tie_embeddings=False,
    )
    base.update(kw)
    return JModelConfig(**base)


def _port_cfg(jcfg):
    return config_from_jax(dataclasses.asdict(jcfg))


# (prompt, n, sampling knobs, seed, speculative): tests/test_tp.py's MIXES
# tlint: disable=TL006(read-only test data)
MIXES = [
    ([1, 2, 3], 10, {}, 0, False),
    ([4, 5, 6, 7], 8, dict(temperature=0.8, top_k=5), 3, False),
    (REP, 12, {}, 7, True),
    (REP, 9, dict(temperature=0.9, top_p=0.9), 11, True),
]
# tlint: disable=TL006(read-only test data)
ENGINE_KW = dict(max_slots=4, page_size=8, chunk_steps=4, spec_decode=True,
                 spec_draft=4)


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, port cfg, port params) for tp 2 (2 heads)
    and tp 4 (4 heads), the JAX tree handed over as numpy."""
    out = {}
    for tp, kw, seed in ((2, {}, 0), (4, dict(n_heads=4, n_kv_heads=4), 1)):
        jcfg = _jcfg(**kw)
        jparams = j_init_params(jcfg, jax.random.PRNGKey(seed))
        out[tp] = (jcfg, jparams, _port_cfg(jcfg),
                   jax.device_get(jparams))
    return out


def _port_engine(cfg, host_params, tp=1, **kw):
    """A port ContinuousEngine over a fresh GenerationEngine (a tp engine
    replaces its engine's params with the placed tree)."""
    gen = GenerationEngine(cfg, params_from_jax(host_params, device="cpu"),
                           max_seq_len=64, device="cpu")
    for k, v in ENGINE_KW.items():
        kw.setdefault(k, v)
    if tp > 1:
        kw.update(tensor_parallel=tp, tp_devices=[CPU] * tp)
    return ContinuousEngine(gen, **kw)


def _jax_engine(jcfg, jparams, **kw):
    gen = JGen(jcfg, jparams, seq_buckets=(8, 32), batch_buckets=(1,),
               max_seq_len=64)
    for k, v in ENGINE_KW.items():
        kw.setdefault(k, v)
    return JEngine(gen, **kw)


def _serve(ce, sp_cls):
    reqs = [
        ce.submit(p, max_new_tokens=n, sampling=sp_cls.make(**knobs),
                  seed=seed, speculative=spec)
        for p, n, knobs, seed, spec in MIXES
    ]
    ce.run_until_idle()
    assert all(r.finished and r.error is None for r in reqs)
    return [list(r.tokens) for r in reqs]


@pytest.fixture(scope="module")
def jax_runs(models):
    """``(tp, kv_quant) -> (streams, pages)`` of the JAX tp=1 engine,
    each served once per module."""
    runs: dict = {}

    def get(tp, kv_quant):
        if (tp, kv_quant) not in runs:
            jcfg, jparams, _, _ = models[tp]
            ce = _jax_engine(jcfg, jparams, kv_quant=kv_quant)
            streams = _serve(ce, JSP)
            c = ce.cache
            pages = [np.asarray(c.k), np.asarray(c.v)]
            if c.k_scale is not None:
                pages += [np.asarray(c.k_scale), np.asarray(c.v_scale)]
            runs[(tp, kv_quant)] = (streams, pages)
        return runs[(tp, kv_quant)]

    return get


# -- gates and specs -------------------------------------------------------
# tlint: disable=TL006(read-only test data)
SHARDABLE_GRID = [
    {},
    dict(n_heads=4, n_kv_heads=4),
    dict(n_heads=4, n_kv_heads=1),
    dict(n_heads=6, n_kv_heads=3, d_model=48, d_ff=96),
    dict(vocab_size=127),
    dict(vocab_size=127, tie_embeddings=True),
    dict(d_ff=66),
    dict(n_experts=4, n_experts_per_tok=2),
    dict(qk_norm_full=True, norm_position="post", family="olmo2"),
    dict(family="qwen3", qk_norm=True, tie_embeddings=True, n_heads=4,
         n_kv_heads=2),
]


@pytest.mark.parametrize("kw", SHARDABLE_GRID,
                         ids=[str(i) for i in range(len(SHARDABLE_GRID))])
def test_tp_shardable_matches_jax(kw):
    jcfg = _jcfg(**kw)
    cfg = _port_cfg(jcfg)
    for tp in (1, 2, 3, 4):
        assert tp_shardable(cfg, tp) == j_tp_shardable(jcfg, tp), (kw, tp)


# tlint: disable=TL006(read-only test data)
SPEC_CONFIGS = [
    {},
    dict(family="qwen3", qk_norm=True, tie_embeddings=True, n_heads=4,
         n_kv_heads=2),
    dict(family="gpt2", norm="layernorm", pos="learned", mlp="fused",
         act="gelu_tanh", attn_bias=True, tie_embeddings=True),
    dict(attn_bias=True, mlp_bias=True, attn_out_bias=True),
]


def _jax_dims(spec):
    """A JAX PartitionSpec leaf as the port's: the dim named ``tp``."""
    dims = [i for i, a in enumerate(spec) if a == "tp"]
    return dims[0] if dims else None


@pytest.mark.parametrize("kw", SPEC_CONFIGS,
                         ids=[str(i) for i in range(len(SPEC_CONFIGS))])
def test_tp_partition_specs_match_jax(kw):
    """Every port spec leaf sits at the JAX spec's path with its split
    dimension, and the spec tree has the parameter tree's structure."""
    jcfg = _jcfg(**kw)
    cfg = _port_cfg(jcfg)
    jspecs = j_tp_partition_specs(jcfg)
    specs = tp_partition_specs(cfg)

    def walk(a, b, path):
        if isinstance(b, dict):
            assert isinstance(a, dict) and set(a) == set(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
            return
        assert isinstance(a, tmesh.Split), path
        assert a.dim == _jax_dims(b), path

    walk(specs, jspecs, "")
    params = init_params(cfg, device="cpu")
    split = tmesh.put(tmesh.serving_mesh(2, devices=[CPU, CPU]), params,
                      specs)
    assert tmesh.is_sharded(split)
    with pytest.raises(ValueError):
        tp_partition_specs(_port_cfg(_jcfg(n_experts=4)))


# -- meshes ----------------------------------------------------------------
def test_meshes_keep_axis_and_device_order():
    devs = [torch.device("cpu", i) for i in range(8)]
    m = tmesh.build_mesh({"tp": 2, "data": 2, "stage": 2}, devs)
    jm = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                           ("stage", "data", "tp"))
    assert m.axis_names == jm.axis_names == ("stage", "data", "tp")
    # from jax's own builder: the same names and flattened device order
    from tensorlink_tpu.parallel.mesh import build_mesh as j_build_mesh
    from tensorlink_tpu.parallel.mesh import serving_mesh as j_serving_mesh

    jb = j_build_mesh({"tp": 2, "data": 2, "stage": 2}, jax.devices())
    assert jb.axis_names == m.axis_names
    assert [d.id for d in jb.devices.reshape(-1)] == \
        [d.index for d in m.flat()]
    sm = tmesh.serving_mesh(2, dp=2, devices=devs)
    jsm = j_serving_mesh(2, dp=2)
    assert sm.axis_names == jsm.axis_names == ("data", "tp")
    assert sm.shape == dict(jsm.shape)
    # flattened index data_idx * tp + tp_idx, as the JAX mesh
    assert [d.index for d in sm.flat()] == \
        [d.id for d in jsm.devices.reshape(-1)]
    assert sm.axis_index("tp") == [0, 1, 0, 1]
    assert sm.axis_index("data") == [0, 0, 1, 1]
    with pytest.raises(ValueError, match="mesh needs 16 devices, have 8"):
        tmesh.build_mesh({"data": 2, "tp": 8}, devs)
    with pytest.raises(ValueError, match="mesh needs 16 devices"):
        j_build_mesh({"data": 2, "tp": 8}, jax.devices())
    # the default devices are the local cards: none on a host without one
    if not torch.cuda.is_available():
        assert tmesh.local_devices() == []
        with pytest.raises(ValueError, match="mesh needs 2 devices, have 0"):
            tmesh.serving_mesh(2)
    # a device repeats only in a list the caller gives
    rep = tmesh.serving_mesh(2, devices=[CPU, CPU])
    assert rep.flat() == [CPU, CPU]
    assert tmesh.MeshPlan({"data": 2, "tp": 2}).n_devices == 4


def test_put_places_pieces_and_shares_replicas():
    mesh = tmesh.serving_mesh(2, devices=[CPU, CPU])
    x = torch.arange(24.0).reshape(2, 3, 4)
    placed = tmesh.put(mesh, {"a": x, "b": x},
                       {"a": tmesh.Split(2), "b": tmesh.REPLICATED})
    a, b = placed["a"], placed["b"]
    assert a.shape == x.shape and [s.shape for s in a.shards] == [(2, 3, 2)] * 2
    assert all(s.is_contiguous() for s in a.shards)
    assert torch.equal(a.full(), x) and torch.equal(b.full(), x)
    assert b.shards[0] is b.shards[1] is x  # on its device already: shared
    z = tmesh.zeros(mesh, (4, 6), torch.int8, tmesh.Split(1))
    assert [s.shape for s in z.shards] == [(4, 3)] * 2
    with pytest.raises(ValueError, match="does not split"):
        tmesh.put(mesh, torch.zeros(3), tmesh.Split(0))


# -- streams and pages -----------------------------------------------------
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_tp_streams_equal_jax_and_tp1(models, jax_runs, tp, kv_quant):
    _, _, cfg, host = models[tp]
    want, _ = jax_runs(tp, kv_quant)
    one = _serve(_port_engine(cfg, host, kv_quant=kv_quant), SamplingParams)
    ce = _port_engine(cfg, host, tp, kv_quant=kv_quant)
    got = _serve(ce, SamplingParams)
    assert one == want
    assert got == want
    assert ce.tensor_parallel == tp and ce.chunks > 0


def _split_heads(a, tp):
    """A whole page array split by kv head (axis 2 of the layer-stacked
    pages and scales)."""
    return np.split(np.asarray(a), tp, axis=2)


def _held_pages(got, want, kv_quant):
    """One shard's pages against the same kv heads of a whole cache:
    float32 within PAGE_TOL, int8/int4 codes within 1 (scales are float32
    pages too). Returns the largest float difference."""
    from tensorlink_tpu.models.quant import unpack_int4

    if got.dtype != np.int8:
        np.testing.assert_allclose(got, want, **PAGE_TOL)
        return float(np.abs(got - want).max())
    if kv_quant == "int4":
        got = np.asarray(unpack_int4(jnp.asarray(got)))
        want = np.asarray(unpack_int4(jnp.asarray(want)))
    assert np.abs(got.astype(np.int32) - want).max() <= 1
    return 0.0


@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_tp_shard_pages_equal_split_pages(models, jax_runs, kv_quant):
    """Each shard's pages are the tp=1 engine's pages split by kv head,
    within PAGE_TOL of the port's tp=1 engine and of the JAX engine's
    (page 0 is scratch: padding rows race to write it, unread).

    Not bitwise against the port's tp=1 pages: with one kv head a shard,
    the plain decode attention's einsum (``ops/attention.py::_ragged_ref``
    at one query row) runs a ``[S, 1, hd] x [S, hd, K]`` batched product
    where the whole cache runs ``[2S, 1, hd] x [2S, hd, K]``, and the CPU
    kernel rounds the two differently in the last place (measured at most
    1.1e-6 here; the ragged pass and every sliced GEMM are bitwise). The
    next layer's KV carries that; the streams are equal all the same."""
    tp = 2
    _, _, cfg, host = models[tp]
    _, jpages = jax_runs(tp, kv_quant)
    one = _port_engine(cfg, host, kv_quant=kv_quant)
    _serve(one, SamplingParams)
    ce = _port_engine(cfg, host, tp, kv_quant=kv_quant)
    _serve(ce, SamplingParams)
    for f, t1, jp in zip(ce.cache.fields(), one.cache.fields(), jpages):
        assert len(f.shards) == tp
        for shard, want, jwant in zip(f.shards,
                                      _split_heads(t1.numpy(), tp),
                                      _split_heads(jp, tp)):
            assert shard.is_contiguous()
            assert shard.shape[2] == cfg.n_kv_heads // tp
            got = shard.numpy()[:, 1:]
            assert _held_pages(got, want[:, 1:], kv_quant) <= 2e-6
            _held_pages(got, jwant[:, 1:], kv_quant)
    # layer 0's KV is written before any attention runs: bitwise there
    for f, t1 in zip(ce.cache.fields(), one.cache.fields()):
        assert np.array_equal(f.full().numpy()[0, 1:], t1.numpy()[0, 1:])


def test_tp_conservation_snapshot_and_layout(models):
    tp = 2
    _, _, cfg, host = models[tp]
    one = _port_engine(cfg, host)
    ce = _port_engine(cfg, host, tp)
    _serve(one, SamplingParams)
    _serve(ce, SamplingParams)
    ce.check_page_conservation()
    snap, snap1 = ce.serving_snapshot(), one.serving_snapshot()
    assert snap["tensor_parallel"] == 2 and snap1["tensor_parallel"] == 1
    # one logical page's bytes, as at tp=1
    assert snap["kv_page_bytes"] == snap1["kv_page_bytes"]
    for key in ("kv_pages_total", "kv_pages_free", "kv_pages_slots"):
        assert snap[key] == snap1[key], key
    # control state whole, never sharded
    assert isinstance(ce.cache.block_tables, torch.Tensor)
    assert torch.equal(ce.cache.block_tables, one.cache.block_tables)
    assert torch.equal(ce.cache.lengths, one.cache.lengths)
    assert isinstance(ce.engine.params["layers"]["attn"]["wq"],
                      tmesh.Sharded)
    assert ce.cache.tp == 2
    ce.close()


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_tp_prefix_cache_on_and_off(models, prefix_cache):
    """Requests sharing a two-page prefix, one admitted after the first
    finished (a trie hit and a copy-on-write when the cache is on): the
    tp=2 streams equal tp=1's with the cache on."""
    tp = 2
    _, _, cfg, host = models[tp]
    shared = [17, 3, 99, 42, 8, 25, 61, 5, 77, 12, 19, 33, 4, 120, 7, 88]
    prompts = [shared + [1, 2], shared + [9], shared[:11] + [3, 3]]

    def run(ce):
        out = []
        for p in prompts:
            r = ce.submit(p, max_new_tokens=6)
            ce.run_until_idle()
            out.append(list(r.tokens))
        return out

    want = run(_port_engine(cfg, host, spec_decode=False))
    ce = _port_engine(cfg, host, tp, spec_decode=False,
                      prefix_cache=prefix_cache)
    assert run(ce) == want
    if prefix_cache:
        assert ce.stats["prefill_tokens_skipped"] > 0
    ce.check_page_conservation()


def test_tp2_host_tier_and_fleet_pull(models):
    """tests/test_kvtier.py's tp=2 case: a prefix demoted to the host tier
    and promoted back, and a cold tp=2 sibling's fleet pull, each stream
    equal to a cold tp=2 serve (itself equal to tp=1)."""
    tp = 2
    _, _, cfg, host = models[tp]
    prompt = list(range(1, 25))

    def one(ce):
        r = ce.submit(prompt, max_new_tokens=8)
        ce.run_until_idle()
        assert r.finished and r.error is None
        return r

    kw = dict(spec_decode=False)
    cold = one(_port_engine(cfg, host, **kw)).tokens
    assert one(_port_engine(cfg, host, tp, **kw)).tokens == cold
    ce = _port_engine(cfg, host, tp, host_tier_pages=8, **kw)
    one(ce)
    while ce.prefix.n_evictable():
        ce.alloc.free(ce.prefix.evict(ce.prefix.n_evictable()))
    assert ce.host_tier.n_resident >= 2
    r = one(ce)
    assert r.cache_tier == "host" and r.tokens == cold
    sib = _port_engine(cfg, host, tp, **kw)
    sib.fetch_prefix = lambda ch, lim, nl: ce.export_prefix_pages(
        ch, lim, n_skip=nl)
    rp = one(sib)
    assert rp.cache_tier == "fleet" and rp.tokens == cold
    assert sib.stats["fleet_pulls"] == 1
    ce.check_page_conservation()
    sib.check_page_conservation()
    ce.close()
    sib.close()


def test_tp_migration_export_has_the_tp1_layout(models):
    """A frozen tp=2 slot's export has the unsharded page layout: shapes
    and dtypes of a tp=1 engine's export of the same stream, its pages
    the tp=2 cache's shards joined by kv head, byte for byte, and within
    PAGE_TOL of the tp=1 export (the last-place difference of
    ``test_tp_shard_pages_equal_split_pages``)."""
    tp = 2
    _, _, cfg, host = models[tp]
    prompt = list(range(3, 30))
    blobs, engines = [], []
    for n in (1, tp):
        ce = _port_engine(cfg, host, n, spec_decode=False)
        r = ce.submit(prompt, max_new_tokens=20)
        for _ in range(3):
            ce.step_chunk()
        slot = next(s for s, q in enumerate(ce._slots) if q is r)
        ce.freeze_slot(slot)
        blobs.append(ce.export_slot(slot))
        engines.append((ce, r))
    ce, r = engines[1]
    row = [n.page for n in r.shared_nodes] + list(r.pages)
    pages = torch.as_tensor(row).long()
    for key, field in (("k", ce.cache.k), ("v", ce.cache.v)):
        a, b = np.asarray(blobs[0][key]), np.asarray(blobs[1][key])
        assert a.shape == b.shape and a.dtype == b.dtype
        joined = field.full()[:, pages].permute(1, 0, 2, 3, 4).numpy()
        assert b.tobytes() == joined[: b.shape[0]].tobytes()
        np.testing.assert_allclose(b, a, **PAGE_TOL)
    assert blobs[0]["dtype"] == blobs[1]["dtype"]


def test_tp_publish_weights(models):
    """A publish on a tp=2 engine re-places the tree on its mesh: the
    next stream equals a fresh tp=1 engine's over the new weights."""
    tp = 2
    _, _, cfg, host = models[tp]
    new = jax.tree.map(lambda a: np.asarray(a) * np.float32(0.5), host)
    ce = _port_engine(cfg, host, tp, spec_decode=False)
    ce.publish_weights(params_from_jax(new, device="cpu"))
    assert isinstance(ce.engine.params["embed"]["tok"], tmesh.Sharded)
    r = ce.submit([1, 2, 3], max_new_tokens=8)
    ce.run_until_idle()
    want = _port_engine(cfg, new, spec_decode=False)
    w = want.submit([1, 2, 3], max_new_tokens=8)
    want.run_until_idle()
    assert r.tokens == w.tokens
    with pytest.raises(ValueError, match="do not match"):
        ce.publish_weights(init_params(cfg.with_(d_ff=128), device="cpu"))


# -- refusals --------------------------------------------------------------
def _refusal(make):
    with pytest.raises((ValueError, NotImplementedError)) as e:
        make()
    return e.type, str(e.value)


@pytest.mark.parametrize("case", ["tp3", "moe", "pool", "quant"])
def test_tp_refusals_match_jax(models, case):
    jcfg, jparams, cfg, host = models[2]
    if case == "moe":
        jcfg = _jcfg(n_experts=4, n_experts_per_tok=2)
        cfg = _port_cfg(jcfg)
        jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
        host = jax.device_get(jparams)
    tp = 3 if case == "tp3" else 2

    def port():
        gen = GenerationEngine(cfg, params_from_jax(host, device="cpu"),
                               max_seq_len=64, device="cpu",
                               quant="int8" if case == "quant" else None)
        pool = (SharedPagePool(cfg, 8, page_size=8, device="cpu")
                if case == "pool" else None)
        return ContinuousEngine(gen, max_slots=4, page_size=8,
                                tensor_parallel=tp, tp_devices=[CPU] * tp,
                                pool=pool)

    def jax_side():
        from tensorlink_tpu.engine.paged import SharedPagePool as JPool

        gen = JGen(jcfg, jparams, seq_buckets=(8, 32), batch_buckets=(1,),
                   max_seq_len=64,
                   quant="int8" if case == "quant" else None)
        pool = (JPool(jcfg, 8, page_size=8) if case == "pool" else None)
        return JEngine(gen, max_slots=4, page_size=8, tensor_parallel=tp,
                       pool=pool)

    got, want = _refusal(port), _refusal(jax_side)
    assert got == want


def test_tp_refusals_of_the_port(models):
    _, _, cfg, host = models[2]

    def make(c=cfg, **kw):
        gen = GenerationEngine(c, params_from_jax(host, device="cpu"),
                               max_seq_len=64, device="cpu")
        return ContinuousEngine(gen, max_slots=4, page_size=8, **kw)

    # no devices named: the local cards, never the CPU or fewer shards
    if not torch.cuda.is_available():
        with pytest.raises(ValueError,
                           match="tensor_parallel=2 needs as many devices, "
                                 "have 0"):
            make(tensor_parallel=2)
    with pytest.raises(ValueError, match="needs as many devices, have 1"):
        make(tensor_parallel=2, tp_devices=[CPU])
    # the quantized gather (ROADMAP queue 1 item 5) is ported
    # (tests/test_torch_product_parallel.py holds its streams against
    # JAX's): a collective_quant engine builds over the same shards, its
    # step's gathers int8
    cq = make(cfg.with_(collective_quant=True), tensor_parallel=2,
              tp_devices=[CPU, CPU])
    assert cq.tensor_parallel == 2 and cq.cfg.collective_quant
    # the dense forward over the placed tree is ported (the GSPMD path,
    # tests/test_torch_mesh.py): the tp engine's own generation engine
    # runs it, with the whole tree's tokens
    ce = make(tensor_parallel=2, tp_devices=[CPU, CPU])
    whole = GenerationEngine(cfg, params_from_jax(host, device="cpu"),
                             max_seq_len=64, device="cpu")
    assert ce.engine.generate([[1, 2, 3]], max_new_tokens=4).sequences == \
        whole.generate([[1, 2, 3]], max_new_tokens=4).sequences


# -- loading onto shards ---------------------------------------------------
def test_load_params_tp_shards_equal_jax(models, jax_runs, tmp_path):
    from tensorlink_tpu.engine.loader import load_params as j_load_params
    from tensorlink_tpu_torch.engine.loader import export_hf, load_params

    jcfg, _, cfg, host = models[2]
    tree = params_from_jax(host, device="cpu")
    export_hf(cfg, tree, tmp_path)
    _, jtree = j_load_params(tmp_path, jcfg, tensor_parallel=2)
    _, ttree = load_params(tmp_path, cfg, tensor_parallel=2,
                           tp_devices=[CPU, CPU])
    pieces = tp_shards(tree, cfg, 2)

    def walk(j, t, path, want):
        if isinstance(t, dict):
            for k in t:
                walk(j[k], t[k], f"{path}/{k}", [w[k] for w in want])
            return
        assert isinstance(t, tmesh.Sharded), path
        shards = sorted(j.addressable_shards, key=lambda s: s.device.id)
        assert len(shards) == len(t.shards) == 2, path
        for js, ts, w in zip(shards, t.shards, want):
            assert np.array_equal(np.asarray(js.data), ts.numpy()), path
            assert torch.equal(ts, w), path

    walk(jtree, ttree, "", pieces)
    # the loaded tree serves without another copy, equal to tp=1
    gen = GenerationEngine(cfg, ttree, max_seq_len=64, device="cpu")
    ce = ContinuousEngine(gen, **ENGINE_KW, tensor_parallel=2,
                          tp_devices=[CPU, CPU])
    placed = ce.engine.params["layers"]["attn"]["wq"]
    assert placed is ttree["layers"]["attn"]["wq"]  # the loaded shards
    assert _serve(ce, SamplingParams) == jax_runs(2, "none")[0]
    # JAX's refusals, in its words
    with pytest.raises(ValueError, match="not both") as e:
        load_params(tmp_path, cfg, tensor_parallel=2, mesh=object())
    with pytest.raises(ValueError) as je:
        j_load_params(tmp_path, jcfg, tensor_parallel=2, mesh=object())
    assert str(e.value) == str(je.value)
    with pytest.raises(ValueError) as e:
        load_params(tmp_path, cfg, tensor_parallel=3, tp_devices=[CPU] * 3)
    with pytest.raises(ValueError) as je:
        j_load_params(tmp_path, jcfg, tensor_parallel=3)
    assert str(e.value) == str(je.value)


# -- a worker hosting tp serving -------------------------------------------
class _Bridge:
    def __init__(self):
        self.q = types.SimpleNamespace(work=queue.Queue())
        self.sent = []

    def request(self, verb, payload=None, timeout=None):
        self.sent.append((verb, payload))

    notify = request


# tlint: disable=TL006(read-only test data)
TP_STAGE = dict(worker_id="w0", first=True, last=True, holds_head=True,
                mesh_axes={}, coworkers=[])


def _tp_worker(**ml_kw):
    """A bare port worker on the CPU with ``MLConfig(**ml_kw)``."""
    from tensorlink_tpu_torch.core import config as C
    from tensorlink_tpu_torch.ml.worker import DistributedWorker

    ml = C.MLConfig(device="cpu", max_seq_len=64, **ml_kw)
    return DistributedWorker(types.SimpleNamespace(
        bridge=_Bridge(), node_id="w0", config=C.WorkerConfig(ml=ml),
        crash=lambda: None))


def _load(w, cfg, job, seed=3, training=False):
    w._handle("load_stage", {
        "rid": "m", "peer": "p", "job_id": job, "training": training,
        "stage": dict(TP_STAGE, layer_lo=0, layer_hi=cfg.n_layers),
        "model": {"name": "tiny", "config": cfg.to_json(), "seed": seed}})


def _worker_streams(w, job, prompts, tag):
    """Serve ``prompts`` as continuous requests on ``w`` and return the
    replies' bodies in order."""
    for i, p in enumerate(prompts):
        w._handle("gen", {"rid": f"{tag}{i}", "peer": "p", "job_id": job,
                          "prompts": [p], "max_new_tokens": 12,
                          "continuous": True, "seed": 0})

    def replies():
        return {p["rid"]: p["body"] for v, p in w.bridge.sent
                if v == "respond" and p["rid"].startswith(tag)}

    for _ in range(100):
        if len(replies()) == len(prompts):
            break
        w._handle("cont_continue", {"job_id": job})
    got = replies()
    assert len(got) == len(prompts), got
    return [got[f"{tag}{i}"] for i in range(len(prompts))]


def _tp1_streams(cfg, ml, prompts, seed=3):
    """The in-process tp=1 engine's streams on the worker's seeded tree
    with the worker's knobs."""
    g = torch.Generator(CPU)
    g.manual_seed(seed)
    gen = GenerationEngine(cfg, init_params(cfg, g, CPU), max_seq_len=64,
                           device="cpu")
    ref = ContinuousEngine(
        gen, max_slots=ml.cont_max_slots, page_size=ml.cont_page_size,
        chunk_steps=ml.cont_chunk_steps, prefill_chunk=ml.prefill_chunk,
        prefix_cache=ml.prefix_cache, kv_quant=ml.kv_quant,
        spec_decode=ml.spec_decode, spec_draft=ml.spec_draft,
    )
    reqs = [ref.submit(p, max_new_tokens=12, seed=0) for p in prompts]
    ref.run_until_idle()
    return [list(r.tokens) for r in reqs]


# tlint: disable=TL006(read-only test data)
WORKER_PROMPTS = [[7, 3, 100, 5], [9, 1, 2, 30, 7], REP]


def test_worker_hosts_tp2_continuous_serving(models):
    """A bare port worker with ``MLConfig(device="cpu",
    tensor_parallel=2)`` loads a seeded model and serves continuous
    requests through a tp=2 engine, equal to the in-process tp=1 engine
    with the worker's knobs. The job's tree is the placed one: no whole
    copy stays beside the shards."""
    from tensorlink_tpu_torch.parallel.mesh import is_sharded

    _, _, cfg, _ = models[2]
    w = _tp_worker(tensor_parallel=2)
    assert w.capacity()["tensor_parallel"] == 2
    job = "ab12cd34"
    _load(w, cfg, job)
    rt = w.jobs[job]
    assert rt.cont.tensor_parallel == 2
    assert is_sharded(rt.params) and rt.params is rt.engine.params
    got = _worker_streams(w, job, WORKER_PROMPTS, "g")
    assert got[0]["serving"]["tensor_parallel"] == 2
    want = _tp1_streams(cfg, w.node.config.ml, WORKER_PROMPTS)
    for i, r in enumerate(want):
        assert list(got[i]["sequences"][0]) == r, i


def _reply(w, kind, rid, **body):
    """One work item on a bare worker; its reply body."""
    w._handle(kind, {"rid": rid, "peer": "p", **body})
    [got] = [p["body"] for v, p in w.bridge.sent
             if v == "respond" and p["rid"] == rid]
    return got


def _train_steps(w, job, n=2):
    """``n`` driver steps on a bare worker (train forward, the
    cross-entropy gradient, backward, AdamW step): the losses, grad norms
    and the params after."""
    from tensorlink_tpu_torch.ml.module import _ce_sum_and_grad

    _reply(w, "opt", "i", job_id=job, op="init",
           spec={"name": "adamw", "lr": 1e-3})
    out = []
    rng = np.random.default_rng(11)
    for i in range(n):
        toks = rng.integers(0, 128, (2, 8)).astype(np.int32)
        fwd = _reply(w, "fwd", f"f{i}", job_id=job, op="stage", train=True,
                     tag=f"s{i}", tokens=toks)
        nll, dlog, cnt = _ce_sum_and_grad(
            torch.as_tensor(np.array(fwd["out"])), toks,
            np.ones(toks.shape, bool))
        _reply(w, "bwd", f"b{i}", job_id=job, op="stage", tag=f"s{i}",
               grad=dlog.numpy())
        step = _reply(w, "opt", f"o{i}", job_id=job, op="step",
                      scale=1.0 / float(cnt))
        out.append((float(nll) / float(cnt), step["grad_norm"]))
    from tensorlink_tpu_torch.engine.optimizers import tree_leaves

    params = _reply(w, "params.req", "q", job_id=job)["params"]
    return out, [np.asarray(a) for a in tree_leaves(params)]


@pytest.mark.parametrize("when", ["load", "train_mode"])
def test_worker_tp_job_trains_like_tp1(models, when):
    """A tensor_parallel=2 job trains — loaded for training, or a serving
    job switched to it — on its placed tree: two AdamW steps within rtol
    1e-5 of the tp=1 worker's losses and grad norms, each param leaf
    within 2e-4 in its norm (the column splits' input gradients sum each
    shard's partial product); the update is published onto the tp
    engine's mesh, piece by piece (the job serves the trained weights,
    equal to the tp=1 engine on them)."""
    from tensorlink_tpu_torch.parallel.mesh import is_sharded

    _, _, cfg, _ = models[2]
    got = {}
    for tp in (2, 1):
        w = _tp_worker(tensor_parallel=tp)
        job = "ab12cd35"
        _load(w, cfg, job, training=when == "load")
        if when == "train_mode":
            _reply(w, "train.mode", "t", job_id=job, training=True)
        rt = w.jobs[job]
        assert rt.training
        version = rt.cont.weights_version if tp == 2 else None
        got[tp] = _train_steps(w, job)
        if tp == 2:
            assert is_sharded(rt.params) and rt.params is rt.engine.params
            assert rt.cont.weights_version == version + 2
            served = _worker_streams(w, job, WORKER_PROMPTS[:2], "c")
    (l2, p2), (l1, p1) = got[2], got[1]
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    for a, b in zip(p2, p1, strict=True):
        assert np.linalg.norm(a - b) <= 2e-4 * np.linalg.norm(b)
    from tensorlink_tpu_torch.engine.optimizers import tree_unflatten

    tree = tree_unflatten(init_params(cfg, device=CPU),
                          [torch.as_tensor(a) for a in p2])
    gen = GenerationEngine(cfg, tree, max_seq_len=64, device="cpu")
    ml = _tp_worker().node.config.ml
    ref = ContinuousEngine(
        gen, max_slots=ml.cont_max_slots, page_size=ml.cont_page_size,
        chunk_steps=ml.cont_chunk_steps, prefill_chunk=ml.prefill_chunk,
        prefix_cache=ml.prefix_cache, kv_quant=ml.kv_quant)
    reqs = [ref.submit(p, max_new_tokens=12, seed=0)
            for p in WORKER_PROMPTS[:2]]
    ref.run_until_idle()
    assert [b["sequences"][0] for b in served] == [list(r.tokens)
                                                   for r in reqs]


# tlint: disable=TL006(read-only test data)
STATIC_REQUESTS = ({}, {"num_beams": 2}, {"lookahead": True},
                   {"continuous": True, "num_beams": 2})


@pytest.mark.parametrize("order", ["before", "after"])
def test_worker_tp_job_answers_static_requests(models, order):
    """A tp job's static batch, beam and lookahead requests (and a beam
    flagged continuous) run the dense engine over its placed tree, before
    or after a continuous request: each answer equals the tp=1 worker's
    (the serving specs split every product by column, so the placed
    forward is bitwise the whole tree's)."""
    _, _, cfg, _ = models[2]
    answers = {}
    for tp in (2, 1):
        w = _tp_worker(tensor_parallel=tp)
        job = "ab12cd36"
        _load(w, cfg, job)
        if order == "after":
            _worker_streams(w, job, WORKER_PROMPTS[:1], "c")
        answers[tp] = [
            _reply(w, "gen", f"s{i}", job_id=job,
                   prompts=[[1, 2, 3], [5, 9, 5, 9]][:1 if extra else 2],
                   max_new_tokens=6, seed=0, **extra)["sequences"]
            for i, extra in enumerate(STATIC_REQUESTS)]
        if tp == 2:
            assert w.jobs[job].cont.tensor_parallel == 2
    assert answers[2] == answers[1]


def test_worker_tp_checkpoint_restore_republishes(models, tmp_path):
    """A checkpoint restored into a tp job is published through its
    sharded engine, which re-places it on the mesh: the job serves the
    restored weights (another seed's), equal to the tp=1 engine on
    them, after it served its own."""
    from tensorlink_tpu_torch.parallel.mesh import is_sharded

    _, _, cfg, _ = models[2]
    src = _tp_worker(tensor_parallel=2)
    _load(src, cfg, "aa000001", seed=5)
    src._handle("ckpt", {"rid": "k", "peer": "p", "job_id": "aa000001",
                               "op": "save", "dir": str(tmp_path)})
    w = _tp_worker(tensor_parallel=2)
    job = "aa000002"
    _load(w, cfg, job, seed=3)
    ml = w.node.config.ml
    got = _worker_streams(w, job, WORKER_PROMPTS, "a")
    assert [g["sequences"][0] for g in got] == _tp1_streams(
        cfg, ml, WORKER_PROMPTS, seed=3)
    rt = w.jobs[job]
    version = rt.cont.weights_version
    w._handle("ckpt", {"rid": "k", "peer": "p", "job_id": job,
                       "op": "restore", "dir": str(tmp_path)})
    assert rt.cont.weights_version == version + 1
    assert is_sharded(rt.engine.params) and rt.params is rt.engine.params
    got = _worker_streams(w, job, WORKER_PROMPTS, "b")
    assert [g["sequences"][0] for g in got] == _tp1_streams(
        cfg, ml, WORKER_PROMPTS, seed=5)


def test_worker_tp_mesh_starts_at_its_card(models, monkeypatch):
    """A card worker's tp mesh is ``tp`` distinct cards from its own card
    on; fewer fail the load with the mesh's ValueError before any weight
    is made (it never serves on fewer shards)."""
    from tensorlink_tpu_torch.parallel import mesh

    cards = [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(mesh, "local_devices", lambda: list(cards))
    _, _, cfg, _ = models[2]
    w = _tp_worker(tensor_parallel=4)
    w.device = torch.device("cuda", 1)
    assert w._mesh_devices(2) == cards[1:3]
    assert w._mesh_devices(3) == cards[1:]
    with pytest.raises(ValueError, match="mesh needs 4 devices, have 3"):
        _load(w, cfg, "ab12cd37")
    assert "ab12cd37" not in w.jobs
