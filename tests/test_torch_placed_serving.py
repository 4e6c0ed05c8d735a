"""The port's slot engine over a tree a worker placed on its planned mesh
(engine/paged.py ``make_placed_ragged_step``/``_PlacedFwd``/
``placed_cache_mesh``, engine/continuous.py's placed path) against the
JAX package's ``ContinuousEngine`` over the same tree ``put`` by
``stage_param_specs`` on the conftest's virtual host devices (GSPMD).

The port's positions lie on the CPU (``[cpu] * n``); the model is the
tiny float32 llama of tests/test_torch_tp.py and a tiny Mixtral of the
same widths (4 experts, 2 a token). Held here, for ``{tensor: 2}``,
``{fsdp: 2, tensor: 2}``, ``{data: 2, tensor: 2}``, ``{expert: 2}`` and
``{expert: 2, tensor: 2}``, and for heads the tensor axis does not split
as the tp engine does: a tiny OLMo-2 (qk_norm_full, post norm) on
``{tensor: 2}`` and ``{fsdp: 2, tensor: 2}``, ``n_heads 4, n_kv_heads 1``
on ``{tensor: 2}`` and ``n_heads 6, n_kv_heads 2`` on ``{tensor: 4}``
(the pages whole):

- greedy, sampled and speculative streams co-resident token-equal to
  JAX's (tests/test_tp.py's mixes), over fp pages on every mesh and int8
  and int4 pages on two;
- the pages, each shard's kv heads joined to the reference layout ``[L,
  P, n_kv, page, hd]``, within float32 2e-5 of JAX's (the two
  frameworks' f32 rows differ in the last bits, tests/test_torch_tp.py);
  int8 and int4 codes within one level, scales within 2e-5 relative;
- teacher-forced logits of the placed forward (a ragged prefill of a
  whole sequence, then one decode step over the pages) within 2e-5 of
  JAX's GSPMD ``forward`` over the put tree;
- the port's own contracts, bitwise on the placed engine: solo ==
  co-batched, prefix cache on == off, spec == plain, a migration blob
  round trip between two placed engines equal to the uninterrupted
  stream, a weight publish re-placed on the same mesh;
- a shared page pool and the unsplit heads now build, and the one
  refusal left (a process-spanning mesh) names its ROADMAP queue 1 item;
- a bare worker's planned-mesh job served continuous as the JAX
  worker's, also as a tenant of a pool (``cont_pool_pages``) and for
  OLMo-2.

tests/test_torch_placed_pool.py holds the placed tenants of a
``SharedPagePool``.
"""

import dataclasses
import queue
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from tensorlink_tpu.engine.continuous import ContinuousEngine as JEngine
from tensorlink_tpu.engine.generate import GenerationEngine as JGen
from tensorlink_tpu.engine.sampling import SamplingParams as JSP
from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu.models.transformer import forward as j_forward
from tensorlink_tpu.parallel import planner as jplanner
from tensorlink_tpu.parallel.mesh import build_mesh as j_build_mesh
from tensorlink_tpu_torch.convert import config_from_jax, params_from_jax
from tensorlink_tpu_torch.core import serialization as tser
from tensorlink_tpu_torch.engine import paged
from tensorlink_tpu_torch.engine.continuous import ContinuousEngine
from tensorlink_tpu_torch.engine.generate import GenerationEngine
from tensorlink_tpu_torch.engine.sampling import SamplingParams
from tensorlink_tpu_torch.parallel import mesh as tmesh
from tensorlink_tpu_torch.parallel import planner as tplanner

# one intra-op thread: a JAX call in this process can leave torch's worker
# threads computing exp off by up to 1e-4 (tests/test_torch_flash.py)
torch.set_num_threads(1)

CPU = torch.device("cpu")
LOGIT_TOL = 2e-5
# tlint: disable=TL006(read-only test data)
PAGE_TOL = dict(rtol=2e-5, atol=2e-5)
# tlint: disable=TL006(read-only test data)
REP = [5, 9, 5, 9, 5, 9, 5, 9]
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
# tlint: disable=TL006(read-only test data)
MESHES = {
    "tensor2": ("dense", {"tensor": 2}),
    "fsdp2-tensor2": ("dense", {"fsdp": 2, "tensor": 2}),
    "data2-tensor2": ("dense", {"data": 2, "tensor": 2}),
    "expert2": ("moe", {"expert": 2}),
    "expert2-tensor2": ("moe", {"expert": 2, "tensor": 2}),
    # heads the tensor axis does not split as the tp engine does: OLMo-2's
    # norm over the whole projection (the pages still split by kv head),
    # and head counts the axis does not divide (the pages whole)
    "olmo2-tensor2": ("olmo2", {"tensor": 2}),
    "olmo2-fsdp2-tensor2": ("olmo2", {"fsdp": 2, "tensor": 2}),
    "mqa-tensor2": ("mqa", {"tensor": 2}),
    "heads6-tensor4": ("heads6", {"tensor": 4}),
}
# fp pages on every mesh, the quantized formats on one dense and one MoE,
# int8 on OLMo-2 and on whole pages
# tlint: disable=TL006(read-only test data)
CASES = [(m, "none") for m in MESHES] + [
    (m, q) for m in ("fsdp2-tensor2", "expert2-tensor2")
    for q in ("int8", "int4")] + [
    ("olmo2-tensor2", "int8"), ("heads6-tensor4", "int8")]
# tlint: disable=TL006(read-only test data)
KINDS = {
    "dense": {},
    "moe": dict(family="mixtral", n_experts=4, n_experts_per_tok=2),
    "olmo2": dict(family="olmo2", qk_norm_full=True, norm_position="post"),
    "mqa": dict(n_heads=4, n_kv_heads=1),
    "heads6": dict(n_heads=6, n_kv_heads=2, d_model=96),
}


def _jcfg(kind: str, **kw) -> JModelConfig:
    base = dict(
        family="llama", vocab_size=128, d_model=32, n_layers=2, n_heads=2,
        n_kv_heads=2, head_dim=16, d_ff=64, max_seq_len=64,
        dtype=jnp.float32, tie_embeddings=False,
    )
    base.update(KINDS[kind])
    base.update(kw)
    return JModelConfig(**base)


def _page_tp(cfg, axes: dict) -> int:
    """How many ways the placed slot engine splits its pages: the tensor
    axis where it divides both head counts, else 1 (whole)."""
    tp = axes.get("tensor", 1)
    return tp if not cfg.n_heads % tp and not cfg.n_kv_heads % tp else 1


@pytest.fixture(scope="module")
def models():
    """``kind -> (jax cfg, jax params on the host, port cfg)``."""
    out = {}
    for seed, kind in enumerate(KINDS):
        jcfg = _jcfg(kind)
        out[kind] = (jcfg, jax.device_get(
            j_init_params(jcfg, jax.random.PRNGKey(seed))),
            config_from_jax(dataclasses.asdict(jcfg)))
    return out


def _stage(cfg, axes: dict, plan_cls):
    return plan_cls(worker_id="w0", layer_lo=0, layer_hi=cfg.n_layers,
                    first=True, last=True, holds_head=True,
                    mesh_axes=dict(axes))


def _n(axes: dict) -> int:
    return int(np.prod(list(axes.values())))


def _jax_tree(jcfg, host, axes: dict):
    """The JAX tree ``put`` by ``stage_param_specs`` on the host devices."""
    jm = j_build_mesh(axes, jax.devices("cpu")[:_n(axes)])
    specs = jplanner.stage_param_specs(jcfg,
                                       _stage(jcfg, axes, jplanner.StagePlan))
    return jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(jm, s)),
                        host, specs)


def _port_tree(cfg, host, axes: dict):
    """The same numpy weights placed by the port's ``stage_param_specs``
    on host positions."""
    mesh = tmesh.build_mesh(axes, [CPU] * _n(axes))
    specs = tplanner.stage_param_specs(cfg,
                                       _stage(cfg, axes, tplanner.StagePlan))
    return tmesh.put(mesh, params_from_jax(host, device="cpu"), specs)


def _port_engine(cfg, tree, **kw) -> ContinuousEngine:
    gen = GenerationEngine(cfg, tree, max_seq_len=64, device="cpu")
    return ContinuousEngine(gen, **{**ENGINE_KW, **kw})


def _placed_engine(models, mesh: str, **kw) -> ContinuousEngine:
    kind, axes = MESHES[mesh]
    _, host, cfg = models[kind]
    return _port_engine(cfg, _port_tree(cfg, host, axes), **kw)


def _serve(ce, sp_cls, mixes=MIXES):
    reqs = [
        ce.submit(p, max_new_tokens=n, sampling=sp_cls.make(**knobs),
                  seed=seed, speculative=spec)
        for p, n, knobs, seed, spec in mixes
    ]
    ce.run_until_idle()
    assert all(r.finished and r.error is None for r in reqs)
    return [list(r.tokens) for r in reqs]


def _joined_pages(cache) -> list:
    """The port's page fields in the reference layout: a placed cache's
    shards joined by kv head."""
    out = []
    for t in cache.fields():
        if isinstance(t, tmesh.Sharded):
            out.append(torch.cat(t.shards, dim=2).numpy())
        else:
            out.append(t.numpy())
    return out


def _jax_pages(cache) -> list:
    out = [np.asarray(cache.k), np.asarray(cache.v)]
    if cache.k_scale is not None:
        out += [np.asarray(cache.k_scale), np.asarray(cache.v_scale)]
    return out


# -- against the JAX package ------------------------------------------------
@pytest.mark.parametrize("mesh,kv_quant", CASES,
                         ids=[f"{m}-{q}" for m, q in CASES])
def test_placed_streams_and_pages_equal_jax(models, mesh, kv_quant):
    kind, axes = MESHES[mesh]
    jcfg, host, cfg = models[kind]
    jgen = JGen(jcfg, _jax_tree(jcfg, host, axes), seq_buckets=(8, 32),
                batch_buckets=(1,), max_seq_len=64)
    jce = JEngine(jgen, **ENGINE_KW, kv_quant=kv_quant)
    want = _serve(jce, JSP)
    ce = _placed_engine(models, mesh, kv_quant=kv_quant)
    assert ce.tensor_parallel == 1 and ce._mesh.shape == axes
    got = _serve(ce, SamplingParams)
    assert got == want
    assert ce.chunks > 0
    for key in ("spec_drafted", "spec_accepted", "prefill_tokens",
                "decode_steps"):
        assert ce.stats[key] == jce.stats[key], key
    assert ce.cache.tp == _page_tp(cfg, axes)
    got_p, want_p = _joined_pages(ce.cache), _jax_pages(jce.cache)
    assert [g.shape for g in got_p] == [w.shape for w in want_p]
    if kv_quant == "none":
        for g, w in zip(got_p, want_p):
            np.testing.assert_allclose(g, w, **PAGE_TOL)
    else:
        for g, w in zip(got_p[:2], want_p[:2]):
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
        for g, w in zip(got_p[2:], want_p[2:]):
            np.testing.assert_allclose(g, w, **PAGE_TOL)
    assert ce.alloc._free == jce.alloc._free
    ce.check_page_conservation()
    ce.close()
    jce.close()


def _teacher_logits(cfg, tree, tokens: list) -> np.ndarray:
    """The placed forward's logits at every position of ``tokens``: a
    ragged prefill of all but the last token over one slot's pages (every
    row through the head), then one decode step of the last token over
    them. ``[T, V]``."""
    fwd = paged._PlacedFwd(tree, cfg, kernel=False)
    dev, cmesh = paged.placed_cache_mesh(tree, cfg)
    cache = paged.PagedKVCache.init(cfg, 1, page_size=8, max_len=64,
                                    device=dev, mesh=cmesh)
    paged.bind_slot(cache, 0, list(range(1, cache.pages_per_slot + 1)), 0)
    T = len(tokens) - 1
    blk = torch.tensor([tokens[:T]], dtype=torch.int32)
    starts = torch.zeros(1, dtype=torch.int32)
    n_valid = torch.tensor([T], dtype=torch.int32)
    write_pg, write_off, pos, _ = paged._ragged_write_indices(
        cache.block_tables, starts, n_valid, cache.page_size,
        cache.pages_per_slot, T)
    x = fwd.ragged(blk, cache, starts, n_valid, write_pg, write_off, pos)
    pre = fwd.head(x, torch.zeros((1, 1), dtype=torch.long),
                   torch.arange(T)[None])[0]
    cache = dataclasses.replace(cache, lengths=n_valid.clone())
    last, _ = fwd.decode(torch.tensor([tokens[T]], dtype=torch.int32),
                         cache, torch.ones(1, dtype=torch.bool))
    return torch.cat([pre, last]).numpy()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placed_teacher_forced_logits_equal_jax(models, mesh):
    kind, axes = MESHES[mesh]
    jcfg, host, cfg = models[kind]
    tokens = [int(t) for t in
              np.random.default_rng(5).integers(0, 128, 21)]
    want, _ = j_forward(_jax_tree(jcfg, host, axes),
                        jnp.asarray([tokens], jnp.int32), jcfg)
    got = _teacher_logits(cfg, _port_tree(cfg, host, axes), tokens)
    np.testing.assert_allclose(got, np.asarray(want)[0], rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


# -- the port's own contracts on the placed engine ---------------------------
@pytest.mark.parametrize("mesh", ["fsdp2-tensor2", "expert2-tensor2",
                                  "olmo2-tensor2", "heads6-tensor4"])
def test_placed_solo_cobatched_prefix_and_spec_bitwise(models, mesh):
    together = _serve(_placed_engine(models, mesh), SamplingParams)
    for mix, want in zip(MIXES, together):
        assert _serve(_placed_engine(models, mesh), SamplingParams,
                      [mix]) == [want]
    plain = _placed_engine(models, mesh, spec_decode=False)
    assert _serve(plain, SamplingParams) == together
    # a shared prefix: the repeat hits the trie, the cache-off engine not
    shared = [([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8], 6, {}, 2, False)] * 2
    on = _placed_engine(models, mesh)
    off = _placed_engine(models, mesh, prefix_cache=False)
    streams = [_serve(on, SamplingParams, [m]) for m in shared]
    assert streams == [_serve(off, SamplingParams, [m]) for m in shared]
    assert on.stats["prefill_tokens_skipped"] > 0
    assert off.stats["prefill_tokens_skipped"] == 0
    for ce in (plain, on, off):
        ce.check_page_conservation()


@pytest.mark.parametrize("mesh,kv_quant", [
    ("fsdp2-tensor2", "none"), ("fsdp2-tensor2", "int8"),
    ("olmo2-fsdp2-tensor2", "none"), ("mqa-tensor2", "int8")])
def test_placed_migration_blob_round_trip(models, mesh, kv_quant):
    sp = SamplingParams.make(temperature=0.9, top_k=5)
    prompt = [5, 6, 7, 8, 9, 10, 11]
    solo = _placed_engine(models, mesh, kv_quant=kv_quant)
    want = _serve(solo, SamplingParams, [(prompt, 14, dict(
        temperature=0.9, top_k=5), 9, False)])[0]
    src = _placed_engine(models, mesh, kv_quant=kv_quant)
    dst = _placed_engine(models, mesh, kv_quant=kv_quant)
    r = src.submit(prompt, max_new_tokens=14, sampling=sp, seed=9)
    while len(r.tokens) < 5:
        src.step_chunk()
    assert not r.finished
    src.freeze_slot(r.slot)
    chain, limit = src.migration_chain(r.slot)
    blob = src.export_slot(r.slot, n_skip=dst.resident_prefix_pages(chain,
                                                                    limit))
    # the blob holds the reference layout: every kv head of a page
    assert np.asarray(blob["k"]).shape[2] == \
        models[MESHES[mesh][0]][2].n_kv_heads
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
    for ce in (src, dst):
        ce.check_page_conservation()
        ce.close()


def test_placed_publish_replaces_on_the_mesh(models):
    """A whole tree published into a placed engine is placed as the
    serving tree lies (leaf by leaf, on the same mesh): its streams equal
    a fresh placed engine's over the new weights."""
    kind, axes = MESHES["fsdp2-tensor2"]
    jcfg, _, cfg = models[kind]
    new = jax.device_get(j_init_params(jcfg, jax.random.PRNGKey(9)))
    ce = _placed_engine(models, "fsdp2-tensor2")
    mesh = ce._mesh
    _serve(ce, SamplingParams)
    ce.publish_weights(params_from_jax(new, device="cpu"))
    assert tmesh.tree_mesh(ce.engine.params) is mesh
    got = _serve(ce, SamplingParams)
    fresh = _port_engine(cfg, _port_tree(cfg, new, axes))
    assert got == _serve(fresh, SamplingParams)
    assert ce.weights_version == 2


def test_placed_refusals_name_their_items(models):
    """A shared page pool on the engine's page mesh and trees whose heads
    the tensor axis does not split as the tp engine does now build; the
    one refusal left in ``_check_placed`` is a process-spanning mesh,
    citing its ROADMAP item (queue 1 item 11)."""
    import inspect
    import re

    _, host, cfg = models["dense"]
    tree = _port_tree(cfg, host, {"fsdp": 2, "tensor": 2})
    gen = GenerationEngine(cfg, tree, max_seq_len=64, device="cpu")
    dev, cmesh = paged.placed_cache_mesh(tree, cfg)
    pool = paged.SharedPagePool(cfg, 32, page_size=8, device=dev,
                                mesh=cmesh)
    ce = ContinuousEngine(gen, **ENGINE_KW, pool=pool, model_id="a")
    assert ce.cache.k is pool.kv[0] and ce.cache.tp == 2
    ce.close()
    for mesh in ("olmo2-tensor2", "mqa-tensor2", "heads6-tensor4"):
        kind, axes = MESHES[mesh]
        _, host_m, cfg_m = models[kind]
        gen_m = GenerationEngine(cfg_m, _port_tree(cfg_m, host_m, axes),
                                 max_seq_len=64, device="cpu")
        ce = ContinuousEngine(gen_m, **ENGINE_KW)
        assert ce.cache.tp == _page_tp(cfg_m, axes)
        ce.close()
    body = inspect.getsource(paged._check_placed)
    assert body.count("raise ") == 1
    assert re.findall(r"queue 1 item (\d+)", body) == ["11"]
    spanning = types.SimpleNamespace(mesh=types.SimpleNamespace(spans=True))
    with pytest.raises(ValueError, match="ROADMAP queue 1 item 11"):
        paged._check_placed(spanning)


# -- a worker's planned-mesh job -------------------------------------------
class _Bridge:
    def __init__(self):
        self.q = types.SimpleNamespace(work=queue.Queue())
        self.sent = []

    def request(self, verb, payload=None, timeout=None):
        self.sent.append((verb, payload))
        return {"ok": True}

    notify = request


def _worker(pkg: str, mesh_devices=None, **ml_kw):
    """A bare worker of either package; ``mesh_devices`` is the port's
    alone (the JAX worker sees the conftest's host devices)."""
    if pkg == "port":
        from tensorlink_tpu_torch.core import config as C
        from tensorlink_tpu_torch.ml.worker import DistributedWorker

        ml = C.MLConfig(device="cpu", max_seq_len=64, warmup_tokens=0,
                        mesh_devices=mesh_devices, **ml_kw)
    else:
        from tensorlink_tpu.core import config as C
        from tensorlink_tpu.ml.worker import DistributedWorker

        ml = C.MLConfig(max_seq_len=64, warmup_tokens=0, **ml_kw)
    return DistributedWorker(types.SimpleNamespace(
        bridge=_Bridge(), node_id=f"{pkg}-w0", config=C.WorkerConfig(ml=ml),
        crash=lambda: None))


@pytest.fixture(scope="module")
def checkpoints(models, tmp_path_factory):
    """``kind -> path``: each tiny model written by the JAX exporter."""
    from tensorlink_tpu.engine.loader import export_hf as j_export_hf

    return {kind: str(j_export_hf(jcfg, host,
                                  tmp_path_factory.mktemp(kind) / "m"))
            for kind, (jcfg, host, _) in models.items()}


# tlint: disable=TL006(read-only test data)
WORKER_REQUESTS = [
    dict(prompts=[[7, 3, 100, 5]], max_new_tokens=10),
    dict(prompts=[REP], max_new_tokens=12, temperature=0.8, top_k=5),
    dict(prompts=[[9, 1, 2, 30, 7]], max_new_tokens=6),
]


def _continuous(w, job: str, tag: str) -> list:
    """``WORKER_REQUESTS`` as continuous GENERATEs, co-resident; their
    reply bodies in order."""
    for i, body in enumerate(WORKER_REQUESTS):
        w._handle("gen", {"rid": f"{tag}{i}", "peer": "p", "job_id": job,
                          "continuous": True, "seed": 3 + i, **body})

    def replies():
        return {p["rid"]: p["body"] for v, p in w.bridge.sent
                if v == "respond" and p["rid"].startswith(tag)}

    for _ in range(200):
        if len(replies()) == len(WORKER_REQUESTS):
            break
        w._handle("cont_continue", {"job_id": job})
    got = replies()
    assert len(got) == len(WORKER_REQUESTS), got
    return [got[f"{tag}{i}"] for i in range(len(WORKER_REQUESTS))]


@pytest.mark.parametrize("mesh,pool_pages", [
    ("expert2-tensor2", 0), ("data2-tensor2", 0), ("fsdp2-tensor2", 64),
    ("olmo2-tensor2", 0)])
def test_planned_mesh_job_serves_continuous_like_jax(models, checkpoints,
                                                      mesh, pool_pages):
    """A job on a planned mesh answers its continuous GENERATEs from its
    slot engine over the placed tree (not the static paths), co-batched,
    and each answer equals the JAX worker's on the same plan — with
    ``cont_pool_pages > 0`` as a tenant of a shared pool made on the
    engine's page mesh, and for OLMo-2 (qk_norm_full)."""
    kind, axes = MESHES[mesh]
    jcfg, _, _ = models[kind]
    stage = {"worker_id": "w0", "layer_lo": 0, "layer_hi": jcfg.n_layers,
             "first": True, "last": True, "holds_head": True,
             "mesh_axes": dict(axes), "coworkers": []}
    job = "cd34ab12"
    answers = []
    for pkg in ("port", "jax"):
        w = _worker(pkg, mesh_devices=4, cont_pool_pages=pool_pages)
        w._handle("load_stage", {
            "rid": "m", "peer": "p", "job_id": job, "training": False,
            "stage": stage, "model": {"name": "tiny",
                                      "config": jcfg.to_json(),
                                      "ckpt": checkpoints[kind]}})
        answers.append(_continuous(w, job, "c"))
        if pkg == "port":
            rt = w.jobs[job]
            assert rt.cont.engine is rt.engine
            assert rt.cont._mesh is rt.mesh and rt.cont.chunks > 0
            assert tmesh.is_sharded(rt.params)
            if pool_pages:
                pool = rt.cont.pool
                assert pool is not None and rt.cont.alloc.pool is pool
                assert list(w._kv_pools.values()) == [pool]
                assert rt.cont.cache.k is pool.kv[0]
                assert pool.placement == paged.page_placement(
                    *paged.placed_cache_mesh(rt.params, rt.cfg))
                assert pool.n_pages - 1 == pool_pages
    for got, want in zip(*answers):
        assert got["sequences"] == [list(map(int, s))
                                    for s in want["sequences"]]
        assert got["serving"]["tensor_parallel"] == 1


def test_a_card_worker_advertises_every_card_from_its_own(monkeypatch):
    """By default (``mesh_devices`` None) a card worker advertises every
    local card from its own on, as the JAX worker advertises every local
    device, and a CPU worker its host once; an int or a list still
    chooses."""
    cards = [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(tmesh, "local_devices", lambda: list(cards))
    w = _worker("port")
    assert w.node.config.ml.mesh_devices is None
    assert w._advertised_devices() == [CPU]
    w.device = torch.device("cuda", 1)
    assert w._advertised_devices() == cards[1:]
    assert w._mesh_devices(2) == cards[1:3]
    one = _worker("port", mesh_devices=1)
    one.device = torch.device("cuda", 1)
    assert one._advertised_devices() == [cards[1]]
    named = _worker("port", mesh_devices=["cuda:0"] * 2)
    assert named._advertised_devices() == [cards[0]] * 2
