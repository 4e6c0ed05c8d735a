"""Live slot migration, drain and the prefill→decode handoff in the port
(engine/continuous.py, engine/paged.py ``gather_page``/``scatter_page``,
core/serialization.py) against the JAX package on the same weights.

- The TLTS frame and ``content_digest`` are byte-equal across packages,
  bfloat16 arrays included (carried as their 16-bit payload).
- A JAX engine's export blob, staged and adopted by a port engine and
  exported again from there, encodes byte for byte as the JAX blob (keys,
  ``blob_v`` 2, the ``"dtype"`` string, payload, digest), in fp, int8 and
  int4; the port's own export of the same slot has the same metadata and
  its payload within 2e-5 (codes within 1).
- A JAX blob adopted by the port continues JAX's uninterrupted stream
  token for token, greedy and sampled, in every page format.
- Inside the port, token for token: a migrated stream equals the
  uninterrupted one (with neighbours on both sides, and with a
  destination prefix short-circuit); abort resumes locally; a refused
  blob (wrong mode, bad digest, int4 → int8) re-prefills; the TTL GC
  frees staged pages; the handoff (ship, re-prefill and local-resume
  rungs) equals the single-engine stream and JAX's; the drain fence
  refuses new work and sheds the queue. Pages are conserved throughout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.core import serialization as jser
from tensorlink_tpu.engine.continuous import ContinuousEngine as JEngine
from tensorlink_tpu.engine.generate import GenerationEngine as JGen
from tensorlink_tpu.engine.sampling import SamplingParams as JSP
from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu_torch.convert import (
    blob_from_jax,
    config_from_jax,
    params_from_jax,
)
from tensorlink_tpu_torch.core import serialization as tser
from tensorlink_tpu_torch.engine import paged as tpaged
from tensorlink_tpu_torch.engine.continuous import ContinuousEngine
from tensorlink_tpu_torch.engine.generate import GenerationEngine
from tensorlink_tpu_torch.engine.sampling import SamplingParams

torch.set_num_threads(1)

JCFG = JModelConfig(
    family="qwen3", vocab_size=258, d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, max_seq_len=64, qk_norm=True,
    tie_embeddings=True, rope_theta=1e6, dtype=jnp.float32,
)
# tlint: disable=TL006(read-only constant table)
ENGINE_KW = dict(max_slots=4, page_size=8, chunk_steps=4, prefill_chunk=16)
# tlint: disable=TL006(read-only shared-prompt data)
SYS = [17, 3, 99, 42, 8, 250, 61, 5, 77, 12, 190, 33, 4, 120, 7, 88]
FORMATS = ("none", "int8", "int4")


@pytest.fixture(scope="module")
def models():
    jparams = j_init_params(JCFG, jax.random.PRNGKey(0))
    cfg = config_from_jax(dataclasses.asdict(JCFG))
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    jgen = JGen(JCFG, jparams, seq_buckets=(8, 32), batch_buckets=(1,),
                max_seq_len=64)
    tgen = GenerationEngine(cfg, tparams, max_seq_len=64, device="cpu")
    return jgen, tgen


def _drive_until(ce, req, n):
    while len(req.tokens) < n and not req.finished:
        ce.step_chunk()
    assert not req.finished, "budget too small to freeze mid-decode"


def _solo(eng_cls, gen, prompt, n, sampling, seed, **kw):
    ce = eng_cls(gen, **{**ENGINE_KW, **kw})
    r = ce.submit(prompt, max_new_tokens=n, sampling=sampling, seed=seed)
    ce.run_until_idle()
    return list(r.tokens)


def _resume(dst, moved, mig_id, sampling=None):
    return dst.submit(
        moved.prompt + moved.tokens,
        max_new_tokens=moved.budget - len(moved.tokens),
        sampling=sampling or moved.sampling, eos_ids=sorted(moved.eos),
        seed=moved.seed, start_step=moved.start_step + len(moved.tokens),
        priority=moved.priority, adopt=mig_id,
    )


def _migrate(src, dst, req, mig_id, *, convert=None, sampling=None):
    """Freeze, probe, export, TLTS round trip, stage, commit, resume."""
    slot = req.slot
    src.freeze_slot(slot)
    src.check_page_conservation()
    chain, limit = src.migration_chain(slot)
    blob = src.export_slot(slot, n_skip=dst.resident_prefix_pages(chain,
                                                                  limit))
    if convert is None:
        blob = tser.decode(tser.encode(blob), copy=True)
    else:
        blob = convert(blob)
    assert dst.stage_migration(mig_id, blob)
    dst.check_page_conservation()
    moved = src.commit_migration(slot)
    src.check_page_conservation()
    return _resume(dst, moved, mig_id, sampling), moved


def _jax_to_port(blob):
    """The JAX blob over the wire: JAX's encoder, the port's decoder."""
    return blob_from_jax(tser.decode(bytes(jser.encode(blob)), copy=True))


# -- the frame -------------------------------------------------------------
def test_tlts_frame_and_digest_byte_equal_jax_bf16_included():
    import ml_dtypes

    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
    bf = f32.astype(ml_dtypes.bfloat16)
    i8 = rng.integers(-127, 128, size=(2, 3, 8, 16)).astype(np.int8)
    jobj = {"k": bf, "v": f32, "codes": i8, "n": 3, "s": "x",
            "t": (1, 2.5, None), "b": b"\x01"}
    tobj = dict(jobj, k=bf.view(np.uint16).view(tser.BFLOAT16))
    assert bytes(tser.encode(tobj)) == bytes(jser.encode(jobj))
    assert tser.content_digest(tobj) == jser.content_digest(jobj)
    # an ml_dtypes array encodes to the same bytes in the port too
    assert bytes(tser.encode(jobj)) == bytes(jser.encode(jobj))
    back = tser.decode(jser.encode(jobj), copy=True)
    assert back["k"].dtype == tser.BFLOAT16
    assert np.array_equal(back["k"].view(np.uint16), bf.view(np.uint16))
    assert back["t"] == (1, 2.5, None) and back["b"] == b"\x01"
    # a bf16 page round-trips byte-exactly through gather/scatter
    cfg = config_from_jax(dataclasses.asdict(JCFG)).with_(
        dtype=torch.bfloat16)
    cache = tpaged.PagedKVCache.init(cfg, 2, page_size=8, max_len=16,
                                     device="cpu")
    cache.k.normal_()
    cache.v.normal_()
    got = tpaged.gather_page(cache, 2)
    assert got[0].dtype == tser.BFLOAT16
    cache.k[:, 2] = 0  # a later write does not reach the host copy
    tpaged.scatter_page(cache, 3, *got)
    assert torch.equal(cache.k[:, 3], tpaged.device_tensor(got[0], "cpu"))
    assert not torch.equal(cache.k[:, 3], cache.k[:, 2])


# -- blobs across the packages ----------------------------------------------
def _mid_decode(eng_cls, gen, sp_cls, kv_quant, *, n_tok=5):
    ce = eng_cls(gen, **ENGINE_KW, kv_quant=kv_quant)
    r = ce.submit(SYS + [40, 41], max_new_tokens=14,
                  sampling=sp_cls.make(temperature=0.9, top_k=5), seed=7)
    _drive_until(ce, r, n_tok)
    ce.freeze_slot(r.slot)
    return ce, r


def _payload_close(tb, jb, kv_quant):
    from tensorlink_tpu.models.quant import unpack_int4

    for f in ("k", "v"):
        t, j = np.asarray(tb[f]), np.asarray(jb[f])
        if kv_quant == "none":
            np.testing.assert_allclose(t, j, rtol=2e-5, atol=2e-5)
        else:
            if kv_quant == "int4":
                t, j = (np.asarray(unpack_int4(jnp.asarray(a)))
                        for a in (t, j))
            assert np.abs(t.astype(int) - j.astype(int)).max() <= 1
    for f in ("k_scale", "v_scale"):
        assert (f in tb) == (f in jb)
        if f in tb:
            np.testing.assert_allclose(tb[f], jb[f], rtol=2e-5, atol=0)


@pytest.mark.parametrize("kv_quant", FORMATS)
def test_export_blob_byte_equal_to_jax(models, kv_quant):
    jgen, tgen = models
    jce, jr = _mid_decode(JEngine, jgen, JSP, kv_quant)
    jblob = jce.export_slot(jr.slot)
    # the port adopts the JAX blob and exports the same slot again
    dst = ContinuousEngine(tgen, **ENGINE_KW, kv_quant=kv_quant)
    assert dst.stage_migration("m", _jax_to_port(jblob))
    moved = jce.commit_migration(jr.slot)
    r2 = _resume(dst, moved, "m", SamplingParams.make(temperature=0.9,
                                                      top_k=5))
    dst.step_chunk(admit_only=True)
    assert r2.slot >= 0 and dst.stats["migrations_adopted"] == 1
    dst.freeze_slot(r2.slot)
    tblob = dst.export_slot(r2.slot)
    assert list(tblob) == list(jblob)
    assert bytes(tser.encode(tblob)) == bytes(jser.encode(jblob))
    assert tblob["digest"] == jblob["digest"]
    assert tblob["blob_v"] == 2
    assert tblob["dtype"] == ("float32" if kv_quant == "none" else "int8")
    # the port's own export of the same request: same metadata, payload
    # within the step's tolerance
    tce, tr = _mid_decode(ContinuousEngine, tgen, SamplingParams, kv_quant)
    own = tce.export_slot(tr.slot)
    for key in jblob:
        if key not in ("k", "v", "k_scale", "v_scale", "digest"):
            assert np.array_equal(np.asarray(own[key]),
                                  np.asarray(jblob[key])), key
    _payload_close(own, jblob, kv_quant)
    dst.abort_migration(r2.slot)
    tce.abort_migration(tr.slot)
    for ce in (dst, tce):
        ce.run_until_idle()
        ce.close()
    jce.close()


@pytest.mark.parametrize("kv_quant", FORMATS)
def test_jax_blob_adopted_by_port_continues_jax_stream(models, kv_quant):
    jgen, tgen = models
    mixes = [
        (SYS + [40, 41], 14, dict(temperature=0.9, top_k=5), 7),
        ([5, 6, 7, 8, 9, 10, 11, 12, 13], 12, {}, 9),
    ]
    for p, n, s, seed in mixes:
        want = _solo(JEngine, jgen, p, n, JSP.make(**s), seed,
                     kv_quant=kv_quant)
        src = JEngine(jgen, **ENGINE_KW, kv_quant=kv_quant)
        dst = ContinuousEngine(tgen, **ENGINE_KW, kv_quant=kv_quant)
        r = src.submit(p, max_new_tokens=n, sampling=JSP.make(**s),
                       seed=seed)
        _drive_until(src, r, 5)
        r2, moved = _migrate(src, dst, r, "j", convert=_jax_to_port,
                             sampling=SamplingParams.make(**s))
        dst.run_until_idle()
        assert moved.tokens + r2.tokens == want
        assert dst.stats["migrations_adopted"] == 1
        assert dst.serving_snapshot()["pages_in_transit"] == 0
        dst.check_page_conservation()
        src.close()
        dst.close()


# -- inside the port ---------------------------------------------------------
@pytest.mark.parametrize("kv_quant", FORMATS)
def test_migrated_stream_unchanged_with_neighbours(models, kv_quant):
    _, tgen = models
    sp = SamplingParams.make(temperature=0.9, top_k=5)
    want = _solo(ContinuousEngine, tgen, [5, 6, 7], 14, sp, 9,
                 kv_quant=kv_quant)
    src = ContinuousEngine(tgen, **ENGINE_KW, kv_quant=kv_quant)
    dst = ContinuousEngine(tgen, **ENGINE_KW, kv_quant=kv_quant)
    nb_src = src.submit([9, 9, 1], max_new_tokens=20, seed=41)
    nb_dst = dst.submit([8, 8, 2], max_new_tokens=20, seed=42)
    r = src.submit([5, 6, 7], max_new_tokens=14, sampling=sp, seed=9)
    _drive_until(src, r, 5)
    dst.step_chunk()
    r2, moved = _migrate(src, dst, r, "m")
    src.run_until_idle()
    dst.run_until_idle()
    assert moved.tokens + r2.tokens == want
    for nb, p, seed in ((nb_src, [9, 9, 1], 41), (nb_dst, [8, 8, 2], 42)):
        assert nb.tokens == _solo(ContinuousEngine, tgen, p, 20,
                                  SamplingParams.make(), seed,
                                  kv_quant=kv_quant)
    assert src.stats["migrations_completed"] == 1
    assert src.serving_snapshot()["pages_in_transit"] == 0
    src.close()
    dst.close()


def test_migration_prefix_short_circuit_abort_and_fallbacks(models):
    _, tgen = models
    prompt = SYS + [40, 41]
    want = _solo(ContinuousEngine, tgen, prompt, 12, SamplingParams.make(), 7)
    # a destination holding the prompt's pages gets fewer pages shipped
    src = ContinuousEngine(tgen, **ENGINE_KW)
    dst = ContinuousEngine(tgen, **ENGINE_KW)
    warm = dst.submit(prompt, max_new_tokens=2, seed=1)
    dst.run_until_idle()
    assert warm.finished
    r = src.submit(prompt, max_new_tokens=12, seed=7)
    _drive_until(src, r, 4)
    src.freeze_slot(r.slot)
    chain, limit = src.migration_chain(r.slot)
    n_skip = dst.resident_prefix_pages(chain, limit)
    assert n_skip >= 2
    full = src.export_slot(r.slot)
    blob = src.export_slot(r.slot, n_skip=n_skip)
    assert blob["k"].shape[0] == full["k"].shape[0] - n_skip
    # refusals leak nothing: a wrong mode and a corrupted payload
    assert not dst.stage_migration("x", dict(blob, kv_quant="int8"))
    assert not dst.stage_migration("x", dict(blob, digest="0" * 64))
    dst.check_page_conservation()
    assert dst.stage_migration("m", blob)
    moved = src.commit_migration(r.slot)
    r2 = _resume(dst, moved, "m")
    dst.run_until_idle()
    assert moved.tokens + r2.tokens == want
    # abort: the slot resumes where it stopped
    ce = ContinuousEngine(tgen, **ENGINE_KW)
    r = ce.submit(prompt, max_new_tokens=12, seed=7)
    _drive_until(ce, r, 4)
    ce.freeze_slot(r.slot)
    ce.export_slot(r.slot)
    ce.abort_migration(r.slot)
    ce.run_until_idle()
    assert r.tokens == want and ce.stats["migrations_failed"] == 1
    # a failed staging: the resume names a ticket never staged and
    # re-prefills
    r = src.submit(prompt, max_new_tokens=12, seed=7)
    _drive_until(src, r, 5)
    src.freeze_slot(r.slot)
    moved = src.commit_migration(r.slot, fell_back=True)
    assert src.stats["migrations_fell_back"] == 1
    other = ContinuousEngine(tgen, **ENGINE_KW)
    r2 = _resume(other, moved, "never-staged")
    other.run_until_idle()
    assert moved.tokens + r2.tokens == want
    assert other.stats["migrations_adopted"] == 0
    # the TTL GC frees a ticket whose resume never arrives
    gc = ContinuousEngine(tgen, **ENGINE_KW, migration_ttl_s=0.0)
    r = src.submit(prompt, max_new_tokens=12, seed=7)
    _drive_until(src, r, 3)
    src.freeze_slot(r.slot)
    free0 = gc.alloc.n_free
    assert gc.stage_migration("lost", src.export_slot(r.slot))
    assert gc.alloc.n_free < free0 and gc.staged_migrations() == ["lost"]
    assert gc.serving_snapshot()["pages_in_transit"] > 0
    gc.check_page_conservation()
    gc.step_chunk()
    assert gc.staged_migrations() == [] and gc.alloc.n_free == free0
    src.abort_migration(r.slot)
    for e in (src, dst, ce, other, gc):
        e.run_until_idle()
        e.check_page_conservation()
        e.close()


def test_int4_to_int8_drain_refuses_and_re_prefills(models):
    _, tgen = models
    src = ContinuousEngine(tgen, **ENGINE_KW, kv_quant="int4")
    dst = ContinuousEngine(tgen, **ENGINE_KW, kv_quant="int8")
    assert src.migration_mode() == ("int4", 8, "int8")
    assert dst.migration_mode() == ("int8", 8, "int8")
    r = src.submit([5, 6, 7], max_new_tokens=12, seed=9)
    _drive_until(src, r, 5)
    src.freeze_slot(r.slot)
    assert not dst.stage_migration("x1", src.export_slot(r.slot))
    dst.check_page_conservation()
    moved = src.commit_migration(r.slot, fell_back=True)
    r2 = dst.submit(moved.prompt + moved.tokens,
                    max_new_tokens=moved.budget - len(moved.tokens),
                    seed=9, start_step=len(moved.tokens))
    dst.run_until_idle()
    assert r2.finished and len(moved.tokens) + len(r2.tokens) == 12
    for e in (src, dst):
        e.check_page_conservation()
        e.close()


# -- the handoff ----------------------------------------------------------
def _prefill_engine(cls, gen, **kw):
    return cls(gen, **ENGINE_KW, handoff_after_prefill=True,
               worker_role="prefill", **kw)


def _handoff_streams(cls, gen, sp_cls, mixes):
    """Each mix handed from a prefill engine to a decode engine."""
    src, dst = _prefill_engine(cls, gen), cls(gen, **ENGINE_KW)
    reqs = [src.submit(p, max_new_tokens=n, sampling=sp_cls.make(**s),
                       seed=seed, handoff=True) for p, n, s, seed in mixes]
    out = {}
    for _ in range(50):
        src.step_chunk()
        for slot, req in src.handoff_manifest():
            dst.step_chunk()
            chain, limit = src.migration_chain(slot)
            blob = src.export_slot(
                slot, n_skip=dst.resident_prefix_pages(chain, limit))
            mid = f"h{len(out)}"
            assert dst.stage_migration(mid, blob)
            moved = src.commit_handoff(slot)
            assert moved.tokens == []
            out[id(req)] = dst.submit(
                moved.prompt, max_new_tokens=moved.budget,
                sampling=moved.sampling, seed=moved.seed, adopt=mid)
        if len(out) == len(mixes):
            break
    dst.run_until_idle()
    assert src.stats["handoffs_started"] == len(mixes)
    assert src.stats["handoffs_completed"] == len(mixes)
    assert src.serving_snapshot()["pages_in_transit"] == 0
    streams = [list(out[id(r)].tokens) for r in reqs]
    src.close()
    dst.close()
    return streams


HANDOFF_MIXES = (
    (SYS + [40, 41], 12, {}, 7),
    ([5, 6, 7, 8, 9, 10, 11, 12, 13], 10, dict(temperature=0.9, top_k=5), 9),
)


def test_handoff_streams_equal_single_engine_and_jax(models):
    jgen, tgen = models
    port = _handoff_streams(ContinuousEngine, tgen, SamplingParams,
                            HANDOFF_MIXES)
    jax_ = _handoff_streams(JEngine, jgen, JSP, HANDOFF_MIXES)
    assert port == jax_
    for (p, n, s, seed), got in zip(HANDOFF_MIXES, port):
        assert got == _solo(ContinuousEngine, tgen, p, n,
                            SamplingParams.make(**s), seed)


def test_handoff_fallback_rungs_and_drain_fence(models):
    _, tgen = models
    prompt, n, seed = SYS + [40, 41], 12, 7
    want = _solo(ContinuousEngine, tgen, prompt, n, SamplingParams.make(),
                 seed)
    # re-prefill rung: the transfer failed, the decode engine prefills
    src = _prefill_engine(ContinuousEngine, tgen)
    r = src.submit(prompt, max_new_tokens=n, seed=seed, handoff=True)
    while not src._handoff_ready:
        src.step_chunk()
    (slot, req), = src.handoff_manifest()
    moved = src.commit_handoff(slot, fell_back=True)
    dst = ContinuousEngine(tgen, **ENGINE_KW)
    r2 = dst.submit(moved.prompt, max_new_tokens=moved.budget, seed=seed,
                    adopt="lost")
    dst.run_until_idle()
    assert r2.tokens == want and src.stats["handoffs_fell_back"] == 1
    # local rung: no destination, the prefill engine finishes it itself
    r = src.submit(prompt, max_new_tokens=n, seed=seed, handoff=True)
    while not src._handoff_ready:
        src.step_chunk()
    (slot, req), = src.handoff_manifest()
    src.abort_handoff(slot)
    src.run_until_idle()
    assert r.finished and r.tokens == want
    # the drain fence
    ce = ContinuousEngine(tgen, **ENGINE_KW)
    q1 = ce.submit([1, 2], max_new_tokens=4, seed=1)
    q2 = ce.submit([3, 4], max_new_tokens=4, seed=2)
    ce.begin_drain()
    assert ce.drain_state == "draining"
    rej = ce.admission_check()
    assert rej is not None and rej.get("draining") is True
    assert ce.submit([5, 6], max_new_tokens=4, seed=3).error is not None
    assert not ce.stage_migration("m", {"kv_quant": "none", "page_size": 8})
    shed = ce.shed_queued()
    assert {x.rid for x in shed} == {q1.rid, q2.rid}
    assert not q1.done.is_set()
    assert ce.stats["migrations_fell_back"] == 2
    for q in shed:
        ce.fail_queued(q, RuntimeError("no transport context"))
        assert q.done.is_set() and q.error is not None
    ce.end_drain()
    ok = ce.submit([5, 6], max_new_tokens=4, seed=3)
    ce.run_until_idle()
    assert ok.finished and ok.error is None
    snap = ce.serving_snapshot()
    assert snap["drain_state"] == "serving" and snap["pages_in_transit"] == 0
    for e in (src, dst, ce):
        e.check_page_conservation()
        e.close()
