"""Speculative decoding in the port (engine/continuous.py ``spec_decode``,
``_pack_drafts``; engine/paged.py's verify rows) against the JAX package
on the same weights and inputs, plus the port's own contracts.

- One ``paged_ragged_step`` with drafts (``n_spec > 0``, spec width 5)
  over fp, int8 and int4 pages: tokens, ``n_tok``, ``spec_m``,
  ``n_exec``, lengths, steps, histograms and budgets exact; every live
  draw's logits within 2e-5 (atol and rtol, as tests/test_ops.py holds
  kernel against reference); fp pages within 2e-5, quantized codes within
  1 and scales within 2e-5 relative. The drafts are built so that greedy
  slots accept some and reject the rest.
- ``ContinuousEngine(spec_decode=True)``: streams token-equal to the JAX
  engine's, and the spec counters (drafted, accepted, verify passes,
  kills) equal; under a ``spec_budget`` too, so the budgeted grants equal.
- Inside the port, token for token: spec == plain, solo and co-batched;
  the kill switch fires after the probe window and never re-probes, even
  across a preemption; a speculating stream preempted or migrated mid-
  decode continues unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.engine import continuous as jcont
from tensorlink_tpu.engine import paged as jpaged
from tensorlink_tpu.engine.continuous import ContinuousEngine as JEngine
from tensorlink_tpu.engine.generate import GenerationEngine as JGen
from tensorlink_tpu.engine.sampling import SamplingParams as JSP
from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu_torch.convert import config_from_jax, params_from_jax
from tensorlink_tpu_torch.engine import paged as tpaged
from tensorlink_tpu_torch.engine import spec as tspec
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
# tlint: disable=TL006(read-only repetitive-prompt data)
REP = [5, 9, 5, 9, 5, 9, 5, 9]
# tlint: disable=TL006(read-only tolerance table)
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def models():
    jparams = j_init_params(JCFG, jax.random.PRNGKey(0))
    cfg = config_from_jax(dataclasses.asdict(JCFG))
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    jgen = JGen(JCFG, jparams, seq_buckets=(8, 32), batch_buckets=(1,),
                max_seq_len=64)
    tgen = GenerationEngine(cfg, tparams, max_seq_len=64, device="cpu")
    return jgen, tgen


# -- one step with drafts ------------------------------------------------
W = 5  # 1 + 4 drafts
ORDER = ("blk", "cache", "starts", "n_valid", "n_spec", "emit", "seeds",
         "steps", "temp", "top_k", "top_p", "pres", "freq", "counts",
         "remaining", "eos")


def _step_state(rng, kv_quant):
    S, C, page, n_pp, L = 4, 8, 8, 8, JCFG.n_layers
    P = 1 + S * n_pp
    shape = (L, P, JCFG.n_kv_heads, page, JCFG.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    ks = vs = None
    if kv_quant != "none":
        from tensorlink_tpu.models import quant as jq

        quant = jq.quantize_kv if kv_quant == "int8" else jq.quantize_kv4
        (k, ks), (v, vs) = (tuple(np.asarray(a) for a in quant(jnp.asarray(x)))
                            for x in (k, v))
    bt = rng.permutation(np.arange(1, P))[: S * n_pp].reshape(S, n_pp)
    bt = bt.astype(np.int32)
    lengths = np.array([8, 13, 20, 30], np.int32)
    blk = rng.integers(1, 258, size=(S, C)).astype(np.int32)
    arrays = dict(
        blk=blk,
        # a prefill, two greedy speculating decodes, one sampled one
        starts=np.array([8, 13, 20, 30], np.int32),
        n_valid=np.array([8, 5, 4, 3], np.int32),
        n_spec=np.array([0, 4, 3, 2], np.int32),
        emit=np.array([True, True, True, True]),
        seeds=np.array([1, 2, 3, 4], np.int32),
        steps=np.array([0, 5, 7, 9], np.int32),
        temp=np.array([0.0, 0.0, 0.0, 0.8], np.float32),
        top_k=np.array([0, 0, 0, 20], np.int32),
        top_p=np.ones(S, np.float32),
        pres=np.array([0.0, 0.0, 0.3, 0.4], np.float32),
        freq=np.array([0.0, 0.0, 0.0, 0.2], np.float32),
        counts=rng.integers(0, 2, size=(S, 258)).astype(np.int32),
        remaining=np.array([6, 9, 9, 9], np.int32),
        eos=np.full((S, 8), -1, np.int32),
    )
    return (k, v, ks, vs, bt, lengths), arrays


def _jax_step(jgen, state, arrays, record=None):
    k, v, ks, vs, bt, lengths = state
    cache = jpaged.PagedKVCache(
        k=jnp.asarray(k), v=jnp.asarray(v), block_tables=jnp.asarray(bt),
        lengths=jnp.asarray(lengths),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs),
    )
    args = [cache if n == "cache" else jnp.asarray(arrays[n]) for n in ORDER]
    if record is None:
        return _jax_call(jgen, args)
    real = jcont._sample_rows

    def rec(logits, *a):
        record.append(np.asarray(logits))
        return real(logits, *a)

    jcont._sample_rows = rec
    try:
        with jax.disable_jit():
            return _jax_call(jgen, args)
    finally:
        jcont._sample_rows = real


def _jax_call(jgen, args):
    return jpaged.paged_ragged_step(jgen.params, *args, JCFG, 4, W, False)


def _port_step(tgen, state, arrays, record, monkeypatch):
    k, v, ks, vs, bt, lengths = state

    def t(a):
        return None if a is None else torch.from_numpy(np.array(a))

    cache = tpaged.PagedKVCache(k=t(k), v=t(v), block_tables=t(bt),
                                lengths=t(lengths), k_scale=t(ks),
                                v_scale=t(vs))
    real = tpaged._sample_rows

    def rec(logits, *a):
        record.append(logits.numpy().copy())
        return real(logits, *a)

    monkeypatch.setattr(tpaged, "_sample_rows", rec)
    args = [cache if n == "cache" else t(arrays[n]) for n in ORDER]
    return tpaged.paged_ragged_step(tgen.params, *args, tgen.cfg, 4, W,
                                    kernel=False)


def _codes(a, kv_quant):
    """int8 codes of a page array (packed int4 unpacked), as int32."""
    from tensorlink_tpu.models.quant import unpack_int4

    if kv_quant == "int4":
        return np.asarray(unpack_int4(jnp.asarray(a))).astype(np.int32)
    return a.astype(np.int32)


def _accepting_drafts(jgen, state, arrays):
    """Rewrite the greedy slots' drafts so that each accepts all but its
    last draft: run the step, put the draw that replaced the first
    rejected draft in its place, repeat."""
    for _ in range(5):
        out = _jax_step(jgen, state, arrays)
        toks, spec_m = np.asarray(out[0]), np.asarray(out[2])
        changed = False
        for s in (1, 2):
            ns = int(arrays["n_spec"][s])
            m = int(spec_m[s])
            if m - 1 < ns - 1:  # draft m-1 was rejected: take the draw
                arrays["blk"][s, m] = toks[s, m - 1]
                changed = True
        if not changed:
            break
    return arrays


@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_ragged_step_with_drafts_matches_jax(models, monkeypatch, kv_quant):
    jgen, tgen = models
    rng = np.random.default_rng(11)
    state, arrays = _step_state(rng, kv_quant)
    arrays = _accepting_drafts(jgen, state, arrays)
    jlog, tlog = [], []
    jout = _jax_step(jgen, state, arrays, jlog)
    jit_out = _jax_step(jgen, state, arrays)
    tout = _port_step(tgen, state, arrays, tlog, monkeypatch)
    names = ("tokens", "n_tok", "spec_m", "n_exec", "cache", "done", "steps",
             "counts", "remaining")
    for name, j, jj, t in zip(names, jout, jit_out, tout):
        if name == "cache":
            assert np.array_equal(np.asarray(j.lengths), t.lengths.numpy())
            assert np.array_equal(np.asarray(jj.lengths), t.lengths.numpy())
            for jp, tp in ((j.k, t.k), (j.v, t.v)):
                jp, tp = np.asarray(jp)[:, 1:], tp.numpy()[:, 1:]
                if kv_quant == "none":
                    np.testing.assert_allclose(tp, jp, **TOL)
                else:
                    assert np.abs(_codes(tp, kv_quant)
                                  - _codes(jp, kv_quant)).max() <= 1
            if kv_quant != "none":
                for js, ts in ((j.k_scale, t.k_scale), (j.v_scale, t.v_scale)):
                    np.testing.assert_allclose(ts.numpy()[:, 1:],
                                               np.asarray(js)[:, 1:],
                                               rtol=2e-5, atol=0)
            continue
        assert np.array_equal(np.asarray(j), t.numpy()), name
        assert np.array_equal(np.asarray(jj), t.numpy()), name
    spec_m, n_tok = tout[2].numpy(), tout[1].numpy()
    # slots 1 and 2 accepted drafts and rejected their last one
    assert spec_m[1] == 4 and spec_m[2] == 3, spec_m
    # every live draw's logits: W verify draws, then the continuation's
    assert len(tlog) == len(jlog) == W + 3
    for i, (jl, tl) in enumerate(zip(jlog, tlog)):
        live = spec_m > i if i < W else n_tok > spec_m + (i - W)
        live &= arrays["emit"]
        np.testing.assert_allclose(tl[live], jl[live], **TOL)


# -- the engine ------------------------------------------------------------
MIXES = (
    # (prompt, budget, sampling kwargs, seed)
    ([12, 13, 14, 15] * 3, 24, {}, 1),
    (REP, 20, dict(temperature=0.9, top_k=5), 2),
    ([4, 5], 8, dict(temperature=0.7, top_p=0.9), 3),
    ([40] * 8, 24, {}, 4),
)


def _serve(eng_cls, gen, sp_cls, mixes, *, spec, **kw):
    ce = eng_cls(gen, **{**ENGINE_KW, "spec_decode": spec, "spec_draft": 4,
                         **kw})
    reqs = []
    for p, n, s, sd in mixes:
        reqs.append(ce.submit(p, max_new_tokens=n, sampling=sp_cls.make(**s),
                              seed=sd, speculative=True))
        ce.step_chunk()  # later requests join mid-flight
    ce.run_until_idle()
    assert all(r.finished and r.error is None for r in reqs)
    return ce, [list(r.tokens) for r in reqs]


SPEC_KEYS = ("spec_drafted", "spec_accepted", "spec_verify_passes",
             "spec_killed", "decode_steps", "slot_steps_live", "admitted")


@pytest.mark.parametrize("spec_budget", [0, 3])
def test_spec_streams_and_counters_equal_jax(models, spec_budget):
    jgen, tgen = models
    jce, jstreams = _serve(JEngine, jgen, JSP, MIXES, spec=True,
                           spec_budget=spec_budget)
    tce, tstreams = _serve(ContinuousEngine, tgen, SamplingParams, MIXES,
                           spec=True, spec_budget=spec_budget)
    assert tstreams == jstreams
    for key in SPEC_KEYS:
        assert tce.stats[key] == jce.stats[key], key
    assert tce._spec_phase == jce._spec_phase
    assert tce.stats["spec_accepted"] >= 1
    tsnap, jsnap = tce.serving_snapshot(), jce.serving_snapshot()
    assert tsnap["spec_tokens_per_pass"] == jsnap["spec_tokens_per_pass"] > 1
    assert tsnap["spec_decode"] is True
    tce.check_page_conservation()
    tce.close()


def test_spec_equals_plain_inside_the_port(models):
    _, tgen = models
    _, plain = _serve(ContinuousEngine, tgen, SamplingParams, MIXES,
                      spec=False)
    spec_ce, spec = _serve(ContinuousEngine, tgen, SamplingParams, MIXES,
                           spec=True)
    assert spec == plain
    assert spec_ce.stats["spec_accepted"] >= 1
    for mix, want in zip(MIXES, plain):
        _, solo = _serve(ContinuousEngine, tgen, SamplingParams, [mix],
                         spec=True)
        assert solo[0] == want
    # the knobs, as the JAX engine sets them
    off = ContinuousEngine(tgen, **ENGINE_KW)
    assert off.spec_width == 1
    assert not off.submit(REP, max_new_tokens=2, speculative=True).speculative
    capped = ContinuousEngine(tgen, **{**ENGINE_KW, "prefill_chunk": 8},
                              spec_decode=True, spec_draft=64)
    assert capped.spec_width == 8
    assert off.serving_snapshot()["spec_decode"] is False


def test_spec_kill_switch_fires_and_never_reprobes(models, monkeypatch):
    """Drafts that always hit and never match trip the kill switch after
    the probe window; the request never drafts again, not after a
    preemption either, and its stream is the plain one."""
    _, tgen = models
    sp = SamplingParams.make(temperature=0.9, top_k=5)
    plain_ce = ContinuousEngine(tgen, **ENGINE_KW)
    ref = plain_ce.submit(REP, max_new_tokens=24, seed=4, sampling=sp)
    plain_ce.run_until_idle()
    plain = ref.tokens

    monkeypatch.setattr(tspec, "lookup_draft",
                        lambda history, n_draft, **kw: [1] * int(n_draft))
    ce = ContinuousEngine(tgen, **{**ENGINE_KW, "max_slots": 1,
                                   "chunk_steps": 1},
                          spec_decode=True, spec_draft=4,
                          sched_aging_ticks=1000)
    r = ce.submit(REP, max_new_tokens=24, seed=4, sampling=sp,
                  speculative=True, priority="best_effort")
    while ce.stats["spec_killed"] == 0 and not r.finished:
        ce.step_chunk()
    assert ce.stats["spec_killed"] == 1 and r.spec_state.dead
    assert ce.stats["spec_verify_passes"] == tspec.ACC_PROBE
    drafted = ce.stats["spec_drafted"]
    assert not r.finished
    hi = ce.submit([8, 8], max_new_tokens=2, seed=9, priority="interactive")
    ce.run_until_idle()
    assert ce.stats["preemptions"] >= 1 and hi.finished and r.finished
    assert ce.stats["spec_drafted"] == drafted
    assert r.tokens == plain and 1 not in plain
    ce.close()


def test_spec_stream_preempted_and_migrated_unchanged(models):
    _, tgen = models
    sp = SamplingParams.make(temperature=0.9, top_k=5)
    base = ContinuousEngine(tgen, **ENGINE_KW)
    ref = base.submit(REP, max_new_tokens=14, seed=2, sampling=sp)
    greedy = [12, 13, 14, 15] * 3
    ref_g = base.submit(greedy, max_new_tokens=24, seed=2)
    base.run_until_idle()
    # preemption: the speculating victim resumes with its controller
    ce = ContinuousEngine(tgen, **{**ENGINE_KW, "max_slots": 1},
                          spec_decode=True, spec_draft=4,
                          sched_aging_ticks=1000)
    victim = ce.submit(REP, max_new_tokens=14, seed=2, sampling=sp,
                       speculative=True, priority="best_effort")
    ce.step_chunk()
    hi = ce.submit([8, 8], max_new_tokens=2, seed=9, priority="interactive")
    ce.run_until_idle()
    assert ce.stats["preemptions"] >= 1 and victim.tokens == ref.tokens
    ce.close()
    # migration mid-decode: the destination re-probes afresh
    src = ContinuousEngine(tgen, **ENGINE_KW, spec_decode=True, spec_draft=4)
    dst = ContinuousEngine(tgen, **ENGINE_KW, spec_decode=True, spec_draft=4)
    r = src.submit(greedy, max_new_tokens=24, seed=2, speculative=True)
    while len(r.tokens) < 8:
        src.step_chunk()
    assert not r.finished and src.stats["spec_verify_passes"] >= 1
    src.freeze_slot(r.slot)
    chain, limit = src.migration_chain(r.slot)
    blob = src.export_slot(r.slot, n_skip=dst.resident_prefix_pages(chain,
                                                                     limit))
    assert dst.stage_migration("sm", blob)
    moved = src.commit_migration(r.slot)
    r2 = dst.submit(moved.prompt + moved.tokens,
                    max_new_tokens=moved.budget - len(moved.tokens),
                    seed=2, start_step=len(moved.tokens), adopt="sm",
                    speculative=True)
    dst.run_until_idle()
    assert moved.tokens + r2.tokens == ref_g.tokens
    assert dst.stats["migrations_adopted"] == 1
    assert r2.spec_state is not moved.spec_state
    for e in (src, dst):
        e.check_page_conservation()
        e.close()
