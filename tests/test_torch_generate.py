"""The port's dense generation path (tensorlink_tpu_torch/engine/generate.py,
models/transformer.py::forward, models/base.py::KVCache, engine/prng.py::
split, engine/sampling.py::sample) against the JAX package on the same
weights and inputs, small float32 configs.

- Integers exact: ``split`` key bits, sampled tokens (batched knobs),
  int8 cache codes and scales from equal inputs (the quantizer and the
  clamped row write), the decode loop's ``n_exec`` and advanced
  key, and every generated token of ``generate_compiled``, ``generate``,
  ``generate_chunked`` (with its survivor re-bucketing), beam search,
  lookahead and the prompt-prefix LRU path — greedy, seeded sampled and
  penalized rows, EOS, per-row budgets and bucket-padded batches, in fp
  and ``quant="int8+kv"``, with and without ``flash_attention``, and for
  a sliding-window (mistral-style) config.
- Floats within rtol = atol = 2e-5: ``forward`` logits and fp cache rows
  with and without a cache, and the prefill logits of a flash engine
  (the plain version on the CPU) against the JAX engine's.
- The port's own contracts: what is not ported raises, naming its slice;
  a flash engine counts one flash prefill per flash-routed forward and
  runs the plain version exactly ``n_layers`` times for each.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.engine import generate as jgen_mod
from tensorlink_tpu.engine.generate import GenerationEngine as JGen
from tensorlink_tpu.engine.sampling import SamplingParams as JSP
from tensorlink_tpu.engine.sampling import sample as j_sample
from tensorlink_tpu.models import KVCache as JKVCache
from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu.models import transformer as jtr
from tensorlink_tpu_torch.convert import (
    config_from_jax,
    kv_cache_from_jax,
    params_from_jax,
)
from tensorlink_tpu_torch.engine import generate as tgen_mod
from tensorlink_tpu_torch.engine import prng
from tensorlink_tpu_torch.engine.generate import GenerationEngine
from tensorlink_tpu_torch.engine.sampling import SamplingParams, sample
from tensorlink_tpu_torch.models import KVCache
from tensorlink_tpu_torch.models import transformer as ttr
from tensorlink_tpu_torch.ops import attention as tatt

# one intra-op thread: a JAX call in this process can leave torch's worker
# threads computing exp off by up to 1e-4 (tests/test_torch_flash.py)
torch.set_num_threads(1)
# tlint: disable=TL006(read-only constant table)
TOL = dict(rtol=2e-5, atol=2e-5)

JCFG = JModelConfig(
    family="qwen3", vocab_size=258, d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, max_seq_len=128, qk_norm=True,
    tie_embeddings=True, rope_theta=1e6, dtype=jnp.float32,
)
# mistral-style: sliding window shorter than the prompts, untied head
WCFG = JModelConfig(
    family="mistral", vocab_size=256, d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, max_seq_len=128,
    tie_embeddings=False, sliding_window=16, dtype=jnp.float32,
)
# tlint: disable=TL006(read-only constant table)
ENGINE_KW = dict(seq_buckets=(8, 32), batch_buckets=(1, 2, 4),
                 max_seq_len=64)
PROMPTS = ([5, 7, 9, 11, 13], [1, 2, 3],
           [100, 101, 102, 103, 104, 105, 106, 107, 108, 109, 110])
# the windowed model's prompts fill most of their 32-token bucket: a
# padding query more than a window past a row's last real key sees no key,
# and the JAX einsum prefill then writes NaN keys that the next decode
# step's einsum carries into the real rows (NaN x 0) — in both packages
# without flash (ROADMAP queue 3)
WPROMPTS = (list(range(1, 33)), list(range(40, 60)), list(range(70, 95)))
# greedy, sampled top-k, sampled top-p with penalties
KNOBS = ({}, {"temperature": 0.8, "top_k": 20},
         {"temperature": 1.0, "top_p": 0.9, "presence_penalty": 0.5,
          "frequency_penalty": 0.3})


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, jcfg, seed in (("qwen3", JCFG, 0), ("window", WCFG, 2)):
        jp = j_init_params(jcfg, jax.random.PRNGKey(seed))
        out[name] = (jcfg, jp, params_from_jax(jax.device_get(jp),
                                               device="cpu"))
    return out


@pytest.fixture(scope="module")
def engines(trees):
    """``engines(model, flash, quant)``: a JAX engine and a port engine on
    the same weights, built once per module."""
    built = {}

    def get(model="qwen3", flash=False, quant=None):
        key = (model, flash, quant)
        if key not in built:
            jcfg, jp, tp = trees[model]
            jcfg = jcfg.with_(flash_attention=flash)
            cfg = config_from_jax(dataclasses.asdict(jcfg))
            built[key] = (
                JGen(jcfg, jp, quant=quant, **ENGINE_KW),
                GenerationEngine(cfg, tp, quant=quant, device="cpu",
                                 **ENGINE_KW),
            )
        return built[key]

    return get


def _knobs(rows, penalized=True):
    knobs = [dict(KNOBS[i % len(KNOBS)]) for i in range(rows)]
    if not penalized:
        for k in knobs:
            k.pop("presence_penalty", None)
            k.pop("frequency_penalty", None)
    return (JSP.stack([JSP.make(**k) for k in knobs], pad_to=len(knobs)),
            SamplingParams.stack([SamplingParams.make(**k) for k in knobs],
                                 pad_to=len(knobs)))


def _bits(key):
    return [int(key[0]), int(key[1])]


# -- prng and sampling -------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 7, -3, 12345, 2**31 - 1])
def test_split_matches_jax_exactly(seed):
    """``split`` (num 2 and 3) and a 64-step split chain equal
    ``jax.random.split`` bit for bit; ``PRNGKey`` takes a Python int."""
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert _bits(tk) == np.asarray(jk).astype(np.int64).tolist()
    for _ in range(64):
        jk, js = jax.random.split(jk)
        tk, ts = prng.split(tk)
        assert _bits(tk) == np.asarray(jk).astype(np.int64).tolist()
        assert _bits(ts) == np.asarray(js).astype(np.int64).tolist()
    for num in (2, 3):
        want = np.asarray(jax.random.split(jk, num)).astype(np.int64)
        assert [_bits(k) for k in prng.split(tk, num)] == want.tolist()


@pytest.mark.parametrize("mode", ["mixed", "greedy", "penalized",
                                  "greedy_penalized"])
def test_sample_batched_knobs_token_equal_to_jax(mode):
    """``sample`` with ``[B, 1]`` knobs (greedy and sampled rows in one
    batch, top-k, top-p, penalties over context counts) picks JAX's
    tokens under the same keys; padding rows from ``pad_rows`` are
    greedy."""
    rng = np.random.default_rng(["mixed", "greedy", "penalized",
                                 "greedy_penalized"].index(mode))
    B, V = 5, 258
    lg = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    counts = rng.integers(0, 3, size=(B, V)).astype(np.int32)
    knobs = [dict(KNOBS[i % 3]) for i in range(3)]
    if mode.startswith("greedy"):
        knobs = [{"presence_penalty": 1.5, "frequency_penalty": 0.5}] * 3 \
            if mode == "greedy_penalized" else [{}] * 3
    jp = JSP.stack([JSP.make(**k) for k in knobs], pad_to=3).pad_rows(B)
    tp = SamplingParams.stack([SamplingParams.make(**k) for k in knobs],
                              pad_to=3).pad_rows(B)
    assert tp.temperature.shape == (B, 1)
    assert np.array_equal(tp.top_p.numpy(), np.asarray(jp.top_p))
    cnt = mode.endswith("penalized")
    jk, tk = jax.random.PRNGKey(9), prng.PRNGKey(9)
    for _ in range(12):
        jk, js = jax.random.split(jk)
        tk, ts = prng.split(tk)
        want = np.asarray(j_sample(jnp.asarray(lg), js, jp,
                                   jnp.asarray(counts) if cnt else None))
        got = sample(torch.from_numpy(lg), ts, tp,
                     torch.from_numpy(counts) if cnt else None)
        assert np.array_equal(got.numpy(), want)


# -- the model ----------------------------------------------------------
def test_mask_bias_and_quant_kv_equal_jax_exactly():
    rng = np.random.default_rng(3)
    pos = rng.integers(0, 20, size=(3, 4)).astype(np.int32)
    valid = rng.random((3, 24)) < 0.8
    for win in (None, 5):
        want = np.asarray(jtr._mask_bias(jnp.asarray(pos), 24,
                                         jnp.asarray(valid), win))
        got = ttr._mask_bias(torch.from_numpy(pos), 24,
                             torch.from_numpy(valid), win).numpy()
        assert np.array_equal(got, want)
    x = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: the 1e-8 floor
    x[1, 1, 1, :4] = [0.5, -0.5, 1.5, 127 / 254]  # .5 ties
    jq, js = jtr._quant_kv(jnp.asarray(x))
    tq, ts = ttr._quant_kv(torch.from_numpy(x))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))


def test_cache_write_clamps_like_dynamic_update_slice():
    """A write whose start would overrun the cache lands at S - T, as
    ``lax.dynamic_update_slice`` does (a row frozen at full room rewrites
    its last slot)."""
    c = torch.zeros((3, 6, 1, 2))
    u = torch.arange(1, 13, dtype=torch.float32).reshape(3, 2, 1, 2)
    ttr._write_rows(c, u, torch.tensor([0, 4, 9], dtype=torch.int32))
    j = jax.vmap(lambda c, u, o: jax.lax.dynamic_update_slice(
        c, u, (o, 0, 0)))(jnp.zeros((3, 6, 1, 2)), jnp.asarray(u.numpy()),
                          jnp.asarray([0, 4, 9]))
    assert np.array_equal(c.numpy(), np.asarray(j))


@pytest.mark.parametrize("quantized", [False, True])
def test_forward_matches_jax_with_and_without_cache(trees, quantized):
    """Logits at 2e-5 without a cache, over a right-padded prefill into a
    fresh cache and two decode steps; cache rows and scales at 2e-5, int8
    codes within one level (the quantizer itself is exact on equal
    inputs: ``test_mask_bias_and_quant_kv_equal_jax_exactly``)."""
    jcfg, jp, tp = trees["qwen3"]
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 258, size=(2, 8)).astype(np.int32)
    mask = np.ones((2, 8), bool)
    mask[1, 5:] = False
    jl, _ = jtr.forward(jp, jnp.asarray(toks), jcfg)
    tl, _ = ttr.forward(tp, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    jc = JKVCache.init(jcfg, 2, max_len=16, quantized=quantized)
    tc = KVCache.init(cfg, 2, max_len=16, quantized=quantized, device="cpu")
    steps = [(toks, mask)] + [
        (rng.integers(0, 258, size=(2, 1)).astype(np.int32), None)
        for _ in range(2)]
    for t, m in steps:
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.from_numpy(m)
        jl, jc = jtr.forward(jp, jnp.asarray(t), jcfg, cache=jc, attn_mask=jm)
        tl, tc = ttr.forward(tp, torch.from_numpy(t), cfg, cache=tc,
                             attn_mask=tm)
        valid = np.ones(jl.shape[:2], bool) if m is None else m
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                                   **TOL)
        assert tc.length.tolist() == np.asarray(jc.length).tolist()
    n = int(np.asarray(jc.length).max())
    for name in ("k", "v") + (("k_scale", "v_scale") if quantized else ()):
        a = getattr(tc, name).numpy()[:, :, :n]
        b = np.asarray(getattr(jc, name))[:, :, :n]
        if a.dtype == np.int8:  # the k/v floats differ in the last bits
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name
        else:
            np.testing.assert_allclose(a, b, **TOL)


def test_kv_cache_from_jax_carries_a_cache(trees):
    """A JAX int8 prefill cache carried over decodes the next token to the
    JAX decode step's logits."""
    jcfg, jp, tp = trees["qwen3"]
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    toks = np.arange(1, 9, dtype=np.int32)[None].repeat(2, 0)
    jc = JKVCache.init(jcfg, 2, max_len=16, quantized=True)
    _, jc = jtr.forward(jp, jnp.asarray(toks), jcfg, cache=jc)
    tc = kv_cache_from_jax(jax.device_get(jc), device="cpu")
    assert tc.quantized and tc.k.dtype == torch.int8
    assert np.array_equal(tc.k.numpy(), np.asarray(jc.k))
    nxt = np.array([[3], [4]], np.int32)
    jl, _ = jtr.forward(jp, jnp.asarray(nxt), jcfg, cache=jc)
    tl, _ = ttr.forward(tp, torch.from_numpy(nxt), cfg, cache=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


# -- the engine ---------------------------------------------------------
VARIANTS = (("qwen3", False, None), ("qwen3", True, None),
            ("qwen3", False, "int8+kv"), ("qwen3", True, "int8+kv"),
            ("window", True, None))


def _eos_from(tg, prompts=PROMPTS):
    """An EOS id the greedy row really emits (its third token)."""
    r = tg.generate_compiled([prompts[0]], max_new_tokens=4)
    return (int(r.sequences[0][2]),)


@pytest.mark.parametrize("model,flash,quant", VARIANTS)
def test_generate_compiled_token_equal_to_jax(engines, model, flash, quant):
    """Three prompts (a padded bucket of 4) with greedy, sampled and
    penalized rows, per-row budgets and an EOS the greedy row emits."""
    jg, tg = engines(model, flash, quant)
    js, ts = _knobs(3)
    prompts = WPROMPTS if model == "window" else PROMPTS
    eos = _eos_from(tg, prompts)
    kw = dict(max_new_tokens=12, seed=3, eos_ids=eos, budgets=[12, 7, 10])
    a = jg.generate_compiled(prompts, sampling=js, **kw)
    b = tg.generate_compiled(prompts, sampling=ts, **kw)
    assert b.sequences == a.sequences
    assert b.finished == a.finished
    assert b.sequences[0][-1] == eos[0]  # the EOS row stopped on it


@pytest.mark.parametrize("model,flash,quant", VARIANTS[:3] + VARIANTS[4:])
def test_generate_host_loop_token_equal_to_jax(engines, model, flash, quant):
    """The per-token host loop, with a stream callback that cancels row 1
    after its fourth token."""
    jg, tg = engines(model, flash, quant)
    js, ts = _knobs(3)
    seen = {}

    def cb_for(name):
        seen[name] = []

        def cb(emitted):
            seen[name].append(list(emitted))
            n1 = sum(1 for e in seen[name] if e[1] is not None)
            return [1] if n1 >= 4 else None

        return cb

    prompts = WPROMPTS if model == "window" else PROMPTS
    kw = dict(max_new_tokens=10, seed=5, budgets=[10, 10, 6])
    a = jg.generate(prompts, sampling=js, stream_cb=cb_for("j"), **kw)
    b = tg.generate(prompts, sampling=ts, stream_cb=cb_for("t"), **kw)
    assert b.sequences == a.sequences and b.finished == a.finished
    assert seen["t"] == seen["j"]
    assert len(b.sequences[1]) == 4


@pytest.mark.parametrize("flash,quant", [(False, None), (True, "int8+kv")])
def test_generate_chunked_token_equal_to_jax(engines, flash, quant):
    """Sampled mixes keep their batch shape; an all-greedy batch with an
    EOS and short budgets re-buckets its survivors (the same chunk shapes
    as JAX), and both equal ``generate_compiled``."""
    jg, tg = engines("qwen3", flash, quant)
    js, ts = _knobs(3, penalized=False)
    kw = dict(max_new_tokens=11, seed=7, chunk_steps=4)
    a = jg.generate_chunked(PROMPTS, sampling=js, **kw)
    b = tg.generate_chunked(PROMPTS, sampling=ts, **kw)
    assert b.sequences == a.sequences
    c = tg.generate_compiled(PROMPTS, sampling=ts, max_new_tokens=11, seed=7)
    assert b.sequences == c.sequences
    eos = _eos_from(tg)
    kw = dict(max_new_tokens=12, eos_ids=eos, budgets=[12, 3, 5],
              chunk_steps=2)
    a = jg.generate_chunked(PROMPTS, **kw)
    b = tg.generate_chunked(PROMPTS, **kw)
    assert b.sequences == a.sequences and b.finished == a.finished
    assert tg.last_chunk_batches == jg.last_chunk_batches
    assert min(tg.last_chunk_batches) < max(tg.last_chunk_batches)
    kw.pop("chunk_steps")
    assert tg.generate_compiled(PROMPTS, **kw).sequences == b.sequences


def test_decode_loop_n_exec_and_key_equal_jax(engines):
    """One loop call on the same prefill: the emitted tokens, ``n_exec``
    (early exit once every row hits EOS or its limit) and the advanced
    key equal JAX's, and so does a second call resuming from them."""
    jg, tg = engines()
    js, ts = _knobs(3, penalized=False)
    js, ts = js.pad_rows(4), ts.pad_rows(4)
    eos = _eos_from(tg)
    jl, jc, _, _ = jg.prefill(PROMPTS)
    tl, tc, _, _ = tg.prefill(PROMPTS)
    first = np.array(jnp.argmax(jl, -1)).astype(np.int32)
    jk, tk = jax.random.PRNGKey(11), prng.PRNGKey(11)
    limits = [9, 3, 6, 0]
    for n_steps in (4, 8):
        jt, jc, jd, jn, jk = jgen_mod._decode_loop(
            jg.params, jnp.asarray(first), jc, jk, js,
            jnp.asarray(eos, jnp.int32), jnp.asarray(limits, jnp.int32),
            jnp.zeros((1, 1), jnp.int32), jg.cfg, n_steps)
        tt, tc, td, tn, tk = tgen_mod._decode_loop(
            tg.params, torch.from_numpy(first), tc, tk, ts,
            torch.tensor(eos, dtype=torch.int32), limits, None, tg.cfg,
            n_steps)
        n = int(jn)
        assert int(tn) == n
        assert np.array_equal(tt.numpy()[:, :n], np.asarray(jt)[:, :n])
        assert td.tolist() == np.asarray(jd).tolist()
        assert _bits(tk) == np.asarray(jk).astype(np.int64).tolist()
        first = np.array(jt)[:, n - 1]
        limits = [max(x - n, 0) for x in limits]


@pytest.mark.parametrize("flash", [False, True])
def test_beam_token_equal_to_jax(engines, flash):
    jg, tg = engines("qwen3", flash)
    for K, eos in ((3, ()), (4, _eos_from(tg))):
        a = jg.generate_beam([PROMPTS[2]], num_beams=K, max_new_tokens=8,
                             eos_ids=eos, length_penalty=0.8)
        b = tg.generate_beam([PROMPTS[2]], num_beams=K, max_new_tokens=8,
                             eos_ids=eos, length_penalty=0.8)
        assert b.sequences == a.sequences and b.finished == a.finished
    # a session advanced in bounded chunks ends where the one-shot does
    st = tg.beam_start([PROMPTS[2]], num_beams=3, max_new_tokens=8)
    while not tg.beam_advance(st, max_steps=2):
        pass
    assert tg.beam_finish(st).sequences == tg.generate_beam(
        [PROMPTS[2]], num_beams=3, max_new_tokens=8).sequences


@pytest.mark.parametrize("flash", [False, True])
def test_lookahead_token_equal_to_jax_and_greedy(engines, flash):
    """Prompt-lookup speculation on a repetitive prompt emits the plain
    greedy sequence, as in JAX, streamed token by token."""
    jg, tg = engines("qwen3", flash)
    prompt = [1, 2, 3, 4] * 4 + [1, 2]
    streamed = []
    a = jg.generate_lookahead([prompt], max_new_tokens=12)
    b = tg.generate_lookahead([prompt], max_new_tokens=12,
                              stream_cb=lambda t: streamed.extend(t))
    c = tg.generate_compiled([prompt], max_new_tokens=12)
    assert b.sequences == a.sequences == c.sequences
    assert streamed == b.sequences[0]
    assert tg.last_lookahead_stats["tokens"] == 12


def test_reuse_prefix_token_equal_to_jax(engines):
    """Conversation turns with ``reuse_prefix``: each turn extends the
    last, hits the LRU and prefills only the suffix; tokens equal JAX's
    and the store holds the same keys."""
    jg, tg = engines("qwen3", False, "int8+kv")
    for g in (jg, tg):
        g._prefix_lru.clear()
    turn = list(PROMPTS[2])
    for i in range(3):
        a = jg.generate_compiled([turn], max_new_tokens=5, reuse_prefix=True)
        b = tg.generate_compiled([turn], max_new_tokens=5, reuse_prefix=True)
        assert b.sequences == a.sequences, i
        assert list(tg._prefix_lru) == list(jg._prefix_lru)
        turn = turn + b.sequences[0] + [40 + i, 41 + i]
    # a hit prefills only the suffix and matches a cold prefill
    cold = GenerationEngine(tg.cfg, tg.params, quant="int8+kv",
                            device="cpu", **ENGINE_KW)
    assert cold.generate_compiled([turn], max_new_tokens=5).sequences == \
        tg.generate_compiled([turn], max_new_tokens=5,
                             reuse_prefix=True).sequences


def test_flash_engine_prefill_matches_jax_and_counts(engines):
    """A flash engine's prefill (the plain version on the CPU) gives the
    JAX engine's last-token logits at 2e-5; every flash-routed prefill is
    counted, runs the plain version once per layer and never launches; a
    chunked prefill routes only its first chunk; the bucket-padding row
    stays finite."""
    jg, tg = engines("qwen3", True)
    jl, *_ = jg.prefill(PROMPTS)
    tatt.reset_counts()
    tg.flash_prefills = 0
    tl, cache, lens, B = tg.prefill(PROMPTS)
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3], **TOL)
    assert torch.isfinite(tl).all()
    L = tg.cfg.n_layers
    assert (tg.flash_prefills, tatt.flash_attention_ref.calls) == (1, L)
    long = list(np.random.default_rng(1).integers(0, 258, 50))
    jl, *_ = jg.prefill([long])
    tl, *_ = tg.prefill([long])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert (tg.flash_prefills, tatt.flash_attention_ref.calls) == (2, 2 * L)
    assert tatt.flash_attention.launches == 0
    tatt.reset_counts()


def test_warmup_runs_every_batch_bucket(engines):
    _, tg = engines()
    assert tg.warmup(max_new_tokens=2) >= 0.0


def test_unported_paths_are_refused(trees):
    jcfg, _, tp = trees["qwen3"]
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    for kw in (dict(mesh=object()), dict(cache_specs=object())):
        with pytest.raises(NotImplementedError, match="tensor-parallel"):
            GenerationEngine(cfg, tp, device="cpu", **kw)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="training"):
        ttr.forward(tp, toks, cfg, remat=True)
    with pytest.raises(NotImplementedError, match="training"):
        ttr.forward(tp, toks, cfg, seq_mesh=object())
    with pytest.raises(NotImplementedError, match="node/pipeline"):
        ttr.stage_forward(tp, cfg, tokens=toks)
    # MoE is ported (tests/test_torch_moe.py); loading a checkpoint
    # straight onto tensor-parallel shards is not
    from tensorlink_tpu_torch.engine.loader import load_params

    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        load_params("unused", cfg, tensor_parallel=2, device="cpu")
    with pytest.raises(ValueError, match="quant"):
        GenerationEngine(cfg, tp, device="cpu", quant="int4")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GenerationEngine(cfg, tp)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            KVCache.init(cfg, 1, max_len=8)
