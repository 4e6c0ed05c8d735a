"""The port's MoE (tensorlink_tpu_torch/models/transformer.py::_moe_mlp,
parallel/expert.py) against the JAX package on a 2-layer tiny Mixtral
(E = 4 experts, top-2, float32), the same seeded weights on both sides:

- ``top_k`` picks ``lax.top_k``'s experts and order, ties going to the
  lower index; ``_moe_mlp`` within rtol = atol = 2e-5 of JAX's, with a
  router tie planted (two experts with equal columns);
- ``forward`` without a cache and a prefill plus decode steps over the
  dense cache, within 2e-5 (tests/test_torch_model.py's tolerance);
- ``sparse_moe_mlp`` and ``topk_capacity_dispatch`` against JAX's: no
  drop at capacity factor E/K (and equal to the dense dispatch),
  overflow dropping the lowest-priority slots (dispatch tensors exact),
  grouped dispatch;
- ``ContinuousEngine`` streams and counters equal to the JAX engine's over
  fp, int8 and int4 pages and with weight-only int8 (the router
  quantized, the 4-D expert weights kept), solo == co-batched inside the
  port; ``GenerationEngine.generate`` tokens equal to JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.engine.continuous import ContinuousEngine as JEngine
from tensorlink_tpu.engine.generate import GenerationEngine as JGen
from tensorlink_tpu.engine.sampling import SamplingParams as JSP
from tensorlink_tpu.models import KVCache as JKVCache
from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu.models import quant as jq
from tensorlink_tpu.models import transformer as jtr
from tensorlink_tpu.parallel import expert as jex
from tensorlink_tpu_torch.convert import config_from_jax, params_from_jax
from tensorlink_tpu_torch.engine.continuous import ContinuousEngine
from tensorlink_tpu_torch.engine.generate import GenerationEngine
from tensorlink_tpu_torch.engine.sampling import SamplingParams
from tensorlink_tpu_torch.models import KVCache
from tensorlink_tpu_torch.models import quant as tq
from tensorlink_tpu_torch.models import transformer as ttr
from tensorlink_tpu_torch.parallel import expert as tex

# one intra-op thread: a JAX call in this process can leave torch's worker
# threads computing exp off by up to 1e-4 (tests/test_torch_flash.py)
torch.set_num_threads(1)
# tlint: disable=TL006(read-only constant table)
TOL = dict(rtol=2e-5, atol=2e-5)

JCFG = JModelConfig(
    family="mixtral", vocab_size=258, d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, max_seq_len=64, rope_theta=1e6,
    n_experts=4, n_experts_per_tok=2, dtype=jnp.float32,
)
# tlint: disable=TL006(read-only constant table)
ENGINE_KW = dict(max_slots=4, page_size=8, chunk_steps=4, prefill_chunk=16)
SHARED = (17, 3, 99, 42, 8, 250, 61, 5, 77, 12, 190, 33, 4, 120, 7, 88)
REQS = (
    # (prompt, budget, sampling kwargs, seed)
    ([*SHARED, 9, 9, 1, 2], 3, {}, 11),
    ([5, 6, 7, 200, 1, 1, 3], 10, dict(temperature=0.9, top_p=0.9), 12),
    (list(range(30, 42)), 8, dict(temperature=0.7, top_k=10,
                                  presence_penalty=0.5,
                                  frequency_penalty=0.2), 13),
    ([*SHARED, 250, 4, 4, 8, 16, 23], 8, {}, 14),  # shares 2 pages
)


@pytest.fixture(scope="module")
def trees():
    jp = jax.device_get(j_init_params(JCFG, jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp, device="cpu")


def _cfg(jcfg=JCFG):
    return config_from_jax(dataclasses.asdict(jcfg))


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def test_top_k_breaks_ties_like_lax():
    rng = np.random.default_rng(0)
    x = rng.integers(-3, 4, size=(6, 5, 8)).astype(np.float32)  # many ties
    for k in (1, 2, 3, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = ttr.top_k(torch.from_numpy(x), k)
        assert np.array_equal(tv.numpy(), np.asarray(jv))
        assert np.array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("tie", [False, True], ids=["plain", "tie"])
@pytest.mark.parametrize("layer", [0, 1])
def test_moe_mlp_matches_jax(trees, layer, tie):
    jp, _ = trees
    lp = {k: np.array(v) for k, v in _layer(jp["layers"]["mlp"],
                                            layer).items()}
    x = np.random.default_rng(layer + 1).normal(size=(3, 7, 64))
    x = x.astype(np.float32)
    if tie:
        # expert 2's router column equals expert 0's: every token's two
        # logits tie exactly, so the pick rests on the tie rule alone
        lp["router"][:, 2] = lp["router"][:, 0]
        logits = x @ lp["router"]
        top = np.argsort(-logits, axis=-1, kind="stable")[..., :2]
        has0, has2 = (top == 0).any(-1), (top == 2).any(-1)
        assert not (has2 & ~has0).any()
        assert (has0 & ~has2).any()  # the tie decided some tokens' pick
    want = np.asarray(jtr._moe_mlp(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in lp.items()}, JCFG))
    got = ttr._moe_mlp(torch.from_numpy(x),
                       {k: torch.from_numpy(v) for k, v in lp.items()},
                       _cfg())
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # _mlp routes a MoE config to it
    np.testing.assert_allclose(
        ttr._mlp(torch.from_numpy(x),
                 {k: torch.from_numpy(v) for k, v in lp.items()},
                 _cfg()).numpy(), want, **TOL)


def test_forward_prefill_and_decode_match_jax(trees):
    jp, tp = trees
    cfg = _cfg()
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 258, size=(2, 8)).astype(np.int32)
    mask = np.ones((2, 8), bool)
    mask[1, 5:] = False
    jl, _ = jtr.forward(jp, jnp.asarray(toks), JCFG)
    tl, _ = ttr.forward(tp, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jc = JKVCache.init(JCFG, 2, max_len=16)
    tc = KVCache.init(cfg, 2, max_len=16, device="cpu")
    steps = [(toks, mask)] + [
        (rng.integers(0, 258, size=(2, 1)).astype(np.int32), None)
        for _ in range(3)]
    for t, m in steps:
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.from_numpy(m)
        jl, jc = jtr.forward(jp, jnp.asarray(t), JCFG, cache=jc, attn_mask=jm)
        tl, tc = ttr.forward(tp, torch.from_numpy(t), cfg, cache=tc,
                             attn_mask=tm)
        valid = np.ones(jl.shape[:2], bool) if m is None else m
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                                   **TOL)
        assert tc.length.tolist() == np.asarray(jc.length).tolist()


@pytest.mark.parametrize("min_size", [0, 1 << 16])
def test_weight_quant_and_config_carry_moe_like_jax(trees, min_size):
    """Weight-only int8 quantizes the same leaves as JAX's
    ``quantize_params`` (2-D/3-D matmul weights over ``min_size``: the
    router, never the 4-D expert weights) to the same codes and scales;
    ``config_from_jax`` carries every MoE field."""
    jp, tp = trees
    jqt = jax.device_get(jq.quantize_params(jax.tree.map(jnp.asarray, jp),
                                            min_size=min_size))
    tqt = tq.quantize_params(tp, min_size=min_size)
    for name in ("router", "w_gate", "w_up", "w_down"):
        j, t = jqt["layers"]["mlp"][name], tqt["layers"]["mlp"][name]
        assert isinstance(t, tq.QTensor) == hasattr(j, "q"), name
        if isinstance(t, tq.QTensor):
            assert np.array_equal(t.q.numpy(), np.asarray(j.q)), name
            assert np.array_equal(t.scale.numpy(), np.asarray(j.scale))
    assert isinstance(tqt["layers"]["mlp"]["router"], tq.QTensor) == \
        (min_size == 0)
    jcfg = JCFG.with_(moe_dispatch="sparse", moe_capacity_factor=1.5,
                      moe_group_size=64, n_experts_per_tok=1)
    cfg = _cfg(jcfg)
    for f in ("n_experts", "n_experts_per_tok", "moe_dispatch",
              "moe_capacity_factor", "moe_group_size"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.moe and cfg.param_count() == jcfg.param_count()


# -- sparse dispatch -------------------------------------------------------
def test_capacity_and_groups_equal_jax():
    for n in (1, 7, 64, 1000):
        for cf in (0.25, 1.0, 2.0, 4.0):
            assert tex.expert_capacity(n, 4, 2, cf) == \
                jex.expert_capacity(n, 4, 2, cf)
    for S in (1, 7, 12, 64, 1024, 3000):
        for gs in (0, 1, 5, 16, 1024):
            assert tex._n_groups(S, gs) == jex._n_groups(S, gs)


@pytest.mark.parametrize("k,capacity", [(2, 8), (2, 3), (1, 2), (3, 1)])
def test_capacity_dispatch_equals_jax(k, capacity):
    """Dispatch and combine tensors exact against JAX's, through overflow:
    rank-0 choices claim slots before rank-1, so a full expert drops the
    lower-weighted assignments first."""
    x = np.random.default_rng(k * 10 + capacity).normal(size=(8, 4))
    x = x.astype(np.float32)
    jd, jc = jex.topk_capacity_dispatch(jnp.asarray(x), k, capacity)
    td, tc = tex.topk_capacity_dispatch(torch.from_numpy(x), k, capacity)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=0)
    if capacity < 8:
        assert td.sum() < 8 * k  # something dropped
        kept0 = td.numpy().sum(axis=(1, 2))
        top0 = np.argmax(x, axis=-1)
        per_expert = np.bincount(top0, minlength=4)
        # every rank-0 choice into an expert with room was kept
        for s in range(8):
            if per_expert[top0[s]] <= capacity:
                assert kept0[s] >= 1


@pytest.mark.parametrize("case", ["no-drop", "overflow", "grouped"])
def test_sparse_moe_matches_jax(trees, case):
    jp, _ = trees
    lp = _layer(jp["layers"]["mlp"], 1)
    x = np.random.default_rng(7).normal(size=(2, 12, 64)).astype(np.float32)
    jcfg = JCFG.with_(moe_dispatch="sparse")
    cf = {"no-drop": 4 / 2, "overflow": 0.5, "grouped": 1.0}[case]
    if case == "grouped":
        jcfg = jcfg.with_(moe_group_size=6)  # 4 groups of 6 tokens
    want = np.asarray(jex.sparse_moe_mlp(
        jnp.asarray(x), jax.tree.map(jnp.asarray, lp), jcfg,
        capacity_factor=cf))
    tlp = {k: torch.from_numpy(np.array(v)) for k, v in lp.items()}
    got = tex.sparse_moe_mlp(torch.from_numpy(x), tlp, _cfg(jcfg),
                             capacity_factor=cf).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    dense = ttr._moe_mlp(torch.from_numpy(x), tlp, _cfg()).numpy()
    if case == "no-drop":
        np.testing.assert_allclose(got, dense, **TOL)
        # the config's own dispatch switch reaches the same function
        np.testing.assert_allclose(
            ttr._moe_mlp(torch.from_numpy(x), tlp,
                         _cfg(jcfg.with_(moe_capacity_factor=cf))).numpy(),
            got, rtol=0, atol=0)
    elif case == "overflow":
        assert np.abs(got - dense).max() > 1e-3  # tokens really dropped


# -- the engines -----------------------------------------------------------
@pytest.fixture(scope="module")
def gens(trees):
    """``gens(weights)``: a JAX and a port GenerationEngine over the same
    tree, plain or weight-only int8 (every 2-D/3-D matmul weight, the
    router included; the 4-D expert weights stay float in both)."""
    jp, _ = trees
    built = {}

    def get(weights="none"):
        if weights not in built:
            jtree = jp
            if weights == "int8":
                jtree = jax.device_get(jq.quantize_params(
                    jax.tree.map(jnp.asarray, jp), min_size=0))
            tparams = params_from_jax(jtree, device="cpu")
            if weights == "int8":
                mlp = tparams["layers"]["mlp"]
                assert isinstance(mlp["router"], tq.QTensor)
                assert not isinstance(mlp["w_gate"], tq.QTensor)
                assert mlp["w_gate"].ndim == 4
                assert tq.quantize_params(params_from_jax(jp, device="cpu"),
                                          min_size=0)["layers"]["mlp"][
                    "w_up"].ndim == 4
            kw = dict(seq_buckets=(8, 32), batch_buckets=(1, 2, 4),
                      max_seq_len=64)
            built[weights] = (
                JGen(JCFG, jax.tree.map(jnp.asarray, jtree), **kw),
                GenerationEngine(_cfg(), tparams, device="cpu", **kw),
            )
        return built[weights]

    return get


def _serve(eng_cls, gen, sp_cls, reqs, **kw):
    """Submit all but the last request, step twice, submit the last one
    mid-flight, drain."""
    ce = eng_cls(gen, **{**ENGINE_KW, **kw})
    out = [ce.submit(p, max_new_tokens=n, sampling=sp_cls.make(**s), seed=sd)
           for p, n, s, sd in reqs[:-1]]
    ce.step_chunk()
    ce.step_chunk()
    p, n, s, sd = reqs[-1]
    out.append(ce.submit(p, max_new_tokens=n, sampling=sp_cls.make(**s),
                         seed=sd))
    ce.run_until_idle()
    assert all(r.finished and r.error is None for r in out)
    return ce, [list(r.tokens) for r in out]


@pytest.mark.parametrize("kv_quant,weights", [
    ("none", "none"), ("int8", "none"), ("int4", "none"), ("none", "int8"),
])
def test_continuous_engine_streams_equal_jax(gens, kv_quant, weights):
    jgen, tgen = gens(weights)
    jce, jstreams = _serve(JEngine, jgen, JSP, REQS, kv_quant=kv_quant)
    tce, tstreams = _serve(ContinuousEngine, tgen, SamplingParams, REQS,
                           kv_quant=kv_quant)
    assert tstreams == jstreams
    assert [len(s) for s in tstreams] == [3, 10, 8, 8]
    assert tce.stats["prefill_tokens_skipped"] > 0
    for key in tce.stats:
        assert tce.stats[key] == jce.stats[key], key
    assert tce.alloc._free == jce.alloc._free
    assert tce.prefix.digest() == jce.prefix.digest()
    tsnap, jsnap = tce.serving_snapshot(), jce.serving_snapshot()
    for key in ("kv_quant", "weight_quant", "kv_page_bytes"):
        assert tsnap[key] == jsnap[key], key
    tce.check_page_conservation()
    # inside the port: each request served alone equals its co-batched run
    for req, want in zip(REQS, tstreams):
        solo = ContinuousEngine(tgen, **{**ENGINE_KW, "kv_quant": kv_quant})
        p, n, s, sd = req
        r = solo.submit(p, max_new_tokens=n,
                        sampling=SamplingParams.make(**s), seed=sd)
        solo.run_until_idle()
        assert list(r.tokens) == want
        solo.close()
    tce.close()


def test_generate_token_equal_to_jax(gens):
    jgen, tgen = gens()
    prompts = ([5, 7, 9, 11, 13], [1, 2, 3],
               [100, 101, 102, 103, 104, 105, 106, 107, 108, 109, 110])
    knobs = ({}, {"temperature": 0.8, "top_k": 20},
             {"temperature": 1.0, "top_p": 0.9, "presence_penalty": 0.5})
    js = JSP.stack([JSP.make(**k) for k in knobs], pad_to=3)
    ts = SamplingParams.stack([SamplingParams.make(**k) for k in knobs],
                              pad_to=3)
    kw = dict(max_new_tokens=10, seed=5, budgets=[10, 10, 6])
    a = jgen.generate(prompts, sampling=js, **kw)
    b = tgen.generate(prompts, sampling=ts, **kw)
    assert b.sequences == a.sequences and b.finished == a.finished
    a = jgen.generate_compiled(prompts, sampling=js, **kw)
    b = tgen.generate_compiled(prompts, sampling=ts, **kw)
    assert b.sequences == a.sequences
