"""Pipeline stages of the port (tensorlink_tpu_torch/models/transformer.py::
stage_forward, head_forward, slice_stage_params) against the JAX package's
on the same weights and inputs, in float32 at rtol = atol = 2e-5.

The scenarios are tests/test_stages.py's:

- two stages chained, tied and untied heads: the JAX chain's logits;
- a tied head on stage 0: the last stage returns hidden states and
  ``head_forward`` on stage 0 finishes (the head hop);
- per-stage session caches through a prefill and three greedy decode
  steps, with fp and int8 (``cache_quant``) caches sized to each slice:
  every step's logits, the greedy tokens, and the caches' rows and
  lengths;
- a middle stage of three, fed hidden states and giving hidden states;
- ring attention (``seq_mesh``) runs, and what JAX refuses with it raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.models import KVCache as JKVCache
from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu.models import transformer as jtr
from tensorlink_tpu_torch.convert import config_from_jax, params_from_jax
from tensorlink_tpu_torch.models import KVCache
from tensorlink_tpu_torch.models import transformer as ttr

torch.set_num_threads(1)
# tlint: disable=TL006(read-only constant table)
TOL = dict(rtol=2e-5, atol=2e-5)


def _cfgs(**kw):
    base = dict(family="llama", vocab_size=128, d_model=32, n_layers=4,
                n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, max_seq_len=64,
                dtype=jnp.float32)
    base.update(kw)
    jcfg = JModelConfig(**base)
    return jcfg, config_from_jax(dataclasses.asdict(jcfg))


def _trees(jcfg, seed=0):
    jp = jax.device_get(j_init_params(jcfg, jax.random.PRNGKey(seed)))
    return jp, params_from_jax(jp, device="cpu")


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _stage(pkg, tree, lo, hi, first, head):
    mod = jtr if pkg == "jax" else ttr
    return mod.slice_stage_params(tree, lo, hi, first=first, holds_head=head)


@pytest.mark.parametrize("tie", [True, False])
def test_stage_chain_matches_jax(tie):
    jcfg, cfg = _cfgs(tie_embeddings=tie)
    jp, tp = _trees(jcfg)
    toks = _tokens((2, 10), jcfg.vocab_size)
    outs = {}
    for pkg, mod, c, tree, x in (("jax", jtr, jcfg, jp, jnp.asarray(toks)),
                                 ("port", ttr, cfg, tp, torch.as_tensor(toks))):
        s0 = _stage(pkg, tree, 0, 2, True, False)
        s1 = _stage(pkg, tree, 2, 4, False, True)
        h, _ = mod.stage_forward(s0, c, tokens=x, first=True)
        out, _ = mod.stage_forward(s1, c, hidden=h, last=True)
        outs[pkg] = (_np(h), _np(out))
    np.testing.assert_allclose(outs["port"][0], outs["jax"][0], **TOL)
    np.testing.assert_allclose(outs["port"][1], outs["jax"][1], **TOL)
    want, _ = ttr.forward(tp, torch.as_tensor(toks), cfg)
    np.testing.assert_allclose(outs["port"][1], want.numpy(), **TOL)


def test_tied_head_hop_matches_jax():
    jcfg, cfg = _cfgs(tie_embeddings=True)
    jp, tp = _trees(jcfg)
    toks = _tokens((1, 7), jcfg.vocab_size)
    outs = {}
    for pkg, mod, c, tree, x in (("jax", jtr, jcfg, jp, jnp.asarray(toks)),
                                 ("port", ttr, cfg, tp, torch.as_tensor(toks))):
        s0 = _stage(pkg, tree, 0, 2, True, True)  # holds the tied head
        s1 = _stage(pkg, tree, 2, 4, False, False)
        h, _ = mod.stage_forward(s0, c, tokens=x, first=True)
        h, _ = mod.stage_forward(s1, c, hidden=h)
        outs[pkg] = _np(mod.head_forward(s0, h, c))
    assert set(_stage("port", tp, 2, 4, False, False)) == {"layers"}
    np.testing.assert_allclose(outs["port"], outs["jax"], **TOL)


def test_middle_stage_hidden_in_hidden_out():
    jcfg, cfg = _cfgs(n_layers=6)
    jp, tp = _trees(jcfg, seed=3)
    toks = _tokens((2, 9), jcfg.vocab_size, seed=4)
    am = np.ones(toks.shape, bool)
    am[1, 6:] = False
    jh, _ = jtr.stage_forward(_stage("jax", jp, 0, 2, True, False), jcfg,
                              tokens=jnp.asarray(toks), first=True,
                              attn_mask=jnp.asarray(am))
    jmid, _ = jtr.stage_forward(_stage("jax", jp, 2, 4, False, False), jcfg,
                                hidden=jh, attn_mask=jnp.asarray(am))
    mid, _ = ttr.stage_forward(_stage("port", tp, 2, 4, False, False), cfg,
                               hidden=torch.as_tensor(np.array(jh)),
                               attn_mask=torch.as_tensor(am))
    np.testing.assert_allclose(mid.numpy(), np.asarray(jmid), **TOL)


def _staged_decode(pkg, jcfg, cfg, tree, toks, quantized, steps=3):
    """Prefill + greedy decode steps through two stages, each with its own
    session cache sized to its slice: each step's logits and the caches."""
    mod = jtr if pkg == "jax" else ttr
    c = jcfg if pkg == "jax" else cfg
    bounds = [(0, 2, True, False), (2, 4, False, True)]
    stages = [_stage(pkg, tree, lo, hi, f, h) for lo, hi, f, h in bounds]
    if pkg == "jax":
        caches = [JKVCache.init(jcfg.with_(n_layers=hi - lo), 1, max_len=16,
                                quantized=quantized)
                  for lo, hi, _, _ in bounds]
        asarr = jnp.asarray
    else:
        caches = [KVCache.init(cfg.with_(n_layers=hi - lo), 1, max_len=16,
                               quantized=quantized, device="cpu")
                  for lo, hi, _, _ in bounds]
        asarr = torch.as_tensor

    def step(x):
        for i, (_lo, _hi, f, h) in enumerate(bounds):
            kw = {"tokens": x} if f else {"hidden": x}
            x, caches[i] = mod.stage_forward(stages[i], c, cache=caches[i],
                                             first=f, last=h, **kw)
        return _np(x)

    logits = [step(asarr(toks))]
    for _ in range(steps):
        tok = logits[-1][:, -1].argmax(-1).astype(np.int32)
        logits.append(step(asarr(tok[:, None])))
    return logits, caches


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
def test_stage_chain_decode_with_session_cache(quantized):
    jcfg, cfg = _cfgs()
    jp, tp = _trees(jcfg)
    toks = _tokens((1, 5), jcfg.vocab_size)
    jl, jc = _staged_decode("jax", jcfg, cfg, jp, toks, quantized)
    tl, tc = _staged_decode("port", jcfg, cfg, tp, toks, quantized)
    for a, b in zip(tl, jl, strict=True):
        np.testing.assert_allclose(a, b, **TOL)
        assert a[:, -1].argmax(-1) == b[:, -1].argmax(-1)
    for a, b in zip(tc, jc, strict=True):
        assert a.k.shape[0] == 2 and a.length.tolist() == \
            np.asarray(b.length).tolist() == [8]
        if quantized:
            # codes from equal inputs match to one level; scales at 2e-5
            assert np.abs(a.k.numpy().astype(int)
                          - np.asarray(b.k).astype(int)).max() <= 1
            np.testing.assert_allclose(a.k_scale.numpy(),
                                       np.asarray(b.k_scale), **TOL)
        else:
            np.testing.assert_allclose(a.k.numpy(), np.asarray(b.k), **TOL)
            np.testing.assert_allclose(a.v.numpy(), np.asarray(b.v), **TOL)
    # the whole-model cached prefill gives the first stage chain's logits
    full = KVCache.init(cfg, 1, max_len=16, quantized=quantized, device="cpu")
    lg, full = ttr.forward(tp, torch.as_tensor(toks), cfg, cache=full)
    np.testing.assert_allclose(lg.numpy(), tl[0], **TOL)


def test_ring_attention_still_raises():
    """Ring attention is ported (ROADMAP queue 1 item 5): a stage's
    ``seq_mesh`` forward equals JAX's unsharded stage within 3e-5
    (tests/test_product_parallel.py's bound), and what JAX refuses — a
    KV cache, a padding mask, a sliding window — still raises, as a
    ValueError."""
    from tensorlink_tpu_torch.parallel.mesh import build_mesh

    jcfg, cfg = _cfgs()
    jp, tp = _trees(jcfg)
    toks = _tokens((2, 8), jcfg.vocab_size, seed=5)
    seq = build_mesh({"seq": 2}, ["cpu"] * 2)
    want, _ = jtr.stage_forward(jp, jcfg, tokens=jnp.asarray(toks),
                                first=True, last=True)
    got, _ = ttr.stage_forward(tp, cfg, tokens=torch.as_tensor(toks),
                               first=True, last=True, seq_mesh=seq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)
    t = torch.as_tensor(toks)
    cache = KVCache.init(cfg, 2, max_len=16, device="cpu")
    for kw, words in ((dict(cache=cache), "KV cache"),
                      (dict(attn_mask=torch.ones(2, 8, dtype=torch.bool)),
                       "padding masks")):
        with pytest.raises(ValueError, match=words):
            ttr.stage_forward(tp, cfg, tokens=t, first=True, last=True,
                              seq_mesh=seq, **kw)
    with pytest.raises(ValueError, match="sliding windows"):
        ttr.stage_forward(tp, cfg.with_(sliding_window=4), tokens=t,
                          first=True, last=True, seq_mesh=seq)
