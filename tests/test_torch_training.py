"""The port's training path (``engine/training.py``, ``engine/optimizers.py``,
the differentiable forward) against the JAX package and optax on the same
weights and inputs:

- ``causal_lm_loss`` and its gradients against ``jax.value_and_grad`` on
  tiny float32 llama, qwen3 (qk-norm) and Mixtral (dense dispatch), with
  and without a loss mask or an attention mask: loss within rtol 1e-6,
  each gradient leaf within rtol 1e-5 and an atol of 1e-6 times the
  leaf's largest magnitude where that exceeds 1 (Mixtral's embedding
  gradient reaches 1.26, where float32 summation order alone moves an
  entry by 1.25e-6), else 1e-6;
- ``remat`` on equals ``remat`` off, bitwise, in the port;
- each optimizer of ``make_optimizer`` against optax over 5 updates of
  seeded gradients (rtol 1e-6, atol 1e-7), the flattened states leaf for
  leaf;
- ``make_train_step`` with n_micro 1, 2 and 3 against the JAX step over 3
  steps: loss and grad_norm within rtol 1e-5; params within rtol 2e-5,
  atol 2e-6 under SGD with momentum; under AdamW each param leaf within
  2e-4 relative in its norm (the JAX end-to-end test's rtol), because
  Adam divides each update by the gradient's own magnitude: an entry
  whose gradient cancels to about eps moves by a few percent of lr on
  float32 summation order alone (2.3e-5 of lr 1e-3 here, in one
  embedding entry);
- a bfloat16 micro carry stays float32, and the ZeRO-1 paths without a
  mesh refuse with JAX's words (ZeRO-1 itself: tests/test_torch_zero1.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorlink_tpu.engine import training as jtrain
from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu.models import transformer as jtr
from tensorlink_tpu_torch.convert import (
    config_from_jax,
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
)
from tensorlink_tpu_torch.engine import optimizers as topt
from tensorlink_tpu_torch.engine import training as ttrain
from tensorlink_tpu_torch.models import transformer as ttr

# one intra-op thread: a JAX call in this process can leave torch's worker
# threads computing exp off by up to 1e-4 (tests/test_torch_flash.py)
torch.set_num_threads(1)

# tlint: disable=TL006(read-only constant table)
_BASE = dict(vocab_size=258, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, head_dim=16, d_ff=128, max_seq_len=64,
             rope_theta=1e6, dtype=jnp.float32)
# tlint: disable=TL006(read-only constant table)
FAMILIES = {
    "llama": JModelConfig(family="llama", **_BASE),
    "qwen3": JModelConfig(family="qwen3", qk_norm=True, tie_embeddings=True,
                          **_BASE),
    "mixtral": JModelConfig(family="mixtral", n_experts=4,
                            n_experts_per_tok=2, **_BASE),
}


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, jcfg in FAMILIES.items():
        jp = jax.device_get(j_init_params(jcfg, jax.random.PRNGKey(3)))
        out[name] = (jcfg, config_from_jax(dataclasses.asdict(jcfg)), jp,
                     params_from_jax(jp, device="cpu"))
    return out


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _assert_trees(got, want, leaf_scaled=False, norm_rtol=None, **tol):
    got_l = [t.detach().numpy() for t in topt.tree_leaves(got)]
    want_l = _leaves_np(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape and g.dtype == w.dtype
        if norm_rtol is not None:
            err = np.linalg.norm((g - w).ravel()) / np.linalg.norm(w.ravel())
            assert err <= norm_rtol, err
            continue
        kw = dict(tol)
        if leaf_scaled:
            kw["atol"] = tol["atol"] * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, **kw)


def _batch(rng, B=4, T=16, vocab=258):
    toks = rng.integers(0, vocab, (B, T)).astype(np.int32)
    lm = rng.random((B, T)) > 0.3
    # right padding: every query row still sees key 0, so no row's
    # softmax is over nothing
    am = np.ones((B, T), bool)
    am[1, T - 5:] = False
    am[3, T - 2:] = False
    return toks, lm, am


@pytest.mark.parametrize("mask", ["none", "loss_mask", "attn_mask"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_causal_lm_loss_and_grads_equal_jax(trees, family, mask):
    jcfg, cfg, jp, tp = trees[family]
    toks, lm, am = _batch(np.random.default_rng(11))
    lm_arg = lm if mask != "none" else None

    if mask == "attn_mask":
        lm_arg = lm & am

        def jloss(p):
            logits, _ = jtr.forward(p, jnp.asarray(toks), jcfg,
                                    attn_mask=jnp.asarray(am))
            lg = logits[:, :-1].astype(jnp.float32)
            m = jnp.asarray(lm_arg)[:, 1:]
            logz = jax.nn.logsumexp(lg, axis=-1)
            gold = jnp.take_along_axis(
                lg, jnp.asarray(toks)[:, 1:, None], axis=-1)[..., 0]
            return ((logz - gold) * m).sum() / jnp.maximum(m.sum(), 1)

        def tloss(p):
            logits, _ = ttr.forward(p, torch.as_tensor(toks), cfg,
                                    attn_mask=torch.as_tensor(am),
                                    remat=True)
            lg = logits[:, :-1].float()
            m = torch.as_tensor(lm_arg)[:, 1:]
            logz = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(
                lg, -1, torch.as_tensor(toks).long()[:, 1:, None])[..., 0]
            return ((logz - gold) * m).sum() / torch.clamp(m.sum(), min=1)
    else:
        def jloss(p):
            return jtrain.causal_lm_loss(
                p, jcfg, jnp.asarray(toks),
                None if lm_arg is None else jnp.asarray(lm_arg))[0]

        def tloss(p):
            return ttrain.causal_lm_loss(
                p, cfg, torch.as_tensor(toks),
                None if lm_arg is None else torch.as_tensor(lm_arg))[0]

    jl, jg = jax.value_and_grad(jloss)(jp)
    tree, leaves = ttrain._trainable(tp)
    tl = tloss(tree)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    _assert_trees(topt.tree_unflatten(tp, list(tg)), jg, leaf_scaled=True,
                  rtol=1e-5, atol=1e-6)


def test_remat_is_bitwise_in_the_port(trees):
    _, cfg, _, tp = trees["qwen3"]
    toks, lm, _ = _batch(np.random.default_rng(5))
    out = []
    for remat in (False, True):
        tree, leaves = ttrain._trainable(tp)
        loss, _ = ttrain.causal_lm_loss(tree, cfg, torch.as_tensor(toks),
                                        torch.as_tensor(lm), remat=remat)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def _sched(c):
    return 1e-2 / (1.0 + c)


# tlint: disable=TL006(read-only constant table)
OPTIMIZERS = {
    "adamw": ("adamw", dict(lr=1e-2, weight_decay=0.1)),
    "adam": ("adam", dict(lr=1e-2)),
    "adamw nesterov eps_root": ("adamw", dict(lr=1e-2, weight_decay=0.05,
                                              nesterov=True, eps_root=1e-8)),
    "adamw no clip": ("adamw", dict(lr=1e-2, grad_clip=None)),
    "adamw schedule": ("adamw", dict(lr=_sched, weight_decay=0.1)),
    "sgd": ("sgd", dict(lr=1e-1)),
    "sgd momentum": ("sgd", dict(lr=1e-1, momentum=0.9)),
    "sgd nesterov no clip": ("sgd", dict(lr=1e-1, momentum=0.9,
                                         nesterov=True, grad_clip=None)),
    "sgd schedule": ("sgd", dict(lr=_sched, momentum=0.5)),
    "adafactor": ("adafactor", dict(lr=1e-2)),
    "adafactor factored": ("adafactor", dict(lr=1e-2,
                                             min_dim_size_to_factor=16)),
    "adafactor momentum decay": ("adafactor", dict(
        lr=1e-2, min_dim_size_to_factor=16, momentum=0.9,
        weight_decay_rate=0.01, grad_clip=None)),
}


@pytest.mark.parametrize("case", list(OPTIMIZERS))
def test_optimizer_matches_optax(trees, case):
    name, kw = OPTIMIZERS[case]
    _, _, jp, tp = trees["llama"]
    jkw = dict(kw)
    tkw = dict(kw)
    if "momentum" in kw and name == "adafactor":
        jkw["dtype_momentum"] = jnp.float32
    jopt = jtrain.make_optimizer(name, **jkw)
    tp_opt = ttrain.make_optimizer(name, **tkw)
    jstate = jopt.init(jp)
    tstate = tp_opt.init(tp)
    jparams, tparams = jp, tp
    rng = np.random.default_rng(17)
    for _ in range(5):
        gj = jax.tree.map(
            lambda p: (rng.standard_normal(p.shape) * 0.5).astype(np.float32),
            jp)
        gt = params_from_jax(gj, device="cpu")
        ju, jstate = jopt.update(gj, jstate, jparams)
        jparams = optax.apply_updates(jparams, ju)
        tu, tstate = tp_opt.update(gt, tstate, tparams)
        tparams = topt.apply_updates(tparams, tu)
    _assert_trees(tparams, jparams, rtol=1e-6, atol=1e-7)
    # the flattened states line up leaf for leaf
    _assert_trees_state(tstate, jstate)
    # and cross over both ways
    back = opt_state_to_jax(tstate, jax.device_get(jstate))
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    moved = opt_state_from_jax(jax.device_get(jstate), device="cpu")
    assert [tuple(t.shape) for t in topt.tree_leaves(moved)] == \
        [tuple(t.shape) for t in topt.tree_leaves(tstate)]


def _assert_trees_state(tstate, jstate):
    tl = topt.tree_leaves(tstate)
    jl = _leaves_np(jstate)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        t = t.numpy()
        assert t.shape == j.shape and t.dtype == j.dtype
        if np.issubdtype(j.dtype, np.integer):
            assert np.array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)


# tlint: disable=TL006(read-only constant table)
STEP_OPTS = {
    "sgd momentum": (("sgd", dict(lr=0.1, momentum=0.9)),
                     dict(rtol=2e-5, atol=2e-6)),
    "adamw": (("adamw", dict(lr=1e-3, weight_decay=0.01)),
              dict(norm_rtol=2e-4)),
}


@pytest.mark.parametrize("opt", list(STEP_OPTS))
@pytest.mark.parametrize("n_micro", [1, 2, 3])
def test_train_step_matches_jax(trees, n_micro, opt):
    (name, kw), ptol = STEP_OPTS[opt]
    jcfg, cfg, jp, tp = trees["qwen3"]
    jts = jtrain.make_train_step(
        jcfg, jtrain.make_optimizer(name, **kw), n_micro=n_micro,
        donate=False)
    tts = ttrain.make_train_step(
        cfg, ttrain.make_optimizer(name, **kw), n_micro=n_micro)
    jstate, tstate = jts.init_state(jp), tts.init_state(tp)
    jparams, tparams = jp, tp
    rng = np.random.default_rng(29)
    for _ in range(3):
        toks, lm, _ = _batch(rng, B=6)
        jparams, jstate, jm = jts.step_fn(
            jparams, jstate,
            {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(lm)})
        tparams, tstate, tm = tts.step_fn(
            tparams, tstate,
            {"tokens": torch.as_tensor(toks), "loss_mask": torch.as_tensor(lm)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    _assert_trees(tparams, jax.device_get(jparams), **ptol)
    assert tts.n_programs() == -1


def test_bf16_micro_carry_stays_f32(trees, monkeypatch):
    jcfg, _, jp, _ = trees["llama"]
    cfg = config_from_jax(dataclasses.asdict(jcfg.with_(dtype=jnp.bfloat16)))
    tp = params_from_jax(jp, device="cpu", dtype=torch.bfloat16)
    seen = []
    inner = ttrain._accum_micro_grads

    def spy(*a):
        out = inner(*a)
        seen.append({t.dtype for t in topt.tree_leaves(out[0])})
        return out

    monkeypatch.setattr(ttrain, "_accum_micro_grads", spy)
    ts = ttrain.make_train_step(cfg, ttrain.make_optimizer("adamw", lr=1e-3),
                                n_micro=2)
    toks, _, _ = _batch(np.random.default_rng(1))
    params, state, m = ts.step_fn(tp, ts.init_state(tp),
                                  {"tokens": torch.as_tensor(toks)})
    assert seen == [{torch.float32}]
    assert np.isfinite(float(m["loss"]))
    assert {t.dtype for t in topt.tree_leaves(params)} == {torch.bfloat16}
    # the optimizer state keeps the params' dtype, as optax's does
    assert {t.dtype for t in topt.tree_leaves(state)} == \
        {torch.int32, torch.bfloat16}


def test_zero1_and_tp_axis_raise_naming_item_8(trees):
    """ZeRO-1 is ported (tests/test_torch_zero1.py): without a mesh the
    zero1 and tp_axis paths refuse with JAX's ValueErrors, as a step on a
    one-replica mesh does, and ``optimizer_state_specs`` answers a spec
    tree of the state's structure."""
    _, cfg, _, _ = trees["llama"]
    opt = ttrain.make_optimizer("adamw")
    for kw, words in ((dict(zero1=True), "requires a mesh"),
                      (dict(tp_axis="tp"), "requires zero1"),
                      (dict(zero1=True, tp_axis="tp"), "requires a mesh")):
        with pytest.raises(ValueError, match=words):
            ttrain.make_train_step(cfg, opt, **kw)
    params = {"w": torch.zeros((4, 2))}
    from tensorlink_tpu_torch.parallel.mesh import REPLICATED

    specs = ttrain.optimizer_state_specs(opt, params, {"w": REPLICATED},
                                         dp_axis="data", dp_size=2)
    assert len(topt.tree_leaves(specs)) == len(
        topt.tree_leaves(opt.init(params)))