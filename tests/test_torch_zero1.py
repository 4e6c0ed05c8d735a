"""The port's ZeRO-1 step (``engine/training.py`` ``make_train_step(zero1=
True[, tp_axis=])``, ``optimizer_state_specs``, ``sharded_update``) and
the planner's zero1 routing, mirroring tests/test_zero1.py and
tests/test_tp.py:219-287 on the same numpy-seeded weights and batches.

The port's replicas lie on the CPU (``[cpu] * dp``), JAX's on the
conftest's virtual host devices. Held here:

- ``dp=2`` zero1 is bitwise the port's unsharded ``n_micro=2`` step over
  three steps — loss, grad norm and every param leaf — with and without
  a loss mask: replica 0's micro-batch sum plus replica 1's, in that
  order, is the unsharded carry's own additions, and the inner update is
  elementwise on each replica's slice;
- the zero1 x tp step on a ``(dp 2, tp 2)`` mesh is bitwise the same
  unsharded step, hands the params back as their serving shards, and
  keeps every state leaf whose leading dim divides 4 at 1/4 per device;
- against JAX: loss and grad norm within rtol 1e-5, each param leaf
  within 2e-4 in its norm (the cross-package AdamW bound of
  tests/test_torch_training.py: an entry whose gradient cancels to about
  eps moves by a few percent of lr on float32 summation order alone) of
  JAX's unsharded ``n_micro == dp`` step, which JAX pins bitwise to its
  zero1 step. JAX's zero1 step itself does not trace under the installed
  jax (its shard_map scan carry's varying axes differ: a TypeError, as
  tests/test_zero1.py's slow tests fail here too), so it is not run;
- per-replica optimizer bytes at 1/dp; the step compiles nothing (the
  JAX compile guard's probe answers -1 in eager PyTorch, every step);
  bf16 params train and keep their dtype;
- JAX's refusals word for word; the spec cases of
  ``optimizer_state_specs`` (mirroring, masked, chained, empty, no dp
  axis, the unique same-shape twin); ``training_update_mode``, the
  plan's zero1 and n_micro, and the capacity model's optimizer share.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tensorlink_tpu.engine import training as jtrain
from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu.parallel.mesh import build_mesh as j_build_mesh
from tensorlink_tpu_torch.convert import config_from_jax, params_from_jax
from tensorlink_tpu_torch.engine import optimizers as topt
from tensorlink_tpu_torch.engine.training import (
    ChainedOptimizer,
    make_optimizer,
    make_train_step,
    optimizer_state_specs,
)
from tensorlink_tpu_torch.models.transformer import tp_partition_specs
from tensorlink_tpu_torch.parallel import mesh as tmesh
from tensorlink_tpu_torch.parallel.mesh import REPLICATED, Split
from tensorlink_tpu_torch.parallel.planner import (
    MemoryEstimate,
    ShardingPlan,
    WorkerCapacity,
    _per_device_bytes,
    plan_sharding,
    training_update_mode,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
JTINY = JModelConfig(
    family="llama", vocab_size=64, d_model=32, n_layers=4, n_heads=4,
    n_kv_heads=2, head_dim=8, d_ff=64, max_seq_len=32, dtype=jnp.float32,
)
TINY = config_from_jax(dataclasses.asdict(JTINY))


def _mesh(dp: int):
    return tmesh.build_mesh({"data": dp}, [CPU] * dp)


def _batch(B=4, T=16, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, JTINY.vocab_size, (B, T)).astype(
        np.int32)}
    if masked:
        m = np.ones((B, T), bool)
        m[:, T // 2:] = rng.integers(0, 2, (B, T - T // 2)).astype(bool)
        out["loss_mask"] = m
    return out


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def trees():
    jp = j_init_params(JTINY, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        topt.tree_leaves(a), topt.tree_leaves(b), strict=True))


def _near_jax(got: dict, want) -> None:
    for a, b in zip(topt.tree_leaves(got), jax.tree.leaves(want),
                    strict=True):
        a, b = a.numpy(), np.asarray(b)
        assert np.linalg.norm(a - b) <= 2e-4 * np.linalg.norm(b)


# -- the bitwise pin ---------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_zero1_step_bitwise_identical_to_unsharded(trees, masked):
    """dp=2 zero1 == n_micro=2 unsharded, bit for bit, over three steps
    (grad_clip active, so the clip runs on the whole gradient), and
    within the cross-package bound of JAX's n_micro=2 step."""
    jp, params = trees
    opt = make_optimizer("adamw", lr=5e-3, grad_clip=1.0)
    base = make_train_step(TINY, opt, n_micro=2)
    z1 = make_train_step(TINY, opt, n_micro=2, zero1=True, mesh=_mesh(2))
    assert z1.mode == "zero1" and base.mode == "unsharded"
    jopt = jtrain.make_optimizer("adamw", lr=5e-3, grad_clip=1.0)
    jz = jtrain.make_train_step(JTINY, jopt, n_micro=2, donate=False)
    p1, s1 = params, base.init_state(params)
    p2, s2 = params, z1.init_state(params)
    p3, s3 = jp, jz.init_state(jp)
    for i in range(3):
        batch = _batch(seed=i, masked=masked)
        p1, s1, m1 = base.step_fn(p1, s1, _t(batch))
        p2, s2, m2 = z1.step_fn(p2, s2, _t(batch))
        p3, s3, m3 = jz.step_fn(p3, s3, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        assert float(m1["loss"]) == float(m2["loss"]), i
        assert float(m1["grad_norm"]) == float(m2["grad_norm"]), i
        np.testing.assert_allclose(float(m2["loss"]), float(m3["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m2["grad_norm"]),
                                   float(m3["grad_norm"]), rtol=1e-5)
    assert _equal(p1, p2), "zero1 params diverged from unsharded"
    _near_jax(p2, jax.device_get(p3))


def test_zero1_opt_state_bytes_one_over_dp(trees):
    """Each replica holds about 1/dp of the state bytes (the step counts
    replicate): every leaf whose leading dim divides dp at exactly 1/dp."""
    dp = 2
    _, params = trees
    z1 = make_train_step(TINY, make_optimizer("adamw", lr=1e-3),
                         n_micro=dp, zero1=True, mesh=_mesh(dp))
    state = z1.init_state(params)
    full = sum(t.numel() * t.element_size()
               for t in topt.tree_leaves(tmesh.full_tree(state)))
    for j in range(dp):
        assert tmesh.shard_bytes(state, j) / full <= 1.0 / dp + 0.05
    for leaf in topt.tree_leaves(state):
        n = leaf.shape.numel()
        if leaf.shape and leaf.shape[0] % dp == 0:
            assert leaf.shards[0].numel() * dp == n, leaf
        else:
            assert leaf.shards[0].numel() == n, leaf


def test_zero1_compile_set_is_bounded(trees):
    """The JAX guard pins at most two compiled programs; the eager port
    compiles none, and its probe answers -1 before and after steps."""
    _, params = trees
    z1 = make_train_step(TINY, make_optimizer("adamw", lr=1e-3), n_micro=2,
                         zero1=True, mesh=_mesh(2))
    assert z1.n_programs() == -1
    p, s = params, z1.init_state(params)
    for i in range(2):
        p, s, _ = z1.step_fn(p, s, _t(_batch(seed=i)))
    assert z1.n_programs() == -1


def test_zero1_bf16_params_train(trees):
    """bf16 params through the zero1 step: finite, descending, dtype kept
    (the float32 carry under the dp split)."""
    _, params = trees
    cfg = TINY.with_(dtype=torch.bfloat16)
    p = topt.tree_map(lambda t: t.to(torch.bfloat16), params)
    z1 = make_train_step(cfg, make_optimizer("adamw", lr=5e-3), n_micro=2,
                         zero1=True, mesh=_mesh(2))
    s = z1.init_state(p)
    losses = []
    for _ in range(6):
        p, s, m = z1.step_fn(p, s, _t(_batch(seed=0)))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert {t.dtype for t in topt.tree_leaves(p)} == {torch.bfloat16}


# -- zero1 x tp --------------------------------------------------------------
def test_zero1_tp_train_step_bitwise(trees):
    """tests/test_tp.py:219: on a ``(dp 2, tp 2)`` mesh with n_micro ==
    dp, two zero1 x tp steps are bitwise the unsharded step's (loss,
    grad norm, every param), the params keep their serving shards, and
    every state leaf whose leading dim divides dp·tp holds exactly
    1/(dp·tp) of it per device; JAX's n_micro=2 step within the
    cross-package bound."""
    jp, params = trees
    batch = {"tokens": np.random.RandomState(0).randint(
        1, 63, size=(4, 16)).astype(np.int32)}
    opt = make_optimizer("adamw", lr=1e-3, grad_clip=1.0)
    ref = make_train_step(TINY, opt, n_micro=2, remat=False)
    rp, rs = params, ref.init_state(params)
    for _ in range(2):
        rp, rs, rm = ref.step_fn(rp, rs, _t(batch))
    mesh = tmesh.serving_mesh(2, dp=2, devices=[CPU] * 4)
    ts = make_train_step(TINY, opt, n_micro=2, remat=False, zero1=True,
                         mesh=mesh, dp_axis="data", tp_axis="tp")
    tp_params = tmesh.put(mesh, params, tp_partition_specs(TINY))
    p, s = tp_params, ts.init_state(tp_params)
    for _ in range(2):
        p, s, m = ts.step_fn(p, s, _t(batch))
    assert float(m["loss"]) == float(rm["loss"])
    assert float(m["grad_norm"]) == float(rm["grad_norm"])
    assert _equal(tmesh.full_tree(p), rp)
    wq = p["layers"]["attn"]["wq"]
    assert isinstance(wq, tmesh.Sharded) and wq.spec == Split(2, "tp")
    world = 4
    for leaf in topt.tree_leaves(s):
        n = leaf.shape.numel()
        shape = tuple(leaf.shape)
        if shape and shape[0] >= world and shape[0] % world == 0:
            assert leaf.shards[0].numel() * world == n, shape
        else:
            assert leaf.shards[0].numel() == n, shape
    jts = jtrain.make_train_step(
        JTINY, jtrain.make_optimizer("adamw", lr=1e-3, grad_clip=1.0),
        n_micro=2, remat=False, donate=False)
    jpp, js = jp, jts.init_state(jp)
    for _ in range(2):
        jpp, js, jm = jts.step_fn(jpp, js, {"tokens": jnp.asarray(
            batch["tokens"])})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    _near_jax(tmesh.full_tree(p), jax.device_get(jpp))


def test_tp_axis_requires_zero1():
    opt = make_optimizer("adamw", lr=1e-3)
    mesh = tmesh.serving_mesh(2, dp=2, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="zero1"):
        make_train_step(TINY, opt, tp_axis="tp", mesh=mesh)


# -- refusals + factory metadata ---------------------------------------------
def _message(fn, *args, **kw) -> str:
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


# tlint: disable=TL006(read-only test data)
REFUSALS = {
    "no mesh": dict(n_micro=2, zero1=True, mesh=None),
    "n_micro": dict(n_micro=3, zero1=True, dp=2),
    "dp 1": dict(n_micro=1, zero1=True, dp=1),
    "no dp axis": dict(n_micro=2, zero1=True, dp=2, dp_axis="batch"),
    "adafactor": dict(n_micro=2, zero1=True, dp=2, opt="adafactor"),
    "tp without mesh": dict(n_micro=2, zero1=True, mesh=None,
                            tp_axis="tp"),
    "tp axis missing": dict(n_micro=2, zero1=True, dp=2, tp_axis="tp"),
    "tp without zero1": dict(n_micro=2, dp=2, tp_axis="data"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_zero1_refusals_word_for_word(case):
    """JAX's refusals, word for word (tests/test_zero1.py:159)."""
    kw = dict(REFUSALS[case])
    name = kw.pop("opt", "adamw")
    dp = kw.pop("dp", None)
    got = _message(make_train_step, TINY, make_optimizer(name, lr=1e-3),
                   mesh=_mesh(dp) if dp else None,
                   **{k: v for k, v in kw.items() if k != "mesh"})
    want = _message(jtrain.make_train_step, JTINY,
                    jtrain.make_optimizer(name, lr=1e-3),
                    mesh=(j_build_mesh({"data": dp}, jax.devices("cpu")[:dp])
                          if dp else None),
                    **{k: v for k, v in kw.items() if k != "mesh"})
    assert got == want.replace("OrderedDict(", "").replace(")", "") \
        or got == want


def test_make_optimizer_carries_chain_metadata():
    opt = make_optimizer("adamw", lr=1e-3, grad_clip=0.5)
    assert isinstance(opt, ChainedOptimizer)
    assert opt.grad_clip == 0.5 and opt.name == "adamw"
    params = {"w": torch.ones((4, 2))}
    state = opt.init(params)
    updates, _ = opt.update(topt.tree_map(torch.ones_like, params), state,
                            params)
    assert set(updates) == {"w"}
    inner_state = opt.inner.init(params)
    assert len(topt.tree_leaves(state[1])) == len(
        topt.tree_leaves(inner_state))
    assert make_optimizer("sgd", lr=1e-3, grad_clip=None).grad_clip is None


# -- optimizer_state_specs ---------------------------------------------------
def _params():
    return {"big": torch.zeros((8, 4)), "odd": torch.zeros((3,)),
            "scalar": torch.zeros(())}


def _jparams():
    return {"big": jnp.zeros((8, 4)), "odd": jnp.zeros((3,)),
            "scalar": jnp.zeros(())}


def _rep(params):
    return topt.tree_map(lambda _: REPLICATED, params)


def _flat(specs) -> list:
    return [s for s in topt.tree_leaves(specs)]


def _jflat(specs) -> list:
    return jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))


def _as_jax(sp: Split, ndim: int) -> tuple:
    return sp.parts(ndim)


def _same(port_specs, state, jax_specs) -> None:
    """Leaf for leaf, the port's spec splits what JAX's does."""
    shapes = [tuple(t.shape) for t in topt.tree_leaves(state)]
    jl = _jflat(jax_specs)
    pl = _flat(port_specs)
    assert len(pl) == len(jl) == len(shapes)
    for a, b, shp in zip(pl, jl, shapes):
        t = tuple(b)
        assert a.parts(len(shp)) == t + (None,) * (len(shp) - len(t))


def test_specs_mirror_subtree_gets_dp_axis():
    opt, jopt = (make_optimizer("adamw", lr=1e-3),
                 jtrain.make_optimizer("adamw", lr=1e-3))
    specs = optimizer_state_specs(opt, _params(), _rep(_params()),
                                  dp_axis="data", dp_size=4)
    jspecs = jtrain.optimizer_state_specs(
        jopt, _jparams(), jax.tree.map(lambda _: P(), _jparams()),
        dp_axis="data", dp_size=4)
    _same(specs, opt.init(_params()), jspecs)
    assert Split(0, "data") in _flat(specs) and REPLICATED in _flat(specs)


def test_specs_masked_state_moments_still_shard():
    """optax.masked: the moment trees hold None where the mask is off, so
    they do not mirror the params — the moment buffers still shard."""
    mask = {"big": True, "odd": False, "scalar": False}
    mopt = topt.masked(topt.adam(1e-3), mask)
    specs = optimizer_state_specs(mopt, _params(), _rep(_params()),
                                  dp_axis="data", dp_size=4)
    jspecs = jtrain.optimizer_state_specs(
        optax.masked(optax.adam(1e-3), mask), _jparams(),
        jax.tree.map(lambda _: P(), _jparams()), dp_axis="data", dp_size=4)
    _same(specs, mopt.init(_params()), jspecs)
    assert _flat(specs).count(Split(0, "data")) == 2


def test_specs_chained_and_empty_states_round_trip():
    chain = topt.chain(topt.clip_by_global_norm(1.0), topt.adamw(1e-3),
                       topt.scale(0.5))
    specs = optimizer_state_specs(chain, _params(), _rep(_params()),
                                  dp_axis="data", dp_size=4)
    jspecs = jtrain.optimizer_state_specs(
        optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3),
                    optax.scale(0.5)),
        _jparams(), jax.tree.map(lambda _: P(), _jparams()),
        dp_axis="data", dp_size=4)
    _same(specs, chain.init(_params()), jspecs)
    assert _flat(optimizer_state_specs(topt.identity(), _params(),
                                       _rep(_params()), dp_axis="data",
                                       dp_size=4)) == []


def test_specs_without_dp_axis_keep_legacy_behavior():
    opt = make_optimizer("adamw", lr=1e-3)
    specs = optimizer_state_specs(opt, _params(), _rep(_params()))
    assert all(sp == REPLICATED for sp in _flat(specs))


def test_specs_inherit_nontrivial_param_layout_by_shape():
    """A state leaf with exactly one same-shape param twin takes that
    param's spec, dp-extended on a free leading dim only."""
    params = {"w": torch.zeros((8, 4))}
    mopt = topt.masked(topt.adam(1e-3), {"w": True})
    specs = optimizer_state_specs(mopt, params, {"w": Split(0, "tensor")},
                                  dp_axis="data", dp_size=4)
    assert Split(0, "tensor") in _flat(specs)
    specs = optimizer_state_specs(mopt, params, {"w": Split(1, "tensor")},
                                  dp_axis="data", dp_size=4)
    assert Split(1, "tensor", 0) in _flat(specs)


# -- planner -----------------------------------------------------------------
def test_training_update_mode_predicate():
    assert training_update_mode({"data": 2}, True) == "zero1"
    assert training_update_mode({"data": 1}, True) == "unsharded"
    assert training_update_mode({"fsdp": 4}, True) == "unsharded"
    assert training_update_mode({"data": 4}, False) == "unsharded"
    assert training_update_mode({}, True) == "unsharded"


# tlint: disable=TL006(read-only test data)
PCFG = dict(family="llama", vocab_size=128, d_model=48, n_layers=4,
            n_heads=4, n_kv_heads=2, head_dim=12, d_ff=96, max_seq_len=64)


def test_plan_sharding_picks_zero1_and_defaults_n_micro():
    cfg = config_from_jax(dataclasses.asdict(JModelConfig(**PCFG)))
    w = WorkerCapacity("w1", hbm_bytes=1e9, n_devices=4)
    plan = plan_sharding(cfg, [w], training=True, batch=4, seq_len=32,
                         mesh_hints={"data": 2, "tensor": 2})
    assert plan.update_mode == "zero1" and plan.n_micro == 2
    assert plan.stages[0].mesh_axes == {"data": 2, "tensor": 2}
    auto = plan_sharding(cfg, [w], training=True, batch=4, seq_len=32)
    assert auto.update_mode == "unsharded"
    serve = plan_sharding(cfg, [w], training=False, batch=4, seq_len=32)
    assert serve.update_mode == "unsharded"
    assert ShardingPlan.from_json(plan.to_json()).update_mode == "zero1"
    legacy = plan.to_json()
    legacy.pop("update_mode")
    assert ShardingPlan.from_json(legacy).update_mode == "unsharded"


def test_capacity_model_shards_optimizer_over_data_for_zero1():
    cfg = config_from_jax(dataclasses.asdict(JModelConfig(**PCFG)))
    est = MemoryEstimate.build(cfg, batch=4, seq_len=32, training=True)
    replicated = _per_device_bytes(est, {"data": 4}, training=False)
    zero1 = _per_device_bytes(est, {"data": 4}, training=True)
    assert zero1 < replicated
    expected = replicated - est.optimizer * (1 - 1 / 4) * 1.1
    assert abs(zero1 - expected) < 1e-6 * replicated


GB = 1 << 30
# tlint: disable=TL006(read-only test data)
TRAINING_PLANS = {
    # tests/test_planner.py:125: a stage hint, the rest filled with fsdp
    "stage-hint": ("gpt2-small", [(64, 8)], {"stage": 2}, 1, 1024),
    # a tensor hint on four devices: {"tensor": 2, "fsdp": 2}
    "tensor-hint": ("qwen3-0p6b", [(12, 4)], {"tensor": 2}, 4, 128),
    "no-hint": ("qwen3-0p6b", [(12, 4)], None, 4, 128),
    "zero1": ("qwen3-0p6b", [(12, 4)], {"data": 2, "tensor": 2}, 4, 128),
    # too little memory for one worker: the stages split by the count
    "stages": ("qwen3-0p6b", [(4, 4), (4, 4), (4, 4)], None, 4, 128),
}


@pytest.mark.parametrize("case", list(TRAINING_PLANS))
def test_training_plans_equal_the_jax_planner_s(case):
    """The port trains the placed tree (params, grads and optimizer state
    split over tensor x fsdp x expert x stage, the state over data too on
    ZeRO-1), so its planner counts training bytes as JAX's does and plans
    the same stages, mesh axes, update mode and micro count, hints or
    none, where memory is tight too."""
    from tensorlink_tpu.models.registry import config_presets as j_presets
    from tensorlink_tpu.parallel import planner as jplanner
    from tensorlink_tpu_torch.models.registry import config_presets

    name, caps, hints, batch, seq = TRAINING_PLANS[case]
    kw = dict(training=True, batch=batch, seq_len=seq, mesh_hints=hints)
    got = plan_sharding(config_presets()[name], [
        WorkerCapacity(f"w{i}", g * GB, n) for i, (g, n) in enumerate(caps)],
        **kw)
    want = jplanner.plan_sharding(j_presets()[name], [
        jplanner.WorkerCapacity(f"w{i}", g * GB, n)
        for i, (g, n) in enumerate(caps)], **kw)
    assert [dataclasses.asdict(s) for s in got.stages] == [
        dataclasses.asdict(s) for s in want.stages]
    assert (got.update_mode, got.n_micro) == (want.update_mode,
                                              want.n_micro)
    if case == "tensor-hint":
        assert got.stages[0].mesh_axes == {"tensor": 2, "fsdp": 2}
    if case == "stages":
        assert len(got.stages) > 1
