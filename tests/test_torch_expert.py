"""The port's ``expert`` mesh axis against the JAX package, case by case
after tests/test_expert_parallel.py, on the same numpy-seeded weights and
batches: a tiny float32 Mixtral (4 experts, top-2) placed by
``models/transformer.py::partition_specs(expert_axis="expert")`` on
``parallel/mesh.py`` meshes of CPU shards (``[cpu] * n``), JAX's on the
conftest's virtual host devices. Held here:

- the planner's mesh axes and whole plans for MoE configs at 2, 4 and 8
  devices, serving and training, with and without hints;
- the spec trees (``partition_specs`` and ``stage_param_specs``) leaf for
  leaf, with tensor and fsdp too;
- each device's piece of every leaf, and of the AdamW state, byte-equal
  to JAX's ``addressable_shards``, loaded straight onto the mesh too;
- the ``{expert: 4, tensor: 2}`` forward within 2e-5 of JAX's GSPMD
  forward, the dense dispatch's expert blocks summed in a fixed order;
- the expert-mesh ``GenerationEngine``'s greedy, batched, beam and int8
  tokens equal to JAX's (test_moe_engine_under_expert_mesh_serves);
- the sparse dispatch over the expert shards equal to the unsharded one
  (the same capacity and drop order) and to JAX's, grouped or not, and
  equal to the dense dispatch at ``moe_capacity_factor = E/K``;
- one AdamW and one SGD step on ``{expert: 2}`` and ``{expert: 2, fsdp:
  2}`` within 2e-5 of JAX's step over the put tree (params per leaf in
  norm under AdamW, elementwise under SGD), each expert leaf's gradient
  on its own shard; each distinct piece updated once; two placed runs
  bitwise equal;
- the sparse dispatch over (data × fsdp) row blocks, with tokens
  dropped, grouped over the whole batch as JAX's step groups it;
- a worker on four CPU shards that gets JAX's default ``{expert: 4}``
  plan for a Mixtral job, serves it (dense dispatch) and trains it
  (sparse dispatch, with tokens dropped) as the JAX worker does.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from tensorlink_tpu.engine import training as jtrain
from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu.models.transformer import forward as j_forward
from tensorlink_tpu.models.transformer import (
    partition_specs as j_partition_specs,
)
from tensorlink_tpu.parallel import planner as jplanner
from tensorlink_tpu.parallel.mesh import build_mesh as j_build_mesh
from tensorlink_tpu_torch.convert import config_from_jax, params_from_jax
from tensorlink_tpu_torch.engine import optimizers as topt
from tensorlink_tpu_torch.engine import training as ttrain
from tensorlink_tpu_torch.models.transformer import forward, partition_specs
from tensorlink_tpu_torch.parallel import mesh as tmesh
from tensorlink_tpu_torch.parallel import planner as tplanner

# one intra-op thread: a JAX call in this process can leave torch's worker
# threads computing exp off by up to 1e-4 (tests/test_torch_flash.py)
torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 2e-5
# tests/test_expert_parallel.py::moe_cfg
JCFG = JModelConfig(
    family="mixtral", vocab_size=128, d_model=32, n_layers=2, n_heads=4,
    n_kv_heads=2, head_dim=8, d_ff=64, max_seq_len=64, n_experts=4,
    n_experts_per_tok=2, dtype=jnp.float32,
)
CFG = config_from_jax(dataclasses.asdict(JCFG))
E_OVER_K = JCFG.n_experts / JCFG.n_experts_per_tok


def _mesh(axes: dict):
    n = int(np.prod(list(axes.values())))
    return (tmesh.build_mesh(axes, [CPU] * n),
            j_build_mesh(axes, jax.devices("cpu")[:n]))


def _axes(axes: dict) -> dict:
    return dict(tensor_axis="tensor" if axes.get("tensor", 1) > 1 else None,
                expert_axis="expert",
                fsdp_axis="fsdp" if axes.get("fsdp", 1) > 1 else None)


def _parts(spec, ndim: int) -> tuple:
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


@pytest.fixture(scope="module")
def trees():
    jp = j_init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _placed(trees, axes: dict, jcfg=JCFG, cfg=CFG):
    jp, tp = trees
    mesh, jm = _mesh(axes)
    placed = tmesh.put(mesh, tp, partition_specs(cfg, **_axes(axes)))
    jput = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(jm, s)),
                        jp, j_partition_specs(jcfg, **_axes(axes)))
    return mesh, jm, placed, jput


def _batch(seed=0, B=2, T=12):
    rng = np.random.default_rng(seed)
    return rng.integers(0, JCFG.vocab_size, (B, T)).astype(np.int32)


# -- the planner ----------------------------------------------------------------
# tlint: disable=TL006(read-only test data)
PLAN_CASES = {
    "tiny-8": (JCFG, 8, None), "tiny-4": (JCFG, 4, None),
    "tiny-2": (JCFG, 2, None), "tiny-8-hint-expert": (JCFG, 8, {"expert": 2}),
    "tiny-8-hint-expert-tensor": (JCFG, 8, {"expert": 2, "tensor": 2}),
    "tiny-4-hint-tensor": (JCFG, 4, {"tensor": 2}),
    "mixtral-8": ("mixtral-8x7b", 8, None),
    "mixtral-4": ("mixtral-8x7b", 4, None),
    "mixtral-2": ("mixtral-8x7b", 2, None),
    "mixtral-8-hint-expert": ("mixtral-8x7b", 8, {"expert": 4}),
}


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_planner_assigns_expert_axis(case, training):
    """``_mesh_axes_for`` gives a MoE worker JAX's axes (the expert axis
    first: 4 on four devices and 8 on eight for Mixtral's 8 experts), and
    ``plan_sharding`` — the memory model and ``_apply_mesh_hints`` too —
    the same plan, for serving and training, with and without hints."""
    from tensorlink_tpu.models.registry import config_presets as jpresets
    from tensorlink_tpu_torch.models.registry import config_presets

    model, n, hints = PLAN_CASES[case]
    if isinstance(model, str):
        jcfg, cfg = jpresets()[model], config_presets()[model]
        hbm = 640e9 if n == 8 else 1e12
    else:
        jcfg, cfg, hbm = model, CFG, 1e12
    kw = dict(seq_len=1024, stage_layers=cfg.n_layers, mesh_hints=hints)
    want = jplanner._mesh_axes_for(
        jcfg, jplanner.WorkerCapacity("w", hbm, n_devices=n), training, **kw)
    got = tplanner._mesh_axes_for(
        cfg, tplanner.WorkerCapacity("w", hbm, n_devices=n), training, **kw)
    assert got == want
    if hints is None:
        assert got.get("expert", 1) == min(n, cfg.n_experts)
        assert int(np.prod(list(got.values()))) == n
    plans = [mod.plan_sharding(
        c, [mod.WorkerCapacity("w0", hbm, n_devices=n)], model_name=case,
        training=training, batch=4, seq_len=1024, mesh_hints=hints).to_json()
        for mod, c in ((jplanner, jcfg), (tplanner, cfg))]
    assert plans[0] == plans[1]


# -- spec trees -----------------------------------------------------------------
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("tensor_axis", ["tensor", None])
def test_expert_partition_specs_match_jax(tensor_axis, fsdp):
    """``partition_specs(expert_axis="expert")`` splits the same dimensions
    over the same axes as JAX's, leaf for leaf: ``w_gate``/``w_up``
    ``P(None, "expert", fs, t)``, ``w_down`` ``P(None, "expert", t, fs)``,
    the router replicated."""
    shapes = jax.eval_shape(lambda: j_init_params(JCFG,
                                                  jax.random.PRNGKey(0)))
    kw = dict(tensor_axis=tensor_axis, expert_axis="expert",
              fsdp_axis="fsdp" if fsdp else None)
    port, want = partition_specs(CFG, **kw), j_partition_specs(JCFG, **kw)

    def walk(p, w, s, path=""):
        if isinstance(w, dict):
            assert isinstance(p, dict) and set(p) == set(w), path
            for k in w:
                walk(p[k], w[k], s[k], f"{path}/{k}")
            return
        assert p.parts(len(s.shape)) == _parts(w, len(s.shape)), path

    walk(port, want, shapes)
    assert port["layers"]["mlp"]["w_gate"].expert_dim == 1


# tlint: disable=TL006(read-only test data)
STAGE_AXES = [{"expert": 4}, {"expert": 2, "tensor": 2},
              {"expert": 2, "fsdp": 2}, {"data": 2, "expert": 2}]


@pytest.mark.parametrize("axes", STAGE_AXES,
                         ids=["e4", "e2t2", "e2f2", "d2e2"])
@pytest.mark.parametrize("first", [True, False])
def test_expert_stage_specs_match_jax(axes, first):
    """``stage_param_specs`` takes the plan's expert axis (no refusal)
    and gives JAX's tree for a first and a later stage."""
    plan = dict(worker_id="w", layer_lo=0, layer_hi=2, mesh_axes=axes,
                first=first, last=True, holds_head=True)
    jspecs = jplanner.stage_param_specs(JCFG, jplanner.StagePlan(**plan))
    specs = tplanner.stage_param_specs(CFG, tplanner.StagePlan(**plan))
    shapes = jax.eval_shape(lambda: j_init_params(JCFG,
                                                  jax.random.PRNGKey(0)))

    def walk(p, w, s):
        if isinstance(w, dict):
            assert set(p) == set(w)
            for k in w:
                walk(p[k], w[k], s[k])
            return
        assert p.parts(len(s.shape)) == _parts(w, len(s.shape))

    walk(specs, jspecs, {k: shapes[k] for k in jspecs})


# -- placement ------------------------------------------------------------------
# tlint: disable=TL006(read-only test data)
PLACE_MESHES = {"e4": {"expert": 4}, "e4t2": {"expert": 4, "tensor": 2},
                "e2f2": {"expert": 2, "fsdp": 2}}


@pytest.mark.parametrize("case", list(PLACE_MESHES))
def test_expert_placement_equals_jax_addressable_shards(trees, case):
    """Every leaf's piece on device ``j`` — the params and the AdamW state
    made piece by piece — is the bytes JAX's ``NamedSharding`` keeps on
    the same device (the device order follows ``AXIS_ORDER``, expert
    before tensor), ``shard_bytes`` counts them and ``full()`` joins
    exactly; each device holds 1/ep of every expert leaf."""
    axes = PLACE_MESHES[case]
    jp, tp = trees
    mesh, jm, placed, jput = _placed(trees, axes)
    devs = list(jm.devices.reshape(-1))
    opt = ttrain.make_optimizer("adamw", lr=1e-3)
    jopt = jtrain.make_optimizer("adamw", lr=1e-3)
    state = ttrain.placed_state(opt, placed, ttrain._specs_of(placed))
    jspecs = j_partition_specs(JCFG, **_axes(axes))
    jstate = jax.tree.map(
        lambda x, sp: jax.device_put(x, NamedSharding(jm, sp)),
        jopt.init(jp), jtrain.optimizer_state_specs(jopt, jp, jspecs))
    for got, want in ((placed, jput), (state, jstate)):
        leaves, jleaves = topt.tree_leaves(got), jax.tree.leaves(want)
        assert len(leaves) == len(jleaves)
        want_bytes = [0] * len(devs)
        for a, b in zip(leaves, jleaves):
            by_dev = {s.device: np.asarray(s.data)
                      for s in b.addressable_shards}
            for j, d in enumerate(devs):
                w = by_dev[d] if b.ndim else np.asarray(b)
                np.testing.assert_array_equal(a.shards[j].numpy(), w)
                want_bytes[j] += w.nbytes
        assert [tmesh.shard_bytes(got, j)
                for j in range(len(devs))] == want_bytes
    w_gate = placed["layers"]["mlp"]["w_gate"]
    assert w_gate.n_expert == axes["expert"]
    assert w_gate.shards[0].shape[1] == JCFG.n_experts // axes["expert"]
    for a, b in zip(topt.tree_leaves(tmesh.full_tree(placed)),
                    topt.tree_leaves(tp)):
        assert torch.equal(a, b)


def test_loader_places_a_checkpoint_onto_an_expert_mesh(trees, checkpoint):
    """``load_params(mesh=, specs=)`` reads a Mixtral checkpoint straight
    onto an ``{expert: 2, tensor: 2}`` mesh: every piece is the bytes
    JAX's loader puts on the same device with ``NamedSharding``."""
    from tensorlink_tpu.engine.loader import load_params as j_load_params
    from tensorlink_tpu_torch.engine.loader import load_params

    axes = {"expert": 2, "tensor": 2}
    mesh, jm = _mesh(axes)
    _, got = load_params(checkpoint, CFG, mesh=mesh,
                         specs=partition_specs(CFG, **_axes(axes)))
    _, want = j_load_params(checkpoint, JCFG, mesh=jm,
                            specs=j_partition_specs(JCFG, **_axes(axes)))
    devs = list(jm.devices.reshape(-1))
    for a, b in zip(topt.tree_leaves(got), jax.tree.leaves(want),
                    strict=True):
        by_dev = {s.device: np.asarray(s.data) for s in b.addressable_shards}
        for j, d in enumerate(devs):
            np.testing.assert_array_equal(a.shards[j].numpy(), by_dev[d])


# -- the forward ----------------------------------------------------------------
@pytest.mark.parametrize("case", ["e4t2", "e4", "e2f2"])
def test_expert_sharded_forward_parity(trees, case):
    """The forward over an expert-placed tree within 2e-5 of JAX's GSPMD
    forward over the same placement and of the port's unsharded forward
    (the expert blocks' outputs sum in a fixed order); two runs bitwise
    equal."""
    axes = PLACE_MESHES[case]
    _, tp = trees
    _, _, placed, jput = _placed(trees, axes)
    toks = _batch(1)
    want = np.asarray(j_forward(jput, jnp.asarray(toks), JCFG)[0])
    got, _ = forward(placed, torch.as_tensor(toks), CFG)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    one, _ = forward(tp, torch.as_tensor(toks), CFG)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=TOL, atol=TOL)
    again, _ = forward(placed, torch.as_tensor(toks), CFG)
    assert torch.equal(got, again)


def test_dense_moe_blocks_sum_to_the_layer(trees):
    """The dense dispatch over expert shards (``placed_moe_mlp``): the
    whole router scores every expert, each block of experts weights its
    own outputs by its own gates, and the blocks' outputs, summed in
    shard order, are the whole layer's (``_moe_mlp``) within float
    rounding; one block holding every expert is the whole layer
    bitwise."""
    from tensorlink_tpu_torch.models.transformer import _moe_mlp
    from tensorlink_tpu_torch.parallel import expert as tex

    _, tp = trees
    lp = {k: v[0] for k, v in tp["layers"]["mlp"].items()}
    h = torch.as_tensor(np.random.default_rng(3).normal(
        size=(2, 5, JCFG.d_model)).astype(np.float32))
    whole = _moe_mlp(h, lp, CFG)

    def blocks(n):
        return [(CPU, {k: lp[k][e:e + n] for k in ("w_gate", "w_up",
                                                    "w_down")})
                for e in range(0, JCFG.n_experts, n)]

    one = tex.placed_moe_mlp({CPU: h}, {CPU: lp["router"]}, blocks(4), CFG)
    assert torch.equal(one[CPU], whole)
    two = tex.placed_moe_mlp({CPU: h}, {CPU: lp["router"]}, blocks(2), CFG)
    np.testing.assert_allclose(two[CPU].numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)


# -- the engine -----------------------------------------------------------------
@pytest.mark.parametrize("case", ["e2", "e2t2"])
def test_moe_engine_under_expert_mesh_serves(trees, case):
    """The whole ``GenerationEngine`` (prefill, then the compiled decode
    loop) over an expert mesh emits JAX's single-device engine's greedy
    tokens, batched too, and its beam and weight-only int8 streams equal
    the unsharded port engine's; the prefill runs flash per distinct
    device set (once here: every shard is on the host)."""
    from tensorlink_tpu.engine.generate import GenerationEngine as JGen
    from tensorlink_tpu_torch.engine.generate import GenerationEngine
    from tensorlink_tpu_torch.models.transformer import cache_specs

    axes = {"expert": 2} if case == "e2" else {"expert": 2, "tensor": 2}
    jp, tp = trees
    mesh, _, placed, _ = _placed(trees, axes)
    kw = dict(seq_buckets=(16,), batch_buckets=(1, 2, 4), max_seq_len=64)
    ref = JGen(JCFG, jp, **kw)
    cs = cache_specs(CFG, data_axis=None,
                     tensor_axis=_axes(axes)["tensor_axis"])
    cfg = CFG.with_(flash_attention=True)
    eng = GenerationEngine(cfg, placed, mesh=mesh, cache_specs=cs,
                           device="cpu", **kw)
    one = GenerationEngine(cfg, tp, device="cpu", **kw)
    for prompts, n in (([[5, 9, 2, 7]], 8), ([[5, 9, 2, 7], [3, 3, 1]], 6)):
        want = ref.generate_compiled(prompts, max_new_tokens=n).sequences
        assert eng.generate_compiled(prompts, max_new_tokens=n).sequences \
            == want
    assert eng.flash_prefills == 2
    beam = dict(num_beams=3, max_new_tokens=6)
    assert eng.generate_beam([[5, 9, 2, 7]], **beam).sequences == \
        one.generate_beam([[5, 9, 2, 7]], **beam).sequences
    q = GenerationEngine(CFG, placed, mesh=mesh, cache_specs=cs,
                         quant="int8", device="cpu", **kw)
    q1 = GenerationEngine(CFG, tp, quant="int8", device="cpu", **kw)
    assert q.generate_compiled([[5, 9, 2, 7]], max_new_tokens=8).sequences \
        == q1.generate_compiled([[5, 9, 2, 7]], max_new_tokens=8).sequences


# -- sparse dispatch --------------------------------------------------------------
@pytest.mark.parametrize("cf", [E_OVER_K, 1.0])
@pytest.mark.parametrize("case", ["e4", "e4t2"])
def test_sparse_dispatch_expert_sharded_parity(trees, case, cf):
    """The capacity-factor dispatch over expert shards (each takes its
    block of the dispatched tokens and the blocks rejoin in expert order)
    equals the unsharded port's sparse forward — the same capacity and
    drop order, tokens dropped at cf 1 — bitwise with the experts alone on
    their shards and within 2e-5 with the tensor axis too, and JAX's
    sparse forward over the same placement within 2e-5."""
    axes = PLACE_MESHES[case]
    jcfg = JCFG.with_(moe_dispatch="sparse", moe_capacity_factor=cf)
    cfg = CFG.with_(moe_dispatch="sparse", moe_capacity_factor=cf)
    _, tp = trees
    _, _, placed, jput = _placed(trees, axes, jcfg, cfg)
    toks = _batch(2, T=16)
    got, _ = forward(placed, torch.as_tensor(toks), cfg)
    one, _ = forward(tp, torch.as_tensor(toks), cfg)
    if "tensor" in axes:
        np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=TOL,
                                   atol=TOL)
    else:
        assert torch.equal(got, one)
    want = np.asarray(j_forward(jput, jnp.asarray(toks), jcfg)[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_sparse_dispatch_matches_dense_when_no_drop(trees):
    """At ``moe_capacity_factor = E/K`` nothing can drop, so the sparse
    dispatch over an expert-placed tree is the dense forward within
    2e-5."""
    _, _, placed, _ = _placed(trees, {"expert": 4})
    toks = torch.as_tensor(_batch(1))
    dense, _ = forward(placed, toks, CFG)
    sparse, _ = forward(placed, toks, CFG.with_(
        moe_dispatch="sparse", moe_capacity_factor=E_OVER_K))
    np.testing.assert_allclose(sparse.numpy(), dense.numpy(), rtol=TOL,
                               atol=TOL)


def test_capacity_overflow_drops_lowest_priority_on_the_shards(trees):
    """Under capacity pressure the dispatched slots hold each expert's
    capacity at most, every expert shard's buffer block is the unsharded
    buffer's rows, and the placed MoE equals the unsharded sparse MoE
    bitwise (tests/test_expert_parallel.py's overflow case on shards)."""
    from tensorlink_tpu_torch.parallel import expert as tex

    _, tp = trees
    cfg = CFG.with_(moe_dispatch="sparse", moe_capacity_factor=0.5)
    lp = {k: v[0] for k, v in tp["layers"]["mlp"].items()}
    h = torch.as_tensor(np.random.default_rng(4).normal(
        size=(2, 8, JCFG.d_model)).astype(np.float32))
    combine, xe = tex._route(h, lp["router"], cfg)
    C = xe.shape[2]
    assert C == tex.expert_capacity(16, 4, 2, 0.5) == 4
    disp = (combine > 0).float()
    assert float(disp.sum(dim=1).max()) <= 1.0  # no slot double-booked
    assert float(disp.sum()) == 4 * C  # demand 32 > supply 16
    blocks = [(CPU, {k: lp[k][e:e + 1] for k in ("w_gate", "w_up",
                                                  "w_down")})
              for e in range(4)]
    got = tex.placed_moe_mlp({CPU: h}, {CPU: lp["router"]}, blocks, cfg)
    assert torch.equal(got[CPU], tex.sparse_moe_mlp(h, lp, cfg))


def test_grouped_dispatch_parity_and_hint_combo(trees):
    """Token grouping (``moe_group_size`` below the token count) leaves a
    no-drop sparse forward over expert shards unchanged within 2e-5, and
    JAX's; seq and stage hints together are refused at plan time, as
    JAX's planner refuses them."""
    cfg = CFG.with_(moe_dispatch="sparse", moe_capacity_factor=E_OVER_K)
    jcfg = JCFG.with_(moe_dispatch="sparse", moe_capacity_factor=E_OVER_K)
    _, _, placed, jput = _placed(trees, {"expert": 4}, jcfg, cfg)
    toks = _batch(4, T=16)
    one, _ = forward(placed, torch.as_tensor(toks), cfg)
    grouped, _ = forward(placed, torch.as_tensor(toks),
                         cfg.with_(moe_group_size=8))  # 4 groups
    np.testing.assert_allclose(grouped.numpy(), one.numpy(), rtol=TOL,
                               atol=TOL)
    want = np.asarray(j_forward(jput, jnp.asarray(toks),
                                jcfg.with_(moe_group_size=8))[0])
    np.testing.assert_allclose(grouped.numpy(), want, rtol=TOL, atol=TOL)
    for mod, c in ((jplanner, JCFG), (tplanner, CFG)):
        with pytest.raises(mod.AssignmentError):
            mod.plan_sharding(c, [mod.WorkerCapacity("w", 1e12, n_devices=8)],
                              seq_len=1024, training=True,
                              mesh_hints={"seq": 2, "stage": 2})


# -- the train step -------------------------------------------------------------
# tlint: disable=TL006(read-only test data)
STEP_MESHES = {"e2": {"expert": 2}, "e2f2": {"expert": 2, "fsdp": 2}}


def _jax_grads(jput, toks, jcfg):
    def loss(p):
        return jtrain.causal_lm_loss(p, jcfg, jnp.asarray(toks), None,
                                     remat=True)[0]

    return jax.jit(jax.grad(loss))(jput)


@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
@pytest.mark.parametrize("opt_name", ["adamw", "sgd"])
@pytest.mark.parametrize("case", list(STEP_MESHES))
def test_expert_step_matches_jax(trees, case, opt_name, dispatch):
    """One placed step (``make_train_step(mesh=)``) against JAX's
    ``make_train_step`` over the put tree, in the dense dispatch and the
    sparse one at E/K: the loss within 2e-5, each gradient leaf within
    2e-5 in its norm (each expert leaf's gradient placed on its own
    shards, 1/ep of it a device), the params elementwise within 2e-5
    under SGD and per leaf in norm under AdamW."""
    axes = STEP_MESHES[case]
    jcfg = JCFG.with_(moe_dispatch=dispatch, moe_capacity_factor=E_OVER_K)
    cfg = CFG.with_(moe_dispatch=dispatch, moe_capacity_factor=E_OVER_K)
    mesh, _, placed, jput = _placed(trees, axes, jcfg, cfg)
    kw = dict(lr=0.05) if opt_name == "sgd" else dict(lr=1e-3)
    opt = ttrain.make_optimizer(opt_name, grad_clip=1.0, **kw)
    jopt = jtrain.make_optimizer(opt_name, grad_clip=1.0, **kw)
    toks = _batch(5, B=4, T=16)
    ts = ttrain.make_train_step(cfg, opt, mesh=mesh)
    jts = jtrain.make_train_step(jcfg, jopt, remat=True, donate=False)
    p1, s1, m = ts.step_fn(placed, ts.init_state(placed),
                           {"tokens": torch.as_tensor(toks)})
    jp1, _, jm = jts.step_fn(jput, jts.init_state(jput),
                             {"tokens": jnp.asarray(toks)})
    assert abs(float(m["loss"]) - float(jm["loss"])) <= TOL * abs(
        float(jm["loss"]))
    grads, _ = ttrain.placed_grads(placed, cfg, torch.as_tensor(toks))
    g = grads["layers"]["mlp"]["w_down"]
    assert g.spec == placed["layers"]["mlp"]["w_down"].spec
    assert g.shards[0].shape[1] == JCFG.n_experts // axes["expert"]
    for a, b in zip(topt.tree_leaves(tmesh.full_tree(grads)),
                    jax.tree.leaves(_jax_grads(jput, toks, jcfg)),
                    strict=True):
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) <= TOL * np.linalg.norm(b)
    for a, b in zip(topt.tree_leaves(p1), jax.tree.leaves(jp1),
                    strict=True):
        assert isinstance(a, tmesh.Sharded)
        a, b = a.full().numpy(), np.asarray(b)
        if opt_name == "sgd":
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
        else:
            assert np.linalg.norm(a - b) <= TOL * np.linalg.norm(b)


def test_expert_sparse_step_with_drops_matches_jax(trees):
    """The sparse step on ``{expert: 2}`` at capacity factor 1, where
    tokens drop: the placed step routes the whole batch as JAX's does, so
    its loss and each gradient leaf stay within 2e-5 of JAX's."""
    jcfg = JCFG.with_(moe_dispatch="sparse", moe_capacity_factor=1.0)
    cfg = CFG.with_(moe_dispatch="sparse", moe_capacity_factor=1.0)
    _, _, placed, jput = _placed(trees, {"expert": 2}, jcfg, cfg)
    toks = _batch(6, B=4, T=16)
    grads, loss = ttrain.placed_grads(placed, cfg, torch.as_tensor(toks))
    jloss = jtrain.causal_lm_loss(jput, jcfg, jnp.asarray(toks), None)[0]
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    dense, _ = ttrain.placed_grads(placed, CFG, torch.as_tensor(toks))
    for a, b, c in zip(topt.tree_leaves(tmesh.full_tree(grads)),
                       jax.tree.leaves(_jax_grads(jput, toks, jcfg)),
                       topt.tree_leaves(tmesh.full_tree(dense)),
                       strict=True):
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) <= TOL * np.linalg.norm(b)
    w = "layers/mlp/w_gate"
    got = dict(zip([w], [grads["layers"]["mlp"]["w_gate"].full()]))
    assert not torch.allclose(got[w], dense["layers"]["mlp"]["w_gate"]
                              .full(), rtol=1e-3, atol=0)  # tokens dropped


# tlint: disable=TL006(read-only test data)
ROW_BLOCK_MESHES = {"d2e2": {"data": 2, "expert": 2},
                    "e2f2": {"expert": 2, "fsdp": 2},
                    "d2": {"data": 2, "expert": 1}}


@pytest.mark.parametrize("group_size", [64, 16])
@pytest.mark.parametrize("case", list(ROW_BLOCK_MESHES))
def test_sparse_dispatch_over_row_blocks_groups_the_whole_batch(
        trees, case, group_size):
    """At capacity factor 1, where tokens drop, on a mesh whose (data ×
    fsdp) groups each take a block of the batch's rows, the placed sparse
    dispatch groups the whole batch's tokens as JAX's GSPMD step does
    (``parallel/expert.py::WholeBatchDispatch``; on ``{data: 2}`` the
    experts are whole on every shard): with dispatch groups of 64 tokens,
    one group over both row blocks of 32, and of 16, groups
    inside a block, the forward's logits, the loss and each gradient leaf
    are within 2e-5 of JAX's over the whole batch, and one AdamW step's
    params within 2e-5 per leaf in norm."""
    jcfg = JCFG.with_(moe_dispatch="sparse", moe_capacity_factor=1.0,
                      moe_group_size=group_size)
    cfg = CFG.with_(moe_dispatch="sparse", moe_capacity_factor=1.0,
                    moe_group_size=group_size)
    mesh, _, placed, jput = _placed(trees, ROW_BLOCK_MESHES[case], jcfg, cfg)
    toks = _batch(7, B=4, T=16)
    got, _ = forward(placed, torch.as_tensor(toks), cfg)
    want = np.asarray(j_forward(jput, jnp.asarray(toks), jcfg)[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    grads, loss = ttrain.placed_grads(placed, cfg, torch.as_tensor(toks))
    jloss = jtrain.causal_lm_loss(jput, jcfg, jnp.asarray(toks), None)[0]
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    for a, b in zip(topt.tree_leaves(tmesh.full_tree(grads)),
                    jax.tree.leaves(_jax_grads(jput, toks, jcfg)),
                    strict=True):
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) <= TOL * np.linalg.norm(b)
    # tokens did drop: capacity factor E/K routes every one
    full, _ = ttrain.placed_grads(placed, cfg.with_(
        moe_capacity_factor=E_OVER_K), torch.as_tensor(toks))
    assert not torch.allclose(grads["layers"]["mlp"]["w_gate"].full(),
                              full["layers"]["mlp"]["w_gate"].full(),
                              rtol=1e-3, atol=0)
    opt = ttrain.make_optimizer("adamw", grad_clip=1.0, lr=1e-3)
    jopt = jtrain.make_optimizer("adamw", grad_clip=1.0, lr=1e-3)
    ts = ttrain.make_train_step(cfg, opt, mesh=mesh)
    jts = jtrain.make_train_step(jcfg, jopt, remat=True, donate=False)
    p1, _, _ = ts.step_fn(placed, ts.init_state(placed),
                          {"tokens": torch.as_tensor(toks)})
    jp1, _, _ = jts.step_fn(jput, jts.init_state(jput),
                            {"tokens": jnp.asarray(toks)})
    for a, b in zip(topt.tree_leaves(p1), jax.tree.leaves(jp1), strict=True):
        a, b = a.full().numpy(), np.asarray(b)
        assert np.linalg.norm(a - b) <= TOL * np.linalg.norm(b)


def test_each_distinct_piece_is_updated_once(trees):
    """``sharded_update`` on ``{expert: 4}`` with every shard on the host
    runs the optimizer once per distinct (device, piece): the replicated
    leaves once, each expert leaf's four pieces once each; the params
    stay within 2e-5 per leaf of the unsharded step's."""
    mesh, _, placed, _ = _placed(trees, {"expert": 4})
    opt = ttrain.make_optimizer("adamw", lr=1e-3, grad_clip=1.0)
    seen = []
    update = opt.inner.update

    def counting(g, s, p):
        seen.append(sorted(_names(p)))
        return update(g, s, p)

    ts = ttrain.make_train_step(CFG, opt._replace(
        inner=opt.inner._replace(update=counting)), mesh=mesh)
    p1, _, _ = ts.step_fn(placed, ts.init_state(placed),
                          {"tokens": torch.as_tensor(_batch(3))})
    experts = {"layers/mlp/w_gate", "layers/mlp/w_up", "layers/mlp/w_down"}
    assert len(seen) == 4
    assert set(seen[0]) > experts
    assert all(set(n) == experts for n in seen[1:])
    one = ttrain.make_train_step(CFG, opt)
    _, tp = trees
    p2, _, _ = one.step_fn(tp, one.init_state(tp),
                           {"tokens": torch.as_tensor(_batch(3))})
    for a, b in zip(topt.tree_leaves(p1), topt.tree_leaves(p2),
                    strict=True):
        a = a.full()
        assert torch.linalg.vector_norm(a - b) <= TOL * \
            torch.linalg.vector_norm(b)


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _names(v, f"{prefix}{k}/")]
    return [prefix[:-1]]


@pytest.mark.parametrize("case", list(STEP_MESHES))
def test_expert_placed_step_is_bitwise_repeatable(trees, case):
    """Two runs of two placed sparse-dispatch AdamW steps from the same
    tree: the losses, grad norms, params and optimizer state equal bit
    for bit."""
    cfg = CFG.with_(moe_dispatch="sparse")
    mesh, _, placed, _ = _placed(trees, STEP_MESHES[case])
    opt = ttrain.make_optimizer("adamw", lr=1e-3, grad_clip=1.0)
    runs = []
    for _ in range(2):
        ts = ttrain.make_train_step(cfg, opt, n_micro=2, mesh=mesh)
        p, s, ms = placed, ts.init_state(placed), []
        for seed in (1, 2):
            p, s, m = ts.step_fn(p, s, {"tokens": torch.as_tensor(
                _batch(seed, B=4))})
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((ms, topt.tree_leaves(tmesh.full_tree(p)),
                     topt.tree_leaves(tmesh.full_tree(s))))
    (ma, pa, sa), (mb, pb, sb) = runs
    assert ma == mb
    assert all(torch.equal(x, y) for x, y in zip(pa + sa, pb + sb,
                                                 strict=True))


# -- the worker -----------------------------------------------------------------
JOB = "ab12cd50"
# the job's config: capacity factor 1 drops tokens in the sparse dispatch,
# so a worker that trained dense where JAX trains sparse would part from it
JOB_JCFG = JCFG.with_(moe_capacity_factor=1.0)


class _Bridge:
    def __init__(self):
        self.sent = []

    def request(self, verb, payload, timeout=None):
        self.sent.append((verb, payload))
        return {"ok": True}


def _worker(pkg: str):
    if pkg == "port":
        from tensorlink_tpu_torch.core import config as C
        from tensorlink_tpu_torch.ml.worker import DistributedWorker

        ml = C.MLConfig(device="cpu", max_seq_len=64, mesh_devices=4,
                        warmup_tokens=0)
    else:
        from tensorlink_tpu.core import config as C
        from tensorlink_tpu.ml.worker import DistributedWorker

        ml = C.MLConfig(max_seq_len=64, warmup_tokens=0)
    node = types.SimpleNamespace(
        bridge=_Bridge(), node_id=f"{pkg}-w0", config=C.WorkerConfig(ml=ml),
        crash=lambda: None)
    return DistributedWorker(node)


def _call(w, kind, **body):
    n = len(w.bridge.sent)
    w._handle(kind, {"rid": "r1", "peer": "p1", "job_id": JOB, **body})
    out = [p for v, p in w.bridge.sent[n:] if v == "respond"
           and p["rid"] == "r1"]
    assert out, w.bridge.sent[n:]
    assert "error" not in out[-1]["body"], out[-1]["body"]
    return out[-1]["body"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, trees):
    from tensorlink_tpu.engine.loader import export_hf as j_export_hf

    jp, _ = trees
    return str(j_export_hf(JCFG, jax.device_get(jp),
                           tmp_path_factory.mktemp("expert_ckpt") / "m"))


def _train(w, toks, tag):
    from tensorlink_tpu_torch.ml.module import _ce_sum_and_grad

    out = _call(w, "fwd", op="stage", train=True, tag=tag, tokens=toks)
    logits = torch.as_tensor(np.array(out["out"]))
    nll, dlogits, n = _ce_sum_and_grad(logits, toks,
                                       np.ones(toks.shape, bool))
    _call(w, "bwd", op="stage", tag=tag, grad=dlogits.numpy())
    body = _call(w, "opt", op="step", scale=1.0 / float(n))
    return float(nll) / float(n), body["grad_norm"]


def _default_stage(port, training: bool) -> dict:
    """The plan both planners make for the job on the port worker's
    advertised four devices."""
    cap = port.capacity()
    assert cap["n_devices"] == 4
    plans = [mod.plan_sharding(
        c, [mod.WorkerCapacity("w0", cap["hbm_bytes"], cap["n_devices"])],
        training=training, batch=4, seq_len=16)
        for mod, c in ((tplanner, CFG), (jplanner, JOB_JCFG))]
    assert plans[0].to_json() == plans[1].to_json()
    axes = plans[0].stages[0].mesh_axes
    assert {k: v for k, v in axes.items() if v > 1} == {"expert": 4}
    return dict(dataclasses.asdict(plans[0].stages[0]))


def _state_leaves(node):
    if isinstance(node, dict):
        node = list(node.values())
    if isinstance(node, (tuple, list)):
        return [x for v in node for x in _state_leaves(v)]
    return [node] if isinstance(node, tmesh.Sharded) else []


@pytest.mark.parametrize("kind", ["static", "beam"])
def test_worker_serves_a_default_expert_plan_like_jax(checkpoint, kind):
    """A port worker advertising four CPU shards gets JAX's default plan
    for a Mixtral job, ``{expert: 4}``, loads the checkpoint straight onto
    that mesh and serves it through the dense dispatch: its static and
    beam answers equal the JAX worker's on the same plan."""
    port, jw = _worker("port"), _worker("jax")
    stage = _default_stage(port, training=False)
    req = (dict(prompts=[[7, 3, 9, 11, 2], [5, 1, 8]], max_new_tokens=8)
           if kind == "static"
           else dict(prompts=[[5, 9, 2, 7]], max_new_tokens=6, num_beams=3))
    answers = []
    for w in (port, jw):
        _call(w, "load_stage", stage=stage, training=False,
              model={"name": "tiny-moe", "config": JOB_JCFG.to_json(),
                     "ckpt": checkpoint, "seed": 0})
        answers.append(_call(w, "gen", seed=0, **req))
    rt = port.jobs[JOB]
    w_gate = rt.params["layers"]["mlp"]["w_gate"]
    assert isinstance(w_gate, tmesh.Sharded) and w_gate.n_expert == 4
    got, want = answers
    assert got["sequences"] == [list(map(int, s))
                                for s in want["sequences"]]


def test_worker_trains_a_default_expert_plan_like_jax(checkpoint):
    """The training plan on the same worker is ``{expert: 4}`` too; the
    worker trains its placed tree with the sparse dispatch exactly where
    JAX's does (training forwards and the BACKWARD's recompute; tokens
    drop at capacity factor 1): two AdamW steps' losses and grad norms
    within rtol 2e-5 of the JAX worker's, each param leaf within 2e-5 in
    its norm, every expert leaf and its optimizer state a quarter a
    device."""
    port, jw = _worker("port"), _worker("jax")
    stage = _default_stage(port, training=True)
    for w in (port, jw):
        _call(w, "load_stage", stage=stage, training=True,
              model={"name": "tiny-moe", "config": JOB_JCFG.to_json(),
                     "ckpt": checkpoint, "seed": 0})
        _call(w, "opt", op="init", spec={"name": "adamw", "lr": 1e-3})
    rt = port.jobs[JOB]
    assert rt.mesh.shape == {k: v for k, v in stage["mesh_axes"].items()}
    w_up = rt.params["layers"]["mlp"]["w_up"]
    twins = [t for t in _state_leaves(rt.opt_state) if t.shape == w_up.shape]
    assert len(twins) == 4  # Adam's two moments of w_gate and of w_up
    for t in (w_up, *twins):
        assert t.n_expert == 4
        assert [s.numel() for s in t.shards] == [t.numel() // 4] * 4
    rng = np.random.default_rng(12)
    for i in range(2):
        toks = rng.integers(0, JCFG.vocab_size, (4, 16)).astype(np.int32)
        got = _train(port, toks, f"s{i}")
        want = _train(jw, toks, f"s{i}")
        np.testing.assert_allclose(got, want, rtol=TOL)
    got = [np.asarray(a) for a in topt.tree_leaves(
        _call(port, "params.req")["params"])]
    want = [np.asarray(a) for a in topt.tree_leaves(
        _call(jw, "params.req")["params"])]
    for a, b in zip(got, want, strict=True):
        assert np.linalg.norm(a - b) <= TOL * np.linalg.norm(b)
