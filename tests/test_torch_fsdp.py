"""The port's fsdp axis (ZeRO-3 over a placed tree) against the JAX
package on the same numpy-seeded weights and batches: ``parallel/mesh.py``
placement over two split dims (``Split(dim, axis, fsdp_dim=)``),
``models/transformer.py::partition_specs(fsdp_axis=)``, the placed train
step (``engine/training.py::make_train_step(mesh=)``, ``placed_grads``,
``GradFold``, ``placed_state``, ``sharded_update``), the placed global
norm and clip (``engine/optimizers.py``) and a worker's planned
``{fsdp, tensor}`` mesh (``ml/worker.py``).

The port's shards lie on the CPU (``[cpu] * n``), JAX's on the conftest's
virtual host devices; the model is the tiny qwen3 of
tests/test_multihost.py:68-72 in float32. Held here:

- the spec trees leaf for leaf, for gated, plain-MLP (gpt2, learned
  positions), MoE, qk_norm_full and untied-head configs;
- each device's piece of every leaf (and of the optimizer state) byte-equal
  to JAX's ``addressable_shards`` on the same device, and ``shard_bytes``
  to the bytes JAX keeps there;
- one AdamW and one SGD step, ``n_micro`` 1 and 2, against JAX's
  ``make_train_step`` over the put tree (GSPMD): loss within 2e-5, each
  gradient leaf within 2e-5 in its norm, params elementwise within 2e-5
  under SGD and per leaf in norm under AdamW (ROADMAP queue 3's rule);
- two placed runs bitwise equal (the gradients reduce in a fixed order,
  never through autograd's accumulation into a shared leaf);
- with ``remat``, nothing autograd keeps for the backward holds a weight
  joined over fsdp (``saved_tensors_hooks`` and the joined weights'
  storages); without it, it does;
- an fsdp forward is the tensor-only placed forward where the groups run
  the same rows (the gathers join exactly);
- weight-only int8 on an fsdp mesh: codes and scales the whole weight's,
  greedy tokens equal to the unsharded engine's and JAX's;
- a worker whose plan asks ``parallelism={"tensor": 2}`` on four devices
  gets ``{"tensor": 2, "fsdp": 2}`` (and ``{"data": 2, "fsdp": 2}``
  ZeRO-1 over data beside fsdp) and trains it as the JAX worker does,
  its checkpoint restoring on the JAX worker bit for bit; a serving job
  on an fsdp plan answers static and beam requests as the JAX worker's.
"""

import dataclasses
import gc
import queue
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from torch.multiprocessing.reductions import StorageWeakRef

from tensorlink_tpu.engine import training as jtrain
from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu.models.transformer import (
    partition_specs as j_partition_specs,
)
from tensorlink_tpu.parallel import planner as jplanner
from tensorlink_tpu.parallel.mesh import build_mesh as j_build_mesh
from tensorlink_tpu_torch.convert import config_from_jax, params_from_jax
from tensorlink_tpu_torch.engine import optimizers as topt
from tensorlink_tpu_torch.engine import training as ttrain
from tensorlink_tpu_torch.models import sharded
from tensorlink_tpu_torch.models.transformer import forward, partition_specs
from tensorlink_tpu_torch.parallel import mesh as tmesh
from tensorlink_tpu_torch.parallel import planner as tplanner

# one intra-op thread: a JAX call in this process can leave torch's worker
# threads computing exp off by up to 1e-4 (tests/test_torch_flash.py)
torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 2e-5
JCFG = JModelConfig(
    family="qwen3", vocab_size=256, d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, max_seq_len=64, qk_norm=True,
    tie_embeddings=True, dtype=jnp.float32,
)
CFG = config_from_jax(dataclasses.asdict(JCFG))
# tlint: disable=TL006(read-only test data)
MESHES = {"fsdp2-tensor2": {"fsdp": 2, "tensor": 2}, "fsdp4": {"fsdp": 4}}


def _mesh(axes: dict):
    n = int(np.prod(list(axes.values())))
    return (tmesh.build_mesh(axes, [CPU] * n),
            j_build_mesh(axes, jax.devices("cpu")[:n]))


def _axes(axes: dict) -> dict:
    return dict(tensor_axis="tensor" if axes.get("tensor", 1) > 1 else None,
                fsdp_axis="fsdp" if axes.get("fsdp", 1) > 1 else None)


def _parts(spec, ndim: int) -> tuple:
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


@pytest.fixture(scope="module")
def trees():
    jp = j_init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _placed(trees, axes: dict):
    jp, tp = trees
    mesh, jm = _mesh(axes)
    placed = tmesh.put(mesh, tp, partition_specs(CFG, **_axes(axes)))
    jput = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(jm, s)),
                        jp, j_partition_specs(JCFG, **_axes(axes)))
    return mesh, jm, placed, jput


def _batch(seed=0, B=4, T=16):
    rng = np.random.default_rng(seed)
    return rng.integers(0, JCFG.vocab_size, (B, T)).astype(np.int32)


# -- spec trees ---------------------------------------------------------------
# tlint: disable=TL006(read-only test data)
SPEC_CONFIGS = {
    "gated-untied": dict(family="llama", qk_norm=False,
                         tie_embeddings=False),
    "qwen3-tied": dict(),
    "gpt2": dict(family="gpt2", norm="layernorm", mlp="fused",
                 pos="learned", attn_bias=True, qk_norm=False),
    "biases": dict(family="llama", qk_norm=False, mlp_bias=True,
                   attn_out_bias=True),
    "moe": dict(family="mixtral", qk_norm=False, n_experts=4,
                n_experts_per_tok=2),
    "qk-norm-full": dict(family="llama", qk_norm=False, qk_norm_full=True),
}


def _walk(port, jspecs, shapes, path=""):
    if isinstance(jspecs, dict):
        assert isinstance(port, dict) and set(port) == set(jspecs), path
        for k in jspecs:
            _walk(port[k], jspecs[k], shapes[k], f"{path}/{k}")
        return
    assert isinstance(port, tmesh.Split), path
    nd = len(shapes.shape)
    assert port.parts(nd) == _parts(jspecs, nd), path


@pytest.mark.parametrize("tensor_axis", ["tensor", None])
@pytest.mark.parametrize("kw", list(SPEC_CONFIGS))
def test_fsdp_partition_specs_match_jax(kw, tensor_axis):
    """``partition_specs(fsdp_axis="fsdp")`` splits the same dimensions
    over the same axes as JAX's, leaf for leaf (``wq`` ``P(None, "fsdp",
    "tensor")``, ``wo`` ``P(None, "tensor", "fsdp")``, the embedding
    ``P("tensor", "fsdp")``, ``lm_head`` ``P("fsdp", "tensor")``, learned
    positions ``P(None, "fsdp")``)."""
    jcfg = dataclasses.replace(JCFG, **SPEC_CONFIGS[kw])
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    shapes = jax.eval_shape(lambda: j_init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    _walk(partition_specs(cfg, tensor_axis=tensor_axis, fsdp_axis="fsdp"),
          j_partition_specs(jcfg, tensor_axis=tensor_axis,
                            fsdp_axis="fsdp"), shapes)


# -- placement ----------------------------------------------------------------
@pytest.mark.parametrize("case", list(MESHES))
def test_fsdp_placement_equals_jax_addressable_shards(trees, case):
    """Every leaf's piece on device ``j`` — params and the AdamW state made
    piece by piece — is the bytes JAX's ``NamedSharding`` keeps there,
    ``shard_bytes`` counts them, and ``full()`` joins exactly."""
    axes = MESHES[case]
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
        leaves = topt.tree_leaves(got)
        jleaves = jax.tree.leaves(want)
        assert len(leaves) == len(jleaves)
        want_bytes = [0] * len(devs)
        for a, b in zip(leaves, jleaves):
            by_dev = {s.device: np.asarray(s.data)
                      for s in b.addressable_shards}
            for j, d in enumerate(devs):
                # a step count: one device's scalar in JAX, each device's
                # own copy in the port
                want = by_dev[d] if b.ndim else np.asarray(b)
                np.testing.assert_array_equal(a.shards[j].numpy(), want)
                want_bytes[j] += want.nbytes
        assert [tmesh.shard_bytes(got, j)
                for j in range(len(devs))] == want_bytes
    for a, b in zip(topt.tree_leaves(tmesh.full_tree(placed)),
                    topt.tree_leaves(tp)):
        assert torch.equal(a, b)


# -- the step -----------------------------------------------------------------
def _jax_grads(jput, toks):
    def loss(p):
        return jtrain.causal_lm_loss(p, JCFG, jnp.asarray(toks), None,
                                     remat=True)[0]

    return jax.jit(jax.grad(loss))(jput)


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("opt_name", ["adamw", "sgd"])
@pytest.mark.parametrize("case", list(MESHES))
def test_fsdp_step_matches_jax(trees, case, opt_name, n_micro):
    """One placed step against JAX's ``make_train_step`` over the put tree:
    the loss within 2e-5, each gradient leaf within 2e-5 in its norm of
    JAX's GSPMD gradient, and the params elementwise within 2e-5 under
    SGD, per leaf in norm under AdamW; the params and the optimizer state
    stay placed."""
    axes = MESHES[case]
    mesh, _, placed, jput = _placed(trees, axes)
    kw = dict(lr=0.05) if opt_name == "sgd" else dict(lr=1e-3)
    opt = ttrain.make_optimizer(opt_name, grad_clip=1.0, **kw)
    jopt = jtrain.make_optimizer(opt_name, grad_clip=1.0, **kw)
    toks = _batch()
    ts = ttrain.make_train_step(CFG, opt, n_micro=n_micro, mesh=mesh)
    assert ts.mode == "placed"
    jts = jtrain.make_train_step(JCFG, jopt, n_micro=n_micro, remat=True,
                                 donate=False)
    state = ts.init_state(placed)
    p1, s1, m = ts.step_fn(placed, state, {"tokens": torch.as_tensor(toks)})
    jp1, _, jm = jts.step_fn(jput, jts.init_state(jput),
                             {"tokens": jnp.asarray(toks)})
    assert abs(float(m["loss"]) - float(jm["loss"])) <= TOL * abs(
        float(jm["loss"]))
    grads, loss = ttrain.placed_grads(placed, CFG, torch.as_tensor(toks),
                                      n_micro=n_micro)
    assert float(loss) == float(m["loss"])
    for a, b in zip(topt.tree_leaves(tmesh.full_tree(grads)),
                    jax.tree.leaves(_jax_grads(jput, toks)), strict=True):
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) <= TOL * np.linalg.norm(b)
    for a, b in zip(topt.tree_leaves(p1), jax.tree.leaves(jp1),
                    strict=True):
        assert isinstance(a, tmesh.Sharded) and a.spec is not None
        a, b = a.full().numpy(), np.asarray(b)
        if opt_name == "sgd":
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
        else:
            assert np.linalg.norm(a - b) <= TOL * np.linalg.norm(b)
    assert all(isinstance(t, tmesh.Sharded) for t in topt.tree_leaves(s1))


@pytest.mark.parametrize("case", list(MESHES))
def test_placed_step_is_bitwise_repeatable(trees, case):
    """Two runs of two placed AdamW steps from the same tree: the losses,
    grad norms, params and optimizer state equal bit for bit."""
    mesh, _, placed, _ = _placed(trees, MESHES[case])
    opt = ttrain.make_optimizer("adamw", lr=1e-3, grad_clip=1.0)
    runs = []
    for _ in range(2):
        ts = ttrain.make_train_step(CFG, opt, n_micro=2, mesh=mesh)
        p, s, ms = placed, ts.init_state(placed), []
        for seed in (1, 2):
            p, s, m = ts.step_fn(p, s, {"tokens": torch.as_tensor(
                _batch(seed))})
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((ms, topt.tree_leaves(tmesh.full_tree(p)),
                     topt.tree_leaves(tmesh.full_tree(s))))
    (ma, pa, sa), (mb, pb, sb) = runs
    assert ma == mb
    assert all(torch.equal(x, y) for x, y in zip(pa + sa, pb + sb,
                                                 strict=True))


@pytest.mark.parametrize("remat", [True, False])
def test_remat_keeps_no_joined_weight(trees, remat, monkeypatch):
    """With ``remat`` each layer's weights are joined over fsdp inside the
    checkpointed block, so nothing autograd keeps between a group's
    forward and its backward holds a joined weight: no tensor saved for
    the backward (``saved_tensors_hooks``) has a joined weight's shape,
    and no joined weight's storage outlives the forward. Without
    ``remat`` the products save them (the check sees what it looks
    for)."""
    mesh, _, placed, _ = _placed(trees, {"fsdp": 2, "tensor": 2})
    joined, shapes = [], set()
    gather = sharded._Placed._gather

    def recording(self, leaf, g, t, layer):
        out = gather(self, leaf, g, t, layer)
        if isinstance(leaf, tmesh.Sharded) and leaf.n_fsdp > 1:
            joined.append(StorageWeakRef(out.untyped_storage()))
            shapes.add(tuple(out.shape))
        return out

    monkeypatch.setattr(sharded._Placed, "_gather", recording)
    saved = []
    kept = []

    def objective(take):
        with torch.autograd.graph.saved_tensors_hooks(
                lambda x: saved.append(tuple(x.shape)) or x, lambda x: x):
            out, _ = sharded.stage(placed, CFG, tokens=torch.as_tensor(
                _batch()[:2]), first=True, last=True, remat=remat, group=0,
                take=take)
        gc.collect()
        kept.extend(r for r in joined if not r.expired())
        return out.float().sum(), None

    ttrain.GradFold(placed).run(objective)
    assert joined and shapes
    hit = [s for s in saved if s in shapes]
    if remat:
        assert not kept and not hit, (len(kept), hit)
    else:
        assert kept and hit


def test_fsdp_forward_is_the_tensor_forward(trees):
    """Where the groups run the same rows (a one-row batch every group
    runs whole), the forward over an ``{fsdp: 2, tensor: 2}`` tree is
    bitwise the ``{tensor: 2}`` placed forward: the fsdp gathers join the
    pieces exactly. Both are within 2e-5 of the whole tree's."""
    _, tp = trees
    toks = torch.as_tensor(_batch(B=1))
    want, _ = forward(tp, toks, CFG)
    outs = []
    for axes in ({"fsdp": 2, "tensor": 2}, {"tensor": 2}):
        mesh, _ = _mesh(axes)
        placed = tmesh.put(mesh, tp, partition_specs(CFG, **_axes(axes)))
        out, _ = forward(placed, toks, CFG)
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0].numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)


# -- the worker ---------------------------------------------------------------
JOB = "ab12cd40"


class _Bridge:
    def __init__(self):
        self.sent = []
        # a continuous request's workers queue their chunks here
        self.q = types.SimpleNamespace(work=queue.Queue())

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
                           tmp_path_factory.mktemp("fsdp_ckpt") / "m"))


def _train(w, toks, tag):
    from tensorlink_tpu_torch.ml.module import _ce_sum_and_grad

    out = _call(w, "fwd", op="stage", train=True, tag=tag, tokens=toks)
    logits = torch.as_tensor(np.array(out["out"]))
    nll, dlogits, n = _ce_sum_and_grad(logits, toks,
                                       np.ones(toks.shape, bool))
    _call(w, "bwd", op="stage", tag=tag, grad=dlogits.numpy())
    body = _call(w, "opt", op="step", scale=1.0 / float(n))
    return float(nll) / float(n), body["grad_norm"]


def _params(w):
    return [np.asarray(a) for a in topt.tree_leaves(
        _call(w, "params.req")["params"])]


# tlint: disable=TL006(read-only test data)
WORKER_PLANS = {
    # the hint tests/test_planner.py fills with fsdp: {tensor: 2, fsdp: 2}
    "tensor-hint": ({"tensor": 2}, {"tensor": 2, "fsdp": 2}, "unsharded"),
    # ZeRO-1 over data composed with fsdp, as the JAX worker composes them
    "data-fsdp": ({"data": 2, "fsdp": 2}, {"data": 2, "fsdp": 2}, "zero1"),
}


@pytest.mark.parametrize("case", list(WORKER_PLANS))
def test_worker_trains_a_placed_fsdp_job_like_jax(checkpoint, tmp_path,
                                                  case):
    """A four-device port worker given the plan both packages' planners
    make for the case's ``parallelism`` hint places the job and trains
    its placed tree: two AdamW steps' losses and grad norms within rtol
    2e-5 of the JAX worker's on the same plan, each param leaf within
    2e-5 in its norm; no device holds more than its share of the params
    (1/(fsdp x tensor)) and optimizer state (over data too on ZeRO-1);
    the port's checkpoint restores on the JAX worker bit for bit."""
    hint, want_axes, mode = WORKER_PLANS[case]
    plan = tplanner.plan_sharding(
        CFG, [tplanner.WorkerCapacity("w0", 1 << 30, 4)], training=True,
        batch=4, seq_len=16, mesh_hints=hint)
    jplan = jplanner.plan_sharding(
        JCFG, [jplanner.WorkerCapacity("w0", 1 << 30, 4)], training=True,
        batch=4, seq_len=16, mesh_hints=hint)
    axes = plan.stages[0].mesh_axes
    assert axes == jplan.stages[0].mesh_axes == want_axes
    assert plan.update_mode == jplan.update_mode == mode
    stage = dict(dataclasses.asdict(plan.stages[0]))
    port, jw = _worker("port"), _worker("jax")
    for w in (port, jw):
        _call(w, "load_stage", stage=stage, training=True,
              model={"name": "tiny", "config": JCFG.to_json(),
                     "ckpt": checkpoint, "seed": 0})
        _call(w, "opt", op="init", spec={"name": "adamw", "lr": 1e-3})
    rt = port.jobs[JOB]
    assert rt.mesh.shape == want_axes
    full_p = sum(t.numel() * t.element_size()
                 for t in topt.tree_leaves(tmesh.full_tree(rt.params)))
    full_s = sum(t.numel() * t.element_size()
                 for t in topt.tree_leaves(tmesh.full_tree(rt.opt_state)))
    k_p = axes.get("fsdp", 1) * axes.get("tensor", 1)
    small = 8 * 1024  # the replicated norms and step counts
    for j in range(4):
        assert tmesh.shard_bytes(rt.params, j) <= full_p / k_p + small
        assert tmesh.shard_bytes(rt.opt_state, j) <= full_s / 4 + small
    rng = np.random.default_rng(11)
    for i in range(2):
        toks = rng.integers(0, JCFG.vocab_size, (4, 16)).astype(np.int32)
        got = _train(port, toks, f"s{i}")
        want = _train(jw, toks, f"s{i}")
        np.testing.assert_allclose(got, want, rtol=TOL)
        assert all(isinstance(g, tmesh.Sharded) or g is None
                   for g in topt.tree_leaves(rt.params))
    got = _params(port)
    for a, b in zip(got, _params(jw), strict=True):
        assert np.linalg.norm(a - b) <= TOL * np.linalg.norm(b)
    _call(port, "ckpt", op="save", dir=str(tmp_path))
    assert _call(jw, "ckpt", op="restore", dir=str(tmp_path))["restored_opt"]
    for a, b in zip(got, _params(jw), strict=True):
        assert np.array_equal(a, b)


# tlint: disable=TL006(read-only test data)
SERVE_REQUESTS = {
    "static": dict(prompts=[[7, 3, 9, 11, 2], [5, 1, 8]], max_new_tokens=8),
    "beam": dict(prompts=[[5, 9, 2, 7]], max_new_tokens=6, num_beams=3),
    "continuous": dict(prompts=[[7, 3, 9, 11, 2]], max_new_tokens=8,
                       continuous=True),
}


def _gen(w, rid: str, body: dict) -> dict:
    """One GENERATE's reply body: at once for the static paths, after the
    worker's slot-engine chunks (``cont_continue``) for a continuous
    one."""
    n = len(w.bridge.sent)
    w._handle("gen", {"rid": rid, "peer": "p1", "job_id": JOB, "seed": 0,
                      **body})
    for _ in range(100):
        out = [p["body"] for v, p in w.bridge.sent[n:]
               if v == "respond" and p["rid"] == rid]
        if out:
            assert "error" not in out[-1], out[-1]
            return out[-1]
        w._handle("cont_continue", {"job_id": JOB})
    raise AssertionError(f"no reply to {rid}")


@pytest.mark.parametrize("kind", list(SERVE_REQUESTS))
def test_fsdp_mesh_worker_serves_static_like_jax(checkpoint, kind):
    """A serving job on an ``{fsdp: 2, tensor: 2}`` plan loads, and its
    static, beam and continuous answers equal the JAX worker's on the same
    plan. A continuous request is served by the job's slot engine over
    the placed tree, as the JAX worker's ``ContinuousEngine`` serves it
    under GSPMD; the static ones by the dense engine's placed forward."""
    stage = {"worker_id": "w0", "layer_lo": 0, "layer_hi": JCFG.n_layers,
             "first": True, "last": True, "holds_head": True,
             "mesh_axes": {"fsdp": 2, "tensor": 2}, "coworkers": []}
    answers = []
    workers = []
    for pkg in ("port", "jax"):
        w = _worker(pkg)
        _call(w, "load_stage", stage=stage, training=False,
              model={"name": "tiny", "config": JCFG.to_json(),
                     "ckpt": checkpoint, "seed": 0})
        answers.append(_gen(w, "g1", SERVE_REQUESTS[kind]))
        workers.append(w)
    got, want = answers
    assert got["sequences"] == [list(map(int, s))
                                for s in want["sequences"]]
    cont = workers[0].jobs[JOB].cont
    if kind == "continuous":
        assert cont.chunks > 0 and cont._mesh.shape == stage["mesh_axes"]
        assert cont.cache.tp == 2 and "serving" in got
    else:
        assert cont is None


@pytest.mark.parametrize("case", list(MESHES))
def test_int8_engine_on_an_fsdp_mesh(case):
    """Weight-only int8 on an fsdp mesh (tests/test_quant.py:263's widths,
    whose stacked weights really quantize): each placed weight quantized
    as the whole weight, its codes split like the weight and its scales
    over the tensor axis only (the forward joins the codes' fsdp pieces),
    and the greedy tokens of the placed engine equal the unsharded
    engine's and JAX's."""
    from tensorlink_tpu.engine.generate import GenerationEngine as JGen
    from tensorlink_tpu_torch.engine.generate import GenerationEngine
    from tensorlink_tpu_torch.models.quant import QTensor
    from tensorlink_tpu_torch.models.transformer import cache_specs

    axes = MESHES[case]
    jcfg = dataclasses.replace(JCFG, vocab_size=512, d_model=128,
                               n_layers=4, d_ff=256)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    jp = j_init_params(jcfg, jax.random.PRNGKey(5))
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    mesh, _ = _mesh(axes)
    kw = dict(max_seq_len=64, seq_buckets=(32, 64), batch_buckets=(1, 2))
    one = GenerationEngine(cfg, tp, quant="int8", device="cpu", **kw)
    eng = GenerationEngine(
        cfg, tmesh.put(mesh, tp, partition_specs(cfg, **_axes(axes))),
        mesh=mesh, quant="int8", device="cpu",
        cache_specs=cache_specs(cfg, data_axis=None,
                                tensor_axis=_axes(axes)["tensor_axis"]),
        **kw)
    for name in ("w_gate", "w_down"):
        leaf = eng.params["layers"]["mlp"][name]
        whole = one.params["layers"]["mlp"][name]
        assert isinstance(leaf, QTensor) and leaf.q.n_fsdp == axes["fsdp"]
        assert torch.equal(leaf.q.full(), whole.q)
        assert torch.equal(leaf.scale.full(), whole.scale)
    prompts = [[5, 9, 2, 7, 11, 3]]
    want = JGen(jcfg, jp, quant="int8", **kw).generate_compiled(
        prompts, max_new_tokens=10).sequences
    assert one.generate_compiled(prompts, max_new_tokens=10).sequences \
        == want
    assert eng.generate_compiled(prompts, max_new_tokens=10).sequences \
        == want
