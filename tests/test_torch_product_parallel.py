"""The stage and seq mesh axes of the port through its product paths,
against the JAX package on the same weights and inputs (after
tests/test_product_parallel.py): the sequence-parallel stage forward,
the planner's stage and seq plans, a worker job planned over either axis,
and tensor-parallel serving with the quantized gathers
(``collective_quant``).

Held here, with tests/test_product_parallel.py's tolerances (3e-5 forward,
5e-4 gradients; the worker's answers at 2e-5, tests/test_torch_nodes.py):

- ``stage_forward(seq_mesh=)`` over ``{seq: 2}`` and ``{seq: 4}`` and its
  gradients against JAX's unsharded stage, the quantized ring within the
  int8 bound and bitwise across runs, and JAX's refusals;
- ``plan_sharding`` with stage and seq hints, and the default seq axis of a
  training job at ``seq_len >= 8192``, equal to JAX's plans, and every hint
  error with JAX's words;
- bare workers of both packages, each a tiny training job (a JAX-exported
  checkpoint) over ``{stage: 2}`` and over ``{seq: 2}``: the forward's
  logits against JAX's ``stage_forward`` and the JAX worker's, two SGD
  steps' losses and params against the JAX worker's;
- the tensor-parallel epilogue with ``collective_quant`` against the JAX
  tp step's quantized gathers (a layer's residual and the logits inside
  ``shard_map``), and a ``ContinuousEngine(tensor_parallel=2)`` over such
  a config: every gather of a split activation through
  ``quantized_all_gather``, the same streams run to run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.engine.loader import export_hf as j_export_hf
from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu.models.transformer import stage_forward as j_stage_forward
from tensorlink_tpu.parallel import planner as jplanner
from tensorlink_tpu.parallel.mesh import build_mesh as j_build_mesh
from tensorlink_tpu.parallel.mesh import get_shard_map
from tensorlink_tpu_torch.convert import config_from_jax, params_from_jax
from tensorlink_tpu_torch.engine import optimizers as topt
from tensorlink_tpu_torch.engine.continuous import ContinuousEngine
from tensorlink_tpu_torch.engine.generate import GenerationEngine
from tensorlink_tpu_torch.engine.sampling import SamplingParams
from tensorlink_tpu_torch.models.transformer import stage_forward
from tensorlink_tpu_torch.parallel import mesh as tmesh
from tensorlink_tpu_torch.parallel import planner as tplanner

# one intra-op thread: a JAX call in this process can leave torch's worker
# threads computing exp off by up to 1e-4 (tests/test_torch_flash.py)
torch.set_num_threads(1)

CPU = torch.device("cpu")
FWD_TOL = 3e-5  # tests/test_product_parallel.py seq forward
GRAD_TOL = 5e-4  # tests/test_product_parallel.py seq gradients
WORKER_TOL = 2e-5
# tests/test_product_parallel.py::CFG
JCFG = JModelConfig(
    family="llama", vocab_size=128, d_model=32, n_layers=4, n_heads=4,
    n_kv_heads=2, head_dim=8, d_ff=64, max_seq_len=64, dtype=jnp.float32,
)
CFG = config_from_jax(dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def trees():
    jp = jax.device_get(j_init_params(JCFG, jax.random.PRNGKey(3)))
    return jp, params_from_jax(jp, device="cpu")


def _toks(batch, T, seed):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, (batch, T)).astype(np.int32)


def _seq_mesh(n):
    return tmesh.build_mesh({"seq": n}, [CPU] * n)


# -- the sequence-parallel stage --------------------------------------------
@pytest.mark.parametrize("sp", [2, 4])
def test_seq_mesh_stage_forward_matches_jax(trees, sp):
    jp, tp = trees
    toks = _toks(2, 16, 0)
    want, _ = j_stage_forward(jp, JCFG, tokens=jnp.asarray(toks), first=True,
                              last=True)
    got, cache = stage_forward(tp, CFG, tokens=torch.as_tensor(toks),
                               first=True, last=True, seq_mesh=_seq_mesh(sp))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    # a hidden-state stage (no embedding, no head), rows placed likewise
    hid = np.random.default_rng(1).normal(
        size=(2, 16, JCFG.d_model)).astype(np.float32)
    sliced = {"layers": tp["layers"]}
    want, _ = j_stage_forward({"layers": jp["layers"]}, JCFG,
                              hidden=jnp.asarray(hid))
    got, _ = stage_forward(sliced, CFG, hidden=torch.as_tensor(hid),
                           seq_mesh=_seq_mesh(sp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_seq_mesh_stage_forward_grads_match_jax(trees):
    jp, tp = trees
    toks = _toks(1, 8, 5)

    def jloss(prm):
        out, _ = j_stage_forward(prm, JCFG, tokens=jnp.asarray(toks),
                                 first=True, last=True)
        return (out.astype(jnp.float32) ** 2).mean()

    want = jax.grad(jloss)(jp)
    prm = topt.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    out, _ = stage_forward(prm, CFG, tokens=torch.as_tensor(toks),
                           first=True, last=True, seq_mesh=_seq_mesh(2),
                           remat=True)
    (out.float() ** 2).mean().backward()
    got = topt.tree_leaves(topt.tree_map(lambda t: t.grad, prm))
    assert len(got) == len(jax.tree.leaves(want))
    for g, w in zip(got, jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_quantized_seq_stage_is_bounded_and_deterministic(trees):
    """``collective_quant`` selects the int8 ring: the logits move, stay
    within the ring's int8 bound of the exact ring's, and repeat
    bitwise."""
    _, tp = trees
    toks = torch.as_tensor(_toks(2, 16, 2))
    mesh = _seq_mesh(4)
    exact, _ = stage_forward(tp, CFG, tokens=toks, first=True, last=True,
                             seq_mesh=mesh)
    qcfg = CFG.with_(collective_quant=True)
    quant, _ = stage_forward(tp, qcfg, tokens=toks, first=True, last=True,
                             seq_mesh=mesh)
    diff = float((quant - exact).abs().max())
    assert 0 < diff < 0.06
    again, _ = stage_forward(tp, qcfg, tokens=toks, first=True, last=True,
                             seq_mesh=mesh)
    assert torch.equal(quant, again)


def test_seq_mesh_refusals_match_jax(trees):
    jp, tp = trees
    jm = j_build_mesh({"seq": 2}, jax.devices("cpu")[:2])
    toks = _toks(2, 8, 3)
    mask = np.ones((2, 8), bool)
    for kw, jkw in (
            (dict(attn_mask=torch.as_tensor(mask)),
             dict(attn_mask=jnp.asarray(mask))),):
        with pytest.raises(ValueError) as got:
            stage_forward(tp, CFG, tokens=torch.as_tensor(toks), first=True,
                          last=True, seq_mesh=_seq_mesh(2), **kw)
        with pytest.raises(ValueError) as want:
            j_stage_forward(jp, JCFG, tokens=jnp.asarray(toks), first=True,
                            last=True, seq_mesh=jm, **jkw)
        assert str(got.value) == str(want.value)


# -- the planner --------------------------------------------------------------
GB = 1e9
# (config overrides, devices, hints, seq_len, training)
# tlint: disable=TL006(read-only test data)
PLANS = {
    "stage2": ({}, 4, {"stage": 2}, 1024, True),
    "stage4": ({}, 4, {"stage": 4}, 1024, True),
    "seq2": ({}, 4, {"seq": 2}, 1024, True),
    "seq4": ({}, 4, {"seq": 4}, 1024, True),
    "seq-default": (dict(n_kv_heads=1), 4, None, 8192, True),
    "seq-default-kv2": ({}, 4, None, 8192, True),
    "seq-default-short": (dict(n_kv_heads=1), 4, None, 4096, True),
    "serving-8192": (dict(n_kv_heads=1), 4, None, 8192, False),
}
# tlint: disable=TL006(read-only test data)
HINT_ERRORS = {
    "stage-serving": ({}, 4, {"stage": 2}, 1024, False),
    "seq-serving": ({}, 4, {"seq": 2}, 1024, False),
    "stage-layers": ({}, 4, {"stage": 3}, 1024, True),
    "seq-len": ({}, 4, {"seq": 4}, 1022, True),
    "seq-window": (dict(sliding_window=16), 4, {"seq": 2}, 1024, True),
    "seq-and-stage": ({}, 4, {"seq": 2, "stage": 2}, 1024, True),
    "too-many": ({}, 4, {"stage": 4, "seq": 2}, 1024, True),
}


def _plan(pkg, kw, n, hints, seq_len, training):
    jcfg = dataclasses.replace(JCFG, **kw)
    if pkg == "jax":
        mod, cfg = jplanner, jcfg
    else:
        mod, cfg = tplanner, config_from_jax(dataclasses.asdict(jcfg))
    return mod.plan_sharding(cfg, [mod.WorkerCapacity("w0", 64 * GB, n)],
                             batch=2, seq_len=seq_len, training=training,
                             mesh_hints=hints)


@pytest.mark.parametrize("case", list(PLANS))
def test_stage_and_seq_plans_equal_jax(case):
    got, want = _plan("port", *PLANS[case]), _plan("jax", *PLANS[case])
    assert [dataclasses.asdict(s) for s in got.stages] == [
        dataclasses.asdict(s) for s in want.stages]
    assert (got.update_mode, got.n_micro) == (want.update_mode,
                                              want.n_micro)
    axes = got.stages[0].mesh_axes
    if case == "seq-default":
        # one kv head leaves tensor at 1: the seq axis takes the devices
        assert axes.get("seq", 1) > 1, axes
    if case in ("seq-default-short", "serving-8192"):
        assert axes.get("seq", 1) == 1, axes
    if case.startswith("stage"):
        # the stage specs split the layers, and mix in no other axis
        specs = tplanner.stage_param_specs(CFG, got.stages[0])
        assert specs["layers"]["attn"]["wq"] == tmesh.Split(0, "stage")
        assert specs["embed"]["tok"].dims() == (None,) * 4


@pytest.mark.parametrize("case", list(HINT_ERRORS))
def test_stage_and_seq_hint_errors_equal_jax(case):
    with pytest.raises(tplanner.AssignmentError) as got:
        _plan("port", *HINT_ERRORS[case])
    with pytest.raises(jplanner.AssignmentError) as want:
        _plan("jax", *HINT_ERRORS[case])
    assert str(got.value) == str(want.value)


# -- a worker job over either axis ---------------------------------------------
WCFG = JModelConfig(
    family="llama", vocab_size=128, d_model=48, n_layers=4, n_heads=4,
    n_kv_heads=2, head_dim=12, d_ff=96, max_seq_len=64, dtype=jnp.float32,
)
# tlint: disable=TL006(read-only test data)
SGD = {"name": "sgd", "lr": 0.1, "momentum": 0.9, "grad_clip": None}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    jp = jax.device_get(j_init_params(WCFG, jax.random.PRNGKey(21)))
    out = j_export_hf(WCFG, jp, tmp_path_factory.mktemp("jax_ckpt") / "m")
    return str(out), jp


def _job(pkg: str, ckpt: str, axes: dict):
    """A bare worker of ``pkg`` training the whole tiny model over
    ``axes``: its eval forward's logits, then two SGD steps' losses and
    the params after them."""
    from test_torch_train_nodes import JOB, bare_worker, call, params_of, \
        train_step

    w = bare_worker(pkg)
    stage = {"worker_id": "w0", "layer_lo": 0, "layer_hi": WCFG.n_layers,
             "first": True, "last": True, "holds_head": True,
             "mesh_axes": dict(axes), "coworkers": []}
    tag, body = call(w, "load_stage", stage=stage, training=True,
                     model={"name": "tiny", "config": WCFG.to_json(),
                            "ckpt": ckpt, "seed": 0})
    assert body.get("ok"), body
    toks = _toks(4, 12, 9)
    _, out = call(w, "fwd", op="stage", tokens=toks)
    call(w, "opt", op="init", spec=SGD)
    losses = [train_step(w, toks, f"t{i}") for i in range(2)]
    return np.asarray(out["out"]), losses, params_of(w), w


@pytest.mark.parametrize("axes", [{"stage": 2}, {"seq": 2}],
                         ids=["stage2", "seq2"])
def test_worker_job_over_the_axis_matches_jax(checkpoint, axes):
    ckpt, jp = checkpoint
    got, g_losses, g_params, w = _job("port", ckpt, axes)
    want, w_losses, w_params, _ = _job("jax", ckpt, axes)
    ref, _ = j_stage_forward(jp, WCFG, tokens=jnp.asarray(_toks(4, 12, 9)),
                             first=True, last=True)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=WORKER_TOL,
                               atol=WORKER_TOL)
    np.testing.assert_allclose(got, want, rtol=WORKER_TOL, atol=WORKER_TOL)
    np.testing.assert_allclose(g_losses, w_losses, rtol=WORKER_TOL)
    assert g_losses[1] < g_losses[0]
    assert len(g_params) == len(w_params)
    for a, b in zip(g_params, w_params):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)
    from test_torch_train_nodes import JOB

    rt = w.jobs[JOB]
    assert dict(rt.mesh.shape) == axes
    leaf = rt.params["layers"]["attn"]["wq"]
    assert isinstance(leaf, tmesh.Sharded)
    if "stage" in axes:  # each stage device holds half the layers
        assert leaf.spec == tmesh.Split(0, "stage")
        assert [t.shape[0] for t in leaf.shards] == [2, 2]
    else:
        assert leaf.pieces() == 1


# -- tensor-parallel serving with the quantized gathers -------------------------
QCFG = JModelConfig(
    family="llama", vocab_size=128, d_model=32, n_layers=2, n_heads=2,
    n_kv_heads=2, head_dim=16, d_ff=64, max_seq_len=64, dtype=jnp.float32,
    tie_embeddings=False, collective_quant=True,
)
# (prompt, n, sampling knobs, seed): tests/test_tp.py's MIXES, not
# speculative
# tlint: disable=TL006(read-only test data)
MIXES = [
    ([1, 2, 3], 10, {}, 0),
    ([4, 5, 6, 7], 8, dict(temperature=0.8, top_k=5), 3),
    ([5, 9] * 4, 12, {}, 7),
    ([5, 9] * 4, 9, dict(temperature=0.9, top_p=0.9), 11),
]
# tlint: disable=TL006(read-only test data)
ENGINE_KW = dict(max_slots=4, page_size=8, chunk_steps=4)


def _serve(ce, sp_cls):
    reqs = [ce.submit(p, max_new_tokens=n, sampling=sp_cls.make(**knobs),
                      seed=seed) for p, n, knobs, seed in MIXES]
    ce.run_until_idle()
    assert all(r.finished and r.error is None for r in reqs)
    return [list(r.tokens) for r in reqs]


def _layer_specs(jcfg):
    from jax.sharding import PartitionSpec as P

    from tensorlink_tpu.models.transformer import tp_partition_specs

    return jax.tree.map(lambda sp: P(*tuple(sp)[1:]),
                        tp_partition_specs(jcfg)["layers"],
                        is_leaf=lambda x: isinstance(x, P))


def test_quantized_tp_gathers_match_jax():
    """The tensor-parallel epilogue with ``collective_quant`` against the
    JAX tp step's own: a layer's ``_paged_residual`` (the heads, ``wo``'s
    output, the MLP's hidden and output each gathered int8) and the head's
    ``_logits`` inside ``shard_map`` over ``tp: 2``, JAX's ``_tp_gather``
    with ``tp_quant``; the port's ``_tp_residual`` and ``_tp_logits`` over
    a ``TPLayout(quant=True)`` of two host shards, within 2e-5 on every
    device's copy. (JAX's whole tp engine does not trace with
    ``collective_quant`` under the installed jax: its scan carry's
    varying axes disagree, the cause of tests/test_tp.py's red quantized
    gather test.)"""
    from jax.sharding import PartitionSpec as P

    from tensorlink_tpu.engine.paged import _paged_residual
    from tensorlink_tpu.models.transformer import _logits
    from tensorlink_tpu_torch.convert import tp_shards
    from tensorlink_tpu_torch.models.transformer import (
        TPLayout,
        _tp_logits,
        _tp_residual,
    )

    jm = j_build_mesh({"tp": 2}, jax.devices("cpu")[:2])
    sm = get_shard_map()
    host = jax.device_get(j_init_params(QCFG, jax.random.PRNGKey(0)))
    cfg = config_from_jax(dataclasses.asdict(QCFG))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, QCFG.d_model)).astype(np.float32)
    attn = rng.standard_normal((2, 5, QCFG.n_heads, QCFG.head_dim)).astype(
        np.float32)
    jlp = jax.tree.map(lambda a: jnp.asarray(a[0]), host["layers"])
    jres = sm(lambda a, b, lp: _paged_residual(a, b, lp, QCFG, "tp",
                                               True)[None],
              mesh=jm, in_specs=(P(), P(None, None, "tp", None),
                                 _layer_specs(QCFG)),
              out_specs=P("tp"))(jnp.asarray(x), jnp.asarray(attn), jlp)
    head = {"lm_head": jnp.asarray(host["lm_head"])}
    jlog = sm(lambda a, h: _logits(h, a, QCFG, "tp", True)[None], mesh=jm,
              in_specs=(P(), {"lm_head": P(None, "tp")}),
              out_specs=P("tp"))(jnp.asarray(x), head)
    shards = tp_shards(params_from_jax(host, device="cpu"), cfg, 2)
    lps = [{k: (v[0] if not isinstance(v, dict) else
                {n: t[0] for n, t in v.items()})
            for k, v in sh["layers"].items()} for sh in shards]
    lay = TPLayout([CPU, CPU], quant=True)
    parts = list(torch.chunk(torch.as_tensor(attn), 2, dim=2))
    got = _tp_residual({CPU: torch.as_tensor(x)}, parts, lps, cfg, lay)[CPU]
    logits = _tp_logits(shards, {CPU: torch.as_tensor(x)}, cfg, lay)
    for i in range(2):
        np.testing.assert_allclose(got.numpy(), np.asarray(jres)[i],
                                   rtol=WORKER_TOL, atol=WORKER_TOL)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlog)[i],
                                   rtol=WORKER_TOL, atol=WORKER_TOL)
    exact = _tp_residual({CPU: torch.as_tensor(x)}, parts, lps, cfg,
                         TPLayout([CPU, CPU]))[CPU]
    assert float((got - exact).abs().max()) > 0  # the gathers were int8


def test_quantized_tp_engine_serves(monkeypatch):
    """A ``ContinuousEngine(tensor_parallel=2)`` over a ``collective_quant``
    config: every gather of a split activation goes through
    ``quantized_all_gather`` (each layer's heads, ``wo``'s output, the
    MLP's hidden and output, then the logits), the streams finish, repeat
    run to run, and a greedy stream equals the exact tp=2 engine's or
    parts from it only where that engine's top two logits lie within
    int8's error of each other."""
    from tensorlink_tpu_torch.parallel import ring as tring

    host = jax.device_get(j_init_params(QCFG, jax.random.PRNGKey(0)))
    cfg = config_from_jax(dataclasses.asdict(QCFG))
    calls = []
    real = tring.quantized_all_gather

    def counted(parts, device, **kw):
        calls.append(len(parts))
        return real(parts, device, **kw)

    monkeypatch.setattr(tring, "quantized_all_gather", counted)

    def port(c):
        gen = GenerationEngine(c, params_from_jax(host, device="cpu"),
                               max_seq_len=64, device="cpu")
        return ContinuousEngine(gen, tensor_parallel=2,
                                tp_devices=[CPU, CPU], **ENGINE_KW)

    got = _serve(port(cfg), SamplingParams)
    assert calls and set(calls) == {2}
    per_forward = 4 * QCFG.n_layers + 1
    assert len(calls) % per_forward == 0
    n = len(calls)
    assert _serve(port(cfg), SamplingParams) == got
    assert len(calls) == 2 * n
    exact = _serve(port(cfg.with_(collective_quant=False)), SamplingParams)
    assert len(calls) == 2 * n  # the exact engine gathers in float
    for (p, _, knobs, _), a, b in zip(MIXES, got, exact):
        if not knobs:
            k = next((i for i, (u, v) in enumerate(zip(a, b)) if u != v),
                     None)
            assert k is None or k > 0, (p, a, b)
