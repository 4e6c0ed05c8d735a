"""The port's placement over a ``{data, tensor}`` mesh and the dense
engine, forward and worker on it (tensorlink_tpu_torch/parallel/mesh.py
``Split``/``put``/``take_rows``, models/transformer.py
``partition_specs``/``cache_specs``, models/sharded.py, the
``GenerationEngine(mesh=, cache_specs=)``, parallel/planner.py
``stage_param_specs``/``stage_cache_specs``, the worker's planned stage
mesh) against the JAX package on the same numpy-seeded weights.

The port's shards lie on the CPU (``[cpu] * 4``: it names its devices),
JAX's on the conftest's virtual host devices. Held here:

- placement: each shard's piece equals JAX's ``addressable_shards`` on
  the same device for the same spec (bitwise), ``full()`` joins exactly,
  the row gather reads the shard that holds each row, and the axes the
  port does not place refuse naming their ROADMAP item;
- the spec trees: the port's ``partition_specs``, ``cache_specs``,
  ``stage_param_specs`` and ``stage_cache_specs`` split the same
  dimensions over the same axes as JAX's, leaf for leaf;
- the engine on a mesh (tests/test_ops.py:644, tests/test_quant.py:263,
  tests/test_engine.py:785): greedy streams, beams and lookahead equal to
  the port's unsharded engine and to JAX's sharded and unsharded engines
  over fp, int8 and int8+kv; prefill logits within 2e-4 of each (JAX's
  own bound: the Megatron layout's row-split ``wo``/``w_down`` sum two
  partial products, which rounds differently from one whole product, and
  a data shard's GEMMs run at half the height);
- the flash prefill per shard: ``_fmesh`` is the mesh and the kernel's
  plain version runs once per (data, tensor) shard and layer; heads the
  tensor axis does not divide (or qk_norm_full) joined on each device,
  and MoE experts split by their hidden dim, equal to JAX's GSPMD engine;
- a CPU worker with a ``{data: 2, tensor: 2}`` plan: static, beam and
  lookahead answers equal to the JAX worker's; two ZeRO-1 training steps
  equal to the JAX worker's (loss rtol 1e-5, each param leaf within 2e-4
  in its norm, the cross-package AdamW bound of
  tests/test_torch_training.py) and bitwise the port's one-device
  worker's; its optimizer state 1/dp per replica; a restore re-placed on
  the mesh; too few devices fail the load; and through a cluster, a
  ``DistributedModel(parallelism={"data": 2, "tensor": 2})`` planned onto
  a worker advertising four host devices serves and trains (ZeRO-1) as
  the unsharded port does.
"""

import dataclasses
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from tensorlink_tpu.engine.generate import GenerationEngine as JGen
from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu.models.transformer import cache_specs as j_cache_specs
from tensorlink_tpu.models.transformer import (
    partition_specs as j_partition_specs,
)
from tensorlink_tpu.parallel import planner as jplanner
from tensorlink_tpu.parallel.mesh import build_mesh as j_build_mesh
from tensorlink_tpu_torch.convert import (
    config_from_jax,
    mesh_shards,
    params_from_jax,
)
from tensorlink_tpu_torch.engine import optimizers as topt
from tensorlink_tpu_torch.engine.generate import GenerationEngine
from tensorlink_tpu_torch.models.quant import QTensor, quantize_tensor
from tensorlink_tpu_torch.models.transformer import (
    cache_specs,
    forward,
    partition_specs,
)
from tensorlink_tpu_torch.ops import attention as tatt
from tensorlink_tpu_torch.parallel import mesh as tmesh
from tensorlink_tpu_torch.parallel import planner as tplanner

# one intra-op thread: a JAX call in this process can leave torch's worker
# threads computing exp off by up to 1e-4 (tests/test_torch_flash.py)
torch.set_num_threads(1)

CPU = torch.device("cpu")
# tlint: disable=TL006(read-only test data)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_ops.py:644-690

JCFG = JModelConfig(
    family="llama", vocab_size=256, d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, max_seq_len=128,
    dtype=jnp.float32, tie_embeddings=False,
)
CFG = config_from_jax(dataclasses.asdict(JCFG))
# tlint: disable=TL006(read-only test data)
KW = dict(seq_buckets=(32, 128), batch_buckets=(1, 2, 4), max_seq_len=128)
# tlint: disable=TL006(read-only test data)
PROMPTS = [[7, 3, 9, 11, 2], [5, 1, 8]]


def _mesh(axes: dict):
    n = int(np.prod(list(axes.values())))
    return (tmesh.build_mesh(axes, [CPU] * n),
            j_build_mesh(axes, jax.devices("cpu")[:n]))


def _parts(spec, ndim: int) -> tuple:
    """A JAX PartitionSpec as one entry per dimension."""
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


@pytest.fixture(scope="module")
def trees():
    jp = j_init_params(JCFG, jax.random.PRNGKey(3))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


# tests/test_quant.py:263's model: its stacked weights clear
# quantize_params' min_size, so they really quantize
QJCFG = dataclasses.replace(JCFG, vocab_size=512, d_model=128, n_layers=4,
                            head_dim=32, d_ff=256)
QCFG = config_from_jax(dataclasses.asdict(QJCFG))


@pytest.fixture(scope="module")
def qtrees():
    jp = j_init_params(QJCFG, jax.random.PRNGKey(6))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _engines(trees, axes, quant=None, data_axis="data", flash=True,
             jcfg=JCFG, jax_data_axis="data"):
    """(port unsharded, port on ``axes``, JAX unsharded, JAX on ``axes``)
    engines over the same weights, both sharded trees placed by the
    Megatron ``partition_specs``. ``jax_data_axis=None`` keeps the JAX
    engine's cache batch whole, as the JAX worker does: its engine
    cannot place a one-row prefill (beam, lookahead) on a data axis,
    where the port's keeps that batch whole by itself."""
    jp, tp = trees
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    mesh, jm = _mesh(axes)
    da = data_axis if "data" in axes else None
    # heads the tensor axis splits (else the cache stays whole over it)
    heads = not (jcfg.n_heads % mesh.shape.get("tensor", 1)
                 or jcfg.n_kv_heads % mesh.shape.get("tensor", 1)
                 or jcfg.qk_norm_full)
    port = GenerationEngine(cfg, tp, quant=quant, device="cpu", **KW)
    placed = tmesh.put(mesh, tp, partition_specs(cfg))
    sharded = GenerationEngine(
        cfg.with_(flash_attention=flash), placed, mesh=mesh, quant=quant,
        cache_specs=cache_specs(cfg, data_axis=da) if heads else None, **KW)
    jsharded_p = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(jm, s)), jp,
        j_partition_specs(jcfg, tensor_axis="tensor"))
    jax_one = JGen(jcfg, jp, quant=quant, **KW)
    jda = da if jax_data_axis else None
    jax_mesh = JGen(jcfg, jsharded_p, mesh=jm, quant=quant,
                    cache_specs=j_cache_specs(
                        jcfg, data_axis=jda,
                        tensor_axis="tensor" if heads else None), **KW)
    return port, sharded, jax_one, jax_mesh, mesh


# -- placement ---------------------------------------------------------------
@pytest.mark.parametrize("spec", [
    (tmesh.Split(2, "tensor", 1), P(None, "data", "tensor")),
    (tmesh.Split(3, "tensor"), P(None, None, None, "tensor")),
    (tmesh.Split(1, "data"), P(None, "data")),
    (tmesh.Split(0, ("data", "tensor")), P(("data", "tensor"))),
    (tmesh.REPLICATED, P()),
], ids=["data+tensor", "tensor", "data", "flattened", "replicated"])
def test_pieces_equal_jax_addressable_shards(spec):
    """Each flattened device's piece is the piece JAX's ``NamedSharding``
    puts on the same device (bitwise), ``full()`` joins exactly, and a
    replicated piece is one tensor per device."""
    port_spec, jspec = spec
    mesh, jm = _mesh({"data": 2, "tensor": 2})
    x = np.arange(4 * 4 * 8 * 2, dtype=np.float32).reshape(4, 4, 8, 2)
    placed = tmesh.put(mesh, torch.as_tensor(x), port_spec)
    jx = jax.device_put(jnp.asarray(x), NamedSharding(jm, jspec))
    by_dev = {s.device: np.asarray(s.data) for s in jx.addressable_shards}
    for j, d in enumerate(jm.devices.reshape(-1)):
        np.testing.assert_array_equal(placed.shards[j].numpy(), by_dev[d])
        np.testing.assert_array_equal(
            tmesh.piece(x, port_spec, mesh, j), by_dev[d])
    assert torch.equal(placed.full(), torch.as_tensor(x))
    assert port_spec.parts(4) == _parts(jspec, 4)
    assert len({id(t) for t in placed.shards}) == len(
        {tuple(np.asarray(b).ravel()[:4]) for b in by_dev.values()})
    z = tmesh.zeros(mesh, x.shape, torch.int8, port_spec)
    assert [tuple(t.shape) for t in z.shards] == [
        b.shape for b in by_dev.values()]


@pytest.mark.parametrize("axis,beside,item", [
    ("seq", "expert", 5), ("stage", "tensor", 4), ("seq", "tensor", 5),
    ("stage", "fsdp", 4)])
def test_unplaced_axes_refuse_naming_their_item(axis, beside, item):
    """The stage axis (ROADMAP queue 1 item 4) and the seq axis (item 5)
    are placed now: a leaf splits over either beside another axis, each
    device holding its piece, as JAX's ``addressable_shards`` do, and no
    refusal names either item."""
    mesh, jm = _mesh({axis: 2, beside: 2})
    x = np.arange(4 * 4 * 4, dtype=np.float32).reshape(4, 4, 4)
    spec = {"tensor": tmesh.Split(0, (axis, "tensor")),
            "expert": tmesh.Split(0, axis, expert_dim=1),
            "fsdp": tmesh.Split(0, axis, fsdp_dim=1)}[beside]
    placed = tmesh.put(mesh, torch.as_tensor(x), spec)
    jplaced = jax.device_put(jnp.asarray(x), NamedSharding(
        jm, P(*spec.parts(3))))
    by_dev = {s.device: np.asarray(s.data) for s in jplaced.addressable_shards}
    for j, d in enumerate(jm.devices.reshape(-1)):
        np.testing.assert_array_equal(placed.shards[j].numpy(), by_dev[d])
    assert torch.equal(placed.full(), torch.as_tensor(x))
    assert not hasattr(tmesh, "_UNPORTED_AXES")
    assert item in (4, 5)


@pytest.mark.parametrize("dest", ["data", "whole"])
def test_take_rows_reads_the_row_from_its_shard(dest):
    """The cross-shard row gather (the beam reorder on a data-split
    cache): every result row is the source's row ``idx[i]``, bitwise,
    whichever data shard holds it, into a data-split or whole batch."""
    mesh, _ = _mesh({"data": 2, "tensor": 2})
    x = torch.arange(2 * 4 * 3 * 2 * 2, dtype=torch.float32).reshape(
        2, 4, 3, 2, 2)
    src = tmesh.put(mesh, x, tmesh.Split(3, "tensor", 1))
    idx = torch.tensor([3, 0, 0, 2])  # rows 3 and 2 live in data shard 1
    spec = tmesh.Split(3, "tensor", 1 if dest == "data" else None)
    got = tmesh.take_rows(src, idx, 1, spec)
    assert torch.equal(got.full(), x[:, idx])
    assert got.grid == ((2, 2) if dest == "data" else (2, 1))


# -- spec trees --------------------------------------------------------------
# tlint: disable=TL006(read-only test data)
SPEC_CONFIGS = [
    dict(),
    dict(tie_embeddings=True, family="qwen3", qk_norm=True),
    dict(family="gpt2", norm="layernorm", mlp="fused", pos="learned",
         attn_bias=True),
    dict(mlp_bias=True, attn_out_bias=True),
    dict(n_experts=4, n_experts_per_tok=2),
]


def _walk_specs(port, jax_specs, params, path=""):
    if isinstance(jax_specs, dict):
        assert isinstance(port, dict) and set(port) == set(jax_specs), path
        for k in jax_specs:
            _walk_specs(port[k], jax_specs[k], params[k], f"{path}/{k}")
        return
    assert isinstance(port, tmesh.Split), path
    nd = len(params.shape)
    assert port.parts(nd) == _parts(jax_specs, nd), path


@pytest.mark.parametrize("kw", SPEC_CONFIGS,
                         ids=[str(i) for i in range(len(SPEC_CONFIGS))])
@pytest.mark.parametrize("tensor_axis", ["tensor", None])
def test_partition_specs_match_jax(kw, tensor_axis):
    jcfg = dataclasses.replace(JCFG, **kw)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    jp = jax.eval_shape(lambda: j_init_params(jcfg, jax.random.PRNGKey(0)))
    _walk_specs(partition_specs(cfg, tensor_axis=tensor_axis),
                j_partition_specs(jcfg, tensor_axis=tensor_axis), jp)
    _walk_specs(partition_specs(cfg, tensor_axis=tensor_axis,
                                expert_axis="expert"),
                j_partition_specs(jcfg, tensor_axis=tensor_axis,
                                  expert_axis="expert"), jp)


# tlint: disable=TL006(read-only test data)
STAGES = [
    dict(first=True, last=True, holds_head=True),
    dict(first=True, last=False, holds_head=False),
    dict(first=False, last=True, holds_head=True),
    dict(first=False, last=True, holds_head=False),
]
# tlint: disable=TL006(read-only test data)
MESHES = [{"data": 2, "tensor": 2}, {"tensor": 2}, {"data": 2}]


@pytest.mark.parametrize("stage", STAGES, ids=[str(i) for i in range(4)])
@pytest.mark.parametrize("axes", MESHES, ids=["dt", "t", "d"])
@pytest.mark.parametrize("tie", [False, True])
def test_stage_specs_match_jax(stage, axes, tie):
    jcfg = dataclasses.replace(JCFG, tie_embeddings=tie)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    plan = dict(worker_id="w", layer_lo=0, layer_hi=2, mesh_axes=axes,
                **stage)
    jspecs = jplanner.stage_param_specs(jcfg, jplanner.StagePlan(**plan))
    specs = tplanner.stage_param_specs(cfg, tplanner.StagePlan(**plan))
    jp = jax.eval_shape(lambda: j_init_params(jcfg, jax.random.PRNGKey(0)))
    _walk_specs(specs, jspecs, {k: jp[k] for k in jspecs})
    jc = jplanner.stage_cache_specs(jcfg, jplanner.StagePlan(**plan))
    tc = tplanner.stage_cache_specs(cfg, tplanner.StagePlan(**plan))
    assert tc.k.parts(5) == _parts(jc.k, 5)
    assert tc.v.parts(5) == _parts(jc.v, 5)
    assert tc.length.parts(1) == _parts(jc.length, 1)
    # a stage axis splits every layer leaf's leading dim over stage, and
    # mixes in no tensor split, as JAX's P("stage", ...)
    staged = dict(plan, mesh_axes={"stage": 2, **axes})
    jspecs = jplanner.stage_param_specs(jcfg, jplanner.StagePlan(**staged))
    specs = tplanner.stage_param_specs(cfg, tplanner.StagePlan(**staged))
    _walk_specs(specs, jspecs, {k: jp[k] for k in jspecs})


def test_placed_tree_equals_jax_addressable_shards(trees):
    """The same weights placed by both packages' ``partition_specs``: the
    port's shard ``j`` of every leaf is JAX's addressable shard on device
    ``j``, and ``convert.mesh_shards`` of the JAX tree is the same."""
    jp, tp = trees
    mesh, jm = _mesh({"data": 2, "tensor": 2})
    placed = tmesh.put(mesh, tp, partition_specs(CFG))
    jplaced = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(jm, s)), jp,
        j_partition_specs(JCFG))
    split = mesh_shards(jax.device_get(jp), partition_specs(CFG), mesh)
    devs = list(jm.devices.reshape(-1))
    for (path, jleaf) in jax.tree_util.tree_flatten_with_path(jplaced)[0]:
        keys = [k.key for k in path]
        leaf, piece = placed, split
        for k in keys:
            leaf = leaf[k]
        by_dev = {s.device: np.asarray(s.data)
                  for s in jleaf.addressable_shards}
        for j, d in enumerate(devs):
            got = split[j]
            for k in keys:
                got = got[k]
            np.testing.assert_array_equal(leaf.shards[j].numpy(), by_dev[d])
            np.testing.assert_array_equal(got, by_dev[d])


# -- the forward and the engine on a mesh ------------------------------------
@pytest.mark.parametrize("layout", ["megatron", "serving"])
def test_placed_forward_matches_whole(trees, layout):
    """The forward over a placed tree, with and without a placed cache:
    within 2e-4 of the whole tree's under the Megatron specs (the
    row-split products' fixed-order sum), bitwise under the serving
    specs (every product column-split, every join a concatenation)."""
    from tensorlink_tpu_torch.models.base import KVCache
    from tensorlink_tpu_torch.models.transformer import tp_partition_specs

    _, tp = trees
    if layout == "megatron":
        mesh, _ = _mesh({"data": 2, "tensor": 2})
        specs, ax = partition_specs(CFG), "tensor"
    else:
        mesh = tmesh.serving_mesh(2, dp=2, devices=[CPU] * 4)
        specs, ax = tp_partition_specs(CFG), "tp"
    placed = tmesh.put(mesh, tp, specs)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (4, 8)), dtype=torch.int32)
    want, _ = forward(tp, toks, CFG)
    got, _ = forward(placed, toks, CFG)
    cs = cache_specs(CFG, tensor_axis=ax)
    c0 = KVCache.init(CFG, 4, 32, device="cpu")
    c1 = KVCache(k=tmesh.zeros(mesh, c0.k.shape, c0.k.dtype, cs.k),
                 v=tmesh.zeros(mesh, c0.v.shape, c0.v.dtype, cs.v),
                 length=torch.zeros(4, dtype=torch.int32))
    w1, c0 = forward(tp, toks, CFG, cache=c0)
    g1, c1 = forward(placed, toks, CFG, cache=c1)
    assert torch.equal(c1.length, c0.length)
    if layout == "serving":
        assert torch.equal(got, want) and torch.equal(g1, w1)
        assert torch.equal(c1.k.full(), c0.k)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGIT_TOL)
        np.testing.assert_allclose(g1.numpy(), w1.numpy(), **LOGIT_TOL)
        np.testing.assert_allclose(c1.k.full().numpy(), c0.k.numpy(),
                                   **LOGIT_TOL)


def test_sharded_flash_engine_matches_dense(trees):
    """tests/test_ops.py:644: the flash engine on a ``{data: 2, tensor:
    2}`` mesh runs the kernel per shard (``_fmesh`` is its mesh; the
    plain version once per shard and layer on the CPU), and its greedy
    tokens equal the unsharded engines' and JAX's sharded engine's;
    logits within 2e-4."""
    port, flash, jax_one, jax_mesh, mesh = _engines(
        trees, {"data": 2, "tensor": 2})
    assert flash._fmesh is mesh and port._fmesh is None
    calls = tatt.flash_attention_ref.calls
    r_f = flash.generate_compiled(PROMPTS, max_new_tokens=10)
    assert flash.flash_prefills == 1
    assert tatt.flash_attention_ref.calls - calls == CFG.n_layers * 4
    want = jax_one.generate_compiled(PROMPTS, max_new_tokens=10).sequences
    assert r_f.sequences == want
    assert port.generate_compiled(PROMPTS, max_new_tokens=10).sequences \
        == want
    assert jax_mesh.generate_compiled(PROMPTS,
                                      max_new_tokens=10).sequences == want
    lg = flash.prefill(PROMPTS)[0].numpy()
    for ref in (port.prefill(PROMPTS)[0].numpy(),
                np.asarray(jax_one.prefill(PROMPTS)[0]),
                np.asarray(jax_mesh.prefill(PROMPTS)[0])):
        np.testing.assert_allclose(lg, ref, **LOGIT_TOL)


@pytest.mark.parametrize("quant", ["int8", "int8+kv"])
def test_int8_sharded_mesh_parity(qtrees, quant):
    """tests/test_quant.py:263: weight-only int8 (and the int8 cache)
    composes with a ``{data: 2, tensor: 2}`` mesh: each placed weight is
    quantized as the whole weight (codes and scales bitwise the
    unsharded tree's, the codes still split over ``tensor``), and the
    greedy tokens equal every engine's."""
    port, eng, jax_one, jax_mesh, _ = _engines(
        qtrees, {"data": 2, "tensor": 2}, quant=quant, data_axis=None,
        flash=False, jcfg=QJCFG)
    wq = eng.params["layers"]["attn"]["wq"]
    wo = eng.params["layers"]["attn"]["wo"]
    assert isinstance(wq, QTensor) and wq.q.grid == (2, 1)
    for leaf, whole in ((wq, port.params["layers"]["attn"]["wq"]),
                        (wo, port.params["layers"]["attn"]["wo"])):
        assert torch.equal(leaf.q.full(), whole.q)
        assert torch.equal(leaf.scale.full(), whole.scale)
    prompts = [[5, 9, 2, 7, 11, 3]]
    want = jax_one.generate_compiled(prompts, max_new_tokens=10).sequences
    assert eng.generate_compiled(prompts, max_new_tokens=10).sequences \
        == want
    assert port.generate_compiled(prompts, max_new_tokens=10).sequences \
        == want
    assert jax_mesh.generate_compiled(prompts,
                                      max_new_tokens=10).sequences == want


@pytest.mark.parametrize("axes", [{"tensor": 2}, {"data": 2, "tensor": 2}],
                         ids=["tensor", "data+tensor"])
def test_beam_search_sharded_mesh_parity(trees, axes):
    """tests/test_engine.py:785: beam search on a mesh emits the
    unsharded beams; on a data-split cache each reorder reads a parent
    from the data shard that holds it (``take_rows``)."""
    port, eng, jax_one, jax_mesh, _ = _engines(trees, axes, flash=False,
                                               jax_data_axis=None)
    prompt = [5, 9, 2, 7]
    want = jax_one.generate_beam([prompt], num_beams=4,
                                 max_new_tokens=8).sequences
    assert eng.generate_beam([prompt], num_beams=4,
                             max_new_tokens=8).sequences == want
    assert port.generate_beam([prompt], num_beams=4,
                              max_new_tokens=8).sequences == want
    assert jax_mesh.generate_beam([prompt], num_beams=4,
                                  max_new_tokens=8).sequences == want


def test_lookahead_and_chunked_on_mesh(trees):
    """Lookahead over the sharded cache (its verify passes and length
    rollbacks), the chunked decode's shrinking batch (a row gather across
    data shards) and the prefix LRU all emit the unsharded tokens."""
    port, eng, jax_one, jax_mesh, _ = _engines(
        trees, {"data": 2, "tensor": 2}, flash=False, jax_data_axis=None)
    rep = [[5, 9, 2, 7, 5, 9, 2, 7, 5, 9]]
    want = jax_one.generate_lookahead(rep, max_new_tokens=12).sequences
    assert eng.generate_lookahead(rep, max_new_tokens=12).sequences == want
    assert jax_mesh.generate_lookahead(rep,
                                       max_new_tokens=12).sequences == want
    four = PROMPTS + [[1, 2], [9, 9, 9, 4, 4]]
    budgets = [2, 10, 3, 6]
    want = port.generate_chunked(four, max_new_tokens=10, chunk_steps=2,
                                 budgets=budgets).sequences
    assert eng.generate_chunked(four, max_new_tokens=10, chunk_steps=2,
                                budgets=budgets).sequences == want
    assert eng.last_chunk_batches[-1] < 4  # it shrank across data shards
    eng.generate([[1, 2, 3, 4, 5]], max_new_tokens=3, reuse_prefix=True)
    got = eng.generate([[1, 2, 3, 4, 5, 6, 7]], max_new_tokens=4,
                       reuse_prefix=True).sequences
    assert got == port.generate([[1, 2, 3, 4, 5, 6, 7]],
                                max_new_tokens=4).sequences


def test_quantized_placed_weight_is_the_whole_weights_codes(trees):
    """``_quantize_placed``: a row-split weight's scales are the whole
    contraction's (kept whole), a column-split weight's split with it."""
    _, tp = trees
    mesh, _ = _mesh({"data": 2, "tensor": 2})
    placed = tmesh.put(mesh, tp, partition_specs(CFG))
    from tensorlink_tpu_torch.models.quant import quantize_params

    q = quantize_params(placed, min_size=1)["layers"]
    for name, grid in (("wo", (1, 1)), ("wq", (2, 1))):
        whole = quantize_tensor(tp["layers"]["attn"][name])
        leaf = q["attn"][name]
        assert leaf.scale.grid == grid
        assert torch.equal(leaf.q.full(), whole.q)
        assert torch.equal(leaf.scale.full(), whole.scale)


# -- the worker's planned mesh ------------------------------------------------
# tlint: disable=TL006(read-only test data)
PLAN_AXES = {"data": 2, "tensor": 2}
JOB = "ab12cd34"


class _Bridge:
    def __init__(self):
        self.sent = []

    def request(self, verb, payload, timeout=None):
        self.sent.append((verb, payload))
        return {"ok": True}


def _worker(pkg: str, mesh_devices: int = 4):
    if pkg == "port":
        from tensorlink_tpu_torch.core import config as C
        from tensorlink_tpu_torch.ml.worker import DistributedWorker

        ml = C.MLConfig(device="cpu", max_seq_len=128,
                        mesh_devices=mesh_devices, seq_buckets=(32, 128),
                        batch_buckets=(1, 2, 4), warmup_tokens=0)
    else:
        from tensorlink_tpu.core import config as C
        from tensorlink_tpu.ml.worker import DistributedWorker

        ml = C.MLConfig(max_seq_len=128, seq_buckets=(32, 128),
                        batch_buckets=(1, 2, 4), warmup_tokens=0)
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
    return out[-1]["body"]


def _load(w, ckpt, axes=PLAN_AXES, training=False):
    stage = {"worker_id": "w0", "layer_lo": 0, "layer_hi": JCFG.n_layers,
             "first": True, "last": True, "holds_head": True,
             "mesh_axes": dict(axes), "coworkers": []}
    return _call(w, "load_stage", stage=stage, training=training,
                 model={"name": "tiny", "config": JCFG.to_json(),
                        "ckpt": ckpt, "seed": 0})


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, trees):
    from tensorlink_tpu.engine.loader import export_hf as j_export_hf

    jp, _ = trees
    out = j_export_hf(JCFG, jax.device_get(jp),
                      tmp_path_factory.mktemp("mesh_ckpt") / "m")
    return str(out)


# tlint: disable=TL006(read-only test data)
REQUESTS = {
    "static": dict(prompts=[[7, 3, 9, 11, 2], [5, 1, 8]],
                   max_new_tokens=8),
    "beam": dict(prompts=[[5, 9, 2, 7]], max_new_tokens=6, num_beams=3),
    "lookahead": dict(prompts=[[5, 9, 2, 7, 5, 9, 2, 7]], max_new_tokens=8,
                      lookahead=True),
}


@pytest.mark.parametrize("kind", list(REQUESTS))
def test_mesh_worker_serves_like_jax(checkpoint, kind):
    """A CPU worker with a ``{data: 2, tensor: 2}`` plan places the stage
    on its mesh and answers static, beam and lookahead requests with the
    JAX worker's tokens on the same plan."""
    port, jw = _worker("port"), _worker("jax")
    for w in (port, jw):
        assert _load(w, checkpoint)["ok"]
    rt = port.jobs[JOB]
    assert rt.mesh.shape == PLAN_AXES and rt.engine.mesh is rt.mesh
    assert tmesh.is_sharded(rt.params) and rt.engine.params is rt.params
    body = dict(REQUESTS[kind], seed=0)
    got = _call(port, "gen", **body)
    want = _call(jw, "gen", **body)
    assert got["sequences"] == [list(map(int, s))
                                for s in want["sequences"]]


def _batches(n, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, JCFG.vocab_size, (4, 16)).astype(np.int32)
            for _ in range(n)]


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


def test_mesh_worker_trains_zero1_like_jax(checkpoint, tmp_path):
    """Two ZeRO-1 steps on the ``{data: 2, tensor: 2}`` plan: losses and
    grad norms within rtol 1e-5 of the JAX worker's and of the port's
    one-device worker's, each param leaf within 2e-4 of theirs in its norm
    (both packages train the placed tree, whose row-split products and
    input gradients sum partial products); the optimizer state lives 1/dp
    per data replica; a saved checkpoint restores re-placed on the mesh,
    state included."""
    port, jw, one = _worker("port"), _worker("jax"), _worker("port")
    for w, axes in ((port, PLAN_AXES), (jw, PLAN_AXES), (one, {})):
        assert _load(w, checkpoint, axes=axes, training=True)["ok"]
        _call(w, "opt", op="init", spec={"name": "adamw", "lr": 1e-3})
    rt = port.jobs[JOB]
    assert rt.mesh is not None and port._zero1_dp(rt) == 2
    mu = rt.opt_state[1][0][1]["layers"]["attn"]["wq"]
    assert isinstance(mu, tmesh.Sharded) and mu.grid == (2, 2)
    full = sum(t.numel() * t.element_size()
               for t in topt.tree_leaves(tmesh.full_tree(rt.opt_state)))
    per = tmesh.shard_bytes(rt.opt_state, 0)
    assert per < full / 2 + 1024, (per, full)
    for i, toks in enumerate(_batches(2)):
        lp, gp = _train(port, toks, f"s{i}m0")
        lj, gj = _train(jw, toks, f"s{i}m0")
        lo, go = _train(one, toks, f"s{i}m0")
        np.testing.assert_allclose((lp, gp), (lo, go), rtol=1e-5)
        np.testing.assert_allclose(lp, lj, rtol=1e-5)
        np.testing.assert_allclose(gp, gj, rtol=1e-5)
    for a, b, c in zip(_params(port), _params(jw), _params(one),
                       strict=True):
        assert np.linalg.norm(a - c) <= 2e-4 * np.linalg.norm(c)
        assert np.linalg.norm(a - b) <= 2e-4 * np.linalg.norm(b)
    assert tmesh.is_sharded(rt.params)
    _call(port, "ckpt", op="save", dir=str(tmp_path))
    before = _params(port)
    _train(port, _batches(1, seed=9)[0], "s9m0")
    assert _call(port, "ckpt", op="restore",
                 dir=str(tmp_path))["restored_opt"]
    assert tmesh.is_sharded(rt.params) and rt.engine.params is rt.params
    assert isinstance(rt.opt_state[1][0][1]["layers"]["attn"]["wq"],
                      tmesh.Sharded)
    for a, b in zip(_params(port), before, strict=True):
        assert np.array_equal(a, b)


def test_mesh_worker_with_too_few_devices_fails_the_load(monkeypatch,
                                                         checkpoint):
    """A card worker takes distinct cards from its own on; fewer than the
    plan's mesh fail the load before any weight is made (the JAX worker
    runs unsharded then; the port never serves on fewer shards)."""
    cards = [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(tmesh, "local_devices", lambda: list(cards))
    w = _worker("port")
    w.device = torch.device("cuda", 1)
    assert w._mesh_devices(3) == cards[1:]
    with pytest.raises(ValueError, match="mesh needs 4 devices, have 3"):
        _load(w, checkpoint)
    assert JOB not in w.jobs


def test_mesh_worker_capacity_counts_a_repeated_host_once():
    """A CPU worker advertising a four-device mesh repeats its host: it
    advertises four devices and the host's memory once, as a one-device
    worker does (so the planner's per-device share is a quarter of it)."""
    one, four = _worker("port", mesh_devices=1), _worker("port")
    assert one.capacity()["n_devices"] == 1
    assert four.capacity()["n_devices"] == 4
    assert four.capacity()["hbm_bytes"] == one.capacity()["hbm_bytes"] > 0


# tlint: disable=TL006(read-only test data)
LAYOUTS = {
    "indivisible": (dict(n_heads=6, n_kv_heads=2, d_model=96),
                    {"tensor": 4}),
    "qk_norm_full": (dict(qk_norm_full=True), {"data": 2, "tensor": 2}),
    "moe": (dict(family="mixtral", n_experts=4, n_experts_per_tok=2),
            {"data": 2, "tensor": 2}),
}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_engine_on_a_mesh_joins_heads_and_splits_experts(case):
    """q/k/v split by column whose heads the tensor axis does not divide,
    or whose norm spans the whole projection (qk_norm_full): every device
    joins the shards' columns and attends over all heads with the cache
    whole over tensor (GSPMD's reshard); the row-split ``wo`` takes each
    shard's block of the heads. And a MoE layer whose experts split their
    hidden dim over tensor: each shard's partial expert outputs, gated,
    summed in shard order. Greedy tokens equal the unsharded engines' and
    JAX's sharded engine's; logits within 2e-4."""
    kw, axes = LAYOUTS[case]
    jcfg = dataclasses.replace(JCFG, **kw)
    jp = j_init_params(jcfg, jax.random.PRNGKey(4))
    tree = (jp, params_from_jax(jax.device_get(jp), device="cpu"))
    port, eng, jax_one, jax_mesh, _ = _engines(
        tree, axes, data_axis=None, flash=False, jcfg=jcfg)
    assert eng.params["layers"]["attn"]["wq"].grid[0] == axes["tensor"]
    assert eng.new_cache(2).k.grid == ((1, 1) if case != "moe" else (2, 1))
    want = jax_one.generate_compiled(PROMPTS, max_new_tokens=8).sequences
    for e in (eng, port, jax_mesh):
        assert e.generate_compiled(PROMPTS,
                                   max_new_tokens=8).sequences == want
    np.testing.assert_allclose(eng.prefill(PROMPTS)[0].numpy(),
                               np.asarray(jax_one.prefill(PROMPTS)[0]),
                               **LOGIT_TOL)


def test_cluster_plans_and_serves_and_trains_a_data_tensor_job(
        checkpoint, tmp_path):
    """A port cluster whose worker advertises four host devices
    (``MLConfig(device="cpu", mesh_devices=4)``): a ``DistributedModel``
    asking for ``parallelism={"data": 2, "tensor": 2}`` gets that plan,
    the worker places the job on its mesh and serves its tokens equal to
    the unsharded engine's; a training job on the same plan runs ZeRO-1
    (``update_mode`` zero1, state split over the data replicas) and two
    steps' losses equal the one-device port step's within 1e-5 (the
    node path's own driver arithmetic, tests/test_torch_train_nodes.py)."""
    from tensorlink_tpu_torch.core import config as C
    from tensorlink_tpu_torch.engine.training import (
        make_optimizer,
        make_train_step,
    )
    from tensorlink_tpu_torch.ml.module import DistributedModel
    from tensorlink_tpu_torch.nodes.runners import (
        UserNode,
        ValidatorNode,
        WorkerNode,
    )

    def common(ml):
        return dict(local_test=True, log_dir=str(tmp_path / "logs"),
                    env_file=str(tmp_path / ".env"), ml=ml)

    nodes = []
    try:
        v = ValidatorNode(C.ValidatorConfig(
            endpoint=False, key_dir=str(tmp_path / "vk"),
            **common(C.MLConfig(device="cpu")))).start()
        nodes.append(v)
        seeds = [["127.0.0.1", v.port]]
        w = WorkerNode(C.WorkerConfig(
            seed_validators=seeds, key_dir=str(tmp_path / "wk"),
            **common(C.MLConfig(device="cpu", mesh_devices=4,
                                max_seq_len=128)))).start()
        nodes.append(w)
        u = UserNode(C.UserConfig(
            seed_validators=seeds, key_dir=str(tmp_path / "uk"),
            **common(C.MLConfig(device="cpu")))).start()
        nodes.append(u)
        deadline = time.monotonic() + 60
        while len(v.status()["peers"]) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        model = DistributedModel(CFG, node=u, ckpt=checkpoint, seq_len=64,
                                 parallelism=dict(PLAN_AXES), device="cpu",
                                 request_timeout=300.0)
        assert model.plan.stages[0].mesh_axes == PLAN_AXES
        rt = w.executor.jobs[model.job_id]
        assert rt.mesh is not None and tmesh.is_sharded(rt.params)
        prompts = [[7, 3, 9, 11, 2], [5, 1, 8]]
        ref = GenerationEngine(CFG, params_from_jax(
            jax.device_get(j_init_params(JCFG, jax.random.PRNGKey(3))),
            device="cpu"), device="cpu", max_seq_len=128)
        want = ref.generate_compiled(prompts, max_new_tokens=6).sequences
        assert model.generate(prompts, max_new_tokens=6) == want
        tm = DistributedModel(CFG, node=u, ckpt=checkpoint, seq_len=16,
                              batch=4, n_micro=2, training=True,
                              parallelism=dict(PLAN_AXES), device="cpu",
                              request_timeout=300.0)
        assert tm.plan.update_mode == "zero1"
        trt = w.executor.jobs[tm.job_id]
        tm.init_optimizer("adamw", lr=1e-3)
        assert any(t.grid[1] == 2
                   for t in topt.tree_leaves(trt.opt_state))
        ts = make_train_step(CFG, make_optimizer("adamw", lr=1e-3,
                                                 grad_clip=1.0), n_micro=2)
        local = params_from_jax(jax.device_get(
            j_init_params(JCFG, jax.random.PRNGKey(3))), device="cpu")
        state = ts.init_state(local)
        for toks in _batches(2, seed=8):
            got = tm.train_step(toks)["loss"]
            local, state, m = ts.step_fn(local, state,
                                         {"tokens": torch.as_tensor(toks)})
            np.testing.assert_allclose(got, float(m["loss"]), rtol=1e-5)
    finally:
        for n in reversed(nodes):
            n.stop()
