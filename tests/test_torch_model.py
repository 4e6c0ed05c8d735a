"""The port's model pieces (tensorlink_tpu_torch/models/) against the JAX
functions on the same inputs and weights — float32, rtol = atol = 2e-5 —
plus the parameter-tree contracts: the port's ``init_params`` has the JAX
tree's leaf names and shapes, and ``params_from_jax`` carries a JAX tree
(plain or weight-only int8) over leaf for leaf."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu.models import transformer as jtr
from tensorlink_tpu_torch.convert import config_from_jax, params_from_jax
from tensorlink_tpu_torch.models import config_presets, init_params
from tensorlink_tpu_torch.models import transformer as ttr

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


@pytest.fixture(scope="module")
def trees():
    jp = jax.device_get(j_init_params(JCFG, jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp, device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tuple(tree.shape)}


def test_config_and_preset_carry_over():
    cfg = config_from_jax(dataclasses.asdict(JCFG))
    assert cfg.dtype == torch.float32
    for f in dataclasses.fields(JCFG):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(JCFG, f.name), f.name
    from tensorlink_tpu.models.registry import config_presets as j_presets

    jq, tq = j_presets()["qwen3-0p6b"], config_presets()["qwen3-0p6b"]
    for f in dataclasses.fields(JCFG):
        if f.name != "dtype":
            assert getattr(tq, f.name) == getattr(jq, f.name), f.name


def test_params_from_jax_round_trips_names_and_shapes(trees):
    jp, tp = trees
    assert _leaves(tp) == _leaves(jp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in flat_j:
        node = tp
        for p in path:
            node = node[p.key]
        assert node.dtype == torch.float32
        assert np.array_equal(node.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("overrides", [
    {},  # qwen3: qk-norm, tied head
    {"family": "llama", "qk_norm": False, "tie_embeddings": False},
    {"family": "gpt2", "pos": "learned", "mlp": "fused", "norm": "layernorm",
     "attn_bias": True, "qk_norm": False},
    {"family": "mixtral", "qk_norm": False, "tie_embeddings": False,
     "n_experts": 4, "n_experts_per_tok": 2},
])
def test_init_params_has_the_jax_tree(overrides):
    jcfg = JCFG.with_(**overrides)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    g = torch.Generator()
    g.manual_seed(0)
    tp = init_params(cfg, g, device="cpu")
    jp = jax.eval_shape(lambda: j_init_params(jcfg, jax.random.PRNGKey(0)))
    assert _leaves(tp) == _leaves(jp)


def test_norms_rope_mlp_logits_match_jax(trees):
    jp, tp = trees
    cfg = config_from_jax(dataclasses.asdict(JCFG))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    lp_j = jax.tree.map(lambda a: a[1], jp["layers"])
    lp_t = jax.tree.map(lambda a: a[1], tp["layers"])

    got = ttr._norm(torch.from_numpy(x), lp_t["ln1"], cfg).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jtr._norm(jnp.asarray(x), lp_j["ln1"], JCFG)), **TOL
    )
    ln = JCFG.with_(norm="layernorm")
    lnp = {"scale": rng.normal(size=64).astype(np.float32),
           "bias": rng.normal(size=64).astype(np.float32)}
    got = ttr._norm(torch.from_numpy(x),
                    {k: torch.from_numpy(v) for k, v in lnp.items()},
                    cfg.with_(norm="layernorm")).numpy()
    want = jtr._norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                      lnp.items()}, ln)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)

    h = rng.normal(size=(3, 5, 4, 16)).astype(np.float32)
    sc = rng.normal(size=16).astype(np.float32)
    np.testing.assert_allclose(
        ttr._rms_head_norm(torch.from_numpy(h), torch.from_numpy(sc),
                           1e-6).numpy(),
        np.asarray(jtr._rms_head_norm(jnp.asarray(h), jnp.asarray(sc), 1e-6)),
        **TOL,
    )

    pos = rng.integers(0, 4000, size=(3, 5)).astype(np.int32)
    for rd in (16, 4):  # full and partial rotary dims
        tc, ts = ttr.rope_tables(torch.from_numpy(pos), rd, 1e6)
        jc, js = jtr.rope_tables(jnp.asarray(pos), rd, 1e6)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
        hr = h[..., :rd]
        np.testing.assert_allclose(
            ttr.apply_rope(torch.from_numpy(hr.copy()), tc, ts).numpy(),
            np.asarray(jtr.apply_rope(jnp.asarray(hr), jc, js)), **TOL,
        )

    np.testing.assert_allclose(
        ttr._mlp(torch.from_numpy(x), lp_t["mlp"], cfg).numpy(),
        np.asarray(jtr._mlp(jnp.asarray(x), lp_j["mlp"], JCFG)), **TOL,
    )
    np.testing.assert_allclose(
        ttr._logits(tp, torch.from_numpy(x), cfg).numpy(),
        np.asarray(jtr._logits(jp, jnp.asarray(x), JCFG)), **TOL,
    )
    assert ttr._rope_dim(cfg.with_(rope_pct=0.25)) == jtr._rope_dim(
        JCFG.with_(rope_pct=0.25)
    )


def test_params_from_jax_carries_a_quantized_tree(trees):
    """A JAX tree after ``quantize_params`` (``QTensor`` leaves, numpy
    ``.q``/``.scale`` after ``device_get``) becomes the port's QTensors
    with the same codes and scales, and serves the same logits."""
    from tensorlink_tpu.models.quant import quantize_params as jqp
    from tensorlink_tpu_torch.models.quant import QTensor

    jp, _ = trees
    jq = jax.device_get(jqp(jax.tree.map(jnp.asarray, jp), min_size=0))
    tq = params_from_jax(jq, device="cpu")
    wq_j, wq_t = jq["layers"]["attn"]["wq"], tq["layers"]["attn"]["wq"]
    assert isinstance(wq_t, QTensor)
    assert wq_t.q.dtype == torch.int8 and wq_t.scale.dtype == torch.float32
    assert np.array_equal(wq_t.q.numpy(), np.asarray(wq_j.q))
    assert np.array_equal(wq_t.scale.numpy(), np.asarray(wq_j.scale))
    cfg = config_from_jax(dataclasses.asdict(JCFG))
    x = np.random.default_rng(4).normal(size=(2, 3, 64)).astype(np.float32)
    lp_j = jax.tree.map(lambda a: a[0], jq["layers"])
    lp_t = {"mlp": {k: QTensor(q=v.q[0], scale=v.scale[0])
                    for k, v in tq["layers"]["mlp"].items()}}
    np.testing.assert_allclose(
        ttr._mlp(torch.from_numpy(x), lp_t["mlp"], cfg).numpy(),
        np.asarray(jtr._mlp(jnp.asarray(x), lp_j["mlp"], JCFG)), **TOL,
    )


def test_params_from_jax_needs_a_device_or_cpu(trees):
    """``device=None`` means the CUDA card, as at every other entry
    point: without one the call raises instead of landing on the CPU."""
    jp, _ = trees
    if torch.cuda.is_available():
        tp = params_from_jax(jp)
        assert tp["final_norm"]["scale"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            params_from_jax(jp)


def test_moe_is_refused_until_its_slice():
    """Named for what it held before MoE was ported (a MoE config
    refused); MoE is ported now, so it holds that a MoE config
    initialises and runs: ``init_params`` draws the JAX expert leaves and
    ``_mlp`` routes to the top-k expert MLP (held against JAX in
    tests/test_torch_moe.py)."""
    cfg = config_from_jax(dataclasses.asdict(JCFG.with_(n_experts=4)))
    tp = init_params(cfg, device="cpu")
    mlp = tp["layers"]["mlp"]
    assert tuple(mlp["router"].shape) == (2, 64, 4)
    assert tuple(mlp["w_down"].shape) == (2, 4, 128, 64)
    lp = ttr._layers(tp)[0]
    x = torch.randn(2, 3, 64, generator=torch.Generator().manual_seed(0))
    out = ttr._mlp(x, lp["mlp"], cfg)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
