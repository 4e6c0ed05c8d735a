"""The port's in-mesh GPipe (``tensorlink_tpu_torch/parallel/pipeline.py``)
against the JAX package's ``parallel/pipeline.py``, case by case after
tests/test_pipeline.py and tests/test_product_parallel.py (a), on the same
numpy-seeded weights and inputs: the port's stages on ``[cpu] * n``, JAX's
inside ``shard_map`` over the conftest's virtual host devices.

Held here, with those files' tolerances (2e-5 forward; 5e-5 for gpipe's
gradients, 2e-4 for a stage's):

- ``gpipe`` at (n_stage, n_micro) (2, 2), (4, 4) and (4, 6), forward and
  the gradients of the layer stack and the micro-batches;
- ``pipelined_stage_forward`` over the first stage (tokens to logits),
  a middle stage (hidden to hidden, with gradients of the params and of
  the input) and with a padding mask, against JAX's;
- a layer stack placed by ``Split(0, "stage")`` giving the same bits as
  the whole stack, and JAX's refusals word for word.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu.parallel import pipeline as jpipe
from tensorlink_tpu.parallel.mesh import build_mesh as j_build_mesh
from tensorlink_tpu_torch.convert import config_from_jax, params_from_jax
from tensorlink_tpu_torch.engine import optimizers as topt
from tensorlink_tpu_torch.models.transformer import stage_forward
from tensorlink_tpu_torch.parallel import mesh as tmesh
from tensorlink_tpu_torch.parallel import pipeline as tpipe

# one intra-op thread: a JAX call in this process can leave torch's worker
# threads computing exp off by up to 1e-4 (tests/test_torch_flash.py)
torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 2e-5
GPIPE_GRAD_TOL = 5e-5  # tests/test_pipeline.py::test_gpipe_is_differentiable
STAGE_GRAD_TOL = 2e-4  # tests/test_product_parallel.py mid stage and grads
# tests/test_product_parallel.py::CFG
JCFG = JModelConfig(
    family="llama", vocab_size=128, d_model=32, n_layers=4, n_heads=4,
    n_kv_heads=2, head_dim=8, d_ff=64, max_seq_len=64, dtype=jnp.float32,
)
CFG = config_from_jax(dataclasses.asdict(JCFG))


def _meshes(n: int):
    return (tmesh.build_mesh({"stage": n}, [CPU] * n),
            j_build_mesh({"stage": n}, jax.devices("cpu")[:n]))


@pytest.fixture(scope="module")
def trees():
    jp = jax.device_get(j_init_params(JCFG, jax.random.PRNGKey(3)))
    return jp, params_from_jax(jp, device="cpu")


def _j_stage_fn(local_w, x):
    def body(h, w):
        return h + jnp.tanh(h @ w), None

    y, _ = jax.lax.scan(body, x, local_w)
    return y


def _t_stage_fn(local_w, x):
    for w in local_w:
        x = x + torch.tanh(x @ w)
    return x


def _toks(batch=4, T=16, seed=0):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, (batch, T)).astype(np.int32)


@pytest.mark.parametrize("n_stage,n_micro", [(2, 2), (4, 4), (4, 6)])
def test_gpipe_matches_jax(n_stage, n_micro):
    tm, jm = _meshes(n_stage)
    L, mb, T, D = 8, 2, 4, 16
    rng = np.random.default_rng(n_stage * 10 + n_micro)
    w = (rng.standard_normal((L, D, D)) * 0.1).astype(np.float32)
    micros = rng.standard_normal((n_micro, mb, T, D)).astype(np.float32)

    want = jpipe.gpipe(_j_stage_fn, jnp.asarray(w), jnp.asarray(micros), jm)
    jgw, jgx = jax.grad(
        lambda a, b: (jpipe.gpipe(_j_stage_fn, a, b, jm) ** 2).sum(),
        argnums=(0, 1))(jnp.asarray(w), jnp.asarray(micros))

    tw = torch.as_tensor(w).requires_grad_(True)
    tx = torch.as_tensor(micros).requires_grad_(True)
    got = tpipe.gpipe(_t_stage_fn, tw, tx, tm)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw),
                               rtol=GPIPE_GRAD_TOL, atol=GPIPE_GRAD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               rtol=GPIPE_GRAD_TOL, atol=GPIPE_GRAD_TOL)


@pytest.mark.parametrize("n_stage,n_micro", [(2, 2), (2, 4), (4, 2)])
def test_pipelined_first_stage_matches_jax(trees, n_stage, n_micro):
    jp, tp = trees
    tm, jm = _meshes(n_stage)
    toks = _toks()
    want, _ = jpipe.pipelined_stage_forward(
        jp, JCFG, jm, tokens=jnp.asarray(toks), n_micro=n_micro, first=True,
        last=True)
    got, cache = tpipe.pipelined_stage_forward(
        tp, CFG, tm, tokens=torch.as_tensor(toks), n_micro=n_micro,
        first=True, last=True)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # the layers placed over the stage axis: the same bits
    placed = dict(tp, layers=tmesh.put(
        tm, tp["layers"], topt.tree_map(lambda _: tmesh.Split(0, "stage"),
                                        tp["layers"])))
    again, _ = tpipe.pipelined_stage_forward(
        placed, CFG, tm, tokens=torch.as_tensor(toks), n_micro=n_micro,
        first=True, last=True)
    assert torch.equal(again, got)
    # and the unsharded stage's, within float rounding
    whole, _ = stage_forward(tp, CFG, tokens=torch.as_tensor(toks),
                             first=True, last=True)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=TOL,
                               atol=TOL)


def test_pipelined_mid_stage_and_grads_match_jax(trees):
    jp, tp = trees
    tm, jm = _meshes(2)
    hid = np.random.default_rng(1).normal(
        size=(2, 8, JCFG.d_model)).astype(np.float32)

    def jloss(prm, h):
        out, _ = jpipe.pipelined_stage_forward(
            prm, JCFG, jm, hidden=h, n_micro=2, first=False, last=False)
        return (out.astype(jnp.float32) ** 2).sum()

    jsliced = {"layers": jp["layers"]}
    jout, _ = jpipe.pipelined_stage_forward(
        jsliced, JCFG, jm, hidden=jnp.asarray(hid), n_micro=2, first=False,
        last=False)
    jgp, jgh = jax.grad(jloss, argnums=(0, 1))(jsliced, jnp.asarray(hid))

    sliced = {"layers": topt.tree_map(
        lambda t: t.clone().requires_grad_(True), tp["layers"])}
    h = torch.as_tensor(hid).requires_grad_(True)
    out, _ = tpipe.pipelined_stage_forward(
        sliced, CFG, tm, hidden=h, n_micro=2, first=False, last=False,
        remat=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=TOL, atol=TOL)
    (out.float() ** 2).sum().backward()
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jgh),
                               rtol=STAGE_GRAD_TOL, atol=STAGE_GRAD_TOL)
    got = topt.tree_leaves(topt.tree_map(lambda t: t.grad, sliced))
    want = jax.tree.leaves(jgp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=STAGE_GRAD_TOL, atol=STAGE_GRAD_TOL)


def test_pipelined_padded_matches_jax(trees):
    jp, tp = trees
    tm, jm = _meshes(2)
    toks = _toks(batch=2, T=8)
    mask = np.ones((2, 8), bool)
    mask[1, 5:] = False
    want, _ = jpipe.pipelined_stage_forward(
        jp, JCFG, jm, tokens=jnp.asarray(toks), attn_mask=jnp.asarray(mask),
        n_micro=2, first=True, last=True)
    got, _ = tpipe.pipelined_stage_forward(
        tp, CFG, tm, tokens=torch.as_tensor(toks),
        attn_mask=torch.as_tensor(mask), n_micro=2, first=True, last=True)
    # only valid positions are constrained, as in JAX's test
    np.testing.assert_allclose(got.numpy()[mask], np.asarray(want)[mask],
                               rtol=TOL, atol=TOL)


def test_pipelined_refusals_match_jax(trees):
    jp, tp = trees
    tm, jm = _meshes(2)
    toks = _toks(batch=3, T=8)

    def both(fn):
        out = []
        for pkg in ("jax", "port"):
            with pytest.raises(ValueError) as e:
                fn(pkg)
            out.append(str(e.value))
        return out

    def run(pkg, **kw):
        if pkg == "jax":
            return jpipe.pipelined_stage_forward(jp, JCFG, jm, **kw)
        kw = {k: torch.as_tensor(np.asarray(v)) if k in ("tokens", "hidden")
              else v for k, v in kw.items()}
        return tpipe.pipelined_stage_forward(tp, CFG, tm, **kw)

    for kw in (dict(tokens=toks, n_micro=2, first=True),
               dict(n_micro=1, first=True),
               dict(n_micro=1, first=False)):
        got, want = both(lambda pkg, kw=kw: run(pkg, **kw))
        assert got == want
    # three layers do not split over two stages
    three = {"layers": topt.tree_map(lambda t: t[:3], tp["layers"])}
    with pytest.raises(ValueError, match="3 layers not divisible by stage "
                                         "axis 2"):
        tpipe.pipelined_stage_forward(
            three, CFG, tm, hidden=torch.zeros(2, 8, JCFG.d_model),
            n_micro=2)
    assert tpipe.pp_n_micro(4, 4) == 4 and tpipe.pp_n_micro(2, 4) == 4
    assert tpipe.pp_n_micro(4, 6) == 2 and tpipe.pp_n_micro(4, 3) == 1
