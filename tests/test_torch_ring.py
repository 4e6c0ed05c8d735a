"""The port's ring attention and quantized collectives
(``tensorlink_tpu_torch/parallel/ring.py``) against the JAX package's
``parallel/ring.py``, case by case after tests/test_ring.py, on the same
numpy-seeded inputs: the port's ring over ``[cpu] * n`` ring devices, JAX's
inside ``shard_map`` over the conftest's virtual host devices.

Held here, with tests/test_ring.py's tolerances:

- ``ring_attention``, causal and not, at n 2, 4 and 8 within 2e-5 of
  JAX's, and its gradients (q, k, v) within 3e-5 of JAX's;
- the quantized ring (int8 K/V with per-row scales) within JAX's
  quantized ring's float rounding, within 0.06 of the exact ring, and
  bitwise across runs;
- ``quantized_psum`` within JAX's and within 0.06·n of the exact sum,
  the same bits on every reader and across runs;
- ``quantized_all_gather`` (stacked and tiled) equal to JAX's within
  float rounding, each shard within 0.03 of itself, the same bits on
  every reader;
- ``sequence_sharded`` pieces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tensorlink_tpu.parallel.mesh import build_mesh as j_build_mesh
from tensorlink_tpu.parallel.mesh import get_shard_map
from tensorlink_tpu.parallel import ring as jring
from tensorlink_tpu_torch.parallel import mesh as tmesh
from tensorlink_tpu_torch.parallel import ring as tring

# one intra-op thread: a JAX call in this process can leave torch's worker
# threads computing exp off by up to 1e-4 (tests/test_torch_flash.py)
torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 2e-5  # tests/test_ring.py::test_ring_matches_full
GRAD_TOL = 3e-5  # tests/test_ring.py::test_ring_is_differentiable
QUANT_BOUND = 0.06  # tests/test_ring.py: measured ~0.012, bar 0.06


def _meshes(n: int, axis: str = "seq"):
    return (tmesh.build_mesh({axis: n}, [CPU] * n),
            j_build_mesh({axis: n}, jax.devices("cpu")[:n]))


def _qkv(seed: int, B=2, S=32, Hq=4, Hkv=2, hd=8):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))


def _jax_ring(arrays, jm, **kw):
    sharded = [jring.sequence_sharded(jm, jnp.asarray(a)) for a in arrays]
    return np.asarray(jring.ring_attention(*sharded, jm, **kw))


@pytest.mark.parametrize("n_seq", [2, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_jax(n_seq, causal):
    """Whole inputs and inputs placed by ``sequence_sharded`` give the
    same bits, within 2e-5 of JAX's ring."""
    tm, jm = _meshes(n_seq)
    arrays = _qkv(0)
    want = _jax_ring(arrays, jm, causal=causal)
    q, k, v = (torch.as_tensor(a) for a in arrays)
    got = tring.ring_attention(q, k, v, tm, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    placed = tring.ring_attention(
        *(tring.sequence_sharded(tm, t) for t in (q, k, v)), tm,
        causal=causal)
    assert isinstance(placed, tmesh.Sharded)
    assert placed.spec == tmesh.Split(1, "seq")
    assert torch.equal(placed.full(), got)


@pytest.mark.parametrize("n_seq", [2, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_gradients_match_jax(n_seq, causal):
    tm, jm = _meshes(n_seq)
    arrays = _qkv(1, B=1, S=16, Hq=2, Hkv=2)

    def jloss(q, k, v):
        sh = [jring.sequence_sharded(jm, t) for t in (q, k, v)]
        return jring.ring_attention(*sh, jm, causal=causal).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.as_tensor(a).requires_grad_(True) for a in arrays]
    tring.ring_attention(*ts, tm, causal=causal).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_quantized_ring_bounded_and_deterministic():
    """tests/test_ring.py::test_quantized_ring_attention_bounded_divergence
    on the port: the int8 ring within JAX's int8 ring's float rounding,
    within 0.06 of the exact ring, and the same bits run to run."""
    n = 4
    tm, jm = _meshes(n)
    arrays = _qkv(2)
    want = _jax_ring(arrays, jm, quantized=True)
    q, k, v = (torch.as_tensor(a) for a in arrays)
    full = tring.ring_attention(q, k, v, tm)
    quant = tring.ring_attention(q, k, v, tm, quantized=True)
    np.testing.assert_allclose(quant.numpy(), want, rtol=TOL, atol=TOL)
    assert float((quant - full).abs().max()) < QUANT_BOUND
    assert float((quant - full).abs().max()) > 0  # the wire was int8
    again = tring.ring_attention(q, k, v, tm, quantized=True)
    assert torch.equal(quant, again)


def _parts(x: np.ndarray, n: int, axis: int) -> list:
    return [torch.as_tensor(p) for p in np.split(x, n, axis=axis)]


def test_quantized_psum_matches_jax_and_is_fixed_order():
    n = 4
    _, jm = _meshes(n)
    sm = get_shard_map()
    x = np.random.default_rng(3).standard_normal((n * 2, 64)).astype(
        np.float32)
    want = np.asarray(sm(lambda t: jring.quantized_psum(t, "seq"), mesh=jm,
                         in_specs=P("seq", None),
                         out_specs=P("seq", None))(jnp.asarray(x)))
    parts = _parts(x, n, 0)
    readers = [tring.quantized_psum(parts, CPU) for _ in range(n)]
    for got in readers:
        assert torch.equal(got, readers[0])  # every reader, the same bits
    # JAX's out_specs hand each device's copy back as its row pair
    for i in range(n):
        np.testing.assert_allclose(readers[0].numpy(),
                                   want[2 * i:2 * i + 2], rtol=TOL, atol=TOL)
    exact = sum(p for p in parts)
    assert float((readers[0] - exact).abs().max()) < QUANT_BOUND * n
    assert torch.equal(tring.quantized_psum(parts, CPU), readers[0])


@pytest.mark.parametrize("tiled", [False, True])
def test_quantized_all_gather_matches_jax(tiled):
    n = 4
    _, jm = _meshes(n)
    sm = get_shard_map()
    x = np.random.default_rng(4).standard_normal((n * 2, 64)).astype(
        np.float32)
    if tiled:  # a feature axis split over the shards, as tp splits it
        parts = _parts(x, n, 1)
        fn = sm(lambda t: jring.quantized_all_gather(
            t, "seq", axis=1, tiled=True)[None], mesh=jm,
            in_specs=P(None, "seq"), out_specs=P("seq"))
    else:
        parts = _parts(x, n, 0)
        fn = sm(lambda t: jring.quantized_all_gather(t, "seq"), mesh=jm,
                in_specs=P("seq", None), out_specs=P(None, "seq", None))
    want = np.asarray(fn(jnp.asarray(x)))
    got = tring.quantized_all_gather(parts, CPU, axis=1 if tiled else 0,
                                     tiled=tiled)
    if tiled:
        assert got.shape == x.shape
        for i in range(n):  # every device's gathered copy
            np.testing.assert_allclose(got.numpy(), want[i], rtol=TOL,
                                       atol=TOL)
        for i, p in enumerate(parts):  # each shard only its own error
            np.testing.assert_allclose(got[:, 16 * i:16 * (i + 1)].numpy(),
                                       p.numpy(), atol=0.03)
    else:
        assert got.shape == (n, 2, 64)
        # JAX's out_specs lay each device's stacked copy side by side
        np.testing.assert_allclose(got.numpy(), want[:, :2], rtol=TOL,
                                   atol=TOL)
        for i, p in enumerate(parts):
            np.testing.assert_allclose(got[i].numpy(), p.numpy(), atol=0.03)
    wire = tring.quantize_shards(parts)
    again = tring.quantized_all_gather(parts, CPU, axis=1 if tiled else 0,
                                       tiled=tiled, quantized=wire)
    assert torch.equal(again, got)


def test_sequence_sharded_places_the_sequence_dim():
    tm, _ = _meshes(4)
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    placed = tring.sequence_sharded(tm, x)
    assert [tuple(t.shape) for t in placed.shards] == [(2, 2, 3)] * 4
    for i, t in enumerate(placed.shards):
        assert torch.equal(t, x[:, 2 * i:2 * (i + 1)])
    assert torch.equal(placed.full(), x)
    with pytest.raises(ValueError, match="does not split"):
        tring.ring_attention(x[:, :6, None], x[:, :6, None],
                             x[:, :6, None], tm)
