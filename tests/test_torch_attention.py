"""The port's paged attention (tensorlink_tpu_torch/ops/attention.py)
against the JAX package's references and its Pallas kernels in interpret
mode, at the shapes of tests/test_ops.py — float32, rtol = atol = 2e-5,
the bound test_ops.py holds the Pallas kernels to against their
references. On the CPU the kernel wrappers take the plain versions and
launch nothing; the CUDA kernels themselves are held against the plain
versions by the test marked ``cuda`` (skipped without a card) and by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.ops import attention as jatt
from tensorlink_tpu_torch.ops import attention as tatt

torch.set_num_threads(2)
# tlint: disable=TL006(read-only constant table)
TOL = dict(rtol=2e-5, atol=2e-5)


def _pages(rng, S, Hkv, hd, page, n_pp):
    P = 1 + S * n_pp
    kp = rng.normal(size=(P, Hkv, page, hd)).astype(np.float32)
    vp = rng.normal(size=(P, Hkv, page, hd)).astype(np.float32)
    bt = (rng.permutation(np.arange(1, P))[: S * n_pp]
          .reshape(S, n_pp).astype(np.int32))
    return kp, vp, bt


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize(
    "S,Hq,Hkv,hd,page,n_pp,lens",
    [
        (4, 8, 2, 32, 8, 4, None),  # GQA, ragged lengths 0 .. full
        (2, 4, 4, 16, 16, 2, None),  # MHA
        (3, 8, 1, 64, 4, 8, None),  # MQA, many small pages
        (4, 4, 2, 16, 8, 3, [0, 1, 9, 17]),  # empty, 1, partial last pages
    ],
)
def test_paged_ref_matches_jax_ref_and_pallas(S, Hq, Hkv, hd, page, n_pp,
                                              lens):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(S, Hq, hd)).astype(np.float32)
    kp, vp, bt = _pages(rng, S, Hkv, hd, page, n_pp)
    if lens is None:
        lens = np.linspace(0, n_pp * page, S).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    scale = hd**-0.5
    jref = np.asarray(jatt.paged_attention_ref(*_j(q, kp, vp, bt, lens),
                                               scale=scale))
    jker = np.asarray(jatt.paged_attention(*_j(q, kp, vp, bt, lens),
                                           scale=scale, interpret=True))
    tatt.reset_counts()
    got = tatt.paged_attention(*_t(q, kp, vp, bt, lens), scale=scale).numpy()
    np.testing.assert_allclose(got, jref, **TOL)
    np.testing.assert_allclose(got, jker, **TOL)
    assert np.abs(got[lens == 0]).max(initial=0) == 0
    # the CPU wrapper took the plain version and launched nothing
    assert tatt.paged_attention.launches == 0
    assert tatt.paged_attention_ref.calls == 1


RAGGED = (
    # mixed: decode slot + fresh prefill + mid-prefill offset + padding
    (4, 8, 8, 2, 32, 8, 4, [13, 0, 11, 0], [1, 8, 5, 0]),
    # decode-only block (every slot 1 valid token, ragged lengths)
    (4, 8, 4, 4, 16, 8, 4, [0, 7, 15, 30], [1, 1, 1, 1]),
    # prefill-only block, MQA, mid-page offsets (COW landings)
    (3, 16, 8, 1, 64, 4, 8, [0, 3, 17], [16, 16, 9]),
    # all-padding block (idle engine shape: all-zero output, no NaN)
    (2, 8, 4, 2, 16, 8, 2, [0, 0], [0, 0]),
    # verify-style rows: a decode slot at 13 carrying 4 draft rows
    (2, 8, 4, 2, 16, 8, 4, [13, 0], [5, 0]),
)


@pytest.mark.parametrize("S,C,Hq,Hkv,hd,page,n_pp,starts,nv", RAGGED)
def test_ragged_ref_matches_jax_ref_and_pallas(S, C, Hq, Hkv, hd, page, n_pp,
                                               starts, nv):
    rng = np.random.default_rng(8)
    q = rng.normal(size=(S, C, Hq, hd)).astype(np.float32)
    kp, vp, bt = _pages(rng, S, Hkv, hd, page, n_pp)
    st = np.asarray(starts, np.int32)
    nva = np.asarray(nv, np.int32)
    scale = hd**-0.5
    args = (q, kp, vp, bt, st, nva)
    jref = np.asarray(jatt.ragged_paged_attention_ref(*_j(*args),
                                                      scale=scale))
    jker = np.asarray(jatt.ragged_paged_attention(*_j(*args), scale=scale,
                                                  interpret=True))
    tatt.reset_counts()
    got = tatt.ragged_paged_attention(*_t(*args), scale=scale).numpy()
    np.testing.assert_allclose(got, jref, **TOL)
    np.testing.assert_allclose(got, jker, **TOL)
    for s in range(S):  # rows at or past n_valid are exactly zero
        assert np.abs(got[s, nv[s]:]).max(initial=0) == 0
    assert tatt.ragged_paged_attention.launches == 0
    assert tatt.ragged_paged_attention_ref.calls == 1


def test_decode_slot_is_the_one_row_ragged_case_bitwise():
    """A decode slot of the plain paged attention runs the ragged plain
    version's code path: bitwise the ragged output of a 1-valid-row slot
    at start = length - 1."""
    rng = np.random.default_rng(9)
    S, Hq, Hkv, hd, page, n_pp = 3, 8, 2, 32, 8, 4
    q = rng.normal(size=(S, Hq, hd)).astype(np.float32)
    kp, vp, bt = _pages(rng, S, Hkv, hd, page, n_pp)
    lens = np.array([14, 0, 32], np.int32)
    scale = hd**-0.5
    dec = tatt.paged_attention_ref(*_t(q, kp, vp, bt, lens), scale=scale)
    rag = tatt.ragged_paged_attention_ref(
        *_t(q[:, None], kp, vp, bt, np.maximum(lens - 1, 0),
            (lens > 0).astype(np.int32)),
        scale=scale,
    )
    assert torch.equal(dec, rag[:, 0])


def test_quantized_pages_raise_on_cuda_tensors_only_path():
    """int8/int4 page variants are a later slice: the CUDA path refuses
    them before touching the card (checked here without one through the
    wrapper's contract function)."""
    q = torch.zeros(1, 2, 32)
    kp = torch.zeros(2, 1, 8, 32)
    with pytest.raises(NotImplementedError, match="int8/int4 slice"):
        tatt._check_launch("paged_attention", q, kp, kp, (),
                           torch.ones(2, 1, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(dtype):
    """On the card: each CUDA kernel against its plain version on the same
    inputs (f32 2e-5; bf16 compared in f32 at 1.6e-2, two bf16 ulps, since
    the output rounds once after a different summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    tol = TOL if dt == torch.float32 else dict(rtol=1.6e-2, atol=1.6e-2)
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    S, C, Hq, Hkv, hd, page, n_pp = 4, 16, 16, 8, 128, 16, 8
    kp, vp, bt = _pages(rng, S, Hkv, hd, page, n_pp)
    q = rng.normal(size=(S, C, Hq, hd)).astype(np.float32)
    st = np.array([0, 37, 100, 0], np.int32)
    nv = np.array([16, 5, 1, 0], np.int32)
    lens = np.array([0, 1, 77, 128], np.int32)
    tq, tk, tv = (torch.from_numpy(a).to(dev, dt) for a in (q, kp, vp))
    tbt, tst, tnv, tln = (torch.from_numpy(a).to(dev)
                          for a in (bt, st, nv, lens))
    scale = hd**-0.5
    got = tatt.ragged_paged_attention(tq, tk, tv, tbt, tst, tnv, scale=scale)
    ref = tatt.ragged_paged_attention_ref(tq, tk, tv, tbt, tst, tnv,
                                          scale=scale)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu(), ref.float().cpu(), **tol)
    got = tatt.paged_attention(tq[:, 0].contiguous(), tk, tv, tbt, tln,
                               scale=scale)
    ref = tatt.paged_attention_ref(tq[:, 0].contiguous(), tk, tv, tbt, tln,
                                   scale=scale)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu(), ref.float().cpu(), **tol)
