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
    return [torch.from_numpy(np.array(a)) for a in arrays]  # writable copies


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


# -- quantized pages (int8, packed int4) and paged prefill ----------------
def _quant_pages(rng, kind, P, Hkv, page, hd):
    """Pages quantized once from the same numpy floats, by the JAX
    package's quantizer (the port's is pinned bitwise to it in
    tests/test_torch_quant.py): ``(k, v, k_scale, v_scale)`` numpy."""
    from tensorlink_tpu.models import quant as jq

    fn = jq.quantize_kv if kind == "int8" else jq.quantize_kv4
    out = []
    for _ in range(2):
        x = rng.normal(size=(P, Hkv, page, hd)).astype(np.float32)
        codes, sc = fn(jnp.asarray(x))
        out.append((np.asarray(codes), np.asarray(sc)))
    (k, ks), (v, vs) = out
    return k, v, ks, vs


def _bt(rng, S, n_pp, P):
    return (rng.permutation(np.arange(1, P))[: S * n_pp]
            .reshape(S, n_pp).astype(np.int32))


QRAGGED = (
    # the shapes of tests/test_ops.py's quantized ragged cases
    (4, 8, 8, 2, 32, 8, 4, [13, 0, 11, 0], [1, 8, 5, 0]),
    (4, 8, 4, 4, 16, 8, 4, [0, 7, 15, 30], [1, 1, 1, 1]),
    (2, 8, 4, 2, 16, 8, 2, [0, 0], [0, 0]),
)


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("S,C,Hq,Hkv,hd,page,n_pp,starts,nv", QRAGGED)
def test_quantized_ragged_ref_matches_jax_ref(kind, S, C, Hq, Hkv, hd, page,
                                              n_pp, starts, nv):
    rng = np.random.default_rng(21)
    P = 1 + S * n_pp
    q = rng.normal(size=(S, C, Hq, hd)).astype(np.float32)
    k, v, ks, vs = _quant_pages(rng, kind, P, Hkv, page, hd)
    assert k.shape[-1] == (hd if kind == "int8" else hd // 2)
    bt = _bt(rng, S, n_pp, P)
    st, nva = np.asarray(starts, np.int32), np.asarray(nv, np.int32)
    scale = hd**-0.5
    jref = np.asarray(jatt.ragged_paged_attention_ref(
        *_j(q, k, v, bt, st, nva), scale=scale, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs)))
    tatt.reset_counts()
    tk, tv, tks, tvs = _t(k, v, ks, vs)
    got = tatt.ragged_paged_attention(
        *_t(q), tk, tv, *_t(bt, st, nva), scale=scale, k_scale=tks,
        v_scale=tvs).numpy()
    np.testing.assert_allclose(got, jref, **TOL)
    for s in range(S):
        assert np.abs(got[s, nv[s]:]).max(initial=0) == 0
    assert tatt.ragged_paged_attention.launches == 0
    assert tatt.ragged_paged_attention_ref.calls == 1


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_decode_and_prefill_refs_match_jax_refs(kind):
    """The decode and offset-prefill plain versions over int8 and packed
    int4 pages (tests/test_ops.py's quantized decode/prefill shapes)."""
    rng = np.random.default_rng(22)
    S, Hq, Hkv, hd, page, n_pp = 4, 8, 2, 32, 8, 4
    P = 1 + S * n_pp
    k, v, ks, vs = _quant_pages(rng, kind, P, Hkv, page, hd)
    bt = _bt(rng, S, n_pp, P)
    scale = hd**-0.5
    qd = rng.normal(size=(S, Hq, hd)).astype(np.float32)
    lens = np.array([0, 9, 17, 32], np.int32)
    jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    tk, tv, tks, tvs = _t(k, v, ks, vs)
    tsc = dict(k_scale=tks, v_scale=tvs)
    jref = np.asarray(jatt.paged_attention_ref(*_j(qd, k, v, bt, lens),
                                               scale=scale, **jsc))
    got = tatt.paged_attention(*_t(qd), tk, tv, *_t(bt, lens), scale=scale,
                               **tsc).numpy()
    np.testing.assert_allclose(got, jref, **TOL)
    assert np.abs(got[0]).max() == 0  # the length-0 slot
    qp = rng.normal(size=(8, Hq, hd)).astype(np.float32)
    jref = np.asarray(jatt.paged_prefill_attention_ref(
        *_j(qp, k, v, bt[0]), jnp.int32(13), scale=scale, **jsc))
    tatt.reset_counts()
    got = tatt.paged_prefill_attention(*_t(qp), tk, tv, *_t(bt[0]), 13,
                                       scale=scale, **tsc).numpy()
    np.testing.assert_allclose(got, jref, **TOL)
    assert tatt.paged_prefill_attention.launches == 0
    assert tatt.paged_prefill_attention_ref.calls == 1


@pytest.mark.parametrize(
    "C,Hq,Hkv,hd,page,n_pp,start",
    [
        (8, 8, 2, 32, 8, 4, 0),  # GQA, offset 0 (fresh admission)
        (8, 8, 2, 32, 8, 4, 13),  # GQA, mid-page offset (COW landing)
        (16, 4, 4, 16, 16, 3, 16),  # MHA, page-aligned offset
        (4, 8, 1, 64, 4, 8, 27),  # MQA, many small pages
    ],
)
def test_paged_prefill_ref_matches_jax_ref(C, Hq, Hkv, hd, page, n_pp, start):
    """The fp cases of tests/test_ops.py's paged-prefill parity."""
    rng = np.random.default_rng(4)
    P = 1 + n_pp + 2
    q = rng.normal(size=(C, Hq, hd)).astype(np.float32)
    kp = rng.normal(size=(P, Hkv, page, hd)).astype(np.float32)
    vp = rng.normal(size=(P, Hkv, page, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, P))[:n_pp].astype(np.int32)
    scale = hd**-0.5
    jref = np.asarray(jatt.paged_prefill_attention_ref(
        *_j(q, kp, vp, bt), jnp.int32(start), scale=scale))
    got = tatt.paged_prefill_attention(*_t(q, kp, vp, bt),
                                       torch.tensor(start, dtype=torch.int32),
                                       scale=scale).numpy()
    np.testing.assert_allclose(got, jref, **TOL)


@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
def test_prefill_is_the_one_slot_ragged_case_bitwise(kind):
    """paged_prefill_attention_ref is bitwise the S = 1 ragged plain
    version at starts = [start], n_valid = [C] — the launch the CUDA
    wrapper makes."""
    rng = np.random.default_rng(6)
    C, Hq, Hkv, hd, page, n_pp, start = 8, 8, 2, 32, 8, 4, 13
    P = 1 + n_pp
    if kind == "fp":
        k, v = (rng.normal(size=(P, Hkv, page, hd)).astype(np.float32)
                for _ in range(2))
        sc = {}
    else:
        k, v, ks, vs = _quant_pages(rng, kind, P, Hkv, page, hd)
        sc = dict(zip(("k_scale", "v_scale"), _t(ks, vs)))
    q = rng.normal(size=(C, Hq, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, P))[:n_pp].astype(np.int32)
    tq, tk, tv, tbt = _t(q, k, v, bt)
    pre = tatt.paged_prefill_attention_ref(tq, tk, tv, tbt, start,
                                           scale=hd**-0.5, **sc)
    rag = tatt.ragged_paged_attention_ref(
        tq[None], tk, tv, tbt[None], torch.tensor([start], dtype=torch.int32),
        torch.tensor([C], dtype=torch.int32), scale=hd**-0.5, **sc)
    assert torch.equal(pre, rag[0])


@pytest.mark.slow  # interpret-mode Pallas compiles, as test_ops.py's
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_refs_match_pallas_interpret(kind):
    rng = np.random.default_rng(31)
    S, C, Hq, Hkv, hd, page, n_pp = 4, 8, 8, 2, 32, 8, 4
    P = 1 + S * n_pp
    k, v, ks, vs = _quant_pages(rng, kind, P, Hkv, page, hd)
    bt = _bt(rng, S, n_pp, P)
    q = rng.normal(size=(S, C, Hq, hd)).astype(np.float32)
    st = np.array([13, 0, 11, 0], np.int32)
    nv = np.array([1, 8, 5, 0], np.int32)
    scale = hd**-0.5
    jker = np.asarray(jatt.ragged_paged_attention(
        *_j(q, k, v, bt, st, nv), scale=scale, interpret=True,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    tk, tv, tks, tvs = _t(k, v, ks, vs)
    got = tatt.ragged_paged_attention(*_t(q), tk, tv, *_t(bt, st, nv),
                                      scale=scale, k_scale=tks,
                                      v_scale=tvs).numpy()
    np.testing.assert_allclose(got, jker, **TOL)


def _contract_inputs(kind):
    """CPU tensors shaped for a launch: q [1, 4, 32], pages of one kv
    head, 2 pages of 8 positions."""
    q = torch.zeros(1, 4, 32)
    if kind == "fp":
        return q, torch.zeros(2, 1, 8, 32), None
    row = 32 if kind == "int8" else 16
    return q, torch.zeros(2, 1, 8, row, dtype=torch.int8), torch.ones(2, 1, 8)


def test_quantized_pages_raise_on_cuda_tensors_only_path():
    """The quantized launch contract, checked without a card through the
    wrapper's contract functions: the page format is read from the
    pages' dtype and trailing dim, and every well-formed combination
    reaches the device check (a CPU tensor is not launched)."""
    for kind, fmt in (("fp", 0), ("int8", 1), ("int4", 2)):
        q, kp, sc = _contract_inputs(kind)
        assert tatt._page_format("paged_attention", q, kp, kp, sc, sc) == fmt
        with pytest.raises(TypeError, match="CUDA device"):
            tatt._check_launch("paged_attention", q, kp, kp, (), sc, sc)


@pytest.mark.parametrize("bad,err,match", [
    ("no_scales", TypeError, "need scales"),
    ("one_scale", ValueError, "both k_scale and v_scale"),
    ("scale_dtype", TypeError, "float32"),
    ("scale_shape", ValueError, r"\[P, Hkv, page\]"),
    ("page_dim", ValueError, "packed int4"),
    ("fp_scaled", TypeError, "must be int8"),
])
def test_quantized_launch_contract_refuses(bad, err, match):
    q, kp, sc = _contract_inputs("int8")
    ks = vs = sc
    if bad == "no_scales":
        ks = vs = None
    elif bad == "one_scale":
        vs = None
    elif bad == "scale_dtype":
        ks = vs = sc.half()
    elif bad == "scale_shape":
        ks = vs = torch.ones(2, 8, 1)
    elif bad == "page_dim":
        kp = torch.zeros(2, 1, 8, 24, dtype=torch.int8)
    elif bad == "fp_scaled":
        kp = torch.zeros(2, 1, 8, 32)
    with pytest.raises(err, match=match):
        tatt._check_launch("ragged_paged_attention", q, kp, kp, (), ks, vs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(dtype):
    """On the card: each CUDA kernel against its plain version on the same
    inputs, over fp, int8 and packed int4 pages, and the prefill launch
    (f32 2e-5; bf16 compared in f32 at 1.6e-2, two bf16 ulps, since the
    output rounds once after a different summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from tensorlink_tpu_torch.models.quant import quantize_kv, quantize_kv4

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
    tq = torch.from_numpy(q).to(dev, dt)
    kf, vf = (torch.from_numpy(a).to(dev) for a in (kp, vp))
    tbt, tst, tnv, tln = (torch.from_numpy(a).to(dev)
                          for a in (bt, st, nv, lens))
    scale = hd**-0.5
    for kind in ("fp", "int8", "int4"):
        if kind == "fp":
            tk, tv, sc = kf.to(dt), vf.to(dt), {}
        else:
            quant = quantize_kv if kind == "int8" else quantize_kv4
            (tk, ks), (tv, vs) = quant(kf), quant(vf)
            sc = dict(k_scale=ks, v_scale=vs)
        calls = (
            (tatt.ragged_paged_attention, tatt.ragged_paged_attention_ref,
             (tq, tk, tv, tbt, tst, tnv)),
            (tatt.paged_attention, tatt.paged_attention_ref,
             (tq[:, 0].contiguous(), tk, tv, tbt, tln)),
            (tatt.paged_prefill_attention, tatt.paged_prefill_attention_ref,
             (tq[1], tk, tv, tbt[1], tst[1])),
        )
        for kern, ref, args in calls:
            got = kern(*args, scale=scale, **sc)
            want = ref(*args, scale=scale, **sc)
            torch.cuda.synchronize()
            np.testing.assert_allclose(got.float().cpu(), want.float().cpu(),
                                       **tol)
