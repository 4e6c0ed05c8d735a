"""The port's quantization (tensorlink_tpu_torch/models/quant.py) and its
quantized serving modes against the JAX package.

- ``quantize_kv``, ``quantize_kv4``, ``pack_int4``/``unpack_int4`` and
  ``quantize_tensor``/``quantize_params``: codes, packed bytes and scales
  exactly equal to JAX's on the same numpy input, exact ``.5`` ties and
  all-zero rows (the 1e-8 scale floor) included.
- The split-half nibble layout pin of tests/test_ops.py.
- ``matmul`` over a ``QTensor`` within float32 2e-5 of JAX.
- The int8 (0.06) and int4 (0.5) divergence bounds of tests/test_ops.py,
  held by the port's plain attention.
- ``PagedKVCache.init`` for int4 (``hd / 2``, f32 scales, odd head_dim
  refused), ``copy_page`` moving scales, the ``"int8+kv"`` route and the
  snapshot's ``kv_quant``/``weight_quant`` (tests/test_quant.py).
"""

import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import quant as jq
from tensorlink_tpu_torch.convert import config_from_jax
from tensorlink_tpu_torch.engine.continuous import ContinuousEngine
from tensorlink_tpu_torch.engine.generate import GenerationEngine
from tensorlink_tpu_torch.engine.paged import PagedKVCache, copy_page
from tensorlink_tpu_torch.models import init_params
from tensorlink_tpu_torch.models import quant as tq
from tensorlink_tpu_torch.ops import attention as tatt

torch.set_num_threads(2)

JCFG = JModelConfig(
    family="qwen3", vocab_size=258, d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, max_seq_len=64, qk_norm=True,
    tie_embeddings=True, rope_theta=1e6, dtype=jnp.float32,
)


def _kv_input(rng, shape, kind, levels):
    """Random rows at a random magnitude, or rows built to hit the
    quantizer's edges: exact .5 ties (amax pinned so the scale is 1.0 and
    half-integers land on ties) and all-zero rows."""
    if kind == "normal":
        return (rng.normal(size=shape) * 10 ** rng.uniform(-3, 3)
                ).astype(np.float32)
    if kind == "ties":
        x = (rng.integers(-2 * levels, 2 * levels + 1, size=shape) / 2
             ).astype(np.float32)
        x[..., 0] = float(levels)
        return x
    x = rng.normal(size=shape).astype(np.float32)
    x[..., ::2, :] = 0.0  # every other row all zero: the 1e-8 floor
    return x


@pytest.mark.parametrize("shape", [(5, 4, 32), (3, 2, 16, 128), (7, 64)])
@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_kv_quantizers_equal_jax_exactly(shape, kind, fmt):
    rng = np.random.default_rng(zlib.crc32(repr((shape, kind, fmt)).encode()))
    levels = 127 if fmt == "int8" else 7
    x = _kv_input(rng, shape, kind, levels)
    jfn, tfn = ((jq.quantize_kv, tq.quantize_kv) if fmt == "int8"
                else (jq.quantize_kv4, tq.quantize_kv4))
    jc, js = jfn(jnp.asarray(x))
    tc, ts = tfn(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    if kind == "ties":  # the ties really were there
        assert (np.abs(x / np.asarray(js)[..., None]) % 1 == 0.5).any()
    deq = (tq.dequantize_kv if fmt == "int8" else tq.dequantize_kv4)(tc, ts)
    jdeq = (jq.dequantize_kv if fmt == "int8" else jq.dequantize_kv4)(jc, js)
    assert np.array_equal(deq.numpy(), np.asarray(jdeq))


def test_pack_unpack_int4_equal_jax_and_wrap():
    """Every int4 pair packs to JAX's byte (values above 127 wrap to
    negative int8 the same way) and unpacks back."""
    vals = np.arange(-8, 8, dtype=np.int32)
    a, b = np.meshgrid(vals, vals)
    q = np.concatenate([a.reshape(-1, 1), b.reshape(-1, 1)], axis=1)
    tp = tq.pack_int4(torch.from_numpy(q))
    jp = np.asarray(jq.pack_int4(jnp.asarray(q)))
    assert np.array_equal(tp.numpy(), jp)
    assert (tp.numpy() < 0).any()  # bytes >= 128 wrapped
    assert np.array_equal(tq.unpack_int4(tp).numpy(), q)
    assert np.array_equal(tq.unpack_int4(tp).numpy(),
                          np.asarray(jq.unpack_int4(jnp.asarray(jp))))


def test_int4_pack_layout_is_split_half():
    """tests/test_ops.py's layout pin: byte j holds element j (low
    nibble) and element j + hd/2 (high nibble): [-4..3] → byte 0 = 0x0C."""
    v = torch.arange(-4, 4, dtype=torch.int32)[None]
    p = tq.pack_int4(v)[0]
    assert int(p[0]) == np.int8((-4 & 0xF) | ((0 & 0xF) << 4)) == 0x0C
    assert torch.equal(tq.unpack_int4(p[None]), v)


@pytest.mark.parametrize("shape", [(64, 48), (3, 32, 80)])
def test_quantize_tensor_equals_jax(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    x[..., 3] = 0.0  # an all-zero output channel: the 1e-8 floor
    j = jq.quantize_tensor(jnp.asarray(x))
    t = tq.quantize_tensor(torch.from_numpy(x))
    assert np.array_equal(t.q.numpy(), np.asarray(j.q))
    assert np.array_equal(t.scale.numpy(), np.asarray(j.scale))
    assert t.scale.shape == (*shape[:-2], 1, shape[-1])


def test_quantize_params_and_matmul_match_jax():
    """The same leaves quantize (min_size respected), to the same codes and
    scales; a QTensor matmul is within f32 2e-5 of JAX's."""
    cfg = config_from_jax(dataclasses.asdict(
        JCFG.with_(tie_embeddings=False)))
    g = torch.Generator()
    g.manual_seed(0)
    tp = init_params(cfg, g, device="cpu")

    def to_j(t):
        if isinstance(t, dict):
            return {k: to_j(v) for k, v in t.items()}
        return jnp.asarray(t.numpy())

    for min_size in (0, 4096, 1 << 16):
        tqp = tq.quantize_params(tp, min_size=min_size)
        jqp = jq.quantize_params(to_j(tp), min_size=min_size)

        def walk(t, j, path=""):
            if isinstance(t, dict):
                assert set(t) == set(j), path
                for k in t:
                    walk(t[k], j[k], f"{path}/{k}")
            elif isinstance(t, tq.QTensor):
                assert isinstance(j, jq.QTensor), path
                assert np.array_equal(t.q.numpy(), np.asarray(j.q)), path
                assert np.array_equal(t.scale.numpy(), np.asarray(j.scale))
            else:
                assert not isinstance(j, jq.QTensor), path

        walk(tqp, jqp)
        assert tq.quantized_bytes(tqp) == jq.quantized_bytes(jqp)
    assert tq.quantized_bytes(tq.quantize_params(tp, min_size=0)) < \
        tq.quantized_bytes(tp)
    w = tq.quantize_tensor(tp["layers"]["mlp"]["w_up"][1])
    jw = jq.quantize_tensor(jnp.asarray(tp["layers"]["mlp"]["w_up"][1]
                                        .numpy()))
    x = np.random.default_rng(2).normal(size=(3, 5, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tq.matmul(torch.from_numpy(x), w).numpy(),
        np.asarray(jq.matmul(jnp.asarray(x), jw)), rtol=2e-5, atol=2e-5,
    )


def _divergence(rng, fmt, n_pp, full_span):
    S, C, Hq, Hkv, hd, page = 4, 8, 8, 2, 32, 8
    P = 1 + S * n_pp
    q = torch.from_numpy(rng.normal(size=(S, C, Hq, hd)).astype(np.float32))
    kf = torch.from_numpy(rng.normal(size=(P, Hkv, page, hd))
                          .astype(np.float32))
    vf = torch.from_numpy(rng.normal(size=(P, Hkv, page, hd))
                          .astype(np.float32))
    quant = tq.quantize_kv if fmt == "int8" else tq.quantize_kv4
    (kc, ks), (vc, vs) = quant(kf), quant(vf)
    bt = torch.from_numpy(rng.permutation(np.arange(1, P))[: S * n_pp]
                          .reshape(S, n_pp).astype(np.int32))
    K = n_pp * page
    st = [K - 1, K - 8, K - 5, K - 1] if full_span else [13, 0, 11, 22]
    st = torch.tensor(st, dtype=torch.int32)
    nv = torch.tensor([1, 8, 5, 1], dtype=torch.int32)
    scale = hd**-0.5
    full = tatt.ragged_paged_attention_ref(q, kf, vf, bt, st, nv, scale=scale)
    got = tatt.ragged_paged_attention_ref(q, kc, vc, bt, st, nv, scale=scale,
                                          k_scale=ks, v_scale=vs)
    return float((got - full).abs().max())


def test_int8_kv_divergence_bounded():
    """tests/test_ops.py's int8 bar: outputs over int8 pages within 0.06
    of the full-precision pages' (N(0,1) values; ~0.015 measured there)."""
    assert _divergence(np.random.default_rng(23), "int8", 4, False) < 0.06


def test_int4_kv_divergence_bounded():
    """tests/test_ops.py's int4 bar, 0.5, at 16- and 128-position
    contexts (the bound does not grow with context length)."""
    rng = np.random.default_rng(33)
    assert _divergence(rng, "int4", 2, True) < 0.5
    assert _divergence(rng, "int4", 16, True) < 0.5


def _cfg(**kw):
    return config_from_jax(dataclasses.asdict(JCFG.with_(**kw)))


def test_paged_cache_int4_layout_and_capacity():
    cfg = _cfg(head_dim=64)

    def page_bytes(kv_quant):
        c = PagedKVCache.init(cfg, 2, page_size=8, max_len=32,
                              kv_quant=kv_quant, device="cpu")
        b = c.k.numel() * c.k.element_size() * 2
        if c.quantized:
            b += c.k_scale.numel() * 4 * 2
        return b // c.n_pages

    c4 = PagedKVCache.init(cfg, 2, page_size=8, max_len=32, kv_quant="int4",
                           device="cpu")
    assert c4.k.shape[-1] == 32 and c4.k.dtype == torch.int8
    assert c4.k_scale.shape == c4.k.shape[:-1]
    assert c4.k_scale.dtype == torch.float32 and c4.quantized
    c8 = PagedKVCache.init(cfg, 2, page_size=8, max_len=32, kv_quant="int8",
                           device="cpu")
    assert c8.k.shape[-1] == 64 and c8.k.dtype == torch.int8
    assert not PagedKVCache.init(cfg, 2, page_size=8, max_len=32,
                                 device="cpu").quantized
    assert page_bytes("int8") / page_bytes("int4") >= 1.8
    with pytest.raises(ValueError, match="even"):
        PagedKVCache.init(_cfg(head_dim=9), 2, page_size=8, max_len=32,
                          kv_quant="int4", device="cpu")
    with pytest.raises(ValueError, match="kv_quant"):
        PagedKVCache.init(cfg, 2, page_size=8, max_len=32, kv_quant="nf4",
                          device="cpu")


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_copy_page_and_clone_move_scales(kv_quant):
    """Payload and scales move together: a COW copy reproduces the source
    page's codes AND scale rows bit for bit; clone() copies the scales."""
    c = PagedKVCache.init(_cfg(), 2, page_size=8, max_len=64,
                          kv_quant=kv_quant, device="cpu")
    g = torch.Generator()
    g.manual_seed(3)
    for t in (c.k, c.v):
        t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                              dtype=torch.int8))
    for t in (c.k_scale, c.v_scale):
        t.copy_(torch.rand(t.shape, generator=g))
    twin = c.clone()
    copy_page(c, 3, 7)
    for t in (c.k, c.v, c.k_scale, c.v_scale):
        assert torch.equal(t[:, 7], t[:, 3])
    assert torch.equal(twin.k_scale[:, 3], c.k_scale[:, 3])
    assert twin.k_scale.data_ptr() != c.k_scale.data_ptr()


def test_weight_quant_and_int8_kv_route():
    """tests/test_quant.py's route: quant="int8" quantizes the weights
    only (pages come from kv_quant); "int8+kv" forces int8 pages when
    kv_quant is "none"; the snapshot reports both knobs."""
    cfg = _cfg()
    g = torch.Generator()
    g.manual_seed(0)
    params = init_params(cfg, g, device="cpu")
    kw = dict(max_seq_len=32, device="cpu")
    eng = GenerationEngine(cfg, params, quant="int8", **kw)
    assert not eng.cache_quant and eng.quant == "int8"
    ce = ContinuousEngine(eng, max_slots=2, page_size=8, kv_quant="int4")
    snap = ce.serving_snapshot()
    assert snap["kv_quant"] == "int4" and snap["weight_quant"] == "int8"
    # payload plus scales per page: 2 * L * Hkv * page * (hd/2 + 4)
    assert snap["kv_page_bytes"] == 2 * 2 * 2 * 8 * (16 // 2 + 4)
    ce.close()
    eng2 = GenerationEngine(cfg, params, quant="int8+kv", **kw)
    ce2 = ContinuousEngine(eng2, max_slots=2, page_size=8, kv_quant="none")
    assert ce2.kv_quant == "int8" and ce2.cache.quantized
    assert ce2.serving_snapshot()["weight_quant"] == "int8+kv"
    ce2.close()
    with pytest.raises(ValueError, match="quant mode"):
        GenerationEngine(cfg, params, quant="int4", **kw)
    plain = GenerationEngine(cfg, params, **kw)
    assert plain.quant is None and not plain.cache_quant
    snap = ContinuousEngine(plain, max_slots=2, page_size=8).serving_snapshot()
    assert snap["kv_quant"] == "none" and snap["weight_quant"] == "none"


def test_weight_quantized_engine_streams_match_jax():
    """A quant="int8" engine whose every matmul weight is quantized
    (``min_size=0`` on both sides: the tiny config's weights are under
    the default 65,536-element floor) serves greedy streams token-equal
    to the JAX engine's over int8 pages."""
    import jax

    from tensorlink_tpu.engine.continuous import ContinuousEngine as JEngine
    from tensorlink_tpu.engine.generate import GenerationEngine as JGen
    from tensorlink_tpu.engine.sampling import SamplingParams as JSP
    from tensorlink_tpu.models import init_params as j_init_params
    from tensorlink_tpu_torch.convert import params_from_jax
    from tensorlink_tpu_torch.engine.sampling import SamplingParams

    plain = j_init_params(JCFG, jax.random.PRNGKey(0))
    jparams = jq.quantize_params(plain, min_size=0)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    assert isinstance(tparams["layers"]["attn"]["wq"], tq.QTensor)
    kw = dict(seq_buckets=(8, 32), batch_buckets=(1,), max_seq_len=64)
    prompts = ([5, 6, 7, 200, 1, 1, 3], list(range(30, 52)))

    def streams(cls, gen, sp, kv_quant):
        ce = cls(gen, max_slots=4, page_size=8, chunk_steps=4,
                 prefill_chunk=16, kv_quant=kv_quant)
        reqs = [ce.submit(p, max_new_tokens=6, sampling=sp.make(), seed=1)
                for p in prompts]
        ce.run_until_idle()
        assert ce.kv_quant == "int8" and ce.cache.quantized
        return [list(r.tokens) for r in reqs]

    got = streams(ContinuousEngine, GenerationEngine(
        _cfg(), tparams, max_seq_len=64, device="cpu"), SamplingParams,
        "int8")
    assert got == streams(JEngine, JGen(JCFG, jparams, **kw), JSP, "int8")
    assert [len(s) for s in got] == [6, 6]
    # the quant="int8+kv" route on both sides: pages forced to int8
    tgen = GenerationEngine(_cfg(), params_from_jax(jax.device_get(plain),
                                                    device="cpu"),
                            max_seq_len=64, quant="int8+kv", device="cpu")
    jgen = JGen(JCFG, plain, quant="int8+kv", **kw)
    assert streams(ContinuousEngine, tgen, SamplingParams, "none") == \
        streams(JEngine, jgen, JSP, "none")


def test_batcher_passes_kv_quant():
    """ContinuousBatcher(kv_quant=...) reaches the engine's pages; the
    default stays "none", as in the JAX batcher."""
    from tensorlink_tpu_torch.ml.batching import ContinuousBatcher

    g = torch.Generator()
    g.manual_seed(0)
    eng = GenerationEngine(_cfg(), init_params(_cfg(), g, device="cpu"),
                           max_seq_len=32, device="cpu")
    b = ContinuousBatcher(engine=eng, kv_quant="int4", max_slots=2,
                          page_size=8)
    assert len(b.generate([5, 6, 7], max_new_tokens=4)) == 4
    st = b.stats()["engine"]
    assert st["kv_quant"] == "int4" and b.engine.cache.k.shape[-1] == 8
    b.close()
    plain = ContinuousBatcher(engine=eng, max_slots=2, page_size=8)
    assert plain.engine.kv_quant == "none" and not plain.engine.cache.quantized
    plain.close()
