"""The port's threefry keys and sampler against ``jax.random`` and the JAX
engine's sampler (tensorlink_tpu_torch/engine/prng.py, engine/sampling.py).

Key bits, random bits and uniforms are integer/bit-exact. The gumbel
transform ``-log(-log(u))`` runs each ``log`` within 1 ulp of XLA's (the
two libraries' float32 ``log`` differ in the last bit); near g = 0 the
outer log amplifies that to ~5e-7 absolute, so gumbel is held at 1e-6.
Sampled tokens are compared on logits whose top-p cut sits midway between
two cumulative masses, away from the 1-ulp boundary where the two
``cumsum``s could disagree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.engine.continuous import _row_keys as j_row_keys
from tensorlink_tpu.engine.continuous import _sample_rows as j_sample_rows
from tensorlink_tpu.engine.sampling import SamplingParams as JSamplingParams
from tensorlink_tpu.engine.sampling import sample as j_sample
from tensorlink_tpu_torch.engine import prng
from tensorlink_tpu_torch.engine.sampling import (
    SamplingParams,
    _row_keys,
    _sample_rows,
    sample,
)

# one intra-op thread: a JAX call in this process can leave torch's worker
# threads computing exp off by up to 1e-4 (tests/test_torch_flash.py)
torch.set_num_threads(1)

SEEDS = (0, 1, -1, 7, 12345, 2**31 - 1, -(2**31), -987654321)
STEPS = (0, 1, 2, 63, 1000, 2**31 - 1)
TINY = float(np.finfo(np.float32).tiny)


def _t32(x):
    return torch.tensor(x, dtype=torch.int32)


def _key_pair(seed, step):
    jk = jax.random.fold_in(jax.random.PRNGKey(jnp.int32(seed)), jnp.int32(step))
    tk = prng.fold_in(prng.PRNGKey(_t32(seed)), _t32(step))
    return jk, tk


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_keys_and_bits_match_jax_exactly(seed):
    """PRNGKey (negative and large seeds), fold_in over many steps and the
    partitionable 32-bit random bits equal jax.random's bit for bit."""
    jkey = jax.random.PRNGKey(jnp.int32(seed))
    tkey = prng.PRNGKey(_t32(seed))
    assert [int(x) for x in tkey] == np.asarray(
        jax.random.key_data(jkey)
    ).astype(np.int64).tolist()
    for step in STEPS:
        jk, tk = _key_pair(seed, step)
        want = np.asarray(jax.random.key_data(jk)).astype(np.int64).tolist()
        assert [int(x) for x in tk] == want, step
        for shape in ((1, 258), (3, 5), (7,)):
            jb = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
            tb = prng.random_bits(tk, shape).numpy()
            assert np.array_equal(jb, tb), (step, shape)


def test_row_keys_match_jax_exactly():
    """The engine's per-slot keys fold_in(PRNGKey(seed_s), step_s), batched
    over slots, equal the JAX engine's vmapped keys."""
    rng = np.random.default_rng(0)
    seeds = rng.integers(-(2**31), 2**31 - 1, size=16).astype(np.int32)
    steps = rng.integers(0, 5000, size=16).astype(np.int32)
    jk = np.asarray(jax.random.key_data(
        j_row_keys(jnp.asarray(seeds), jnp.asarray(steps))
    )).astype(np.int64)
    k1, k2 = _row_keys(torch.from_numpy(seeds), torch.from_numpy(steps))
    assert np.array_equal(jk[:, 0], k1.numpy())
    assert np.array_equal(jk[:, 1], k2.numpy())


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_uniform_exact_and_gumbel_within_log_ulp(seed):
    for step in STEPS[:4]:
        jk, tk = _key_pair(seed, step)
        for lo in (0.0, TINY):
            ju = np.asarray(jax.random.uniform(jk, (1, 1024), minval=lo))
            tu = prng.uniform(tk, (1, 1024), minval=lo).numpy()
            assert np.array_equal(ju, tu), (step, lo)
        # tlint: disable=TL102(parity test: one key drives both packages' draws)
        u = np.asarray(jax.random.uniform(jk, (1, 1024), minval=TINY))
        # each log stage within 1 ulp of XLA's on the same input
        jl = np.asarray(jnp.log(jnp.asarray(u)))
        tl = torch.log(torch.from_numpy(u.copy())).numpy()
        assert np.abs(jl.view(np.int32) - tl.view(np.int32)).max() <= 1
        y = -jl
        jl2 = np.asarray(jnp.log(jnp.asarray(y)))
        tl2 = torch.log(torch.from_numpy(y.copy())).numpy()
        assert np.abs(jl2.view(np.int32) - tl2.view(np.int32)).max() <= 1
        # tlint: disable=TL102(parity test: one key drives both packages' draws)
        jg = np.asarray(jax.random.gumbel(jk, (1, 1024)))
        tg = prng.gumbel(tk, (1, 1024)).numpy()
        np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-6)


def _logits(rng, S, V, ties=False):
    lg = rng.normal(size=(S, V)).astype(np.float32) * 3.0
    if ties:
        lg = np.round(lg)  # many exact ties, including at the top
    return lg


def _top_p_midway(lg_row, temp, rank):
    """A top-p whose cut sits midway between the exclusive cumulative
    masses of sorted ranks ``rank`` and ``rank + 1`` (float64)."""
    s = np.sort(lg_row.astype(np.float64) / max(temp, 1e-6))[::-1]
    p = np.exp(s - s.max())
    p /= p.sum()
    excl = np.cumsum(p) - p
    return float((excl[rank] + excl[rank + 1]) / 2)


# tlint: disable=TL006(read-only constant table)
MODES = {
    "greedy": dict(temperature=0.0),
    "temperature": dict(temperature=0.8),
    "top_k": dict(temperature=1.0, top_k=5),
    "top_p": dict(temperature=0.9, top_p="mid"),
    "penalties": dict(temperature=0.7, top_k=40, presence_penalty=0.5,
                      frequency_penalty=0.3),
    "greedy_penalties": dict(temperature=0.0, presence_penalty=1.5,
                             frequency_penalty=0.5),
}


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_sample_rows_token_equal_to_jax(mode, ties):
    """The engine sampler over a slot batch (per-row keys, knobs and
    histograms) draws the JAX engine's tokens, step after step."""
    rng = np.random.default_rng(sorted(MODES).index(mode) * 2 + int(ties))
    S, V = 4, 258
    lg = _logits(rng, S, V, ties)
    counts = rng.integers(0, 3, size=(S, V)).astype(np.int32)
    knobs = dict(MODES[mode])
    temp = knobs.get("temperature", 0.0)
    top_p = knobs.get("top_p", 1.0)
    if top_p == "mid":
        top_p = [_top_p_midway(lg[s], temp, 4 + s) for s in range(S)]
    col = {
        "temp": np.full(S, temp, np.float32),
        "top_k": np.full(S, knobs.get("top_k", 0), np.int32),
        "top_p": np.asarray(np.broadcast_to(top_p, (S,)), np.float32),
        "pres": np.full(S, knobs.get("presence_penalty", 0.0), np.float32),
        "freq": np.full(S, knobs.get("frequency_penalty", 0.0), np.float32),
    }
    seeds = np.array([3, -5, 2**31 - 1, 11], np.int32)
    for step in range(24):
        steps = np.full(S, step, np.int32)
        want = np.asarray(j_sample_rows(
            jnp.asarray(lg), j_row_keys(jnp.asarray(seeds), jnp.asarray(steps)),
            *(jnp.asarray(col[k]) for k in ("temp", "top_k", "top_p", "pres",
                                            "freq")),
            jnp.asarray(counts),
        ))
        got = _sample_rows(
            torch.from_numpy(lg),
            _row_keys(torch.from_numpy(seeds), torch.from_numpy(steps)),
            *(torch.from_numpy(col[k]) for k in ("temp", "top_k", "top_p",
                                                 "pres", "freq")),
            torch.from_numpy(counts),
        ).numpy()
        assert np.array_equal(got, want), (step, got, want)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mode", ["greedy", "temperature", "top_k"])
def test_sample_scalar_knobs_matches_jax(mode, B):
    """``sample`` with one key and scalar knobs (noise drawn over the whole
    [B, V] block) equals the JAX ``sample``."""
    rng = np.random.default_rng(7)
    lg = _logits(rng, B, 300)
    knobs = MODES[mode]
    for step in range(8):
        jk, tk = _key_pair(42, step)
        want = np.asarray(j_sample(
            jnp.asarray(lg), jk, JSamplingParams.make(**knobs)
        ))
        got = sample(torch.from_numpy(lg), tk, SamplingParams.make(**knobs))
        assert np.array_equal(got.numpy(), want), step


def test_greedy_takes_the_first_index_on_ties():
    lg = np.zeros((2, 10), np.float32)
    lg[0, [3, 7]] = 5.0
    lg[1, [0, 9]] = 1.0
    z = np.zeros(2, np.float32)
    got = _sample_rows(
        torch.from_numpy(lg), _row_keys(_t32([0, 0]), _t32([0, 0])),
        torch.from_numpy(z), _t32([0, 0]), torch.ones(2),
        torch.from_numpy(z), torch.from_numpy(z),
        torch.zeros((2, 10), dtype=torch.int32),
    )
    assert got.tolist() == [3, 0]
