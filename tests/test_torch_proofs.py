"""The port's proof-of-learning primitives (``platform/proofs.py``) against
the JAX package's on equal inputs: proof-entry hashes, the gradient
sketch's coordinates and values, gradient hashes, continuity and loss
plausibility, and the verifier's verdicts on good, reordered, tampered,
truncated, malformed and sketchless logs."""

import jax
import numpy as np
import pytest
import torch

from tensorlink_tpu.platform import proofs as jproofs
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.platform import proofs as tproofs

torch.set_num_threads(1)


def _grads(seed: int):
    """A gradient tree shaped like a model's (dicts, unsorted keys)."""
    rng = np.random.default_rng(seed)
    return {
        "layers": {"mlp": {"w_up": rng.standard_normal((2, 8, 12)),
                           "w_down": rng.standard_normal((2, 12, 8))},
                   "attn": {"wq": rng.standard_normal((2, 8, 8))}},
        "embed": {"tok": rng.standard_normal((40, 8))},
        "final_norm": {"scale": rng.standard_normal(8)},
    }


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("dim,seed", [(256, 0), (32, 7), (1000, 0x5eed)])
def test_gradient_sketch_picks_the_same_coordinates(dim, seed):
    g = _f32(_grads(1))
    want = jproofs.gradient_sketch(g, dim=dim, seed=seed)
    got = tproofs.gradient_sketch(params_from_jax(g, device="cpu"), dim=dim,
                                  seed=seed)
    assert got.dtype == np.float64 and np.array_equal(got, want)
    # numpy leaves take the same path
    assert np.array_equal(tproofs.gradient_sketch(g, dim=dim, seed=seed),
                          want)


def test_bf16_gradients_sketch_and_hash_as_jax():
    g = _f32(_grads(2))
    tg = params_from_jax(g, device="cpu", dtype=torch.bfloat16)
    jg = jax.tree.map(lambda a: jax.numpy.asarray(a, jax.numpy.bfloat16), g)
    assert np.array_equal(tproofs.gradient_sketch(tg, seed=3),
                          jproofs.gradient_sketch(jg, seed=3))
    assert tproofs.gradient_hash(tg) == jproofs.gradient_hash(jg)


def test_hashes_continuity_and_plausibility_equal_jax():
    g1, g2 = _f32(_grads(3)), _f32(_grads(4))
    t1, t2 = (params_from_jax(x, device="cpu") for x in (g1, g2))
    assert tproofs.gradient_hash(t1) == jproofs.gradient_hash(g1)
    assert tproofs.gradient_hash(t1) != tproofs.gradient_hash(t2)
    assert tproofs.gradient_continuity(t1, t2) == \
        jproofs.gradient_continuity(g1, g2)
    for losses in ([3.0, 2.5, 2.4], [1.0, 5.0], [2.0, float("nan")], [],
                   [1.0, 1.2, 1.9]):
        assert tproofs.loss_plausibility(losses) == \
            jproofs.loss_plausibility(losses)


def _log(pkg, n=5, prev=""):
    out = []
    for step in range(1, n + 1):
        sk = pkg.gradient_sketch(_f32(_grads(10 + step % 2)), dim=64,
                                 seed=9)
        e = pkg.proof_entry(step, 0.5 + 0.1 * step, sk, prev)
        out.append(e)
        prev = e["hash"]
    return out


def test_proof_entries_hash_as_jax():
    for step, gn, prev in ((1, 0.25, ""), (7, 3.0000000004, "ab" * 32),
                           (12, 1e-9, "")):
        sk = np.random.default_rng(step).standard_normal(17)
        assert tproofs.proof_entry(step, gn, sk, prev) == \
            jproofs.proof_entry(step, gn, sk, prev)
    assert _log(tproofs) == _log(jproofs)


def _variants():
    good = _log(jproofs, 6)
    reordered = [good[1], good[0]] + good[2:]
    tampered = [dict(e) for e in good]
    tampered[3]["grad_norm"] = 9.0
    truncated = [dict(e) for e in good[2:]]
    truncated[0]["_chain_root"] = good[1]["hash"]
    unrooted = good[2:]
    spiked = []
    prev = ""
    for step, gn in enumerate((1.0, 1.1, 500.0), 1):
        e = jproofs.proof_entry(step, gn, np.ones(4), prev)
        spiked.append(e)
        prev = e["hash"]
    sketchless = []
    prev = ""
    for step in range(1, 5):
        e = jproofs.proof_entry(step, 1.0, np.zeros(0), prev)
        sketchless.append(e)
        prev = e["hash"]
    anti = []
    prev = ""
    for step in range(1, 6):
        e = jproofs.proof_entry(step, 1.0, np.ones(8) * (-1) ** step, prev)
        anti.append(e)
        prev = e["hash"]
    return {
        "good": good, "empty": [], "reordered": reordered,
        "tampered": tampered, "truncated with root": truncated,
        "truncated without root": unrooted, "norm spike": spiked,
        "sketchless": sketchless, "anti-correlated": anti,
        "malformed": [{"step": "x"}], "not dicts": [1, 2],
    }


@pytest.mark.parametrize("case", list(_variants()))
def test_verify_proof_log_gives_jax_verdicts(case):
    log = _variants()[case]
    assert tproofs.verify_proof_log(log) == jproofs.verify_proof_log(log)
