"""Proof-of-learning primitives (port of
``tensorlink_tpu/platform/proofs.py``).

- workers record a per-optimizer-step **proof entry** — gradient norm, a
  deterministic fixed-coordinate *sketch* of the step gradient (a small
  gather per leaf on the device, one host transfer), and a hash chained
  over the log (tamper-evident ordering);
- the validator pulls each worker's log (PROOF_REQ) and runs
  :func:`verify_proof_log` — continuity cosine over consecutive sketches,
  norm plausibility, chain integrity.

Gradient trees are the port's nested dicts of tensors, flattened in
``jax.tree.leaves`` order (dict keys sorted), so a sketch picks the same
coordinates as the JAX package's and the hashes agree for equal inputs.
At module level only numpy is imported (torch only inside
:func:`gradient_sketch`): the node's network process verifies logs and
loads neither torch nor jax.
"""

from __future__ import annotations

import hashlib

import numpy as np


def _tree_leaves(tree) -> list:
    """Leaves of nested dicts, tuples and lists, dict keys sorted (the
    ``jax.tree.leaves`` order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _tree_leaves(v)]
    if tree is None:
        return []
    return [tree]


def _host(x) -> np.ndarray:
    """A leaf on the host: numpy as is, a tensor copied over (bfloat16
    widened to float32, which numpy can hold exactly)."""
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "detach"):  # a torch tensor, without importing torch
        x = x.detach()
        if str(x.dtype) == "torch.bfloat16":
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _leaves(tree) -> list[np.ndarray]:
    return [_host(x) for x in _tree_leaves(tree)]


def gradient_hash(grads) -> str:
    """Deterministic digest of a gradient pytree (reference
    calculate_gradient_hash, proofs.py:6)."""
    h = hashlib.sha256()
    for leaf in _leaves(grads):
        h.update(np.ascontiguousarray(leaf, dtype=np.float32).tobytes())
    return h.hexdigest()


def gradient_continuity(g1, g2, *, min_cosine: float = -0.2) -> tuple[bool, float]:
    """Cosine similarity between consecutive gradient pytrees; wildly
    anti-correlated consecutive gradients suggest fabricated work
    (reference continuity check, proofs.py:23)."""
    a = np.concatenate([l.ravel().astype(np.float64) for l in _leaves(g1)])
    b = np.concatenate([l.ravel().astype(np.float64) for l in _leaves(g2)])
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    if denom == 0:
        return False, 0.0
    cos = float(a @ b / denom)
    return cos >= min_cosine, cos


SKETCH_DIM = 256


def gradient_sketch(grads, dim: int = SKETCH_DIM, seed: int = 0) -> np.ndarray:
    """Deterministic fixed-coordinate subsample of the flattened gradient
    pytree. The same ``seed`` picks the same coordinates every step, so the
    cosine between consecutive sketches estimates the true gradient
    continuity without shipping gradients. Device cost: one small gather
    per leaf; host transfer: ``dim`` floats total."""
    leaves = _tree_leaves(grads)
    sizes = [int(np.prod(tuple(l.shape))) for l in leaves]
    total = max(sum(sizes), 1)
    rng = np.random.default_rng(seed)
    gathers = []  # device-side slices; ONE host transfer at the end
    for leaf, n in zip(leaves, sizes):
        if n == 0:
            continue
        k = min(max(1, round(dim * n / total)), n)
        idx = np.sort(rng.choice(n, size=k, replace=False))
        if isinstance(leaf, np.ndarray):
            gathers.append(leaf.ravel()[idx].astype(np.float64))
        elif hasattr(leaf, "take_flat"):
            import torch

            # a leaf placed on a mesh: each coordinate from its piece
            gathers.append(leaf.take_flat(idx).to(torch.float64))
        else:
            import torch

            at = torch.as_tensor(idx, device=leaf.device)
            gathers.append(leaf.detach().reshape(-1)[at].to(torch.float64))
    if not gathers:
        return np.zeros(0)
    if isinstance(gathers[0], np.ndarray):
        return np.concatenate(gathers)
    import torch

    return torch.cat(gathers).cpu().numpy()


def proof_entry(
    step: int, grad_norm: float, sketch: np.ndarray, prev_hash: str = ""
) -> dict:
    """JSON-safe log entry; ``hash`` chains over (prev, step, sketch) so a
    log can't be silently reordered or rewritten after the fact."""
    sk = [round(float(v), 6) for v in np.asarray(sketch).ravel()]
    h = hashlib.sha256()
    h.update(prev_hash.encode())
    h.update(str(step).encode())
    h.update(repr(round(float(grad_norm), 9)).encode())
    h.update(np.asarray(sk, np.float64).tobytes())
    return {
        "step": int(step),
        "grad_norm": float(grad_norm),
        "sketch": sk,
        "hash": h.hexdigest(),
    }


def verify_proof_log(
    log: list[dict],
    *,
    min_cosine: float = -0.2,
    max_norm_ratio: float = 100.0,
) -> tuple[bool, dict]:
    """Monitor-side verification of a worker's proof log: hash-chain
    integrity, strictly increasing steps, finite sane norms, and gradient
    continuity over consecutive sketches (reference continuity semantics:
    flag wildly anti-correlated steps, proofs.py:23)."""
    if not log:
        return True, {"reason": "empty"}
    try:
        return _verify_entries(log, min_cosine, max_norm_ratio)
    except (KeyError, TypeError, ValueError, AttributeError, IndexError):
        # the log is adversarial input — a malformed entry is a failed
        # verdict, never an exception escaping into the monitor
        return False, {"reason": "malformed"}


def _verify_entries(
    log: list[dict], min_cosine: float, max_norm_ratio: float
) -> tuple[bool, dict]:
    prev_hash = str(log[0].get("_chain_root", ""))
    cosines = []
    # entries contributing no continuity evidence (empty or all-zero
    # sketch — the worker's documented fallback emits np.zeros(0))
    sketchless = sum(
        1 for e in log
        if not np.any(np.asarray(e.get("sketch", []), np.float64))
    )
    for i, e in enumerate(log):
        expect = proof_entry(
            e.get("step", -1), e.get("grad_norm", 0.0),
            np.asarray(e.get("sketch", []), np.float64), prev_hash,
        )["hash"]
        if e.get("hash") != expect:
            return False, {"reason": "chain-broken", "at": i}
        prev_hash = e["hash"]
        gn = float(e.get("grad_norm", np.nan))
        if not np.isfinite(gn) or gn < 0:
            return False, {"reason": "bad-norm", "at": i}
        if i:
            if int(e["step"]) <= int(log[i - 1]["step"]):
                return False, {"reason": "non-increasing-step", "at": i}
            prev_gn = max(float(log[i - 1]["grad_norm"]), 1e-12)
            if gn / prev_gn > max_norm_ratio:
                return False, {"reason": "norm-spike", "at": i,
                               "ratio": gn / prev_gn}
            a = np.asarray(log[i - 1].get("sketch", []), np.float64)
            b = np.asarray(e.get("sketch", []), np.float64)
            if a.size and b.size and a.shape != b.shape:
                return False, {"reason": "sketch-shape", "at": i}
            denom = (
                np.linalg.norm(a) * np.linalg.norm(b)
                if a.shape == b.shape else 0.0
            )
            if denom > 0:
                cosines.append(float(a @ b / denom))
    if cosines and float(np.median(cosines)) < min_cosine:
        return False, {"reason": "anti-correlated",
                       "median_cosine": float(np.median(cosines))}
    # all-empty / all-zero sketches would trivially bypass the continuity
    # check. The worker's sketch fallback (np.zeros(0) on a sketch error)
    # makes an occasional sketchless entry legitimate; more than a quarter
    # of a multi-entry log contributing no evidence is not
    if len(log) >= 3 and sketchless > max(1, len(log) // 4):
        return False, {"reason": "sketchless", "n_sketchless": sketchless}
    return True, {
        "n": len(log),
        "median_cosine": float(np.median(cosines)) if cosines else None,
    }


def loss_plausibility(
    losses: list[float], *, max_spike: float = 3.0, min_progress: float = -0.5
) -> tuple[bool, dict]:
    """Loss-trajectory sanity (reference monotonicity check, proofs.py:41,
    loosened: real training is noisy). Flags NaN/Inf, per-step spikes
    > max_spike×, and net regression beyond min_progress of the start."""
    arr = np.asarray(losses, np.float64)
    if arr.size == 0:
        return False, {"reason": "empty"}
    if not np.isfinite(arr).all():
        return False, {"reason": "non-finite"}
    spikes = arr[1:] / np.maximum(arr[:-1], 1e-12)
    if arr.size > 1 and float(spikes.max()) > max_spike:
        return False, {"reason": "spike", "max_ratio": float(spikes.max())}
    progress = (arr[0] - arr[-1]) / max(abs(arr[0]), 1e-12)
    ok = progress >= min_progress
    return ok, {"progress": float(progress)}
