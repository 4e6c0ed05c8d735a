"""Token sampling (port of ``tensorlink_tpu/engine/sampling.py`` and of
``engine/continuous.py::_row_keys``/``_sample_rows``).

Temperature, top-k, top-p and OpenAI-style presence/frequency penalties,
with the JAX rules kept exactly: the sort is stable (ties keep vocabulary
order), top-p keeps the smallest prefix whose mass before each token is
below ``top_p``, the draw is gumbel-max over the filtered sorted logits
with the row's own threefry key (``engine/prng.py``), and argmax takes
the first index. So on the same logits both packages pick the same token.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import prng


@dataclass
class SamplingParams:
    """One request's sampling knobs (plain Python scalars)."""

    temperature: float = 0.0  # <= 0 → greedy
    top_k: int = 0  # 0 → disabled
    top_p: float = 1.0  # >= 1 → disabled
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0

    @classmethod
    def make(
        cls, temperature=0.0, top_k=0, top_p=1.0,
        presence_penalty=0.0, frequency_penalty=0.0,
    ) -> "SamplingParams":
        return cls(
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), presence_penalty=float(presence_penalty),
            frequency_penalty=float(frequency_penalty),
        )


def _row_keys(seeds: torch.Tensor, steps: torch.Tensor):
    """Per-slot sampling keys ``fold_in(PRNGKey(seed_s), step_s)`` —
    stateless in the step index, which is what makes mid-flight admission
    and resumption exact."""
    return prng.fold_in(prng.PRNGKey(seeds), steps)


def _filter(logits, temp, top_k, top_p, pres, freq, counts):
    """Penalties, temperature, top-k and top-p over ``logits [B, V]`` with
    per-row knobs ``[B]``. Returns ``(greedy, sort_idx, masked)``: the
    argmax of the penalized logits, the stable descending sort order of
    the scaled logits, and the scaled sorted logits with every filtered
    token at ``-inf``."""
    logits = logits.float()
    cf = counts.float()
    logits = logits - pres[:, None] * (cf > 0) - freq[:, None] * cf
    greedy = torch.argmax(logits, dim=-1)
    V = logits.shape[-1]
    scaled = logits / torch.clamp(temp, min=1e-6)[:, None]
    sort_idx = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_logits = torch.gather(scaled, -1, sort_idx)
    ranks = torch.arange(V, device=logits.device)[None, :]
    k = torch.where(top_k > 0, top_k, V).to(torch.int64)
    keep = ranks < k[:, None]
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep &= (cum - probs) < top_p[:, None]
    masked = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, float("-inf")))
    return greedy, sort_idx, masked


def _sample_rows(logits, keys, temp, top_k, top_p, pres, freq, counts):
    """Row-independent sampling of ``logits [S, V]``: each row uses its own
    key and knobs (``[S]`` tensors) and its own context histogram
    ``counts [S, V]``, exactly as the JAX engine's per-row ``sample``
    under ``vmap`` — both the sampled and the greedy pick are computed and
    each row selects by its temperature, so no host decision is needed."""
    greedy, sort_idx, masked = _filter(
        logits, temp, top_k, top_p, pres, freq, counts
    )
    choice = prng.categorical(keys, masked)
    picks = torch.gather(sort_idx, -1, choice[:, None])[:, 0]
    return torch.where(temp > 0.0, picks, greedy).to(torch.int32)


def sample(logits: torch.Tensor, key, p: SamplingParams,
           counts: torch.Tensor | None = None) -> torch.Tensor:
    """The JAX ``sample`` with scalar knobs: one key ``(k1, k2)`` draws
    gumbel noise over the whole ``[B, V]`` block; greedy when the
    temperature is not positive. ``counts [B, V]`` applies the
    penalties."""
    B, V = logits.shape
    dev = logits.device

    def full(v, dtype):
        return torch.full((B,), v, dtype=dtype, device=dev)

    if counts is None:
        counts = torch.zeros((B, V), dtype=torch.int32, device=dev)
    temp = full(p.temperature, torch.float32)
    greedy, sort_idx, masked = _filter(
        logits, temp, full(p.top_k, torch.int32),
        full(p.top_p, torch.float32), full(p.presence_penalty, torch.float32),
        full(p.frequency_penalty, torch.float32), counts,
    )
    if p.temperature <= 0:
        return greedy.to(torch.int32)
    choice = torch.argmax(prng.gumbel(key, (B, V)) + masked, dim=-1)
    return torch.gather(sort_idx, -1, choice[:, None])[:, 0].to(torch.int32)


__all__ = ["SamplingParams", "sample"]
