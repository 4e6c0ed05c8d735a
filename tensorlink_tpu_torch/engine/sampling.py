"""Token sampling (port of ``tensorlink_tpu/engine/sampling.py`` and of
``engine/continuous.py::_row_keys``/``_sample_rows``).

:func:`sample` is the dense engine's sampler (one key per call, scalar or
``[B, 1]`` knobs); :func:`_sample_rows` the serving step's (one key and
one knob per row).

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
    """Sampling knobs. Each field is a Python scalar (one request: the
    knob applies to every row) or a ``[B, 1]`` tensor (a batched mix of
    requests, built by :meth:`stack` or :meth:`pad_rows`)."""

    temperature: float | torch.Tensor = 0.0  # <= 0 → greedy
    top_k: int | torch.Tensor = 0  # 0 → disabled
    top_p: float | torch.Tensor = 1.0  # >= 1 → disabled
    presence_penalty: float | torch.Tensor = 0.0
    frequency_penalty: float | torch.Tensor = 0.0

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

    def _per_row(self) -> bool:
        return isinstance(self.temperature, torch.Tensor)

    def pad_rows(self, batch: int) -> "SamplingParams":
        """Pad per-row knobs to the engine's bucketed batch (extra rows
        decode greedily); scalar knobs pass through untouched."""
        if not self._per_row():
            return self
        n = self.temperature.reshape(-1).shape[0]
        if n == batch:
            return self

        def pad(leaf, fill, dtype):
            flat = torch.as_tensor(leaf, dtype=dtype).reshape(-1)
            tail = torch.full((batch - n,), fill, dtype=dtype,
                              device=flat.device)
            return torch.cat([flat, tail])[:, None]

        return SamplingParams(*(
            pad(getattr(self, name), fill, dtype)
            for name, fill, dtype in _COLUMNS
        ))

    @classmethod
    def stack(cls, params: "list[SamplingParams]",
              pad_to: int) -> "SamplingParams":
        """Per-row knobs ``[pad_to, 1]`` for a batched generate; rows past
        ``len(params)`` (bucket padding) decode greedily."""
        def col(name, fill, dtype):
            vals = [float(getattr(p, name)) for p in params]
            vals += [fill] * (pad_to - len(vals))
            return torch.tensor(vals, dtype=dtype)[:, None]

        return cls(*(col(*c) for c in _COLUMNS))

    def take(self, idx: torch.Tensor) -> "SamplingParams":
        """The rows ``idx`` of per-row knobs (scalar knobs unchanged)."""
        if not self._per_row():
            return self
        return SamplingParams(*(
            getattr(self, name)[idx.to(getattr(self, name).device)]
            for name, _, _ in _COLUMNS
        ))

    def to(self, device) -> "SamplingParams":
        """Per-row knobs moved to ``device`` (scalar knobs unchanged)."""
        if not self._per_row():
            return self
        return SamplingParams(*(
            getattr(self, name).to(device) for name, _, _ in _COLUMNS
        ))

    def any_sampled(self) -> bool:
        """Whether some row samples (temperature > 0): the host decision
        behind :func:`sample`'s all-greedy fast path."""
        t = self.temperature
        return bool((t > 0).any()) if isinstance(t, torch.Tensor) else t > 0

    def penalized(self) -> bool:
        """Whether some row applies a presence or frequency penalty."""
        return any(
            bool((v != 0).any()) if isinstance(v, torch.Tensor) else v != 0
            for v in (self.presence_penalty, self.frequency_penalty)
        )


# (field, padding-row fill, dtype) of the per-row knob columns
_COLUMNS = (
    ("temperature", 0.0, torch.float32),
    ("top_k", 0, torch.int32),
    ("top_p", 1.0, torch.float32),
    ("presence_penalty", 0.0, torch.float32),
    ("frequency_penalty", 0.0, torch.float32),
)


def _row_keys(seeds: torch.Tensor, steps: torch.Tensor):
    """Per-slot sampling keys ``fold_in(PRNGKey(seed_s), step_s)`` —
    stateless in the step index, which is what makes mid-flight admission
    and resumption exact."""
    return prng.fold_in(prng.PRNGKey(seeds), steps)


def _penalize(logits, pres, freq, counts):
    """OpenAI-style repetition control over the context so far (``counts
    [B, V]``; None applies nothing)."""
    if counts is None:
        return logits
    cf = counts.float()
    return logits - pres[:, None] * (cf > 0) - freq[:, None] * cf


def _filter(logits, temp, top_k, top_p, pres, freq, counts):
    """Penalties, temperature, top-k and top-p over ``logits [B, V]`` with
    per-row knobs ``[B]``. Returns ``(greedy, sort_idx, masked)``: the
    argmax of the penalized logits, the stable descending sort order of
    the scaled logits, and the scaled sorted logits with every filtered
    token at ``-inf``."""
    logits = _penalize(logits.float(), pres, freq, counts)
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
           counts: torch.Tensor | None = None, *,
           any_sampled: bool | None = None) -> torch.Tensor:
    """The JAX ``sample``: temperature / top-k / top-p over ``logits
    [B, V]`` with one key ``(k1, k2)`` drawing gumbel noise over the whole
    block, greedy where a row's temperature is not positive. Knobs are
    scalars or ``[B, 1]``; ``counts [B, V]`` applies the penalties. When
    no row samples, the vocabulary sort is skipped (the JAX all-greedy
    fast path); ``any_sampled`` states that on the host, so a caller with
    knobs on the device decides it once instead of syncing per call."""
    B, V = logits.shape
    dev = logits.device

    def col(v, dtype):
        if isinstance(v, torch.Tensor):
            return v.to(device=dev, dtype=dtype).reshape(-1).expand(B)
        return torch.full((B,), v, dtype=dtype, device=dev)

    temp = col(p.temperature, torch.float32)
    pres = col(p.presence_penalty, torch.float32)
    freq = col(p.frequency_penalty, torch.float32)
    if any_sampled is None:
        any_sampled = p.any_sampled()
    if not any_sampled:
        logits = _penalize(logits.float(), pres, freq, counts)
        return torch.argmax(logits, dim=-1).to(torch.int32)
    greedy, sort_idx, masked = _filter(
        logits, temp, col(p.top_k, torch.int32),
        col(p.top_p, torch.float32), pres, freq, counts,
    )
    choice = torch.argmax(prng.gumbel(key, (B, V)) + masked, dim=-1)
    picks = torch.gather(sort_idx, -1, choice[:, None])[:, 0]
    return torch.where(temp > 0.0, picks, greedy).to(torch.int32)


__all__ = ["SamplingParams", "sample"]
