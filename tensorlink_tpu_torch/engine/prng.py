"""threefry2x32 keys and draws in torch integer ops, bit for bit as
``jax.random`` (jax 0.9.0, ``jax_threefry_partitionable=True``).

The serving engine samples each slot's token ``n`` with the key
``fold_in(PRNGKey(seed), n)``; mirroring JAX's bits exactly makes the
port's sampled streams comparable token for token with the JAX engine's.
Keys are ``(k1, k2)`` pairs of uint32 values carried as int64 tensors
(torch has no full uint32 arithmetic); every operation masks back to 32
bits. Vectorised over any leading shape, on any device.

- ``PRNGKey(seed)`` = ``(seed >> 32, seed & 0xFFFFFFFF)``: ``(0, seed mod
  2**32)`` for an int32 seed.
- ``fold_in(key, d)`` = ``threefry2x32(key, (0, d))``.
- ``split(key, num)`` (the fold-like split): key ``i`` is
  ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``, both output words.
- ``random_bits(key, shape)`` (32-bit, partitionable): the counter of
  element ``i`` (row-major) is the 64-bit ``i`` split ``(hi, lo)``; the
  bits are ``x0 ^ x1`` of ``threefry2x32(key, (hi, lo))``.
- ``uniform`` keeps 23 random mantissa bits under exponent 0 and
  subtracts 1; ``gumbel`` (JAX's default "low" mode) is
  ``-log(-log(uniform(tiny, 1)))``; ``categorical`` is the gumbel-max
  argmax (first index on ties).
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 block (20 rounds) on broadcastable int64 tensors
    holding uint32 values; returns ``(y0, y1)``."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    x0 = (x0 + k1) & _MASK
    x1 = (x1 + k2) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.PRNGKey`` of int32 seeds (a tensor of any shape, or a
    Python int placed on ``device``): ``(0, seed mod 2**32)``."""
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor(int(seed), dtype=torch.int64, device=device)
    s = seed.to(torch.int64) & _MASK
    return torch.zeros_like(s), s


def fold_in(key, data: torch.Tensor):
    """``jax.random.fold_in``: the key hashed with uint32 ``data``."""
    k1, k2 = key
    d = data.to(torch.int64) & _MASK
    return threefry2x32(k1, k2, torch.zeros_like(d), d)


def split(key, num: int = 2) -> tuple:
    """``jax.random.split``: ``num`` new keys, each a ``(k1, k2)`` pair of
    the input key's shape — so ``key, sub = split(key)`` walks the chain
    as the JAX engine does."""
    k1, k2 = key
    idx = torch.arange(int(num), dtype=torch.int64, device=k1.device)
    y0, y1 = threefry2x32(k1[..., None], k2[..., None], idx >> 32,
                          idx & _MASK)
    return tuple((y0[..., i], y1[..., i]) for i in range(int(num)))


def random_bits(key, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` for each key (keys of shape
    ``B`` give ``B + shape``), as int64 in ``[0, 2**32)``."""
    k1, k2 = key
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=k1.device).reshape(shape)
    lead = k1.shape
    k1 = k1.reshape(*lead, *([1] * len(shape)))
    k2 = k2.reshape(*lead, *([1] * len(shape)))
    y0, y1 = threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    return y0 ^ y1


def uniform(key, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key, shape) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in float32."""
    return -torch.log(-torch.log(uniform(key, shape, minval=_TINY)))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of ``logits``
    ``[B, V]`` with one key per row: gumbel-max, first index on ties."""
    g = gumbel(key, (1, logits.shape[-1]))[:, 0]  # [B, V]
    return torch.argmax(g + logits, dim=-1)


__all__ = [
    "PRNGKey",
    "categorical",
    "fold_in",
    "gumbel",
    "random_bits",
    "split",
    "threefry2x32",
    "uniform",
]
