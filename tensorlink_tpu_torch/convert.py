"""Moving configs and parameter trees over from the JAX package.

Both packages keep weights as ``[in, out]`` matrices stacked ``[L, …]``
under the same leaf names, so a JAX tree becomes a port tree by a pure
relayout: no transposes, no renames. The caller hands the tree over as
numpy arrays (``jax.device_get``), which keeps this module free of JAX.
A weight-only int8 leaf (the JAX ``QTensor``) arrives as any object with
numpy ``.q`` and ``.scale`` and becomes the port's ``QTensor``. A dense
JAX ``KVCache`` (fp, or int8 with scales) arrives the same way, as an
object with numpy ``.k``/``.v``/``.length`` (and ``.k_scale``/
``.v_scale``), and becomes the port's ``KVCache`` with the same layout.

Serving state crosses too: a JAX engine's migration or prefix blob
(``export_slot``, ``export_prefix_pages``) becomes a blob the port's
``stage_migration``/``stage_prefix`` take (:func:`blob_from_jax`), and a
JAX ``HostPagePool``'s entries load into the port's
(:func:`host_pool_from_jax`) — the same bytes, bfloat16 payloads carried
as their 16 bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.devices import resolve_device
from .core.serialization import BFLOAT16
from .models.base import DTYPES, KVCache, ModelConfig
from .models.quant import QTensor


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy (or ``ml_dtypes``) dtype, a scalar type
    numpy understands, a dtype name, or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return DTYPES[name]
    except KeyError:
        raise TypeError(f"no torch dtype for {name!r}") from None


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.array(a)  # a writable copy: the tensor owns its memory
    if a.dtype.name == "bfloat16":
        # numpy has no native bfloat16: move the 16-bit payload, then view
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree, device=None, dtype: torch.dtype | None = None):
    """A JAX parameter tree given as (nested dicts of) numpy arrays → the
    port's dict of tensors on ``device`` (None = the CUDA card), float
    leaves cast to ``dtype`` when given. Leaf names and shapes are kept
    exactly; a quantized leaf keeps its int8 codes and f32 scales."""
    return _convert(tree, resolve_device(device), dtype)


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "scale"):  # a JAX QTensor
        return QTensor(q=_tensor(tree.q, device, None),
                       scale=_tensor(tree.scale, device, None))
    return _tensor(tree, device, dtype)


def kv_cache_from_jax(cache, device=None) -> KVCache:
    """A JAX dense ``KVCache`` given with numpy leaves (``jax.device_get``)
    → the port's ``KVCache`` on ``device`` (None = the CUDA card): the
    same ``[L, B, S, n_kv, hd]`` payload bytes, ``length``, and in int8
    mode the f32 ``[L, B, S, n_kv, 1]`` scales."""
    dev = resolve_device(device)

    def t(a):
        return None if a is None else _tensor(a, dev, None)

    return KVCache(k=t(cache.k), v=t(cache.v), length=t(cache.length),
                   k_scale=t(getattr(cache, "k_scale", None)),
                   v_scale=t(getattr(cache, "v_scale", None)))


def _host(a):
    """A numpy payload as the port keeps it on the host: an ``ml_dtypes``
    bfloat16 array becomes its 16-bit payload under ``BFLOAT16``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" and a.dtype != BFLOAT16:
        return a.view(np.uint16).view(BFLOAT16)
    return a


def blob_from_jax(blob: dict) -> dict:
    """A JAX engine's migration or prefix blob (numpy leaves, e.g. after
    ``jax.device_get`` or a TLTS round trip) → the port's blob: every key
    and value kept, payload arrays in the port's host representation."""
    return {k: _host(v) if isinstance(v, np.ndarray) else v
            for k, v in blob.items()}


def host_pool_from_jax(jax_pool, pool) -> int:
    """Load a JAX ``HostPagePool``'s entries into the port's ``pool``
    (least recently used first, so the LRU order carries over). Returns
    the entries loaded."""
    entries = sorted(jax_pool._entries.values(), key=lambda e: e.tick)
    for e in entries:
        pool.put(
            e.blocks, _host(e.k), _host(e.v),
            None if e.k_scale is None else _host(e.k_scale),
            None if e.v_scale is None else _host(e.v_scale),
            weights_version=e.weights_version,
        )
    return len(entries)


def config_from_jax(fields: dict) -> ModelConfig:
    """A JAX ``ModelConfig`` given as a field dict
    (``dataclasses.asdict``) → the port's config; ``dtype`` may be a
    numpy dtype, a scalar type or its name."""
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in fields.items() if k in known}
    kw["dtype"] = torch_dtype(fields.get("dtype", "bfloat16"))
    return ModelConfig(**kw)


__all__ = ["blob_from_jax", "config_from_jax", "host_pool_from_jax",
           "kv_cache_from_jax", "params_from_jax", "torch_dtype"]
