"""Moving configs and parameter trees over from the JAX package.

Both packages keep weights as ``[in, out]`` matrices stacked ``[L, …]``
under the same leaf names, so a JAX tree becomes a port tree by a pure
relayout: no transposes, no renames. The caller hands the tree over as
numpy arrays (``jax.device_get``), which keeps this module free of JAX.
A weight-only int8 leaf (the JAX ``QTensor``) arrives as any object with
numpy ``.q`` and ``.scale`` and becomes the port's ``QTensor``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.devices import resolve_device
from .models.base import ModelConfig
from .models.quant import QTensor

_TORCH_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
    "int32": torch.int32,
    "int64": torch.int64,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy (or ``ml_dtypes``) dtype, a scalar type
    numpy understands, a dtype name, or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _TORCH_DTYPES[name]
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


def config_from_jax(fields: dict) -> ModelConfig:
    """A JAX ``ModelConfig`` given as a field dict
    (``dataclasses.asdict``) → the port's config; ``dtype`` may be a
    numpy dtype, a scalar type or its name."""
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in fields.items() if k in known}
    kw["dtype"] = torch_dtype(fields.get("dtype", "bfloat16"))
    return ModelConfig(**kw)


__all__ = ["config_from_jax", "params_from_jax", "torch_dtype"]
