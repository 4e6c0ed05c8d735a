"""The model holder the serving engine wraps (port of the parts of
``tensorlink_tpu/engine/generate.py::GenerationEngine`` that
``ContinuousEngine`` reads).

It owns one model's config and parameters on one device, optionally
weight-only int8 (``quant="int8"``; ``"int8+kv"`` also asks the serving
engine for int8 KV pages). Dense generation (bucketed prefill,
``generate_compiled``, beam, lookahead) and the flash prefill wait for
the dense-generation slice.
"""

from __future__ import annotations

import torch

from ..core.devices import resolve_device
from ..models.base import ModelConfig
from ..models.quant import quantize_params

DEFAULT_MAX_SEQ_LEN = 4096  # the JAX engine's largest default seq bucket


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)  # a tensor or a QTensor


class GenerationEngine:
    """One loaded model on one device: ``cfg``, ``params`` (moved to
    ``device``), ``max_seq_len``, ``cache_dtype``, ``quant`` and
    ``cache_quant``. ``device=None`` is the CUDA card. ``quant`` is None,
    ``"int8"`` (weight-only int8: ``quantize_params``) or ``"int8+kv"``
    (the same, and ``cache_quant`` asks for int8 KV pages)."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        *,
        max_seq_len: int | None = None,
        cache_dtype: torch.dtype | None = None,
        quant: str | None = None,
        device=None,
    ):
        if quant and quant not in ("int8", "int8+kv"):
            raise ValueError(f"unknown quant mode {quant!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        if quant:
            # on the device: the codes and scales are the same bits there
            self.params = quantize_params(self.params)
        self.quant = quant
        self.cache_quant = quant == "int8+kv"
        self.max_seq_len = int(
            max_seq_len or min(cfg.max_seq_len, DEFAULT_MAX_SEQ_LEN)
        )
        self.cache_dtype = cache_dtype or cfg.dtype


__all__ = ["GenerationEngine"]
