"""The model holder the serving engine wraps (port of the parts of
``tensorlink_tpu/engine/generate.py::GenerationEngine`` that
``ContinuousEngine`` reads).

It owns one model's config and parameters on one device. Dense
generation (bucketed prefill, ``generate_compiled``, beam, lookahead) and
the flash prefill wait for the dense-generation slice.
"""

from __future__ import annotations

import torch

from ..core.devices import resolve_device
from ..models.base import ModelConfig

DEFAULT_MAX_SEQ_LEN = 4096  # the JAX engine's largest default seq bucket


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class GenerationEngine:
    """One loaded model on one device: ``cfg``, ``params`` (moved to
    ``device``), ``max_seq_len``, ``cache_dtype`` and ``cache_quant``.
    ``device=None`` is the CUDA card."""

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
        if quant:
            raise NotImplementedError(
                f"quant={quant!r}: weight-only int8 serving is not ported "
                "yet — it arrives with the int8/int4 slice of the port"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.quant = None
        self.cache_quant = False
        self.max_seq_len = int(
            max_seq_len or min(cfg.max_seq_len, DEFAULT_MAX_SEQ_LEN)
        )
        self.cache_dtype = cache_dtype or cfg.dtype


__all__ = ["GenerationEngine"]
