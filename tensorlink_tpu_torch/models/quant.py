"""Matmul entry point (port of ``tensorlink_tpu/models/quant.py::matmul``).

The JAX package routes every weight product through ``matmul`` so that an
int8 ``QTensor`` weight dequantizes on the fly. This slice serves plain
weights only; ``QTensor``, ``quantize_kv*`` and the int4 packing come with
the int8/int4 slice, and ``matmul`` stays the one seam they will hook.
"""

from __future__ import annotations

import torch


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a plain ``[in, out]`` weight tensor."""
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            "quantized weights (QTensor) arrive with the int8/int4 slice "
            "of the port"
        )
    return x @ w


__all__ = ["matmul"]
