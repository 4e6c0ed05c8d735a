"""Device resolution for the port's entry points.

Every entry point (``init_params``, ``GenerationEngine``,
``ContinuousEngine``, ``ContinuousBatcher``) takes an explicit ``device``.
``None`` means the CUDA card: the port exists to run there, so a missing
card is an error, never a silent move to the CPU. Tests and CPU-only
callers pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda`` (raises when no card is visible); anything else
    is taken as given, and a CUDA device is checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available — pass device='cpu' to run the "
            "plain PyTorch path on the host"
        )
    return dev


__all__ = ["resolve_device"]
