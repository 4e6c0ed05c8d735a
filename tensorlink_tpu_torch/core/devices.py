"""Device resolution and the worker's device probe.

Every entry point (``init_params``, ``GenerationEngine``,
``ContinuousEngine``, ``ContinuousBatcher``, ``DistributedWorker``) takes
an explicit device. ``None`` means the CUDA card: the port exists to run
there, so a missing card is an error, never a silent move to the CPU.
Tests and CPU-only callers pass ``device="cpu"`` (``MLConfig.device`` for
a worker node).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# what a host device advertises when it has no memory statistics (the
# JAX worker's default for a CPU device)
CPU_CAPACITY_GB = 4.0


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


@dataclass
class DeviceProbe:
    """What a worker advertises about the device it serves on."""

    device: torch.device
    platform: str  # "gpu" | "cpu"
    hbm_bytes: float
    n_devices: int = 1


def probe_device(device=None, max_memory_gb: float | None = None) -> DeviceProbe:
    """The worker's capacity probe: a card advertises the free bytes
    ``torch.cuda.mem_get_info`` reports, the host ``max_memory_gb`` (else
    :data:`CPU_CAPACITY_GB`); ``max_memory_gb`` caps either. One device:
    a worker serves on one card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        free, _total = torch.cuda.mem_get_info(dev)
        cap = float(free)
        platform = "gpu"
    else:
        cap = float(max_memory_gb or CPU_CAPACITY_GB) * 1e9
        platform = "cpu"
    if max_memory_gb:
        cap = min(cap, float(max_memory_gb) * 1e9)
    return DeviceProbe(device=dev, platform=platform, hbm_bytes=cap)


__all__ = ["DeviceProbe", "probe_device", "resolve_device"]
