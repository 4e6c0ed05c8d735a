"""Model configuration, presets, the dense KV cache and the decoder."""

from .base import KVCache, ModelConfig
from .registry import config_presets
from .transformer import forward, init_params

__all__ = ["KVCache", "ModelConfig", "config_presets", "forward",
           "init_params"]
