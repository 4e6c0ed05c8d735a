"""Model configuration, presets and the decoder building blocks."""

from .base import ModelConfig
from .registry import config_presets
from .transformer import init_params

__all__ = ["ModelConfig", "config_presets", "init_params"]
