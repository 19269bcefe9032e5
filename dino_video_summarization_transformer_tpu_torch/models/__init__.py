from . import convert
from .timesformer import (
    TimeSformer,
    TimeSformerConfig,
    build_timesformer,
    config_from_cfg,
    vit_base_config,
    vit_small_config,
    vit_tiny_config,
)

__all__ = [
    "convert",
    "TimeSformer",
    "TimeSformerConfig",
    "build_timesformer",
    "config_from_cfg",
    "vit_base_config",
    "vit_small_config",
    "vit_tiny_config",
]
