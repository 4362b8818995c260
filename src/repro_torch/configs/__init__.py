"""Model, shape and run configurations: a copy of ``repro.configs``."""
from .base import ModelConfig, MoEConfig, RunConfig, ShapeConfig, SSMConfig
from .registry import ARCHS, get_arch, reduced_config
from .shapes import (
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    ZOO_PHASES,
    ZOO_SHAPES,
    shapes_for,
    skipped_shapes_for,
    zoo_phases_for,
)

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "RunConfig",
    "ShapeConfig",
    "SSMConfig",
    "ARCHS",
    "get_arch",
    "reduced_config",
    "SHAPES",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "ZOO_PHASES",
    "ZOO_SHAPES",
    "shapes_for",
    "skipped_shapes_for",
    "zoo_phases_for",
]
