"""Configurations (port of ``repro.configs``): the ten architectures, the
shape cells and the paper's queue parameters, restated without a
framework."""

from repro_torch.configs.base import (
    ModelConfig,
    ParallelConfig,
    ShapeConfig,
    SHAPES,
    cells_for,
)
from repro_torch.configs.registry import ARCH_IDS, get, reduced

__all__ = [
    "ModelConfig",
    "ParallelConfig",
    "ShapeConfig",
    "SHAPES",
    "cells_for",
    "ARCH_IDS",
    "get",
    "reduced",
]
