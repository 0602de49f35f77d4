"""The port's own copy of the JAX package's architecture and shape
configurations (data and dataclasses only), so that the port imports
nothing of ``repro``.  ``tests/test_torch_models.py`` holds every config
equal to the reference's."""
from repro_torch.configs.base import ArchConfig, LayerSpec, ShapeConfig, SHAPES
from repro_torch.configs.registry import ARCH_IDS, all_configs, cells, get_config, get_shape

__all__ = [
    "ArchConfig", "LayerSpec", "ShapeConfig", "SHAPES",
    "ARCH_IDS", "all_configs", "cells", "get_config", "get_shape",
]
