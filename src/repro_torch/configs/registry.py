"""--arch registry: canonical ids -> ArchConfig (full and reduced)."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ArchConfig, SHAPES, ShapeConfig  # noqa: F401

_MODULES = {
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, reduced: bool = False) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.reduced() if reduced else mod.CONFIG


def all_configs(reduced: bool = False) -> Dict[str, ArchConfig]:
    return {a: get_config(a, reduced) for a in ARCH_IDS}


def get_shape(shape_id: str) -> ShapeConfig:
    if shape_id not in SHAPES:
        raise KeyError(f"unknown shape {shape_id!r}; known: {sorted(SHAPES)}")
    return SHAPES[shape_id]


def cells(include_skips: bool = False):
    """Yield (arch_id, shape_id, applicable, reason) for all 40 cells."""
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES:
            ok, reason = SHAPES[s].applicable(cfg)
            if ok or include_skips:
                yield a, s, ok, reason
