"""repro-lint rule plugins.

Each submodule holds one rule *family*; a rule registers itself with the
``@register`` decorator.  ``all_rules()`` imports every family module
and returns one instance per registered rule class — the engine, the
CLI, and the meta-test ("every shipped rule has a firing bad fixture")
all enumerate rules through it, so a rule that isn't registered simply
does not exist.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Type

from repro_torch.analysis.lint import Rule

_FAMILY_MODULES = ("determinism", "device", "concurrency", "durability")
_REGISTRY: Dict[str, Type[Rule]] = {}


def register(cls: Type[Rule]) -> Type[Rule]:
    if not cls.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if cls.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {cls.id}")
    _REGISTRY[cls.id] = cls
    return cls


def _load() -> None:
    for name in _FAMILY_MODULES:
        importlib.import_module(f"{__name__}.{name}")


def all_rules() -> List[Rule]:
    _load()
    return [cls() for _, cls in sorted(_REGISTRY.items())]


def rule_ids() -> List[str]:
    _load()
    return sorted(_REGISTRY)
