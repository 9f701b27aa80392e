"""Architecture registry of the port: ``get_config(arch)``."""
from __future__ import annotations

import importlib

from ..models.config import ArchConfig

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
}

ARCH_IDS = list(_MODULES)


def get_config(arch: str) -> ArchConfig:
    key = arch if arch in _MODULES else arch.replace("_", "-")
    for k, m in _MODULES.items():
        if m == arch:
            key = k
    if key not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has: {ARCH_IDS}")
    return importlib.import_module(f".{_MODULES[key]}", __package__).CONFIG
