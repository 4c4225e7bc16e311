"""Assigned-architecture registry: ``get_config(name)`` / ``ARCHS``."""
from __future__ import annotations

import importlib

ARCHS = [
    "smollm-135m",
    "qwen1.5-110b",
    "qwen2.5-3b",
    "deepseek-7b",
    "mamba2-1.3b",
    "whisper-small",
    "grok-1-314b",
    "llama4-scout-17b-a16e",
    "paligemma-3b",
    "zamba2-2.7b",
    "granite-4.0-h-small",
]

_MODULES = {name: name.replace("-", "_").replace(".", "_") for name in ARCHS}


def get_config(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_configs():
    return {name: get_config(name) for name in ARCHS}
