"""Architecture registry: ``--arch <id>`` resolution.

Each assigned architecture lives in its own module exposing ``CONFIG``
(the exact published configuration) and ``smoke_config()`` (a reduced
same-family variant for CPU smoke tests).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "tinyllama-1.1b",
    "qwen3-4b",
    "qwen3-8b",
    "llama3-405b",
    "arctic-480b",
    "qwen2-moe-a2.7b",
    "mamba2-370m",
    "internvl2-26b",
    "musicgen-large",
    "recurrentgemma-9b",
)

_MODULE_OF = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str, **overrides) -> ModelConfig:
    if arch not in _MODULE_OF:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_OF[arch]}")
    cfg = mod.CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_OF[arch]}")
    cfg = mod.smoke_config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
