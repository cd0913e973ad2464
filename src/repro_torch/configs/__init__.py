"""Architecture config registry of the port.

``get_config(arch_id)`` returns the full configuration;
``get_smoke_config(arch_id)`` returns the reduced same-family config used by
the CPU tests.  The names are the JAX package's; the port has every one.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.common import ModelConfig

ALL_ARCHS: List[str] = [
    "mamba2-1.3b",
    "zamba2-1.2b",
    "nemotron-4-15b",
    "llama3.2-3b",
    "tinyllama-1.1b",
    "stablelm-3b",
    "mixtral-8x22b",
    "deepseek-v2-lite-16b",
    "whisper-large-v3",
    "qwen2-vl-2b",
]

PORTED_ARCHS: List[str] = [
    "mamba2-1.3b", "zamba2-1.2b", "nemotron-4-15b", "llama3.2-3b",
    "tinyllama-1.1b", "stablelm-3b", "mixtral-8x22b", "deepseek-v2-lite-16b",
    "whisper-large-v3", "qwen2-vl-2b"]


def _module(arch: str):
    if arch not in PORTED_ARCHS:
        raise ValueError(f"unknown arch {arch!r}; have {ALL_ARCHS}")
    name = arch.replace("-", "_").replace(".", "p")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()
