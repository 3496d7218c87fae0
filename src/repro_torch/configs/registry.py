"""Architecture registry: --arch <id> -> ArchConfig.

The port's copy of ``repro.configs.registry``: the same ids and the same
``CONFIG`` data, imported from ``repro_torch.configs``.
"""
from __future__ import annotations

from importlib import import_module
from typing import List

from ..models.config import ArchConfig

_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
    "phi3-medium-14b": "phi3_medium_14b",
    "nemotron-4-15b": "nemotron_4_15b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "musicgen-medium": "musicgen_medium",
    "mamba2-2.7b": "mamba2_2_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    mod = import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG
