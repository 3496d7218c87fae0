"""Architecture registry: --arch <id> -> ArchConfig.

The port's copy of ``repro.configs.registry``: the same ids and the same
``CONFIG`` data, imported from ``repro_torch.configs``, the shape cells
that apply to each arch, and the per-arch §Perf bundles.
"""
from __future__ import annotations

from importlib import import_module
from typing import List

from ..models.config import ArchConfig, SHAPES, ShapeConfig

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


def shapes_for(cfg: ArchConfig) -> List[ShapeConfig]:
    """The shape cells that apply to an architecture.

    ``long_500k`` needs sub-quadratic attention: it runs only for the
    SSM/hybrid archs (mamba2, zamba2) and is SKIPPED for the 8 pure
    full-attention archs (documented in DESIGN.md §Shape skips)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.family in ("ssm", "hybrid"):
        out.append(SHAPES["long_500k"])
    return out


def cell_applicable(cfg: ArchConfig, shape_name: str) -> bool:
    return any(s.name == shape_name for s in shapes_for(cfg))


# ---------------------------------------------------------------------- #
# §Perf beyond-paper optimization bundles (EXPERIMENTS.md §Perf).
# The paper-faithful BASELINE keeps all of these off; ``--optimized``
# dry-runs apply them per architecture.
# ---------------------------------------------------------------------- #
_COMMON_OPT = {"bf16_grads": True, "seq_sharded_loss": True,
               "prefill_last_logits": True}

PERF_PATCHES = {
    "llama3.2-3b": dict(_COMMON_OPT),
    "phi3-medium-14b": dict(_COMMON_OPT),
    "nemotron-4-15b": dict(_COMMON_OPT),
    "phi4-mini-3.8b": dict(_COMMON_OPT),
    "musicgen-medium": dict(_COMMON_OPT),
    "qwen2-vl-72b": dict(_COMMON_OPT),
    "qwen3-moe-30b-a3b": {**_COMMON_OPT, "moe_impl": "a2a",
                          "capacity_factor": 1.0},
    "llama4-maverick-400b-a17b": {**_COMMON_OPT, "moe_impl": "a2a",
                              "moe_ep2d": True},
    "mamba2-2.7b": {**_COMMON_OPT, "ssm_seq_sharded": True,
                    "ssm_chunk": 128},
    "zamba2-2.7b": {**_COMMON_OPT, "ssm_seq_sharded": True,
                    "ssm_chunk": 128},
}


def perf_patch(arch_id: str) -> dict:
    return dict(PERF_PATCHES.get(arch_id, _COMMON_OPT))
