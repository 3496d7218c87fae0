"""Decoder-only backbone, dense family: init specs, forward, decode step.

The port of the dense branches of ``repro/models/transformer.py``. The
layers are stacked on a leading ``[L, ...]`` axis as in JAX, so weights
copy across one to one; the JAX ``scan`` over layers is a Python loop.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .config import ArchConfig
from .layers import (attention, attn_specs, embed_specs, embed_tokens,
                     lm_logits, mlp, mlp_specs, stack_specs)


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.is_moe or cfg.frontend != "token":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (dense only)")


def init_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """The full parameter-spec tree of a dense architecture."""
    _check_dense(cfg)
    return {"embed": embed_specs(cfg),
            "blocks": stack_specs({"attn": attn_specs(cfg), "mlp": mlp_specs(cfg)},
                                  cfg.n_layers)}


def make_positions(cfg: ArchConfig, batch: int, seq: int, offset: int = 0,
                   device=None) -> torch.Tensor:
    if cfg.rope == "mrope":
        raise NotImplementedError("M-RoPE lands with the vlm family")
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    return pos.expand(batch, seq)


def _layer(blocks: Dict, i: int) -> Dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in blocks.items()}


def forward(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
            want_cache: bool = False,
            logits_positions: str = "all") -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence forward over tokens [b, s]. Returns (logits, cache or
    None); the cache is {"k", "v"}: [L, b, s, kvh, d] in the compute dtype."""
    b, s = tokens.shape
    x = embed_tokens(tokens, params["embed"], cfg)
    positions = make_positions(cfg, b, s, device=tokens.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        bp = _layer(params["blocks"], i)
        a, kv = attention(x, bp["attn"], cfg, positions, want_cache=want_cache)
        x = x + a
        x = x + mlp(x, bp["mlp"], cfg)
        if want_cache:
            ks.append(kv["k"])
            vs.append(kv["v"])
    if logits_positions == "last":
        x = x[:, -1:, :]
    logits = lm_logits(x, params["embed"], cfg)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)} if want_cache else None
    return logits, cache


def init_cache_specs(cfg: ArchConfig, batch: int, seq: int,
                     dtype=torch.bfloat16) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each decode-cache buffer: k/v [L, b, S, kvh, d].
    bf16 whatever the compute dtype, as in JAX."""
    _check_dense(cfg)
    kvd = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.hd)
    return {"k": (kvd, dtype), "v": (kvd, dtype)}


def decode_step(params: Dict, cache: Dict, cfg: ArchConfig,
                tokens: torch.Tensor, pos: int) -> Tuple[torch.Tensor, Dict]:
    """One decode step. tokens [b, 1]; ``pos`` is the write position (the
    current context length). Writes the new k/v into ``cache`` in place
    and returns (logits [b, 1, v], cache)."""
    b = tokens.shape[0]
    x = embed_tokens(tokens, params["embed"], cfg)
    positions = make_positions(cfg, b, 1, offset=pos, device=tokens.device)
    for i in range(cfg.n_layers):
        bp = _layer(params["blocks"], i)
        a, _ = attention(x, bp["attn"], cfg, positions,
                         cache={"k": cache["k"][i], "v": cache["v"][i]},
                         cache_index=pos)
        x = x + a
        x = x + mlp(x, bp["mlp"], cfg)
    return lm_logits(x, params["embed"], cfg), cache
