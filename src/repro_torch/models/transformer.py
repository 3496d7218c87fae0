"""Decoder-only backbone: init specs, forward, decode step.

The port of ``repro/models/transformer.py``, all its families:

* dense transformers (llama3.2 / phi3 / nemotron / phi4, and the musicgen
  and qwen2-vl backbones) — attention + MLP per layer;
* MoE — attention + MoE per layer (qwen3-moe), or interleaved (llama4:
  ``moe_every`` 2) as groups of a dense layer and a MoE layer;
* SSM (mamba2) — one Mamba2 block per layer;
* hybrid (zamba2) — groups of ``shared_attn_every`` Mamba2 blocks, each
  group followed by one *shared* attention + MLP block (the same weights
  at every application).

The layers are stacked on a leading ``[L, ...]`` axis as in JAX, so
weights copy across one to one; the JAX ``scan`` over layers is a Python
loop over the stack's slices (one ``unbind`` per leaf, so a training
step's gradient of each stacked leaf is one stack of its layers' parts).
``cfg.remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``).

Under the Zero-3 layout a layer's split leaves arrive as ``Sharded``
shards and the layer body gathers them first (``gather_tree``), inside
the checkpointed region: remat gathers them again in the backward, and no
gathered weight is kept between the forward and the backward. Each
gather's backward reduce-scatters that use's gradient. The hybrid's
shared block is gathered at each application. The embedding table is
never gathered: each rank looks its tokens up in its own shard
(``layers.embed_tokens``).

Under a mesh whose "model" axis has m > 1 ranks (``ctx``), each rank's
residual stream is its rows and its block of m of the sequence, [b/data,
s/m, e], at every layer (JAX's ``constrain(x, "batch", "seq",
"embed")``): positions start at r s/m on model rank r, attention gathers
K and V over "model", the Mamba2 block takes its conv's halo from rank r
- 1 and runs the SSD scan on its heads over the whole sequence, the MoE
layer runs on the mesh (``moe.moe``), and the loss is this rank's part of
the global token mean.

The audio and vision frontends are stubs, as in JAX: those models take
precomputed frame or patch embeddings [b, s, e] (``embeds``) in place of
tokens. qwen2-vl rotates by M-RoPE over [3, b, s] position streams;
musicgen adds an absolute sinusoid to its inputs and, as JAX does for
every rope but "none", also rotates q and k by RoPE.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.sharding import ShardingCtx, gather_seq, gather_tree, seq_shards
from ..tally_hooks import count, span
from .config import ArchConfig
from .layers import (attention, attn_specs, cross_entropy, embed_specs, embed_tokens,
                     lm_logits, mlp, mlp_specs, stack_specs)
from .mamba2 import mamba_layer, mamba_specs, mamba_state_specs
from .moe import moe, moe_specs


def _interleaved(cfg: ArchConfig) -> bool:
    return cfg.is_moe and cfg.moe_every > 1


def _group_layout(cfg: ArchConfig) -> Tuple[int, int]:
    """(n_groups, layers_per_group): a hybrid's shared block follows each
    group; an interleaved MoE model's group is a dense layer and a MoE layer."""
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        per = cfg.shared_attn_every
        return cfg.n_layers // per, per
    if _interleaved(cfg):
        return cfg.n_layers // cfg.moe_every, cfg.moe_every
    return cfg.n_layers, 1


def init_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """The full parameter-spec tree of an architecture."""
    specs: Dict[str, Any] = {"embed": embed_specs(cfg)}
    if cfg.family in ("ssm", "hybrid"):
        specs["blocks"] = stack_specs(mamba_specs(cfg), cfg.n_layers)
        if cfg.family == "hybrid":
            specs["shared"] = {"attn": attn_specs(cfg), "mlp": mlp_specs(cfg)}
    elif _interleaved(cfg):
        specs["blocks"] = stack_specs(
            {"dense": {"attn": attn_specs(cfg), "mlp": mlp_specs(cfg)},
             "moe": {"attn": attn_specs(cfg), "ffn": moe_specs(cfg)}},
            _group_layout(cfg)[0])
    elif cfg.is_moe:
        specs["blocks"] = stack_specs({"attn": attn_specs(cfg), "ffn": moe_specs(cfg)},
                                      cfg.n_layers)
    else:
        specs["blocks"] = stack_specs({"attn": attn_specs(cfg), "mlp": mlp_specs(cfg)},
                                      cfg.n_layers)
    return specs


def make_positions(cfg: ArchConfig, batch: int, seq: int, offset: int = 0,
                   device=None) -> torch.Tensor:
    """[b, s] positions from ``offset``; under M-RoPE [3, b, s], the
    temporal, height and width streams all equal (text positions)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    pos = pos.expand(batch, seq)
    if cfg.rope == "mrope":
        return pos[None].expand(3, batch, seq)
    return pos


def _sinusoid(positions: torch.Tensor, e: int, dtype: torch.dtype) -> torch.Tensor:
    """Absolute sinusoidal embedding (MusicGen-style), [b, s, e]: [sin, cos]
    halves, not interleaved. The frequencies are computed in float64 and
    rounded to fp32 against fp32 positions, as JAX's numpy ones are."""
    half = e // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / half).astype(np.float32)
    ang = positions.float()[..., None] * torch.from_numpy(freqs).to(positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _inputs(params: Dict, cfg: ArchConfig, tokens: Optional[torch.Tensor],
            embeds: Optional[torch.Tensor], offset: int = 0,
            ctx: Optional[ShardingCtx] = None,
            seq_split: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first layer's input and the positions: embeds [b, s, e] cast to
    the compute dtype, or tokens [b, s] looked up in the embedding (under
    ``ctx``'s mesh, in the rank's shard of it); then, for ``abs_sin``, the
    sinusoid added in that dtype. With ``seq_split`` under a sequence split
    the s positions are the rank's block, from r s. The span ``model.embed``."""
    with span("model.embed"):
        if embeds is not None:
            x = embeds.to(getattr(torch, cfg.dtype))
        else:
            x = embed_tokens(tokens, params["embed"], cfg, ctx, seq_split)
        b, s = x.shape[:2]
        sp = seq_shards(ctx) if seq_split else None
        if sp is not None:
            offset += sp.rank * s
        positions = make_positions(cfg, b, s, offset=offset, device=x.device)
        if cfg.rope == "abs_sin":
            x = x + _sinusoid(positions, cfg.d_model, x.dtype)
        return x, positions


def _unstack(blocks: Dict, n: int) -> List[Dict]:
    """The n per-layer trees of a stacked ``[L, ...]`` tree (of tensors or
    ``Sharded`` shards)."""
    flat = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
            for k, v in blocks.items()}
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


def _cast_blocks(blocks: Dict, dtype: torch.dtype) -> Dict:
    """``cast_params_once``: every fp32 block leaf in the compute dtype."""
    return {k: _cast_blocks(v, dtype) if isinstance(v, dict)
            else v.to(dtype) if v.dtype == torch.float32 else v
            for k, v in blocks.items()}


def _block(x: torch.Tensor, bp: Dict, cfg: ArchConfig,
           positions: torch.Tensor, ctx: Optional[ShardingCtx] = None,
           **attn_kw) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Attention then the feed-forward: the MoE layer where ``bp`` has one
    ("ffn"), else the MLP. A dense or MoE layer, or the hybrid's shared
    block (the same weights at every application). ``ctx``: the mesh the
    batch is split over (attention's sequence split, ``moe.moe``). The
    spans ``block.attention`` and ``block.mlp`` (the MoE layer's too)."""
    with span("block.attention"):
        a, kv = attention(x, bp["attn"], cfg, positions, sp=seq_shards(ctx), **attn_kw)
        x = x + a
    with span("block.mlp"):
        ffn = moe(x, bp["ffn"], cfg, ctx) if "ffn" in bp else mlp(x, bp["mlp"], cfg)
        return x + ffn, kv


def _remat_body(body, **attrs):
    """``body`` as ``checkpoint`` runs it: its first call, the forward, is
    the span ``model.layer``; a later one, remat's recompute in the
    backward, is ``remat.layer`` and counts in ``remat.recomputes``."""
    first = [True]

    def run(*args):
        if first[0]:
            first[0] = False
            with span("model.layer", **attrs):
                return body(*args)
        count("remat.recomputes")
        with span("remat.layer", **attrs):
            return body(*args)
    return run


def forward(params: Dict, cfg: ArchConfig, tokens: Optional[torch.Tensor] = None,
            want_cache: bool = False,
            logits_positions: str = "all", *,
            embeds: Optional[torch.Tensor] = None,
            ctx: Optional[ShardingCtx] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence forward over tokens [b, s], or over ``embeds`` [b, s, e]
    for the stub frontends; under ``ctx``'s mesh the batch is this rank's
    block of a global one (its rows over "data", its positions over
    "model"), and so are the logits. Returns (logits, cache or None). The cache is, by family: dense and moe {"k", "v"} [L, b, s, kvh,
    d] in the compute dtype (interleaved moe [groups, 2, b, s, kvh, d]:
    each group's dense layer, then its MoE layer); ssm {"conv" [L, b, K-1,
    conv_dim], "ssm" [L, b, H, P, N]} in fp32; hybrid the ssm states plus
    {"shared_k", "shared_v"} [groups, b, s, kvh, d]."""
    sp = seq_shards(ctx)
    x, positions = _inputs(params, cfg, tokens, embeds, ctx=ctx)
    _, per = _group_layout(cfg)
    cache: Dict[str, list] = {}

    def collect(part: Optional[Dict], prefix: str = "") -> None:
        if want_cache:
            for k, v in part.items():
                cache.setdefault(prefix + k, []).append(v)

    def run(body, *args, **attrs):
        """A layer's body, the span ``model.layer`` with ``attrs`` (its
        index ``i``), recomputed in the backward under ``cfg.remat`` when a
        gradient is being taken (the cache path never is)."""
        if cfg.remat and not want_cache and torch.is_grad_enabled():
            return checkpoint(_remat_body(body, **attrs), *args, use_reentrant=False,
                              preserve_rng_state=False)
        with span("model.layer", **attrs):
            return body(*args)

    blocks = params["blocks"]
    if cfg.cast_params_once:
        blocks = _cast_blocks(blocks, getattr(torch, cfg.dtype))

    def block_body(x, bp):
        return _block(x, gather_tree(bp), cfg, positions, ctx, want_cache=want_cache)

    if cfg.family in ("ssm", "hybrid"):
        def ssm_body(x, bp):
            y, st = mamba_layer(x, gather_tree(bp), cfg, want_state=want_cache, sp=sp)
            return x + y, st

        for i, bp in enumerate(_unstack(blocks, cfg.n_layers)):
            x, st = run(ssm_body, x, bp, i=i)
            collect(st)
            if cfg.family == "hybrid" and (i + 1) % per == 0:
                x, kv = run(block_body, x, params["shared"], i=i, shared=True)
                collect(kv, "shared_")
    elif _interleaved(cfg):
        def group_body(x, bp):
            x, kv_dense = block_body(x, bp["dense"])
            x, kv_moe = block_body(x, bp["moe"])
            return x, kv_dense, kv_moe

        for i, bp in enumerate(_unstack(blocks, _group_layout(cfg)[0])):
            x, kv_dense, kv_moe = run(group_body, x, bp, i=i)
            collect(kv_dense, "dense_")
            collect(kv_moe)
    else:
        for i, bp in enumerate(_unstack(blocks, cfg.n_layers)):
            x, kv = run(block_body, x, bp, i=i)
            collect(kv)
    if logits_positions == "last":
        x = x[:, -1:, :]
        if sp is not None:
            # the sequence's last position is the last model rank's
            x = gather_seq(x, 1, sp)[:, -1:, :]
    logits = lm_logits(x, params["embed"], cfg)
    return logits, (_pack_cache(cfg, cache) if want_cache else None)


def _pack_cache(cfg: ArchConfig, cache: Dict[str, list]) -> Dict[str, torch.Tensor]:
    """The per-layer caches collected by ``forward``, stacked into the
    decode layout (an interleaved model's two layers of a group side by
    side on axis 1)."""
    if _interleaved(cfg):
        return {k: torch.stack([torch.stack(cache["dense_" + k]), torch.stack(cache[k])], 1)
                for k in ("k", "v")}
    return {k: torch.stack(v) for k, v in cache.items()}


def loss_fn(params: Dict, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` ({"tokens", "labels"}
    [b, s], or {"embeds" [b, s, e], "labels"} for the stub frontends), as
    ``repro/models/transformer.py::loss_fn``. Under ``ctx``'s mesh the batch
    is this rank's block (``forward``) and the loss its part of its data
    rank's mean: the sum of its tokens' losses over its rows' b s tokens,
    which the "model" ranks' parts sum to (the caller sums the parts over
    the mesh and divides by the data size). The cross-entropy is the span
    ``model.loss``."""
    logits, _ = forward(params, cfg, batch.get("tokens"), embeds=batch.get("embeds"), ctx=ctx)
    with span("model.loss"):
        loss = cross_entropy(logits, batch["labels"], onehot=cfg.onehot_ce)
    sp = seq_shards(ctx)
    return loss if sp is None else loss / sp.n


def init_cache_specs(cfg: ArchConfig, batch: int, seq: int, dtype=torch.bfloat16
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each decode-cache buffer: k/v [L, b, S, kvh, d]
    (bf16 whatever the compute dtype, as in JAX; an interleaved MoE
    model's [groups, 2, b, S, kvh, d]); SSM states fp32 [L, ...]; the
    hybrid's shared k/v [groups, b, S, kvh, d]."""
    groups, _ = _group_layout(cfg)
    kvd = (batch, seq, cfg.n_kv_heads, cfg.hd)
    if cfg.family in ("ssm", "hybrid"):
        cache = {k: ((cfg.n_layers,) + shape, dt)
                 for k, (shape, dt) in mamba_state_specs(cfg, batch).items()}
        if cfg.family == "hybrid":
            cache["shared_k"] = ((groups,) + kvd, dtype)
            cache["shared_v"] = ((groups,) + kvd, dtype)
        return cache
    lead = (groups, 2) if _interleaved(cfg) else (cfg.n_layers,)
    return {"k": (lead + kvd, dtype), "v": (lead + kvd, dtype)}


def cache_shardings(cfg: ArchConfig, ctx: ShardingCtx):
    """The layouts of ``init_cache_specs``' buffers (sequence-split KV, the
    SSM states' heads over "model"); None without a mesh."""
    if ctx.mesh is None:
        return None
    sh = ctx.sharding
    if cfg.family == "ssm":
        return {"conv": sh("layers", "batch", None, None),
                "ssm": sh("layers", "batch", "ssm_heads", None, None)}
    kv = sh("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    if cfg.family == "hybrid":
        return {"conv": sh("layers", "batch", None, None),
                "ssm": sh("layers", "batch", "ssm_heads", None, None),
                "shared_k": kv, "shared_v": kv}
    if _interleaved(cfg):
        kv2 = sh("layers", None, "batch", "kv_seq", "kv_heads", "head_dim")
        return {"k": kv2, "v": kv2}
    return {"k": kv, "v": kv}


def decode_step(params: Dict, cache: Dict, cfg: ArchConfig,
                tokens: Optional[torch.Tensor], pos: int, *,
                embeds: Optional[torch.Tensor] = None,
                ctx: Optional[ShardingCtx] = None) -> Tuple[torch.Tensor, Dict]:
    """One decode step. tokens [b, 1] (or ``embeds`` [b, 1, e]); ``pos`` is
    the write position (the current context length). Updates ``cache`` in
    place (new k/v at ``pos``, new SSM states) and returns (logits
    [b, 1, v], cache). Under ``ctx``'s mesh the rows are this rank's and
    whole over "model"; each layer's split leaves are gathered where they
    are used; the cache is this rank's blocks (``cache_shardings``):
    attention runs over the rank's block of the sequence and combines the
    model ranks' partial results, the MLP is tensor-parallel over "model"
    (its weights' "tp" blocks; with ``mlp_seq_sharded`` it runs whole on
    every model rank, its weights gathered whole, as JAX's decode then
    does), Mamba2 steps its H/m heads, and the MoE
    layer plans the batch's tokens over the batch axes, each model rank
    running its own experts (``moe.moe_dispatch``'s ``model``)."""
    sp = seq_shards(ctx)
    x, positions = _inputs(params, cfg, tokens, embeds, offset=pos, ctx=ctx, seq_split=False)
    groups, per = _group_layout(cfg)

    def block(x, bp, ck, cv):
        a, _ = attention(x, gather_tree(bp["attn"]), cfg, positions, cache={"k": ck, "v": cv},
                         cache_index=pos, sp=sp)
        x = x + a
        if "ffn" in bp:
            ffn = moe(x, gather_tree(bp["ffn"]), cfg, ctx, seq_split=False)
        elif sp is not None and not cfg.mlp_seq_sharded:
            ffn = mlp(x, bp["mlp"], cfg, sp=sp)
        else:
            ffn = mlp(x, gather_tree(bp["mlp"]), cfg)
        return x + ffn

    if cfg.family in ("ssm", "hybrid"):
        layers = _unstack(params["blocks"], cfg.n_layers)
        for i in range(cfg.n_layers):
            y, st = mamba_layer(x, gather_tree(layers[i]), cfg,
                                state={"conv": cache["conv"][i], "ssm": cache["ssm"][i]}, sp=sp)
            cache["conv"][i].copy_(st["conv"])
            cache["ssm"][i].copy_(st["ssm"])
            x = x + y
            if cfg.family == "hybrid" and (i + 1) % per == 0:
                g = i // per
                x = block(x, params["shared"], cache["shared_k"][g], cache["shared_v"][g])
    elif _interleaved(cfg):
        for g, bp in enumerate(_unstack(params["blocks"], groups)):
            x = block(x, bp["dense"], cache["k"][g, 0], cache["v"][g, 0])
            x = block(x, bp["moe"], cache["k"][g, 1], cache["v"][g, 1])
    else:
        for i, bp in enumerate(_unstack(params["blocks"], cfg.n_layers)):
            x = block(x, bp, cache["k"][i], cache["v"][i])
    return lm_logits(x, params["embed"], cfg), cache
