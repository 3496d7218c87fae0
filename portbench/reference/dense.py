"""A dense decoder layer (Phi-3, Llama style), plain: pre-norm GQA
attention with half-split RoPE, then a pre-norm SwiGLU MLP. x [b, s, e]
in float32; ``p`` one layer's leaves by the layout's names less
``blocks.``; ``c`` the configuration's sizes. Attention is causal,
softmax in float32, taken in blocks of query rows to bound its memory."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..weights import Leaf
from .common import mm, rmsnorm

Q_BLOCK = 1024
# the sizes at which the CPU tests run the family
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256)


def _head_dim(c: dict) -> int:
    return c.get("head_dim") or c["d_model"] // c["n_heads"]


def leaves(c: dict, std: float, res_std: float) -> Dict[str, Leaf]:
    e, L, h, kvh, f = c["d_model"], c["n_layers"], c["n_heads"], c["n_kv_heads"], c["d_ff"]
    d = _head_dim(c)
    return {
        "blocks.attn.wq": Leaf((L, e, h * d), "normal", std),
        "blocks.attn.wk": Leaf((L, e, kvh * d), "normal", std),
        "blocks.attn.wv": Leaf((L, e, kvh * d), "normal", std),
        "blocks.attn.wo": Leaf((L, h * d, e), "normal", res_std),
        "blocks.attn.norm": Leaf((L, e), "zeros"),
        "blocks.mlp.w_up": Leaf((L, e, f), "normal", std),
        "blocks.mlp.w_gate": Leaf((L, e, f), "normal", std),
        "blocks.mlp.w_down": Leaf((L, f, e), "normal", res_std),
        "blocks.mlp.norm": Leaf((L, e), "zeros"),
    }


def matrix_params(c: dict) -> int:
    """Q, K, V, O and SwiGLU's three matrices."""
    e, h, kvh, d = c["d_model"], c["n_heads"], c["n_kv_heads"], _head_dim(c)
    return 2 * e * h * d + 2 * e * kvh * d + 3 * e * c["d_ff"]


def mixer_flops(c: dict, b: int, s: int) -> float:
    """Causal attention's two products, Q K^T and P V, over the s (s + 1) / 2 pairs."""
    return 4.0 * _head_dim(c) * b * c["n_heads"] * s * (s + 1) / 2


def program_cache(cache: Dict[str, torch.Tensor], s: int) -> Dict[str, torch.Tensor]:
    """K and V [L, b, S, kvh, d]: the first ``s`` slots hold the prompt."""
    return {k: cache[k][:, :, :s] for k in ("k", "v")}


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [b, s, h, d] rotated at positions 0..s-1: the first and second
    halves of each head are the pairs (rotate_half)."""
    s, d = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [b, s, h, d], k and v [b, s, kvh, d] -> [b, s, h, d]."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    out = []
    for i0 in range(0, s, Q_BLOCK):
        i1 = min(i0 + Q_BLOCK, s)
        scores = torch.einsum("bqhd,bkhd->bhqk", q[:, i0:i1], k[:, :i1]) / math.sqrt(d)
        keys = torch.arange(i1, device=q.device)
        rows = torch.arange(i0, i1, device=q.device)
        scores = scores.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
        out.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v[:, :i1]))
    return torch.cat(out, dim=1)


def layer(x: torch.Tensor, p: Dict[str, torch.Tensor], c: dict, fp8: bool = False,
          want_cache: bool = False) -> Tuple[torch.Tensor, Optional[dict]]:
    b, s, e = x.shape
    h, kvh = c["n_heads"], c["n_kv_heads"]
    d = _head_dim(c)
    eps = c["norm_eps"]
    xn = rmsnorm(x, p["attn.norm"], eps)
    q = rope(mm(xn, p["attn.wq"], fp8).view(b, s, h, d), c["rope_theta"])
    k = rope(mm(xn, p["attn.wk"], fp8).view(b, s, kvh, d), c["rope_theta"])
    v = mm(xn, p["attn.wv"], fp8).view(b, s, kvh, d)
    o = causal_attention(q, k, v).reshape(b, s, h * d)
    x = x + mm(o, p["attn.wo"], fp8)
    xn = rmsnorm(x, p["mlp.norm"], eps)
    hmid = F.silu(mm(xn, p["mlp.w_gate"], fp8)) * mm(xn, p["mlp.w_up"], fp8)
    x = x + mm(hmid, p["mlp.w_down"], fp8)
    return x, ({"k": k, "v": v} if want_cache else None)
