"""Model building blocks: norms, RoPE, GQA attention, MLP, embedding and
LM head. Plain functions on tensors.

The port of ``repro/models/layers.py``. The JAX layers take a
``ShardingCtx`` for their activation constraints, hints to GSPMD that
change no value; the port has no GSPMD and drops them. The parameters'
specs keep JAX's logical axes, from which the model lays them out over a
mesh (``models/model.py``). Where the sequence is split over "model"
(``sp``), attention is the one layer that needs other ranks' positions:
it gathers K and V (``gather_seq``). Attention goes through the port's kernels
(``kernels/ops.py``): prefill through ``flash_attention``, cached decode
through ``flash_decode``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ops import attention_op, decode_attention_op
from ..parallel.sharding import (SeqShards, Sharded, ShardingCtx, all_reduce, gather_seq, gathered,
                                 gathered_but_model, sharded_take)
from ..tally_hooks import span
from .config import ArchConfig


# ---------------------------------------------------------------------- #
# param specs
# ---------------------------------------------------------------------- #
@dataclass(frozen=True)
class ParamSpec:
    """Shape, logical axes (one a dimension: the names the sharding rules
    map onto a mesh), init rule and dtype of one parameter."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"                 # normal | zeros | ones | small
    dtype: str = "float32"

    def std(self) -> float:
        """The JAX init rule: N(0, 1/fan_in), fan_in = shape[-2] for
        ndim >= 2 (so V for the [V, e] embedding); "small" is x0.1."""
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
        return scale * 0.1 if self.init == "small" else scale

    def materialize_(self, out: torch.Tensor, generator: torch.Generator) -> None:
        """Fill ``out`` (of this spec's shape) in place. The distribution is
        JAX's; the values cannot be, since the generators differ."""
        if self.init == "zeros":
            out.zero_()
        elif self.init == "ones":
            out.fill_(1.0)
        else:
            out.normal_(0.0, self.std(), generator=generator)


def stack_specs(specs: Dict, n: int) -> Dict:
    """Prepend a stacked-layer axis ("layers") to every ParamSpec in a tree."""
    return {k: stack_specs(v, n) if isinstance(v, dict)
            else ParamSpec((n,) + v.shape, ("layers",) + v.axes, v.init, v.dtype)
            for k, v in specs.items()}


# ---------------------------------------------------------------------- #
# norms
# ---------------------------------------------------------------------- #
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
            mean_sq: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """x's last dimension over its root mean square, times (1 + w), in fp32.
    ``mean_sq`` maps the squares [..., c] to their mean [..., 1] where x is
    a block of a wider dimension (the mean over every rank's block)."""
    x32 = x.float()
    sq = x32 * x32
    var = torch.mean(sq, dim=-1, keepdim=True) if mean_sq is None else mean_sq(sq)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


# ---------------------------------------------------------------------- #
# rotary embeddings (RoPE and M-RoPE)
# ---------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """x: [b, s, h, d]; positions: [b, s] (RoPE) or [3, b, s] (M-RoPE).
    Half-split rotation.

    M-RoPE (Qwen2-VL): the d/2 frequency slots are split into (temporal,
    height, width) sections, each rotated by its own position stream. With
    text positions (all three equal) it is plain RoPE."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # [d/2]
    if mrope_sections is not None:
        pos3 = positions.float()                             # [3, b, s]
        secs, off = [], 0
        for i, n in enumerate(mrope_sections):
            secs.append(pos3[i][..., None] * freqs[off:off + n])
            off += n
        angles = torch.cat(secs, dim=-1)                     # [b, s, d/2]
    else:
        angles = positions.float()[..., None] * freqs        # [b, s, d/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def mrope_sections_for(head_dim: int) -> Tuple[int, int, int]:
    """Qwen2-VL style (t, h, w) split of the d/2 frequency slots."""
    half = head_dim // 2
    t = half // 2
    h = (half - t) // 2
    return (t, h, half - t - h)


# ---------------------------------------------------------------------- #
# attention (GQA, causal, optional sliding window)
# ---------------------------------------------------------------------- #
def attn_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    e, h, kvh, d = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": ParamSpec((e, h * d), ("fsdp2d", None)),
        "wk": ParamSpec((e, kvh * d), ("fsdp2d", None)),
        "wv": ParamSpec((e, kvh * d), ("fsdp2d", None)),
        "wo": ParamSpec((h * d, e), ("fsdp2d", None)),
        "norm": ParamSpec((e,), (None,), init="zeros"),
    }


def attention(x: torch.Tensor, p: Dict, cfg: ArchConfig,
              positions: torch.Tensor,
              cache: Optional[Dict] = None,
              cache_index: Optional[int] = None,
              window: int = 0,
              want_cache: bool = False,
              sp: Optional[SeqShards] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """GQA attention.

    Prefill: ``x`` is [b, s, e], cache is None; with ``want_cache`` the
    fresh k/v [b, s, kvh, d] come back as the cache. Under a sequence
    split ``sp`` x is model rank r's block of s positions (r s onward):
    K and V are gathered over "model" (the backward reduce-scatters their
    gradients) and the rank attends the prefix [0, (r+1) s), whose last s
    keys are its own, so the kernel's causal mask, aligned to the end of
    the keys, is the mask at positions r s + i.
    Decode: ``x`` is [b, 1, e]; ``cache`` holds this layer's k/v
    [b, S, kvh, d] (bf16), which the new k/v are written into IN PLACE
    at ``cache_index``. Row i attends cache positions <= positions[i, 0]
    (under M-RoPE, the temporal stream's: positions[0, i, 0]), within the
    window if there is one. Under ``sp`` x is whole on every model rank
    and the cache is the rank's block of the sequence (``_decode``).
    """
    b, s, e = x.shape
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    window = window or cfg.sliding_window
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    cdt = xn.dtype

    q = (xn @ p["wq"].to(cdt)).view(b, s, h, d)
    k = (xn @ p["wk"].to(cdt)).view(b, s, kvh, d)
    v = (xn @ p["wv"].to(cdt)).view(b, s, kvh, d)
    # as in JAX, every rope but "none" rotates: abs_sin (musicgen) takes
    # RoPE on top of its sinusoid
    msecs = mrope_sections_for(d) if cfg.rope == "mrope" else None
    if cfg.rope != "none":
        q = apply_rope(q, positions, cfg.rope_theta, msecs)
        k = apply_rope(k, positions, cfg.rope_theta, msecs)

    new_cache = None
    if cache is not None:
        if s != 1:
            raise ValueError(f"decode takes one token per row, got {s}")
        ck, cv = cache["k"], cache["v"]
        new_cache = {"k": ck, "v": cv}
        ppos = positions if positions.dim() == 2 else positions[0]    # mrope: t
        o = _decode(q, k, v, ck, cv, ppos[:, 0], cache_index, window, sp)
    else:
        if want_cache:
            new_cache = {"k": k, "v": v}
        if sp is not None:
            kv = gather_seq(torch.stack([k, v]), 2, sp)[:, :, :(sp.rank + 1) * s]
            k, v = kv[0], kv[1]
        o = attention_op(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                         v.permute(0, 2, 1, 3), causal=True, window=window)
    o = o.permute(0, 2, 1, 3).reshape(b, s, h * d)
    return o @ p["wo"].to(cdt), new_cache


def _decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ck: torch.Tensor,
            cv: torch.Tensor, pos: torch.Tensor, cache_index: int, window: int,
            sp: Optional[SeqShards]) -> torch.Tensor:
    """One query row a head (q [b, 1, h, d]) against the cache [b, S, kvh,
    d], after writing the new k/v [b, 1, kvh, d] into it at
    ``cache_index``; row i attends positions t <= pos[i] (with a window,
    t > pos[i] - window, as JAX's mask). Under a sequence split ``sp`` the
    cache is model rank r's block of S positions [r S, (r+1) S): only the
    block that holds ``cache_index`` writes, the rank attends its own
    positions of that range (lengths = clamp(pos + 1 - r S, 0, S), starts =
    clamp(pos + 1 - window - r S, 0, S): a rank may attend none), and the
    ranks' (output, logsumexp) pairs, gathered over "model", combine into
    the softmax over every position. Returns [b, h, 1, d]."""
    S = ck.shape[1]
    first = 0 if sp is None else sp.rank * S
    if first <= cache_index < first + S:
        # the cache keeps its dtype (bf16): new k/v are rounded to it
        ck[:, cache_index - first:cache_index - first + 1] = k.to(ck.dtype)
        cv[:, cache_index - first:cache_index - first + 1] = v.to(cv.dtype)
    lengths = (pos + 1 - first).clamp(0, S).to(torch.int32)
    starts = (pos + 1 - window - first).clamp(0, S).to(torch.int32) if window else None
    # the kernel reads the [b, S, kvh, d] cache in place through a [b, kvh,
    # S, d] view, and attends it in fp32
    qh, kh, vh = q.permute(0, 2, 1, 3), ck.permute(0, 2, 1, 3), cv.permute(0, 2, 1, 3)
    if sp is None:
        return decode_attention_op(qh, kh, vh, lengths, starts)
    # each rank's partial softmax in fp32 (an fp32 q over the bf16 cache),
    # then o = sum_r exp(lse_r - lse) o_r with lse = logsumexp_r lse_r
    o, lse = decode_attention_op(qh.float(), kh, vh, lengths, starts, lse=True)
    parts = gather_seq(torch.cat([o[:, :, 0], lse], dim=-1)[None], 0, sp)   # [m, b, h, d+1]
    o_r, lse_r = parts[..., :-1], parts[..., -1:]
    top = lse_r.amax(0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(lse_r - top)                               # 0 where a rank attended nothing
    o = (w * o_r).sum(0) / w.sum(0).clamp_min(torch.finfo(torch.float32).tiny)
    return o[:, :, None].to(q.dtype)


# ---------------------------------------------------------------------- #
# MLPs
# ---------------------------------------------------------------------- #
def mlp_specs(cfg: ArchConfig, d_ff: Optional[int] = None) -> Dict[str, ParamSpec]:
    e, f = cfg.d_model, (d_ff or cfg.d_ff)
    specs = {
        "w_up": ParamSpec((e, f), ("fsdp", "tp")),
        "w_down": ParamSpec((f, e), ("tp", "fsdp")),
        "norm": ParamSpec((e,), (None,), init="zeros"),
    }
    if cfg.mlp_act == "swiglu":
        specs["w_gate"] = ParamSpec((e, f), ("fsdp", "tp"))
    return specs


def mlp(x: torch.Tensor, p: Dict, cfg: ArchConfig, normed: bool = False,
        sp: Optional[SeqShards] = None) -> torch.Tensor:
    """The MLP of x [b, s, e]. With ``sp`` (decode on a mesh, x whole on
    every model rank) it is tensor-parallel over the "model" ranks, as
    GSPMD partitions JAX's decode: p's weights may be ``Sharded`` leaves,
    gathered over every axis but "model" (``gathered_but_model``), so that
    the rank holds its block of f (columns of w_up and w_gate, rows of
    w_down), and the partial outputs are summed over the model group."""
    if sp is not None:
        p = {k: gathered_but_model(v) for k, v in p.items()}
        y = mlp(x, p, cfg, normed)
        all_reduce(y, sp.group)
        return y
    cdt = x.dtype
    xn = x if normed else rmsnorm(x, p["norm"], cfg.norm_eps)
    up = xn @ p["w_up"].to(cdt)
    if cfg.mlp_act == "swiglu":
        hmid = F.silu(xn @ p["w_gate"].to(cdt)) * up
    elif cfg.mlp_act == "relu2":
        r = F.relu(up)
        hmid = r * r
    else:
        # jax.nn.gelu is the tanh form (torch's default is erf)
        hmid = F.gelu(up, approximate="tanh")
    return hmid @ p["w_down"].to(cdt)


# ---------------------------------------------------------------------- #
# embeddings / head
# ---------------------------------------------------------------------- #
def embed_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    v, e = cfg.vocab, cfg.d_model
    vocab_ax = "vocab" if v % 256 == 0 else None   # mamba2's 50280 is odd
    emb_e_ax = "fsdp" if vocab_ax else "fsdp2d"
    specs = {
        "embedding": ParamSpec((v, e), (vocab_ax, emb_e_ax), init="small"),
        "final_norm": ParamSpec((e,), (None,), init="zeros"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((e, v), (emb_e_ax, vocab_ax), init="small")
    return specs


def embed_tokens(tokens: torch.Tensor, p: Dict, cfg: ArchConfig,
                 ctx: Optional[ShardingCtx] = None, seq_split: bool = True) -> torch.Tensor:
    """The rows of the fp32 table, cast to the compute dtype. A table held
    as shards (a ``Sharded`` under ``ctx``'s mesh) is never gathered: each
    rank looks its tokens (its block of the batch, with ``seq_split`` its
    positions over "model" too) up in its own shard, as GSPMD partitions
    JAX's ``jnp.take`` (``sharded_take``). Either way a token's repeated
    rows sum their gradients in fp32."""
    cdt = getattr(torch, cfg.dtype)
    table = p["embedding"]
    if isinstance(table, Sharded):
        return sharded_take(table, tokens, ctx, seq_split, cdt)
    return table[tokens].to(cdt)


def lm_logits(x: torch.Tensor, p: Dict, cfg: ArchConfig) -> torch.Tensor:
    """fp32 logits. The LM head runs in fp32 (as JAX does by default); with
    ``cast_params_once`` or ``seq_sharded_loss`` its inputs are rounded to
    the compute dtype first and multiplied with an fp32 result, as JAX's
    ``dot_general(..., preferred_element_type=float32)`` does: a product of
    two bf16 values is exact in fp32, so rounding the inputs and then
    multiplying in fp32 is that product (``torch.matmul`` of two bf16
    tensors would round its output to bf16). Without a mesh the two
    variants are the same arithmetic. On a card this needs
    ``torch.backends.cuda.matmul.allow_tf32 = False``, which the entry
    points set. A sharded head is gathered in the dtype it is used in.
    The span ``model.head``."""
    with span("model.head"):
        xn = rmsnorm(x, p["final_norm"], cfg.norm_eps)
        head = p["embedding"] if cfg.tie_embeddings else p["lm_head"]
        if cfg.cast_params_once or cfg.seq_sharded_loss:
            cdt = getattr(torch, cfg.dtype)
            xn, head = xn.to(cdt), head.to(cdt)
        head = gathered(head).float()
        return xn.float() @ (head.T if cfg.tie_embeddings else head)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  onehot: bool = False) -> torch.Tensor:
    """Mean token cross-entropy; logits [b, s, v] fp32, labels [b, s].
    ``onehot`` takes the gold logit through an iota == label select, as
    JAX's §Perf variant does, instead of a gather: the same value."""
    logz = torch.logsumexp(logits, dim=-1)
    if onehot:
        iota = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(iota == labels[..., None], logits, 0.0).sum(dim=-1)
    else:
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()
