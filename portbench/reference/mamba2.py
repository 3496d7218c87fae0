"""A Mamba-2 block (arXiv:2405.21060), plain: pre-norm, in_proj to [z, x,
B, C, dt], a depthwise causal conv with SiLU over [x, B, C], the SSD over
heads of P channels with a state of N, the D skip, the gated RMSNorm
norm(y * silu(z)) and out_proj. Per head the SSD is the recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,    y_t = h_t C_t,

taken here in its chunked form (the quadratic form inside each chunk of
Q positions, the states carried between chunks), as the paper's minimal
SSD listing computes it; every exponent is a difference of cumulative
sums over at most one chunk, or a sum over whole chunks, and is <= 0."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import roofline
from ..weights import Leaf
from .common import mm, rmsnorm

CONV_K = 4
# the sizes at which the CPU tests run the family
TINY = dict(n_layers=2, d_model=64, vocab=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=8)


def _dims(c: dict):
    """(d_inner, heads, head dim, state, groups)."""
    di = c["ssm_expand"] * c["d_model"]
    return di, di // c["ssm_head_dim"], c["ssm_head_dim"], c["ssm_state"], c["ssm_groups"]


def leaves(c: dict, std: float, res_std: float) -> Dict[str, Leaf]:
    e, L = c["d_model"], c["n_layers"]
    di, H, _, N, G = _dims(c)
    conv = di + 2 * G * N
    return {
        "blocks.in_proj": Leaf((L, e, 2 * di + 2 * G * N + H), "normal", std),
        "blocks.conv_w": Leaf((L, CONV_K, conv), "uniform", 1 / math.sqrt(CONV_K)),
        "blocks.conv_b": Leaf((L, conv), "uniform", 1 / math.sqrt(CONV_K)),
        "blocks.A_log": Leaf((L, H), "a_log"),
        "blocks.D": Leaf((L, H), "ones"),
        "blocks.dt_bias": Leaf((L, H), "dt_bias"),
        "blocks.out_norm": Leaf((L, di), "zeros"),
        "blocks.out_proj": Leaf((L, di, e), "normal", res_std),
        "blocks.norm": Leaf((L, e), "zeros"),
    }


def matrix_params(c: dict) -> int:
    """in_proj, out_proj and the depthwise conv; the per-head scalars and
    the norms are left out."""
    e = c["d_model"]
    di, H, _, N, G = _dims(c)
    return e * (2 * di + 2 * G * N + H) + di * e + CONV_K * (di + 2 * G * N)


def mixer_flops(c: dict, b: int, s: int) -> float:
    """The SSD's chunked products: intra-chunk as ``roofline.ssd_fwd``,
    plus the states read back, C S_prev, 2 Q N P a head and chunk."""
    _, H, P, N, G = _dims(c)
    Q = c["ssm_chunk"]
    _, intra, _ = roofline.ssd_fwd(b, s, H, P, G, N, Q)
    return intra + b * (s // Q) * H * 2.0 * Q * N * P


def program_cache(cache: Dict[str, torch.Tensor], s: int) -> Dict[str, torch.Tensor]:
    """The conv window and the SSM state [L, b, ...]: a prompt fills them whole."""
    return {"conv": cache["conv"], "ssm": cache["ssm"]}


def segsum(a: torch.Tensor) -> torch.Tensor:
    """[..., T] -> [..., T, T]: out[i, j] = sum_{j < t <= i} a[t] for
    j <= i, -inf above the diagonal."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)
    below = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device), -1)
    x = x.masked_fill(~below, 0.0)
    out = torch.cumsum(x, dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device), 0)
    return out.masked_fill(~keep, float("-inf"))


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
        chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b, s, H, P], dt [b, s, H], A [H], B and C [b, s, G, N] (head h
    reads group h // (H / G)); s a multiple of ``chunk``. Returns y [b, s,
    H, P] and the final state [b, H, P, N], from a zero state."""
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc, Q = s // chunk, chunk
    Bh = B.repeat_interleave(H // G, dim=2).view(b, nc, Q, H, N)
    Ch = C.repeat_interleave(H // G, dim=2).view(b, nc, Q, H, N)
    X = (x * dt[..., None]).view(b, nc, Q, H, P)
    a = (dt * A).view(b, nc, Q, H).permute(0, 3, 1, 2)             # [b, H, nc, Q]
    a_cum = torch.cumsum(a, dim=-1)
    L = torch.exp(segsum(a))                                        # [b, H, nc, Q, Q]
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Ch, Bh, L, X)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)               # [b, H, nc, Q]
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay_states, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))  # [b, H, nc+1, nc+1]
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    prev, final = states[:, :-1], states[:, -1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, prev, torch.exp(a_cum))
    return (y_diag + y_off).reshape(b, s, H, P), final


def layer(x: torch.Tensor, p: Dict[str, torch.Tensor], c: dict, fp8: bool = False,
          want_cache: bool = False) -> Tuple[torch.Tensor, Optional[dict]]:
    b, s, e = x.shape
    di, H, P, N, G = _dims(c)
    eps = c["norm_eps"]
    xn = rmsnorm(x, p["norm"], eps)
    z, xbc, dt = mm(xn, p["in_proj"], fp8).split([di, di + 2 * G * N, H], dim=-1)
    pad = F.pad(xbc, (0, 0, CONV_K - 1, 0))
    conv = sum(pad[:, i:i + s] * p["conv_w"][i] for i in range(CONV_K)) + p["conv_b"]
    xs, Bm, Cm = F.silu(conv).split([di, G * N, G * N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(b, s, H, P)
    y, final = ssd(xh, dt, A, Bm.reshape(b, s, G, N), Cm.reshape(b, s, G, N), c["ssm_chunk"])
    y = (y + xh * p["D"][:, None]).reshape(b, s, di)
    y = rmsnorm(y * F.silu(z), p["out_norm"], eps)
    out = x + mm(y, p["out_proj"], fp8)
    cache = {"conv": xbc[:, -(CONV_K - 1):], "ssm": final} if want_cache else None
    return out, cache
