"""Mamba2 layer: SSD (state-space duality) chunked scan and recurrent decode.

The port of ``repro/models/mamba2.py``. Per head,

    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t^T     (state [P, N])
    y_t = h_t C_t

Prefill and training run the chunked scan ``kernels/ops.py::ssd_scan_op``
(the ``ssd_chunk`` CUDA kernel on a card, its plain version on the CPU;
under grad with its backward, ``ssd_chunk_bwd``) where the JAX model
calls its pure-jnp ``ssd_chunked`` and XLA differentiates it; decode is
the O(1) recurrent step. The JAX layer's sharding constraints are no-ops without
a mesh and are dropped.

Layout: x [b, s, H, P] (heads H = d_inner / headdim, P = headdim),
B/C [b, s, G, N] (G groups, N = ssm_state), dt/A per head.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ops import ssd_scan_op
from .config import ArchConfig
from .layers import ParamSpec, rmsnorm

CONV_K = 4  # depthwise causal conv width


def mamba_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    e, di = cfg.d_model, cfg.d_inner
    H, N, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    conv_dim = di + 2 * G * N
    return {
        # in_proj emits [z, x, B, C, dt]
        "in_proj": ParamSpec((e, 2 * di + 2 * G * N + H), ("fsdp2d", None)),
        "conv_w": ParamSpec((CONV_K, conv_dim), (None, None), init="small"),
        "conv_b": ParamSpec((conv_dim,), (None,), init="zeros"),
        "A_log": ParamSpec((H,), (None,), init="zeros"),
        "D": ParamSpec((H,), (None,), init="ones"),
        "dt_bias": ParamSpec((H,), (None,), init="zeros"),
        "out_norm": ParamSpec((di,), (None,), init="zeros"),
        "out_proj": ParamSpec((di, e), (None, "fsdp2d")),
        "norm": ParamSpec((e,), (None,), init="zeros"),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ArchConfig):
    di, G, N = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    return zxbcdt.split([di, di, G * N, G * N, cfg.ssm_heads], dim=-1)


def _conv1d(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq: u [b, s, c], w [K, c]."""
    K, s = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0))
    out = torch.zeros_like(u)
    for i in range(K):
        out = out + pad[:, i:i + s, :] * w[i]
    return F.silu(out + bias)


def _conv_step(window: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The decode conv: one position from the window [b, K, c], summed in
    one einsum as JAX's decode does (its prefill, ``_conv1d``, adds the K
    taps one at a time: in bf16 the two round differently)."""
    return F.silu(torch.einsum("bkc,kc->bc", window, w) + bias)


def _split_conv(conv: torch.Tensor, cfg: ArchConfig):
    di, GN = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    return conv[..., :di], conv[..., di:di + GN], conv[..., di + GN:]


def mamba_layer(x: torch.Tensor, p: Dict, cfg: ArchConfig,
                state: Optional[Dict] = None,
                want_state: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One Mamba2 block. Prefill when ``state is None`` (``want_state``
    returns the final recurrent state); otherwise a single-token recurrent
    decode step (x: [b, 1, e]) from ``state`` {"conv" [b, K-1, conv_dim],
    "ssm" [b, H, P, N]}, returning the new state in the dtypes of the old
    (fp32 in the model's cache)."""
    b, s, _ = x.shape
    cdt = x.dtype
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    zxbcdt = xn @ p["in_proj"].to(cdt)
    z, xin, B, C, dt = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xin, B, C], dim=-1)
    dtp = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    D = p["D"].float()

    new_state = None
    if state is None:
        conv = _conv1d(conv_in, p["conv_w"].to(cdt), p["conv_b"].to(cdt))
        xc, Bc, Cc = _split_conv(conv, cfg)
        xh = xc.reshape(b, s, H, P).float()
        out = ssd_scan_op(xh, dtp, A, Bc.reshape(b, s, G, N).float(),
                          Cc.reshape(b, s, G, N).float(), cfg.ssm_chunk,
                          return_state=want_state)
        if want_state:
            y, final = out
            new_state = {"conv": conv_in[:, -(CONV_K - 1):, :].float(),
                         "ssm": final.float()}
        else:
            y = out
        y = y + xh * D[None, None, :, None]
        y = y.reshape(b, s, cfg.d_inner).to(cdt)
    else:
        # recurrent decode: roll the conv window (in the compute dtype), one SSM step
        window = torch.cat([state["conv"].to(cdt), conv_in], dim=1)    # [b, K, conv_dim]
        conv = _conv_step(window, p["conv_w"].to(cdt), p["conv_b"].to(cdt))[:, None, :]
        xc, Bc, Cc = _split_conv(conv, cfg)
        dtp = dtp[:, 0]                                                # [b, H]
        h = state["ssm"].float()                                       # [b, H, P, N]
        xh = xc.reshape(b, H, P).float()
        Bh = Bc.reshape(b, G, N).repeat_interleave(H // G, dim=1).float()
        Ch = Cc.reshape(b, G, N).repeat_interleave(H // G, dim=1).float()
        da = torch.exp(dtp * A[None, :])                               # [b, H]
        h = h * da[:, :, None, None] + torch.einsum("bhp,bhn,bh->bhpn", xh, Bh, dtp)
        y = torch.einsum("bhpn,bhn->bhp", h, Ch)
        y = y + xh * D[None, :, None]
        y = y.reshape(b, 1, cfg.d_inner).to(cdt)
        new_state = {"conv": window[:, 1:].to(state["conv"].dtype),
                     "ssm": h.to(state["ssm"].dtype)}

    y = y * F.silu(z)
    y = rmsnorm(y, p["out_norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(cdt), new_state


def mamba_state_specs(cfg: ArchConfig, batch: int, dtype=torch.float32
                      ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of one layer's decode state."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "conv": ((batch, CONV_K - 1, conv_dim), dtype),
        "ssm": ((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), dtype),
    }
