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

Where the sequence is split over "model" (``sp``: m ranks, each a block of
s/m positions) the block does explicitly what JAX's constraints make
GSPMD do (``repro/models/mamba2.py:167-202``): the conv takes the K - 1
positions before the block from the previous rank (``halo_prev``); x and
dt go by all-to-all to every position of the rank's H/m heads (its slice
of ``A_log``, ``D``), B and C (JAX's compact G-form) are gathered whole,
and the scan runs there. How the block leaves the scan follows
``cfg.ssm_seq_sharded``, as JAX's HLO does:

* on (§Perf): y comes back to the rank's positions by the inverse
  all-to-all, and the gate, ``out_norm`` and ``out_proj`` act there on the
  whole d_inner;
* off (the baseline): y stays on the rank's heads over every position; z
  goes to them by all-to-all, ``out_norm``'s mean square is summed over
  "model", and ``out_proj``'s rows of the rank's heads give its part of
  the output, reduce-scattered over "model" to the rank's positions
  (``sum_over_model``). Its backward takes y's gradient on the rank's
  heads alone; GSPMD's partition of JAX's baseline takes it over the whole
  d_inner and keeps the rank's heads, products the port does not make.

Decode (x whole on every model rank, the SSM state the rank's heads') takes
the baseline's exit whatever the flag, as JAX's decode does.

Layout: x [b, s, H, P] (heads H = d_inner / headdim, P = headdim),
B/C [b, s, G, N] (G groups, N = ssm_state), dt/A per head.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.causal_conv import CausalConv
from ..kernels.ops import ssd_scan_op
from ..parallel.sharding import (SeqShards, gather_seq, halo_prev, heads_to_seq, seq_to_heads,
                                 sum_over_model)
from ..tally_hooks import span
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
    """z, xBC (x, B and C side by side: the conv's input) and dt, views of
    the input projection's columns."""
    di, GN = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    return zxbcdt.split([di, di + 2 * GN, cfg.ssm_heads], dim=-1)


def _conv1d(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
            halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over seq and its SiLU: u [b, s, c] (a strided
    view), w [K, c]; ``halo`` [b, K-1, c], the positions before u's first
    (zeros where None). The ``causal_conv`` kernels on the card, their
    plain pair on the CPU (``kernels/causal_conv.py``)."""
    return CausalConv.apply(u, w, bias, halo)


def _dt_a_d(dt: torch.Tensor, p: Dict) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scan's step sizes softplus(dt + dt_bias), its decay A = -exp(A_log)
    and the skip D, in fp32."""
    return (F.softplus(dt.float() + p["dt_bias"].float()), -torch.exp(p["A_log"].float()),
            p["D"].float())


def _conv_step(window: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The decode conv: one position from the window [b, K, c], summed in
    one einsum as JAX's decode does (its prefill, ``_conv1d``, adds the K
    taps one at a time: in bf16 the two round differently)."""
    return F.silu(torch.einsum("bkc,kc->bc", window, w) + bias)


def _split_conv(conv: torch.Tensor, cfg: ArchConfig):
    di, GN = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    return conv[..., :di], conv[..., di:di + GN], conv[..., di + GN:]


def _head_groups(H: int, G: int, sp: SeqShards) -> slice:
    """The groups of B and C that model rank r's heads [r H/m, (r+1) H/m)
    read (head h reads group h // (H / G))."""
    Hl, rep = H // sp.n, H // G
    if Hl % rep and rep % Hl:
        raise ValueError(f"{H} heads over {sp.n} model ranks split groups of {rep} heads")
    first = sp.rank * Hl // rep
    return slice(first, first + max(Hl // rep, 1))


def _rank_heads(H: int, sp: SeqShards) -> slice:
    """Model rank r's heads [r H/m, (r+1) H/m) ("ssm_heads" over "model")."""
    return slice(sp.rank * H // sp.n, (sp.rank + 1) * H // sp.n)


def _scan_heads(xh: torch.Tensor, dtp: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                BC: torch.Tensor, cfg: ArchConfig, sp: SeqShards, want_state: bool = False,
                back: bool = True):
    """The SSD scan and the D residual of the rank's positions xh [b, s/m,
    H, P], dtp [b, s/m, H] and BC [b, s/m, 2 G N] (B, then C), run on the
    rank's heads over the whole sequence; y fp32, with ``back`` [b, s/m, H,
    P] (the rank's positions), else [b, s, H/m, P] (the rank's heads) (and,
    with ``want_state``, the rank's heads' final state [b, H/m, P, N])."""
    b, sl = xh.shape[:2]
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    heads = _rank_heads(H, sp)
    groups = _head_groups(H, G, sp)
    xs, dts = seq_to_heads(xh, sp), seq_to_heads(dtp, sp)       # [b, s, H/m, ...]
    BCs = gather_seq(BC, 1, sp).view(b, sl * sp.n, 2, G, N)[:, :, :, groups]
    out = ssd_scan_op(xs, dts, A[heads], BCs[:, :, 0], BCs[:, :, 1], cfg.ssm_chunk,
                      return_state=want_state)
    y, final = out if want_state else (out, None)
    y = y + xs * D[heads][None, None, :, None]
    if back:
        y = heads_to_seq(y, sp)
    return (y, final) if want_state else y


def _rank_cols(cfg: ArchConfig, sp: SeqShards) -> slice:
    """The d_inner channels of model rank r's heads."""
    di = cfg.d_inner
    return slice(sp.rank * di // sp.n, (sp.rank + 1) * di // sp.n)


def _heads_out(y: torch.Tensor, z: torch.Tensor, p: Dict, cfg: ArchConfig,
               sp: SeqShards, dim: Optional[int]) -> torch.Tensor:
    """The block's output from y [..., di/m] on the rank's heads, gated by
    z (their channels): ``out_norm`` with the mean square summed over the
    model ranks, the rank's rows of ``out_proj``, and the parts summed over
    "model" (with ``dim``, the rank's positions of that dimension kept)."""
    cols = _rank_cols(cfg, sp)
    y = rmsnorm(y * F.silu(z), p["out_norm"][cols], cfg.norm_eps,
                mean_sq=lambda sq: sum_over_model(sq.sum(-1, keepdim=True), sp) / cfg.d_inner)
    return sum_over_model(y @ p["out_proj"].to(y.dtype)[cols], sp, dim)


def mamba_layer(x: torch.Tensor, p: Dict, cfg: ArchConfig,
                state: Optional[Dict] = None,
                want_state: bool = False,
                sp: Optional[SeqShards] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One Mamba2 block. Prefill when ``state is None`` (``want_state``
    returns the final recurrent state); otherwise a single-token recurrent
    decode step (x: [b, 1, e]) from ``state`` {"conv" [b, K-1, conv_dim],
    "ssm" [b, H, P, N]}, returning the new state in the dtypes of the old
    (fp32 in the model's cache). ``sp``: the mesh's "model" axis. In
    prefill x is this rank's block of positions and the state it returns
    the conv's last K - 1 positions (whole) and its heads' SSM state; in
    decode x is whole on every model rank and ``state["ssm"]`` holds the
    rank's H/m heads, which it steps, their parts of the output summed over
    "model". The spans ``mamba2.in_proj``, ``mamba2.conv``, ``mamba2.scan``
    (dt, the scan and the D residual) and ``mamba2.out`` (gate, norm and
    ``out_proj``)."""
    b, s, _ = x.shape
    cdt = x.dtype
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    with span("mamba2.in_proj"):
        xn = rmsnorm(x, p["norm"], cfg.norm_eps)
        zxbcdt = xn @ p["in_proj"].to(cdt)
        z, xBC, dt = _split_proj(zxbcdt, cfg)

    new_state = None
    if state is None and sp is not None:
        with span("mamba2.conv"):
            conv = _conv1d(xBC, p["conv_w"].to(cdt), p["conv_b"].to(cdt),
                           halo_prev(xBC, CONV_K - 1, sp))
        back = cfg.ssm_seq_sharded
        with span("mamba2.scan"):
            dtp, A, D = _dt_a_d(dt, p)
            xh = conv[..., :cfg.d_inner].reshape(b, s, H, P).float()
            y = _scan_heads(xh, dtp, A, D, conv[..., cfg.d_inner:].float(), cfg, sp,
                            want_state, back)
            if want_state:
                # the conv state is the sequence's last K - 1 positions (the last
                # rank's), whole on every rank; the SSM state the rank's heads'
                y, final = y
                tail = gather_seq(xBC[:, -(CONV_K - 1):], 1, sp)[:, -(CONV_K - 1):]
                new_state = {"conv": tail.float(), "ssm": final.float()}
            if back:
                y = y.reshape(b, s, cfg.d_inner).to(cdt)
        if not back:
            with span("mamba2.out"):
                zh = seq_to_heads(z.reshape(b, s, H, P), sp)
                y = y.reshape(zh.shape[:2] + (-1,)).to(cdt)
                return _heads_out(y, zh.reshape(y.shape), p, cfg, sp, 1), new_state
    elif state is None:
        with span("mamba2.conv"):
            conv = _conv1d(xBC, p["conv_w"].to(cdt), p["conv_b"].to(cdt))
        with span("mamba2.scan"):
            dtp, A, D = _dt_a_d(dt, p)
            xc, Bc, Cc = _split_conv(conv, cfg)
            xh = xc.reshape(b, s, H, P).float()
            out = ssd_scan_op(xh, dtp, A, Bc.reshape(b, s, G, N).float(),
                              Cc.reshape(b, s, G, N).float(), cfg.ssm_chunk,
                              return_state=want_state)
            if want_state:
                y, final = out
                new_state = {"conv": xBC[:, -(CONV_K - 1):, :].float(),
                             "ssm": final.float()}
            else:
                y = out
            y = y + xh * D[None, None, :, None]
            y = y.reshape(b, s, cfg.d_inner).to(cdt)
    else:
        # recurrent decode: roll the conv window (in the compute dtype), one SSM step
        with span("mamba2.conv"):
            window = torch.cat([state["conv"].to(cdt), xBC], dim=1)        # [b, K, conv_dim]
            conv = _conv_step(window, p["conv_w"].to(cdt), p["conv_b"].to(cdt))[:, None, :]
        with span("mamba2.scan"):
            dtp, A, D = _dt_a_d(dt, p)
            xc, Bc, Cc = _split_conv(conv, cfg)
            dtp = dtp[:, 0]                                                # [b, H]
            h = state["ssm"].float()                                       # [b, H, P, N]
            xh = xc.reshape(b, H, P).float()
            Bh = Bc.reshape(b, G, N).repeat_interleave(H // G, dim=1).float()
            Ch = Cc.reshape(b, G, N).repeat_interleave(H // G, dim=1).float()
            if sp is not None:
                # the state holds the rank's heads: step them
                heads = _rank_heads(H, sp)
                xh, Bh, Ch, dtp, A, D = xh[:, heads], Bh[:, heads], Ch[:, heads], \
                    dtp[:, heads], A[heads], D[heads]
            da = torch.exp(dtp * A[None, :])                               # [b, H]
            h = h * da[:, :, None, None] + torch.einsum("bhp,bhn,bh->bhpn", xh, Bh, dtp)
            y = torch.einsum("bhpn,bhn->bhp", h, Ch)
            y = y + xh * D[None, :, None]
            new_state = {"conv": window[:, 1:].to(state["conv"].dtype),
                         "ssm": h.to(state["ssm"].dtype)}
        if sp is not None:
            # the heads' output parts, summed over "model"
            with span("mamba2.out"):
                y = y.reshape(b, 1, -1).to(cdt)
                return _heads_out(y, z[..., _rank_cols(cfg, sp)], p, cfg, sp, None), new_state
        y = y.reshape(b, 1, cfg.d_inner).to(cdt)

    with span("mamba2.out"):
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
