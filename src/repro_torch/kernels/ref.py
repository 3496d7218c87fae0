"""Plain PyTorch versions of the CUDA kernels.

Deliberately naive (no tiling, no online softmax): the CPU runs these in
place of the CUDA kernels, and ``chip_smoke.py`` holds each kernel
against them on the card. In attention, softmax is in fp32 and masked
scores are -1e30, as in ``repro/kernels/ref.py`` and the Pallas kernels.
``ref_attention_bwd`` is the attention backward by its explicit formulas.
``ref_ssd`` is the definitional SSD recurrence, the oracle of the whole
chunked scan; ``ref_ssd_chunk`` is the ``ssd_chunk`` kernel's contract.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int,
            scale: float) -> torch.Tensor:
    """Scaled fp32 scores [b, kvh, g, sq, skv] with masked entries NEG_INF."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, sq, d).float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        mask = kpos <= qpos
        if window:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None, return_lse: bool = False):
    """q: [b, h, sq, d]; k, v: [b, kvh, skv, d] (GQA: h % kvh == 0).

    Query positions are offset by ``skv - sq``; the window applies only
    together with the causal mask, as in the JAX oracle. With
    ``return_lse`` also each row's logsumexp of the scaled scores, fp32
    [b, h, sq] (what the forward kernel saves for the backward).
    """
    b, h, sq, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = _scores(q, k, causal, window, scale)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    o = o.reshape(b, h, sq, d).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(b, h, sq)
    return o


def ref_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                      lse: torch.Tensor, dO: torch.Tensor, causal: bool = True,
                      window: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``flash_attention_bwd`` contract, by the explicit formulas in
    fp32: P = exp(S - lse) from the forward's logsumexp ``lse`` [b, h, sq],
    D = rowsum(dO o O), dS = P o (dO V^T - D); dV = P^T dO, dK = dS^T Q
    scale and dQ = dS K scale, the query heads of each kv head summed into
    its dK and dV. Masked entries have P = 0. Returns (dq, dk, dv) in the
    dtypes of q, k and v."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    p = torch.exp(_scores(q, k, causal, window, scale)
                  - lse.float().reshape(b, kvh, g, sq, 1))
    dOg = dO.float().reshape(b, kvh, g, sq, d)
    delta = (dOg * o.float().reshape(b, kvh, g, sq, d)).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, dOg)
    ds = p * (torch.einsum("bkgqd,bktd->bkgqt", dOg, v.float()) - delta)
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, k.float()) * scale
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds, q.float().reshape(b, kvh, g, sq, d)) * scale
    return dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ref_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """The ``flash_decode`` contract: q [b, h, 1, d]; k, v [b, kvh, S, d]
    (any strides); lengths int32 [b]. Cache position t of row i is
    attended when ``t < lengths[i]``. Returns [b, h, 1, d] in q's dtype."""
    b, h, _, d = q.shape
    kvh, S = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, 1, d).float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) / math.sqrt(d)
    kpos = torch.arange(S, device=q.device)
    mask = kpos[None, :] < lengths.to(q.device)[:, None]          # [b, S]
    s = torch.where(mask[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    return o.reshape(b, h, 1, d).to(q.dtype)


def ref_feasible(vtype: torch.Tensor, vok: torch.Tensor, vsize: torch.Tensor,
                 vmask: torch.Tensor, agg: torch.Tensor, tid: torch.Tensor,
                 msize: torch.Tensor, rmask: torch.Tensor,
                 need: torch.Tensor) -> torch.Tensor:
    """The ``feasible_mask`` contract (``kernels/feasibility.py``) as the
    broadcast expression of ``_ref_batched_feasible`` in
    ``repro/kernels/feasibility.py``, with the property masks in int64
    rather than split into int31 halves. Vertex columns [V], ``agg``
    [V, T] (any strides), request rows [U], ``need`` [U, T]. Returns
    [U, V] uint8."""
    m = (vtype[None, :] == tid[:, None]) & (vok[None, :] != 0)
    m &= vsize[None, :] >= msize[:, None]
    rm = rmask[:, None]
    m &= (vmask[None, :] & rm) == rm
    m &= (agg[None, :, :] >= need[:, None, :]).all(dim=2)
    return m.to(torch.uint8)


def ref_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, initial_state: Optional[torch.Tensor] = None,
            return_state: bool = False):
    """Naive sequential SSD recurrence (the definitional semantics), a
    Python loop over the sequence.

    x: [b, s, H, P]; dt: [b, s, H]; A: [H] (negative); B, C: [b, s, G, N].
    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t^T, y_t = h_t C_t, with the
    state h [b, H, P, N] in fp32. Returns y in x's dtype (and h_T)."""
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=2).float()            # [b, s, H, N]
    Ch = C.repeat_interleave(rep, dim=2).float()
    xf, dtf, Af = x.float(), dt.float(), A.float()
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t] * Af[None, :])             # [b, H]
        h = h * da[:, :, None, None] + torch.einsum(
            "bhp,bhn,bh->bhpn", xf[:, t], Bh[:, t], dtf[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = torch.stack(ys, dim=1).to(x.dtype)                  # [b, s, H, P]
    return (y, h) if return_state else y


def seg_hi_lo(dA: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``seg = cumsum(dA)`` along ``dim`` as the ``ssd_chunk`` kernel keeps
    it: the fp32 terms summed in fp64 (exactly, unless their magnitudes
    span more than about 20 binades, so the order of the sum does not
    matter), then split into fp32 ``hi``
    (the sum rounded) and ``lo`` (the rounding of the rest). Differences
    of seg are formed as ``(hi_i - hi_j) + (lo_i - lo_j)``: at chunk 256
    seg reaches about -190, where one fp32 ulp is 1.5e-5, and a single
    fp32 seg would put y up to a few times the 1e-4 tolerance from the
    exact function (tests/test_torch_ssd_numerics.py)."""
    seg = torch.cumsum(dA.double(), dim=dim)
    hi = seg.float()
    return hi, (seg - hi.double()).float()


def ref_ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, chunk: int, exact: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``ssd_chunk`` contract (``repro/kernels/ssd_scan.py``'s
    ``ssd_chunk_pallas``), as the broadcast form of the intra-chunk part
    of ``ssd_chunked`` (``repro/models/mamba2.py``). Per (batch, chunk,
    head), with ``seg = cumsum(dt * A)`` within the chunk:

    - y_intra[i] = sum_{j <= i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j
    - states = sum_j exp(total - seg_j) B_j^T (dt_j x_j)     [N, P]
    - decay_log = total = seg[-1]

    x: [b, s, H, P]; dt: [b, s, H]; A: [H]; B, C: [b, s, G, N], head h
    reading group h // (H / G); s % chunk == 0. Returns fp32 (y_intra
    [b, s, H, P], states [b, nc, H, N, P], decay_log [b, nc, H]). In fp32
    dt * A is rounded and seg kept as ``seg_hi_lo`` keeps it, as the
    kernel does. ``exact`` evaluates every step in fp64 and returns fp64:
    the function itself, which the kernel and this version are held to at
    the serving chunk of 256."""
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    nc, rep = s // chunk, H // G
    f = torch.float64 if exact else torch.float32
    xg = x.to(f).reshape(b, nc, chunk, H, P)
    dtg = dt.to(f).reshape(b, nc, chunk, H)
    Bg = B.to(f).reshape(b, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    Cg = C.to(f).reshape(b, nc, chunk, G, N).repeat_interleave(rep, dim=3)

    dA = dtg * A.to(f)[None, None, None, :]                           # [b,nc,q,H]
    if exact:
        hi = torch.cumsum(dA, dim=2)
        lo = torch.zeros_like(hi)
    else:
        hi, lo = seg_hi_lo(dA, dim=2)
    total, total_lo = hi[:, :, -1, :], lo[:, :, -1, :]                # [b,nc,H]
    rel = ((hi[:, :, :, None, :] - hi[:, :, None, :, :])
           + (lo[:, :, :, None, :] - lo[:, :, None, :, :]))           # [b,nc,q,q,H]
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    # exp overflows above the diagonal (rel > 0): where() drops it, as JAX does
    L = torch.where(causal[None, None, :, :, None], torch.exp(rel), 0.0)
    scores = torch.einsum("bcqhn,bckhn->bcqkh", Cg, Bg)
    ydt = xg * dtg[..., None]
    y = torch.einsum("bcqkh,bckhp->bcqhp", scores * L, ydt)
    decay_to_end = torch.exp((total[:, :, None, :] - hi) + (total_lo[:, :, None, :] - lo))
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchnp", Bg, decay_to_end, ydt)
    return y.reshape(b, s, H, P), states, total
