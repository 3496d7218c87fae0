"""Plain PyTorch versions of the CUDA kernels.

Deliberately naive (no tiling, no online softmax): the CPU runs these in
place of the CUDA kernels, and ``chip_smoke.py`` holds each kernel
against them on the card. In attention, softmax is in fp32 and masked
scores are -1e30, as in ``repro/kernels/ref.py`` and the Pallas kernels.
``ref_attention_bwd`` is the attention backward by its explicit formulas.
``ref_ssd`` is the definitional SSD recurrence, the oracle of the whole
chunked scan; ``ref_ssd_chunk`` is the ``ssd_chunk`` kernel's contract.
``tile_rel_err`` measures a kernel's output against one of these tile by
tile.
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
               lengths: torch.Tensor, starts: Optional[torch.Tensor] = None,
               lse: bool = False):
    """The ``flash_decode`` contract: q [b, h, 1, d]; k, v [b, kvh, S, d]
    (any strides); lengths and ``starts`` int32 [b]. Cache position t of
    row i is attended when ``starts[i] <= t < lengths[i]`` (``starts``
    defaults to zeros); a row that attends nothing gives 0 and a logsumexp
    of -inf. Returns [b, h, 1, d] in q's dtype (and, with ``lse``, each
    (row, head)'s logsumexp of the scaled scores, fp32 [b, h, 1])."""
    b, h, _, d = q.shape
    kvh, S = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, 1, d).float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) / math.sqrt(d)
    kpos = torch.arange(S, device=q.device)
    mask = kpos[None, :] < lengths.to(q.device)[:, None]          # [b, S]
    if starts is not None:
        mask = mask & (kpos[None, :] >= starts.to(q.device)[:, None])
    mask = mask[:, None, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, -math.inf))
    m = torch.logsumexp(s, dim=-1, keepdim=True)                  # -inf: an empty row
    p = torch.where(mask, torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)), 0.0)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    o = o.reshape(b, h, 1, d).to(q.dtype)
    return (o, m.reshape(b, h, 1)) if lse else o


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


def _ssd_seg(dA: torch.Tensor, exact: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """seg = cumsum(dA) over the chunk (dim 2) as a pair hi + lo: in fp64
    with lo = 0 when ``exact``, else as ``seg_hi_lo`` keeps it."""
    if exact:
        hi = torch.cumsum(dA, dim=2)
        return hi, torch.zeros_like(hi)
    return seg_hi_lo(dA, dim=2)


def _decay_matrix(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """L[i, j] = exp(seg_i - seg_j) for j <= i, else 0: [b, nc, q, q, H]
    from the pair [b, nc, q, H]. Masked before exp: above the diagonal
    seg_i - seg_j > 0 and exp overflows past 88, where a mask after exp
    would leave the forward finite and its gradient 0 * inf = NaN."""
    q = hi.shape[2]
    rel = ((hi[:, :, :, None, :] - hi[:, :, None, :, :])
           + (lo[:, :, :, None, :] - lo[:, :, None, :, :]))
    causal = torch.ones((q, q), dtype=torch.bool, device=hi.device).tril()
    return torch.exp(rel.masked_fill(~causal[None, None, :, :, None], -math.inf))


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
    the serving chunk of 256. Autograd of either is finite at every chunk
    (``_decay_matrix``)."""
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

    hi, lo = _ssd_seg(dtg * A.to(f)[None, None, None, :], exact)     # [b,nc,q,H]
    total, total_lo = hi[:, :, -1, :], lo[:, :, -1, :]                # [b,nc,H]
    L = _decay_matrix(hi, lo)                                         # [b,nc,q,q,H]
    scores = torch.einsum("bcqhn,bckhn->bcqkh", Cg, Bg)
    ydt = xg * dtg[..., None]
    y = torch.einsum("bcqkh,bckhp->bcqhp", scores * L, ydt)
    decay_to_end = torch.exp((total[:, :, None, :] - hi) + (total_lo[:, :, None, :] - lo))
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchnp", Bg, decay_to_end, ydt)
    return y.reshape(b, s, H, P), states, total


def ref_ssd_chunk_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor, chunk: int, gy: torch.Tensor, gstates: torch.Tensor,
                      gdecay: torch.Tensor, exact: bool = False
                      ) -> Tuple[torch.Tensor, ...]:
    """The ``ssd_chunk_bwd`` contract: the gradients (gx, gdt, gA, gB, gC)
    of ``ref_ssd_chunk``'s inputs from those of its outputs (gy [b, s, H,
    P], gstates [b, nc, H, N, P], gdecay [b, nc, H]), by the explicit
    formulas, the seg pair kept as the forward keeps it (``exact``: every
    step in fp64). Per (batch, chunk, head), with u = dt x, S = C B^T of
    the head's group, L[i, j] = exp(seg_i - seg_j) [j <= i], M = S o L and
    w = exp(total - seg):

    - gM = (gy u^T) o [j <= i];  gu = M^T gy + (B o w) gstate;
    - the group's G_S = sum over its heads of gM o L; gC = G_S B and
      gB = G_S^T C + sum over its heads of w o (u gstate^T);
    - R = gM o M, r_j = w_j sum_n B_jn (u gstate^T)_jn, and
      g(dA_k) = sum_{j < k <= i} R_ij + sum_{j < k} r_j + gdecay: seg_i -
      seg_j sums dA over j < k <= i and total - seg_j over k > j, so each
      pair's term is added where it acts, with no difference of large
      partial sums;
    - gx = gu dt, gdt = g(dA) A + sum_p gu o x, gA = sum_{b, c, k}
      g(dA) dt.

    Returns fp32 (fp64 when ``exact``) tensors shaped as the inputs."""
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    nc, rep = s // chunk, H // G
    f = torch.float64 if exact else torch.float32
    xg = x.to(f).reshape(b, nc, chunk, H, P)
    dtg = dt.to(f).reshape(b, nc, chunk, H)
    Af = A.to(f)
    Bg = B.to(f).reshape(b, nc, chunk, G, N)
    Cg = C.to(f).reshape(b, nc, chunk, G, N)
    gyg = gy.to(f).reshape(b, nc, chunk, H, P)
    gs = gstates.to(f)                                                # [b,nc,H,N,P]

    hi, lo = _ssd_seg(dtg * Af[None, None, None, :], exact)          # [b,nc,q,H]
    L = _decay_matrix(hi, lo)                                         # [b,nc,i,j,H]
    w = torch.exp((hi[:, :, -1:, :] - hi) + (lo[:, :, -1:, :] - lo))  # [b,nc,q,H]
    u = xg * dtg[..., None]                                           # [b,nc,q,H,P]
    M = torch.einsum("bcign,bcjgn->bcijg", Cg, Bg).repeat_interleave(rep, dim=4) * L
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    gM = torch.einsum("bcihp,bcjhp->bcijh", gyg, u) * causal[None, None, :, :, None]
    v = torch.einsum("bcjhn,bchnp->bcjhp", Bg.repeat_interleave(rep, dim=3), gs)   # B gstate
    gu = torch.einsum("bcijh,bcihp->bcjhp", M, gyg) + w[..., None] * v
    G_S = (gM * L).reshape(b, nc, chunk, chunk, G, rep).sum(-1)       # [b,nc,i,j,G]
    gC = torch.einsum("bcijg,bcjgn->bcign", G_S, Bg)
    state_term = torch.einsum("bcjh,bcjhp,bchnp->bcjhn", w, u, gs)
    gB = (torch.einsum("bcijg,bcign->bcjgn", G_S, Cg)
          + state_term.reshape(b, nc, chunk, G, rep, N).sum(4))

    # g(dA_k): R's pairs j < k <= i (each row's sum over j < k, then the
    # rows i >= k), r's keys j < k, and gdecay through total = seg_{q-1}
    R = gM * M                                                        # [b,nc,i,j,H]
    before_k = torch.nn.functional.pad(torch.cumsum(R, dim=3)[:, :, :, :-1], (0, 0, 1, 0))
    gdA = (before_k * causal[None, None, :, :, None]).sum(2)          # [b,nc,k,H]
    r = w * (u * v).sum(-1)                                           # [b,nc,j,H]
    gdA = (gdA + torch.nn.functional.pad(torch.cumsum(r, dim=2)[:, :, :-1], (0, 0, 1, 0))
           + gdecay.to(f)[:, :, None, :])
    gx = gu * dtg[..., None]
    gdt = gdA * Af + (gu * xg).sum(-1)
    gA = (gdA * dtg).sum((0, 1, 2))
    return (gx.reshape(b, s, H, P), gdt.reshape(b, s, H), gA, gB.reshape(b, s, G, N),
            gC.reshape(b, s, G, N))


def tile_rel_err(out: torch.Tensor, ref: torch.Tensor, rows: int = 64) -> float:
    """The largest ||out - ref||_2 / ||ref||_2 over ``rows``-row tiles of
    axis -2 of [..., s, d] tensors (each batch and head apart); a tile whose
    ``ref`` is 0 counts 0 where ``out`` is 0 there too, else inf. A wrong
    tile shows against its own scale, where a max check weighs it against
    the tensor's largest value and a norm over the whole tensor dilutes it
    by the number of tiles."""
    e, n = (x.float().square().sum(-1) for x in (out.float() - ref.float(), ref))
    pad = -e.shape[-1] % rows
    e, n = (torch.nn.functional.pad(x, (0, pad)).unflatten(-1, (-1, rows)).sum(-1)
            for x in (e, n))
    ratio = torch.where(n > 0, e / n.clamp_min(torch.finfo(torch.float32).tiny),
                        torch.where(e > 0, math.inf, 0.0))
    return math.sqrt(ratio.max().item())
