"""Plain PyTorch versions of the CUDA kernels.

Deliberately naive (no tiling, no online softmax): the CPU runs these in
place of the CUDA kernels, and ``chip_smoke.py`` holds each kernel
against them on the card. In attention, softmax is in fp32 and masked
scores are -1e30, as in ``repro/kernels/ref.py`` and the Pallas kernels.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: [b, h, sq, d]; k, v: [b, kvh, skv, d] (GQA: h % kvh == 0).

    Query positions are offset by ``skv - sq``; the window applies only
    together with the causal mask, as in the JAX oracle.
    """
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, kvh, g, sq, d).float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        mask = kpos <= qpos
        if window:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)


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
