"""The bf16 attention backward kernels' arithmetic against JAX's autodiff, on the CPU.

``flash_bwd_dkdv_mma_kernel`` and ``flash_bwd_dq_mma_kernel``
(``repro_torch/kernels/csrc/flash_attention.cu``) run only on a card.
Their numerical changes from the plain formulas are that every product
takes bf16 inputs with fp32 sums on the tensor cores, so P and dS are
rounded to bf16 before the dV, dK and dQ products (as FlashAttention-2
rounds them; ``ref_attention_bwd`` keeps them in fp32), and that P is
recomputed as exp2(S scale log2 e - lse log2 e) from the forward's
natural-log lse. ``_kernel_arithmetic_bwd`` repeats that arithmetic in
plain torch over the kernels' tiles (64 keys by 64 query rows; dK and dV
summed over the query heads of each kv head) and the tests hold it
against ``jax.vjp`` of ``repro.kernels.ref.ref_attention`` in fp32 on
the same bf16-rounded numpy inputs, within 2e-2 of each gradient's
largest |value| and, in every 64-row tile, within half of 1e-2 of the
tile's own norm (the card's two tolerances for bf16 gradients: the
rounding leaves room under both for what the card adds).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ref_attention as jax_ref_attention
from repro_torch.kernels.ref import ref_attention, tile_rel_err

TILE = 64               # kMmaBQ = kMmaBK: query rows and keys per tile
LOG2E = 1.4426950408889634
TOL = 2e-2              # of the largest |grad|, as chip_smoke.py's BWD_TOL for bf16
TILE_TOL = 1e-2         # of a 64-row tile's norm, as chip_smoke.py's BWD_TILE_TOL


def _bf16(x: torch.Tensor, on: bool = True) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if on else x


def _mask(q0, nq, k0, nk, sq, skv, window):
    """True where query row q0 + i sees key k0 + j (causal, query offset
    skv - sq, the window, both ragged edges)."""
    qpos = torch.arange(q0, q0 + nq)[:, None] + (skv - sq)
    kpos = torch.arange(k0, k0 + nk)[None, :]
    m = (kpos <= qpos) & (kpos < skv) & (qpos - (skv - sq) < sq)
    if window:
        m &= kpos > qpos - window
    return m


def _kernel_arithmetic_bwd(q, k, v, o, lse, dO, window=0, round=True):
    """(dq, dk, dv) as the bf16 kernels compute them. q, o, dO: [b, h, sq,
    d] bf16; k, v: [b, kvh, skv, d] bf16; lse: fp32 [b, h, sq] (natural
    log). ``round=False`` keeps P and dS in fp32 before their products,
    to size the rounding's share."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    qf = q.float().reshape(b, kvh, g, sq, d)
    dOf = dO.float().reshape(b, kvh, g, sq, d)
    kf, vf = k.float(), v.float()
    lse2 = (lse.float() * torch.tensor(LOG2E, dtype=torch.float32)).reshape(b, kvh, g, sq)
    delta = (dOf * o.float().reshape(b, kvh, g, sq, d)).sum(-1)      # flash_bwd_delta_kernel

    def p_ds(q0, k0):
        """P and dS of query tile q0 against key tile k0: [b, kvh, g, rows, keys]."""
        qt, ot = qf[:, :, :, q0:q0 + TILE], dOf[:, :, :, q0:q0 + TILE]
        kt, vt = kf[:, :, k0:k0 + TILE], vf[:, :, k0:k0 + TILE]
        s = torch.einsum("bkgqd,bktd->bkgqt", qt, kt)
        dp = torch.einsum("bkgqd,bktd->bkgqt", ot, vt)
        p = torch.exp2(s * scale_log2 - lse2[:, :, :, q0:q0 + TILE, None])
        p = torch.where(_mask(q0, qt.shape[3], k0, kt.shape[2], sq, skv, window), p,
                        torch.zeros_like(p))
        return p, p * (dp - delta[:, :, :, q0:q0 + TILE, None])

    # dK, dV: one key tile at a time, over every (head of the group, query tile)
    dk = torch.zeros((b, kvh, skv, d))
    dv = torch.zeros((b, kvh, skv, d))
    for k0 in range(0, skv, TILE):
        for q0 in range(0, sq, TILE):
            p, ds = p_ds(q0, k0)
            ot, qt = dOf[:, :, :, q0:q0 + TILE], qf[:, :, :, q0:q0 + TILE]
            dv[:, :, k0:k0 + TILE] += torch.einsum("bkgqt,bkgqd->bktd", _bf16(p, round), ot)
            dk[:, :, k0:k0 + TILE] += torch.einsum("bkgqt,bkgqd->bktd", _bf16(ds, round), qt)
    # dQ: one query tile at a time, over the key tiles
    dq = torch.zeros((b, kvh, g, sq, d))
    for q0 in range(0, sq, TILE):
        for k0 in range(0, skv, TILE):
            _, ds = p_ds(q0, k0)
            dq[:, :, :, q0:q0 + TILE] += torch.einsum("bkgqt,bktd->bkgqd", _bf16(ds, round),
                                                      kf[:, :, k0:k0 + TILE])
    return ((dq * scale).reshape(b, h, sq, d).to(torch.bfloat16),
            (dk * scale).to(torch.bfloat16), dv.to(torch.bfloat16))


def _inputs(seed, b, h, kvh, sq, skv, d):
    """q, k, v, dO rounded to bf16 (as numpy fp32 for JAX)."""
    rng = np.random.default_rng(seed)
    shapes = [(b, h, sq, d), (b, kvh, skv, d), (b, kvh, skv, d), (b, h, sq, d)]
    return [torch.from_numpy(rng.standard_normal(sh, np.float32)).to(torch.bfloat16)
            .float().numpy() for sh in shapes]


@pytest.mark.parametrize("b,h,kvh,sq,skv,d,window", [
    (1, 2, 2, 128, 128, 16, 0),     # GQA 1, the reduced configs' head_dim
    (1, 6, 2, 130, 130, 64, 0),     # GQA 3, a ragged length
    (1, 8, 1, 128, 128, 128, 0),    # GQA 8, llama's head_dim
    (1, 4, 2, 128, 128, 64, 32),    # window 32, inside a tile
    (1, 6, 2, 72, 200, 80, 0),      # sq 72 < skv 200, zamba2's head_dim
    (1, 4, 4, 100, 100, 80, 32),    # ragged under a window
])
def test_bf16_backward_stays_within_the_reference_tolerance(b, h, kvh, sq, skv, d, window):
    qn, kn, vn, dOn = _inputs(20, b, h, kvh, sq, skv, d)
    _, vjp = jax.vjp(lambda q, k, v: jax_ref_attention(q, k, v, window=window), qn, kn, vn)
    want = [np.asarray(w) for w in vjp(jnp.asarray(dOn))]

    q, k, v, dO = (torch.from_numpy(a).to(torch.bfloat16) for a in (qn, kn, vn, dOn))
    o, lse = ref_attention(q.float(), k.float(), v.float(), window=window, return_lse=True)
    o = o.to(torch.bfloat16)                 # the forward kernel's output dtype
    got = _kernel_arithmetic_bwd(q, k, v, o, lse, dO, window=window)
    exact = _kernel_arithmetic_bwd(q, k, v, o, lse, dO, window=window, round=False)
    for name, g, e, w in zip(("dq", "dk", "dv"), got, exact, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        scale = np.abs(w).max()
        err = np.abs(g.float().numpy() - w).max()
        assert err <= TOL * scale, f"{name}: {err} > {TOL} * {scale}"
        tile = tile_rel_err(g, torch.from_numpy(w))
        assert tile <= TILE_TOL / 2, f"{name}: a 64-row tile off by {tile}"
        # what rounding P and dS moves: the same arithmetic with them in
        # fp32 differs, by less than half the tolerance
        gap = np.abs(g.float().numpy() - e.float().numpy()).max()
        assert 0 < gap < TOL / 2 * scale, f"{name}: rounding gap {gap} of {scale}"


def test_tile_rel_err_reads_each_tile_at_its_own_scale():
    """A tile of small values that is 10% off reads 0.1, though it is far
    under 2e-2 of the tensor's largest value; a ragged last tile counts
    on its own rows; a tile that is 0 in both reads 0, and inf where only
    the reference is 0."""
    rng = np.random.default_rng(3)
    ref = torch.from_numpy(rng.standard_normal((2, 3, 150, 16), np.float32))
    ref[1, 2, 64:128] *= 1e-3
    out = ref.clone()
    out[1, 2, 64:128] *= 1.1
    assert (out - ref).abs().max() < 1e-3 * ref.abs().max()
    assert tile_rel_err(out, ref) == pytest.approx(0.1, rel=1e-5)
    out = ref.clone()
    out[0, 1, 128:] *= 1.2                  # the last tile: rows 128..149
    assert tile_rel_err(out, ref) == pytest.approx(0.2, rel=1e-5)
    ref[0, 0, :64] = 0
    out = ref.clone()
    assert tile_rel_err(out, ref) == 0
    out[0, 0, 5, 3] = 1e-6
    assert tile_rel_err(out, ref) == math.inf
