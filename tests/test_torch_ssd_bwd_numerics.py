"""The SSD chunk backward kernels' arithmetic, against the fp64 formula and JAX, on the CPU.

``ssd_bwd_head_kernel``, ``ssd_bwd_state_kernel``, ``ssd_bwd_pair_kernel``
and ``ssd_bwd_group_kernel`` (``repro_torch/kernels/csrc/ssd_chunk.cu``)
run only on a card. ``_kernel_bwd`` repeats in plain torch how they divide
the work and round: every product in 3xTF32 (``mm_3xtf32`` of
tests/test_torch_ssd_numerics.py), the head kernel's and the pair and state
kernels' products (a head's, over its k-steps) as one chain on the tensor
cores, the group kernel's with each k-step of 8 summed from zero there and
the k-steps in fp32; the decay L by ``exp2`` of x log2(e) as ``ex2.approx``
takes it (off G_S's diagonal tiles as the product of a factor of each row
and of each key, taken into the operands); operands rounded where the
kernels round them (u = dt x, w o u); per head the row and column sums of R
= gM o M off its diagonal, accumulated over the 64 x 64 pairs in the
kernel's order, and g(dA_k) as an exclusive scan over the chunk of cs - rs
+ r (the pairs j < k <= i are those of the columns m < k less those of the
rows m < k), the scan shaped as the kernel's (shuffles within each 32
positions, then the warps' totals in order); per group G_S and gB's state
term summed over the heads of each ``bwd_slices`` slice in order, then
over the slices in order. The tests hold it to
``ref_ssd_chunk_bwd(exact=True)`` (the formulas in fp64) at 1e-4 of each
gradient's largest |value| and each (batch, chunk, head or group) tile at
1e-4 of its own norm, at mamba2's widths with a few heads, chunks 256 and
64, one and two groups; and, with the arithmetic in place of
``SsdChunk``'s plain backward, the scan's gradients to a jitted
``jax.vjp`` of ``ssd_chunked`` at chunks up to 64 (at 128 and more the JAX
reference's dt and A gradients are not finite: it takes exp before the
mask). The state and pair kernels' launch plan is checked to cover every
(item, head) once.
"""
import functools
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked
from repro_torch.kernels import ssd_scan, ssd_scan_op
from repro_torch.kernels.ref import ref_ssd_chunk_bwd, seg_hi_lo, tile_rel_err
from repro_torch.kernels.ssd_scan import bwd_slices
from test_torch_ssd_numerics import mm_3xtf32

TOL = 1e-4              # of each gradient's largest |value|, and of each tile's norm
LOG2E = 1.4426950408889634
TILE = 64               # kTile: the 64 x 64 pairs of rows and keys
WARP = 32
NAMES = ("gx", "gdt", "gA", "gB", "gC")


@pytest.fixture(autouse=True)
def _two_threads():
    """The emulation's large fp64 tensors on at most two threads, so that
    this file leaves the machine's cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _pair_sums(R, Q):
    """(cs, rs) of R [..., Q(i), Q(j)] (0 on and above the diagonal): per
    64 x 64 pair (I, J <= I), its column sums added to cs in row-tile order
    and its row sums added to rs in key-tile order, in fp32."""
    nt = -(-Q // TILE)
    cs = torch.zeros(R.shape[:-1])
    rs = torch.zeros(R.shape[:-1])
    for jt in range(nt):
        for it in range(jt, nt):
            tile = R[..., it * TILE:(it + 1) * TILE, jt * TILE:(jt + 1) * TILE]
            cs[..., jt * TILE:(jt + 1) * TILE] += tile.sum(-2)
            rs[..., it * TILE:(it + 1) * TILE] += tile.sum(-1)
    return cs, rs


def _exclusive_scan(e):
    """sum_{m < k} e_m along the last axis as the head kernel scans it: one
    position a thread, a Hillis-Steele scan by shuffles within each warp of
    32, then the warps' totals added in order, in fp32."""
    Q = e.shape[-1]
    pad = -Q % WARP
    v = torch.nn.functional.pad(e, (0, pad)).unflatten(-1, (-1, WARP))
    d = 1
    while d < WARP:
        v = v + torch.nn.functional.pad(v[..., :-d], (d, 0))
        d *= 2
    exc = torch.nn.functional.pad(v[..., :-1], (1, 0))
    off = torch.zeros(v.shape[:-1])
    for w in range(1, v.shape[-2]):
        off[..., w] = off[..., w - 1] + v[..., w - 1, -1]
    return (off[..., None] + exc).flatten(-2)[..., :Q]


def slice_heads(hpg, ns):
    """The head offsets within a group that slice ``sl`` of ``ns`` sums, in
    order: [sl hpg / ns, (sl + 1) hpg / ns) (ssd_bwd_state_kernel and
    ssd_bwd_pair_kernel)."""
    return [list(range(sl * hpg // ns, (sl + 1) * hpg // ns)) for sl in range(ns)]


def slice_plan(H, G, Q):
    """The blocks along grid x of the state kernel, then of the pair kernel,
    as their index arithmetic decodes them: (item, slice, heads), the state
    kernel's items the key tiles jt (blockIdx.x = jt ns + slice), the pair
    kernel's the pairs (it, jt <= it), numbered p = it (it + 1) / 2 + jt
    (blockIdx.x = p ns + slice), each block summing its slice's heads of a
    group."""
    nt = -(-Q // TILE)
    ns = bwd_slices(H, G)
    heads = slice_heads(H // G, ns)
    blocks = []
    for x in range(ns * nt):
        jt, sl = divmod(x, ns)
        blocks.append((("state", jt), sl, heads[sl]))
    for x in range(ns * nt * (nt + 1) // 2):
        p, sl = divmod(x, ns)
        it = 0
        while (it + 1) * (it + 2) // 2 <= p:
            it += 1
        blocks.append((("pair", it, p - it * (it + 1) // 2), sl, heads[sl]))
    return blocks


def _kernel_bwd(x, dt, A, B, C, Q, gy, gstates, gdecay):
    """(gx, gdt, gA, gB, gC) as the backward kernels compute them."""
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc, rep = s // Q, H // G
    x, dt, A, B, C, gy, gstates, gdecay = (t.float() for t in (x, dt, A, B, C, gy, gstates,
                                                               gdecay))
    xc = x.reshape(b, nc, Q, H, P).transpose(2, 3)                  # [b, nc, H, Q, P]
    dtc = dt.reshape(b, nc, Q, H).transpose(2, 3)                   # [b, nc, H, Q]
    Bc = B.reshape(b, nc, Q, G, N).transpose(2, 3)                  # [b, nc, G, Q, N]
    Cc = C.reshape(b, nc, Q, G, N).transpose(2, 3)
    gyc = gy.reshape(b, nc, Q, H, P).transpose(2, 3)
    S = mm_3xtf32(Cc, Bc.transpose(-1, -2))                         # the scores kernel
    hi, lo = seg_hi_lo(dtc * A[:, None], dim=-1)
    rel = (hi[..., :, None] - hi[..., None, :]) + (lo[..., :, None] - lo[..., None, :])
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()
    L = torch.where(causal, torch.exp2(rel * LOG2E), 0.0)          # [b, nc, H, i, j]
    w = torch.exp((hi[..., -1:] - hi) + (lo[..., -1:] - lo))
    u = xc * dtc[..., None]

    # ssd_bwd_head_kernel, per (batch, chunk, head): each product one chain
    chain = functools.partial(mm_3xtf32, chain=True)
    M = S.repeat_interleave(rep, dim=2) * L
    gM = chain(gyc, u.transpose(-1, -2))
    R = torch.where(torch.ones((Q, Q), dtype=torch.bool).tril(-1), gM * M, 0.0)
    cs, rs = _pair_sums(R, Q)
    gu = chain(M.transpose(-1, -2), gyc)
    v = chain(Bc.repeat_interleave(rep, dim=2), gstates)
    gu = gu + w[..., None] * v
    gx = gu * dtc[..., None]
    xg = (gu * xc).sum(-1)
    r = w * (u * v).sum(-1)
    gdA = _exclusive_scan((cs - rs) + r) + gdecay[..., None]
    gdt = gdA * A[:, None] + xg
    ga = (gdA * dtc).sum(-1).reshape(b * nc, H)                     # the blocks' shares
    gA = torch.zeros(H)
    for i in range(b * nc):                                         # ssd_bwd_gA_kernel
        gA = gA + ga[i]

    # ssd_bwd_pair_kernel and ssd_bwd_state_kernel: per head one chain of
    # products on the tensor cores (wgmma), the heads of each slice added in
    # order; then the group kernel: the slices in order, then G_S's products
    # (a diagonal tile gM o L; off it, L = a_i b_j is taken into the operands:
    # gy's rows times a_i = e^(seg_i - ref), u's times b_j = e^(ref - seg_j),
    # ref the seg pair at key tile jt's last position)
    gML = gM * L
    nt = -(-Q // TILE)
    for jt in range(nt):
        J = slice(jt * TILE, (jt + 1) * TILE)
        ref, ref_lo = hi[..., J][..., -1:], lo[..., J][..., -1:]
        for it in range(jt + 1, nt):
            I = slice(it * TILE, (it + 1) * TILE)
            a = torch.exp2(((hi[..., I] - ref) + (lo[..., I] - ref_lo)) * LOG2E)
            bj = torch.exp2(((ref - hi[..., J]) + (ref_lo - lo[..., J])) * LOG2E)
            gML[..., I, J] = chain(gyc[..., I, :] * a[..., None],
                                   (u[..., J, :] * bj[..., None]).transpose(-1, -2))
    gML = gML.unflatten(2, (G, rep))                                # [b, nc, G, rep, i, j]
    st_h = chain(u * w[..., None], gstates.transpose(-1, -2)).unflatten(2, (G, rep))  # [.., j, n]
    G_S = state = None
    for heads in slice_heads(rep, bwd_slices(H, G)):
        part, st = gML[:, :, :, heads[0]], st_h[:, :, :, heads[0]]
        for h in heads[1:]:
            part = part + gML[:, :, :, h]
            st = st + st_h[:, :, :, h]
        G_S = part if G_S is None else G_S + part
        state = st if state is None else state + st
    gC = mm_3xtf32(G_S, Bc)
    gB = mm_3xtf32(G_S.transpose(-1, -2), Cc) + state
    return (gx.transpose(2, 3).reshape(b, s, H, P), gdt.transpose(2, 3).reshape(b, s, H), gA,
            gB.transpose(2, 3).reshape(b, s, G, N), gC.transpose(2, 3).reshape(b, s, G, N))


def _inputs(seed, b, s, H, P, G, N, Q):
    """As ``_ssd_inputs`` in tests/test_kernels.py (dt = softplus(normal),
    A = -exp(0.3 normal)), and standard normal gradients of the outputs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, H, P), np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, H)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, s, G, N), np.float32)
    C = rng.standard_normal((b, s, G, N), np.float32)
    nc = s // Q
    ups = [rng.standard_normal(shape, np.float32)
           for shape in ((b, s, H, P), (b, nc, H, N, P), (b, nc, H))]
    return [torch.from_numpy(a) for a in (x, dt, A, B, C)], [torch.from_numpy(a) for a in ups]


def _tiles(g, Q):
    """A gradient as chip_smoke.py's ``ssd_bwd_tiles`` cuts it: [b, heads or
    groups, s, cols] with Q-row tiles; gA as one tile."""
    if g.dim() == 1:
        return g[None, :, None], g.numel()
    g = g if g.dim() == 4 else g[..., None]
    return g.transpose(1, 2), Q


@pytest.mark.parametrize("b,s,H,P,G,N,Q", [
    (1, 256, 6, 64, 1, 128, 256),     # mamba2's widths, six heads in four slices of 1-2
    (1, 256, 4, 64, 2, 128, 256),     # two groups, one head a slice
    (1, 256, 6, 64, 1, 64, 256),      # zamba2's state
    (2, 256, 6, 64, 1, 128, 64),      # chunk 64
    (1, 256, 8, 64, 2, 128, 64),      # chunk 64, two groups
    (1, 400, 4, 16, 1, 8, 200),       # a chunk that is not a tile multiple
    (2, 96, 4, 12, 2, 10, 32),        # P 12, N 10: ragged k-steps
])
def test_kernel_arithmetic_holds_the_exact_formula(b, s, H, P, G, N, Q):
    """Every gradient of the kernels' arithmetic finite, within 1e-4 of its
    largest |value| of the formulas in fp64, and each (batch, chunk, head
    or group) tile within 1e-4 of its own norm."""
    ins, ups = _inputs(21, b, s, H, P, G, N, Q)
    got = _kernel_bwd(*ins, Q, *ups)
    want = ref_ssd_chunk_bwd(*ins, Q, *ups, exact=True)
    for name, g, e in zip(NAMES, got, want):
        assert g.shape == e.shape and torch.isfinite(g).all(), name
        assert (g.double() - e).abs().max().item() <= TOL * e.abs().max().item(), name
        (tg, rows), (te, _) = _tiles(g.double(), Q), _tiles(e, Q)
        assert tile_rel_err(tg, te, rows=rows) <= TOL, name


@pytest.mark.parametrize("b,s,H,P,G,N,chunk", [
    (1, 128, 6, 64, 1, 128, 64),      # mamba2's widths at chunk 64
    (1, 128, 8, 64, 2, 128, 64),      # two groups
    (2, 100, 4, 16, 2, 8, 32),        # ragged: 100 = 3 chunks of 32 + 4
])
def test_scan_through_the_kernel_arithmetic_matches_jax_vjp(b, s, H, P, G, N, chunk):
    """``ssd_scan_op``'s gradients (x, dt, A, B, C and an initial state)
    with the kernels' arithmetic in place of ``SsdChunk``'s plain
    backward, and autograd of the carry, within 1e-4 of each one's largest
    |value| of a jitted ``jax.vjp`` of ``ssd_chunked``. (Element by element
    at atol = rtol = 1e-4 the plain backward misses JAX too at mamba2's
    widths, on gdt and gA entries near 0: both lie within a tenth of this
    check.)"""
    rng = np.random.default_rng(22)
    arrays = [rng.standard_normal((b, s, H, P), np.float32),
              np.logaddexp(rng.standard_normal((b, s, H)), 0).astype(np.float32),
              -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32),
              rng.standard_normal((b, s, G, N), np.float32),
              rng.standard_normal((b, s, G, N), np.float32),
              rng.standard_normal((b, H, P, N), np.float32)]
    gy = rng.standard_normal((b, s, H, P), np.float32)
    gh = rng.standard_normal((b, H, P, N), np.float32)

    def f(x, dt, A, B, C, h0):
        return ssd_chunked(x, dt, A, B, C, chunk, initial_state=h0, return_state=True)

    @jax.jit
    def vjp(args, cotangents):
        return jax.vjp(f, *args)[1](cotangents)
    want = vjp(tuple(jnp.asarray(a) for a in arrays), (jnp.asarray(gy), jnp.asarray(gh)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    with mock.patch.object(ssd_scan, "ref_ssd_chunk_bwd", _kernel_bwd):
        y, h = ssd_scan_op(*leaves[:5], chunk, initial_state=leaves[5], return_state=True)
        got = torch.autograd.grad((y, h), leaves, (torch.from_numpy(gy), torch.from_numpy(gh)))
    for name, g, w in zip(NAMES + ("gh0",), got, want):
        w = np.asarray(w, np.float64)
        assert np.isfinite(w).all() and g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= TOL * np.abs(w).max(), name


@pytest.mark.parametrize("H,G,Q", [(80, 1, 256), (80, 1, 128), (4, 4, 16), (6, 1, 200),
                                   (8, 2, 64), (7, 1, 256), (3, 1, 1), (40, 8, 256)])
def test_slice_plan_covers_every_item_and_head_once(H, G, Q):
    """The state and pair kernels' blocks cover every (item, head of the
    group) exactly once: each key tile's state term and each causal pair
    (it, jt <= it), each head in exactly one slice, the slices at most 4
    whatever H."""
    nt = -(-Q // TILE)
    rep = H // G
    blocks = slice_plan(H, G, Q)
    assert bwd_slices(H, G) == min(4, rep)
    seen = {}
    for what, _, heads in blocks:
        assert heads, "an empty slice"
        for h in heads:
            seen[(what, h)] = seen.get((what, h), 0) + 1
    items = [("state", t) for t in range(nt)] + [("pair", i, j) for i in range(nt)
                                                 for j in range(i + 1)]
    assert seen == {(it, h): 1 for it in items for h in range(rep)}


def test_slices_sum_each_groups_heads_in_order():
    """Each group's heads fall into the slices in order and contiguously,
    so the slices' sum adds the heads in the same order for every shape."""
    for hpg in range(1, 90):
        ns = bwd_slices(hpg, 1)
        heads = slice_heads(hpg, ns)
        assert [h for sl in heads for h in sl] == list(range(hpg))
        assert max(len(sl) for sl in heads) - min(len(sl) for sl in heads) <= 1


def test_column_less_row_sums_are_the_straddling_pairs():
    """The identity the head kernel's g(dA) rests on, in fp64 on a causal
    R with a diagonal: sum_{m < k} (cs_m - rs_m) over the sums off the
    diagonal equals sum over the pairs j < k <= i of R_ij, for every k."""
    Q = 77
    R = torch.randn((3, Q, Q), generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64).tril()
    direct = torch.stack([R[:, k:, :k].sum((-1, -2)) for k in range(Q)], -1)
    off = R.tril(-1)
    e = off.sum(-2) - off.sum(-1)
    ident = torch.nn.functional.pad(torch.cumsum(e, -1)[:, :-1], (1, 0))
    assert (direct - ident).abs().max().item() < 1e-12


@pytest.mark.parametrize("Q", [1, 16, 31, 32, 33, 200, 256])
def test_warp_scan_is_the_exclusive_prefix_sum(Q):
    """The modelled scan (shuffles in each warp, the totals in order) gives
    sum_{m < k} e_m to fp32 rounding, and exactly 0 at k = 0."""
    e = torch.randn((5, Q), generator=torch.Generator().manual_seed(Q))
    got = _exclusive_scan(e)
    want = torch.nn.functional.pad(torch.cumsum(e.double(), -1)[:, :-1], (1, 0))
    assert torch.equal(got[:, 0], torch.zeros(5))
    bound = 4e-5 * math.sqrt(Q) * e.abs().max().item()
    assert (got.double() - want).abs().max().item() <= bound


def test_pair_sums_are_the_row_and_column_sums():
    """``_pair_sums`` adds every element of a causal R once to its column's
    and its row's sum, Q not a tile multiple."""
    Q = 200
    R = torch.randn((2, Q, Q), generator=torch.Generator().manual_seed(4)).tril(-1)
    cs, rs = _pair_sums(R, Q)
    torch.testing.assert_close(cs, R.sum(-2), atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(rs, R.sum(-1), atol=1e-4, rtol=1e-5)
