"""The SSD chunk kernels' arithmetic, against the JAX Pallas kernel, on the CPU.

``ssd_scores_kernel`` and ``ssd_chunk_kernel``
(``repro_torch/kernels/csrc/ssd_chunk.cu``) run only on a card.
``_kernel_arithmetic`` repeats in plain torch how they divide the work and
round: the scores S = C B^T once per (batch, chunk, group), seg summed
exactly and kept as an fp32 pair hi + lo (``seg_hi_lo``, with differences
formed as (hi_i - hi_j) + (lo_i - lo_j)), then per head the masked,
decayed scores times dt*x and (B w)^T times dt*x, every product in
3xTF32 (each operand split into a TF32 high part and the TF32 rounding of
the rest, the low-low product dropped), TF32 rounding emulated bit for
bit as ``cvt.rna`` does it, and each k-step of 8 summed as the tensor
cores are modelled to sum (``tc_sum``: aligned to the largest term and cut
toward zero). The tests hold it against ``ssd_chunk_pallas`` in interpret
mode at the tolerance of tests/test_kernels.py (atol = rtol = 1e-4) at
the odd shapes the card tests use. At the serving chunk of 256 seg
reaches about -190, where an fp32 ulp is 1.5e-5, and no fp32 seg holds
both references: the Pallas kernel itself lies up to 2.6x the tolerance
from an fp64 evaluation of the formula (``_exact``). There the tests hold
the kernels' arithmetic within half the tolerance of ``_exact``, and
within the Pallas kernel's own share of it (plus 0.25) of the Pallas
kernel, over 12 draws; and show that a single fp32 seg summed in sequence,
as the kernels once did, lies more than the tolerance from ``_exact``;
that one TF32 pass would miss the tolerance, which is why the kernels
split; and that summing every k-step into one accumulator on the tensor
cores drifts further, which is why each k-step starts from zero.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_chunk_pallas
from repro_torch.kernels.ref import seg_hi_lo

TOL = 1e-4              # tests/test_kernels.py:79-81
LOG2E = 1.4426950408889634


def tf32(t):
    """Round fp32 to TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32``: to
    nearest, ties away from zero, on the bits."""
    u = t.contiguous().numpy().view(np.uint32).astype(np.uint64)
    r = ((u + 0x1000) & 0xFFFFE000).astype(np.uint32)
    return torch.from_numpy(r.view(np.float32).copy())


K_STEP = 8              # the k of mma.sync.m16n8k8


def tc_sum(products, c):
    """One mma.sync sum of K_STEP products [..., K_STEP, n] into c [..., n],
    fp32, as modelled here (NVIDIA does not document it): the products are
    exact (a TF32 x TF32 product fits in fp32); they and c are aligned to
    the largest exponent among them, each cut toward zero to 24 bits below
    its leading bit, added exactly, and the sum is cut toward zero to fp32."""
    terms = torch.cat([products.double(), c.double().unsqueeze(-2)], -2)
    _, e = torch.frexp(terms.abs().amax(-2, keepdim=True))
    quantum = torch.ldexp(torch.ones_like(e, dtype=torch.float64), (e - 24).double())
    s = (torch.trunc(terms / quantum) * quantum).sum(-2)            # exact in float64
    r = s.float()
    return torch.where(r.double().abs() > s.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def mm_3xtf32(a, b, chain=False):
    """a @ b as the kernels take it: for each k-step of K_STEP columns of a,
    a_lo b_hi, then a_hi b_lo, then a_hi b_hi summed from zero on the
    tensor cores (``tc_sum``), and the k-steps added in fp32, rounded to
    nearest. ``chain`` sums every k-step's products into the running
    accumulator on the tensor cores instead, as the kernels do not."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k in range(0, a.shape[-1], K_STEP):
        ks = slice(k, k + K_STEP)

        def products(u, v):
            return u[..., :, ks, None].double() * v[..., ks, :].double().unsqueeze(-3)
        d = acc if chain else torch.zeros_like(acc)
        for u, v in ((al, bh), (ah, bl), (ah, bh)):
            d = tc_sum(products(u, v), d)
        acc = d if chain else acc + d
    return acc


def mm_tf32(a, b):
    """a @ b in one TF32 pass, which the kernels do not take."""
    return tf32(a) @ tf32(b)


def hi_lo_cumsum(dA):
    """seg as the scores kernel keeps it: the fp32 terms summed exactly,
    then the pair (hi, lo) of fp32 values, hi the sum rounded."""
    return seg_hi_lo(dA, dim=-1)


def sequential_cumsum(dA):
    """seg as the scores kernel summed it before it kept the pair: in
    order along the chunk, one fp32, dt*A rounded before each add (as
    torch.cumsum does along a non-last axis on a card)."""
    seg, acc = torch.empty_like(dA), torch.zeros_like(dA[..., 0])
    for i in range(dA.shape[-1]):
        acc = acc + dA[..., i]
        seg[..., i] = acc
    return seg


def pallas_cumsum(dA):
    """seg as the Pallas body sums it: ``jnp.cumsum`` of each [Q, 1] column."""
    f = jax.jit(lambda v: jnp.cumsum(v, axis=0))
    cols = dA.reshape(-1, dA.shape[-1]).numpy()
    return torch.from_numpy(np.stack([np.asarray(f(c[:, None]))[:, 0] for c in cols])
                            ).reshape(dA.shape)


def _kernel_arithmetic(x, dt, A, B, C, Q, mm=mm_3xtf32, cumsum=hi_lo_cumsum):
    """(y_intra, states, decay_log) as the two kernels compute them; ``mm``
    and ``cumsum`` replace their products or their seg (a ``cumsum`` that
    returns one fp32 seg stands for the pair (seg, 0))."""
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc, rep = s // Q, H // G
    Bc = B.reshape(b, nc, Q, G, N).transpose(2, 3)                  # [b, nc, G, Q, N]
    Cc = C.reshape(b, nc, Q, G, N).transpose(2, 3)
    S = mm(Cc, Bc.transpose(-1, -2))                                # scores pass: once a group
    seg = cumsum((dt.reshape(b, nc, Q, H) * A).transpose(2, 3))     # [b, nc, H, Q]
    hi, lo = seg if isinstance(seg, tuple) else (seg, torch.zeros_like(seg))
    total, total_lo = hi[..., -1], lo[..., -1]
    rel = (hi[..., :, None] - hi[..., None, :]) + (lo[..., :, None] - lo[..., None, :])
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()
    L = torch.where(causal, torch.exp2(rel * torch.tensor(LOG2E)), 0.0)   # ex2.approx
    X = (x.reshape(b, nc, Q, H, P) * dt.reshape(b, nc, Q, H, 1)).transpose(2, 3)
    y = mm(S.repeat_interleave(rep, dim=2) * L, X)                  # [b, nc, H, Q, P]
    w = torch.exp((total[..., None] - hi) + (total_lo[..., None] - lo))
    Bw = Bc.repeat_interleave(rep, dim=2) * w[..., None]            # [b, nc, H, Q, N]
    states = mm(Bw.transpose(-1, -2), X)                            # [b, nc, H, N, P]
    return y.transpose(2, 3).reshape(b, s, H, P), states, total


def _exact(x, dt, A, B, C, Q):
    """(y_intra, states, decay_log) of the formula evaluated in fp64 with
    numpy, from the definition: seg = cumsum(dt A) within the chunk, y_i =
    sum_{j <= i} (C_i . B_j) e^(seg_i - seg_j) dt_j x_j, states = sum_j
    e^(total - seg_j) B_j^T dt_j x_j, total = seg[-1]."""
    x, dt, A, B, C = (np.asarray(a, np.float64) for a in (x, dt, A, B, C))
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc, rep = s // Q, H // G
    xc, dtc = x.reshape(b, nc, Q, H, P), dt.reshape(b, nc, Q, H)
    Bh = np.repeat(B.reshape(b, nc, Q, G, N), rep, axis=3)          # [b, nc, Q, H, N]
    Ch = np.repeat(C.reshape(b, nc, Q, G, N), rep, axis=3)
    seg = np.cumsum(dtc * A, axis=2)                                # [b, nc, Q, H]
    causal = np.tril(np.ones((Q, Q), bool))[None, None, :, :, None]
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]             # [b, nc, i, j, H]
    L = np.where(causal, np.exp(np.where(causal, rel, 0.0)), 0.0)
    S = np.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    y = np.einsum("bcijh,bcjhp->bcihp", S * L * dtc[:, :, None, :, :], xc)
    total = seg[:, :, -1, :]
    w = np.exp(total[:, :, None, :] - seg) * dtc                    # [b, nc, Q, H]
    states = np.einsum("bcjhn,bcjh,bcjhp->bchnp", Bh, w, xc)
    return y.reshape(b, s, H, P), states, total


def _inputs(seed, b, s, H, P, G, N):
    """As ``_ssd_inputs`` in tests/test_kernels.py: dt = softplus(normal),
    A = -exp(0.3 normal)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, H, P), np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, H)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, s, G, N), np.float32)
    C = rng.standard_normal((b, s, G, N), np.float32)
    return x, dt, A, B, C


def _worst(got, want):
    """The largest |got - want| / (atol + rtol |want|) over the outputs:
    at most 1 inside the tolerance."""
    return max(float(np.max(np.abs(g.numpy() - np.asarray(w)) / (TOL + TOL * np.abs(w))))
               for g, w in zip(got, want))


def _pallas(arrays, chunk):
    return ssd_chunk_pallas(*(jnp.asarray(a) for a in arrays), chunk, interpret=True)


@pytest.mark.parametrize("b,s,H,P,G,N,chunk", [
    (2, 32, 8, 16, 1, 16, 8),       # chunk 8, the reduced configs
    (1, 200, 4, 16, 1, 8, 200),     # chunk 200, not a tile multiple
    (1, 64, 4, 32, 2, 16, 16),      # two groups
    (1, 96, 4, 16, 4, 8, 16),       # four groups, P 16
    (1, 64, 4, 4, 1, 12, 16),       # N and P below one mma tile
    (1, 16, 4, 16, 1, 8, 1),        # a chunk of one position
])
def test_partition_matches_pallas(b, s, H, P, G, N, chunk):
    arrays = _inputs(17, b, s, H, P, G, N)
    got = _kernel_arithmetic(*(torch.from_numpy(a) for a in arrays), chunk)
    nc = s // chunk
    assert [tuple(t.shape) for t in got] == [(b, s, H, P), (b, nc, H, N, P), (b, nc, H)]
    for ours, ref in zip(got, _pallas(arrays, chunk)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


SERVING = [(1, 512, 2, 64, 1, 128, 256),    # mamba2-2.7b's widths, two heads
           (1, 512, 2, 64, 1, 64, 256)]     # zamba2-2.7b's state


@pytest.mark.parametrize("b,s,H,P,G,N,chunk", SERVING)
def test_partition_at_serving_widths_matches_pallas(b, s, H, P, G, N, chunk):
    """At chunk 256 the products and the partition, with seg summed as the
    Pallas body sums it (see the next test for why)."""
    arrays = _inputs(17, b, s, H, P, G, N)
    got = _kernel_arithmetic(*(torch.from_numpy(a) for a in arrays), chunk,
                             cumsum=pallas_cumsum)
    for ours, ref in zip(got, _pallas(arrays, chunk)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("b,s,H,P,G,N,chunk", SERVING)
def test_serving_widths_over_seeds_match_pallas(b, s, H, P, G, N, chunk, seed):
    """The serving widths over further draws of the inputs: the margin is
    not a property of one seed."""
    arrays = _inputs(seed, b, s, H, P, G, N)
    got = _kernel_arithmetic(*(torch.from_numpy(a) for a in arrays), chunk,
                             cumsum=pallas_cumsum)
    assert _worst(got, _pallas(arrays, chunk)) < 0.5


@pytest.mark.parametrize("b,s,H,P,G,N,chunk", SERVING)
def test_serving_width_gap_is_the_cumsum_order(b, s, H, P, G, N, chunk):
    """At chunk 256 seg reaches about -190, where an fp32 ulp is 1.5e-5, and
    y's terms of up to ~50 carry exp(seg_i - seg_j): two fp32 sums of seg in
    different orders (in sequence, as the kernels once summed it, and as
    the Pallas body sums it) put y more than the tolerance apart, with the
    same exact fp32 products. That gap is seg's and not the split's: with
    any seg, either fp32 order or the kernels' pair, the 3xTF32 products
    stay within half the tolerance of exact fp32 products on the same seg,
    and with seg summed as the Pallas body sums it they are within half
    the tolerance of the Pallas kernel."""
    arrays = _inputs(17, b, s, H, P, G, N)
    inputs = [torch.from_numpy(a) for a in arrays]
    exact = {}
    for cumsum in (sequential_cumsum, pallas_cumsum, hi_lo_cumsum):
        exact[cumsum] = _kernel_arithmetic(*inputs, chunk, mm=torch.matmul, cumsum=cumsum)
        split = _kernel_arithmetic(*inputs, chunk, cumsum=cumsum)
        assert _worst(split, [e.numpy() for e in exact[cumsum]]) < 0.5
        if cumsum is pallas_cumsum:
            assert _worst(split, _pallas(arrays, chunk)) < 0.5
    assert _worst(exact[sequential_cumsum], [e.numpy() for e in exact[pallas_cumsum]]) > 1.0


SEEDS = [0, 1, 2, 17, *range(100, 108)]


@functools.lru_cache(maxsize=None)
def _references(shape, seed):
    """The inputs of one draw at a serving shape, ``_exact`` on them, the
    Pallas kernel's outputs and its share of the tolerance against
    ``_exact``."""
    arrays = _inputs(seed, *shape[:6])
    exact = _exact(*arrays, shape[6])
    pallas = [np.asarray(p) for p in _pallas(arrays, shape[6])]
    return arrays, exact, pallas, _worst([torch.from_numpy(p) for p in pallas], exact)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SERVING)
def test_serving_widths_hold_the_exact_function(shape, seed):
    """At chunk 256 the kernels' arithmetic (3xTF32 products, seg as the
    pair hi + lo) lies within half the tolerance of the formula in fp64,
    and no further from the Pallas kernel than the Pallas kernel lies from
    the formula, plus 0.25: the kernels are held to the exact function at
    the unchanged 1e-4, and to the Pallas kernel within its own error."""
    arrays, exact, pallas, pallas_share = _references(shape, seed)
    got = _kernel_arithmetic(*(torch.from_numpy(a) for a in arrays), shape[6])
    assert _worst(got, exact) < 0.5
    assert _worst(got, pallas) < pallas_share + 0.25


def test_one_fp32_seg_misses_the_exact_function():
    """The fault the pair repairs: with seg one fp32 summed in sequence, as
    the kernels summed it before, the same arithmetic lies more than the
    tolerance from the formula in fp64 on at least one draw at a serving
    shape, where the pair stays under half of it (the test above)."""
    worst = 0.0
    for shape in SERVING:
        for seed in SEEDS:
            arrays, exact, _, _ = _references(shape, seed)
            got = _kernel_arithmetic(*(torch.from_numpy(a) for a in arrays), shape[6],
                                     cumsum=sequential_cumsum)
            worst = max(worst, _worst(got, exact))
            if worst > 1.0:
                return
    pytest.fail(f"one fp32 seg stays within {worst:.3f} of the tolerance of fp64")


def test_chained_k_steps_drift_further():
    """Summing every k-step's products into one running accumulator on the
    tensor cores (each sum cut toward zero) drifts further from exact fp32
    products than summing each k-step from zero and the k-steps in fp32,
    as the kernels do: the chain's drift grows with the chunk's 32
    k-steps."""
    arrays = _inputs(17, 1, 512, 2, 64, 1, 128)
    inputs = [torch.from_numpy(a) for a in arrays]
    exact = [e.numpy() for e in _kernel_arithmetic(*inputs, 256, mm=torch.matmul)]
    split = _worst(_kernel_arithmetic(*inputs, 256), exact)
    chained = _worst(_kernel_arithmetic(
        *inputs, 256, mm=lambda a, b: mm_3xtf32(a, b, chain=True)), exact)
    assert chained > 1.5 * split


def test_tc_sum_aligns_and_cuts_toward_zero():
    """``tc_sum`` on chosen values: a product of 1.5 ulp of the accumulator
    is cut to 1 ulp (rounding to nearest would give 2), either sign; three
    terms of 1 + 2^-23 add exactly to 3 + 1.5 ulp of the result's binade
    and are cut to 3 + 1 ulp; all-zero terms give 0."""
    ulp = 2.0 ** -23
    one = torch.tensor([[1.0]])
    prods = torch.zeros(1, K_STEP, 1)
    prods[0, 0, 0] = 1.5 * ulp
    assert tc_sum(prods, one).item() == 1 + ulp
    assert tc_sum(-prods, -one).item() == -(1 + ulp)
    prods[0, :2, 0] = 1 + ulp
    assert tc_sum(prods, one + ulp).item() == 3 + 2 * ulp
    assert tc_sum(torch.zeros(1, K_STEP, 1), torch.zeros(1, 1)).item() == 0.0


def test_one_tf32_pass_misses_the_tolerance():
    """At Q 256 and N 128 one TF32 pass (10-bit mantissas) is far outside
    atol = rtol = 1e-4 of the Pallas kernel, and the 3xTF32 split well
    inside it (seg summed as the Pallas body sums it on both): the split is
    what keeps the kernels at fp32's tolerance."""
    arrays = _inputs(19, 1, 512, 2, 64, 1, 128)
    want = _pallas(arrays, 256)
    inputs = [torch.from_numpy(a) for a in arrays]
    one_pass = _worst(_kernel_arithmetic(*inputs, 256, mm=mm_tf32, cumsum=pallas_cumsum), want)
    split = _worst(_kernel_arithmetic(*inputs, 256, cumsum=pallas_cumsum), want)
    assert one_pass > 10.0
    assert split < 0.5


def test_tf32_rounds_to_nearest_ties_away():
    """``tf32`` on chosen bit patterns: below half an ulp (2^-10 at 1.0)
    rounds down, half rounds away from zero, either sign; the result has
    its 13 low bits clear."""
    ulp = 2.0 ** -10
    v = torch.tensor([1 + 0.49 * ulp, 1 + 0.5 * ulp, -(1 + 0.5 * ulp), 1 + 1.5 * ulp, 3.0],
                     dtype=torch.float32)
    assert tf32(v).tolist() == [1.0, 1 + ulp, -(1 + ulp), 1 + 2 * ulp, 3.0]
    bits = tf32(torch.randn(1000, generator=torch.Generator().manual_seed(0))).numpy()
    assert not np.any(bits.view(np.uint32) & 0x1FFF)
