"""The port's SSD scan against the JAX package's, on the CPU.

``ref_ssd_chunk`` (the ``ssd_chunk`` kernel's plain version) against the
Pallas kernel ``ssd_chunk_pallas`` in interpret mode on all three
outputs; ``ref_ssd`` against JAX's ``ref_ssd``; ``ssd_scan_op`` against
``ssd_chunked`` and the Pallas-backed ``ssd_scan_op``, with ragged
lengths, an initial state and the final state. Inputs are numpy draws
shaped as ``_ssd_inputs`` in tests/test_kernels.py; the tolerance is
that file's (atol = rtol = 1e-4: both sides compute in fp32 and differ in
the order of sums and in how seg = cumsum(dt*A) is kept: the Pallas
kernel sums it in fp32 with ``jnp.cumsum``, the port exactly, as an fp32
pair hi + lo, ``seg_hi_lo``). At the serving chunk of 256, where the
Pallas kernel itself lies up to 2.6x the tolerance from the formula in
fp64, ``ref_ssd_chunk`` is held to its fp64 evaluation (``exact=True``)
and to the Pallas kernel within the Pallas kernel's own error. The CUDA
kernel against ``ref_ssd_chunk`` is in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import ssd_scan_op as jax_ssd_scan_op
from repro.kernels.ref import ref_ssd as jax_ref_ssd
from repro.kernels.ssd_scan import ssd_chunk_pallas
from repro.models.mamba2 import ssd_chunked
from repro_torch.kernels import LAUNCHES, ssd_scan_op
from repro_torch.kernels.ref import ref_ssd, ref_ssd_chunk, seg_hi_lo
from repro_torch.kernels.ssd_scan import ssd_chunk

TOL = 1e-4

SHAPES = [   # b, s, H, P, G, N, chunk: tests/test_kernels.py:68-73 and 84-90
    (1, 64, 2, 16, 1, 8, 16),
    (2, 128, 4, 32, 2, 16, 32),
    (1, 96, 4, 16, 4, 8, 16),     # non-power-of-two chunk count
    (1, 64, 8, 64, 1, 32, 64),    # single group, wide head
    (2, 64, 4, 16, 2, 8, 16),
    (2, 64, 4, 16, 2, 8, 32),
]


def _inputs(seed, b, s, H, P, G, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, H, P), np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, H)), 0).astype(np.float32)   # softplus
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, s, G, N), np.float32)
    C = rng.standard_normal((b, s, G, N), np.float32)
    return x, dt, A, B, C


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(ours, ref):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref, np.float32),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,s,H,P,G,N,chunk", SHAPES)
def test_ref_ssd_chunk_vs_pallas(b, s, H, P, G, N, chunk):
    arrays = _inputs(0, b, s, H, P, G, N)
    want = ssd_chunk_pallas(*_j(arrays), chunk, interpret=True)
    got = ref_ssd_chunk(*_t(arrays), chunk)
    nc = s // chunk
    assert [tuple(t.shape) for t in got] == [(b, s, H, P), (b, nc, H, N, P), (b, nc, H)]
    assert all(t.dtype == torch.float32 for t in got)
    for ours, ref in zip(got, want):
        _close(ours, ref)


def _share(got, want):
    """The largest |got - want| / (atol + rtol |want|) over the outputs."""
    return max(float(np.max(np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64))
                            / (TOL + TOL * np.abs(np.asarray(w, np.float64)))))
               for g, w in zip(got, want))


@pytest.mark.parametrize("b,s,H,P,G,N,chunk", SHAPES)
def test_ref_ssd_chunk_exact_vs_pallas(b, s, H, P, G, N, chunk):
    """``exact=True`` evaluates the same formula in fp64 and returns fp64;
    at these chunks the Pallas kernel is within 1e-4 of it."""
    arrays = _inputs(0, b, s, H, P, G, N)
    got = ref_ssd_chunk(*_t(arrays), chunk, exact=True)
    assert all(t.dtype == torch.float64 for t in got)
    for ours, ref in zip(got, ssd_chunk_pallas(*_j(arrays), chunk, interpret=True)):
        _close(ours, ref)


@pytest.mark.parametrize("seed", [0, 17, 103])
@pytest.mark.parametrize("N", [128, 64])      # mamba2-2.7b's and zamba2-2.7b's state
def test_ref_ssd_chunk_at_the_serving_chunk(N, seed):
    """At chunk 256 the plain version lies within half the tolerance of the
    formula in fp64, and no further from the Pallas kernel than the Pallas
    kernel lies from the formula, plus 0.25."""
    arrays = _inputs(seed, 1, 512, 2, 64, 1, N)
    exact = [t.numpy() for t in ref_ssd_chunk(*_t(arrays), 256, exact=True)]
    pallas = [np.asarray(t) for t in ssd_chunk_pallas(*_j(arrays), 256, interpret=True)]
    got = [t.numpy() for t in ref_ssd_chunk(*_t(arrays), 256)]
    assert _share(got, exact) < 0.5
    assert _share(got, pallas) < _share(pallas, exact) + 0.25


def test_seg_hi_lo_is_the_exact_sum():
    """hi + lo is the fp64 sum of the fp32 terms whatever their order, hi
    is that sum rounded to fp32 and lo the rounding of the rest (at most
    half an fp32 ulp of hi); a running sum in fp32 differs from hi."""
    rng = np.random.default_rng(5)
    dA = torch.from_numpy((-np.logaddexp(rng.standard_normal((3, 256, 4)), 0)
                           * np.exp(0.3 * rng.standard_normal(4))).astype(np.float32))
    hi, lo = seg_hi_lo(dA, dim=1)
    assert hi.dtype == lo.dtype == torch.float32 and hi.shape == lo.shape == dA.shape
    exact = torch.cumsum(dA.double(), dim=1)
    backward = torch.flip(torch.cumsum(torch.flip(dA.double(), [1]), dim=1), [1])
    total = backward[:, 0]                         # the same sum, in the other order
    assert torch.equal(hi[:, -1], total.float())
    assert torch.equal(hi, exact.float())
    assert torch.allclose(hi.double() + lo.double(), exact, rtol=1e-15, atol=0)
    half_ulp = torch.nextafter(hi.abs(), torch.full_like(hi, np.inf)).double() - hi.abs().double()
    assert torch.all(lo.double().abs() <= half_ulp / 2)
    assert hi.min() < -150                         # the serving chunk's range
    running, acc = torch.empty_like(dA), torch.zeros_like(dA[:, 0])
    for i in range(dA.shape[1]):
        acc = acc + dA[:, i]
        running[:, i] = acc
    assert not torch.equal(running, hi)


def test_ref_ssd_chunk_refuses_a_ragged_length():
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ref_ssd_chunk(*_t(_inputs(0, 1, 40, 2, 16, 1, 8)), 16)


@pytest.mark.parametrize("b,s,H,P,G,N,chunk", SHAPES[:4])
@pytest.mark.parametrize("with_init", [False, True])
def test_ref_ssd_vs_jax(b, s, H, P, G, N, chunk, with_init):
    arrays = _inputs(1, b, s, H, P, G, N)
    init = (np.random.default_rng(2).standard_normal((b, H, P, N), np.float32)
            if with_init else None)
    jy, jh = jax_ref_ssd(*_j(arrays), initial_state=None if init is None else jnp.asarray(init),
                         return_state=True)
    y, h = ref_ssd(*_t(arrays), initial_state=None if init is None else torch.from_numpy(init),
                   return_state=True)
    _close(y, jy)
    _close(h, jh)
    if init is None:
        np.testing.assert_array_equal(ref_ssd(*_t(arrays)).numpy(), y.numpy())


@pytest.mark.parametrize("b,s,H,P,G,N,chunk", SHAPES)
def test_ssd_scan_op_vs_jax(b, s, H, P, G, N, chunk):
    """Against ssd_chunked (final state too) and the Pallas-backed scan."""
    arrays = _inputs(3, b, s, H, P, G, N)
    jy, jh = ssd_chunked(*_j(arrays), chunk, return_state=True)
    pallas = jax_ssd_scan_op(*_j(arrays), chunk, use_pallas="interpret")
    y, h = ssd_scan_op(*_t(arrays), chunk, return_state=True)
    assert y.shape == (b, s, H, P) and h.shape == (b, H, P, N)
    _close(y, jy)
    _close(y, pallas)
    _close(h, jh)
    _close(ssd_scan_op(*_t(arrays), chunk), jy)


@pytest.mark.parametrize("s,chunk", [(50, 16), (7, 8), (100, 32), (33, 64)])
def test_ssd_scan_op_pads_a_ragged_length(s, chunk):
    """A ragged s is padded with dt = 0 steps, as ssd_chunked does, and
    equals the sequential recurrence too."""
    arrays = _inputs(4, 2, s, 4, 16, 2, 8)
    jy, jh = ssd_chunked(*_j(arrays), chunk, return_state=True)
    y, h = ssd_scan_op(*_t(arrays), chunk, return_state=True)
    assert y.shape == (2, s, 4, 16)
    _close(y, jy)
    _close(h, jh)
    ry, rh = ref_ssd(*_t(arrays), return_state=True)
    _close(y, ry)
    _close(h, rh)


@pytest.mark.parametrize("split,chunk", [(32, 16), (24, 16), (40, 8)])
def test_ssd_initial_state_chaining(split, chunk):
    """The twin of tests/test_kernels.py:93-104: two halves with the state
    carried equal the whole sequence, here also at split points that are
    not chunk multiples; and the port's chained halves equal JAX's."""
    x, dt, A, B, C = _inputs(5, 1, 64, 2, 16, 1, 8)
    halves = [[a[:, :split] for a in (x, dt)] + [A] + [a[:, :split] for a in (B, C)],
              [a[:, split:] for a in (x, dt)] + [A] + [a[:, split:] for a in (B, C)]]
    y_full, h_full = ssd_scan_op(*_t((x, dt, A, B, C)), chunk, return_state=True)
    y1, h1 = ssd_scan_op(*_t(halves[0]), chunk, return_state=True)
    y2, h2 = ssd_scan_op(*_t(halves[1]), chunk, initial_state=h1, return_state=True)
    _close(torch.cat([y1, y2], dim=1), y_full)
    _close(h2, h_full)
    jy1, jh1 = ssd_chunked(*_j(halves[0]), chunk, return_state=True)
    jy2, jh2 = ssd_chunked(*_j(halves[1]), chunk, initial_state=jh1, return_state=True)
    _close(y2, jy2)
    _close(h2, jh2)


def test_ssd_scan_op_reads_strided_views():
    """The model hands views into its projections: the same numbers as
    contiguous inputs."""
    b, s, H, P, G, N = 2, 32, 4, 16, 2, 8
    x, dt, A, B, C = _t(_inputs(6, b, s, H, P, G, N))
    wide = torch.cat([x.reshape(b, s, H * P), B.reshape(b, s, G * N),
                      C.reshape(b, s, G * N)], dim=-1)
    views = (wide[..., :H * P].reshape(b, s, H, P), dt, A,
             wide[..., H * P:H * P + G * N].reshape(b, s, G, N),
             wide[..., H * P + G * N:].reshape(b, s, G, N))
    assert not views[0].is_contiguous() and not views[3].is_contiguous()
    for got, want in zip(ref_ssd_chunk(*views, 8), ref_ssd_chunk(x, dt, A, B, C, 8)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(ssd_scan_op(*views, 8).numpy(),
                                  ssd_scan_op(x, dt, A, B, C, 8).numpy())


def test_ssd_scan_op_cpu_goes_to_plain_version():
    before = dict(LAUNCHES)
    ssd_scan_op(*_t(_inputs(7, 1, 32, 2, 16, 1, 8)), 8)
    assert LAUNCHES == before


def test_ssd_chunk_refuses_cpu_tensors():
    """The kernel wrapper never falls back to the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk(*_t(_inputs(8, 1, 16, 2, 16, 1, 8)), 8)
