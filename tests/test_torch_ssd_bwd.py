"""The SSD chunk backward on the CPU.

``ref_ssd_chunk_bwd`` (the ``ssd_chunk_bwd`` kernel's plain version, by
explicit formulas) against torch autograd of ``ref_ssd_chunk(exact=True)``
in fp64; ``ssd_scan_op``'s gradients, through ``SsdChunk`` and its plain
backward, against ``jax.vjp`` of ``repro.models.mamba2.ssd_chunked``; and
at the serving and training chunk of 256, where the JAX reference's
gradients of dt and A are not finite (it exponentiates before it masks,
mamba2.py:112), the port's against the recurrence in fp64. Inputs are
numpy draws shaped as ``_ssd_inputs`` in tests/test_kernels.py. The CUDA
kernel against ``ref_ssd_chunk_bwd`` is in test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked
from repro_torch.kernels import LAUNCHES, ssd_scan_op
from repro_torch.kernels.ref import ref_ssd_chunk, ref_ssd_chunk_bwd, seg_hi_lo
from repro_torch.kernels.ssd_scan import SsdChunk

TOL = 1e-4        # of each gradient's largest |value|, or atol = rtol as tests/test_torch_ssd.py
NAMES = ("x", "dt", "A", "B", "C")


def _inputs(seed, b, s, H, P, G, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, H, P), np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, H)), 0).astype(np.float32)   # softplus
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, s, G, N), np.float32)
    C = rng.standard_normal((b, s, G, N), np.float32)
    return x, dt, A, B, C


def _upstream(seed, b, s, H, P, N, nc, gdecay=True):
    rng = np.random.default_rng(seed)
    gy = rng.standard_normal((b, s, H, P), np.float32)
    gs = rng.standard_normal((b, nc, H, N, P), np.float32)
    gd = (rng.standard_normal((b, nc, H), np.float32) if gdecay
          else np.zeros((b, nc, H), np.float32))
    return [torch.from_numpy(a) for a in (gy, gs, gd)]


def _of_largest(got, want):
    """max |got - want| / max |want|, in fp64."""
    got, want = torch.as_tensor(np.asarray(got)).double(), torch.as_tensor(np.asarray(want)).double()
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("b,s,H,P,G,N,chunk", [
    (2, 64, 4, 16, 1, 8, 8),
    (1, 128, 4, 16, 2, 16, 64),
    (1, 512, 4, 16, 1, 16, 256),
    (1, 512, 4, 32, 2, 32, 256),
])
@pytest.mark.parametrize("exact", [False, True])
def test_ref_ssd_chunk_bwd_matches_fp64_autograd(b, s, H, P, G, N, chunk, exact):
    """Both arithmetics within 1e-4 of each gradient's largest |value| of
    autograd through the forward in fp64, with a nonzero gdecay; at chunk
    256 too, where seg spans ~190 and every product of L's exponent would
    overflow above the diagonal."""
    ins = [torch.from_numpy(a) for a in _inputs(0, b, s, H, P, G, N)]
    ups = _upstream(1, b, s, H, P, N, s // chunk)
    leaves = [t.double().requires_grad_() for t in ins]
    want = torch.autograd.grad(ref_ssd_chunk(*leaves, chunk, exact=True), leaves,
                               [u.double() for u in ups])
    got = ref_ssd_chunk_bwd(*ins, chunk, *ups, exact=exact)
    for name, g, w, t in zip(NAMES, got, want, ins):
        assert g.shape == t.shape and g.dtype == (torch.float64 if exact else torch.float32)
        assert torch.isfinite(w).all()
        assert _of_largest(g, w) <= (1e-12 if exact else TOL), f"g{name}"


def test_ref_ssd_chunk_masks_before_exp():
    """The forward is the where-after-exp formula bit for bit, and its fp32
    autograd is finite at chunk 256, where exp taken before the mask
    overflows above the diagonal (0 * inf = NaN in the gradient)."""
    ins = [torch.from_numpy(a) for a in _inputs(2, 1, 512, 4, 16, 1, 16)]
    x, dt, A, B, C = ins
    hi, lo = seg_hi_lo((dt * A).reshape(1, 2, 256, 4), dim=2)
    rel = (hi[:, :, :, None] - hi[:, :, None]) + (lo[:, :, :, None] - lo[:, :, None])
    assert torch.isinf(torch.exp(rel)).any()
    causal = torch.ones((256, 256), dtype=torch.bool).tril()[None, None, :, :, None]
    L = torch.where(causal, torch.exp(rel), 0.0)
    Bh, Ch = (t.reshape(1, 2, 256, 1, 16).expand(1, 2, 256, 4, 16) for t in (B, C))
    u = x.reshape(1, 2, 256, 4, 16) * dt.reshape(1, 2, 256, 4, 1)
    y = torch.einsum("bcqkh,bckhp->bcqhp", torch.einsum("bcqhn,bckhn->bcqkh", Ch, Bh) * L, u)
    assert torch.equal(ref_ssd_chunk(*ins, 256)[0], y.reshape(1, 512, 4, 16))
    leaves = [t.clone().requires_grad_() for t in ins]
    grads = torch.autograd.grad(sum(o.sum() for o in ref_ssd_chunk(*leaves, 256)), leaves)
    assert all(torch.isfinite(g).all() for g in grads)


def test_ssd_chunk_function_on_cpu_is_the_plain_pair():
    """On CPU tensors ``SsdChunk`` runs ``ref_ssd_chunk`` forward and
    ``ref_ssd_chunk_bwd`` backward, with no kernel launch."""
    ins = [torch.from_numpy(a) for a in _inputs(3, 2, 64, 4, 16, 2, 8)]
    ups = _upstream(4, 2, 64, 4, 16, 8, 4)
    leaves = [t.clone().requires_grad_() for t in ins]
    before = dict(LAUNCHES)
    out = SsdChunk.apply(*leaves, 16)
    for o, r in zip(out, ref_ssd_chunk(*ins, 16)):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    got = torch.autograd.grad(out, leaves, ups)
    for g, w in zip(got, ref_ssd_chunk_bwd(*ins, 16, *ups)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert LAUNCHES == before


def _jax_vjp(arrays, init, chunk, gy, gh):
    """Gradients of ssd_chunked (x, dt, A, B, C, initial state) by jax.vjp."""
    def f(x, dt, A, B, C, h0):
        return ssd_chunked(x, dt, A, B, C, chunk, initial_state=h0, return_state=True)

    @jax.jit
    def grads(args, cotangents):
        return jax.vjp(f, *args)[1](cotangents)
    args = tuple(jnp.asarray(a) for a in (*arrays, init))
    return [np.asarray(g) for g in grads(args, (jnp.asarray(gy), jnp.asarray(gh)))]


def _port_grads(arrays, init, chunk, gy, gh):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (*arrays, init)]
    y, h = ssd_scan_op(*leaves[:5], chunk, initial_state=leaves[5], return_state=True)
    return [g.numpy() for g in torch.autograd.grad((y, h), leaves,
                                                   (torch.from_numpy(gy), torch.from_numpy(gh)))]


@pytest.mark.parametrize("b,s,H,P,G,N,chunk", [
    (2, 64, 4, 16, 1, 8, 8),
    (2, 128, 4, 32, 2, 16, 32),
    (1, 192, 4, 16, 1, 16, 64),
    (2, 100, 4, 16, 2, 8, 32),      # ragged: 100 = 3 chunks of 32 + 4
    (1, 50, 2, 16, 1, 8, 64),       # ragged, shorter than one chunk
])
def test_ssd_scan_op_grads_match_jax_vjp(b, s, H, P, G, N, chunk):
    """Every gradient of the scan (x, dt, A, B, C and the initial state),
    through ``SsdChunk``'s plain backward and autograd of the carry, within
    atol = rtol = 1e-4 of ``jax.vjp`` of ``ssd_chunked`` (whose own
    gradients are finite at these chunks)."""
    arrays = _inputs(5, b, s, H, P, G, N)
    rng = np.random.default_rng(6)
    init = rng.standard_normal((b, H, P, N), np.float32)
    gy = rng.standard_normal((b, s, H, P), np.float32)
    gh = rng.standard_normal((b, H, P, N), np.float32)
    want = _jax_vjp(arrays, init, chunk, gy, gh)
    assert all(np.isfinite(w).all() for w in want)
    got = _port_grads(arrays, init, chunk, gy, gh)
    for name, g, w in zip(NAMES + ("h0",), got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=f"g{name}")


def _recurrence64(x, dt, A, B, C, h0):
    """The SSD recurrence in fp64 (y and the final state), for autograd."""
    b, s, H, P = x.shape
    rep = H // B.shape[2]
    Bh, Ch = B.repeat_interleave(rep, dim=2), C.repeat_interleave(rep, dim=2)
    h, ys = h0, []
    for t in range(s):
        h = (h * torch.exp(dt[:, t] * A)[:, :, None, None]
             + torch.einsum("bhp,bhn,bh->bhpn", x[:, t], Bh[:, t], dt[:, t]))
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, dim=1), h


def test_ssd_scan_op_grads_at_chunk_256_match_fp64():
    """At chunk 256 every gradient of the scan is finite and within 1e-4 of
    each one's largest |value| of autograd through the recurrence in fp64.
    The known difference pinned beside it: there the JAX reference's
    gradients of dt and A are not finite (mamba2.py:112 takes exp before
    the mask; the port masks first), while its x gradient is."""
    b, s, H, P, G, N = 1, 512, 4, 16, 1, 16
    arrays = _inputs(7, b, s, H, P, G, N)
    rng = np.random.default_rng(8)
    init = rng.standard_normal((b, H, P, N), np.float32)
    gy = rng.standard_normal((b, s, H, P), np.float32)
    gh = rng.standard_normal((b, H, P, N), np.float32)
    got = _port_grads(arrays, init, 256, gy, gh)
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in (*arrays, init)]
    want = torch.autograd.grad(_recurrence64(*leaves), leaves,
                               (torch.from_numpy(gy).double(), torch.from_numpy(gh).double()))
    for name, g, w in zip(NAMES + ("h0",), got, want):
        assert np.isfinite(g).all(), f"g{name}"
        assert _of_largest(g, w.numpy()) <= TOL, f"g{name}"
    jax_grads = _jax_vjp(arrays, init, 256, gy, gh)
    assert np.isfinite(jax_grads[0]).all()
    assert not np.isfinite(jax_grads[1]).all() and not np.isfinite(jax_grads[2]).all()
