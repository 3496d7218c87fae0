"""The attention backward's plain version (``ref_attention_bwd``) against
JAX's autodiff of ``repro.kernels.ref.ref_attention`` and torch's
autograd of the port's ``ref_attention``; ``FlashAttention`` on the CPU;
and the rule that no gradient stops silently at a kernel on the card
(checked here with the device checks patched and the kernels replaced by
their plain versions): attention and the SSD scan carry gradients through
their backward kernels, decode raises."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ref_attention as jax_ref_attention
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.ref import ref_attention, ref_attention_bwd, ref_ssd

TOL = 2e-5        # fp32, as tests/test_kernels.py holds the forward

# tests/test_kernels.py's sweep (b, h, kvh, sq, skv, d, window), then a
# window of 32 and fewer queries than keys (the query offset skv - sq)
CASES = [
    (1, 4, 4, 128, 128, 64, 0),
    (2, 8, 2, 256, 256, 64, 0),
    (1, 6, 2, 128, 128, 128, 0),
    (1, 4, 1, 384, 384, 32, 0),
    (1, 4, 2, 256, 256, 64, 32),
    (2, 6, 2, 72, 200, 32, 0),
]


def _inputs(b, h, kvh, sq, skv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, skv, d)).astype(np.float32)
    dO = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    return q, k, v, dO


def _plain_bwd(q, k, v, dO, window):
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = ref_attention(qt, kt, vt, window=window, return_lse=True)
    return ref_attention_bwd(qt, kt, vt, o, lse, torch.from_numpy(dO), window=window)


@pytest.mark.parametrize("b,h,kvh,sq,skv,d,window", CASES)
def test_ref_attention_bwd_matches_jax_vjp(b, h, kvh, sq, skv, d, window):
    q, k, v, dO = _inputs(b, h, kvh, sq, skv, d)
    _, vjp = jax.vjp(lambda q, k, v: jax_ref_attention(q, k, v, window=window), q, k, v)
    want = vjp(jnp.asarray(dO))
    for name, got, w in zip("qkv", _plain_bwd(q, k, v, dO, window), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=TOL, rtol=TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("b,h,kvh,sq,skv,d,window", CASES)
def test_ref_attention_bwd_matches_torch_autograd(b, h, kvh, sq, skv, d, window):
    q, k, v, dO = _inputs(b, h, kvh, sq, skv, d, seed=1)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = ref_attention(qt, kt, vt, window=window)
    want = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(dO))
    for name, got, w in zip("qkv", _plain_bwd(q, k, v, dO, window), want):
        torch.testing.assert_close(got, w, atol=TOL, rtol=TOL, msg=f"d{name}")


def test_ref_attention_lse_is_the_rows_logsumexp():
    q, k, v, _ = _inputs(2, 6, 2, 72, 200, 32)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = ref_attention(qt, kt, vt, return_lse=True)
    torch.testing.assert_close(o, ref_attention(qt, kt, vt), rtol=0, atol=0)
    qpos = np.arange(72)[:, None] + 128
    s = np.einsum("bkgqd,bktd->bkgqt", q.reshape(2, 2, 3, 72, 32), k) / np.sqrt(32)
    s = np.where(np.arange(200)[None, :] <= qpos, s.astype(np.float64), -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want.reshape(2, 6, 72), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [0, 32])
def test_flash_attention_function_on_cpu_is_the_plain_pair(window):
    """On CPU tensors ``FlashAttention`` runs ``ref_attention`` (with its
    logsumexp) forward and ``ref_attention_bwd`` backward."""
    q, k, v, dO = _inputs(2, 6, 2, 72, 200, 32, seed=2)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = FlashAttention.apply(qt, kt, vt, True, window)
    torch.testing.assert_close(o, ref_attention(qt, kt, vt, window=window), rtol=0, atol=0)
    got = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(dO))
    for g, w in zip(got, _plain_bwd(q, k, v, dO, window)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ---------------------------------------------------------------------- #
# no gradient stops silently at a kernel
# ---------------------------------------------------------------------- #
@pytest.fixture
def as_if_on_card(monkeypatch):
    """The device checks of ``ops``, ``FlashAttention`` and ``SsdChunk``
    take every tensor for a CUDA tensor, and the kernels are their plain
    versions, counting their calls: the dispatch of the card, run on the
    CPU."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ref import ref_decode, ref_ssd_chunk, ref_ssd_chunk_bwd
    calls = []

    def counted(name, fn):
        def call(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        return call

    fwd = counted("flash_attention", ref_attention)
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(fa, "_on_card", lambda t: True)
    monkeypatch.setattr(ssd_scan, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "flash_attention", fwd)
    monkeypatch.setattr(fa, "flash_attention", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", counted("flash_attention_bwd", ref_attention_bwd))
    monkeypatch.setattr(ops, "flash_decode", ref_decode)
    monkeypatch.setattr(ssd_scan, "ssd_chunk", counted("ssd_chunk", ref_ssd_chunk))
    monkeypatch.setattr(ssd_scan, "ssd_chunk_bwd", counted("ssd_chunk_bwd", ref_ssd_chunk_bwd))
    return calls


def test_attention_op_on_card_carries_gradients(as_if_on_card):
    q, k, v, dO = _inputs(1, 4, 2, 16, 16, 16, seed=3)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = ops.attention_op(qt, kt, vt)
    got = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(dO))
    assert as_if_on_card == ["flash_attention", "flash_attention_bwd"]
    for g, w in zip(got, _plain_bwd(q, k, v, dO, 0)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with torch.no_grad():                      # serving: the forward kernel alone
        ops.attention_op(qt, kt, vt)
    assert as_if_on_card[2:] == ["flash_attention"]


def test_kernels_without_backward_raise_under_grad(as_if_on_card):
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 4, 1, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 2, 8, 16)).astype(np.float32))
    lengths = torch.tensor([8, 3], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="flash_decode has no backward"):
        ops.decode_attention_op(q.requires_grad_(), kv, kv, lengths)
    # without a gradient it runs, as serving does
    with torch.no_grad():
        assert ops.decode_attention_op(q, kv, kv, lengths).shape == (2, 4, 1, 16)
    assert ops.decode_attention_op(q.detach(), kv, kv, lengths).shape == (2, 4, 1, 16)


def test_ssd_scan_op_on_card_carries_gradients(as_if_on_card):
    """Under grad the scan runs ``SsdChunk``: the forward kernel, then the
    backward kernel, with the gradients of the plain pair; without a
    gradient the forward kernel alone."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 16, 4, 8)).astype(np.float32))
    dt = torch.full((1, 16, 4), 0.5)
    A = -torch.ones(4)
    B = torch.from_numpy(rng.standard_normal((1, 16, 1, 8)).astype(np.float32))
    gy = torch.from_numpy(rng.standard_normal((1, 16, 4, 8)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B)]
    got = torch.autograd.grad(ops.ssd_scan_op(*leaves, leaves[3], chunk=8), leaves, gy)
    assert as_if_on_card == ["ssd_chunk", "ssd_chunk_bwd"]
    plain = [t.clone().requires_grad_() for t in (x, dt, A, B)]
    want = torch.autograd.grad(ref_ssd(*plain, plain[3]), plain, gy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4 * w.abs().max().item(), rtol=0)
    with torch.no_grad():                      # serving: the forward kernel alone
        assert ops.ssd_scan_op(x, dt, A, B, B, chunk=8).shape == x.shape
    assert as_if_on_card[2:] == ["ssd_chunk"]
