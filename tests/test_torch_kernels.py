"""The port's kernels against the JAX package's.

On the CPU: the plain versions (``repro_torch.kernels.ref``) against the
JAX Pallas kernels in interpret mode and the JAX oracle, on the same
numpy inputs, with the sweeps and tolerances of tests/test_kernels.py
(the feasibility mask is integer and compared exactly). The CUDA kernels
against the plain versions are in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.feasibility import batched_feasible_op as jax_batched_feasible_op
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention import flash_decode as jax_flash_decode
from repro.kernels.ref import ref_attention as jax_ref_attention
from repro_torch.kernels import (LAUNCHES, attention_op, batched_feasible_op,
                                 decode_attention_op)
from repro_torch.kernels.feasibility import feasible_mask
from repro_torch.kernels.flash_attention import flash_attention, flash_decode
from repro_torch.kernels.ref import ref_attention, ref_decode, ref_feasible

# fp32: both sides sum in fp32 in another order; bf16: the inputs are the
# same bf16 values, the output is rounded to bf16 (tests/test_kernels.py:32)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(seed, b, h, kvh, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d), np.float32),
            rng.standard_normal((b, kvh, skv, d), np.float32),
            rng.standard_normal((b, kvh, skv, d), np.float32))


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _torch(a, dtype, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))


def _np(t):
    return np.asarray(t.float().cpu() if isinstance(t, torch.Tensor) else t,
                      np.float32)


@pytest.mark.parametrize("b,h,kvh,s,d", [
    (1, 4, 4, 128, 64),     # MHA
    (2, 8, 2, 256, 64),     # GQA 4:1
    (1, 6, 2, 128, 128),    # GQA 3:1, wide head
    (1, 4, 1, 384, 32),     # MQA, non-square block count
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_attention_vs_jax(b, h, kvh, s, d, dtype):
    q, k, v = _qkv(0, b, h, kvh, s, s, d)
    ours = ref_attention(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype))
    pallas = jax_flash_attention(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                                 interpret=True)
    oracle = jax_ref_attention(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype))
    assert ours.dtype == getattr(torch, dtype) and ours.shape == (b, h, s, d)
    for ref in (pallas, oracle):
        np.testing.assert_allclose(_np(ours), _np(ref), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("window", [32, 128])
def test_ref_attention_window_vs_jax(window):
    q, k, v = _qkv(1, 1, 4, 2, 256, 256, 64)
    ours = ref_attention(*(torch.from_numpy(a) for a in (q, k, v)), window=window)
    pallas = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 window=window, interpret=True)
    oracle = jax_ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               window=window)
    for ref in (pallas, oracle):
        np.testing.assert_allclose(_np(ours), _np(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("sq,skv,causal", [
    (200, 200, True),       # ragged length (no block multiple)
    (72, 200, True),        # query rows offset by skv - sq
    (50, 130, False),
])
def test_ref_attention_ragged_vs_jax_oracle(sq, skv, causal):
    q, k, v = _qkv(2, 2, 4, 2, sq, skv, 16)
    ours = ref_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    oracle = jax_ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal)
    np.testing.assert_allclose(_np(ours), _np(oracle), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,h,kvh,S,d,block_k", [
    (2, 8, 2, 256, 64, 128),
    (1, 4, 4, 512, 128, 128),
    (3, 6, 2, 256, 32, 64),
])
def test_ref_decode_vs_jax(b, h, kvh, S, d, block_k):
    """ref_decode == the Pallas flash_decode == full attention over each
    row's valid prefix."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, h, 1, d), np.float32)
    k = rng.standard_normal((b, kvh, S, d), np.float32)
    v = rng.standard_normal((b, kvh, S, d), np.float32)
    lengths = rng.integers(S // 4, S + 1, (b,)).astype(np.int32)
    ours = ref_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                      torch.from_numpy(lengths))
    pallas = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lengths), block_k=block_k, interpret=True)
    np.testing.assert_allclose(_np(ours), _np(pallas), atol=2e-5, rtol=2e-5)
    for i in range(b):
        L = int(lengths[i])
        oracle = jax_ref_attention(jnp.asarray(q[i:i + 1]), jnp.asarray(k[i:i + 1, :, :L]),
                                   jnp.asarray(v[i:i + 1, :, :L]), causal=False)
        np.testing.assert_allclose(_np(ours[i:i + 1]), _np(oracle), atol=2e-5, rtol=2e-5)


def test_ref_decode_reads_strided_cache_view():
    """The model hands ref_decode/flash_decode a [b, kvh, S, d] view of its
    [b, S, kvh, d] cache; the result equals that of a contiguous copy."""
    rng = np.random.default_rng(4)
    b, h, kvh, S, d = 2, 6, 2, 40, 16
    q = torch.from_numpy(rng.standard_normal((b, h, 1, d), np.float32))
    cache_k = torch.from_numpy(rng.standard_normal((b, S, kvh, d), np.float32))
    cache_v = torch.from_numpy(rng.standard_normal((b, S, kvh, d), np.float32))
    lengths = torch.tensor([17, 40], dtype=torch.int32)
    kv = cache_k.permute(0, 2, 1, 3), cache_v.permute(0, 2, 1, 3)
    assert not kv[0].is_contiguous()
    got = ref_decode(q, *kv, lengths)
    want = ref_decode(q, *(t.contiguous() for t in kv), lengths)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_ops_dispatch_cpu_to_plain_version():
    """CPU tensors go to the plain versions; no kernel is launched."""
    q, k, v = _qkv(5, 1, 4, 2, 64, 64, 32)
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    before = dict(LAUNCHES)
    np.testing.assert_array_equal(attention_op(q, k, v, window=16).numpy(),
                                  ref_attention(q, k, v, window=16).numpy())
    lengths = torch.tensor([30], dtype=torch.int32)
    qd = q[:, :, :1]
    np.testing.assert_array_equal(decode_attention_op(qd, k, v, lengths).numpy(),
                                  ref_decode(qd, k, v, lengths).numpy())
    assert LAUNCHES == before


@pytest.mark.parametrize("fn,args", [
    (flash_attention, ()),
    (flash_decode, (torch.ones(1, dtype=torch.int32),)),
])
def test_kernel_wrappers_refuse_cpu_tensors(fn, args):
    """A kernel wrapper never falls back to the plain version."""
    q = torch.zeros(1, 2, 1, 16)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fn(q, k, k, *args)


# ---------------------------------------------------------------------- #
# the feasibility scan
# ---------------------------------------------------------------------- #
def _feasibility_case(seed=0, n_req=11, n_vert=300, n_types=5, extra_bits=()):
    """tests/test_kernels.py's random request/vertex tables, in its draw
    order (every clause: type mismatch, busy vertices, size floors,
    property bits on both sides of bit 31, per-type aggregates), plus a
    random bit at each of ``extra_bits`` in both masks."""
    rng = np.random.default_rng(seed)
    vtype = rng.integers(0, n_types, n_vert, dtype=np.int32)
    vok = rng.integers(0, 2, n_vert, dtype=np.int32)
    vsize = rng.integers(1, 64, n_vert, dtype=np.int32)
    vmask = (rng.integers(0, 2, n_vert, dtype=np.int64) << 40
             | rng.integers(0, 8, n_vert, dtype=np.int64))
    agg = rng.integers(0, 16, (n_vert, n_types), dtype=np.int32)
    tid = rng.integers(0, n_types, n_req, dtype=np.int32)
    msize = rng.integers(1, 48, n_req, dtype=np.int32)
    rmask = (rng.integers(0, 2, n_req, dtype=np.int64) << 40
             | rng.integers(0, 4, n_req, dtype=np.int64))
    need = rng.integers(0, 12, (n_req, n_types), dtype=np.int32)
    for bit in extra_bits:
        vmask |= rng.integers(0, 2, n_vert, dtype=np.int64) << bit
        rmask |= rng.integers(0, 2, n_req, dtype=np.int64) << bit
    return vtype, vok, vsize, vmask, agg, tid, msize, rmask, need


def _torch_case(case):
    vtype, vok, *rest = (torch.from_numpy(a) for a in case)
    return (vtype, vok.to(torch.uint8), *rest)


FEASIBILITY_CASES = [   # seed, n_req, n_vert, extra mask bits
    (0, 11, 300, ()),       # ragged: the Pallas kernel pads request and vertex blocks
    (1, 8, 256, ()),        # exact block multiples
    (2, 1, 33, ()),         # one request, few vertices
    (3, 40, 1024, ()),      # a deep window: more rows than a CUDA block holds
    (4, 13, 97, ()),
    (5, 9, 200, (61,)),     # bits 40 and 61 of the int64 masks
]


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("seed,n_req,n_vert,bits", FEASIBILITY_CASES)
def test_ref_feasible_vs_jax(seed, n_req, n_vert, bits, mode):
    """ref_feasible == JAX's batched_feasible_op, through its XLA
    reference and through the Pallas kernel in interpret mode."""
    case = _feasibility_case(seed, n_req, n_vert, extra_bits=bits)
    ours = ref_feasible(*_torch_case(case))
    assert ours.dtype == torch.uint8 and ours.shape == (n_req, n_vert)
    want = jax_batched_feasible_op(*case, use_pallas=mode)
    np.testing.assert_array_equal(ours.numpy(), want)


def test_ref_feasible_reads_strided_agg():
    """The flat graph hands over ``agg[:n, :T]`` of a wider table."""
    case = list(_feasibility_case(6, 7, 150, n_types=3))
    wide = np.zeros((150, 8), np.int32)
    wide[:, :3] = case[4]
    args = _torch_case(case)
    view = torch.from_numpy(wide)[:, :3]
    assert not view.is_contiguous()
    got = ref_feasible(*args[:4], view, *args[5:])
    np.testing.assert_array_equal(got.numpy(), ref_feasible(*args).numpy())


def test_batched_feasible_op_cpu_goes_to_plain_version():
    args = _torch_case(_feasibility_case(7, 5, 64))
    before = dict(LAUNCHES)
    np.testing.assert_array_equal(batched_feasible_op(*args).numpy(),
                                  ref_feasible(*args).numpy())
    assert LAUNCHES == before


def test_feasible_mask_refuses_cpu_tensors():
    """The kernel's wrapper never falls back to the plain version, and
    no other device reaches either."""
    args = _torch_case(_feasibility_case(8, 3, 40))
    with pytest.raises(ValueError, match="CUDA"):
        feasible_mask(*args)
    with pytest.raises(ValueError, match="no kernel path"):
        batched_feasible_op(*(a.to("meta") for a in args))
