"""The port's CUDA kernels against their plain versions, on a card.

Imports neither JAX nor ``repro``, so it runs on a machine with only
PyTorch; skipped without a card (the kernels have no CPU mode):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, feasibility
from repro_torch.kernels.causal_conv import (causal_conv, causal_conv_bwd, ref_causal_conv,
                                             ref_causal_conv_bwd)
from repro_torch.kernels.feasibility import feasible_mask
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                 flash_decode)
from repro_torch.kernels.ref import (ref_attention, ref_attention_bwd, ref_decode, ref_feasible,
                                     ref_ssd_chunk, tile_rel_err)
from repro_torch.kernels.ssd_scan import ssd_chunk

# atol = rtol as in tests/test_kernels.py:32: in bf16 the output is rounded
# to bf16; in fp32 only the order of the sums differs
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in full fp32
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device=device, dtype=getattr(torch, dtype))


def _close(out, ref, dtype):
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kvh,sq,skv,d,window", [
    (8, 24, 8, 512, 512, 128, 0),    # llama3.2-3b prefill
    (8, 32, 4, 512, 512, 128, 0),    # qwen3-moe-30b-a3b prefill, GQA group 8
    (2, 8, 2, 256, 256, 64, 32),     # window
    (2, 8, 2, 256, 256, 64, 128),
    (1, 4, 2, 200, 200, 16, 0),      # ragged length, reduced head_dim
    (1, 6, 2, 72, 200, 32, 0),       # sq < skv
    (2, 32, 32, 96, 96, 80, 0),      # zamba2 head_dim
    (2, 6, 2, 256, 256, 32, 0),      # GQA group 3
    (2, 6, 2, 200, 200, 64, 32),     # ragged length under a window
    (2, 32, 32, 200, 200, 80, 0),    # zamba2 head_dim, ragged
])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])   # bshd: the model's permuted views
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_vs_plain(b, h, kvh, sq, skv, d, window, layout, dtype, cuda):
    rng = np.random.default_rng(6)
    if layout == "bhsd":
        q = _randn(rng, (b, h, sq, d), dtype, cuda)
        k = _randn(rng, (b, kvh, skv, d), dtype, cuda)
        v = _randn(rng, (b, kvh, skv, d), dtype, cuda)
    else:
        q = _randn(rng, (b, sq, h, d), dtype, cuda).permute(0, 2, 1, 3)
        k = _randn(rng, (b, skv, kvh, d), dtype, cuda).permute(0, 2, 1, 3)
        v = _randn(rng, (b, skv, kvh, d), dtype, cuda).permute(0, 2, 1, 3)
    n = LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == n + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    _close(out, ref_attention(q, k, v, window=window), dtype)


# the backward: of each gradient's largest |value| (dq, dk and dv are rounded
# to bf16 in bf16; in fp32 only the order of the sums differs)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# and of each 64-row tile of each (batch, head), ||g - r|| / ||r||, so that a
# wrong tile of small gradients shows (chip_smoke.py's BWD_TILE_TOL)
BWD_TILE_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kvh,sq,skv,d,window", [
    (2, 24, 8, 256, 256, 128, 0),    # llama3.2-3b's heads
    (2, 16, 2, 128, 128, 128, 0),    # GQA group 8
    (2, 6, 2, 256, 256, 64, 32),     # GQA group 3, window
    (1, 6, 2, 72, 200, 32, 0),       # sq < skv
    (2, 8, 8, 200, 200, 80, 0),      # head_dim 80, ragged
    (1, 4, 2, 100, 100, 16, 0),
    (2, 6, 2, 130, 130, 16, 32),     # head_dim 16, ragged under a window
    (1, 8, 2, 72, 200, 80, 0),       # head_dim 80, sq < skv, GQA group 4
    (1, 24, 24, 192, 192, 64, 0),    # musicgen-medium's MHA at d 64
    (1, 64, 8, 128, 128, 128, 0),    # qwen2-vl-72b's 64 heads at group 8
])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_kernel_vs_plain(b, h, kvh, sq, skv, d, window, layout, dtype,
                                             cuda):
    rng = np.random.default_rng(7)
    shapes = [(b, h, sq, d), (b, kvh, skv, d), (b, kvh, skv, d), (b, h, sq, d)]
    if layout == "bhsd":
        q, k, v, dO = (_randn(rng, sh, dtype, cuda) for sh in shapes)
    else:
        q, k, v, dO = (_randn(rng, (sh[0], sh[2], sh[1], sh[3]), dtype, cuda).permute(0, 2, 1, 3)
                       for sh in shapes)
    o, lse = flash_attention(q, k, v, window=window, return_lse=True)
    _close(lse, ref_attention(q, k, v, window=window, return_lse=True)[1], "float32")
    n = LAUNCHES["flash_attention_bwd"]
    grads = flash_attention_bwd(q, k, v, o, lse, dO, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd"] == n + 1
    for g, r, t in zip(grads, ref_attention_bwd(q, k, v, o, lse, dO, window=window), (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype
        scale = r.float().abs().max().item()
        assert (g.float() - r.float()).abs().max().item() <= BWD_TOL[dtype] * scale
        assert tile_rel_err(g, r) <= BWD_TILE_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("misalign", ["pointer", "row_stride"])
def test_flash_attention_bwd_bf16_rejects_unaligned_rows(misalign, cuda):
    """The bf16 backward copies 16-byte rows with cp.async: a q whose
    pointer or row stride is not 16-byte aligned raises, and nothing is
    launched; the same values through aligned rows pass."""
    rng = np.random.default_rng(11)
    b, h, kvh, s, d = 1, 4, 2, 100, 16
    k, v = (_randn(rng, (b, kvh, s, d), "bfloat16", cuda) for _ in range(2))
    dO = _randn(rng, (b, h, s, d), "bfloat16", cuda)
    if misalign == "pointer":      # starts one element into its buffer
        q = _randn(rng, (b * h * s * d + 1,), "bfloat16", cuda)[1:].view(b, h, s, d)
    else:                          # rows 20 elements (40 bytes) apart
        q = _randn(rng, (b, h, s, d + 4), "bfloat16", cuda)[..., :d]
    aligned = q.clone(memory_format=torch.contiguous_format)
    o, lse = flash_attention(aligned, k, v, return_lse=True)
    n = LAUNCHES["flash_attention_bwd"]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd(q, k, v, o, lse, dO)
    assert LAUNCHES["flash_attention_bwd"] == n
    grads = flash_attention_bwd(aligned, k, v, o, lse, dO)
    torch.cuda.synchronize()
    for g, r in zip(grads, ref_attention_bwd(aligned, k, v, o, lse, dO)):
        assert (g.float() - r.float()).abs().max().item() <= \
            BWD_TOL["bfloat16"] * r.float().abs().max().item()


@pytest.mark.cuda
def test_attention_op_carries_gradients_through_the_kernels(cuda):
    from repro_torch.kernels.ops import attention_op
    rng = np.random.default_rng(8)
    q = _randn(rng, (2, 128, 8, 64), "bfloat16", cuda).permute(0, 2, 1, 3).requires_grad_()
    k = _randn(rng, (2, 128, 2, 64), "bfloat16", cuda).permute(0, 2, 1, 3).requires_grad_()
    v = _randn(rng, (2, 128, 2, 64), "bfloat16", cuda).permute(0, 2, 1, 3).requires_grad_()
    dO = _randn(rng, (2, 8, 128, 64), "bfloat16", cuda)
    n = dict(LAUNCHES)
    got = torch.autograd.grad(attention_op(q, k, v), (q, k, v), dO)
    assert LAUNCHES["flash_attention"] == n["flash_attention"] + 1
    assert LAUNCHES["flash_attention_bwd"] == n["flash_attention_bwd"] + 1
    plain = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref_attention(*plain), plain, dO.float())
    for g, w in zip(got, want):
        assert (g.float() - w).abs().max().item() <= BWD_TOL["bfloat16"] * w.abs().max().item()


@pytest.mark.cuda
def test_kernels_without_backward_raise_under_grad_on_card(cuda):
    from repro_torch.kernels.ops import decode_attention_op
    q = torch.randn(2, 4, 1, 16, device=cuda, requires_grad=True)
    kv = torch.randn(2, 2, 64, 16, device=cuda)
    with pytest.raises(NotImplementedError, match="flash_decode has no backward"):
        decode_attention_op(q, kv, kv, torch.full((2,), 64, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_non_causal_kernel_vs_plain(dtype, cuda):
    """Without the causal mask every key is read, past sq too, and both
    ragged edges (sq 100, skv 72: neither a tile multiple) are masked."""
    rng = np.random.default_rng(10)
    q = _randn(rng, (2, 4, 100, 64), dtype, cuda)
    k = _randn(rng, (2, 2, 72, 64), dtype, cuda)
    v = _randn(rng, (2, 2, 72, 64), dtype, cuda)
    out = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    _close(out, ref_attention(q, k, v, causal=False), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("misalign", ["pointer", "row_stride"])
def test_flash_attention_bf16_rejects_unaligned_rows(misalign, cuda):
    """The bf16 kernel copies 16-byte rows with cp.async: a view whose
    pointer or row stride is not 16-byte aligned raises (never a quiet
    detour to another kernel), and nothing is launched."""
    rng = np.random.default_rng(9)
    b, h, kvh, s, d = 1, 4, 2, 64, 16
    k = _randn(rng, (b, kvh, s, d), "bfloat16", cuda)
    v = _randn(rng, (b, kvh, s, d), "bfloat16", cuda)
    if misalign == "pointer":      # starts one element into its buffer
        q = _randn(rng, (b * h * s * d + 1,), "bfloat16", cuda)[1:].view(b, h, s, d)
    else:                          # rows 20 elements (40 bytes) apart
        q = _randn(rng, (b, h, s, d + 4), "bfloat16", cuda)[..., :d]
    n = LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, k, v)
    assert LAUNCHES["flash_attention"] == n
    # the same values through aligned rows pass (a copy: the misaligned
    # pointer case is already contiguous)
    out = flash_attention(q.clone(memory_format=torch.contiguous_format), k, v)
    _close(out, ref_attention(q, k, v), "bfloat16")


DECODE_DTYPES = [
    ("float32", "float32"),
    ("bfloat16", "bfloat16"),
    ("float32", "bfloat16"),         # the fp32 reduced model over its bf16 cache
]


def _decode_inputs(rng, b, h, kvh, S, d, dtype, cache_dtype, device):
    """q and a [b, S, kvh, d] cache read through [b, kvh, S, d] views, as the
    model passes them; ragged lengths with row 0 at S and row 1 at 1."""
    q = _randn(rng, (b, 1, h, d), dtype, device).permute(0, 2, 1, 3)
    ck = _randn(rng, (b, S, kvh, d), cache_dtype, device).permute(0, 2, 1, 3)
    cv = _randn(rng, (b, S, kvh, d), cache_dtype, device).permute(0, 2, 1, 3)
    lengths = torch.from_numpy(rng.integers(1, S + 1, (b,)).astype(np.int32)).to(device)
    lengths[0] = S
    if b > 1:
        lengths[1] = 1
    return q, ck, cv, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cache_dtype", DECODE_DTYPES)
@pytest.mark.parametrize("b,h,kvh,S,d", [
    (8, 24, 8, 544, 128),            # llama3.2-3b decode
    (8, 32, 4, 544, 128),            # qwen3-moe-30b-a3b decode, GQA group 8
    (8, 32, 32, 520, 80),            # zamba2-2.7b decode (S not a tile multiple)
    (3, 4, 2, 40, 16),               # reduced config, shorter than a tile
    (2, 16, 2, 200, 64),             # GQA group 8
    (2, 12, 4, 100, 32),             # d 32, group 3
    (4, 8, 2, 300, 64),              # d 64, group 4
    (2, 10, 2, 130, 80),             # group 5, run as 8 with 3 heads idle
    (2, 12, 2, 200, 64),             # group 6, run as 8 with 2 heads idle
    (2, 14, 2, 130, 128),            # group 7, run as 8 with 1 head idle
    (8, 48, 8, 544, 128),            # nemotron-4-15b decode: group 6
    (8, 40, 10, 544, 128),           # phi3-medium-14b decode: 10 kv heads, group 4
    (1, 8, 1, 512, 128),             # 8 splits, the most a cluster takes
])
def test_flash_decode_kernel_vs_plain(b, h, kvh, S, d, dtype, cache_dtype, cuda):
    """Ragged lengths (one row at S, one at 1), read in place through the
    model's [b, S, kvh, d] cache layout. ``decode_plan`` gives these shapes
    1 to 8 splits (clusters of 1 to 8 blocks), some with a short last split
    (2 keys at S 130)."""
    rng = np.random.default_rng(7)
    q, ck, cv, lengths = _decode_inputs(rng, b, h, kvh, S, d, dtype, cache_dtype, cuda)
    n = LAUNCHES["flash_decode"]
    out = flash_decode(q, ck, cv, lengths)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_decode"] == n + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    _close(out, ref_decode(q, ck, cv, lengths), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cache_dtype", DECODE_DTYPES)
@pytest.mark.parametrize("b,h,kvh,S,d,window", [
    (1, 32, 32, 2048, 80, 256),      # zamba2's block: the window within two splits
    (8, 24, 8, 544, 128, 64),        # llama3.2-3b shape under a window
    (4, 8, 2, 300, 64, 1),           # a window of one key
    (2, 16, 2, 200, 64, 150),        # GQA group 8
    (3, 4, 2, 40, 16, 8),            # shorter than a tile
    (1, 8, 1, 512, 128, 100),        # 8 splits, most of them outside the window
])
def test_flash_decode_starts_empty_rows_and_lse(b, h, kvh, S, d, window, dtype, cache_dtype,
                                                cuda):
    """The sequence-split, windowed contract: row i attends [starts[i],
    lengths[i]) with starts = max(0, lengths - window); one row attends
    nothing (starts = lengths), one row's range lies in the cache's last
    split alone. Outputs and the logsumexps of ``lse=True`` against
    ``ref_decode``; an empty row gives 0 and -inf, with no NaN."""
    rng = np.random.default_rng(11)
    q, ck, cv, lengths = _decode_inputs(rng, b, h, kvh, S, d, dtype, cache_dtype, cuda)
    starts = (lengths - window).clamp_min(0)
    starts[-1] = lengths[-1]                                  # an empty row
    out, lse = flash_decode(q, ck, cv, lengths, starts, lse=True)
    torch.cuda.synchronize()
    want, want_lse = ref_decode(q, ck, cv, lengths, starts, lse=True)
    assert lse.shape == (b, h, 1) and lse.dtype == torch.float32
    _close(out, want, dtype)
    assert torch.isneginf(lse[-1]).all() and not out[-1].float().any()
    assert torch.isfinite(lse[:-1]).all() and not torch.isnan(out).any()
    np.testing.assert_allclose(lse[:-1].cpu().numpy(), want_lse[:-1].cpu().numpy(),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(flash_decode(q, ck, cv, lengths, starts).float().cpu().numpy(),
                                  out.float().cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("misalign", ["pointer", "row_stride"])
def test_flash_decode_rejects_unaligned_rows(cache_dtype, misalign, cuda):
    """The decode kernel reads K/V rows 16 bytes at a time: a K view whose
    pointer or row stride is not 16-byte aligned raises (never a quiet
    detour to the plain version), and nothing is launched."""
    rng = np.random.default_rng(11)
    b, h, kvh, S, d = 2, 4, 2, 64, 16
    q = _randn(rng, (b, h, 1, d), "float32", cuda)
    v = _randn(rng, (b, kvh, S, d), cache_dtype, cuda)
    if misalign == "pointer":      # starts one element into its buffer
        k = _randn(rng, (b * kvh * S * d + 1,), cache_dtype, cuda)[1:].view(b, kvh, S, d)
    else:                          # rows d + 2 elements apart
        k = _randn(rng, (b, kvh, S, d + 2), cache_dtype, cuda)[..., :d]
    lengths = torch.full((b,), S, dtype=torch.int32, device=cuda)
    n = LAUNCHES["flash_decode"]
    with pytest.raises(ValueError, match="16-byte"):
        flash_decode(q, k, v, lengths)
    assert LAUNCHES["flash_decode"] == n
    out = flash_decode(q, k.clone(memory_format=torch.contiguous_format), v, lengths)
    _close(out, ref_decode(q, k, v, lengths), "float32")


@pytest.mark.cuda
def test_model_attention_goes_through_kernels(cuda):
    """A reduced-config prefill and decode step on the card launch each
    kernel once per layer and agree with the same model on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import make_model

    cfg = get_config("llama3.2-3b").reduced()
    cpu = make_model(cfg, device="cpu")
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = make_model(cfg, device=cuda)
    gpu.load_params(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab, (2, 12)))
    before = dict(LAUNCHES)
    outs = []
    for model in (cpu, gpu):
        logits, pc = model.prefill_step(toks[:, :11].to(model.device))
        cache = model.init_cache(ShapeConfig("serve", 16, 2, "decode"))
        for k in cache:
            cache[k][:, :, :11].copy_(pc[k])
        step, _ = model.serve_step(cache, toks[:, 11:].to(model.device), 11)
        outs.append((logits.cpu(), step.cpu()))
    assert LAUNCHES["flash_attention"] == before["flash_attention"] + cfg.n_layers
    assert LAUNCHES["flash_decode"] == before["flash_decode"] + cfg.n_layers
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------- #
# the feasibility kernel and the scheduler slice on the card
# ---------------------------------------------------------------------- #
def _feasibility_case(seed, n_req, n_vert, n_types=5, extra_bits=()):
    """The random tables of tests/test_kernels.py (same draw order), plus
    a random bit at each of ``extra_bits`` in both property masks."""
    rng = np.random.default_rng(seed)
    vtype = rng.integers(0, n_types, n_vert, dtype=np.int32)
    vok = rng.integers(0, 2, n_vert, dtype=np.int32).astype(np.uint8)
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
    return [vtype, vok, vsize, vmask, agg, tid, msize, rmask, need]


def _feasibility_args(device, seed, n_req, n_vert, bits=(), n_types=5, width=0, offset=0):
    """``_feasibility_case`` on ``device``: agg as the [:, :T] view of a
    table ``width`` columns wide (0: T), and with ``offset`` 1 every vertex
    column and agg the [1:] view of one vertex more."""
    case = _feasibility_case(seed, n_req, n_vert + offset, n_types, extra_bits=bits)
    args = [torch.from_numpy(a).to(device) for a in case]
    if width and width != n_types:
        wide = torch.zeros((n_vert + offset, width), dtype=torch.int32, device=device)
        wide[:, :n_types] = args[4]
        args[4] = wide[:, :n_types]
    args[:5] = [t[offset:] for t in args[:5]]
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n_req,n_vert,bits,n_types,width,offset", [
    (0, 11, 300, (), 5, 0, 0), (1, 8, 256, (), 5, 0, 0), (2, 1, 33, (), 5, 0, 0),
    (3, 40, 1024, (), 5, 0, 0), (4, 13, 97, (), 5, 0, 0), (5, 9, 200, (61,), 5, 0, 0),
    # the launch plan's edges: fewer vertices than one thread takes, a
    # ragged tail, 33 and 65 request rows (two and three blocks of rows),
    # one and eight types, agg rows 5 apart, [1:] views of every column
    (35, 6, 3, (), 4, 0, 0), (10, 6, 1025, (), 4, 0, 0), (11, 33, 1025, (), 4, 0, 0),
    (12, 65, 517, (), 4, 0, 0), (12, 6, 1025, (), 1, 0, 0), (11, 9, 1025, (), 8, 0, 0),
    (10, 6, 1025, (), 4, 5, 0), (10, 33, 1025, (), 4, 0, 1), (15, 9, 300, (), 5, 0, 1),
])
@pytest.mark.parametrize("strided", [False, True])
def test_feasibility_kernel_vs_plain(seed, n_req, n_vert, bits, n_types, width, offset, strided,
                                     cuda):
    """Bit-exact against ref_feasible; ``strided`` reads agg as the
    [:, :T] view of a table 9 columns wide, as the flat graph hands it
    over."""
    args = _feasibility_args(cuda, seed, n_req, n_vert, bits, n_types,
                             9 if strided else width, offset)
    n = LAUNCHES["feasibility"]
    out = feasible_mask(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["feasibility"] == n + 1
    assert out.dtype == torch.uint8 and out.shape == (n_req, n_vert)
    assert torch.equal(out, ref_feasible(*args))


@pytest.mark.cuda
def test_feasibility_plans_vs_plain(cuda):
    """The launch plan is bit-exact against ref_feasible over several
    blocks, on the vector path and the per-element one; a plan of another
    VPT than the kernel's is refused at launch, not run."""
    for offset, n_vert in ((0, 5000), (0, 4097), (1, 4097)):
        args = _feasibility_args(cuda, 21, 37, n_vert, n_types=4, offset=offset)
        out = feasible_mask(*args)
        torch.cuda.synchronize()
        assert torch.equal(out, ref_feasible(*args)), (offset, n_vert)
    n = LAUNCHES["feasibility"]
    with mock.patch.object(feasibility, "VPT", 2 * feasibility.VPT):
        with pytest.raises(RuntimeError, match="CUDA error"):
            feasible_mask(*args)
    assert LAUNCHES["feasibility"] == n


@pytest.mark.cuda
def test_feasibility_wrapper_refuses_bad_inputs(cuda):
    args = [torch.from_numpy(a).to(cuda) for a in _feasibility_case(0, 4, 64)]
    bad = [("vmask", 3, args[3].int()),                     # int32 masks
           ("agg", 4, args[4].float()),
           ("agg", 4, args[4].t().contiguous().t()),        # column stride != 1
           ("need", 8, args[8][:, :4]),                     # shape
           ("vtype", 0, args[0].cpu())]                     # not on the card
    n = LAUNCHES["feasibility"]
    for name, i, t in bad:
        with pytest.raises(ValueError, match=name):
            feasible_mask(*args[:i], t, *args[i + 1:])
    assert LAUNCHES["feasibility"] == n


@pytest.mark.cuda
def test_aggregate_sweep_on_card_matches_cpu(cuda):
    from repro_torch.core import build_cluster
    from repro_torch.core.flatgraph import aggregate_sweep

    g = build_cluster(nodes=16, gpus_per_socket=1, device="cpu")
    f = g.flat()
    rng = np.random.default_rng(9)
    own = rng.integers(0, 3, (f.n, len(f.types))).astype(np.int32)
    got = aggregate_sweep(own, f._parent_dev, f._levels, cuda)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), aggregate_sweep(own, f._parent_dev, f._levels, "cpu"))


@pytest.mark.cuda
def test_flat_graph_on_card_matches_cpu(cuda):
    """A graph on the card and its CPU twin give the same matches, masks
    and aggregates through churn and a splice, and every
    feasible_roots_batch on the card launches the kernel once."""
    from repro_torch.core import (Jobspec, Matcher, add_subgraph, build_cluster,
                                  remove_subgraph, update_metadata)

    twins = [build_cluster(nodes=24, gpus_per_socket=1, device=d) for d in (cuda, "cpu")]
    specs = [Jobspec.hpc(nodes=1, sockets=s, cores=s * c) for s in (1, 2) for c in (4, 16)]
    specs.append(Jobspec.hpc(nodes=2, sockets=4, cores=64))
    reqs = [r for js in specs for r in js.resources]
    n = LAUNCHES["feasibility"]
    for step, js in enumerate(specs * 3):
        got = [Matcher(g, use_flat=True).match(js) for g in twins]
        assert got[0] == got[1] and got[0] is not None
        for g in twins:
            g.set_allocated(got[0], f"j{step}")
        masks = [g.flat().feasible_roots_batch(reqs) for g in twins]
        assert np.array_equal(masks[0], masks[1])
    assert LAUNCHES["feasibility"] == n + 3 * len(specs)
    res = []
    for g in twins:
        ext = build_cluster(nodes=2, gpus_per_socket=1, node_prefix="grow", device=g.device)
        r = add_subgraph(g, ext.extract([p for p in ext.paths() if "grow" in p]))
        update_metadata(g, r)
        res.append(r.new_paths)
    assert [Matcher(g, use_flat=True).match(specs[-1]) for g in twins][0] is not None
    for g, paths in zip(twins, res):
        remove_subgraph(g, paths)
        assert g.flat().verify_against(g)
    fc, fh = (g.flat() for g in twins)
    assert fc.n_agg_sweeps == fh.n_agg_sweeps >= 3
    assert np.array_equal(fc.agg[:fc.n, :len(fc.types)], fh.agg[:fh.n, :len(fh.types)])


# ---------------------------------------------------------------------- #
# the SSD chunk kernel and the SSM / hybrid models on the card
# ---------------------------------------------------------------------- #
def _ssd_inputs(rng, b, s, H, P, G, N, device):
    x = rng.standard_normal((b, s, H, P), np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, H)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, s, G, N), np.float32)
    C = rng.standard_normal((b, s, G, N), np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, dt, A, B, C)]


def _model_views(x, dt, B, C):
    """x, B and C as views into one [b, s, H*P + 2*G*N] projection and dt as
    a view of a wider one, as the model passes them."""
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    wide = torch.cat([x.reshape(b, s, -1), B.reshape(b, s, -1), C.reshape(b, s, -1)], -1)
    views = (wide[..., :H * P].reshape(b, s, H, P), torch.cat([dt, dt], -1)[..., :H],
             wide[..., H * P:H * P + G * N].reshape(b, s, G, N),
             wide[..., H * P + G * N:].reshape(b, s, G, N))
    assert not any(t.is_contiguous() for t in views[:3])
    return views


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,H,P,G,N,chunk", [
    (2, 512, 16, 64, 1, 128, 256),   # mamba2's head and state widths, fewer heads
    (2, 512, 16, 64, 1, 64, 256),    # zamba2's state
    (1, 384, 8, 64, 1, 128, 128),    # chunk 128, three chunks
    (2, 32, 8, 16, 1, 16, 8),        # the reduced configs
    (1, 64, 4, 32, 2, 16, 16),       # two groups
    (1, 96, 4, 16, 4, 8, 16),        # a chunk count that is not a power of two
    (1, 200, 4, 16, 1, 8, 200),      # a chunk that is not a tile multiple
    (1, 64, 4, 4, 1, 12, 16),        # N and P below one mma tile: zero-padded in shared memory
    (2, 96, 4, 12, 2, 12, 32),       # P 12: a ragged 8-column tile
    (1, 64, 4, 8, 1, 10, 16),        # N 10: 4-byte copies of B and C rows
    (1, 16, 4, 16, 1, 8, 1),         # a chunk of one position
])
@pytest.mark.parametrize("strided", [False, True])
def test_ssd_chunk_kernel_vs_plain(b, s, H, P, G, N, chunk, strided, cuda):
    """All three outputs within atol = rtol = 1e-4 (tests/test_kernels.py);
    ``strided`` hands x, B and C as views into one [b, s, H*P + 2*G*N]
    projection and dt as a view of a wider one, as the model does."""
    x, dt, A, B, C = _ssd_inputs(np.random.default_rng(10), b, s, H, P, G, N, cuda)
    if strided:
        x, dt, B, C = _model_views(x, dt, B, C)
    n = LAUNCHES["ssd_chunk"]
    got = ssd_chunk(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_chunk"] == n + 1
    for out, ref in zip(got, ref_ssd_chunk(x, dt, A, B, C, chunk)):
        assert out.shape == ref.shape and out.dtype == torch.float32
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_ssd_chunk_launches_two_kernels(cuda):
    """One wrapper call is one launch of ``ssd_scores_kernel`` and one of
    ``ssd_chunk_kernel`` (read from the profiler), and one count in
    ``LAUNCHES["ssd_chunk"]``."""
    from torch.profiler import ProfilerActivity, profile

    args = _ssd_inputs(np.random.default_rng(14), 2, 512, 16, 64, 1, 128, cuda)
    ssd_chunk(*args, 256)
    torch.cuda.synchronize()
    n = LAUNCHES["ssd_chunk"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ssd_chunk(*args, 256)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("ssd_scores_kernel" in k for k in names) == 1
    assert sum("ssd_chunk_kernel" in k for k in names) == 1
    assert LAUNCHES["ssd_chunk"] == n + 1


@pytest.mark.cuda
def test_ssd_chunk_wrapper_refuses_bad_inputs(cuda):
    args = _ssd_inputs(np.random.default_rng(11), 1, 64, 4, 16, 2, 8, cuda)
    bad = [(0, args[0].double(), "dtype"),
           (0, args[0].cpu(), "CUDA"),                       # not on the card
           (1, args[1][:, :, :2], "shape"),
           (3, args[3].transpose(2, 3).contiguous().transpose(2, 3), "contiguous"),
           (2, torch.cat([args[2], args[2]])[::2], "contiguous")]
    n = LAUNCHES["ssd_chunk"]
    for i, t, match in bad:
        with pytest.raises(ValueError, match=match):
            ssd_chunk(*args[:i], t, *args[i + 1:], 16)
    for chunk, match in ((48, "chunk"), (512, "chunk")):
        with pytest.raises(ValueError, match=match):
            ssd_chunk(*args, chunk)
    with pytest.raises(ValueError, match="groups"):
        ssd_chunk(*_ssd_inputs(np.random.default_rng(12), 1, 16, 3, 16, 2, 8, cuda), 8)
    assert LAUNCHES["ssd_chunk"] == n


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,H,P,G,N,chunk", [
    (2, 512, 16, 64, 1, 128, 256),   # mamba2's head and state widths, fewer heads
    (2, 512, 16, 64, 1, 64, 256),    # zamba2's state
    (1, 384, 8, 64, 1, 128, 128),    # chunk 128, three chunks
    (2, 32, 8, 16, 1, 16, 8),        # the reduced configs
    (1, 64, 4, 32, 2, 16, 16),       # two groups
    (1, 200, 4, 16, 1, 8, 200),      # a chunk that is not a tile multiple
    (2, 96, 4, 12, 2, 12, 32),       # P 12, N 12: ragged 8-column tiles
    (1, 64, 4, 8, 1, 10, 16),        # N 10: 4-byte copies of B and C rows
    (1, 16, 4, 16, 1, 8, 1),         # a chunk of one position
    (1, 512, 80, 64, 1, 128, 256),   # mamba2's 80 heads in one group: the full head sum
])
@pytest.mark.parametrize("strided", [False, True])
def test_ssd_chunk_bwd_kernel_vs_plain(b, s, H, P, G, N, chunk, strided, cuda):
    """All five gradients finite and within 1e-4 of each one's largest
    |value| of ``ref_ssd_chunk_bwd``, and each (batch, chunk, head or
    group) tile within 1e-4 of its own norm (chip_smoke.py's
    ``SSD_BWD_TILE_TOL``); two calls agree bit for bit (fixed-order sums,
    no atomics)."""
    from repro_torch.kernels.ref import ref_ssd_chunk_bwd
    from repro_torch.kernels.ssd_scan import ssd_chunk_bwd
    rng = np.random.default_rng(15)
    x, dt, A, B, C = _ssd_inputs(rng, b, s, H, P, G, N, cuda)
    if strided:
        x, dt, B, C = _model_views(x, dt, B, C)
    nc = s // chunk
    outs = [torch.from_numpy(rng.standard_normal(shape, np.float32)).to(cuda)
            for shape in ((b, s, H, P), (b, nc, H, N, P), (b, nc, H))]
    n = LAUNCHES["ssd_chunk_bwd"]
    got = ssd_chunk_bwd(x, dt, A, B, C, chunk, *outs)
    again = ssd_chunk_bwd(x, dt, A, B, C, chunk, *outs)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_chunk_bwd"] == n + 2
    for g, r, a in zip(got, ref_ssd_chunk_bwd(x, dt, A, B, C, chunk, *outs), again):
        assert g.shape == r.shape and g.dtype == torch.float32 and g.is_contiguous()
        assert torch.isfinite(g).all() and torch.equal(g, a)
        assert (g - r).abs().max().item() <= 1e-4 * r.abs().max().item()
        if g.dim() > 1:        # gA, a sum over batch and chunk, is held by the max check
            t = (lambda v: (v if v.dim() == 4 else v[..., None]).transpose(1, 2))
            assert tile_rel_err(t(g), t(r), rows=chunk) <= 1e-4


@pytest.mark.cuda
def test_ssd_scan_op_carries_gradients_through_the_kernels(cuda):
    """``ssd_scan_op`` under grad launches the forward kernel, then the
    backward kernel, and its gradients (an initial state, a ragged length)
    equal autograd through the sequential recurrence."""
    from repro_torch.kernels.ops import ssd_scan_op
    from repro_torch.kernels.ref import ref_ssd
    rng = np.random.default_rng(16)
    b, s, H, P, G, N, chunk = 2, 100, 8, 32, 2, 16, 32
    ins = _ssd_inputs(rng, b, s, H, P, G, N, cuda)
    h0 = torch.from_numpy(rng.standard_normal((b, H, P, N), np.float32)).to(cuda)
    gy = torch.from_numpy(rng.standard_normal((b, s, H, P), np.float32)).to(cuda)
    leaves = [t.clone().requires_grad_() for t in (*ins, h0)]
    before = dict(LAUNCHES)
    y, h = ssd_scan_op(*leaves[:5], chunk, initial_state=leaves[5], return_state=True)
    got = torch.autograd.grad((y, h), leaves, (gy, torch.ones_like(h)))
    assert LAUNCHES["ssd_chunk"] == before["ssd_chunk"] + 1
    assert LAUNCHES["ssd_chunk_bwd"] == before["ssd_chunk_bwd"] + 1
    plain = [t.clone().requires_grad_() for t in (*ins, h0)]
    ry, rh = ref_ssd(*plain[:5], initial_state=plain[5], return_state=True)
    for g, w in zip(got, torch.autograd.grad((ry, rh), plain, (gy, torch.ones_like(rh)))):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_models_go_through_kernels(arch, cuda):
    """A reduced-config prefill and two decode steps on the card launch
    ssd_chunk once per Mamba2 block (and the attention kernels once per
    shared-block application) and agree with the same model on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import splice_cache
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import make_model

    cfg = get_config(arch).reduced()
    cpu = make_model(cfg, device="cpu")
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = make_model(cfg, device=cuda)
    gpu.load_params(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(13).integers(0, cfg.vocab, (2, 14)))
    shared = cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0
    before = dict(LAUNCHES)
    outs = []
    for model in (cpu, gpu):
        logits, pc = model.prefill_step(toks[:, :12].to(model.device))
        cache = model.init_cache(ShapeConfig("serve", 16, 2, "decode"))
        splice_cache(cache, pc)
        steps = [model.serve_step(cache, toks[:, 12 + i:13 + i].to(model.device), 12 + i)[0]
                 for i in range(2)]
        outs.append([t.cpu() for t in (logits, *steps, cache["ssm"])])
    assert LAUNCHES["ssd_chunk"] == before["ssd_chunk"] + cfg.n_layers
    assert LAUNCHES["flash_attention"] == before["flash_attention"] + shared
    assert LAUNCHES["flash_decode"] == before["flash_decode"] + 2 * shared
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------- #
# Mamba2's causal conv: causal_conv / causal_conv_bwd against the plain pair
# ---------------------------------------------------------------------- #
# u as the model feeds it: "split", the xBC view of a [b, s, 2 c - 256 + 80]
# projection (mamba2-2.7b's [z, xBC, dt] at c = 5376, z at least 8 wide;
# 16-byte rows, the vector variant); "contiguous"; "offset", a view one
# element into its rows (the scalar variant, as a ragged c is)
CONV_CASES = [
    (2, 4096, 5376, "split", False),     # mamba2-2.7b training
    (4, 2048, 5376, "split", False),     # mamba2-2.7b prefill
    (2, 1000, 5376, "split", True),      # a halo; s not a multiple of the kernel's run of 64
    (2, 300, 1030, "contiguous", True),  # ragged c: the scalar variant
    (3, 130, 40, "offset", False),       # misaligned rows: the scalar variant
    (1, 3, 24, "split", True),           # s < K
]
# one rounding of each dtype
CONV_EPS = {"float32": 2.0 ** -24, "bfloat16": 2.0 ** -9}


def _conv_inputs(b, s, c, layout, halo, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    if layout == "split":
        z = max(c - 256, 8)
        u = torch.randn(b, s, z + c + 80, device=dev, generator=g).to(dt)[..., z:z + c]
    elif layout == "offset":
        u = torch.randn(b, s, c + 1, device=dev, generator=g).to(dt)[..., 1:]
    else:
        u = torch.randn(b, s, c, device=dev, generator=g).to(dt)
    w = (torch.rand(4, c, device=dev, generator=g) - 0.5).to(dt)
    bias = (torch.rand(c, device=dev, generator=g) - 0.5).to(dt)
    h = torch.randn(b, 3, c, device=dev, generator=g).to(dt) if halo else None
    gy = torch.randn(b, s, c, device=dev, generator=g).to(dt)
    return u, w, bias, h, gy


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c,layout,halo", CONV_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_kernels_vs_plain(b, s, c, layout, halo, dtype, cuda):
    """The forward against ``ref_causal_conv``: the kernel sums the taps in
    fp32 and rounds once, the plain version rounds each of its K products
    and K + 1 sums in the input dtype, so they differ by up to (2K + 1)
    roundings of the taps' magnitude sum_i |w_i u| + |bias| (times SiLU's
    slope, at most 1.1) plus one rounding of y on each side. The backward
    against ``ref_causal_conv_bwd``, which takes the kernel's arithmetic in
    fp32 in another order: each gradient within 2^-7 (bf16: both round the
    fp32 result once) or 1e-5 (fp32: sums of up to b s terms) of its
    largest |value|."""
    u, w, bias, h, gy = _conv_inputs(b, s, c, layout, halo, dtype, cuda)
    n = dict(LAUNCHES)
    y = causal_conv(u, w, bias, h)
    grads = causal_conv_bwd(u, w, bias, h, gy)
    torch.cuda.synchronize()
    assert LAUNCHES["causal_conv"] == n["causal_conv"] + 1
    assert LAUNCHES["causal_conv_bwd"] == n["causal_conv_bwd"] + 1
    assert y.shape == u.shape and y.dtype == u.dtype and y.is_contiguous()
    ref = ref_causal_conv(u, w, bias, h)
    # the taps' magnitude |bias| + sum_i |w_i| |u[t - K + 1 + i]|
    pad = torch.cat([torch.zeros_like(u[:, :3]) if h is None else h, u], dim=1).float().abs()
    mag = bias.float().abs() + sum(pad[:, i:i + s] * w[i].float().abs() for i in range(4))
    eps = CONV_EPS[dtype]
    tol = 9 * 1.1 * eps * mag + 2 * eps * ref.float().abs()
    assert ((y.float() - ref.float()).abs() <= tol).all()
    want = ref_causal_conv_bwd(u, w, bias, h, gy)
    rel = {"float32": 1e-5, "bfloat16": 2.0 ** -7}[dtype]
    for name, got, wnt, x in zip(("gu", "gw", "gb", "ghalo"), grads, want, (u, w, bias, h)):
        if x is None:
            assert got is None and wnt is None
            continue
        assert got.shape == x.shape and got.dtype == x.dtype and got.is_contiguous(), name
        assert torch.isfinite(got).all(), name
        err = (got.float() - wnt.float()).abs().max().item()
        assert err <= rel * wnt.float().abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("halo", [False, True])
def test_causal_conv_bwd_is_deterministic(halo, cuda):
    """Two backward calls agree bit for bit: the taps' and the bias's
    partials are summed in a fixed order, with no atomics."""
    args = _conv_inputs(2, 4096, 5376, "split", halo, "bfloat16", cuda, seed=3)
    first = causal_conv_bwd(*args)
    second = causal_conv_bwd(*args)
    for a, b in zip(first, second):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(65536, 1), (1, 65535 * 64 + 1)])
def test_causal_conv_refuses_a_grid_too_large(b, s, cuda):
    """The C entry points refuse, launching nothing, where b or the runs of
    s exceed a grid axis's 65535 blocks (the forward's runs of 64 positions
    are the shorter, so only it refuses the long s)."""
    u = torch.zeros(b, s, 4, device=cuda)
    w, bias = torch.zeros(4, 4, device=cuda), torch.zeros(4, device=cuda)
    n = dict(LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error"):
        causal_conv(u, w, bias)
    if b > 65535:
        with pytest.raises(RuntimeError, match="CUDA error"):
            causal_conv_bwd(u, w, bias, None, u)
    torch.cuda.synchronize()
    assert LAUNCHES["causal_conv"] == n["causal_conv"]
    assert LAUNCHES["causal_conv_bwd"] == n["causal_conv_bwd"]


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_mamba_layer_runs_the_conv_kernels(remat, cuda):
    """One ``mamba_layer`` forward and backward on the card launches the
    conv's forward once (twice under remat: the recompute) and its
    backward once; the output and gradients agree with the CPU's, whose
    conv is the plain pair."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.configs import get_config
    from repro_torch.models import mamba2 as tm

    cfg = get_config("mamba2-2.7b").reduced()
    rng = np.random.default_rng(4)
    params = {k: torch.from_numpy((rng.standard_normal(s.shape) * 0.2).astype(np.float32))
              for k, s in tm.mamba_specs(cfg).items()}
    params["D"] += 1.0
    x = torch.from_numpy(rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32))
    outs = []
    for dev in ("cpu", cuda):
        p = {k: v.to(dev, copy=True).requires_grad_() for k, v in params.items()}
        xd = x.to(dev, copy=True).requires_grad_()

        def body(t):
            return tm.mamba_layer(t, p, cfg)[0]
        n = dict(LAUNCHES)
        y = checkpoint(body, xd, use_reentrant=False) if remat else body(xd)
        y.square().sum().backward()
        if dev == cuda:
            torch.cuda.synchronize()
            assert LAUNCHES["causal_conv"] == n["causal_conv"] + (2 if remat else 1)
            assert LAUNCHES["causal_conv_bwd"] == n["causal_conv_bwd"] + 1
        outs.append([y.detach().cpu(), xd.grad.cpu()] + [p[k].grad.cpu()
                                                        for k in ("conv_w", "conv_b", "in_proj")])
    for a, b in zip(*outs):
        assert (b - a).abs().max().item() <= 1e-4 * a.abs().max().item()


# ---------------------------------------------------------------------- #
# the MoE slice on the card (no kernel of its own: the attention kernels
# at qwen3's GQA group 8, the capacity dispatch in plain torch)
# ---------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("T,k,E,factor", [(8, 8, 128, 1.25),        # qwen3 decode at batch 8: C 1
                                          (4096, 8, 128, 1.0),      # qwen3 prefill tokens: C 256
                                          (64, 2, 8, 0.1)])
def test_moe_dispatch_on_card_matches_cpu(T, k, E, factor, cuda):
    """The same routing, plan and output on the card as on the CPU, in
    fp32: identical ids and keep masks, outputs within 1e-4 (cuBLAS and
    the CPU sum the products in other orders)."""
    from repro_torch.models import moe
    from repro_torch.models.config import ArchConfig

    cfg = ArchConfig(name="m", family="moe", n_layers=1, d_model=64, n_heads=2, n_kv_heads=1,
                     d_ff=64, vocab=64, n_experts=E, top_k=k, moe_d_ff=32,
                     capacity_factor=factor, dtype="float32")
    gen = torch.Generator().manual_seed(3)
    params = {}
    for name, spec in moe.moe_specs(cfg).items():
        params[name] = torch.empty(spec.shape)
        spec.materialize_(params[name], gen)
    # router logits spread to gaps far above the two devices' rounding, so
    # that the top-k sets and their order are tie-free on both
    params["router"] *= 100.0
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((1, T, 64), np.float32))
    outs = []
    for dev in ("cpu", cuda):
        p = {n: t.to(dev) for n, t in params.items()}
        xd = x.to(dev)
        _, ids = moe._route(xd.reshape(T, -1), p, cfg)
        plan = moe.dispatch_plan(ids, cfg)
        outs.append((ids.cpu(), plan.keep.cpu(), plan.dest.cpu(),
                     moe.moe_dispatch(xd, p, cfg).cpu()))
    (ids0, keep0, dest0, y0), (ids1, keep1, dest1, y1) = outs
    assert torch.equal(ids0, ids1) and torch.equal(keep0, keep1) and torch.equal(dest0, dest1)
    assert not keep0.all()
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b"])
def test_moe_models_go_through_kernels(arch, cuda):
    """A reduced-config prefill and two decode steps on the card launch the
    attention kernels once per layer and agree with the same model on the
    CPU (fp32, capacity dispatch)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import splice_cache
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import make_model

    cfg = get_config(arch).reduced()
    cpu = make_model(cfg, device="cpu")
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = make_model(cfg, device=cuda)
    gpu.load_params(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(14).integers(0, cfg.vocab, (2, 14)))
    before = dict(LAUNCHES)
    outs = []
    for model in (cpu, gpu):
        logits, pc = model.prefill_step(toks[:, :12].to(model.device))
        cache = model.init_cache(ShapeConfig("serve", 16, 2, "decode"))
        splice_cache(cache, pc)
        steps = [model.serve_step(cache, toks[:, 12 + i:13 + i].to(model.device), 12 + i)[0]
                 for i in range(2)]
        outs.append([t.cpu() for t in (logits, *steps)])
    assert LAUNCHES["flash_attention"] == before["flash_attention"] + cfg.n_layers
    assert LAUNCHES["flash_decode"] == before["flash_decode"] + 2 * cfg.n_layers
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "musicgen-medium"])
def test_stub_frontend_models_go_through_kernels(arch, cuda):
    """A reduced-config prefill over embeddings and two decode steps on the
    next embeddings (qwen2-vl: M-RoPE; musicgen: sinusoid plus RoPE) on the
    card launch the attention kernels once per layer and agree with the
    same model on the CPU (fp32)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import splice_cache
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import make_model

    cfg = get_config(arch).reduced()
    cpu = make_model(cfg, device="cpu")
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = make_model(cfg, device=cuda)
    gpu.load_params(cpu.state_dict())
    emb = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (2, 14, cfg.d_model)).astype(np.float32))
    before = dict(LAUNCHES)
    outs = []
    for model in (cpu, gpu):
        e = emb.to(model.device)
        logits, pc = model.prefill_step(embeds=e[:, :12])
        cache = model.init_cache(ShapeConfig("serve", 16, 2, "decode"))
        splice_cache(cache, pc)
        steps = [model.serve_step(cache, None, 12 + i, embeds=e[:, 12 + i:13 + i])[0]
                 for i in range(2)]
        outs.append([t.cpu() for t in (logits, *steps)])
    assert LAUNCHES["flash_attention"] == before["flash_attention"] + cfg.n_layers
    assert LAUNCHES["flash_decode"] == before["flash_decode"] + 2 * cfg.n_layers
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 20, 128])
def test_mrope_on_card_matches_cpu(d, cuda):
    """``apply_rope`` under three distinct M-RoPE streams (the reduced, an
    odd and qwen2-vl's section split), card against CPU in fp32."""
    from repro_torch.models.layers import apply_rope, mrope_sections_for

    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((2, 64, 4, d)).astype(np.float32))
    pos = torch.from_numpy(np.stack([np.arange(64)[None].repeat(2, 0),
                                     rng.integers(0, 64, (2, 64)),
                                     rng.integers(0, 1024, (2, 64))]).astype(np.int32))
    secs = mrope_sections_for(d)
    want = apply_rope(x, pos, 1e6, secs)
    got = apply_rope(x.to(cuda), pos.to(cuda), 1e6, secs).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_moe_a2a_on_card_matches_cpu(cuda):
    """``moe_impl="a2a"`` at capacity factor 0.5 on the reduced qwen3-moe
    (both stages drop pairs), fp32: the same ids and pairs kept at both
    stages on the card as on the CPU, the output and every gradient of
    sum(y^2) within 1e-4 of its largest |value|."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(), moe_impl="a2a",
                              capacity_factor=0.5)
    gen = torch.Generator().manual_seed(3)
    params = {}
    for name, spec in moe.moe_specs(cfg).items():
        params[name] = torch.empty(spec.shape)
        spec.materialize_(params[name], gen)
    params["router"] *= 100.0        # tie-free top-k sets on both devices
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 32, cfg.d_model),
                                                                  np.float32))
    fields = ("keep", "slot", "recv_eid", "recv_keep", "recv_slot")
    outs = []
    for dev in ("cpu", cuda):
        p = {n: t.to(dev).requires_grad_() for n, t in params.items()}
        xd = x.to(dev).requires_grad_()
        sp = moe.send_plan(moe._route(xd.detach().reshape(64, -1), p, cfg)[1], cfg, 1)
        rp = moe.recv_plan(sp.send_eid.reshape(-1), cfg, 1)
        plan = dict(keep=sp.keep, slot=sp.slot, recv_eid=sp.send_eid.reshape(-1),
                    recv_keep=rp.recv_keep, recv_slot=rp.recv_slot)
        y = moe.moe(xd, p, cfg)
        grads = torch.autograd.grad((y ** 2).sum(), [xd, *p.values()])
        outs.append(({f: plan[f].cpu() for f in fields}, sp.kept(rp).cpu(),
                     y.detach().cpu(), [g.cpu() for g in grads]))
    (plan0, kept0, y0, g0), (plan1, kept1, y1, g1) = outs
    assert all(torch.equal(plan0[f], plan1[f]) for f in fields) and torch.equal(kept0, kept1)
    assert 0 < kept0.sum() < kept0.numel()
    for got, want in [(y1, y0), *zip(g1, g0)]:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * want.abs().max().item())


@pytest.mark.cuda
def test_moe_train_step_on_card_matches_cpu(cuda):
    """One reduced qwen3-moe ``train_step`` (AdamW, capacity dispatch,
    fp32) on the card against the same step on the CPU: the loss within
    1e-5, every parameter within 1e-4 of the largest |value| (AdamW moves
    an element whose gradient is near zero by up to lr whatever its
    size), and one forward and one backward attention launch per layer."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import make_model
    from repro_torch.optim.adamw import OptConfig

    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    opt = OptConfig(kind=cfg.optimizer, warmup=2, total_steps=10)
    cpu = make_model(cfg, device="cpu", opt=opt)
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = make_model(cfg, device=cuda, opt=opt)
    gpu.load_params(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(15).integers(0, cfg.vocab, (4, 17)))
    before = dict(LAUNCHES)
    losses = []
    for model in (cpu, gpu):
        batch = {"tokens": toks[:, :-1].to(model.device), "labels": toks[:, 1:].to(model.device)}
        _, m = model.train_step(model.init_opt(), batch)
        losses.append(m["loss"].item())
    assert LAUNCHES["flash_attention"] == before["flash_attention"] + cfg.n_layers
    assert LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + cfg.n_layers
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    want, got = cpu.masters(), gpu.masters()
    scale = max(t.abs().max().item() for t in want.values())
    for name, t in want.items():
        np.testing.assert_allclose(got[name].cpu().numpy(), t.numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def _loopback(x, params, cfg, n_sh, dev):
    """``moe_a2a_shards`` over n_sh shards in one process on ``dev``: each
    shard's y, both stages' plans, and the gradients of sum(y^2) over
    the shards (x's and each shard's parameter leaves)."""
    from repro_torch.models import moe
    xs, ps = [], []
    for m in range(n_sh):
        xs.append(moe.moe_shard_input(x, cfg, (m, n_sh)).to(dev).detach().requires_grad_())
        ps.append({n: t.to(dev).detach().requires_grad_()     # a leaf a shard on either device
                   for n, t in moe.moe_shard_params(params, cfg, (m, n_sh)).items()})
    runs = moe.moe_a2a_shards(xs, ps, cfg, n_sh, moe.loopback_exchange)
    leaves = xs + [t for p in ps for t in p.values()]
    grads = torch.autograd.grad(sum((r.y ** 2).sum() for r in runs), leaves)
    plans = [[t.cpu() for t in (r.send.keep, r.send.slot, r.send.send_eid, r.recv.recv_keep,
                                r.recv.recv_slot)] for r in runs]
    return [r.y.detach().cpu() for r in runs], plans, [g.cpu() for g in grads]


@pytest.mark.cuda
@pytest.mark.parametrize("n_sh", [1, 2, 4])
def test_moe_a2a_loopback_on_card_matches_cpu(n_sh, cuda):
    """The all-to-all body over n_sh model shards with the loopback
    exchange, on the reduced qwen3-moe (4 experts, d 64) in fp32 at
    capacity factor 1.0: every shard keeps the same pairs at both stages
    on the card as on the CPU, y and every gradient within 1e-4 of its
    largest |value| (as the one-shard case above); at one shard the card's
    loopback equals ``moe_a2a`` on the card bit for bit."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(), moe_impl="a2a",
                              capacity_factor=1.0, dtype="float32")
    gen = torch.Generator().manual_seed(4)
    params = {}
    for name, spec in moe.moe_specs(cfg).items():
        params[name] = torch.empty(spec.shape)
        spec.materialize_(params[name], gen)
    params["router"] *= 100.0        # tie-free top-k sets on both devices
    x = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 32, cfg.d_model),
                                                                   np.float32))
    y0, plans0, g0 = _loopback(x, params, cfg, n_sh, "cpu")
    y1, plans1, g1 = _loopback(x, params, cfg, n_sh, cuda)
    for a, b in zip(plans0, plans1):
        assert all(torch.equal(s, t) for s, t in zip(a, b))
    reached = sum(int(p[3].sum()) for p in plans0)      # pairs that reach an expert
    assert 0 < reached < x.shape[0] * x.shape[1] * cfg.top_k
    for got, want in [*zip(y1, y0), *zip(g1, g0)]:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * want.abs().max().item())
    if n_sh == 1:
        p = {n: t.to(cuda) for n, t in params.items()}
        assert torch.equal(moe.moe_a2a(x.to(cuda), p, cfg).cpu(), y1[0])
