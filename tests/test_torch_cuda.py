"""The port's CUDA kernels against their plain versions, on a card.

Imports neither JAX nor ``repro``, so it runs on a machine with only
PyTorch; skipped without a card (the kernels have no CPU mode):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention import flash_attention, flash_decode
from repro_torch.kernels.ref import ref_attention, ref_decode

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
    (2, 8, 2, 256, 256, 64, 32),     # window
    (2, 8, 2, 256, 256, 64, 128),
    (1, 4, 2, 200, 200, 16, 0),      # ragged length, reduced head_dim
    (1, 6, 2, 72, 200, 32, 0),       # sq < skv
    (2, 32, 32, 96, 96, 80, 0),      # zamba2 head_dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_vs_plain(b, h, kvh, sq, skv, d, window, dtype, cuda):
    rng = np.random.default_rng(6)
    q = _randn(rng, (b, h, sq, d), dtype, cuda)
    k = _randn(rng, (b, kvh, skv, d), dtype, cuda)
    v = _randn(rng, (b, kvh, skv, d), dtype, cuda)
    n = LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == n + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    _close(out, ref_attention(q, k, v, window=window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cache_dtype", [
    ("float32", "float32"),
    ("bfloat16", "bfloat16"),
    ("float32", "bfloat16"),         # the fp32 reduced model over its bf16 cache
])
@pytest.mark.parametrize("b,h,kvh,S,d", [
    (8, 24, 8, 544, 128),            # llama3.2-3b decode
    (3, 4, 2, 40, 16),               # reduced config, S not a tile multiple
])
def test_flash_decode_kernel_vs_plain(b, h, kvh, S, d, dtype, cache_dtype, cuda):
    """Ragged lengths, read in place through the model's [b, S, kvh, d]
    cache layout."""
    rng = np.random.default_rng(7)
    q = _randn(rng, (b, 1, h, d), dtype, cuda).permute(0, 2, 1, 3)
    ck = _randn(rng, (b, S, kvh, d), cache_dtype, cuda).permute(0, 2, 1, 3)
    cv = _randn(rng, (b, S, kvh, d), cache_dtype, cuda).permute(0, 2, 1, 3)
    lengths = torch.from_numpy(rng.integers(1, S + 1, (b,)).astype(np.int32)).to(cuda)
    lengths[0] = S
    n = LAUNCHES["flash_decode"]
    out = flash_decode(q, ck, cv, lengths)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_decode"] == n + 1
    _close(out, ref_decode(q, ck, cv, lengths), dtype)


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
