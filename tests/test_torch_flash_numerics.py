"""The bf16 prefill kernel's arithmetic against the JAX Pallas kernel, on the CPU.

``flash_fwd_mma_kernel`` (``repro_torch/kernels/csrc/flash_attention.cu``)
runs only on a card. Its one numerical change from the Pallas kernel is
that P is rounded to bf16 before the P·V product on the tensor cores
(FlashAttention and ``scaled_dot_product_attention`` do the same); the
Pallas kernel keeps P in fp32. ``_kernel_arithmetic`` repeats the
kernel's arithmetic in plain torch — bf16 q/k/v, fp32 scores in log2
units, an online softmax over tiles of 64 keys with fp32 m/l/acc, l summed
from the fp32 P, P rounded to bf16 for P·V — and the tests hold it against
the Pallas kernel in interpret mode within the bf16 tolerance of
tests/test_kernels.py (2e-2), on the same numpy inputs.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention

NEG_INF = -1e30
BLOCK_K = 64            # kMmaBK
LOG2E = 1.4426950408889634
TOL = 2e-2              # bf16, tests/test_kernels.py:32


def _kernel_arithmetic(q, k, v, window=0, round_p=True):
    """Causal GQA attention as the bf16 kernel computes it. q: [b, h, sq, d]
    bf16; k, v: [b, kvh, skv, d] bf16. ``round_p=False`` keeps P in fp32
    (the Pallas kernel's choice), to size the rounding's effect."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    scale_log2 = torch.tensor((1.0 / math.sqrt(d)) * LOG2E, dtype=torch.float32)
    qg = q.float().reshape(b, kvh, g, sq, d)
    qpos = torch.arange(sq)[:, None] + (skv - sq)
    m = torch.full((b, kvh, g, sq), NEG_INF)
    l = torch.zeros((b, kvh, g, sq))
    acc = torch.zeros((b, kvh, g, sq, d))
    for k0 in range(0, skv, BLOCK_K):
        kt, vt = k[:, :, k0:k0 + BLOCK_K].float(), v[:, :, k0:k0 + BLOCK_K].float()
        s = torch.einsum("bkgqd,bktd->bkgqt", qg, kt) * scale_log2
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        mask = kpos <= qpos
        if window:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = p.to(torch.bfloat16).float() if round_p else p
        acc = acc * alpha[..., None] + torch.einsum("bkgqt,bktd->bkgqd", pv, vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, sq, d).to(torch.bfloat16)


def _inputs(seed, b, h, kvh, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d), np.float32),
            rng.standard_normal((b, kvh, skv, d), np.float32),
            rng.standard_normal((b, kvh, skv, d), np.float32))


@pytest.mark.parametrize("sq,skv,d,window", [
    (128, 128, 16, 0),      # the reduced configs' head_dim
    (128, 128, 80, 0),      # zamba2's: 5 k-steps, 10 output n-tiles
    (128, 128, 16, 32),     # window inside a key tile
    (128, 128, 80, 32),
    (64, 128, 80, 0),       # query positions offset by skv - sq
])
def test_bf16_p_stays_within_the_reference_tolerance(sq, skv, d, window):
    b, h, kvh = 2, 4, 2
    qn, kn, vn = _inputs(15, b, h, kvh, sq, skv, d)
    ref = np.asarray(jax_flash_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (qn, kn, vn)),
        window=window, interpret=True), np.float32)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in (qn, kn, vn))
    out = _kernel_arithmetic(q, k, v, window=window)
    assert out.shape == (b, h, sq, d) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL, rtol=TOL)
    # what rounding P moves: the same arithmetic with P in fp32 differs,
    # by less than half the tolerance
    exact = _kernel_arithmetic(q, k, v, window=window, round_p=False).float().numpy()
    gap = np.abs(out.float().numpy() - exact).max()
    assert 0 < gap < TOL / 2
