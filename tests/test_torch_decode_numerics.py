"""The decode kernel's partition of the work, against the JAX Pallas kernel, on the CPU.

``flash_decode_kernel`` (``repro_torch/kernels/csrc/flash_attention.cu``)
runs only on a card. ``_kernel_arithmetic`` repeats in plain torch how it
divides the work: the split plan (``decode_plan``), each warp's keys
(``decode_geometry``: row group ``r`` of a block reads keys ``k0 + j *
groups + r`` at the ring stage that starts at ``k0``) with the warp's own
running max and each row group's own sum and accumulator, scores in log2
units, the merge of the 4 warps in the block and the join of the splits
in their cluster (one pass over the splits in order, with a running max). The tests hold it
against the Pallas ``flash_decode`` in interpret mode and against
``ref_decode``, in fp32 on the same numpy inputs, within the fp32
tolerance of tests/test_kernels.py (2e-5); and check the split plan's
properties at the main path's shapes and others.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_decode as jax_flash_decode
from repro_torch.kernels.flash_attention import (DECODE_BLOCKS_PER_SM, DECODE_MAX_SPLITS,
                                                 DECODE_TILE, decode_plan)
from repro_torch.kernels.ref import ref_decode

LOG2E = 1.4426950408889634
TOL = 2e-5              # fp32, tests/test_kernels.py:32
H100_SMS = 132
WARPS = 4               # kDecWarps
STAGE_KEYS = 4          # DecodeGeometry::kKeys


def decode_geometry(d, kv_itemsize):
    """(groups, keys_per_stage) as ``DecodeGeometry``: a block reads
    ``groups`` key rows at once (4 warps of 32 // (d / vec) rows, each row
    copied 16 bytes, vec = 16 / itemsize dims, a lane), and each row group
    takes ``keys_per_stage`` keys per ring stage: key ``k0 + j * groups +
    group`` at the stage that starts at k0."""
    lanes_per_row = d // (16 // kv_itemsize)
    return WARPS * (32 // lanes_per_row), STAGE_KEYS


def _kernel_arithmetic(q, k, v, lengths, plan, kv_itemsize):
    """q [b, h, 1, d], k/v [b, kvh, S, d] fp32, lengths [b]: the output as
    the kernel computes it under ``plan`` = (split_len, n_splits), with the
    geometry of a cache of ``kv_itemsize``-byte elements."""
    b, h, _, d = q.shape
    kvh, S = k.shape[1], k.shape[2]
    g = h // kvh
    groups, n_keys = decode_geometry(d, kv_itemsize)
    rows = groups // WARPS
    tile = groups * n_keys
    split_len, n_splits = plan
    ninf = torch.tensor(-math.inf)
    qs = q.reshape(b, kvh, g, d) * torch.tensor((1.0 / math.sqrt(d)) * LOG2E)
    out = torch.empty(b, kvh, g, d)
    for bb in range(b):
        length = min(int(lengths[bb]), S)
        for kh in range(kvh):
            parts = []                                   # (acc [g, d], m [g], l [g])
            for split in range(n_splits):
                s0 = split * split_len
                s1 = min(s0 + split_len, length)
                wm = torch.full((WARPS, g), -math.inf)
                wl = torch.zeros(WARPS, rows, g)
                wacc = torch.zeros(WARPS, rows, g, d)
                for k0 in range(s0, s1, tile):
                    for w in range(WARPS):
                        grp = w * rows + torch.arange(rows)
                        keys = k0 + torch.arange(n_keys)[None, :] * groups + grp[:, None]
                        ok = keys < s1                       # [rows, n_keys]
                        kk = keys.clamp(max=S - 1)
                        s = torch.einsum("gd,rjd->rjg", qs[bb, kh], k[bb, kh][kk])
                        s = torch.where(ok[..., None], s, ninf)
                        m_new = torch.maximum(wm[w], s.amax(dim=(0, 1)))
                        seen = m_new > -math.inf
                        alpha = torch.where(seen, torch.exp2(wm[w] - m_new), 1.0)
                        wm[w] = torch.where(seen, m_new, wm[w])
                        p = torch.where(ok[..., None], torch.exp2(s - wm[w]), 0.0)
                        wl[w] = wl[w] * alpha + p.sum(1)
                        wacc[w] = (wacc[w] * alpha[:, None]
                                   + torch.einsum("rjg,rjd->rgd", p, v[bb, kh][kk]))
                # the warps meet in shared memory
                M = wm.amax(0)
                f = torch.where(wm > -math.inf, torch.exp2(wm - M), 0.0)   # [warps, g]
                parts.append(((f[:, :, None] * wacc.sum(1)).sum(0), M,
                              (f * wl.sum(1)).sum(0)))
            M = torch.full((g,), -math.inf)     # the cluster's join
            l, acc = torch.zeros(g), torch.zeros(g, d)
            for a_s, m_s, l_s in parts:
                m_new = torch.maximum(M, m_s)
                c = torch.where(M == m_new, 1.0, torch.exp2(M - m_new))
                w = torch.where(m_s > -math.inf, torch.exp2(m_s - m_new), 0.0)
                l = l * c + w * l_s
                acc = acc * c[:, None] + w[:, None] * a_s
                M = m_new
            out[bb, kh] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out.reshape(b, h, 1, d)


@pytest.mark.parametrize("g", [1, 3, 8])
@pytest.mark.parametrize("d", [16, 80, 128])
@pytest.mark.parametrize("splits", ["one", "several"])
@pytest.mark.parametrize("kv_itemsize", [4, 2])   # fp32 cache; bf16 cache under fp32 q
def test_partition_matches_pallas_and_ref(g, d, splits, kv_itemsize):
    b, kvh, S = 3, 2, 256
    h = g * kvh
    rng = np.random.default_rng(16)
    qn = rng.standard_normal((b, h, 1, d), np.float32)
    kn = rng.standard_normal((b, kvh, S, d), np.float32)
    vn = rng.standard_normal((b, kvh, S, d), np.float32)
    if kv_itemsize == 2:     # the bf16 cache's values, widened to fp32 exactly
        kn, vn = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in (kn, vn))
    lengths = np.array([1, S, 150], np.int32)                     # 1, full and ragged
    plan = (S, 1) if splits == "one" else (DECODE_TILE, S // DECODE_TILE)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    ours = _kernel_arithmetic(q, k, v, lengths, plan, kv_itemsize)
    pallas = np.asarray(jax_flash_decode(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                                         jnp.asarray(lengths), interpret=True))
    np.testing.assert_allclose(ours.numpy(), pallas, atol=TOL, rtol=TOL)
    ref = ref_decode(q, k, v, torch.from_numpy(lengths))
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,kvh,S,sms", [
    (8, 8, 544, H100_SMS),       # llama3.2-3b decode at batch 8
    (8, 32, 520, H100_SMS),      # zamba2-2.7b decode at batch 8
    (1, 8, 544, H100_SMS),
    (64, 8, 544, H100_SMS),      # more rows than the plan needs to split for
    (1, 1, 32768, H100_SMS),     # a long cache
    (2, 2, 40, H100_SMS),        # shorter than a tile
    (1, 1, 1, H100_SMS),
    (8, 8, 544, 114),            # H100 PCIe
    (3, 2, 100, 1),
])
def test_split_plan_covers_the_cache_in_whole_tiles(b, kvh, S, sms):
    split_len, n_splits = decode_plan(b, kvh, S, sms)
    assert split_len > 0 and split_len % DECODE_TILE == 0          # whole tiles
    assert n_splits * split_len >= S                               # cover [0, S)
    assert (n_splits - 1) * split_len < S                          # none empty at length S
    assert 1 <= n_splits <= DECODE_MAX_SPLITS                      # one cluster
    # all blocks resident at once: no more than fit, unless one split each
    # is already more
    resident = DECODE_BLOCKS_PER_SM * sms
    assert b * kvh * n_splits <= max(resident, b * kvh)
    # and as many as fit, unless there are fewer tiles or more than a cluster
    # holds; rounding the splits up to whole tiles at most halves their number
    tiles = -(-S // DECODE_TILE)
    assert 2 * n_splits >= min(resident // (b * kvh), tiles, DECODE_MAX_SPLITS)
    assert decode_plan(b, kvh, S, sms) == (split_len, n_splits)    # pure


def test_split_plan_at_the_main_path_shapes():
    """llama: 5 splits of 128 keys, 320 blocks (2.4 per SM); zamba2: one
    split, 256 blocks (1.9 per SM)."""
    assert decode_plan(8, 8, 544, H100_SMS) == (128, 5)
    assert decode_plan(8, 32, 520, H100_SMS) == (576, 1)


@pytest.mark.parametrize("d,itemsize,want", [
    (128, 2, (8, 4)),        # llama: 16 lanes a row, 2 rows a warp
    (80, 2, (12, 4)),        # zamba2: 10 lanes a row, 3 rows a warp
    (16, 2, (64, 4)),
    (128, 4, (4, 4)),        # fp32 cache: a row fills a warp
    (80, 4, (4, 4)),         # 20 lanes a row
])
def test_decode_geometry(d, itemsize, want):
    assert decode_geometry(d, itemsize) == want
