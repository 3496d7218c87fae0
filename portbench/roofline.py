"""The yardstick's arithmetic: one H100's peaks, each kernel's least time
from its shapes, and a step's model FLOPs.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit (dense,
no sparsity). A bound is the larger of operations over the peak rate and
bytes over HBM bandwidth, each input read once and each output written
once; the causal half of attention and of the SSD's chunks is counted.
The SSD kernels are fp32-accurate by three TF32 passes (3xTF32), so their
operations are priced at a third of the TF32 rate.
"""
from __future__ import annotations

from .reference import family

BF16_FLOPS = 989e12           # dense bf16 tensor-core peak
TF32_FLOPS = 495e12           # dense TF32 tensor-core peak
HBM_BYTES_PER_S = 3.35e12


def _bound(flops: float, nbytes: float, rate: float):
    """(seconds, flops, bytes) of the least time for the work."""
    return max(flops / rate, nbytes / HBM_BYTES_PER_S), flops, nbytes


def attention_fwd(b, h, kvh, sq, skv, d, itemsize=2):
    """The forward's two products (S = Q K^T, O = P V) over the causal
    pairs, query rows aligned to the end of the keys; q and o, k and v
    moved once."""
    pairs = sq * (skv - sq) + sq * (sq + 1) // 2
    flops = 4.0 * d * pairs * b * h
    nbytes = itemsize * (2.0 * b * h * sq * d + 2.0 * b * kvh * skv * d)
    return _bound(flops, nbytes, BF16_FLOPS)


def attention_bwd(b, h, kvh, sq, skv, d, itemsize=2):
    """The backward's five products (S, dP, dV, dK, dQ) over the causal
    pairs; q, k, v, o, dO and the logsumexp read once, dq, dk, dv written
    once."""
    pairs = sq * (skv - sq) + sq * (sq + 1) // 2
    flops = 5 * 2.0 * d * pairs * b * h
    nbytes = itemsize * (4.0 * b * h * sq * d + 4.0 * b * kvh * skv * d) + 4.0 * b * h * sq
    return _bound(flops, nbytes, BF16_FLOPS)


def ssd_fwd(b, s, H, P, G, N, Q):
    """``ssd_chunk``: C B^T once per (batch, chunk, group), and per head
    the masked scores times x and the chunk's state, the causal half."""
    nc, tri = s // Q, Q * (Q + 1) / 2
    flops = b * nc * (G * tri * N * 2.0 + H * (tri * P * 2.0 + Q * N * P * 2.0))
    nbytes = 4.0 * (2 * b * s * H * P + b * s * H + H + 2 * b * s * G * N
                    + b * nc * H * (N * P + 1))
    return _bound(3 * flops, nbytes, TF32_FLOPS)[0], flops, nbytes


def ssd_bwd(b, s, H, P, G, N, Q):
    """``ssd_chunk_bwd``: per head gM = gy u^T and M^T gy over the causal
    pairs, B gstate and (w o u) gstate^T; per group S = C B^T again, G_S B
    and G_S^T C. x, dt, A, B, C, gy, gstates and gdecay read once, the
    five gradients written once."""
    nc, tri = s // Q, Q * (Q + 1) / 2
    flops = b * nc * (H * (4.0 * tri * P + 4.0 * Q * N * P) + G * 6.0 * tri * N)
    nbytes = 4.0 * (3 * b * s * H * P + 2 * b * s * H + 2 * H + 4 * b * s * G * N
                    + b * nc * H * (N * P + 1))
    return _bound(3 * flops, nbytes, TF32_FLOPS)[0], flops, nbytes


def matrix_params(c: dict) -> int:
    """The parameters a token is multiplied by: every layer's matrices, as
    its family counts them (``reference/<family>.py``), and the LM head
    (the tied embedding counted once, as the head); the embedding's
    lookup and the norms are left out. ``c`` as ``reference.sizes``."""
    return c["n_layers"] * family(c).matrix_params(c) + c["d_model"] * c["vocab"]


def forward_flops(c: dict, b: int, s: int) -> float:
    """Model FLOPs of one forward over [b, s]: 2 N per token, and each
    layer's products beside its matrices (causal attention's, the SSD's
    chunked ones), as its family counts them."""
    return 2.0 * matrix_params(c) * b * s + c["n_layers"] * family(c).mixer_flops(c, b, s)


def train_flops(c: dict, b: int, s: int) -> float:
    """A training step's model FLOPs: the forward and its backward (twice
    the forward); remat's recomputed forward is not counted."""
    return 3.0 * forward_flops(c, b, s)
