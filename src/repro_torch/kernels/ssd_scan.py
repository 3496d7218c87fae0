"""Wrapper of the CUDA SSD intra-chunk kernels (``csrc/ssd_chunk.cu``).

``ssd_chunk`` replaces ``ssd_chunk_pallas`` in ``repro/kernels/ssd_scan.py``
with the same signature and layouts: per (batch, chunk, head) the masked
quadratic form ``y_intra``, the chunk's state and its total decay-log. The
inter-chunk recurrence is ``ops.py::ssd_scan_op``. It takes CUDA tensors
only and launches the kernels or raises: the plain version is
``ref.py::ref_ssd_chunk``, and ``ops.py`` picks between the two by the
tensor's device. One call is two launches, ``ssd_scores_kernel`` (C B^T
once per group, and the cumulative decay) and ``ssd_chunk_kernel`` (the
per-head products), through a scratch the wrapper allocates; each call
adds one to ``build.LAUNCHES["ssd_chunk"]``.

``ssd_chunk_bwd`` is the backward kernel (the JAX package has no Pallas
backward: it differentiates the jnp ``ssd_chunked`` with XLA): the
gradients of x, dt, A, B and C from those of the three outputs, six
launches a call (``ssd_scores_kernel`` again; the per-head kernel; the state
and pair kernels, which sum gB's state term and G_S over each group's heads
in ``bwd_slices`` ordered slices; the per-group kernel and the gA kernel),
one count in ``build.LAUNCHES["ssd_chunk_bwd"]``; its plain version is
``ref.py::ref_ssd_chunk_bwd``. ``SsdChunk`` pairs the two for autograd.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build
from .build import LAUNCHES
from ..tally_hooks import counts_as
from .ref import ref_ssd_chunk, ref_ssd_chunk_bwd

MAX_CHUNK = 256          # kMaxQ: the chunk's dt, seg and weights sit in shared memory
MAX_STATE = 128          # kMaxN: columns of the B and C tiles in shared memory
MAX_HEAD_DIM = 64        # kMaxP: columns of the dt*x tile in shared memory
BWD_SLICES = 4           # the backward's head slices a group, at most: its scratch holds one
                         # part of G_S and of gB's state term a slice, whatever the head count


def bwd_slices(H: int, G: int) -> int:
    """The slices ``ssd_chunk_bwd`` cuts each group's ``H / G`` heads into:
    slice ``k`` of ``n`` sums heads ``[k (H/G) // n, (k + 1) (H/G) // n)``
    of the group in order, and the slices are summed in order after."""
    return min(BWD_SLICES, H // G)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of a built ``ssd_chunk.cu``'s
    C entry points on ``lib``, and return it."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssd_chunk_fwd.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P, P]
    lib.ssd_chunk_fwd.restype = I
    lib.ssd_chunk_scratch_floats.argtypes = [I, I, I, I, I]
    lib.ssd_chunk_scratch_floats.restype = ctypes.c_longlong
    lib.ssd_chunk_bwd.argtypes = [P] * 14 + [I] * 8 + [P, P]
    lib.ssd_chunk_bwd.restype = I
    lib.ssd_chunk_bwd_scratch_floats.argtypes = [I] * 7
    lib.ssd_chunk_bwd_scratch_floats.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build.load("ssd_chunk"))


def _check(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
           C: torch.Tensor, chunk: int) -> None:
    """Raise on inputs the kernels do not take."""
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != x.device:
            raise ValueError("x, dt, A, B and C must be on one device")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"x and B must be 4-d, got {tuple(x.shape)} and {tuple(B.shape)}")
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    for name, t, shape in (("dt", dt, (b, s, H)), ("A", A, (H,)), ("B", B, (b, s, G, N)),
                           ("C", C, (b, s, G, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if G < 1 or H % G:
        raise ValueError(f"{H} heads do not split into {G} groups")
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"chunk {chunk}: needs 1 <= chunk <= {MAX_CHUNK} dividing s = {s}")
    if P > MAX_HEAD_DIM or P % 4:
        raise ValueError(f"head_dim {P}: needs a multiple of 4 up to {MAX_HEAD_DIM}")
    if N > MAX_STATE:
        raise ValueError(f"state {N} > {MAX_STATE}")
    if x.stride(3) != 1 or B.stride(3) != 1 or C.stride(3) != 1 or not A.is_contiguous():
        raise ValueError("the last axis of x, B and C, and A, must be contiguous")
    if s // chunk > 65535 or b * G > 65535:
        raise ValueError(f"grid ({H}, {s // chunk}, {b} x {G}) too large")


def _strides(x, dt, B, C):
    return (ctypes.c_longlong * 12)(
        x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1), dt.stride(2),
        B.stride(0), B.stride(1), B.stride(2), C.stride(0), C.stride(1), C.stride(2))


@counts_as(ref_ssd_chunk)
def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor, chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD. x: [b, s, H, P]; dt: [b, s, H]; A: [H]; B, C:
    [b, s, G, N]; all fp32 on one CUDA device, ``s % chunk == 0``, head h
    reading group ``h // (H / G)``. x, dt, B and C may be strided views
    (the last axis of x, B and C contiguous); A is contiguous. Returns
    (y_intra [b, s, H, P], states [b, nc, H, N, P], decay_log [b, nc, H]),
    fp32 and contiguous."""
    _check(x, dt, A, B, C, chunk)
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc = s // chunk
    y = torch.empty((b, s, H, P), dtype=torch.float32, device=x.device)
    states = torch.empty((b, nc, H, N, P), dtype=torch.float32, device=x.device)
    decay = torch.empty((b, nc, H), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, states, decay
    with torch.cuda.device(x.device):
        lib = _lib()
        scratch = torch.empty(lib.ssd_chunk_scratch_floats(b, s, H, G, chunk),
                              dtype=torch.float32, device=x.device)
        rc = lib.ssd_chunk_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), states.data_ptr(), decay.data_ptr(), scratch.data_ptr(),
            b, s, H, P, G, N, chunk, _strides(x, dt, B, C),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk: CUDA error {rc} at launch")
    LAUNCHES["ssd_chunk"] += 1
    return y, states, decay


@counts_as(ref_ssd_chunk_bwd)
def ssd_chunk_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, chunk: int, gy: torch.Tensor, gstates: torch.Tensor,
                  gdecay: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The gradients (gx, gdt, gA, gB, gC) of ``ssd_chunk``'s inputs from
    those of its outputs: gy [b, s, H, P], gstates [b, nc, H, N, P] and
    gdecay [b, nc, H], fp32 on x's device (made contiguous here). The
    inputs as ``ssd_chunk`` takes them, views too. Returns fp32 contiguous
    tensors shaped as x, dt, A, B and C."""
    _check(x, dt, A, B, C, chunk)
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc = s // chunk
    for name, t, shape in (("gy", gy, (b, s, H, P)), ("gstates", gstates, (b, nc, H, N, P)),
                           ("gdecay", gdecay, (b, nc, H))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}, expected "
                             f"{shape} torch.float32 on {x.device}")
    gy, gstates, gdecay = gy.contiguous(), gstates.contiguous(), gdecay.contiguous()
    grads = [torch.empty(t.shape, dtype=torch.float32, device=x.device) for t in (x, dt, A, B, C)]
    if x.numel() == 0:
        return tuple(g.zero_() for g in grads)
    ns = bwd_slices(H, G)
    with torch.cuda.device(x.device):
        lib = _lib()
        scratch = torch.empty(lib.ssd_chunk_bwd_scratch_floats(b, s, H, G, N, chunk, ns),
                              dtype=torch.float32, device=x.device)
        rc = lib.ssd_chunk_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            gy.data_ptr(), gstates.data_ptr(), gdecay.data_ptr(),
            *(g.data_ptr() for g in grads), scratch.data_ptr(),
            b, s, H, P, G, N, chunk, ns, _strides(x, dt, B, C),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk_bwd: CUDA error {rc} at launch")
    LAUNCHES["ssd_chunk_bwd"] += 1
    return tuple(grads)


class SsdChunk(torch.autograd.Function):
    """``ssd_chunk`` with a gradient: the forward and backward kernels on
    CUDA tensors, the plain pair (``ref_ssd_chunk``, ``ref_ssd_chunk_bwd``)
    on CPU tensors. ``ops.ssd_scan_op`` calls it when a gradient is
    wanted. Saves the inputs (remat drops them with the rest of a block);
    the backward recomputes S and seg."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        fwd = ssd_chunk if _on_card(x) else ref_ssd_chunk
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return fwd(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, gy, gstates, gdecay):
        x, dt, A, B, C = ctx.saved_tensors
        bwd = ssd_chunk_bwd if _on_card(x) else ref_ssd_chunk_bwd
        return (*bwd(x, dt, A, B, C, ctx.chunk, gy, gstates, gdecay), None)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"
