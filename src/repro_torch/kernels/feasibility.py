"""Wrapper of the CUDA feasibility kernel (``csrc/feasibility.cu``).

``feasible_mask`` replaces ``_feasible_pallas`` in
``repro/kernels/feasibility.py``: the ``[U, V]`` root-feasibility mask of
a deduplicated request matrix against the flat graph's vertex columns,
which ``core/flatgraph.py::FlatGraph.feasible_roots_batch`` hands it.
It takes CUDA tensors only and launches the kernel or raises: the plain
version is ``ref.py::ref_feasible``, and ``ops.py`` picks between the
two by the tensor's device. Each launch adds one to
``build.LAUNCHES["feasibility"]``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .build import LAUNCHES

ROWS_PER_BLOCK = 32          # request rows a block keeps in shared memory (kRowsPerBlock)
MAX_TYPES = 256              # shared memory of a block: 32 * (16 + 4T) bytes <= 48 KB
MAX_ROWS = 65535 * ROWS_PER_BLOCK     # grid y of 65535 blocks


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("feasibility")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.feasible_fwd.argtypes = [P, P, P, P, P, L, I, I, P, P, P, P, I, P, P]
    lib.feasible_fwd.restype = I
    return lib


def _check(name: str, t: torch.Tensor, dtypes: tuple, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def feasible_mask(vtype: torch.Tensor, vok: torch.Tensor, vsize: torch.Tensor,
                  vmask: torch.Tensor, agg: torch.Tensor, tid: torch.Tensor,
                  msize: torch.Tensor, rmask: torch.Tensor,
                  need: torch.Tensor) -> torch.Tensor:
    """[U, V] uint8, 1 where request row ``u`` can root a match at vertex ``v``.

    Vertex columns: ``vtype``, ``vsize`` int32 [V]; ``vok`` bool or uint8
    [V] (free and present); ``vmask`` int64 [V] property bits; ``agg``
    int32 [V, T] with any row stride and unit column stride. Request
    rows: ``tid``, ``msize`` int32 [U]; ``rmask`` int64 [U]; ``need``
    int32 [U, T]. All on one CUDA device; the 1-d columns and ``need``
    contiguous."""
    if vtype.device.type != "cuda":
        raise ValueError(f"vtype must be a CUDA tensor, got {vtype.device}")
    dev = vtype.device
    V, U = vtype.shape[0], tid.shape[0]
    T = agg.shape[1] if agg.dim() == 2 else -1
    i32, i64 = (torch.int32,), (torch.int64,)
    for name, t, dtypes, shape in (
            ("vtype", vtype, i32, (V,)), ("vok", vok, (torch.bool, torch.uint8), (V,)),
            ("vsize", vsize, i32, (V,)), ("vmask", vmask, i64, (V,)),
            ("agg", agg, i32, (V, T)), ("tid", tid, i32, (U,)),
            ("msize", msize, i32, (U,)), ("rmask", rmask, i64, (U,)),
            ("need", need, i32, (U, T))):
        _check(name, t, dtypes, shape, dev)
        if name != "agg" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if T > 1 and agg.stride(1) != 1:
        raise ValueError("agg: the type columns of a row must be contiguous")
    if T > MAX_TYPES:
        raise ValueError(f"{T} types > {MAX_TYPES}")
    if U > MAX_ROWS:
        raise ValueError(f"{U} request rows > {MAX_ROWS}")
    out = torch.empty((U, V), dtype=torch.uint8, device=dev)
    if U == 0 or V == 0:
        return out
    with torch.cuda.device(dev):
        rc = _lib().feasible_fwd(
            vtype.data_ptr(), vok.data_ptr(), vsize.data_ptr(), vmask.data_ptr(),
            agg.data_ptr(), agg.stride(0), V, T, tid.data_ptr(), msize.data_ptr(),
            rmask.data_ptr(), need.data_ptr(), U, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"feasibility: CUDA error {rc} at launch")
    LAUNCHES["feasibility"] += 1
    return out
