"""Wrapper of the CUDA feasibility kernel (``csrc/feasibility.cu``).

``feasible_mask`` replaces ``_feasible_pallas`` in
``repro/kernels/feasibility.py``: the ``[U, V]`` root-feasibility mask of
a deduplicated request matrix against the flat graph's vertex columns,
which ``core/flatgraph.py::FlatGraph.feasible_roots_batch`` hands it.
It takes CUDA tensors only and launches the kernel or raises: the plain
version is ``ref.py::ref_feasible``, and ``ops.py`` picks between the
two by the tensor's device. Each launch adds one to
``build.LAUNCHES["feasibility"]``. ``feasible_plan`` is the launch plan
(the grid, which loads are vectors), computed here and passed to the
kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import build
from .build import LAUNCHES

ROWS_PER_BLOCK = 32          # request rows of a block, one a lane (kRowsPerBlock)
MAX_ROWS = 65535 * ROWS_PER_BLOCK     # grid y of 65535 blocks
# The kernel's kVpt and kThreads, which it checks at launch. VPT 2 measured
# fastest at Quartz, at 128 or 256 threads alike (PERF.md §6): 66 bytes of
# loads in flight a thread, 230 blocks of 8 warps for 117,703 vertices on
# 132 SMs
VPT = 2                      # vertices a thread
THREADS = 256                # threads a block


class FeasiblePlan(NamedTuple):
    vpt: int                 # consecutive vertices a thread loads and compares
    threads: int             # a block covers vpt * threads vertices
    grid: Tuple[int, int]    # (vertex blocks, blocks of ROWS_PER_BLOCK request rows)
    vec_cols: bool           # vtype, vok, vsize, vmask in vectors of vpt elements
    vec_agg: bool            # each agg row as one int4


def feasible_plan(V: int, U: int, T: int, agg_stride: int, base_alignment: int) -> FeasiblePlan:
    """The launch of ``feasible_kernel`` for V vertices, U request rows and
    T types, with agg's row stride in elements and ``base_alignment`` the
    largest power of two (bytes) dividing the address of every vertex
    column and of agg. Whole groups of ``VPT`` vertices are loaded as
    vectors where every column is 16-byte aligned; agg rows as one int4
    each where, besides, T is 4 and the rows lie a multiple of 16 bytes
    apart. Any other group, and the ragged tail of V, is loaded element
    by element (the kernel's general path)."""
    vec_cols = base_alignment % 16 == 0
    return FeasiblePlan(VPT, THREADS, (-(-V // (VPT * THREADS)), -(-U // ROWS_PER_BLOCK)),
                        vec_cols, vec_cols and T == 4 and agg_stride % 4 == 0)


def _alignment(*tensors: torch.Tensor) -> int:
    """The largest power of two up to 16 dividing every tensor's address."""
    bits = 16
    for t in tensors:
        bits |= t.data_ptr()
    return bits & -bits


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("feasibility")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.feasible_fwd.argtypes = [P, P, P, P, P, L, I, I, P, P, P, P, I, P, P, P]
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
                  msize: torch.Tensor, rmask: torch.Tensor, need: torch.Tensor) -> torch.Tensor:
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
    if U > MAX_ROWS:
        raise ValueError(f"{U} request rows > {MAX_ROWS}")
    out = torch.empty((U, V), dtype=torch.uint8, device=dev)
    if U == 0 or V == 0:
        return out
    plan = feasible_plan(V, U, T, agg.stride(0), _alignment(vtype, vok, vsize, vmask, agg))
    args = (ctypes.c_int * 6)(plan.vpt, plan.threads, *plan.grid, plan.vec_cols, plan.vec_agg)
    with torch.cuda.device(dev):
        rc = _lib().feasible_fwd(
            vtype.data_ptr(), vok.data_ptr(), vsize.data_ptr(), vmask.data_ptr(),
            agg.data_ptr(), agg.stride(0), V, T, tid.data_ptr(), msize.data_ptr(),
            rmask.data_ptr(), need.data_ptr(), U, out.data_ptr(), args,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"feasibility: CUDA error {rc} at launch")
    LAUNCHES["feasibility"] += 1
    return out
