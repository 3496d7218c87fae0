"""The feasibility kernel's launch plan and its partition of the work, on the CPU.

``feasible_kernel`` (``repro_torch/kernels/csrc/feasibility.cu``) runs
only on a card; ``feasible_plan`` (``kernels/feasibility.py``) computes its
launch in Python. ``_loads`` repeats the kernel's index arithmetic in
numpy: which thread loads which vertices, as vectors or element by
element, and so which bytes of the ``[U, V]`` mask it stores (each thread
its vertices' byte of every row of its block). The tests hold that every
vertex is loaded once and every (row, vertex) written once, that vector
loads are taken only at aligned addresses, and that the main path's
columns (LLNL Quartz: 117,703 vertices, T 4, agg rows 16 bytes apart) take
the vector path. The kernel itself is held bit-exact against
``ref_feasible`` on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels.feasibility import ROWS_PER_BLOCK, THREADS, VPT, feasible_plan

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
          / "feasibility.cu")
VS = [1, 3, 4, 5, 1023, 1024, 1025, 117_703]
US = [1, 6, 32, 33, 65]
# element bytes of the vertex columns
COLUMNS = {"vtype": 4, "vok": 1, "vsize": 4, "vmask": 8}


def _loads(plan, V):
    """(vertex, vector): for every vertex a thread covers, the vertex and
    whether it is loaded in a whole group of ``vpt`` (the vector path);
    and the first vertex of every group."""
    span = plan.vpt * plan.threads
    v0 = np.arange(plan.grid[0]) * span
    n = np.minimum(span, V - v0)
    first = np.arange(plan.threads) * plan.vpt
    vt = (v0[:, None] + first[None, :]).ravel()
    whole = (first[None, :] + plan.vpt <= n[:, None]).ravel()
    k = np.arange(plan.vpt)
    inside = ((first[None, :, None] + k) < n[:, None, None]).reshape(len(vt), plan.vpt)
    vert = (vt[:, None] + k)[inside]
    return vert, np.repeat(whole, plan.vpt).reshape(len(vt), plan.vpt)[inside], vt, whole


@pytest.mark.parametrize("U", US)
@pytest.mark.parametrize("V", VS)
def test_every_mask_byte_is_written_once(V, U):
    """Each (row, vertex) of the [U, V] mask is written exactly once, by
    the thread that loads the vertex, once for each row of its block
    (blocks along grid y take 32 rows each); a warp's stores of a row
    cover neighbouring bytes."""
    plan = feasible_plan(V, U, 4, 4, 16)
    vert, _, _, _ = _loads(plan, V)
    rows = np.arange(plan.grid[1] * ROWS_PER_BLOCK)
    rows = rows[rows < U]
    written = (rows[:, None] * V + vert[None, :]).ravel()
    counts = np.bincount(written, minlength=U * V)
    assert len(counts) == U * V and np.all(counts == 1)
    warp = vert[:32 * VPT]                             # the first warp's vertices, in order
    assert np.array_equal(warp, np.arange(min(V, 32 * VPT)))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("T,stride", [(1, 4), (1, 5), (1, 8), (1, 9), (4, 4), (4, 5),
                                      (4, 8), (4, 9), (5, 5), (5, 8), (5, 9), (8, 8), (8, 9)])
def test_vector_loads_only_where_aligned(T, stride, offset):
    """Every vertex is loaded by exactly one thread. A whole group of
    ``vpt`` is loaded as vectors only where every column's address is a
    multiple of the vector's width (columns that start one vertex into
    their storage are not), and agg rows as one int4 only where T is 4 and
    each row's address is 16-byte aligned; the main path's columns take
    both vector paths."""
    base = 1 << 20                                       # a 16-byte aligned allocation
    addr = {name: base + offset * size for name, size in COLUMNS.items()}
    agg_addr = base + offset * stride * 4
    align = min(a & -a for a in [*addr.values(), agg_addr, 16])
    for V in VS:
        plan = feasible_plan(V, 6, T, stride, align)
        vert, _, vt, whole = _loads(plan, V)
        assert np.array_equal(np.sort(vert), np.arange(V))
        vec = vt[whole] if plan.vec_cols else vt[:0]
        for name, size in COLUMNS.items():
            piece = min(16, size * VPT)
            assert np.all((addr[name] + vec * size) % piece == 0), name
        if plan.vec_agg:
            rows = (vt[whole][:, None] + np.arange(VPT)).ravel()
            assert T == 4 and np.all((agg_addr + rows * stride * 4) % 16 == 0)
        assert plan.vec_cols == (offset == 0)
        assert plan.vec_agg == (offset == 0 and T == 4 and stride % 4 == 0)
        if plan.vec_cols and V >= VPT * THREADS:
            assert whole.sum() * VPT >= V - VPT          # only the ragged tail is per element


@pytest.mark.parametrize("T", [0, 1, 4, 5, 8, 256])
@pytest.mark.parametrize("U", US)
def test_plan_grid(U, T):
    """The grid covers V and U with no empty block, and a block's request
    rows fit the lanes of a warp."""
    assert ROWS_PER_BLOCK == 32
    for V in VS:
        plan = feasible_plan(V, U, T, max(T, 1), 16)
        span = VPT * THREADS
        gx, gy = plan.grid
        assert (gx - 1) * span < V <= gx * span
        assert (gy - 1) * ROWS_PER_BLOCK < U <= gy * ROWS_PER_BLOCK


def test_main_path_plan():
    """At Quartz (117,703 vertices, 6 request shapes, T 4, agg [V, 4]) the
    plan is VPT vertices a thread in blocks of THREADS, every
    column and agg row on the vector path, and more blocks than the
    H100's 132 SMs."""
    plan = feasible_plan(117_703, 6, 4, 4, 16)
    assert (plan.vpt, plan.threads) == (VPT, THREADS)
    assert plan.vec_cols and plan.vec_agg
    assert plan.grid == (-(-117_703 // (VPT * THREADS)), 1) and plan.grid[0] >= 132


def test_plan_is_the_kernels():
    """The plan's vertices a thread, block size and rows a block are the
    constants the kernel is compiled with (``feasible_fwd`` refuses a plan
    that differs)."""
    text = SOURCE.read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert (consts["kVpt"], consts["kThreads"], consts["kRowsPerBlock"]) == (
        VPT, THREADS, ROWS_PER_BLOCK)
    assert "if (plan[0] != kVpt || plan[1] != kThreads)" in text
