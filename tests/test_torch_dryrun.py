"""The port's dry-run (``launch/dryrun.py``) and its tally (``launch/tally.py``)
against JAX's (``repro/launch/dryrun.py``, ``repro/launch/hloparse.py``).

* ``argument_size_in_bytes`` of every (arch x shape) cell on the
  production meshes (16, 16) and (2, 16, 16): the port's, from one rank
  of a fake world of 256 and of 512 in a subprocess (no step runs), equals
  the sum over JAX's ``build_cell`` arguments (parameters, optimizer state,
  inputs, cache; decode's scalar position aside) of each one's
  ``sharding.shard_shape`` times its itemsize, exactly; the mesh raises on
  a smaller world;
* the twin of ``tests/test_hloparse.py::test_analyze_trip_count_weighting``:
  a synthetic step (12 trips of an fp32 [8, 16] all-gather, a dot and an
  [8, 8] all-reduce, then a bf16 [4, 8, 16] all-gather and a dot) on a gloo
  world of 4 gives the analyzer's numbers;
* ``dot_flops_per_device`` of reduced llama3.2-3b's train, prefill and
  decode cells and reduced qwen3-moe's decode cell (its experts split over
  "model" in the dispatch) on a ("data" 2, "model" 2) mesh, at the last
  model rank, against ``analyze(compiled.as_text()).dot_flops`` of JAX's
  compiled step on a 4-device mesh of Auto axes, within ``FLOPS_TOL``;
* each kernel wrapper's report (``counts_as``): what its plain version
  counts on the same arguments, products and result bytes;
* the tally of the reduced twins of ``chip_smoke.py`` with each kernel
  replaced by a stand-in that writes the kernel's output layout: the same
  as on the plain path, every field.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from torch_dist_harness import ROOT, run_jax_oracle, run_world

WORLD = 4
ARCH = "llama3.2-3b"
SEQ, BATCH = 32, 4
FLOP_MESH = (2, 2)
FLOP_MODES = ("train", "prefill", "decode")
MOE_ARCH = "qwen3-moe-30b-a3b"
# the cells of the FLOPs check: name -> (arch, mode)
FLOP_CELLS = {**{m: (ARCH, m) for m in FLOP_MODES}, "moe_decode": (MOE_ARCH, "decode")}
# the port's count at its last model rank against JAX's per-device count
FLOPS_TOL = 0.02

_CELLS = """
from repro{pkg}.configs.registry import ARCH_IDS, get_config, shapes_for
CELLS = [(a, s.name) for a in ARCH_IDS for s in shapes_for(get_config(a))]
"""

JAX_ARGS = _CELLS.format(pkg="") + """
import json
import jax.numpy as jnp
from repro.launch.dryrun import build_cell
out = {}
for multi_pod in (False, True):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:int(np.prod(shape))])
    for arch, sname in CELLS:
        cfg, model, fn, args = build_cell(arch, sname, mesh)
        if sname in ("decode_32k", "long_500k"):
            args = args[:3]                       # the scalar position aside
        total = sum(int(np.prod(l.sharding.shard_shape(l.shape))) * jnp.dtype(l.dtype).itemsize
                    for l in jax.tree_util.tree_leaves(args))
        out[f"{arch}|{sname}|{int(multi_pod)}"] = total
save(args=np.asarray(json.dumps(out)))
"""

PORT_ARGS = _CELLS.format(pkg="_torch") + """
import json
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.dryrun import argument_bytes, build_cell, default_rank
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPES
out, raised = {}, []
for multi_pod in (False, True):
    dims = (2, 16, 16) if multi_pod else (16, 16)
    n = int(__import__("math").prod(dims))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n - 1)
    try:
        make_production_mesh(multi_pod=multi_pod)
    except ValueError:
        raised.append(multi_pod)
    dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=default_rank(dims), world_size=n)
    mesh = make_production_mesh(multi_pod=multi_pod)
    out[f"mesh|{int(multi_pod)}"] = [list(mesh.shape), list(mesh.mesh_dim_names),
                                     list(mesh.get_coordinate())]
    for arch, sname in CELLS:
        model = build_cell(arch, SHAPES[sname], mesh, device="meta")
        out[f"{arch}|{sname}|{int(multi_pod)}"] = argument_bytes(model, SHAPES[sname])
    dist.destroy_process_group()
print(json.dumps({"bytes": out, "raised": raised}))
"""

FLOPS_ORACLE = f"""
import dataclasses
from repro.configs.registry import get_config
from repro.launch.hloparse import analyze
from repro.models.config import ShapeConfig
from repro.models.model import make_model
from repro.parallel.sharding import Rules, ShardingCtx
mesh = jax.make_mesh({FLOP_MESH!r}, ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def with_sh(shapes, shardings):
    return jax.tree_util.tree_map(
        lambda sd, sh: jax.ShapeDtypeStruct(sd.shape, sd.dtype, sharding=sh), shapes, shardings)


for name, (arch, mode) in {FLOP_CELLS!r}.items():
    model = make_model(get_config(arch).reduced(), ShardingCtx(Rules(), mesh))
    shape = ShapeConfig(mode, {SEQ}, {BATCH}, mode)
    p = with_sh(model.param_shapes(), model.param_shardings())
    x = with_sh(model.input_specs(shape), model.input_shardings(shape))
    if mode == "train":
        fn = jax.jit(model.train_step)
        args = (p, with_sh(model.opt_shapes(), model.opt_shardings()), x)
    elif mode == "prefill":
        fn = jax.jit(model.prefill_step, out_shardings=(None, model.cache_shardings()))
        args = (p, x)
    else:
        fn = jax.jit(model.serve_step, out_shardings=(None, model.cache_shardings()))
        args = (p, with_sh(model.cache_specs(shape), model.cache_shardings()), x,
                jax.ShapeDtypeStruct((), jax.numpy.int32))
    with mesh:
        compiled = fn.lower(*args).compile()
    save(**{{name: analyze(compiled.as_text()).dot_flops}})
"""


# the reduced cell (arch, shape) through ``run_cell`` on the CPU twice: on
# the plain path, then with each kernel a stand-in (``counts_as`` its plain
# version) that writes the kernel's output layout: attention's [b, h, s, d]
# a view of a [b, s, h, d] buffer, the others contiguous
LAYOUT_TWIN = """
import json, sys
from repro_torch.kernels import ops, ref, flash_attention as fa, ssd_scan as ss
from repro_torch.launch.dryrun import run_cell
from repro_torch.tally_hooks import counts_as
arch, shape = sys.argv[1:3]


def run():
    return run_cell(arch, shape, device="cpu", reduced=True, tag="layout_twin", verbose=False)


def bshd(t):
    return t.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)


def dense(out):
    return tuple(t.contiguous() for t in out) if isinstance(out, tuple) else out.contiguous()


def attn(q, k, v, causal=True, window=0, return_lse=False):
    out = ref.ref_attention(q, k, v, causal=causal, window=window, return_lse=return_lse)
    return (bshd(out[0]), out[1].contiguous()) if return_lse else bshd(out)


plain = run()
fa.flash_attention = ops.flash_attention = counts_as(ref.ref_attention)(attn)
fa.flash_attention_bwd = counts_as(ref.ref_attention_bwd)(
    lambda *a, **kw: tuple(bshd(t) for t in ref.ref_attention_bwd(*a, **kw)))
fa.flash_decode = ops.flash_decode = counts_as(ref.ref_decode)(
    lambda *a, **kw: dense(ref.ref_decode(*a, **kw)))
ss.ssd_chunk = counts_as(ref.ref_ssd_chunk)(lambda *a, **kw: dense(ref.ref_ssd_chunk(*a, **kw)))
ss.ssd_chunk_bwd = counts_as(ref.ref_ssd_chunk_bwd)(
    lambda *a, **kw: dense(ref.ref_ssd_chunk_bwd(*a, **kw)))
ops._on_cuda = fa._on_card = ss._on_card = lambda t: True
print(json.dumps([plain, run()]))
"""
TALLY_KEYS = ("ok", "dot_flops_per_device", "collectives", "collective_counts",
              "collective_bytes_ag2d", "collective_bytes_other2d", "collective_bytes_hi",
              "result_bytes_per_device")


# ---------------------------------------------------------------------- #
# the port's side, on every rank of the gloo world
# ---------------------------------------------------------------------- #
def _synthetic_step():
    """hloparse's SYNTHETIC_HLO as a step of 4 ranks: 12 trips of an fp32
    all-gather of [2, 16] blocks into [8, 16], ag ag^T [8, 8] (contraction
    16) and its all-reduce; then a bf16 all-gather of [1, 8, 16] blocks into
    [4, 8, 16] and a^T a [16, 16] (contraction 8)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.tally import tally
    from repro_torch.parallel.sharding import all_gather_flat, all_reduce
    r = dist.get_rank()
    a = torch.arange(r * 32, r * 32 + 32, dtype=torch.float32).view(2, 16) / 100
    with tally() as t:
        for _ in range(12):
            ag = torch.empty(8, 16)
            all_gather_flat(ag, a, None)
            dot = ag @ ag.T
            all_reduce(dot, None)
        big = torch.empty(4, 8, 16, dtype=torch.bfloat16)
        all_gather_flat(big, torch.full((1, 8, 16), float(r), dtype=torch.bfloat16), None)
        whole = torch.empty(8, 16)
        all_gather_flat(whole, a, None, kind=None)          # a helper the caller counts
        dot9 = whole.T @ whole
    return t, float(dot9.sum())


def _flop_cells(rank):
    """This rank's tally of each ``FLOP_CELLS`` cell, reduced, on the (2, 2)
    mesh."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import build_cell, cell_arguments, run_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.tally import tally
    from repro_torch.models.config import ShapeConfig
    mesh = make_mesh(FLOP_MESH, ("data", "model"))
    out = {}
    for name, (arch, mode) in FLOP_CELLS.items():
        shape = ShapeConfig(mode, SEQ, BATCH, mode)
        model = build_cell(arch, shape, mesh, cfg_override=get_config(arch).reduced(),
                           device="cpu")
        args = cell_arguments(model, shape, torch.Generator().manual_seed(rank))
        with tally() as t:
            run_step(model, shape, args)
        out[name] = t.as_dict()
    return out


def _port_world(rank, world):
    t, _ = _synthetic_step()
    return {"synthetic": (t.as_dict(), hasattr(t, "trip_counts")), "flops": _flop_cells(rank)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    with ThreadPoolExecutor(3) as pool:
        jax_args = pool.submit(run_jax_oracle, JAX_ARGS, tmp, devices=512, timeout=600.0)
        jax_flops = pool.submit(run_jax_oracle, FLOPS_ORACLE, tmp, timeout=600.0)
        port_args = pool.submit(subprocess.run, [sys.executable, "-c", PORT_ARGS],
                                capture_output=True, text=True, timeout=600,
                                env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        ranks = run_world(_port_world, WORLD, tmp, timeout=600.0)
        proc = port_args.result()
        assert proc.returncode == 0, proc.stderr
        return dict(jax_args=json.loads(str(jax_args.result()["args"])),
                    jax_flops=jax_flops.result(), port=json.loads(proc.stdout), ranks=ranks)


def _cells():
    from repro_torch.configs.registry import ARCH_IDS, get_config, shapes_for
    return [(a, s.name) for a in ARCH_IDS for s in shapes_for(get_config(a))]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch,shape", _cells())
def test_argument_bytes_match_jax_shard_shapes(arch, shape, multi_pod, results):
    """A rank's parameter, optimizer-state, input and cache shards on the
    production mesh hold exactly the bytes of JAX's ``build_cell``
    arguments' shard shapes (the batch axes dropped where the batch does not
    divide, zamba2's window at ``long_500k``)."""
    key = f"{arch}|{shape}|{int(multi_pod)}"
    got = results["port"]["bytes"][key]
    assert sum(got.values()) == results["jax_args"][key], got
    assert ("opt_state" in got) == (shape == "train_4k")
    assert ("cache" in got) == (shape in ("decode_32k", "long_500k"))


def test_production_meshes_under_a_fake_world(results):
    """(16, 16) over ("data", "model") and (2, 16, 16) over ("pod", "data",
    "model"); the default rank sits at data (and pod) 0 and the last model
    coordinate; a world one rank short raises."""
    port = results["port"]
    assert port["bytes"]["mesh|0"] == [[16, 16], ["data", "model"], [0, 15]]
    assert port["bytes"]["mesh|1"] == [[2, 16, 16], ["pod", "data", "model"], [0, 0, 15]]
    assert port["raised"] == [False, True]


def test_tally_twin_of_hloparse_trip_count_weighting(results):
    """``test_analyze_trip_count_weighting``'s numbers from a step that runs
    its loop: all-gather 12 x 512 + 1024 bytes, all-reduce 12 x 256, dot
    FLOPs 12 x 2 x 8 x 8 x 16 + 2 x 16 x 16 x 8, the rank <= 2 all-gathers
    and reductions and the rank >= 3 results in their buckets; a gather
    whose caller counts it adds nothing; no trip counts (eager code runs
    every trip)."""
    for t, has_trips in (r["synthetic"] for r in results["ranks"]):
        assert t["collective_bytes"] == {"all-gather": 12 * 512 + 1024, "all-reduce": 12 * 256}
        assert t["collective_counts"] == {"all-gather": 13, "all-reduce": 12}
        assert t["dot_flops"] == 12 * 2 * 8 * 8 * 16 + 2 * 16 * 16 * 8
        assert t["collective_bytes_ag2d"] == 12 * 512
        assert t["collective_bytes_other2d"] == 12 * 256
        assert t["collective_bytes_hi"] == 1024
        assert not has_trips


@pytest.mark.parametrize("mode", list(FLOP_CELLS))
def test_dot_flops_match_jax_compiled_step(mode, results):
    """The reduced ``FLOP_CELLS`` cell on ("data" 2, "model" 2): the last
    model rank's dot FLOPs (aten products, attention at full sq x skv
    scores over its K/V prefix; MoE decode's products of the rank's E / 2
    experts over its data rank's C / 2 slots) within ``FLOPS_TOL`` of
    JAX's per-device ``analyze(...).dot_flops``, on every rank of the last
    model column; the first column's attention sees a shorter prefix and
    counts less."""
    want = float(results["jax_flops"][mode])
    ranks = results["ranks"]
    last = [ranks[r]["flops"][mode]["dot_flops"] for r in range(WORLD) if r % 2 == 1]
    for got in last:
        assert abs(got - want) <= FLOPS_TOL * want, (got, want)
    if FLOP_CELLS[mode][1] != "decode":
        assert all(ranks[r]["flops"][mode]["dot_flops"] < last[0]
                   for r in range(WORLD) if r % 2 == 0)


@pytest.mark.parametrize("name", ["attention", "attention_lse", "attention_bwd", "decode",
                                  "decode_window", "ssd_chunk", "ssd_chunk_bwd"])
def test_kernel_reports_are_their_plain_versions_counts(name):
    """A wrapper decorated ``counts_as(plain)`` adds, inside ``tally()``,
    the products and result bytes that ``plain`` counts when it runs on the
    same arguments (here it runs on the CPU), and none of its own ops."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.launch.tally import tally
    from repro_torch.tally_hooks import counts_as
    g = torch.Generator().manual_seed(0)

    def rn(*s):
        return torch.randn(*s, generator=g)
    q, k, o = rn(2, 4, 8, 16), rn(2, 2, 12, 16), rn(2, 4, 8, 16)
    x, dt, A, B = rn(1, 16, 4, 8), torch.rand(1, 16, 4, generator=g), -torch.rand(4), rn(1, 16, 1, 8)
    lengths, starts = torch.tensor([5, 12], dtype=torch.int32), torch.tensor([2, 0], dtype=torch.int32)
    y = ref.ref_ssd_chunk(x, dt, A, B, B, 8)
    calls = {"attention": (ref.ref_attention, (q, k, k), {"causal": True, "window": 0}),
             "attention_lse": (ref.ref_attention, (q, k, k), {"window": 4, "return_lse": True}),
             "attention_bwd": (ref.ref_attention_bwd, (q, k, k, o, rn(2, 4, 8), o), {}),
             "decode": (ref.ref_decode, (q[:, :, :1], k, k, lengths), {}),
             "decode_window": (ref.ref_decode, (q[:, :, :1], k, k, lengths, starts, True), {}),
             "ssd_chunk": (ref.ref_ssd_chunk, (x, dt, A, B, B, 8), {}),
             "ssd_chunk_bwd": (ref.ref_ssd_chunk_bwd, (x, dt, A, B, B, 8) + y, {})}
    plain, args, kwargs = calls[name]

    def kernel(*a, **kw):            # a stand-in whose own ops must not count
        torch.empty(1000)
        return torch.ones(3) @ torch.ones(3)
    with tally() as want:
        plain(*args, **kwargs)
    with tally() as got:
        counts_as(plain)(kernel)(*args, **kwargs)
    assert want.dot_flops > 0
    assert (got.dot_flops, got.result_bytes) == (want.dot_flops, want.result_bytes)


@pytest.mark.parametrize("arch,shape", [("llama3.2-3b", "train_4k"), ("zamba2-2.7b", "long_500k")])
def test_tally_is_the_same_under_the_kernels_layouts(arch, shape):
    """``chip_smoke.py``'s reduced twins, whose tally must be the same on
    the card as on the CPU: with every kernel a stand-in that reports its
    plain version's count and writes the kernel's output layout (which the
    layout copies after it follow), each tally field is the plain path's
    exactly, forward and backward."""
    proc = subprocess.run([sys.executable, "-c", LAYOUT_TWIN, arch, shape], capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    plain, layout = json.loads(proc.stdout.strip().splitlines()[-1])
    assert plain["ok"], plain.get("error")
    assert {k: plain[k] for k in TALLY_KEYS} == {k: layout[k] for k in TALLY_KEYS}
