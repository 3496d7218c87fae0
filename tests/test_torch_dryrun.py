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
* the tally of the reduced ``FLOP_CELLS`` on a ("data" 2, "model" 2) mesh
  against ``analyze(compiled.as_text())`` of JAX's compiled step on a
  4-device mesh of Auto axes: llama3.2-3b's train, prefill and decode
  cells, qwen3-moe's decode cell (its experts split over "model" in the
  dispatch), mamba2's three with ``ssm_seq_sharded`` off and on, llama
  with its vocab cut to 250 (an e-split embedding table, as mamba2's
  50,280) in prefill and decode, and llama's decode with
  ``mlp_seq_sharded``. At every rank of the last model column the dot
  FLOPs within ``FLOPS_TOL`` of JAX's per-device count, less the products
  that only GSPMD makes (``out_proj_gap``), and in every
  prefill and decode cell the weights' all-gathers
  (``collective_bytes_ag2d``) JAX's to the byte (qwen3-moe's decode
  routing aside, ``ROUTING_GAP``); the two flags move the port's FLOPs and
  weight gathers by what they move JAX's, those products aside;
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
SSM_ARCH = "mamba2-2.7b"
SEQ_SHARDED = {"ssm_seq_sharded": True}
# the cells of the tally check: name -> (arch, mode, config patch)
FLOP_CELLS = {**{m: (ARCH, m, {}) for m in FLOP_MODES},
              "moe_decode": (MOE_ARCH, "decode", {}),
              **{f"mamba2_{m}": (SSM_ARCH, m, {}) for m in FLOP_MODES},
              **{f"mamba2_seq_{m}": (SSM_ARCH, m, SEQ_SHARDED) for m in FLOP_MODES},
              **{f"vocab250_{m}": (ARCH, m, {"vocab": 250}) for m in ("prefill", "decode")},
              "mlp_seq_decode": (ARCH, "decode", {"mlp_seq_sharded": True})}
GATHER_CELLS = [c for c, (_, mode, _) in FLOP_CELLS.items() if mode != "train"]
# (cell without the flag, cell with it)
FLAG_PAIRS = [(f"mamba2_{m}", f"mamba2_seq_{m}") for m in FLOP_MODES] + [
    ("decode", "mlp_seq_decode")]
# the port's count at its last model rank against JAX's per-device count
FLOPS_TOL = 0.02
# JAX's all-gathers that the port has no counterpart of, in bytes a rank
# (ROADMAP.md, Known differences): in reduced qwen3-moe's decode GSPMD
# gathers the router's probabilities f32[4, 4] (64 B a layer) to run top_k
# over the batch, then its flat expert ids s32[8] (32 B) again for the
# argsort; the port routes its own tokens and gathers their ids once,
# int64 [2, 2] into [4, 2] (64 B): 32 B a layer short, over 2 layers
ROUTING_GAP = {"moe_decode": 64}


def out_proj_gap(cell: str) -> int:
    """The dot FLOPs a rank that JAX's baseline Mamba2 training counts and
    the port does not make (ROADMAP.md, Known differences): GSPMD takes the
    gradient of y, ``out_proj``'s input, over the whole d_inner and keeps
    the rank's heads, where the port takes it on those heads alone;
    2 b s d_inner e (1 - 1/m) a layer for a rank's b sequences of s."""
    import dataclasses
    from repro_torch.configs import get_config
    arch, mode, patch = FLOP_CELLS[cell]
    cfg = dataclasses.replace(get_config(arch).reduced(), **patch)
    if cfg.family != "ssm" or mode != "train" or cfg.ssm_seq_sharded:
        return 0
    data, m = FLOP_MESH
    return (2 * (BATCH // data) * SEQ * cfg.d_inner * cfg.d_model * (m - 1) // m
            * cfg.n_layers)


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

# the fields of ``analyze``'s tally that the port's is held against
JAX_TALLY = ("dot_flops", "collective_bytes", "collective_counts", "collective_bytes_ag2d",
             "collective_bytes_other2d", "collective_bytes_hi")

FLOPS_ORACLE = f"""
import dataclasses
import json
from repro.configs.registry import get_config
from repro.launch.hloparse import analyze
from repro.models.config import ShapeConfig
from repro.models.model import make_model
from repro.parallel.sharding import Rules, ShardingCtx
mesh = jax.make_mesh({FLOP_MESH!r}, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
TALLY = {JAX_TALLY!r}


def with_sh(shapes, shardings):
    return jax.tree_util.tree_map(
        lambda sd, sh: jax.ShapeDtypeStruct(sd.shape, sd.dtype, sharding=sh), shapes, shardings)


for name, (arch, mode, patch) in {FLOP_CELLS!r}.items():
    cfg = dataclasses.replace(get_config(arch).reduced(), **patch)
    model = make_model(cfg, ShardingCtx(Rules(), mesh))
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
    t = analyze(compiled.as_text())
    save(**{{name: np.asarray(json.dumps({{k: getattr(t, k) for k in TALLY}}))}})
"""


# the reduced cell (arch, shape) through ``run_cell`` on the CPU twice: on
# the plain path, then with each kernel a stand-in (``counts_as`` its plain
# version) that writes the kernel's output layout: attention's [b, h, s, d]
# a view of a [b, s, h, d] buffer, the others contiguous
LAYOUT_TWIN = """
import json, sys
from repro_torch.kernels import ops, ref, causal_conv as cc, flash_attention as fa, ssd_scan as ss
from repro_torch.launch.dryrun import run_cell
from repro_torch.tally_hooks import counts_as
arch, shape = sys.argv[1:3]


def run(seed=0):
    return run_cell(arch, shape, device="cpu", reduced=True, tag="layout_twin", verbose=False,
                    seed=seed)


def bshd(t):
    return t.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)


def dense(out):
    return tuple(t.contiguous() for t in out) if isinstance(out, tuple) else out.contiguous()


def attn(q, k, v, causal=True, window=0, return_lse=False):
    out = ref.ref_attention(q, k, v, causal=causal, window=window, return_lse=return_lse)
    return (bshd(out[0]), out[1].contiguous()) if return_lse else bshd(out)


plain, drawn = run(), run(seed=1)
fa.flash_attention = ops.flash_attention = counts_as(ref.ref_attention)(attn)
fa.flash_attention_bwd = counts_as(ref.ref_attention_bwd)(
    lambda *a, **kw: tuple(bshd(t) for t in ref.ref_attention_bwd(*a, **kw)))
fa.flash_decode = ops.flash_decode = counts_as(ref.ref_decode)(
    lambda *a, **kw: dense(ref.ref_decode(*a, **kw)))
ss.ssd_chunk = counts_as(ref.ref_ssd_chunk)(lambda *a, **kw: dense(ref.ref_ssd_chunk(*a, **kw)))
ss.ssd_chunk_bwd = counts_as(ref.ref_ssd_chunk_bwd)(
    lambda *a, **kw: dense(ref.ref_ssd_chunk_bwd(*a, **kw)))
cc.causal_conv = counts_as(cc.ref_causal_conv)(lambda *a: cc.ref_causal_conv(*a).contiguous())
cc.causal_conv_bwd = counts_as(cc.ref_causal_conv_bwd)(
    lambda *a: tuple(t if t is None else t.contiguous() for t in cc.ref_causal_conv_bwd(*a)))
ops._on_cuda = fa._on_card = ss._on_card = cc._on_card = lambda t: True
print(json.dumps([plain, run(), drawn]))
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
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import build_cell, cell_arguments, run_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.tally import tally
    from repro_torch.models.config import ShapeConfig
    mesh = make_mesh(FLOP_MESH, ("data", "model"))
    out = {}
    for name, (arch, mode, patch) in FLOP_CELLS.items():
        shape = ShapeConfig(mode, SEQ, BATCH, mode)
        cfg = dataclasses.replace(get_config(arch).reduced(), **patch)
        model = build_cell(arch, shape, mesh, cfg_override=cfg, device="cpu")
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
                    jax={k: json.loads(str(v)) for k, v in jax_flops.result().items()},
                    port=json.loads(proc.stdout), ranks=ranks)


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


def _port(results, cell, key):
    """The port's ``key`` on each rank of the cell, by rank."""
    return [results["ranks"][r]["flops"][cell][key] for r in range(WORLD)]


@pytest.mark.parametrize("mode", list(FLOP_CELLS))
def test_dot_flops_match_jax_compiled_step(mode, results):
    """The reduced ``FLOP_CELLS`` cell on ("data" 2, "model" 2): the last
    model rank's dot FLOPs (aten products, attention at full sq x skv
    scores over its K/V prefix; MoE decode's products of the rank's E / 2
    experts over its data rank's C / 2 slots; Mamba2's products of the
    rank's heads) within ``FLOPS_TOL`` of JAX's per-device
    ``analyze(...).dot_flops`` less the products only JAX makes
    (``out_proj_gap``), on every rank of the last model column; the
    first column's attention sees a shorter prefix and counts less, and
    without attention it counts the same."""
    want = float(results["jax"][mode]["dot_flops"] - out_proj_gap(mode))
    got = _port(results, mode, "dot_flops")
    last = got[1::2]
    for g in last:
        assert abs(g - want) <= FLOPS_TOL * want, (g, want)
    arch, shape, _ = FLOP_CELLS[mode]
    if arch == SSM_ARCH:
        assert got[0::2] == last
    elif shape != "decode":
        assert all(g < last[0] for g in got[0::2])


@pytest.mark.parametrize("cell", GATHER_CELLS)
def test_weight_gathers_match_jax_to_the_byte(cell, results):
    """In every prefill and decode cell the bytes of the rank <= 2
    all-gathers (``collective_bytes_ag2d``: each weight gathered where it is
    used, the embedding table never, its tokens' ids [b, s, 1] gathered as
    JAX's index) are JAX's to the byte on every rank, less the routing
    gathers of qwen3-moe's decode that only JAX makes (``ROUTING_GAP``)."""
    want = results["jax"][cell]["collective_bytes_ag2d"] - ROUTING_GAP.get(cell, 0)
    assert _port(results, cell, "collective_bytes_ag2d") == [want] * WORLD


@pytest.mark.parametrize("off,on", FLAG_PAIRS, ids=[p[1] for p in FLAG_PAIRS])
def test_flags_move_the_tally_as_they_move_jax(off, on, results):
    """``ssm_seq_sharded`` (mamba2's train, prefill and decode) and
    ``mlp_seq_sharded`` (llama's decode) change the last model rank's dot
    FLOPs and weight gathers by exactly what they change JAX's, but for
    the transposed ``out_proj`` over the whole d_inner that JAX's baseline
    training makes and the port does not (``out_proj_gap``, 1,048,576
    FLOPs): mamba2's prefill and decode move nothing, and the MLP of
    llama's decode runs whole with the flag, its weights gathered whole."""
    for key in ("dot_flops", "collective_bytes_ag2d"):
        jax_moves = results["jax"][on][key] - results["jax"][off][key]
        if key == "dot_flops":
            jax_moves += out_proj_gap(off) - out_proj_gap(on)
        assert _port(results, on, key)[-1] - _port(results, off, key)[-1] == jax_moves, key


def test_baseline_exit_reduce_scatters_what_jax_all_reduces(results):
    """Mamba2's baseline prefill (``ssm_seq_sharded`` off) sums the block's
    output parts over "model" where JAX's does: GSPMD all-reduces the
    whole [b, s, e] and the norm's mean square [b, s, 1] a layer; the
    port all-reduces the mean square alone and reduce-scatters the output
    to the rank's positions, 1/m of its bytes (ROADMAP.md, Known
    differences). Each as the flag's move, at the last model rank."""
    from repro_torch.configs import get_config

    def moves(side, kind):
        off, on = (results["jax"][c]["collective_bytes"] if side == "jax"
                   else _port(results, c, "collective_bytes")[-1]
                   for c in ("mamba2_prefill", "mamba2_seq_prefill"))
        return off.get(kind, 0) - on.get(kind, 0)

    cfg = get_config(SSM_ARCH).reduced()
    data, m = FLOP_MESH
    mean_sq = cfg.n_layers * (BATCH // data) * SEQ * 4
    jax_ar, port_ar = moves("jax", "all-reduce"), moves("port", "all-reduce")
    port_rs = moves("port", "reduce-scatter")
    assert port_ar == mean_sq
    assert port_rs * m == jax_ar - mean_sq > 0


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


@pytest.mark.parametrize("arch,shape", [("llama3.2-3b", "train_4k"), ("zamba2-2.7b", "long_500k"),
                                        ("mamba2-2.7b", "train_4k")])
def test_tally_is_the_same_under_the_kernels_layouts(arch, shape):
    """``chip_smoke.py``'s reduced twins, whose tally must be the same on
    the card as on the CPU: with every kernel a stand-in that reports its
    plain version's count and writes the kernel's output layout (which the
    layout copies after it follow), each tally field is the plain path's
    exactly, forward and backward; and so it is with other drawn values
    (the card draws other tokens than the CPU from the same seed: no shape
    may follow them)."""
    proc = subprocess.run([sys.executable, "-c", LAYOUT_TWIN, arch, shape], capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    plain, layout, drawn = json.loads(proc.stdout.strip().splitlines()[-1])
    assert plain["ok"], plain.get("error")
    assert {k: plain[k] for k in TALLY_KEYS} == {k: layout[k] for k in TALLY_KEYS}
    assert {k: plain[k] for k in TALLY_KEYS} == {k: drawn[k] for k in TALLY_KEYS}
