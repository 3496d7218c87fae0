"""The production meshes' cells, one rank of each run for real.

The port's counterpart of ``repro/launch/dryrun.py``. JAX's dry-run
lowers and compiles every (arch x shape x mesh) cell for 256 or 512
placeholder devices and reads the compiled program's memory, cost and
collectives. The port has no compiler to ask: it binds a world of the
fake process group (``FakeStore``, backend "fake": collectives that move
nothing and leave their outputs as they were) as large as the mesh, builds
the mesh (``make_production_mesh``), and runs one step of one rank on
its device, with that rank's shards at their production shapes:

* ``memory_analysis``: ``argument_size_in_bytes``, the exact sum of the
  rank's parameter, optimizer-state, input and cache shards (from the
  specs, as JAX's ``shard_shape`` gives them); ``peak_allocated_bytes``,
  the allocator's peak over the timed step on the card (on the CPU, none);
* the step's tally (``launch/tally.py``, hloparse's counterpart): dot
  FLOPs of this rank, collectives by kind and their bytes (each
  collective's result), result bytes;
* ``step_s`` in place of ``compile_s``: the time of a second step on
  the device, outside the tally (the first counts and warms up). Under
  the fake group no collective moves a byte, so it is the rank's compute
  and memory time alone, beside the card's name and power limit.

The rank is by default the one at data (and pod) coordinate 0 and the
last "model" coordinate: it gathers the whole K/V prefix, so its
attention work is JAX's per-device einsum's, and at ``long_500k`` its
block holds the window. Decode runs at ``pos = seq_len - 1``. The
parameters are drawn shard by shard (``Model.init_shards``), never whole:
qwen2-vl-72b's and llama4's whole masters do not fit a card. The values
are random; the collectives write nothing, so what a step computes is not
checked, and every shape the step takes comes from the rank's own plan:
an integer collective's output (the MoE plan's expert ids) starts as the
rank's own input (``seeded_integer_collectives``).

Records go to ``experiments/dryrun_torch/<arch>_<shape>_<mesh>_<tag>.json``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k [--multi-pod] [--all] [--optimized]
  # on the CPU, at the reduced configs and sequences / 64:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape decode_32k --reduced --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..configs.registry import ARCH_IDS, get_config, perf_patch, shapes_for
from ..device import resolve_device
from ..models.config import SHAPES, ArchConfig, ShapeConfig
from ..models.model import Model, make_model
from ..parallel.sharding import Rules, ShardingCtx, mesh_shape, shard_shape, spec_axes
from .mesh import make_production_mesh
from .tally import tally

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
# --reduced: the reduced configs, widened so that the 256 ("data", "model")
# blocks of an fsdp2d leaf divide its d_model and its heads x head_dim, at
# sequences this much shorter (the batches and meshes as they are): small
# enough for the CPU; an MoE model's experts as many as the model ranks
REDUCED_SEQ = 64
REDUCED_WIDTH = dict(d_model=256, head_dim=64)
REDUCED_EXPERTS = 16


def reduced_config(arch_id: str) -> ArchConfig:
    cfg = get_config(arch_id).reduced()
    experts = {"n_experts": REDUCED_EXPERTS} if cfg.is_moe else {}
    return dataclasses.replace(cfg, **REDUCED_WIDTH, **experts)


def cell_config(arch_id: str, shape: ShapeConfig, cfg_override: Optional[ArchConfig] = None,
                cfg_patch: Optional[Dict[str, Any]] = None) -> ArchConfig:
    """The cell's config: the arch's (or ``cfg_override``), patched, and
    zamba2's shared attention windowed at 4096 at ``long_500k`` (JAX's
    ``build_cell``)."""
    cfg = cfg_override or get_config(arch_id)
    if cfg_patch:
        cfg = dataclasses.replace(cfg, **cfg_patch)
    if cfg.name.startswith("zamba2") and shape.name == "long_500k":
        cfg = dataclasses.replace(cfg, sliding_window=4096)
    return cfg


def cell_rules(mesh, shape: ShapeConfig) -> Rules:
    """JAX's ``build_cell`` rule for the batch: the axes "batch" maps to
    that the global batch does not divide (with those before them) are
    dropped, so ``long_500k``'s batch of 1 stays whole (the model axis
    still spreads the state and the cache)."""
    rules = Rules()
    sizes = mesh_shape(mesh)
    axes = rules.table.get("batch") or ()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    keep, prod = [], 1
    for a in axes:
        k = sizes.get(a, 1)
        if shape.global_batch % (prod * k) == 0:
            keep.append(a)
            prod *= k
    if tuple(keep) != axes:
        rules = rules.override(batch=tuple(keep) if keep else None)
    return rules


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                                         torch.dtype]]:
    """(whole shape, dtype) of each model input of a cell (JAX's
    ``input_specs``): tokens int32 [b, s] or the stub frontends' bf16
    embeddings [b, s, e]; labels in training; decode's s is 1."""
    b = shape.global_batch
    s = shape.seq_len if shape.mode != "decode" else 1
    out = {}
    if cfg.frontend != "token":
        out["embeds"] = ((b, s, cfg.d_model), torch.bfloat16)
    else:
        out["tokens"] = ((b, s), torch.int32)
    if shape.mode == "train":
        out["labels"] = ((b, s), torch.int32)
    return out


def _nbytes(shape: Tuple[int, ...], dtype: torch.dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def argument_bytes(model: Model, shape: ShapeConfig) -> Dict[str, int]:
    """The bytes of this rank's arguments of the cell's step, by kind:
    parameter shards, optimizer-state shards (training), input blocks and
    cache blocks (decode), each leaf's shard shape (``shard_shape``) times
    its itemsize. JAX's ``memory_analysis().argument_size_in_bytes`` is of
    the same arguments (decode's scalar position aside)."""
    mesh = model.ctx.mesh
    psh = model.param_shardings()
    out = {"params": sum(_nbytes(shard_shape(s, psh[n].spec, mesh, n), dt)
                         for n, (s, dt) in model.param_shapes().items())}
    if shape.mode == "train":
        leaves = []
        _map_pairs(model.opt_shapes(), model.opt_shardings(), leaves)
        out["opt_state"] = sum(_nbytes(shard_shape(s, sh.spec, mesh), dt) for (s, dt), sh in leaves)
    ish = model.input_shardings(shape)
    out["inputs"] = sum(_nbytes(shard_shape(s, ish[n].spec, mesh, n), dt)
                        for n, (s, dt) in input_specs(model.cfg, shape).items())
    if shape.mode == "decode":
        out["cache"] = sum(_nbytes(s, dt) for s, dt in model.cache_shapes(shape).values())
    return out


def _map_pairs(shapes, shardings, out: list) -> None:
    """The (shape, layout) pairs of two trees of one structure (an
    OptState or nested dicts), in order."""
    if hasattr(shapes, "_fields"):
        for f in shapes._fields:
            _map_pairs(getattr(shapes, f), getattr(shardings, f), out)
    elif isinstance(shapes, dict):
        for k in shapes:
            _map_pairs(shapes[k], shardings[k], out)
    else:
        out.append((shapes, shardings))


def build_cell(arch_id: str, shape: ShapeConfig, mesh,
               cfg_override: Optional[ArchConfig] = None,
               cfg_patch: Optional[Dict[str, Any]] = None,
               device: Union[str, torch.device] = "meta") -> Model:
    """The cell's model on this rank of ``mesh``: its config
    (``cell_config``) and sharding rules (``cell_rules``), its leaves this
    rank's shards on ``device`` (allocated, not drawn; "meta": the layout
    alone)."""
    cfg = cell_config(arch_id, shape, cfg_override, cfg_patch)
    ctx = ShardingCtx(cell_rules(mesh, shape), mesh)
    return make_model(cfg, ctx, device=device)


def cell_arguments(model: Model, shape: ShapeConfig, generator: torch.Generator) -> Dict:
    """Draw the rank's parameter shards (``init_shards``) and make its
    step's other arguments: zeroed optimizer state, random inputs (its
    block of the batch, drawn for the block alone), a zeroed cache. Returns
    {"opt_state"?, "batch", "cache"?}."""
    dev = model.device
    model.init_shards(generator)
    ish = model.input_shardings(shape)
    batch = {}
    for n, (s, dt) in input_specs(model.cfg, shape).items():
        local = shard_shape(s, ish[n].spec, model.ctx.mesh, n)
        if dt == torch.int32:
            batch[n] = torch.randint(0, model.cfg.vocab, local, generator=generator, device=dev,
                                     dtype=torch.int32)
        else:
            batch[n] = torch.randn(local, generator=generator, device=dev, dtype=dt)
    args: Dict[str, Any] = {"batch": batch}
    if shape.mode == "train":
        args["opt_state"] = model.init_opt()
    if shape.mode == "decode":
        args["cache"] = model.init_cache(shape)
    return args


def run_step(model: Model, shape: ShapeConfig, args: Dict):
    """One step of the cell on this rank: a train step (its gradients
    summed over the mesh, ``Model.mean_over_batch``), a prefill, or one
    decode step at ``pos = seq_len - 1``."""
    batch = args["batch"]
    if shape.mode == "train":
        args["opt_state"], _ = model.train_step(args["opt_state"], batch,
                                                reduce=model.mean_over_batch)
        return None
    if shape.mode == "prefill":
        return model.prefill_step(batch.get("tokens"), embeds=batch.get("embeds"))
    return model.serve_step(args["cache"], batch.get("tokens"), shape.seq_len - 1,
                            embeds=batch.get("embeds"))


@contextlib.contextmanager
def seeded_integer_collectives() -> Iterator[None]:
    """Under the fake process group a collective moves nothing and leaves
    its output as it was. Inside, the all-to-all and the all-gather do no
    more than that, except that an integer output (the MoE plan's expert
    ids, whose values become shapes and indices) is filled with this
    rank's own input, as many times as it holds it: every index read from
    it is one of this rank's plan, never uninitialised memory. (The fake
    all-to-all would also check the row counts of such a plan, which need
    not agree across ranks that never met.)"""
    names = [n for n in ("all_to_all_single", "all_gather_single", "all_gather_into_tensor")
             if hasattr(dist, n)]
    saved = {n: getattr(dist, n) for n in names}

    def seeded(out, x, *args, **kwargs):
        if not out.is_floating_point() and x.numel() and out.numel() % x.numel() == 0:
            out.view(-1, x.numel()).copy_(x.reshape(1, -1))
    for n in names:
        setattr(dist, n, seeded)
    try:
        yield
    finally:
        for n in names:
            setattr(dist, n, saved[n])


def default_rank(mesh_dims: Tuple[int, ...]) -> int:
    """The rank at every coordinate 0 but the last "model" one."""
    return mesh_dims[-1] - 1


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_info(dev: torch.device) -> Dict[str, Any]:
    """The device's name and, on a card, ``nvidia-smi``'s name and power
    limit (every time stands beside them)."""
    if dev.type != "cuda":
        return {"name": "cpu"}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        smi = []
    index = dev.index or 0
    return {"name": torch.cuda.get_device_name(index),
            "nvidia_smi": smi[index] if index < len(smi) else None}


def shape_of(shape_name: str, reduced: bool = False) -> ShapeConfig:
    shape = SHAPES[shape_name]
    if reduced:
        shape = dataclasses.replace(shape, seq_len=shape.seq_len // REDUCED_SEQ)
    return shape


def run_cell(arch_id: str, shape_name: str, multi_pod: bool = False,
             tag: str = "baseline", verbose: bool = True,
             cfg_patch: Optional[Dict[str, Any]] = None, rank: Optional[int] = None,
             device: Union[str, torch.device] = "cuda", reduced: bool = False,
             seed: int = 0) -> Dict[str, Any]:
    """One cell on one rank: binds a fake world of the mesh's size at
    ``rank`` (``default_rank``) unless a process group is already up, runs
    the step and returns (and writes) its record."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dev = resolve_device(device)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    dims = (2, 16, 16) if multi_pod else (16, 16)
    shape = shape_of(shape_name, reduced)
    rank = default_rank(dims) if rank is None else rank
    own_world = not (dist.is_available() and dist.is_initialized())
    rec: Dict[str, Any] = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "mode": shape.mode, "n_devices": math.prod(dims), "rank": rank,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch, "reduced": reduced,
        "cfg_patch": dict(cfg_patch or {}), "device": device_info(dev)}
    if own_world:
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=math.prod(dims))
    t0 = time.perf_counter()
    seeding = seeded_integer_collectives() if own_world else contextlib.nullcontext()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
        rec["coordinate"] = list(mesh.get_coordinate())
        cfg_override = reduced_config(arch_id) if reduced else None
        model = build_cell(arch_id, shape, mesh, cfg_override, cfg_patch, device=dev)
        rec["batch_axes"] = list(spec_axes(model.ctx.spec("batch")))
        expect = argument_bytes(model, shape)
        args = cell_arguments(model, shape, torch.Generator(device=dev).manual_seed(seed))
        held = _held_bytes(model, args)
        _sync(dev)
        rec["setup_s"] = time.perf_counter() - t0
        with seeding:
            with tally() as t:
                run_step(model, shape, args)
                _sync(dev)
            # the step again, outside the tally's dispatch mode (which costs
            # host time at every op): its time and the allocator's peak
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            t1 = time.perf_counter()
            run_step(model, shape, args)
            _sync(dev)
        rec["step_s"] = time.perf_counter() - t1
        rec["step_note"] = ("the second step of the cell, the first warm-up and counted; fake "
                            "process group: no collective moves a byte, so the step's time is "
                            "this rank's compute and memory traffic alone")
        rec["memory_analysis"] = {
            "argument_size_in_bytes": sum(expect.values()),
            "argument_bytes_by_kind": expect, "argument_bytes_held": held,
            "peak_allocated_bytes": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None)}
        rec["flops"] = t.dot_flops
        rec["dot_flops_per_device"] = t.dot_flops
        rec["collectives"] = dict(t.collective_bytes)
        rec["collective_counts"] = dict(t.collective_counts)
        rec["collective_bytes_total"] = t.total_collective_bytes
        rec["collective_bytes_ag2d"] = t.collective_bytes_ag2d
        rec["collective_bytes_other2d"] = t.collective_bytes_other2d
        rec["collective_bytes_hi"] = t.collective_bytes_hi
        rec["result_bytes_per_device"] = t.result_bytes
        rec["ok"] = held == sum(expect.values())
        if not rec["ok"]:
            rec["error"] = f"the rank holds {held} argument bytes, the specs give {expect}"
    except Exception as e:  # noqa: BLE001
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
    finally:
        model = args = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if own_world:
            dist.destroy_process_group()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / f"{arch_id}_{shape_name}_{mesh_name}_{tag}.json"
    path.write_text(json.dumps(rec, indent=1))
    if verbose:
        status = "OK " if rec["ok"] else "FAIL"
        extra = (f"dotflops/dev={rec['dot_flops_per_device']:.3e} "
                 f"coll/dev={rec['collective_bytes_total']:.3e}B "
                 f"args={rec['memory_analysis']['argument_size_in_bytes']:.3e}B "
                 f"step={rec['step_s']:.2f}s"
                 if rec["ok"] else rec.get("error", ""))
        print(f"[{status}] {arch_id:28s} {shape_name:12s} {mesh_name:10s} {extra}", flush=True)
    return rec


def _held_bytes(model: Model, args: Dict) -> int:
    """The bytes of the argument tensors this rank holds."""
    ts = list(model.masters().values()) + list(args["batch"].values())
    if "opt_state" in args:
        st = args["opt_state"]
        ts += [t for t in _leaves(st.mu)] + [t for t in _leaves(st.nu)]
    if "cache" in args:
        ts += list(args["cache"].values())
    step = 4 if "opt_state" in args else 0          # JAX's int32 step counter
    return step + sum(t.numel() * t.element_size() for t in ts)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every applicable (arch x shape) cell")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the per-arch §Perf patches (registry.PERF_PATCHES) and tag "
                         "records 'optimized'")
    ap.add_argument("--rank", type=int, default=None,
                    help="the rank of the mesh to run (default: data 0, the last model rank)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help=f"the reduced configs, sequences / {REDUCED_SEQ} (a CPU run)")
    args = ap.parse_args(argv)
    if args.optimized and args.tag == "baseline":
        args.tag = "optimized"
    if not args.all and (not args.arch or not args.shape):
        ap.error("--arch and --shape required unless --all")
    todo = ([(aid, s.name) for aid in ARCH_IDS for s in shapes_for(get_config(aid))]
            if args.all else [(args.arch, args.shape)])
    failures = 0
    for aid, sname in todo:
        rec = run_cell(aid, sname, multi_pod=args.multi_pod, tag=args.tag,
                       cfg_patch=perf_patch(aid) if args.optimized else None, rank=args.rank,
                       device=args.device, reduced=args.reduced)
        failures += 0 if rec["ok"] else 1
    print(f"\n{len(todo) - failures}/{len(todo)} cells ran", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
