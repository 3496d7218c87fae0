"""The Zero-3 layout of the port's training across ranks against JAX's.

JAX's runtime binds each leaf with ``param_shardings()`` /
``opt_shardings()``: 1/n of the masters and moments a device, the small
leaves whole. The port holds the same layout on the ranks of a gloo
world of 4 CPU processes (one ``run_world`` for the whole file) and is
held against a JAX subprocess with 4 host devices (one oracle):

* the specs of every leaf for every arch, full and reduced, on meshes
  (1, 1), (2, 1), (4, 1) and (2, 2): masters, AdamW and Adafactor state,
  inputs in the three modes, the decode cache; at (3, 1) both raise on the
  same leaf of every reduced arch;
* reduced llama3.2-3b, mamba2-2.7b, qwen3-moe (capacity dispatch at
  capacity factor 1.0) and llama4 (Adafactor, interleaved) bound at 4 and
  at 2 on JAX's weights: each rank's shard of every master and moment is
  JAX's device-r shard bit for bit, and after one and two steps within
  the step tolerances of ``test_torch_elastic_ranks``; a rank holds the
  whole leaves plus 1/n of the split ones, to the byte;
* the gathered masters against the one-process port (``grad_accum`` 1
  and 2); grow, shrink and ejection change no gathered value; a
  checkpoint of 4 ranks restores on 2 through ``shardings=``, and the
  files restore into JAX's tree and JAX's into the port;
* the MoE dispatch's [E, C/n, e] buffer on each rank (C padded to a
  multiple of n where it does not divide), against the one-process
  dispatch;
* the layer gather's backward at float64: the sum of the ranks' slices.
"""
import dataclasses
import json
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from repro.configs.registry import ARCH_IDS
from torch_dist_harness import run_jax_oracle, run_world

WORLD = 4
SEQ, BATCH = 32, 8
MESHES = ((1, 1), (2, 1), (4, 1), (2, 2))
KINDS = ("params", "opt_adamw", "opt_adafactor", "inputs", "cache")
# the reduced configs whose shards are held against JAX's devices
PATCH = {"llama3.2-3b": {}, "mamba2-2.7b": {},
         "qwen3-moe-30b-a3b": {"moe_impl": "dispatch", "capacity_factor": 1.0},
         "llama4-maverick-400b-a17b": {}}
SHARD_CASES = [(arch, n) for arch in PATCH for n in (4, 2)]
ARCH = "llama3.2-3b"
ACCUM = (1, 2)
REBINDS = ("grow 2", "shrink 2", "eject and replace")
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_CASES = [(n, cf) for n in (4, 2) for cf in (1.0, 1.01)]    # C 128, and 129 (padded)
TOL = 1e-6

ORACLE = f"""
import dataclasses
import json
import re
import jax.numpy as jnp
from repro.configs.registry import ARCH_IDS, get_config
from repro.models.config import ShapeConfig
from repro.models.model import make_model
from repro.models.transformer import loss_fn
from repro.optim.adamw import OptConfig
from repro.parallel.sharding import Rules, ShardingCtx


def flat(tree, prefix=""):
    out = {{}}
    for k in sorted(tree):
        v = tree[k]
        out.update(flat(v, prefix + k + ".") if isinstance(v, dict) else {{prefix + k: v}})
    return out


def norm(p):
    if isinstance(p, tuple):
        return p[0] if len(p) == 1 else list(p)
    return p


def specs(tree):
    return {{k: [norm(p) for p in v.spec] for k, v in flat(tree).items()}}


def opt_specs(osh):
    return {{"step": [norm(p) for p in osh.step.spec],
             "mu": specs(osh.mu) if osh.mu else {{}}, "nu": specs(osh.nu)}}


def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])


layouts = {{}}
for arch in ARCH_IDS:
    for size in ("full", "reduced"):
        cfg = get_config(arch).reduced() if size == "reduced" else get_config(arch)
        for shape in {MESHES!r}:
            ctx = ShardingCtx(Rules(), mesh_of(shape))
            m = make_model(cfg, ctx)
            rec = {{"params": specs(m.param_shardings()), "cache": specs(m.cache_shardings()),
                    "inputs": {{mode: specs(m.input_shardings(ShapeConfig("t", {SEQ}, {BATCH}, mode)))
                               for mode in ("train", "prefill", "decode")}}}}
            for kind in ("adamw", "adafactor"):
                rec["opt_" + kind] = opt_specs(make_model(cfg, ctx, OptConfig(kind=kind))
                                               .opt_shardings())
            layouts[f"{{arch}}|{{size}}|{{shape[0]}}x{{shape[1]}}"] = rec
raises = {{}}
mesh3 = mesh_of((3, 1))
for arch in ARCH_IDS:
    m = make_model(get_config(arch).reduced(), ShardingCtx(Rules(), mesh3))
    try:
        with mesh3:
            jax.jit(m.init_params, out_shardings=m.param_shardings()).lower(jax.random.key(0))
        raises[arch] = ""
    except ValueError as e:
        path = re.search(r"result((?:\\['\\w+'\\])+)", str(e)).group(1)
        raises[arch] = ".".join(re.findall(r"'(\\w+)'", path))
save(layouts=np.asarray(json.dumps(layouts)), raises=np.asarray(json.dumps(raises)))

data = np.load(sys.argv[1])
for arch, patch in {PATCH!r}.items():
    cfg = dataclasses.replace(get_config(arch).reduced(), **patch)
    opt = OptConfig(kind=cfg.optimizer, warmup=5, total_steps=10)
    for n in (4, 2):
        mesh = mesh_of((n, 1))
        devices = list(mesh.devices.flat)
        model = make_model(cfg, ShardingCtx(Rules(), mesh), opt)
        tag = f"{{arch}}|{{n}}"

        def shards(stage, params, opt_state):
            leaves = {{"p." + k: v for k, v in flat(params).items()}}
            leaves.update({{"mu." + k: v for k, v in flat(opt_state.mu).items()}}
                          if opt_state.mu else {{}})
            leaves.update({{"nu." + k: v for k, v in flat(opt_state.nu).items()}})
            for k, v in leaves.items():
                for s in v.addressable_shards:
                    save(**{{f"{{tag}}|{{stage}}|{{k}}|{{devices.index(s.device)}}": s.data}})

        def step(p, o, b):
            g = jax.grad(lambda q: loss_fn(q, cfg, model.ctx, b))(p)
            p, o, metrics = model.train_step(p, o, b)
            return g, p, o, metrics["loss"]

        with mesh:
            psh, osh = model.param_shardings(), model.opt_shardings()
            params = jax.device_put(model.init_params(jax.random.key(0)), psh)
            opt_state = jax.device_put(model.init_opt(params), osh)
            shards(0, params, opt_state)
            jstep = jax.jit(step, out_shardings=(psh, psh, osh, None))
            bsh = model.input_shardings(ShapeConfig("t", {SEQ}, {BATCH}, "train"))
            for i in range(2):
                batch = jax.device_put({{"tokens": jnp.asarray(data[f"{{arch}}|{{i}}|tokens"]),
                                        "labels": jnp.asarray(data[f"{{arch}}|{{i}}|labels"])}},
                                       bsh)
                g, params, opt_state, loss = jstep(params, opt_state, batch)
                save(**{{f"{{tag}}|{{i + 1}}|loss": loss}})
                save(**{{f"{{tag}}|{{i + 1}}|g.{{k}}": v for k, v in flat(g).items()}})
                shards(i + 1, params, opt_state)
"""


# ---------------------------------------------------------------------- #
# the port's side, on every rank of the gloo world
# ---------------------------------------------------------------------- #
def _cfg(arch, **kw):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(), **{**PATCH.get(arch, {}), **kw})


def _runtime(cfg):
    from repro_torch.core.graph import build_tpu_fleet
    from repro_torch.core.scheduler import SchedulerInstance
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.elastic import ElasticRuntime
    fleet = build_tpu_fleet(pods=1, racks_per_pod=1, nodes_per_rack=4, chips_per_node=4,
                            device="cpu")
    return ElasticRuntime(SchedulerInstance("top", fleet), cfg,
                          ShapeConfig("smoke_train", SEQ, BATCH, "train"), chip_type="chip",
                          opt=OptConfig(kind=cfg.optimizer, warmup=5, total_steps=10),
                          device="cpu")


def _bound(cfg, n, params):
    """A runtime of n bound ranks loaded with ``params`` (whole leaves)."""
    import torch
    rt = _runtime(cfg)
    rt.allocate(n)
    rt.bind()
    if rt.model is not None:
        rt.model.load_params({k: torch.from_numpy(v) for k, v in params.items()})
        rt.opt_state = rt.model.init_opt()
    return rt


def _shards(rt):
    """This rank's shards: {"p.<name>", "mu.<name>", "nu.<name>[.row|.col]"}."""
    out = {"p." + k: v.numpy().copy() for k, v in rt.params.items()}

    def walk(tree, prefix):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[prefix + k] = v.numpy().copy()
    walk(rt.opt_state.mu, "mu.")
    walk(rt.opt_state.nu, "nu.")
    return out


def _full(rt):
    """The gathered state as numpy on every bound rank (each calls it),
    None outside."""
    if rt.model is None:
        return None
    return _numpy_state({"params": rt.model.full_params(),
                         "opt_state": rt.model.full_opt_state(rt.opt_state)})


def _numpy_state(state):
    out = {"p." + k: v.numpy() for k, v in state["params"].items()}
    out.update(_flat_opt(state["opt_state"]))
    return out


def _flat_opt(state):
    out = {"step": np.asarray(state.step)}

    def walk(tree, prefix):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[prefix + k] = np.asarray(v)
    walk(state.mu, "mu.")
    walk(state.nu, "nu.")
    return out


def _step(rt, batch):
    """One step: the loss, the gradient the optimizer is given (gathered
    whole), and this rank's shards after it."""
    grads, reduce = {}, rt._mean_over_data

    def capture(loss, g):
        loss, g = reduce(loss, g)
        psh = rt.model.param_shardings()
        grads.update({k: rt.model.gather(v, psh[k]).numpy().copy() for k, v in g.items()})
        return loss, g
    rt._mean_over_data = capture
    loss = float(rt.step(batch)["loss"])
    rt._mean_over_data = reduce
    return dict(loss=loss, grads=grads, shards=None if rt.model is None else _shards(rt))


def _layouts(rank):
    """The port's specs, as the oracle's, on rank 0 (every rank builds the
    meshes); and at (3, 1) the leaf each reduced arch raises on."""
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ARCH_IDS as TORCH_ARCH_IDS
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import make_model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.parallel.sharding import Rules, ShardingCtx

    def specs(tree):
        return {k: [list(p) if isinstance(p, tuple) else p for p in v.spec]
                for k, v in _flat_tree(tree).items()}

    meshes = {shape: make_mesh_for(shape[0] * shape[1], shape[1]) for shape in MESHES}
    mesh3 = make_mesh_for(3, 1)
    if rank != 0:
        return None
    layouts = {}
    for arch in TORCH_ARCH_IDS:
        for size in ("full", "reduced"):
            cfg = get_config(arch).reduced() if size == "reduced" else get_config(arch)
            for shape, mesh in meshes.items():
                ctx = ShardingCtx(Rules(), mesh)
                m = make_model(cfg, ctx, device="meta")
                rec = {"params": specs(m.param_shardings()), "cache": specs(m.cache_shardings()),
                       "inputs": {mode: specs(m.input_shardings(ShapeConfig("t", SEQ, BATCH, mode)))
                                  for mode in ("train", "prefill", "decode")}}
                for kind in ("adamw", "adafactor"):
                    osh = make_model(cfg, ctx, device="meta", opt=OptConfig(kind=kind)).opt_shardings()
                    rec["opt_" + kind] = {"step": specs({"s": osh.step})["s"],
                                          "mu": specs(osh.mu), "nu": specs(osh.nu)}
                layouts[f"{arch}|{size}|{shape[0]}x{shape[1]}"] = rec
    raises = {}
    for arch in TORCH_ARCH_IDS:
        try:
            make_model(get_config(arch).reduced(), ShardingCtx(Rules(), mesh3), device="meta")
            raises[arch] = ""
        except ValueError as e:
            raises[arch] = str(e).split(" ")[0]
    return dict(layouts=layouts, raises=raises)


def _flat_tree(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_flat_tree(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def _moe_world(rank, inputs):
    """``moe_dispatch`` of the reduced qwen3-moe layer with each of the n
    bound ranks holding its rows: y, the gradients of x's rows, of the
    layer's leaves (summed over the ranks) and the buffers the experts ran."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import moe
    meshes = {n: make_mesh_for(n, 1) for n in (4, 2)}
    out = {}
    shapes = []
    ffn = moe._expert_ffn

    def recording(xb, p, cfg):
        shapes.append(tuple(xb.shape))
        return ffn(xb, p, cfg)
    moe._expert_ffn = recording
    try:
        for n, cf in MOE_CASES:
            if rank >= n:
                continue
            group = meshes[n].get_group("data")
            cfg = _cfg(MOE_ARCH, capacity_factor=cf)
            rows = slice(rank * BATCH // n, (rank + 1) * BATCH // n)
            x = torch.from_numpy(inputs["moe_x"][rows]).requires_grad_()
            leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in inputs["moe_p"].items()}
            shapes.clear()
            y = moe.moe_dispatch(x, leaves, cfg, group)
            grads = torch.autograd.grad((y * torch.from_numpy(inputs["moe_w"][rows])).sum(),
                                        [x] + list(leaves.values()))
            pg = {k: g.clone() for k, g in zip(leaves, grads[1:])}
            for g in pg.values():
                dist.all_reduce(g, group=group)
            out[(n, cf)] = dict(y=y.detach().numpy(), gx=grads[0].numpy(),
                                gp={k: v.numpy() for k, v in pg.items()}, buffers=list(shapes))
    finally:
        moe._expert_ffn = ffn
    return out


def _gather_world(rank, world):
    """The layer gather of a float64 shard [3, 2] along dimension 1: the
    gradient of sum(full * w_rank) with respect to the shard."""
    import torch
    import torch.distributed as dist
    from repro_torch.parallel.sharding import Sharded, Split
    shard = torch.from_numpy(np.random.default_rng(rank).standard_normal((3, 2))).requires_grad_()
    w = torch.from_numpy(np.random.default_rng(100 + rank).standard_normal((3, 2 * world)))
    full = Sharded(shard, (Split(1, ("data",), dist.group.WORLD, world),), torch.float64).full()
    (g,) = torch.autograd.grad((full * w).sum(), shard)
    return dict(full=full.detach().numpy(), grad=g.numpy())


def _port_world(rank, world, inputs, ckpt):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.train import run_training
    from repro_torch.runtime.checkpoint import CheckpointManager

    out = {"layouts": _layouts(rank), "gather": _gather_world(rank, world),
           "moe": _moe_world(rank, inputs)}
    # the four archs' shards at 4 and at 2 bound ranks on JAX's weights, two steps
    for arch, n in SHARD_CASES:
        rt = _bound(_cfg(arch), n, inputs["params"][arch])
        res = {"bound": rt.bound, "stages": [None if rt.model is None else _shards(rt)]}
        if rt.bound:
            res["held"] = sum(t.numel() * t.element_size() for t in
                              list(rt.params.values()) + _tensors(rt.opt_state))
        for i in range(2):
            res["stages"].append(_step(rt, inputs["batches"][arch][i]))
        out[("shards", arch, n)] = res
    # llama at 4 ranks against one process, grad_accum 1 and 2
    for k in ACCUM:
        rt = _bound(_cfg(ARCH, grad_accum=k), 4, inputs["params"][ARCH])
        out[("accum", k)] = []
        for b in inputs["batches"][ARCH]:
            loss = float(rt.step(b)["loss"])
            out[("accum", k)].append(dict(loss=loss, full=_full(rt)))
    # rebinds: the gathered state before and after each
    rt = _bound(_cfg(ARCH), 2, inputs["params"][ARCH])
    rt.step(inputs["batches"][ARCH][0])
    acts = {"grow 2": lambda: rt.grow(2), "shrink 2": lambda: rt.shrink(2),
            "eject and replace": lambda: _eject_first_node(rt)}
    for name in REBINDS:
        before, n_before = _full(rt), len(rt.mesh)
        ok = acts[name]()
        out[("rebind", name)] = dict(ok=ok, bound=(n_before, len(rt.mesh)), before=before,
                                     after=_full(rt))
    # checkpoints: run_training on 4 ranks writes them (rank 0, leaves gathered)
    res = run_training(ARCH, steps=11, smoke=True, ckpt_dir=ckpt["port"], ckpt_every=10,
                       start_chips=4, device="cpu", log_every=10 ** 9)
    out["trained"] = _full(res["runtime"])
    state = res["runtime"].full_state()          # the checkpoint's gather
    out["writer_state"] = None if state is None else _numpy_state(state)
    dist.barrier()
    # ... and they restore on 2 through shardings=, as does JAX's
    for name, n in (("port", 2), ("jax", 4), ("jax", 2)):
        rt = _runtime(_cfg(ARCH))
        rt.allocate(n)
        rt.bind(torch.Generator().manual_seed(1))
        step = loss = None
        shards = None
        if rt.bound:
            step, state = CheckpointManager(ckpt[name]).restore(
                {"params": rt.params, "opt_state": rt.opt_state},
                shardings={"params": rt.model.param_shardings(),
                           "opt_state": rt.model.opt_shardings()})
            rt.params, rt.opt_state = state["params"], state["opt_state"]
            shards = _shards(rt)
        full = _full(rt)
        if name == "port":
            loss = float(rt.step(inputs["batches"][ARCH][0])["loss"])
        out[("restore", name, n)] = dict(step=step, shards=shards, full=full, loss=loss,
                                         opt_step=None if rt.opt_state is None
                                         else rt.opt_state.step)
    return out


def _tensors(state):
    out = []

    def walk(tree):
        for v in tree.values():
            walk(v) if isinstance(v, dict) else out.append(v)
    walk(state.mu)
    walk(state.nu)
    return out


def _eject_first_node(rt):
    g = rt.scheduler.graph
    chip = next(p for p in rt.scheduler.allocations[rt.jobid].paths
                if p in g and g.vertex(p).type == "chip")
    return rt.eject_and_replace(next(a for a in g.ancestors(chip)
                                     if g.vertex(a).type == "node"))


# ---------------------------------------------------------------------- #
# fixtures
# ---------------------------------------------------------------------- #
def _jax_params(arch):
    import jax
    from repro.configs.registry import get_config as jax_get_config
    from repro.models.model import make_model as jax_make_model
    from repro_torch.convert import params_from_jax
    cfg = dataclasses.replace(jax_get_config(arch).reduced(), **PATCH[arch])
    tree = jax.device_get(jax_make_model(cfg).init_params(jax.random.key(0)))
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


def _jax_checkpoint(directory, rng):
    """A JAX checkpoint of reduced llama3.2-3b at step 3 with drawn values
    in every leaf (masters and both moments)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_get_config
    from repro.models.model import make_model as jax_make_model
    from repro.optim.adamw import OptState
    from repro.runtime.checkpoint import CheckpointManager as JaxCheckpointManager
    model = jax_make_model(jax_get_config(ARCH).reduced())
    params = model.init_params(jax.random.key(0))
    state = model.init_opt(params)
    draw = lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32))  # noqa: E731
    tree = {"params": jax.tree_util.tree_map(draw, params),
            "opt_state": OptState(step=jnp.asarray(3, jnp.int32),
                                  mu=jax.tree_util.tree_map(draw, state.mu),
                                  nu=jax.tree_util.tree_map(draw, state.nu))}
    JaxCheckpointManager(str(directory)).save(3, tree)
    flat = {"p." + k: np.asarray(v) for k, v in _flat_tree(tree["params"]).items()}
    flat.update({"mu." + k: np.asarray(v) for k, v in _flat_tree(tree["opt_state"].mu).items()})
    flat.update({"nu." + k: np.asarray(v) for k, v in _flat_tree(tree["opt_state"].nu).items()})
    flat["step"] = np.asarray(3)
    return flat


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero3")
    rng = np.random.default_rng(0)
    batches, data = {}, {}
    for arch in PATCH:
        vocab = _cfg(arch).vocab
        batches[arch] = []
        for i in range(2):
            b = {"tokens": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32),
                 "labels": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)}
            batches[arch].append(b)
            data.update({f"{arch}|{i}|{k}": v for k, v in b.items()})
    np.savez(tmp / "batches.npz", **data)
    moe_cfg = _cfg(MOE_ARCH)
    params = {arch: _jax_params(arch) for arch in PATCH}
    moe_p = {k.split("blocks.ffn.")[1]: v[0] for k, v in params[MOE_ARCH].items()
             if k.startswith("blocks.ffn.")}
    inputs = dict(params=params, batches=batches, moe_p=moe_p,
                  moe_x=rng.standard_normal((BATCH, SEQ, moe_cfg.d_model)).astype(np.float32),
                  moe_w=rng.standard_normal((BATCH, SEQ, moe_cfg.d_model)).astype(np.float32))
    ckpt = {"port": str(tmp / "port_ckpt"), "jax": str(tmp / "jax_ckpt")}
    inputs["jax_ckpt"] = _jax_checkpoint(ckpt["jax"], rng)
    code = ORACLE.replace("np.load(sys.argv[1])", f"np.load({str(tmp / 'batches.npz')!r})")
    with ThreadPoolExecutor(1) as pool:
        oracle = pool.submit(run_jax_oracle, code, tmp)
        ranks = run_world(_port_world, WORLD, tmp, args=(inputs, ckpt), timeout=400.0)
        oracle = oracle.result()
    return inputs, oracle, ranks, ckpt


# ---------------------------------------------------------------------- #
# specs
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", ("full", "reduced"))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_jax(arch, size, kind, results):
    """Every leaf's spec equals JAX's on each mesh: the masters
    (``param_shardings``), the AdamW and Adafactor state (``opt_shardings``:
    Adafactor's row takes axes[:-1], its col axes[:-2] + axes[-1:]), the
    inputs in train, prefill and decode (``input_shardings``) and the
    decode cache (``cache_shardings``)."""
    _, oracle, ranks, _ = results
    want = json.loads(str(oracle["layouts"]))
    got = ranks[0]["layouts"]["layouts"]
    for shape in MESHES:
        key = f"{arch}|{size}|{shape[0]}x{shape[1]}"
        assert got[key][kind] == want[key][kind], key


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_indivisible_mesh_raises_where_jax_raises(arch, results):
    """At a (3, 1) mesh JAX's ``jit(init_params, out_shardings=psh)``
    raises on the first leaf whose split dimension does not divide by 3
    (JAX pads no parameter's shards); the port's model raises
    ``ValueError`` on the same leaf."""
    _, oracle, ranks, _ = results
    want = json.loads(str(oracle["raises"]))[arch]
    assert want, f"{arch}: JAX binds (3, 1)"
    assert ranks[0]["layouts"]["raises"][arch] == want


# ---------------------------------------------------------------------- #
# shards against JAX's devices
# ---------------------------------------------------------------------- #
def _jax_shard(oracle, arch, n, stage, key, r):
    return oracle[f"{arch}|{n}|{stage}|{key}|{r}"]


def _step_tolerance(oracle, arch, n, stage, key):
    """The tolerance of ``test_torch_elastic_ranks._assert_step_matches_jax``
    carried through ``stage`` steps, for leaf ``key`` (a master "p.", a
    moment "mu." / "nu."): each step's gradient may be off by delta, 1e-5
    of the leaf's largest |g| of JAX's. A master moves by AdamW's slope in
    g times delta (``lr s eps^2 / ((g s)^2 + eps^2)^1.5``, s the clip
    scale), summed over the steps; the first moment by ``(1 - b1) s
    delta``, the second by ``(1 - b2) s^2 (2 |g| delta + delta^2)`` (for
    Adafactor, that bound's means along the factored axes, at its decay),
    each decayed as the moment is. Adafactor's update divides by factored
    moments, not by the element's own, and its master carries none: the
    test adds 1e-6 of the largest |value|."""
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.optim.schedule import warmup_cosine
    import torch
    opt = OptConfig(kind=_cfg(arch).optimizer, warmup=5, total_steps=10)
    kind, name = key.split(".", 1)
    part = None
    if kind == "nu" and opt.kind == "adafactor":
        name, part = name.rsplit(".", 1)
    carried = dm = dv = 0.0
    for t in range(1, stage + 1):
        g = oracle[f"{arch}|{n}|{t}|g.{name}"]
        s = min(1.0, opt.clip_norm / max(_grad_norm(oracle, arch, n, t), 1e-9))
        delta = 1e-5 * np.abs(g).max()
        e2 = s * s * (2 * np.abs(g) * delta + delta * delta)
        if opt.kind == "adamw":
            lr = float(warmup_cosine(torch.tensor(float(t)), opt.lr, opt.warmup, opt.total_steps))
            carried = carried + lr * s * delta * opt.eps ** 2 / ((g * s) ** 2 + opt.eps ** 2) ** 1.5
            dm = opt.b1 * dm + (1 - opt.b1) * s * delta
            dv = opt.b2 * dv + (1 - opt.b2) * e2
        elif part is not None:
            decay = 1.0 - (t + 1.0) ** -0.8
            e2 = {"row": lambda a: a.mean(-1), "col": lambda a: a.mean(-2)}.get(
                part, lambda a: a)(e2)
            dv = decay * dv + (1 - decay) * e2
    return {"p": carried, "mu": dm, "nu": dv}[kind]


_NORMS = {}


def _grad_norm(oracle, arch, n, t):
    key = (arch, n, t)
    if key not in _NORMS:
        prefix = f"{arch}|{n}|{t}|g."
        _NORMS[key] = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                                  for k, v in oracle.items() if k.startswith(prefix)))
    return _NORMS[key]


@pytest.mark.parametrize("arch,n", SHARD_CASES, ids=[f"{a}-{n}" for a, n in SHARD_CASES])
def test_shards_match_jax_devices(arch, n, results):
    """Bound at n on JAX's weights, rank r's shard of every master and
    moment is JAX's device-r shard bit for bit; after one step and after
    two, the loss within 1e-6, the mean gradient within 1e-5 of each
    leaf's largest |g| of JAX's, and each shard within 1e-6 of the leaf
    kind's largest |value| of JAX's (or within the gradient tolerance
    carried through the steps, ``_step_tolerance``). The ranks outside the
    n bound ones hold nothing.

    llama4's top-1 router is held as in tests/test_torch_moe_train.py: at
    top-1 the renormalised gate is g / g = 1, so its gradient is each
    framework's rounding noise (within 1e-5 of the model's largest |g|),
    and Adafactor turns that noise into a step of lr's order in a
    direction the noise picks: after the first step its shard lies within
    the two frameworks' largest steps (``_adafactor_step_bound``) of
    JAX's, and the second step, whose loss the moved router changes
    (``test_adafactor_losses_part_after_the_first_step``), is not held
    against JAX."""
    _, oracle, ranks, _ = results
    router = _top1_router(arch)
    stages = (1,) if router else (1, 2)
    for r, res in enumerate(ranks):
        st = res[("shards", arch, n)]
        assert st["bound"] == (r < n)
        if r >= n:
            assert st["stages"][0] is None
            assert all(np.isnan(s["loss"]) and s["shards"] is None for s in st["stages"][1:])
            continue
        for key, got in st["stages"][0].items():
            np.testing.assert_array_equal(got, _jax_shard(oracle, arch, n, 0, key, r), err_msg=key)
        for stage in stages:
            s = st["stages"][stage]
            want_loss = float(oracle[f"{arch}|{n}|{stage}|loss"])
            assert abs(s["loss"] - want_loss) <= TOL * abs(want_loss)
            largest = max(np.abs(v).max() for k, v in oracle.items()
                          if k.startswith(f"{arch}|{n}|{stage}|g."))
            for k, g in s["grads"].items():
                want = oracle[f"{arch}|{n}|{stage}|g.{k}"]
                scale = largest if k == router else np.abs(want).max()
                np.testing.assert_allclose(g, want, atol=1e-5 * scale, rtol=0, err_msg=k)
            for kind in ("p.", "mu.", "nu."):
                keys = [k for k in s["shards"] if k.startswith(kind)]      # Adafactor: no mu
                scale = max((np.abs(_jax_shard(oracle, arch, n, stage, k, r)).max()
                             for k in keys), default=0.0)
                for key in keys:
                    want = _jax_shard(oracle, arch, n, stage, key, r)
                    err = np.abs(s["shards"][key] - want)
                    if router and key.split(".", 1)[1].startswith(router):
                        if kind == "p.":
                            p0 = _jax_shard(oracle, arch, n, 0, key, r)
                            assert err.max() <= 2 * _adafactor_step_bound(p0), key
                        continue
                    tol = np.maximum(TOL * scale, _jax_shard_of(
                        _step_tolerance(oracle, arch, n, stage, key), want.shape, r))
                    assert (err <= tol).all(), (key, stage, err.max())


def _top1_router(arch):
    return "blocks.moe.ffn.router" if _cfg(arch).top_k == 1 else None


def _adafactor_step_bound(p0):
    """The largest change one Adafactor step at lr(1) can make to an
    element of the leaf ``p0`` (tests/test_torch_moe_train.py): the RMS clip
    leaves no |u| above sqrt(n) over the leaf's n elements."""
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.optim.schedule import warmup_cosine
    import torch
    opt = OptConfig(kind="adafactor", warmup=5, total_steps=10)
    lr = float(warmup_cosine(torch.tensor(1.0), opt.lr, opt.warmup, opt.total_steps))
    return lr * (math.sqrt(p0.size) + opt.weight_decay * np.abs(p0).max())


def _jax_shard_of(carried, shape, r):
    """Rank r's block of a whole-leaf tolerance array (the block of
    ``shape`` along the one dimension where they differ)."""
    if np.ndim(carried) == 0 or carried.shape == shape:
        return carried
    d = next(i for i, (a, b) in enumerate(zip(carried.shape, shape)) if a != b)
    index = [slice(None)] * carried.ndim
    index[d] = slice(r * shape[d], (r + 1) * shape[d])
    return carried[tuple(index)]


@pytest.mark.parametrize("arch,n", SHARD_CASES, ids=[f"{a}-{n}" for a, n in SHARD_CASES])
def test_held_bytes(arch, n, results):
    """A bound rank holds exactly the whole leaves plus 1/n of the split
    ones (masters and moments, fp32), the split ones being those JAX's
    specs at (n, 1) put over "data"."""
    inputs, oracle, ranks, _ = results
    layout = json.loads(str(oracle["layouts"]))[f"{arch}|reduced|{n}x1"]
    cfg = _cfg(arch)
    opt = layout["opt_" + cfg.optimizer]
    params = inputs["params"][arch]

    def split(spec):
        return any(p == "data" or isinstance(p, list) and "data" in p for p in spec)

    want = 0
    for name, v in params.items():
        want += v.size * 4 // (n if split(layout["params"][name]) else 1)
        for tree in ("mu", "nu"):
            for k, spec in _flat_tree(opt[tree]).items():
                if k == name or k.startswith(name + "."):
                    shape = {"row": v.shape[:-1], "col": v.shape[:-2] + v.shape[-1:]}.get(
                        k.rsplit(".", 1)[1] if k != name else "", v.shape)
                    want += math.prod(shape) * 4 // (n if split(spec) else 1)
    for r in range(n):
        assert ranks[r][("shards", arch, n)]["held"] == want


# ---------------------------------------------------------------------- #
# against one process, rebinds, checkpoints
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def single(results):
    """The llama steps in one process, no process group, by grad_accum."""
    inputs = results[0]
    out = {}
    for k in ACCUM:
        rt = _bound(_cfg(ARCH, grad_accum=k), 1, inputs["params"][ARCH])
        out[k] = [dict(loss=float(rt.step(b)["loss"]), full=_full(rt))
                  for b in inputs["batches"][ARCH]]
    return out


@pytest.mark.parametrize("accum", ACCUM)
def test_gathered_matches_one_process(accum, results, single):
    """Two steps on 4 bound ranks and in one process: the losses within
    1e-6 and the gathered masters and moments within 1e-6 of each kind's
    largest |value|, with ``grad_accum`` 1 and 2."""
    _, _, ranks, _ = results
    for res in ranks:
        for got, want in zip(res[("accum", accum)], single[accum]):
            assert abs(got["loss"] - want["loss"]) <= TOL * abs(want["loss"])
            assert got["full"].keys() == want["full"].keys()
            for kind in ("p.", "mu.", "nu."):
                keys = [k for k in want["full"] if k.startswith(kind)]
                scale = max(np.abs(want["full"][k]).max() for k in keys)
                for k in keys:
                    np.testing.assert_allclose(got["full"][k], want["full"][k], atol=TOL * scale,
                                               rtol=0, err_msg=k)


@pytest.mark.parametrize("name", REBINDS)
def test_rebind_keeps_gathered_state(name, results):
    """Grow 2 -> 4, shrink 4 -> 2, and an ejection whose replacement binds
    4: every gathered master and moment and the step are bit for bit what
    they were before the rebind, on every rank bound after it."""
    _, _, ranks, _ = results
    want_bound = {"grow 2": (2, 4), "shrink 2": (4, 2), "eject and replace": (2, 4)}[name]
    for r, res in enumerate(ranks):
        st = res[("rebind", name)]
        assert st["ok"] and st["bound"] == want_bound
        if r >= want_bound[1]:
            assert st["after"] is None
            continue
        before = ranks[0][("rebind", name)]["before"]
        assert st["after"].keys() == before.keys()
        for k, v in before.items():
            np.testing.assert_array_equal(st["after"][k], v, err_msg=k)


def test_checkpoint_from_four_restores_on_two(results):
    """The twin of tests/test_elastic.py's ``test_checkpoint_restart_resumes``
    across ranks: ``run_training`` on 4 bound ranks checkpoints (rank 0,
    every leaf gathered whole); a runtime of 2 bound ranks restores the
    latest through ``shardings=``: each rank's shards gather to the file's
    leaves, bit for bit, and its next step is finite."""
    from repro_torch.runtime.checkpoint import CheckpointManager
    _, _, ranks, ckpt = results
    with np.load(f"{ckpt['port']}/step_00000011/params.npz") as z:
        saved = [z[f"leaf_{i}"] for i in range(len(z.files))]
    trained = ranks[0]["trained"]
    params = [trained[k] for k in sorted(trained) if k.startswith("p.")]
    assert [a.shape for a in saved] == [a.shape for a in params]       # whole leaves
    for a, b in zip(saved, params):
        np.testing.assert_array_equal(a, b)
    assert CheckpointManager(ckpt["port"]).latest_step() == 11
    for r, res in enumerate(ranks):
        st = res[("restore", "port", 2)]
        if r >= 2:
            assert st["shards"] is None and st["full"] is None
            continue
        assert st["step"] == 11 and st["opt_step"] == 12 and np.isfinite(st["loss"])
        assert st["full"].keys() == trained.keys()
        for k, v in trained.items():
            np.testing.assert_array_equal(st["full"][k], v, err_msg=k)


def test_checkpoint_gather_keeps_one_host_copy(results):
    """``full_state``, the gather a checkpoint takes, leaves the whole
    state on the host of rank 0, the writer, equal to the gathered state;
    the other ranks take part in the gathers and keep nothing."""
    _, _, ranks, _ = results
    trained = ranks[0]["trained"]
    got = ranks[0]["writer_state"]
    assert got.keys() == trained.keys()
    for k, v in trained.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert all(res["writer_state"] is None for res in ranks[1:])


def test_port_checkpoint_restores_into_jax(results):
    """The files the ranks wrote restore into JAX's tree of reduced
    llama3.2-3b (its ``CheckpointManager``), equal to the gathered state."""
    import jax
    from repro.configs.registry import get_config as jax_get_config
    from repro.models.model import make_model as jax_make_model
    from repro.runtime.checkpoint import CheckpointManager as JaxCheckpointManager
    _, _, ranks, ckpt = results
    model = jax_make_model(jax_get_config(ARCH).reduced())
    params = model.init_params(jax.random.key(0))
    step, out = JaxCheckpointManager(ckpt["port"]).restore(
        like={"params": params, "opt_state": model.init_opt(params)})
    assert step == 11 and int(out["opt_state"].step) == 11
    trained = ranks[0]["trained"]
    for k, v in _flat_tree(out["params"]).items():
        np.testing.assert_array_equal(np.asarray(v), trained["p." + k], err_msg=k)
    for tree in ("mu", "nu"):
        for k, v in _flat_tree(getattr(out["opt_state"], tree)).items():
            np.testing.assert_array_equal(np.asarray(v), trained[f"{tree}.{k}"], err_msg=k)


@pytest.mark.parametrize("n", (4, 2))
def test_jax_checkpoint_restores_into_port(n, results):
    """A checkpoint JAX wrote restores through ``shardings=`` on n bound
    ranks: each rank's shards are its blocks of JAX's leaves along the
    dimension JAX's (n, 1) spec puts over "data", and they gather to
    JAX's leaves, bit for bit."""
    inputs, oracle, ranks, _ = results
    want = inputs["jax_ckpt"]
    layout = json.loads(str(oracle["layouts"]))[f"{ARCH}|reduced|{n}x1"]
    specs = {"p." + k: v for k, v in layout["params"].items()}
    specs.update({f"{t}.{k}": v for t in ("mu", "nu")
                  for k, v in _flat_tree(layout["opt_adamw"][t]).items()})
    for r, res in enumerate(ranks):
        st = res[("restore", "jax", n)]
        if r >= n:
            assert st["shards"] is None
            continue
        assert st["step"] == 3 and st["opt_step"] == 3
        for k, v in want.items():
            if k == "step":
                continue
            np.testing.assert_array_equal(st["full"][k], v, err_msg=k)
            d = next((i for i, p in enumerate(specs[k])
                      if p == "data" or isinstance(p, list) and "data" in p), None)
            block = v if d is None else np.split(v, n, axis=d)[r]
            np.testing.assert_array_equal(st["shards"][k], block, err_msg=k)


# ---------------------------------------------------------------------- #
# the MoE dispatch's buffer, the gather
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n,cf", MOE_CASES, ids=[f"n{n}-cf{cf}" for n, cf in MOE_CASES])
def test_moe_dispatch_splits_capacity(n, cf, results):
    """On n data ranks the reduced qwen3-moe layer's experts run over an
    [E, C/n, e] buffer on each rank (C 128 at capacity factor 1.0; 129 at
    1.01, padded to a multiple of n); y, x's gradient and the layer's
    gradients (summed over the ranks) equal the one-process dispatch of the
    whole batch within 1e-6 of their largest |value|."""
    import torch
    from repro_torch.models import moe
    inputs, _, ranks, _ = results
    cfg = _cfg(MOE_ARCH, capacity_factor=cf)
    x = torch.from_numpy(inputs["moe_x"]).requires_grad_()
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in inputs["moe_p"].items()}
    y = moe.moe_dispatch(x, leaves, cfg)
    grads = torch.autograd.grad((y * torch.from_numpy(inputs["moe_w"])).sum(),
                                [x] + list(leaves.values()))
    C = moe.capacity(BATCH * SEQ, cfg)
    assert C == {1.0: 128, 1.01: 129}[cf]
    buffer = (cfg.n_experts, -(-C // n), cfg.d_model)
    parts = [ranks[r]["moe"][(n, cf)] for r in range(n)]
    for part in parts:
        assert part["buffers"] == [buffer]
    for got, want in ((np.concatenate([p["y"] for p in parts]), y.detach().numpy()),
                      (np.concatenate([p["gx"] for p in parts]), grads[0].numpy())):
        np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)
    for (k, want) in zip(leaves, grads[1:]):
        for part in parts:
            np.testing.assert_allclose(part["gp"][k], want.numpy(),
                                       atol=TOL * np.abs(want.numpy()).max(), rtol=0, err_msg=k)


def test_gather_backward_sums_rank_slices(results):
    """At float64 on gloo, ``Sharded.full`` returns the ranks' shards side
    by side, and its backward gives each rank the sum over the ranks of
    their gradients' slices for its block (the reduce-scatter)."""
    _, _, ranks, _ = results
    shards = [np.random.default_rng(r).standard_normal((3, 2)) for r in range(WORLD)]
    ws = [np.random.default_rng(100 + r).standard_normal((3, 2 * WORLD)) for r in range(WORLD)]
    total = sum(ws)
    for r, res in enumerate(ranks):
        g = res["gather"]
        np.testing.assert_array_equal(g["full"], np.concatenate(shards, axis=1))
        np.testing.assert_allclose(g["grad"], total[:, 2 * r:2 * r + 2], rtol=1e-15, atol=1e-15)
