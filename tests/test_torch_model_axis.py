"""A model axis above 1 in the port's training runtime against JAX's.

``ElasticRuntime(model_axis=m)`` binds a ("data" n/m, "model" m) mesh of
a gloo world of 4 CPU processes (one ``run_world`` for the whole file)
and is held against a JAX subprocess with 4 host devices under Auto
axes (one ``run_jax_oracle``):

* reduced llama3.2-3b, mamba2-2.7b, zamba2-2.7b and qwen3-moe-30b-a3b
  (capacity factor 1.0, once on the dispatch and once on ``moe_a2a``) on
  meshes (1, 2), (2, 2) and (1, 4), on JAX's weights: each rank's shard of
  every master and moment is JAX's device shard for its mesh coordinate
  bit for bit, and after one and two AdamW steps within the step
  tolerances of ``test_torch_zero3`` (the loss within 1e-6, the mean
  gradient within 1e-5 of each leaf's largest |g|); the second step
  starts from JAX's state after the first (a second world, after the
  oracle), because AdamW turns the first step's rounding in near-zero
  gradients into steps of up to lr, which the second step's gradients
  carry on past 1e-5 (qwen3-moe's, and zamba2's against one process); a
  rank holds the bytes of JAX's device shards;
* ``moe_a2a`` under ``moe_ep2d`` (each expert's f sliced over "data") at
  (2, 2), the same way;
* the gathered masters and moments after one step against the
  one-process port, within 1e-6 of each kind's largest |value| or twice
  the step tolerance (every case but ``moe_a2a``, whose capacities
  follow its shard count in both frameworks);
* mamba2 with ``ssm_seq_sharded`` (the scan's output back to the
  positions by all-to-all) at (2, 2), the same way: JAX's program changes
  with the flag, the values must not;
* qwen2-vl's M-RoPE and musicgen's sinusoid, whose positions start at
  each model rank's block, at the loss level;
* the embedding lookup in a sharded table (``sharded_take``), at (2, 2),
  of a vocab-split table (vocab 256: rows over "model", e over "data") and
  an e-split one (vocab 250: e over ("data", "model")), against JAX's
  ``embed_tokens`` under the same mesh: each rank's rows of its block of
  the tokens (positions split over "model", and decode's one position
  whole over it) bit for bit, each rank's shard of the table's gradient
  within 1e-6, and no weight all-gather;
* the sequence gather (attention's K and V, with the prefix a rank
  attends), the conv's halo and the all-to-alls between sequence and head
  blocks at float64 over model groups of 2 and 4: forward values, and the
  backward as the sum over the ranks of their gradients' slices;
* grow 2 -> 4, shrink 4 -> 2 and an ejection at ``model_axis=2`` change
  no gathered value; a checkpoint of (2, 2) restores on (1, 2).
"""
import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from torch_dist_harness import run_jax_oracle, run_world

WORLD = 4
SEQ, BATCH = 32, 8
MESHES = ((1, 2), (2, 2), (1, 4))
MOE = "qwen3-moe-30b-a3b"
# case: (arch, config patch)
CASES = {"llama3.2-3b": ("llama3.2-3b", {}), "mamba2-2.7b": ("mamba2-2.7b", {}),
         "zamba2-2.7b": ("zamba2-2.7b", {}),
         "qwen3-moe-dispatch": (MOE, {"moe_impl": "dispatch", "capacity_factor": 1.0}),
         "qwen3-moe-a2a": (MOE, {"moe_impl": "a2a", "capacity_factor": 1.0}),
         "qwen3-moe-a2a-ep2d": (MOE, {"moe_impl": "a2a", "capacity_factor": 1.0,
                                      "moe_ep2d": True}),
         "mamba2-seq-sharded": ("mamba2-2.7b", {"ssm_seq_sharded": True})}
# cases on the (2, 2) mesh alone: moe_ep2d slices each expert's f over
# "data", a mesh with both axes above 1; the §Perf Mamba2 form beside the
# baseline's three meshes
ONE_MESH = ("qwen3-moe-a2a-ep2d", "mamba2-seq-sharded")
SHARD_CASES = [(c, m) for c in CASES for m in MESHES if c not in ONE_MESH or m == (2, 2)]
ONE_PROCESS = [(c, m) for c, m in SHARD_CASES if not c.startswith("qwen3-moe-a2a")]
FAMILIES = ("qwen2-vl-72b", "musicgen-medium")
FAMILY_CASES = [(a, m) for a in FAMILIES for m in MESHES]
GROUPS = {2: (2, 2), 4: (1, 4)}        # model group size: the mesh that has it
# the sharded lookup's tables: layout -> vocab (256 splits its rows over
# "model", 250 does not divide 256 and splits e over ("data", "model"))
EMBED_VOCABS = {"vocab-split": 256, "e-split": 250}
EMBED_PARTS = ("prefill", "decode", "grad")
REBINDS = ("grow 2", "shrink 2", "eject and replace")
TOL = 1e-6


def _tag(case, mesh):
    return f"{case}|{mesh[0]}x{mesh[1]}"


ORACLE = f"""
import dataclasses
import json
import jax.numpy as jnp
from repro.configs.registry import get_config
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


def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])


data = np.load(sys.argv[1])
for case, shape in {SHARD_CASES!r}:
    arch, patch = {CASES!r}[case]
    cfg = dataclasses.replace(get_config(arch).reduced(), **patch)
    opt = OptConfig(kind=cfg.optimizer, warmup=5, total_steps=10)
    mesh = mesh_of(shape)
    devices = list(mesh.devices.flat)
    model = make_model(cfg, ShardingCtx(Rules(), mesh), opt)
    tag = f"{{case}}|{{shape[0]}}x{{shape[1]}}"
    save(**{{f"{{tag}}|spec": np.asarray(json.dumps(
        {{k: [norm(p) for p in v.spec] for k, v in flat(model.param_shardings()).items()}}))}})

    def shards(stage, params, opt_state):
        leaves = {{"p." + k: v for k, v in flat(params).items()}}
        leaves.update({{"mu." + k: v for k, v in flat(opt_state.mu).items()}})
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
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.models.layers import embed_tokens
mesh = mesh_of((2, 2))
for layout, vocab in {EMBED_VOCABS!r}.items():
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), vocab=vocab)
    ctx = ShardingCtx(Rules(), mesh)
    tsh = make_model(cfg, ctx).param_shardings()["embed"]["embedding"]
    with mesh:
        table = jax.device_put(jnp.asarray(data[f"embed|{{layout}}|table"]), tsh)
        tok = jax.device_put(jnp.asarray(data[f"embed|{{layout}}|tokens"]),
                             NamedSharding(mesh, P("data", "model")))
        dec = jax.device_put(jnp.asarray(data[f"embed|{{layout}}|tokens"][:, :1]),
                             NamedSharding(mesh, P("data", None)))
        w = jnp.asarray(data[f"embed|{{layout}}|w"])
        look = jax.jit(lambda t, k: embed_tokens(k, {{"embedding": t}}, cfg, ctx))
        out, vjp = jax.vjp(lambda t: look(t, tok), table)
        (grad,) = vjp(w)
        save(**{{f"embed|{{layout}}|prefill": out, f"embed|{{layout}}|grad": grad,
                 f"embed|{{layout}}|decode": look(table, dec)}})
for arch in {FAMILIES!r}:
    cfg = get_config(arch).reduced()
    params = make_model(cfg).init_params(jax.random.key(0))
    batch = {{"embeds": jnp.asarray(data[f"{{arch}}|embeds"]),
              "labels": jnp.asarray(data[f"{{arch}}|labels"])}}
    for shape in {MESHES!r}:
        mesh = mesh_of(shape)
        model = make_model(cfg, ShardingCtx(Rules(), mesh))
        with mesh:
            p = jax.device_put(params, model.param_shardings())
            b = jax.device_put(batch, model.input_shardings(
                ShapeConfig("t", {SEQ}, {BATCH}, "train")))
            loss = jax.jit(lambda p, b: loss_fn(p, cfg, model.ctx, b))(p, b)
        save(**{{f"{{arch}}|{{shape[0]}}x{{shape[1]}}|loss": loss}})
"""


# ---------------------------------------------------------------------- #
# the port's side, on every rank of the gloo world
# ---------------------------------------------------------------------- #
def _cfg(case, **kw):
    from repro_torch.configs import get_config
    arch, patch = CASES[case] if case in CASES else (case, {})
    return dataclasses.replace(get_config(arch).reduced(), **{**patch, **kw})


def _runtime(cfg, model_axis):
    from repro_torch.core.graph import build_tpu_fleet
    from repro_torch.core.scheduler import SchedulerInstance
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.elastic import ElasticRuntime
    fleet = build_tpu_fleet(pods=1, racks_per_pod=1, nodes_per_rack=4, chips_per_node=4,
                            device="cpu")
    return ElasticRuntime(SchedulerInstance("top", fleet), cfg,
                          ShapeConfig("smoke_train", SEQ, BATCH, "train"), chip_type="chip",
                          model_axis=model_axis,
                          opt=OptConfig(kind=cfg.optimizer, warmup=5, total_steps=10),
                          device="cpu")


def _bound(cfg, mesh, params):
    """A runtime bound on a (data, model) ``mesh`` of ranks, loaded with
    ``params`` (whole leaves)."""
    import torch
    rt = _runtime(cfg, mesh[1])
    rt.allocate(mesh[0] * mesh[1])
    rt.bind()
    if rt.model is not None:
        rt.model.load_params({k: torch.from_numpy(v) for k, v in params.items()})
        rt.opt_state = rt.model.init_opt()
    return rt


def _shards(rt):
    """This rank's shards: {"p.<name>", "mu.<name>", "nu.<name>"}."""
    out = {"p." + k: v.numpy().copy() for k, v in rt.params.items()}
    out.update({"mu." + k: v.numpy().copy() for k, v in rt.opt_state.mu.items()})
    out.update({"nu." + k: v.numpy().copy() for k, v in rt.opt_state.nu.items()})
    return out


def _full(rt):
    """The gathered masters and moments on every bound rank, None outside."""
    if rt.model is None:
        return None
    out = {"p." + k: v.numpy() for k, v in rt.model.full_params().items()}
    state = rt.model.full_opt_state(rt.opt_state)
    out.update({"mu." + k: v.numpy() for k, v in state.mu.items()})
    out.update({"nu." + k: v.numpy() for k, v in state.nu.items()})
    return out


def _step(rt, batch):
    """One step: the loss, the gradient the optimizer is given (gathered
    whole) and this rank's shards after it."""
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


def _collectives_world(rank):
    """The sequence gather (with the prefix of (r+1) blocks that attention
    keeps), the halo and the all-to-alls at float64 over the model groups
    of 2 ((2, 2) mesh) and 4 ((1, 4) mesh): outputs and the gradients of
    sum(out * w) with respect to the rank's block."""
    import torch
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.parallel.sharding import (Rules, ShardingCtx, gather_seq, halo_prev,
                                               heads_to_seq, seq_to_heads, seq_shards)
    out = {}
    for n, mesh in GROUPS.items():
        mesh = make_mesh_for(WORLD, mesh[1])
        sp = seq_shards(ShardingCtx(Rules(), mesh))
        a, w = (torch.from_numpy(t) for t in _collective_inputs(n, rank))
        x = a.clone().requires_grad_()
        full = gather_seq(x, 1, sp)[:, :(sp.rank + 1) * 3]
        (gx,) = torch.autograd.grad((full * w[:, :full.shape[1], :5]).sum(), x)
        u = a[:, :, :4].clone().requires_grad_()
        halo = halo_prev(u, 2, sp)
        (gu,) = torch.autograd.grad((halo * w[:, :2, :4]).sum(), u)
        # [b 2, s/n 3, H 4, P 2] -> [2, 3 n, 4 / n, 2]
        xh = (a[:, :, :4, None] * torch.arange(1.0, 3.0, dtype=a.dtype)).requires_grad_()
        heads = seq_to_heads(xh, sp)
        back = heads_to_seq(heads, sp)
        wh = w[:, :3 * n, :4 // n, None].expand(2, 3 * n, 4 // n, 2)
        (gh,) = torch.autograd.grad((heads * wh).sum() + (back * back).sum(), xh)
        out[n] = dict(rank=sp.rank, full=full.detach().numpy(), gx=gx.numpy(),
                      halo=halo.detach().numpy(), gu=gu.numpy(), xh=xh.detach().numpy(),
                      heads=heads.detach().numpy(), back=back.detach().numpy(),
                      wh=wh.numpy(), gh=gh.numpy())
    return out


def _embed_world(rank, inputs):
    """Each ``EMBED_VOCABS`` table as this rank's shard on the (2, 2) mesh,
    looked up for the rank's block of the tokens (rows over "data",
    positions over "model"), and for decode's first position (whole over
    "model"): the rows, the gradient of sum(rows * w) for the shard, and
    the weight all-gathers' bytes of the lookup."""
    import torch
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.tally import tally
    from repro_torch.models.layers import embed_specs, embed_tokens
    from repro_torch.parallel.sharding import (Rules, Sharded, ShardingCtx, local_shard,
                                               splits_of)
    mesh = make_mesh_for(WORLD, 2)
    ctx = ShardingCtx(Rules(), mesh)
    d, m = mesh.get_coordinate()
    rows = slice(d * BATCH // 2, (d + 1) * BATCH // 2)
    cols = slice(m * SEQ // 2, (m + 1) * SEQ // 2)
    out = {}
    for layout, vocab in EMBED_VOCABS.items():
        cfg = _cfg("llama3.2-3b", vocab=vocab)
        spec = ctx.spec(*embed_specs(cfg)["embedding"].axes)
        table, tokens, w = (torch.from_numpy(inputs["embed"][f"{layout}|{k}"])
                            for k in ("table", "tokens", "w"))
        shard = local_shard(table, spec, mesh).clone().requires_grad_()
        p = {"embedding": Sharded(shard, splits_of(spec, mesh), shard.dtype)}
        with tally() as t:
            x = embed_tokens(tokens[rows, cols], p, cfg, ctx)
            (grad,) = torch.autograd.grad((x * w[rows, cols]).sum(), shard)
            dec = embed_tokens(tokens[rows, :1], p, cfg, ctx, seq_split=False)
        out[layout] = dict(prefill=x.detach().numpy(), grad=grad.numpy(),
                           decode=dec.detach().numpy(), ag2d=t.collective_bytes_ag2d,
                           spec=list(spec), coord=(d, m))
    return out


def _collective_inputs(n, rank):
    """Rank ``rank``'s block a [2, 3, 5] and weights w [2, 12, 5], float64."""
    rng = np.random.default_rng(100 * n + rank)
    return rng.standard_normal((2, 3, 5)), rng.standard_normal((2, 12, 5))


def _port_world(rank, world, inputs, ckpt):
    import torch
    import torch.distributed as dist
    from repro_torch.runtime.checkpoint import CheckpointManager

    out = {"collectives": _collectives_world(rank), "embed": _embed_world(rank, inputs)}
    for case, mesh in SHARD_CASES:
        arch = CASES[case][0]
        rt = _bound(_cfg(case), mesh, inputs["params"][arch])
        res = {"bound": rt.bound, "stages": [None if rt.model is None else _shards(rt)],
               "mesh": list(rt.device_mesh.shape),
               "coord": list(rt.device_mesh.get_coordinate() or [])}
        if rt.bound:
            res["held"] = sum(t.numel() * t.element_size() for t in
                              list(rt.params.values()) + list(rt.opt_state.mu.values())
                              + list(rt.opt_state.nu.values()))
        res["stages"].append(_step(rt, inputs["batches"][arch][0]))
        res["full"] = _full(rt)
        out[("shards", case, mesh)] = res
    for arch, mesh in FAMILY_CASES:
        rt = _bound(_cfg(arch), mesh, inputs["params"][arch])
        out[("family", arch, mesh)] = float(rt.step(inputs["families"][arch])["loss"])
    # rebinds at model_axis 2: the gathered state before and after each
    rt = _bound(_cfg("mamba2-2.7b"), (1, 2), inputs["params"]["mamba2-2.7b"])
    rt.step(inputs["batches"]["mamba2-2.7b"][0])
    acts = {"grow 2": lambda: rt.grow(2), "shrink 2": lambda: rt.shrink(2),
            "eject and replace": lambda: _eject_first_node(rt)}
    for name in REBINDS:
        before, n_before = _full(rt), len(rt.mesh)
        ok = acts[name]()
        after = _full(rt)
        loss = float(rt.step(inputs["batches"]["mamba2-2.7b"][1])["loss"])
        out[("rebind", name)] = dict(ok=ok, bound=(n_before, len(rt.mesh)), before=before,
                                     after=after, mesh=list(rt.device_mesh.shape), loss=loss)
    # a checkpoint of (2, 2), restored on (1, 2)
    rt = _bound(_cfg("llama3.2-3b"), (2, 2), inputs["params"]["llama3.2-3b"])
    rt.step(inputs["batches"]["llama3.2-3b"][0])
    state = rt.full_state()
    if rank == 0:
        CheckpointManager(ckpt).save(1, state)
    out["saved"] = _full(rt)
    dist.barrier()
    rt = _runtime(_cfg("llama3.2-3b"), 2)
    rt.allocate(2)
    rt.bind(torch.Generator().manual_seed(1))
    res = {"bound": rt.bound}
    if rt.bound:
        step, state = CheckpointManager(ckpt).restore(
            {"params": rt.params, "opt_state": rt.opt_state},
            shardings={"params": rt.model.param_shardings(),
                       "opt_state": rt.model.opt_shardings()})
        rt.params, rt.opt_state = state["params"], state["opt_state"]
        res.update(step=step, opt_step=rt.opt_state.step, mesh=list(rt.device_mesh.shape))
    res["full"] = _full(rt)
    res["loss"] = float(rt.step(inputs["batches"]["llama3.2-3b"][1])["loss"])
    out["restore"] = res
    return out


def _second_step_world(rank, world, inputs, state):
    """Each shard case's second step from JAX's state after the first:
    this rank's shards of JAX's masters and moments (``state``, by
    case, mesh and rank) at optimizer step 1."""
    import torch
    from repro_torch.optim.adamw import OptState
    out = {}
    for case, mesh in SHARD_CASES:
        rt = _bound(_cfg(case), mesh, inputs["params"][CASES[case][0]])
        if rt.bound:
            mine = state[(case, mesh, rank)]
            rt.params = {k: torch.from_numpy(mine["p." + k]) for k in rt.params}
            rt.opt_state = OptState(
                step=1, mu={k: torch.from_numpy(mine["mu." + k].copy()) for k in rt.opt_state.mu},
                nu={k: torch.from_numpy(mine["nu." + k].copy()) for k in rt.opt_state.nu})
        out[(case, mesh)] = _step(rt, inputs["batches"][CASES[case][0]][1])
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
def _jax_params(arch, patch):
    import jax
    from repro.configs.registry import get_config as jax_get_config
    from repro.models.model import make_model as jax_make_model
    from repro_torch.convert import params_from_jax
    cfg = dataclasses.replace(jax_get_config(arch).reduced(), **patch)
    tree = jax.device_get(jax_make_model(cfg).init_params(jax.random.key(0)))
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_axis")
    rng = np.random.default_rng(0)
    archs = {arch: patch for arch, patch in CASES.values()}
    batches, data, families = {}, {}, {}
    for arch in archs:
        vocab = _cfg(arch).vocab
        batches[arch] = []
        for i in range(2):
            b = {"tokens": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32),
                 "labels": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)}
            batches[arch].append(b)
            data.update({f"{arch}|{i}|{k}": v for k, v in b.items()})
    for arch in FAMILIES:
        cfg = _cfg(arch)
        families[arch] = {
            "embeds": rng.standard_normal((BATCH, SEQ, cfg.d_model)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)}
        data.update({f"{arch}|{k}": v for k, v in families[arch].items()})
    embed = {}
    for layout, vocab in EMBED_VOCABS.items():
        embed.update({f"{layout}|table": rng.standard_normal((vocab, 64)).astype(np.float32),
                      f"{layout}|tokens": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32),
                      f"{layout}|w": rng.standard_normal((BATCH, SEQ, 64)).astype(np.float32)})
    data.update({f"embed|{k}": v for k, v in embed.items()})
    np.savez(tmp / "batches.npz", **data)
    params = {arch: _jax_params(arch, {}) for arch in list(archs) + list(FAMILIES)}
    inputs = dict(params=params, batches=batches, families=families, embed=embed)
    code = ORACLE.replace("np.load(sys.argv[1])", f"np.load({str(tmp / 'batches.npz')!r})")
    with ThreadPoolExecutor(1) as pool:
        oracle = pool.submit(run_jax_oracle, code, tmp, timeout=600.0)
        ranks = run_world(_port_world, WORLD, tmp, args=(inputs, str(tmp / "ckpt")),
                          timeout=600.0)
        oracle = oracle.result()
    state = {(case, mesh, r): {k.split("|")[3]: v for k, v in oracle.items()
                               if k.startswith(f"{_tag(case, mesh)}|1|") and k.endswith(f"|{r}")}
             for case, mesh in SHARD_CASES for r in range(mesh[0] * mesh[1])}
    second = run_world(_second_step_world, WORLD, tmp, args=(inputs, state), timeout=600.0)
    for r, res in enumerate(ranks):
        for (case, mesh), st in second[r].items():
            res[("shards", case, mesh)]["stages"].append(st)
    return inputs, oracle, ranks


@pytest.fixture(scope="module")
def single(results):
    """One step of each case but ``moe_a2a`` in one process, gathered."""
    inputs = results[0]
    out = {}
    for case in {c for c, _ in ONE_PROCESS}:
        arch = CASES[case][0]
        rt = _bound(_cfg(case), (1, 1), inputs["params"][arch])
        loss = float(rt.step(inputs["batches"][arch][0])["loss"])
        out[case] = dict(loss=loss, full=_full(rt))
    return out


# ---------------------------------------------------------------------- #
# shards against JAX's devices
# ---------------------------------------------------------------------- #
def _block(full, spec, mesh, coord):
    """The block of ``full`` that mesh coordinate ``coord`` owns under
    ``spec`` (JAX's order of each dimension's axes)."""
    if np.ndim(full) == 0:
        return full
    sizes = dict(zip(("data", "model"), mesh))
    at = dict(zip(("data", "model"), coord))
    index = []
    for d, p in enumerate(spec):
        axes = [p] if isinstance(p, str) else list(p or [])
        i, k = 0, 1
        for a in axes:
            i, k = i * sizes[a] + at[a], k * sizes[a]
        n = full.shape[d] // k
        index.append(slice(i * n, (i + 1) * n))
    return full[tuple(index)]


def _step_tolerance(oracle, tag, stage, key, start=0):
    """The gradient tolerance (1e-5 of the leaf's largest |g| of JAX's)
    carried through AdamW's steps ``start`` + 1 .. ``stage`` to leaf
    ``key``, as in tests/test_torch_zero3.py: a master by AdamW's slope in
    g, the first moment by (1 - b1) s delta, the second by (1 - b2) s^2 (2
    |g| delta + delta^2), each decayed as the moment is."""
    import torch
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.optim.schedule import warmup_cosine
    opt = OptConfig(kind="adamw", warmup=5, total_steps=10)
    kind, name = key.split(".", 1)
    carried = dm = dv = 0.0
    for t in range(start + 1, stage + 1):
        g = oracle[f"{tag}|{t}|g.{name}"]
        norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for k, v in oracle.items()
                           if k.startswith(f"{tag}|{t}|g.")))
        s = min(1.0, opt.clip_norm / max(norm, 1e-9))
        delta = 1e-5 * np.abs(g).max()
        lr = float(warmup_cosine(torch.tensor(float(t)), opt.lr, opt.warmup, opt.total_steps))
        carried = carried + lr * s * delta * opt.eps ** 2 / ((g * s) ** 2 + opt.eps ** 2) ** 1.5
        dm = opt.b1 * dm + (1 - opt.b1) * s * delta
        dv = opt.b2 * dv + (1 - opt.b2) * s * s * (2 * np.abs(g) * delta + delta * delta)
    return {"p": carried, "mu": dm, "nu": dv}[kind]


@pytest.mark.parametrize("case,mesh", SHARD_CASES, ids=[_tag(c, m) for c, m in SHARD_CASES])
def test_shards_match_jax_devices(case, mesh, results):
    """On a (data, model) mesh on JAX's weights, the rank at mesh
    coordinate (d, m) holds JAX's device shard of every master and moment
    bit for bit; after the first step (from JAX's weights) and the second
    (from JAX's state after the first), the loss within 1e-6, the mean
    gradient within 1e-5 of each leaf's largest |g| of JAX's, and each
    shard within 1e-6 of the leaf kind's largest |value| of JAX's or the
    step's gradient tolerance carried to it. Ranks outside the mesh hold
    nothing."""
    _, oracle, ranks = results
    tag = _tag(case, mesh)
    n = mesh[0] * mesh[1]
    spec = json.loads(str(oracle[f"{tag}|spec"]))
    for r, res in enumerate(ranks):
        st = res[("shards", case, mesh)]
        assert st["bound"] == (r < n) and st["mesh"] == list(mesh)
        if r >= n:
            assert st["stages"][0] is None
            assert all(np.isnan(s["loss"]) and s["shards"] is None for s in st["stages"][1:])
            continue
        assert st["coord"] == [r // mesh[1], r % mesh[1]]
        for key, got in st["stages"][0].items():
            np.testing.assert_array_equal(got, oracle[f"{tag}|0|{key}|{r}"], err_msg=key)
        for stage in (1, 2):
            s = st["stages"][stage]
            want_loss = float(oracle[f"{tag}|{stage}|loss"])
            assert abs(s["loss"] - want_loss) <= TOL * abs(want_loss)
            for k, g in s["grads"].items():
                want = oracle[f"{tag}|{stage}|g.{k}"]
                np.testing.assert_allclose(g, want, atol=1e-5 * np.abs(want).max(), rtol=0,
                                           err_msg=f"{k} step {stage}")
            for kind in ("p.", "mu.", "nu."):
                keys = [k for k in s["shards"] if k.startswith(kind)]
                scale = max(np.abs(oracle[f"{tag}|{stage}|{k}|{r}"]).max() for k in keys)
                for key in keys:
                    want = oracle[f"{tag}|{stage}|{key}|{r}"]
                    carried = _block(_step_tolerance(oracle, tag, stage, key, stage - 1),
                                     spec[key.split(".", 1)[1]], mesh, st["coord"])
                    err = np.abs(s["shards"][key] - want)
                    assert (err <= np.maximum(TOL * scale, carried)).all(), (key, stage,
                                                                            err.max())


@pytest.mark.parametrize("case,mesh", SHARD_CASES, ids=[_tag(c, m) for c, m in SHARD_CASES])
def test_held_bytes(case, mesh, results):
    """A bound rank holds exactly the bytes of JAX's device shards at its
    coordinate: the whole leaves, and of each split leaf the block its
    spec's axes give it (masters and both moments, fp32)."""
    _, oracle, ranks = results
    tag = _tag(case, mesh)
    for r in range(mesh[0] * mesh[1]):
        want = sum(v.nbytes for k, v in oracle.items()
                   if k.startswith(f"{tag}|0|") and k.endswith(f"|{r}"))
        assert ranks[r][("shards", case, mesh)]["held"] == want


@pytest.mark.parametrize("case,mesh", ONE_PROCESS, ids=[_tag(c, m) for c, m in ONE_PROCESS])
def test_gathered_matches_one_process(case, mesh, results, single):
    """A step on the mesh and in one process, from JAX's weights: the
    losses within 1e-6, the gathered masters and moments within 1e-6 of
    each kind's largest |value| or twice the step's gradient tolerance
    carried to them (each run within it of JAX's), on every bound rank."""
    _, oracle, ranks = results
    want = single[case]
    tag = _tag(case, mesh)
    for r in range(mesh[0] * mesh[1]):
        st = ranks[r][("shards", case, mesh)]
        assert abs(st["stages"][1]["loss"] - want["loss"]) <= TOL * abs(want["loss"])
        assert st["full"].keys() == want["full"].keys()
        for kind in ("p.", "mu.", "nu."):
            keys = [k for k in want["full"] if k.startswith(kind)]
            scale = max(np.abs(want["full"][k]).max() for k in keys)
            for k in keys:
                tol = np.maximum(TOL * scale, 2 * _step_tolerance(oracle, tag, 1, k))
                err = np.abs(st["full"][k] - want["full"][k])
                assert (err <= tol).all(), (k, err.max())


@pytest.mark.parametrize("arch,mesh", FAMILY_CASES, ids=[_tag(a, m) for a, m in FAMILY_CASES])
def test_family_positions_loss(arch, mesh, results):
    """qwen2-vl (M-RoPE over three equal streams) and musicgen (the
    sinusoid added to its inputs, then RoPE) on embeddings: each model
    rank's positions start at its block, so the loss on the mesh is JAX's
    under the same mesh within 1e-6, on every bound rank."""
    _, oracle, ranks = results
    want = float(oracle[f"{_tag(arch, mesh)}|loss"])
    for r in range(mesh[0] * mesh[1]):
        assert abs(ranks[r][("family", arch, mesh)] - want) <= TOL * abs(want)


# ---------------------------------------------------------------------- #
# the embedding looked up in its sharded table
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("part", EMBED_PARTS)
@pytest.mark.parametrize("layout", list(EMBED_VOCABS))
def test_sharded_lookup_matches_jax(layout, part, results):
    """On the (2, 2) mesh, with the table held as each rank's shard (a
    vocab-split table, or an e-split one): each rank's rows of its tokens'
    block are JAX's ``embed_tokens`` under the same mesh bit for bit (the
    lookup copies rows, its sums add zeros), decode's whole over "model";
    each rank's gradient of sum(rows * w) is JAX's gradient's block of its
    shard within 1e-6 of the largest |g| (a token's repeats summed in
    another order); the lookup gathers no weight (no rank <= 2
    all-gather)."""
    _, oracle, ranks = results
    want = oracle[f"embed|{layout}|{part}"]
    for res in ranks:
        got = res["embed"][layout]
        d, m = got["coord"]
        assert got["ag2d"] == 0
        if part == "grad":
            blk = _block(want, got["spec"], (2, 2), (d, m))
            np.testing.assert_allclose(got["grad"], blk, rtol=0, atol=1e-6 * np.abs(want).max())
            assert got["grad"].shape != want.shape
        else:
            rows = slice(d * BATCH // 2, (d + 1) * BATCH // 2)
            cols = slice(m * SEQ // 2, (m + 1) * SEQ // 2) if part == "prefill" else slice(None)
            np.testing.assert_array_equal(got[part], want[rows, cols])


# ---------------------------------------------------------------------- #
# the collectives at float64
# ---------------------------------------------------------------------- #
def _group(ranks, n):
    """The world ranks of rank 0's model group of size n, in model order."""
    return [r for r in range(WORLD) if r // n == 0]


@pytest.mark.parametrize("n", sorted(GROUPS))
def test_seq_gather_backward_sums_rank_slices(n, results):
    """``gather_seq`` over a model group of n: each rank gets the blocks in
    rank order, keeps the prefix of r + 1 blocks (attention's K and V), and
    the backward gives each rank the sum, over the ranks whose prefix
    holds its block, of their gradients' slices for it."""
    _, _, ranks = results
    group = _group(ranks, n)
    blocks = [_collective_inputs(n, g)[0] for g in group]
    ws = [_collective_inputs(n, g)[1] for g in group]
    for m, g in enumerate(group):
        got = ranks[g]["collectives"][n]
        assert got["rank"] == m
        np.testing.assert_array_equal(got["full"], np.concatenate(blocks[:m + 1], axis=1))
        want = sum(ws[j][:, 3 * m:3 * m + 3, :5] for j in range(m, n))
        np.testing.assert_allclose(got["gx"], want, rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("n", sorted(GROUPS))
def test_halo_backward_returns_to_previous_rank(n, results):
    """``halo_prev``: rank m gets rank m - 1's last 2 positions (zeros on
    rank 0); the backward hands each rank's tail the gradient of the rank
    after it (nothing on the last rank's), and nothing elsewhere."""
    _, _, ranks = results
    group = _group(ranks, n)
    for m, g in enumerate(group):
        got = ranks[g]["collectives"][n]
        a = _collective_inputs(n, g)[0][:, :, :4]
        prev = np.zeros((2, 2, 4)) if m == 0 else _collective_inputs(n, group[m - 1])[0][:, 1:, :4]
        np.testing.assert_array_equal(got["halo"], prev)
        want = np.zeros_like(a)
        if m + 1 < n:
            want[:, 1:] = _collective_inputs(n, group[m + 1])[1][:, :2, :4]
        np.testing.assert_array_equal(got["gu"], want)


@pytest.mark.parametrize("n", sorted(GROUPS))
def test_all_to_all_backward_sums_rank_slices(n, results):
    """``seq_to_heads`` over a model group of n: rank m gets heads [m H/n,
    (m+1) H/n) of every rank's block, in rank order along the sequence;
    ``heads_to_seq`` is its inverse; the backward of sum(heads * w) gives
    each rank, for its block and each head, the weight of the rank that
    holds that head (and of the round trip's sum of squares, 2 x)."""
    _, _, ranks = results
    group = _group(ranks, n)
    xs = [ranks[g]["collectives"][n]["xh"] for g in group]
    H = xs[0].shape[2]
    for m, g in enumerate(group):
        got = ranks[g]["collectives"][n]
        heads = slice(m * H // n, (m + 1) * H // n)
        np.testing.assert_array_equal(got["heads"], np.concatenate([x[:, :, heads] for x in xs],
                                                                   axis=1))
        np.testing.assert_array_equal(got["back"], xs[m])
        want = 2 * xs[m]
        for j, gj in enumerate(group):
            hj = slice(j * H // n, (j + 1) * H // n)
            want[:, :, hj] += ranks[gj]["collectives"][n]["wh"][:, 3 * m:3 * m + 3]
        np.testing.assert_allclose(got["gh"], want, rtol=1e-15, atol=1e-15)


# ---------------------------------------------------------------------- #
# rebinds and checkpoints at model_axis 2
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", REBINDS)
def test_rebind_keeps_gathered_state(name, results):
    """mamba2 at ``model_axis=2``: grow 2 -> 4 ((1, 2) -> (2, 2)), shrink
    4 -> 2 and an ejection whose replacement binds 4: every gathered master
    and moment is bit for bit what it was before the rebind, on every rank
    bound after it, and the next step's loss is finite."""
    _, _, ranks = results
    want_bound = {"grow 2": (2, 4), "shrink 2": (4, 2), "eject and replace": (2, 4)}[name]
    for r, res in enumerate(ranks):
        st = res[("rebind", name)]
        assert st["ok"] and st["bound"] == want_bound
        assert st["mesh"] == [want_bound[1] // 2, 2]
        if r >= want_bound[1]:
            assert st["after"] is None and np.isnan(st["loss"])
            continue
        assert np.isfinite(st["loss"])
        before = ranks[0][("rebind", name)]["before"]
        assert st["after"].keys() == before.keys()
        for k, v in before.items():
            np.testing.assert_array_equal(st["after"][k], v, err_msg=k)


def test_checkpoint_from_2x2_restores_on_1x2(results):
    """llama at ``model_axis=2``: a checkpoint written from a (2, 2) mesh
    (rank 0, every leaf gathered over both axes) restores on (1, 2)
    through ``shardings=``: the shards gather to the saved state bit for
    bit and the next step is finite."""
    _, _, ranks = results
    saved = ranks[0]["saved"]
    for r, res in enumerate(ranks):
        st = res["restore"]
        assert st["bound"] == (r < 2)
        if r >= 2:
            assert st["full"] is None and np.isnan(st["loss"])
            continue
        assert st["step"] == 1 and st["opt_step"] == 1 and st["mesh"] == [1, 2]
        assert np.isfinite(st["loss"])
        assert st["full"].keys() == saved.keys()
        for k, v in saved.items():
            np.testing.assert_array_equal(st["full"][k], v, err_msg=k)
