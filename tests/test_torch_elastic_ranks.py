"""The port's elastic runtime across the ranks of a gloo world of 4
(``repro_torch.runtime.elastic``): ``ElasticRuntime`` on reduced
llama3.2-3b with the smoke shape (seq 32, global batch 8) binds 2 ranks,
grows to 4, shrinks to 2, and ejects a node and replaces it; at each stage
the losses and parameters equal the one-process port's run on the same
batches within 1e-6 of the largest |p|. At 4 ranks one step equals JAX's
``train_step`` under a (4, 1) mesh with Auto axes (a subprocess with 4
host devices) on JAX's weights, and a checkpoint saved on 4 ranks restores
onto 2 through ``shardings=``. The state has JAX's Zero-3 layout, so
the parameters compared are the bound ranks' shards gathered whole. Rebinding again and again reuses the meshes: the world's count of
process groups stays put. Reduced qwen3-moe on the capacity dispatch at
capacity factor 1.0, where pairs drop, steps on 2 ranks as JAX's
``train_step`` under a (2, 1) mesh (the capacity and the pairs' ranks of
the global batch) and as the one-process port, with ``grad_accum`` 1 and
2. The twin of tests/test_perf_flags.py's
``test_ssm_seq_sharded_matches_baseline`` (slow there): reduced mamba2's
loss over a (2, 1) mesh is the same with ``ssm_seq_sharded`` on and off,
and equals JAX's under its (2, 2) mesh."""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from torch_dist_harness import run_jax_oracle, run_world

ARCH = "llama3.2-3b"
SEQ, BATCH = 32, 8
STAGES = ("allocate 2", "grow 2", "shrink 2", "eject and replace")
BOUND = (2, 4, 2, 4)           # the ejected node held 4 chips: 4 replace them
TOL = 1e-6
SSM_BATCH = (4, 32)
MOE_ARCH = "qwen3-moe-30b-a3b"
ACCUM = (1, 2)
CYCLES = 3

ORACLE = f"""
import dataclasses
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


cfg = get_config({ARCH!r}).reduced()
opt = OptConfig(kind=cfg.optimizer, warmup=5, total_steps=10)
mesh = auto_mesh((4, 1), ("data", "model"))
model = make_model(cfg, ShardingCtx(Rules(), mesh), opt)
tokens = np.load(sys.argv[1])
batch = {{"tokens": jnp.asarray(tokens["tokens"]), "labels": jnp.asarray(tokens["labels"])}}
with mesh:
    psh, osh = model.param_shardings(), model.opt_shardings()
    params = jax.device_put(model.init_params(jax.random.key(0)), psh)
    opt_state = jax.device_put(model.init_opt(params), osh)
    batch = jax.device_put(batch, model.input_shardings(ShapeConfig("t", {SEQ}, {BATCH}, "train")))
    grads = jax.jit(jax.grad(lambda p: loss_fn(p, cfg, model.ctx, batch)))(params)
    save(**{{"g." + k: v for k, v in flat(grads).items()}})
    params, opt_state, metrics = jax.jit(model.train_step, out_shardings=(psh, osh, None))(
        params, opt_state, batch)
save(loss=metrics["loss"], **{{"p." + k: v for k, v in flat(params).items()}})

cfg = dataclasses.replace(get_config({MOE_ARCH!r}).reduced(), moe_impl="dispatch",
                          capacity_factor=1.0)
opt = OptConfig(kind=cfg.optimizer, warmup=5, total_steps=10)
mesh = jax.make_mesh((2, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:2])
model = make_model(cfg, ShardingCtx(Rules(), mesh), opt)
batch = {{"tokens": jnp.asarray(tokens["moe_tokens"]), "labels": jnp.asarray(tokens["moe_labels"])}}
with mesh:
    psh, osh = model.param_shardings(), model.opt_shardings()
    params = jax.device_put(model.init_params(jax.random.key(0)), psh)
    opt_state = jax.device_put(model.init_opt(params), osh)
    batch = jax.device_put(batch, model.input_shardings(ShapeConfig("t", {SEQ}, {BATCH}, "train")))
    grads = jax.jit(jax.grad(lambda p: loss_fn(p, cfg, model.ctx, batch)))(params)
    save(**{{"mg." + k: v for k, v in flat(grads).items()}})
    params, opt_state, metrics = jax.jit(model.train_step, out_shardings=(psh, osh, None))(
        params, opt_state, batch)
save(moe_loss=metrics["loss"], **{{"mp." + k: v for k, v in flat(params).items()}})

base = dataclasses.replace(get_config("mamba2-2.7b").reduced(), vocab=64, ssm_chunk=8)
mesh = auto_mesh((2, 2), ("data", "model"))
ctx = ShardingCtx(Rules(), mesh)
bt = {{"tokens": jnp.ones({SSM_BATCH}, jnp.int32), "labels": jnp.ones({SSM_BATCH}, jnp.int32)}}
params = make_model(base, ctx).init_params(jax.random.key(0))
for flag in (False, True):
    c = dataclasses.replace(base, ssm_seq_sharded=flag)
    with mesh:
        save(**{{f"ssm_loss_{{int(flag)}}": jax.jit(lambda p: loss_fn(p, c, ctx, bt))(params)}})
"""


def _llama_cfg():
    from repro_torch.configs import get_config
    return get_config(ARCH).reduced()


def _moe_cfg(accum=1):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH).reduced(), moe_impl="dispatch",
                               capacity_factor=1.0, grad_accum=accum)


def _runtime(cfg, shape):
    from repro_torch.core.graph import build_tpu_fleet
    from repro_torch.core.scheduler import SchedulerInstance
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.elastic import ElasticRuntime
    fleet = build_tpu_fleet(pods=1, racks_per_pod=1, nodes_per_rack=4, chips_per_node=4,
                            device="cpu")
    return ElasticRuntime(SchedulerInstance("top", fleet), cfg, shape, chip_type="chip",
                          opt=OptConfig(kind=cfg.optimizer, warmup=5, total_steps=10),
                          device="cpu")


def _eject_first_node(rt):
    g = rt.scheduler.graph
    chip = next(p for p in rt.scheduler.allocations[rt.jobid].paths
                if p in g and g.vertex(p).type == "chip")
    return rt.eject_and_replace(next(a for a in g.ancestors(chip)
                                     if g.vertex(a).type == "node"))


def _elastic_stages(rt, batches):
    """Allocate 2, grow 2, shrink 2, eject and replace, with a step after
    each: per stage, (ok, bound ranks, this rank bound, loss, params)."""
    import torch
    actions = (lambda: rt.allocate(2) and rt.bind(torch.Generator().manual_seed(0)) is None,
               lambda: rt.grow(2), lambda: rt.shrink(2), lambda: _eject_first_node(rt))
    out = []
    for act, batch in zip(actions, batches):
        ok = act()
        loss = float(rt.step(batch)["loss"])
        out.append(dict(ok=ok, bound=len(rt.mesh), me=rt.bound, loss=loss,
                        params=_gathered(rt)))
    return out


def _gathered(rt):
    """The masters gathered whole (every bound rank calls it), None on a
    rank that is not bound."""
    if rt.model is None:
        return None
    return {k: v.numpy().copy() for k, v in rt.model.full_params().items()}


def _load(rt, state):
    import torch
    if rt.model is not None:
        rt.model.load_params({k: torch.from_numpy(v) for k, v in state.items()})
        rt.opt_state = rt.model.init_opt()


def _captured_step(rt, batch):
    """One step: the bound ranks, the loss, the mean gradient the
    optimizer is given and the parameters after it, gathered whole."""
    grads, reduce = {}, rt._mean_over_data

    def capture(loss, g):
        loss, g = reduce(loss, g)
        psh = rt.model.param_shardings()
        grads.update({k: rt.model.gather(v, psh[k]).numpy().copy() for k, v in g.items()})
        return loss, g
    rt._mean_over_data = capture
    loss = float(rt.step(batch)["loss"])
    return dict(bound=len(rt.mesh), loss=loss, grads=grads, params=_gathered(rt))


def _group_count():
    import torch.distributed.distributed_c10d as c10d
    return len(c10d._world.pg_map)


def _port_world(rank, world, inputs, ckpt_dir):
    import torch
    import torch.distributed as dist
    from repro_torch.models.config import ShapeConfig
    from repro_torch.runtime.checkpoint import CheckpointManager
    cfg = _llama_cfg()
    shape = ShapeConfig("smoke_train", SEQ, BATCH, "train")
    rt = _runtime(cfg, shape)
    out = {"stages": _elastic_stages(rt, inputs["batches"])}
    # the stages built the meshes of 2 and 4; more resizes build none
    groups = _group_count()
    for _ in range(CYCLES):
        rt.shrink(2)
        rt.grow(2)
    out["groups"] = dict(before=groups, after=_group_count(), bound=len(rt.mesh),
                         rebinds=sum(e.kind == "rebind" for e in rt.events))

    # one step at 4 ranks on JAX's weights; rank 0 checkpoints it
    rt = _runtime(cfg, shape)
    rt.allocate(4)
    rt.bind()
    _load(rt, inputs["jax_params"])
    out["jax_step"] = _captured_step(rt, inputs["jax_batch"])
    state = rt.full_state()
    if rank == 0:
        CheckpointManager(ckpt_dir).save(1, state)
    dist.barrier()
    # the 2 bound ranks of a new runtime restore their shards and step once
    rt2 = _runtime(cfg, shape)
    rt2.allocate(2)
    rt2.bind()
    step = opt_step = restored = None
    if rt2.bound:
        step, state = CheckpointManager(ckpt_dir).restore(
            {"params": rt2.params, "opt_state": rt2.opt_state},
            shardings={"params": rt2.model.param_shardings(),
                       "opt_state": rt2.model.opt_shardings()})
        rt2.params, rt2.opt_state = state["params"], state["opt_state"]
    restored = _gathered(rt2)
    loss = float(rt2.step(inputs["batches"][0])["loss"])
    if rt2.bound:
        opt_step = rt2.opt_state.step
    out["restore"] = dict(step=step, bound=len(rt2.mesh), opt_step=opt_step,
                          restored=restored, loss=loss, params=_gathered(rt2))

    # reduced qwen3-moe's dispatch at 2 ranks on JAX's weights
    for accum in ACCUM:
        rt = _runtime(_moe_cfg(accum), shape)
        rt.allocate(2)
        rt.bind()
        _load(rt, inputs["moe_params"])
        out[f"moe_{accum}"] = _captured_step(rt, inputs["moe_batch"])

    # reduced mamba2 over a (2, 1) mesh, ssm_seq_sharded off and on
    base = dataclasses.replace(_mamba_base(), ssm_seq_sharded=False)
    ones = np.ones(SSM_BATCH, np.int64)
    for flag in (False, True):
        rt = _runtime(dataclasses.replace(base, ssm_seq_sharded=flag),
                      ShapeConfig("t", SSM_BATCH[1], SSM_BATCH[0], "train"))
        rt.allocate(2)
        rt.bind()
        _load(rt, inputs["mamba_params"])
        out[f"ssm_{int(flag)}"] = dict(bound=len(rt.mesh), mesh=tuple(rt.device_mesh.shape),
                                       loss=float(rt.step({"tokens": ones, "labels": ones})["loss"]))
    return out


def _mamba_base():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("mamba2-2.7b").reduced(), vocab=64, ssm_chunk=8)


def _jax_params(arch_cfg, seed=0):
    import jax
    from repro.models.model import make_model
    from repro_torch.convert import params_from_jax
    tree = jax.device_get(make_model(arch_cfg).init_params(jax.random.key(seed)))
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro.configs.registry import get_config as jax_get_config
    tmp = tmp_path_factory.mktemp("elastic")
    rng = np.random.default_rng(0)
    vocab = _llama_cfg().vocab
    batches = [{"tokens": rng.integers(0, vocab, (BATCH, SEQ)),
                "labels": rng.integers(0, vocab, (BATCH, SEQ))} for _ in STAGES]
    jax_batch = {"tokens": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32),
                 "labels": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)}
    mvocab = _moe_cfg().vocab
    moe_batch = {"tokens": rng.integers(0, mvocab, (BATCH, SEQ)).astype(np.int32),
                 "labels": rng.integers(0, mvocab, (BATCH, SEQ)).astype(np.int32)}
    np.savez(tmp / "batch.npz", **jax_batch, **{"moe_" + k: v for k, v in moe_batch.items()})
    jmamba = dataclasses.replace(jax_get_config("mamba2-2.7b").reduced(), vocab=64, ssm_chunk=8)
    inputs = dict(batches=batches, jax_batch=jax_batch, moe_batch=moe_batch,
                  jax_params=_jax_params(jax_get_config(ARCH).reduced()),
                  moe_params=_jax_params(jax_get_config(MOE_ARCH).reduced()),
                  mamba_params=_jax_params(jmamba))
    code = ORACLE.replace("np.load(sys.argv[1])", f"np.load({str(tmp / 'batch.npz')!r})")
    with ThreadPoolExecutor(1) as pool:
        oracle = pool.submit(run_jax_oracle, code, tmp)
        ranks = run_world(_port_world, 4, tmp, args=(inputs, str(tmp / "ckpt")))
        oracle = oracle.result()
    inputs["ckpt"] = str(tmp / "ckpt")
    return inputs, oracle, ranks


@pytest.fixture(scope="module")
def single(results):
    """The same stages and steps in one process, no process group."""
    from repro_torch.models.config import ShapeConfig
    rt = _runtime(_llama_cfg(), ShapeConfig("smoke_train", SEQ, BATCH, "train"))
    return _elastic_stages(rt, results[0]["batches"])


@pytest.fixture(scope="module")
def moe_single(results):
    """The MoE steps in one process, no process group, by grad_accum."""
    from repro_torch.models.config import ShapeConfig
    out = {}
    for accum in ACCUM:
        rt = _runtime(_moe_cfg(accum), ShapeConfig("smoke_train", SEQ, BATCH, "train"))
        rt.allocate(1)
        rt.bind()
        _load(rt, results[0]["moe_params"])
        out[accum] = _captured_step(rt, results[0]["moe_batch"])
    return out


def _close_params(got, want):
    scale = max(np.abs(v).max() for v in want.values())
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL * scale, rtol=0, err_msg=k)


@pytest.mark.parametrize("i", range(len(STAGES)), ids=STAGES)
def test_stage_matches_one_process(i, results, single):
    """Each stage binds its ranks, the ranks outside skip the step, and the
    bound ranks' loss and parameters equal the one-process run's."""
    _, _, ranks = results
    single = single[i]
    n = BOUND[i]
    for r, res in enumerate(ranks):
        st = res["stages"][i]
        assert st["ok"] and st["bound"] == n and st["me"] == (r < n)
        if r >= n:
            assert np.isnan(st["loss"])
            continue
        assert abs(st["loss"] - single["loss"]) <= TOL * abs(single["loss"])
        _close_params(st["params"], single["params"])
        for k, v in st["params"].items():           # gathered: equal on every bound rank
            np.testing.assert_array_equal(v, ranks[0]["stages"][i]["params"][k])


def _assert_step_matches_jax(st, oracle, loss_key, p_prefix, g_prefix):
    """A rank's captured step against JAX's under its mesh: the loss within
    1e-6; the mean gradient the ranks' all-reduce gives the optimizer
    within 1e-5 of each leaf's largest |g| of JAX's gradient under that
    mesh; the parameters within 1e-6 of the largest |p|, or, where more,
    within that gradient tolerance carried through AdamW's first step. That
    step moves an element by lr g s / sqrt((g s)^2 + eps^2) (s the clip
    scale), whose slope in g is lr s eps^2 / ((g s)^2 + eps^2)^1.5: where
    |g| is near eps (1e-8) a rounding of g moves the parameter by a share
    of lr."""
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.optim.schedule import warmup_cosine
    import torch
    want = {k[len(p_prefix):]: v for k, v in oracle.items() if k.startswith(p_prefix)}
    jgrad = {k[len(g_prefix):]: v for k, v in oracle.items() if k.startswith(g_prefix)}
    opt = OptConfig(kind="adamw", warmup=5, total_steps=10)
    lr = float(warmup_cosine(torch.tensor(1.0), opt.lr, opt.warmup, opt.total_steps))
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in jgrad.values()))
    s = min(1.0, opt.clip_norm / max(norm, 1e-9))
    scale = max(np.abs(v).max() for v in want.values())
    assert abs(st["loss"] - float(oracle[loss_key])) <= TOL * abs(float(oracle[loss_key]))
    assert st["grads"].keys() == jgrad.keys()
    for k, g in jgrad.items():
        delta = 1e-5 * np.abs(g).max()
        np.testing.assert_allclose(st["grads"][k], g, atol=delta, rtol=0, err_msg=k)
        carried = lr * s * delta * opt.eps ** 2 / ((g * s) ** 2 + opt.eps ** 2) ** 1.5
        err = np.abs(st["params"][k] - want[k])
        assert (err <= np.maximum(TOL * scale, carried)).all(), k


def test_step_at_four_matches_jax_mesh(results):
    """One step at 4 bound ranks on JAX's weights against JAX's
    ``train_step`` under a (4, 1) mesh (``_assert_step_matches_jax``)."""
    _, oracle, ranks = results
    for res in ranks:
        assert res["jax_step"]["bound"] == 4
        _assert_step_matches_jax(res["jax_step"], oracle, "loss", "p.", "g.")


def test_rebinds_reuse_meshes(results):
    """Resizing again and again between 2 and 4 ranks builds no new mesh:
    the world's count of process groups is the same after the cycles."""
    _, _, ranks = results
    for res in ranks:
        g = res["groups"]
        assert g["bound"] == 4 and g["rebinds"] == len(STAGES) + 2 * CYCLES
        assert g["after"] == g["before"]


def test_moe_dispatch_at_two_matches_jax_mesh(results):
    """Reduced qwen3-moe on the capacity dispatch at capacity factor 1.0,
    one step on 2 bound ranks against JAX's ``train_step`` under a (2, 1)
    mesh, where GSPMD keeps the dispatch's global meaning: the capacity of
    the global T and the pairs ranked over every rank's tokens."""
    _, oracle, ranks = results
    for res in ranks[:2]:
        assert res["moe_1"]["bound"] == 2
        _assert_step_matches_jax(res["moe_1"], oracle, "moe_loss", "mp.", "mg.")


@pytest.mark.parametrize("accum", ACCUM)
def test_moe_dispatch_at_two_matches_one_process(accum, results, moe_single):
    """The same MoE step on 2 ranks and in one process: the loss and the
    parameters within 1e-6, with ``grad_accum`` 1 and 2 (each rank's rows
    of each global microbatch)."""
    _, _, ranks = results
    single = moe_single[accum]
    for r, res in enumerate(ranks):
        st = res[f"moe_{accum}"]
        assert st["bound"] == 2
        if r >= 2:
            assert np.isnan(st["loss"])
            continue
        assert abs(st["loss"] - single["loss"]) <= TOL * abs(single["loss"])
        _close_params(st["params"], single["params"])


def test_checkpoint_from_four_restores_onto_two(results):
    """Rank 0's checkpoint of the 4-rank step (the leaves gathered whole)
    restores through ``shardings=`` onto the 2 bound ranks of a new binding
    bit for bit, and the next step there equals the same step in one
    process from the same checkpoint; the ranks outside hold no state."""
    from repro_torch.models.config import ShapeConfig
    from repro_torch.runtime.checkpoint import CheckpointManager
    inputs, _, ranks = results
    for r, res in enumerate(ranks):
        st = res["restore"]
        assert st["bound"] == 2
        if r >= 2:
            assert st["step"] is None and st["restored"] is None and st["params"] is None
            continue
        assert st["step"] == 1 and st["opt_step"] == 2
        for k, v in st["restored"].items():
            np.testing.assert_array_equal(v, ranks[0]["jax_step"]["params"][k])
    rt = _runtime(_llama_cfg(), ShapeConfig("smoke_train", SEQ, BATCH, "train"))
    rt.allocate(1)
    rt.bind()
    _, state = CheckpointManager(inputs["ckpt"]).restore(
        {"params": rt.params, "opt_state": rt.opt_state})
    rt.model.load_params(state["params"])
    rt.opt_state = state["opt_state"]
    loss = float(rt.step(inputs["batches"][0])["loss"])
    single = {k: v.numpy() for k, v in rt.params.items()}
    for r in range(2):
        st = ranks[r]["restore"]
        assert abs(st["loss"] - loss) <= TOL * abs(loss)
        _close_params(st["params"], single)


def test_ssm_seq_sharded_matches_baseline(results):
    """The twin of the JAX test: over a (2, 1) mesh the loss is the same
    with ``ssm_seq_sharded`` on and off (rtol 1e-5, as JAX's test), and
    equals JAX's under its (2, 2) mesh. The port's ranks hold whole
    sequences on a (2, 1) mesh, where the flag changes nothing of its
    program, so the on/off comparison holds the port to itself; the
    comparison with JAX, where the flag changes the program, carries the
    weight (the two forms on the port's (2, 2) mesh:
    tests/test_torch_model_axis.py)."""
    _, oracle, ranks = results
    for res in ranks[:2]:
        off, on = res["ssm_0"], res["ssm_1"]
        assert off["bound"] == on["bound"] == 2 and off["mesh"] == (2, 1)
        np.testing.assert_allclose(on["loss"], off["loss"], rtol=1e-5)
        for flag in (0, 1):
            np.testing.assert_allclose(res[f"ssm_{flag}"]["loss"], oracle[f"ssm_loss_{flag}"],
                                       rtol=1e-5)
