"""The port's sharding rules (``repro_torch.parallel.sharding``) against
``repro.parallel.sharding``: ``Rules.spec`` for every logical tuple the
JAX models pass (their parameters' axes and the constraints in their
source) and for random tuples, ``override``, and ``ShardingCtx.spec`` and
``divisible`` on ("data", "model") meshes of 4 ranks and a ("pod",
"data", "model") mesh of 8, the port's a gloo world, JAX's from a
subprocess with host devices."""
import ast
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.configs.registry import ARCH_IDS, get_config as jax_get_config
from repro.models.layers import ParamSpec as JaxParamSpec
from repro.models.transformer import init_specs as jax_init_specs
from repro.parallel.sharding import DEFAULT_RULES as JAX_DEFAULT_RULES, Rules as JaxRules
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import DEFAULT_RULES, PartitionSpec, Rules, ShardingCtx
from torch_dist_harness import ROOT, run_jax_oracle, run_world

CALLS = ("constrain", "spec")


def _source_tuples() -> set:
    """The logical tuples of the constraint and spec calls in
    ``src/repro/models`` (string and None arguments after the tensor and
    the context)."""
    out = set()
    for path in sorted((ROOT / "src" / "repro" / "models").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call):
                continue
            name = getattr(node.func, "attr", getattr(node.func, "id", None))
            args = node.args[2:] if name == "constrain" else node.args
            if name not in CALLS and name != "P_" or not args:
                continue
            if all(isinstance(a, ast.Constant) and (a.value is None or isinstance(a.value, str))
                   for a in args):
                out.add(tuple(a.value for a in args))
    return out


def _param_tuples() -> set:
    out = set()

    def walk(tree):
        for v in tree.values():
            if isinstance(v, JaxParamSpec):
                out.add(tuple(v.axes))
            else:
                walk(v)
    for arch in ARCH_IDS:
        walk(jax_init_specs(jax_get_config(arch)))
    return out


MODEL_TUPLES = sorted(_source_tuples() | _param_tuples(), key=repr)
NAMES = sorted(DEFAULT_RULES)
OVERRIDES = [{}, {"seq": None}, {"batch": "data", "fsdp": None},
             {"expert": ("model", "data"), "vocab": None},
             {"embed": "model", "kv_seq": ("pod", "model")}]


def test_default_rules_are_jax_rules():
    assert DEFAULT_RULES == JAX_DEFAULT_RULES
    assert len(MODEL_TUPLES) >= 20


@pytest.mark.parametrize("logical", MODEL_TUPLES, ids=repr)
def test_spec_matches_jax_on_model_tuples(logical):
    got, want = Rules().spec(*logical), JaxRules().spec(*logical)
    assert isinstance(got, PartitionSpec) and isinstance(got, tuple)
    assert tuple(got) == tuple(want)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.one_of(st.none(), st.sampled_from(NAMES + ["unknown"])), max_size=6),
       st.integers(0, len(OVERRIDES) - 1))
def test_spec_matches_jax_on_random_tuples(logical, which):
    kv = OVERRIDES[which]
    assert tuple(Rules().override(**kv).spec(*logical)) == \
        tuple(JaxRules().override(**kv).spec(*logical))


@pytest.mark.parametrize("kv", OVERRIDES, ids=lambda kv: ",".join(kv) or "none")
def test_override_matches_jax(kv):
    got, want = Rules().override(**kv), JaxRules().override(**kv)
    assert got.table == want.table
    assert Rules().table == DEFAULT_RULES          # the base is not changed


def test_ctx_without_mesh_is_rules_spec():
    ctx = ShardingCtx()
    for logical in MODEL_TUPLES:
        assert ctx.spec(*logical) == Rules().spec(*logical)
    assert ctx.placements("batch") is None
    x = object()
    assert sharding.constrain(x, ctx, "batch") is x


MESHES = {"dm22": ((2, 2), ("data", "model")), "dm41": ((4, 1), ("data", "model")),
          "dm14": ((1, 4), ("data", "model")), "pdm222": ((2, 2, 2), ("pod", "data", "model"))}
DIV_N = (1, 2, 3, 4, 6, 8, 12)
DIV_PHYS = (None, "data", "model", "pod", ("pod", "data"), ("data", "model"),
            ("pod", "data", "model"))

ORACLE = f"""
import json
from repro.parallel.sharding import Rules, ShardingCtx, divisible
tuples = json.loads({json.dumps(json.dumps([list(t) for t in MODEL_TUPLES]))})
meshes = json.loads({json.dumps(json.dumps(MESHES))})
phys = json.loads({json.dumps(json.dumps(DIV_PHYS))})
for name, (shape, axes) in meshes.items():
    n = int(np.prod(shape))
    mesh = jax.make_mesh(tuple(shape), tuple(axes), devices=jax.devices()[:n],
                         axis_types=(AxisType.Auto,) * len(shape))
    ctx = ShardingCtx(Rules(), mesh)
    specs = [repr(tuple(ctx.spec(*t))) for t in tuples]
    div = [[divisible(k, mesh, tuple(p) if isinstance(p, list) else p) for p in phys]
           for k in {list(DIV_N)}]
    save(**{{"spec_" + name: np.array(specs), "div_" + name: np.array(div)}})
"""


def _port_meshes(rank, world, tuples, meshes, phys):
    """Every mesh of ``meshes`` built on all ranks (a subset mesh of 4
    ranks on a world of 8); rank 0 returns each one's specs, divisibility,
    placements of a few spec, and a DTensor redistributed by ``constrain``."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    out = {}
    for name, (shape, axes) in meshes.items():
        n = int(np.prod(shape))
        mesh = DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))
        if mesh.get_coordinate() is None:
            continue
        ctx = ShardingCtx(Rules(), mesh)
        specs = [repr(tuple(ctx.spec(*t))) for t in tuples]
        div = [[sharding.divisible(k, mesh, tuple(p) if isinstance(p, list) else p)
                for p in phys] for k in DIV_N]
        place = {t: [repr(p) for p in ctx.placements(*t)]
                 for t in (("batch", "seq", "embed"), ("expert", "fsdp", None), (None,))}
        both = [repr(q) for q in ctx.override(expert=("data", "model")).placements("expert")]
        try:
            ctx.override(expert=("model", "data")).placements("expert")
            reversed_raises = False
        except NotImplementedError:
            reversed_raises = True
        x = torch.arange(8 * 8, dtype=torch.float32).reshape(8, 8)
        dt = distribute_tensor(x, mesh, [Replicate()] * len(shape))
        moved = sharding.constrain(dt, ctx, "batch", "seq")
        plain = sharding.constrain(x, ctx, "batch", "seq")
        out[name] = dict(specs=specs, div=div, place=place,
                         placements=[repr(p) for p in moved.placements],
                         want=[repr(p) for p in ctx.placements("batch", "seq")],
                         full=bool(torch.equal(moved.full_tensor(), x)),
                         plain_same=plain is x, shard=Shard(0) in ctx.placements("batch"),
                         both=both, reversed_raises=reversed_raises)
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """JAX's subprocess and the gloo world of 8, side by side."""
    with ThreadPoolExecutor(1) as pool:
        oracle = pool.submit(run_jax_oracle, ORACLE, tmp_path_factory.mktemp("sharding"),
                             devices=8)
        port = run_world(_port_meshes, 8, tmp_path_factory.mktemp("world"),
                         args=(MODEL_TUPLES, MESHES, DIV_PHYS))[0]
        return oracle.result(), port


@pytest.fixture(scope="module")
def oracle(both):
    return both[0]


@pytest.fixture(scope="module")
def port(both):
    return both[1]


@pytest.mark.parametrize("name", list(MESHES))
def test_ctx_spec_matches_jax_on_meshes(name, oracle, port):
    assert port[name]["specs"] == list(oracle["spec_" + name])


@pytest.mark.parametrize("name", list(MESHES))
def test_divisible_matches_jax_on_meshes(name, oracle, port):
    np.testing.assert_array_equal(np.array(port[name]["div"]), oracle["div_" + name])


@pytest.mark.parametrize("name", list(MESHES))
def test_placements_and_constrain(name, port):
    """A spec's placements name the array dimension for each mesh
    dimension it shards, and ``constrain`` redistributes a DTensor to them
    (its values unchanged) and leaves a plain tensor alone."""
    r = port[name]
    assert r["placements"] == r["want"] and r["full"] and r["plain_same"] and r["shard"]
    axes = MESHES[name][1]
    want = ["Shard(dim=0)" if a in ("pod", "data") else
            "Shard(dim=1)" if a == "model" else "Replicate()" for a in axes]
    assert r["place"][("batch", "seq", "embed")] == want
    assert r["place"][(None,)] == ["Replicate()"] * len(axes)


@pytest.mark.parametrize("name", list(MESHES))
def test_placements_split_in_mesh_order(name, port):
    """A dimension split over "data" then "model" takes ``Shard`` on both
    mesh dimensions; the reverse order, which JAX splits in the spec's
    order and DTensor in the mesh's, raises."""
    r = port[name]
    axes = MESHES[name][1]
    assert r["both"] == ["Shard(dim=0)" if a in ("data", "model") else "Replicate()"
                         for a in axes]
    assert r["reversed_raises"]
