"""The port's ``moe_a2a`` over several model shards against JAX's
``moe_a2a`` under a ("data", "model") mesh with Auto axes (from a
subprocess with 4 host devices): the twins of tests/test_perf_flags.py's
``test_moe_a2a_matches_dense_oracle`` and ``test_moe_a2a_grad_flows_sharded``
(slow there), on that test's config (8 experts, top 2, fp32, a shared
expert). The port's ranks are a gloo world of 4 as a (2, 2) mesh, at
capacity factors 16, 1.0 and 1.25, with and without ``moe_ep2d``, and as a
(1, 4) mesh at 1.0. y is held within 2e-5 of max(1, largest |y|) and every
gradient leaf of sum(y^2) within 1e-5 of its largest |g|: the expert
leaves shard by shard (summed over the data ranks that hold the same
experts; under ``moe_ep2d`` each rank's f slice alone), the router, norm
and shared expert summed over the ranks. The loopback exchange (all
shards in one process) equals the gloo world bit for bit at n_sh 2 and 4.
Where E % n_sh is nonzero JAX falls back to its GSPMD-partitioned
``moe_dispatch``; the port's ranks, each holding every expert, run the
dispatch over the mesh's tokens, held against JAX's at (1, 4) with 6
experts and (2, 2) with 3."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from torch_dist_harness import run_jax_oracle, run_world

BASE = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=1,
            d_ff=64, vocab=64, n_experts=8, top_k=2, moe_d_ff=16, moe_shared=1,
            dtype="float32", moe_impl="a2a")
# tag: (mesh (data, model), capacity factor, moe_ep2d)
CASES = {"cf16": ((2, 2), 16.0, False), "cf1": ((2, 2), 1.0, False),
         "cf125": ((2, 2), 1.25, False), "cf16_ep2d": ((2, 2), 16.0, True),
         "cf1_ep2d": ((2, 2), 1.0, True), "cf125_ep2d": ((2, 2), 1.25, True),
         "cf1_m4": ((1, 4), 1.0, False)}
# where JAX falls back to the dispatch: tag: (mesh, experts)
FALLBACK = {"odd_m4": ((1, 4), 6), "odd_22": ((2, 2), 3)}
LEAVES = ("norm", "router", "shared_down", "shared_gate", "shared_up", "w_down", "w_gate",
          "w_up")
EXPERT = ("w_down", "w_gate", "w_up")
Y_TOL, G_TOL = 2e-5, 1e-5

ORACLE = f"""
import dataclasses
import jax.numpy as jnp
from repro.models.config import ArchConfig
from repro.models.layers import materialize_tree
from repro.models.moe import moe_a2a, moe_dense, moe_specs
from repro.parallel.sharding import Rules, ShardingCtx
base = ArchConfig(**{BASE!r})
p = materialize_tree(moe_specs(base), jax.random.key(0))
x = jax.random.normal(jax.random.key(1), (4, 16, base.d_model))


def loss(p, cfg, ctx):
    y = moe_a2a(x, p, cfg, ctx)
    return jnp.sum(y ** 2), y


for tag, (shape, cf, ep2d) in {CASES!r}.items():
    cfg = dataclasses.replace(base, capacity_factor=cf, moe_ep2d=ep2d)
    mesh = auto_mesh(tuple(shape), ("data", "model"))
    ctx = ShardingCtx(Rules(), mesh)
    with mesh:
        (_, y), g = jax.jit(jax.value_and_grad(lambda p: loss(p, cfg, ctx), has_aux=True))(p)
    save(**{{f"y_{{tag}}": y}}, **{{f"g_{{tag}}_{{k}}": v for k, v in g.items()}})
for tag, (shape, E) in {FALLBACK!r}.items():
    cfg = dataclasses.replace(base, n_experts=E, capacity_factor=1.0)
    po = materialize_tree(moe_specs(cfg), jax.random.key(2))
    mesh = auto_mesh(tuple(shape), ("data", "model"))
    ctx = ShardingCtx(Rules(), mesh)
    with mesh:
        (_, y), g = jax.jit(jax.value_and_grad(lambda p: loss(p, cfg, ctx), has_aux=True))(po)
    save(**{{f"y_{{tag}}": y}}, **{{f"g_{{tag}}_{{k}}": v for k, v in g.items()}},
         **{{f"p_{{tag}}_{{k}}": v for k, v in po.items()}})
cfg = dataclasses.replace(base, capacity_factor=16.0)
save(x=x)
save(y_dense=moe_dense(x, p, cfg, ShardingCtx()),
     **{{f"g_dense_{{k}}": v for k, v in
        jax.grad(lambda p: jnp.sum(moe_dense(x, p, cfg, ShardingCtx()) ** 2))(p).items()}})
"""


def _shard_run(x, p, cfg, coords):
    """Leaves of shard ``coords`` ((m, n_sh), (d, D)) that require grad."""
    from repro_torch.models import moe
    xl = moe.moe_shard_input(x, cfg, *coords).clone().requires_grad_()
    leaves = {k: v.clone().requires_grad_()
              for k, v in moe.moe_shard_params(p, cfg, *coords).items()}
    return xl, leaves


def _grads(xl, leaves):
    return {"x": xl.grad.numpy(), **{k: leaves[k].grad.numpy() for k in LEAVES}}


def _port_a2a(rank, world, arrays, fallback):
    """Every case on its mesh of the gloo world; rank 0 also runs the
    loopback exchange over data slice 0's shards of each case without
    ``moe_ep2d``; then the fallback cases, every rank holding every expert
    of JAX's weights ``fallback``."""
    import dataclasses
    import torch
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import moe
    from repro_torch.models.config import ArchConfig
    from repro_torch.parallel.sharding import Rules, ShardingCtx
    x = torch.from_numpy(arrays["x"])
    p = {k[2:]: torch.from_numpy(v) for k, v in arrays.items() if k.startswith("p_")}
    base = ArchConfig(**BASE)
    meshes = {shape: make_mesh_for(4, shape[1])
              for shape in sorted({c[0] for c in CASES.values()})}
    out = {}
    for tag, (shape, cf, ep2d) in CASES.items():
        cfg = dataclasses.replace(base, capacity_factor=cf, moe_ep2d=ep2d)
        mesh = meshes[shape]
        (D, n_sh), (d, m) = shape, mesh.get_coordinate()
        xl, leaves = _shard_run(x, p, cfg, ((m, n_sh), (d, D)))
        y = moe.moe_a2a(xl, leaves, cfg, ShardingCtx(Rules(), mesh))
        (y ** 2).sum().backward()
        res = {"y": y.detach().numpy(), "g": _grads(xl, leaves)}
        if rank == 0 and not ep2d:
            shards = [_shard_run(x, p, cfg, ((j, n_sh), (0, D))) for j in range(n_sh)]
            runs = moe.moe_a2a_shards([s[0] for s in shards], [s[1] for s in shards], cfg,
                                      n_sh, moe.loopback_exchange)
            ys = [moe.add_shared(r.y, xl_, lv, cfg) for r, (xl_, lv) in zip(runs, shards)]
            sum((yj ** 2).sum() for yj in ys).backward()
            res["loopback"] = [{"y": yj.detach().numpy(), "g": _grads(*s)}
                               for yj, s in zip(ys, shards)]
        out[tag] = res
    for tag, (shape, E) in FALLBACK.items():
        cfg = dataclasses.replace(base, n_experts=E, capacity_factor=1.0)
        mesh = meshes[shape]
        (D, n_sh), (d, m) = shape, mesh.get_coordinate()
        xl = moe.moe_shard_input(x, cfg, (m, n_sh), (d, D)).clone().requires_grad_()
        leaves = {k: torch.from_numpy(v).clone().requires_grad_()
                  for k, v in fallback[tag].items()}
        y = moe.moe_a2a(xl, leaves, cfg, ShardingCtx(Rules(), mesh))
        (y ** 2).sum().backward()
        out[tag] = {"y": y.detach().numpy(), "g": _grads(xl, leaves)}
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """JAX's subprocess and the gloo world run side by side, on the same
    weights and input (JAX's draws, made here)."""
    import jax
    from repro.models.config import ArchConfig as JaxArchConfig
    from repro.models.layers import materialize_tree
    from repro.models.moe import moe_specs
    p = materialize_tree(moe_specs(JaxArchConfig(**BASE)), jax.random.key(0))
    inputs = {"x": np.array(jax.random.normal(jax.random.key(1), (4, 16, BASE["d_model"]))),
              **{"p_" + k: np.array(v) for k, v in p.items()}}
    fallback = {}
    for tag, (_, E) in FALLBACK.items():
        po = materialize_tree(moe_specs(JaxArchConfig(**{**BASE, "n_experts": E})),
                              jax.random.key(2))
        fallback[tag] = {k: np.array(v) for k, v in po.items()}
    with ThreadPoolExecutor(1) as pool:
        oracle = pool.submit(run_jax_oracle, ORACLE, tmp_path_factory.mktemp("a2a"))
        ranks = run_world(_port_a2a, 4, tmp_path_factory.mktemp("world"),
                          args=(inputs, fallback))
        oracle = oracle.result()
    for tag in FALLBACK:
        for k, v in fallback[tag].items():
            np.testing.assert_array_equal(oracle[f"p_{tag}_{k}"], v)
    np.testing.assert_array_equal(oracle["x"], inputs["x"])
    return oracle, ranks


def _assemble_y(ranks, tag):
    """The ranks' local y [b/D, s/n_sh, e] put back into [b, s, e]."""
    (D, n_sh) = CASES[tag][0] if tag in CASES else FALLBACK[tag][0]
    rows = [np.concatenate([ranks[d * n_sh + m][tag]["y"] for m in range(n_sh)], axis=1)
            for d in range(D)]
    return np.concatenate(rows, axis=0)


def _close(got, want, tol):
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _check_grads(ranks, tag, want):
    """Every leaf's gradient against ``want(leaf)``, JAX's full array."""
    (D, n_sh), _, ep2d = CASES[tag]
    for leaf in LEAVES:
        full = want(leaf)
        if leaf not in EXPERT:
            got = sum(r[tag]["g"][leaf] for r in ranks)
            _close(got, full, G_TOL)
            continue
        e_loc = BASE["n_experts"] // n_sh
        parts = []
        for m in range(n_sh):
            per_data = [ranks[d * n_sh + m][tag]["g"][leaf] for d in range(D)]
            if ep2d:       # each data rank holds its slice of f: w_up/gate [.., f], w_down [f, ..]
                parts.append(np.concatenate(per_data, axis=2 if leaf != "w_down" else 1))
            else:          # the same experts on every data rank: the tokens' parts summed
                parts.append(sum(per_data))
        got = np.concatenate(parts, axis=0)
        assert got.shape == full.shape
        for m in range(n_sh):
            sl = slice(m * e_loc, (m + 1) * e_loc)
            _close(got[sl], full[sl], G_TOL * np.abs(full).max() / np.abs(full[sl]).max())


@pytest.mark.parametrize("tag", list(CASES))
def test_y_matches_jax(tag, results):
    oracle, ranks = results
    want = oracle[f"y_{tag}"]
    got = _assemble_y(ranks, tag)
    np.testing.assert_allclose(got, want, atol=Y_TOL * max(1.0, np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("tag", list(CASES))
def test_grads_match_jax(tag, results):
    oracle, ranks = results
    _check_grads(ranks, tag, lambda leaf: oracle[f"g_{tag}_{leaf}"])


@pytest.mark.parametrize("tag", ["cf16", "cf16_ep2d"])
def test_matches_dense_oracle(tag, results):
    """At capacity factor 16 nothing drops: y and every gradient equal the
    dense oracle's (JAX's ``moe_dense``) within the same tolerances."""
    oracle, ranks = results
    want = oracle["y_dense"]
    np.testing.assert_allclose(_assemble_y(ranks, tag), want,
                               atol=Y_TOL * max(1.0, np.abs(want).max()), rtol=0)
    _check_grads(ranks, tag, lambda leaf: oracle[f"g_dense_{leaf}"])


def test_capacity_one_drops(results):
    """At capacity factor 1.0 pairs are dropped: y is held more than 0.1 of
    its largest |y| away from the dense oracle's, so a path that dropped
    nothing could not pass ``test_y_matches_jax``."""
    oracle, ranks = results
    want = oracle["y_dense"]
    for tag in ("cf1", "cf1_ep2d", "cf1_m4"):
        assert np.abs(_assemble_y(ranks, tag) - want).max() > 0.1 * np.abs(want).max()


@pytest.mark.parametrize("tag", [t for t, c in CASES.items() if not c[2]])
def test_loopback_equals_world_bitwise(tag, results):
    """The loopback exchange over data slice 0's n_sh shards in one process
    gives those ranks' y and gradients bit for bit."""
    _, ranks = results
    (D, n_sh), _, _ = CASES[tag]
    loop = ranks[0][tag]["loopback"]
    assert len(loop) == n_sh
    for m in range(n_sh):
        np.testing.assert_array_equal(loop[m]["y"], ranks[m][tag]["y"])
        for leaf, g in loop[m]["g"].items():
            np.testing.assert_array_equal(g, ranks[m][tag]["g"][leaf])


@pytest.mark.parametrize("tag", list(FALLBACK))
def test_unsupported_shards_raise(tag, results):
    """Where JAX falls back to the GSPMD dispatch under a mesh (E % n_sh
    nonzero: 6 experts over 4 model shards, 3 over 2) the port computes as
    JAX does: every rank holds every expert and its block of x, the
    dispatch ranks the mesh's pairs in the tokens' global order; y within
    2e-5 of max(1, largest |y|) of JAX's, x's gradient block by block and
    every leaf's gradient summed over the ranks within 1e-5 of its largest
    |g|. A sequence that does not split over the model shards (decode's
    one position) is JAX's other fallback: ``moe_shard_input`` gives every
    rank its rows with every position, whole over "model"."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.config import ArchConfig
    oracle, ranks = results
    want = oracle[f"y_{tag}"]
    np.testing.assert_allclose(_assemble_y(ranks, tag), want,
                               atol=Y_TOL * max(1.0, np.abs(want).max()), rtol=0)
    for leaf in LEAVES:
        _close(sum(r[tag]["g"][leaf] for r in ranks), oracle[f"g_{tag}_{leaf}"], G_TOL)
    (D, n_sh), _ = FALLBACK[tag]
    gx = np.concatenate([np.concatenate([ranks[d * n_sh + m][tag]["g"]["x"]
                                         for m in range(n_sh)], axis=1) for d in range(D)])
    assert np.abs(gx).max() > 0
    x = torch.arange(2 * 6 * 32, dtype=torch.float32).view(2, 6, 32)
    for m in range(4):
        assert torch.equal(moe.moe_shard_input(x, ArchConfig(**BASE), (m, 4)), x)
        assert torch.equal(moe.moe_shard_input(x, ArchConfig(**BASE), (m, 4), (1, 2)), x[1:])
