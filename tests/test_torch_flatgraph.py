"""The port's flat mirror and matcher against the JAX package's.

Twin graphs, one per package (the port's with ``device="cpu"``), go
through the same seeded sequence of allocations, releases, status flips,
splices and revokes. After every step the mirrors' columns, aggregates
and counters are equal, each mirror agrees with its dict graph, and the
flat and dict matchers of both packages return the same paths. The
scans (``feasible_roots_batch``, ``aggregate_sweep``) are held bit-exact
against the JAX package's numpy and jax paths. The graphs are above
``VECTOR_MIN_VERTICES`` and ``FLAT_MIN_VERTICES``, so the vectorized
prefilter and the per-level sweep really run.
"""
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import flatgraph as jax_flatgraph
from repro.core.graph import DOWN, UP
from repro_torch import core as P
from repro_torch.core import flatgraph

CPU = {"device": "cpu"}
SHAPE = dict(nodes=16, sockets_per_node=2, cores_per_socket=16)      # 561 vertices


def _twins(**kw):
    kw = {**SHAPE, **kw}
    return P.build_cluster(**kw, **CPU), J.build_cluster(**kw)


def assert_same_mirror(ours, ref):
    fo, fr = ours.flat(), ref.flat()
    fo.sync()
    fr.sync()
    n, T = fr.n, len(fr.types)
    assert (fo.n, fo.types, fo.path) == (n, fr.types, fr.path)
    for col in ("parent", "type_id", "size", "free", "present", "prop_mask"):
        assert np.array_equal(getattr(fo, col)[:n], getattr(fr, col)[:n]), col
    assert np.array_equal(fo.agg[:n, :T], fr.agg[:n, :T])
    assert fo.children[:n] == fr.children[:n]
    for counter in ("n_builds", "n_agg_sweeps", "n_bubbles"):
        assert getattr(fo, counter) == getattr(fr, counter), counter
    assert fo.verify_against(ours) and fr.verify_against(ref)
    assert ours.n_agg_rebuilds == ref.n_agg_rebuilds


def assert_same_matches(ours, ref, js_ours, js_ref):
    got = [P.Matcher(ours, use_flat=True).match(js_ours),
           P.Matcher(ours, use_flat=False).match(js_ours),
           J.Matcher(ref, use_flat=True).match(js_ref),
           J.Matcher(ref, use_flat=False).match(js_ref)]
    assert got[1:] == got[:-1]
    return got[0]


# ---------------------------------------------------------------------- #
# deterministic twins of tests/test_flatgraph.py
# ---------------------------------------------------------------------- #
def test_mirror_after_build():
    ours, ref = _twins(nodes=2, gpus_per_socket=2, mem_per_socket=4)
    assert_same_mirror(ours, ref)
    assert ours.flat().n_builds == 1


def test_mirror_tracks_alloc_release_and_status():
    ours, ref = _twins()
    cores = sorted(ref.by_type("core"))[:8]
    node = sorted(ref.by_type("node"))[3]
    for g in (ours, ref):
        g.flat()
        g.set_allocated(cores, "job-a")
    assert_same_mirror(ours, ref)
    for g in (ours, ref):
        g.set_free(cores, "job-a")
        g.set_status(node, DOWN)
    assert_same_mirror(ours, ref)
    for g in (ours, ref):
        g.set_status(node, UP)
    assert_same_mirror(ours, ref)
    assert ours.flat().n_builds == 1 and ours.flat().n_bubbles >= 2


def test_mirror_tracks_splice_revoke_and_compaction():
    """Splices, revokes and the compacting rebuild after heavy removal."""
    ours, ref = _twins(nodes=8)
    for g, mod in ((ours, P), (ref, J)):
        g.flat()
        dev = CPU if mod is P else {}
        ext = mod.build_cluster(nodes=1, node_prefix="burst", **dev)
        res = mod.add_subgraph(g, ext.extract([p for p in ext.paths() if "burst" in p]))
        mod.update_metadata(g, res, jobid="burst-job")
        assert g.flat().verify_against(g)
        mod.remove_subgraph(g, res.new_paths, jobid="burst-job")
        for k in range(6):
            mod.remove_subgraph(g, [f"/cluster0/node{k}"])
        late = mod.build_cluster(nodes=1, node_prefix="late", **dev)
        res = mod.add_subgraph(g, late.extract([p for p in late.paths() if "late" in p]))
        mod.update_metadata(g, res, jobid="late-job")
    assert ours.flat().n_builds == 2        # the compaction ran on both sides
    assert_same_mirror(ours, ref)


@pytest.mark.parametrize("spec", [
    dict(nodes=2, sockets=4, cores=32),
    dict(nodes=1, sockets=2, cores=8, gpus=2),
    dict(nodes=8, sockets=16, cores=64),        # unsatisfiable
    dict(nodes=0, sockets=1, cores=4),          # socket-rooted
])
def test_flat_and_dict_matchers_identical(spec):
    ours, ref = _twins(nodes=4, gpus_per_socket=2, mem_per_socket=4)
    got = assert_same_matches(ours, ref, P.Jobspec.hpc(**spec), J.Jobspec.hpc(**spec))
    if got is not None:
        assert len(got) == len(set(got))        # exclusive claims


def test_env_toggle_and_size_cutoffs(monkeypatch):
    big = P.build_cluster(**SHAPE, **CPU)
    small = P.build_cluster(nodes=2, **CPU)
    assert P.Matcher(big).use_flat and not P.Matcher(small).use_flat
    assert P.Matcher(small, use_flat=True).use_flat
    monkeypatch.setenv("CONVERGED_FLAT_MATCH", "0")
    assert not P.Matcher(big).use_flat
    for name in ("VECTOR_MIN_VERTICES", "FLAT_MIN_VERTICES", "FLAT_REQ_RATIO"):
        assert getattr(flatgraph, name) == getattr(jax_flatgraph, name)


def test_feasible_roots_unknown_type_is_empty():
    g = P.build_cluster(**SHAPE, **CPU)
    missing = P.ResourceReq(type="quantum-annealer", count=1)
    assert len(g.flat().feasible_roots(missing)) == 0
    mask = g.flat().feasible_roots_batch([missing])
    assert mask.shape == (1, g.flat().n) and not mask.any()


# ---------------------------------------------------------------------- #
# seeded churn: the twins stay equal after every step
# ---------------------------------------------------------------------- #
def _spec(rng, mod):
    sockets = int(rng.choice([1, 2]))
    if rng.random() < 0.2:
        return mod.Jobspec.hpc(nodes=2, sockets=4, cores=int(rng.choice([16, 64])))
    return mod.Jobspec.hpc(nodes=1, sockets=sockets,
                           cores=sockets * int(rng.choice([2, 4, 16])),
                           gpus=int(rng.choice([0, sockets])))


@pytest.mark.parametrize("seed", range(6))
def test_twins_equal_under_seeded_churn(seed):
    rng = np.random.default_rng(seed)
    ours, ref = _twins(gpus_per_socket=1)
    for g in (ours, ref):
        g.flat()
    cores = sorted(ref.by_type("core"))
    nodes = sorted(ref.by_type("node"))
    running, spliced = [], {}
    for step in range(40):
        op = rng.choice(["alloc", "free", "down", "up", "splice_in", "splice_out",
                         "match", "match"])
        if op == "alloc":
            pick = [cores[i] for i in rng.choice(len(cores), 3, replace=False)]
            for g in (ours, ref):
                g.set_allocated(pick, f"a{step}")
            running.append((f"a{step}", pick))
        elif op == "free" and running:
            jobid, paths = running.pop(int(rng.integers(len(running))))
            for g in (ours, ref):
                g.set_free(paths, jobid)
        elif op in ("down", "up"):
            node = nodes[int(rng.integers(len(nodes)))]
            for g in (ours, ref):
                g.set_status(node, DOWN if op == "down" else UP)
        elif op == "splice_in":
            k = int(rng.integers(3))
            if k in spliced:
                continue
            for g, mod, dev in ((ours, P, CPU), (ref, J, {})):
                ext = mod.build_cluster(nodes=1, sockets_per_node=1, cores_per_socket=4,
                                        mem_per_socket=2, node_prefix=f"burst{k}-", **dev)
                res = mod.add_subgraph(
                    g, ext.extract([p for p in ext.paths() if f"burst{k}-" in p]))
                mod.update_metadata(g, res, jobid=None if k == 0 else f"b{k}")
            spliced[k] = res.new_paths
        elif op == "splice_out" and spliced:
            k = list(spliced)[int(rng.integers(len(spliced)))]
            paths = spliced.pop(k)
            for g, mod in ((ours, P), (ref, J)):
                mod.remove_subgraph(g, paths, jobid=None if k == 0 else f"b{k}")
        elif op == "match":
            got = assert_same_matches(ours, ref, *(_spec(np.random.default_rng(step), m)
                                                   for m in (P, J)))
            if got is not None:
                for g in (ours, ref):
                    g.set_allocated(got, f"m{step}")
                running.append((f"m{step}", got))
        assert ours.validate_tree() and ref.validate_tree()
        assert_same_mirror(ours, ref)


# ---------------------------------------------------------------------- #
# the scans: feasible_roots_batch and aggregate_sweep
# ---------------------------------------------------------------------- #
def _churned(mod, dev):
    """test_flatgraph.py's churned graph: cores busy, one node down."""
    g = mod.build_cluster(nodes=4, gpus_per_socket=2, mem_per_socket=4, **dev)
    g.set_allocated(sorted(g.by_type("core"))[:24], "busy")
    g.set_status(sorted(g.by_type("node"))[1], DOWN)
    return g


def _batch(mod):
    specs = [mod.Jobspec.hpc(nodes=1, sockets=1, cores=4),
             mod.Jobspec.hpc(nodes=1, sockets=2, cores=8, gpus=2),
             mod.Jobspec.hpc(nodes=2, sockets=4, cores=32),
             mod.Jobspec.hpc(nodes=1, sockets=1, cores=4),       # repeated shape
             mod.Jobspec.hpc(nodes=8, sockets=16, cores=64),     # unsatisfiable
             mod.Jobspec.hpc(nodes=0, sockets=1, cores=2, mem=2)]
    return [r for js in specs for r in js.resources] + [mod.ResourceReq("quantum-annealer")]


@pytest.mark.parametrize("new_type", [False, True])
def test_feasible_roots_batch_matches_jax(new_type):
    """Equal to JAX's numpy and jax paths, and row i equals
    feasible_roots(reqs[i]). With ``new_type`` a splice adds a resource
    type after the build, so the type columns grow by 4 and the scan
    reads ``agg[:n, :T]`` as a strided view."""
    ours, ref = _churned(P, CPU), _churned(J, {})
    if new_type:
        for g, mod, dev in ((ours, P, CPU), (ref, J, {})):
            g.flat()
            ext = mod.build_cluster(nodes=1, gpus_per_socket=0, mem_per_socket=0,
                                    node_prefix="fpga", **dev)
            sub = ext.extract([p for p in ext.paths() if "fpga" in p])
            sub.add_vertex(mod.Vertex(type="fpga", name="fpga0",
                                      path="/cluster0/fpga0/socket0/fpga0"))
            sub.add_edge("/cluster0/fpga0/socket0", "/cluster0/fpga0/socket0/fpga0")
            mod.update_metadata(g, mod.add_subgraph(g, sub))
        assert ours.flat().agg.shape[1] > len(ours.flat().types)
    fo, fr = ours.flat(), ref.flat()
    mask = fo.feasible_roots_batch(_batch(P))
    for use_jax in ("numpy", "jax"):
        assert np.array_equal(mask, fr.feasible_roots_batch(_batch(J), use_jax=use_jax))
    assert mask.dtype == bool and mask.shape == (len(_batch(P)), fo.n)
    for i, r in enumerate(_batch(P)):
        assert np.array_equal(np.nonzero(mask[i])[0], fo.feasible_roots(r)), i
    assert not mask[-1].any()
    assert_same_mirror(ours, ref)


def test_aggregate_sweep_matches_jax():
    ours, ref = _churned(P, CPU), _churned(J, {})
    fo, fr = ours.flat(), ref.flat()
    fo.sync()
    fr.sync()
    n, T = fr.n, len(fr.types)
    own = np.zeros((n, T), np.int32)
    live = np.nonzero(fr.present[:n] & fr.free[:n])[0]
    own[live, fr.type_id[live]] = 1
    want = [jax_flatgraph.aggregate_sweep(own, fr.parent[:n], fr._levels, use_jax=u)
            for u in ("numpy", "jax")]
    got = flatgraph.aggregate_sweep(own, fr.parent[:n], fr._levels, "cpu")
    again = flatgraph.aggregate_sweep(torch.from_numpy(own), fo._parent_dev, fo._levels,
                                      torch.device("cpu"))
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    for w in want:
        assert np.array_equal(got.numpy(), np.asarray(w))
    assert np.array_equal(again.numpy(), got.numpy())
    assert np.array_equal(got.numpy(), fo.agg[:n, :T])
    assert own.sum() == live.size               # the input is left as it was
