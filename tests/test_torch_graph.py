"""The port's resource graph, jobspecs and transforms against the JAX package's.

Every comparison is exact: the graph holds strings and integers only.
The port's graphs are built with ``device="cpu"``; state crosses from
the JAX package as JSON Graph Format (``to_jgf``), the slice's
counterpart of ``convert.params_from_jax``.
"""
import numpy as np
import pytest
import torch

from repro.core import graph as jax_graph
from repro.core import jobspec as jax_jobspec
from repro.core import transform as jax_transform
from repro_torch.core import graph, jobspec, transform

CLUSTERS = [
    dict(nodes=2),
    dict(nodes=3, sockets_per_node=2, cores_per_socket=4, gpus_per_socket=2,
         mem_per_socket=4),
    dict(nodes=4, sockets_per_node=1, cores_per_socket=8, gpus_per_socket=1,
         node_prefix="n", rank_offset=10),
    dict(name="quartz", nodes=5, sockets_per_node=2, cores_per_socket=18),
]


def assert_same_graph(a, b):
    """``a`` and ``b`` hold the same vertices (every field, the pruning
    aggregates included), edges, roots and JGF, in the same order."""
    assert list(a.paths()) == list(b.paths())
    assert a.roots == b.roots
    for p in a.paths():
        va, vb = a.vertex(p), b.vertex(p)
        for field in ("type", "name", "id", "size", "rank", "status", "properties",
                      "allocations", "agg_free"):
            assert getattr(va, field) == getattr(vb, field), (p, field)
        assert a.children(p) == b.children(p)
        assert a.parent(p) == b.parent(p)
    assert a.counts_by_type() == b.counts_by_type()
    assert (a.num_vertices, a.num_edges, a.size) == (b.num_vertices, b.num_edges, b.size)
    assert a.to_jgf() == b.to_jgf()
    assert a.to_jgf_bytes() == b.to_jgf_bytes()


def _churn(g, seed):
    """Allocate some cores, take a node down: state the JGF must carry."""
    rng = np.random.default_rng(seed)
    cores = sorted(g.by_type("core"))
    g.set_allocated([cores[i] for i in rng.choice(len(cores), 5, replace=False)], "busy")
    g.set_status(sorted(g.by_type("node"))[-1], graph.DOWN)
    g.vertex(sorted(g.by_type("node"))[0]).properties["zone"] = "a"


@pytest.mark.parametrize("kw", CLUSTERS, ids=lambda kw: "-".join(map(str, kw.values())))
def test_build_cluster_matches_jax(kw):
    ours = graph.build_cluster(**kw, device="cpu")
    ref = jax_graph.build_cluster(**kw)
    assert_same_graph(ours, ref)
    assert ours.validate_tree()
    assert ours.device == torch.device("cpu")


def test_build_tpu_fleet_matches_jax():
    kw = dict(pods=2, racks_per_pod=2, nodes_per_rack=3, chips_per_node=4)
    assert_same_graph(graph.build_tpu_fleet(**kw, device="cpu"),
                      jax_graph.build_tpu_fleet(**kw))


@pytest.mark.parametrize("kw", CLUSTERS[:3], ids=lambda kw: "-".join(map(str, kw.values())))
@pytest.mark.parametrize("as_bytes", [False, True])
def test_jgf_from_jax_round_trip(kw, as_bytes):
    """A JAX graph, allocations, a DOWN node and properties included,
    loads into the port through its JGF and comes out the same."""
    ref = jax_graph.build_cluster(**kw)
    _churn(ref, 0)
    if as_bytes:
        ours = graph.ResourceGraph.from_jgf_bytes(ref.to_jgf_bytes(), device="cpu")
    else:
        ours = graph.ResourceGraph.from_jgf(ref.to_jgf(), device="cpu")
    back = jax_graph.ResourceGraph.from_jgf(ours.to_jgf())
    assert_same_graph(ours, back)
    assert ours.validate_tree()
    for p in ref.paths():
        assert ours.vertex(p).agg_free == ref.vertex(p).agg_free


def test_extract_matches_jax():
    ours = graph.build_cluster(nodes=3, gpus_per_socket=1, device="cpu")
    ref = jax_graph.build_cluster(nodes=3, gpus_per_socket=1)
    for g in (ours, ref):
        _churn(g, 1)
    keep = sorted(p for p in ref.paths() if "node1/socket0" in p)
    sub_ours, sub_ref = ours.extract(keep), ref.extract(keep)
    assert_same_graph(sub_ours, sub_ref)
    assert sub_ours.device == ours.device
    assert ours.extent_size(keep) == ref.extent_size(keep)


def _burst(mod, device_kw, prefix, nodes=1):
    ext = mod.build_cluster(nodes=nodes, sockets_per_node=1, cores_per_socket=4,
                            gpus_per_socket=1, node_prefix=prefix, **device_kw)
    return ext.extract([p for p in ext.paths() if prefix in p])


def _result_fields(res):
    return (res.kind.value, res.kind.direction, res.added_vertices, res.added_edges,
            res.removed_vertices, res.removed_edges, res.ancestors_updated,
            res.total_size, res.new_paths, res.subgraph_size)


@pytest.mark.parametrize("jobid", [None, "grow-job"])
def test_transforms_match_jax(jobid):
    """AddSubgraph + UpdateMetadata, the fused JGF splice, and
    RemoveSubgraph give the same results and aggregates on both sides."""
    ours = graph.build_cluster(nodes=3, device="cpu")
    ref = jax_graph.build_cluster(nodes=3)
    for g in (ours, ref):
        _churn(g, 2)
    sides = ((ours, graph, transform, {"device": "cpu"}),
             (ref, jax_graph, jax_transform, {}))
    results = []
    for g, gmod, tmod, dev in sides:
        res = tmod.add_subgraph(g, _burst(gmod, dev, "burst"))
        tmod.update_metadata(g, res, jobid=jobid)
        assert g.validate_tree()
        spliced = tmod.splice_jgf(g, _burst(gmod, dev, "jgf").to_jgf())
        tmod.update_metadata(g, spliced, jobid=jobid)
        again = tmod.add_subgraph(g, _burst(gmod, dev, "burst"))     # the identity
        gone = tmod.remove_subgraph(g, res.new_paths, jobid=jobid)
        gone_node = tmod.remove_subgraph(g, ["/cluster0/node0"])
        assert g.validate_tree()
        results.append([_result_fields(r) for r in (res, spliced, again, gone, gone_node)])
    assert results[0] == results[1]
    assert_same_graph(ours, ref)


def test_jobspec_matches_jax():
    specs = [
        ("hpc", dict(nodes=2, sockets=4, cores=32)),
        ("hpc", dict(nodes=0, sockets=1, cores=16)),
        ("hpc", dict(nodes=1, sockets=2, cores=8, gpus=2, mem=4)),
        ("tpu", dict(pods=1)),
        ("tpu", dict(nodes=2)),
        ("tpu", dict(chips=8)),
        ("instances", dict(instance_type="m5.large", count=3)),
        ("fleet", dict(count=4, allowed_types=["a", "b"])),
    ]
    for ctor, kw in specs:
        ours = getattr(jobspec.Jobspec, ctor)(**kw)
        ref = getattr(jax_jobspec.Jobspec, ctor)(**kw)
        assert ours.to_dict() == ref.to_dict()
        assert ours.graph_size() == ref.graph_size()
        assert ours.type_counts() == ref.type_counts()
        assert [r.total_vertices() for r in ours.resources] == \
            [r.total_vertices() for r in ref.resources]
        assert jobspec.Jobspec.from_dict(ref.to_dict()).to_dict() == ref.to_dict()


def test_default_device_needs_a_card(monkeypatch):
    """Without a card the default (CUDA) graph raises; nothing falls
    back to the CPU unless it is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graph.ResourceGraph()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graph.build_cluster(nodes=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graph.ResourceGraph.from_jgf(jax_graph.build_cluster(nodes=1).to_jgf())
    with pytest.raises(ValueError, match="unsupported device"):
        graph.ResourceGraph(device="meta")
    assert graph.ResourceGraph(device="cpu").device == torch.device("cpu")
