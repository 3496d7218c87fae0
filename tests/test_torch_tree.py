"""Tree-shaped hierarchies: multi-child instances and sibling routing.

The paper's Fig. 2 multi-user topology: a parent with several child
subtrees.  A child's failed MATCHGROW is routed by the parent to the
child's *siblings* (the ``reclaim`` RPC) before escalating to the
parent's own parent or the External API.

The twin of tests/test_tree.py on ``repro_torch.core``, the port's copy
of the control plane: only the imports are rewritten, and the graphs are built
with ``device="cpu"`` (the port's graphs take the device of their flat mirror)."""
import functools

import pytest

from repro_torch.core import (GrowResult, Jobspec, SchedulerInstance, TreeSpec,
                              build_cluster, build_tree)

# the port's graphs take the device of their flat mirror; these run on the CPU
build_cluster = functools.partial(build_cluster, device="cpu")


def _delegated_tree(socket=False):
    """Root owns 8 nodes; users A and B each get a 4-node subtree
    (disjoint node sets, same path space — subgraph inclusion), and the
    root marks everything delegated so it has no free pool of its own."""
    root_g = build_cluster(nodes=8)
    a_g = root_g.extract([p for p in root_g.paths()
                          if any(f"node{i}" in p for i in (0, 1, 2, 3))])
    b_g = root_g.extract([p for p in root_g.paths()
                          if any(f"node{i}" in p for i in (4, 5, 6, 7))])
    for g in (a_g, b_g):
        g.init_aggregates()
    spec = TreeSpec(root_g, name="root", children=[
        TreeSpec(a_g, name="userA", socket=socket,
                 children=[TreeSpec(build_cluster(nodes=1), name="leafA",
                                    socket=socket)]),
        TreeSpec(b_g, name="userB"),
    ])
    h = build_tree(spec)
    root = h["root"]
    root.graph.set_allocated(
        [p for p in root.graph.paths() if "/node" in p], "delegated")
    return h


def test_build_tree_shape():
    h = _delegated_tree()
    try:
        root, a, b = h["root"], h["userA"], h["userB"]
        assert set(root.children) == {"userA", "userB"}
        assert set(a.children) == {"leafA"}
        assert b.children == {}
        assert h.top is root
        # preorder: leafA is under userA, userB last
        assert [i.name for i in h.instances] == \
            ["root", "userA", "leafA", "userB"]
        assert a.graph.is_subgraph_of(root.graph)
        assert b.graph.is_subgraph_of(root.graph)
    finally:
        h.close()


@pytest.mark.parametrize("socket", [False, True])
def test_sibling_routing_three_levels(socket):
    """leafA's MG fails locally and at userA; the root (fully delegated)
    reclaims from userB's free subtree instead of failing."""
    h = _delegated_tree(socket=socket)
    try:
        root, a, b, leaf = h["root"], h["userA"], h["userB"], h["leafA"]
        # userA and leafA fully allocated -> the request must escalate
        assert a.match_allocate(
            Jobspec.hpc(nodes=4, sockets=8, cores=128), jobid="hogA")
        assert leaf.match_allocate(
            Jobspec.hpc(nodes=1, sockets=2, cores=32), jobid="j")
        b_nodes_before = len(b.graph.by_type("node"))
        res = leaf.match_grow(Jobspec.hpc(nodes=1, sockets=2, cores=32),
                              "j")
        assert isinstance(res, GrowResult) and res
        assert res.via == "parent"          # from the leaf's viewpoint
        # the root recorded the sibling route
        assert root.timings[-1].via_sibling == "userB"
        # donor shrank (subtractive, bottom-up), receiver grew
        assert len(b.graph.by_type("node")) == b_nodes_before - 1
        assert len(leaf.graph.by_type("node")) == 2
        # every graph in the tree stays a valid aggregate-correct tree
        for inst in h.instances:
            assert inst.graph.validate_tree(), inst.name
        # the donated vertices are bound to the job at leaf AND root
        for p in res.paths():
            assert leaf.graph.vertex(p).allocations.get("j")
            assert root.graph.vertex(p).allocations.get("j")
    finally:
        h.close()


def test_sibling_preferred_over_external():
    """With a free sibling available, the root must not burst."""
    from repro_torch.core import SimulatedEC2Provider
    root_g = build_cluster(nodes=2)
    a_g = root_g.extract([p for p in root_g.paths() if "node0" in p])
    b_g = root_g.extract([p for p in root_g.paths() if "node1" in p])
    h = build_tree(TreeSpec(root_g, name="root",
                            external=SimulatedEC2Provider(),
                            children=[TreeSpec(a_g, name="A"),
                                      TreeSpec(b_g, name="B")]))
    try:
        root, a = h["root"], h["A"]
        root.graph.set_allocated(
            [p for p in root.graph.paths() if "/node" in p], "delegated")
        a.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32), "j")
        res = a.match_grow(Jobspec.hpc(nodes=1, sockets=2, cores=32), "j")
        assert res
        assert root.timings[-1].via_sibling == "B"
        assert not root.timings[-1].external
        assert not root.external_paths
    finally:
        h.close()


def test_sibling_exhausted_falls_through_to_external():
    from repro_torch.core import SimulatedEC2Provider
    root_g = build_cluster(nodes=1)
    a_g = root_g.extract(list(root_g.paths()))
    a_g.init_aggregates()
    h = build_tree(TreeSpec(root_g, name="root",
                            external=SimulatedEC2Provider(),
                            children=[TreeSpec(a_g, name="A")]))
    try:
        root, a = h["root"], h["A"]
        root.graph.set_allocated(
            [p for p in root.graph.paths() if "/node" in p], "delegated")
        a.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32), "j")
        res = a.match_grow(Jobspec.instances("t2.2xlarge", 1), "j")
        assert res                      # no sibling exists: burst
        assert root.timings[-1].external
        assert root.timings[-1].via_sibling is None
    finally:
        h.close()


def test_reclaim_rpc_direct():
    """The donor-side reclaim: matched subgraph leaves the donor."""
    g = build_cluster(nodes=2)
    inst = SchedulerInstance("donor", g)
    out = inst.engine.reclaim(Jobspec.hpc(nodes=1, sockets=2, cores=32))
    assert out is not None
    assert len(out["paths"]) == 35
    assert all(p not in inst.graph for p in out["paths"])
    assert inst.graph.validate_tree()
    # nothing left for a second whole-node claim of the same shape x2
    assert inst.engine.reclaim(
        Jobspec.hpc(nodes=2, sockets=4, cores=64)) is None


def test_reclaim_never_steals_live_job_allocation():
    """Sibling reclaim displaces delegation markers only: a vertex a
    parent allocated to a LIVE job keeps that binding (the new jobid is
    added alongside, conflict visible) — release bookkeeping for the
    prior owner must survive."""
    root_g = build_cluster(nodes=2)
    b_g = root_g.extract([p for p in root_g.paths() if "node1" in p])
    h = build_tree(TreeSpec(root_g, name="root",
                            children=[TreeSpec(build_cluster(nodes=1),
                                               name="A"),
                                      TreeSpec(b_g, name="B")]))
    try:
        root = h["root"]
        # discipline violation on purpose: root allocates BOTH nodes to
        # its own live job Y while B's stale copy still shows node1 free
        y = root.match_allocate(Jobspec.hpc(nodes=2, sockets=4, cores=64),
                                jobid="Y")
        assert y
        a = h["A"]
        a.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32), "Z")
        res = a.match_grow(Jobspec.hpc(nodes=1, sockets=2, cores=32), "Z")
        assert res and root.timings[-1].via_sibling == "B"
        stolen = [p for p in res.paths() if p in root.graph]
        # Y's binding survives next to Z's
        assert all(root.graph.vertex(p).allocations.get("Y")
                   for p in stolen)
        root.release("Y")
        assert all(not root.graph.vertex(p).allocations.get("Y")
                   for p in stolen if p in root.graph)
        assert root.graph.validate_tree()
    finally:
        h.close()


def test_delegation_marker_displaced_on_reclaim():
    """The normal case: vertices marked 'delegated*' at the parent are
    rebound cleanly to the requesting job (marker dropped), and return
    to the parent's free pool when that job releases."""
    root_g = build_cluster(nodes=2)
    a_g = root_g.extract([p for p in root_g.paths() if "node0" in p])
    b_g = root_g.extract([p for p in root_g.paths() if "node1" in p])
    h = build_tree(TreeSpec(root_g, name="root",
                            children=[TreeSpec(a_g, name="A"),
                                      TreeSpec(b_g, name="B")]))
    try:
        root = h["root"]
        root.graph.set_allocated(
            [p for p in root.graph.paths() if "/node" in p],
            "delegated-to-children")
        a = h["A"]
        a.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32), "j")
        res = a.match_grow(Jobspec.hpc(nodes=1, sockets=2, cores=32), "j")
        assert res
        donated = [p for p in res.paths() if p in root.graph]
        assert all(root.graph.vertex(p).allocations == {"j": 1}
                   for p in donated)
        a.release("j")     # propagates: root frees its copies too
        assert all(not root.graph.vertex(p).allocations for p in donated)
        assert root.graph.validate_tree()
    finally:
        h.close()


def test_aliased_parent_grow_fails_cleanly():
    """If the parent's matched subgraph fully aliases vertices the
    child already holds (namespace collision, no delegation marking),
    the grow reports failure and the parent's allocation is rolled
    back — no phantom success, no stranded capacity."""
    from repro_torch.core import build_chain
    # both levels use the default node namespace: full alias
    h = build_chain([build_cluster(nodes=1), build_cluster(nodes=1)])
    try:
        top, leaf = h.instances
        leaf.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32),
                            jobid="j")
        res = leaf.match_grow(Jobspec.hpc(nodes=1, sockets=2, cores=32),
                              "j")
        assert not res
        # rollback: nothing left allocated to j at the parent
        alloc = top.allocations.get("j")
        assert alloc is None or alloc.paths == []
        assert all("j" not in top.graph.vertex(p).allocations
                   for p in top.graph.paths())
        assert top.graph.validate_tree()
    finally:
        h.close()


def test_partially_aliased_parent_grow_fails_cleanly():
    """Partial namespace collision: the parent matches 2 nodes, one of
    which the child already holds.  The grow must fail and roll back —
    booking half a grow would double-use the aliased node and strand
    the parent's allocation for it."""
    from repro_torch.core import build_chain
    h = build_chain([build_cluster(nodes=2), build_cluster(nodes=1)])
    try:
        top, leaf = h.instances
        leaf.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32),
                            jobid="j")
        n_before = leaf.graph.num_vertices
        res = leaf.match_grow(Jobspec.hpc(nodes=2, sockets=4, cores=64),
                              "j")
        assert not res
        # rollback on both sides: leaf unchanged, top fully freed
        assert leaf.graph.num_vertices == n_before
        assert all("j" not in top.graph.vertex(p).allocations
                   for p in top.graph.paths())
        assert leaf.graph.validate_tree() and top.graph.validate_tree()
    finally:
        h.close()
