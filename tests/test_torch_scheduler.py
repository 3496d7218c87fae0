"""Scheduler tests: MA / MG (Algorithm 1), shrink, hierarchy, external.

The twin of tests/test_scheduler.py on ``repro_torch.core``, the port's copy
of the control plane: only the imports are rewritten."""
import functools

from repro_torch.core import (Jobspec, ResourceReq, SchedulerInstance,
                              SimulatedEC2Provider, TPUSliceProvider, build_chain,
                              build_cluster)

# the port's graphs take the device of their flat mirror; these run on the CPU
build_cluster = functools.partial(build_cluster, device="cpu")


def _levels(paper=True):
    """Paper Table-2 level graphs (L0..L4)."""
    sizes = [(128, 2, 16), (8, 2, 16), (4, 2, 16), (2, 2, 16), (1, 2, 16)]
    return [build_cluster(nodes=n, sockets_per_node=s, cores_per_socket=c)
            for n, s, c in sizes]


def test_jobspec_table1_sizes():
    want = {(64, 128, 2048): 4480, (32, 64, 1024): 2240, (16, 32, 512): 1120,
            (8, 16, 256): 560, (4, 8, 128): 280, (2, 4, 64): 140,
            (1, 2, 32): 70, (0, 1, 16): 36}
    for (n, s, c), size in want.items():
        assert Jobspec.hpc(nodes=n, sockets=s, cores=c).graph_size() == size


def test_match_allocate_exclusive():
    g = build_cluster(nodes=4)
    sched = SchedulerInstance("L0", g)
    a1 = sched.match_allocate(Jobspec.hpc(nodes=2, sockets=4, cores=64))
    a2 = sched.match_allocate(Jobspec.hpc(nodes=2, sockets=4, cores=64))
    assert a1 and a2
    assert not (set(a1.paths) & set(a2.paths))
    a3 = sched.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32))
    assert a3 is None  # cluster exhausted


def test_match_grow_local():
    g = build_cluster(nodes=2)
    sched = SchedulerInstance("L0", g)
    alloc = sched.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32),
                                 jobid="j")

    assert alloc
    sub = sched.match_grow(Jobspec.hpc(nodes=1, sockets=2, cores=32), "j")
    assert sub and sub.via == "local"
    rec = sched.timings[-1]
    assert rec.matched_locally and rec.t_comms == 0
    # all resources joined the SAME job
    assert len(sched.allocations["j"].paths) == 70


def test_nested_match_grow_chain():
    graphs = _levels()
    h = build_chain(graphs, socket_levels=[1])
    try:
        leaf = h.leaf
        # make L1..L4 fully allocated so requests recurse to L0
        for inst in h.instances[1:]:
            n = len(inst.graph.by_type("node"))
            assert inst.match_allocate(
                Jobspec.hpc(nodes=n, sockets=2 * n, cores=32 * n),
                jobid="init")
        sub = leaf.match_grow(Jobspec.hpc(nodes=1, sockets=2, cores=32),
                              "init")
        assert sub and sub.via == "parent"

        # the leaf's graph grew by the matched subgraph
        assert len(leaf.graph.by_type("node")) == 2
        assert leaf.graph.validate_tree()
        # every level on the path recorded a timing
        levels = {t.level for inst in h.instances for t in inst.timings}
        assert {"L0", "L1", "L2", "L3", "L4"} <= levels
        # component model: match + comms + add_upd == total (by def.)
        for inst in h.instances:
            for t in inst.timings:
                assert t.total == t.t_match + t.t_comms + t.t_add_upd
    finally:
        h.close()


def test_match_shrink_bottom_up():
    g = build_cluster(nodes=2)
    sched = SchedulerInstance("L0", g)
    sched.match_allocate(Jobspec.hpc(nodes=2, sockets=4, cores=64),
                         jobid="j")
    victims = [p for p in sched.allocations["j"].paths if "/node1" in p]
    sched.match_shrink("j", victims, remove_vertices=True)
    assert all(p not in sched.graph for p in victims)
    assert sched.graph.validate_tree()


def test_external_burst_ec2():
    g = build_cluster(nodes=1)
    sched = SchedulerInstance("top", g, external=SimulatedEC2Provider())
    sched.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32),
                         jobid="j")
    sub = sched.match_grow(Jobspec.instances("t2.2xlarge", 2), "j")
    assert sub and sub.via == "external"
    assert sched.timings[-1].external
    assert len(sched.graph.by_type("zone")) >= 1  # zone interposition
    # E_i bookkeeping: external resources tracked separately
    assert sched.external_paths
    # releasing the job removes the external resources (E_i = G_i \ G_0)
    sched.release("j")
    assert not sched.external_paths
    assert sched.graph.validate_tree()


def test_external_specialization_at_child_level():
    """A child instance with its own provider bursts independently; the
    parent graph is untouched (supergraph-inclusion deliberately
    invalidated — paper Section 3)."""
    graphs = [build_cluster(nodes=2), build_cluster(nodes=1)]
    h = build_chain(graphs)
    try:
        child = h.leaf
        child.external = TPUSliceProvider()
        child.external_at_any_level = True
        # parent fully allocated -> parent MG fails -> child's own provider
        h.top.match_allocate(Jobspec.hpc(nodes=2, sockets=4, cores=64),
                             jobid="hog")
        child.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32),
                             jobid="j")
        before_parent = set(h.top.graph.paths())
        sub = child.match_grow(
            Jobspec(resources=[ResourceReq("node", 1)]), "j")
        assert sub and child.timings[-1].external
        assert set(h.top.graph.paths()) == before_parent
    finally:
        h.close()


def test_grow_then_release_returns_to_parent_pool():
    graphs = [build_cluster(nodes=2), build_cluster(nodes=1)]
    h = build_chain(graphs)
    try:
        leaf = h.leaf
        leaf.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32),
                            jobid="j")
        sub = leaf.match_grow(Jobspec.hpc(nodes=1, sockets=2, cores=32), "j")
        assert sub
        # parent allocated the resources to the child's job
        parent_alloc = h.top.allocations.get("j")
        assert parent_alloc and parent_alloc.paths
        leaf.match_shrink("j", [p for p in sub.paths()], remove_vertices=True)
        # parent released them back to its free pool
        g = h.top.graph
        freed = [p for p in parent_alloc.paths if p in g]
        assert all(not g.vertex(p).allocations for p in freed)
    finally:
        h.close()


def test_match_shrink_release_rpc_over_socket():
    """Bottom-up shrink over the internode regime: the leaf's shrink
    sends the release RPC through the SocketTransport to its parent,
    which returns the vertices to its free pool."""
    graphs = [build_cluster(nodes=2), build_cluster(nodes=1)]
    h = build_chain(graphs, socket_levels=[1])   # leaf->parent: socket
    try:
        leaf, top = h.leaf, h.top
        leaf.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32),
                            jobid="j")
        sub = leaf.match_grow(Jobspec.hpc(nodes=1, sockets=2, cores=32),
                              "j")
        assert sub and sub.via == "parent"
        held = [p for p in top.allocations["j"].paths]
        assert held
        leaf.match_shrink("j", sub.paths(), remove_vertices=True)
        # the release RPC crossed the socket: parent freed the vertices
        for p in held:
            if p in top.graph:
                assert not top.graph.vertex(p).allocations
        assert all(p not in leaf.graph for p in sub.paths())
        assert leaf.graph.validate_tree() and top.graph.validate_tree()
    finally:
        h.close()


def test_grow_then_shrink_invariants_every_transform():
    """validate_tree() holds after EVERY transform in a grow/shrink
    churn sequence, at every level of the hierarchy."""
    graphs = [build_cluster(nodes=4), build_cluster(nodes=1)]
    h = build_chain(graphs, socket_levels=[1])
    try:
        leaf, top = h.leaf, h.top

        def check():
            assert leaf.graph.validate_tree()
            assert top.graph.validate_tree()

        leaf.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32),
                            jobid="j")
        check()
        grown = []
        for _ in range(3):
            sub = leaf.match_grow(
                Jobspec.hpc(nodes=1, sockets=2, cores=32), "j")
            assert sub
            grown.append(sub.paths())
            check()
        # shrink back in reverse order, one grow at a time
        for paths in reversed(grown):
            leaf.match_shrink("j", paths, remove_vertices=True)
            check()
        # the leaf is back to its own single node
        assert len(leaf.graph.by_type("node")) == 1
        # the parent's pool is fully free again
        freed = [p for p in top.graph.paths() if "/node" in p]
        assert all(not top.graph.vertex(p).allocations for p in freed)
    finally:
        h.close()


def test_release_external_paths_subset():
    """Partial release with external resources present: only the
    released subset of E_i disappears (set bookkeeping, not O(n^2))."""
    g = build_cluster(nodes=1)
    sched = SchedulerInstance("top", g, external=SimulatedEC2Provider())
    sched.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32), "j")
    s1 = sched.match_grow(Jobspec.instances("t2.small", 1), "j")
    s2 = sched.match_grow(Jobspec.instances("t2.small", 1), "j")
    assert s1 and s2
    assert isinstance(sched.external_paths, set)
    before = set(sched.external_paths)
    sched.release("j", s1.paths())
    assert sched.external_paths == before - set(s1.paths())
    assert sched.graph.validate_tree()
