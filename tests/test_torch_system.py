"""End-to-end system behaviour tests (the paper's three capabilities).

The twin of tests/test_system.py on ``repro_torch.core``, the port's copy
of the control plane: only the imports are rewritten, and the graphs are built
with ``device="cpu"`` (the port's graphs take the device of their flat mirror)."""
import functools

from repro_torch.core import (Jobspec, ResourceReq, SchedulerInstance,
                              SimulatedEC2Provider, build_chain, build_cluster)

# the port's graphs take the device of their flat mirror; these run on the CPU
build_cluster = functools.partial(build_cluster, device="cpu")


def test_capability_1_rjms_dynamism():
    """Elastic job: grow then shrink a running allocation."""
    g = build_cluster(nodes=4)
    sched = SchedulerInstance("L0", g)
    sched.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32), "job")
    assert len(sched.allocations["job"].paths) == 35
    sched.match_grow(Jobspec.hpc(nodes=2, sockets=4, cores=64), "job")
    assert len(sched.allocations["job"].paths) == 35 * 3
    victims = sched.allocations["job"].paths[-35:]
    sched.match_shrink("job", victims, remove_vertices=False)
    sched.release("job", victims)
    assert len(sched.allocations["job"].paths) == 35 * 2
    assert g.validate_tree()


def test_capability_2_external_integration():
    """Cloud bursting: fleet resources chosen BY THE PROVIDER integrate
    into the running allocation with zone placement info."""
    g = build_cluster(nodes=1)
    sched = SchedulerInstance("top", g,
                              external=SimulatedEC2Provider(seed=3))
    sched.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32), "job")
    sub = sched.match_grow(Jobspec.fleet(10), "job")
    assert sub
    zones = {sched.graph.vertex(n).properties.get("zone")
             for n in sched.graph.by_type("node")
             if sched.graph.vertex(n).properties.get("provider") == "aws"}
    assert len(zones) >= 2  # location-aware integration
    assert g.validate_tree()


def test_capability_3_orchestrator_tasks():
    """KubeFlux-style: schedule many pod-sized tasks via MA, then scale
    the set elastically via MG."""
    g = build_cluster(nodes=8, sockets_per_node=2, cores_per_socket=20)
    sched = SchedulerInstance("kubeflux", g)
    pod_req = Jobspec(resources=[ResourceReq("core", 4)])
    pods = []
    for i in range(10):
        a = sched.match_allocate(pod_req, jobid=f"pod-{i}")
        assert a is not None
        pods.append(a)
    replicaset = sched.match_allocate(pod_req, jobid="rs")
    for _ in range(9):
        assert sched.match_grow(pod_req, "rs")
    assert len(sched.allocations["rs"].paths) == 40
    assert g.validate_tree()


def test_combined_all_three():
    """The paper's thesis: all three combined in one scenario — a nested
    job grows locally, exhausts the cluster, bursts to the cloud, then
    shrinks back."""
    graphs = [build_cluster(nodes=2), build_cluster(nodes=1)]
    h = build_chain(graphs, external=SimulatedEC2Provider())
    try:
        leaf = h.leaf
        leaf.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32), "j")
        # local growth through the hierarchy
        assert leaf.match_grow(
            Jobspec.hpc(nodes=1, sockets=2, cores=32), "j")
        # cluster exhausted -> top level bursts via ExternalAPI
        h.top.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32),
                             "hog")
        sub = leaf.match_grow(Jobspec.instances("t2.2xlarge", 1), "j")
        assert sub
        assert any("t2-2xlarge" in p for p in leaf.graph.paths())
        # shrink the external part back out
        ext = [p for p in sub.paths() if "t2-2xlarge" in p]
        leaf.match_shrink("j", ext, remove_vertices=True)
        assert all(p not in leaf.graph for p in ext)
        assert leaf.graph.validate_tree()
    finally:
        h.close()
