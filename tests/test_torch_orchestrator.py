"""Orchestrator (capability 3) tests: reconcile, burst policy, autoscale.

The twin of tests/test_orchestrator.py on ``repro_torch``, the port's copy
of the control plane: only the imports are rewritten, and the graphs are built
with ``device="cpu"`` (the port's graphs take the device of their flat mirror)."""
import functools

from repro_torch.core import (Jobspec, ResourceReq, SchedulerInstance,
                              SimulatedEC2Provider, build_cluster)
from repro_torch.runtime.orchestrator import BurstPolicy, Orchestrator, ReplicaSet

# the port's graphs take the device of their flat mirror; these run on the CPU
build_cluster = functools.partial(build_cluster, device="cpu")

POD = Jobspec(resources=[ResourceReq("core", 4)])


def _sched(nodes=2, cores=8, external=False):
    g = build_cluster(nodes=nodes, sockets_per_node=2,
                      cores_per_socket=cores)
    prov = SimulatedEC2Provider(seed=5) if external else None
    return SchedulerInstance("orch", g, external=prov)


def test_reconcile_scale_up_and_down():
    orch = Orchestrator(_sched())
    rs = orch.create(ReplicaSet("web", POD, desired=4))
    assert rs.replicas == 4
    assert len(orch.scheduler.allocations[rs.jobid].paths) == 16
    rs.desired = 2
    orch.reconcile("web")
    assert rs.replicas == 2
    assert len(orch.scheduler.allocations[rs.jobid].paths) == 8
    assert orch.scheduler.graph.validate_tree()


def test_scale_up_blocked_without_burst():
    """Local cluster holds 8 pods; no provider -> stuck at 8."""
    orch = Orchestrator(_sched(nodes=2, cores=8))
    rs = orch.create(ReplicaSet("big", POD, desired=12,
                                policy=BurstPolicy(allow_burst=False)))
    assert rs.replicas == 8
    assert any("blocked" in e for e in rs.events)


def test_burst_policy_caps_external_fraction():
    orch = Orchestrator(_sched(nodes=2, cores=8, external=True))
    rs = orch.create(ReplicaSet(
        "burst", POD, desired=12,
        policy=BurstPolicy(max_external_fraction=0.25)))
    # 8 local + external capped at 25% of total
    assert rs.replicas > 8
    assert rs.external_replicas / rs.replicas <= 0.26
    assert rs.external_replicas > 0


def test_burst_unlimited_reaches_desired():
    orch = Orchestrator(_sched(nodes=1, cores=8, external=True))
    rs = orch.create(ReplicaSet(
        "elastic", POD, desired=10,
        policy=BurstPolicy(max_external_fraction=1.0)))
    assert rs.replicas == 10
    assert rs.external_replicas >= 6   # only 4 pods fit locally


def test_autoscale_up_then_down():
    orch = Orchestrator(_sched(nodes=4, cores=16))
    rs = orch.create(ReplicaSet("svc", POD, desired=2))
    orch.autoscale("svc", load=1.4, target_load=0.7)   # 2x overload
    assert rs.replicas == 4
    orch.autoscale("svc", load=0.2, target_load=0.7, min_replicas=1)
    assert rs.replicas < 4
    assert orch.scheduler.graph.validate_tree()


def test_scale_down_drains_external_first():
    orch = Orchestrator(_sched(nodes=1, cores=8, external=True))
    rs = orch.create(ReplicaSet(
        "drain", POD, desired=6,
        policy=BurstPolicy(max_external_fraction=1.0)))
    assert rs.external_replicas > 0
    ext_before = rs.external_replicas
    rs.desired = 4
    orch.reconcile("drain")
    assert rs.replicas == 4
    assert rs.external_replicas < ext_before


def test_reconcile_not_wedged_behind_blocked_queue_head():
    """A shared queue whose head is an unrelated, unsatisfiable batch
    job must not block replica scale-up (dispatch, not head-of-line)."""
    from repro_torch.core import JobQueue, SimClock
    sched = _sched(nodes=2, cores=8)
    q = JobQueue(sched, clock=SimClock(), backfill=True)
    q.submit(Jobspec.hpc(nodes=10, sockets=20, cores=160), walltime=10.0)
    q.step()    # head cannot start: 10 nodes on a 2-node cluster
    orch = Orchestrator(sched, queue=q)
    rs = orch.create(ReplicaSet("web", POD, desired=3))
    assert rs.replicas == 3
    assert len(sched.allocations[rs.jobid].paths) == 12


def test_first_replica_is_local_only():
    """The first replica is pure MATCHALLOCATE: it must not escalate
    through the hierarchy even when a parent has room."""
    from repro_torch.core import build_chain
    h = build_chain([build_cluster(nodes=2), build_cluster(nodes=1)])
    try:
        leaf = h.leaf
        # leaf fully allocated: no local room for even one pod
        leaf.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32),
                            jobid="hog")
        orch = Orchestrator(leaf)
        rs = orch.create(ReplicaSet("web", POD, desired=2))
        assert rs.replicas == 0
        assert any("blocked at 0" in e for e in rs.events)
        # later replicas MAY escalate: free the leaf, first goes local,
        # the rest grow through the parent
        leaf.release("hog")
        rs.desired = 10
        orch.reconcile("web")
        assert rs.replicas == 10
        assert any(t.level == "L0" for t in h.top.timings)
    finally:
        h.close()


def test_reconcile_after_revocation():
    """Replica jobs are preemptible: a higher-priority tenant's grow
    revokes the replica set's allocation through the hierarchy; the
    next reconcile observes the loss, drops the requeued retries, and
    rebuilds replicas against the post-revoke state."""
    from repro_torch.core import (JobState, Jobspec, MultiTenantTree,
                                  PreemptivePriority, TenantSpec)
    root_g = build_cluster(nodes=3, sockets_per_node=2,
                           cores_per_socket=8)
    a_g = root_g.extract([p for p in root_g.paths() if "node0" in p])
    b_g = root_g.extract([p for p in root_g.paths()
                          if "node1" in p or "node2" in p])
    mt = MultiTenantTree(root_g, [
        TenantSpec("A", a_g, policy=PreemptivePriority()),
        TenantSpec("B", b_g)])
    try:
        orch = Orchestrator(mt.hierarchy["B"], queue=mt.queue("B"))
        rs = orch.create(ReplicaSet("web", POD, desired=10))
        assert rs.replicas == 10        # 8 on B's nodes + 2 grown onto A
        # tenant A needs sockets back at high priority; A's free pool
        # cannot cover it, so the grow revokes the (shared, hence
        # whole) replica allocation and every replica requeues
        hi = mt.queue("A").submit(
            Jobspec.hpc(nodes=0, sockets=2, cores=8),
            walltime=5.0, priority=9)
        mt.queue("A").step()    # only A's queue: the revoke lands but
        # B's queue has not rescheduled its requeued victims yet
        assert hi.state is JobState.RUNNING
        assert not orch.queue.running_for(rs.jobid)
        # reconcile: observe, resync, rebuild what fits around the
        # high-priority tenant's allocation
        orch.reconcile("web")
        assert any(e.startswith("revoked:") for e in rs.events)
        assert 0 < rs.replicas < 10
        # once A's job finishes, the next reconcile restores 10
        mt.advance(5.0)
        assert hi.state is JobState.COMPLETED
        orch.reconcile("web")
        assert rs.replicas == 10
        for inst in mt.hierarchy.instances:
            assert inst.graph.validate_tree(), inst.name
    finally:
        mt.close()


def test_revocation_survives_journal_truncation():
    """If reconcile falls more than ``maxlen`` events behind, the
    bounded journal drops PREEMPT events.  The orchestrator must
    detect the cursor gap and fall back to a full resync — cancelling
    stale PREEMPTED replicas instead of leaking them back into the
    queue (where they would later restart as untracked replicas)."""
    from repro_torch.core import (EventLog, Instance, JobQueue, JobState,
                                  PreemptivePriority, SchedulerInstance,
                                  SimClock)
    g = build_cluster(nodes=1, sockets_per_node=2, cores_per_socket=8)
    sched = SchedulerInstance("orch", g)
    clock = SimClock()
    q = JobQueue(sched, clock=clock, policy=PreemptivePriority(),
                 eventlog=EventLog(clock=clock, maxlen=16))
    inst = Instance(queue=q)
    # follow=False forces cursor replay (the push stream would observe
    # the PREEMPTs live and never need the truncation fallback)
    orch = Orchestrator(inst, follow=False)
    rs = orch.create(ReplicaSet("web", POD, desired=3))
    assert rs.replicas == 3
    # a high-priority job preempts every (preemptible) replica; with
    # the single node taken they stay PREEMPTED in the pending queue
    hi = inst.submit(Jobspec.hpc(nodes=1, sockets=2, cores=16),
                     walltime=5.0, priority=9)
    inst.step()
    assert hi.state is JobState.RUNNING
    assert len(inst.pending(rs.jobid)) == 3
    # flood the journal well past maxlen so the PREEMPTs are dropped
    for i in range(20):
        inst.submit(POD, jobid=f"noise-{i}").cancel()
    events, _ = inst.events_since(0)
    assert all(e.type.value != "preempt" for e in events)
    # reconcile detects the truncated cursor and resyncs anyway
    orch.reconcile("web")
    assert any(e.startswith("revoked:") for e in rs.events)
    assert rs.replicas == 0                 # nothing fits around hi
    assert inst.pending(rs.jobid) == []     # stale retries cancelled
    # once hi finishes the next reconcile rebuilds exactly desired
    inst.advance(5.0)
    assert hi.state is JobState.COMPLETED
    orch.reconcile("web")
    assert rs.replicas == 3
    assert len(inst.running(rs.jobid)) == 3


def test_push_mode_observes_revocation_without_replay():
    """Following the push stream (default), PREEMPTs are buffered by
    the live subscription and reconcile drains the buffer — the
    journal is never scanned (verified against a journal too small to
    retain the PREEMPTs)."""
    from repro_torch.core import (EventLog, Instance, JobQueue, JobState,
                                  PreemptivePriority, SchedulerInstance,
                                  SimClock)
    g = build_cluster(nodes=1, sockets_per_node=2, cores_per_socket=8)
    clock = SimClock()
    q = JobQueue(SchedulerInstance("orch", g), clock=clock,
                 policy=PreemptivePriority(),
                 eventlog=EventLog(clock=clock, maxlen=16))
    inst = Instance(queue=q)
    orch = Orchestrator(inst)           # follow=True
    rs = orch.create(ReplicaSet("web", POD, desired=3))
    hi = inst.submit(Jobspec.hpc(nodes=1, sockets=2, cores=16),
                     walltime=5.0, priority=9)
    inst.step()
    assert hi.state is JobState.RUNNING
    # flood the journal so replay could NOT see the PREEMPTs; the
    # live subscription already buffered them
    for i in range(20):
        inst.submit(POD, jobid=f"noise-{i}").cancel()
    assert len(orch._pushed) >= 3
    orch.reconcile("web")
    assert rs.replicas == 0
    assert inst.pending(rs.jobid) == []


def test_detach_reattach_covers_the_gap():
    """A detached follower misses live events; reattach replays the
    gap from the saved cursor, and the seen-list dedup makes the
    replay/push overlap idempotent."""
    from repro_torch.core import (Instance, JobState, PreemptivePriority,
                                  SchedulerInstance, SimClock, JobQueue)
    g = build_cluster(nodes=1, sockets_per_node=2, cores_per_socket=8)
    q = JobQueue(SchedulerInstance("orch", g), clock=SimClock(),
                 policy=PreemptivePriority())
    inst = Instance(queue=q)
    orch = Orchestrator(inst)
    rs = orch.create(ReplicaSet("web", POD, desired=3))
    orch.detach()                       # "connection lost"
    hi = inst.submit(Jobspec.hpc(nodes=1, sockets=2, cores=16),
                     walltime=5.0, priority=9)
    inst.step()
    assert hi.state is JobState.RUNNING
    assert len(orch._pushed) == 0       # nothing arrived while detached
    orch.reattach()                     # replay covers the gap
    orch.reconcile("web")
    assert rs.replicas == 0
    assert inst.pending(rs.jobid) == []
    # stream is live again: new PREEMPTs arrive by push
    inst.advance(5.0)
    orch.reconcile("web")
    assert rs.replicas == 3


def test_revoked_records_pruned_for_removed_replica_sets():
    """PREEMPT records for a replica set that was deleted must not
    accumulate in ``_revoked`` forever."""
    from repro_torch.core import EventType
    orch = Orchestrator(_sched(nodes=1, cores=8))
    orch.create(ReplicaSet("web", POD, desired=1))
    orch.api.events.emit(EventType.PREEMPT, "rs-web-r0",
                         alloc_id="rs-web")
    orch._drain_events()
    assert "rs-web" in orch._revoked
    del orch.replica_sets["web"]
    orch._drain_events()
    assert "rs-web" not in orch._revoked
