"""Job lifecycle queue tests: states, ordering, timed release, EASY
backfill over the pruning aggregates, and grow escalation.

The twin of tests/test_queue.py on ``repro_torch.core``, the port's copy
of the control plane: only the imports are rewritten."""
import functools

import pytest

from repro_torch.core import (JobQueue, JobState, Jobspec, SchedulerInstance,
                              SimClock, SimulatedEC2Provider, WallClock,
                              build_chain, build_cluster)

# the port's graphs take the device of their flat mirror; these run on the CPU
build_cluster = functools.partial(build_cluster, device="cpu")


def _queue(nodes=2, backfill=True, allow_grow=False, external=False):
    g = build_cluster(nodes=nodes)
    prov = SimulatedEC2Provider(seed=1) if external else None
    sched = SchedulerInstance("q", g, external=prov)
    return JobQueue(sched, clock=SimClock(), backfill=backfill,
                    allow_grow=allow_grow)


NODE = Jobspec.hpc(nodes=1, sockets=2, cores=32)


def test_job_states_and_timed_release():
    q = _queue(nodes=1)
    job = q.submit(NODE, walltime=10.0)
    assert job.state is JobState.PENDING
    q.step()
    assert job.state is JobState.RUNNING
    assert job.start_time == 0.0 and job.end_time == 10.0
    # resources held while running
    g = q.scheduler.graph
    assert g.vertex(g.roots[0]).agg_free.get("node", 0) == 0
    q.advance(10.0)
    assert job.state is JobState.COMPLETED
    # timed release freed everything (set_free through release)
    assert g.vertex(g.roots[0]).agg_free["node"] == 1
    assert g.validate_tree()


def test_fcfs_within_priority_and_priority_wins():
    q = _queue(nodes=1, backfill=False)
    a = q.submit(NODE, walltime=5.0, priority=0)
    q.step()
    assert a.state is JobState.RUNNING
    b = q.submit(NODE, walltime=5.0, priority=0)
    c = q.submit(NODE, walltime=5.0, priority=7)
    # after a ends, priority beats FCFS: c runs before the earlier b
    q.advance(5.0)
    assert c.state is JobState.RUNNING and b.state is JobState.PENDING
    q.advance(5.0)
    assert b.state is JobState.RUNNING
    q.advance(5.0)
    assert all(j.state is JobState.COMPLETED for j in (a, b, c))


def test_queue_drain_completes_everything():
    q = _queue(nodes=2)
    jobs = [q.submit(NODE, walltime=float(5 + i)) for i in range(6)]
    done = q.drain()
    assert len(done) == 6
    assert all(j.state is JobState.COMPLETED for j in jobs)
    assert q.scheduler.graph.validate_tree()
    s = q.stats()
    assert s.completed == 6 and s.pending == 0
    assert s.utilization > 0


def test_easy_backfill_does_not_delay_head():
    """Small jobs jump a blocked wide job only if they end before the
    head's shadow time; an over-long candidate must wait."""
    q = _queue(nodes=2)
    hog = q.submit(NODE, walltime=100.0)
    q.step()
    wide = q.submit(Jobspec.hpc(nodes=2, sockets=4, cores=64),
                    walltime=10.0, priority=5)
    short = q.submit(Jobspec.hpc(nodes=0, sockets=1, cores=8),
                     walltime=20.0)
    long_ = q.submit(Jobspec.hpc(nodes=0, sockets=1, cores=8),
                     walltime=500.0)
    q.step()
    assert wide.state is JobState.PENDING
    assert short.state is JobState.RUNNING      # fits + ends by t=100
    assert long_.state is JobState.PENDING      # would delay the head
    q.advance(100.0)
    assert wide.state is JobState.RUNNING
    assert wide.start_time == 100.0             # exactly the reservation
    q.drain()
    assert long_.state is JobState.COMPLETED


def test_backfill_disabled_is_strict_fifo():
    q = _queue(nodes=2, backfill=False)
    q.submit(NODE, walltime=100.0)
    q.step()
    q.submit(Jobspec.hpc(nodes=2, sockets=4, cores=64), walltime=10.0)
    short = q.submit(Jobspec.hpc(nodes=0, sockets=1, cores=8),
                     walltime=1.0)
    q.step()
    assert short.state is JobState.PENDING


def test_cancel_pending_and_running():
    q = _queue(nodes=1)
    a = q.submit(NODE, walltime=50.0)
    b = q.submit(NODE, walltime=50.0)
    q.step()
    assert q.cancel(b.jobid) and b.state is JobState.CANCELLED
    assert q.cancel(a.jobid) and a.state is JobState.CANCELLED
    g = q.scheduler.graph
    assert g.vertex(g.roots[0]).agg_free["node"] == 1
    assert not q.cancel(a.jobid)                # already finished


def test_grow_escalation_through_hierarchy():
    """allow_grow: a job too big for the leaf pulls resources down the
    chain, and its timed release pushes them back up (match_shrink)."""
    h = build_chain([build_cluster(nodes=4), build_cluster(nodes=1)],
                    socket_levels=[1])
    try:
        leaf = h.leaf
        clock = SimClock()
        q = JobQueue(leaf, clock=clock, allow_grow=True)
        local = q.submit(NODE, walltime=5.0)
        big = q.submit(Jobspec.hpc(nodes=2, sockets=4, cores=64),
                       walltime=5.0)
        q.step()
        assert local.state is JobState.RUNNING and local.via == "local"
        assert big.state is JobState.RUNNING and big.via == "parent"
        assert len(leaf.graph.by_type("node")) == 3   # 1 local + 2 grown
        q.advance(5.0)
        assert big.state is JobState.COMPLETED
        # spliced-in vertices removed at the leaf, freed at the parent
        assert len(leaf.graph.by_type("node")) == 1
        freed = [p for p in big.paths if p in h.top.graph]
        assert freed and all(not h.top.graph.vertex(p).allocations
                             for p in freed)
        assert leaf.graph.validate_tree() and h.top.graph.validate_tree()
    finally:
        h.close()


def test_external_burst_rides_the_queue():
    q = _queue(nodes=1, allow_grow=True, external=True)
    a = q.submit(NODE, walltime=10.0)
    burst = q.submit(Jobspec.instances("t2.2xlarge", 2), walltime=10.0)
    q.step()
    assert a.via == "local" and burst.via == "external"
    assert q.scheduler.external_paths
    q.advance(10.0)
    # external vertices evaporate on release (E_i = G_i \ G_0)
    assert not q.scheduler.external_paths
    assert q.scheduler.graph.validate_tree()


def test_wait_time_stats():
    q = _queue(nodes=1)
    a = q.submit(NODE, walltime=10.0)
    b = q.submit(NODE, walltime=10.0)
    q.drain()
    assert a.wait_time == 0.0
    assert b.wait_time == 10.0
    s = q.stats()
    assert s.mean_wait == pytest.approx(5.0)
    assert s.max_wait == pytest.approx(10.0)


def test_wallclock_queue_smoke():
    g = build_cluster(nodes=1)
    q = JobQueue(SchedulerInstance("w", g), clock=WallClock())
    job = q.submit(NODE, walltime=0.0)
    q.step()
    q.step()    # 0-walltime job completes on the next observation
    assert job.state is JobState.COMPLETED


def test_allow_grow_false_never_escalates_shared_alloc():
    """The allow_grow gate holds even for jobs sharing an alloc_id:
    no cloud bursting, strictly local MA (regression test)."""
    q = _queue(nodes=1, allow_grow=False, external=True)
    a = q.submit(Jobspec.hpc(nodes=0, sockets=1, cores=16),
                 walltime=10.0, alloc_id="shared")
    b = q.submit(Jobspec.hpc(nodes=0, sockets=1, cores=16),
                 walltime=10.0, alloc_id="shared")
    c = q.submit(Jobspec.hpc(nodes=0, sockets=1, cores=16),
                 walltime=10.0, alloc_id="shared")
    q.step()
    assert a.state is JobState.RUNNING and b.state is JobState.RUNNING
    assert c.state is JobState.PENDING          # 2 sockets: no 3rd, no burst
    assert not q.scheduler.external_paths
    # each job owns only its own slice of the shared allocation
    assert len(a.paths) == 17 and len(b.paths) == 17
    assert not (set(a.paths) & set(b.paths))
    # per-job override: c may escalate explicitly (mutating a pending
    # job from outside the queue API needs a kick)
    c.grow = True
    q.kick()
    q.step()
    assert c.state is JobState.RUNNING and c.via == "external"


def test_dispatch_bypasses_blocked_head():
    q = _queue(nodes=2)
    q.submit(Jobspec.hpc(nodes=10, sockets=20, cores=320), walltime=5.0)
    q.step()
    job = q.dispatch(Jobspec.hpc(nodes=1, sockets=2, cores=32),
                     walltime=5.0)
    assert job.state is JobState.RUNNING


def test_sibling_reclaimed_resources_survive_release():
    """Finishing a job whose resources came from a sibling subtree must
    free them into the instance's pool — not destroy them (regression:
    _finish used to remove vertices that were never spliced in)."""
    from repro_torch.core import TreeSpec, build_tree
    root_g = build_cluster(nodes=2)
    a_g = root_g.extract([p for p in root_g.paths() if "node0" in p])
    b_g = root_g.extract([p for p in root_g.paths() if "node1" in p])
    h = build_tree(TreeSpec(root_g, name="root",
                            children=[TreeSpec(a_g, name="A"),
                                      TreeSpec(b_g, name="B")]))
    try:
        root = h["root"]
        size_before = root.graph.num_vertices
        # root's own pool empty: everything delegated
        root.graph.set_allocated(
            [p for p in root.graph.paths() if "/node" in p], "delegated")
        q = JobQueue(root, clock=SimClock(), allow_grow=True)
        job = q.submit(NODE, walltime=5.0)
        q.step()
        assert job.state is JobState.RUNNING
        assert job.via.startswith("sibling:")
        q.advance(5.0)
        assert job.state is JobState.COMPLETED
        # the reclaimed vertices are still in the cluster, now free
        assert root.graph.num_vertices == size_before
        assert all(not root.graph.vertex(p).allocations for p in job.paths)
        assert root.graph.validate_tree()
    finally:
        h.close()


def test_release_propagates_through_three_levels():
    """Timed release of a grow matched at L0 must travel the whole
    chain bottom-up: L2 removes its spliced copies, L1 removes its
    pass-through copies, L0 frees the matched vertices (regression:
    release used to stop after one hop, leaking L0 capacity)."""
    graphs = [build_cluster(nodes=4, node_prefix="l0n"),
              build_cluster(nodes=2, node_prefix="l1n"),
              build_cluster(nodes=1, node_prefix="l2n")]
    h = build_chain(graphs, socket_levels=[1])
    try:
        top, mid, leaf = h.instances
        # leaf and mid exhausted: the grow must match at the top
        leaf.match_allocate(Jobspec.hpc(nodes=1, sockets=2, cores=32),
                            jobid="hog-leaf")
        mid.match_allocate(Jobspec.hpc(nodes=2, sockets=4, cores=64),
                           jobid="hog-mid")
        q = JobQueue(leaf, clock=SimClock(), allow_grow=True)
        job = q.submit(NODE, walltime=5.0)
        q.step()
        assert job.state is JobState.RUNNING and job.via == "parent"
        assert any(p.startswith("/cluster0/l0n") for p in job.paths)
        q.advance(5.0)
        assert job.state is JobState.COMPLETED
        # L0: matched vertices freed (not leaked as allocated)
        for p in job.paths:
            assert p in top.graph
            assert not top.graph.vertex(p).allocations, p
        # L1 and L2: pass-through copies removed again
        assert all(p not in mid.graph for p in job.paths)
        assert all(p not in leaf.graph for p in job.paths)
        for inst in h.instances:
            assert inst.graph.validate_tree(), inst.name
        # a second identical job can reuse the same L0 capacity
        job2 = q.submit(NODE, walltime=5.0)
        q.step()
        assert job2.state is JobState.RUNNING and job2.via == "parent"
    finally:
        h.close()


def test_cancelled_pending_jobs_do_not_accumulate():
    q = _queue(nodes=1)
    q.submit(NODE, walltime=1.0)
    q.step()
    for i in range(50):   # a reconciler hammering a full cluster
        j = q.submit(NODE, walltime=1.0)
        q.cancel(j.jobid)
    assert q.stats().submitted == 1
    assert len(q.pending) == 0


def test_blocked_head_not_reescalated_without_state_change():
    """An unsatisfiable head must not re-run its hierarchy escalation
    (RPCs + failure timings at every level) on every idle tick."""
    h = build_chain([build_cluster(nodes=1), build_cluster(nodes=1,
                                                          node_prefix="x")])
    try:
        leaf = h.leaf
        q = JobQueue(leaf, clock=SimClock(), allow_grow=True)
        q.submit(Jobspec.hpc(nodes=8, sockets=16, cores=256), walltime=5.0)
        q.step()
        n_after_first = len(leaf.timings) + len(h.top.timings)
        for _ in range(25):
            q.advance(1.0)      # idle ticks: nothing changed
        assert len(leaf.timings) + len(h.top.timings) == n_after_first
        # a state change (new submit / completion) re-arms scheduling
        ok = q.submit(Jobspec.hpc(nodes=1, sockets=2, cores=32),
                      walltime=1.0)
        q.step()
        assert ok.state is JobState.RUNNING
    finally:
        h.close()


def test_completed_jobs_leave_no_empty_allocations():
    q = _queue(nodes=2)
    for _ in range(10):
        q.submit(NODE, walltime=2.0)
    q.drain()
    assert q.scheduler.allocations == {}


def test_shrink_rejects_invalid_count():
    """``count <= 0`` (or no arguments at all) must be rejected before
    the slice is computed: a negative count would slice from the FRONT
    of ``job.paths`` and silently release most of the allocation — and
    this surface is remotely reachable via the RPC ``shrink`` verb."""
    q = _queue(nodes=2)
    job = q.submit(NODE, walltime=None)
    q.step()
    assert job.state is JobState.RUNNING
    n = len(job.paths)
    for bad in (-2, 0, None):
        assert not q.shrink_job(job.jobid, count=bad)
        assert len(job.paths) == n          # nothing was released
    exc = [e for e in q.eventlog.for_job(job.jobid)
           if e.type.value == "exception"]
    assert len(exc) == 3
    assert all(e.detail["reason"] == "invalid shrink count" for e in exc)
    # a positive count still shrinks
    assert q.shrink_job(job.jobid, count=1)
    assert len(job.paths) == n - 1
    assert q.scheduler.graph.validate_tree()


def test_graph_version_bumps_on_match_relevant_mutations():
    """Equal ``graph.version`` must guarantee equal match results: every
    free-flip, status-flip, and structural edit bumps it; pure reads
    and no-op mutations do not."""
    q = _queue(nodes=2)
    g = q.scheduler.graph
    v0 = g.version
    job = q.submit(NODE, walltime=5.0)
    q.step()                            # alloc: free flips -> bump
    assert job.state is JobState.RUNNING
    v1 = g.version
    assert v1 > v0
    assert g.validate_tree() and g.version == v1     # reads: no bump
    q.advance(5.0)                      # release: free flips -> bump
    assert g.version > v1
    v2 = g.version
    g.set_status(g.roots[0], "down")
    assert g.version > v2
    g.set_status(g.roots[0], "up")
    v3 = g.version
    g.set_status(g.roots[0], "up")      # no-op status: no bump
    assert g.version == v3


def test_failed_match_memo_skips_and_invalidates():
    """A job that failed to match is not re-matched until the graph
    changes; a release (or an external kick()) re-arms it."""
    q = _queue(nodes=1)
    a = q.submit(NODE, walltime=10.0)
    b = q.submit(NODE, walltime=10.0)
    q.step()
    assert a.state is JobState.RUNNING and b.state is JobState.PENDING
    g = q.scheduler.graph
    assert b.nogo_version == g.version   # memoized at current version
    # idle re-steps do not clear the memo (graph unchanged)
    q.kick()                             # kick clears it (contract:
    assert b.nogo_version is None        # out-of-band Job mutation)
    q.step()
    assert b.state is JobState.PENDING   # still does not fit
    assert b.nogo_version == g.version   # re-memoized
    q.advance(10.0)                      # a completes -> version moves
    assert b.state is JobState.RUNNING   # memo did not block the start
    q.advance(10.0)
    assert b.state is JobState.COMPLETED


def test_easy_backfill_window_bounds_candidates():
    """``EasyBackfill(max_candidates=k)`` examines at most k pending
    jobs per pass; unbounded EASY backfills deeper."""
    from repro_torch.core import EasyBackfill

    def run(max_candidates):
        g = build_cluster(nodes=2)
        sched = SchedulerInstance("w", g)
        q = JobQueue(sched, clock=SimClock(), backfill=True,
                     policy=EasyBackfill(max_candidates=max_candidates))
        # head needs both nodes and must wait for the wide job; the
        # singles behind it are backfill food
        wide = q.submit(Jobspec.hpc(nodes=2, sockets=2, cores=32),
                        walltime=5.0)
        q.step()
        assert wide.state is JobState.RUNNING
        head = q.submit(Jobspec.hpc(nodes=2, sockets=2, cores=32),
                        walltime=5.0, priority=9)
        small = Jobspec.hpc(nodes=0, sockets=1, cores=4)
        fillers = [q.submit(small, walltime=1.0) for _ in range(6)]
        q.step()
        assert head.state is JobState.PENDING
        return sum(j.state is JobState.RUNNING for j in fillers)

    assert run(max_candidates=None) > run(max_candidates=1) == 1


# ---------------------------------------------------------------------- #
# reservation ledger lifecycle (core/policy.ReservationLedger)
# ---------------------------------------------------------------------- #
def _ledger_agrees(q):
    """The ledger's entries must mirror the running set exactly: one
    entry per walltimed running job, carrying its end_time and bound
    path type counts."""
    from repro_torch.core.policy import _path_type_counts
    want = {j.jobid: (j.end_time, _path_type_counts(q, j))
            for j in q.running if j.end_time is not None}
    assert q.ledger._entries == want, (q.ledger._entries, want)


def test_ledger_tracks_start_finish_cancel():
    q = _queue(nodes=2)
    a = q.submit(NODE, walltime=10.0)
    b = q.submit(NODE, walltime=20.0)
    q.step()
    assert a.state is JobState.RUNNING and b.state is JobState.RUNNING
    _ledger_agrees(q)
    assert q.cancel(b.jobid)
    _ledger_agrees(q)
    q.advance(10.0)
    assert a.state is JobState.COMPLETED
    _ledger_agrees(q)
    assert q.ledger._entries == {}


def test_ledger_tracks_grow_and_shrink():
    q = _queue(nodes=2)
    job = q.submit(NODE, walltime=50.0)
    q.step()
    assert job.state is JobState.RUNNING
    _ledger_agrees(q)
    n = len(job.paths)
    assert q.shrink_job(job.jobid, count=4)
    assert len(job.paths) == n - 4
    _ledger_agrees(q)
    assert q.grow_job(job.jobid, Jobspec.hpc(nodes=0, sockets=1,
                                             cores=4))
    _ledger_agrees(q)
    q.drain()
    assert q.ledger._entries == {}


def test_ledger_tracks_preemption():
    from repro_torch.core import PreemptivePriority
    g = build_cluster(nodes=1)
    q = JobQueue(SchedulerInstance("lp", g), clock=SimClock(),
                 policy=PreemptivePriority())
    low = q.submit(NODE, walltime=50.0, priority=0, preemptible=True)
    q.step()
    assert low.state is JobState.RUNNING
    _ledger_agrees(q)
    hi = q.submit(NODE, walltime=10.0, priority=5)
    q.step()
    assert low.state is JobState.PREEMPTED
    assert hi.state is JobState.RUNNING
    _ledger_agrees(q)               # victim's entry gone, winner's in
    q.drain()
    assert low.state is JobState.COMPLETED
    assert q.ledger._entries == {}


def test_kick_clears_prefilter_and_backfill_memos():
    """kick()'s contract covers the new memo fields too: out-of-band
    Job mutation re-arms the prefilter and EASY skip memos alongside
    the failed-match memo."""
    q = _queue(nodes=1)
    a = q.submit(NODE, walltime=10.0)
    b = q.submit(NODE, walltime=10.0)
    q.step()
    assert b.state is JobState.PENDING
    b._pf_version, b._pf_ok = 123, False
    b._bf_version, b._bf_head = 123, 456
    q.kick()
    assert b.nogo_version is None
    assert b._pf_version is None and b._bf_version is None


# ---------------------------------------------------------------------- #
# columnar pending mirror (core/policy._PendingMirror)
# ---------------------------------------------------------------------- #
def _mirror_agrees(q):
    """Mirror live rows must equal the pending list, column for column."""
    import numpy as np
    mir = q._pmirror
    live = {}
    for i, j in enumerate(mir.jobs):
        if j is None:
            continue
        assert mir.slot[j.jobid] == i
        spec, grow, prio = mir.sig_entries[int(mir.sig[i])]
        assert spec is j.jobspec and grow == j.grow and prio == j.priority
        wt = mir.wt[i]
        assert (j.walltime is None and np.isnan(wt)) or wt == j.walltime
        assert mir.prio[i] == j.priority and mir.seq[i] == j.seq
        live[j.jobid] = j
    assert live == {j.jobid: j for j in q.pending}


def test_pending_mirror_tracks_queue_churn():
    """The columnar mirror the vectorized exact-EASY pass reads must
    stay in sync with ``queue.pending`` through every lifecycle edge:
    submit, start, cancel, preemption requeue, and kick's resync."""
    from repro_torch.core import PreemptivePriority
    g = build_cluster(nodes=1)
    q = JobQueue(SchedulerInstance("pm", g), clock=SimClock(),
                 policy=PreemptivePriority())
    low = q.submit(NODE, walltime=30.0, priority=0, preemptible=True)
    fillers = [q.submit(NODE, walltime=5.0) for _ in range(4)]
    q.submit(NODE)                   # walltime None -> NaN column
    q.step()
    _mirror_agrees(q)
    assert q.cancel(fillers[0].jobid)
    _mirror_agrees(q)
    hi = q.submit(NODE, walltime=10.0, priority=5)
    q.step()                         # preempts low -> requeued
    assert low.state is JobState.PREEMPTED
    assert hi.state is JobState.RUNNING
    _mirror_agrees(q)
    q.kick()                         # full-resync path
    _mirror_agrees(q)
    for _ in range(12):
        q.advance(10.0)
    _mirror_agrees(q)


def test_pending_mirror_compacts_tombstones():
    """Discards tombstone rather than shift; once tombstones dominate
    the mirror compacts down to the live set."""
    q = _queue(nodes=1)
    blocker = q.submit(NODE, walltime=500.0)
    q.step()
    assert blocker.state is JobState.RUNNING
    jobs = [q.submit(NODE, walltime=1.0) for _ in range(80)]
    # 80 live rows + the started blocker's tombstone
    assert q._pmirror.n == 81 and q._pmirror.holes == 1
    for j in jobs:
        assert q.cancel(j.jobid)
    _mirror_agrees(q)
    # compacted at least once; tombstone residue stays bounded
    assert q._pmirror.n < 80
    assert q._pmirror.holes <= 32 or \
        q._pmirror.holes * 2 <= q._pmirror.n
