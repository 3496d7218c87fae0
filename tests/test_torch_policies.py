"""Scheduling-policy layer tests: ordering, reservation semantics
(conservative vs EASY vs firstfit), preempt/requeue round-trip
invariants, and multi-tenant fair-share arbitration.

The twin of tests/test_policies.py on ``repro_torch.core``, the port's copy
of the control plane: only the imports are rewritten, the graphs are built with
``device="cpu"`` (the port's graphs take the device of their flat mirror),
and the traces of ``benchmarks/trace_replay.py`` carry the port's
``Jobspec`` (``_trace``) and replay through the port's ``Instance``
(``_replay_policy``)."""
import functools
import sys
import time
from pathlib import Path

import pytest

from repro_torch.core import (ConservativeBackfill, EasyBackfill, FCFS,
                              FairShareArbiter, FirstFit, JobQueue, JobState,
                              Jobspec, MultiTenantTree, PreemptivePriority,
                              PriorityFCFS, SchedulerInstance, SimClock,
                              TenantSpec, build_cluster, make_policy)

# the port's graphs take the device of their flat mirror; these run on the CPU
build_cluster = functools.partial(build_cluster, device="cpu")

NODE = Jobspec.hpc(nodes=1, sockets=2, cores=32)
SOCKET8 = Jobspec.hpc(nodes=0, sockets=1, cores=8)


def _trace(name, *args, **kw):
    """``benchmarks.trace_replay``'s trace generator ``name`` with each
    jobspec rebuilt as the port's ``Jobspec`` (one object per shape, as
    the generator interns them)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import benchmarks.trace_replay as tr

    specs = {}
    return [{**e, "jobspec": specs.setdefault(
        id(e["jobspec"]), Jobspec.from_dict(e["jobspec"].to_dict()))}
        for e in getattr(tr, name)(*args, **kw)]


def _replay_policy(policy_name, trace, nodes=4):
    """``benchmarks.trace_replay.replay_policy`` on the port's
    ``Instance``: one policy over one trace on a single over-subscribed
    instance, with the same checks; the rows the test reads."""
    from repro_torch.core import Instance
    g = build_cluster(nodes=nodes)
    clock = SimClock()
    inst = Instance(graph=g, name=f"pc-{policy_name}", clock=clock,
                    policy=make_policy(policy_name))
    t0 = time.perf_counter()
    for entry in trace:
        inst.advance(max(entry["arrival"] - clock.now(), 0.0))
        inst.submit(entry["jobspec"], walltime=entry["walltime"],
                    priority=entry["priority"],
                    preemptible=entry["preemptible"])
        inst.step()
    completed = inst.drain()
    s = inst.stats()
    assert s.completed == s.submitted, policy_name
    assert inst.scheduler.allocations == {}, policy_name
    assert g.validate_tree(), policy_name
    hi = [j.wait_time for j in completed if j.priority > 0]
    return {"completed": s.completed, "preemptions": s.preemptions,
            "wait_hi_mean_s": sum(hi) / len(hi) if hi else 0.0,
            "replay_wall_s": time.perf_counter() - t0}


def _queue(nodes=2, policy=None, allow_grow=False):
    g = build_cluster(nodes=nodes)
    sched = SchedulerInstance("p", g)
    return JobQueue(sched, clock=SimClock(), policy=policy,
                    allow_grow=allow_grow)


def test_make_policy_registry():
    for name in ("fcfs", "priority-fcfs", "easy", "conservative",
                 "firstfit", "preempt"):
        assert make_policy(name).name == name
    with pytest.raises(ValueError, match="unknown scheduling policy"):
        make_policy("lottery")


def test_fcfs_ignores_priority():
    q = _queue(nodes=1, policy=FCFS())
    a = q.submit(NODE, walltime=5.0, priority=0)
    q.step()
    b = q.submit(NODE, walltime=5.0, priority=0)
    c = q.submit(NODE, walltime=5.0, priority=7)
    q.advance(5.0)
    # strict arrival order: b before the higher-priority c
    assert b.state is JobState.RUNNING and c.state is JobState.PENDING
    q.drain()
    assert all(j.state is JobState.COMPLETED for j in (a, b, c))


def test_priority_fcfs_orders_by_priority():
    q = _queue(nodes=1, policy=PriorityFCFS())
    a = q.submit(NODE, walltime=5.0, priority=0)
    q.step()
    b = q.submit(NODE, walltime=5.0, priority=0)
    c = q.submit(NODE, walltime=5.0, priority=7)
    q.advance(5.0)
    assert c.state is JobState.RUNNING and b.state is JobState.PENDING
    assert a.state is JobState.COMPLETED


# ---------------------------------------------------------------------- #
# reservation semantics: EASY vs conservative vs firstfit
# ---------------------------------------------------------------------- #
def _blocked_head_setup(policy):
    """1 node held for 100s; a 2-node head blocked behind it."""
    q = _queue(nodes=2, policy=policy)
    hog = q.submit(NODE, walltime=100.0)
    q.step()
    assert hog.state is JobState.RUNNING
    head = q.submit(Jobspec.hpc(nodes=2, sockets=2, cores=16),
                    walltime=10.0, priority=5)
    return q, hog, head


@pytest.mark.parametrize("policy,starts", [
    # refined EASY admits spare-capacity jobs like conservative does
    (make_policy("easy"), True),
    (make_policy("conservative"), True),
    # strict single-shadow EASY (pre-refinement) still refuses them
    (EasyBackfill(spare_capacity=False), False),
])
def test_long_spare_capacity_candidate(policy, starts):
    """A 500s socket job on genuinely spare capacity: strict EASY's
    single shadow rule rejects it; refined EASY proves (via a one-job
    reservation profile) that it cannot touch the head's reservation
    and admits it, exactly like conservative — and in every case the
    head still starts exactly at its reservation."""
    q, hog, head = _blocked_head_setup(policy)
    cand = q.submit(SOCKET8, walltime=500.0)
    q.step()
    assert (cand.state is JobState.RUNNING) == starts
    q.advance(100.0)
    assert head.state is JobState.RUNNING
    assert head.start_time == 100.0     # reservation never delayed
    q.drain()
    assert cand.state is JobState.COMPLETED


def test_easy_refinement_refuses_reservation_toucher():
    """Refined EASY is not firstfit: a wide 500s candidate that would
    consume the head's shadow-time credit is still refused."""
    q, hog, head = _blocked_head_setup(make_policy("easy"))
    cand = q.submit(NODE, walltime=500.0)
    q.step()
    assert cand.state is JobState.PENDING
    q.advance(100.0)
    assert head.state is JobState.RUNNING
    assert head.start_time == 100.0


def test_easy_vs_conservative_admission_on_contended_trace():
    """Regression on the existing contended trace: refined EASY admits
    strictly more backfills than strict EASY (the spare-capacity rule
    has real bite under contention), every variant completes the whole
    trace leak-free, and conservative remains at least as permissive in
    total admissions as refined EASY's head-only rule."""

    def replay(policy):
        q = JobQueue(SchedulerInstance("tr", build_cluster(nodes=4)),
                     clock=SimClock(), policy=policy)
        for e in _trace("make_contended_trace", 150, seed=3):
            q.advance(max(e["arrival"] - q.clock.now(), 0.0))
            q.submit(e["jobspec"], walltime=e["walltime"],
                     priority=e["priority"],
                     preemptible=e["preemptible"])
            q.step()
        q.drain()
        s = q.stats()
        assert s.completed == s.submitted
        assert q.scheduler.allocations == {}
        assert q.scheduler.graph.validate_tree()
        backfills = sum(1 for line in q.events if " backfill " in line)
        return backfills, s

    bf_refined, s_refined = replay(make_policy("easy"))
    bf_strict, s_strict = replay(EasyBackfill(spare_capacity=False))
    bf_cons, s_cons = replay(make_policy("conservative"))
    assert bf_refined > bf_strict, (bf_refined, bf_strict)
    # conservative protects EVERY queued reservation, so it admits
    # fewer spare-capacity jumps than the head-only rule; strict EASY
    # (shadow cut-off only) trails both
    assert bf_refined >= bf_cons >= bf_strict, \
        (bf_refined, bf_cons, bf_strict)
    # the extra admissions paid off on this trace (deterministic seed)
    assert s_refined.mean_wait <= s_strict.mean_wait


def test_firstfit_delays_head_for_utilization():
    """firstfit has no reservations: a 500s wide job jumps the queue
    and the head's start slips past the hog's end."""
    q, hog, head = _blocked_head_setup(FirstFit())
    cand = q.submit(NODE, walltime=500.0)
    q.step()
    assert cand.state is JobState.RUNNING
    q.advance(100.0)
    assert head.state is JobState.PENDING   # still blocked by cand
    q.drain()
    assert head.state is JobState.COMPLETED
    assert head.start_time > 100.0


def test_conservative_refuses_delaying_candidate():
    """The same wide 500s candidate conservative must refuse: running
    it would push the head's reservation from t=100 to t=500."""
    q, hog, head = _blocked_head_setup(ConservativeBackfill())
    cand = q.submit(NODE, walltime=500.0)
    q.step()
    assert cand.state is JobState.PENDING
    q.advance(100.0)
    assert head.state is JobState.RUNNING
    assert head.start_time == 100.0


def test_easy_unchanged_as_default():
    """The queue default is still priority+EASY (regression guard)."""
    q = JobQueue(SchedulerInstance("d", build_cluster(nodes=1)),
                 clock=SimClock())
    assert isinstance(q.policy, EasyBackfill)
    q2 = JobQueue(SchedulerInstance("d2", build_cluster(nodes=1)),
                  clock=SimClock(), backfill=False)
    assert isinstance(q2.policy, PriorityFCFS)
    assert not isinstance(q2.policy, EasyBackfill)


# ---------------------------------------------------------------------- #
# preemption: intra-queue and cross-tenant
# ---------------------------------------------------------------------- #
def test_preempt_requeue_roundtrip_invariants():
    """PREEMPTED -> PENDING -> RUNNING -> COMPLETED, with no leaked
    allocation at any point and full accounting in QueueStats."""
    q = _queue(nodes=1, policy=PreemptivePriority())
    g = q.scheduler.graph
    low = q.submit(NODE, walltime=50.0, priority=0, preemptible=True)
    q.step()
    assert low.state is JobState.RUNNING
    hi = q.submit(NODE, walltime=10.0, priority=5)
    q.step()
    assert hi.state is JobState.RUNNING and hi.start_time == 0.0
    assert low.state is JobState.PREEMPTED
    assert low.preemptions == 1 and low.paths == []
    # no vertex anywhere still bound to the victim's alloc_id
    assert not any(low.alloc_id in v.allocations for v in g.vertices())
    assert low.alloc_id not in q.scheduler.allocations
    q.advance(10.0)
    assert hi.state is JobState.COMPLETED
    q.drain()
    assert low.state is JobState.COMPLETED      # victim completes
    assert low.requeue_wait == pytest.approx(10.0)
    s = q.stats()
    assert s.preemptions == 1 and s.preempted_jobs == 1
    assert s.mean_requeue_wait == pytest.approx(10.0)
    assert q.scheduler.allocations == {}
    assert g.validate_tree()


def test_preempt_spares_higher_and_equal_priority():
    q = _queue(nodes=2, policy=PreemptivePriority())
    same = q.submit(NODE, walltime=50.0, priority=5, preemptible=True)
    protected = q.submit(NODE, walltime=50.0, priority=0,
                         preemptible=False)
    q.step()
    hi = q.submit(NODE, walltime=10.0, priority=5)
    q.step()
    # equal priority and non-preemptible jobs are both untouchable
    assert same.state is JobState.RUNNING
    assert protected.state is JobState.RUNNING
    assert hi.state is JobState.PENDING


def test_preempt_skips_non_contributing_victims():
    """A victim whose vertices cannot close the head's deficit must
    not be evicted: the gpu-only job sorts first among candidates but
    contributes nothing toward a node/socket/core shortfall, so the
    node hog is the one displaced."""
    from repro_torch.core import ResourceReq
    g = build_cluster(nodes=1, gpus_per_socket=2)
    q = JobQueue(SchedulerInstance("p", g), clock=SimClock(),
                 policy=PreemptivePriority())
    gpu_job = q.submit(Jobspec(resources=[ResourceReq("gpu", 2)]),
                       walltime=50.0, priority=0, preemptible=True)
    node_hog = q.submit(NODE, walltime=50.0, priority=1,
                        preemptible=True)
    q.step()
    assert all(j.state is JobState.RUNNING for j in (gpu_job, node_hog))
    head = q.submit(NODE, walltime=5.0, priority=9)
    q.step()
    assert head.state is JobState.RUNNING
    assert node_hog.state is JobState.PREEMPTED
    # lower priority, sorts first as a candidate — but owns only gpu
    # vertices, none of which the head requests: it must keep running
    assert gpu_job.state is JobState.RUNNING


def test_reservation_profile_uncoverable_job_does_not_corrupt_pool():
    """A pending job the profile can never cover must not pre-credit
    future releases into the pool for the jobs behind it."""
    from repro_torch.core.policy import reservation_profile
    q = _queue(nodes=1)
    running = q.submit(NODE, walltime=100.0)
    q.step()
    assert running.state is JobState.RUNNING
    impossible = q.submit(Jobspec.hpc(nodes=8, sockets=16, cores=256),
                          walltime=10.0)
    coverable = q.submit(NODE, walltime=10.0)
    prof = reservation_profile(q, [impossible, coverable])
    assert prof[impossible.jobid] is None
    # without the copy-scan fix this reads 0.0 (reservable "now")
    assert prof[coverable.jobid] == pytest.approx(100.0)


def test_shared_alloc_meta_resyncs_when_jobs_leave():
    """A finished high-priority job must stop pinning the shared
    allocation's priority/preemptible flags (revocability)."""
    q = _queue(nodes=1)
    hi = q.submit(SOCKET8, walltime=5.0, priority=9, alloc_id="shared",
                  preemptible=True)
    lo = q.submit(SOCKET8, walltime=50.0, priority=0, alloc_id="shared",
                  preemptible=True)
    q.step()
    alloc = q.scheduler.allocations["shared"]
    assert alloc.priority == 9
    q.advance(5.0)                  # hi completes, lo keeps running
    assert hi.state is JobState.COMPLETED
    assert lo.state is JobState.RUNNING
    assert alloc.priority == 0      # resynced to the surviving job
    assert alloc.preemptible


def _two_tenants(wa=1.0, wb=1.0, socket=False):
    root_g = build_cluster(nodes=2)
    a_g = root_g.extract([p for p in root_g.paths() if "node0" in p])
    b_g = root_g.extract([p for p in root_g.paths() if "node1" in p])
    return MultiTenantTree(root_g, [
        TenantSpec("A", a_g, weight=wa, policy=PreemptivePriority(),
                   socket=socket),
        TenantSpec("B", b_g, weight=wb, socket=socket)])


@pytest.mark.parametrize("socket", [False, True])
def test_cross_tenant_revoke_and_requeue(socket):
    """Tenant B overflows onto A's subtree; A's high-priority grow
    revokes only the useful victim, which requeues and completes —
    over both transport regimes."""
    mt = _two_tenants(socket=socket)
    try:
        qa, qb = mt.queue("A"), mt.queue("B")
        b1 = qb.submit(NODE, walltime=100.0, preemptible=True)
        b2 = qb.submit(NODE, walltime=100.0, preemptible=True)
        mt.step()
        assert {b1.state, b2.state} == {JobState.RUNNING}
        a1 = qa.submit(NODE, walltime=10.0, priority=5)
        mt.step()
        assert a1.state is JobState.RUNNING
        states = {b1.state, b2.state}
        assert states == {JobState.PREEMPTED, JobState.RUNNING}
        victim = b1 if b1.state is JobState.PREEMPTED else b2
        # graph invariant: the revoked jobid owns nothing at ANY level
        for inst in mt.hierarchy.instances:
            assert not any(victim.alloc_id in v.allocations
                           for v in inst.graph.vertices()), inst.name
        mt.advance(10.0)
        mt.drain()
        assert a1.state is JobState.COMPLETED
        assert b1.state is JobState.COMPLETED
        assert b2.state is JobState.COMPLETED   # victim completed too
        for inst in mt.hierarchy.instances:
            assert inst.graph.validate_tree(), inst.name
            assert not any(a.paths for a in inst.allocations.values()), \
                inst.name
    finally:
        mt.close()


def test_fair_share_arbiter_blocks_overserved_tenant():
    """With equal weights and equal usage, neither tenant may preempt
    the other; tripling A's weight flips the decision."""
    for wa, expect in ((1.0, False), (3.0, True)):
        mt = _two_tenants(wa=wa)
        try:
            qa, qb = mt.queue("A"), mt.queue("B")
            mine = qa.submit(NODE, walltime=100.0, priority=9)
            theirs = qb.submit(NODE, walltime=100.0, preemptible=True)
            mt.step()
            assert mine.state is JobState.RUNNING
            assert theirs.state is JobState.RUNNING
            # both tenants fully busy; A asks for MORE at high priority
            more = qa.submit(NODE, walltime=5.0, priority=9)
            mt.step()
            assert (more.state is JobState.RUNNING) == expect, wa
            assert (theirs.state is JobState.PREEMPTED) == expect, wa
            mt.drain()
            for inst in mt.hierarchy.instances:
                assert inst.graph.validate_tree(), inst.name
        finally:
            mt.close()


def test_fair_share_arbiter_unit():
    arb = FairShareArbiter({"A": 2.0, "B": 1.0})
    usage = {"A": {"allocated": 10, "capacity": 20},
             "B": {"allocated": 10, "capacity": 20}}
    # same usage fraction, but A is entitled to twice as much
    assert arb.may_preempt("A", "B", usage)
    assert not arb.may_preempt("B", "A", usage)
    # empty tenants may always preempt busy ones
    assert arb.may_preempt("C", "B", {"B": usage["B"]})
    assert not arb.may_preempt("B", "C", {"B": usage["B"]})


# ---------------------------------------------------------------------- #
# satellite regressions
# ---------------------------------------------------------------------- #
def test_finish_is_idempotent():
    """Finishing a job twice (cancel racing a passed walltime deadline,
    stale controller references) must not double-release its paths."""
    q = _queue(nodes=1)
    g = q.scheduler.graph
    job = q.submit(NODE, walltime=10.0)
    q.step()
    clock = q.clock
    clock.set(20.0)                     # deadline passed, advance not run
    assert q.cancel(job.jobid)
    free_after = dict(g.vertex(g.roots[0]).agg_free)
    # the stale path: timed release fires on the same Job object
    q._finish(job, JobState.COMPLETED)
    q._finish(job, JobState.COMPLETED)
    assert dict(g.vertex(g.roots[0]).agg_free) == free_after
    assert job.state is JobState.CANCELLED
    assert not q.cancel(job.jobid)      # second cancel: no-op
    assert g.validate_tree()


def test_preemptive_grow_leaves_no_trace_after_drain():
    """Allocation-leak regression, extended over the revoke path: a
    burst of preempting growers against one shared pool must end with
    every instance clean."""
    mt = _two_tenants()
    try:
        qa, qb = mt.queue("A"), mt.queue("B")
        for i in range(6):
            qb.submit(SOCKET8, walltime=20.0 + i, preemptible=True)
        mt.step()
        for i in range(4):
            qa.submit(NODE, walltime=5.0, priority=5)
        mt.drain()
        for q in (qa, qb):
            assert all(j.state is JobState.COMPLETED
                       for j in q.completed)
            assert not q.pending and not q.running
        for inst in mt.hierarchy.instances:
            assert inst.graph.validate_tree(), inst.name
            assert not any(a.paths for a in inst.allocations.values()), \
                inst.name
    finally:
        mt.close()


@pytest.mark.slow
def test_policy_compare_scale_10k():
    """~10k-job contended trace under all four policies: everything
    completes, nothing leaks, and preemptive-priority buys high-
    priority jobs a shorter mean wait than EASY."""

    rows = {}
    for name in ("easy", "conservative", "firstfit", "preempt"):
        trace = _trace("make_contended_trace", 10_000, seed=7)
        rows[name] = _replay_policy(name, trace)   # asserts internally
    assert all(r["completed"] == 10_000 for r in rows.values())
    assert rows["preempt"]["wait_hi_mean_s"] < rows["easy"]["wait_hi_mean_s"]
    assert rows["preempt"]["preemptions"] > 0


# ---------------------------------------------------------------------- #
# reservation ledger: estimator + decision equivalence vs the seed walk
# ---------------------------------------------------------------------- #
def _replay_easy(policy, trace, nodes=4):
    """One contended trace under ``policy``; returns (start map,
    backfill count, stats)."""
    q = JobQueue(SchedulerInstance("lw", build_cluster(nodes=nodes)),
                 clock=SimClock(), policy=policy)
    for e in trace:
        q.advance(max(e["arrival"] - q.clock.now(), 0.0))
        q.submit(e["jobspec"], walltime=e["walltime"],
                 priority=e.get("priority", 0),
                 preemptible=e.get("preemptible", False))
        q.step()
    q.drain()
    s = q.stats()
    assert s.completed == s.submitted
    assert q.scheduler.allocations == {}
    starts = {j.jobid: j.start_time for j in q.completed}
    backfills = sum(1 for line in q.events if " backfill " in line)
    return starts, backfills, s


def test_ledger_estimators_equal_legacy_walk():
    """shadow_time / reservation_profile answers from the incremental
    ledger must equal the seed's O(running) rebuild at every step of a
    contended replay."""
    from repro_torch.core.policy import reservation_profile, shadow_time

    q = JobQueue(SchedulerInstance("le", build_cluster(nodes=4)),
                 clock=SimClock(), policy=make_policy("easy"))
    for e in _trace("make_contended_trace", 120, seed=11):
        q.advance(max(e["arrival"] - q.clock.now(), 0.0))
        q.submit(e["jobspec"], walltime=e["walltime"],
                 priority=e["priority"], preemptible=e["preemptible"])
        q.step()
        if q.pending:
            head = q.pending[0]
            assert shadow_time(q, head, use_ledger=True) == \
                shadow_time(q, head, use_ledger=False)
            window = list(q.pending)[:4]
            assert reservation_profile(q, window, use_ledger=True) == \
                reservation_profile(q, window, use_ledger=False)
    q.drain()
    assert q.ledger._entries == {}


def test_exact_ledger_easy_equals_walk_oracle():
    """Decision equivalence: ledger-backed exact EASY starts every job
    at the same time as the seed's reservation_profile-walk EASY
    (``ledger=False``) on the identical contended trace — and the same
    holds with the batched prefilter active (a graph above
    FLAT_MIN_VERTICES)."""

    trace = _trace("make_contended_trace", 150, seed=3)
    s_led, bf_led, _ = _replay_easy(EasyBackfill(), trace)
    s_walk, bf_walk, _ = _replay_easy(EasyBackfill(ledger=False), trace)
    assert s_led == s_walk
    assert bf_led == bf_walk

    # big graph (16 nodes = 881 vertices > FLAT_MIN_VERTICES): the
    # vectorized prefilter + skip memos are live and must not change
    # one admission
    trace16 = _trace("make_trace", 250, seed=5)
    s_led, bf_led, _ = _replay_easy(EasyBackfill(), trace16, nodes=16)
    s_walk, bf_walk, _ = _replay_easy(EasyBackfill(ledger=False),
                                      trace16, nodes=16)
    assert s_led == s_walk
    assert bf_led == bf_walk


def test_windowed_easy_unchanged_by_ledger():
    """The bounded window (Slurm bf_max_job_test analogue) admits the
    identical set with and without the ledger plane."""

    trace = _trace("make_contended_trace", 150, seed=9)
    s_led, bf_led, _ = _replay_easy(
        EasyBackfill(max_candidates=8), trace)
    s_walk, bf_walk, _ = _replay_easy(
        EasyBackfill(max_candidates=8, ledger=False), trace)
    assert s_led == s_walk
    assert bf_led == bf_walk


try:
    import hypothesis.strategies as hyp_st
    from hypothesis import given as hyp_given, settings as hyp_settings
    HAS_HYPOTHESIS = True
except ImportError:
    HAS_HYPOTHESIS = False

if HAS_HYPOTHESIS:
    _churn_event = hyp_st.tuples(
        hyp_st.floats(0.0, 8.0),        # arrival gap
        hyp_st.integers(0, 4),          # shape index
        hyp_st.floats(1.0, 60.0),       # walltime
        hyp_st.integers(0, 5),          # priority
    )

    @pytest.mark.slow
    @hyp_settings(max_examples=30, deadline=None)
    @hyp_given(hyp_st.lists(_churn_event, min_size=5, max_size=60),
               hyp_st.integers(0, 1000))
    def test_ledger_easy_equivalence_under_random_churn(events, seed):
        """Property (ISSUE 9 satellite): under random submit/finish
        churn — arrivals, shapes, walltimes, priorities all drawn by
        hypothesis — ledger-backed exact EASY admits exactly the same
        backfill set (same per-job start times) as the seed's
        reservation-profile-walk EASY, and the windowed variant is
        equally unchanged.  ``drain`` interleaves finishes with starts,
        so release-order churn is covered too."""
        shapes = [
            Jobspec.hpc(nodes=1, sockets=2, cores=32),
            Jobspec.hpc(nodes=0, sockets=1, cores=8),
            Jobspec.hpc(nodes=0, sockets=1, cores=16),
            Jobspec.hpc(nodes=2, sockets=4, cores=64),
            Jobspec.hpc(nodes=0, sockets=2, cores=16),
        ]
        t = 0.0
        trace = []
        for gap, si, wt, prio in events:
            t += gap
            trace.append({"arrival": t, "jobspec": shapes[si],
                          "walltime": wt, "priority": prio})
        for window in (None, 4):
            s_led, bf_led, _ = _replay_easy(
                EasyBackfill(max_candidates=window), trace)
            s_walk, bf_walk, _ = _replay_easy(
                EasyBackfill(max_candidates=window, ledger=False), trace)
            assert s_led == s_walk
            assert bf_led == bf_walk

    @pytest.mark.slow
    @hyp_settings(max_examples=20, deadline=None)
    @hyp_given(hyp_st.lists(_churn_event, min_size=5, max_size=40),
               hyp_st.integers(0, 1000))
    def test_ledger_consistent_under_preempt_churn(events, seed):
        """Property: under preemptive churn (random priorities force
        evictions) the ledger's entries always mirror the running set
        — start/finish/preempt deltas never leak or drift."""
        from repro_torch.core.policy import _path_type_counts
        shapes = [
            Jobspec.hpc(nodes=1, sockets=2, cores=32),
            Jobspec.hpc(nodes=0, sockets=1, cores=8),
            Jobspec.hpc(nodes=0, sockets=1, cores=16),
            Jobspec.hpc(nodes=1, sockets=1, cores=16),
            Jobspec.hpc(nodes=0, sockets=2, cores=16),
        ]
        q = JobQueue(SchedulerInstance("pc", build_cluster(nodes=2)),
                     clock=SimClock(), policy=PreemptivePriority())
        t = 0.0
        for gap, si, wt, prio in events:
            t += gap
            q.advance(max(t - q.clock.now(), 0.0))
            q.submit(shapes[si], walltime=wt, priority=prio,
                     preemptible=prio < 3)
            q.step()
            want = {j.jobid: (j.end_time, _path_type_counts(q, j))
                    for j in q.running if j.end_time is not None}
            assert q.ledger._entries == want
        q.drain()
        assert q.ledger._entries == {}
