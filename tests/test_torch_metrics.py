"""Observability-plane tests: sketch error bounds, replay==live==remote
metric equivalence, journal-gap detection/resync, emit-clock coherence,
lease conservation and the return-home policy, engine trace spans, and
the cluster-health RPC surface.

The twin of tests/test_metrics.py on ``repro_torch``, the port's copy
of the control plane: only the imports are rewritten, and the graphs are built
with ``device="cpu"`` (the port's graphs take the device of their flat mirror)."""
import functools
import math
import random
import time as _time

import pytest

from repro_torch.core import (EventLog, EventType, Instance, JobQueue, JobState,
                              Jobspec, MetricsAggregator, MultiTenantTree,
                              MuxTransport, PreemptivePriority, QuantileSketch,
                              RemoteInstance, RemoteSubscription,
                              SchedulerInstance, SimClock, SpanCollector,
                              TenantSpec, build_cluster, fragmentation)
from repro_torch.runtime.dashboard import ClusterHealth, follow_metrics

# the port's graphs take the device of their flat mirror; these run on the CPU
build_cluster = functools.partial(build_cluster, device="cpu")

NODE = Jobspec.hpc(nodes=1, sockets=2, cores=32)
SOCKET8 = Jobspec.hpc(nodes=0, sockets=1, cores=8)


def _instance(nodes=2, **kw):
    kw.setdefault("clock", SimClock())
    return Instance(graph=build_cluster(nodes=nodes), name="m", **kw)


def _two_tenants(wa=1.0, wb=1.0):
    root_g = build_cluster(nodes=2)
    a_g = root_g.extract([p for p in root_g.paths() if "node0" in p])
    b_g = root_g.extract([p for p in root_g.paths() if "node1" in p])
    return MultiTenantTree(root_g, [
        TenantSpec("A", a_g, weight=wa, policy=PreemptivePriority()),
        TenantSpec("B", b_g, weight=wb)])


def _spin(pred, timeout=5.0):
    deadline = _time.monotonic() + timeout
    while _time.monotonic() < deadline:
        if pred():
            return True
        _time.sleep(0.005)
    return pred()


# ---------------------------------------------------------------------- #
# quantile sketch
# ---------------------------------------------------------------------- #
def test_sketch_error_bound_vs_exact():
    """Relative error vs exact percentiles on 10k samples stays within
    the configured alpha (2x slack for rank discretization)."""
    rng = random.Random(7)
    alpha = 0.01
    xs = [rng.lognormvariate(0.0, 1.0) for _ in range(10_000)]
    sk = QuantileSketch(alpha)
    for x in xs:
        sk.add(x)
    xs.sort()
    for q in (0.50, 0.90, 0.99):
        exact = xs[max(math.ceil(q * len(xs)), 1) - 1]
        est = sk.quantile(q)
        assert abs(est - exact) / exact <= 2 * alpha, q
    s = sk.summary()
    assert s["n"] == 10_000
    assert s["max"] == pytest.approx(xs[-1])


def test_sketch_order_independent_and_mergeable():
    rng = random.Random(11)
    xs = [rng.expovariate(0.5) for _ in range(5000)]
    a = QuantileSketch()
    for x in xs:
        a.add(x)
    shuffled = list(xs)
    rng.shuffle(shuffled)
    b = QuantileSketch()
    for x in shuffled:
        b.add(x)
    assert a.buckets == b.buckets           # bit-identical bucket state
    for q in (0.5, 0.9, 0.99):
        assert a.quantile(q) == b.quantile(q)
    assert a.summary()["mean"] == pytest.approx(b.summary()["mean"])
    # split + merge == whole
    lo, hi = QuantileSketch(), QuantileSketch()
    for x in xs[:2500]:
        lo.add(x)
    for x in xs[2500:]:
        hi.add(x)
    lo.merge(hi)
    assert lo.buckets == a.buckets
    for q in (0.5, 0.9, 0.99):
        assert lo.quantile(q) == a.quantile(q)


def test_sketch_zero_and_bounded_bins():
    sk = QuantileSketch(maxbins=16)
    for i in range(1000):
        sk.add(0.0 if i % 10 == 0 else float(i + 1))
    assert len(sk.buckets) <= 16
    assert sk.quantile(0.01) == 0.0         # zeros rank lowest
    assert sk.quantile(0.99) > 0.0


# ---------------------------------------------------------------------- #
# replay == live == remote equivalence
# ---------------------------------------------------------------------- #
def test_metrics_equivalence_live_replay_remote():
    """The same trace, folded three ways — live batch sink, cursor
    replay, and a remote-over-mux event feed — yields identical
    derived metrics."""
    inst = _instance(nodes=2, allow_grow=True)
    live = MetricsAggregator("eq")
    live.follow(inst)                       # attached before the trace
    handles = [inst.submit(SOCKET8, walltime=float(3 + i))
               for i in range(3)]
    inst.step()
    assert inst.grow(handles[0].jobid, SOCKET8)
    inst.advance(2.0)
    assert inst.shrink(handles[0].jobid, count=1)
    inst.advance(20.0)
    inst.drain()
    assert all(h.state is JobState.COMPLETED for h in handles)

    replay = MetricsAggregator("eq")
    replay.pump(inst)                       # cursor replay from 0

    remote = MetricsAggregator("eq")
    transport = MuxTransport(inst.serve())
    sub = RemoteSubscription(transport, remote.observe, cursor=0)
    try:
        total = inst.events.stats()["next"]
        assert _spin(lambda: remote.n_events >= total)
    finally:
        sub.close()
        transport.close()
        inst.close()

    d_live, d_replay, d_remote = (a.derived()
                                  for a in (live, replay, remote))
    assert d_live == d_replay
    assert d_live == d_remote
    assert d_live["resyncs"] == 0
    assert d_live["counts"][EventType.GROW.value] >= 1
    assert d_live["counts"][EventType.SHRINK.value] == 1
    assert d_live["busy_now"] == 0          # trace fully drained
    assert d_live["wait"]["n"] == 3


def test_tree_trace_equivalence_under_preemption_churn():
    """Per-tenant live vs replay equivalence on a trace with sibling
    donation, revocation, and requeue."""
    mt = _two_tenants()
    try:
        lives = {n: MetricsAggregator(n) for n in mt.instances}
        for n, agg in lives.items():
            agg.follow(mt.instances[n])
        qa, qb = mt.queue("A"), mt.queue("B")
        b1 = qb.submit(NODE, walltime=100.0, preemptible=True)
        b2 = qb.submit(NODE, walltime=100.0, preemptible=True)
        mt.step()
        a1 = qa.submit(NODE, walltime=10.0, priority=5)
        mt.step()
        assert a1.state is JobState.RUNNING
        mt.advance(10.0)
        mt.drain()
        assert {b1.state, b2.state} == {JobState.COMPLETED}
        for n, agg in lives.items():
            replay = MetricsAggregator(n)
            replay.pump(mt.instances[n])
            assert agg.derived() == replay.derived(), n
        db = lives["B"].derived()
        assert db["preemptions"] >= 1
        assert db["requeue"]["n"] >= 1      # PREEMPT -> restart latency
    finally:
        mt.close()


# ---------------------------------------------------------------------- #
# journal gaps
# ---------------------------------------------------------------------- #
def test_eventlog_dropped_count_and_watermark():
    log = EventLog(clock=SimClock(), maxlen=8)
    for i in range(30):
        log.emit(EventType.SUBMIT, f"j{i}")
    st = log.stats()
    assert st["dropped"] == 22
    assert st["oldest"] == 22               # truncation watermark
    assert st["retained"] == 8
    assert st["next"] == 30
    assert log.dropped == 22
    events, nxt = log.since(0)
    assert events[0].seq == 22 and nxt == 30


def test_aggregator_detects_gap_and_resyncs():
    log = EventLog(clock=SimClock(), maxlen=8)
    agg = MetricsAggregator("gap")
    for i in range(5):
        log.emit(EventType.SUBMIT, f"j{i}")
    agg.pump(log)
    assert agg.resyncs == 0 and agg.n_events == 5
    for i in range(5, 30):                  # overflow past the cursor
        log.emit(EventType.SUBMIT, f"j{i}")
    agg.pump(log)
    assert agg.resyncs == 1
    assert agg.gap_events == 22 - 5         # events lost to truncation
    assert agg.n_events == 5 + 8
    assert agg.derived()["resyncs"] == 1
    # fresh consumer pumping an already-truncated journal is a gap too
    fresh = MetricsAggregator("fresh")
    fresh.pump(log)
    assert fresh.resyncs == 1 and fresh.gap_events == 22


def test_live_join_mid_stream_is_not_a_gap():
    log = EventLog(clock=SimClock(), maxlen=1000)
    for i in range(10):
        log.emit(EventType.SUBMIT, f"j{i}")
    agg = MetricsAggregator("join")
    agg.follow(log)                         # joins at seq 10
    log.emit(EventType.SUBMIT, "late")
    d = agg.derived()
    assert d["n_events"] == 1
    assert d["resyncs"] == 0


def test_orchestrator_counts_resyncs():
    from repro_torch.runtime.orchestrator import Orchestrator, ReplicaSet
    inst = _instance(nodes=2)
    inst.events.maxlen = 8                  # tiny retained window
    orch = Orchestrator(inst, follow=False)
    orch.create(ReplicaSet("web", SOCKET8, desired=1))
    for i in range(40):                     # push the journal past us
        inst.events.emit(EventType.SUBMIT, f"noise{i}")
    orch.reconcile("web")
    assert orch.resyncs == 1


# ---------------------------------------------------------------------- #
# emit-clock coherence (every event stamped by the owning queue's clock)
# ---------------------------------------------------------------------- #
def test_event_clock_coherence():
    # a caller-supplied clockless journal adopts the queue's clock
    sched = SchedulerInstance("c1", build_cluster(nodes=1))
    clock = SimClock()
    q = JobQueue(sched, clock=clock, eventlog=EventLog())
    assert q.eventlog.clock is clock
    # and the reverse: a clocked journal defines the queue's time base
    sched2 = SchedulerInstance("c2", build_cluster(nodes=1))
    log2 = EventLog(clock=SimClock(start=5.0))
    q2 = JobQueue(sched2, eventlog=log2)
    assert q2.clock is log2.clock
    # every emit site (queue, engine, scheduler release) stamps with
    # that one clock: t is non-decreasing in seq order and never ahead
    # of the clock
    mt = _two_tenants()
    try:
        qa, qb = mt.queue("A"), mt.queue("B")
        qb.submit(NODE, walltime=10.0, preemptible=True)
        qb.submit(NODE, walltime=10.0, preemptible=True)
        mt.step()
        qa.submit(NODE, walltime=5.0, priority=5)
        mt.step()
        mt.advance(10.0)
        mt.drain()
        for name, inst in mt.instances.items():
            assert inst.events.clock is inst.queue.clock, name
            events, _ = inst.events_since(0)
            assert events, name
            ts = [e.t for e in events]
            assert ts == sorted(ts), name
            assert all(0.0 <= t <= mt.clock.now() for t in ts), name
    finally:
        mt.close()


# ---------------------------------------------------------------------- #
# lease ledger: conservation, debt, return-home
# ---------------------------------------------------------------------- #
def test_lease_conservation_and_return_home():
    mt = _two_tenants()
    try:
        ledger = mt.root.arbiter.ledger
        donor_graph = mt.hierarchy["A"].graph
        a_before = donor_graph.num_vertices
        qb = mt.queue("B")
        b1 = qb.submit(NODE, walltime=50.0)
        b2 = qb.submit(NODE, walltime=50.0)
        mt.step()
        assert {b1.state, b2.state} == {JobState.RUNNING}
        # b2 overflowed onto A's subtree: the donation is a lease
        debt, credit = ledger.debt(), ledger.credit()
        assert debt.get("A", 0) > 0
        assert sum(debt.values()) == sum(credit.values())  # conservation
        assert ledger.summary()["outstanding_vertices"] > 0
        assert donor_graph.num_vertices < a_before
        # pressure drops: borrower drains, capacity returns home
        mt.advance(50.0)
        mt.drain()
        assert ledger.debt() == {}
        assert ledger.summary()["active"] == 0
        assert ledger.summary()["returned"] >= 1
        assert donor_graph.num_vertices == a_before
        assert donor_graph.validate_tree()
        # and the donor can schedule on the returned capacity locally
        qa = mt.queue("A")
        a1 = qa.submit(NODE, walltime=1.0)
        mt.step()
        assert a1.state is JobState.RUNNING
        assert a1.via == "local"
    finally:
        mt.close()


def test_lease_recorded_on_preemptive_revoke():
    mt = _two_tenants()
    try:
        ledger = mt.root.arbiter.ledger
        qa, qb = mt.queue("A"), mt.queue("B")
        b1 = qb.submit(NODE, walltime=100.0, preemptible=True)
        b2 = qb.submit(NODE, walltime=100.0, preemptible=True)
        mt.step()
        qa.submit(NODE, walltime=10.0, priority=5)
        mt.step()
        assert {b1.state, b2.state} == {JobState.PREEMPTED,
                                        JobState.RUNNING}
        leases = ledger.active()
        assert any(l.preempt and l.n_victims >= 1 for l in leases)
        assert sum(ledger.debt().values()) == \
            sum(ledger.credit().values())
        mt.advance(200.0)
        mt.drain()
        assert ledger.debt() == {}          # debt -> 0 after churn
        for inst in mt.hierarchy.instances:
            assert inst.graph.validate_tree(), inst.name
    finally:
        mt.close()


# ---------------------------------------------------------------------- #
# trace spans
# ---------------------------------------------------------------------- #
def test_engine_spans_record_stages_when_attached():
    inst = _instance(nodes=2, allow_grow=True)
    col = SpanCollector()
    inst.scheduler.span_collector = col
    h = inst.submit(SOCKET8, walltime=5.0)
    inst.step()
    assert inst.grow(h.jobid, SOCKET8)
    inst.advance(5.0)
    inst.drain()
    spans = col.drain()
    assert col.recorded == len(spans) > 0
    grows = [s for s in spans if s["name"] == "match_grow"]
    releases = [s for s in spans if s["name"] == "release"]
    assert grows and releases
    g = grows[0]
    assert g["ok"] and g["dur"] > 0.0
    assert g["level"] == "m"
    assert "local_match" in g["stages"]
    agg = MetricsAggregator("sp")
    col2 = SpanCollector()
    for s in spans:
        col2.record(s)
    summ = agg.consume_spans(col2)
    assert summ["match_grow"]["n"] == len(grows)
    assert "match_grow.local_match" in summ
    inst.close()


def test_engine_detached_records_nothing():
    inst = _instance(nodes=2, allow_grow=True)
    assert inst.scheduler.span_collector is None
    h = inst.submit(SOCKET8, walltime=5.0)
    inst.step()
    assert inst.grow(h.jobid, SOCKET8)
    inst.advance(5.0)
    inst.drain()
    assert h.state is JobState.COMPLETED    # identical behavior, no spans
    inst.close()


# ---------------------------------------------------------------------- #
# fragmentation gauge
# ---------------------------------------------------------------------- #
def test_fragmentation_gauge():
    g = build_cluster(nodes=2)
    f0 = fragmentation(g)
    for t, row in f0.items():
        assert row["largest_block"] == row["total_free"]
        assert row["frag"] == 0.0
    # allocate one core inside node0: core capacity fragments
    core = next(p for p in g.paths()
                if "node0" in p and g.vertex(p).type == "core")
    g.set_allocated([core], "jobx")
    f1 = fragmentation(g)
    assert f1["core"]["total_free"] == f0["core"]["total_free"] - 1
    assert f1["core"]["largest_block"] <= f0["core"]["largest_block"]
    assert 0.0 <= f1["core"]["frag"] <= 1.0


# ---------------------------------------------------------------------- #
# cluster-health surface
# ---------------------------------------------------------------------- #
def test_status_verbs_local_and_over_mux():
    mt = _two_tenants(wa=2.0, wb=1.0)
    health = ClusterHealth(mt)
    try:
        qb = mt.queue("B")
        b1 = qb.submit(NODE, walltime=50.0)
        b2 = qb.submit(NODE, walltime=50.0)
        mt.step()
        assert {b1.state, b2.state} == {JobState.RUNNING}
        remote = RemoteInstance(MuxTransport(mt.root.serve()))
        try:
            s = remote.status()
            assert s["fleet"]["utilization"] > 0.0
            assert s["lease"]["debt"].get("A", 0) > 0   # debt observable
            assert s["tenants"]["B"]["lease_credit"] > 0
            assert s["tenants"]["A"]["lease_debt"] == \
                s["lease"]["debt"]["A"]
            assert s == health.status()     # same view, both transports
            t = remote.tenants()["tenants"]
            assert t["A"]["weight"] == 2.0
            m = remote.metrics()
            assert "A" in m["instances"] and "B" in m["instances"]
            assert "fragmentation" in m["instances"]["A"]["gauges"]
            # pressure drops -> the remote view shows debt back at zero
            mt.advance(50.0)
            mt.drain()
            s2 = remote.status()
            assert s2["lease"]["debt"] == {}
            assert s2["lease"]["outstanding_vertices"] == 0
            assert s2["lease"]["returned"] >= 1
            table = health.render(s2)
            assert "tenant" in table and "A" in table and "B" in table
        finally:
            remote.close()
    finally:
        health.close()
        mt.close()


def test_metrics_stream_push_fanout():
    mt = _two_tenants()
    health = ClusterHealth(mt)
    try:
        addr = mt.root.serve()
        snaps1, snaps2 = [], []
        t1, t2 = MuxTransport(addr), MuxTransport(addr)
        s1 = follow_metrics(t1, snaps1.append)
        s2 = follow_metrics(t2, snaps2.append)
        try:
            qb = mt.queue("B")
            qb.submit(NODE, walltime=5.0)
            mt.step()
            snap = health.publish()
            assert _spin(lambda: snaps1 and snaps2)
            assert snaps1[0]["fleet"] == snap["fleet"]
            assert snaps2[0]["fleet"] == snap["fleet"]
        finally:
            s1.close()
            s2.close()
            t1.close()
            t2.close()
    finally:
        health.close()
        mt.close()


def test_cluster_health_single_instance():
    inst = _instance(nodes=2)
    health = ClusterHealth(inst)
    try:
        h = inst.submit(NODE, walltime=5.0)
        inst.step()
        assert h.state is JobState.RUNNING
        s = health.status()
        assert "lease" not in s             # no arbiter on a lone node
        (row,) = s["tenants"].values()
        assert row["utilization"] > 0.0
        remote = RemoteInstance(MuxTransport(inst.serve()))
        try:
            assert remote.status()["fleet"]["allocated"] == \
                s["fleet"]["allocated"]
        finally:
            remote.close()
    finally:
        health.close()
        inst.close()
