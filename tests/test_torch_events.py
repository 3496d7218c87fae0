"""Event-semantics tests: total order per job, cursor replay == live
subscription, the PREEMPT requeue sequence, and events riding
``SocketTransport`` unchanged.

The twin of tests/test_events.py on ``repro_torch.core``, the port's copy
of the control plane: only the imports are rewritten, and the graphs are built
with ``device="cpu"`` (the port's graphs take the device of their flat mirror)."""
import functools
import threading

from repro_torch.core import (EventLog, EventType, Instance, JobEvent, JobState,
                              Jobspec, MultiTenantTree, PreemptivePriority,
                              RemoteInstance, SimClock, TenantSpec, build_cluster)
from repro_torch.core.rpc import SocketTransport

# the port's graphs take the device of their flat mirror; these run on the CPU
build_cluster = functools.partial(build_cluster, device="cpu")

NODE = Jobspec.hpc(nodes=1, sockets=2, cores=32)
SOCKET8 = Jobspec.hpc(nodes=0, sockets=1, cores=8)


def _instance(nodes=2, **kw):
    return Instance(graph=build_cluster(nodes=nodes), name="ev",
                    clock=SimClock(), **kw)


# ---------------------------------------------------------------------- #
# the log itself
# ---------------------------------------------------------------------- #
def test_eventlog_cursor_replay_and_bounds():
    log = EventLog(maxlen=8)
    for i in range(20):
        log.emit(EventType.SUBMIT, f"j{i}", t=float(i))
    events, cursor = log.since(0)
    assert len(events) == 8                 # bounded retention
    assert [e.jobid for e in events] == [f"j{i}" for i in range(12, 20)]
    assert cursor == 20
    # incremental replay from a live cursor
    log.emit(EventType.FREE, "j20", t=20.0)
    more, cursor2 = log.since(cursor)
    assert [e.jobid for e in more] == ["j20"] and cursor2 == 21
    tail, _ = log.since(cursor2)
    assert tail == []


def test_event_roundtrips_through_dict():
    ev = JobEvent(seq=3, t=1.5, type=EventType.GROW, jobid="a",
                  detail={"via": "parent", "size": 10})
    assert JobEvent.from_dict(ev.to_dict()) == ev


def test_live_subscription_equals_cursor_replay():
    inst = _instance()
    live = []
    unsubscribe = inst.subscribe(live.append)
    a = inst.submit(NODE, walltime=5.0)
    b = inst.submit(NODE, walltime=7.0)
    inst.step()
    inst.drain()
    replayed, _ = inst.events_since(0)
    assert replayed == live
    assert a.state is JobState.COMPLETED
    assert b.state is JobState.COMPLETED
    # unsubscribe stops the live feed
    unsubscribe()
    inst.submit(NODE, walltime=1.0)
    assert len(live) < len(inst.events_since(0)[0])


# ---------------------------------------------------------------------- #
# per-job sequences
# ---------------------------------------------------------------------- #
def test_total_order_per_job_lifecycle():
    inst = _instance(nodes=1)
    h = inst.submit(NODE, walltime=5.0)
    inst.step()
    inst.drain()
    kinds = [e.type for e in h.events()]
    assert kinds == [EventType.SUBMIT, EventType.ALLOC, EventType.START,
                     EventType.RELEASE, EventType.FREE]
    # seq is globally monotonic, hence totally ordered per job
    seqs = [e.seq for e in h.events()]
    assert seqs == sorted(seqs)


def test_preempt_requeue_emits_the_right_sequence():
    """Intra-queue preemption: the victim's journal reads
    RELEASE -> PREEMPT, then a fresh ALLOC/START when it restarts."""
    inst = _instance(nodes=1, policy=PreemptivePriority())
    low = inst.submit(NODE, walltime=50.0, priority=0, preemptible=True)
    inst.step()
    hi = inst.submit(NODE, walltime=10.0, priority=5)
    inst.step()
    assert hi.state is JobState.RUNNING
    assert low.state is JobState.PREEMPTED
    inst.drain()
    assert low.state is JobState.COMPLETED
    kinds = [e.type.value for e in low.events()]
    assert kinds == ["submit", "alloc", "start",
                     "release", "preempt",
                     "alloc", "start", "release", "free"], kinds


def test_cross_tenant_revoke_emits_revoke_then_preempt():
    """A hierarchy revoke lands in the victim tenant's journal as
    RELEASE -> REVOKE -> PREEMPT (the scheduler releases, the engine
    revokes, the queue requeues) before the victim restarts."""
    root_g = build_cluster(nodes=2)
    a_g = root_g.extract([p for p in root_g.paths() if "node0" in p])
    b_g = root_g.extract([p for p in root_g.paths() if "node1" in p])
    mt = MultiTenantTree(root_g, [
        TenantSpec("A", a_g, policy=PreemptivePriority()),
        TenantSpec("B", b_g)])
    try:
        b1 = mt.instance("B").submit(NODE, walltime=100.0,
                                     preemptible=True)
        b2 = mt.instance("B").submit(NODE, walltime=100.0,
                                     preemptible=True)
        mt.step()
        mt.instance("A").submit(NODE, walltime=10.0, priority=9)
        mt.step()
        victim = b1 if b1.state is JobState.PREEMPTED else b2
        kinds = [e.type.value for e in victim.events()]
        i = kinds.index("release")
        assert kinds[i:i + 3] == ["release", "revoke", "preempt"], kinds
        mt.drain()
        assert victim.state is JobState.COMPLETED
    finally:
        mt.close()


def test_grow_and_shrink_are_observable_operations():
    inst = _instance(nodes=2, allow_grow=False)
    h = inst.submit(SOCKET8, walltime=None)
    inst.step()
    assert h.state is JobState.RUNNING
    assert h.grow(SOCKET8)
    n = len(h.paths)
    assert h.shrink(count=max(n // 2, 1))
    kinds = [e.type.value for e in h.events()]
    assert "grow" in kinds and "shrink" in kinds
    assert kinds.index("grow") < kinds.index("shrink")
    # shrink detail carries the released path count
    shrink_ev = next(e for e in h.events()
                     if e.type is EventType.SHRINK)
    assert shrink_ev.detail["n_paths"] == max(n // 2, 1)
    # refused operations surface as EXCEPTION, not silence
    assert not h.shrink(count=len(h.paths))
    assert any(e.type is EventType.EXCEPTION for e in h.events())


# ---------------------------------------------------------------------- #
# events over SocketTransport
# ---------------------------------------------------------------------- #
def _drive(api) -> list:
    """One scripted scenario driven through any Instance-like surface;
    returns the (type, jobid) event sequence it produced."""
    a = api.submit(NODE, walltime=5.0, jobid="job-a")
    b = api.submit(NODE, walltime=8.0, jobid="job-b")
    api.step()
    api.advance(20.0)
    events, _ = api.events_since(0)
    return [(e.type.value, e.jobid) for e in events]


def test_remote_tree_observes_same_event_sequence_as_inproc():
    """A remote client drives a tree it doesn't own over
    ``SocketTransport`` and reads back, via cursor replay, exactly the
    sequence an in-proc consumer sees for the same scenario."""
    local = _instance(nodes=2)
    inproc_seq = _drive(local)

    served = _instance(nodes=2)
    remote = RemoteInstance(SocketTransport(served.serve()))
    try:
        remote_seq = _drive(remote)
        assert remote_seq == inproc_seq
        # cursor semantics hold remotely too: replay is incremental
        events, cursor = remote.events_since(0)
        assert [(e.type.value, e.jobid) for e in events] == remote_seq
        more, cursor2 = remote.events_since(cursor)
        assert more == [] and cursor2 == cursor
        # and the remote handle verbs work against the served queue
        h = remote.submit(NODE, walltime=3.0, jobid="job-c")
        remote.step()
        assert h.wait() is JobState.COMPLETED
        assert [e.type.value for e in h.events()] == \
            ["submit", "alloc", "start", "release", "free"]
    finally:
        remote.close()
        served.close()
        local.close()


# ---------------------------------------------------------------------- #
# delivery semantics: outside the lock, isolated, still in seq order
# ---------------------------------------------------------------------- #
def test_subscriber_exception_does_not_abort_emit():
    """A bad subscriber must neither abort the emitting queue
    operation mid-mutation nor starve the other subscribers."""
    inst = _instance()
    got = []

    def bad(ev):
        raise RuntimeError("boom")

    inst.subscribe(bad)
    inst.subscribe(got.append)
    h = inst.submit(NODE, walltime=5.0)
    inst.drain()
    assert h.state is JobState.COMPLETED
    replayed, _ = inst.events_since(0)
    assert got == replayed


def test_reentrant_emit_from_subscriber_preserves_seq_order():
    """A subscriber emitting into the same log defers its event to the
    active drain, so live delivery order equals seq/replay order."""
    log = EventLog()
    live = []

    def echo(ev):
        if ev.type is EventType.SUBMIT:
            log.emit(EventType.FREE, ev.jobid)

    log.subscribe(echo)
    log.subscribe(live.append)
    log.emit(EventType.SUBMIT, "a")
    log.emit(EventType.SUBMIT, "b")
    replayed, _ = log.since(0)
    assert live == replayed
    assert [e.type for e in live] == [EventType.SUBMIT, EventType.FREE,
                                      EventType.SUBMIT, EventType.FREE]


def test_callbacks_run_outside_the_log_lock():
    """Delivery must not hold ``EventLog._lock`` across subscriber
    code: another thread can emit while a subscriber is still running
    (holding the lock here deadlocked emitters and invited lock-order
    inversions with Instance verbs)."""
    log = EventLog()
    done = threading.Event()

    def emit_from_other_thread():
        log.emit(EventType.FREE, "inner")
        done.set()

    def sub(ev):
        if ev.jobid != "outer":
            return
        t = threading.Thread(target=emit_from_other_thread)
        t.start()
        assert done.wait(5.0), "emit blocked on the log lock"
        t.join(5.0)

    log.subscribe(sub)
    log.emit(EventType.SUBMIT, "outer")
    events, _ = log.since(0)
    assert [e.jobid for e in events] == ["outer", "inner"]


def test_revoke_listener_takes_victim_queue_api_lock():
    """A hierarchy revoke arrives on whatever thread ran the
    preemptive grow; the victim queue's requeue — the mutation of its
    pending/running lists — must happen under its ``_api_lock`` so it
    serializes with the owner's own verbs.  (Event-subscriber context
    is deliberately NOT the probe here: which thread runs a callback
    is unspecified.)"""
    root_g = build_cluster(nodes=2)
    a_g = root_g.extract([p for p in root_g.paths() if "node0" in p])
    b_g = root_g.extract([p for p in root_g.paths() if "node1" in p])
    mt = MultiTenantTree(root_g, [
        TenantSpec("A", a_g, policy=PreemptivePriority()),
        TenantSpec("B", b_g)])
    try:
        held = []
        qb = mt.queue("B")
        requeue = qb._requeue

        def probe(job):
            held.append(qb._api_lock._is_owned())
            return requeue(job)

        qb._requeue = probe
        # two node-sized jobs: the second grows into A's subtree, so
        # A's high-priority submit must revoke it to reclaim node0
        mt.instance("B").submit(NODE, walltime=100.0, preemptible=True)
        mt.instance("B").submit(NODE, walltime=100.0, preemptible=True)
        mt.step()
        mt.instance("A").submit(NODE, walltime=10.0, priority=9)
        mt.step()
        assert held and all(held)
        # and the PREEMPT really landed in B's journal
        evs = [e.type for e in mt.instance("B").events_since(0)[0]]
        assert EventType.PREEMPT in evs
    finally:
        mt.close()


def test_late_subscriber_skips_parked_events():
    """since()-then-subscribe handoff: a subscriber never receives an
    event emitted before it subscribed — even one still parked for
    delivery when the subscription lands (it would otherwise arrive
    both via replay and live)."""
    log = EventLog()
    got = []
    once = []

    def sub1(ev):
        if ev.type is EventType.SUBMIT and not once:
            once.append(1)
            log.emit(EventType.FREE, ev.jobid)   # parked behind drain
            log.subscribe(got.append)            # joins after the park
    log.subscribe(sub1)
    log.emit(EventType.SUBMIT, "a")
    assert got == []            # parked FREE predated the subscription
    log.emit(EventType.SUBMIT, "b")
    assert [e.jobid for e in got] == ["b"]


# ---------------------------------------------------------------------- #
# push-mode streaming: same sequences as cursor replay, over the wire
# ---------------------------------------------------------------------- #
def test_push_subscribers_see_exact_replay_sequences():
    """Acceptance: a push-mode remote subscriber observes the exact
    same per-job event sequences as ``events_since`` cursor replay —
    across both the backlog (replayed) and live (streamed) phases."""
    from repro_torch.core import MuxTransport

    served = _instance(nodes=2)
    t = MuxTransport(served.serve())
    remote = RemoteInstance(t)
    try:
        # backlog phase: drive some history before anyone subscribes
        served.submit(NODE, walltime=5.0, jobid="job-a")
        served.step()
        got = []
        sub = remote.subscribe(cb=got.append, cursor=0)
        # live phase: more activity lands after the subscription
        served.submit(NODE, walltime=8.0, jobid="job-b")
        served.step()
        served.advance(20.0)
        replay, _ = served.events_since(0)
        deadline = threading.Event()
        for _ in range(200):                    # wait for the stream
            if sub.events_received >= len(replay):
                break
            deadline.wait(0.02)
        assert sub.events_received == len(replay)
        assert [(e.seq, e.type, e.jobid) for e in got] == \
            [(e.seq, e.type, e.jobid) for e in replay]
        for jobid in {e.jobid for e in replay}:
            assert [e.seq for e in got if e.jobid == jobid] == \
                [e.seq for e in replay if e.jobid == jobid]
        sub.close()
    finally:
        remote.close()
        served.close()


def test_push_subscriber_fleet_all_see_every_event():
    """A fleet of concurrent subscribers on one shared reactor all
    receive the full sequence (encode-once fan-out)."""
    from repro_torch.core import ClientReactor, MuxTransport

    served = _instance(nodes=2)
    addr = served.serve()
    reactor = ClientReactor()
    try:
        transports = [MuxTransport(addr, reactor=reactor)
                      for _ in range(32)]
        subs = [RemoteInstance(t).subscribe(cursor=0)
                for t in transports]
        served.submit(NODE, walltime=5.0, jobid="job-a")
        served.submit(NODE, walltime=8.0, jobid="job-b")
        served.step()
        served.advance(20.0)
        total = len(served.events_since(0)[0])
        ev = threading.Event()
        for _ in range(300):
            if all(s.events_received >= total for s in subs):
                break
            ev.wait(0.02)
        assert [s.events_received for s in subs] == [total] * 32
        assert all(s.cursor == total for s in subs)
        for t in transports:
            t.close()
    finally:
        reactor.close()
        served.close()


def test_server_restart_subscriber_reattach_no_gaps_no_dups():
    """Satellite: after a server restart, a subscriber reattaches on a
    fresh transport from its cursor and the merged stream equals the
    ``events_since`` replay — no gaps, no duplicates."""
    from repro_torch.core import MuxTransport

    served = _instance(nodes=2)
    t1 = MuxTransport(served.serve())
    got = []
    sub = RemoteInstance(t1).subscribe(cb=got.append, cursor=0)
    served.submit(NODE, walltime=5.0, jobid="job-a")
    served.step()
    ev = threading.Event()
    for _ in range(200):
        if sub.events_received >= len(served.events_since(0)[0]):
            break
        ev.wait(0.02)
    cursor_before = sub.cursor
    served.close()                       # server restarts
    t1.close()
    # events emitted while the subscriber is disconnected
    served.submit(NODE, walltime=8.0, jobid="job-b")
    served.step()
    served.advance(20.0)
    t2 = MuxTransport(served.serve())    # fresh port, same journal
    try:
        sub.reattach(t2)
        assert sub.cursor >= cursor_before
        replay, total = served.events_since(0)
        for _ in range(300):
            if sub.events_received >= len(replay):
                break
            ev.wait(0.02)
        seqs = [e.seq for e in got]
        assert seqs == sorted(set(seqs))            # no duplicates
        assert seqs == [e.seq for e in replay]      # no gaps
        sub.close()
    finally:
        t2.close()
        served.close()


def test_batch_sink_receives_every_event_in_order():
    """The EventLog server-push hook: a batch sink sees the same total
    order as a per-event subscriber, just chunked."""
    log = EventLog()
    singles, batches = [], []
    log.subscribe(singles.append)
    log.add_sink(batches.extend)
    for i in range(600):
        log.emit(EventType.SUBMIT, f"j{i}")
    assert [e.seq for e in batches] == [e.seq for e in singles]
    # join-cursor semantics: a late sink misses nothing it shouldn't
    late = []
    remove = log.add_sink(late.extend)
    log.emit(EventType.FREE, "jX")
    assert [e.jobid for e in late] == ["jX"]
    remove()
    log.emit(EventType.FREE, "jY")
    assert [e.jobid for e in late] == ["jX"]
