"""`Instance` facade tests: the one submit/handle/event surface, its
served (remote) twin, and concurrent MG safety under the per-instance
lock.

The twin of tests/test_api.py on ``repro_torch.core``, the port's copy
of the control plane: only the imports are rewritten (and the tenancy test
left out: tenancy is not ported)."""
import functools
import threading

import pytest

from repro_torch.core import (Instance, JobState, Jobspec, RemoteInstance,
                              SimClock, TreeSpec, WallClock, build_cluster,
                              build_tree)
from repro_torch.core.rpc import SocketTransport

# the port's graphs take the device of their flat mirror; these run on the CPU
build_cluster = functools.partial(build_cluster, device="cpu")

NODE = Jobspec.hpc(nodes=1, sockets=2, cores=32)
SOCKET8 = Jobspec.hpc(nodes=0, sockets=1, cores=8)


def _instance(nodes=2, **kw):
    kw.setdefault("clock", SimClock())
    return Instance(graph=build_cluster(nodes=nodes), name="api", **kw)


# ---------------------------------------------------------------------- #
# local surface
# ---------------------------------------------------------------------- #
def test_submit_wait_result_roundtrip():
    inst = _instance()
    h = inst.submit(NODE, walltime=5.0, priority=3)
    assert h.state is JobState.PENDING
    res = h.result()                    # wait() drives the SimClock
    assert h.state is JobState.COMPLETED
    assert res["state"] == "completed"
    assert res["priority"] == 3
    assert res["via"] == "local"
    assert res["n_paths"] > 0


def test_handle_cancel_pending_and_running():
    inst = _instance(nodes=1)
    a = inst.submit(NODE, walltime=50.0)
    b = inst.submit(NODE, walltime=50.0)
    inst.step()
    assert a.state is JobState.RUNNING
    assert b.cancel() and b.state is JobState.CANCELLED
    assert a.cancel() and a.state is JobState.CANCELLED
    assert not a.cancel()


def test_dispatch_bypasses_blocked_head():
    inst = _instance()
    inst.submit(Jobspec.hpc(nodes=10, sockets=20, cores=320),
                walltime=5.0)
    inst.step()
    h = inst.submit(NODE, walltime=5.0, dispatch=True)
    assert h.state is JobState.RUNNING


def test_running_filters_by_alloc_id():
    inst = _instance()
    a = inst.submit(SOCKET8, walltime=None, alloc_id="shared",
                    dispatch=True)
    b = inst.submit(SOCKET8, walltime=None, alloc_id="shared",
                    dispatch=True)
    c = inst.submit(SOCKET8, walltime=None, dispatch=True)
    assert {h.jobid for h in inst.running("shared")} == \
        {a.jobid, b.jobid}
    assert len(inst.running()) == 3
    assert c.state is JobState.RUNNING


def test_wait_on_wallclock_polls_to_completion():
    inst = _instance(clock=WallClock())
    h = inst.submit(NODE, walltime=0.01)
    assert h.wait(timeout=5.0) is JobState.COMPLETED


def test_wallclock_wait_wakes_on_terminal_event_not_spin():
    """A cross-thread cancel must wake the waiter via the condition
    variable — promptly, and without the old fixed-2ms stepping spin
    (the step count stays far below what polling would rack up)."""
    import time

    inst = _instance(clock=WallClock())
    # a job that can never start (cluster too small): the waiter parks
    h = inst.submit(Jobspec.hpc(nodes=10, sockets=20, cores=320),
                    walltime=60.0)
    steps = []
    orig_step = inst.queue.step
    inst.queue.step = lambda: steps.append(1) or orig_step()

    def cancel_later():
        time.sleep(0.4)
        h.cancel()

    th = threading.Thread(target=cancel_later)
    t0 = time.monotonic()
    th.start()
    state = h.wait(timeout=10.0)
    elapsed = time.monotonic() - t0
    th.join()
    assert state is JobState.CANCELLED
    assert elapsed < 2.0                    # woke promptly on FREE
    # 2ms spin over 0.4s would step ~200 times; the condition-variable
    # wait ticks at most every 50ms plus the wake itself
    assert len(steps) < 30


def test_submit_many_local_and_remote():
    """Batched submit/grow: one lock hold locally, one round-trip
    remotely, same handles as N singles."""
    inst = _instance(nodes=2)
    handles = inst.submit_many([SOCKET8] * 4, walltime=5.0)
    assert len(handles) == 4
    inst.step()
    assert all(h.state is JobState.RUNNING for h in handles)
    # remote, over the multiplexed transport
    from repro_torch.core import MuxTransport
    served = _instance(nodes=2)
    t = MuxTransport(served.serve())
    remote = RemoteInstance(t)
    try:
        rh = remote.submit_many([SOCKET8] * 4, walltime=5.0)
        assert len(rh) == 4
        remote.step()
        assert all(x.state is JobState.RUNNING for x in rh)
        oks = remote.grow_many([(rh[0].jobid, SOCKET8)])
        assert oks == [False]       # queue built without allow_grow
        # pipelined generic batch: one write, ordered responses
        infos = remote.call_many([("job", {"jobid": x.jobid})
                                  for x in rh])
        assert [i["job"]["jobid"] for i in infos] == \
            [x.jobid for x in rh]
    finally:
        remote.close()
        served.close()


def test_grow_many_applies_in_order():
    inst = _instance(nodes=2, allow_grow=True)
    h = inst.submit(SOCKET8, walltime=5.0)
    inst.step()
    assert h.state is JobState.RUNNING
    before = len(h.paths)
    oks = inst.grow_many([(h.jobid, SOCKET8), (h.jobid, SOCKET8)])
    assert oks == [True, True]
    assert len(h.paths) > before


def test_wait_returns_current_state_when_stuck():
    inst = _instance()
    h = inst.submit(Jobspec.hpc(nodes=10, sockets=20, cores=320),
                    walltime=5.0)
    assert h.wait() is JobState.PENDING     # nothing can ever start it


def test_usage_and_stats_through_facade():
    inst = _instance(nodes=1)
    h = inst.submit(NODE, walltime=5.0)
    inst.step()
    assert inst.usage()["allocated"] > 0
    inst.drain()
    s = inst.stats()
    assert s.completed == 1 and s.submitted == 1
    assert h.state is JobState.COMPLETED


def test_instance_adopts_existing_queue_and_log():
    """Wrapping an existing queue must reuse its event log — one queue
    never gets two journals."""
    from repro_torch.core import JobQueue, SchedulerInstance
    sched = SchedulerInstance("q", build_cluster(nodes=1))
    q = JobQueue(sched, clock=SimClock())
    first = Instance(queue=q)
    second = Instance(queue=q)
    assert first.events is q.eventlog
    assert second.events is q.eventlog
    assert sched.eventlog is q.eventlog


# ---------------------------------------------------------------------- #
# served surface (remote drives a tree it doesn't own)
# ---------------------------------------------------------------------- #
def test_remote_full_verb_set_over_socket():
    served = _instance(nodes=2)
    remote = RemoteInstance(SocketTransport(served.serve()))
    try:
        h = remote.submit(SOCKET8, walltime=None, dispatch=True)
        assert h.state is JobState.RUNNING
        # malleable grow/shrink over the wire
        assert h.grow(SOCKET8)
        n = remote.job(h.jobid)["n_paths"]
        assert h.shrink(count=n // 2)
        assert remote.job(h.jobid)["n_paths"] == n - n // 2
        assert remote.usage()["allocated"] > 0
        assert h.cancel()
        # cancelled jobs leave no queue trace (bounded bookkeeping),
        # so the remote record is gone; the journal keeps the story
        assert h.state is None
        assert [e.type.value for e in h.events()][-1] == "free"
        # a second client sees the same journal by cursor
        other = RemoteInstance(SocketTransport(served.serve()))
        events, _ = other.events_since(0)
        assert [e.type.value for e in events] == \
            [e.type.value for e in served.events_since(0)[0]]
        other.close()
    finally:
        remote.close()
        served.close()


def test_remote_submit_error_surfaces():
    """A malformed remote submit returns an error payload and leaves
    an EXCEPTION event in the journal instead of killing the server."""
    from repro_torch.core import EventType
    served = _instance()
    remote = RemoteInstance(SocketTransport(served.serve()))
    try:
        resp = remote._call("submit",
                            jobspec={"resources": [{"count": 2}]})
        assert "error" in resp
        events, _ = served.events_since(0)
        assert any(e.type is EventType.EXCEPTION for e in events)
        # the server is still alive and serving
        h = remote.submit(NODE, walltime=1.0, dispatch=True)
        assert h.state is JobState.RUNNING
    finally:
        remote.close()
        served.close()


# ---------------------------------------------------------------------- #
# concurrent MG through one parent (per-instance lock)
# ---------------------------------------------------------------------- #
def _two_leaf_tree(socket=True):
    root_g = build_cluster(nodes=8, node_prefix="rn")
    la = build_cluster(nodes=1, node_prefix="an")
    lb = build_cluster(nodes=1, node_prefix="bn")
    return build_tree(TreeSpec(root_g, name="root", children=[
        TreeSpec(la, name="A", socket=socket),
        TreeSpec(lb, name="B", socket=socket)]))


@pytest.mark.parametrize("socket", [False, True])
def test_two_threads_growing_through_one_parent(socket):
    """Concurrent MG requests from two children (pooled socket
    connections) race on the shared parent: every grow must succeed on
    disjoint vertices and every level must stay a valid tree."""
    h = _two_leaf_tree(socket=socket)
    try:
        a, b = h["A"], h["B"]
        results = {"A": [], "B": []}
        errors = []

        def grower(inst, key):
            try:
                for i in range(3):
                    res = inst.match_grow(NODE, f"{key}-job{i}")
                    results[key].append(res)
            except Exception as exc:     # pragma: no cover - fail loud
                errors.append(exc)

        t1 = threading.Thread(target=grower, args=(a, "A"))
        t2 = threading.Thread(target=grower, args=(b, "B"))
        t1.start(); t2.start()
        t1.join(10.0); t2.join(10.0)
        assert not errors, errors
        assert all(r.ok for rs in results.values() for r in rs)
        # disjoint vertices: the parent handed no node out twice
        taken = [p for rs in results.values() for r in rs
                 for p in r.new_paths]
        grown_nodes = [p for p in taken if p.count("/") == 2]
        assert len(grown_nodes) == len(set(grown_nodes))
        for inst in h.instances:
            assert inst.graph.validate_tree(), inst.name
        # parent bookkeeping consistent: every grow that escalated is
        # booked at the parent (the first per leaf matches locally)
        root = h["root"]
        escalated = [r for rs in results.values() for r in rs
                     if r.via == "parent"]
        assert len(escalated) == 4       # 1 local + 2 remote per leaf
        for key in ("A", "B"):
            for i in (1, 2):
                assert f"{key}-job{i}" in root.allocations
    finally:
        h.close()


def test_concurrent_remote_clients_and_owner_share_one_queue():
    """Two socket clients submitting/waiting while the owner drives the
    same wall-clock queue: the Instance-level lock must keep queue
    state consistent (no double-starts, no list corruption)."""
    served = Instance(graph=build_cluster(nodes=4), name="cc",
                      clock=WallClock())
    errors = []

    def client(n):
        try:
            remote = RemoteInstance(SocketTransport(served.serve()))
            handles = [remote.submit(SOCKET8, walltime=0.01)
                       for _ in range(n)]
            for h in handles:
                assert h.wait(timeout=10.0) is JobState.COMPLETED
            remote.close()
        except Exception as exc:         # pragma: no cover - fail loud
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(4,))
               for _ in range(2)]
    for t in threads:
        t.start()
    for _ in range(50):                  # the owner drives too
        served.step()
    for t in threads:
        t.join(20.0)
    try:
        assert not errors, errors
        import time as _t
        for _ in range(500):            # wall clock: step until done
            served.step()
            if served.stats().completed == 8:
                break
            _t.sleep(0.005)
        s = served.stats()
        assert s.completed == s.submitted == 8
        assert not served.scheduler.allocations
        assert served.scheduler.graph.validate_tree()
        # the journal stayed a total order
        seqs = [e.seq for e in served.events_since(0)[0]]
        assert seqs == sorted(seqs)
    finally:
        served.close()


def test_concurrent_release_and_grow_do_not_corrupt():
    """Release storms racing grows on one instance (the pooled-socket
    reality) must keep allocations and the graph consistent."""
    h = _two_leaf_tree(socket=True)
    try:
        a = h["A"]
        stop = threading.Event()
        errors = []

        def churn():
            try:
                for i in range(10):
                    jid = f"churn-{i}"
                    if a.match_grow(SOCKET8, jid):
                        a.release(jid)
            except Exception as exc:     # pragma: no cover
                errors.append(exc)
            finally:
                stop.set()

        t = threading.Thread(target=churn)
        t.start()
        for i in range(10):
            jid = f"main-{i}"
            if a.match_grow(SOCKET8, jid):
                a.release(jid)
        t.join(10.0)
        assert not errors, errors
        assert not a.allocations
        for inst in h.instances:
            assert inst.graph.validate_tree(), inst.name
    finally:
        h.close()

